"""Command-line tools of the port, registered under ``accelerate-tpu-torch``
(``commands/cli.py``; ``python -m accelerate_tpu_torch.commands.cli`` from a
checkout)."""
