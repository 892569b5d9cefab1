"""Command-line tools of the port, each run as ``python -m
accelerate_tpu_torch.commands.<name>``. The ``accelerate-tpu`` entry point
that registers them comes with ROADMAP item 20."""
