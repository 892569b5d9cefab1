"""The port's copies of the reference's examples (``examples/``), run with
``python -m accelerate_tpu_torch.examples.<name>``."""
