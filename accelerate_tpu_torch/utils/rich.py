"""Opt-in rich tracebacks (counterpart of ``accelerate_tpu/utils/rich.py``).

Importing this module installs rich's traceback handler, so the stack
traces of several processes stay readable; it raises when rich is not
installed (the import is the opt-in).
"""

from .imports import is_rich_available

if is_rich_available():
    from rich.traceback import install

    install(show_locals=False)
else:
    raise ModuleNotFoundError("To use the rich extension, install rich with `pip install rich`")
