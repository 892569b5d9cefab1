"""Process-aware logging.

Counterpart of ``accelerate_tpu/logging.py``: ``get_logger`` returns a
``MultiProcessAdapter`` whose records carry ``process_index`` and
``local_process_index`` and which logs on the main process unless a call
passes ``main_process_only=False``; ``in_order=True`` makes each process log
in turn. Both go through the port's ``PartialState``, which runs one process
until the parallel slice (ROADMAP item 9(b)).
"""

from __future__ import annotations

import functools
import logging
import os


class MultiProcessAdapter(logging.LoggerAdapter):
    """Logs on the main process unless ``main_process_only=False``."""

    @staticmethod
    def _should_log(main_process_only: bool) -> bool:
        from .state import PartialState

        # before any PartialState exists there is one process: logging must
        # not construct one (that picks the device)
        if not main_process_only or not PartialState._shared_state.get("_ready"):
            return True
        return PartialState().is_main_process

    def process(self, msg, kwargs):
        from .state import PartialState

        extra = kwargs.setdefault("extra", {})
        index = PartialState().process_index if PartialState._shared_state.get("_ready") else 0
        extra.setdefault("process_index", index)
        extra.setdefault("local_process_index", index)
        return msg, kwargs

    def log(self, level, msg, *args, **kwargs):
        from .state import PartialState

        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        if not self.isEnabledFor(level):
            return
        if in_order:
            state = PartialState()
            for i in range(state.num_processes):
                if i == state.process_index:
                    pmsg, pkwargs = self.process(msg, kwargs)
                    self.logger.log(level, pmsg, *args, **pkwargs)
                state.wait_for_everyone()
        elif self._should_log(main_process_only):
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """A ``MultiProcessAdapter`` over ``logging.getLogger(name)``; the level
    comes from ``log_level`` or ``ACCELERATE_LOG_LEVEL``."""
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    logger = logging.getLogger(name)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
