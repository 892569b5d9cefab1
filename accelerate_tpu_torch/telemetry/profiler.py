"""Windowed ``torch.profiler`` trace orchestration.

Counterpart of ``accelerate_tpu/telemetry/profiler.py``. A profiler window
is armed with (start_step, num_steps, output_dir), usually through the
``ACCELERATE_PROFILE_*`` environment names, so every process of a job that
runs the same command captures the SAME step window, aligned by step number
rather than wall clock.

The hub checks :meth:`ProfileWindow.on_step` each step: two int compares
when disarmed. The window runs one ``torch.profiler.profile`` with CPU and
(where a card is present) CUDA activities, and writes its Chrome trace to
``<output_dir>/host_<process_index>/trace.json``, so a shared filesystem
collects the whole job without filename collisions.

The JAX package can also start ``jax.profiler``'s server for live capture
(``ACCELERATE_PROFILE_PORT``); PyTorch has no counterpart, so asking for a
port raises instead of being ignored.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..logging import get_logger
from ..utils.environment import parse_int_from_env

logger = get_logger(__name__)

NO_SERVER = (
    "a profiler server port was given (ACCELERATE_PROFILE_PORT or port=): jax.profiler's live-capture "
    "server has no counterpart in torch.profiler. Drop the port: the window's trace is written to its "
    "output directory"
)


def profiler_activities() -> list:
    """CPU, and CUDA where a card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


class ProfileWindow:
    def __init__(
        self,
        output_dir: Optional[str] = None,
        start_step: int = 0,
        num_steps: int = 1,
        port: Optional[int] = None,
    ):
        if port is not None:
            raise ValueError(NO_SERVER)
        self.output_dir = output_dir
        self.start_step = int(start_step)
        self.num_steps = max(int(num_steps), 1)
        self.port = port
        self.active = False
        self.completed = False
        self._profiler = None

    @classmethod
    def from_env(cls) -> Optional["ProfileWindow"]:
        output_dir = os.environ.get("ACCELERATE_PROFILE_DIR")
        if not output_dir:
            return None
        return cls(
            output_dir=output_dir,
            start_step=parse_int_from_env("ACCELERATE_PROFILE_START_STEP", 0),
            num_steps=parse_int_from_env("ACCELERATE_PROFILE_STEPS", 5),
            port=parse_int_from_env("ACCELERATE_PROFILE_PORT"),
        )

    @property
    def armed(self) -> bool:
        return self.output_dir is not None and not self.completed

    def trace_dir(self) -> str:
        from ..state import job_process_index

        return os.path.join(self.output_dir, f"host_{job_process_index()}")

    def on_step(self, step: int) -> None:
        """Start/stop the trace at the armed window's boundaries. Call with
        the step that is ABOUT to run (the hub calls it pre-increment)."""
        if not self.armed:
            return
        if not self.active and step >= self.start_step:
            self._start()
        elif self.active and step >= self.start_step + self.num_steps:
            self._stop()

    def _start(self) -> None:
        os.makedirs(self.trace_dir(), exist_ok=True)
        self._profiler = torch.profiler.profile(activities=profiler_activities())
        self._profiler.__enter__()
        self.active = True
        logger.info(f"Profiler trace started → {self.trace_dir()} ({self.num_steps} steps)", main_process_only=False)

    def _stop(self) -> None:
        from .step_timer import drain_local_devices

        # drain so the trace covers the final step's device work
        drain_local_devices()
        profiler, self._profiler = self._profiler, None
        profiler.__exit__(None, None, None)
        profiler.export_chrome_trace(os.path.join(self.trace_dir(), "trace.json"))
        self.active = False
        self.completed = True
        logger.info(f"Profiler trace written → {self.trace_dir()}", main_process_only=False)

    def close(self) -> None:
        """Stop a still-open trace (loop ended inside the window)."""
        if self.active:
            self._stop()
