"""Async-dispatch-correct step timing.

Counterpart of ``accelerate_tpu/telemetry/step_timer.py``. Naive per-step
wall clocks are WRONG under CUDA's asynchronous launches: the Python call
that "runs" a step only enqueues its kernels, so ``t1 - t0`` measures the
host's run-ahead while the card is still working on earlier steps, and
fencing every step to fix that serializes the pipeline the measurement is
supposed to observe.

The timer instead brackets WINDOWS: every ``sample_every`` steps it forces one
fence (``torch.cuda.synchronize()`` of the device the step's outputs live on,
else of this process's card; nothing on the CPU), and the window duration
divided by the window's step count is one *sample* of true steady-state step
time. Between boundaries the timer is two integer ops: steady-state steps
incur ZERO forced synchronization outside the sampling cadence. A caller
that has already fenced the device at this step (the numerical guard's read
of its state, on the same cadence) says so with :meth:`StepTimer.note_fence`,
and the boundary takes that fence instead of a second one.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch


def drain_local_devices() -> None:
    """Wait for every kernel queued on this process's card: a
    ``torch.cuda.synchronize()``. Nothing on a CPU-only run, and nothing
    where CUDA was never initialized (no card work can be in flight)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Sampling step timer. Call :meth:`step` once per training step, passing
    the step's outputs (loss) when available so the fence waits on real work.

    ``fence_count`` is exposed for tests and overhead audits: it must equal
    the number of completed sampling boundaries, never the step count.
    """

    def __init__(self, sample_every: int = 16, max_samples: int = 4096):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = sample_every
        self.max_samples = max_samples
        self.steps = 0
        self.fence_count = 0
        self.samples: list[float] = []  # seconds per step, one per window
        self._timed_seconds = 0.0  # fenced-window time, for goodput accounting
        self._timed_steps = 0
        self._boundary_time: Optional[float] = None
        self._boundary_step = 0
        self.shared_fences = 0  # boundaries that took a caller's fence (note_fence)
        self._noted_fence = False

    def note_fence(self) -> None:
        """The caller has just waited for the device (a blocking read of
        device state) after this step's work: a boundary at this step takes
        that fence instead of synchronizing again."""
        self._noted_fence = True

    def step(self, outputs: Any = None) -> None:
        self.steps += 1
        shared, self._noted_fence = self._noted_fence, False
        if self.steps % self.sample_every != 0:
            return
        self._fence(outputs, shared)
        now = time.perf_counter()
        if self._boundary_time is not None:
            window_steps = self.steps - self._boundary_step
            if window_steps > 0:
                self._record(now - self._boundary_time, window_steps)
        self._boundary_time = now
        self._boundary_step = self.steps

    def discard_window(self) -> None:
        """Drop the in-flight window (call after a checkpoint save, resume, or
        profiler start/stop inside the loop — that wall time belongs to the
        goodput ledger, not the step-time distribution)."""
        self._boundary_time = None

    def _record(self, seconds: float, window_steps: int) -> None:
        self._timed_seconds += seconds
        self._timed_steps += window_steps
        self.samples.append(seconds / window_steps)
        if len(self.samples) > self.max_samples:
            # decimate rather than slide: keeps early-run samples represented
            self.samples = self.samples[::2]

    def _fence(self, outputs: Any, shared: bool = False) -> None:
        self.fence_count += 1
        if shared:
            self.shared_fences += 1
            return
        if isinstance(outputs, torch.Tensor):
            if outputs.is_cuda:
                torch.cuda.synchronize(outputs.device)
        else:
            drain_local_devices()

    # -- derived -----------------------------------------------------------

    @property
    def mean_step_seconds(self) -> Optional[float]:
        if not self._timed_steps:
            return None
        return self._timed_seconds / self._timed_steps

    @property
    def productive_seconds(self) -> float:
        """Estimated compute time over ALL steps so far (measured window time
        extrapolated to the unmeasured steps) — the goodput numerator."""
        mean = self.mean_step_seconds
        return mean * self.steps if mean is not None else 0.0

    def percentiles(self, qs=(50, 90, 99)) -> dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    def summary(self) -> dict:
        out = {
            "steps": self.steps,
            "sampled_windows": len(self.samples),
            "sample_every": self.sample_every,
        }
        mean = self.mean_step_seconds
        if mean is not None:
            out["step_time_mean_ms"] = mean * 1e3
            out["steps_per_sec"] = 1.0 / mean if mean > 0 else float("inf")
            for name, value in self.percentiles().items():
                out[f"step_time_{name}_ms"] = value * 1e3
        return out
