"""Learning-rate schedule wrapper.

Counterpart of ``accelerate_tpu/scheduler.py``, with its counter semantics:
the counter does not move while the optimizer does not step, except that
with ``adjust_scheduler`` it ticks on the micro-steps of an accumulation
window; it does not move on a step the fp16 loss scale skipped; and with
``split_batches=False`` it ticks by the number of data shards (1 at the one
process of this slice) for schedules written per worker.

As in the JAX package the schedule that moves the learning rate is the one
inside the optimizer transform (the port's ``adamw(schedule)``, like
``optax.adamw(schedule)``). The wrapper keeps user loops'
``scheduler.step()`` / ``get_last_lr()`` and carries the schedule's
position in checkpoints; where the transform holds no schedule its counter
is advisory: ``get_last_lr()`` reports ``schedule_fn(counter)``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .state import GradientState, PartialState


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0, exponent: float = 1.0) -> Callable:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps``, in fp32 with optax's operation order.
    The schedule takes a step count (an int or an integer tensor, whose
    device it keeps) and returns an fp32 scalar tensor."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = float(decay_steps - warmup_steps)

    def schedule(count):
        count = torch.as_tensor(count)
        if warmup_steps > 0:
            frac = 1 - torch.clamp(count, 0, warmup_steps).to(torch.float32) / warmup_steps
            warm = (init_value - peak_value) * frac + peak_value
        else:  # optax's linear schedule over no steps is constant
            warm = torch.full((), init_value, dtype=torch.float32, device=count.device)
        decay_count = torch.clamp((count - warmup_steps).to(torch.float32), max=cosine_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * decay_count / cosine_steps))
        decayed = peak_value * ((1 - alpha) * cosine ** exponent + alpha)
        return torch.where(count < warmup_steps, warm, decayed)

    return schedule


class AcceleratedScheduler:
    def __init__(
        self,
        schedule_fn: Callable[[int], float],
        optimizer=None,
        step_with_optimizer: bool = True,
        split_batches: bool = False,
    ):
        self.schedule_fn = schedule_fn
        self.optimizer = optimizer
        self.step_with_optimizer = step_with_optimizer
        self.split_batches = split_batches
        self.gradient_state = GradientState()
        self._counter = 0

    def step(self) -> None:
        if not self.step_with_optimizer:
            self._counter += 1
            return
        if not self.gradient_state.sync_gradients:
            # the optimizer did not step on this micro-step; adjust_scheduler
            # keeps schedules written for per-batch stepping at their length
            if self.gradient_state.adjust_scheduler:
                self._counter += 1
            return
        if self.optimizer is not None and self.optimizer.step_was_skipped:
            return
        if self.split_batches:
            self._counter += 1
        else:
            # one tick per data shard: the batch axes' extent (the processes
            # of a tensor, expert or sequence group take the same rows)
            self._counter += PartialState().batch_shards

    def get_last_lr(self) -> list[float]:
        return [float(self.schedule_fn(self._counter))]

    @property
    def step_count(self) -> int:
        return self._counter

    def state_dict(self) -> dict:
        return {"counter": self._counter}

    def load_state_dict(self, state: dict) -> None:
        self._counter = int(state["counter"])
