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

from typing import Callable

from .state import GradientState, PartialState


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
            # one tick per data shard: the number of processes until the
            # parallel slice adds data-parallel devices (ROADMAP item 9(b))
            self._counter += PartialState().num_devices

    def get_last_lr(self) -> list[float]:
        return [float(self.schedule_fn(self._counter))]

    @property
    def step_count(self) -> int:
        return self._counter

    def state_dict(self) -> dict:
        return {"counter": self._counter}

    def load_state_dict(self, state: dict) -> None:
        self._counter = int(state["counter"])
