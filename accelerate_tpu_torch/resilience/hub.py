"""The Resilience hub: one object wiring the numerical guard, the chaos
harness, and retry observability into an Accelerator, mirroring how the
Telemetry hub hangs off ``accelerator.telemetry``.

Counterpart of ``accelerate_tpu/resilience/hub.py``.

Canonical loop::

    accelerator = Accelerator(
        resilience_config=ResilienceConfig(
            guard=GuardPolicy(restore_after=3, escalate_clip=1.0),
        )
    )
    step = accelerator.compiled_step(loss_fn)   # the guard rides the step
    for batch in loader:
        loss = step(batch)                      # skips/escalates/restores ride along
        accelerator.telemetry.step(loss)

Disabled (the default without a config or ``ACCELERATE_RESILIENCE=1`` /
``ACCELERATE_CHAOS_*`` env), the hub is inert: ``compiled_step`` runs the
same step as without it, and no hook is installed anywhere.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

from ..logging import get_logger
from ..utils.environment import parse_flag_from_env
from . import chaos as chaos_mod
from . import retry as retry_mod
from .chaos import FaultPlan
from .guards import GuardPolicy, NumericalGuard

logger = get_logger(__name__)


@dataclass
class ResilienceConfig:
    enabled: bool = True
    guard: Optional[GuardPolicy] = field(default_factory=GuardPolicy)
    fault_plan: Optional[FaultPlan] = None

    @classmethod
    def from_env(cls) -> "ResilienceConfig":
        plan = FaultPlan.from_env()
        # any chaos env var arms the whole subsystem: injecting faults into a
        # run that cannot defend itself is a test of nothing
        enabled = parse_flag_from_env("ACCELERATE_RESILIENCE", False) or plan is not None
        return cls(enabled=enabled, fault_plan=plan)


class Resilience:
    """Owns the guard + chaos plan for one Accelerator and the step counter
    chaos schedules against; bridges retry backoffs into telemetry."""

    def __init__(self, accelerator: Any = None, config: Optional[ResilienceConfig] = None):
        self.accelerator = accelerator
        self.config = config or ResilienceConfig.from_env()
        self.enabled = self.config.enabled
        self.steps = 0
        self.retries = 0
        self._finished = False
        self._owns_hook = False
        telemetry = getattr(accelerator, "telemetry", None)
        telemetry = telemetry if (telemetry is not None and telemetry.enabled) else None
        self.chaos: Optional[FaultPlan] = None
        self.guard: Optional[NumericalGuard] = None
        if not self.enabled:
            return
        if self.config.guard is not None:
            guard = NumericalGuard(self.config.guard, telemetry=telemetry)
            if self.config.guard.check_every is None and telemetry is not None:
                # piggyback the telemetry fence cadence: the guard's host read
                # then lands on a boundary that already synchronizes
                guard.check_every = telemetry.config.sample_every
            self.guard = guard
        if self.config.fault_plan is not None:
            self.chaos = chaos_mod.activate(self.config.fault_plan)
            if telemetry is not None:
                self.chaos.sink = lambda event, _t=weakref.ref(telemetry): (
                    _t() is not None and _t().write_record("resilience", event)
                )
        if telemetry is not None:
            # report every retry backoff anywhere in the stack (checkpoint
            # commit, offload reads, data loader) as a resilience record;
            # weakly bound so a dead Accelerator never pins its sink
            self_ref = weakref.ref(self)
            telemetry_ref = weakref.ref(telemetry)

            def _on_retry(op: str, attempt: int, delay: float, error: Exception) -> None:
                hub = self_ref()
                sink = telemetry_ref()
                if hub is not None:
                    hub.retries += 1
                if sink is not None:
                    sink.write_record(
                        "resilience",
                        {
                            "event": "retry",
                            "op": op,
                            "attempt": attempt,
                            "delay_s": round(delay, 4),
                            "error": str(error)[:200],
                        },
                    )

            retry_mod.retry_hook = _on_retry
            self._installed_hook = _on_retry
            self._owns_hook = True

    # -- per-step -----------------------------------------------------------

    def begin_step(self) -> int:
        """Advance the training-step counter chaos schedules against; fire
        host-side faults (stall, SIGTERM) for the step about to run."""
        self.steps += 1
        if self.chaos is not None:
            self.chaos.on_step(self.steps)
        return self.steps

    # -- teardown -----------------------------------------------------------

    def summary(self) -> dict:
        out = {"steps": self.steps, "retries": self.retries}
        if self.guard is not None:
            out.update(self.guard.summary())
        if self.chaos is not None:
            out["chaos_events"] = len(self.chaos.events)
        return out

    def finish(self) -> None:
        """Final guard check + summary record; idempotent (mirrors
        ``Telemetry.finish``). Called by ``Accelerator.end_training``."""
        if not self.enabled or self._finished:
            return
        self._finished = True
        if self.guard is not None and self.guard.state is not None and self.guard._bound:
            model, optimizer = self.guard._bound
            self.guard.check(model, optimizer)
        telemetry = getattr(self.accelerator, "telemetry", None)
        if telemetry is not None and telemetry.enabled:
            telemetry.write_record("resilience", {"event": "summary", **self.summary()})
        if self.chaos is not None and chaos_mod.active_plan() is self.chaos:
            chaos_mod.deactivate()
        # clear only OUR hook: a later Accelerator may have installed its own
        if self._owns_hook and retry_mod.retry_hook is getattr(self, "_installed_hook", None):
            retry_mod.retry_hook = None
        self._owns_hook = False
