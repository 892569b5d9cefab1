"""Deterministic fault injection: the chaos plan the fleet is drilled against.

Counterpart of ``accelerate_tpu/resilience/chaos.py``. A :class:`FaultPlan`
is a schedule, not a dice roll: the same plan fires the same faults at the
same steps every run, so a test can hold the fleet's books to exact counts.
The seed feeds synthetic content only, never whether a fault fires.

The plan is whole here: every field of the JAX plan, ``from_env`` over the
same ``ACCELERATE_CHAOS_*`` names, the ledger (``events``) and its
``sink``, and every predicate. In this port the training step
(``nan_steps``, ``stall_steps``, ``sigterm_step``, through the resilience
hub), the checkpoint and loader I/O (``io_failures``, through the
module-level :func:`probe_io`), the engine (``serving_burst``,
``spec_disable``), the router (``replica_kill``, ``replica_stall``,
``heartbeat_loss``), the handoff (``handoff_stall``, ``handoff_loss``,
``redistribute_fail``, and the elastic relayout's transfers), the
autoscaler (``rebalance_fail``, ``autoscale_outage``) and the elastic
coordinator (``host_loss``, and the ``membership_silence``/
``membership_stall`` legs on its own host's heartbeat,
``resilience/elastic.py``) consume it.

Fleet-step indices are 0-based router steps, checked at the top of the
router's step; handoff indices count handoff attempts fleet-wide (retries
are attempts); redistribute indices count transfers process-wide
(``parallel/redistribute.py``); flip indices count the rebalancer's role
flips. ``activate()`` registers a plan for call sites with no constructor
plumbing (a router built without ``fault_plan=`` reads it).
"""

from __future__ import annotations

import errno
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..logging import get_logger

logger = get_logger(__name__)


def _parse_steps(value: Optional[str]) -> tuple[int, ...]:
    if not value:
        return ()
    return tuple(int(v) for v in value.replace(" ", "").split(",") if v)


@dataclass
class FaultPlan:
    """One run's deterministic fault schedule plus the ledger of what fired.

    Training-step indices are 1-based counts of ``compiled_step`` invocations
    on the owning Accelerator; serving-step indices count ``ServingEngine``
    decode steps (``engine._steps`` BEFORE the step runs, i.e. 0-based).
    """

    seed: int = 0
    nan_steps: tuple[int, ...] = ()
    nan_target: str = "grads"  # "grads" | "loss"
    io_failures: int = 0
    stall_steps: tuple[int, ...] = ()
    stall_seconds: float = 0.05
    sigterm_step: Optional[int] = None
    serving_burst_step: Optional[int] = None
    serving_burst_size: int = 0
    # fleet faults: indices are ServingRouter fleet-step counts (0-based,
    # checked at the TOP of the router step, before any replica decodes)
    replica_kill_step: Optional[int] = None
    replica_kill_index: int = 0
    replica_stall_step: Optional[int] = None
    replica_stall_index: int = 0
    heartbeat_loss_step: Optional[int] = None
    heartbeat_loss_index: int = 0
    # elastic-training fault: training-step boundary (1-based) at which host
    # ``host_loss_index``'s device group dies (resilience/elastic.py)
    host_loss_step: Optional[int] = None
    host_loss_index: int = 0
    # membership faults (resilience/membership.py): PERSISTENT from the
    # chosen training-step boundary (1-based) on — silence stops the host's
    # heartbeat publisher, stall freezes its published step-stamp while the
    # beats keep coming
    membership_silence_step: Optional[int] = None
    membership_silence_index: int = 0
    membership_stall_step: Optional[int] = None
    membership_stall_index: int = 0
    # handoff faults: indices count the router's live-KV handoff ATTEMPTS
    # (0-based, fleet-wide — retries are attempts too, so (0, 1) drills a
    # first failure AND its retry)
    handoff_stall_at: tuple[int, ...] = ()
    handoff_loss_at: tuple[int, ...] = ()
    # redistribution faults: indices count redistribute TRANSFERS (0-based,
    # process-wide — parallel/redistribute.py's sequence counter); the stage
    # index selects WHICH stage of the decomposition dies mid-transfer
    redistribute_fail_at: tuple[int, ...] = ()
    redistribute_fail_stage: int = 0
    # autoscale faults (serving/autoscale.py): rebalance_fail_at counts role
    # FLIPS (0-based, per-rebalancer flip sequence) whose donor replica is
    # killed mid-flip; the outage leg makes the rebalancer's signal source
    # unreadable from the chosen fleet step for `duration` steps (0 =
    # persistent) — the fail-static rung, not this hook, decides what
    # happens next
    rebalance_fail_at: tuple[int, ...] = ()
    autoscale_outage_step: Optional[int] = None
    autoscale_outage_duration: int = 0
    # speculative-decoding fault: the serving step (0-based, engine._steps
    # BEFORE the step) at which speculation is disabled MID-STREAM — the
    # drill asserts the engine falls back to plain decode without dropping
    # or duplicating a token (serving/speculative.py)
    spec_disable_step: Optional[int] = None

    # ledger of injected faults (appended in firing order); ``sink`` is set by
    # the resilience hub so every injection also lands in telemetry.jsonl
    events: list = field(default_factory=list)
    sink: Optional[Callable[[dict], None]] = field(default=None, repr=False)
    _io_injected: int = field(default=0, repr=False)
    _sigterm_fired: bool = field(default=False, repr=False)
    _host_loss_fired: bool = field(default=False, repr=False)
    _membership_silence_recorded: bool = field(default=False, repr=False)
    _membership_stall_recorded: bool = field(default=False, repr=False)
    _autoscale_outage_recorded: bool = field(default=False, repr=False)

    def __post_init__(self):
        if self.nan_target not in ("grads", "loss"):
            raise ValueError(f"nan_target must be 'grads' or 'loss', got {self.nan_target!r}")

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """Build a plan from ``ACCELERATE_CHAOS_*`` env vars; None when no
        chaos var is set (the common case — zero overhead)."""
        env = os.environ
        if not any(k.startswith("ACCELERATE_CHAOS_") for k in env):
            return None
        sigterm = env.get("ACCELERATE_CHAOS_SIGTERM_STEP")
        burst_step = env.get("ACCELERATE_CHAOS_SERVING_BURST_STEP")
        kill_step = env.get("ACCELERATE_CHAOS_REPLICA_KILL_STEP")
        rstall_step = env.get("ACCELERATE_CHAOS_REPLICA_STALL_STEP")
        hb_step = env.get("ACCELERATE_CHAOS_HEARTBEAT_LOSS_STEP")
        hl_step = env.get("ACCELERATE_CHAOS_HOST_LOSS_STEP")
        ms_step = env.get("ACCELERATE_CHAOS_MEMBERSHIP_SILENCE_STEP")
        mst_step = env.get("ACCELERATE_CHAOS_MEMBERSHIP_STALL_STEP")
        spec_step = env.get("ACCELERATE_CHAOS_SPEC_DISABLE_STEP")
        outage_step = env.get("ACCELERATE_CHAOS_AUTOSCALE_OUTAGE_STEP")
        return cls(
            seed=int(env.get("ACCELERATE_CHAOS_SEED", "0")),
            nan_steps=_parse_steps(env.get("ACCELERATE_CHAOS_NAN_STEPS")),
            nan_target=env.get("ACCELERATE_CHAOS_NAN_TARGET", "grads"),
            io_failures=int(env.get("ACCELERATE_CHAOS_IO_FAILURES", "0")),
            stall_steps=_parse_steps(env.get("ACCELERATE_CHAOS_STALL_STEPS")),
            stall_seconds=float(env.get("ACCELERATE_CHAOS_STALL_SECONDS", "0.05")),
            sigterm_step=int(sigterm) if sigterm else None,
            serving_burst_step=int(burst_step) if burst_step else None,
            serving_burst_size=int(env.get("ACCELERATE_CHAOS_SERVING_BURST_SIZE", "0")),
            replica_kill_step=int(kill_step) if kill_step else None,
            replica_kill_index=int(env.get("ACCELERATE_CHAOS_REPLICA_KILL_INDEX", "0")),
            replica_stall_step=int(rstall_step) if rstall_step else None,
            replica_stall_index=int(env.get("ACCELERATE_CHAOS_REPLICA_STALL_INDEX", "0")),
            heartbeat_loss_step=int(hb_step) if hb_step else None,
            heartbeat_loss_index=int(env.get("ACCELERATE_CHAOS_HEARTBEAT_LOSS_INDEX", "0")),
            host_loss_step=int(hl_step) if hl_step else None,
            host_loss_index=int(env.get("ACCELERATE_CHAOS_HOST_LOSS_INDEX", "0")),
            membership_silence_step=int(ms_step) if ms_step else None,
            membership_silence_index=int(
                env.get("ACCELERATE_CHAOS_MEMBERSHIP_SILENCE_INDEX", "0")
            ),
            membership_stall_step=int(mst_step) if mst_step else None,
            membership_stall_index=int(
                env.get("ACCELERATE_CHAOS_MEMBERSHIP_STALL_INDEX", "0")
            ),
            handoff_stall_at=_parse_steps(env.get("ACCELERATE_CHAOS_HANDOFF_STALL_AT")),
            handoff_loss_at=_parse_steps(env.get("ACCELERATE_CHAOS_HANDOFF_LOSS_AT")),
            redistribute_fail_at=_parse_steps(
                env.get("ACCELERATE_CHAOS_REDISTRIBUTE_FAIL_AT")
            ),
            redistribute_fail_stage=int(
                env.get("ACCELERATE_CHAOS_REDISTRIBUTE_FAIL_STAGE", "0")
            ),
            rebalance_fail_at=_parse_steps(env.get("ACCELERATE_CHAOS_REBALANCE_FAIL_AT")),
            autoscale_outage_step=int(outage_step) if outage_step else None,
            autoscale_outage_duration=int(
                env.get("ACCELERATE_CHAOS_AUTOSCALE_OUTAGE_DURATION", "0")
            ),
            spec_disable_step=int(spec_step) if spec_step else None,
        )

    @property
    def active(self) -> bool:
        return bool(
            self.nan_steps
            or self.io_failures
            or self.stall_steps
            or self.sigterm_step is not None
            or self.serving_burst_size
            or self.replica_kill_step is not None
            or self.replica_stall_step is not None
            or self.heartbeat_loss_step is not None
            or self.host_loss_step is not None
            or self.membership_silence_step is not None
            or self.membership_stall_step is not None
            or self.handoff_stall_at
            or self.handoff_loss_at
            or self.redistribute_fail_at
            or self.rebalance_fail_at
            or self.autoscale_outage_step is not None
            or self.spec_disable_step is not None
        )

    def _record(self, fault: str, **detail) -> None:
        event = {"event": "fault_injected", "fault": fault, **detail}
        self.events.append(event)
        logger.warning(f"chaos: injected {fault} ({detail})")
        if self.sink is not None:
            try:
                self.sink(event)
            except Exception:  # noqa: BLE001 - chaos must not break the run twice
                pass

    # -- training-side hooks (driven by the resilience hub per step) --------

    def on_step(self, step: int) -> None:
        """Host-side faults at the START of training step ``step``: stalls
        and the (single) SIGTERM."""
        if step in self.stall_steps:
            self._record("stall", step=step, seconds=self.stall_seconds)
            time.sleep(self.stall_seconds)
        if self.sigterm_step == step and not self._sigterm_fired:
            self._sigterm_fired = True
            self._record("sigterm", step=step)
            os.kill(os.getpid(), signal.SIGTERM)

    def corrupt_target(self, step: int) -> Optional[str]:
        """Which tensor (if any) to poison with NaN this step."""
        if step in self.nan_steps:
            self._record("nan", step=step, target=self.nan_target)
            return self.nan_target
        return None

    # -- I/O-side hook (checkpoint save/load probes) ------------------------

    def probe_io(self, site: str) -> None:
        """Raise a *transient* I/O error while the injection budget lasts —
        the retry policy downstream is expected to absorb it."""
        if self._io_injected < self.io_failures:
            self._io_injected += 1
            self._record("io_error", site=site, index=self._io_injected)
            raise OSError(errno.EIO, f"chaos: injected transient I/O error at {site}")

    # -- serving-side hook --------------------------------------------------

    def serving_burst(self, engine_step: int) -> int:
        """Synthetic requests to force-inject before this engine step."""
        if self.serving_burst_step == engine_step and self.serving_burst_size:
            self._record("serving_burst", step=engine_step, size=self.serving_burst_size)
            return self.serving_burst_size
        return 0

    def spec_disable(self, engine_step: int) -> bool:
        """Whether to disable speculative decoding before this engine step
        (permanent: the engine's fallback to plain decode is one-way)."""
        if self.spec_disable_step == engine_step:
            self._record("spec_disable", step=engine_step)
            return True
        return False

    # -- fleet-side hooks (driven by ServingRouter per fleet step) -----------

    def replica_kill(self, fleet_step: int, valid=None) -> Optional[int]:
        """Index of the replica to SIGKILL at this fleet step, or None.

        ``valid`` (the router passes its own check: index in range, replica
        still alive) gates the injection BEFORE it is recorded — the ledger
        and telemetry must only claim faults that actually fired, or a drill
        against a mistargeted index looks armed while testing nothing."""
        if self.replica_kill_step == fleet_step:
            if valid is not None and not valid(self.replica_kill_index):
                return None
            self._record("replica_kill", step=fleet_step, replica=self.replica_kill_index)
            return self.replica_kill_index
        return None

    def replica_stall(self, fleet_step: int, valid=None) -> Optional[tuple[int, float]]:
        """``(replica_index, seconds)`` to stall at this fleet step, or None."""
        if self.replica_stall_step == fleet_step:
            if valid is not None and not valid(self.replica_stall_index):
                return None
            self._record(
                "replica_stall", step=fleet_step, replica=self.replica_stall_index,
                seconds=self.stall_seconds,
            )
            return self.replica_stall_index, self.stall_seconds
        return None

    def heartbeat_loss(self, fleet_step: int, valid=None) -> Optional[int]:
        """Replica whose heartbeat goes permanently silent at this step."""
        if self.heartbeat_loss_step == fleet_step:
            if valid is not None and not valid(self.heartbeat_loss_index):
                return None
            self._record(
                "heartbeat_loss", step=fleet_step, replica=self.heartbeat_loss_index
            )
            return self.heartbeat_loss_index
        return None

    # -- elastic-training hook (ElasticCoordinator per step boundary) --------

    def host_loss(self, step: Optional[int], valid=None) -> Optional[int]:
        """Index of the host whose device group dies at training-step
        boundary ``step`` (1-based — the loss is detected BEFORE that step
        runs), or None. Fires at most once; ``valid`` (the coordinator's
        check: host index in range, not already lost, survivors still form a
        mesh) gates the injection before it is recorded, like the fleet
        hooks."""
        if self._host_loss_fired or step is None or self.host_loss_step != step:
            return None
        if valid is not None and not valid(self.host_loss_index):
            return None
        self._host_loss_fired = True
        self._record("host_loss", step=step, host=self.host_loss_index)
        return self.host_loss_index

    def membership_silent(self, host: int, boundary: int) -> bool:
        """Whether ``host``'s heartbeat publisher is silent at training-step
        boundary ``boundary`` (1-based, like ``host_loss``). PERSISTENT from
        the armed boundary on — a dead process never beats again — so unlike
        the one-shot legs this returns True every later boundary; the ledger
        records the onset once."""
        if (
            self.membership_silence_step is None
            or host != self.membership_silence_index
            or boundary < self.membership_silence_step
        ):
            return False
        if not self._membership_silence_recorded:
            self._membership_silence_recorded = True
            self._record("membership_silence", step=boundary, host=host)
        return True

    def membership_stall(self, host: int, boundary: int) -> Optional[int]:
        """The FROZEN step-stamp ``host`` publishes from boundary
        ``boundary`` on (heartbeats keep flowing, the step stops advancing —
        a rank wedged in a collective), or None when the host is healthy.
        The frozen value is the last step completed before the wedge."""
        if (
            self.membership_stall_step is None
            or host != self.membership_stall_index
            or boundary < self.membership_stall_step
        ):
            return None
        if not self._membership_stall_recorded:
            self._membership_stall_recorded = True
            self._record("membership_stall", step=boundary, host=host)
        return max(self.membership_stall_step - 1, 0)

    def handoff_stall(self, attempt: int) -> Optional[float]:
        """Seconds to stall handoff attempt ``attempt`` mid-transfer, or
        None. Fires INSIDE the router's transfer (between the source read
        and the destination adopt), so an armed ``handoff_timeout_s`` sees a
        genuinely late transfer, not a mocked clock."""
        if attempt in self.handoff_stall_at:
            self._record("handoff_stall", attempt=attempt, seconds=self.stall_seconds)
            return self.stall_seconds
        return None

    def handoff_loss(self, attempt: int) -> bool:
        """Whether handoff attempt ``attempt`` loses its source blocks
        mid-transfer (the router raises HandoffLost where the read would
        have returned)."""
        if attempt in self.handoff_loss_at:
            self._record("handoff_loss", attempt=attempt)
            return True
        return False

    def rebalance_fail(self, flip: int, valid=None) -> bool:
        """Whether the donor replica of role flip ``flip`` (0-based, the
        rebalancer's own flip sequence) dies mid-flip — fired by the
        rebalancer right after the donor's drain-safe transition begins,
        the window where a real autoscaler loses a node. ``valid`` (the
        rebalancer's check: donor still alive) gates the injection before
        it is recorded, like the fleet hooks."""
        if flip in self.rebalance_fail_at:
            if valid is not None and not valid(flip):
                return False
            self._record("rebalance_fail", flip=flip)
            return True
        return False

    def autoscale_outage(self, fleet_step: int) -> bool:
        """Whether the rebalancer's signal source is unreadable at this
        fleet step. PERSISTENT from the armed step (bounded by
        ``autoscale_outage_duration`` when non-zero); the ledger records the
        onset once — the fail-static rung is expected to hold for the whole
        outage, not re-enter per step."""
        if self.autoscale_outage_step is None or fleet_step < self.autoscale_outage_step:
            return False
        if (
            self.autoscale_outage_duration
            and fleet_step >= self.autoscale_outage_step + self.autoscale_outage_duration
        ):
            return False
        if not self._autoscale_outage_recorded:
            self._autoscale_outage_recorded = True
            self._record("autoscale_outage", step=fleet_step)
        return True

    def redistribute_fail(self, transfer: int, stage: int, kind: str) -> bool:
        """Whether stage ``stage`` of redistribute transfer ``transfer``
        dies mid-transfer (parallel/redistribute.py raises a
        ``RedistributeStageFailure`` where the stage would have run — the
        primitive's ladder, not this hook, decides what happens next). The
        ledger names the stage and its collective ``kind``, so the drill's
        telemetry pins WHICH stage of the decomposition was killed."""
        if transfer in self.redistribute_fail_at and stage == self.redistribute_fail_stage:
            self._record(
                "redistribute_fail", transfer=transfer, stage=stage, kind=kind
            )
            return True
        return False


# ---------------------------------------------------------------------------
# module-level activation (for call sites without constructor plumbing)
# ---------------------------------------------------------------------------

_active: Optional[FaultPlan] = None


def activate(plan: FaultPlan) -> FaultPlan:
    global _active
    _active = plan
    return plan


def deactivate() -> None:
    global _active
    _active = None


def active_plan() -> Optional[FaultPlan]:
    return _active


def probe_io(site: str) -> None:
    """Checkpoint and loader I/O call sites probe here; a no-op unless a
    plan with an I/O budget is active (one attribute read on the common
    path). The JAX package also tells its lock recorder that a blocking
    store-I/O boundary was crossed; that recorder is program analysis
    (ROADMAP item 21)."""
    if _active is not None:
        _active.probe_io(site)
