"""Replica lifecycle for the serving fleet: health states and transitions.

Counterpart of ``accelerate_tpu/serving/fleet.py``. One :class:`EngineReplica` wraps one :class:`~.engine.ServingEngine` with the
operational state the router places against. The state machine:

::

                 degradation events            persistent degradation
                 (watchdog, quarantine)        (or operator drain)
      HEALTHY ───────────────────────▶ DEGRADED ──────────────────▶ DRAINING
         ▲                                │                            │
         │  clean steps                   │ heartbeat loss /           │ queue re-homed,
         │  (recover_after)               │ step exception /           │ active slots
         ├────────────────────────────────┘ chaos kill                 │ finish, then
         │                                ▼                            ▼
      RECOVERING ◀────────────────────── DEAD ◀────────────────────────┘
                  revive() (fresh engine)

Policy knobs live in :class:`HealthPolicy`; the *decisions* (what counts as a
degradation event, when DEGRADED escalates to DRAINING, when silence means
DEAD) live here so the router stays pure placement + failover mechanics. Like
the scheduler/engine split, this module is host-side bookkeeping only: no
device work.

Replica death is modelled honestly: a DEAD replica's engine is treated as
unreachable (SIGKILL semantics — its queue and KV cache are gone with the
process), so recovery of in-flight work must come from the *router's* own
request bookkeeping, never from the dead engine's memory.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..resilience.detector import SilenceDetector


class ReplicaLost(RuntimeError):
    """A replica died (step exception, chaos kill, or heartbeat silence)
    with requests in flight. Classified transient by
    :func:`~..resilience.retry.is_fleet_transient`: the requests re-home."""

    def __init__(self, message: str, replica_index: Optional[int] = None):
        super().__init__(message)
        self.replica_index = replica_index


class HandoffLost(RuntimeError):
    """A live-KV handoff attempt failed in flight: the transfer timed out,
    the source's blocks vanished mid-read (chaos ``handoff_loss``, or the
    source replica died between park and adoption), or the destination
    raised before acknowledging. Classified transient by
    :func:`~..resilience.retry.is_handoff_transient` — the router retries
    under a jittered policy and then degrades to re-prefill on the decode
    pool, which is always correct: a parked request has delivered ZERO
    tokens, so regeneration from the prompt can neither duplicate nor skip
    one."""


class ReplicaState(str, enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DRAINING = "draining"
    DEAD = "dead"
    RECOVERING = "recovering"


# Disaggregated serving: a replica's ROLE names which
# request phases it serves. "mixed" (the default) is the replicated baseline
# — prefill and decode on the same chips. A "prefill" replica runs prompt
# prefills and parks the finished KV for handoff; a "decode" replica adopts
# handed-off KV (or re-prefills on fallback) and streams tokens. Roles are
# an OPERATIONAL property, not a health state: the router demotes a pool's
# survivors to "mixed" when the opposite pool dies, so the fleet keeps
# serving — slower — with either pool gone.
REPLICA_ROLES = ("prefill", "decode", "mixed")


@dataclass(frozen=True)
class HealthPolicy:
    """When a replica's observed behavior moves it between states.

    ``heartbeat_timeout_s=None`` disables the wall-clock probe (an in-process
    fleet steps synchronously, so genuine silence only happens under chaos
    injection or a wedged step reported by the step watchdog). The
    timeout semantics are the shared
    :class:`~..resilience.detector.SilenceDetector` — the SAME primitive the
    training membership service uses, so the two subsystems cannot drift on
    what "silent" means."""

    heartbeat_timeout_s: Optional[float] = None
    # degradation events (watchdog trips + slot quarantines, observed via
    # stats deltas) that move HEALTHY → DEGRADED
    degrade_after: int = 1
    # consecutive clean steps that move DEGRADED back to HEALTHY
    recover_after: int = 8
    # cumulative degradation events while DEGRADED that escalate to DRAINING
    # (the replica is sick, not unlucky — stop feeding it)
    drain_after: int = 4


class EngineReplica:
    """One engine + its health state machine, as the router sees it."""

    def __init__(
        self,
        index: int,
        engine: Any,
        policy: Optional[HealthPolicy] = None,
        on_transition: Optional[Callable[["EngineReplica", ReplicaState, str], None]] = None,
        role: str = "mixed",
    ):
        if role not in REPLICA_ROLES:
            raise ValueError(f"role must be one of {REPLICA_ROLES}, got {role!r}")
        self.index = index
        self.engine = engine
        self.policy = policy or HealthPolicy()
        self.on_transition = on_transition
        self.role = role
        self.state = ReplicaState.HEALTHY
        self.last_progress = time.monotonic()
        self.death_reason: Optional[str] = None
        self.heartbeat_lost = False  # chaos: probe permanently silent
        self._degraded_events = 0
        self._clean_steps = 0
        # stats counters at last observation — transitions run on DELTAS, so
        # one old quarantine doesn't keep re-degrading a recovered replica
        self._seen_watchdog = 0
        self._seen_quarantines = 0

    # -- placement view ------------------------------------------------------

    @property
    def alive(self) -> bool:
        """The router may still step this replica's engine."""
        return self.state not in (ReplicaState.DEAD, ReplicaState.RECOVERING)

    @property
    def placeable(self) -> bool:
        """New requests may land here (DRAINING replicas only finish)."""
        return (
            self.state in (ReplicaState.HEALTHY, ReplicaState.DEGRADED)
            and not self.engine.draining
        )

    @property
    def serves_prefill(self) -> bool:
        """This replica runs new prompts' prefills ("mixed" serves both)."""
        return self.role in ("prefill", "mixed")

    @property
    def serves_decode(self) -> bool:
        """This replica decodes (adopting handed-off KV, or full serving)."""
        return self.role in ("decode", "mixed")

    def load_score(self) -> float:
        """Live load from the engine's own books: waiting requests plus
        occupied slots, normalized by slot count so replicas of different
        sizes compare fairly. The queue term dominates once slots fill —
        exactly the signal ``retry_after_hint`` prices. A paged engine adds
        its page-pool occupancy: pages are the scarcer resource under mixed
        long/short traffic (one 4k prompt can pin most of a pool while its
        lane count looks idle), and a replica near page exhaustion would
        preempt or shed whatever the router places there."""
        scheduler = self.engine.scheduler
        score = (scheduler.waiting + len(scheduler.active_slots)) / max(
            self.engine.cache.num_slots, 1
        )
        if getattr(self.engine, "paged", False):
            score += self.engine.cache.page_occupancy
        return score

    # -- observations --------------------------------------------------------

    def touch(self) -> None:
        """Refresh the progress clock. The router calls this when it PLACES
        a request here: an idle replica's clock is necessarily stale (only
        steps advance it), and without the refresh the first request after
        an idle gap longer than the heartbeat timeout would read
        busy-and-silent and kill a perfectly healthy replica."""
        self.last_progress = time.monotonic()

    def heartbeat(self) -> bool:
        """Liveness probe. False means operationally dead: chaos took the
        heartbeat, or the engine has work but made no step progress within
        the timeout (a wedged replica and a dead one are indistinguishable
        from outside — both fail over). The silence decision is the shared
        :class:`~..resilience.detector.SilenceDetector`, one timeout
        semantic for the fleet and the training membership detector."""
        if self.heartbeat_lost:
            return False
        if self.engine.busy and SilenceDetector(
            self.policy.heartbeat_timeout_s
        ).expired(self.last_progress):
            return False
        return True

    def observe_step(self) -> None:
        """Fold one completed engine step into the state machine."""
        self.last_progress = time.monotonic()
        stats = self.engine.stats
        events = (stats.watchdog_trips - self._seen_watchdog) + (
            stats.slot_quarantines - self._seen_quarantines
        )
        self._seen_watchdog = stats.watchdog_trips
        self._seen_quarantines = stats.slot_quarantines
        if events:
            self._degraded_events += events
            self._clean_steps = 0
            if (
                self.state is ReplicaState.HEALTHY
                and self._degraded_events >= self.policy.degrade_after
            ):
                self._transition(ReplicaState.DEGRADED, f"{self._degraded_events} degradation events")
            elif (
                self.state is ReplicaState.DEGRADED
                and self._degraded_events >= self.policy.drain_after
            ):
                self._transition(
                    ReplicaState.DRAINING,
                    f"{self._degraded_events} degradation events while degraded",
                )
        elif self.state is ReplicaState.DEGRADED:
            self._clean_steps += 1
            if self._clean_steps >= self.policy.recover_after:
                self._degraded_events = 0
                self._transition(ReplicaState.HEALTHY, f"{self._clean_steps} clean steps")

    # -- transitions ---------------------------------------------------------

    def _transition(self, state: ReplicaState, reason: str) -> None:
        if state is self.state:
            return
        self.state = state
        if self.on_transition is not None:
            self.on_transition(self, state, reason)

    def start_drain(self, reason: str = "operator drain") -> None:
        """Stop placement; the engine finishes its active slots. The queued
        requests come back via ``engine.drain()`` — the ROUTER calls that, so
        it can re-home them (this module never touches request payloads)."""
        if self.state in (ReplicaState.DEAD, ReplicaState.RECOVERING):
            raise ValueError(f"replica {self.index} is {self.state.value}, cannot drain")
        self._transition(ReplicaState.DRAINING, reason)

    def finish_flip(self, role: str) -> None:
        """Complete a drain-safe role flip (serving/autoscale.py): a DRAINING
        replica that ran empty re-enters placement under ``role`` — same
        engine, same kernel builds, same page pool. The rebalancer (not this
        module) calls this only once the engine is idle with nothing parked;
        the guard here is the state machine's, not the drain's."""
        if self.state is not ReplicaState.DRAINING:
            raise ValueError(
                f"replica {self.index} is {self.state.value}, not draining — "
                "only a drained replica can re-enter under a new role"
            )
        if role not in REPLICA_ROLES:
            raise ValueError(f"role must be one of {REPLICA_ROLES}, got {role!r}")
        self.role = role
        self.engine.resume_admission()
        # the old role's measured service rates would misprice the new
        # role's queue (a decode history underquotes chunked prefill by an
        # order of magnitude — enough to turn backed-off clients into a
        # retry storm): quotes restart from the conservative prior
        self.engine.reset_service_estimate()
        self._degraded_events = 0
        self._clean_steps = 0
        self.last_progress = time.monotonic()
        self._transition(ReplicaState.HEALTHY, f"role flip to {role} complete")

    def mark_dead(self, reason: str) -> None:
        """SIGKILL semantics: from here the engine object must be treated as
        unreachable — in-flight recovery uses the router's bookkeeping."""
        self.death_reason = reason
        self._transition(ReplicaState.DEAD, reason)

    def begin_recovery(self, engine: Any) -> None:
        """A fresh engine (new process in a real fleet) starts warming."""
        if self.state is not ReplicaState.DEAD:
            raise ValueError(f"replica {self.index} is {self.state.value}, not dead")
        self.engine = engine
        self.heartbeat_lost = False
        self.death_reason = None
        self._degraded_events = 0
        self._clean_steps = 0
        self._seen_watchdog = engine.stats.watchdog_trips
        self._seen_quarantines = engine.stats.slot_quarantines
        self.last_progress = time.monotonic()
        self._transition(ReplicaState.RECOVERING, "fresh engine attached")

    def complete_recovery(self) -> None:
        if self.state is not ReplicaState.RECOVERING:
            raise ValueError(f"replica {self.index} is {self.state.value}, not recovering")
        self._transition(ReplicaState.HEALTHY, "recovery probe passed")

    def summary(self) -> dict:
        """Flat per-replica health view for fleet telemetry records."""
        return {
            "index": self.index,
            "state": self.state.value,
            "role": self.role,
            "load_score": self.load_score() if self.alive else None,
            "degraded_events": self._degraded_events,
            "death_reason": self.death_reason,
        }
