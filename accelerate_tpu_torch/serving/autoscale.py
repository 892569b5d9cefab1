"""Policy-driven pool autoscaling: drain-safe role flips on live signals.

Counterpart of ``accelerate_tpu/serving/autoscale.py``. A
:class:`RoleRebalancer` that the :class:`~.router.ServingRouter` steps once
a fleet step reads the signals the fleet already keeps (per-pool slot and
page occupancy, queue depth with the router's pending requests, sheds, the
SLO burn when a monitor is attached) and flips a replica of an idle pool to
the starved role through the drain an operator's ``drain_replica`` uses:

1. ``start_drain``: placement stops, the queue re-homes through the
   router's ``_rehome_drained``, active slots run to completion and parked
   KV is handed off as in any drain;
2. once the engine is empty (no slots, nothing parked) the replica
   re-enters under its new role (:meth:`~.fleet.EngineReplica.finish_flip`).
   The engine, its pool and its kernel builds survive the flip.

Hysteresis is structural: a flip needs a starved pool (pressure at or
above ``scale_up_pressure``, or sheds since the last evaluation) and a
donor pool (at or below ``scale_down_pressure``) at once; a replica holds a
role ``min_dwell_steps`` fleet steps and the reverse of a recent flip is
blocked as long; ``cooldown_steps`` follow every flip; one transition runs
at a time fleet-wide. ``thrash_count`` counts dwell-window reversals
anyway.

**Fail-static**: when the signal read fails (the chaos leg
``autoscale_outage``), returns nothing, or carries a ``fleet_step`` older
than ``stale_after_steps``, the rebalancer freezes the fleet's shape and
writes one ``{"kind": "autoscale", "event": "fail_static"}`` record naming
why; it still settles a flip in flight. Chaos ``rebalance_fail_at`` kills
the donor mid-flip: the flip aborts and the router's death path re-homes
everything.

The rebalancer reads ``time.perf_counter`` only to time its flips (the
``seconds`` of a ``flip_completed`` record) and stamp its signals; its
decisions depend on fleet steps and the signals alone.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .fleet import REPLICA_ROLES, EngineReplica, ReplicaState

# flip "traces" (tracer spans for the drain-safe transition) live far above
# the router's request-id range (1 << 40) so a flip span can never collide
# with a routed request's trace
_FLIP_TRACE_BASE = 1 << 41


@dataclass(frozen=True)
class AutoscalePolicy:
    """The rebalancer's knobs. Pressure is a pool's queued-plus-active
    demand normalized by its slot capacity (``fleet_signals``): 1.0 means
    the pool is exactly full with nothing waiting; the defaults ask for a
    2×-overloaded pool AND a mostly-idle donor before anything moves."""

    # fleet steps between policy evaluations (settle/fail-static checks run
    # every step regardless — convergence and freezing are not on a cadence)
    cadence_steps: int = 4
    # deadband: a pool is starved at/above scale_up, a donor at/below
    # scale_down; the gap between them is where oscillation dies
    scale_up_pressure: float = 2.0
    scale_down_pressure: float = 0.75
    # hysteresis: min fleet steps a replica holds a role (construction
    # counts), also the not-before window for reversing a flip's direction
    min_dwell_steps: int = 16
    # fleet steps after a flip starts/completes before the next decision
    cooldown_steps: int = 8
    # a donor pool must keep at least this many placeable replicas AFTER
    # donating — the rebalancer never empties a pool (that is the death
    # path's _rebalance_roles job, not a policy decision)
    min_pool_replicas: int = 1
    # fail-static: freeze when the signal rollup's fleet_step stamp is older
    # than this many steps
    stale_after_steps: int = 8

    def __post_init__(self):
        if self.scale_down_pressure >= self.scale_up_pressure:
            raise ValueError(
                "deadband inverted: scale_down_pressure "
                f"({self.scale_down_pressure}) must sit below "
                f"scale_up_pressure ({self.scale_up_pressure})"
            )
        if self.cadence_steps < 1 or self.min_dwell_steps < 1:
            raise ValueError("cadence_steps and min_dwell_steps must be >= 1")


def fleet_signals(router: Any) -> dict:
    """The default signal read: one live per-pool rollup straight off the
    fleet's own books (the same scheduler/cache counters ``load_score`` and
    ``fleet_rollup`` price). Pool pressure counts every request the pool is
    on the hook for: active slots, replica-queue waiting, and the router's
    pending buffer attributed by phase (a parked request awaiting handoff
    is decode demand, a re-homing one is prefill demand), normalized by the
    pool's slot capacity. Each pool also carries its cumulative shed count
    (``router.sheds_by_phase``): occupancy is an instantaneous sample that
    can look calm between steps while every burst arrival sheds, but a shed
    is unfakeable evidence the pool turned real traffic away — the
    rebalancer treats a nonzero shed delta as starvation in its own right.
    Stamped with ``fleet_step`` so the rebalancer's staleness check has
    something honest to compare against."""
    pending_prefill = sum(1 for rr in router._pending if rr.phase == "prefill")
    pending_decode = sum(1 for rr in router._pending if rr.phase == "decode")
    members: dict[str, list[EngineReplica]] = {}
    for replica in router.replicas:
        if replica.placeable:
            members.setdefault(replica.role, []).append(replica)
    pools = {}
    for role, pool in members.items():
        slots = sum(m.engine.cache.num_slots for m in pool)
        active = sum(len(m.engine.scheduler.active_slots) for m in pool)
        waiting = sum(m.engine.scheduler.waiting for m in pool)
        pending = 0
        if role in ("prefill", "mixed"):
            pending += pending_prefill
        if role in ("decode", "mixed"):
            pending += pending_decode
        paged = [
            m.engine.cache.page_occupancy
            for m in pool
            if getattr(m.engine, "paged", False)
        ]
        by_phase = getattr(router, "sheds_by_phase", {})
        sheds = 0
        if role in ("prefill", "mixed"):
            sheds += by_phase.get("prefill", 0)
        if role in ("decode", "mixed"):
            sheds += by_phase.get("decode", 0)
        pools[role] = {
            "replicas": len(pool),
            "slots": slots,
            "active": active,
            "waiting": waiting,
            "pending": pending,
            "slot_occupancy": round(active / max(slots, 1), 4),
            "page_occupancy": round(max(paged), 4) if paged else 0.0,
            "pressure": round((active + waiting + pending) / max(slots, 1), 4),
            "sheds": sheds,
        }
    out = {
        "fleet_step": router._steps,
        "stamp": time.perf_counter(),
        "router_sheds": router.router_sheds,
        "pools": pools,
    }
    # SLO burn rides along when a monitor is attached to the fleet's tracer
    # — reported in every autoscale record, so a flip's telemetry says what
    # the error budget looked like when the decision was made
    monitor = getattr(router.tracer, "slo", None) if router.tracer is not None else None
    if monitor is not None:
        snap = monitor.snapshot()
        rates = [v for k, v in snap.items() if k.endswith("_bad_rate")]
        out["slo_bad_rate"] = max(rates) if rates else None
    return out


class RoleRebalancer:
    """The closed control loop: signals in, at most one drain-safe role
    flip out, frozen solid when the signals cannot be trusted.

    Pass one to ``ServingRouter(autoscale=...)``; the router calls
    :meth:`on_fleet_step` once per fleet step (after replicas stepped,
    before the drain-completion sweep, so a flip completing this step is
    re-admitted before the sweep could mistake it for a finished drain).
    ``signal_reader`` defaults to :func:`fleet_signals`; tests and external
    telemetry stores substitute their own — a reader that raises or goes
    stale lands the rebalancer in fail-static, never in an exception that
    would take ``step()`` (and the fleet) down with it."""

    def __init__(
        self,
        policy: Optional[AutoscalePolicy] = None,
        signal_reader: Optional[Callable[[Any], dict]] = None,
        telemetry: Any = None,
        tracer: Any = None,
    ):
        self.policy = policy or AutoscalePolicy()
        self.signal_reader = signal_reader
        self.telemetry = telemetry
        self.tracer = tracer
        # counters (the router's metrics() folds these in as autoscale_*)
        self.flip_count = 0  # completed flips
        self.thrash_count = 0  # dwell-window reversals (policy invariant: 0)
        self.aborted_flips = 0  # donor died mid-flip
        self.fail_static = False
        self.fail_static_reason: Optional[str] = None
        self.fail_static_count = 0  # fail-static episodes entered
        self.evaluations = 0
        self.last_signals: Optional[dict] = None
        # hysteresis state
        self._inflight: Optional[dict] = None
        self._cooldown_until = 0
        self._role_since: dict[int, int] = {}  # replica index -> step of last flip
        self._direction_since: dict[tuple[str, str], int] = {}
        self._last_completed: Optional[tuple[str, str, int]] = None
        self._flip_seq = 0
        self._last_sheds = 0
        self._shed_delta = 0
        # cumulative per-pool shed counts at the last evaluation: the delta
        # between evaluations is the pool's shed RATE, the starvation signal
        # occupancy sampling cannot fake and cannot miss
        self._last_pool_sheds: dict[str, int] = {}
        self._pool_shed_delta: dict[str, int] = {}

    def attach(self, router: Any) -> None:
        """Router-construction hook: inherit the fleet's telemetry/tracer
        unless the caller wired dedicated ones."""
        if self.telemetry is None:
            self.telemetry = router.telemetry
        if self.tracer is None:
            self.tracer = router.tracer

    # -- the per-step hook ---------------------------------------------------

    def on_fleet_step(self, router: Any) -> None:
        """One control-loop tick. Never raises: a policy engine that can
        crash ``step()`` would be a new failure mode in the loop that
        exists to absorb failure modes."""
        step = router._steps
        self._settle(router, step)
        signals, outage = self._read_signals(router, step)
        if outage is not None:
            if not self.fail_static:
                self.fail_static = True
                self.fail_static_reason = outage
                self.fail_static_count += 1
                self._record(router, {"event": "fail_static", "reason": outage})
            return
        if self.fail_static:
            # signals recovered: unfreeze, but say so — an operator reading
            # the records must see both edges of the episode
            self._record(
                router,
                {"event": "fail_static_cleared", "was": self.fail_static_reason},
            )
            self.fail_static = False
            self.fail_static_reason = None
        self.last_signals = signals
        if self._inflight is not None:
            return  # one in-flight transition, fleet-wide
        if step % self.policy.cadence_steps != 0:
            return
        self.evaluations += 1
        self._shed_delta = router.router_sheds - self._last_sheds
        self._last_sheds = router.router_sheds
        self._pool_shed_delta = {}
        for role, pool in (signals.get("pools") or {}).items():
            total = int(pool.get("sheds", 0) or 0)
            self._pool_shed_delta[role] = total - self._last_pool_sheds.get(role, 0)
            self._last_pool_sheds[role] = total
        if step < self._cooldown_until:
            return
        decision = self._decide(router, signals, step)
        if decision is not None:
            self._begin_flip(router, decision, step)

    # -- signal trust --------------------------------------------------------

    def _read_signals(self, router, step: int):
        """(signals, None) when the read is healthy, (None, reason) when the
        fail-static rung must hold the current shape."""
        plan = router.chaos
        if plan is not None and plan.autoscale_outage(step):
            return None, "chaos: telemetry signal outage (autoscale_outage leg)"
        reader = self.signal_reader or fleet_signals
        try:
            signals = reader(router)
        except Exception as error:  # noqa: BLE001 - any read failure freezes
            return None, f"signal read failed: {type(error).__name__}: {error}"
        if not signals:
            return None, "signal reader returned no rollup"
        age = step - int(signals.get("fleet_step", step))
        if age > self.policy.stale_after_steps:
            return None, (
                f"stale rollup: {age} fleet steps old "
                f"(stale_after_steps={self.policy.stale_after_steps})"
            )
        return signals, None

    # -- the decision --------------------------------------------------------

    def _decide(self, router, signals: dict, step: int):
        """Pick (donor replica, target role), or None. Both deadband sides
        must hold at once, the donor pool must survive the donation, and
        every dwell gate must have expired."""
        if not router.disaggregated:
            # an all-mixed fleet has one pool: nothing to rebalance (and a
            # dense mixed fleet could not park KV for the flip's handoffs)
            return None
        policy = self.policy
        pools = {
            role: p for role, p in (signals.get("pools") or {}).items()
            if p.get("replicas", 0) > 0 and role in REPLICA_ROLES
        }
        if len(pools) < 2:
            return None
        # starvation is EITHER side of the demand ledger: occupancy pressure
        # over the threshold, or sheds since the last evaluation — a burst
        # can shed every arrival while the end-of-step occupancy sample
        # looks calm, but a shed is demand the pool provably turned away
        starved_role, starved_score = None, -1.0
        for role, pool in pools.items():
            sheds = self._pool_shed_delta.get(role, 0)
            if pool["pressure"] < policy.scale_up_pressure and sheds <= 0:
                continue
            score = pool["pressure"] + sheds / max(pool.get("slots", 1) or 1, 1)
            if score > starved_score:
                starved_role, starved_score = role, score
        if starved_role is None:
            return None
        donor_role, donor_pressure = None, float("inf")
        for role, pool in pools.items():
            if role == starved_role:
                continue
            if (
                pool["pressure"] <= policy.scale_down_pressure
                and self._pool_shed_delta.get(role, 0) <= 0
                and pool["replicas"] > policy.min_pool_replicas
                and pool["pressure"] < donor_pressure
            ):
                donor_role, donor_pressure = role, pool["pressure"]
        if donor_role is None:
            return None
        # direction dwell: the reverse of a recent flip is structurally
        # blocked — an oscillating signal cannot see-saw replicas
        reverse_at = self._direction_since.get((starved_role, donor_role))
        if reverse_at is not None and step - reverse_at < policy.min_dwell_steps:
            return None
        # the never-empty-a-pool guard runs against the FLEET'S own books,
        # not the reader's claimed replica count — a stale or lying signal
        # source must not be able to drain a pool's last member
        donor_pool_live = [
            r for r in router.replicas if r.role == donor_role and r.placeable
        ]
        if len(donor_pool_live) <= policy.min_pool_replicas:
            return None
        candidates = [
            r for r in donor_pool_live
            if r.state is ReplicaState.HEALTHY
            and step - self._role_since.get(r.index, 0) >= policy.min_dwell_steps
        ]
        if not candidates:
            return None
        donor = min(candidates, key=lambda r: (r.load_score(), r.index))
        return donor, starved_role

    # -- the transition ------------------------------------------------------

    def _begin_flip(self, router, decision, step: int) -> None:
        donor, target = decision
        source_role = donor.role
        flip = self._flip_seq
        self._flip_seq += 1
        prev = self._last_completed
        if (
            prev is not None
            and prev[0] == target
            and prev[1] == source_role
            and step - prev[2] <= 2 * self.policy.min_dwell_steps
        ):
            # should be unreachable under the direction dwell — counted
            # anyway so the bench can assert the invariant, not assume it
            self.thrash_count += 1
        self._inflight = {
            "replica": donor.index,
            "from": source_role,
            "to": target,
            "step": step,
            "flip": flip,
            "t0": time.perf_counter(),
        }
        self._direction_since[(source_role, target)] = step
        self._cooldown_until = step + self.policy.cooldown_steps
        if self.tracer is not None:
            key = _FLIP_TRACE_BASE + flip
            self.tracer.begin(key, kind="autoscale_flip", flip=flip)
            self.tracer.span_start(
                key, "role_flip", replica=donor.engine.name,
                src_role=source_role, dst_role=target,
            )
        self._record(
            router,
            {"event": "flip_started", "replica": donor.index, "from": source_role,
             "to": target, "flip": flip, "shed_delta": self._shed_delta,
             "pools": (self.last_signals or {}).get("pools")},
        )
        # the drain-safe core: placement stops, the queue re-homes through
        # _rehome_drained, active slots finish, parked KV relays — all via
        # the machinery drains already drill
        donor.start_drain(f"autoscale flip {source_role}->{target}")
        plan = router.chaos
        if plan is not None and plan.rebalance_fail(flip, valid=lambda _i: donor.alive):
            router._on_replica_death(donor, "chaos: replica killed mid role-flip")
        self._settle(router, step)  # an idle donor completes immediately

    def _settle(self, router, step: int) -> None:
        """Converge the in-flight flip: abort it if the donor died, complete
        it once the donor drained empty, otherwise leave it draining."""
        flight = self._inflight
        if flight is None:
            return
        donor = router.replicas[flight["replica"]]
        key = _FLIP_TRACE_BASE + flight["flip"]
        if not donor.alive:
            self.aborted_flips += 1
            self._inflight = None
            if self.tracer is not None:
                self.tracer.span_end(
                    key, "role_flip", outcome="aborted", error=donor.death_reason
                )
                self.tracer.retire(key, "flip_aborted", observe_slo=False)
            self._record(
                router,
                {"event": "flip_aborted", "replica": flight["replica"],
                 "from": flight["from"], "to": flight["to"], "flip": flight["flip"],
                 "reason": donor.death_reason or "replica lost mid-flip"},
            )
            return
        if (
            donor.state is ReplicaState.DRAINING
            and not donor.engine.busy
            and not getattr(donor.engine, "parked_count", 0)
        ):
            donor.finish_flip(flight["to"])
            self.flip_count += 1
            self._role_since[donor.index] = step
            self._last_completed = (flight["from"], flight["to"], step)
            self._cooldown_until = step + self.policy.cooldown_steps
            elapsed = time.perf_counter() - flight["t0"]
            if self.tracer is not None:
                self.tracer.span_end(key, "role_flip", outcome="completed")
                self.tracer.retire(key, "flip_completed", observe_slo=False)
            self._record(
                router,
                {"event": "flip_completed", "replica": donor.index,
                 "from": flight["from"], "to": flight["to"], "flip": flight["flip"],
                 "steps": step - flight["step"], "seconds": elapsed},
            )
            self._inflight = None

    # -- observability -------------------------------------------------------

    def _record(self, router, payload: dict) -> None:
        if self.telemetry is not None:
            self.telemetry.write_record(
                "autoscale", {"fleet_step": router._steps, **payload}
            )

    def snapshot(self) -> dict:
        """The gain fields ``router.metrics()`` adds when a rebalancer is
        attached (and ONLY then — a fleet without one keeps today's schema
        byte-identical)."""
        return {
            "autoscale_flip_count": self.flip_count,
            "autoscale_thrash_count": self.thrash_count,
            "autoscale_aborted_flips": self.aborted_flips,
            "autoscale_fail_static": self.fail_static,
            "autoscale_fail_static_count": self.fail_static_count,
            "autoscale_fail_static_reason": self.fail_static_reason,
            "autoscale_inflight_flip": (
                self._inflight["replica"] if self._inflight is not None else None
            ),
            "autoscale_evaluations": self.evaluations,
        }


__all__ = ["AutoscalePolicy", "RoleRebalancer", "fleet_signals"]
