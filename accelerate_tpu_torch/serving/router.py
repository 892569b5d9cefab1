"""Health-aware router over N serving-engine replicas.

Counterpart of ``accelerate_tpu/serving/router.py``. The
:class:`ServingRouter` fronts N :class:`~.engine.ServingEngine` replicas
behind the engine's own ``submit / cancel / step / run / generate_many``
surface:

- **placement** is load-aware: each submit goes to the placeable replica
  (HEALTHY first, then DEGRADED) with the lowest load score, queue depth
  plus occupied slots plus page occupancy from the replica's own books;
- **failover**: every in-flight request is mirrored in the router's own
  books (id -> prompt and parameters), so when a replica dies (its step
  raised, a chaos kill, heartbeat silence) its requests re-submit to a
  survivor from the router's copy, never from the dead engine's memory.
  Recovery re-prefills from the prompt: at temperature 0 the tokens are
  the same, and no token was delivered twice;
- **backpressure**: a full replica spills to the others, and only when
  every placeable replica is full does the router shed, quoting the least
  ``retry_after_s`` of the fleet;
- **degradation** stays per engine (shed, deadline, quarantine), and the
  health state machine (:mod:`~.fleet`) folds its events into placement.

**Disaggregated pools** (``roles=``): replicas are ``prefill``, ``decode``
or ``mixed`` (the default, the replicated fleet above). A new request
prefills on a prefill replica with ``prefill_only=True``, which parks the
finished KV, and the router then hands the live pages to a decode replica
(:meth:`ServingRouter._kv_handoff`): ``kv_page_layout`` names the pages,
``parallel.redistribute.paged_transfer`` moves their blocks through the
source's ``extract_pages`` (to the host) and the destination's ``adopt_kv``
(to its pool). The handoff is a transaction: the source keeps its pages
until the destination adopted them token-exact, and a failed attempt
(timeout, ``HandoffLost``, the source dying) retries under
:data:`~..resilience.retry.HANDOFF_RETRY`, one attempt a router step, and
then falls back to re-prefill on the decode pool (a parked request has
delivered no token, so nothing is duplicated or lost). When a pool's last
replica dies or drains, the other pool's replicas turn ``mixed``.

Engines built over one model share its weights (``ServingEngine`` keeps
no copy): a fleet of N such replicas holds one copy of the weights and N
KV pools.

The router writes its own records through ``telemetry=`` (any object with
``enabled`` and ``write_record(kind, payload)``): ``fleet``,
``redistribute``, ``trace``, ``slo`` and ``autoscale``, and hands the sink
to every engine that has none (its ``kernels``, ``resilience`` and
``speculative`` records). Program analysis (``analyze``) comes with ROADMAP
item 21.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from ..telemetry.serving import fleet_rollup
from .engine import ServingEngine, ServingResult, generation_row
from .fleet import EngineReplica, HandoffLost, HealthPolicy, ReplicaLost, ReplicaState
from .scheduler import QueueFull

# Router request ids live far above any engine-internal id (engine schedulers
# count from 0 for their own synthetic requests — warmup probes, chaos
# bursts), so a routed id can never collide with one and the router can trust
# `result.request_id in self._inflight` as "this is mine".
_ROUTER_ID_BASE = 1 << 40


@dataclass
class RoutedRequest:
    """The router's own copy of one in-flight request — the failover source
    of truth. Deliberately payload-only (no generated tokens): re-homing
    restarts from the prompt, so this record is sufficient whether the
    source replica drained gracefully or vanished mid-decode."""

    id: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline_s: Optional[float]
    submitted_at: float
    replica: Optional[int] = None  # index hosting it; None = router-pending
    last_replica: Optional[int] = None  # previous host
    # which capability the NEXT placement needs: "prefill" until the prompt's
    # KV exists somewhere, "decode" once a prefill-pool replica parked it
    # (or a fallback re-prefill is heading for the decode pool)
    phase: str = "prefill"
    # replica index holding this request's PARKED live KV (refcounted there
    # until the handoff acks or falls back); None = nothing to relay
    kv_source: Optional[int] = None
    # handoff retry state: failed attempts so far, and the jittered-backoff
    # stamp before which the router must NOT retry — the backoff is a time
    # GATE on the per-step re-offer, never an in-step sleep (a sleep inside
    # step() would stall decode on every replica fleet-wide)
    handoff_attempts: int = 0
    handoff_retry_at: Optional[float] = None
    failovers: int = 0
    cancelled: bool = False

    @property
    def deadline_at(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.submitted_at + self.deadline_s


class ServingRouter:
    """N engine replicas behind the single-engine serving surface."""

    def __init__(
        self,
        engines: Optional[Sequence[ServingEngine]] = None,
        *,
        engine_factory: Optional[Any] = None,
        num_replicas: Optional[int] = None,
        roles: Optional[Sequence[str]] = None,
        health: Optional[HealthPolicy] = None,
        telemetry: Any = None,
        tracer: Any = None,
        fault_plan: Any = None,
        max_failovers: int = 2,
        handoff_timeout_s: Optional[float] = 5.0,
        handoff_retry: Any = None,
        autoscale: Any = None,
    ):
        if engines is None:
            if engine_factory is None or num_replicas is None:
                raise ValueError(
                    "pass engines=, or engine_factory= with num_replicas="
                )
            engines = [engine_factory() for _ in range(num_replicas)]
        elif not engines:
            raise ValueError("a router needs at least one replica")
        self.engine_factory = engine_factory
        self.telemetry = telemetry
        if fault_plan is None:
            from ..resilience import chaos as _chaos_mod

            fault_plan = _chaos_mod.active_plan()
        self.chaos = fault_plan
        self.max_failovers = max_failovers
        if roles is None:
            roles = ["mixed"] * len(engines)
        elif len(roles) != len(engines):
            raise ValueError(
                f"roles= names {len(roles)} replicas but the fleet has {len(engines)}"
            )
        # ONE tracer across the fleet (telemetry/tracing.py): spans key by
        # the fleet-unique request id, so a request prefilled on one pool
        # and decoded on another keeps a single trace — the router adds the
        # handoff_attempt spans, the engines everything else
        self.tracer = tracer
        self.replicas = []
        for i, engine in enumerate(engines):
            if engine.name is None:
                engine.name = f"replica{i}"
            if engine.telemetry is None and telemetry is not None:
                engine.telemetry = telemetry
            if engine.tracer is None and tracer is not None:
                engine.tracer = tracer
            self.replicas.append(
                EngineReplica(
                    i, engine, policy=health, on_transition=self._on_transition,
                    role=roles[i],
                )
            )
        # disaggregated = any non-mixed role was CONFIGURED; pool-loss
        # degradation may later demote survivors to mixed, but the fleet
        # stays "disaggregated" in the sense that matters (handoff machinery
        # armed, per-pool telemetry labeled)
        self.disaggregated = any(r.role != "mixed" for r in self.replicas)
        if self.disaggregated:
            if not any(r.serves_prefill for r in self.replicas) or not any(
                r.serves_decode for r in self.replicas
            ):
                raise ValueError(
                    "disaggregated roles need at least one prefill-capable and "
                    "one decode-capable replica (mixed counts as both)"
                )
            dense = [i for i, r in enumerate(self.replicas) if not r.engine.paged]
            if dense:
                raise ValueError(
                    f"disaggregated serving relays page-granular KV — replicas "
                    f"{dense} run the dense slab (paged=False) and cannot hand off"
                )
        if handoff_retry is None:
            from ..resilience.retry import HANDOFF_RETRY

            handoff_retry = HANDOFF_RETRY
        self.handoff_retry = handoff_retry
        self.handoff_timeout_s = handoff_timeout_s
        self._ids = itertools.count(_ROUTER_ID_BASE)
        self._inflight: dict[int, RoutedRequest] = {}
        self._pending: list[RoutedRequest] = []  # awaiting (re-)placement
        self._retired: list[ServingResult] = []  # terminal results made HERE
        self._drain_moved: dict[int, int] = {}  # re-home counts per drain
        self._steps = 0
        # policy-driven pool autoscaling (serving/autoscale.py): stepped once
        # per fleet step; None (the default) keeps the fleet's shape fixed —
        # and its telemetry/metrics schema byte-identical to a fleet from
        # before the rebalancer existed
        self.autoscale = autoscale
        if autoscale is not None:
            autoscale.attach(self)
        # fleet counters (the rollup adds per-engine sums on top)
        self.router_sheds = 0
        self.router_deadline_sheds = 0  # early-shed: wait exceeds deadline budget
        # sheds attributed to the phase whose pool turned the request away —
        # the autoscaler's "traffic you cannot serve" signal (fleet_signals):
        # an instantaneous occupancy sample can look calm between steps while
        # every burst arrival sheds, but a shed is unfakeable demand
        self.sheds_by_phase = {"prefill": 0, "decode": 0}
        self.failovers = 0
        self.failed_failovers = 0
        self.rehomed = 0
        self.replica_deaths = 0
        self.kv_handoffs = 0  # adopted live-KV handoffs (per-replica economy
        # counters live on the engines' ServingStats; this is the router view)
        self._handoff_attempt_seq = 0  # fleet-wide attempt index (chaos hooks)
        self.placements = [0] * len(self.replicas)

    # -- the single-engine surface ------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        submitted_at: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> int:
        """Place one request on the least-loaded placeable replica; returns
        the (fleet-unique) request id. Raises ``ValueError`` for requests no
        replica can ever serve, :class:`ReplicaLost` when the whole fleet is
        down, and :class:`QueueFull` — with the fleet-minimum
        ``retry_after_s`` — only when *every* placeable replica is full."""
        rr = RoutedRequest(
            id=next(self._ids),
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            deadline_s=deadline_s,
            submitted_at=submitted_at if submitted_at is not None else time.perf_counter(),
        )
        candidates = self._placement_order("prefill")
        if not candidates:
            alive = [r for r in self.replicas if r.alive]
            if not alive:
                raise ReplicaLost("no live replicas — the fleet is down")
            # same shed as the all-full branch below — counted, recorded,
            # and priced the same way. The quote must NOT use a draining
            # replica's optimistic per-position hint: its freed queue
            # positions are not admissible (nothing lands there until the
            # drain — or role flip — completes), so _quoted_hint prices
            # draining replicas at their full drain ETA instead.
            self.router_sheds += 1
            self.sheds_by_phase["prefill"] += 1
            hint = self._quoted_hint(alive)
            depth = sum(r.engine.scheduler.waiting for r in alive)
            self._fleet_record(
                {"event": "shed", "reason": "no_placeable", "queue_depth": depth,
                 "retry_after_s": hint}
            )
            raise QueueFull(
                "no placeable replicas (all draining/recovering)",
                queue_depth=depth,
                retry_after_s=hint,
            )
        # deadline-aware admission: a request whose estimated queue wait
        # already exceeds its remaining deadline budget would be admitted,
        # burn a prefill, and expire — wasted work that steepens the
        # overload spiral. The gate only fires where the request would
        # actually wait (a backlogged replica): an idle replica serves
        # immediately, whatever the hint formula says.
        remaining = None
        if rr.deadline_at is not None:
            remaining = rr.deadline_at - time.perf_counter()
        admissible = 0
        deadline_skipped = 0
        for replica in candidates:
            if not replica.engine.queue_available:
                continue
            admissible += 1
            if (
                remaining is not None
                and replica.engine.scheduler.waiting > 0
                and replica.engine.retry_after_hint() > remaining
            ):
                deadline_skipped += 1
                continue
            # ValueError (prompt the fleet can never serve) propagates —
            # every replica shares one shape config, so the first verdict
            # is the fleet's verdict. A prefill-POOL replica runs the
            # prompt's prefill and parks the KV for handoff; a mixed
            # replica serves the request end to end (the baseline path).
            replica.engine.submit(
                rr.prompt,
                rr.max_new_tokens,
                request_id=rr.id,
                submitted_at=rr.submitted_at,
                deadline_s=rr.deadline_s,
                prefill_only=replica.role == "prefill",
            )
            rr.replica = replica.index
            replica.touch()  # placement resets the idle heartbeat clock
            self.placements[replica.index] += 1
            self._inflight[rr.id] = rr
            return rr.id
        self.router_sheds += 1
        self.sheds_by_phase["prefill"] += 1
        hint = min(r.engine.retry_after_hint() for r in candidates)
        depth = sum(r.engine.scheduler.waiting for r in candidates)
        if admissible and deadline_skipped == admissible:
            # every replica that COULD queue this request would hold it past
            # its deadline: shed now, before a prefill is burned. Priced
            # separately — an operator must be able to tell capacity sheds
            # from deadline sheds, they call for different fixes.
            self.router_deadline_sheds += 1
            self._fleet_record(
                {"event": "shed", "reason": "deadline", "queue_depth": depth,
                 "retry_after_s": hint, "deadline_s": rr.deadline_s,
                 "remaining_s": remaining}
            )
            raise QueueFull(
                f"deadline-aware admission: the soonest queue position "
                f"(~{hint:.3f}s) exceeds the request's remaining deadline "
                f"budget ({remaining:.3f}s)",
                queue_depth=depth,
                retry_after_s=hint,
            )
        # every placeable replica is full: the router-level shed, priced at
        # the soonest any replica expects to free a queue position
        self._fleet_record(
            {"event": "shed", "queue_depth": depth, "retry_after_s": hint}
        )
        raise QueueFull(
            f"all {len(candidates)} placeable replicas are full — retry in ~{hint:.3f}s",
            queue_depth=depth,
            retry_after_s=hint,
        )

    def _quoted_hint(self, replicas: Sequence[EngineReplica]) -> float:
        """The shed quote: minimum expected wait across ``replicas``, with
        DRAINING replicas priced at their full drain ETA
        (:meth:`~.engine.ServingEngine.drain_eta_hint`) rather than the
        optimistic one-queue-position ``retry_after_hint`` — a draining
        replica admits nothing until it finishes, so quoting its
        per-position hint under-quotes the wait during exactly the
        transitions a drain or an autoscale role flip creates. DEAD
        replicas never reach here (callers pass alive sets)."""
        hints = []
        for r in replicas:
            if r.state is ReplicaState.DRAINING or r.engine.draining:
                hints.append(r.engine.drain_eta_hint())
            else:
                hints.append(r.engine.retry_after_hint())
        return min(hints)

    def cancel(self, request_id: int) -> bool:
        """Fleet-wide cancellation: wherever the request lives — a replica's
        queue or slots, or the router's own pending buffer — it terminates
        as ``cancelled``. Same promise as the engine's: a ``True`` is never
        contradicted by a different terminal reason."""
        rr = self._inflight.get(request_id)
        if rr is None:
            return False
        # the router's own copy is marked FIRST: if the hosting replica dies
        # after the ack but before retiring the request, the re-home path
        # must see the cancellation — not resurrect the request on a
        # survivor and contradict this True with a "length" result
        rr.cancelled = True
        if rr.replica is None:
            return True
        replica = self.replicas[rr.replica]
        if replica.alive and replica.engine.cancel(request_id):
            return True
        # the hosting replica died between bookkeeping updates: retire the
        # router's copy through the pending sweep (which emits the
        # "cancelled" terminal result next step)
        rr.replica = None
        self._pending.append(rr)
        return True

    def step(self) -> list[ServingResult]:
        """One fleet iteration: inject chaos, re-offer pending (failed-over)
        requests, step every live replica, fold their health observations,
        sweep heartbeats, and finish drains. Returns every request that
        reached a terminal state this step, whichever replica (or the router
        itself) retired it."""
        stall = self._inject_chaos()
        # heartbeat sweep BEFORE stepping: an unreachable replica must not
        # get one more decode out of the router after its probe went silent
        for replica in self.replicas:
            if replica.alive and not replica.heartbeat():
                self._on_replica_death(replica, "heartbeat lost")
        results: list[ServingResult] = []
        if self._retired:
            results.extend(self._retired)
            self._retired.clear()
        self._offer_pending(results)
        for replica in self.replicas:
            engine = replica.engine
            if not replica.alive or not (engine.busy or engine.cache.quarantined):
                continue
            if stall is not None and replica.index == stall[0]:
                # the straggler drill: the stall rides immediately before
                # THIS replica's decode (every other replica steps at full
                # speed this iteration, and the target still heartbeats —
                # it makes progress right after, just late)
                time.sleep(stall[1])
            try:
                step_results = engine.step()
            except Exception as error:  # noqa: BLE001 - any step failure is a death
                self._on_replica_death(replica, f"step raised {type(error).__name__}: {error}")
                continue
            replica.observe_step()
            for result in step_results:
                rr = self._inflight.get(result.request_id)
                if result.finish_reason == "prefilled" and rr is not None:
                    # NOT terminal to the fleet: the prefill pool parked this
                    # request's live KV. Queue the handoff — next step's
                    # re-offer relays the pages to a decode replica (or falls
                    # back to re-prefill there). The caller never sees a
                    # "prefilled" result, so offered==terminated accounting
                    # holds unchanged under disaggregation.
                    rr.phase = "decode"
                    rr.kv_source = replica.index
                    rr.last_replica, rr.replica = rr.replica, None
                    self._pending.append(rr)
                    continue
                self._inflight.pop(result.request_id, None)
                results.append(result)
        # autoscale hook BEFORE the drained sweep: a replica draining for a
        # role flip that just ran empty must be flipped back to placement by
        # the rebalancer's settle pass — the sweep below would otherwise read
        # it as an ordinary finished drain and mark it DEAD
        if self.autoscale is not None:
            self.autoscale.on_fleet_step(self)
        for replica in self.replicas:
            if (
                replica.state is ReplicaState.DRAINING
                and not replica.engine.busy
                and not getattr(replica.engine, "parked_count", 0)
            ):
                # parked KV pins the drain open: the replica's pages must
                # stay readable until every pending handoff acks or falls
                # back — only then is the drain complete
                replica.mark_dead("drained")
                self._fleet_record({"event": "drained", "replica": replica.index})
        self._steps += 1
        return results

    @property
    def busy(self) -> bool:
        return bool(
            self._pending
            or self._retired
            or any(r.alive and r.engine.busy for r in self.replicas)
        )

    def run(self) -> dict[int, ServingResult]:
        """Drive ``step()`` until the whole fleet drains; results by id."""
        results: dict[int, ServingResult] = {}
        while self.busy:
            for result in self.step():
                results[result.request_id] = result
        return results

    def generate_many(
        self, prompts: Sequence[np.ndarray], max_new_tokens: int = 32
    ) -> list[np.ndarray]:
        """Blocking batch API with the engine's exact output contract — at
        temperature 0 a routed fleet is bit-identical to one engine, whatever
        the placement happened to be. A request the fleet could not complete
        (failover budget exhausted, every replica lost) raises rather than
        returning a fabricated row."""
        eos = self.replicas[0].engine.eos_token_id
        ids = [self.submit(p, max_new_tokens) for p in prompts]
        results = self.run()
        return [
            generation_row(p, results[rid], max_new_tokens, eos)
            for p, rid in zip(prompts, ids)
        ]

    def warmup(self) -> None:
        """Warm every live replica up (``ServingEngine.warmup``): the kernels
        build once per process, and each replica touches every prefill span
        and its decode before traffic arrives, so no first step outlasts a
        health clock."""
        for replica in self.replicas:
            if replica.alive:
                replica.engine.warmup()

    # -- placement -----------------------------------------------------------

    def _placement_order(self, phase: Optional[str] = None) -> list[EngineReplica]:
        """Placeable replicas serving ``phase`` (``"prefill"`` /
        ``"decode"`` / None = any), healthiest-then-least-loaded first.
        Mixed replicas serve both phases, so an all-mixed fleet behaves
        exactly as before roles existed."""
        if phase == "prefill":
            serves = lambda r: r.serves_prefill  # noqa: E731
        elif phase == "decode":
            serves = lambda r: r.serves_decode  # noqa: E731
        else:
            serves = lambda r: True  # noqa: E731
        return sorted(
            (r for r in self.replicas if r.placeable and serves(r)),
            key=lambda r: (r.state is not ReplicaState.HEALTHY, r.load_score(), r.index),
        )

    def _offer_pending(self, results: list[ServingResult]) -> None:
        """Re-offer router-pending (failed-over / drained-out) requests.
        Placement failures are classified like any fleet weather: transient
        (queue full) keeps the request pending for the next step, fatal
        (malformed) terminates it — a bad request must not bounce around the
        fleet forever."""
        from ..resilience.retry import is_fleet_transient

        if not self._pending:
            return
        still_pending: list[RoutedRequest] = []
        now = time.perf_counter()
        for rr in self._pending:
            if rr.cancelled:
                self._drop_parked(rr)  # the parked pages must not strand
                self._inflight.pop(rr.id, None)
                results.append(self._terminal(rr, "cancelled", now))
                continue
            if rr.deadline_at is not None and now >= rr.deadline_at:
                self._drop_parked(rr)
                self._inflight.pop(rr.id, None)
                results.append(self._terminal(rr, "expired", now))
                continue
            settled = False  # placed on a replica, or terminally failed
            # the live-KV source: a prefill-pool replica holding this
            # request's parked pages. A dead source's memory is gone
            # (SIGKILL semantics — _on_replica_death already recorded the
            # fallback); re-prefill is then the path.
            src = (
                self.replicas[rr.kv_source]
                if rr.kv_source is not None
                else None
            )
            if src is not None and not src.alive:
                src, rr.kv_source = None, None
            if (
                src is not None
                and rr.handoff_retry_at is not None
                and now < rr.handoff_retry_at
            ):
                # inside the jittered retry backoff: the parked KV waits it
                # out while the fleet decodes — neither retrying early nor
                # falling through to a premature re-prefill
                still_pending.append(rr)
                continue
            for replica in self._placement_order(rr.phase):
                # the handoff: relay the parked fixed-shape pages to this
                # decode-capable replica; on success the DESTINATION now
                # schedules the request (adopt_kv seated it), so placement
                # is done. A False either means the transfer fell back
                # (parked pages released, kv_source cleared — the submit
                # below re-prefills HERE, on the decode pool) or nothing
                # was parked (plain failover re-home).
                if src is not None and self._kv_handoff(src, replica, rr):
                    settled = True
                    break
                if src is not None and rr.kv_source is not None:
                    if rr.handoff_retry_at is not None and now < rr.handoff_retry_at:
                        # the attempt FAILED and scheduled its jittered
                        # backoff: stop probing destinations this step — an
                        # immediate try against the next replica would burn
                        # the whole retry budget in one step with zero
                        # backoff, exactly when the transfer path is sick
                        break
                    # deferred: the parked KV is intact and this destination
                    # is saturated — try the next one, and NEVER queue a
                    # re-prefill while the pages wait (that would race two
                    # copies of the request through two scheduling paths)
                    continue
                if src is not None:
                    src = None  # fell back: re-prefill takes over below
                if not replica.engine.queue_available:
                    continue
                try:
                    replica.engine.submit(
                        rr.prompt,
                        rr.max_new_tokens,
                        request_id=rr.id,
                        submitted_at=rr.submitted_at,
                        deadline_s=rr.deadline_s,
                        # a re-homed not-yet-prefilled request re-enters the
                        # prefill pool's park-and-handoff path; a post-park
                        # fallback re-prefills to COMPLETION wherever it lands
                        prefill_only=rr.phase == "prefill" and replica.role == "prefill",
                    )
                except Exception as error:  # noqa: BLE001 - classifier decides
                    if is_fleet_transient(error):
                        continue
                    self._inflight.pop(rr.id, None)
                    results.append(self._terminal(rr, "failed", now))
                    settled = True
                    break
                rr.replica = replica.index
                replica.touch()  # placement resets the idle heartbeat clock
                self.placements[replica.index] += 1
                self.rehomed += 1
                self._fleet_record(
                    {"event": "rehome", "request_id": rr.id, "replica": replica.index,
                     "phase": rr.phase, "failovers": rr.failovers}
                )
                settled = True
                break
            if (
                not settled
                and rr.kv_source is not None
                and not self._placement_order(rr.phase)
            ):
                # no placeable destination exists at all (e.g. the decode
                # pool died while the source was DRAINING — promotion only
                # covers placeable survivors): finish the request on its own
                # source, like any active slot a drain lets run to
                # completion. Without this, the drain waits on the handoff
                # and the handoff waits on a destination that can never
                # exist — a livelock that would spin run() forever.
                parked_src = self.replicas[rr.kv_source]
                if parked_src.alive and self._kv_handoff(parked_src, parked_src, rr):
                    settled = True
            if not settled:
                if not any(r.alive for r in self.replicas):
                    # nobody left to ever take it: terminate, don't strand
                    self._drop_parked(rr)
                    self._inflight.pop(rr.id, None)
                    results.append(self._terminal(rr, "failed", now))
                else:
                    still_pending.append(rr)
        self._pending = still_pending

    # -- failure handling ----------------------------------------------------

    def _inject_chaos(self) -> Optional[tuple[int, float]]:
        """Fire this fleet step's chaos. Returns the (replica, seconds)
        stall, if any — applied in the stepping loop so only the TARGET
        replica's decode is late, not the whole fleet's."""
        if self.chaos is None:
            return None
        # validity gates the plan's own ledger: a mistargeted fault (index
        # out of range, replica already dead) must not be recorded as fired
        alive = lambda i: 0 <= i < len(self.replicas) and self.replicas[i].alive
        in_fleet = lambda i: 0 <= i < len(self.replicas)
        stall = self.chaos.replica_stall(self._steps, valid=alive)
        lost = self.chaos.heartbeat_loss(self._steps, valid=in_fleet)
        if lost is not None:
            self.replicas[lost].heartbeat_lost = True
        kill = self.chaos.replica_kill(self._steps, valid=alive)
        if kill is not None:
            self._on_replica_death(self.replicas[kill], "chaos replica-kill")
        return stall

    def _on_replica_death(self, replica: EngineReplica, reason: str) -> None:
        """A replica is gone (SIGKILL semantics). Re-home every request the
        router placed there from the router's OWN bookkeeping — the dead
        engine's queue and KV cache no longer exist, so re-prefill from the
        prompt is the only correct recovery (and the capped-failover budget
        keeps a poison request from killing the whole fleet one replica at
        a time)."""
        replica.mark_dead(reason)
        self.replica_deaths += 1
        orphans = [rr for rr in self._inflight.values() if rr.replica == replica.index]
        self._fleet_record(
            {"event": "replica_death", "replica": replica.index, "reason": reason,
             "orphaned": len(orphans)}
        )
        # parked KV died with the process: every pending handoff sourced
        # here can never complete — record the fallback now (the re-offer
        # loop re-prefills those requests on the decode pool)
        for rr in self._inflight.values():
            if rr.kv_source == replica.index:
                rr.kv_source = None
                if self.tracer is not None:
                    # the parked span's pages died with the process — the
                    # engine-side release that would close it can never run
                    self.tracer.span_end(
                        rr.id, "parked", stats=replica.engine.stats,
                        outcome="fell_back",
                    )
                replica.engine.stats.record_handoff_fallback()
                self._fleet_record(
                    {"event": "kv_handoff", "outcome": "fell_back",
                     "request_id": rr.id, "src": replica.index, "dst": None,
                     "error": "source replica died with KV parked"}
                )
        now = time.perf_counter()
        for rr in orphans:
            if self.tracer is not None:
                # whatever spans were running on the dead replica ended with
                # it; the survivor that re-homes the request opens fresh ones
                self.tracer.interrupt(rr.id, stamp=now, outcome="replica_death")
            rr.last_replica, rr.replica = rr.replica, None
            if rr.cancelled:
                # the client already gave up on it: terminate as cancelled
                # instead of spending a failover on a request nobody wants
                self._inflight.pop(rr.id, None)
                self._retired.append(self._terminal(rr, "cancelled", now))
                continue
            rr.failovers += 1
            if rr.failovers > self.max_failovers:
                self.failed_failovers += 1
                self._inflight.pop(rr.id, None)
                self._retired.append(self._terminal(rr, "failed", now))
            else:
                self.failovers += 1
                self._pending.append(rr)
        self._rebalance_roles()

    def _rebalance_roles(self) -> None:
        """Pool-loss degradation: when the LAST prefill-capable replica dies
        or drains, the decode pool's survivors are promoted to ``mixed`` (and
        symmetrically for a lost decode pool) — the fleet keeps serving,
        slower, instead of shedding every new request against a pool that no
        longer exists. Promotion is one-way: a revived replica rejoins with
        its configured role, but survivors stay mixed until an operator
        re-partitions — flapping roles on every health transition would
        thrash placement for no capacity gain."""
        if not self.disaggregated:
            return
        for lost, survivor_role, serves in (
            ("prefill", "decode", lambda r: r.serves_prefill),
            ("decode", "prefill", lambda r: r.serves_decode),
        ):
            if any(r.placeable and serves(r) for r in self.replicas):
                continue
            promoted = [
                r for r in self.replicas if r.placeable and r.role == survivor_role
            ]
            for r in promoted:
                r.role = "mixed"
            if promoted:
                self._fleet_record(
                    {"event": "pool_degraded", "pool": lost,
                     "promoted": [r.index for r in promoted],
                     "detail": f"no placeable {lost}-capable replica — the "
                               f"{survivor_role} pool now serves mixed"}
                )

    def _kv_handoff(self, src: EngineReplica, dst: EngineReplica, rr: RoutedRequest) -> bool:
        """Live-KV migration between pools: relay ``rr``'s parked pages from
        ``src`` into ``dst``'s pool and hand over scheduling. A request's
        cache slice is an array-redistribution problem (arXiv:2112.01075 —
        move fixed blocks, never materialize the full buffer):
        :meth:`~.engine.ServingEngine.kv_page_layout` names exactly which
        physical pages hold the live KV, in what order, with how many valid
        positions, so the transfer is ``len(pages)`` fixed-shape block reads
        (``extract_pages``, one gather and one device-to-host copy a pool)
        and writes (``adopt_kv``, one host-to-device copy a pool).

        The TRANSACTION: the source's pages stay refcounted (parked) until
        ``adopt_kv`` returns having verified token-exact adoption — only
        then does the ack (``release_parked``) drop them. An attempt that
        stalls past ``handoff_timeout_s``, raises, or loses its source
        mid-transfer is retried under the jittered ``handoff_retry`` policy
        — ONE attempt per router step, the policy's jittered delay becoming
        a not-before gate (``rr.handoff_retry_at``) on the next step's
        re-offer rather than an in-step sleep: a sleep here would stall
        decode on EVERY replica for the duration (step() is single-threaded
        and this runs before the stepping loop), turning one flaky transfer
        into a fleet-wide inter-token latency spike. When the budget is
        spent (or the failure is fatal — incompatible pool geometry) the
        parked pages are released and this returns False with
        ``rr.kv_source`` cleared, which tells the caller to re-prefill on
        the decode pool: never a token delivered twice (a parked request
        has delivered none), never a request stranded (re-prefill needs
        only the prompt, which the router holds). Returns True when ``dst``
        adopted — the destination is now scheduling the request.

        ``src is dst`` (pool degradation re-seated the source as mixed)
        short-circuits to ``resume_parked``: the pages are already in the
        right pool, so the table row re-attaches with zero copies."""
        layout = self.kv_handoff_layout(src, rr)
        if layout is None or not layout.get("parked"):
            # a stale source pointer (nothing parked there anymore) must not
            # leave the request waiting on a handoff that can never happen
            self._drop_parked(rr)
            return False  # nothing parked to relay: re-prefill is the path
        from ..resilience.retry import is_handoff_transient

        policy = self.handoff_retry
        pages = layout["pages"]
        # destination backpressure DEFERS, it does not fail: a saturated
        # pool frees lanes/pages only when the router steps it — which an
        # in-step retry loop cannot cause — so the parked KV simply waits
        # (kv_source intact) and the next fleet step re-offers
        if dst.index == src.index:
            if src.engine.cache.lanes.free_count == 0:
                return False
        elif not dst.engine.can_adopt(len(pages)):
            return False
        attempt = rr.handoff_attempts
        seq = self._handoff_attempt_seq
        self._handoff_attempt_seq += 1
        src.engine.stats.record_handoff_attempt()
        t0 = time.perf_counter()
        if self.tracer is not None:
            # one handoff_attempt[j] span per attempt, in the SOURCE's lane
            # (its pages move); the outcome lands when the attempt settles
            self.tracer.span_start(
                rr.id, "handoff_attempt", stamp=t0, replica=src.engine.name,
                src=src.index, dst=dst.index, pages=len(pages),
            )
        try:
            if dst.index == src.index:
                if not src.engine.resume_parked(
                    rr.id, rr.prompt, rr.max_new_tokens,
                    submitted_at=rr.submitted_at, deadline_s=rr.deadline_s,
                ):
                    raise QueueFull(
                        "no free lane to resume the parked request",
                        queue_depth=src.engine.scheduler.waiting,
                        retry_after_s=src.engine.retry_after_hint(),
                    )
                moved_bytes = 0
            else:
                kb, vb = self._transfer_blocks(src, pages, seq, request_id=rr.id)
                if (
                    self.handoff_timeout_s is not None
                    and time.perf_counter() - t0 > self.handoff_timeout_s
                ):
                    raise HandoffLost(
                        f"handoff of request {rr.id} exceeded "
                        f"{self.handoff_timeout_s}s — transfer treated as lost"
                    )
                if not src.alive:
                    raise HandoffLost("source replica died mid-transfer")
                dst.engine.adopt_kv(
                    rr.prompt, rr.max_new_tokens, layout, kb, vb,
                    request_id=rr.id, submitted_at=rr.submitted_at,
                    deadline_s=rr.deadline_s,
                )
                moved_bytes = int(kb.nbytes + vb.nbytes)
        except QueueFull:
            # the pre-check raced real admission (pages pinned by live
            # holders that the prefix-eviction estimate counted as
            # reclaimable): same verdict — defer, parked KV intact, and no
            # retry budget spent (backpressure is not a transfer failure)
            if self.tracer is not None:
                self.tracer.span_end(
                    rr.id, "handoff_attempt", stats=src.engine.stats,
                    outcome="deferred",
                )
            return False
        except Exception as error:  # noqa: BLE001 - classifier decides
            rr.handoff_attempts += 1
            final = (
                rr.handoff_attempts >= policy.max_attempts
                or not is_handoff_transient(error)
                or not src.alive  # the parked pages are gone with the process
            )
            if not final:
                src.engine.stats.record_handoff_retry()
                if self.tracer is not None:
                    self.tracer.span_end(
                        rr.id, "handoff_attempt", stats=src.engine.stats,
                        outcome="retried", error=type(error).__name__,
                    )
                # the jittered backoff, as a GATE: the re-offer skips this
                # request until the stamp passes, while every replica keeps
                # decoding — in-step sleeping here would stall the fleet
                rr.handoff_retry_at = time.perf_counter() + policy.delay_for(attempt)
                self._fleet_record(
                    {"event": "kv_handoff", "outcome": "retried",
                     "request_id": rr.id, "src": src.index, "dst": dst.index,
                     "attempt": rr.handoff_attempts,
                     "error": f"{type(error).__name__}: {error}"}
                )
                return False
            # the ladder's last rung: release the parked pages (their
            # content regenerates bit-identically from the prompt) and
            # degrade to re-prefill on the decode pool
            if self.tracer is not None:
                self.tracer.span_end(
                    rr.id, "handoff_attempt", stats=src.engine.stats,
                    outcome="fell_back", error=type(error).__name__,
                )
            self._drop_parked(rr)
            src.engine.stats.record_handoff_fallback()
            self._fleet_record(
                {"event": "kv_handoff", "outcome": "fell_back",
                 "request_id": rr.id, "src": src.index, "dst": dst.index,
                 "attempts": rr.handoff_attempts,
                 "error": f"{type(error).__name__}: {error}"}
            )
            return False
        elapsed = time.perf_counter() - t0
        if self.tracer is not None:
            self.tracer.span_end(
                rr.id, "handoff_attempt", stats=src.engine.stats,
                outcome="adopted", bytes=moved_bytes,
            )
        # the ack: adoption verified token-exact — ONLY now do the
        # source-side refcounts drop (resume_parked already consumed
        # its own parked entry; release is then a no-op)
        if src.alive:
            src.engine.release_parked(rr.id)
        rr.kv_source = None
        rr.phase = "decode"
        rr.replica = dst.index
        if rr.cancelled:
            # a cancel raced the transfer: honor it on the destination
            # immediately so its True is never contradicted
            dst.engine.cancel(rr.id)
        dst.touch()
        self.placements[dst.index] += 1
        self.kv_handoffs += 1
        src.engine.stats.record_handoff(len(pages), moved_bytes, elapsed)
        self._fleet_record(
            {"event": "kv_handoff", "outcome": "adopted", "request_id": rr.id,
             "src": src.index, "dst": dst.index, "pages": len(pages),
             "bytes": moved_bytes, "seconds": elapsed,
             "attempts": rr.handoff_attempts + 1}
        )
        return True

    def _transfer_blocks(
        self, src: EngineReplica, pages, attempt_seq: int, request_id=None
    ):
        """The wire, routed through the redistribution primitive
        (:func:`~..parallel.redistribute.paged_transfer`): one stage per
        parked page, the page block as the scratch-bounded chunk, one
        ``{"kind": "redistribute"}`` record per transfer carrying the
        request's ``trace_id``. Chaos rides in the probe — mid-transfer,
        between deciding to move and the destination adopting — so the
        stall/loss drills exercise exactly the window where a real
        interconnect fails, and the primitive's ``redistribute_fail_*`` legs
        kill a named page-read stage in the same window. A killed stage
        surfaces as :class:`~.fleet.HandoffLost` naming the stage: the
        handoff's retry-then-re-prefill ladder IS this transfer's fallback
        rung, and the parked source pages stay refcounted throughout."""
        from ..parallel.redistribute import RedistributeStageFailure, paged_transfer

        def _probe() -> None:
            if self.chaos is not None:
                stall = self.chaos.handoff_stall(attempt_seq)
                if stall:
                    time.sleep(stall)
                if self.chaos.handoff_loss(attempt_seq):
                    raise HandoffLost("chaos: source blocks lost mid-transfer")

        try:
            return paged_transfer(
                src.engine.extract_pages,
                pages,
                fault_plan=self.chaos,
                probe=_probe,
                telemetry=self.telemetry,
                trace_id=request_id,
            )
        except RedistributeStageFailure as failure:
            raise HandoffLost(
                f"redistribute stage {failure.stage} ({failure.kind}) lost "
                "mid-transfer"
            ) from failure

    def _drop_parked(self, rr: RoutedRequest) -> None:
        """Release a pending request's parked source pages (terminal from
        the router, or handoff fallback): without this, a cancelled/expired
        request would pin its pages at the source forever."""
        if rr.kv_source is None:
            return
        src = self.replicas[rr.kv_source]
        rr.kv_source = None
        rr.handoff_retry_at = None
        if src.alive:
            try:
                src.engine.release_parked(rr.id)
            except Exception:  # noqa: BLE001 - a half-dead source changes nothing
                pass

    def kv_handoff_layout(self, src: EngineReplica, rr: RoutedRequest) -> Optional[dict]:
        """The page-granular source description a handoff relays: the
        engine's :meth:`~.engine.ServingEngine.kv_page_layout` for ``rr``,
        guarded by the fleet's reachability rules (a DEAD replica's memory is
        gone — SIGKILL semantics — so only a live source is readable)."""
        if not src.alive:
            return None
        try:
            return src.engine.kv_page_layout(rr.id)
        except Exception:  # noqa: BLE001 - a half-dead source must not break re-home
            return None

    # -- lifecycle operations ------------------------------------------------

    def drain_replica(self, index: int, reason: str = "operator drain") -> int:
        """Gracefully retire a replica: stop placing, re-home its queue, let
        active slots finish. Returns how many queued requests were re-homed.
        The replica transitions DRAINING → DEAD("drained") once empty."""
        replica = self.replicas[index]
        replica.start_drain(reason)  # → _on_transition → _rehome_drained
        moved = self._drain_moved.pop(index, 0)
        # an already-idle replica completes its drain right here — step()'s
        # completion sweep only runs when the fleet has work to step (parked
        # KV keeps the drain open: those pages must survive until handoff)
        if not replica.engine.busy and not getattr(replica.engine, "parked_count", 0):
            replica.mark_dead("drained")
            self._fleet_record({"event": "drained", "replica": replica.index})
        return moved

    def _rehome_drained(self, replica: EngineReplica, reason: str) -> int:
        """Drain a DRAINING replica's engine and re-home its queue. Runs on
        EVERY entry into DRAINING — operator `drain_replica` or the health
        machine escalating a sick replica — so the documented semantics
        ("queue re-homed, active slots finish") hold whichever path got
        there; without this the automatic path would keep feeding queued
        requests to the replica it just judged too sick to place on."""
        payloads, retired = replica.engine.drain()
        for result in retired:
            self._inflight.pop(result.request_id, None)
            self._retired.append(result)
        moved = 0
        for payload in payloads:
            rr = self._inflight.get(payload["request_id"])
            if rr is None:
                continue  # an engine-internal request; not the router's to re-home
            rr.last_replica, rr.replica = rr.replica, None
            self._pending.append(rr)
            moved += 1
        self._fleet_record(
            {"event": "drain", "replica": replica.index, "rehomed": moved,
             "reason": reason}
        )
        return moved

    def revive(self, index: int, warmup: bool = False) -> None:
        """Bring a DEAD replica back with a fresh engine (new process in a
        real fleet — requires ``engine_factory``). The replica re-enters
        placement only after the recovery completes."""
        if self.engine_factory is None:
            raise ValueError("revive() needs an engine_factory")
        replica = self.replicas[index]
        engine = self.engine_factory()
        if engine.name is None:
            engine.name = f"replica{index}"
        if engine.telemetry is None and self.telemetry is not None:
            engine.telemetry = self.telemetry
        if engine.tracer is None and self.tracer is not None:
            engine.tracer = self.tracer
        replica.begin_recovery(engine)
        if warmup:
            engine.warmup()
        replica.complete_recovery()
        self._fleet_record({"event": "revive", "replica": index})

    # -- observability -------------------------------------------------------

    def _on_transition(self, replica: EngineReplica, state: ReplicaState, reason: str) -> None:
        self._fleet_record(
            {"event": "health", "replica": replica.index, "state": state.value,
             "reason": reason}
        )
        if state is ReplicaState.DRAINING:
            self._drain_moved[replica.index] = self._rehome_drained(replica, reason)
            # a draining pool member stops placing: if it was the pool's
            # last, the opposite pool must go mixed NOW — its drain may take
            # many steps, and new requests cannot wait for it to finish
            self._rebalance_roles()

    def _terminal(self, rr: RoutedRequest, reason: str, now: float) -> ServingResult:
        if self.tracer is not None:
            # a router-made terminal (failed failover, cancelled/expired
            # while pending): the trace must end exactly once HERE — no
            # engine will ever retire this request. The stats sink is the
            # LAST replica that hosted it (its books live on, dead or not,
            # and the rollup sums them all): without one, exactly the failed
            # requests would vanish from the fleet's trace/SLO counters and
            # slo_bad_rate would report a clean fleet mid-drill
            host = rr.last_replica if rr.last_replica is not None else 0
            host_replica = self.replicas[host]
            self.tracer.retire(
                rr.id, reason, stamp=now,
                stats=host_replica.engine.stats,
                replica=host_replica.engine.name,
            )
        return ServingResult(
            request_id=rr.id,
            prompt=rr.prompt,
            generated=np.zeros((0,), np.int32),
            finish_reason=reason,
            ttft_s=None,
            latency_s=now - rr.submitted_at,
        )

    def _fleet_record(self, payload: dict) -> None:
        if self.telemetry is not None:
            if "trace_id" not in payload:
                # every fleet record (kv_handoff, rehome, shed, ...) carries
                # a trace_id — null for non-request records — so one grep of
                # the records reconstructs a request's full story
                trace_id = (
                    self.tracer.trace_id(payload.get("request_id"))
                    if self.tracer is not None
                    else None
                )
                payload = {**payload, "trace_id": trace_id}
            self.telemetry.write_record("fleet", {"fleet_step": self._steps, **payload})

    def metrics(self) -> dict:
        """Fleet-aggregated serving metrics plus router-level counters and
        the per-replica health summaries. Disaggregated fleets add the
        handoff economy (attempted/adopted/fallbacks, pages and bytes
        moved, handoff p50/p99) and per-pool occupancy from the rollup."""
        out = fleet_rollup(
            [r.engine.stats for r in self.replicas],
            roles=[r.role for r in self.replicas] if self.disaggregated else None,
        )
        out["fleet_steps"] = self._steps
        out["router_sheds"] = self.router_sheds
        out["router_deadline_sheds"] = self.router_deadline_sheds
        if self.autoscale is not None:
            # gain-only schema: a fleet built without a rebalancer emits
            # byte-identical metrics to one from before autoscaling existed
            out.update(self.autoscale.snapshot())
        out["failovers"] = self.failovers
        out["failed_failovers"] = self.failed_failovers
        out["rehomed"] = self.rehomed
        out["replica_deaths"] = self.replica_deaths
        out["kv_handoffs"] = self.kv_handoffs
        out["pending_depth"] = len(self._pending)
        out["placements"] = list(self.placements)
        out["replica_roles"] = [r.role for r in self.replicas]
        out["replica_health"] = [r.summary() for r in self.replicas]
        return out

    def flush_telemetry(self) -> Optional[dict]:
        """One ``{"kind": "fleet"}`` record with the aggregated metrics."""
        if self.telemetry is None:
            return None
        return self.telemetry.write_record("fleet", {"fleet": self.metrics()})

    def analyze(self, *args, **kwargs):
        """Program analysis of the replicas' decode path: not ported yet."""
        raise NotImplementedError(
            "ServingRouter.analyze comes with program analysis (ROADMAP item 21)"
        )
