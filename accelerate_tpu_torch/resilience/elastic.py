"""Elastic training: survive the loss of a host without restarting the job.

Counterpart of ``accelerate_tpu/resilience/elastic.py`` across processes.
The ZeRO sharded update (``parallel/zero.py``) stores the params and the
optimizer moments 1/N on each process, so losing a host loses only the
shards that lived on it, and a buddy copy of each shard, mirrored one host
over, leaves no shard with a single point of failure. Recovery is then a
relayout: pause at a step boundary, form a new process group over the
survivors, move the state from the surviving shards (and the lost ones'
buddy copies) onto the shrunken layout, and resume. A host returns the same
way in reverse.

A host is one process, or ``ElasticConfig.num_hosts`` contiguous groups of
them. Once a host is lost no survivor reads its shards and no survivor
enters a collective with it; the lost process itself frees its shards,
stops its heartbeats and leaves its process group
(:class:`HostLost`), and may come back through :meth:`ElasticCoordinator.
rejoin`. The ladder, as in the JAX package:

1. **buddy reshard**: redundancy on and the mirror fresh (refreshed at the
   last boundary): every lost shard is read from its buddy copy; no step is
   lost.
2. **checkpoint reload**: no redundancy, the buddy lost too, or the mirror
   stale (``mirror_every > 1`` and the loss between refreshes): the newest
   valid checkpoint is loaded onto the survivors (``checkpointing.py``
   reshards on load) and the step count rewinds to it.
3. **fail loudly**: :class:`ElasticFailure`.

Across processes the agreement on who takes part is the membership epoch
(``resilience/membership.py``): each transition mints one, and the
survivors (or the members and a returning host) meet at a rendezvous named
after it (``PartialState.rejoin``: the old group is left, a ``FileStore``
per epoch in the membership store's directory forms the new one, ranks
renumbered in their old order, and the mesh is rebuilt). A process of an
older epoch cannot join a newer group, and the launcher's rendezvous,
which still counts the dead rank, is never used again. At every boundary
the members agree on the losses and joins they act on with one small
all-reduce (the union of what each read from the store and the chaos
plan). A peer lost between boundaries fails the next collective in
bounded time (the group's ``timeout``; gloo reports a closed connection at
once): the step has not updated anything yet (the update is the step's
last, local work), the detector then names the host by its heartbeat
silence, and the step runs again on the survivors.

Every detection, recovery and regrow lands as a ``{"kind": "elastic"}``
record with ``mttr_s``; recovery time goes to the goodput ledger as
``elastic_reshard``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..logging import get_logger
from ..parallel.redistribute import (  # noqa: F401 - re-exported, as in the JAX package
    EpochFence,
    ProcessSharding,
    assemble_from_survivors,
    redistribute,
    relay_tree,
    tree_covered,
)
from ..utils.constants import (
    MESH_AXIS_DATA,
    MESH_AXIS_EXPERT,
    MESH_AXIS_FSDP,
    MESH_AXIS_PIPELINE,
    MESH_AXIS_SEQUENCE,
    MESH_AXIS_TENSOR,
)
from ..utils.concurrency import named_lock
from ..utils.params import state_leaves, state_paths, state_unflatten, tree_leaves, tree_paths, tree_unflatten

logger = get_logger(__name__)

_STRICT_AXES = (MESH_AXIS_PIPELINE, MESH_AXIS_EXPERT, MESH_AXIS_SEQUENCE, MESH_AXIS_TENSOR)


# what a collective's failure says when a peer has gone (gloo's transport,
# NCCL's watchdog, the c10d store), where torch raises it as a plain
# RuntimeError and not as a DistError
_LOST_PEER_MARKERS = ("gloo", "NCCL", "Connection closed", "Connection reset", "Connection refused",
                      "Broken pipe", "Timed out", "timed out", "Socket Timeout")


class ElasticFailure(RuntimeError):
    """Every rung of the ladder failed (or the survivors cannot form a
    mesh): the run cannot continue correctly."""


class HostLost(RuntimeError):
    """This process's host was removed from the job: it holds no state and
    must not step. It may ask back in with ``ElasticCoordinator.rejoin``."""


@dataclass
class ElasticConfig:
    """Elastic-training knobs (``Accelerator.elastic_coordinator``).

    - ``redundancy``: buddy copies of each process's shards (0 or 1); each
      costs another (params + optimizer state)/N a process.
    - ``num_hosts``: how many hosts the processes divide into (contiguous
      groups); default one host a process.
    - ``mirror_every``: refresh the buddy copies every N completed steps;
      a loss between refreshes falls to the checkpoint rung.
    - ``checkpoint_dir``: where the checkpoint rung looks.
    - ``contracts_dir``: the program audit of the resharded step, which is
      program analysis (ROADMAP item 21): refused here.
    - ``handle_signals``: SIGUSR1 requests a shrink at the next boundary.
    """

    redundancy: int = 1
    num_hosts: Optional[int] = None
    mirror_every: int = 1
    checkpoint_dir: Optional[str] = None
    contracts_dir: Optional[str] = None
    handle_signals: bool = False

    def __post_init__(self):
        if self.redundancy not in (0, 1):
            raise ValueError(f"ElasticConfig.redundancy must be 0 or 1 (one buddy roll), got {self.redundancy}")
        if self.mirror_every < 1:
            raise ValueError("ElasticConfig.mirror_every must be >= 1")
        if self.contracts_dir is not None:
            raise NotImplementedError(
                "ElasticConfig.contracts_dir gates the resharded step with the program audit, which is "
                "not in the port yet (ROADMAP item 21)")


# -- hosts and the buddy layout -------------------------------------------------------


def host_device_groups(devices: list, num_hosts: int) -> list[list]:
    """``devices`` (here: the processes, in rank order) in ``num_hosts``
    contiguous groups: a host's processes. The buddy roll is one host's
    worth of processes, so a shard and its buddy never share a host."""
    n = len(devices)
    if num_hosts < 1 or n % num_hosts != 0:
        raise ValueError(f"{n} devices do not divide into {num_hosts} equal hosts")
    per = n // num_hosts
    return [list(devices[i * per: (i + 1) * per]) for i in range(num_hosts)]


def buddy_mesh(members: list, stride: int) -> list:
    """The buddy placement: the member list rolled by ``stride`` (the
    processes of a host), so the shard of position ``i`` is also held by
    ``members[i - stride]``, on another host."""
    if not 0 < stride < len(members):
        raise ValueError(f"buddy stride {stride} out of range for {len(members)} processes")
    return list(np.roll(np.asarray(members), stride).tolist())


def buddy_shardings(shardings: list, stride: int) -> list:
    """Primary shardings to the buddy layout (same specs, rolled members)."""
    return [s.rolled(stride) for s in shardings]


@dataclass
class _Specs:
    """A layout of the model's state at some mesh sizes: the params' stored
    and update specs (trees) and the optimizer state's specs (a list)."""

    sizes: dict
    params: dict
    update: dict
    state: list
    zero: bool


class ElasticCoordinator:
    """One process's side of an elastic run: the step, the buddy mirror,
    detection (the chaos plan, a SIGUSR1 request, the membership detector,
    a failed collective), the ladder, and regrow::

        coordinator = accelerator.elastic_coordinator(
            loss_fn, config=ElasticConfig(redundancy=1), membership=MembershipService(...))
        for batch in global_batches:
            loss = coordinator.step(batch)   # a loss pauses, reshards and resumes here

    ``step`` takes the GLOBAL batch (host arrays or tensors) and runs this
    process's share of its rows, re-derived every call: after a shrink the
    same rows spread over fewer processes."""

    def __init__(
        self,
        accelerator: Any,
        loss_fn: Callable,
        model: Any = None,
        optimizer: Any = None,
        config: Optional[ElasticConfig] = None,
        checkpoint_manager: Any = None,
        membership: Any = None,
        **step_kwargs: Any,
    ):
        self.accelerator = accelerator
        self.config = config or ElasticConfig()
        if model is None:
            if not accelerator._models:
                raise ValueError("ElasticCoordinator needs a prepared model.")
            model = accelerator._models[-1]
        self.model = model
        if optimizer is None:
            optimizer = next((o for o in accelerator._optimizers if o.params is model.params), None)
            if optimizer is None:
                raise ValueError("ElasticCoordinator needs an optimizer prepared for this model: call "
                                 "prepare_optimizer() first.")
        self.optimizer = optimizer
        if self.optimizer.cpu_offload:
            raise ValueError(
                "ElasticCoordinator does not compose with cpu_offload optimizer state (the buddy mirror and "
                "the survivors' relay cover device shards); keep the state on the device or drop elastic "
                "training.")
        sizes = dict(accelerator.state.mesh_shape)
        strict = [a for a in _STRICT_AXES if sizes[a] > 1]
        if strict:
            raise NotImplementedError(
                f"elastic training under the model axes {strict} (their groups are wired into the model at "
                "prepare) is not in the port yet: the batch axes absorb a shrink")
        self._loss_fn = loss_fn
        self._step_kwargs = step_kwargs
        self.checkpoint_manager = checkpoint_manager
        if checkpoint_manager is not None and self.config.checkpoint_dir is None:
            self.config = dataclasses.replace(self.config, checkpoint_dir=checkpoint_manager.checkpoint_dir)
        state = accelerator.state
        world = state.num_processes
        self.member = state.process_index  # this process's identity for the whole run
        self._full_world = world
        num_hosts = self.config.num_hosts or world
        self.host_groups = host_device_groups(list(range(world)), num_hosts)
        self._host_of = {m: h for h, group in enumerate(self.host_groups) for m in group}
        self.host = self._host_of[self.member]
        self.members = list(range(world))  # the live processes, in rank order
        self._full_parallelism = dataclasses.replace(state.parallelism, data=sizes[MESH_AXIS_DATA],
                                                     fsdp=sizes[MESH_AXIS_FSDP])
        self.lost_hosts: set[int] = set()
        self.completed_steps = 0
        self._mirror_step = -1
        self._buddy: Optional[dict] = None
        self._shrink_requested = False
        self._departed = False
        self._boundaries = 0  # the boundaries agreed so far, the same count on every member
        self.last_recovery: Optional[dict] = None
        self.recoveries: list[dict] = []
        # the whole shapes of every param and state leaf: a layout at any
        # mesh size is derived from them, a returning process's included
        layout = model.layout

        def _whole(leaves, specs):
            if layout is None:
                return [tuple(x.shape) for x in leaves]
            return [layout.full_shape(tuple(x.shape), s) for x, s in zip(leaves, specs)]

        self._param_shapes = _whole(tree_leaves(model.params), layout.pspecs if layout is not None else None)
        self._state_shapes = _whole(state_leaves(optimizer.opt_state), optimizer.state_specs)
        self._param_paths = [p for p, _ in tree_paths(model.params)]
        self._state_paths = state_paths(optimizer.opt_state)
        self._specs = self._specs_for(sizes)
        if membership is None:
            from .membership import MembershipService

            membership = MembershipService.from_env(num_hosts=num_hosts, host_index=self.host)
        self.membership = membership
        if world > 1 and membership is None:
            raise ValueError(
                "elastic training across processes needs a membership store (its epoch names each "
                "rendezvous and fences out a returning zombie): pass membership=MembershipService("
                "FilesystemStore(dir), num_hosts, host_index) or set ACCELERATE_MEMBERSHIP_DIR")
        self._hang_watchdog = None
        self._last_membership_io: Optional[float] = None
        if membership is not None:
            if membership.num_hosts != num_hosts:
                raise ValueError(
                    f"membership service tracks {membership.num_hosts} hosts but the coordinator has "
                    f"{num_hosts}: the two views would name different hosts for the same rank")
            if membership.telemetry is None:
                membership.telemetry = getattr(accelerator, "telemetry", None)
            hang_timeout = membership.config.hang_watchdog_timeout_s
            if hang_timeout is not None:
                from .membership import CollectiveHangWatchdog

                self._hang_watchdog = CollectiveHangWatchdog(membership, hang_timeout)
        self.signals_armed = False
        self._beat_lock = named_lock("elastic.heartbeat")
        self._beating: Optional[threading.Event] = None
        self._recompile()
        if self.config.redundancy:
            self._mirror()
        if self.config.handle_signals:
            self._install_signal_handler()
        self._start_beating()

    def _install_signal_handler(self) -> None:
        """SIGUSR1 flags a shrink request for the next boundary (flag only:
        never relayout from a handler)."""
        import signal

        try:
            signal.signal(signal.SIGUSR1, lambda signum, frame: self.request_shrink())
            self.signals_armed = True
        except ValueError:  # signal.signal works on the main thread only
            logger.warning(
                "ElasticCoordinator could not install the SIGUSR1 handler outside the main thread: handler "
                "left UNARMED; call request_shrink() from your own signal plumbing, or rely on the "
                "membership= probe.")

    # -- surfaces ------------------------------------------------------------------

    @property
    def mesh(self):
        return self.accelerator.mesh

    @property
    def num_hosts(self) -> int:
        return len(self.host_groups)

    @property
    def _per_host(self) -> int:
        return self._full_world // self.num_hosts

    def _rank_of(self, members: list) -> dict:
        return {m: i for i, m in enumerate(members)}

    def _members_of(self, hosts) -> list:
        return sorted(m for h in hosts for m in self.host_groups[h])

    def surviving_devices(self) -> list:
        """The live processes (their identities), in rank order."""
        return list(self.members)

    def shard_batch(self, batch: Any) -> Any:
        """This process's rows of a global host batch, on its device: its
        share over the live batch axes (the same rows spread over fewer
        processes after a shrink)."""
        state = self.accelerator.state
        shards, index = state.batch_shards, state.batch_shard_index
        device = state.device

        def _put(x):
            x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
            rows = x.shape[0]
            if rows % shards:
                raise ElasticFailure(f"a global batch of {rows} rows does not divide over {shards} processes: "
                                     "size the global batch for every mesh the run may shrink to")
            share = rows // shards
            return x[index * share:(index + 1) * share].to(device)

        if isinstance(batch, dict):
            return {k: _put(v) for k, v in batch.items()}
        return _put(batch)

    def request_shrink(self) -> None:
        """Out-of-band loss notification (SIGUSR1): the next boundary probes
        for the lost host."""
        self._shrink_requested = True

    # -- the step ----------------------------------------------------------------------

    def step(self, batch: Any):
        """One training step with the elastic boundary in front
        (:meth:`boundary`), on the live processes. A collective of the step
        that fails for a lost peer is recovered and the step runs again: the
        step's update is its last, local work, so nothing of the failed
        attempt was applied."""
        self.boundary()
        try:
            loss = self._run_step(self.shard_batch(batch))
        except RuntimeError as error:
            if not self._peer_failure(error):
                raise
            self.reshard(self._await_loss(error))
            loss = self._run_step(self.shard_batch(batch))
        self.completed_steps += 1
        if self.config.redundancy and self.completed_steps % self.config.mirror_every == 0:
            self._mirror()
        return loss

    def boundary(self) -> None:
        """The step boundary alone: the members agree on the losses and
        joins to act on (the chaos plan, a request, the membership
        detector, join records), then recover or regrow. Idempotent until
        the next step: a second call finds nothing new to act on."""
        if self._departed:
            raise HostLost(f"host {self.host} was removed from the job at step {self.completed_steps}; "
                           "rejoin() to ask back in")
        try:
            lost, joins = self._boundary()
            for host in joins:
                self.regrow(hosts=[host])
            if lost is not None:
                self.reshard(lost)
        except RuntimeError as error:
            if not self._peer_failure(error):
                raise
            self.reshard(self._await_loss(error))

    def _run_step(self, local_batch):
        if self._hang_watchdog is not None:
            self._hang_watchdog.arm()
        try:
            return self._step(local_batch)
        finally:
            if self._hang_watchdog is not None:
                self._hang_watchdog.disarm()

    def _peer_failure(self, error: RuntimeError) -> bool:
        """Whether a failed step may be a lost peer: a communication error
        (the backend's, the rendezvous store's, or a closed or timed-out
        connection) across processes, with a detector that can name it. Any
        other error (out of memory, a kernel, a shape) and the elastic
        path's own are raised where they happened."""
        from ..parallel.redistribute import RedistributeError
        from .membership import StaleEpochError

        if isinstance(error, (ElasticFailure, HostLost, RedistributeError, StaleEpochError)):
            return False
        if len(self.members) < 2 or self.membership is None:
            return False
        if isinstance(error, dist.DistError):
            return True
        text = str(error)
        return any(marker in text for marker in _LOST_PEER_MARKERS)

    def _await_loss(self, error: RuntimeError) -> int:
        """After a failed collective: keep beating and ask the detector
        until it names a lost host (its silence), within
        a few of its silences; the original error otherwise."""
        logger.warning(f"elastic: a collective failed ({str(error).splitlines()[0][:200]}); waiting for the "
                       "membership detector to name the lost host")
        # the broken group is left at once: its connections close, so a
        # survivor still blocked in one of its collectives fails now too
        self.accelerator.state._partial.leave()
        timeout = self.membership.config.heartbeat_timeout_s or 1.0
        deadline = time.monotonic() + self._detect_timeout_s
        while time.monotonic() < deadline:
            self._heartbeat()
            try:
                suspicions = self.membership.detect()
            except Exception as e:  # noqa: BLE001 - store weather must not kill the run
                self._membership_degraded("detect", e)
                suspicions = []
            named = [s for s in suspicions if s["host"] != self.host and self._loss_valid(s["host"])]
            if named:
                # the host silent the longest: a survivor slow to the
                # rendezvous must not be taken for the dead one
                suspicion = max(named, key=lambda s: s["mttd_s"])
                logger.warning(f"elastic: membership detector named host {suspicion['host']} lost "
                               f"({suspicion['reason']}, mttd {suspicion['mttd_s']:.3f}s)")
                return suspicion["host"]
            time.sleep(min(0.05, timeout / 4))
        raise ElasticFailure(f"a collective failed and no lost host was named within "
                             f"{self._detect_timeout_s} s") from error

    # -- the boundary ------------------------------------------------------------------

    def _membership_due(self) -> bool:
        interval = self.membership.config.min_probe_interval_s
        if interval <= 0:
            return True
        now = time.monotonic()
        if self._last_membership_io is None or now - self._last_membership_io >= interval:
            self._last_membership_io = now
            return True
        return False

    def _membership_degraded(self, op: str, error: Exception) -> None:
        """Store weather outlasted its retries: this boundary's membership
        work degrades to a warning (the next boundary retries)."""
        logger.warning(f"elastic: membership {op} degraded (store unreachable past its retry budget: {error}); "
                       "detection skipped this boundary.")
        try:
            self.membership._record("store_degraded", {"op": op, "error": str(error)})
        except Exception:  # noqa: BLE001 - degradation reporting must not raise
            pass

    def _chaos(self):
        return getattr(getattr(self.accelerator, "resilience", None), "chaos", None)

    def _start_beating(self) -> None:
        """Across processes, beat from a side thread every quarter of the
        heartbeat timeout, besides each boundary's beat: a process busy in a
        relayout, a long gather or a collective is alive, and only a dead one
        (or one whose step-stamp stops while its peers' advance) is named."""
        if self.membership is None or len(self.members) <= 1:
            return
        stop = self._beating = threading.Event()
        period = (self.membership.config.heartbeat_timeout_s or 1.0) / 4

        def beat():
            while not stop.wait(period):
                self._heartbeat()

        threading.Thread(target=beat, name="elastic-heartbeat", daemon=True).start()

    def _stop_beating(self) -> None:
        if self._beating is not None:
            self._beating.set()
            self._beating = None

    def _heartbeat(self) -> None:
        """This host's beat (its first process publishes it), through the
        chaos plan's membership legs: silence stops it, a stall freezes its
        step-stamp."""
        if self.membership is None or self.member != self.host_groups[self.host][0]:
            return
        with self._beat_lock:
            self._beat_once()

    def _beat_once(self) -> None:
        step = self.completed_steps
        plan = self._chaos()
        if plan is not None:
            boundary = self.completed_steps + 1
            if plan.membership_silent(self.host, boundary):
                return
            frozen = plan.membership_stall(self.host, boundary)
            if frozen is not None:
                step = frozen
        try:
            self.membership.heartbeat(step)
        except Exception as e:  # noqa: BLE001 - store weather must not kill the run
            self._membership_degraded("heartbeat", e)

    def _boundary(self) -> tuple[Optional[int], list]:
        """This boundary's agreed loss (or None) and hosts to admit: each
        process reads the join records and the detector, the chaos plan
        names its loss, and one all-reduce over the live group takes the
        union, so every member acts on the same set."""
        due = False
        if self.membership is not None:
            due = self._membership_due() or self._shrink_requested
        joins: list = []
        if due:
            try:
                pending = self.membership.pending_joins()
            except Exception as e:  # noqa: BLE001 - store weather must not kill the run
                self._membership_degraded("pending_joins", e)
                pending = []
            joins = [h for h in pending if h in self.lost_hosts]
            for host in pending:
                if host in joins:
                    continue
                # a join record this coordinator cannot act on (the host is a
                # member already): resolve it so it does not list forever
                try:
                    if host in self.membership.view()["members"]:
                        self.membership.store.delete(f"join/{host}")
                except Exception as e:  # noqa: BLE001
                    self._membership_degraded("admit_stale_join", e)
            self._heartbeat()
        lost = self._detect_loss(due)
        if len(self.members) > 1:
            lost, joins = self._agree(lost, joins)
        return lost, joins[:1]  # one transition a boundary: each its own epoch

    def _agree(self, lost: Optional[int], joins: list) -> tuple[Optional[int], list]:
        """The members' union of what each names at this boundary, through
        the store (no collective: a dead member cannot block it). Each
        writes its record and reads every member's of the same boundary;
        a member whose record never comes is named by the detector (its
        silence) and joins the union as a loss."""
        self._boundaries += 1
        store, epoch, seq = self.membership.store, self.membership.epoch, self._boundaries
        store.write(f"boundary/{self.member}/{seq}", {"member": self.member, "epoch": epoch,
                                                       "lost": [] if lost is None else [lost], "joins": joins})
        records: dict = {}
        named: set = set()
        period = (self.membership.config.heartbeat_timeout_s or 1.0) / 4  # detections while waiting
        deadline = time.monotonic() + self._detect_timeout_s
        next_probe = time.monotonic() + period
        while True:
            for m in self.members:
                if m not in records:
                    record = store.read(f"boundary/{m}/{seq}")
                    if record is not None and int(record["epoch"]) == epoch:
                        records[m] = record
            waiting = [m for m in self.members if m not in records and self._host_of[m] not in named]
            if not waiting:
                break
            if time.monotonic() > deadline:
                raise ElasticFailure(f"members {waiting} wrote no record at boundary {seq} within "
                                     f"{self._detect_timeout_s} s and the detector named none of them")
            if time.monotonic() >= next_probe:
                next_probe = time.monotonic() + period
                try:
                    suspicions = self.membership.detect()
                except Exception as e:  # noqa: BLE001 - store weather must not kill the run
                    self._membership_degraded("detect", e)
                    suspicions = []
                hosts = {self._host_of[m] for m in waiting}
                named.update(s["host"] for s in suspicions if s["host"] in hosts and self._loss_valid(s["host"]))
            time.sleep(0.002)
        # every member wrote its record of the previous boundary only after
        # reading all of that one's: this process's is read by now
        store.delete(f"boundary/{self.member}/{seq - 1}")
        losses = sorted(named | {h for r in records.values() for h in r["lost"]})
        agreed_joins = sorted({h for r in records.values() for h in r["joins"]})
        return (losses[0] if losses else None), agreed_joins

    def _membership_probe(self) -> Optional[int]:
        try:
            suspicions = self.membership.detect()
        except Exception as e:  # noqa: BLE001 - store weather must not kill the run
            self._membership_degraded("detect", e)
            return None
        for suspicion in suspicions:
            if self._loss_valid(suspicion["host"]):
                logger.warning(f"elastic: membership detector named host {suspicion['host']} lost "
                               f"({suspicion['reason']}, mttd {suspicion['mttd_s']:.3f}s)")
                return suspicion["host"]
        return None

    def _detect_loss(self, membership_due: bool = False) -> Optional[int]:
        plan = self._chaos()
        requested, self._shrink_requested = self._shrink_requested, False
        lost = None
        if plan is not None:
            boundary = self.completed_steps + 1  # 1-based, like the training chaos legs
            lost = plan.host_loss(boundary, valid=self._loss_valid)
            if lost is None and requested:
                lost = plan.host_loss(plan.host_loss_step, valid=self._loss_valid)
        if lost is None and self.membership is not None and (membership_due or requested):
            lost = self._membership_probe()
        if lost is None and requested:
            logger.warning(
                "elastic: shrink requested (supervisor signal) but no host probe identified the lost host. "
                "The run continues on the FULL group; if a host is really gone, the next collective fails "
                "and the detector names it. Wire a membership= probe, arm ACCELERATE_CHAOS_HOST_LOSS_STEP/"
                "_INDEX (drills), or call coordinator.reshard(lost_host=...) directly.")
            telemetry = getattr(self.accelerator, "telemetry", None)
            if telemetry is not None and telemetry.enabled:
                telemetry.write_record("elastic", {"event": "shrink_request_unresolved",
                                                   "at_step": self.completed_steps})
        return lost

    def _loss_valid(self, host_index: int) -> bool:
        if not 0 <= host_index < self.num_hosts or host_index in self.lost_hosts:
            return False
        remaining = len(self.members) - len(self.host_groups[host_index])
        return remaining > 0 and self._shrunk_parallelism(remaining) is not None

    # -- layouts -------------------------------------------------------------------------

    def _specs_for(self, sizes: dict) -> _Specs:
        """The layout ``prepare_model`` and ``prepare_optimizer`` give the
        model's state at mesh ``sizes``, from the whole shapes alone: the
        rules' specs, folded over the batch axes where the ZeRO update runs
        there, FSDP stages 1 and 2's update specs, the moments' specs."""
        from ..parallel.sharding import infer_shardings, shardings_like, zero_update_shardings
        from ..parallel.zero import zero_ineligible_reason

        acc = self.accelerator
        full = tree_unflatten(self.model.params, [torch.empty(s, device="meta") for s in self._param_shapes])
        rules = acc._partition_rules(self.model.module)
        specs = infer_shardings(full, sizes, rules)
        zero = (zero_ineligible_reason(sizes, acc.fsdp_plugin) is None
                and acc.state.parallelism.zero_stage != 0)
        if zero:
            specs = zero_update_shardings(full, specs, sizes)
        update = specs
        plugin = acc.fsdp_plugin
        if plugin is not None and plugin.stage < 3:
            update = infer_shardings(full, sizes, rules.with_fsdp_applied())
        state_full = state_unflatten(self.optimizer.opt_state,
                                     [torch.empty(s, device="meta") for s in self._state_shapes])
        return _Specs(dict(sizes), specs, update, shardings_like(state_full, full, update), zero)

    def _shardings(self, specs: _Specs, members: list) -> tuple[list, list]:
        """Each param's and each state leaf's :class:`ProcessSharding`."""
        return ([ProcessSharding.of(members, specs.sizes, s) for s in tree_leaves(specs.params)],
                [ProcessSharding.of(members, specs.sizes, s) for s in specs.state])

    def _shrunk_parallelism(self, n_processes: int):
        """The ParallelismConfig for ``n_processes``, or None when none fits:
        data absorbs the change (keeping fsdp), else fsdp (keeping data); the
        full set restores the original layout exactly."""
        if n_processes == self._full_world:
            return self._full_parallelism
        state = self.accelerator.state
        par, shape = state.parallelism, state.mesh_shape
        strict = int(np.prod([shape[a] for a in _STRICT_AXES]))
        data, fsdp = int(shape[MESH_AXIS_DATA]), int(shape[MESH_AXIS_FSDP])
        if n_processes >= strict * fsdp and n_processes % (strict * fsdp) == 0:
            return dataclasses.replace(par, data=n_processes // (strict * fsdp), fsdp=fsdp)
        if n_processes >= strict * data and n_processes % (strict * data) == 0:
            return dataclasses.replace(par, data=data, fsdp=n_processes // (strict * data))
        return None

    @property
    def _detect_timeout_s(self) -> float:
        """How long the members wait for a missing member's record, or for
        the detector to name the peer a failed collective lost: a few of its
        silences."""
        return 4 * (self.membership.config.heartbeat_timeout_s or 1.0) + 30.0

    def _rendezvous(self, epoch: int) -> str:
        root = getattr(getattr(self.membership, "store", None), "root", None)
        if root is None:
            raise ElasticFailure("no rendezvous directory: across processes the membership store is a "
                                 "FilesystemStore, whose directory holds each epoch's rendezvous")
        path = os.path.join(root, "rendezvous", f"epoch-{int(epoch)}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return f"file://{path}"

    def _rebuild_mesh(self, members: list, epoch: int) -> None:
        """Leave the old group, meet the ``members`` at the epoch's
        rendezvous, rebuild the mesh under the shrunk (or full) parallelism."""
        par = self._shrunk_parallelism(len(members))
        if par is None:
            raise ElasticFailure(f"internal: {len(members)} processes cannot form a training mesh "
                                 "(feasibility must be checked before the ladder runs)")
        partial = self.accelerator.state._partial
        # a survivor held in a collective until the group's timeout arrives
        # that late: the rendezvous waits for it
        held = partial.__dict__.get("_pg_timeout") or timedelta(minutes=30)
        partial.rejoin(members.index(self.member), len(members), self._rendezvous(epoch), parallelism=par,
                       rendezvous_timeout=held + timedelta(seconds=self._detect_timeout_s))
        self.members = list(members)

    def _install(self, specs: _Specs, params: list, state: list) -> None:
        """The new layout and the moved tensors into the model, the
        optimizer and the accelerator (the in-flight accumulation and the
        guard's device state belong to the old layout: dropped)."""
        from ..parallel.zero import ShardedLayout

        acc = self.accelerator
        layout = ShardedLayout(acc.state, specs.params, specs.update)
        self.model.params = tree_unflatten(self.model.params, params)
        self.model.layout = layout
        opt = self.optimizer
        opt.params = self.model.params
        opt.layout = layout
        opt.state_specs = list(specs.state)
        opt.opt_state = state_unflatten(opt.opt_state, state)
        opt._grads = None
        opt._accum_count = 0
        acc._zero_update_sharding = specs.zero
        guard = getattr(getattr(acc, "resilience", None), "guard", None)
        if guard is not None:
            guard.state = None
            guard._bound = None
            guard._snapshot = None
        self._specs = specs

    def _sync_small_state(self, root_member: int) -> None:
        """The step counts and the fp16 scaler from one process that held
        them before the relayout (a returning process holds nothing)."""
        opt = self.optimizer
        resilience = getattr(self.accelerator, "resilience", None)
        values = torch.tensor([
            self.completed_steps, self._mirror_step, opt._step_count, getattr(resilience, "steps", 0),
            self._boundaries,
            float(opt.scale) if opt.scale is not None else 0.0,
            float(opt.growth_tracker) if opt.growth_tracker is not None else 0.0,
        ], dtype=torch.float64, device=self.accelerator.state.comm_device)
        if len(self.members) > 1:
            dist.broadcast(values, self.members.index(root_member))
        completed, mirror_step, count, steps, boundaries, scale, growth = values.cpu().tolist()
        self.completed_steps, self._mirror_step, opt._step_count = int(completed), int(mirror_step), int(count)
        self._boundaries = int(boundaries)
        if resilience is not None and hasattr(resilience, "steps"):
            resilience.steps = int(steps)
        if opt.scale is not None:
            opt.scale = torch.tensor(scale, dtype=torch.float32, device=opt.device)
            opt.growth_tracker = torch.tensor(int(growth), dtype=torch.int32, device=opt.device)

    # -- the buddy mirror --------------------------------------------------------------

    def _mirror(self) -> None:
        """Refresh the buddy copy: each process's split shards (params and
        optimizer state) one host over, a ring shift by a host's processes.
        Leaves whole on every process need none. With one host left the
        mirror stands down (a further loss falls to the checkpoint rung)."""
        from ..parallel.compat import Hop

        n, per_host = len(self.members), self._per_host
        if n <= per_host:
            if self._buddy is not None:
                logger.warning("elastic: one host's processes remain: buddy mirror stood down; a further loss "
                               "degrades to the checkpoint rung.")
            self._buddy = None
            return
        psh, ssh = self._shardings(self._specs, self.members)
        leaves = tree_leaves(self.model.params) + state_leaves(self.optimizer.opt_state)
        shapes = self._param_shapes + self._state_shapes
        split = [i for i, (sh, shape) in enumerate(zip(psh + ssh, shapes))
                 if len(set(sh.indices_map(shape).values())) > 1]
        position = self.members.index(self.member)
        held = [None] * len(leaves)
        if split:
            rank_of = self._rank_of(self.members)
            hop = Hop([leaves[i] for i in split], dst=rank_of[self.members[(position - per_host) % n]],
                      src=rank_of[self.members[(position + per_host) % n]], group=dist.group.WORLD)
            for i, x in zip(split, hop.wait()):
                held[i] = x
        first = self._buddy is None
        n_params = len(self._param_shapes)
        self._buddy = {"params": held[:n_params], "opt_state": held[n_params:]}
        self._mirror_step = self.completed_steps
        if first:
            telemetry = getattr(self.accelerator, "telemetry", None)
            if telemetry is not None and telemetry.enabled:
                telemetry.write_record("elastic", {
                    "event": "redundancy_allocated", "redundancy": self.config.redundancy,
                    "buddy_bytes_per_chip": self.buddy_bytes(), "mirror_every": self.config.mirror_every,
                })

    def buddy_bytes(self) -> int:
        """The bytes of buddy copies this process holds."""
        if self._buddy is None:
            return 0
        return sum(x.numel() * x.element_size() for part in self._buddy.values() for x in part if x is not None)

    def _buddy_fresh(self) -> bool:
        return self._buddy is not None and self._mirror_step == self.completed_steps

    # -- the ladder ----------------------------------------------------------------------

    def _telemetry(self):
        telemetry = getattr(self.accelerator, "telemetry", None)
        return telemetry if (telemetry is not None and telemetry.enabled) else None

    def reshard(self, lost_host: int) -> dict:
        """Walk the ladder for the loss of ``lost_host``; on success this
        process trains on the survivors' group. The lost process itself
        departs (:class:`HostLost`). Raises :class:`ElasticFailure` from
        the last rung."""
        t0 = time.perf_counter()
        telemetry = self._telemetry()
        if lost_host == self.host:
            self.lost_hosts.add(lost_host)
            self._depart()
            raise HostLost(f"host {lost_host} (this process) was lost at step boundary {self.completed_steps}")
        lost_ids = set(self.host_groups[lost_host]) & set(self.members)
        self.lost_hosts.add(lost_host)
        survivors = [m for m in self.members if m not in lost_ids]
        if telemetry is not None:
            telemetry.write_record("elastic", {"event": "host_loss_detected", "host": lost_host,
                                               "lost_devices": sorted(lost_ids), "survivors": len(survivors),
                                               "at_step": self.completed_steps})
        if not survivors or self._shrunk_parallelism(len(survivors)) is None:
            raise self._fail(lost_host, t0, telemetry, tried=[],
                             reason=f"{len(survivors)} surviving processes cannot form a training mesh (the "
                             "batch axes must absorb the shrink)")
        pause = telemetry.pause("elastic_reshard") if telemetry is not None else nullcontext()
        with pause:
            return self._run_ladder(lost_host, lost_ids, survivors, t0, telemetry)

    def _run_ladder(self, lost_host, lost_ids, survivors, t0, telemetry) -> dict:
        tried: list[str] = []
        rung = None
        steps_lost = 0
        old_members = list(self.members)
        psh, ssh = self._shardings(self._specs, old_members)
        per_host = self._per_host
        bpsh, bssh = buddy_shardings(psh, per_host), buddy_shardings(ssh, per_host)
        if self.config.redundancy:
            tried.append("buddy")
            if self._buddy_fresh():
                if tree_covered(self._param_shapes + self._state_shapes, psh + ssh, lost_ids, bpsh + bssh):
                    rung = "buddy"
                else:
                    logger.warning("elastic: buddy rung failed: a shard and its mirror are both on lost hosts; "
                                   "falling back to checkpoint.")
            else:
                logger.warning(f"elastic: buddy mirror is stale (last refreshed at step {self._mirror_step}, loss "
                               f"at step boundary {self.completed_steps}); falling back to checkpoint.")
        ckpt_path = None
        if rung is None and self.config.checkpoint_dir is not None:
            from ..fault_tolerance import latest_valid_checkpoint

            tried.append("checkpoint")
            ckpt_path = latest_valid_checkpoint(self.config.checkpoint_dir)
        if rung is None and ckpt_path is None:
            raise self._fail(lost_host, t0, telemetry, tried=tried,
                             reason="buddy mirror unavailable and no valid checkpoint found"
                             + (f" under {self.config.checkpoint_dir}" if self.config.checkpoint_dir
                                else " (no checkpoint_dir configured)"))
        # the membership transition first: its epoch names the rendezvous
        epoch = self.membership.resolve_loss(lost_host, reason=f"recovered_{rung or 'checkpoint'}") \
            if self.membership is not None else len(self.recoveries) + 1
        self._rebuild_mesh(survivors, epoch)
        specs = self._specs_for(self.accelerator.state.mesh_shape)
        if rung == "buddy":
            self._relay(psh, ssh, specs, lost_ids=lost_ids,
                        buddy=(self._buddy, bpsh, bssh), root=survivors[0])
        else:
            rung = "checkpoint"
            steps_lost = self._restore_checkpoint(ckpt_path, specs)
        self._recompile()
        self._buddy = None
        if self.config.redundancy:
            self._mirror()
        mttr = time.perf_counter() - t0
        report = {
            "event": "recovered", "rung": rung, "tried": tried, "host": lost_host,
            "lost_devices": sorted(lost_ids), "mesh": self._mesh_sizes(), "steps_lost": steps_lost,
            "resumed_at_step": self.completed_steps, "mttr_s": round(mttr, 4), "epoch": epoch,
        }
        if telemetry is not None:
            telemetry.write_record("elastic", report)
        self.last_recovery = report
        self.recoveries.append(report)
        logger.warning(f"elastic: recovered from host {lost_host} loss via {rung} rung in {mttr:.2f}s on mesh "
                       f"{self._mesh_sizes()} ({steps_lost} steps lost)")
        return report

    def _mesh_sizes(self) -> dict:
        return {axis: int(size) for axis, size in self.accelerator.state.mesh_shape.items()}

    def _fail(self, lost_host, t0, telemetry, tried, reason) -> ElasticFailure:
        record = {"event": "recovery_failed", "rung": "fail", "tried": tried, "host": lost_host,
                  "reason": reason, "mttr_s": round(time.perf_counter() - t0, 4)}
        if telemetry is not None:
            telemetry.write_record("elastic", record)
        self.last_recovery = record
        self.recoveries.append(record)
        return ElasticFailure(
            f"elastic recovery from host {lost_host} loss failed after trying {tried or ['nothing']}: {reason}. "
            "The run cannot continue correctly: restart from the last checkpoint, or enable "
            "ElasticConfig(redundancy=1) / a checkpoint_dir for in-memory recovery.")

    def _relay(self, psh, ssh, specs: _Specs, lost_ids=frozenset(), buddy=None, root=None,
               sources=None) -> None:
        """Move the params and the optimizer state from the old layout
        (``psh``/``ssh`` over the old members) onto ``specs`` over the
        live members, through the redistribution primitive, epoch-fenced;
        then the small state from ``root``."""
        npsh, nssh = self._shardings(specs, self.members)
        fence = EpochFence(self.membership.store, self.membership.epoch) if self.membership is not None else None
        held, bpsh, bssh = buddy if buddy is not None else (None, None, None)
        params, state = sources if sources is not None else (tree_leaves(self.model.params),
                                                              state_leaves(self.optimizer.opt_state))
        common = dict(member=self.member, rank_of=self._rank_of(self.members), device=self.optimizer.device,
                      lost_device_ids=lost_ids, fault_plan=self._chaos(), epoch_fence=fence,
                      telemetry=getattr(self.accelerator, "telemetry", None))
        new_params = redistribute(params, npsh, src_shardings=psh, paths=self._param_paths,
                                  buddy_tree=held["params"] if held else None, buddy_shardings=bpsh, **common)
        new_state = redistribute(state, nssh, src_shardings=ssh, paths=self._state_paths,
                                 buddy_tree=held["opt_state"] if held else None, buddy_shardings=bssh, **common)
        self._install(specs, new_params, new_state)
        self._sync_small_state(root)

    def _restore_checkpoint(self, path: str, specs: _Specs) -> int:
        """The checkpoint rung: the newest valid checkpoint loaded onto the
        survivors' layout (``load_state`` cuts each process's shard of the
        whole leaves), the step count rewound to it."""
        from ..fault_tolerance import checkpoint_step

        npsh, nssh = self._shardings(specs, self.members)
        device = self.optimizer.device
        old_state = state_leaves(self.optimizer.opt_state)
        params = [torch.zeros(sh.shard_shape(s), dtype=torch.float32, device=device)
                  for sh, s in zip(npsh, self._param_shapes)]
        state = [torch.zeros(sh.shard_shape(s), dtype=x.dtype, device=device)
                 for sh, s, x in zip(nssh, self._state_shapes, old_state)]
        self._install(specs, params, state)
        self.accelerator.load_state(path)
        ckpt_step = checkpoint_step(path)
        steps_lost = max(self.completed_steps - ckpt_step, 0)
        self.completed_steps = ckpt_step
        telemetry = self._telemetry()
        if telemetry is not None:
            telemetry.goodput.mark_restart()
        return steps_lost

    def _recompile(self) -> None:
        self._step = self.accelerator.compiled_step(self._loss_fn, model=self.model, **self._step_kwargs)

    # -- leaving and coming back ----------------------------------------------------------

    def _depart(self) -> None:
        """This process's host is lost: free every shard and buddy copy,
        stop beating, leave the group. It never joins another collective
        of this epoch."""
        self._departed = True
        self._stop_beating()
        def _freed(leaves):  # the dtypes stay: a returning process plans with them
            return [torch.empty(0, dtype=x.dtype, device=x.device) for x in leaves]

        self.model.params = tree_unflatten(self.model.params, _freed(tree_leaves(self.model.params)))
        self.optimizer.params = self.model.params
        self.optimizer.opt_state = state_unflatten(self.optimizer.opt_state,
                                                   _freed(state_leaves(self.optimizer.opt_state)))
        self._buddy = None
        self._step = None
        self.members = [m for m in self.members if self._host_of[m] != self.host]
        self.accelerator.state._partial.leave()
        telemetry = self._telemetry()
        if telemetry is not None:
            telemetry.write_record("elastic", {"event": "host_departed", "host": self.host,
                                               "at_step": self.completed_steps})

    def rejoin(self, timeout: float = 300.0, poll_s: float = 0.01) -> dict:
        """A departed process asks back in: its join record, then the wait
        for the members to admit it at a boundary (a new epoch that lists
        its host), the epoch's rendezvous, and its shards of the live state
        (it only receives). Returns the ``regrown`` report."""
        from .membership import EPOCH_KEY

        if not self._departed:
            raise RuntimeError("rejoin() is for a process whose host was lost")
        if self.membership is None:
            raise ElasticFailure("rejoin needs the membership store")
        t0 = time.perf_counter()
        self.membership.announce_join()
        deadline = time.monotonic() + timeout
        while True:
            record = self.membership.store.read(EPOCH_KEY) or {}
            if self.host in record.get("members", []):
                break
            if time.monotonic() > deadline:
                raise ElasticFailure(f"host {self.host} was not admitted within {timeout} s")
            time.sleep(poll_s)
        epoch = int(record["epoch"])
        self.membership._epoch = epoch  # admitted: this epoch is ours now
        hosts = sorted(int(h) for h in record["members"])
        old_members = self._members_of([h for h in hosts if h != self.host])
        self.lost_hosts = set(range(self.num_hosts)) - set(hosts)
        old_sizes = self._shrunk_parallelism(len(old_members)).axis_sizes(len(old_members))
        old = self._specs_for(old_sizes)
        psh, ssh = self._shardings(old, old_members)
        sources = ([torch.empty(sh.shard_shape(s), device="meta") for sh, s in zip(psh, self._param_shapes)],
                   [torch.empty(sh.shard_shape(s), dtype=x.dtype, device="meta")  # the freed leaves keep dtypes
                    for sh, s, x in zip(ssh, self._state_shapes, state_leaves(self.optimizer.opt_state))])
        self._rebuild_mesh(self._members_of(hosts), epoch)
        self._relay(psh, ssh, self._specs_for(self.accelerator.state.mesh_shape), root=old_members[0],
                    sources=sources)
        self._departed = False
        self._recompile()
        if self.config.redundancy:
            self._mirror()
        self._heartbeat()
        self._start_beating()
        report = {"event": "rejoined", "host": self.host, "epoch": epoch, "mesh": self._mesh_sizes(),
                  "resumed_at_step": self.completed_steps, "mttr_s": round(time.perf_counter() - t0, 4)}
        telemetry = self._telemetry()
        if telemetry is not None:
            telemetry.write_record("elastic", report)
        return report

    def regrow(self, hosts: Optional[list] = None) -> dict:
        """The returning host(s) come back, one epoch each: the members
        admit it (the epoch mint), meet it at the epoch's rendezvous and
        move the live state onto the regrown layout (a pure relayout: the
        staged rung; the returning process only receives). The full set of
        hosts restores the original layout exactly."""
        revive = sorted(set(hosts) if hosts is not None else set(self.lost_hosts))
        unknown = set(revive) - self.lost_hosts
        if unknown:
            raise ValueError(f"cannot regrow hosts {sorted(unknown)}: not lost")
        report = {"event": "regrown", "hosts": [], "mttr_s": 0.0}
        for host in revive:
            report = self._regrow_one(host)
        return report

    def _regrow_one(self, host: int) -> dict:
        t0 = time.perf_counter()
        telemetry = self._telemetry()
        if self.membership is None:
            raise ElasticFailure("regrow across processes needs the membership store (the epoch names the "
                                 "rendezvous the returning process meets the members at)")
        pause = telemetry.pause("elastic_reshard") if telemetry is not None else nullcontext()
        with pause:
            old_members = list(self.members)
            psh, ssh = self._shardings(self._specs, old_members)
            epoch = self.membership.admit(host)
            self.lost_hosts.discard(host)
            self._rebuild_mesh(sorted(old_members + self.host_groups[host]), epoch)
            self._relay(psh, ssh, self._specs_for(self.accelerator.state.mesh_shape), root=old_members[0])
            self._recompile()
            if self.config.redundancy:
                self._mirror()
        report = {"event": "regrown", "hosts": [host], "mesh": self._mesh_sizes(),
                  "resumed_at_step": self.completed_steps, "mttr_s": round(time.perf_counter() - t0, 4),
                  "epoch": epoch}
        if telemetry is not None:
            telemetry.write_record("elastic", report)
        self.recoveries.append(report)
        logger.info(f"elastic: regrew host {host} onto mesh {self._mesh_sizes()} in {report['mttr_s']:.2f}s")
        return report
