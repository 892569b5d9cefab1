"""What each process of the elastic, redistribution and LocalSGD tests runs.

Kept apart from the test modules so the processes the port's
``debug_launcher`` starts import torch and the port only, never JAX. Every
scenario forms its own process group (its own rendezvous file and
membership store under the launch's directory) and leaves it at its end, so
one launch runs them all in turn; every function returns plain Python and
numpy.
"""

import os
import signal
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from accelerate_tpu_torch import (
    Accelerator,
    CompilationConfig,
    ElasticConfig,
    ElasticFailure,
    FaultPlan,
    FilesystemStore,
    InitProcessGroupKwargs,
    LocalSGD,
    Llama,
    MembershipConfig,
    MembershipService,
    ResilienceConfig,
    TelemetryConfig,
    fused_adamw,
    load_jax_params,
)
from accelerate_tpu_torch.parallel.redistribute import (
    EpochFence,
    ProcessSharding,
    RedistributeConfig,
    RedistributeError,
    plan_redistribute,
    redistribute,
    reset_transfer_seq,
)
from accelerate_tpu_torch.resilience.elastic import HostLost
from accelerate_tpu_torch.resilience.membership import EPOCH_KEY, StaleEpochError
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState, leave_process_group
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin, ParallelismConfig
from accelerate_tpu_torch.utils.params import flatten_tree, state_leaves

MODEL = "llama-tiny"
LR = 1e-3
FLASH_MIN_SEQ = 128
GLOO_TIMEOUT_S = 60
HEARTBEAT_TIMEOUT_S = 3.0  # above any pause of a loaded host: a live process is never named
# the drill: host 1 of 4 lost by chaos at boundary 3, back at boundary 6
LOSS_AT, REGROW_AT, DRILL_STEPS = 3, 6, 8


def _reset() -> None:
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _numpy_tree(tree) -> dict:
    return {k: v.detach().cpu().float().numpy().copy() for k, v in flatten_tree(tree)}


def _rank() -> int:
    return int(os.environ["RANK"])


def _group_env(base: str, name: str) -> str:
    """A scenario's own directory and rendezvous (the launcher's is used
    once): the process group of the scenario forms there."""
    root = os.path.join(base, name)
    os.makedirs(root, exist_ok=True)
    os.environ["ACCELERATE_INIT_METHOD"] = f"file://{os.path.join(root, 'init')}"
    return root


def _end() -> None:
    leave_process_group()
    _reset()


def _accelerator(root: str, plan=None, **options) -> Accelerator:
    _reset()
    torch.use_deterministic_algorithms(True)  # the CPU embedding backward adds in no fixed order otherwise
    return Accelerator(
        device="cpu", compilation_config=CompilationConfig(flash_attention_min_seq=FLASH_MIN_SEQ),
        resilience_config=ResilienceConfig(guard=None, fault_plan=plan) if plan is not None else None,
        telemetry_config=TelemetryConfig(dir=root),
        kwargs_handlers=[InitProcessGroupKwargs("gloo", timeout=timedelta(seconds=GLOO_TIMEOUT_S))], **options)


def _recorded(acc) -> list:
    """Every record this process's telemetry is given (the hub writes only
    rank 0's to its file)."""
    records = []
    write = acc.telemetry.write_record

    def record(kind, payload):
        records.append((kind, dict(payload)))
        return write(kind, payload)

    acc.telemetry.write_record = record
    return records


def _state(prepared, optimizer) -> dict:
    """The whole params and optimizer state (a collective)."""
    return {"params": _numpy_tree(prepared.full_params()),
            "state": [x.detach().cpu().numpy().copy() for x in state_leaves(optimizer.state_dict()["opt_state"])]}


def _same(a: dict, b: dict) -> bool:
    return (a["params"].keys() == b["params"].keys()
            and all(np.array_equal(a["params"][k], b["params"][k]) for k in a["params"])
            and all(np.array_equal(x, y) for x, y in zip(a["state"], b["state"])))


def _elastic(root, params, plan=None, config=None, num_hosts=4, mixed_precision="no", **options):
    acc = _accelerator(root, plan, mixed_precision=mixed_precision, **options)
    records = _recorded(acc)
    model = load_jax_params(Llama(MODEL, device="cpu"), params)
    prepared = acc.prepare_model(model)
    optimizer = acc.prepare_optimizer(fused_adamw(LR))
    per_host = acc.num_processes // num_hosts
    membership = MembershipService(FilesystemStore(os.path.join(root, "membership")), num_hosts=num_hosts,
                                   host_index=_rank() // per_host,
                                   config=MembershipConfig(heartbeat_timeout_s=HEARTBEAT_TIMEOUT_S))
    config = config or ElasticConfig(redundancy=1, num_hosts=num_hosts)
    coordinator = acc.elastic_coordinator(Llama.loss_fn(model), config=config, membership=membership)
    return acc, prepared, optimizer, coordinator, records


def _wait_for(predicate, timeout: float = 120.0, poll: float = 0.005) -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise TimeoutError("the drill's harness waited too long")
        time.sleep(poll)


def _members_at(coordinator, step: int) -> bool:
    """Whether every member host has published a heartbeat at ``step``."""
    store = coordinator.membership.store
    hosts = coordinator.membership.view()["members"]
    beats = [store.read(f"hosts/{h}") for h in hosts if h != coordinator.host]
    return all(b is not None and int(b["step"]) >= step for b in beats)


def drill(base: str, params: dict, batches: list) -> dict:
    """The chaos drill: llama-tiny on 4 processes, one host a process, the
    buddy mirror every step; host 1 lost at boundary 3 (the buddy rung) and
    back at boundary 6 by its join record (the staged regrow). The whole
    state is gathered around each relayout."""
    root = _group_env(base, "drill")
    plan = FaultPlan(host_loss_step=LOSS_AT, host_loss_index=1)
    acc, prepared, optimizer, coordinator, records = _elastic(root, params, plan)
    losses, checks, mirror_bytes = {}, {}, coordinator.buddy_bytes()
    handled = set()
    while coordinator.completed_steps < DRILL_STEPS:
        i = coordinator.completed_steps
        if i + 1 in (LOSS_AT, REGROW_AT) and i + 1 not in handled:
            handled.add(i + 1)
            if i + 1 == REGROW_AT:  # the returning host has asked back in: every member sees its record
                _wait_for(lambda: coordinator.membership.pending_joins())
            before = _state(prepared, optimizer)
            try:
                coordinator.boundary()
            except HostLost:
                # this process's host is lost: it holds nothing, and asks
                # back in once every member has beaten at the step before
                # the regrow's boundary
                _wait_for(lambda: _members_at(coordinator, REGROW_AT - 1))
                coordinator.rejoin()
                handled.add(REGROW_AT)
                _state(prepared, optimizer)  # the members' gather after the regrow
                continue
            checks[i + 1] = {"bit_equal": _same(before, _state(prepared, optimizer)),
                             "members": list(coordinator.members)}
        losses[i] = float(coordinator.step({"input_ids": batches[i]}))
    out = {"losses": losses, "checks": checks, "final": _state(prepared, optimizer),
           "recoveries": coordinator.recoveries, "records": records, "mirror_bytes": mirror_bytes,
           "members": coordinator.members, "epoch": coordinator.membership.epoch,
           "shapes": {k: tuple(v.shape) for k, v in flatten_tree(prepared.params)},
           "adamw_leaves": len(state_leaves(optimizer.opt_state))}
    _end()
    return out


def checkpoint_rung(base: str, params: dict, batches: list) -> dict:
    """The checkpoint rung: the mirror every 2 steps, a checkpoint at step
    2, host 2 lost at boundary 4 (the mirror is a step stale): the
    survivors reload the checkpoint and re-run from it."""
    root = _group_env(base, "checkpoint")
    ckpt = os.path.join(root, "ckpt")
    plan = FaultPlan(host_loss_step=4, host_loss_index=2)
    config = ElasticConfig(redundancy=1, num_hosts=4, mirror_every=2, checkpoint_dir=ckpt)
    acc, prepared, optimizer, coordinator, records = _elastic(root, params, plan, config)
    losses, saved = {}, False
    while coordinator.completed_steps < 6:
        if coordinator.completed_steps == 2 and not saved:
            acc.save_state(os.path.join(ckpt, "checkpoint_2"), manifest_metadata={"step": 2})
            saved = True
        try:
            # the boundary first: the checkpoint rung rewinds the step count,
            # and the loop takes its batch from the count
            coordinator.boundary()
        except HostLost:
            out = {"lost": True, "recoveries": coordinator.recoveries}
            _reset()
            return out
        i = coordinator.completed_steps
        losses[i] = float(coordinator.step({"input_ids": batches[i]}))
    out = {"lost": False, "losses": losses, "final": _state(prepared, optimizer),
           "recoveries": coordinator.recoveries, "records": records}
    _end()
    return out


def nothing_left(base: str, params: dict, batches: list) -> dict:
    """No redundancy and no checkpoint: the ladder fails loudly, recorded;
    then a loss whose survivors cannot form a mesh fails on its own rung."""
    root = _group_env(base, "nothing_left")
    plan = FaultPlan(host_loss_step=2, host_loss_index=1)
    acc, prepared, optimizer, coordinator, records = _elastic(root, params, plan, ElasticConfig(redundancy=0,
                                                                                                num_hosts=4))
    coordinator.step({"input_ids": batches[0]})
    out = {}
    try:
        coordinator.step({"input_ids": batches[1]})
    except HostLost:
        out = {"lost": True}
        _reset()
        return out
    except ElasticFailure as error:
        out = {"lost": False, "error": str(error), "last": coordinator.last_recovery}
    coordinator._shrunk_parallelism = lambda n: None
    try:
        coordinator.reshard(lost_host=[h for h in range(4) if h not in coordinator.lost_hosts and
                                       h != coordinator.host][0])
    except ElasticFailure as error:
        out["infeasible"] = str(error)
        out["infeasible_last"] = coordinator.last_recovery
    out["records"] = [r for r in records if r[0] == "elastic"]
    _end()
    return out


def fp16_scaler(base: str, params: dict, batches: list) -> dict:
    """fp16 with its loss scaler across a shrink that loses host 0 (the
    process a naive read of the replicated scale would read from)."""
    root = _group_env(base, "fp16")
    plan = FaultPlan(host_loss_step=3, host_loss_index=0)
    acc, prepared, optimizer, coordinator, records = _elastic(root, params, plan, mixed_precision="fp16")
    out = {"losses": []}
    for i in range(2):
        out["losses"].append(float(coordinator.step({"input_ids": batches[i]})))
    out["scale_before"] = float(optimizer.scale)
    out["growth_before"] = int(optimizer.growth_tracker)
    try:
        coordinator.boundary()
    except HostLost:
        _reset()
        return {"lost": True}
    out["scale_after"] = float(optimizer.scale)
    out["growth_after"] = int(optimizer.growth_tracker)
    out["losses"].append(float(coordinator.step({"input_ids": batches[2]})))
    out["rung"] = coordinator.last_recovery["rung"]
    out["lost"] = False
    _end()
    return out


def stage2(base: str, params: dict, batches: list) -> dict:
    """FSDP stage 2 (params whole, moments over fsdp) on 2 hosts of 2
    processes: host 1 lost at boundary 2; the moments stay sharded over the
    2 survivors, and the whole state crosses the shrink bit for bit."""
    root = _group_env(base, "stage2")
    plan = FaultPlan(host_loss_step=2, host_loss_index=1)
    plugin = FullyShardedDataParallelPlugin(stage=2, min_weight_size=16)
    acc, prepared, optimizer, coordinator, records = _elastic(root, params, plan, num_hosts=2, fsdp_plugin=plugin)
    coordinator.step({"input_ids": batches[0]})
    before = _state(prepared, optimizer)
    try:
        coordinator.boundary()
    except HostLost:
        _reset()
        return {"lost": True}
    after = _state(prepared, optimizer)
    out = {"lost": False, "bit_equal": _same(before, after), "mesh": dict(acc.state.mesh_shape),
           "param_shapes": [tuple(x.shape) for _, x in flatten_tree(prepared.params)],
           "state_shapes": [tuple(x.shape) for x in state_leaves(optimizer.opt_state)],
           "whole_state_shapes": [x.shape for x in after["state"]],
           "loss": float(coordinator.step({"input_ids": batches[1]}))}
    _end()
    return out


def remesh(base: str) -> dict:
    """A prepared loader (``split_batches``, prefetch 2) over 24 rows, 12 a
    global batch: one batch consumed by 4 processes, then process 3 leaves
    and the 3 others form a new group; the next batch, prefetched for the
    old group, is cut again for the new one."""
    from accelerate_tpu_torch.data_loader import prepare_data_loader

    root = _group_env(base, "remesh")
    _accelerator(root)
    state = PartialState()
    rows = np.arange(24 * 2, dtype=np.int64).reshape(24, 2)
    loader = prepare_data_loader([{"x": r} for r in rows], batch_size=12, split_batches=True, prefetch=2,
                                 device="cpu")
    it = iter(loader)
    first = next(it)["x"].numpy().copy()
    time.sleep(0.2)  # the producer has the next batch ready for the old group
    rank = state.process_index
    if rank == 3:
        it.close()
        _end()
        return {"first": first, "left": True}
    state.rejoin(rank, 3, f"file://{os.path.join(root, 'second')}")
    second = next(it)["x"].numpy().copy()
    it.close()
    _end()
    return {"first": first, "second": second, "left": False}


def redistribution(base: str, cases: list) -> dict:
    """The redistribution primitive across the 4 processes: each case's
    leaves (whole values, the same on every process) relaid 4 -> 3 -> 4
    on the staged rung (process 2 only sends, then only receives), the
    shrink also on the relay; a chaos-killed stage, the forced staged
    rung, and a zombie transfer refused at commit."""
    _group_env(base, "redistribute")
    _accelerator(os.path.join(base, "redistribute"))
    me = dist.get_rank()
    out = {"roundtrip": [], "plans": []}

    def local(x, sharding):
        x = np.asarray(x)
        if me not in sharding.members:
            return torch.empty(sharding.shard_shape(x.shape), dtype=torch.from_numpy(x).dtype, device="meta")
        t = torch.empty(sharding.shard_shape(x.shape), dtype=torch.from_numpy(x).dtype)
        for box, offset in sharding.pieces(x.shape, sharding.members.index(me)):
            t[tuple(slice(o, o + hi - lo) for (lo, hi), o in zip(box, offset))] = torch.from_numpy(
                np.ascontiguousarray(x[tuple(slice(lo, hi) for lo, hi in box)]))
        return t

    for values, specs4, specs3, scratch in cases:
        src = [ProcessSharding.of(range(4), {"data": 4}, s) for s in specs4]
        dst = [ProcessSharding.of([0, 1, 3], {"data": 3}, s) for s in specs3]
        config = RedistributeConfig(max_scratch_bytes=scratch)
        tree = [local(x, s) for x, s in zip(values, src)]
        shrunk = redistribute(tree, dst, src_shardings=src, member=me, config=config)
        relayed = redistribute(tree, dst, src_shardings=src, member=me, config=RedistributeConfig(force_path="relay"))
        held = [a if a is not None else local(x, d) for a, x, d in zip(shrunk, values, dst)]
        back = redistribute(held, src, src_shardings=dst, member=me, device="cpu", config=config)
        ok = all(torch.equal(a, local(x, d)) and torch.equal(a, b)
                 for a, b, x, d in zip(shrunk, relayed, values, dst) if me in d.members)
        ok &= all(torch.equal(a, t) for a, t in zip(back, tree))
        ok &= all(a is None for a, d in zip(shrunk, dst) if me not in d.members)
        out["roundtrip"].append(bool(ok))
        plan = plan_redistribute(tree, dst, src_shardings=src, config=config)
        out["plans"].append({"rung": plan.rung, "kinds": plan.stage_kinds, "peak": plan.peak_scratch_bytes,
                             "stages": [s.nbytes for s in plan.stages]})

    values, specs4, specs3, _ = cases[0]
    src = [ProcessSharding.of(range(4), {"data": 4}, s) for s in specs4]
    dst = [ProcessSharding.of([0, 1, 3], {"data": 3}, s) for s in specs3]
    tree = [local(x, s) for x, s in zip(values, src)]
    copies = [t.clone() for t in tree]
    config = RedistributeConfig(max_scratch_bytes=64)

    class Sink:
        enabled = True

        def __init__(self):
            self.records = []

        def write_record(self, kind, payload):
            self.records.append({"kind": kind, **payload})

    reset_transfer_seq()
    sink = Sink()
    killed = redistribute(tree, dst, src_shardings=src, member=me, config=config,
                          fault_plan=FaultPlan(redistribute_fail_at=(0,), redistribute_fail_stage=2), telemetry=sink)
    out["killed"] = {
        "source_intact": all(torch.equal(a, b) for a, b in zip(tree, copies)),
        "result": all(torch.equal(a, local(x, d)) for a, x, d in zip(killed, values, dst) if me in d.members),
        "records": sink.records,
    }
    try:
        redistribute(tree, dst, src_shardings=src, member=me,
                     config=RedistributeConfig(max_scratch_bytes=64, force_path="staged"),
                     fault_plan=FaultPlan(redistribute_fail_at=(1,), redistribute_fail_stage=1))
        out["forced"] = None
    except RedistributeError as error:
        out["forced"] = str(error)
    store = FilesystemStore(os.path.join(base, "redistribute", "membership"))
    if me == 0:
        store.write(EPOCH_KEY, {"epoch": 3, "members": [0, 1, 2, 3]})
    dist.barrier()
    fence = EpochFence(store, 3)

    calls = []

    def zombie():  # the view moves on mid-transfer (once every process is past its plan-time check)
        calls.append(1)
        if len(calls) == 1:
            dist.barrier()
            store.write(EPOCH_KEY, {"epoch": 4, "members": [0, 1, 3]})

    sink = Sink()
    try:
        redistribute(tree, dst, src_shardings=src, member=me, config=config, epoch_fence=fence, probe=zombie,
                     telemetry=sink)
        out["zombie"] = None
    except StaleEpochError as error:
        out["zombie"] = {"error": str(error), "outcomes": [r["outcome"] for r in sink.records],
                         "source_intact": all(torch.equal(a, b) for a, b in zip(tree, copies))}
    dist.barrier()
    _end()
    return out


def local_sgd(base: str, params: dict, batches: list) -> dict:
    """LocalSGD on the 4 processes (one worker each): k=2 over 4 steps with
    each worker's replica after every step; k=1; enabled=False; a step
    outside the context."""
    out = {}
    for name, k, enabled in (("k2", 2, True), ("k1", 1, True), ("off", 2, False)):
        acc = _accelerator(_group_env(base, f"local_sgd_{name}"))
        model = load_jax_params(Llama(MODEL, device="cpu"), params)
        prepared = acc.prepare_model(model)
        acc.prepare_optimizer(fused_adamw(LR))
        rows = batches[0].shape[0] // acc.num_processes
        index = acc.process_index

        def share(b):
            return {"input_ids": torch.tensor(b[index * rows:(index + 1) * rows])}

        replicas, losses, presync = [], [], []
        with LocalSGD(acc, prepared, fused_adamw(LR), local_sgd_steps=k, enabled=enabled) as lsgd:
            sync = lsgd._sync

            def recorded():  # each replica just before the average
                presync.append(_numpy_tree(lsgd.params))
                sync()

            lsgd._sync = recorded
            for batch in batches[:4]:
                losses.append(float(lsgd.step(Llama.loss_fn(model), share(batch))))
                replicas.append(_numpy_tree(lsgd.params))
        out[name] = {"losses": losses, "replicas": replicas, "presync": presync,
                     "final": _numpy_tree(prepared.full_params())}
        try:
            lsgd.step(Llama.loss_fn(model), share(batches[0]))
            out[name]["outside"] = None
        except RuntimeError as error:
            out[name]["outside"] = str(error)
        _end()
    return out


def suite(base: str, params: dict, batches: list, cases: list) -> dict:
    """Every scenario of one launch, in turn."""
    torch.set_num_threads(1)
    out = {"local_sgd": local_sgd(base, params, batches), "redistribute": redistribution(base, cases),
           "remesh": remesh(base), "drill": drill(base, params, batches),
           "checkpoint": checkpoint_rung(base, params, batches), "nothing_left": nothing_left(base, params, batches),
           "fp16": fp16_scaler(base, params, batches), "stage2": stage2(base, params, batches)}
    return out


def sigkill(base: str, params: dict, batches: list, out_dir: str) -> None:
    """A real death: 4 processes, the buddy mirror every step; process 3
    kills itself (SIGKILL) after step 2. The survivors' next boundary
    collective fails, the detector names host 3 by its heartbeat silence,
    the buddy rung recovers (the whole state bit-equal to the state before
    the death: no half step read) and training goes on. Each survivor
    writes its results to ``out_dir`` (the dead one cannot)."""
    import pickle

    torch.set_num_threads(1)
    root = _group_env(base, "sigkill")
    acc, prepared, optimizer, coordinator, records = _elastic(root, params)
    losses = {}
    for i in range(2):
        losses[i] = float(coordinator.step({"input_ids": batches[i]}))
    before = _state(prepared, optimizer)
    if coordinator.member == 3:
        os.kill(os.getpid(), signal.SIGKILL)
    t0 = time.perf_counter()
    coordinator.boundary()
    seconds = time.perf_counter() - t0
    after = _state(prepared, optimizer)
    for i in range(2, 4):
        losses[i] = float(coordinator.step({"input_ids": batches[i]}))
    out = {"losses": losses, "recoveries": coordinator.recoveries, "members": coordinator.members,
           "bit_equal": _same(before, after), "seconds": seconds,
           "suspected": [e for e in coordinator.membership.events if e["event"] == "host_suspected"]}
    with open(os.path.join(out_dir, f"rank{coordinator.member}.pkl"), "wb") as f:
        pickle.dump(out, f)
    _end()
