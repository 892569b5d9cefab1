"""Helpers shared by the port's parity tests: a once-per-session cache
(``once``) for ``test_torch_parallel.py`` and the fleet tests, and the two
packages' serving fleets behind one surface for ``test_torch_fleet.py`` and
``test_torch_fleet_telemetry.py`` (llama-tiny in fp32 with the JAX package's
weights, engines of 2 slots of 64 tokens by default)."""

import functools
import pickle
import time
from types import SimpleNamespace

import numpy as np
import pytest
from filelock import FileLock

import jax
import torch

import accelerate_tpu.resilience as jax_resilience
import accelerate_tpu.serving as jax_serving
import accelerate_tpu.telemetry as jax_telemetry
import accelerate_tpu.telemetry.serving as jax_telemetry_serving
import accelerate_tpu_torch.resilience as port_resilience
import accelerate_tpu_torch.serving as port_serving
import accelerate_tpu_torch.telemetry as port_telemetry
import accelerate_tpu_torch.telemetry.serving as port_telemetry_serving
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu_torch import Llama, ServingEngine, load_jax_params

MODEL = "llama-tiny"


def once(request, tmp_path_factory, name, compute):
    """``compute()`` once per session: under xdist the first worker to ask
    computes and pickles it under the session's shared temporary directory,
    the others read it."""
    if getattr(request.config, "workerinput", None) is None:
        return compute()
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        data = compute()
        path.write_bytes(pickle.dumps(data))
        return data


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


class Recorder:
    """A telemetry sink: every record written, in order."""

    enabled = True

    def __init__(self):
        self.records = []

    def write_record(self, kind, payload):
        self.records.append((kind, payload))
        return payload

    def of(self, kind, drop=()):
        """The records of ``kind``, without the fields named in ``drop``."""
        return [{k: v for k, v in p.items() if k not in drop} for k_, p in self.records if k_ == kind]


@functools.lru_cache(maxsize=None)
def sides():
    """The two packages behind one surface: ``engine(**kwargs)`` builds an
    engine over the package's llama-tiny with the same weights, ``spec``
    a speculative config drafting with that model; only the port's side
    has ``model``."""
    jax_model = JaxLlama(MODEL)
    params = jax_model.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    port_model = load_jax_params(Llama(MODEL, device="cpu"), tree)
    return {
        "jax": SimpleNamespace(
            serving=jax_serving, resilience=jax_resilience, telemetry=jax_telemetry,
            stats=jax_telemetry_serving,
            engine=lambda **kw: jax_serving.ServingEngine(jax_model, params, **kw),
            spec=lambda **kw: jax_serving.SpeculativeConfig(draft_model=jax_model, draft_params=params, **kw),
        ),
        "port": SimpleNamespace(
            serving=port_serving, resilience=port_resilience, telemetry=port_telemetry,
            stats=port_telemetry_serving,
            engine=lambda **kw: ServingEngine(port_model, device="cpu", **kw),
            spec=lambda **kw: port_serving.SpeculativeConfig(draft_model=port_model, **kw),
            model=port_model,
        ),
    }


def prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1024, (n,)).astype(np.int32) for n in lengths]


def router(side, n=2, roles=None, engine=None, **kwargs):
    engine = {"num_slots": 2, "max_len": 64, **(engine or {})}
    return side.serving.ServingRouter(
        engine_factory=lambda: side.engine(**engine), num_replicas=n if roles is None else len(roles),
        roles=roles, **kwargs,
    )


def step_all(router, seconds=60.0):
    """Results through ``step()`` (a dict would hide a duplicate). Bounded
    in time: a handoff retry waits out its backoff on the wall clock."""
    results = []
    deadline = time.monotonic() + seconds
    while router.busy:
        if time.monotonic() > deadline:
            raise AssertionError("the fleet did not drain")
        results.extend(router.step())
    return results


def scenario_runs(request, tmp_path_factory, prefix, scenarios):
    """A getter of each scenario's (jax, port) results, computed once per
    session and shared by the workers."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = once(request, tmp_path_factory, f"{prefix}_{name}",
                               lambda: (scenarios[name](sides()["jax"]), scenarios[name](sides()["port"])))
        return cache[name]

    return get


# -- elastic training, the redistribution primitive and LocalSGD across processes --

ELASTIC_ROWS, ELASTIC_SEQ, ELASTIC_STEPS = 24, 128, 8  # 24 rows: whole over 8, 6, 4 and 3 shards


def elastic_inputs():
    """llama-tiny's params from the JAX package's seed, the global batches,
    and the redistribution cases (whole values, specs at 4 and at 3
    processes, the scratch bound)."""
    params = jax.tree.map(np.asarray, JaxLlama(MODEL).init(jax.random.key(0)))
    rng = np.random.default_rng(18)
    batches = [rng.integers(0, 1024, (ELASTIC_ROWS, ELASTIC_SEQ)).astype(np.int32) for _ in range(ELASTIC_STEPS)]
    cases = []
    for trial in range(3):
        f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
        i = lambda *shape: rng.integers(-9, 9, shape).astype(np.int32)  # noqa: E731
        cases.append((
            [f(12 * (trial + 1), 8), i(24), f(24, 4, 2 + trial), f(5, 3), np.asarray(3.0 + trial, np.float32)],
            [("data",), ("data",), (None, "data"), (), ()],
            [("data",), ("data",), ("data", None), (), ()],
            [64, 4096, 1 << 20][trial],
        ))
    return params, batches, cases


def _jax_reset():
    from accelerate_tpu.state import AcceleratorState, GradientState, PartialState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def jax_elastic(params, batches, kind, ckpt_dir=None):
    """The JAX package's ElasticCoordinator on its 8 devices, 4 hosts of 2,
    on the port's schedules: ``"drill"`` (host 1 lost at boundary 3, the
    buddy rung; regrow before step 6), ``"checkpoint"`` (mirror every 2
    steps, a checkpoint at step 2, host 2 lost at boundary 4), ``"fail"``
    (no redundancy, no checkpoint, host 1 lost at boundary 2), ``"fp16"``
    (fp16 with its loss scaler, host 0 lost at boundary 3, 3 steps; the
    scale and growth tracker before and after the shrink). Each loop runs
    the boundary's recovery before it takes its batch, as the port's
    harness does."""
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator, ElasticConfig, ElasticFailure, FaultPlan, ResilienceConfig

    _jax_reset()
    plan = {"drill": FaultPlan(host_loss_step=3, host_loss_index=1),
            "checkpoint": FaultPlan(host_loss_step=4, host_loss_index=2),
            "fail": FaultPlan(host_loss_step=2, host_loss_index=1),
            "fp16": FaultPlan(host_loss_step=3, host_loss_index=0)}[kind]
    config = {"drill": ElasticConfig(redundancy=1, num_hosts=4),
              "checkpoint": ElasticConfig(redundancy=1, num_hosts=4, mirror_every=2, checkpoint_dir=ckpt_dir),
              "fail": ElasticConfig(redundancy=0, num_hosts=4),
              "fp16": ElasticConfig(redundancy=1, num_hosts=4)}[kind]
    acc = Accelerator(mixed_precision="fp16" if kind == "fp16" else "no",
                      resilience_config=ResilienceConfig(guard=None, fault_plan=plan))
    model = JaxLlama(MODEL)
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params))
    optimizer = acc.prepare_optimizer(optax.adamw(1e-3))
    coordinator = acc.elastic_coordinator(JaxLlama.loss_fn(model), config=config)
    losses, steps, scaler = {}, {"drill": 8, "checkpoint": 6, "fail": 2, "fp16": 3}[kind], {}
    try:
        while coordinator.completed_steps < steps:
            if kind == "fp16" and coordinator.completed_steps == 2:
                scaler["before"] = (float(optimizer.scale), int(optimizer.growth_tracker))
            if kind == "checkpoint" and coordinator.completed_steps == 2 and not losses.get("saved"):
                acc.save_state(f"{ckpt_dir}/checkpoint_2", manifest_metadata={"step": 2})
                losses["saved"] = True
            if kind == "drill" and coordinator.completed_steps == 5 and coordinator.lost_hosts:
                coordinator.regrow()
            lost = coordinator._detect_loss()
            if lost is not None:
                coordinator.reshard(lost)
            if kind == "fp16" and coordinator.completed_steps == 2:
                scaler["after"] = (float(optimizer.scale), int(optimizer.growth_tracker))
            i = coordinator.completed_steps
            losses[i] = float(coordinator.step({"input_ids": batches[i]}))  # host rows: placed on the live mesh
    except ElasticFailure as error:
        out = {"error": str(error), "last": coordinator.last_recovery}
        _jax_reset()
        return out
    losses.pop("saved", None)
    out = {"losses": losses, "params": dict(flatten_params(jax.tree.map(np.asarray, prepared.params))),
           "recoveries": coordinator.recoveries, "scaler": scaler}
    _jax_reset()
    return out


def jax_local_sgd(params, batches):
    """The JAX package's LocalSGD with 4 workers (``data=4``): k=2, k=1 and
    ``enabled=False`` over 4 steps; each worker's replica after each step."""
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator, LocalSGD, ParallelismConfig

    out = {}
    for name, k, enabled in (("k2", 2, True), ("k1", 1, True), ("off", 2, False)):
        _jax_reset()
        acc = Accelerator(parallelism=ParallelismConfig(data=4, fsdp=2))
        model = JaxLlama(MODEL)
        prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params))
        replicas, losses = [], []
        with LocalSGD(acc, prepared, optax.adamw(1e-3), local_sgd_steps=k, enabled=enabled) as lsgd:
            for batch in batches[:4]:
                losses.append(float(lsgd.step(JaxLlama.loss_fn(model), {"input_ids": jnp.asarray(batch)})))
                replicas.append(dict(flatten_params(jax.tree.map(np.asarray, lsgd.params))))
        out[name] = {"losses": losses, "replicas": replicas,
                     "final": dict(flatten_params(jax.tree.map(np.asarray, prepared.params)))}
    _jax_reset()
    return out


def flatten_params(tree, prefix=""):
    from accelerate_tpu_torch.utils.params import flatten_tree

    return flatten_tree(tree, prefix)


def elastic_launch(request, tmp_path_factory):
    """Every process's results of ``torch_elastic_workers.suite`` (one
    launch of 4 gloo processes), the SIGKILL drill's (its own 4), and the
    JAX package's references, computed side by side once per session."""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_elastic_workers as workers

    from accelerate_tpu_torch.launchers import debug_launcher

    def compute():
        params, batches, cases = elastic_inputs()
        root = tmp_path_factory.mktemp("elastic")
        with ThreadPoolExecutor(2) as pool:
            suite = pool.submit(debug_launcher, workers.suite, (str(root / "port"), params, batches, cases),
                                num_processes=4, timeout=600)
            killed = pool.submit(sigkill_launch, str(root / "sigkill"), params, batches)
            out = jax_references(params, batches, str(root / "jax"))
            out["port"] = suite.result()
            out["sigkill"] = killed.result()
        out["cases"] = cases
        return out

    if "launch" not in _ELASTIC:  # the three test modules share it in one process too
        _ELASTIC["launch"] = once(request, tmp_path_factory, "torch_elastic_launch", compute)
    return _ELASTIC["launch"]


_ELASTIC: dict = {}


def _jax_references_child(params, batches, root: str, out_path: str) -> None:
    import os

    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except Exception:  # noqa: BLE001 - older jax: XLA_FLAGS (inherited) forces the 8 devices
        pass
    out = {"jax": {kind: jax_elastic(params, batches, kind, os.path.join(root, kind))
                   for kind in ("drill", "checkpoint", "fail", "fp16")},
           "jax_local_sgd": jax_local_sgd(params, batches)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def jax_references(params, batches, root: str, attempts: int = 3) -> dict:
    """The JAX package's coordinator and LocalSGD runs, in a process of
    their own: the JAX package's ``device_put`` onto a rolled mesh (its
    buddy mirror) has aborted the whole interpreter on this host now and
    then (ROADMAP §3), which must not take the test worker with it. A run
    that crashes is run again, up to ``attempts`` times; its results, when
    it ends, are what the tests compare."""
    import multiprocessing
    import os

    ctx = multiprocessing.get_context("spawn")
    codes = []
    for attempt in range(attempts):
        out_path = os.path.join(root, f"references{attempt}.pkl")
        proc = ctx.Process(target=_jax_references_child,
                           args=(params, batches, os.path.join(root, f"run{attempt}"), out_path))
        proc.start()
        proc.join(900)
        if proc.is_alive():
            proc.kill()
            proc.join()
        codes.append(proc.exitcode)
        if proc.exitcode == 0:
            with open(out_path, "rb") as f:
                return pickle.load(f)
    raise RuntimeError(f"the JAX package's reference runs ended with exit codes {codes}")


def _sigkill_rank(rank: int, env: dict, args: tuple) -> None:
    import os

    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    import torch_elastic_workers as workers

    workers.sigkill(*args)


def sigkill_launch(base, params, batches, timeout: float = 300.0):
    """The SIGKILL drill's own harness (a lost rank's death is its point,
    not a failed launch): 4 fresh processes, rank 3 must end by SIGKILL and
    the 3 others with 0; returns each survivor's results and the exit
    codes."""
    import multiprocessing
    import os

    os.makedirs(os.path.join(base, "out"), exist_ok=True)
    env = {"WORLD_SIZE": "4", "OMP_NUM_THREADS": "1"}
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sigkill_rank, args=(r, env, (base, params, batches, os.path.join(base, "out"))))
             for r in range(4)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(deadline - time.monotonic(), 0))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    results = {}
    for rank in range(3):
        path = os.path.join(base, "out", f"rank{rank}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                results[rank] = pickle.load(f)
    return {"exit_codes": [proc.exitcode for proc in procs], "survivors": results}
