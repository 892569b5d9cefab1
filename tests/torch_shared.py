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
