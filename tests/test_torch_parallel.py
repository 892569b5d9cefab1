"""Training across processes: the port at 2 and 4 gloo processes on the CPU
against the JAX package on its 8-device virtual mesh (``tests/conftest.py``).

The port's processes are started by its own ``debug_launcher``; each runs
``torch_parallel_workers.suite`` (torch and the port only, no JAX) once per
world size, and every rank's results come back as numpy. The launches and
the JAX reference runs happen once per test session, side by side (the two
launches in threads, the JAX runs meanwhile; a file under the session's
shared temporary directory carries them between xdist workers), so the
tests here only compare.

Tolerances, and why:
- losses: rtol 1e-5 in fp32 (the same sums in other orders: per process,
  then across processes, against XLA's);
- params after N updates: as ``test_torch_training.py``: Adam moves a
  param by about ``lr`` a step whatever its gradient's size, so a gradient
  near 0 whose rounding differs can move it by up to ``2 * lr``: the
  largest difference is held to ``2 * lr * N`` and the mean one to 1e-5;
- every process ends with the same params, bit for bit;
- the update gate at 2 processes: tolerance 0 (a reduce-scatter and an
  all-reduce of two terms add the same two numbers); at 4 processes gloo's
  two collectives may add in different orders, and the gap is held to
  ``GATE_4_ATOL`` (fp32 rounding of 10 Adam steps);
- checkpoints crossing packages: bit for bit (a copy).
"""

import ast
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import FullyShardedDataParallelPlugin as JaxFSDP
from accelerate_tpu import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.data_loader import BatchSamplerShard as JaxBatchSamplerShard
from accelerate_tpu.data_loader import IterableDatasetShard as JaxIterableDatasetShard
from accelerate_tpu.data_loader import SeedableRandomSampler as JaxSeedableRandomSampler
from accelerate_tpu.models import GPT2 as JaxGPT2
from accelerate_tpu.models import Bert as JaxBert
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.models import T5 as JaxT5
from accelerate_tpu.parallel import sharding as jax_sharding
from accelerate_tpu.parallel.ring_attention import make_ring_attention as jax_make_ring_attention
from accelerate_tpu.parallel.zero import zero_update_state_bytes as jax_zero_update_state_bytes
from accelerate_tpu.resilience import FaultPlan as JaxFaultPlan
from accelerate_tpu.resilience import GuardPolicy as JaxGuardPolicy
from accelerate_tpu.resilience import ResilienceConfig as JaxResilienceConfig
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils.constants import CANONICAL_MESH_AXES
from accelerate_tpu_torch import T5, Accelerator, Bert, Llama
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.parallel import sharding as port_sharding
from accelerate_tpu_torch.parallel.zero import zero_update_state_bytes
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig
from accelerate_tpu_torch.utils.params import flatten_tree, tree_paths

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as workers  # noqa: E402 - the launches' processes import it by this name
from torch_shared import once  # noqa: E402

MODEL = workers.MODEL
LR = workers.LR
GLOBAL_BATCH, SEQ = 8, 128  # 8 rows: one a device on JAX's mesh, 2 or 4 a process here
N_BATCHES = 4  # compiled configurations: 4 updates; the eager window of 2: 2 updates
GATE_4_ATOL = 1e-6
WORLD_CONFIGS = {
    2: ["zero", "replicated", "fsdp2", "fsdp3", "fsdp3_offload", "zero_eager"],
    4: ["zero", "replicated", "fsdp2", "fsdp3", "zero_data_fsdp"],
}
# the JAX package's configuration of each kind, on its 8 devices
JAX_TRAINING = {
    "zero": (dict(), dict(clip_grad_norm=0.5), 0),
    "replicated": (dict(parallelism=JaxParallelismConfig(zero_stage=0)), dict(), 0),
    "fsdp2": (dict(fsdp_plugin=JaxFSDP(stage=2, min_weight_size=16)), dict(), 0),
    "fsdp3": (dict(fsdp_plugin=JaxFSDP(stage=3, min_weight_size=16)), dict(), 0),
    "zero_eager": (dict(gradient_accumulation_steps=2), dict(), 2),
    "zero_data_fsdp": (dict(parallelism=JaxParallelismConfig(data=4, fsdp=2)), dict(), 0),
    "seq2": (dict(parallelism=JaxParallelismConfig(sequence=2)), dict(), 0),
    "seq2_fsdp2": (dict(parallelism=JaxParallelismConfig(sequence=2, fsdp=2)), dict(), 0),
}
# the sequence axis at each world size: the ring's and the forwards' size, the
# training configurations, the loader's mesh
SEQUENCE_CONFIGS = {
    2: dict(size=2, train=["seq2"], loader_mesh=dict(sequence=2)),
    4: dict(size=4, train=["seq2_fsdp2"], loader_mesh=dict(sequence=2, fsdp=2)),
}
RING_TOL = 1e-5  # fp32: the same exact attention, blocks merged in another order
JAX_OF = {"fsdp3_offload": "fsdp3"}  # the same arithmetic, state kept on the host


def _reset():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _shared_dir(tmp_path_factory, request, name):
    root = tmp_path_factory.getbasetemp()
    if getattr(request.config, "workerinput", None) is not None:
        root = root.parent
    path = root / f"torch_parallel_{name}"
    path.mkdir(exist_ok=True)
    return path


@pytest.fixture(scope="module")
def init_params():
    return jax.tree.map(np.asarray, JaxLlama(MODEL).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 1024, (GLOBAL_BATCH, SEQ)).astype(np.int32) for _ in range(N_BATCHES)]


def _jax_train(kind, params, batches):
    _reset()
    options, step_options, window = JAX_TRAINING[kind]
    acc = JaxAccelerator(**options)
    model = JaxLlama(MODEL)
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params))
    optimizer = acc.prepare_optimizer(optax.adamw(LR))
    losses = []
    if window:
        for batch in batches:
            with acc.accumulate():
                losses.append(float(acc.backward(JaxLlama.loss_fn(model), {"input_ids": jnp.asarray(batch)})))
                optimizer.step()
                optimizer.zero_grad()
    else:
        step = acc.compiled_step(JaxLlama.loss_fn(model), **step_options)
        losses = [float(step({"input_ids": jnp.asarray(batch)})) for batch in batches]
    out = {"losses": losses, "params": dict(flatten_tree(jax.tree.map(np.asarray, prepared.params))),
           "steps": optimizer.step_count}
    _reset()
    return out


def _jax_guarded(params, batches):
    """The JAX package's guarded ZeRO step on its 8 devices, the same chaos
    plan as the workers' ``guarded``: NaN at step 2 of 3."""
    _reset()
    config = JaxResilienceConfig(guard=JaxGuardPolicy(check_every=3), fault_plan=JaxFaultPlan(nan_steps=(2,)))
    acc = JaxAccelerator(resilience_config=config)
    model = JaxLlama(MODEL)
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params))
    acc.prepare_optimizer(optax.adamw(LR))
    step = acc.compiled_step(JaxLlama.loss_fn(model))
    losses = [float(step({"input_ids": jnp.asarray(batch)})) for batch in batches[:3]]
    out = {"losses": losses, "params": dict(flatten_tree(jax.tree.map(np.asarray, prepared.params))),
           "skipped": acc.resilience.guard.skipped_steps}
    _reset()
    return out


@pytest.fixture(scope="module")
def jax_runs(launches):
    """The JAX package's training runs (computed beside the launches)."""
    return launches["jax_runs"]


def _jax_checkpoint(directory, params, batches):
    """The JAX package, fsdp over its 8 devices: one step, a sharded save."""
    _reset()
    acc = JaxAccelerator(fsdp_plugin=JaxFSDP(stage=3, min_weight_size=16))
    model = JaxLlama(MODEL)
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params))
    optimizer = acc.prepare_optimizer(optax.adamw(LR))
    acc.compiled_step(JaxLlama.loss_fn(model))({"input_ids": jnp.asarray(batches[1])})
    acc.save_state(str(directory), sharded=True)
    out = {"params": dict(flatten_tree(jax.tree.map(np.asarray, prepared.params))),
           "state": [np.asarray(x) for x in jax.tree.leaves(optimizer.opt_state)]}
    _reset()
    return out


def _ring_cases() -> dict:
    """The ring's inputs (``tests/test_ring_attention.py``'s cases at a
    length whose chunks the flash path tiles), with a cotangent each."""
    rng = np.random.default_rng(40)
    cases = {}
    for name, (kv, causal, padded) in {"causal": (4, True, False), "noncausal": (4, False, False),
                                      "padded": (4, True, True), "gqa": (2, True, False)}.items():
        f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
        mask = None
        if padded:
            mask = np.ones((2, 512), np.int32)
            mask[0, :130] = 0  # left padding on row 0, past the first chunk at 4
        cases[name] = dict(q=f(2, 512, 4, 16), k=f(2, 512, kv, 16), v=f(2, 512, kv, 16), cot=f(2, 512, 4, 16),
                           mask=mask, causal=causal)
    return cases


def _forward_cases() -> dict:
    """The sequence axis's forwards: (ids, attention mask)."""
    rng = np.random.default_rng(41)
    ids = lambda s: rng.integers(0, 1024, (2, s)).astype(np.int32)  # noqa: E731
    left = np.ones((2, 64), np.int32)
    left[0, :16] = 0
    right = np.ones((2, 64), np.int32)
    right[1, 48:] = 0
    return {"llama": (ids(64), None), "llama_padded": (ids(64), left), "llama_indivisible": (ids(63), None),
            "bert_padded": (ids(64), right), "gpt2": (ids(64), None), "gpt2_padded": (ids(64), left)}


@pytest.fixture(scope="module")
def bert_params():
    return jax.tree.map(np.asarray, JaxBert("bert-tiny").init(jax.random.key(0)))


@pytest.fixture(scope="module")
def gpt2_params():
    return jax.tree.map(np.asarray, JaxGPT2("gpt2-tiny").init(jax.random.key(0)))


@pytest.fixture(scope="module")
def launches(request, tmp_path_factory, init_params, batches, bert_params, gpt2_params):
    """Every rank's results of the suite at 2 and at 4 processes, and the
    JAX checkpoint the 2-process suite loaded."""
    ckpt = _shared_dir(tmp_path_factory, request, "ckpt")

    def launch(world):
        names = WORLD_CONFIGS[world]
        dirs = (str(ckpt / "jax"), str(ckpt / "port")) if world == 2 else (None, None)
        config = SEQUENCE_CONFIGS[world]
        sequence = dict(size=config["size"], ring=_ring_cases(), bert_params=bert_params,
                        gpt2_params=gpt2_params, forwards=_forward_cases(),
                        loader_mesh=config["loader_mesh"],
                        remat_ids=np.random.default_rng(42).integers(0, 1024, (2, 256)).astype(np.int32))
        return debug_launcher(workers.suite, (names + config["train"], init_params, batches, *dirs, sequence),
                              num_processes=world, timeout=420)

    def compute():
        out = {"jax_checkpoint": _jax_checkpoint(ckpt / "jax", init_params, batches)}
        # the two launches run side by side (one thread a process), and the
        # JAX references here meanwhile: the slowest of the three sets the wait
        with ThreadPoolExecutor(len(WORLD_CONFIGS)) as pool:
            futures = {world: pool.submit(launch, world) for world in WORLD_CONFIGS}
            out["jax_runs"] = {kind: _jax_train(kind, init_params, batches) for kind in JAX_TRAINING}
            out["jax_guarded"] = _jax_guarded(init_params, batches)
            out["jax_ring"] = _jax_ring()
            out["jax_forwards"] = _jax_forwards(init_params, bert_params, gpt2_params)
            out.update({world: future.result() for world, future in futures.items()})
        out["port_checkpoint"] = str(ckpt / "port")
        return out

    return once(request, tmp_path_factory, "torch_parallel_launches", compute)


# -- (i) the layout engine ------------------------------------------------------


def _jax_mesh(data, fsdp):
    devices = np.asarray(jax.devices()[: data * fsdp]).reshape((data, fsdp, 1, 1, 1, 1))
    return Mesh(devices, CANONICAL_MESH_AXES)


@pytest.mark.parametrize("data,fsdp", [(2, 1), (4, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("model_name", ["llama-tiny", "bert-tiny", "t5-tiny"])
def test_partition_rules_give_the_jax_specs(model_name, data, fsdp):
    """Every leaf's spec under the model's rules (stage 3), with the ZeRO
    fold over the data axes, and stage 1/2's optimizer-state layout: the
    JAX package's ``PartitionSpec`` entry for entry (T5's rules match its
    nested ``encoder/`` and ``layers/`` paths)."""
    classes = {"llama": (JaxLlama, Llama), "bert": (JaxBert, Bert), "t5": (JaxT5, T5)}[model_name.split("-")[0]]
    jax_model, port_model = classes[0](model_name), classes[1](model_name, device="cpu")
    shapes = jax.eval_shape(jax_model.init, jax.random.key(0))
    mesh = _jax_mesh(data, fsdp)
    sizes = dict(mesh.shape)
    plugin = JaxFSDP(min_weight_size=16)
    port_plugin = workers.FullyShardedDataParallelPlugin(min_weight_size=16)
    jax_rules = jax_sharding.PartitionRules(jax_model.partition_rules())
    port_rules = port_sharding.PartitionRules(port_model.partition_rules())
    jax_specs = jax_sharding.infer_shardings(shapes, mesh, jax_rules)
    jax_zero = jax_sharding.zero_update_shardings(shapes, jax_specs, mesh)
    jax_stage2 = jax_sharding.infer_shardings(
        shapes, mesh, jax_sharding.PartitionRules(jax_model.partition_rules(), fsdp_plugin=plugin,
                                                  apply_fsdp_to_params=False).with_fsdp_applied())
    tree = port_model.param_tree()
    port_specs = port_sharding.infer_shardings(tree, sizes, port_rules)
    port_zero = port_sharding.zero_update_shardings(tree, port_specs, sizes)
    port_stage2 = port_sharding.infer_shardings(
        tree, sizes, port_sharding.PartitionRules(port_model.partition_rules(), fsdp_plugin=port_plugin,
                                                  apply_fsdp_to_params=False).with_fsdp_applied())
    for want_tree, got_tree in ((jax_specs, port_specs), (jax_zero, port_zero), (jax_stage2, port_stage2)):
        want = {k.replace(".", "/"): tuple(v.spec) for k, v in flatten_tree(want_tree)}
        got = dict(tree_paths(got_tree))
        assert set(got) == set(want)
        assert got == want
    # the fold reaches every weight big enough: something is split at every size
    assert any(port_sharding.sharded_dims(s, sizes) for _, s in tree_paths(port_zero))


def test_fold_update_spec_matches_jax_on_odd_shapes():
    """The fold's corner cases: a spec already split, no divisible dim, a
    dim divisible by fsdp but not by fsdp x data (the fold moves to another
    dim), a scalar."""
    mesh = _jax_mesh(4, 2)
    sizes = dict(mesh.shape)
    axes = jax_sharding.zero_batch_axes(mesh)
    assert port_sharding.zero_batch_axes(sizes) == axes == ("data", "fsdp")
    cases = [((8, 10), ("fsdp", None)), ((6, 10), (None, "fsdp")), ((8, 10), (None, "fsdp")), ((3, 5), ()),
             ((), ()), ((16, 4), (None, None)), ((2, 64, 128), ("pipeline", "fsdp", "tensor"))]
    for shape, spec in cases:
        want = tuple(jax_sharding.fold_update_spec(shape, jax.sharding.PartitionSpec(*spec), mesh, axes))
        assert port_sharding.fold_update_spec(shape, spec, sizes, axes) == want, (shape, spec)


# -- (ii) training against the JAX package --------------------------------------


def _assert_params_close(want, got, steps):
    assert set(got) == set(want)
    for key in want:
        diff = np.abs(got[key] - want[key])
        assert diff.max() <= 2 * LR * steps, f"{key}: {diff.max()}"
        assert diff.mean() <= 1e-5, f"{key}: mean {diff.mean()}"


@pytest.mark.parametrize("world,name", [(w, n) for w, names in WORLD_CONFIGS.items() for n in names])
def test_training_matches_the_jax_mesh(launches, jax_runs, world, name):
    """Losses and params of each configuration at ``world`` gloo processes
    against the JAX ``Accelerator`` of the same kind on 8 devices, at the
    same global batch; every process agrees with every other bit for bit."""
    ranks = [launches[world][r][f"train/{name}"] for r in range(world)]
    want = jax_runs[JAX_OF.get(name, name)]
    for rank in ranks[1:]:
        assert rank["losses"] == ranks[0]["losses"]
        for key in ranks[0]["params"]:
            np.testing.assert_array_equal(rank["params"][key], ranks[0]["params"][key], err_msg=key)
    got = ranks[0]
    assert got["steps"] == want["steps"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _assert_params_close(want["params"], got["params"], want["steps"])
    assert got["mesh"]["data"] * got["mesh"]["fsdp"] == world


@pytest.mark.parametrize("world", sorted(WORLD_CONFIGS))
def test_guarded_zero_update_skips_bit_exactly_and_matches_the_jax_mesh(launches, world):
    """Under the ZeRO sharded update a poisoned step is skipped on every
    process (the verdict reads the global norm): params and optimizer state
    equal a clean run over the other batches bit for bit, and the params
    stay within the training tolerance of the JAX package's guarded ZeRO
    step on its 8 devices."""
    ranks = [launches[world][r]["guarded"] for r in range(world)]
    got, clean = ranks[0]["guarded"], ranks[0]["clean"]
    assert got["zero"] and all(rank["guarded"]["skipped"] == 1 for rank in ranks)
    # the NaN is in the gradients: the losses are finite, the skipped step's too
    assert got["losses"][0] == clean["losses"][0] and got["losses"][2] == clean["losses"][1]
    for key in clean["params"]:
        np.testing.assert_array_equal(got["params"][key], clean["params"][key], err_msg=key)
    for a, b in zip(got["state"], clean["state"]):
        np.testing.assert_array_equal(a, b)
    want = launches["jax_guarded"]
    assert want["skipped"] == 1
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _assert_params_close(want["params"], got["params"], 2)


def _elements(shapes):
    return sum(int(np.prod(s)) for s in shapes.values())


@pytest.mark.parametrize("world", [2, 4])
def test_zero_stores_one_nth_of_params_and_state(launches, world):
    """Under ZeRO each process stores 1/N of the params (the module's own
    weights emptied) and of the optimizer state; the replicated update
    stores all of both."""
    zero = [launches[world][r]["train/zero"] for r in range(world)]
    replicated = launches[world][0]["train/replicated"]
    full = _elements(replicated["stored_shapes"])
    assert sum(_elements(z["stored_shapes"]) for z in zero) == full
    assert all(z["module_emptied"] for z in zero) and not replicated["module_emptied"]
    state = sum(z["state_bytes"] for z in zero)
    assert abs(state - replicated["state_bytes"]) <= 4 * world  # the step count is held by every process
    assert replicated["distributed_type"] == "DATA_PARALLEL"


def test_fsdp_stage_2_keeps_params_whole_and_shards_the_state(launches):
    ranks = [launches[2][r]["train/fsdp2"] for r in range(2)]
    replicated = launches[2][0]["train/replicated"]
    assert ranks[0]["stored_shapes"] == replicated["stored_shapes"]
    assert not ranks[0]["module_emptied"]
    assert ranks[0]["state_bytes"] < 0.6 * replicated["state_bytes"]
    assert ranks[0]["distributed_type"] == "FSDP"


def test_cpu_offload_keeps_the_state_on_the_host(launches):
    """(vi) Stage 3 with ``cpu_offload``: the state's tensors live on the
    host between steps, and the training is stage 3's bit for bit (at 2
    processes a reduce-scatter and an all-reduce add the same two terms)."""
    for r in range(2):
        offloaded = launches[2][r]["train/fsdp3_offload"]
        assert offloaded["state_devices"] == ["cpu"]
        plain = launches[2][r]["train/fsdp3"]
        assert offloaded["losses"] == plain["losses"]
        for key in plain["params"]:
            np.testing.assert_array_equal(offloaded["params"][key], plain["params"][key], err_msg=key)


def test_zero_state_bytes_match_the_jax_sizing():
    assert zero_update_state_bytes(134_105_856, 4, 2) == jax_zero_update_state_bytes(134_105_856, 4, 2)
    assert zero_update_state_bytes(1001, 2, 8) == jax_zero_update_state_bytes(1001, 2, 8)


# -- (iii) the update-equivalence gate -------------------------------------------


def _gate_gap(ranks):
    sharded, replicated = ranks[0]["gate/sharded"], ranks[0]["gate/replicated"]
    gaps = [np.abs(sharded["params"][k] - replicated["params"][k]).max() for k in sharded["params"]]
    gaps += [np.abs(a - b).max() for a, b in zip(sharded["state"], replicated["state"])]
    return max(float(g) for g in gaps), sharded, replicated


def test_sharded_update_equals_the_replicated_one_bit_for_bit_at_two(launches):
    """10 eager steps of seeded gradients (each process its own draw): the
    ZeRO update against the replicated one, params and optimizer state
    gathered, tolerance 0; the sharded side holds half the state."""
    gap, sharded, replicated = _gate_gap(launches[2])
    assert gap == 0.0
    assert sharded["state_bytes"] < 0.55 * replicated["state_bytes"]


def test_sharded_update_at_four_stays_within_fp32_rounding(launches):
    gap, sharded, replicated = _gate_gap(launches[4])
    assert gap <= GATE_4_ATOL, gap
    assert sharded["state_bytes"] < 0.3 * replicated["state_bytes"]


# -- (iv) collectives and loaders -------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_across_processes(launches, world):
    outs = [launches[world][r]["collectives"] for r in range(world)]
    for r, out in enumerate(outs):
        assert out["rank"] == r and out["world"] == world
        np.testing.assert_array_equal(out["gather"]["t"], np.concatenate([np.arange(3) + 10 * p for p in range(world)]))
        np.testing.assert_array_equal(out["gather"]["s"], np.arange(world, dtype=np.float32))
        assert isinstance(out["gather_numpy"], np.ndarray) and out["gather_numpy"].shape == (2 * world, 2)
        assert out["gather_object"] == [x for p in range(world) for x in (f"p{p}", p)]
        np.testing.assert_array_equal(out["broadcast"], [world - 1.0] * 2)
        assert out["broadcast_object_list"] == [1, {"from": 1}]
        np.testing.assert_array_equal(out["reduce_sum"], [world, sum(range(world))])
        np.testing.assert_allclose(out["reduce_mean"], [2.0 * sum(range(world)) / world])
        assert out["pad"].shape == (world, 2) and (out["pad"][r + 1:] == -1).all() and (out["pad"][: r + 1] == 1).all()
        assert np.asarray(out["pad_first"]).shape == (2, world)
        assert out["any_false"] is False and out["any_one"] is True
        assert out["metrics"]["step_ms"] == {"min": 10.0, "max": 10.0 + world - 1, "mean": 10.0 + (world - 1) / 2}
        assert "flag" not in out["metrics"]
        assert out["rng"] == outs[0]["rng"]  # process 0's states everywhere
        assert "shape mismatches" in out["debug_mismatch"] and "Process 1" in out["debug_mismatch"]
    base, extra = divmod(7, world)
    sizes = [base + (1 if p < extra else 0) for p in range(world)]
    starts = np.cumsum([0] + sizes)
    for p, out in enumerate(outs):
        mine = list(range(starts[p], starts[p + 1]))
        assert out["split"] == mine + [6] * (max(sizes) - len(mine))  # padded with the last element
    assert [x for out in outs for x in out["split_dict"]] == list(range(5))


def _jax_shard_rows(n_rows, batch_size, world, rank, **kwargs):
    sampler = JaxSeedableRandomSampler(n_rows, seed=7)
    sampler.set_epoch(1)
    shard = JaxBatchSamplerShard(JaxBatchSampler(sampler, batch_size=batch_size), num_processes=world,
                                 process_index=rank, **kwargs)
    return [list(b) for b in shard]


@pytest.mark.parametrize("world", [2, 4])
def test_loaders_shard_as_the_jax_package(launches, world):
    """Each process's rows: the shuffled round-robin shards and
    ``split_batches`` against the JAX package's ``BatchSamplerShard`` at
    the same process index, an iterable dataset's shard and the
    dispatcher's slices against its ``IterableDatasetShard``;
    ``gather_for_metrics`` over an epoch gives every row once (the padded
    tail dropped)."""
    n_rows = 21
    outs = [launches[world][r]["loaders"] for r in range(world)]
    for r, out in enumerate(outs):
        assert out["shuffled"] == _jax_shard_rows(n_rows, 2, world, r)
        sequential = JaxBatchSamplerShard(JaxBatchSampler(range(n_rows), batch_size=4 * world), world, r,
                                          split_batches=True)
        assert out["split"] == [list(b) for b in sequential]
        stream = JaxIterableDatasetShard(range(n_rows), batch_size=2, num_processes=world, process_index=r)
        rows = list(stream)
        assert out["iterable"] == [rows[i:i + 2] for i in range(0, len(rows), 2)]
        assert out["dispatched"] == out["iterable"]
    gathered = [x for batch in outs[0]["metrics"] for x in batch]
    assert sorted(gathered) == list(range(n_rows))
    assert all(out["metrics"] == outs[0]["metrics"] for out in outs)
    assert outs[0]["gather_plain"] == [len(outs[0]["shuffled"])] * world


# -- (v) sharded checkpoints cross packages -----------------------------------


def test_port_sharded_checkpoint_loads_into_the_jax_package(launches, init_params):
    """Two port processes (ZeRO over data=2) write ``save_state(sharded=True)``:
    each its own chunks; the JAX package on 8 devices loads them bit for bit."""
    saved = launches[2][0]["checkpoints"]["saved"]
    assert {f for f in saved["files"] if f.startswith("model_0.shard")} >= {
        "model_0.shard00000.index.json", "model_0.shard00001.index.json"}
    _reset()
    acc = JaxAccelerator()
    model = JaxLlama(MODEL)
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, init_params))
    optimizer = acc.prepare_optimizer(optax.adamw(LR))
    acc.load_state(launches["port_checkpoint"])
    got = dict(flatten_tree(jax.tree.map(np.asarray, prepared.params)))
    for key, value in saved["params"].items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    for a, b in zip(jax.tree.leaves(optimizer.opt_state), saved["state"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert optimizer.step_count == 1
    _reset()


def test_jax_sharded_checkpoint_loads_into_port_processes(launches):
    """The JAX package's sharded save (fsdp over 8 devices) loads into two
    port processes holding the ZeRO layout (data=2): params and state bit
    for bit."""
    want = launches["jax_checkpoint"]
    for r in range(2):
        loaded = launches[2][r]["checkpoints"]["loaded"]
        for key, value in want["params"].items():
            np.testing.assert_array_equal(loaded["params"][key], value, err_msg=key)
        for a, b in zip(loaded["state"], want["state"]):
            np.testing.assert_array_equal(a, b)
        assert loaded["steps"] == 1


# -- (vii) what waits for model parallelism -------------------------------------


@pytest.mark.parametrize("axis", ["tensor", "pipeline", "expert"])
def test_model_parallel_axes_raise_naming_item_17(axis):
    """The tensor, expert and pipeline axes (item 17(c) brought the last)
    run across processes (``tests/test_torch_tensor_parallel.py``,
    ``tests/test_torch_pipeline.py``), each named as the JAX package names
    it; on one process an axis of 2 raises for the mesh it cannot cover."""
    config = ParallelismConfig(**{axis: 2})
    assert config.distributed_type == {"tensor": "TENSOR_PARALLEL", "pipeline": "PIPELINE_PARALLEL",
                                       "expert": "HYBRID"}[axis]
    _reset()
    with pytest.raises(ValueError, match="not divisible"):
        Accelerator(device="cpu", parallelism=config)
    _reset()


def test_fsdp_plugin_sizes_the_mesh_and_checkpoints_activations():
    """``fsdp_plugin`` alone sizes the fsdp axis to every process (one
    here), and its ``activation_checkpointing`` is ``remat_policy=
    "save_flash"`` unless the config names a policy."""
    _reset()
    acc = Accelerator(device="cpu", fsdp_plugin=workers.FullyShardedDataParallelPlugin(activation_checkpointing=True))
    assert acc.state.mesh_shape["fsdp"] == 1 and acc.compilation_config.remat_policy == "save_flash"
    _reset()
    acc = Accelerator(device="cpu", fsdp_plugin=workers.FullyShardedDataParallelPlugin(activation_checkpointing=True),
                      compilation_config=workers.CompilationConfig(remat_policy="full"))
    assert acc.compilation_config.remat_policy == "full"
    _reset()


def test_one_process_keeps_the_single_device_path():
    """A world of one: no process group, no mesh, ``distributed_type``
    NO; an fsdp axis above 1 does not fit one device."""
    _reset()
    acc = Accelerator(device="cpu")
    assert acc.mesh is None and acc.num_processes == 1 and str(acc.distributed_type) == "NO"
    assert acc.state.mesh_shape["data"] == 1
    _reset()
    with pytest.raises(ValueError, match="not divisible"):
        Accelerator(device="cpu", parallelism=ParallelismConfig(fsdp=2))
    _reset()
    with pytest.raises(ValueError, match="zero_stage=1"):
        Accelerator(device="cpu", parallelism=ParallelismConfig(zero_stage=1))
    _reset()


# -- the launcher ------------------------------------------------------------------


def test_a_failing_process_fails_the_launch_within_seconds():
    """Process 1 raises while process 0 waits for it in a collective: the
    launch raises with process 1's traceback, and process 0 is stopped."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="process 1 of 2 failed(.|\n)*rank 1 gives up"):
        debug_launcher(workers.fail_on_rank_one, num_processes=2, timeout=120)
    assert time.monotonic() - t0 < 60


def test_workers_import_nothing_of_jax():
    path = workers.__file__
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import) for alias in node.names]
    names += [node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module]
    assert not [n for n in names if n.split(".")[0] in ("jax", "optax", "accelerate_tpu")]


# -- (viii) the sequence axis: ring attention --------------------------------------


def _jax_ring():
    """JAX's ``make_ring_attention`` at ``sequence=4`` on its 8 devices:
    each case's output and the q, k, v gradients of ``sum(out * cot)``."""
    _reset()
    state = JaxPartialState(parallelism=JaxParallelismConfig(sequence=4))
    out = {}
    for name, c in _ring_cases().items():
        ring = jax_make_ring_attention(state.mesh, causal=c["causal"])
        mask = None if c["mask"] is None else jnp.asarray(c["mask"])
        qkv = [jnp.asarray(c[n]) for n in ("q", "k", "v")]
        cot = jnp.asarray(c["cot"])
        got = jax.jit(ring)(*qkv, mask)
        grads = jax.jit(jax.grad(lambda q, k, v: (ring(q, k, v, mask) * cot).sum(), argnums=(0, 1, 2)))(*qkv)
        out[name] = [np.asarray(x) for x in (got, *grads)]
    _reset()
    return out


@pytest.fixture(scope="module")
def jax_ring(launches):
    return launches["jax_ring"]


@pytest.mark.parametrize("case", ["causal", "noncausal", "padded", "gqa"])
@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_the_jax_ring(launches, jax_ring, world, case):
    """The port's ring over 2 and 4 gloo processes (each its chunk, K/V
    rotating) against JAX's ring over its sequence axis of 4: the output
    and the q, k, v gradients through the ring (the hops' backward, the
    blocks' lse cotangent), atol 1e-5."""
    chunks = [launches[world][r]["ring"][case] for r in range(world)]
    got = [np.concatenate([c[i] for c in chunks], axis=1) for i in range(4)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, jax_ring[case]):
        np.testing.assert_allclose(g, w, rtol=0, atol=RING_TOL, err_msg=name)


def _jax_forwards(init_params, bert_params, gpt2_params):
    models = {"bert": (JaxBert("bert-tiny"), bert_params), "gpt2": (JaxGPT2("gpt2-tiny"), gpt2_params)}
    out = {}
    for name, (ids, mask) in _forward_cases().items():
        jmask = None if mask is None else jnp.asarray(mask)
        m, p = models.get(name.split("_")[0], (JaxLlama(MODEL), init_params))
        out[name] = np.asarray(m.apply(jax.tree.map(jnp.asarray, p), jnp.asarray(ids), attention_mask=jmask))
    return out


@pytest.fixture(scope="module")
def jax_forwards(launches):
    return launches["jax_forwards"]


@pytest.mark.parametrize("case", list(_forward_cases()))
@pytest.mark.parametrize("world", [2, 4])
def test_sequence_forwards_match_the_jax_models(launches, jax_forwards, world, case):
    """Prepared models under ``ParallelismConfig(sequence=world)`` called
    on the global rows, against the JAX models' plain forward, 2e-4 (the
    JAX package's tests): llama's and gpt2's chunks of the logits
    concatenated (real positions under padding; gpt2's learned positions at
    each chunk's offset, as ``tests/test_ring_attention.py`` holds JAX's
    sequence-parallel gpt2), the whole logits on every process at a
    length the ring does not divide (the einsum fallback), bert's logits
    from the process holding position 0 and zeros elsewhere."""
    want = jax_forwards[case]
    ranks = [launches[world][r]["forwards"][case] for r in range(world)]
    ids, mask = _forward_cases()[case]
    if case == "llama_indivisible":
        assert all(r["span"] == (0, 63) for r in ranks)
        for r in ranks:
            np.testing.assert_allclose(r["out"], want, atol=2e-4)
        return
    if case.startswith("bert"):
        np.testing.assert_allclose(ranks[0]["out"], want, atol=2e-4)
        assert all(not r["out"].any() for r in ranks[1:])
        return
    assert [r["span"] for r in ranks] == [(i * 64 // world, (i + 1) * 64 // world) for i in range(world)]
    got = np.concatenate([r["out"] for r in ranks], axis=1)
    real = np.ones(ids.shape, bool) if mask is None else mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=2e-4)


@pytest.mark.parametrize("world,name", [(w, n) for w, c in SEQUENCE_CONFIGS.items() for n in c["train"]])
def test_sequence_training_matches_the_jax_mesh(launches, jax_runs, world, name):
    """llama-tiny trained under ``sequence=2`` (and ``fsdp=2`` at 4
    processes): each process runs its half of every row of its batch shard,
    the losses and gradients summed over the sequence group; losses at rtol
    1e-5 and params at the tolerances above against the JAX package's mesh,
    every process ending bit-equal, the replicated update (ZeRO is
    ineligible under a sequence axis, as in the JAX package)."""
    ranks = [launches[world][r][f"train/{name}"] for r in range(world)]
    want = jax_runs[name]
    for rank in ranks[1:]:
        assert rank["losses"] == ranks[0]["losses"]
        for key in ranks[0]["params"]:
            np.testing.assert_array_equal(rank["params"][key], ranks[0]["params"][key], err_msg=key)
    got = ranks[0]
    assert got["steps"] == want["steps"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _assert_params_close(want["params"], got["params"], want["steps"])
    mesh = got["mesh"]
    assert mesh["sequence"] == 2 and mesh["data"] * mesh["fsdp"] * mesh["sequence"] == world
    assert got["distributed_type"] == ("HYBRID" if mesh["fsdp"] > 1 else "TENSOR_PARALLEL")


def test_remat_under_the_ring_is_bit_equal(launches):
    """One step under ``remat_policy`` "full" (a recomputed layer re-runs
    its hops) and "save_flash" (the stash replays each block) equals the
    step without remat, bit for bit, on both processes; the processes
    agree."""
    for r in range(2):
        runs = launches[2][r]["remat"]
        for policy in ("full", "save_flash"):
            assert runs[policy]["loss"] == runs["None"]["loss"], policy
            for key, value in runs["None"]["params"].items():
                np.testing.assert_array_equal(runs[policy]["params"][key], value, err_msg=f"{policy} {key}")
    assert launches[2][0]["remat"]["None"]["loss"] == launches[2][1]["remat"]["None"]["loss"]


@pytest.mark.parametrize("world", [2, 4])
def test_sequence_loader_shards_by_the_batch_axes(launches, world):
    """Under a sequence axis the processes of one sequence group take the
    same rows: the JAX package's ``BatchSamplerShard`` over the batch axes
    only (one shard at sequence=2, fsdp's two at sequence=2, fsdp=2)."""
    outs = [launches[world][r]["sequence_loader"] for r in range(world)]
    shards = outs[0]["shards"][0]
    for out in outs:
        index = out["coords"]["fsdp"]
        assert out["shards"] == (shards, index)
        assert out["rows"] == _jax_shard_rows(21, 2, shards, index)


def test_sequence_axis_raises_for_models_that_run_no_chunk(launches):
    """T5 runs no chunk of the sequence: under a sequence axis
    ``prepare_model`` raises, naming item 17. MoE layers route over the
    whole sequence (their parity is ``tests/test_torch_tensor_parallel.py``'s):
    a chunked llama-MoE forward gives its chunk's logits."""
    assert "ROADMAP item 17" in launches[2][0]["forwards"]["t5"]
    moe = launches[2][0]["forwards"]["moe"]
    assert moe.shape == (2, 32, 1024) and np.isfinite(moe).all()


def test_groups_over_several_axes_of_a_larger_mesh(monkeypatch):
    """On a mesh of three live axes (8 processes: data, fsdp and sequence
    of 2), the group over ``(data, sequence)`` is made on first use: one
    group for each fsdp coordinate, every process making every group in
    the same order, this process keeping its own; cached after."""
    import torch.distributed as dist

    made = []
    monkeypatch.setattr(dist, "new_group", lambda ranks: made.append(tuple(ranks)) or f"group{len(made)}")
    _reset()
    state = object.__new__(PartialState)
    state.__dict__ = PartialState._shared_state
    state._world, state._rank, state._ready = 8, 6, True
    state.mesh_shape = ParallelismConfig(data=2, fsdp=2, sequence=2).axis_sizes(8)
    assert state.group(("data", "sequence")) == "group2"  # rank 6: data 1, fsdp 1, sequence 0
    assert made == [(0, 1, 4, 5), (2, 3, 6, 7)]
    assert state.group(("sequence", "data")) == "group2" and len(made) == 2
    assert (state.batch_shards, state.batch_shard_index) == (4, 3)
    _reset()


def test_sequence_axis_is_accepted_with_the_jax_naming():
    """``ParallelismConfig(sequence=2)`` no longer raises (its mesh needs
    two processes), with the JAX package's naming of the distributed type."""
    assert ParallelismConfig(sequence=2).distributed_type == "TENSOR_PARALLEL"
    assert ParallelismConfig(sequence=2, fsdp=2).distributed_type == "HYBRID"
    _reset()
    with pytest.raises(ValueError, match="not divisible"):
        Accelerator(device="cpu", parallelism=ParallelismConfig(sequence=2))
    _reset()
