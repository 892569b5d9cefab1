"""Training across processes: the port at 2 and 4 gloo processes on the CPU
against the JAX package on its 8-device virtual mesh (``tests/conftest.py``).

The port's processes are started by its own ``debug_launcher``; each runs
``torch_parallel_workers.suite`` (torch and the port only, no JAX) once per
world size, and every rank's results come back as numpy. The launches and
the JAX reference runs happen once per test session (a file under the
session's shared temporary directory carries them between xdist workers),
so the tests here only compare.

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
import pickle
import sys

import numpy as np
import optax
import pytest
from filelock import FileLock

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
from accelerate_tpu.models import Bert as JaxBert
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.parallel import sharding as jax_sharding
from accelerate_tpu.parallel.zero import zero_update_state_bytes as jax_zero_update_state_bytes
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils.constants import CANONICAL_MESH_AXES
from accelerate_tpu_torch import Accelerator, Bert, Llama
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.parallel import sharding as port_sharding
from accelerate_tpu_torch.parallel.zero import zero_update_state_bytes
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig
from accelerate_tpu_torch.utils.params import flatten_tree, tree_paths

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as workers  # noqa: E402 - the launches' processes import it by this name

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
}
JAX_OF = {"fsdp3_offload": "fsdp3"}  # the same arithmetic, state kept on the host


def _reset():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _once(request, tmp_path_factory, name, compute):
    """``compute()`` once per session: under xdist the first worker to ask
    computes and pickles it under the session's shared temporary directory,
    the others read it."""
    if getattr(request.config, "workerinput", None) is None:
        return compute()
    path = tmp_path_factory.getbasetemp().parent / f"torch_parallel_{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        data = compute()
        path.write_bytes(pickle.dumps(data))
        return data


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


@pytest.fixture(scope="module")
def jax_runs(request, tmp_path_factory, init_params, batches):
    return _once(request, tmp_path_factory, "jax_runs",
                 lambda: {kind: _jax_train(kind, init_params, batches) for kind in JAX_TRAINING})


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


@pytest.fixture(scope="module")
def launches(request, tmp_path_factory, init_params, batches):
    """Every rank's results of the suite at 2 and at 4 processes, and the
    JAX checkpoint the 2-process suite loaded."""
    ckpt = _shared_dir(tmp_path_factory, request, "ckpt")

    def compute():
        jax_saved = _jax_checkpoint(ckpt / "jax", init_params, batches)
        out = {"jax_checkpoint": jax_saved}
        for world, names in WORLD_CONFIGS.items():
            dirs = (str(ckpt / "jax"), str(ckpt / "port")) if world == 2 else (None, None)
            out[world] = debug_launcher(workers.suite, (names, init_params, batches, *dirs),
                                        num_processes=world, timeout=300)
        out["port_checkpoint"] = str(ckpt / "port")
        return out

    return _once(request, tmp_path_factory, "launches", compute)


# -- (i) the layout engine ------------------------------------------------------


def _jax_mesh(data, fsdp):
    devices = np.asarray(jax.devices()[: data * fsdp]).reshape((data, fsdp, 1, 1, 1, 1))
    return Mesh(devices, CANONICAL_MESH_AXES)


@pytest.mark.parametrize("data,fsdp", [(2, 1), (4, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("model_name", ["llama-tiny", "bert-tiny"])
def test_partition_rules_give_the_jax_specs(model_name, data, fsdp):
    """Every leaf's spec under the model's rules (stage 3), with the ZeRO
    fold over the data axes, and stage 1/2's optimizer-state layout: the
    JAX package's ``PartitionSpec`` entry for entry."""
    jax_model, port_model = ((JaxLlama(model_name), Llama(model_name, device="cpu")) if "llama" in model_name
                             else (JaxBert(model_name), Bert(model_name, device="cpu")))
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


@pytest.mark.parametrize("axis", ["tensor", "pipeline", "expert", "sequence"])
def test_model_parallel_axes_raise_naming_item_17(axis):
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        ParallelismConfig(**{axis: 2})
    _reset()
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        Accelerator(device="cpu", parallelism=ParallelismConfig(**{axis: 2}))
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
