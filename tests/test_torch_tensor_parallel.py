"""Tensor and expert parallelism across processes: the port at 2 and 4 gloo
processes on the CPU against the JAX package on its 8-device virtual mesh
(``tests/conftest.py``) with a tensor or expert axis.

The port's processes are started by its ``debug_launcher``; each runs
``torch_tensor_workers.suite`` (torch and the port only) once per world
size, and every rank's results come back as numpy. The launches and the
JAX reference runs happen once per session, side by side (a file under the
session's shared temporary directory carries them between xdist workers),
so the tests here only compare. One CPU thread a process.

What is mirrored: ``tests/test_models.py``'s llama and gpt2 forwards at
``tensor=4`` and their training at ``fsdp=2, tensor=2``; ``tests/test_t5.py``'s
forward at ``fsdp=2, tensor=2``; a bert-tiny ``tensor=2`` case;
``tests/test_zero.py``'s and ``tests/test_accelerator.py``'s resolution at
``data=2, tensor=2``; ``tests/test_ring_attention.py``'s ring at
``sequence=2, tensor=2`` and llama training there; llama-moe-tiny under
``expert=2`` and ``expert=2, sequence=2``; the gathered and sharded
checkpoints of ``tensor=2`` runs loading into the JAX package; fp8 under
``tensor=2`` and ``data=2`` (its product and gradient, and training,
also at ``fsdp=2, tensor=2``); dropout under ``tensor=2``.

Tolerances, and why:
- logits: the JAX package's own 2e-4 (``tests/test_models.py``);
- fp32 losses: rtol 1e-5 (the same sums in other orders);
- params after 3 Adam updates: as ``tests/test_torch_parallel.py`` (the
  largest difference within ``2 * lr * steps``, the mean within 1e-5), but
  t5-tiny's mean within 5e-5: its gradients sit near 0 at init, where Adam
  turns rounding into steps of ``lr`` (1e-5 to 3e-5 a param einsum against
  einsum, ``tests/test_torch_t5.py``'s finding); the key biases (bert's
  ``bk``, the k third of gpt2's ``bqkv``) have an exact gradient of 0, so
  they are held to the largest difference only;
- the ring's pieces: 1e-5, as ``tests/test_ring_attention.py``;
- the fp8 product and its gradient under ``tensor=2`` in fp32: 1e-5 of each
  result's largest magnitude (the e4m3 values are exact; fp32 sums in
  another order);
- fp8 training in bf16 (its compute dtype), llama-tiny against the JAX
  package's fp8 on its ``tensor=2`` mesh: the first loss within 4e-4
  relative, every loss within 1e-3, params within ``2 * lr * steps`` and
  each leaf's mean difference within 1e-4. bf16 rounds the partial sums
  of a product wherever its operands are split, and e4m3 rounds a shifted
  value to its other neighbour now and then. Measured on the CPU at
  ``tensor=2``, ``data=2`` and ``fsdp=2, tensor=2``: the first loss
  2.6e-5, 2.6e-4 and 2.6e-5 off, every loss at most 5.7e-4 off, the worst
  leaf's mean 7.6e-5, 7.2e-5 and 7.6e-5 (``lm_head``). With each
  operand's e4m3 scale taken from a process's slice and not the whole
  tensor, which is the fault these limits are for, the first loss was
  6.3e-4, 1.5e-3 and 8.7e-4 off and the worst leaf's mean 1.9e-4, 1.3e-4
  and 2.0e-4;
- checkpoints crossing packages: bit for bit (a copy).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu.models import GPT2 as JaxGPT2
from accelerate_tpu.models import Bert as JaxBert
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.models import T5 as JaxT5
from accelerate_tpu.models.attention import dot_product_attention as jax_attention
from accelerate_tpu.ops.fp8 import fp8_dot as jax_fp8_dot
from accelerate_tpu.parallel import sharding as jax_sharding
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils import FP8RecipeKwargs as JaxFP8RecipeKwargs
from accelerate_tpu.utils.constants import CANONICAL_MESH_AXES
from accelerate_tpu_torch import GPT2, T5, Bert, Llama
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.parallel import sharding as port_sharding
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.params import flatten_tree, tree_paths

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tensor_workers as workers  # noqa: E402 - the launches' processes import it by this name
from torch_shared import once  # noqa: E402

LR = workers.LR
STEPS = 3
LOSS_RTOL, LOGITS_ATOL, RING_TOL, FP8_PRODUCT_TOL = 1e-5, 2e-4, 1e-5, 1e-5
FP8_FIRST_LOSS_RTOL, FP8_LOSS_RTOL, FP8_MEAN_TOL = 4e-4, 1e-3, 1e-4
JAX_CLASSES = {"llama": JaxLlama, "gpt2": JaxGPT2, "bert": JaxBert, "t5": JaxT5}
PORT_CLASSES = {"llama": Llama, "gpt2": GPT2, "bert": Bert, "t5": T5}

# the JAX package's runs: name -> (model, model axes, {mixed_precision, margin});
# its data axis takes the rest of its 8 devices. GSPMD gives one result on
# every mesh, so one run of each model serves the port's configurations of it
JAX_TRAINING = {
    "llama": ("llama-tiny", dict(fsdp=2, tensor=2), {}),
    "llama_clip": ("llama-tiny", dict(fsdp=2, tensor=2), dict(clip_grad_norm=0.5)),
    "gpt2": ("gpt2-tiny", dict(fsdp=2, tensor=2), {}),
    "bert": ("bert-tiny", dict(tensor=2), {}),
    "t5": ("t5-tiny", dict(fsdp=2, tensor=2), {}),
    "moe": ("llama-moe-tiny", dict(expert=2), {}),
    "fp8": ("llama-tiny", dict(tensor=2), dict(mixed_precision="fp8")),
}
# the port's runs: name -> (model, model axes, world, {mixed_precision, margin,
# clip_grad_norm}, JAX run); the clipped ones hold the global norm over the
# batch and model axes, each replicated leaf counted once (k and v whole at tensor=4)
TRAINING = {
    "llama_tp2": ("llama-tiny", dict(tensor=2), 2, {}, "llama"),
    "gpt2_tp2": ("gpt2-tiny", dict(tensor=2), 2, {}, "gpt2"),
    "bert_tp2": ("bert-tiny", dict(tensor=2), 2, {}, "bert"),
    "moe_e2": ("llama-moe-tiny", dict(expert=2), 2, {}, "moe"),
    "fp8_tp2": ("llama-tiny", dict(tensor=2), 2, dict(mixed_precision="fp8"), "fp8"),
    "fp8_data2": ("llama-tiny", dict(data=2), 2, dict(mixed_precision="fp8"), "fp8"),
    "fp8_fsdp2_tp2": ("llama-tiny", dict(fsdp=2, tensor=2), 4, dict(mixed_precision="fp8"), "fp8"),
    "llama_tp4": ("llama-tiny", dict(tensor=4), 4, dict(clip_grad_norm=0.5), "llama_clip"),
    "llama_fsdp2_tp2": ("llama-tiny", dict(fsdp=2, tensor=2), 4, dict(clip_grad_norm=0.5), "llama_clip"),
    "gpt2_fsdp2_tp2": ("gpt2-tiny", dict(fsdp=2, tensor=2), 4, {}, "gpt2"),
    "t5_fsdp2_tp2": ("t5-tiny", dict(fsdp=2, tensor=2), 4, {}, "t5"),
    "llama_seq2_tp2": ("llama-tiny", dict(sequence=2, tensor=2), 4, {}, "llama"),
    "moe_e2_seq2": ("llama-moe-tiny", dict(expert=2, sequence=2), 4, {}, "moe"),
}
CHECKPOINTED = ("llama_tp2", "gpt2_tp2")
# name -> (model, model axes, world): forwards against the JAX package's plain apply
FORWARDS = {
    "bert_tp2": ("bert-tiny", dict(tensor=2), 2),
    "llama_tp4": ("llama-tiny", dict(tensor=4), 4),
    "gpt2_tp4": ("gpt2-tiny", dict(tensor=4), 4),
    "t5_fsdp2_tp2": ("t5-tiny", dict(fsdp=2, tensor=2), 4),
}


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
    path = root / f"torch_tensor_{name}"
    path.mkdir(exist_ok=True)
    return path


def _family(name: str) -> str:
    return name.split("-")[0]


def _params(name: str) -> dict:
    return jax.tree.map(np.asarray, JAX_CLASSES[_family(name)](name).init(jax.random.key(0)))


def _batches(name: str) -> list:
    """3 global batches of 8 rows (32 tokens; t5: 32 in, 16 out; bert: labels)."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, 1024, (8, 32)).astype(np.int32)
        if _family(name) == "t5":
            out.append({"input_ids": ids, "labels": ids[:, :16].copy()})
        elif _family(name) == "bert":
            out.append({"input_ids": ids, "labels": (ids[:, 0] % 2).astype(np.int32)})
        else:
            out.append({"input_ids": ids})
    return out


def _forward_args(name: str) -> tuple:
    ids = np.random.default_rng(8).integers(0, 1024, (2, 32)).astype(np.int32)
    return (ids, ids[:, :16].copy()) if _family(name) == "t5" else (ids,)


def _jax_forward(name: str, params: dict, args: tuple) -> np.ndarray:
    model = JAX_CLASSES[_family(name)](name)
    return np.asarray(model.apply(jax.tree.map(jnp.asarray, params), *map(jnp.asarray, args)))


def _jax_train(name: str, params: dict, axes: dict, batches: list, options: dict) -> dict:
    _reset()
    handlers = [JaxFP8RecipeKwargs(margin=options["margin"])] if "margin" in options else None
    acc = JaxAccelerator(parallelism=JaxParallelismConfig(**axes),
                         mixed_precision=options.get("mixed_precision", "no"), kwargs_handlers=handlers)
    cls = JAX_CLASSES[_family(name)]
    model = cls(name)
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params))
    acc.prepare_optimizer(optax.adamw(LR))
    step = acc.compiled_step(cls.loss_fn(model), clip_grad_norm=options.get("clip_grad_norm"))
    losses = [float(step({k: jnp.asarray(v) for k, v in batch.items()})) for batch in batches]
    out = {"losses": losses, "params": dict(flatten_tree(jax.tree.map(np.asarray, prepared.params)))}
    _reset()
    return out


def _ring_case() -> dict:
    """``tests/test_ring_attention.py``'s GQA case (4 heads, 2 kv heads), causal."""
    rng = np.random.default_rng(44)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(q=f(2, 32, 4, 16), k=f(2, 32, 2, 16), v=f(2, 32, 2, 16))


def _fp8_case() -> dict:
    rng = np.random.default_rng(45)
    return dict(x=rng.standard_normal((16, 64)).astype(np.float32),
                w=(rng.standard_normal((64, 32)) * 0.1).astype(np.float32),
                ct=rng.standard_normal((16, 32)).astype(np.float32))


def _jax_fp8(case: dict) -> dict:
    x, w, ct = (jnp.asarray(case[k]) for k in ("x", "w", "ct"))
    out = jax_fp8_dot(x, w)
    gx, gw = jax.grad(lambda a, b: jnp.sum(jax_fp8_dot(a, b) * ct), argnums=(0, 1))(x, w)
    return {"out": np.asarray(out), "gx": np.asarray(gx), "gw": np.asarray(gw)}


@pytest.fixture(scope="module")
def params():
    names = {spec[0] for spec in TRAINING.values()} | {spec[0] for spec in FORWARDS.values()}
    return {name: _params(name) for name in names}


@pytest.fixture(scope="module")
def launches(request, tmp_path_factory, params):
    """Every rank's results at 2 and 4 processes, and the JAX references."""
    ckpt = _shared_dir(tmp_path_factory, request, "ckpt")

    def jobs(world):
        out = []
        for key, (name, axes, w, options, _) in TRAINING.items():
            if w != world:
                continue
            dirs = (str(ckpt / f"{key}_whole"), str(ckpt / f"{key}_sharded")) if key in CHECKPOINTED else None
            out.append((f"train/{key}", "train",
                        (name, params[name], axes, _batches(name), options.get("mixed_precision", "no"),
                         options.get("margin"), dirs, options.get("clip_grad_norm"))))
        for key, (name, axes, w) in FORWARDS.items():
            if w == world:
                out.append((f"forward/{key}", "forward", (name, params[name], axes, _forward_args(name))))
        if world == 2:
            out.append(("fp8", "fp8_products", (_fp8_case(),)))
            out.append(("dropout", "dropout", (params["llama-tiny"], dict(tensor=2), _batches("llama-tiny")[:2])))
        else:
            case = _ring_case()
            out.append(("ring", "ring", (case["q"], case["k"], case["v"], None, True)))
            out.append(("resolution", "resolution", ()))
        return out

    def compute():
        with ThreadPoolExecutor(2) as pool:
            futures = {world: pool.submit(debug_launcher, workers.suite, (jobs(world),), world, 420)
                       for world in (2, 4)}
            out = {"jax_train": {key: _jax_train(name, params[name], axes, _batches(name), options)
                                 for key, (name, axes, options) in JAX_TRAINING.items()},
                   "jax_forward": {key: _jax_forward(name, params[name], _forward_args(name))
                                   for key, (name, _, _) in FORWARDS.items()},
                   "jax_fp8": _jax_fp8(_fp8_case())}
            case = _ring_case()
            out["jax_ring"] = np.asarray(jax_attention(*(jnp.asarray(case[k]) for k in "qkv"), causal=True))
            out.update({world: future.result() for world, future in futures.items()})
        out["ckpt"] = str(ckpt)
        return out

    return once(request, tmp_path_factory, "torch_tensor_launches", compute)


def _ranks(launches, key):
    world = TRAINING[key.split("/")[1]][2] if key.startswith("train/") else FORWARDS[key.split("/")[1]][2]
    return [launches[world][r][key] for r in range(world)]


# -- (i) the layout rules -------------------------------------------------------------


def _jax_mesh(**axes):
    sizes = {a: axes.get(a, 1) for a in CANONICAL_MESH_AXES}
    n = int(np.prod(list(sizes.values())))
    devices = np.asarray(jax.devices()[:n]).reshape(tuple(sizes.values()))
    return jax.sharding.Mesh(devices, CANONICAL_MESH_AXES)


@pytest.mark.parametrize("axes", [dict(tensor=2), dict(tensor=4), dict(fsdp=2, tensor=2), dict(expert=2),
                                  dict(data=2, expert=2, tensor=2)], ids=str)
@pytest.mark.parametrize("model_name", ["llama-tiny", "gpt2-tiny", "bert-tiny", "t5-tiny", "llama-moe-tiny"])
def test_rules_give_the_jax_specs_under_the_model_axes(model_name, axes):
    """Every leaf's spec under the model's rules on a mesh with tensor and
    expert axes: the JAX package's ``PartitionSpec`` entry for entry (a dim
    that does not divide stays whole, ``_spec_fits``), but for the rules a
    model adds before them (``tensor_rules``): gpt2's fused ``wqkv``/``bqkv``
    as three blocks, and the tiny llamas' k and v whole at ``tensor=4`` (2
    kv heads)."""
    jax_model = JAX_CLASSES[_family(model_name)](model_name)
    port_model = PORT_CLASSES[_family(model_name)](model_name, device="meta")
    shapes = jax.eval_shape(jax_model.init, jax.random.key(0))
    mesh = _jax_mesh(**axes)
    sizes = dict(mesh.shape)
    jax_specs = jax_sharding.infer_shardings(shapes, mesh, jax_sharding.PartitionRules(jax_model.partition_rules()))
    want = {k.replace(".", "/"): tuple(v.spec) for k, v in flatten_tree(jax_specs)}
    tree = port_model.param_tree()
    plain = dict(tree_paths(port_sharding.infer_shardings(tree, sizes,
                                                          port_sharding.PartitionRules(port_model.partition_rules()))))
    assert plain == want
    added = list(port_model.tensor_rules(sizes["tensor"])) if hasattr(port_model, "tensor_rules") else []
    got = dict(tree_paths(port_sharding.infer_shardings(
        tree, sizes, port_sharding.PartitionRules(added + list(port_model.partition_rules())))))
    changed = {k for k in want if got[k] != want[k]}
    if model_name == "gpt2-tiny" and sizes["tensor"] > 1:
        assert changed == {"layers/wqkv", "layers/bqkv"}
        assert got["layers/wqkv"][-1] == (3, "tensor")
        assert port_sharding.sharded_dims(got["layers/wqkv"], sizes) == port_sharding.sharded_dims(want["layers/wqkv"], sizes)
    elif model_name.startswith("llama") and sizes["tensor"] == 4:
        assert changed == {"layers/wk", "layers/wv"}
        assert not port_sharding.sharded_dims(got["layers/wk"], sizes)
    else:
        assert not changed
    # gpt2's 50257-token vocab does not split in two: the embedding stays whole
    if model_name == "gpt2-tiny":
        big = port_sharding.PartitionRules(GPT2("gpt2-124m", device="meta").partition_rules())
        spec = big.spec_for("embed_tokens", (50257, 768), sizes)
        assert all("tensor" not in split for _, split in port_sharding.sharded_dims(spec, sizes))


# -- (ii) forwards and training against the JAX package ---------------------------------


@pytest.mark.parametrize("key", sorted(FORWARDS))
def test_forward_matches_the_jax_package(launches, key):
    """``prepared(...)`` on this process's slices, the logits gathered: every
    process equal to the JAX package's plain forward (its own test's 2e-4)."""
    want = launches["jax_forward"][key]
    for rank in _ranks(launches, f"forward/{key}"):
        np.testing.assert_allclose(rank["logits"], want, atol=LOGITS_ATOL)


def _null_gradient(key: str, diff: np.ndarray) -> np.ndarray:
    """``diff`` without the key biases, whose exact gradient is 0 (a query's
    logits all shift by ``q . bk``, which the softmax ignores): Adam turns
    their rounding into steps of ``lr`` in either package, so they are held
    to the largest difference only."""
    if key == "layers.bk":
        return diff[..., :0]
    if key == "layers.bqkv":
        third = diff.shape[-1] // 3
        return np.concatenate([diff[..., :third], diff[..., 2 * third:]], axis=-1)
    return diff


def _assert_params_close(want, got, mean_tol):
    assert set(got) == set(want)
    for key in want:
        diff = np.abs(got[key] - want[key])
        assert diff.max() <= 2 * LR * STEPS, f"{key}: {diff.max()}"
        held = _null_gradient(key, diff)
        assert held.size == 0 or held.mean() <= mean_tol, f"{key}: mean {held.mean()}"


@pytest.mark.parametrize("key", sorted(TRAINING))
def test_training_matches_the_jax_mesh(launches, key):
    """3 steps of ``fused_adamw`` under the model axes against the JAX
    ``Accelerator`` on a mesh with the tensor (or expert) axis: losses and
    gathered params; every process agrees with every other bit for bit."""
    ranks = _ranks(launches, f"train/{key}")
    want = launches["jax_train"][TRAINING[key][4]]
    for rank in ranks[1:]:
        assert rank["losses"] == ranks[0]["losses"]
        for k in ranks[0]["params"]:
            np.testing.assert_array_equal(rank["params"][k], ranks[0]["params"][k], err_msg=k)
    got = ranks[0]
    fp8 = TRAINING[key][3].get("mixed_precision") == "fp8"
    if fp8:
        np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=FP8_FIRST_LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=FP8_LOSS_RTOL if fp8 else LOSS_RTOL)
    mean_tol = FP8_MEAN_TOL if fp8 else {"t5": 5e-5}.get(_family(TRAINING[key][0]), 1e-5)
    _assert_params_close(want["params"], got["params"], mean_tol)
    axes = TRAINING[key][1]
    assert all(got["mesh"][a] == n for a, n in axes.items())


def test_tensor_axis_stores_each_process_slices(launches):
    """Under ``tensor=2`` a process stores its heads' columns of q/k/v, its
    rows of o, its half of the vocab (llama-tiny: 4 heads of 32, 2 kv heads);
    at ``tensor=4`` k and v stay whole (2 kv heads for 4 processes)."""
    tp2 = _ranks(launches, "train/llama_tp2")[0]["stored"]
    assert tp2["layers.wq"] == (2, 128, 64) and tp2["layers.wk"] == (2, 128, 32)
    assert tp2["layers.wo"] == (2, 64, 128) and tp2["embed_tokens"] == (512, 128)
    assert tp2["lm_head"] == (128, 512) and tp2["layers.attn_norm"] == (2, 128)
    tp4 = _ranks(launches, "train/llama_tp4")[0]["stored"]
    assert tp4["layers.wq"] == (2, 128, 32) and tp4["layers.wk"] == (2, 128, 64)
    gpt2 = _ranks(launches, "train/gpt2_tp2")[0]["stored"]
    assert gpt2["layers.wqkv"] == (2, 128, 192) and gpt2["layers.bqkv"] == (2, 192)


def test_the_expert_exchange_names_its_route(launches):
    """The expert exchange runs ``all_to_all_single`` on the tensors
    themselves over each process's expert group (its index on the axis,
    2 processes), and the mesh is named as the JAX package names it."""
    for key in ("moe_e2", "moe_e2_seq2"):
        ranks = _ranks(launches, f"train/{key}")
        assert {rank["expert"][0] for rank in ranks} == {0, 1}
        for rank in ranks:
            assert rank["expert"] == (rank["mesh_coords"]["expert"], 2)
            assert rank["distributed_type"] == "HYBRID"
    assert _ranks(launches, "train/llama_tp2")[0]["distributed_type"] == "TENSOR_PARALLEL"


def test_ring_under_the_tensor_axis(launches):
    """The ring at ``sequence=2, tensor=2`` (GQA: 4 heads, 2 kv heads):
    each process's chunk of its heads equals the JAX package's attention."""
    want = launches["jax_ring"]
    for rank in launches[4]:
        got = rank["ring"]
        rows, heads = slice(*got["rows"]), slice(*got["heads"])
        np.testing.assert_allclose(got["out"], want[:, rows, heads], atol=RING_TOL)


def test_zero_and_the_scheduler_under_the_tensor_axis(launches):
    """``data=2, tensor=2``: the ZeRO update stays off (a model axis), a
    demanded one raises naming ``zero_stage`` with the JAX package's reason,
    the scheduler ticks by the data extent (2), not the processes, and a
    gather holds each batch shard's rows once."""
    for rank in launches[4]:
        got = rank["resolution"]
        assert got["zero_auto"] is False
        assert "zero_stage=1" in got["zero_demanded"]
        assert "their collectives live inside the auto-partitioned forward" in got["zero_demanded"]
        assert got["scheduler_tick"] == 2 and got["batch_shards"] == 2
        assert got["gathered"] == [0, 10, 1, 10]


def test_dropout_masks_are_one_process_s_under_the_tensor_axis(launches, params):
    """Residual dropout under ``tensor=2`` with each process's generator
    seeded apart: the group draws its first process's masks (at the global
    shape of the replicated activations), so the losses equal one
    process's run with that seed."""
    import torch

    ranks = [launches[2][r]["dropout"] for r in range(2)]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    _reset()
    torch.manual_seed(0)
    single = workers.dropout_train(params["llama-tiny"], {}, _batches("llama-tiny")[:2])
    np.testing.assert_allclose(ranks[0]["losses"], single["losses"], rtol=LOSS_RTOL)


# -- (iii) fp8 under the tensor axis --------------------------------------------------


def test_fp8_products_under_the_tensor_axis_match_jax_grad(launches):
    """The e4m3 product on one process's slices at ``tensor=2``, fp32:
    column-parallel (its columns of ``w``), row-parallel (its rows of ``w``
    and columns of ``x``) and GQA-shared (the whole ``w``, its columns
    read), and at ``data=2`` (its rows of ``x``; ``w``'s gradient summed
    over the processes): the output and the gradients equal ``jax.grad``
    of the JAX ``fp8_dot`` on the whole tensors, whose scales are the
    whole tensors'."""
    want = launches["jax_fp8"]

    def close(got, ref):
        np.testing.assert_allclose(got, ref, atol=FP8_PRODUCT_TOL * np.abs(ref).max())

    for rank in launches[2]:
        got = rank["fp8"]
        cols, rows = slice(*got["cols"]), slice(*got["rows"])
        close(got["column"]["out"], want["out"][:, cols])
        close(got["column"]["gx"], want["gx"])
        close(got["column"]["gw"], want["gw"][:, cols])
        close(got["row"]["out"], want["out"])
        close(got["row"]["gx"], want["gx"][:, rows])
        close(got["row"]["gw"], want["gw"][rows])
        close(got["shared"]["out"], want["out"][:, cols])
        close(got["shared"]["gx"], want["gx"])
        close(got["shared"]["gw"], want["gw"])
        mine = slice(*got["data_rows"])
        close(got["data"]["out"], want["out"][mine])
        close(got["data"]["gx"], want["gx"][mine])
    close(launches[2][0]["fp8"]["data"]["gw"] + launches[2][1]["fp8"]["data"]["gw"], want["gw"])
    assert not launches[2][1]["fp8"]["data"]["gw"].any()


@pytest.mark.parametrize("key", ["fp8_tp2", "fp8_data2", "fp8_fsdp2_tp2"])
def test_fp8_training_installs_the_e4m3_product(launches, key):
    ranks = _ranks(launches, f"train/{key}")
    assert all(rank["dot_fn"] == 0 for rank in ranks)  # the e4m3 product, margin 0
    assert all(np.isfinite(rank["losses"]).all() for rank in ranks)


# -- (iv) checkpoints of tensor-parallel runs --------------------------------------------


@pytest.mark.parametrize("key", CHECKPOINTED)
@pytest.mark.parametrize("form", ["whole", "sharded"])
def test_tensor_parallel_checkpoints_load_into_the_jax_package(launches, params, key, form):
    """A ``tensor=2`` run's gathered and sharded saves (each process writes
    its slices; gpt2's fused ``wqkv`` as three chunks a process, one a
    block) load into the JAX package bit for bit, and back into a port run
    of the same layout."""
    import json

    name = TRAINING[key][0]
    directory = os.path.join(launches["ckpt"], f"{key}_{form}")
    saved = _ranks(launches, f"train/{key}")
    if form == "sharded" and _family(name) == "gpt2":
        chunks = {}
        for r in range(2):
            with open(os.path.join(directory, f"model_0.shard{r:05d}.index.json")) as f:
                chunks.update(json.load(f)["chunks"])
        wqkv = sorted(k for k in chunks if k.startswith("layers/wqkv@"))
        assert wqkv == sorted(f"layers/wqkv@0,0,{start}" for start in (0, 64, 128, 192, 256, 320))
    _reset()
    cls = JAX_CLASSES[_family(name)]
    acc = JaxAccelerator()
    model = cls(name)
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params[name]))
    acc.prepare_optimizer(optax.adamw(LR))
    acc.load_state(directory)
    got = dict(flatten_tree(jax.tree.map(np.asarray, prepared.params)))
    for k, value in saved[0]["params"].items():
        np.testing.assert_array_equal(got[k], value, err_msg=k)
    _reset()
    if form == "sharded":
        for rank in saved:
            for k, value in rank["params"].items():
                np.testing.assert_array_equal(rank["resumed"][k], value, err_msg=k)
