"""Pipeline parallelism across processes: the port at 2 and 4 gloo processes
on the CPU against the JAX package on its 8-device virtual mesh
(``tests/conftest.py``) with a pipeline axis.

The port's processes are started by its ``debug_launcher``; each runs
``torch_pipeline_workers.suite`` (torch and the port only) once per world
size, and every rank's results come back as numpy. The launches and the JAX
reference runs happen once per session, side by side (a file under the
session's shared temporary directory carries them between xdist workers),
so the tests here only compare. One CPU thread a process.

What is mirrored: ``tests/test_pipeline.py``'s and
``tests/test_pipeline_zoo.py``'s forwards at ``pipeline=2`` (llama plain,
through the flash dispatch, padded, with per-row positions, in bf16, at
``virtual_pipeline_stages=2``; gpt2 padded; bert; t5's two stacks;
llama-moe-tiny's aux at one microbatch), dropout against the fold, the
schedule tables, the ``must divide`` error, the declared broadcast side
input and the microbatch cut; training at ``pipeline=2`` with ``data=2``,
``tensor=2``, ``sequence=2``, ``fsdp=2`` (bf16, clipped at 1.0), ``expert=2``
(MoE with its balance term), gpt2's tied ``wte``, and fp8; the sequence
axis's forwards; sharded checkpoints into the JAX package and back.

Tolerances, and why:
- the schedule tables and idle fractions: bit-equal (host code, copied);
- logits: the JAX package's own 2e-4 (``tests/test_pipeline.py``), bf16
  its 1.5e-1; the MoE aux at one microbatch its 1e-5;
- dropout: the pipeline against the port's own run of the same
  per-(layer, microbatch) fold on each microbatch, 2e-4 (the same ops on
  the same rows; the masks are Philox's, not threefry's);
- gradients of the first batch at ``pipeline=2`` against one process's
  without the pipeline: 1e-5 of each leaf's largest (fp32 sums over
  microbatches in another order); the leaves outside the layer stack
  bit-equal on the two stages;
- fp32 training, 3 Adam updates: losses rtol 1e-5, params as
  ``tests/test_torch_tensor_parallel.py`` (the largest difference within
  ``2 * lr * steps``, the mean within 1e-5);
- bf16 training at ``fsdp=2, pipeline=2`` clipped at 1.0: losses rtol
  ``BF16_LOSS_RTOL`` (1e-3), params the largest difference within ``2 *
  lr * steps`` and the mean within ``BF16_MEAN_TOL`` (1e-4): bf16 rounds
  every product and the two packages sum the microbatches' gradients in
  other orders. Measured on the CPU: losses 1.4e-4 to 1.8e-4 off, the
  worst leaf's mean 4.7e-5 (``layers.attn_norm``); the fp32 runs' losses
  at most 3.8e-7 off, their worst means 1e-7 to 8.6e-6;
- fp8 training: as the tensor-parallel fp8 cases (the first loss within
  4e-4 relative, every loss 1e-3, each leaf's mean 1e-4); measured 1.8e-4,
  at most 7.9e-4 and 6.2e-5 (``lm_head``). Each e4m3 scale is a
  microbatch's inside the schedule, in both packages;
- checkpoints crossing packages: bit for bit (a copy).

The three-axis mesh ``fsdp=2, pipeline=2, tensor=2`` needs 8 processes and
is not run here.
"""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu.models import GPT2 as JaxGPT2
from accelerate_tpu.models import Bert as JaxBert
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.models import T5 as JaxT5
from accelerate_tpu.models import get_config as jax_get_config
from accelerate_tpu.parallel.pipeline import build_interleaved_schedule as jax_schedule
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch import Llama
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.models.attention import rotary_embedding
from accelerate_tpu_torch.models.llama import rms_norm
from accelerate_tpu_torch.parallel import pipeline as port_pipeline
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState, PipelineStages
from accelerate_tpu_torch.utils.params import flatten_tree

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_pipeline_workers as workers  # noqa: E402 - the launches' processes import it by this name
from torch_shared import once, one_cpu_thread  # noqa: E402,F401 - one_cpu_thread: a module fixture

LR = workers.LR
STEPS = 3
LOGITS_ATOL, BF16_LOGITS_ATOL, AUX_ATOL, LOSS_RTOL, GRAD_RTOL = 2e-4, 1.5e-1, 1e-5, 1e-5, 1e-5
BF16_LOSS_RTOL, BF16_MEAN_TOL = 1e-3, 1e-4
FP8_FIRST_LOSS_RTOL, FP8_LOSS_RTOL, FP8_MEAN_TOL = 4e-4, 1e-3, 1e-4
JAX_CLASSES = {"llama": JaxLlama, "gpt2": JaxGPT2, "bert": JaxBert, "t5": JaxT5}

# the JAX package's runs on its mesh with a pipeline axis: name -> (model,
# axes, options); its data axis takes the rest of its 8 devices. GSPMD gives
# one result on every mesh, so one run serves the port's meshes of it
JAX_TRAINING = {
    "llama": ("llama-tiny", dict(pipeline=2, tensor=2), {}),
    "llama_bf16_clip": ("llama-tiny", dict(fsdp=2, pipeline=2),
                        dict(mixed_precision="bf16", clip_grad_norm=1.0)),
    "moe": ("llama-moe-tiny", dict(pipeline=2, expert=2), {}),
    "gpt2": ("gpt2-tiny", dict(pipeline=2), {}),
    "fp8": ("llama-tiny", dict(pipeline=2), dict(mixed_precision="fp8")),
}
# the port's runs: name -> (model, axes, world, options, JAX run)
TRAINING = {
    "llama_pp2": ("llama-tiny", dict(pipeline=2), 2, {}, "llama"),
    "gpt2_pp2": ("gpt2-tiny", dict(pipeline=2), 2, {}, "gpt2"),
    "fp8_pp2": ("llama-tiny", dict(pipeline=2), 2, dict(mixed_precision="fp8"), "fp8"),
    "llama_pp2_dp2": ("llama-tiny", dict(pipeline=2, data=2), 4, {}, "llama"),
    "llama_pp2_tp2": ("llama-tiny", dict(pipeline=2, tensor=2), 4, {}, "llama"),
    "llama_pp2_seq2": ("llama-tiny", dict(pipeline=2, sequence=2), 4, {}, "llama"),
    "llama_fsdp2_pp2": ("llama-tiny", dict(fsdp=2, pipeline=2), 4,
                        dict(mixed_precision="bf16", clip_grad_norm=1.0), "llama_bf16_clip"),
    "moe_pp2_ep2": ("llama-moe-tiny", dict(pipeline=2, expert=2), 4, {}, "moe"),
}
CHECKPOINTED = "llama_pp2"


def _rng(seed):
    return np.random.default_rng(seed)


def _ids(seed, b=8, s=16):
    return _rng(seed).integers(0, 1024, (b, s)).astype(np.int32)


def _padded(b, s, rows):
    am = np.ones((b, s), np.int32)
    for row, stop in rows:
        am[row, :stop] = 0
    return am


def _positions():
    rng = _rng(5)
    return (rng.integers(0, 64, (8, 1)) + np.arange(16)[None, :]).astype(np.int32)


def _t5_args():
    rng = _rng(13)
    ids, dec = rng.integers(0, 1024, (8, 32)).astype(np.int32), rng.integers(0, 1024, (8, 16)).astype(np.int32)
    return (ids, dec), dict(attention_mask=_padded(8, 32, [(2, 5)])[:, ::-1].copy(),
                            decoder_attention_mask=_padded(8, 16, [(4, 3)])[:, ::-1].copy())


# the forwards at pipeline=2: key -> (model, axes, world, args, kwargs, options)
FORWARDS = {
    "llama": ("llama-tiny", dict(pipeline=2), 2, (_ids(0),), {}, {}),
    "llama_flash": ("llama-tiny", dict(pipeline=2), 2, (_ids(10, s=32),), {}, dict(flash=16)),
    "llama_mask": ("llama-tiny", dict(pipeline=2), 2, (_ids(2),),
                   dict(attention_mask=_padded(8, 16, [(0, 4), (5, 7)])), {}),
    "llama_positions": ("llama-tiny", dict(pipeline=2), 2, (_ids(5),), dict(positions=_positions()), {}),
    "llama_bf16": ("llama-tiny", dict(pipeline=2), 2, (_ids(3),), {}, dict(mixed_precision="bf16")),
    "llama_v2": ("llama-tiny-4", dict(pipeline=2), 2, (_ids(4),), {}, dict(virtual=2)),
    "gpt2_mask": ("gpt2-tiny", dict(pipeline=2), 2, (_ids(1),), dict(attention_mask=_padded(8, 16, [(0, 5), (3, 2)])),
                  {}),
    "bert": ("bert-tiny", dict(pipeline=2), 2, (_ids(2),), dict(attention_mask=_padded(8, 16, [])), {}),
    "t5": ("t5-tiny", dict(pipeline=2), 2, *_t5_args(), dict(flash=16)),
    "moe_one_microbatch": ("llama-moe-tiny", dict(pipeline=2), 2, (_ids(3, b=4),), dict(return_aux=True),
                           dict(microbatches=1)),
    "llama_seq2": ("llama-tiny", dict(pipeline=2, sequence=2), 4, (_ids(20, s=32),), {}, {}),
    "llama_seq2_padded": ("llama-tiny", dict(pipeline=2, sequence=2), 4, (_ids(21, b=4, s=32),),
                          dict(attention_mask=_padded(4, 32, [(0, 10)])), {}),
}
# bert's padding rows: one row padded past position 10 (its JAX test)
FORWARDS["bert"][4]["attention_mask"][1, 10:] = 0


def _reset():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _family(name: str) -> str:
    return name.split("-")[0]


def _jax_config(name: str):
    if name == "llama-tiny-4":
        return dataclasses.replace(jax_get_config("llama-tiny"), num_layers=4)
    return jax_get_config(name)


def _jax_model(name: str):
    return JAX_CLASSES[_family(name)](_jax_config(name))


def _params(name: str) -> dict:
    return jax.tree.map(np.asarray, _jax_model(name).init(jax.random.key(0)))


def _batches(name: str) -> list:
    """3 global batches of 8 rows of 32 tokens."""
    rng = _rng(7)
    return [{"input_ids": rng.integers(0, 1024, (8, 32)).astype(np.int32)} for _ in range(STEPS)]


def _jax_forward(name: str, params: dict, args: tuple, kwargs: dict, options: dict):
    model = _jax_model(name)
    tree = jax.tree.map(jnp.asarray, params)
    if options.get("mixed_precision") == "bf16":
        tree = jax.tree.map(lambda p: p.astype(jnp.bfloat16), tree)
    out = model.apply(tree, *map(jnp.asarray, args), **{k: v if isinstance(v, bool) else jnp.asarray(v)
                                                         for k, v in kwargs.items()})
    if kwargs.get("return_aux"):
        return np.asarray(out[0], np.float32), float(out[1])
    return np.asarray(out, np.float32), None


def _jax_train(name: str, params: dict, axes: dict, batches: list, options: dict) -> dict:
    _reset()
    acc = JaxAccelerator(parallelism=JaxParallelismConfig(**axes), mixed_precision=options.get("mixed_precision", "no"))
    cls = JAX_CLASSES[_family(name)]
    model = cls(name)
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params))
    acc.prepare_optimizer(optax.adamw(LR))
    step = acc.compiled_step(cls.loss_fn(model), clip_grad_norm=options.get("clip_grad_norm"))
    losses = [float(step({k: jnp.asarray(v) for k, v in batch.items()})) for batch in batches]
    out = {"losses": losses, "params": dict(flatten_tree(jax.tree.map(np.asarray, prepared.params)))}
    _reset()
    return out


def _jax_checkpoint(params: dict, directory: str) -> dict:
    """The JAX package's llama-tiny on its ``pipeline=2`` mesh, one Adam
    update, saved sharded to ``directory``: the params it saved."""
    _reset()
    acc = JaxAccelerator(parallelism=JaxParallelismConfig(pipeline=2))
    model = JaxLlama("llama-tiny")
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params))
    acc.prepare_optimizer(optax.adamw(LR))
    step = acc.compiled_step(JaxLlama.loss_fn(model))
    step({"input_ids": jnp.asarray(_ids(30, s=32))})
    acc.save_state(directory, sharded=True)
    out = dict(flatten_tree(jax.tree.map(np.asarray, prepared.params)))
    _reset()
    return out


@pytest.fixture(scope="module")
def params():
    names = {spec[0] for spec in TRAINING.values()} | {spec[0] for spec in FORWARDS.values()}
    return {name: _params(name) for name in names | {"llama-tiny-4"}}


def _shared_dir(tmp_path_factory, request, name):
    root = tmp_path_factory.getbasetemp()
    if getattr(request.config, "workerinput", None) is not None:
        root = root.parent
    path = root / f"torch_pipeline_{name}"
    path.mkdir(exist_ok=True)
    return path


@pytest.fixture(scope="module")
def launches(request, tmp_path_factory, params):
    """Every rank's results at 2 and 4 processes, and the JAX references."""
    ckpt = _shared_dir(tmp_path_factory, request, "ckpt")

    def jobs(world):
        out = []
        for key, (name, axes, w, options, _) in TRAINING.items():
            if w != world:
                continue
            dirs = (str(ckpt / f"{key}_whole"), str(ckpt / f"{key}_sharded")) if key == CHECKPOINTED else None
            out.append((f"train/{key}", "train",
                        (name, params[name], axes, _batches(name), options.get("mixed_precision", "no"), None,
                         dirs, options.get("clip_grad_norm"))))
        for key, (name, axes, w, args, kwargs, options) in FORWARDS.items():
            if w == world:
                out.append((f"forward/{key}", "forward", (name, params[name], axes, args, kwargs, options)))
        if world == 2:
            out.append(("dropout", "dropout", ("llama-tiny", params["llama-tiny"], dict(pipeline=2), _ids(7), 42)))
            for name in ("llama-tiny", "gpt2-tiny"):
                out.append((f"grads/{name}", "grads", (name, params[name], dict(pipeline=2), _batches(name)[0])))
            out.append(("load", "load", ("llama-tiny", params["llama-tiny"], dict(pipeline=2), str(ckpt / "jax"))))
            out.append(("cut_warning", "cut_warning", (params["llama-tiny"],)))
            out.append(("interleaved", "save_interleaved", ("llama-tiny-4", params["llama-tiny-4"],
                                                            str(ckpt / "interleaved"))))
        return out

    def compute():
        jax_saved = _jax_checkpoint(params["llama-tiny"], str(ckpt / "jax"))
        with ThreadPoolExecutor(2) as pool:
            futures = {world: pool.submit(debug_launcher, workers.suite, (jobs(world),), world, 420)
                       for world in (2, 4)}
            out = {"jax_train": {key: _jax_train(name, params[name], axes, _batches(name), options)
                                 for key, (name, axes, options) in JAX_TRAINING.items()},
                   "jax_forward": {key: _jax_forward(name, params[name], args, kwargs, options)
                                   for key, (name, _, _, args, kwargs, options) in FORWARDS.items()},
                   "jax_saved": jax_saved}
            out.update({world: future.result() for world, future in futures.items()})
        out["ckpt"] = str(ckpt)
        return out

    return once(request, tmp_path_factory, "torch_pipeline_launches", compute)


def _ranks(launches, world, key):
    return [launches[world][r][key] for r in range(world)]


# -- (i) the schedule, on the host ----------------------------------------------------


@pytest.mark.parametrize("stages,virtual,microbatches",
                         [(p, v, m) for p in (2, 4) for v in (1, 2) for m in (1, 3, 8)])
def test_schedule_tables_equal_the_jax_package_s(stages, virtual, microbatches):
    """``build_interleaved_schedule``: the four (device, tick) tables and
    the idle fraction bit-equal to the JAX package's."""
    got, want = (port_pipeline.build_interleaved_schedule(stages, virtual, microbatches),
                 jax_schedule(stages, virtual, microbatches))
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]


def _one_stage(**axes):
    """A stand-in for ``PartialState`` with a pipeline of one stage (no
    processes): the schedule runs locally."""
    sizes = {**dict(data=1, fsdp=1, pipeline=1, expert=1, sequence=1, tensor=1), **axes}
    return SimpleNamespace(mesh_shape=sizes, mesh_coords={a: 0 for a in sizes},
                           pipeline_stages=lambda: PipelineStages(None, 1, 0, 0, 0))


def test_layer_count_must_divide_the_stages():
    """``num_layers`` must divide ``virtual_stages * pipeline`` (the JAX
    package's ``ValueError``), and pipeline with a sequence axis needs the
    model's sequence dims."""
    model = Llama("llama-tiny", device="meta")
    with pytest.raises(ValueError, match="must divide"):
        port_pipeline.make_pipeline_layers_fn(model.config, _one_stage(pipeline=8), 4, layer_fn=model.pipeline_layer)
    with pytest.raises(ValueError, match="must divide"):
        port_pipeline.make_pipeline_layers_fn(model.config, _one_stage(pipeline=2), 4, layer_fn=model.pipeline_layer,
                                              virtual_stages=2)
    with pytest.raises(NotImplementedError, match="sequence"):
        port_pipeline.make_pipeline_layers_fn(model.config, _one_stage(pipeline=2, sequence=2), 4,
                                              layer_fn=model.pipeline_layer)


def test_declared_broadcast_side_input_with_a_batch_like_leading_dim(params):
    """A batch-invariant side input whose leading dim equals the batch
    (cos/sin ``[S=b, D/2]``) is passed whole when declared ``"bcast"``
    (``tests/test_pipeline.py``'s case, on one stage of 4 layers in 2
    microbatches); a declaration of the wrong count raises."""
    torch.manual_seed(0)
    model = workers.model_of("llama-tiny-4", _params("llama-tiny-4"))
    cfg = model.config
    b = 4
    ids = torch.tensor(_ids(11, b=b, s=b))
    tree = model.param_tree()
    h = tree["embed_tokens"][ids.long()]
    cos, sin = rotary_embedding(torch.arange(b), cfg.dim_per_head, cfg.rope_theta)
    assert cos.shape[0] == b
    with torch.no_grad():
        want = h
        for i in range(cfg.num_layers):
            want, _ = model.pipeline_layer(model.layer_params(i), want, None, None, cos, sin, None)
        fn = port_pipeline.make_pipeline_layers_fn(cfg, _one_stage(), 2, layer_fn=model.pipeline_layer,
                                                   const_kinds=("mb", "bcast", "bcast", "mb"))
        got, _ = fn(tree["layers"], h, None, cos, sin, None)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        bad = port_pipeline.make_pipeline_layers_fn(cfg, _one_stage(), 2, layer_fn=model.pipeline_layer,
                                                    const_kinds=("mb",))
        with pytest.raises(ValueError, match="side inputs"):
            bad(tree["layers"], h, None, cos, sin, None)


# -- (ii) forwards against the JAX package ---------------------------------------------


@pytest.mark.parametrize("key", sorted(FORWARDS))
def test_pipeline_forward_matches_the_jax_package(launches, key):
    """``prepared(...)`` under a pipeline axis (each stage its chunks of the
    layers, the activations hopping between the processes) against the JAX
    package's plain forward; under a sequence axis each process's chunk of
    the sequence, padded positions left out."""
    name, axes, world, args, kwargs, options = FORWARDS[key]
    want, want_aux = launches["jax_forward"][key]
    tol = BF16_LOGITS_ATOL if options.get("mixed_precision") == "bf16" else LOGITS_ATOL
    for rank in _ranks(launches, world, f"forward/{key}"):
        assert rank["pipeline_fn"]
        start, stop = rank["span"]
        ref = want if want.ndim < 3 else want[:, start:stop]
        got = rank["logits"]
        if "attention_mask" in kwargs and want.ndim == 3 and _family(name) != "t5":
            real = kwargs["attention_mask"][:, start:stop].astype(bool)
            got, ref = got[real], ref[real]
        np.testing.assert_allclose(got, ref, atol=tol)
        if want_aux is not None:
            assert abs(rank["aux"] - want_aux) <= AUX_ATOL and rank["aux"] > 0.0


def test_layers_are_stored_as_each_stage_s_chunks(launches):
    """Each process stores its chunks of every stacked leaf: llama-tiny's 2
    layers one a stage, llama-tiny-4 at ``virtual_pipeline_stages=2`` two a
    stage (chunks ``c*P + p``), T5's two stacks each split; the leaves
    outside the stacks whole."""
    stored = _ranks(launches, 2, "forward/llama")[0]["stored"]
    assert stored["layers.wq"] == (1, 128, 128) and stored["embed_tokens"] == (1024, 128)
    assert _ranks(launches, 2, "forward/llama_v2")[0]["stored"]["layers.wq"] == (2, 128, 128)
    t5 = _ranks(launches, 2, "forward/t5")[0]["stored"]
    assert t5["encoder.wq"][0] == 1 and t5["layers.self_wq"][0] == 1 and t5["shared_embed"][0] == 1024


def test_pipeline_dropout_matches_the_fold_reference(launches, params):
    """Residual dropout 0.3 through the schedule against a run without the
    pipeline applying the same fold (``fold_pipeline_dropout_rng`` of the
    base seed, the global layer and the microbatch) to each microbatch."""
    ids = _ids(7)
    seed = torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(42)).tolist()[0]
    model = workers.model_of("llama-tiny", params["llama-tiny"], dropout=0.3)
    cfg, tree = model.config, model.param_tree()
    micro = port_pipeline.microbatch_count(8, ids.shape[0])
    rows = ids.shape[0] // micro
    cos, sin = rotary_embedding(torch.arange(ids.shape[1])[None, :], cfg.dim_per_head, cfg.rope_theta)
    outs = []
    with torch.no_grad():
        for m in range(micro):
            h = tree["embed_tokens"][torch.tensor(ids[m * rows:(m + 1) * rows]).long()]
            for layer in range(cfg.num_layers):
                fold = port_pipeline.fold_pipeline_dropout_rng(seed, layer, m)
                h, _ = model.pipeline_layer(model.layer_params(layer), h, fold, None, cos, sin, None)
            outs.append(h)
        h = rms_norm(torch.cat(outs), tree["final_norm"], cfg.norm_eps)
        want = (h @ (tree["embed_tokens"].T if cfg.tie_embeddings else tree["lm_head"])).numpy()
        plain = model.apply(tree, torch.tensor(ids)).numpy()
    ranks = _ranks(launches, 2, "dropout")
    assert not np.allclose(want, plain, atol=1e-2)  # the masks fired
    for rank in ranks:
        np.testing.assert_allclose(rank["logits"], want, atol=LOGITS_ATOL)


def test_microbatch_count_is_cut_with_a_warning(launches, params):
    """8 microbatches on a batch of 6 run as 6, with the JAX package's
    warning, and the logits equal one process's."""
    model = workers.model_of("llama-tiny", params["llama-tiny"])
    ids = torch.tensor(np.random.default_rng(12).integers(0, 1024, (6, 16)))
    with torch.no_grad():
        want = model.apply(model.param_tree(), ids).numpy()
    for rank, got in enumerate(_ranks(launches, 2, "cut_warning")):
        if rank == 0:  # the logger writes on the main process
            assert any("num_microbatches=8 cut to 6 by batch 6" in w for w in got["warnings"])
        np.testing.assert_allclose(got["logits"], want, atol=LOGITS_ATOL)


# -- (iii) gradients and training --------------------------------------------------------


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
def test_gradients_equal_one_process_s(launches, params, name):
    """The first batch's gradients at ``pipeline=2`` against one process's
    without the pipeline: every leaf outside the layer stack (embeddings,
    gpt2's tied ``wte``, the final norm, llama's head) equal on both stages
    bit for bit and within ``GRAD_RTOL`` of one process's; each stage's
    layer slice within it of the same rows of one process's."""
    _reset()
    one = workers.grads(name, params[name], {}, _batches(name)[0])
    ranks = _ranks(launches, 2, f"grads/{name}")
    assert [r["stage"] for r in ranks] == [0, 1]
    for key, want in one["grads"].items():
        for rank in ranks:
            got = rank["grads"][key]
            if key.startswith("layers."):
                want_slice = want[rank["stage"]:rank["stage"] + 1]
                np.testing.assert_allclose(got, want_slice, atol=GRAD_RTOL * np.abs(want).max(), err_msg=key)
            else:
                np.testing.assert_array_equal(got, ranks[0]["grads"][key], err_msg=key)
                np.testing.assert_allclose(got, want, atol=GRAD_RTOL * np.abs(want).max(), err_msg=key)
        assert abs(ranks[0]["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])


def _assert_params_close(want, got, mean_tol):
    assert set(got) == set(want)
    for key in want:
        diff = np.abs(got[key] - want[key])
        assert diff.max() <= 2 * LR * STEPS, f"{key}: {diff.max()}"
        assert diff.mean() <= mean_tol, f"{key}: mean {diff.mean()}"


@pytest.mark.parametrize("key", sorted(TRAINING))
def test_pipeline_training_matches_the_jax_mesh(launches, key):
    """3 steps of ``fused_adamw`` under the pipeline axis (and the axis
    named) against the JAX ``Accelerator`` on a mesh with a pipeline axis:
    losses and gathered params; every process agrees with every other bit
    for bit."""
    name, axes, world, options, ref = TRAINING[key]
    ranks = _ranks(launches, world, f"train/{key}")
    want = launches["jax_train"][ref]
    for rank in ranks[1:]:
        assert rank["losses"] == ranks[0]["losses"]
        for k in ranks[0]["params"]:
            np.testing.assert_array_equal(rank["params"][k], ranks[0]["params"][k], err_msg=k)
    got = ranks[0]
    precision = options.get("mixed_precision", "no")
    if precision == "fp8":
        np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=FP8_FIRST_LOSS_RTOL)
        assert all(rank["dot_fn"] == 0 for rank in ranks)  # the e4m3 product, margin 0
    rtol = {"fp8": FP8_LOSS_RTOL, "bf16": BF16_LOSS_RTOL}.get(precision, LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
    _assert_params_close(want["params"], got["params"],
                         {"fp8": FP8_MEAN_TOL, "bf16": BF16_MEAN_TOL}.get(precision, 1e-5))
    assert all(got["mesh"][a] == n for a, n in axes.items())
    model_axes = [a for a in axes if a != "data"]
    assert got["distributed_type"] == ("PIPELINE_PARALLEL" if model_axes == ["pipeline"] else "HYBRID")


# -- (iv) checkpoints ----------------------------------------------------------------------


@pytest.mark.parametrize("form", ["whole", "sharded"])
def test_pipeline_checkpoints_load_into_the_jax_package(launches, params, form):
    """A ``pipeline=2`` run's gathered and sharded saves (each stage writes
    its layers' chunks) load into the JAX package bit for bit, and the
    sharded one back into a port run of the same layout."""
    directory = os.path.join(launches["ckpt"], f"{CHECKPOINTED}_{form}")
    saved = _ranks(launches, 2, f"train/{CHECKPOINTED}")
    _reset()
    acc = JaxAccelerator()
    model = JaxLlama("llama-tiny")
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params["llama-tiny"]))
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


def test_interleaved_checkpoint_loads_into_the_jax_package(launches, params):
    """Under ``virtual_pipeline_stages=2`` a stage stores chunks ``c*P + p``
    (llama-tiny-4: stage 0 layers 0 and 2, stage 1 layers 1 and 3), and its
    sharded save, each stage writing its two chunks at their own offsets,
    loads into the JAX package bit for bit."""
    ranks = _ranks(launches, 2, "interleaved")
    assert [rank["rows"] for rank in ranks] == [[0, 2], [1, 3]]
    _reset()
    acc = JaxAccelerator()
    model = _jax_model("llama-tiny-4")
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params["llama-tiny-4"]))
    acc.prepare_optimizer(optax.adamw(LR))
    acc.load_state(os.path.join(launches["ckpt"], "interleaved"))
    got = dict(flatten_tree(jax.tree.map(np.asarray, prepared.params)))
    for k, value in ranks[0]["params"].items():
        np.testing.assert_array_equal(got[k], value, err_msg=k)
        np.testing.assert_array_equal(value, params["llama-tiny-4"][k.split(".")[0]][k.split(".")[1]]
                                      if "." in k else params["llama-tiny-4"][k], err_msg=k)
    _reset()


def test_jax_pipeline_checkpoint_loads_into_the_port(launches):
    """The JAX package's sharded save from its ``pipeline=2`` mesh loads
    into a port run at ``pipeline=2`` bit for bit, each stage storing its
    layer."""
    want = launches["jax_saved"]
    for rank in _ranks(launches, 2, "load"):
        assert rank["stored"]["layers.wq"] == (1, 128, 128)
        for k, value in want.items():
            np.testing.assert_array_equal(rank["params"][k], value, err_msg=k)
