"""The port's training step against the JAX package's: llama-tiny (GQA 4/2,
vocab 1024), batch 2 x 256 tokens, the same params (JAX's init, loaded with
``load_jax_params``) and the same numpy batches, through each package's
``Accelerator`` -> ``prepare_model`` -> ``prepare_optimizer(fused_adamw(1e-3))``
-> ``compiled_step`` (or the eager ``backward`` + ``optimizer.step()``).

The JAX side runs on the CPU, where its ``Accelerator`` wires no flash kernel
(it does on a TPU only) and attends by einsum; its adamw kernel runs in
interpret mode. The port sets ``flash_attention_min_seq=128``, so its flash
path (the kernels' plain versions on the CPU) runs against JAX's einsum.

Tolerances, and why:
- losses: rtol 1e-5 in fp32 (sums in other orders). In bf16 1e-4 at the
  first step (the einsum path rounds ``q·scale`` and the scores to bf16, the
  flash path keeps fp32 scores) and 1e-3 after it, once the params carry
  Adam's amplification of the bf16 gradients' rounding (below);
- step-1 gradients (fp32): within 1e-4 of each gradient's largest magnitude
  (the embedding's backward sums rows with atomics-free scatter-adds here,
  but in another order than XLA's);
- params after N steps: Adam's first steps move each param by about
  ``lr * g / |g|``, so a gradient near 0 whose rounding differs between the
  frameworks can move a param by up to ``2 * lr`` a step: the largest
  difference is held to ``2 * lr * N``, and the mean one to 1e-5 (fp32) or
  2e-4 (bf16), which is where nearly all params sit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import ParallelismConfig
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.ops.fused_adamw import fused_adamw as jax_fused_adamw
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils.dataclasses import LossScaleKwargs as JaxLossScaleKwargs
from accelerate_tpu_torch import (
    Accelerator,
    CompilationConfig,
    Llama,
    LossScaleKwargs,
    fused_adamw,
    load_jax_params,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig as PortParallelismConfig
from accelerate_tpu_torch.utils.params import flatten_tree

LR = 1e-3
MODEL = "llama-tiny"


@pytest.fixture(scope="module")
def init_params():
    return jax.tree.map(np.asarray, JaxLlama(MODEL).init(jax.random.key(0)))


def _batches(n, seed=0, masked=False, batch=2, seq=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"input_ids": rng.integers(0, 1024, (batch, seq)).astype(np.int32)}
        if masked:
            mask = np.ones((batch, seq), np.int32)
            mask[-1, 177:] = 0  # a right-padded row: its loss weights end at 177
            b["attention_mask"] = mask
        out.append(b)
    return out


def _reset():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _jax_setup(params, mixed_precision="no", accum=1, handlers=None):
    _reset()
    acc = JaxAccelerator(
        mixed_precision=mixed_precision, gradient_accumulation_steps=accum,
        parallelism=ParallelismConfig(zero_stage=0), kwargs_handlers=handlers,
    )
    model = JaxLlama(MODEL)
    prepared = acc.prepare_model(model, params=jax.tree.map(jnp.asarray, params))
    optimizer = acc.prepare_optimizer(jax_fused_adamw(LR))
    return acc, model, prepared, optimizer


def _port_setup(params, mixed_precision="no", accum=1, handlers=None):
    _reset()
    acc = Accelerator(
        mixed_precision=mixed_precision, gradient_accumulation_steps=accum, device="cpu",
        compilation_config=CompilationConfig(flash_attention_min_seq=128), kwargs_handlers=handlers,
    )
    model = load_jax_params(Llama(MODEL, device="cpu"), params)
    prepared = acc.prepare_model(model)
    optimizer = acc.prepare_optimizer(fused_adamw(LR))
    return acc, model, prepared, optimizer


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _assert_params_close(jax_params, port_params, steps, mean_tol):
    want = dict(flatten_tree(jax.tree.map(np.asarray, jax_params)))
    got = {k: v.detach().numpy() for k, v in flatten_tree(port_params)}
    assert set(want) == set(got)
    for key in want:
        diff = np.abs(got[key] - want[key])
        assert diff.max() <= 2 * LR * steps, f"{key}: {diff.max()}"
        assert diff.mean() <= mean_tol, f"{key}: mean {diff.mean()}"


@pytest.mark.parametrize("mixed_precision,loss_rtol,mean_tol",
                         [("no", (1e-5, 1e-5), 1e-5), ("bf16", (1e-4, 1e-3), 2e-4)], ids=["fp32", "bf16"])
def test_compiled_step_matches_jax(init_params, mixed_precision, loss_rtol, mean_tol):
    """3 steps of compiled_step on one batch (the loss falls as it is
    learnt): per-step losses, then the params."""
    batches = _batches(1, masked=True) * 3
    acc, model, prepared, _ = _jax_setup(init_params, mixed_precision)
    step = acc.compiled_step(JaxLlama.loss_fn(model))
    want = [float(step(_jax_batch(b))) for b in batches]
    acc, model, port, _ = _port_setup(init_params, mixed_precision)
    step = acc.compiled_step(Llama.loss_fn(model))
    got = [float(step(_port_batch(b))) for b in batches]
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=loss_rtol[1])
    assert got[-1] < got[0] - 1.0
    _assert_params_close(prepared.params, port.params, 3, mean_tol)


def test_step1_grads_match_jax(init_params):
    """fp32, one eager backward: the accumulated gradient of every leaf."""
    batch = _batches(1, seed=4, masked=True)[0]
    acc, model, prepared, optimizer = _jax_setup(init_params)
    want_loss = float(acc.backward(JaxLlama.loss_fn(model), _jax_batch(batch)))
    want = dict(flatten_tree(jax.tree.map(np.asarray, optimizer.grads)))
    acc, model, port, optimizer = _port_setup(init_params)
    got_loss = float(acc.backward(Llama.loss_fn(model), _port_batch(batch)))
    got = {k: v.numpy() for k, v in flatten_tree(optimizer.grads)}
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for key in want:
        assert got[key].dtype == np.float32
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4 * scale, err_msg=key)


def test_accumulation_and_clip_match_jax(init_params):
    """fp32, gradient_accumulation_steps=2 (two microbatches of one
    sequence each), clip_grad_value=0.02 then clip_grad_norm=0.5, 3 steps."""
    batches = _batches(3, seed=1)
    clips = dict(clip_grad_norm=0.5, clip_grad_value=0.02)
    acc, model, prepared, _ = _jax_setup(init_params, accum=2)
    step = acc.compiled_step(JaxLlama.loss_fn(model), **clips)
    want = [float(step(_jax_batch(b))) for b in batches]
    acc, model, port, _ = _port_setup(init_params, accum=2)
    step = acc.compiled_step(Llama.loss_fn(model), **clips)
    got = [float(step(_port_batch(b))) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(prepared.params, port.params, 3, 1e-5)


def _eager(acc, model_loss, optimizer, batches, to_batch):
    losses = []
    acc.clip_grad_value_(0.05)
    acc.clip_grad_norm_(1.0)
    for b in batches:
        with acc.accumulate():
            losses.append(float(acc.backward(model_loss, to_batch(b))))
            optimizer.step()
            optimizer.zero_grad()
    return losses


def test_eager_backward_and_step_match_jax(init_params):
    """fp32, the eager path: accumulate over 2 batches, clip_grad_value_(0.05)
    and clip_grad_norm_(1.0), optimizer.step() / zero_grad() on every batch
    (they act on every 2nd): 4 batches, 2 updates."""
    batches = _batches(4, seed=2, masked=True)
    acc, model, prepared, optimizer = _jax_setup(init_params, accum=2)
    want = _eager(acc, JaxLlama.loss_fn(model), optimizer, batches, _jax_batch)
    want_steps = optimizer.step_count
    acc, model, port, optimizer = _port_setup(init_params, accum=2)
    got = _eager(acc, Llama.loss_fn(model), optimizer, batches, _port_batch)
    assert optimizer.step_count == want_steps == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(prepared.params, port.params, 2, 1e-5)


def _poisoned(loss_fn):
    """The llama loss times the batch's ``poison`` factor: inf makes every
    gradient non-finite."""
    def fn(params, batch):
        base = {k: v for k, v in batch.items() if k != "poison"}
        return loss_fn(params, base) * batch["poison"]

    return fn


def test_fp16_loss_scale_skips_and_backs_off_like_jax(init_params):
    """fp16 with a loss scale of 2^8: a finite step, a step whose grads are
    non-finite (skipped: params kept, scale halved), a finite step. Scale,
    skip flags and losses as the JAX scaled_optimizer_update gives them."""
    batches = _batches(3, seed=3)
    poison = [1.0, np.inf, 1.0]

    def run(setup, llama, to_batch, handler):
        acc, model, prepared, optimizer = setup(init_params, "fp16", handlers=[handler(init_scale=2.0**8)])
        step = acc.compiled_step(_poisoned(llama.loss_fn(model)))
        trace = []
        for b, f in zip(batches, poison):
            batch = to_batch(b)
            batch["poison"] = to_batch({"p": np.float32(f)})["p"]
            before = jax.tree.map(np.asarray, prepared.params) if llama is JaxLlama else None
            loss = float(step(batch))
            trace.append((loss, float(optimizer.scale), optimizer.step_was_skipped))
            if f != 1.0 and before is not None:
                after = jax.tree.map(np.asarray, prepared.params)
                assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(before)))
        return trace, prepared.params

    want, jax_params = run(_jax_setup, JaxLlama, _jax_batch, JaxLossScaleKwargs)
    got, port_params = run(_port_setup, Llama, _port_batch, LossScaleKwargs)
    assert [t[1:] for t in got] == [t[1:] for t in want] == [(256.0, False), (128.0, True), (128.0, False)]
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-3)
    np.testing.assert_allclose(got[2][0], want[2][0], rtol=1e-3)
    _assert_params_close(jax_params, port_params, 2, 2e-4)


def test_prepare_model_wires_flash_and_trains_the_masters():
    """The fp32 masters require grad after prepare_model; the attention hook
    is the flash dispatch when flash_attention_min_seq is set, einsum at 0."""
    _reset()
    acc = Accelerator(device="cpu")
    model = Llama(MODEL, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    prepared = acc.prepare_model(model)
    assert all(p.requires_grad for p in model.parameters())
    assert model.attention_fn is not None and model.remat_layers is False
    assert prepared.params["layers"]["wq"] is model.layers.wq
    _reset()
    acc = Accelerator(device="cpu", compilation_config=CompilationConfig(flash_attention_min_seq=0))
    model = Llama(MODEL, device="cpu")
    acc.prepare_model(model)
    assert model.attention_fn is None


def test_prepare_sorts_models_before_transforms():
    """prepare() binds the transform to the model prepared in the same call,
    whatever their order."""
    _reset()
    acc = Accelerator(device="cpu")
    model = Llama(MODEL, device="cpu")
    tx = fused_adamw(1e-3)
    optimizer, prepared = acc.prepare(tx, model)
    assert prepared.module is model and optimizer.tx is tx
    assert optimizer.params is prepared.params
    assert int(optimizer.opt_state[0].count) == 0


def test_set_seed_makes_the_generators_repeat():
    from accelerate_tpu_torch import set_seed
    from accelerate_tpu_torch.utils.random import generator

    set_seed(11)
    first = (torch.randn(4, generator=generator("cpu")), torch.randn(4), np.random.rand(2))
    set_seed(11)
    again = (torch.randn(4, generator=generator("cpu")), torch.randn(4), np.random.rand(2))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    set_seed(12)
    assert not torch.equal(torch.randn(4, generator=generator("cpu")), first[0])


def test_later_slices_raise_not_implemented():
    """fp8, tensor parallelism and the ring's flash block wait for their
    items (``remat_policy`` raised here until activation checkpointing came;
    a ``ParallelismConfig`` until training across processes came)."""
    from accelerate_tpu_torch.ops.flash_attention import flash_attention_block

    _reset()
    assert CompilationConfig(remat_policy="save_flash").checkpoint_policy() is not None
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        flash_attention_block(None, None, None)
    with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
        Accelerator(mixed_precision="fp8", device="cpu")
    _reset()
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        Accelerator(parallelism=PortParallelismConfig(tensor=2), device="cpu")
    _reset()


def test_entry_points_raise_without_a_card():
    """``device=None`` means CUDA: without a card the entry points raise
    instead of quietly training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _reset()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator()
    _reset()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Llama(MODEL)
