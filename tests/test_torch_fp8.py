"""fp8 (e4m3) projections on one process: the port's ``ops/fp8.py`` against
the JAX package's, case by case as ``tests/test_fp8.py`` (its pipeline
case, ``:148``, is in ``tests/test_torch_pipeline.py``); under the tensor
axis in ``tests/test_torch_tensor_parallel.py``.

Tolerances, and why:
- quantize: bit for bit (one division and one cast, RNE both);
- the product and its gradient against ``jax.grad`` in fp32: 1e-5 of each
  result's largest magnitude (the e4m3 values and their products are exact;
  fp32 sums in another order). The gradient is not straight through: the
  cotangents are cast to e4m3 unscaled, and the abs-max routes the scale's
  gradient to its elements, which these cases check;
- training with ``FP8RecipeKwargs(margin=1)``, bf16 compute: losses within
  2e-3 relative of the JAX package's, params within ``2 * lr * steps`` and
  each leaf's mean difference within 6e-4 (bf16 rounds to 2^-8 relative,
  and e4m3 rounds a shifted value to its other neighbour now and then).
  Measured on the CPU: the losses 6.5e-4 to 1.3e-3 off, the worst leaf's
  mean 2.3e-4 (``layers.mlp_norm``; the projections' 8e-9 to 5e-8). With
  the cotangents left in fp32 and not cast to e4m3, which is the
  straight-through gradient these limits are for, the last loss was 3.5e-3
  off and every layer leaf's mean 1.7e-3 to 1.8e-3.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.ops.fp8 import make_fp8_dot as jax_make_fp8_dot
from accelerate_tpu.ops.fp8 import quantize_e4m3 as jax_quantize
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils import FP8RecipeKwargs as JaxFP8RecipeKwargs
from accelerate_tpu_torch import Accelerator, FP8RecipeKwargs, Llama, fused_adamw, load_jax_params
from accelerate_tpu_torch.ops.fp8 import E4M3_MAX, fp8_dot, fp8_dot_reference, make_fp8_dot, quantize_e4m3
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.params import flatten_tree

PRODUCT_TOL = 1e-5
LOSS_RTOL, MEAN_TOL, LR, STEPS = 2e-3, 6e-4, 1e-3, 3


def _reset():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=PRODUCT_TOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("margin", [0, 2])
@pytest.mark.parametrize("shape", [(64, 32), (4, 16, 64)])
def test_quantize_is_bit_equal_to_jax(shape, margin):
    """The e4m3 bytes and the scale equal the JAX package's, and the round
    trip's error stays within e4m3's 3-bit mantissa (``test_fp8.py``'s bound)."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    q, scale = quantize_e4m3(torch.tensor(x), margin)
    jq, jscale = jax_quantize(jnp.asarray(x), margin)
    assert q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(), np.asarray(jq).view(np.uint8))
    assert float(scale) == float(jscale)
    back = q.float().numpy() * float(scale)
    np.testing.assert_allclose(back, x, rtol=2**-3, atol=float(scale) * 2**margin)


def test_quantize_saturates_exactly_at_amax_and_margin_backs_off():
    """Margin 0 maps the abs-max onto ``E4M3_MAX``; each margin bit doubles
    the scale and halves the range (``test_fp8.py``'s two cases)."""
    x = torch.tensor([[-3.0, 0.25], [1.5, 12.0]])
    q, scale = quantize_e4m3(x)
    assert float(scale) == pytest.approx(12.0 / E4M3_MAX)
    assert torch.isfinite(q.float()).all() and float(q.float().abs().max()) == E4M3_MAX
    y = torch.tensor(np.random.default_rng(6).normal(size=(8, 8)).astype(np.float32))
    _, s0 = quantize_e4m3(y, margin=0)
    q1, s1 = quantize_e4m3(y, margin=1)
    assert float(s1) == pytest.approx(2.0 * float(s0))
    assert float(q1.float().abs().max()) <= E4M3_MAX / 2 + 1e-3


def test_zero_tensor_has_no_nan_and_no_gradient_through_the_floor():
    """An all-zero operand meets the scale's floor: finite zeros out, and a
    zero gradient into the scale (the floor's max takes it, as in JAX)."""
    q, scale = quantize_e4m3(torch.zeros(4, 4))
    assert torch.isfinite(scale) and float(q.float().abs().max()) == 0.0
    x = torch.zeros(2, 16, requires_grad=True)
    w = torch.tensor(np.random.default_rng(1).normal(size=(16, 16)).astype(np.float32), requires_grad=True)
    out = fp8_dot(x, w)
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jax_make_fp8_dot()(a, b)), argnums=(0, 1))(
        jnp.zeros((2, 16)), jnp.asarray(w.detach().numpy()))
    _close(x.grad.numpy(), jgx)
    _close(w.grad.numpy(), jgw)


@pytest.mark.parametrize("margin", [0, 1])
@pytest.mark.parametrize("ct_scale", [1.0, 1e-3, 1e3], ids=["ct1", "ct1e-3", "ct1e3"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_product_and_gradient_match_jax_grad(margin, ct_scale, ties):
    """Output, ``dx`` and ``dw`` against ``jax.grad`` of the JAX ``fp8_dot``
    under cotangents of three scales (1e-3 flushes most e4m3 cotangents to
    0, which straight-through would not), two margins, and abs-max ties
    (the scale's gradient shared among them)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 8, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 16)) * 0.1).astype(np.float32)
    if ties:
        x[0, 0, :3] = [5.0, -5.0, 5.0]
        w[1, :2] = [-0.5, 0.5]
    ct = (rng.normal(size=(4, 8, 16)) * ct_scale).astype(np.float32)
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    out = make_fp8_dot(margin)(tx, tw)
    (out * torch.tensor(ct)).sum().backward()
    jdot = jax_make_fp8_dot(margin)
    jout = jdot(jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jdot(a, b) * ct), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(out.detach().numpy(), jout)
    _close(tx.grad.numpy(), jgx)
    _close(tw.grad.numpy(), jgw)
    # the plain version (no autograd function) gives the same product
    np.testing.assert_array_equal(fp8_dot_reference(tx.detach(), tw.detach(), margin).numpy(),
                                  out.detach().numpy())
    # it really quantized: not the exact product
    assert not np.array_equal(out.detach().numpy(), (tx @ tw).detach().numpy())


def test_output_dtype_follows_x():
    x = torch.tensor(np.random.default_rng(7).normal(size=(2, 16)), dtype=torch.bfloat16)
    w = torch.tensor(np.random.default_rng(8).normal(size=(16, 4)), dtype=torch.float32)
    out = fp8_dot(x, w)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4)


def test_recipe_handler_validates_and_sets_the_margin():
    with pytest.raises(ValueError, match="fp8_format"):
        FP8RecipeKwargs(fp8_format="E5M2")
    with pytest.raises(ValueError, match="margin"):
        FP8RecipeKwargs(margin=-1)
    assert FP8RecipeKwargs(fp8_format="hybrid").margin == 0
    _reset()
    acc = Accelerator(mixed_precision="fp8", device="cpu", kwargs_handlers=[FP8RecipeKwargs(margin=3)])
    model = Llama("llama-tiny", device="cpu")
    acc.prepare_model(model)
    assert model.dot_fn.margin == 3
    assert acc.state.precision_policy.compute_dtype == torch.bfloat16
    _reset()
    acc = Accelerator(mixed_precision="fp8", device="cpu")
    model = Llama("llama-tiny", device="cpu")
    acc.prepare_model(model)
    assert model.dot_fn is fp8_dot
    _reset()


def test_model_without_dot_fn_raises():
    class Plain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(4, 4))

        def param_tree(self):
            return {"w": self.w}

        def apply(self, params, x):
            return x @ params["w"]

    _reset()
    acc = Accelerator(mixed_precision="fp8", device="cpu")
    with pytest.raises(NotImplementedError, match="fp8"):
        acc.prepare(Plain())
    _reset()


def test_fp8_output_differs_from_bf16():
    """The same model and batch: fp8's loss moves off bf16's, by little."""
    params = jax.tree.map(np.asarray, JaxLlama("llama-tiny").init(jax.random.key(0)))
    ids = torch.tensor(np.random.default_rng(4).integers(0, 1024, (2, 16)))
    losses = {}
    for precision in ("bf16", "fp8"):
        _reset()
        acc = Accelerator(mixed_precision=precision, device="cpu")
        model = load_jax_params(Llama("llama-tiny", device="cpu"), params)
        prepared = acc.prepare_model(model)
        losses[precision] = float(Llama.loss_fn(model)(_cast(prepared.params), {"input_ids": ids}))
    _reset()
    assert losses["fp8"] != losses["bf16"]
    assert abs(losses["fp8"] - losses["bf16"]) < 0.5


def _cast(tree):
    if isinstance(tree, dict):
        return {k: _cast(v) for k, v in tree.items()}
    return tree.detach().to(torch.bfloat16)


def test_fp8_training_matches_the_jax_package():
    """``mixed_precision="fp8"`` with ``FP8RecipeKwargs(margin=1)``: 3 steps
    of adamw on llama-tiny in both packages, losses and params; the losses
    fall over 6 steps (``test_fp8.py``'s training case)."""
    params = jax.tree.map(np.asarray, JaxLlama("llama-tiny").init(jax.random.key(0)))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 1024, (8, 16)).astype(np.int32) for _ in range(STEPS)]
    _reset()
    jacc = JaxAccelerator(mixed_precision="fp8", kwargs_handlers=[JaxFP8RecipeKwargs(margin=1)])
    jmodel = JaxLlama("llama-tiny")
    jprepared = jacc.prepare_model(jmodel, params=jax.tree.map(jnp.asarray, params))
    jacc.prepare_optimizer(optax.adamw(LR))
    jstep = jacc.compiled_step(JaxLlama.loss_fn(jmodel))
    want = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]
    want_params = dict(flatten_tree(jax.tree.map(np.asarray, jprepared.params)))
    _reset()
    acc = Accelerator(mixed_precision="fp8", device="cpu", kwargs_handlers=[FP8RecipeKwargs(margin=1)])
    model = load_jax_params(Llama("llama-tiny", device="cpu"), params)
    prepared = acc.prepare_model(model)
    acc.prepare_optimizer(fused_adamw(LR))
    step = acc.compiled_step(Llama.loss_fn(model))
    got = [float(step({"input_ids": torch.tensor(b)})) for b in batches]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for key, value in flatten_tree(prepared.params):
        diff = np.abs(value.detach().numpy() - want_params[key])
        assert diff.max() <= 2 * LR * STEPS, key
        assert diff.mean() <= MEAN_TOL, f"{key}: mean {diff.mean()}"
    more = [float(step({"input_ids": torch.tensor(batches[0])})) for _ in range(3)]
    assert np.isfinite(got + more).all() and more[-1] < got[0]
    _reset()
