"""The port's T5 (accelerate_tpu_torch/models/t5.py) against the JAX
package's, on the CPU in fp32: ``t5-tiny`` (2 + 2 layers, hidden 128, 4 heads
of 32, 8 relative buckets) with the JAX package's params (``T5.init``, loaded
with ``load_jax_params``) and the same numpy batches: 256 encoder tokens and
128 decoder tokens, batch row 1 padded on both sides.

Both packages run T5 two ways: by einsum (no hook), and through their flash
dispatch with ``min_seq=128``, which routes all three attention sites there
(encoder self with the bidirectional bias, decoder self with the causal one,
cross without): JAX's Pallas kernels in interpret mode, the port's plain
versions of its kernels.

Tolerances, and why:
- logits: rtol 1e-4, atol 2e-5 (the same fp32 products summed in other
  orders; the flash sides normalise after P·V);
- the loss: rtol 1e-5; gradients: within 1e-4 of each leaf's largest
  magnitude (the embedding's and the bias tables' backward scatter-add rows
  in another order than XLA);
- ``compiled_step`` losses: rtol 1e-5 (the JAX ``Accelerator`` attends by
  einsum on the CPU, the port through its flash path); params after 3 steps
  within ``2 * lr * 3`` (Adam's first steps move a param by about
  ``lr * g / |g|``) and a mean difference of 1e-4 (a tenth of lr): at
  t5-tiny's init most gradients sit near 0, so Adam's sign-like steps
  amplify fp32 rounding, and every leaf drifts by 1e-5 to 3e-5 on average
  even between the two packages' einsum paths;
- remat and ZeRO at one process: bit-equal to the step without them
  (``torch.use_deterministic_algorithms``: the CPU embedding backward
  otherwise sums in no fixed order)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import ParallelismConfig
from accelerate_tpu.models import T5 as JaxT5
from accelerate_tpu.models.config import get_config as jax_get_config
from accelerate_tpu.models.config import param_count as jax_param_count
from accelerate_tpu.models.t5 import relative_position_bucket as jax_bucket
from accelerate_tpu.ops.flash_attention import make_auto_attention as jax_auto_attention
from accelerate_tpu.ops.fused_adamw import fused_adamw as jax_fused_adamw
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch import (
    T5,
    Accelerator,
    CompilationConfig,
    FullyShardedDataParallelPlugin,
    fused_adamw,
    load_jax_params,
)
from accelerate_tpu_torch.models import build_model, get_config, list_models, param_count
from accelerate_tpu_torch.models.t5 import relative_position_bucket
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops.flash_attention import make_auto_attention
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.params import flatten_tree, tree_leaves, tree_map

MODEL = "t5-tiny"
LR = 1e-3
T5_NAMES = ["t5-tiny", "t5-small", "t5-base", "t5-large", "t5-3b", "t5-11b"]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, numpy tree) of t5-tiny."""
    model = JaxT5(MODEL)
    params = model.init(jax.random.key(1))
    return model, params, jax.tree.map(np.asarray, params)


def _batch(seed=0, batch=2, enc=256, dec=128, masked=True):
    rng = np.random.default_rng(seed)
    b = {
        "input_ids": rng.integers(0, 1024, (batch, enc)).astype(np.int32),
        "labels": rng.integers(0, 1024, (batch, dec)).astype(np.int32),
    }
    if masked:
        am = np.ones((batch, enc), np.int32)
        am[-1, 150:] = 0  # a right-padded encoder row, its bound mid-tile
        dm = np.ones((batch, dec), np.int32)
        dm[-1, 90:] = 0
        b["attention_mask"], b["decoder_attention_mask"] = am, dm
    return b


def _port(tree, flash: bool):
    model = load_jax_params(T5(MODEL, device="cpu"), tree)
    if flash:
        model.attention_fn = make_auto_attention(128)
    return model


def _jax_model(flash: bool):
    model = JaxT5(MODEL)
    if flash:
        model.attention_fn = jax_auto_attention(min_seq=128)
    return model


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_registry_shift_right_and_param_count_match_jax():
    """Every t5 config field for field, ``param_count`` (and the module's
    own count at t5-tiny), ``build_model`` and ``shift_right``."""
    assert [n for n in list_models() if n.startswith("t5")] == sorted(T5_NAMES)
    for name in T5_NAMES:
        want = dataclasses.asdict(jax_get_config(name))
        got = dataclasses.asdict(get_config(name))
        assert {k: want[k] for k in got} == got, name
        assert param_count(get_config(name)) == jax_param_count(jax_get_config(name)), name
    model = build_model(MODEL, device="cpu")
    assert isinstance(model, T5)
    assert sum(p.numel() for p in model.parameters()) == param_count(model.config)
    labels = np.random.default_rng(3).integers(1, 1024, (3, 9)).astype(np.int32)
    want = np.asarray(JaxT5(MODEL).shift_right(jnp.asarray(labels)))
    np.testing.assert_array_equal(model.shift_right(torch.from_numpy(labels)).numpy(), want)
    assert (want[:, 0] == get_config(MODEL).decoder_start_token_id).all()


@pytest.mark.parametrize("bidirectional,buckets,distance", [(True, 32, 128), (False, 32, 128), (True, 8, 32),
                                                            (False, 8, 32)])
def test_relative_position_buckets_match_jax(bidirectional, buckets, distance):
    rel = np.arange(-600, 600, dtype=np.int32)
    want = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional, buckets, distance))
    got = relative_position_bucket(torch.from_numpy(rel).long(), bidirectional, buckets, distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_param_tree_keys_and_shapes_match_jax(pair):
    """26 leaves at the JAX key paths: the embedding, two bias tables, two
    final norms, 8 encoder and 13 decoder leaves; ``load_jax_params``
    carries the nested tree across unchanged."""
    _, _, tree = pair
    model = _port(tree, flash=False)
    want = {k: v.shape for k, v in flatten_tree(tree)}
    got = {k: tuple(v.shape) for k, v in flatten_tree(model.param_tree())}
    assert got == want and len(got) == 26
    for key, leaf in flatten_tree(model.param_tree()):
        np.testing.assert_array_equal(leaf.detach().numpy(), dict(flatten_tree(tree))[key])


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_encode_and_logits_match_jax(pair, flash, monkeypatch):
    """Encoder states and decoder logits with padding on both sides, each
    package by einsum or through its flash dispatch; the port's flash path
    runs all three attention sites (2 encoder + 2 x 2 decoder calls)."""
    _, params, tree = pair
    jax_model = _jax_model(flash)
    port = _port(tree, flash)
    calls = {"n": 0}
    forward = fa.flash_forward

    def counted(*args):
        calls["n"] += 1
        return forward(*args)

    monkeypatch.setattr(fa, "flash_forward", counted)
    b = _batch(seed=1)
    jb = _jb(b)
    dec = jax_model.shift_right(jb["labels"])
    want_enc = np.asarray(jax_model.encode(params, jb["input_ids"], jb["attention_mask"]))
    want = np.asarray(jax_model.apply(params, jb["input_ids"], dec, jb["attention_mask"],
                                      jb["decoder_attention_mask"]))
    tb = _tb(b)
    with torch.no_grad():
        got_enc = port.encode(port.param_tree(), tb["input_ids"], tb["attention_mask"]).numpy()
        assert calls["n"] == (2 if flash else 0)
        got = port(tb["input_ids"], port.shift_right(tb["labels"]), tb["attention_mask"],
                   tb["decoder_attention_mask"]).numpy()
    assert calls["n"] == (2 + 6 if flash else 0)
    assert got.dtype == np.float32 and got.shape == (2, 128, 1024)
    np.testing.assert_allclose(got_enc, want_enc, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_masked_loss_and_every_gradient_match_jax(pair, flash):
    """The loss (mean over the decoder mask's real positions) and the
    gradient of every leaf, the bias tables' included (on the flash path
    they come from the dq kernel's dbias, summed over the batch)."""
    _, params, tree = pair
    jax_model = _jax_model(flash)
    b = _batch(seed=2)
    want_loss, want_grads = jax.jit(jax.value_and_grad(JaxT5.loss_fn(jax_model)))(params, _jb(b))
    want_grads = dict(flatten_tree(jax.tree.map(np.asarray, want_grads)))
    port = _port(tree, flash)
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), port.param_tree())
    loss = T5.loss_fn(port)(leaves, _tb(b))
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    got_grads = {k: v.numpy() for k, v in flatten_tree(tree_map(lambda _: next(it), leaves))}
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert set(got_grads) == set(want_grads)
    for key, want in want_grads.items():
        assert np.abs(want).max() > 0, key
        np.testing.assert_allclose(got_grads[key], want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=key)


def _reset():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _port_steps(tree, batches, remat_policy=None, fsdp_plugin=None, dropout_seed=None, config=MODEL):
    """Losses of ``compiled_step`` over ``batches`` and the params after."""
    _reset()
    acc = Accelerator(device="cpu", fsdp_plugin=fsdp_plugin, compilation_config=CompilationConfig(
        flash_attention_min_seq=128, remat_policy=remat_policy))
    model = T5(config, device="cpu")
    if tree is not None:
        load_jax_params(model, tree)
    prepared = acc.prepare_model(model)
    acc.prepare_optimizer(fused_adamw(LR))
    gen = None if dropout_seed is None else torch.Generator().manual_seed(dropout_seed)
    step = acc.compiled_step(T5.loss_fn(model, dropout_generator=gen))
    losses = [float(step(_tb(b))) for b in batches]
    params = {k: v.detach().clone() for k, v in flatten_tree(prepared.params)}
    _reset()
    return losses, params


def test_compiled_step_with_fused_adamw_matches_jax(pair):
    """3 steps of ``Accelerator`` -> ``prepare_model`` ->
    ``prepare_optimizer(fused_adamw)`` -> ``compiled_step(T5.loss_fn)``:
    per-step losses (the loss falls), then the params."""
    _, params, tree = pair
    batches = [_batch(seed=4)] * 3
    _reset()
    acc = JaxAccelerator(parallelism=ParallelismConfig(zero_stage=0))
    model = JaxT5(MODEL)
    prepared = acc.prepare_model(model, params=params)
    acc.prepare_optimizer(jax_fused_adamw(LR))
    step = acc.compiled_step(JaxT5.loss_fn(model))
    want = [float(step(_jb(b))) for b in batches]
    want_params = dict(flatten_tree(jax.tree.map(np.asarray, prepared.params)))
    got, got_params = _port_steps(tree, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    assert set(got_params) == set(want_params)
    for key, want_p in want_params.items():
        diff = np.abs(got_params[key].numpy() - want_p)
        assert diff.max() <= 2 * LR * 3, f"{key}: {diff.max()}"
        assert diff.mean() <= 0.1 * LR, f"{key}: mean {diff.mean()}"


@pytest.fixture
def deterministic():
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(previous)


def test_remat_and_one_process_fsdp_equal_the_plain_step(pair, deterministic, monkeypatch):
    """A step under ``remat_policy`` "full" and "save_flash", and under a
    one-process FSDP plugin with activation checkpointing (its default
    "save_flash"), against the same step without remat: equal loss and
    params. The flash forward runs 6 times a step (2 encoder, 4 decoder
    calls), 12 under "full", 6 under "save_flash" (the stash carries out
    and lse across the decoder layer's two calls)."""
    _, _, tree = pair
    batches = [_batch(seed=5, enc=128)]
    calls = {"n": 0}
    forward = fa.flash_forward

    def counted(*args):
        calls["n"] += 1
        return forward(*args)

    monkeypatch.setattr(fa, "flash_forward", counted)
    want = _port_steps(tree, batches)
    assert calls["n"] == 6
    for policy, plugin, forwards in (("full", None, 12), ("save_flash", None, 6),
                                     (None, FullyShardedDataParallelPlugin(activation_checkpointing=True), 6)):
        calls["n"] = 0
        got = _port_steps(tree, batches, remat_policy=policy, fsdp_plugin=plugin)
        assert calls["n"] == forwards, policy
        assert got[0] == want[0], policy
        for key in want[1]:
            assert torch.equal(got[1][key], want[1][key]), (policy, key)


def test_eager_backward_and_step_equal_the_compiled_step(pair, deterministic):
    """``accelerator.backward(T5.loss_fn(model), batch)`` then
    ``optimizer.step()``: the compiled step's loss and params."""
    _, _, tree = pair
    batch = _batch(seed=8, enc=128)
    want = _port_steps(tree, [batch])
    _reset()
    acc = Accelerator(device="cpu", compilation_config=CompilationConfig(flash_attention_min_seq=128))
    model = load_jax_params(T5(MODEL, device="cpu"), tree)
    prepared = acc.prepare_model(model)
    optimizer = acc.prepare_optimizer(fused_adamw(LR))
    loss = acc.backward(T5.loss_fn(model), _tb(batch))
    optimizer.step()
    assert float(loss) == want[0][0]
    for key, leaf in flatten_tree(prepared.params):
        assert torch.equal(leaf.detach(), want[1][key]), key
    _reset()


def test_dropout_draws_from_the_generator(pair, deterministic):
    """t5-tiny with dropout 0.1 (5 masks a layer pair: 2 encoder, 3 decoder),
    through the flash path: one generator seed gives the same step twice,
    the second time under "full" remat (a recomputed layer draws its masks
    again), another seed another step."""
    cfg = get_config(MODEL).replace(dropout_rate=0.1)
    batches = [_batch(seed=7, enc=128)]
    a = _port_steps(None, batches, dropout_seed=5, config=cfg)
    b = _port_steps(None, batches, dropout_seed=5, config=cfg, remat_policy="full")
    c = _port_steps(None, batches, dropout_seed=6, config=cfg)
    assert a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert a[0] != c[0]


def test_streaming_and_pipeline_hooks_name_their_items():
    """The pipeline hooks name ROADMAP item 17; the streaming protocol (the
    big-model slice) runs: prefix (the encoder), every decoder layer and
    suffix equal the model's forward bit for bit."""
    model = T5(MODEL, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        model.pipeline_layer({}, None, None)
    rng = np.random.default_rng(3)
    ids = torch.tensor(rng.integers(0, 1024, (2, 11)))
    dec = torch.tensor(rng.integers(0, 1024, (2, 5)))
    tree = model.param_tree()
    resident = {k: v for k, v in tree.items() if k != "layers"}
    carry = model.stream_prefix(resident, ids, dec)
    for i in range(model.config.num_layers):
        carry = model.stream_layer(carry, {k: v[i] for k, v in tree["layers"].items()})
    assert torch.equal(model.stream_suffix(resident, carry), model(ids, dec))
