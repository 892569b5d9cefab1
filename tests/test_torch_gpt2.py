"""The port's GPT2 (accelerate_tpu_torch/models/gpt2.py) against the JAX
package's, on the CPU in fp32: ``gpt2-tiny`` (2 layers, hidden 128, 4 heads
of 32, vocab 1024, 256 learned positions) with the JAX package's params,
drawn from a seed and loaded with ``load_jax_params``, and the same numpy
batches.

Tolerances, and why:
- logits: 1e-5 absolute on the einsum path (the same products summed in
  other orders; logits are O(1));
- loss and gradients: the loss within 1e-4 relative, every gradient within
  1e-4 of its leaf's largest magnitude (floored at 1e-4: the key bias's
  gradient is 0 in exact arithmetic), through the einsum path and through
  ``flash_attention_min_seq=128`` (the flash kernels' plain versions, fp32
  scores, the normalisation after P.V) at S=128 against JAX's einsum;
- ``generate`` at temperature 0: the same ids.
Remat is held bit-equal to no remat under deterministic algorithms (the
CPU embedding backward accumulates in no fixed order otherwise)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models import GPT2 as JaxGPT2
from accelerate_tpu.models.config import get_config as jax_get_config
from accelerate_tpu.models.config import list_models as jax_list_models
from accelerate_tpu.models.config import param_count as jax_param_count
from accelerate_tpu.models.generation import generate as jax_generate
from accelerate_tpu_torch import GPT2, Accelerator, CompilationConfig, ServingEngine, adamw, generate
from accelerate_tpu_torch import load_jax_params
from accelerate_tpu_torch.models import build_model, get_config, list_models, param_count, register_config
from accelerate_tpu_torch.ops.flash_attention import make_auto_attention
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.params import flatten_tree, tree_leaves, tree_map

MODEL = "gpt2-tiny"


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
    """(jax model, jax params, numpy tree) of gpt2-tiny."""
    model = JaxGPT2(MODEL)
    params = model.init(jax.random.key(0))
    return model, params, jax.tree.map(np.asarray, params)


def _port(tree, flash_min_seq=0):
    model = load_jax_params(GPT2(MODEL, device="cpu"), tree)
    if flash_min_seq:
        model.attention_fn = make_auto_attention(flash_min_seq, causal=True)
    return model


def _batch(seed=0, batch=2, seq=16, masked=False):
    rng = np.random.default_rng(seed)
    b = {"input_ids": rng.integers(1, 1024, (batch, seq)).astype(np.int32)}
    if masked:
        mask = np.ones((batch, seq), np.int32)
        mask[-1, seq * 5 // 8:] = 0  # a right-padded row
        b["attention_mask"] = mask
    return b


def test_logits_match_jax(pair):
    jax_model, params, tree = pair
    ids = _batch(seed=1, seq=40)["input_ids"]
    want = np.asarray(jax_model.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seq,masked,flash", [(16, False, False), (32, True, False), (128, True, True)],
                         ids=["einsum", "einsum-masked", "flash-masked-s128"])
def test_loss_and_grads_match_jax(pair, seq, masked, flash):
    """The loss and every gradient; at S=128 the port attends through its
    flash path (the kernels' plain versions), JAX by einsum."""
    jax_model, params, tree = pair
    batch = _batch(seed=seq, seq=seq, masked=masked)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(JaxGPT2.loss_fn(jax_model)))(params, jb)
    want_grads = dict(flatten_tree(jax.tree.map(np.asarray, want_grads)))
    port = _port(tree, flash_min_seq=128 if flash else 0)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), port.param_tree())
    loss = GPT2.loss_fn(port)(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(p))
    it = iter(grads)
    got_grads = {k: v.numpy() for k, v in flatten_tree(tree_map(lambda _: next(it), p))}
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    assert set(got_grads) == set(want_grads)
    for key, want in want_grads.items():
        scale = max(np.abs(want).max(), 1e-4)
        np.testing.assert_allclose(got_grads[key], want, rtol=0, atol=1e-4 * scale, err_msg=key)


def test_param_tree_keys_shapes_and_rules_match_jax(pair):
    jax_model, _, tree = pair
    port = GPT2(MODEL, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_tree(port.param_tree())} == {
        k: v.shape for k, v in flatten_tree(tree)}
    assert port.partition_rules() == jax_model.partition_rules()
    broken = jax.tree.map(lambda x: x, tree)
    del broken["layers"]["bqkv"]
    with pytest.raises(KeyError):
        load_jax_params(GPT2(MODEL, device="cpu"), broken)


def test_registry_and_param_count_match_jax():
    """Every gpt2 config of the JAX registry is in the port's with its count
    (gpt2-124m: 124,439,808 with its 1024 learned positions); a built model
    holds exactly that many; ``register_config`` adds a name."""
    gpt2 = [name for name in jax_list_models() if name.startswith("gpt2")]
    assert len(gpt2) == 5 and set(gpt2) <= set(list_models())
    for name in gpt2:
        assert get_config(name).__dict__ == jax_get_config(name).__dict__
        assert param_count(get_config(name)) == jax_param_count(jax_get_config(name))
    assert param_count(get_config("gpt2-124m")) == 124_439_808
    model = build_model("gpt2-124m", device="cpu", dtype=torch.bfloat16)
    assert isinstance(model, GPT2) and sum(p.numel() for p in model.parameters()) == 124_439_808
    register_config("gpt2-test-only", get_config(MODEL).replace(num_layers=1))
    assert "gpt2-test-only" in list_models() and build_model("gpt2-test-only", device="cpu").config.num_layers == 1


def test_init_draws_from_the_seed():
    a, b = (build_model(MODEL, device="cpu", seed=3) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert float(a.layers.attn_norm_scale.min()) == 1.0 and float(a.layers.bqkv.abs().max()) == 0.0
    assert abs(float(a.embed_positions.std()) - 0.01) < 1e-3
    with pytest.raises(ValueError, match="gpt2 config"):
        GPT2("llama-tiny", device="cpu")


def test_positions_past_the_table_raise(pair):
    """Learned positions: a sequence, a given position, a cache or an
    engine slot past max_seq_len raises on the host (a CUDA index past the
    table would end the process)."""
    _, _, tree = pair
    port = _port(tree)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        port(torch.ones((1, 257), dtype=torch.int32))
    with pytest.raises(ValueError, match="max_seq_len"):
        port(torch.ones((1, 4), dtype=torch.int32), positions=torch.tensor([0, 1, 2, 256]))
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        generate(port, np.ones((1, 250), np.int32), max_new_tokens=8, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        ServingEngine(port, num_slots=1, max_len=512, device="cpu")


def test_generate_matches_jax(pair):
    jax_model, params, tree = pair
    ids = _batch(seed=4, seq=9)["input_ids"]
    want = np.asarray(jax_generate(jax_model, params, jnp.asarray(ids), max_new_tokens=8))
    got = generate(_port(tree), ids, max_new_tokens=8, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_dropout_repeats_from_a_seed(pair):
    _, _, tree = pair
    model = load_jax_params(GPT2(get_config(MODEL).replace(dropout_rate=0.1), device="cpu"), tree)
    ids = torch.from_numpy(_batch(seed=5)["input_ids"])
    with torch.no_grad():
        off = model(ids)
        runs = [model.apply(model.param_tree(), ids, dropout_generator=torch.Generator().manual_seed(s))
                for s in (5, 5, 6)]
        assert torch.equal(off, _port(tree)(ids))
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2]) and not torch.allclose(runs[0], off)


def _step_params(tree, policy, dropout_rate):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    acc = Accelerator(device="cpu", compilation_config=CompilationConfig(
        remat_policy=policy, flash_attention_min_seq=128))
    model = load_jax_params(GPT2(get_config(MODEL).replace(dropout_rate=dropout_rate), device="cpu"), tree)
    prepared = acc.prepare_model(model)
    acc.prepare_optimizer(adamw(1e-3))
    gen = torch.Generator().manual_seed(7)
    step = acc.compiled_step(GPT2.loss_fn(model, dropout_generator=gen))
    batch = _batch(seed=6, seq=128, masked=True)
    step({k: torch.from_numpy(v) for k, v in batch.items()})
    return {k: v.detach().clone() for k, v in flatten_tree(prepared.params)}


@pytest.fixture(scope="module")
def deterministic():
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(previous)


@pytest.fixture(scope="module")
def no_remat_step(pair, deterministic):
    return _step_params(pair[2], None, 0.1)


@pytest.mark.parametrize("policy", ["full", "save_flash"])
def test_remat_is_bit_equal_to_none(pair, deterministic, no_remat_step, policy):
    """One step through the flash path with dropout on: every param equal
    bit for bit with and without activation checkpointing."""
    got = _step_params(pair[2], policy, 0.1)
    for key, w in no_remat_step.items():
        assert torch.equal(got[key], w), key


def test_pipeline_and_streamed_forward_wait_for_their_items():
    """The pipeline hook (item 17(c), ``tests/test_torch_pipeline.py``) runs
    one block as the loop does, bit for bit, with no aux; the streamed
    forward (the big-model slice) runs: prefix, every layer, suffix equal
    the model's forward bit for bit, and a per-layer cache past the learned
    positions raises."""
    model = GPT2(MODEL, device="cpu")
    ids = torch.tensor(np.random.default_rng(2).integers(0, 1024, (2, 9)))
    tree = model.param_tree()
    with torch.no_grad():
        h = tree["embed_tokens"][ids]
        got, aux = model.pipeline_layer(model.layer_params(0), h, None, None, None)
        assert torch.equal(got, model._block(h, model.layer_params(0), None)) and aux == 0.0
    resident = {k: v for k, v in tree.items() if k != "layers"}
    carry = model.stream_prefix(resident, ids)
    for i in range(model.config.num_layers):
        carry = model.stream_layer(carry, {k: v[i] for k, v in tree["layers"].items()})
    assert torch.equal(model.stream_suffix(resident, carry), model(ids))
    cfg = model.config
    assert model.init_layer_cache(1, 8, torch.float32, device="cpu")["k"].shape == (
        1, 8, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
    with pytest.raises(ValueError, match="max_seq_len"):
        model.init_layer_cache(1, model.config.max_seq_len + 1, device="cpu")
