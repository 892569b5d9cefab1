"""The port's BERT (accelerate_tpu_torch/models/bert.py) and dropout against
the JAX package's, on the CPU in fp32: ``bert-tiny`` (2 layers, hidden 128,
2 heads of 64) with the JAX package's params, drawn from a seed and loaded
with ``load_jax_params``, and the same numpy batches.

Tolerances, and why:
- logits: rtol 1e-4, atol 1e-5 on the einsum path (the same products summed
  in other orders); 2e-4 both on the port's flash path (its plain version:
  fp32 scores, exp-sum normalisation after P·V) against JAX's einsum, the
  bound ``tests/test_flash_attention.py`` holds JAX's own kernel to;
- gradients: within 1e-4 (einsum) or 5e-4 (flash) of each leaf's largest
  magnitude (the embeddings' backward sums rows in another order), floored
  at 1e-4: the key bias's gradient is 0 in exact arithmetic (softmax
  ignores a shift shared by all keys), so both packages hold round-off;
- dropout with an injected mask: equal to the JAX formula to 1 ulp (both
  divide by ``1 - rate`` in fp32); the keep rate over 1e5 draws within 4
  standard deviations (0.0038 at rate 0.1)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models import Bert as JaxBert
from accelerate_tpu.models.attention import dropout as jax_dropout
from accelerate_tpu.models.config import get_config as jax_get_config
from accelerate_tpu.models.config import param_count as jax_param_count
from accelerate_tpu_torch import Bert, Llama, load_jax_params
from accelerate_tpu_torch.models import build_model, get_config, param_count
from accelerate_tpu_torch.models.attention import dropout, dropout_keep, dropout_with_mask
from accelerate_tpu_torch.ops.flash_attention import make_auto_attention
from accelerate_tpu_torch.utils.params import flatten_tree, tree_leaves, tree_map

MODEL = "bert-tiny"


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
    """(jax model, jax params, numpy tree) of bert-tiny."""
    model = JaxBert(MODEL)
    params = model.init(jax.random.key(0))
    return model, params, jax.tree.map(np.asarray, params)


def _batch(seed=0, batch=2, seq=16, masked=False):
    rng = np.random.default_rng(seed)
    b = {
        "input_ids": rng.integers(1, 1024, (batch, seq)).astype(np.int32),
        "token_type_ids": (np.arange(seq)[None, :] >= seq // 2).repeat(batch, 0).astype(np.int32),
        "labels": rng.integers(0, 2, (batch,)).astype(np.int32),
    }
    if masked:
        mask = np.ones((batch, seq), np.int32)
        mask[-1, seq * 5 // 8:] = 0  # a right-padded row
        b["attention_mask"] = mask
    return b


def _port(tree, flash_min_seq=0):
    model = load_jax_params(Bert(MODEL, device="cpu"), tree)
    if flash_min_seq:
        model.attention_fn = make_auto_attention(flash_min_seq, causal=False)
    return model


def _port_loss_and_grads(model, batch):
    params = tree_map(lambda p: p.detach().clone().requires_grad_(), model.param_tree())
    loss = Bert.loss_fn(model)(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(params))
    it = iter(grads)
    return float(loss.detach()), {k: v.numpy() for k, v in flatten_tree(tree_map(lambda _: next(it), params))}


@pytest.mark.parametrize("seq,masked,flash", [(16, False, False), (16, True, False), (128, True, True)],
                         ids=["einsum", "einsum-masked", "flash-masked-s128"])
def test_logits_and_grads_match_jax(pair, seq, masked, flash):
    """Logits, the loss and every gradient; at S=128 the port attends through
    its flash path (the kernels' plain versions), JAX by einsum."""
    jax_model, params, tree = pair
    batch = _batch(seed=seq, seq=seq, masked=masked)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits = np.asarray(jax.jit(lambda p, b: jax_model.apply(
        p, b["input_ids"], b.get("attention_mask"), b["token_type_ids"]))(params, jb))
    want_loss, want_grads = jax.jit(jax.value_and_grad(JaxBert.loss_fn(jax_model)))(params, jb)
    want_grads = dict(flatten_tree(jax.tree.map(np.asarray, want_grads)))
    port = _port(tree, flash_min_seq=128 if flash else 0)
    with torch.no_grad():
        got_logits = port(torch.from_numpy(batch["input_ids"]),
                          None if not masked else torch.from_numpy(batch["attention_mask"]),
                          torch.from_numpy(batch["token_type_ids"])).numpy()
    tol = 2e-4 if flash else None
    np.testing.assert_allclose(got_logits, want_logits, rtol=tol or 1e-4, atol=tol or 1e-5)
    got_loss, got_grads = _port_loss_and_grads(port, batch)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=tol or 1e-5)
    assert set(got_grads) == set(want_grads)
    for key, want in want_grads.items():
        scale = max(np.abs(want).max(), 1e-4)
        np.testing.assert_allclose(got_grads[key], want, rtol=0, atol=(5e-4 if flash else 1e-4) * scale,
                                   err_msg=key)


def test_padding_changes_nothing_past_the_mask(pair):
    """A padded row's logits do not depend on the ids under its padding, on
    the flash path as on the einsum path."""
    _, _, tree = pair
    for flash in (0, 128):
        port = _port(tree, flash)
        batch = _batch(seed=5, seq=128, masked=True)
        other = batch["input_ids"].copy()
        other[-1, 100:] = 7
        with torch.no_grad():
            a, b = (port(torch.from_numpy(ids), torch.from_numpy(batch["attention_mask"])).numpy()
                    for ids in (batch["input_ids"], other))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_sequence_past_the_position_table_raises(pair):
    _, _, tree = pair
    port = _port(tree)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        port(torch.ones((1, 129), dtype=torch.int32))


def test_streaming_bert_waits_for_the_big_model_slice():
    """BERT dispatches through its streaming protocol (the big-model slice):
    every layer streamed from host memory gives the model's own logits, bit
    for bit (``tests/test_torch_big_modeling.py`` holds it to the JAX
    package's)."""
    from accelerate_tpu_torch import cpu_offload

    model = Bert(MODEL, device="cpu", seed=1)
    ids = torch.tensor(np.random.default_rng(1).integers(0, 1024, (2, 10)))
    mask = torch.tensor([[1] * 10, [1] * 7 + [0] * 3])
    streamed = cpu_offload(model, dtype=torch.float32, device="cpu")
    assert not any(streamed.layer_on_device)
    assert torch.equal(streamed(ids, mask), model(ids, mask))


def test_param_tree_keys_and_shapes_match_jax(pair):
    """The port's tree holds the JAX tree's key paths and shapes; a tree with
    a key missing or a shape off does not load."""
    _, _, tree = pair
    port = Bert(MODEL, device="cpu")
    want = {k: v.shape for k, v in flatten_tree(tree)}
    got = {k: tuple(v.shape) for k, v in flatten_tree(port.param_tree())}
    assert got == want
    broken = jax.tree.map(lambda x: x, tree)
    del broken["pooler"]["b"]
    with pytest.raises(KeyError):
        load_jax_params(Bert(MODEL, device="cpu"), broken)
    broken = jax.tree.map(lambda x: x, tree)
    broken["layers"]["wq"] = broken["layers"]["wq"][:, :, :64]
    with pytest.raises(ValueError):
        load_jax_params(Bert(MODEL, device="cpu"), broken)


@pytest.mark.parametrize("name", ["bert-tiny", "bert-base", "bert-large", "llama-moe-tiny", "llama-125m"])
def test_param_count_matches_jax(name):
    """The registry entries equal the JAX package's, and so do their counts
    (bert-base 109,483,778 parameters with a 2-label head)."""
    assert get_config(name).__dict__.items() <= jax_get_config(name).__dict__.items()
    assert param_count(get_config(name)) == jax_param_count(jax_get_config(name))


def test_init_counts_and_orders_like_the_registry():
    model = build_model("bert-tiny", device="cpu", seed=3)
    assert isinstance(model, Bert)
    assert sum(p.numel() for p in model.parameters()) == param_count(model.config)
    again = build_model("bert-tiny", device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    assert float(model.layers.attn_norm_scale.min()) == 1.0 and float(model.layers.bq.abs().max()) == 0.0
    with pytest.raises(ValueError, match="bert config"):
        Bert("llama-tiny", device="cpu")


def test_dropout_with_an_injected_mask_matches_jax_formula():
    """The same keep mask through both packages: JAX's ``dropout`` formula
    (``where(keep, x / (1 - rate), 0)``) with its bernoulli mask, and the
    port's mask form given that mask."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    key = jax.random.key(3)
    rate = 0.3
    want = np.asarray(jax_dropout(jnp.asarray(x), rate, key))
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, x.shape))
    got = dropout_with_mask(torch.from_numpy(x), rate, torch.from_numpy(keep)).numpy()
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


def test_dropout_keep_rate_and_identities():
    gen = torch.Generator().manual_seed(0)
    keep = dropout_keep((100_000,), 0.1, gen, "cpu")
    assert abs(float(keep.float().mean()) - 0.9) <= 4 * (0.9 * 0.1 / 1e5) ** 0.5
    x = torch.randn(3, 5)
    assert dropout(x, 0.0, torch.Generator().manual_seed(1)) is x
    assert dropout(x, 0.5, None) is x
    y = dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert torch.equal(y, dropout(x, 0.5, torch.Generator().manual_seed(1)))
    assert torch.equal(y[y != 0], (x * 2)[y != 0])


def test_bert_dropout_draws_from_the_generator(pair):
    """Dropout is on only with a generator; the same generator seed gives
    the same logits, another seed others; without one the model is
    deterministic and equals the rate-0 model."""
    _, _, tree = pair
    model = load_jax_params(Bert(get_config(MODEL).replace(dropout_rate=0.1), device="cpu"), tree)
    plain = _port(tree)
    b = _batch(seed=1, masked=True)
    args = (torch.from_numpy(b["input_ids"]), torch.from_numpy(b["attention_mask"]),
            torch.from_numpy(b["token_type_ids"]))
    with torch.no_grad():
        off = model.apply(model.param_tree(), *args)
        assert torch.equal(off, plain.apply(plain.param_tree(), *args))
        runs = [model.apply(model.param_tree(), *args, dropout_generator=torch.Generator().manual_seed(s))
                for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2]) and not torch.allclose(runs[0], off)


def test_llama_residual_dropout_draws_from_the_generator():
    """A llama config with dropout builds (it raised before the port had
    dropout), and its residual dropout is on only with a generator."""
    model = Llama(get_config("llama-tiny").replace(dropout_rate=0.1), device="cpu")
    ids = torch.ones((1, 8), dtype=torch.int32)
    with torch.no_grad():
        a, b = (model.apply(model.param_tree(), ids, dropout_generator=torch.Generator().manual_seed(0))
                for _ in range(2))
        off = model.apply(model.param_tree(), ids)
    assert torch.equal(a, b) and not torch.allclose(a, off)
