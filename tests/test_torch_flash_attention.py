"""The port's flash attention (accelerate_tpu_torch/ops/flash_attention.py)
against the JAX package's ``flash_attention``, whose Pallas kernels run in
interpret mode on the CPU: the forward and the vjp of q, k and v, on the same
numpy inputs.

On the CPU the port's wrappers take their plain PyTorch versions; the CUDA
kernels are held against those on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

Tolerances, as ``tests/test_flash_attention.py`` uses them in fp32: 2e-5 on
the forward and 5e-4 on the grads (the two sides sum in other orders: the
JAX kernels block by block with an online softmax, the plain versions over
whole rows)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models.attention import dot_product_attention as jax_dot_product_attention
from accelerate_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from accelerate_tpu_torch.models.attention import dot_product_attention
from accelerate_tpu_torch.ops import flash_attention as fa

FWD_TOL, GRAD_TOL = 2e-5, 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _case(b=2, s=256, t=None, n=4, kv=4, d=64, seed=0):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    q = rng.normal(size=(b, s, n, d)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    do = rng.normal(size=(b, s, n, d)).astype(np.float32)
    return q, k, v, do


def _jax(q, k, v, do, mask, **kwargs):
    """JAX forward and the vjp of q, k, v against cotangent ``do``."""
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, jm, **kwargs),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(q, k, v, do, mask, fn=fa.flash_attention, **kwargs):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*leaves, None if mask is None else torch.tensor(mask), **kwargs)
    out.backward(torch.tensor(do))
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _assert_close(port, want):
    (out, grads), (w_out, w_grads) = port, want
    np.testing.assert_allclose(out, w_out, rtol=FWD_TOL, atol=FWD_TOL)
    for g, w, name in zip(grads, w_grads, "qkv"):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa4x2"])
def test_forward_and_grads_match_jax(causal, kv):
    q, k, v, do = _case(kv=kv, seed=kv)
    _assert_close(_port(q, k, v, do, None, causal=causal), _jax(q, k, v, do, None, causal=causal))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_masked_with_a_fully_padded_row_matches_jax(causal):
    """A [B, S] mask: batch row 0 padded from 200 (mid-tile), row 1 padded
    throughout. The padded row's output and grads are exactly 0 on both
    sides (the running max starts at M_INIT, not at a masked score)."""
    q, k, v, do = _case(kv=2, seed=6)
    mask = np.ones((2, 256), np.int32)
    mask[0, 200:] = 0
    mask[1] = 0
    port = _port(q, k, v, do, mask, causal=causal)
    _assert_close(port, _jax(q, k, v, do, mask, causal=causal))
    out, grads = port
    assert np.count_nonzero(out[1]) == 0
    for g in grads:
        assert np.count_nonzero(g[1]) == 0


def test_distinct_lengths_bidirectional_match_jax():
    """Cross attention: 128 queries over 256 keys, non-causal, masked."""
    q, k, v, do = _case(s=128, t=256, n=2, kv=2, seed=10)
    mask = np.ones((2, 256), np.int32)
    mask[1, 150:] = 0
    _assert_close(_port(q, k, v, do, mask, causal=False), _jax(q, k, v, do, mask, causal=False))


@pytest.mark.parametrize("s,causal_t", [(200, None), (96, None), (256, 384)],
                         ids=["untileable_200", "untileable_96", "causal_s_ne_t"])
def test_untileable_shapes_take_the_einsum_path(s, causal_t):
    """A length no 128-block divides, or causal with S != T: both packages
    run their einsum attention (no kernel launch in the port)."""
    q, k, v, do = _case(s=s, t=causal_t, n=2, kv=2, seed=s)
    launches = fa.flash_forward.launches
    _assert_close(_port(q, k, v, do, None, causal=True), _jax(q, k, v, do, None, causal=True))
    assert fa.flash_forward.launches == launches


def _reference_einsum(q, k, v, causal=True):
    return np.asarray(jax_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))


def test_auto_attention_switches_at_min_seq():
    """make_auto_attention: at S >= min_seq the flash path (the plain version
    of the kernels here, against JAX's kernels), below it the einsum path."""
    attention = fa.make_auto_attention(min_seq=256)
    q, k, v, do = _case(n=2, kv=2, seed=2)
    _assert_close(_port(q, k, v, do, None, fn=attention), _jax(q, k, v, do, None))
    q2, k2, v2, _ = _case(b=1, s=128, n=2, kv=2, seed=3)
    short = attention(*(torch.tensor(x) for x in (q2, k2, v2)))
    np.testing.assert_allclose(short.numpy(), _reference_einsum(q2, k2, v2), rtol=1e-6, atol=1e-6)
    # the flash path's plain forward: fully masked rows give exactly 0,
    # where the einsum path gives a uniform row
    mask = torch.zeros((2, 256), dtype=torch.int32)
    out = attention(*(torch.tensor(x) for x in (q, k, v)), mask)
    assert torch.count_nonzero(out) == 0


def test_bias_and_ring_offsets_raise():
    """An additive bias runs, through ``flash_attention`` and the auto hook
    (which says so by ``supports_bias``), and equals the einsum path with
    the same bias; a bias whose batch dim is neither 1 nor B raises, and the
    ring inside a pipeline stage (item 17(c) brought it) raises without a
    sequence axis (the ring block entry with its global offsets runs since
    item 17(a))."""
    q, k, v, _ = _case(n=2, kv=2)
    t = [torch.tensor(x) for x in (q, k, v)]
    bias = torch.tensor(np.random.default_rng(1).normal(size=(1, 2, 256, 256)).astype(np.float32))
    want = dot_product_attention(*t, causal=True, bias=bias)
    np.testing.assert_allclose(fa.flash_attention(*t, bias=bias).numpy(), want.numpy(), rtol=FWD_TOL, atol=FWD_TOL)
    hook = fa.make_auto_attention(min_seq=1024)
    assert hook.supports_bias
    np.testing.assert_allclose(hook(*t, bias=bias).numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="bias batch dim must be 1 or 6, got 2"):
        fa.flash_attention(*(x.repeat(3, 1, 1, 1) for x in t), bias=bias.repeat(2, 1, 1, 1))
    from accelerate_tpu_torch.parallel.ring_attention import make_local_ring_attention

    with pytest.raises(ValueError, match="'sequence' axis above 1"):
        make_local_ring_attention()


def _bias_case(bias_batch, b=2, s=256, n=4, d=64, seed=0):
    return np.random.default_rng(seed + 100).normal(size=(bias_batch, n, s, s)).astype(np.float32)


def _jax_bias(q, k, v, do, mask, bias, **kwargs):
    """JAX forward and the vjp of q, k, v and the bias."""
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(
        lambda a, b, c, e: jax_flash_attention(a, b, c, jm, bias=e, **kwargs),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
    )
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_bias(q, k, v, do, mask, bias, **kwargs):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, bias)]
    out = fa.flash_attention(*leaves[:3], None if mask is None else torch.tensor(mask), bias=leaves[3], **kwargs)
    out.backward(torch.tensor(do))
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


BIAS_CASES = {
    # name: (bias batch, causal, masked, kv heads of 4, head dim, scale)
    "broadcast_bidirectional_masked": (1, False, True, 4, 64, 1.0),
    "batched_bidirectional_masked": (2, False, True, 4, 64, 1.0),
    "broadcast_causal_gqa4x2": (1, True, False, 2, 64, None),
    "batched_causal_masked_gqa4x2": (2, True, True, 2, 64, None),
    "broadcast_causal_masked_d32": (1, True, True, 4, 32, 1.0),
    "broadcast_bidirectional_gqa4x2_d32": (1, False, False, 2, 32, None),
}


@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_bias_forward_and_all_grads_match_jax(case):
    """The plain flash with an additive bias (what the kernels compute: the
    bias after the scale, before the causal limit and the mask penalty)
    against JAX's kernels in interpret mode: out, dq, dk, dv and dbias, the
    last summed over the batch for a [1, ...] bias and per row for a
    [B, ...] one; masked rows of batch row 0 from 200 (mid-tile), of row 1
    from 90."""
    bias_batch, causal, masked, kv, d, scale = BIAS_CASES[case]
    seed = list(BIAS_CASES).index(case)
    q, k, v, do = _case(kv=kv, d=d, seed=30 + seed)
    bias = _bias_case(bias_batch, d=d, seed=seed)
    mask = None
    if masked:
        mask = np.ones((2, 256), np.int32)
        mask[0, 200:] = 0
        mask[1, 90:] = 0
    kwargs = dict(causal=causal, scale=scale)
    port = _port_bias(q, k, v, do, mask, bias, **kwargs)
    want = _jax_bias(q, k, v, do, mask, bias, **kwargs)
    np.testing.assert_allclose(port[0], want[0], rtol=FWD_TOL, atol=FWD_TOL)
    for g, w, name in zip(port[1], want[1], ("q", "k", "v", "bias")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("bias_batch", [1, 2], ids=["broadcast", "batched"])
def test_plain_dbias_matches_autograd_through_the_plain_forward(bias_batch):
    """The plain dq version's dbias (what the dq kernel writes) against
    autograd through the plain forward with the bias, GQA, causal, a mask;
    and the dq wrapper on CPU tensors returns it beside dq and delta."""
    q, k, v, do = _case(kv=2, seed=40 + bias_batch)
    bias = torch.tensor(_bias_case(bias_batch, seed=bias_batch))
    mask, limit = fa._mask_limit(torch.tensor(np.r_[np.ones((1, 256)), [[1] * 100 + [0] * 156]]))
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv, bias)]
    out, lse = fa.flash_forward_reference(*leaves[:3], mask, True, 0.125, leaves[3])
    out.backward(tdo)
    out, lse = out.detach(), lse.detach()
    delta = fa.flash_delta_reference(tdo, out)
    args = (tq, tk, tv, mask, tdo, lse, delta, True, 0.125, bias)
    dq, dbias = fa.flash_backward_dq_reference(*args)
    dk, dv = fa.flash_backward_dkv_reference(*args)
    for got, leaf in zip((dq, dk, dv, dbias), leaves):
        assert got.shape == leaf.shape
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    got = fa.flash_backward_dq(tq, tk, tv, mask, limit, tdo, lse, out, True, 0.125, bias)
    assert len(got) == 3
    np.testing.assert_array_equal(got[0].numpy(), dq.numpy())
    np.testing.assert_array_equal(got[2].numpy(), dbias.numpy())


def test_dbias_chunks_cover_the_batch():
    """The broadcast bias's batch chunks (one dq block a chunk of rows and
    64 query rows and head): about four blocks an SM, every row in one
    chunk, never more chunks than rows."""
    for b, nh, s in ((32, 12, 512), (32, 12, 128), (2, 4, 256), (1, 12, 512), (7, 2, 64)):
        chunk = fa.dbias_chunk(b, nh, s, 132)
        chunks = -(-b // chunk)
        assert 1 <= chunk <= b and (chunks - 1) * chunk < b <= chunks * chunk
    assert fa.dbias_chunk(32, 12, 512, 132) == 6  # t5-base's encoder: 6 chunks of 96 blocks
    assert fa.dbias_chunk(32, 12, 128, 132) == 2  # its decoder: 16 chunks of 24


@pytest.mark.parametrize("entry,source", [("flash_forward", "flash_fwd"), ("flash_backward_dq", "flash_bwd"),
                                          ("flash_backward_dkv", "flash_bwd")])
def test_ctypes_signature_matches_the_c_entry_point(entry, source):
    """The argument types the wrappers declare for ``ctypes`` are those of
    the C entry point in ``csrc/<source>.cu``, one by one: a missing int
    would shift every later argument."""
    import ctypes
    import os
    import re

    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "accelerate_tpu_torch", "csrc", f"{source}.cu")
    params = re.search(rf"int {entry}\(([^)]*)\)", open(csrc).read()).group(1)
    kinds = {"void*": ctypes.c_void_p, "float": ctypes.c_float, "int": ctypes.c_int}
    declared = [kinds[re.sub(r"^const |\s+\w+$", "", p.strip()).replace(" ", "")] for p in params.split(",")]
    assert declared == fa.ARGTYPES[entry]


def test_plain_backward_matches_autograd_through_the_plain_forward():
    """The plain dq and dk/dv versions (what the CPU backward runs) against
    autograd through the plain forward, GQA and a mask: same function, so
    the two agree to fp32 rounding."""
    q, k, v, do = _case(kv=2, seed=12)
    mask, limit = fa._mask_limit(torch.tensor(np.r_[np.ones((1, 256)), [[1] * 100 + [0] * 156]]))
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out, lse = fa.flash_forward_reference(*leaves, mask, True, 0.125)
    out.backward(tdo)
    out, lse = out.detach(), lse.detach()
    delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    args = (tq, tk, tv, mask, tdo, lse, delta, True, 0.125)
    dq = fa.flash_backward_dq_reference(*args)
    dk, dv = fa.flash_backward_dkv_reference(*args)
    for got, leaf in zip((dq, dk, dv), leaves):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    assert int(limit[1]) == 99 and int(limit[0]) == 255


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_backward_entry_matches_jax_grads(causal, masked):
    """The backward entry the autograd function runs, on CPU tensors: the
    dq wrapper returns dq with ``delta = rowsum(dO·O)`` by the plain
    formula, and ``flash_backward`` (dq, then dk/dv fed that delta) fed the
    plain forward's out and lse gives the JAX package's flash vjp, GQA, in
    fp32 within GRAD_TOL (the two sides sum in other orders)."""
    q, k, v, do = _case(kv=2, seed=20 + 2 * causal + masked)
    mask = None
    if masked:
        mask = np.ones((2, 256), np.int32)
        mask[0, 200:] = 0
        mask[1, 100:] = 0
    _, want = _jax(q, k, v, do, mask, causal=causal)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    m = limit = None
    if masked:
        m, limit = fa._mask_limit(torch.tensor(mask))
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = fa.flash_forward(tq, tk, tv, m, limit, causal, scale)
    dq, delta = fa.flash_backward_dq(tq, tk, tv, m, limit, tdo, lse, out, causal, scale)
    np.testing.assert_array_equal(delta.numpy(), (tdo * out).sum(-1).transpose(1, 2).numpy())
    grads = fa.flash_backward(tq, tk, tv, m, limit, tdo, lse, out, causal, scale)
    np.testing.assert_array_equal(grads[0].numpy(), dq.numpy())
    for g, w, name in zip(grads, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"d{name}")
