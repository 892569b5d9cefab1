"""The ring-block entry of the port's flash attention against the JAX
package's on the CPU: ``flash_attention_block`` (global offsets, ``(out,
lse)`` both differentiable) against JAX's block in interpret mode, its exact
einsum fallback, the two-block merge, and the ring module's pieces that need
no process group. The ring itself, across 2 and 4 gloo processes, is in
``tests/test_torch_parallel.py``.

The same seeded numpy inputs go through both packages. Tolerances, as the
JAX package's flash tests use them in fp32: forward (out and lse) 2e-5, the
q, k and v gradients 5e-4 (the two sides sum in other orders).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu_torch.models.attention import dot_product_attention, sequence_chunk
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.parallel import ring_attention as ra

FWD_TOL, GRAD_TOL = 2e-5, 5e-4
BLOCKS = dict(block_q=128, block_k=128)

# name: (JAX block options, key length, kv heads, masked)
CASES = {
    "past": (dict(causal=True, q_offset=256, kv_offset=0), 256, 4, False),
    "past_masked_gqa": (dict(causal=True, q_offset=256, kv_offset=0), 256, 2, True),
    "diagonal_masked": (dict(causal=True, q_offset=256, kv_offset=256), 256, 4, True),
    "diagonal_gqa": (dict(causal=True, q_offset=256, kv_offset=256), 256, 2, False),
    "future_masked": (dict(causal=True, q_offset=0, kv_offset=256), 256, 4, True),
    "noncausal_masked_gqa": (dict(causal=False), 256, 2, True),
    # causal S != T without offsets compares local positions (top-left), unlike flash_attention
    "causal_s_ne_t": (dict(causal=True), 384, 4, False),
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _inputs(s=256, t=256, n=4, kv=4, d=64, masked=False, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    q, k, v = f(2, s, n, d), f(2, t, kv, d), f(2, t, kv, d)
    d_out, d_lse = f(2, s, n, d), f(2, s, n)
    mask = None
    if masked:
        mask = np.ones((2, t), np.int32)
        mask[1, 170:] = 0  # row 1's keys end mid-tile
    return q, k, v, d_out, d_lse, mask


def _jax_block(q, k, v, d_out, d_lse, mask, options):
    """JAX's block (interpret mode on the CPU) and its vjp under both
    cotangents."""
    jmask = None if mask is None else jnp.asarray(mask)

    def block(q, k, v):
        return jfa.flash_attention_block(q, k, v, jmask, **options, **BLOCKS)

    (out, lse), vjp = jax.vjp(block, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(d_out), jnp.asarray(d_lse)))
    return [np.asarray(x) for x in (out, lse, *grads)]


def _port_block(q, k, v, d_out, d_lse, mask, options):
    leaves = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    tmask = None if mask is None else torch.tensor(mask)
    out, lse = fa.flash_attention_block(*leaves, tmask, **options, **BLOCKS)
    torch.autograd.backward((out, lse), (torch.tensor(d_out), torch.tensor(d_lse)))
    return [x.detach().numpy() for x in (out, lse, *(leaf.grad for leaf in leaves))]


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_jax_block_and_its_vjp(name):
    """``(out, lse)`` and the q, k, v gradients under random cotangents on
    both outputs (the lse cotangent folded into delta) against JAX's
    ``flash_attention_block``: past, diagonal and future blocks, masked and
    not, GQA, non-causal, and causal S != T without offsets."""
    options, t, kv, masked = CASES[name]
    args = _inputs(t=t, kv=kv, masked=masked, seed=len(name))
    want = _jax_block(*args, options)
    got = _port_block(*args, options)
    for label, g, w in zip(("out", "lse"), got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=FWD_TOL, atol=FWD_TOL, err_msg=label)
    for label, g, w in zip("qkv", got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"d{label}")
    if name.startswith("future"):  # a zero-trip block: exactly 0, a merge weight of exp(lse) = 0
        assert not got[0].any() and (got[1] < -1e28).all()
        assert not any(g.any() for g in got[2:])


def test_untileable_block_takes_the_exact_einsum_fallback():
    """At a length no 128-tile divides, the block entry is the einsum path
    with the block's contract, against JAX's ``_einsum_attention_lse``:
    forward and the vjp through both outputs; a row that sees no key gives
    0 and a very negative lse."""
    q, k, v, d_out, d_lse, _ = _inputs(s=200, t=200, n=4, kv=2, d=32, seed=3)
    mask = np.ones((2, 200), np.int32)
    mask[0, :120] = 0  # with the offsets below, row 0's first queries see no valid key
    options = dict(causal=True, q_offset=50, kv_offset=70)

    def jax_fn(q, k, v):
        return jfa._einsum_attention_lse(q, k, v, jnp.asarray(mask), True, 50, 70, None)

    (out, lse), vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in (out, lse, *vjp((jnp.asarray(d_out), jnp.asarray(d_lse))))]
    got = _port_block(q, k, v, d_out, d_lse, mask, options)
    for label, g, w in zip(("out", "lse"), got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=FWD_TOL, atol=FWD_TOL, err_msg=label)
    for label, g, w in zip("qkv", got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"d{label}")
    assert not got[0][0, :10].any() and (got[1][0, :10] < -1e28).all()


@pytest.mark.parametrize("masked", [False, True])
def test_two_blocks_merged_reconstruct_causal_attention(masked):
    """The ring on one process: the second half's queries attend the first
    half (past) and their own (diagonal) as two blocks at their global
    offsets, merged by ``ring_attention.merge_block``, against causal
    attention over the whole sequence; the first half against the second
    (future) is exactly 0. JAX's ``test_block_merge_reconstructs_causal_attention``."""
    s, half = 256, 128
    q, k, v, _, _, _ = _inputs(s=s, t=s, n=2, kv=2, seed=12)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    mask = torch.tensor([[1] * s, [1] * 170 + [0] * (s - 170)], dtype=torch.int32) if masked else None
    o, m, l = ra.merge_start(tq[:, half:])
    for kv0 in (0, half):
        piece = fa.flash_attention_block(tq[:, half:], tk[:, kv0:kv0 + half], tv[:, kv0:kv0 + half],
                                         None if mask is None else mask[:, kv0:kv0 + half], causal=True,
                                         q_offset=half, kv_offset=kv0, **BLOCKS)
        o, m, l = ra.merge_block(o, m, l, *piece)
    got = ra.merge_end(o, l, tq.dtype)
    want = dot_product_attention(tq, tk, tv, mask=None if mask is None else mask[:, None, None, :].bool(),
                                 causal=True)[:, half:]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_TOL, atol=FWD_TOL)
    out, lse = fa.flash_attention_block(tq[:, :half], tk[:, half:], tv[:, half:],
                                        None if mask is None else mask[:, half:], causal=True, q_offset=0,
                                        kv_offset=half, **BLOCKS)
    assert torch.count_nonzero(out) == 0 and bool((lse < -1e28).all())


def test_flash_attention_without_offsets_is_unchanged():
    """The no-offset path: ``flash_attention`` still equals the JAX
    package's kernel (interpret mode) forward, and causal S != T still
    takes the einsum path there."""
    q, k, v, _, _, _ = _inputs(seed=21)
    want = np.asarray(jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), **BLOCKS))
    got = fa.flash_attention(*(torch.tensor(x) for x in (q, k, v)), **BLOCKS)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    before = fa.flash_forward.launches
    fa.flash_attention(torch.tensor(q), torch.tensor(q[:, :128, :, :]), torch.tensor(q[:, :128]), causal=True)
    assert fa.flash_forward.launches == before  # causal S != T: the einsum path, no kernel call


@pytest.mark.parametrize("entry,source", [("flash_forward_ring", "flash_fwd"),
                                          ("flash_backward_dq_ring", "flash_bwd"),
                                          ("flash_backward_dkv_ring", "flash_bwd")])
def test_ring_ctypes_signature_matches_the_c_entry_point(entry, source):
    """The ring entry points' ``ctypes`` argument types are those of the C
    functions in ``csrc/<source>.cu``, one by one."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "accelerate_tpu_torch", "csrc", f"{source}.cu")
    with open(csrc) as f:
        params = re.search(rf"int {entry}\(([^)]*)\)", f.read()).group(1)
    kinds = {"void*": ctypes.c_void_p, "float": ctypes.c_float, "int": ctypes.c_int}
    declared = [kinds[re.sub(r"^const |\s+\w+$", "", p.strip()).replace(" ", "")] for p in params.split(",")]
    assert declared == fa.ARGTYPES[entry]


def test_sequence_spans_and_the_fallback():
    """A ring index's chunk of a sequence; None where the ring size does
    not divide the length, and the models then run the whole sequence by
    einsum, counting its terms on index 0 only."""
    assert ra.sequence_span(64, 1, 4) == (16, 32)
    assert ra.sequence_span(30, 0, 4) is None and ra.sequence_span(2, 0, 4) is None

    def hook(q, k, v, kv_mask=None):
        raise AssertionError("the fallback must not call the ring")

    hook.span, hook.index = (lambda n: ra.sequence_span(n, 1, 2)), 1
    assert sequence_chunk(hook, 64) == (32, 64, hook, True)
    assert sequence_chunk(hook, 63) == (0, 63, None, False)
    assert sequence_chunk(None, 63) == (0, 63, None, True)


def test_local_ring_attention_names_its_item():
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 17\(c\)"):
        ra.make_local_ring_attention()


def test_save_flash_stash_replays_each_block():
    """Under ``remat_policy="save_flash"`` a ring layer's blocks are kept
    and replayed one entry a block: the recompute launches no forward and
    the gradients equal a run without the stash bit for bit."""
    q, k, v, d_out, d_lse, _ = _inputs(s=256, t=256, seed=5)
    options = dict(causal=True, q_offset=256, kv_offset=0, **BLOCKS)

    def run(stash):
        leaves = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
        if stash:
            record, replay = fa.flash_stash_contexts()
            with record:
                fa.flash_attention_block(*leaves, **options)
            with replay:
                out, lse = fa.flash_attention_block(*leaves, **options)
        else:
            out, lse = fa.flash_attention_block(*leaves, **options)
        torch.autograd.backward((out, lse), (torch.tensor(d_out), torch.tensor(d_lse)))
        return [leaf.grad for leaf in leaves]

    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)
