"""The port's paged decode attention (accelerate_tpu_torch/ops/paged_attention.py)
against the JAX package's: the Pallas kernel run in interpret mode and its
gather reference ``_reference``, on the same numpy inputs.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerance: rtol 2e-5, atol 2e-6 in fp32. Both sides accumulate in fp32 but
sum in different orders (online softmax over pages vs one softmax)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accelerate_tpu.ops.paged_attention import _reference
from accelerate_tpu.ops.paged_attention import paged_decode_attention as jax_paged_decode
from accelerate_tpu_torch.ops.paged_attention import (
    _check,
    paged_decode_attention,
    paged_decode_attention_reference,
)

RTOL, ATOL = 2e-5, 2e-6


def _case(seed, nh, kv, d, ps, pps, lengths, nan_unwalked=False):
    """Numpy inputs for len(lengths) slots, each slot on its own pages. The
    tail of each partial last page holds stale finite values (1e6), as the
    JAX package's own test has it; ``nan_unwalked`` fills every page past a
    slot's length with NaN."""
    rng = np.random.default_rng(seed)
    slots = len(lengths)
    num_pages = slots * pps + 1
    pool_k = rng.normal(size=(num_pages, ps, kv, d)).astype(np.float32)
    pool_v = rng.normal(size=(num_pages, ps, kv, d)).astype(np.float32)
    tables = (1 + rng.permutation(num_pages - 1)).reshape(slots, pps).astype(np.int32)
    for s, length in enumerate(lengths):
        walked = -(-length // ps)
        if length % ps:
            pool_k[tables[s, walked - 1], length % ps :] = 1e6
            pool_v[tables[s, walked - 1], length % ps :] = -1e6
        if nan_unwalked:
            pool_k[tables[s, walked:]] = np.nan
            pool_v[tables[s, walked:]] = np.nan
    return {
        "q": rng.normal(size=(slots, nh, d)).astype(np.float32),
        "k_new": rng.normal(size=(slots, kv, d)).astype(np.float32),
        "v_new": rng.normal(size=(slots, kv, d)).astype(np.float32),
        "pool_k": pool_k,
        "pool_v": pool_v,
        "tables": tables,
        "lengths": np.asarray(lengths, np.int32),
    }


def _port(case):
    args = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()}
    return paged_decode_attention(**args).numpy()


def _jax_per_slot(fn, case, **kwargs):
    """The JAX functions take one slot (the engine vmaps them): call per slot."""
    outs = []
    for s in range(case["q"].shape[0]):
        out = fn(
            jnp.asarray(case["q"][s][None, None]),
            jnp.asarray(case["k_new"][s][None, None]),
            jnp.asarray(case["v_new"][s][None, None]),
            jnp.asarray(case["pool_k"]),
            jnp.asarray(case["pool_v"]),
            jnp.asarray(case["tables"][s]),
            jnp.int32(case["lengths"][s]),
            **kwargs,
        )
        outs.append(np.asarray(out)[0, 0])
    return np.stack(outs)


GEOMETRIES = {
    # nh, kv, d, ps, pps, lengths
    "gqa4x2_partial_pages": (4, 2, 32, 8, 4, [19, 11, 3]),
    "mha_mixed_lengths": (2, 2, 32, 8, 3, [24, 1, 9, 16]),
    "gqa4x2_zero_and_full": (4, 2, 16, 4, 4, [0, 16, 7]),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_matches_jax_kernel_and_reference(name):
    """Several slots of different lengths in one call, partial last pages
    with stale tails, GQA (q head h reads kv head h // group): the port
    matches the Pallas kernel (interpret mode) and the gather reference."""
    nh, kv, d, ps, pps, lengths = GEOMETRIES[name]
    case = _case(0, nh, kv, d, ps, pps, lengths)
    got = _port(case)
    kernel = _jax_per_slot(jax_paged_decode, case)
    np.testing.assert_allclose(got, kernel, rtol=RTOL, atol=ATOL)
    reference = _jax_per_slot(_reference, case, scale=1.0 / d**0.5)
    np.testing.assert_allclose(got, reference, rtol=RTOL, atol=ATOL)


def test_nan_in_unwalked_pages_never_reaches_output():
    """Pages past a slot's length may hold anything, NaN included: the
    output equals the clean run's and the JAX kernel's on the same pool."""
    nh, kv, d, ps, pps, lengths = GEOMETRIES["gqa4x2_partial_pages"]
    clean = _port(_case(1, nh, kv, d, ps, pps, lengths))
    poisoned_case = _case(1, nh, kv, d, ps, pps, lengths, nan_unwalked=True)
    poisoned = _port(poisoned_case)
    assert np.isfinite(poisoned).all()
    np.testing.assert_array_equal(clean, poisoned)
    np.testing.assert_allclose(
        poisoned, _jax_per_slot(jax_paged_decode, poisoned_case), rtol=RTOL, atol=ATOL
    )


def test_zero_length_attends_only_the_new_token():
    """A lane of length 0 reads no page and returns v_new (per query head)."""
    case = _case(2, 4, 2, 32, 8, 2, [0, 0], nan_unwalked=True)
    got = _port(case)
    want = np.repeat(case["v_new"], 2, axis=1)  # heads 2g, 2g+1 read kv head g
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        got, _jax_per_slot(jax_paged_decode, case), rtol=RTOL, atol=ATOL
    )


def test_reference_is_the_cpu_path():
    """On CPU tensors the wrapper is exactly the plain version and launches
    nothing."""
    case = _case(3, 4, 2, 64, 8, 2, [5, 12])
    args = {k: torch.from_numpy(v) for k, v in case.items()}
    before = paged_decode_attention.launches
    got = paged_decode_attention(**args)
    assert paged_decode_attention.launches == before
    torch.testing.assert_close(got, paged_decode_attention_reference(**args), rtol=0, atol=0)


def _valid_args(dtype=torch.float32, d=128):
    case = _case(4, 4, 2, d, 16, 2, [3, 20])
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v)
            for k, v in case.items()}


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda a: {**a, **{k: v.half() for k, v in a.items() if v.is_floating_point()}}, TypeError),
        (lambda a: _valid_args(d=32), ValueError),
        (lambda a: {**a, "pool_k": a["pool_k"].transpose(0, 1).contiguous().transpose(0, 1)}, ValueError),
        (lambda a: {**a, "tables": a["tables"].long()}, TypeError),
        (lambda a: {**a, "k_new": a["k_new"][:1]}, ValueError),
    ],
    ids=["fp16", "head_dim_32", "non_contiguous", "int64_tables", "short_k_new"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(mutate, error):
    """The checks the wrapper runs before a CUDA launch."""
    assert _check(**_valid_args()) is None
    with pytest.raises(error):
        _check(**mutate(_valid_args()))
