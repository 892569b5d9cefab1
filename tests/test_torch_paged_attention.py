"""The port's paged decode attention (accelerate_tpu_torch/ops/paged_attention.py)
against the JAX package's: the Pallas kernel run in interpret mode and its
gather reference ``_reference``, on the same numpy inputs.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

The kernels' split walk (chunks of positions, fp32 partials, an ordered
combine) is held here through ``paged_split_reference``, its plain PyTorch
form, and the host-side split plan through ``paged_plan``.

Tolerance: rtol 2e-5, atol 2e-6 in fp32. Both sides accumulate in fp32 but
sum in different orders (online softmax over pages vs one softmax)."""

import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accelerate_tpu.ops.paged_attention import _reference
from accelerate_tpu.ops.paged_attention import paged_decode_attention as jax_paged_decode
from accelerate_tpu.ops.paged_attention import paged_verify_attention as jax_paged_verify
from accelerate_tpu_torch.ops.paged_attention import (
    CHUNK_QUANTUM,
    MAX_CHUNK,
    ROW_TILE,
    WAVE_BLOCKS,
    WIDE_CHUNK,
    _check,
    argtypes,
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_plan,
    paged_split_reference,
)

RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


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
        (lambda a: _valid_args(d=48), ValueError),
        (lambda a: {**a, "pool_k": a["pool_k"].transpose(0, 1).contiguous().transpose(0, 1)}, ValueError),
        (lambda a: {**a, "tables": a["tables"].long()}, TypeError),
        (lambda a: {**a, "k_new": a["k_new"][:1]}, ValueError),
    ],
    ids=["fp16", "head_dim_48", "non_contiguous", "int64_tables", "short_k_new"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(mutate, error):
    """The checks the wrapper runs before a CUDA launch."""
    assert _check(**_valid_args()) is None
    with pytest.raises(error):
        _check(**mutate(_valid_args()))


@pytest.mark.parametrize("d", [32, 64, 128])
def test_kernel_wrapper_takes_every_instantiated_head_dim(d):
    """The kernels are built for head dims 32, 64 and 128, so the checks
    pass each in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        assert _check(**_valid_args(dtype, d=d)) is None


# -- the split walk: its plan and its algorithm -------------------------------------


def _smoke():
    """``chip_smoke.py`` at the repository root, imported by path."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _plan_cases():
    """(slots, kv heads, rows, capacity) of every paged launch ``chip_smoke.py``
    makes: phase 2's and 5's geometries at each window, and the engines of
    phases 3-9 and 4b (llama-1b 16/16 heads over 64 pages of 16, its k=4
    verify, llama-125m drafting, llama-tiny 4/2 over 32 pages of 8)."""
    smoke = _smoke()
    cases = {}
    for name, (slots, nh, kv, d, ps, pps, lengths) in smoke.GEOMETRIES.items():
        for window in smoke.WINDOWS.get(name, (smoke.SPEC_K + 1, 1)):
            cases[f"{name}_w{window}"] = (slots, kv, window * nh // kv, ps * pps)
    cases.update(serve_llama1b=(8, 16, 1, 1024), serve_verify_k4=(8, 16, smoke.SPEC_K + 1, 1024),
                 serve_draft_125m=(8, 12, 1, 1024), serve_tiny=(4, 2, 2, 256))
    return cases


PLAN_CASES = _plan_cases()


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_stays_within_its_bounds(name):
    """The split plan at every geometry the smoke run launches: whole
    64-position units up to MAX_CHUNK, chunks that cover the capacity with
    no chunk wholly past it, 16-row tiles that cover the rows, and at most
    two waves of walk blocks (more only where the chunk is capped: at
    WIDE_CHUNK for a grid already a wave wide, or at MAX_CHUNK)."""
    slots, kv, rows, capacity = PLAN_CASES[name]
    plan = paged_plan(slots, kv, rows, capacity)
    assert plan.chunk % CHUNK_QUANTUM == 0 and CHUNK_QUANTUM <= plan.chunk <= MAX_CHUNK
    assert plan.chunks >= 1 and (plan.chunks - 1) * plan.chunk < capacity <= plan.chunks * plan.chunk
    assert (plan.row_tiles - 1) * ROW_TILE < rows <= plan.row_tiles * ROW_TILE
    base = slots * kv * plan.row_tiles
    assert base * plan.chunks <= max(base, 2 * WAVE_BLOCKS) or plan.chunk in (WIDE_CHUNK, MAX_CHUNK)
    if base < WAVE_BLOCKS and capacity > CHUNK_QUANTUM:
        assert plan.chunks > 1  # a short grid is split


def test_plan_caps_the_chunk():
    """A short grid's chunks stop at MAX_CHUNK; a grid a wave wide takes
    chunks of WIDE_CHUNK, or the whole capacity below that; an empty pool
    still has a chunk."""
    assert paged_plan(2, 8, 8, 65536) == (1, MAX_CHUNK, 32)
    assert paged_plan(64, 8, 8, 32768) == (1, WIDE_CHUNK, 64)
    assert paged_plan(64, 8, 8, 256) == (1, 256, 1)
    assert paged_plan(8, 16, 33, 1024) == (3, WIDE_CHUNK, 2)
    assert paged_plan(1, 1, 1, 0) == (1, CHUNK_QUANTUM, 1)


def _windowed(case):
    """The decode case with a window axis of 1 (the verify layout)."""
    return {**case, **{k: case[k][:, None] for k in ("q", "k_new", "v_new")}}


@pytest.mark.parametrize("chunk", [64, 128, 1024], ids=["many_chunks", "two_chunks", "one_chunk"])
def test_split_reference_matches_jax_decode(chunk):
    """The kernels' algorithm at 3, 2 and 1 chunks of a 192-position pool:
    slots of length 0 (every chunk empty), 9 (later chunks empty), 64 (a
    chunk boundary) and 150, NaN past every walk; against the Pallas decode
    kernel (interpret mode)."""
    case = _case(5, 4, 2, 32, 8, 24, [0, 9, 64, 150], nan_unwalked=True)
    args = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _windowed(case).items()}
    got = paged_split_reference(**args, chunk=chunk)[:, 0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_per_slot(jax_paged_decode, case), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[0], np.repeat(case["v_new"][0], 2, axis=0))


@pytest.mark.parametrize("chunk", [64, 128, 1024], ids=["many_chunks", "two_chunks", "one_chunk"])
def test_split_reference_matches_jax_verify(chunk):
    """The same at window 3 against the Pallas verify kernel; the length-0
    lane's first window row returns its own key's value."""
    rng = np.random.default_rng(6)
    case = _case(6, 4, 2, 32, 8, 24, [150, 0, 9, 64], nan_unwalked=True)
    w = 3
    case.update(q=rng.normal(size=(4, w, 4, 32)).astype(np.float32),
                k_new=rng.normal(size=(4, w, 2, 32)).astype(np.float32),
                v_new=rng.normal(size=(4, w, 2, 32)).astype(np.float32))
    args = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()}
    got = paged_split_reference(**args, chunk=chunk).numpy()
    want = np.stack([
        np.asarray(jax_paged_verify(
            jnp.asarray(case["q"][s][None]), jnp.asarray(case["k_new"][s][None]),
            jnp.asarray(case["v_new"][s][None]), jnp.asarray(case["pool_k"]),
            jnp.asarray(case["pool_v"]), jnp.asarray(case["tables"][s]), jnp.int32(case["lengths"][s]),
        ))[0] for s in range(4)
    ])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1, 0], np.repeat(case["v_new"][1, 0], 2, axis=0))


def test_split_reference_equals_the_plain_versions():
    """Chunking only reorders fp32 sums: at 1, 2 and many chunks the split
    form equals the plain decode version within fp32 roundoff."""
    case = _case(7, 8, 2, 64, 16, 8, [128, 0, 77, 5], nan_unwalked=True)
    args = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()}
    want = paged_decode_attention_reference(**args)
    for chunk in (64, 128, 2048):
        got = paged_split_reference(**_windowed(args), chunk=chunk)[:, 0]
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("source", ["paged_decode", "paged_verify"])
def test_ctypes_signature_matches_the_c_entry_point(source):
    """The argument types the wrapper declares for ``ctypes`` are those of
    the C entry point in ``csrc/<source>.cu``, one by one: a missing int
    would shift every later argument."""
    import ctypes
    import re

    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "accelerate_tpu_torch", "csrc", f"{source}.cu")
    text = open(csrc).read()
    params = re.search(rf"int {source}_attention\(([^)]*)\)", text).group(1)
    kinds = {"void*": ctypes.c_void_p, "float": ctypes.c_float, "int": ctypes.c_int}
    declared = [kinds[re.sub(r"^const |\s+\w+$", "", p.strip()).replace(" ", "")] for p in params.split(",")]
    assert declared == argtypes(source)
