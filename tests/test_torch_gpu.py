"""Tests that launch the port's CUDA kernel: marked ``gpu``, they skip on a
machine without a CUDA card. This file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Whether a card exists is decided inside the ``cuda`` fixture, never while
the module is imported, so every worker collects the same tests."""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import Llama, ServingEngine, generate, get_config
from accelerate_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
)

pytestmark = pytest.mark.gpu

# max abs error of the kernel against its plain version: fp32 sums in
# another order; bf16 outputs may differ by one unit in the last place
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


def _case(device, dtype, nh, kv, d, ps, pps, lengths, seed=0):
    rng = np.random.default_rng(seed)
    slots = len(lengths)
    num_pages = slots * pps + 1
    pool_k = rng.standard_normal((num_pages, ps, kv, d), dtype=np.float32)
    pool_v = rng.standard_normal((num_pages, ps, kv, d), dtype=np.float32)
    tables = (1 + rng.permutation(num_pages - 1)).reshape(slots, pps).astype(np.int32)
    for s, length in enumerate(lengths):
        for j in range(pps):
            lo = max(length - j * ps, 0)
            if lo < ps:  # the partial tail and every unwalked page hold NaN
                pool_k[tables[s, j], lo:] = np.nan
                pool_v[tables[s, j], lo:] = np.nan
    f = lambda a: torch.tensor(a, device=device).to(dtype)  # noqa: E731
    return dict(
        q=f(rng.standard_normal((slots, nh, d), dtype=np.float32)),
        k_new=f(rng.standard_normal((slots, kv, d), dtype=np.float32)),
        v_new=f(rng.standard_normal((slots, kv, d), dtype=np.float32)),
        pool_k=f(pool_k),
        pool_v=f(pool_v),
        tables=torch.tensor(tables, device=device),
        lengths=torch.tensor(np.asarray(lengths, np.int32), device=device),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "geometry",
    [(16, 16, 128, 16, 8, [128, 77, 0, 1]), (64, 8, 128, 16, 8, [0, 100, 33, 128]),
     (4, 2, 64, 8, 4, [5, 32, 0])],
    ids=["llama1b", "gqa64x8", "d64_gqa4x2"],
)
def test_kernel_matches_plain_version(cuda, dtype, geometry):
    nh, kv, d, ps, pps, lengths = geometry
    case = _case(cuda, dtype, nh, kv, d, ps, pps, lengths)
    before = paged_decode_attention.launches
    got = paged_decode_attention(**case)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_attention_reference(**case)
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= TOLERANCE[dtype]
    zero = lengths.index(0) if 0 in lengths else None
    if zero is not None:
        assert torch.equal(got[zero], case["v_new"][zero].repeat_interleave(nh // kv, dim=0))


def test_engine_on_the_card_matches_generate(cuda):
    """fp32, llama-tiny widened to head dim 64 (the kernel takes 64 and 128):
    the engine's kernel decode gives generate()'s tokens, and the kernel ran
    once per layer per decode step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config("llama-tiny").replace(hidden_size=256)
    model = Llama(config, device=cuda, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 1024, (n,)).astype(np.int32) for n in (3, 17, 33, 1)]
    engine = ServingEngine(model, num_slots=4, max_len=96, page_size=16, prefill_chunk=16)
    paged_decode_attention.launches = 0
    rows = engine.generate_many(prompts, max_new_tokens=6)
    assert paged_decode_attention.launches == model.config.num_layers * engine.stats.steps
    for row, p in zip(rows, prompts):
        np.testing.assert_array_equal(row, generate(model, p[None], max_new_tokens=6)[0])
