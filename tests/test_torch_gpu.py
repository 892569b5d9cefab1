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
    paged_verify_attention,
    paged_verify_attention_reference,
)
from accelerate_tpu_torch.big_modeling import dispatch_model, make_layered_device_map
from accelerate_tpu_torch.ops.quant_matmul import quant_dot, quant_matmul, quant_matmul_reference
from accelerate_tpu_torch.serving import SpeculativeConfig
from accelerate_tpu_torch.serving.engine import params_from_streamed
from accelerate_tpu_torch.utils.quantization import (
    QuantizationConfig,
    QuantizedWeight,
    quantize_weight,
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


def _case(device, dtype, nh, kv, d, ps, pps, lengths, seed=0, window=None):
    """Decode inputs (``window=None``) or verify inputs with a window axis."""
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
    lead = (slots,) if window is None else (slots, window)
    return dict(
        q=f(rng.standard_normal(lead + (nh, d), dtype=np.float32)),
        k_new=f(rng.standard_normal(lead + (kv, d), dtype=np.float32)),
        v_new=f(rng.standard_normal(lead + (kv, d), dtype=np.float32)),
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


@pytest.mark.parametrize("window", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "geometry",
    [(16, 16, 128, 16, 8, [128, 77, 0, 1]), (64, 8, 128, 16, 8, [0, 100, 33, 128]),
     (4, 2, 64, 8, 4, [5, 32, 0])],
    ids=["llama1b", "gqa64x8", "d64_gqa4x2"],
)
def test_verify_kernel_matches_plain_version(cuda, dtype, geometry, window):
    """The verify kernel against its plain version; at W=1 against the
    decode kernel too. A length-0 lane's first window row reads only its
    own key, so it returns that key's value."""
    nh, kv, d, ps, pps, lengths = geometry
    case = _case(cuda, dtype, nh, kv, d, ps, pps, lengths, window=window)
    before = paged_verify_attention.launches
    got = paged_verify_attention(**case)
    torch.cuda.synchronize()
    assert paged_verify_attention.launches == before + 1
    want = paged_verify_attention_reference(**case)
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= TOLERANCE[dtype]
    zero = lengths.index(0)
    assert torch.equal(got[zero, 0], case["v_new"][zero, 0].repeat_interleave(nh // kv, dim=0))
    if window == 1:
        decode = {**case, **{k: case[k][:, 0] for k in ("q", "k_new", "v_new")}}
        err = (got[:, 0].float() - paged_decode_attention(**decode).float()).abs().max()
        assert float(err) <= TOLERANCE[dtype]


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


@pytest.mark.parametrize("mode", ["linear", "tree"])
def test_speculative_engine_on_the_card_matches_plain(cuda, mode):
    """fp32, llama-tiny widened to head dim 64, self draft, k=3: the
    speculative engine gives the plain engine's tokens, and the verify
    kernel ran once per layer per verify forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config("llama-tiny").replace(hidden_size=256)
    model = Llama(config, device=cuda, seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 1024, (n,)).astype(np.int32) for n in (3, 17, 33, 1)]
    kwargs = dict(num_slots=4, max_len=96, page_size=16, prefill_chunk=16, prefix_sharing=False)
    want = ServingEngine(model, **kwargs).generate_many(prompts, max_new_tokens=8)
    engine = ServingEngine(
        model, speculative=SpeculativeConfig(draft_model=model, k=3, mode=mode), **kwargs
    )
    paged_verify_attention.launches = 0
    rows = engine.generate_many(prompts, max_new_tokens=8)
    assert paged_verify_attention.launches == config.num_layers * engine.forward_counts["verify"]
    assert engine.stats.spec_accepted_tokens > 0 and engine.cache.pages.used_count == 0
    for row, w in zip(rows, want):
        np.testing.assert_array_equal(row, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize(
    "mkn",
    [(3, 100, 72), (5, 98, 61), (65, 98, 61), (8, 2048, 2048), (40, 2048, 2048),
     (64, 2048, 5504), (512, 5504, 2048)],
    ids=["tails", "odd_n", "odd_n_tiled", "decode", "verify", "chunk", "prefill"],
)
def test_quant_kernel_matches_plain_version(cuda, dtype, bits, mkn):
    """The dequant-matmul kernel against its plain version (dequantize,
    then a full-precision cuBLAS product), at tail shapes (an odd N takes
    byte-wide weight loads) and at llama-1b's projection shapes for both
    tilings (M <= 64 and above)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n + bits)
    q, scale = quantize_weight(rng.standard_normal((k, n), dtype=np.float32), bits=bits)
    w = QuantizedWeight(torch.tensor(q, device=cuda), torch.tensor(scale, device=cuda), bits, dtype)
    x = torch.tensor(rng.standard_normal((m, k), dtype=np.float32) / (4 * np.sqrt(k)), device=cuda).to(dtype)
    before = quant_matmul.launches
    got = quant_matmul(x, w)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1 and got.dtype == dtype
    want = quant_matmul_reference(x, w)
    assert float((got.float() - want.float()).abs().max()) <= TOLERANCE[dtype]


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_kernel_takes_an_unaligned_weight_view(cuda, bits):
    """A packed weight that starts 3 bytes into its buffer (a view into a
    packed layer can): the kernel reads it byte by byte, same result."""
    k, n = 64, 64
    rng = np.random.default_rng(bits)
    q, scale = quantize_weight(rng.standard_normal((k, n), dtype=np.float32), bits=bits)
    buf = torch.zeros(q.size + 3, dtype=torch.int8, device=cuda)
    buf[3:] = torch.tensor(q.ravel(), device=cuda)
    w = QuantizedWeight(buf[3:].view(q.shape), torch.tensor(scale, device=cuda), bits, torch.float32)
    x = torch.tensor(rng.standard_normal((8, k)) / (4 * np.sqrt(k)), dtype=torch.float32, device=cuda)
    got = quant_matmul(x, w)
    torch.cuda.synchronize()
    want = quant_matmul_reference(x, w)
    assert float((got - want).abs().max()) <= TOLERANCE[torch.float32]


def test_quantized_resident_engine_on_the_card(cuda):
    """fp32 int8, llama-tiny widened to head dim 64: from_streamed serves
    generate()'s tokens over the dequantized weights, through the kernel
    once per projection per forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config("llama-tiny").replace(hidden_size=256)
    model = Llama(config, device=cuda, seed=0)
    streamed = dispatch_model(model, None, make_layered_device_map(model, "cpu"),
                              dtype=torch.float32, quantization=QuantizationConfig(load_in_8bit=True))
    reference = Llama(config, device=cuda, seed=1).install(params_from_streamed(streamed))
    engine = ServingEngine.from_streamed(streamed, num_slots=4, max_len=96, page_size=16, prefill_chunk=16)
    assert model.dot_fn is quant_dot
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 1024, (n,)).astype(np.int32) for n in (3, 17, 33, 1)]
    quant_matmul.launches = 0
    rows = engine.generate_many(prompts, max_new_tokens=6)
    forwards = engine.forward_counts["prefill"] + engine.forward_counts["decode"]
    assert quant_matmul.launches == 7 * config.num_layers * forwards
    for row, p in zip(rows, prompts):
        np.testing.assert_array_equal(row, generate(reference, p[None], max_new_tokens=6)[0])
