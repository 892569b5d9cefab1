"""Tests that launch the port's CUDA kernel: marked ``gpu``, they skip on a
machine without a CUDA card. This file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Whether a card exists is decided inside the ``cuda`` fixture, never while
the module is imported, so every worker collects the same tests."""

import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu_torch import (
    Accelerator,
    AcceleratorState,
    CompilationConfig,
    GradientState,
    Llama,
    PartialState,
    ServingEngine,
    generate,
    get_config,
)
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_plan,
    paged_verify_attention,
    paged_verify_attention_reference,
)
from accelerate_tpu_torch.big_modeling import dispatch_model, make_layered_device_map
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops.fused_adamw import (
    adamw_leaf,
    adamw_leaf_reference,
    bias_corrections,
    fused_adamw,
)
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
# the delta rows the dq kernel writes against the plain formula, relative to
# the largest row (at least 1): the same fp32 products summed in another order
DELTA_TOLERANCE = 1e-4


# paged geometries: (NH, KV, D, page_size, pages_per_slot, lengths); head dims 128,
# 64 and 32, page sizes 16, 8 and 5
PAGED_GEOMETRIES = [
    (16, 16, 128, 16, 8, [128, 77, 0, 1]), (64, 8, 128, 16, 8, [0, 100, 33, 128]),
    (4, 2, 64, 8, 4, [5, 32, 0]), (4, 2, 32, 8, 6, [5, 41, 0, 48]), (8, 2, 64, 5, 30, [149, 0, 61]),
]
PAGED_IDS = ["llama1b", "gqa64x8", "d64_gqa4x2", "d32_gqa4x2", "ps5_gqa8x2"]


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
    PAGED_GEOMETRIES,
    ids=PAGED_IDS,
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
    PAGED_GEOMETRIES,
    ids=PAGED_IDS,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window, geometry", [
    (9, (64, 8, 128, 16, 8, [0, 100, 33, 128])),  # 72 rows: five row tiles
    (33, (16, 16, 128, 16, 8, [128, 77, 0, 1])),  # the window chunk walked in three steps
    (33, (4, 2, 32, 5, 30, [149, 0, 61])),
], ids=["w9_gqa64x8", "w33_llama1b", "w33_d32_ps5"])
def test_verify_kernel_takes_wide_windows(cuda, dtype, window, geometry):
    """Windows past the first kernel's limits (W <= 32, W * group * D <=
    6144): the verify kernels against their plain version."""
    nh, kv, d, ps, pps, lengths = geometry
    case = _case(cuda, dtype, nh, kv, d, ps, pps, lengths, seed=3, window=window)
    got = paged_verify_attention(**case)
    want = paged_verify_attention_reference(**case)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= TOLERANCE[dtype]


def _split(monkeypatch, chunk, capacity):
    """Walk in chunks of ``chunk`` positions, whatever paged_plan would choose."""
    def plan(slots, kv, rows, cap):
        assert cap == capacity
        return pa.PagedPlan(-(-rows // pa.ROW_TILE), chunk, -(-cap // chunk))

    monkeypatch.setattr(pa, "paged_plan", plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window", [None, 5])
def test_split_counts_of_one_and_many_agree(cuda, monkeypatch, dtype, window):
    """The same inputs walked in the plan's chunks, in one chunk and in
    chunks of 64 positions (16 partials; a slot of length 0 and one of 1000
    positions): each within TOLERANCE of the plain version."""
    nh, kv, d, ps, pps, lengths = 16, 4, 128, 16, 64, [1000, 0, 64, 65, 1]
    case = _case(cuda, dtype, nh, kv, d, ps, pps, lengths, seed=4, window=window)
    fn = paged_decode_attention if window is None else paged_verify_attention
    ref = paged_decode_attention_reference if window is None else paged_verify_attention_reference
    want = ref(**case)
    plan = paged_plan(len(lengths), kv, (window or 1) * nh // kv, ps * pps)
    assert 1 < plan.chunks < ps * pps // 64
    for chunk in (plan.chunk, ps * pps, 64):
        _split(monkeypatch, chunk, ps * pps)
        got = fn(**case)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= TOLERANCE[dtype], chunk


@pytest.mark.parametrize("window", [None, 1, 5, 33])
@pytest.mark.parametrize("geometry", PAGED_GEOMETRIES[1:4], ids=PAGED_IDS[1:4])
def test_paged_kernels_are_bit_identical_across_launches(cuda, monkeypatch, geometry, window):
    """No atomics: two launches of the walk and its ordered combine give the
    same bits, bf16, in the plan's chunks and in chunks of 64."""
    nh, kv, d, ps, pps, lengths = geometry
    case = _case(cuda, torch.bfloat16, nh, kv, d, ps, pps, lengths, seed=6, window=window)
    fn = paged_decode_attention if window is None else paged_verify_attention
    assert torch.equal(fn(**case), fn(**case))
    _split(monkeypatch, 64, ps * pps)
    assert torch.equal(fn(**case), fn(**case))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_engine_on_the_card_serves_head_dim_32(cuda, dtype):
    """llama-tiny as configured (head dim 32, 4 heads over 2), page size 8:
    the engine decodes through the kernel once per layer per step, and in
    fp32 gives generate()'s tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Llama("llama-tiny", device=cuda, dtype=dtype, seed=0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 1024, (n,)).astype(np.int32) for n in (3, 17, 70, 1)]
    engine = ServingEngine(model, num_slots=4, max_len=128, page_size=8, prefill_chunk=16)
    paged_decode_attention.launches = 0
    rows = engine.generate_many(prompts, max_new_tokens=6)
    assert paged_decode_attention.launches == model.config.num_layers * engine.stats.steps > 0
    if dtype == torch.float32:
        for row, p in zip(rows, prompts):
            np.testing.assert_array_equal(row, generate(model, p[None], max_new_tokens=6)[0])


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


def _quant_case(device, m, k, n, bits, dtype, seed=0):
    rng = np.random.default_rng(seed + m + k + n + bits)
    q, scale = quantize_weight(rng.standard_normal((k, n), dtype=np.float32), bits=bits)
    w = QuantizedWeight(torch.tensor(q, device=device), torch.tensor(scale, device=device), bits, dtype)
    x = torch.tensor(rng.standard_normal((m, k), dtype=np.float32) / (4 * np.sqrt(k)), device=device).to(dtype)
    return x, w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kn", [(2048, 2048), (2048, 5504), (5504, 2048), (2048, 1001)],
                         ids=["2048x2048", "2048x5504", "5504x2048", "n_1001"])
@pytest.mark.parametrize("m", [1, 8, 40, 64, 65, 512])
def test_quant_tensor_core_kernel_matches_plain_version(cuda, m, kn, bits):
    """bf16 on the tensor cores, every row tile (M = 1 .. 64 in one tile,
    65 and 512 in several), split K (every M up to 65 at these N), and an N
    that is no multiple of 8 (byte-wide weight copies): within one bf16
    unit of the plain version."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    x, w = _quant_case(cuda, m, *kn, bits, torch.bfloat16)
    got = quant_matmul(x, w)
    want = quant_matmul_reference(x, w)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= TOLERANCE[torch.bfloat16]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", [(8, 2048, 5504), (40, 5504, 2048), (512, 2048, 2048)],
                         ids=["decode", "verify", "prefill"])
def test_quant_kernel_is_bit_identical_across_launches(cuda, mkn, bits):
    """Split K adds its partial sums in a fixed order, with no atomics: two
    launches on the same inputs give the same bits (serving's parity gates
    compare tokens)."""
    x, w = _quant_case(cuda, *mkn, bits, torch.bfloat16, seed=7)
    first = quant_matmul(x, w)
    second = quant_matmul(x, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny", "bert-tiny", "t5-tiny"])
def test_streamed_model_on_the_card_equals_the_all_device_dispatch(cuda, name, tmp_path):
    """The copy stream, its events and the pinned bounce buffer: five layers
    over device, pinned host memory and disk, at groups of one layer and of
    all five, give the all-device dispatch's logits bit for bit and (for
    the decoders) its greedy tokens; the layers' bytes were streamed."""
    from accelerate_tpu_torch.models import _ARCHS

    cfg = get_config(name).replace(num_layers=5)
    model = _ARCHS[cfg.arch](cfg, device=cuda, seed=1)
    names = list(make_layered_device_map(model, "device"))
    mixed = {n: ("cpu", "disk", "device")[int(n.split(".")[1]) % 3] if n.startswith("layers.") else "device"
             for n in names}
    ids = torch.randint(1, 1000, (2, 12), device=cuda)
    args = (ids, torch.randint(1, 1000, (2, 5), device=cuda)) if cfg.arch == "t5" else (ids,)
    device = dispatch_model(model, None, make_layered_device_map(model, "device"), dtype=torch.float32)
    want = device(*args)
    for window in (1, 1 << 30):
        streamed = dispatch_model(model, None, mixed, offload_dir=str(tmp_path), dtype=torch.float32,
                                  stream_window_bytes=window)
        assert torch.equal(streamed(*args), want)
        assert streamed.layer_on_device.count(False) == 4  # layers 0 and 3 pinned, 1 and 4 on disk
        assert streamed.streamed_bytes == 4 * streamed.packer.layer_nbytes
        if cfg.arch != "bert":
            prompt = (ids if cfg.arch == "t5" else ids[:, :4]).cpu().numpy()
            np.testing.assert_array_equal(streamed.generate(prompt, max_new_tokens=5),
                                          device.generate(prompt, max_new_tokens=5))


# flash attention geometries: (B, S, T, NH, KV, D, causal, masked)
FLASH_GEOMETRIES = {
    "causal_d64": (2, 256, 256, 4, 4, 64, True, False),
    "causal_gqa_masked": (2, 256, 256, 8, 2, 64, True, True),
    "causal_gqa_masked_s192": (2, 192, 192, 8, 2, 64, True, True),
    "d128_gqa_masked": (2, 192, 192, 4, 2, 128, True, True),
    "noncausal_cross_masked": (2, 128, 320, 4, 2, 64, False, True),
    "causal_d32_gqa_masked": (2, 256, 256, 4, 2, 32, True, True),  # dq on 128-key tiles
    "causal_d32_s192": (2, 192, 192, 4, 2, 32, True, False),  # dq on 64-key tiles
}


def _flash_case(device, dtype, geometry, seed=0):
    """Inputs and a [B, T] mask whose last batch row is fully padded (its
    queries see no key: output, dq, dk, dv exactly 0) and whose first row
    ends mid-tile."""
    b, s, t, nh, kv, d, causal, masked = geometry
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=device).to(dtype)  # noqa: E731
    q, k, v, do = f(b, s, nh, d), f(b, t, kv, d), f(b, t, kv, d), f(b, s, nh, d)
    mask = limit = None
    if masked:
        valid = np.ones((b, t), np.int32)
        valid[0, t - 37:] = 0
        valid[-1] = 0
        mask, limit = fa._mask_limit(torch.tensor(valid, device=device))
    return q, k, v, do, mask, limit, causal, 1.0 / np.sqrt(d)


def test_flash_kernels_run_on_a_fresh_thread_after_serving(cuda):
    """A serving pass, then the flash forward and backward from a thread that
    has made no CUDA call (as autograd's backward thread): the TMA launches
    make the context current before they encode their tensor maps, so they
    are not refused."""
    config = get_config("llama-tiny").replace(hidden_size=256)
    model = Llama(config, device=cuda, dtype=torch.bfloat16, seed=0)
    engine = ServingEngine(model, num_slots=4, max_len=96, page_size=16, prefill_chunk=16)
    engine.generate_many([np.arange(1, 40, dtype=np.int32)], max_new_tokens=4)
    del engine, model
    q, k, v, do, mask, limit, causal, scale = _flash_case(cuda, torch.bfloat16, FLASH_GEOMETRIES["causal_d64"])
    errors = []

    def run():
        try:
            out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale)
            fa.flash_backward(q, k, v, mask, limit, do, lse, out, causal, scale)
            torch.cuda.synchronize()
        except RuntimeError as err:
            errors.append(err)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=300)
    assert not thread.is_alive() and not errors, errors


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("geometry", list(FLASH_GEOMETRIES.values()), ids=list(FLASH_GEOMETRIES))
def test_flash_kernels_match_plain_versions(cuda, dtype, geometry):
    """Forward, dq and dk/dv kernels against their plain versions on the
    same inputs: out within TOLERANCE, lse within 1e-4 (fp32 sums in
    another order), grads within 5e-4 in fp32 and, in bf16, within 2e-2 of
    each gradient's largest magnitude (bf16 rounds p and dS before the
    products, in tiles of another order). A fully padded batch row gives
    exact zeros."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, mask, limit, causal, scale = _flash_case(cuda, dtype, geometry)
    before = (fa.flash_forward.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches)
    out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, mask, causal, scale)
    dq, delta = fa.flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal, scale)
    dk, dv = fa.flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    after = (fa.flash_forward.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches)
    assert after == tuple(x + 1 for x in before)
    assert float((out.float() - want_out.float()).abs().max()) <= TOLERANCE[dtype]
    assert float((lse - want_lse).abs().max()) <= 1e-4
    want_delta = fa.flash_delta_reference(do, out)
    assert float((delta - want_delta).abs().max()) <= DELTA_TOLERANCE * float(want_delta.abs().max().clamp(min=1))
    ref_args = (q, k, v, mask, do, lse, want_delta, causal, scale)
    grads = {"dq": (dq, fa.flash_backward_dq_reference(*ref_args))}
    grads.update(zip(("dk", "dv"), zip((dk, dv), fa.flash_backward_dkv_reference(*ref_args))))
    for name, (got, want) in grads.items():
        assert torch.isfinite(got.float()).all(), name
        err = float((got.float() - want.float()).abs().max())
        tol = 5e-4 if dtype == torch.float32 else 2e-2 * float(want.float().abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"
    if mask is not None:
        for x in (out[-1], dq[-1], dk[-1], dv[-1]):
            assert torch.count_nonzero(x) == 0


# the ring-block variants: ((B, S, T, NH, KV, D, causal, masked), (q_offset, kv_offset) or None).
# Offsets a multiple of the chunk (the ring's diagonal, past and future blocks) and others that
# cut the 64-row tiles (the first queries of the block see no key, or see all of some tile)
RING_GEOMETRIES = {
    "diagonal_d64": ((2, 256, 256, 4, 4, 64, True, False), (256, 256)),
    "past_gqa_masked": ((2, 256, 256, 8, 2, 64, True, True), (512, 0)),
    "future_masked": ((2, 256, 256, 4, 4, 64, True, True), (0, 512)),
    "shift_63_s192": ((2, 192, 192, 4, 2, 64, True, False), (100, 37)),
    "shift_minus_63_d32": ((2, 256, 256, 4, 2, 32, True, True), (37, 100)),
    "diagonal_d32_s192": ((2, 192, 192, 4, 2, 32, True, False), (192, 192)),
    "past_d128_gqa_masked": ((2, 192, 192, 4, 2, 128, True, True), (384, 0)),
    "noncausal_masked": ((2, 256, 256, 4, 2, 64, False, True), None),
}


def _ring_launch(q, k, v, do, mask, limit, causal, scale, offsets, dlse):
    out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale, offsets=offsets)
    dq, delta = fa.flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal, scale, offsets=offsets, dlse=dlse)
    dk, dv = fa.flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal, scale, offsets=offsets)
    return out, lse, dq, delta, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("geometry,offsets", list(RING_GEOMETRIES.values()), ids=list(RING_GEOMETRIES))
def test_flash_ring_kernels_match_plain_versions(cuda, dtype, geometry, offsets):
    """The ring-block variants (global offsets; dq with an lse cotangent)
    against their plain versions, at the tolerances of the kernels without
    offsets; each launch counted as a ring launch; a block wholly in the
    future gives exact zeros and lse < -1e28."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, mask, limit, causal, scale = _flash_case(cuda, dtype, geometry)
    b, s, nh = q.shape[0], q.shape[1], q.shape[2]
    dlse = torch.tensor(np.random.default_rng(7).standard_normal((b, nh, s), dtype=np.float32), device=cuda)
    before = [w.ring_launches for w in (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)]
    out, lse, dq, delta, dk, dv = _ring_launch(q, k, v, do, mask, limit, causal, scale, offsets, dlse)
    torch.cuda.synchronize()
    after = [w.ring_launches for w in (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)]
    assert after == [before[0] + (offsets is not None), before[1] + 1, before[2] + (offsets is not None)]
    want_out, want_lse = fa.flash_forward_reference(q, k, v, mask, causal, scale, offsets=offsets)
    assert float((out.float() - want_out.float()).abs().max()) <= TOLERANCE[dtype]
    assert float((lse - want_lse).abs().max()) <= 1e-4
    want_delta = fa.flash_delta_reference(do, out, dlse)
    assert float((delta - want_delta).abs().max()) <= DELTA_TOLERANCE * float(want_delta.abs().max().clamp(min=1))
    ref_args = (q, k, v, mask, do, lse, want_delta, causal, scale)
    grads = {"dq": (dq, fa.flash_backward_dq_reference(*ref_args, offsets=offsets))}
    grads.update(zip(("dk", "dv"), zip((dk, dv), fa.flash_backward_dkv_reference(*ref_args, offsets=offsets))))
    for name, (got, want) in grads.items():
        assert torch.isfinite(got.float()).all(), name
        err = float((got.float() - want.float()).abs().max())
        tol = 5e-4 if dtype == torch.float32 else 2e-2 * float(want.float().abs().max().clamp(min=1e-30))
        assert err <= tol, f"{name}: {err} > {tol}"
    if offsets is not None and offsets[0] + s - 1 < offsets[1]:  # wholly in the future
        assert bool((lse < -1e28).all())
        for x in (out, dq, dk, dv):
            assert torch.count_nonzero(x) == 0


@pytest.mark.parametrize("geometry,offsets", list(RING_GEOMETRIES.values()), ids=list(RING_GEOMETRIES))
def test_flash_ring_kernels_are_bit_identical_across_launches(cuda, geometry, offsets):
    q, k, v, do, mask, limit, causal, scale = _flash_case(cuda, torch.bfloat16, geometry)
    dlse = torch.tensor(np.random.default_rng(8).standard_normal((q.shape[0], q.shape[2], q.shape[1]),
                                                                  dtype=np.float32), device=cuda)
    first = _ring_launch(q, k, v, do, mask, limit, causal, scale, offsets, dlse)
    again = _ring_launch(q, k, v, do, mask, limit, causal, scale, offsets, dlse)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_block_grads_match_autograd_through_plain(cuda, masked):
    """The ring block's autograd function on the card (the kernels, the lse
    cotangent folded into delta) against autograd through the plain forward
    with both cotangents, fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, mask, limit, _, scale = _flash_case(cuda, torch.float32, (2, 256, 256, 4, 2, 64, True, masked))
    rng = np.random.default_rng(9)
    dlse = torch.tensor(rng.standard_normal((2, 256, 4), dtype=np.float32), device=cuda)
    kv_mask = None if mask is None else mask
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_block(*leaves, kv_mask, causal=True, q_offset=256, kv_offset=128)
    got = torch.autograd.grad((out, lse), leaves, (do, dlse))
    plain = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want_out, want_lse = fa.flash_forward_reference(*plain, mask, True, scale, offsets=(256, 128))
    want = torch.autograd.grad((want_out, want_lse.transpose(1, 2)), plain, (do, dlse))
    assert float((out - want_out).abs().max()) <= TOLERANCE[torch.float32]
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 5e-4


# the bias kernels: (B, S, T, NH, KV, D, causal, masked, bias batched). t5-base's attention at
# B=12 (encoder, 2 batch rows a dq block, 6 chunks summed) and B=32 (decoder self-attention)
BIAS_GEOMETRIES = {
    "enc_broadcast_masked": (12, 256, 256, 12, 12, 64, False, True, False),
    "dec_broadcast_causal_masked": (32, 128, 128, 12, 12, 64, True, True, False),
    "batched_causal_gqa_masked": (2, 256, 256, 4, 2, 64, True, True, True),
    "d32_broadcast_causal_gqa": (3, 192, 192, 4, 2, 32, True, False, False),
    "d128_broadcast_masked": (4, 128, 128, 4, 4, 128, False, True, False),
}


def _bias_case(device, dtype, geometry, seed=0):
    """A flash case with an fp32 bias [1|B, NH, S, T]."""
    q, k, v, do, mask, limit, causal, scale = _flash_case(device, dtype, geometry[:8], seed)
    b, s, t, nh = geometry[0], geometry[1], geometry[2], geometry[3]
    rng = np.random.default_rng(seed + 1)
    bias = torch.tensor(rng.standard_normal((b if geometry[8] else 1, nh, s, t), dtype=np.float32), device=device)
    return q, k, v, do, mask, limit, causal, scale, bias


def _bias_launch(q, k, v, do, mask, limit, causal, scale, bias):
    out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale, bias)
    dq, delta, dbias = fa.flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal, scale, bias)
    dk, dv = fa.flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal, scale, bias)
    return out, lse, dq, delta, dbias, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("geometry", list(BIAS_GEOMETRIES.values()), ids=list(BIAS_GEOMETRIES))
def test_flash_bias_kernels_match_plain_versions(cuda, dtype, geometry):
    """The bias variants of the forward, dq (with dbias) and dk/dv kernels
    against their plain versions, with the tolerances of the kernels
    without a bias (dbias like the other grads); two launches bit-identical,
    dbias included (no atomics: a broadcast bias's batch sum runs in a fixed
    order); a fully padded batch row gives exact zeros, in its dbias rows
    too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, mask, limit, causal, scale, bias = _bias_case(cuda, dtype, geometry)
    before = (fa.flash_forward.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches)
    out, lse, dq, delta, dbias, dk, dv = _bias_launch(q, k, v, do, mask, limit, causal, scale, bias)
    again = _bias_launch(q, k, v, do, mask, limit, causal, scale, bias)
    torch.cuda.synchronize()
    after = (fa.flash_forward.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches)
    assert after == tuple(x + 2 for x in before)
    for name, a, b in zip(("out", "lse", "dq", "delta", "dbias", "dk", "dv"), (out, lse, dq, delta, dbias, dk, dv),
                          again):
        assert torch.equal(a, b), f"{name} differs between two launches"
    want_out, want_lse = fa.flash_forward_reference(q, k, v, mask, causal, scale, bias)
    assert float((out.float() - want_out.float()).abs().max()) <= TOLERANCE[dtype]
    assert float((lse - want_lse).abs().max()) <= 1e-4
    want_delta = fa.flash_delta_reference(do, out)
    assert float((delta - want_delta).abs().max()) <= DELTA_TOLERANCE * float(want_delta.abs().max().clamp(min=1))
    ref_args = (q, k, v, mask, do, lse, want_delta, causal, scale, bias)
    want_dq, want_dbias = fa.flash_backward_dq_reference(*ref_args)
    grads = {"dq": (dq, want_dq), "dbias": (dbias, want_dbias)}
    grads.update(zip(("dk", "dv"), zip((dk, dv), fa.flash_backward_dkv_reference(*ref_args))))
    assert dbias.shape == bias.shape and dbias.dtype == torch.float32
    for name, (got, want) in grads.items():
        assert torch.isfinite(got.float()).all(), name
        err = float((got.float() - want.float()).abs().max())
        tol = 5e-4 if dtype == torch.float32 else 2e-2 * float(want.float().abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"
    if mask is not None:
        for x in (out[-1], dq[-1], dk[-1], dv[-1]) + ((dbias[-1],) if geometry[8] else ()):
            assert torch.count_nonzero(x) == 0


@pytest.mark.parametrize("bias_batch", [1, 2], ids=["broadcast", "batched"])
def test_flash_attention_bias_grads_match_autograd_through_plain(cuda, bias_batch):
    """fp32 ``flash_attention`` with a bias (the autograd function over the
    kernels) against autograd through the plain forward: all four grads,
    dbias in the bias's dtype; with a bias that needs no grad, q's, k's and
    v's grads unchanged."""
    torch.backends.cuda.matmul.allow_tf32 = False
    geometry = (2, 256, 256, 4, 2, 64, False, True, bias_batch == 2)
    q, k, v, do, mask, _, causal, _, bias = _bias_case(cuda, torch.float32, geometry, seed=4)
    kv_mask = mask
    grads = {}
    for kind in ("kernel", "plain"):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
        if kind == "kernel":
            out = fa.flash_attention(*leaves[:3], kv_mask, causal=causal, bias=leaves[3], scale=1.0)
        else:
            out = fa.flash_forward_reference(*leaves[:3], mask, causal, 1.0, leaves[3])[0]
        out.backward(do)
        grads[kind] = [x.grad for x in leaves]
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), grads["kernel"], grads["plain"]):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert float((got - want).abs().max()) <= 5e-4, name
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*leaves, kv_mask, causal=causal, bias=bias, scale=1.0).backward(do)
    for name, got, want in zip(("dq", "dk", "dv"), (x.grad for x in leaves), grads["kernel"]):
        assert torch.equal(got, want), name


@pytest.mark.parametrize(
    "geometry",
    [(2, 192, 320, 4, 4, 64, True, False), (2, 320, 192, 4, 2, 64, False, True),
     (2, 256, 256, 8, 2, 128, True, True), (3, 128, 128, 2, 1, 128, False, True)],
    ids=["causal_s_lt_t", "cross_s_gt_t_masked", "gqa_d128_masked", "mqa_d128_bidirectional"],
)
def test_flash_forward_kernel_edges(cuda, geometry):
    """bf16 forward on wgmma and TMA at the edges of its tiling: S != T
    (causal keys beyond S unseen, more queries than keys), GQA and MQA at
    head dim 128 (two TMA boxes a row), a mask ending mid-tile and a fully
    padded batch row (exactly 0); two launches give the same bits."""
    q, k, v, _, mask, limit, causal, scale = _flash_case(cuda, torch.bfloat16, geometry, seed=5)
    out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale)
    again, lse_again = fa.flash_forward(q, k, v, mask, limit, causal, scale)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, mask, causal, scale)
    torch.cuda.synchronize()
    assert float((out.float() - want_out.float()).abs().max()) <= TOLERANCE[torch.bfloat16]
    assert float((lse - want_lse).abs().max()) <= 1e-4
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    if mask is not None:
        assert torch.count_nonzero(out[-1]) == 0


@pytest.mark.parametrize("geometry", [FLASH_GEOMETRIES["causal_gqa_masked"], FLASH_GEOMETRIES["d128_gqa_masked"]],
                         ids=["d64", "d128"])
def test_flash_forward_lse_feeds_the_backward_kernels(cuda, geometry):
    """bf16: the backward kernels fed the forward kernel's out and lse give
    the gradients of the plain backward fed the plain forward's, within the
    backward's tolerance (2e-2 of each gradient's largest magnitude)."""
    q, k, v, do, mask, limit, causal, scale = _flash_case(cuda, torch.bfloat16, geometry, seed=9)
    out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale)
    got = dict(zip(("dq", "dk", "dv"), fa.flash_backward(q, k, v, mask, limit, do, lse, out, causal, scale)))
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, mask, causal, scale)
    ref_delta = fa.flash_delta_reference(do, ref_out)
    ref_args = (q, k, v, mask, do, ref_lse, ref_delta, causal, scale)
    want = {"dq": fa.flash_backward_dq_reference(*ref_args)}
    want.update(zip(("dk", "dv"), fa.flash_backward_dkv_reference(*ref_args)))
    torch.cuda.synchronize()
    for name in ("dq", "dk", "dv"):
        err = float((got[name].float() - want[name].float()).abs().max())
        tol = 2e-2 * float(want[name].float().abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("geometry", list(FLASH_GEOMETRIES.values()), ids=list(FLASH_GEOMETRIES))
def test_flash_backward_kernels_are_bit_identical_across_launches(cuda, geometry):
    """bf16: two launches of the dq kernel (dq and the delta rows it
    writes) and of the dk/dv kernel give the same bits: every block owns
    its output rows and sums them in a fixed order, no atomics."""
    q, k, v, do, mask, limit, causal, scale = _flash_case(cuda, torch.bfloat16, geometry, seed=11)
    out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale)
    runs = []
    for _ in range(2):
        dq, delta = fa.flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal, scale)
        runs.append((dq, delta, *fa.flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal, scale)))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "delta", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("geometry", list(FLASH_GEOMETRIES.values()), ids=list(FLASH_GEOMETRIES))
def test_whole_cuda_backward_matches_plain_backward(cuda, dtype, geometry):
    """flash_backward (the dq kernel writing delta, then dk/dv) against the
    plain dq and dk/dv versions fed delta by the plain formula: 5e-4 in
    fp32, 2e-2 of each gradient's largest magnitude in bf16; a fully padded
    batch row gives exact zeros."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, mask, limit, causal, scale = _flash_case(cuda, dtype, geometry, seed=13)
    out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale)
    got = dict(zip(("dq", "dk", "dv"), fa.flash_backward(q, k, v, mask, limit, do, lse, out, causal, scale)))
    ref_args = (q, k, v, mask, do, lse, fa.flash_delta_reference(do, out), causal, scale)
    want = {"dq": fa.flash_backward_dq_reference(*ref_args)}
    want.update(zip(("dk", "dv"), fa.flash_backward_dkv_reference(*ref_args)))
    torch.cuda.synchronize()
    for name in ("dq", "dk", "dv"):
        err = float((got[name].float() - want[name].float()).abs().max())
        tol = 5e-4 if dtype == torch.float32 else 2e-2 * float(want[name].float().abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"
        if mask is not None:
            assert torch.count_nonzero(got[name][-1]) == 0, name


class _AtenOps(TorchDispatchMode):
    """Records the name of every ATen op that runs under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_backward_runs_no_eager_op(cuda, dtype):
    """On CUDA tensors the autograd function's backward is its two kernels:
    delta = rowsum(dO·O) is computed inside the dq kernel, so no ATen op
    runs but the outputs' allocations."""
    q, k, v, do, mask, limit, causal, scale = _flash_case(cuda, dtype, FLASH_GEOMETRIES["causal_gqa_masked"])
    out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale)
    before = (fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches)
    with _AtenOps() as mode:
        fa.flash_backward(q, k, v, mask, limit, do, lse, out, causal, scale)
    assert set(mode.ops) <= {"empty", "empty_like", "empty_strided"}, mode.ops
    assert (fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_grads_match_autograd_through_plain(cuda, masked):
    """fp32: the autograd Function's grads (dq, dk/dv kernels) against
    autograd through the einsum attention, 5e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    geometry = (2, 256, 256, 8, 2, 64, True, masked)
    q, k, v, do, mask, _, causal, _ = _flash_case(cuda, torch.float32, geometry, seed=3)
    kv_mask = None if mask is None else mask.clone()
    if kv_mask is not None:
        kv_mask[-1, :5] = 1  # every batch row keeps a key: the einsum softmax has no empty row
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, kv_mask, causal=causal)
    out.backward(do)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    m = None if kv_mask is None else kv_mask[:, None, None, :].bool()
    want = fa.dot_product_attention(*ref, mask=m, causal=causal, scale=1.0 / 8.0)
    want.backward(do)
    assert float((out - want).abs().max()) <= 2e-5
    for got, w in zip(leaves, ref):
        assert float((got.grad - w.grad).abs().max()) <= 5e-4


@pytest.mark.parametrize("flag", [False, True], ids=["clear", "set"])
def test_guarded_adamw_variant_takes_the_skip_flag(cuda, flag):
    """The guarded variant on leaves of odd sizes (a tail of 1-3 elements):
    the flag clear, bit-equal to the unguarded launch and the plain version;
    set, p, mu and nu bit-equal to what went in (the plain version's too,
    which takes the flag on the CPU)."""
    rng = np.random.default_rng(1)
    hp = fused_adamw(3e-3).hyperparams
    skip = torch.tensor(flag, device=cuda)
    bc = bias_corrections(hp, torch.tensor(3, dtype=torch.int32, device=cuda))
    for shape in [(64, 48), (7,), (3, 5, 11), (1,)]:
        leaf = [torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=cuda) for _ in range(2)]
        leaf.append(torch.tensor(rng.random(shape, dtype=np.float32), device=cuda))
        g = torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=cuda)
        guarded, unguarded = [x.clone() for x in leaf], [x.clone() for x in leaf]
        before = (adamw_leaf.launches, adamw_leaf.guarded_launches)
        adamw_leaf(*guarded, g, bc, hp, skip)
        adamw_leaf(*unguarded, g, bc, hp)
        assert (adamw_leaf.launches, adamw_leaf.guarded_launches) == (before[0] + 2, before[1] + 1)
        plain = leaf if flag else adamw_leaf_reference(*leaf, g, bc, hp)
        host = [x.cpu() for x in leaf]
        adamw_leaf(*host, g.cpu(), bc.cpu(), hp, skip.cpu())  # the plain version takes the flag on the CPU
        torch.cuda.synchronize()
        for got, ref, want in zip(guarded, leaf if flag else unguarded, plain):
            assert torch.equal(got, ref) and torch.equal(got, want)
        if flag:
            assert all(torch.equal(a.cpu(), b) for a, b in zip(leaf, host))


def test_fused_adamw_kernel_is_bit_equal_to_plain(cuda):
    """Five steps on leaves of odd sizes (a tail of 1-3 elements): the
    kernel's p, mu and nu equal the plain version's bit for bit."""
    rng = np.random.default_rng(0)
    tx = fused_adamw(3e-3)
    shapes = [(64, 48), (7,), (3, 5, 11), (1,)]
    p = [torch.tensor(rng.standard_normal(s, dtype=np.float32), device=cuda) for s in shapes]
    mu = [torch.zeros_like(x) for x in p]
    nu = [torch.zeros_like(x) for x in p]
    ref = [[x.clone() for x in p], [x.clone() for x in mu], [x.clone() for x in nu]]
    for step in range(1, 6):
        bc = bias_corrections(tx.hyperparams, torch.tensor(step, dtype=torch.int32, device=cuda))
        for i, shape in enumerate(shapes):
            g = torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=cuda)
            before = adamw_leaf.launches
            adamw_leaf(p[i], mu[i], nu[i], g, bc, tx.hyperparams)
            assert adamw_leaf.launches == before + 1
            ref[0][i], ref[1][i], ref[2][i] = adamw_leaf_reference(
                ref[0][i], ref[1][i], ref[2][i], g, bc, tx.hyperparams
            )
        torch.cuda.synchronize()
        for got, want in zip(p + mu + nu, ref[0] + ref[1] + ref[2]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("mixed_precision", ["no", "bf16"])
def test_training_step_runs_each_kernel_once_per_layer(cuda, mixed_precision):
    """llama-tiny widened to head dim 64, flash from 128 tokens, B=2 S=256,
    through Accelerator -> compiled_step: each flash kernel launches once per
    layer per step and adamw once per leaf per step, and one batch learnt
    for 3 steps loses loss."""
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    torch.backends.cuda.matmul.allow_tf32 = False
    accelerator = Accelerator(
        mixed_precision=mixed_precision, compilation_config=CompilationConfig(flash_attention_min_seq=128)
    )
    model = Llama(get_config("llama-tiny").replace(hidden_size=256), seed=0)
    accelerator.prepare_model(model)
    accelerator.prepare_optimizer(fused_adamw(1e-3))
    step = accelerator.compiled_step(Llama.loss_fn(model))
    batch = {"input_ids": torch.tensor(np.random.default_rng(0).integers(0, 1024, (2, 256)), device=cuda)}
    counts = lambda: (fa.flash_forward.launches, fa.flash_backward_dq.launches,  # noqa: E731
                      fa.flash_backward_dkv.launches, adamw_leaf.launches)
    before = counts()
    losses = [float(step(batch)) for _ in range(3)]
    torch.cuda.synchronize()
    layers = model.config.num_layers
    assert [a - b for a, b in zip(counts(), before)] == [3 * layers] * 3 + [3 * 12]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def _reset_training_state():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def test_prefetching_loader_on_the_card_yields_the_sampled_rows(cuda):
    """300 shuffled batches of 4 rows through ``prefetch=3`` on the card,
    the consumer's stream kept busy so the producer's copies run ahead:
    every batch holds the rows its sampler picked (compared on the card,
    in the consumer's stream, so a read before the copy landed or a buffer
    reused too early would show), and the batches equal those of
    ``prefetch=0``."""
    from accelerate_tpu_torch.data_loader import BatchSampler, SeedableRandomSampler, prepare_data_loader

    _reset_training_state()
    PartialState(device=cuda)
    rows = np.random.default_rng(0).integers(-2**31, 2**31 - 1, (1200, 33)).astype(np.int32)
    dataset = [{"x": r} for r in rows]
    sampler = BatchSampler(SeedableRandomSampler(len(rows), seed=5), 4)
    sampler.set_epoch(1)
    want = [torch.tensor(rows[b], device=cuda) for b in sampler]
    got = {}
    for prefetch in (3, 0):
        loader = prepare_data_loader(dataset, batch_size=4, shuffle=True, seed=5, prefetch=prefetch)
        loader.set_epoch(1)
        bad = torch.zeros((), dtype=torch.int64, device=cuda)
        sums = []
        for batch, expected in zip(loader, want):
            assert batch["x"].is_cuda
            torch.cuda._sleep(200_000)  # the step: the consumer's stream lags the copies
            bad += (batch["x"] != expected).sum()
            sums.append(batch["x"].sum(dtype=torch.int64))
        torch.cuda.synchronize()
        assert int(bad) == 0 and loader.batches_yielded == len(want) == 300
        got[prefetch] = torch.stack(sums).cpu()
    assert torch.equal(got[3], got[0])


class _TinyModel(torch.nn.Module):
    """A two-leaf model with the port's ``apply`` and ``param_tree``."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(8, 4))
        self.b = torch.nn.Parameter(torch.zeros(4))

    def param_tree(self):
        return {"w": self.w, "b": self.b}

    @staticmethod
    def apply(params, x):
        return x @ params["w"] + params["b"]


def test_checkpoint_round_trips_cuda_rng_and_generators(cuda, tmp_path):
    """save_state on the card, draw, load_state: the global CUDA RNG, the
    port's CUDA and CPU generators and the model's params come back, so the
    draws after the load repeat those after the save."""
    from accelerate_tpu_torch.utils.random import generator, set_seed

    _reset_training_state()
    accelerator = Accelerator()
    model, _ = accelerator.prepare(_TinyModel(), fused_adamw(1e-2))
    set_seed(11)
    torch.randn(3, device=cuda)
    generator("cuda")
    accelerator.save_state(str(tmp_path / "ckpt"))
    draws = lambda: (torch.randn(5, device=cuda), torch.randn(5, generator=generator("cuda"), device=cuda),  # noqa: E731
                     torch.randn(5, generator=generator("cpu")))
    first = draws()
    with torch.no_grad():
        model.params["w"].add_(1.0)
    accelerator.load_state(str(tmp_path / "ckpt"))
    again = draws()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert torch.equal(model.params["w"], torch.ones(8, 4, device=cuda))


def _plain_attention(causal):
    """The flash dispatch's function by the kernels' plain forward, with
    autograd through it (no kernel)."""

    def attention(q, k, v, kv_mask=None):
        mask = None if kv_mask is None else fa._mask_limit(kv_mask)[0]
        return fa.flash_forward_reference(q, k, v, mask, causal, 1.0 / q.shape[-1] ** 0.5)[0]

    return attention


def test_bert_flash_path_matches_its_plain_path(cuda):
    """bert-base's width (12 heads of 64, 2 layers) at B=4 S=128 in fp32,
    non-causal under a padding mask: the logits (2e-5) and every gradient
    (5e-4 of its largest magnitude) through the flash kernels against the
    same model attending by the kernels' plain version; each flash kernel
    launches once a layer."""
    from accelerate_tpu_torch import Bert
    from accelerate_tpu_torch.utils.params import flatten_tree, tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("bert-base").replace(num_layers=2)
    rng = np.random.default_rng(0)
    mask = np.ones((4, 128), np.int32)
    for row, length in enumerate((128, 100, 37, 16)):
        mask[row, length:] = 0
    batch = {"input_ids": torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)), device=cuda),
             "attention_mask": torch.tensor(mask, device=cuda),
             "labels": torch.tensor([0, 1, 1, 0], device=cuda)}
    results = {}
    for kind in ("kernels", "plain"):
        model = Bert(cfg, seed=0)
        model.attention_fn = (fa.make_auto_attention(128, causal=False) if kind == "kernels"
                              else _plain_attention(causal=False))
        params = tree_map(lambda p: p.detach().clone().requires_grad_(), model.param_tree())
        before = fa.flash_forward.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches
        logits = model.apply(params, batch["input_ids"], batch["attention_mask"])
        loss = Bert.loss_fn(model)(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        torch.cuda.synchronize()
        after = fa.flash_forward.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches
        it = iter(grads)
        results[kind] = (logits.detach(), dict(flatten_tree(tree_map(lambda _: next(it), params))),
                         [a - b for a, b in zip(after, before)])
    assert results["kernels"][2] == [2 * 2, 2, 2] and results["plain"][2] == [0, 0, 0]
    assert float((results["kernels"][0] - results["plain"][0]).abs().max()) <= 2e-5
    for key, want in results["plain"][1].items():
        got = results["kernels"][1][key]
        assert float((got - want).abs().max()) <= 5e-4 * max(float(want.abs().max()), 1e-4), key


@pytest.mark.parametrize("policy,forwards", [(None, 1), ("full", 2), ("save_flash", 1)])
def test_remat_policies_launch_the_flash_forward_once_or_twice(cuda, policy, forwards):
    """llama-tiny widened to head dim 64, flash from 128 tokens, B=2 S=256,
    bf16, one compiled step: ``flash_fwd`` launches once a layer without
    remat and under ``save_flash``, twice under ``"full"``; dq and dk/dv
    once a layer under each; the loss equals the loss without remat."""
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    accelerator = Accelerator(mixed_precision="bf16", compilation_config=CompilationConfig(
        flash_attention_min_seq=128, remat_policy=policy))
    model = Llama(get_config("llama-tiny").replace(hidden_size=256), seed=0)
    accelerator.prepare_model(model)
    accelerator.prepare_optimizer(fused_adamw(1e-3))
    step = accelerator.compiled_step(Llama.loss_fn(model))
    batch = {"input_ids": torch.tensor(np.random.default_rng(0).integers(0, 1024, (2, 256)), device=cuda)}
    counts = lambda: (fa.flash_forward.launches, fa.flash_backward_dq.launches,  # noqa: E731
                      fa.flash_backward_dkv.launches)
    before = counts()
    loss = float(step(batch))
    torch.cuda.synchronize()
    layers = model.config.num_layers
    assert [a - b for a, b in zip(counts(), before)] == [forwards * layers, layers, layers]
    assert np.isfinite(loss)


def test_two_processes_share_the_card_over_gloo(cuda):
    """Phase 18 of ``chip_smoke.py`` at llama-tiny size: two processes on
    cuda:0 over gloo, bf16, flash from 128 tokens, fused adamw, 3 steps on
    halves of each global batch of 8 rows: under ZeRO over fsdp=2 and under
    FSDP stage 3 with ``cpu_offload``. Both processes report the same global
    losses, within 5e-3 relative of one process's steps on the whole batch
    (bf16 rounds to 2^-8 relative); each launches every flash kernel once a
    layer a step and fused adamw once a shard leaf a step; the offloaded
    state lives in pinned host memory."""
    import os
    import sys

    from accelerate_tpu_torch.launchers import debug_launcher

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_workers as workers

    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 1024, (8, 128)).astype(np.int32) for _ in range(3)]
    ranks = debug_launcher(workers.gpu_pair, (batches,), num_processes=2, timeout=600)
    _reset_training_state()
    acc = Accelerator(mixed_precision="bf16", compilation_config=CompilationConfig(flash_attention_min_seq=128))
    model = Llama("llama-tiny", seed=0)
    acc.prepare_model(model)
    acc.prepare_optimizer(fused_adamw(1e-3))
    step = acc.compiled_step(Llama.loss_fn(model))
    single = [float(step({"input_ids": torch.tensor(b, device="cuda")})) for b in batches]
    layers = model.config.num_layers
    for name in ("zero", "offload"):
        got = [ranks[r][name] for r in range(2)]
        assert got[0]["losses"] == got[1]["losses"]
        np.testing.assert_allclose(got[0]["losses"], single, rtol=5e-3)
        for out in got:
            want = {"flash_fwd": 3 * layers, "flash_dq": 3 * layers, "flash_dkv": 3 * layers,
                    "fused_adamw": 3 * out["shard_leaves"]}
            assert out["launches"] == want
    assert all(ranks[r]["offload"]["state_pinned_on_host"] for r in range(2))
    _reset_training_state()


def test_pipeline_stages_share_the_card_over_gloo(cuda):
    """Phase 29 of ``chip_smoke.py`` at llama-tiny size: two processes on
    cuda:0 over gloo under ``pipeline=2`` (one layer a stage), bf16, flash
    from 128 tokens, fused adamw, 3 steps on global batches of 8 rows in 8
    microbatches. Both stages report the same losses, within 5e-3 relative
    of one process's steps (bf16 rounds to 2^-8 relative); each stage
    launches the flash forward twice a microbatch a step (the chunk is
    recomputed in the backward), dq and dk/dv once, adamw once a stored
    leaf a step."""
    import os
    import sys

    from accelerate_tpu_torch.launchers import debug_launcher

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_pipeline_workers as workers

    rng = np.random.default_rng(29)
    batches = [rng.integers(0, 1024, (8, 128)).astype(np.int32) for _ in range(3)]
    ranks = debug_launcher(workers.gpu_pipeline, (batches,), num_processes=2, timeout=600)
    _reset_training_state()
    acc = Accelerator(mixed_precision="bf16", compilation_config=CompilationConfig(flash_attention_min_seq=128))
    model = Llama("llama-tiny", seed=0)
    acc.prepare_model(model)
    acc.prepare_optimizer(fused_adamw(1e-3))
    step = acc.compiled_step(Llama.loss_fn(model))
    single = [float(step({"input_ids": torch.tensor(b, device="cuda")})) for b in batches]
    _reset_training_state()
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], single, rtol=5e-3)
    per_stage = model.config.num_layers // 2
    for out in ranks:
        micro = out["microbatches"]
        assert out["launches"] == {"flash_fwd": 2 * per_stage * micro * 3, "flash_dq": per_stage * micro * 3,
                                   "flash_dkv": per_stage * micro * 3, "fused_adamw": out["leaves"] * 3}


# -- gpt2 at its shapes: the paged kernels at 25 heads, the dequant-matmul at K=1600 --


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window", [None, 5], ids=["decode", "verify5"])
def test_paged_kernels_at_gpt2_1_5b_heads(cuda, dtype, window):
    """gpt2-1.5b's attention: 25 heads of 64 and no grouped K/V, 8 slots of
    up to 1000 positions in pages of 16."""
    case = _case(cuda, dtype, 25, 25, 64, 16, 64, [1000, 700, 517, 64, 33, 17, 1, 0], seed=22, window=window)
    fn, ref = ((paged_decode_attention, paged_decode_attention_reference) if window is None
               else (paged_verify_attention, paged_verify_attention_reference))
    got = fn(**case)
    assert torch.equal(got, fn(**case))
    assert float((got.float() - ref(**case).float()).abs().max()) <= TOLERANCE[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("kn", [(1600, 4800), (1600, 1600), (1600, 6400), (6400, 1600)],
                         ids=["wqkv", "wo", "w_up", "w_down"])
def test_quant_kernel_at_gpt2_1_5b_shapes(cuda, dtype, bits, m, kn):
    """K = 1600 is 12.5 tiles of 128 rows (int4: 800 packed rows): the
    ragged last K tile against the plain version, two launches equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    k, n = kn
    rng = np.random.default_rng(k + n + m + bits)
    q, scale = quantize_weight(rng.standard_normal((k, n), dtype=np.float32), bits=bits)
    w = QuantizedWeight(torch.tensor(q, device=cuda), torch.tensor(scale, device=cuda), bits, dtype)
    x = torch.tensor(rng.standard_normal((m, k), dtype=np.float32) / (4 * np.sqrt(k)), device=cuda).to(dtype)
    got = quant_matmul(x, w)
    assert torch.equal(got, quant_matmul(x, w))
    assert float((got.float() - quant_matmul_reference(x, w).float()).abs().max()) <= TOLERANCE[dtype]


def test_gpt2_engine_on_the_card_quarantine_dense_and_handoff(cuda):
    """gpt2-tiny in fp32 on the card: the paged engine gives generate()'s
    tokens through the decode kernel; NaN in a live slot's pages
    quarantines it, its freed pages read back 0 and the requeued request
    still ends with generate()'s tokens; the dense slab and a KV handoff
    give the same tokens."""
    from accelerate_tpu_torch import GPT2

    torch.backends.cuda.matmul.allow_tf32 = False
    model = GPT2("gpt2-tiny", device=cuda, seed=0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 1024, (n,)).astype(np.int32) for n in (3, 17, 40, 1)]
    want = [generate(model, p[None], max_new_tokens=6)[0] for p in prompts]
    kwargs = dict(num_slots=4, max_len=96, page_size=16)
    engine = ServingEngine(model, prefill_chunk=16, **kwargs)
    paged_decode_attention.launches = 0
    for row, w in zip(engine.generate_many(prompts, max_new_tokens=6), want):
        np.testing.assert_array_equal(row, w)
    assert paged_decode_attention.launches == model.config.num_layers * engine.forward_counts["decode"] > 0

    rid = engine.submit(prompts[2], max_new_tokens=6)
    while not engine.cache.active.any():  # chunked prefill: a few steps
        engine.step()
    pages = engine.cache.pages_of(int(np.flatnonzero(engine.cache.active)[0]))
    engine.cache.k[:, pages] = float("nan")
    engine.step()
    assert engine.stats.slot_quarantines == 1
    assert all(float(engine.cache.k[:, p].abs().max()) == 0.0 for p in pages)
    np.testing.assert_array_equal(engine.run()[rid].generated, want[2][prompts[2].size:])
    assert bool(torch.isfinite(engine.cache.k[:, 0]).all())

    dense = ServingEngine(model, paged=False, **kwargs)
    for row, w in zip(dense.generate_many(prompts, max_new_tokens=6), want):
        np.testing.assert_array_equal(row, w)
    src, dst = ServingEngine(model, prefix_sharing=False, **kwargs), ServingEngine(model, **kwargs)
    rid = src.submit(prompts[2], max_new_tokens=6, prefill_only=True)
    src.run()
    layout = src.kv_page_layout(rid)
    kb, vb = src.extract_pages(layout["pages"])
    new_id = dst.adopt_kv(prompts[2], 6, layout, kb, vb)
    assert src.release_parked(rid) and src.cache.pages_in_use == 0
    np.testing.assert_array_equal(dst.run()[new_id].generated, want[2][prompts[2].size:])


# -- fp8 and the vocab-parallel loss on the card --------------------------------------

# _scaled_mm against the plain fp8 product, which sums the exact e4m3
# products in fp32: the fp8 tensor cores keep about 14 bits of the partial
# sums between cuBLAS's fp32 promotions (without fast accumulation), 2.3e-4
# of the largest at [2048, 768] x [768, 768] on an H100. The gradients pass
# through e4m3 casts of fp32 products summed in another order, which flip an
# element to its other neighbour now and then: they are held by the norm of
# the gap over their own
SCALED_MM_RTOL = 1e-3


@pytest.mark.parametrize("mkn", [(2048, 768, 768), (2048, 768, 2048), (2048, 2048, 768)],
                         ids=["qkvo", "up", "down"])
def test_scaled_mm_matches_the_plain_fp8_product(cuda, mkn):
    """``torch._scaled_mm`` at llama-125m's projection shapes against the
    fp32 product of the same e4m3 values; the autograd product's output
    and gradients against the same computation on the CPU; a shape off the
    16-multiple layout rule raises."""
    from accelerate_tpu_torch.ops.fp8 import fp8_matmul, make_fp8_dot, quantize_e4m3

    m, k, n = mkn
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.05
    qx, _ = quantize_e4m3(x)
    qw, _ = quantize_e4m3(w)
    got, want = fp8_matmul(qx, qw), qx.float() @ qw.float()
    assert float((got - want).abs().max()) <= SCALED_MM_RTOL * float(want.abs().max())
    ct = torch.randn((m, n), generator=gen, device="cuda")
    outs = {}
    for device in ("cuda", "cpu"):
        xd, wd = x.detach().to(device).requires_grad_(True), w.detach().to(device).requires_grad_(True)
        out = make_fp8_dot(1)(xd, wd)
        (out * ct.to(device)).sum().backward()
        outs[device] = [t.detach().cpu() for t in (out, xd.grad, wd.grad)]
    a, b = outs["cuda"][0], outs["cpu"][0]
    assert float((a - b).abs().max()) <= SCALED_MM_RTOL * float(b.abs().max())
    for a, b in zip(outs["cuda"][1:], outs["cpu"][1:]):
        assert float(torch.linalg.vector_norm(a - b)) <= SCALED_MM_RTOL * float(torch.linalg.vector_norm(b))
    with pytest.raises(ValueError, match="multiple of 16"):
        fp8_matmul(qx[:, :40], qw[:40])


def test_vocab_parallel_loss_on_cuda_in_one_process(cuda):
    """The vocab-parallel loss's collectives on CUDA tensors in a process
    group of one (gloo): equal to the plain log-softmax, value and gradient."""
    import socket

    import torch.distributed as dist

    from accelerate_tpu_torch.parallel.tensor_parallel import TensorParallel, split_vocab_nll

    started = not dist.is_initialized()
    if started:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    logits = torch.randn((2, 8, 64), generator=gen, device="cuda") * 4
    targets = torch.randint(0, 64, (2, 8), generator=gen, device="cuda")
    tp = TensorParallel(dist.group.WORLD, 1, 0, "tensor")
    a = logits.clone().requires_grad_(True)
    got = split_vocab_nll(a, targets, tp)
    got.sum().backward()
    b = logits.clone().requires_grad_(True)
    want = -torch.gather(torch.log_softmax(b, dim=-1), -1, targets[..., None])[..., 0]
    want.sum().backward()
    if started:
        dist.destroy_process_group()
    assert float((got - want).detach().abs().max()) <= 1e-5
    assert float((a.grad - b.grad).abs().max()) <= 1e-6


def _cli_output(module, argv: list) -> tuple:
    """``(exit code, stdout)`` of a port subcommand run in this process."""
    import argparse
    import contextlib
    import io

    parser = argparse.ArgumentParser()
    module.register_subcommand(parser.add_subparsers())
    args = parser.parse_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = args.func(args)
    return code, out.getvalue()


def test_env_reports_the_card(cuda):
    from accelerate_tpu_torch.commands import env

    code, out = _cli_output(env, ["env"])
    assert code == 0, out
    assert f"- card 0: {torch.cuda.get_device_name(0)}, power limit " in out
    assert f"- card count: {torch.cuda.device_count()}" in out


def test_estimate_memory_counts_the_model_on_the_card(cuda):
    """The params columns of ``estimate-memory llama-125m`` against the
    numel and element size of the model built on the card."""
    from accelerate_tpu_torch.commands import estimate

    model = Llama("llama-125m", device=cuda, seed=0)
    numel = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    code, out = _cli_output(estimate, ["estimate-memory", "llama-125m", "--dtypes", "float32", "bfloat16"])
    assert code == 0
    rows = {cols[0]: cols for cols in ([c.strip() for c in line.split("|")] for line in out.splitlines())}
    assert rows["float32"][1] == estimate._convert_bytes(nbytes)
    assert rows["bfloat16"][1] == estimate._convert_bytes(numel * 2)


def _accelerator_on_the_card():
    accelerator = Accelerator()
    return accelerator.mixed_precision, accelerator.device.type, accelerator.num_processes


def test_notebook_launcher_runs_one_process_on_the_card(cuda):
    from accelerate_tpu_torch import notebook_launcher

    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    got = notebook_launcher(_accelerator_on_the_card, num_processes=1, mixed_precision="bf16")
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    assert got == ("bf16", "cuda", 1)
