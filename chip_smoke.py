#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``accelerate_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (``nvcc``), and exits non-zero, printing no
result, when either is missing or any phase fails. Each phase prints its
wall time:

1. environment: card, power limit, and the build of every kernel (one
   ``nvcc`` per source, all started together) with its ``nvcc -Xptxas -v``
   register / shared-memory report;
2. the paged decode kernel against its plain PyTorch version on the card,
   at three geometries (llama-1b, the llama-70b GQA head layout, the
   llama-125m head dim 64), in bf16 and fp32, with lengths that end
   mid-page, a length-0 lane and NaN in every position past a length; plus
   CUDA-event times of the kernel, the plain version and, as a yardstick
   only, ``F.scaled_dot_product_attention`` over a pre-gathered view;
3. the serving slice in bf16: llama-1b at full width and depth (random
   weights from a seed) behind ``ServingEngine``, 16 requests to
   completion, with the kernel's launch count checked against
   layers x decode steps; then ``torch.profiler`` over ten steady decode
   steps and over a second pass of such traffic, prefill chunks included;
4. the same model in fp32: the engine's tokens against ``generate()``
   (dense cache, plain attention), equal except at printed near-ties;
5. the speculative verify kernel against its plain version at the same
   three geometries with a window of 5 (k=4) and of 1, in bf16 and fp32;
   at W=1 also against the decode kernel; times as in phase 2, with SDPA
   over a pre-gathered view under the window mask as the yardstick;
6. speculative serving in bf16: llama-1b verifying llama-125m's drafts
   (k=4, linear), phase 3's traffic, with verify launches checked against
   layers x verify forwards;
7. speculative parity in fp32: llama-1b drafting for itself, linear and
   tree mode, tokens equal to the plain engine's except at near-ties, most
   drafted tokens accepted, tree mode returning every page it borrowed;
8. the fused dequant-matmul kernel against its plain version at every
   llama-1b projection shape, int8 and int4, M in {8, 64, 512}, bf16 and
   fp32, timed beside cuBLAS over the weight dequantized beforehand;
9. quantized-resident serving: llama-1b int8 through ``dispatch_model`` and
   ``ServingEngine.from_streamed`` in bf16 with phase 3's traffic (kernel
   launches checked against 7 projections x layers x forwards, resident
   layer bytes against bf16's, the device memory ``from_streamed`` adds
   measured), profiled as in phase 3; then fp32 int8 and int4 tokens
   against ``generate()`` over the dequantized weights.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from accelerate_tpu_torch import (
    Llama,
    QuantizationConfig,
    QuantizedWeight,
    ServingEngine,
    SpeculativeConfig,
    dispatch_model,
    generate,
    make_layered_device_map,
    paged_decode_attention,
    paged_verify_attention,
    quant_dot,
    quant_matmul,
)
from accelerate_tpu_torch.big_modeling import StreamedModel
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.ops.quant_matmul import quant_matmul_reference
from accelerate_tpu_torch.ops.runtime import build_kernel, build_log
from accelerate_tpu_torch.serving.engine import params_from_streamed
from accelerate_tpu_torch.utils.quantization import dequantize_weight, quantize_weight

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, data sheet
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # max abs error vs the plain version
KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "paged_decode": ("accelerate_tpu_torch/csrc/paged_decode.cu",
                     "accelerate_tpu/ops/paged_attention.py:69"),  # _decode_kernel
    "paged_verify": ("accelerate_tpu_torch/csrc/paged_verify.cu",
                     "accelerate_tpu/ops/paged_attention.py:219"),  # _verify_kernel
    "quant_matmul": ("accelerate_tpu_torch/csrc/quant_matmul.cu",
                     "accelerate_tpu/ops/quant_matmul.py:68"),  # _matmul_kernel
}
TIE_GAP = 1e-4
SPEC_K = 4
WRAPPERS = {"paged_decode": paged_decode_attention, "paged_verify": paged_verify_attention,
            "quant_matmul": quant_matmul}  # each counts the launches of its kernel
PROJECTIONS = 7  # wq wk wv wo w_gate w_up w_down: the quantized matrices of a layer


def reset_launches() -> None:
    """Every kernel's count to 0, just before a path is driven."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, iters: int = 50) -> float:
    """Median CUDA-event time of ``fn``, with L2 flushed before each call
    (the engine's decode reaches each layer's pool cold). A spin of about
    half a millisecond on the card follows the flush, so the host has
    enqueued ``fn``'s launches before the start event fires: a wrapper's
    host time (tens of µs) never shows as device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # clock cycles
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def make_case(rng, slots, nh, kv, d, ps, pps, lengths, dtype, window=None):
    """Random decode inputs (verify inputs with a ``window`` axis): each slot
    owns distinct pages; every position at or past its length (the partial
    page's tail and the unwalked pages) holds NaN."""
    num_pages = slots * pps + 1
    pool_k = rng.standard_normal((num_pages, ps, kv, d), dtype=np.float32)
    pool_v = rng.standard_normal((num_pages, ps, kv, d), dtype=np.float32)
    tables = (1 + rng.permutation(num_pages - 1)[: slots * pps]).reshape(slots, pps).astype(np.int32)
    for s, length in enumerate(lengths):
        for j in range(pps):
            lo = max(length - j * ps, 0)
            if lo < ps:
                pool_k[tables[s, j], lo:] = np.nan
                pool_v[tables[s, j], lo:] = np.nan
    dev = torch.device("cuda")
    t = lambda a: torch.tensor(a, device=dev).to(dtype)  # noqa: E731
    lead = (slots,) if window is None else (slots, window)
    return dict(
        q=t(rng.standard_normal(lead + (nh, d), dtype=np.float32)),
        k_new=t(rng.standard_normal(lead + (kv, d), dtype=np.float32)),
        v_new=t(rng.standard_normal(lead + (kv, d), dtype=np.float32)),
        pool_k=t(pool_k),
        pool_v=t(pool_v),
        tables=torch.tensor(tables, device=dev),
        lengths=torch.tensor(np.asarray(lengths, np.int32), device=dev),
    )


def _windowed(case):
    """q, k_new, v_new with a window axis ``[S, W, heads, D]`` (decode: W=1)."""
    q, kn, vn = case["q"], case["k_new"], case["v_new"]
    if q.dim() == 3:
        q, kn, vn = q[:, None], kn[:, None], vn[:, None]
    return q, kn, vn


def bound_ms(case, dtype) -> tuple[float, str]:
    """Least time for the work this call needs: the valid K/V rows, q,
    k_new, v_new and out once each, the tables and lengths; 4 flops per
    K/V element read per query row (q.k and p.v), over the committed
    positions and the window's causal block."""
    q, kn, _ = _windowed(case)
    slots, w, nh, d = q.shape
    kv = kn.shape[2]
    esize = torch.finfo(dtype).bits // 8
    valid = int(case["lengths"].sum().item())
    kv_bytes = valid * kv * d * 2 * esize
    io_bytes = (2 * q.numel() + 2 * kn.numel()) * esize
    index_bytes = case["tables"].numel() * 4 + slots * 4
    flops = 4.0 * nh * d * w * (valid + slots * (w + 1) / 2)
    t_bytes = (kv_bytes + io_bytes + index_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(case):
    """``scaled_dot_product_attention`` over a contiguous pre-gathered view
    (gathered outside the timed call) under the window's mask: the library
    yardstick."""
    q, kn, vn = _windowed(case)
    slots, w, nh, d = q.shape
    kv = kn.shape[2]
    pps, ps = case["tables"].shape[1], case["pool_k"].shape[1]
    t = pps * ps
    valid = torch.arange(t, device=q.device)[None, :] < case["lengths"][:, None]
    k = case["pool_k"][case["tables"].long()].reshape(slots, t, kv, d).nan_to_num()
    v = case["pool_v"][case["tables"].long()].reshape(slots, t, kv, d).nan_to_num()
    # [S, NH, T + W, D]: kv heads repeated for their query heads
    k = torch.cat([k, kn], 1).repeat_interleave(nh // kv, dim=2).transpose(1, 2).contiguous()
    v = torch.cat([v, vn], 1).repeat_interleave(nh // kv, dim=2).transpose(1, 2).contiguous()
    in_window = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    mask = torch.cat([valid[:, None, :].expand(slots, w, t), in_window[None].expand(slots, w, w)], 2)
    mask = mask[:, None]
    qh = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def phase_environment() -> str:
    card = card_line()
    print(f"[env] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {card}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        list(pool.map(build_kernel, KERNELS))
    print(f"[env] built {len(KERNELS)} kernels for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name, (source, _) in KERNELS.items():
        for line in (build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[env] ptxas {source.split('/')[-1]}: {line.strip()}")
    return card


GEOMETRIES = {
    # name: (slots, nh, kv, d, ps, pps, lengths)
    "a_llama1b": (8, 16, 16, 128, 16, 64, [1024, 777, 0, 513, 16, 1, 300, 1000]),
    "b_gqa64x8": (8, 64, 8, 128, 16, 64, [600, 0, 1023, 17, 250, 999, 64, 5]),
    "c_d64": (8, 12, 12, 64, 16, 64, [0, 1024, 33, 700, 2, 415, 128, 901]),
}


def phase_kernel(card: str) -> dict:
    """Kernel vs plain version at each geometry and dtype; returns the
    record of geometry (a) in bf16, the main path's shape."""
    rng = np.random.default_rng(SEED)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    record = None
    for name, (slots, nh, kv, d, ps, pps, lengths) in GEOMETRIES.items():
        for dtype in (torch.bfloat16, torch.float32):
            case = make_case(rng, slots, nh, kv, d, ps, pps, lengths, dtype)
            got = paged_decode_attention(**case)
            want = pa.paged_decode_attention_reference(**case)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max().item())
            tol = TOLERANCE[dtype]
            group = nh // kv
            zero = lengths.index(0)
            exact_v = torch.equal(
                got[zero], case["v_new"][zero].repeat_interleave(group, dim=0)
            )
            ms = time_ms(lambda: paged_decode_attention(**case), flush)
            plain = time_ms(lambda: pa.paged_decode_attention_reference(**case), flush)
            library = time_ms(sdpa_call(case), flush)
            bound, bound_by = bound_ms(case, dtype)
            print(
                f"[kernel] {name} {str(dtype).split('.')[-1]}: max_abs_err {err:.3e} "
                f"(tolerance {tol:.0e}), length-0 lane == v_new: {exact_v}; "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library_ms {library:.4f}, "
                f"bound {bound:.4f} ms ({bound_by}), achieved {bound / ms:.1%} of bound "
                f"[{card}]"
            )
            if not (err <= tol) or not exact_v:
                raise AssertionError(f"kernel disagrees with its plain version at {name} {dtype}")
            if name == "a_llama1b" and dtype == torch.bfloat16:
                record = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=bound_by, library_ms=library,
                )
    return record


def serving_prompts(rng, vocab) -> list[np.ndarray]:
    """16 prompts of 1..700 tokens: sub-page, page-straddling, multi-page,
    and two that share a 64-token prefix (first and last, so the second
    arrives after the first's prefill has filed the prefix)."""
    lengths = [5, 17, 33, 1, 700] + [int(n) for n in rng.integers(2, 700, size=9)]
    prompts = [rng.integers(1, vocab, size=n).astype(np.int32) for n in lengths]
    prefix = rng.integers(1, vocab, size=64).astype(np.int32)
    shared = [np.concatenate([prefix, rng.integers(1, vocab, size=n).astype(np.int32)])
              for n in (20, 45)]
    return [shared[0]] + prompts + [shared[1]]


def phase_serving(card: str) -> int:
    """llama-1b bf16 behind the engine; returns the kernel launches."""
    model = Llama("llama-1b", dtype=torch.bfloat16, seed=SEED)
    layers = model.config.num_layers
    engine = ServingEngine(model, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    engine.warmup()
    prompts = serving_prompts(np.random.default_rng(SEED), model.config.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ids = [engine.submit(p, max_new_tokens=64) for p in prompts]
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["paged_decode"]
    m = engine.metrics()
    steps = m["steps"]
    print(
        f"[serve] llama-1b bf16, 16 requests x 64 new tokens: {steps} decode steps, "
        f"{launches} kernel launches ({layers} layers x {steps} steps = {layers * steps}), "
        f"prefix hits {m['prefix_hits']}, prefill chunks {m['prefill_chunks']}, wall {wall:.3f} s"
    )
    print(
        f"[serve] decode step p50 {m['per_token_p50_ms']:.3f} ms p99 {m['per_token_p99_ms']:.3f} ms; "
        f"{m['throughput_tokens_per_sec']:.1f} generated tokens/s; TTFT p50 "
        f"{m['ttft_p50_ms']:.1f} ms p99 {m['ttft_p99_ms']:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]"
    )
    if launches != layers * steps or launches == 0:
        raise AssertionError(f"{launches} kernel launches, expected {layers} x {steps}")
    if counts["paged_verify"] or counts["quant_matmul"]:
        raise AssertionError(f"plain serving launched other kernels: {counts}")
    for rid in ids:
        result = results[rid]
        if result.finish_reason != "length" or result.generated.size != 64:
            raise AssertionError(f"request {rid} ended {result.finish_reason!r}")
        if not ((result.generated >= 0) & (result.generated < model.config.vocab_size)).all():
            raise AssertionError(f"request {rid} produced ids outside the vocabulary")
    if m["prefix_hits"] < 1:
        raise AssertionError("the shared 64-token prefix was never reused")
    profile_decode(engine, card, "plain bf16")
    profile_serving(engine, card, "plain bf16")
    del engine, model
    torch.cuda.empty_cache()
    return launches


def report_profile(prof, wall_us: float, steps: int, what: str, card: str) -> None:
    """Device-busy share of the wall time and device time by kernel."""
    device = {}  # device-side events only: a host op's device time repeats its kernels'
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA and event.self_device_time_total > 0:
            device[event.key] = event.self_device_time_total
    busy = sum(device.values())
    print(f"[profile] {what}: {steps} steps, wall {wall_us / steps / 1e3:.3f} ms/step under the "
          f"profiler, device busy {busy / steps / 1e3:.3f} ms/step ({busy / wall_us:.1%} of wall) "
          f"[{card}]")
    for key, us in sorted(device.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {us / steps:9.1f} us/step  {key[:90]}")


def profile_decode(engine, card: str, tag: str, steps: int = 10) -> None:
    """Where a steady decode step's time goes: 8 slots decoding (prompts of
    32 tokens, prefilled before the window), ``steps`` steps under
    torch.profiler. Runs after the main path's counts are read."""
    rng = np.random.default_rng(SEED + 2)
    vocab = engine.model.config.vocab_size
    for _ in range(engine.cache.num_slots):
        engine.submit(rng.integers(1, vocab, size=32).astype(np.int32), max_new_tokens=64)
    for _ in range(4):
        engine.step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    engine.run()
    report_profile(prof, wall_us, steps, f"{tag} decode, 8 slots at ~32-96 positions", card)


def profile_serving(engine, card: str, tag: str) -> None:
    """Where a serving step's time goes: phase 3's traffic shape (fresh
    prompts, so no prefix from the counted run is reused), every step from
    submission to drain under torch.profiler, prefill chunks included.
    Device activity only: host events over some 140 steps take minutes to
    collect, and the report reads device events alone."""
    prompts = serving_prompts(np.random.default_rng(SEED + 3), engine.model.config.vocab_size)
    for p in prompts:
        engine.submit(p, max_new_tokens=64)
    torch.cuda.synchronize()
    steps = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.busy:
            engine.step()
            steps += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, steps, f"{tag} serving, 16 requests x 64 tokens with prefill", card)


def reference_rows(model, prompts, new):
    """``generate()``'s rows and, per prompt, the top-two logit gap at each
    generated position (from a full forward over the reference row)."""
    rows, gaps = [], []
    for prompt in prompts:
        ref = generate(model, prompt[None], max_new_tokens=new)[0]
        with torch.no_grad():
            logits = model(torch.tensor(ref[None, :-1], device="cuda"))[0, prompt.size - 1 :]
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        rows.append(ref)
        gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
    return rows, gaps


def compare_rows(tag, prompts, rows, want, gaps, what) -> int:
    """Rows equal to ``want`` position by position until a near-tie (top-two
    gap < TIE_GAP), where the comparison of that request stops; returns the
    number of ties."""
    ties = 0
    for i, (prompt, row, ref, gap) in enumerate(zip(prompts, rows, want, gaps)):
        for j in range(gap.size):
            if gap[j] < TIE_GAP:
                ties += 1
                print(f"[{tag}] request {i} step {j}: tie (top-two gap {gap[j]:.2e}), "
                      "comparison stops here")
                break
            if row[prompt.size + j] != ref[prompt.size + j]:
                raise AssertionError(
                    f"[{tag}] request {i} step {j}: engine token {row[prompt.size + j]} != "
                    f"{what} token {ref[prompt.size + j]} (top-two gap {gap[j]:.2e})"
                )
    return ties


def phase_parity(card: str):
    """fp32: engine tokens == generate() tokens, up to near-ties. Returns
    the model, prompts, engine rows and gaps for phase 7."""
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products on both sides
    torch.backends.cudnn.allow_tf32 = False
    model = Llama("llama-1b", dtype=torch.float32, seed=SEED)
    prompts = parity_prompts(model.config.vocab_size)
    new = 16
    engine = ServingEngine(model, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    rows = engine.generate_many(prompts, max_new_tokens=new)
    want, gaps = reference_rows(model, prompts, new)
    ties = compare_rows("parity", prompts, rows, want, gaps, "generate()")
    print(f"[parity] llama-1b fp32, prompts {[p.size for p in prompts]} x {new} tokens: "
          f"engine == generate() with {ties} ties [{card}]")
    return model, prompts, rows, gaps


def parity_prompts(vocab) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in (1, 17, 150, 333)]


def phase_verify_kernel(card: str) -> dict:
    """Verify kernel vs plain version at each geometry, window 5 (k=4) and 1,
    and dtype; at W=1 also vs the decode kernel. Returns the record of
    geometry (a) in bf16 at W=5, the main path's shape."""
    rng = np.random.default_rng(SEED + 5)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    record = None
    for name, (slots, nh, kv, d, ps, pps, lengths) in GEOMETRIES.items():
        for window in (SPEC_K + 1, 1):
            for dtype in (torch.bfloat16, torch.float32):
                case = make_case(rng, slots, nh, kv, d, ps, pps, lengths, dtype, window=window)
                got = paged_verify_attention(**case)
                want = pa.paged_verify_attention_reference(**case)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max().item())
                tol = TOLERANCE[dtype]
                zero = lengths.index(0)  # its first window row sees only its own key
                exact_v = torch.equal(got[zero, 0], case["v_new"][zero, 0].repeat_interleave(nh // kv, 0))
                decode_err = 0.0
                if window == 1:
                    decode = paged_decode_attention(
                        case["q"][:, 0], case["k_new"][:, 0], case["v_new"][:, 0], case["pool_k"],
                        case["pool_v"], case["tables"], case["lengths"],
                    )
                    torch.cuda.synchronize()
                    decode_err = float((got[:, 0].float() - decode.float()).abs().max().item())
                ms = time_ms(lambda: paged_verify_attention(**case), flush)
                plain = time_ms(lambda: pa.paged_verify_attention_reference(**case), flush)
                library = time_ms(sdpa_call(case), flush)
                bound, bound_by = bound_ms(case, dtype)
                print(
                    f"[verify] {name} W={window} {str(dtype).split('.')[-1]}: max_abs_err "
                    f"{err:.3e} (tolerance {tol:.0e}), length-0 lane row 0 == v_new: {exact_v}"
                    + (f", vs decode kernel {decode_err:.3e}" if window == 1 else "")
                    + f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, library_ms {library:.4f}, "
                    f"bound {bound:.4f} ms ({bound_by}), achieved {bound / ms:.1%} of bound [{card}]"
                )
                if not (err <= tol) or not exact_v or not (decode_err <= tol):
                    raise AssertionError(f"verify kernel disagrees at {name} W={window} {dtype}")
                if name == "a_llama1b" and dtype == torch.bfloat16 and window == SPEC_K + 1:
                    record = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                                  bound_by=bound_by, library_ms=library)
    return record


def phase_spec_serving(card: str) -> int:
    """llama-1b bf16 verifying llama-125m's drafts behind the engine;
    returns the verify kernel's launches."""
    model = Llama("llama-1b", dtype=torch.bfloat16, seed=SEED)
    draft = Llama("llama-125m", dtype=torch.bfloat16, seed=SEED + 6)
    layers = model.config.num_layers
    engine = ServingEngine(
        model, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64,
        speculative=SpeculativeConfig(draft_model=draft, k=SPEC_K, mode="linear"),
    )
    engine.warmup()
    prompts = serving_prompts(np.random.default_rng(SEED), model.config.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ids = [engine.submit(p, max_new_tokens=64) for p in prompts]
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["paged_verify"]
    draft_launches = counts["paged_decode"]  # the draft decodes through the decode kernel
    draft_layers = draft.config.num_layers
    verifies = engine.forward_counts["verify"]
    m = engine.metrics()
    print(
        f"[spec] llama-1b bf16 verifying llama-125m drafts (k={SPEC_K}, linear), 16 requests x "
        f"64 new tokens: {m['steps']} steps, {verifies} verify forwards, {launches} verify "
        f"launches ({layers} layers x {verifies} = {layers * verifies}); proposed "
        f"{m['spec_proposed_tokens']}, accepted {m['spec_accepted_tokens']} (random weights: "
        f"the draft almost never agrees with the target); draft decode launches {draft_launches} "
        f"({draft_layers} layers x {draft_launches // draft_layers}); wall {wall:.3f} s"
    )
    print(
        f"[spec] step p50 {m['per_token_p50_ms']:.3f} ms p99 {m['per_token_p99_ms']:.3f} ms; "
        f"{m['throughput_tokens_per_sec']:.1f} generated tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]"
    )
    if launches != layers * verifies or launches == 0:
        raise AssertionError(f"{launches} verify launches, expected {layers} x {verifies}")
    if draft_launches == 0 or draft_launches % draft_layers or counts["quant_matmul"]:
        raise AssertionError(f"speculative serving launched {counts}")
    for rid in ids:
        if results[rid].finish_reason != "length" or results[rid].generated.size != 64:
            raise AssertionError(f"request {rid} ended {results[rid].finish_reason!r}")
    del engine, model, draft
    torch.cuda.empty_cache()
    return launches


def phase_spec_parity(card: str, model, prompts, want, gaps) -> None:
    """fp32 self draft: speculative tokens == the plain engine's (phase 4)
    up to near-ties, in linear and tree mode."""
    layers = model.config.num_layers
    for mode in ("linear", "tree"):
        engine = ServingEngine(
            model, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64, prefix_sharing=False,
            speculative=SpeculativeConfig(draft_model=model, k=SPEC_K, mode=mode, num_branches=2),
        )
        used = engine.cache.pages.used_count
        reset_launches()
        rows = engine.generate_many(prompts, max_new_tokens=16)
        ties = compare_rows(f"spec-{mode}", prompts, rows, want, gaps, "plain engine")
        s = engine.stats
        share = s.spec_accepted_tokens / max(s.spec_proposed_tokens, 1)
        # a drafting step accepts at most k - 1 tokens (the cap stays at k)
        attained = s.spec_accepted_tokens / max(len(s.spec_accepted_lengths) * (SPEC_K - 1), 1)
        verifies = engine.forward_counts["verify"]
        print(
            f"[spec-{mode}] llama-1b fp32 self draft, k={SPEC_K}: spec == plain engine with "
            f"{ties} ties; proposed {s.spec_proposed_tokens}, accepted {s.spec_accepted_tokens} "
            f"({share:.1%} of proposed, {attained:.1%} of the k-1 per drafting step); "
            f"{verifies} verify forwards, pages in use {used} -> {engine.cache.pages.used_count} "
            f"[{card}]"
        )
        if paged_verify_attention.launches != layers * verifies:
            raise AssertionError(f"{paged_verify_attention.launches} verify launches")
        # tree mode proposes 1 + (k - 1) * branches tokens per drafting step
        # for at most k - 1 accepted, so its share of proposed is bounded by
        # 3/7 at k=4; it is held to the share of what a step can accept
        if (share if mode == "linear" else attained) < 0.5:
            raise AssertionError(f"{mode}: a self draft accepted too little")
        if engine.cache.pages.used_count != used:
            raise AssertionError(f"{mode}: pages in use {used} -> {engine.cache.pages.used_count}")
        del engine
    torch.cuda.empty_cache()


QUANT_SHAPES = ((2048, 2048), (2048, 5504), (5504, 2048))  # llama-1b [K, N] projections


def quant_bound_ms(m, k, n, bits, dtype) -> tuple[float, str]:
    """Least time: the packed weight, scales, x and out once each, or the
    2 M K N flops at the dense peak of x's dtype, whichever is larger."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = k * n * bits // 8 + n * 4 + (m * k + m * n) * esize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_quant_kernel(card: str) -> dict:
    """Dequant-matmul kernel vs plain version at every llama-1b projection
    shape; returns the record of int8 bf16 [2048, 5504] at M=8 (the decode
    step's w_gate / w_up)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rng = np.random.default_rng(SEED + 8)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    record = None
    for k, n in QUANT_SHAPES:
        w = rng.standard_normal((k, n), dtype=np.float32)
        for bits in (8, 4):
            q, scale = quantize_weight(w, bits=bits)
            q, scale = torch.tensor(q, device="cuda"), torch.tensor(scale, device="cuda")
            for dtype in (torch.bfloat16, torch.float32):
                weight = QuantizedWeight(q, scale, bits, dtype)
                dense = dequantize_weight(q, scale, bits, dtype)  # the yardstick's weight
                for m in (8, 64, 512):
                    x = torch.tensor(rng.standard_normal((m, k), dtype=np.float32) / (4 * np.sqrt(k)),
                                     device="cuda").to(dtype)
                    got = quant_matmul(x, weight)
                    want = quant_matmul_reference(x, weight)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max().item())
                    ms = time_ms(lambda: quant_matmul(x, weight), flush, iters=20)
                    plain = time_ms(lambda: quant_matmul_reference(x, weight), flush, iters=20)
                    library = time_ms(lambda: x @ dense, flush, iters=20)
                    bound, bound_by = quant_bound_ms(m, k, n, bits, dtype)
                    print(
                        f"[quant] [{k},{n}] int{bits} {str(dtype).split('.')[-1]} M={m}: max_abs_err "
                        f"{err:.3e} (tolerance {TOLERANCE[dtype]:.0e}); kernel {ms:.4f} ms, plain "
                        f"{plain:.4f} ms, library_ms {library:.4f}, bound {bound:.4f} ms "
                        f"({bound_by}), achieved {bound / ms:.1%} of bound [{card}]"
                    )
                    if not (err <= TOLERANCE[dtype]):
                        raise AssertionError(f"quant kernel disagrees at [{k},{n}] int{bits} {dtype} M={m}")
                    if (k, n, bits, dtype, m) == (2048, 5504, 8, torch.bfloat16, 8):
                        record = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                                      bound_by=bound_by, library_ms=library)
                del dense
    return record


def layer_bytes(model) -> tuple[int, int]:
    """(resident bytes of the layer weights, their bytes in bf16)."""
    resident = bf16 = 0
    for name, shape in model._shapes().items():
        if name.startswith("layers."):
            leaf = getattr(model.layers, name[len("layers."):])
            resident += leaf.nbytes if isinstance(leaf, QuantizedWeight) else leaf.numel() * leaf.element_size()
            bf16 += int(np.prod(shape)) * 2
    return resident, bf16


def as_fp32(streamed: StreamedModel) -> StreamedModel:
    """The same int8 placement at fp32 compute without quantizing again:
    the packed layers do not depend on the dtype and are shared, the
    resident leaves are cast."""
    packer = copy.copy(streamed.packer)
    packer.dtype = torch.float32
    resident = {key: value.to(torch.float32) for key, value in streamed.resident.items()}
    return StreamedModel(streamed.model, resident, list(streamed.layer_buffers),
                         list(streamed.layer_on_device), packer, torch.float32, streamed.device)


def quantize_llama(bits: int, dtype) -> StreamedModel:
    """llama-1b's seeded fp32 weights, quantized on the host and placed on the card."""
    model = Llama("llama-1b", dtype=torch.float32, seed=SEED)  # the source weights
    t0 = time.perf_counter()
    streamed = dispatch_model(
        model, device_map=make_layered_device_map(model, "device"), dtype=dtype,
        quantization=QuantizationConfig(load_in_8bit=bits == 8, load_in_4bit=bits == 4),
    )
    print(f"[quant-serve] quantized llama-1b to int{bits} on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    return streamed


def phase_quant_serving(card: str, prompts) -> int:
    """llama-1b int8 behind the engine in bf16 (returns the quant kernel's
    launches), then fp32 int8 and int4 tokens against generate() over the
    dequantized weights. The host quantizes once per bit width."""
    streamed = quantize_llama(8, torch.bfloat16)
    model = streamed.model
    layers = model.config.num_layers
    # from_streamed replaces the model's own fp32 weights (freed) by the
    # streamer's layers, stacked in place: the layers must not be held twice
    replaced = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = ServingEngine.from_streamed(
        streamed, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64
    )
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated() - before + replaced
    pools = sum(t.numel() * t.element_size() for t in (engine.cache.k, engine.cache.v))
    if model.dot_fn is not quant_dot or not isinstance(model.layers.wq, QuantizedWeight):
        raise AssertionError("from_streamed did not keep the matrices packed behind quant_dot")
    resident, bf16 = layer_bytes(model)
    print(f"[quant-serve] from_streamed added {added} bytes on the card beside the {replaced} "
          f"bytes of fp32 weights it replaced: the KV pools' {pools} and {added - pools} more "
          f"(a second copy of the int8 layers would be {resident}) [{card}]")
    if not abs(added - pools) < 0.02 * resident:
        raise AssertionError(f"from_streamed added {added - pools} bytes beyond the KV pools")
    engine.warmup()
    vocab = model.config.vocab_size
    serve = serving_prompts(np.random.default_rng(SEED), vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ids = [engine.submit(p, max_new_tokens=64) for p in serve]
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["quant_matmul"]
    forwards = engine.forward_counts["prefill"] + engine.forward_counts["decode"]
    m = engine.metrics()
    print(
        f"[quant-serve] llama-1b int8 in bf16, 16 requests x 64 new tokens: {m['steps']} decode "
        f"steps, {forwards} forwards ({engine.forward_counts['prefill']} prefill spans), "
        f"{launches} kernel launches ({PROJECTIONS} x {layers} x {forwards} = "
        f"{PROJECTIONS * layers * forwards}), decode kernel launches {counts['paged_decode']}; "
        f"resident layer bytes {resident} = "
        f"{resident / bf16:.3f} x bf16's {bf16}; wall {wall:.3f} s"
    )
    print(
        f"[quant-serve] decode step p50 {m['per_token_p50_ms']:.3f} ms p99 "
        f"{m['per_token_p99_ms']:.3f} ms; {m['throughput_tokens_per_sec']:.1f} generated "
        f"tokens/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]"
    )
    if launches != PROJECTIONS * layers * forwards or launches == 0:
        raise AssertionError(f"{launches} quant launches, expected {PROJECTIONS} x {layers} x {forwards}")
    if counts["paged_decode"] != layers * engine.forward_counts["decode"] or counts["paged_verify"]:
        raise AssertionError(f"quantized serving launched {counts}")
    if not resident < 0.55 * bf16:
        raise AssertionError(f"resident layer bytes {resident} >= 0.55 x {bf16}")
    for rid in ids:
        if results[rid].finish_reason != "length" or results[rid].generated.size != 64:
            raise AssertionError(f"request {rid} ended {results[rid].finish_reason!r}")
    profile_decode(engine, card, "int8-resident bf16")
    profile_serving(engine, card, "int8-resident bf16")
    del engine, results
    torch.cuda.empty_cache()

    new = 16
    for bits in (8, 4):
        fp32 = as_fp32(streamed) if bits == 8 else quantize_llama(4, torch.float32)
        reference = Llama("llama-1b", dtype=torch.float32, seed=SEED).install(params_from_streamed(fp32))
        want, gaps = reference_rows(reference, prompts, new)
        del reference
        engine = ServingEngine.from_streamed(fp32, num_slots=8, max_len=1024, page_size=16,
                                             prefill_chunk=64)
        rows = engine.generate_many(prompts, max_new_tokens=new)
        ties = compare_rows(f"quant-int{bits}", prompts, rows, want, gaps, "dequantized generate()")
        print(f"[quant-int{bits}] llama-1b fp32 int{bits}, prompts {[p.size for p in prompts]} x "
              f"{new} tokens: engine == generate() over the dequantized weights with {ties} ties "
              f"[{card}]")
        del engine, fp32
        torch.cuda.empty_cache()
    return launches


def timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = timed("phase 1 environment and build", phase_environment)
    records = {"paged_decode": timed("phase 2 decode kernel", phase_kernel, card)}
    launches = {"paged_decode": timed("phase 3 serving", phase_serving, card)}
    model, prompts, rows, gaps = timed("phase 4 parity", phase_parity, card)
    records["paged_verify"] = timed("phase 5 verify kernel", phase_verify_kernel, card)
    launches["paged_verify"] = timed("phase 6 speculative serving", phase_spec_serving, card)
    timed("phase 7 speculative parity", phase_spec_parity, card, model, prompts, rows, gaps)
    del model
    torch.cuda.empty_cache()
    records["quant_matmul"] = timed("phase 8 quant kernel", phase_quant_kernel, card)
    launches["quant_matmul"] = timed("phase 9 quantized serving", phase_quant_serving, card, prompts)
    kernels = [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name], **records[name])
        for name, (source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
