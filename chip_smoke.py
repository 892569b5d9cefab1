#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``accelerate_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (``nvcc``), and exits non-zero, printing no
result, when either is missing or any phase fails:

1. environment: card, power limit, and the kernel build with its
   ``nvcc -Xptxas -v`` register / shared-memory report;
2. the paged decode kernel against its plain PyTorch version on the card,
   at three geometries (llama-1b, the llama-70b GQA head layout, the
   llama-125m head dim 64), in bf16 and fp32, with lengths that end
   mid-page, a length-0 lane and NaN in every position past a length; plus
   CUDA-event times of the kernel, the plain version and, as a yardstick
   only, ``F.scaled_dot_product_attention`` over a pre-gathered view;
3. the serving slice in bf16: llama-1b at full width and depth (random
   weights from a seed) behind ``ServingEngine``, 16 requests to
   completion, with the kernel's launch count checked against
   layers x decode steps;
4. the same model in fp32: the engine's tokens against ``generate()``
   (dense cache, plain attention), equal except at printed near-ties.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from accelerate_tpu_torch import Llama, ServingEngine, generate, paged_decode_attention
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.ops.runtime import build_kernel, build_log

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, data sheet
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # max abs error vs the plain version
KERNEL_SOURCE = "accelerate_tpu_torch/csrc/paged_decode.cu"
REPLACES = "accelerate_tpu/ops/paged_attention.py:69"  # _decode_kernel
TIE_GAP = 1e-4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, iters: int = 50) -> float:
    """Median CUDA-event time of ``fn``, with L2 flushed before each call
    (the engine's decode reaches each layer's pool cold)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def make_case(rng, slots, nh, kv, d, ps, pps, lengths, dtype):
    """Random decode inputs: each slot owns distinct pages; every position
    at or past its length (the partial page's tail and the unwalked pages)
    holds NaN."""
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
    return dict(
        q=t(rng.standard_normal((slots, nh, d), dtype=np.float32)),
        k_new=t(rng.standard_normal((slots, kv, d), dtype=np.float32)),
        v_new=t(rng.standard_normal((slots, kv, d), dtype=np.float32)),
        pool_k=t(pool_k),
        pool_v=t(pool_v),
        tables=torch.tensor(tables, device=dev),
        lengths=torch.tensor(np.asarray(lengths, np.int32), device=dev),
    )


def bound_ms(case, dtype) -> tuple[float, str]:
    """Least time for the work this call needs: the valid K/V rows, q,
    k_new, v_new and out once each, the tables and lengths; 4 flops per
    K/V element read (q.k and p.v)."""
    slots, nh, d = case["q"].shape
    kv = case["k_new"].shape[1]
    esize = torch.finfo(dtype).bits // 8
    valid = int(case["lengths"].sum().item())
    kv_bytes = valid * kv * d * 2 * esize
    io_bytes = (2 * slots * nh * d + 2 * slots * kv * d) * esize
    index_bytes = case["tables"].numel() * 4 + slots * 4
    flops = 4.0 * valid * nh * d
    t_bytes = (kv_bytes + io_bytes + index_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(case):
    """``scaled_dot_product_attention`` over a contiguous pre-gathered view
    (gathered outside the timed call): the library yardstick."""
    q, kn, vn = case["q"], case["k_new"], case["v_new"]
    slots, nh, d = q.shape
    kv = kn.shape[1]
    pps, ps = case["tables"].shape[1], case["pool_k"].shape[1]
    t = pps * ps
    valid = torch.arange(t, device=q.device)[None, :] < case["lengths"][:, None]
    k = case["pool_k"][case["tables"].long()].reshape(slots, t, kv, d).nan_to_num()
    v = case["pool_v"][case["tables"].long()].reshape(slots, t, kv, d).nan_to_num()
    # [S, NH, T + 1, D]: kv heads repeated for their query heads
    k = torch.cat([k, kn[:, None]], 1).repeat_interleave(nh // kv, dim=2).transpose(1, 2).contiguous()
    v = torch.cat([v, vn[:, None]], 1).repeat_interleave(nh // kv, dim=2).transpose(1, 2).contiguous()
    mask = torch.cat([valid, torch.ones((slots, 1), dtype=torch.bool, device=q.device)], 1)
    mask = mask[:, None, None, :]
    qh = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def phase_environment() -> str:
    card = card_line()
    print(f"[env] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {card}")
    t0 = time.perf_counter()
    build_kernel("paged_decode")
    print(f"[env] built {KERNEL_SOURCE} for sm_90a in {time.perf_counter() - t0:.1f} s")
    for line in (build_log("paged_decode") or "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[env] ptxas: {line.strip()}")
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
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    ids = [engine.submit(p, max_new_tokens=64) for p in prompts]
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
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
    for rid in ids:
        result = results[rid]
        if result.finish_reason != "length" or result.generated.size != 64:
            raise AssertionError(f"request {rid} ended {result.finish_reason!r}")
        if not ((result.generated >= 0) & (result.generated < model.config.vocab_size)).all():
            raise AssertionError(f"request {rid} produced ids outside the vocabulary")
    if m["prefix_hits"] < 1:
        raise AssertionError("the shared 64-token prefix was never reused")
    profile_decode(engine, card)
    del engine, model
    torch.cuda.empty_cache()
    return launches


def profile_decode(engine, card: str, steps: int = 10) -> None:
    """Where a steady decode step's time goes: 8 slots decoding (prompts of
    32 tokens, prefilled before the window), ``steps`` steps under
    torch.profiler. Prints the device-busy share of the wall time and the
    device time by kernel. Runs after the main path's counts are read."""
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
    device = {}  # device-side events only: a host op's device time repeats its kernels'
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA and event.self_device_time_total > 0:
            device[event.key] = event.self_device_time_total
    busy = sum(device.values())
    print(f"[profile] {steps} decode steps, 8 slots at ~32-96 positions: wall "
          f"{wall_us / steps / 1e3:.3f} ms/step under the profiler, device busy "
          f"{busy / steps / 1e3:.3f} ms/step ({busy / wall_us:.1%} of wall) [{card}]")
    for key, us in sorted(device.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {us / steps:9.1f} us/step  {key[:90]}")


def phase_parity(card: str) -> None:
    """fp32: engine tokens == generate() tokens, up to near-ties."""
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products on both sides
    torch.backends.cudnn.allow_tf32 = False
    model = Llama("llama-1b", dtype=torch.float32, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    vocab = model.config.vocab_size
    prompts = [rng.integers(1, vocab, size=n).astype(np.int32) for n in (1, 17, 150, 333)]
    new = 16
    engine = ServingEngine(model, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    rows = engine.generate_many(prompts, max_new_tokens=new)
    ties = 0
    for i, (prompt, row) in enumerate(zip(prompts, rows)):
        ref = generate(model, prompt[None], max_new_tokens=new)[0]
        with torch.no_grad():
            logits = model(torch.tensor(ref[None, :-1], device="cuda"))[0, prompt.size - 1 :]
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        for j in range(new):
            if gaps[j] < TIE_GAP:
                ties += 1
                print(f"[parity] request {i} step {j}: tie (top-two gap {gaps[j]:.2e}), "
                      "comparison stops here")
                break
            if row[prompt.size + j] != ref[prompt.size + j]:
                raise AssertionError(
                    f"request {i} step {j}: engine token {row[prompt.size + j]} != "
                    f"generate() token {ref[prompt.size + j]} (top-two gap {gaps[j]:.2e})"
                )
    print(f"[parity] llama-1b fp32, prompts {[p.size for p in prompts]} x {new} tokens: "
          f"engine == generate() with {ties} ties [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = phase_environment()
    record = phase_kernel(card)
    launches = phase_serving(card)
    phase_parity(card)
    kernels = [dict(
        name="paged_decode", route="cuda", source=KERNEL_SOURCE, replaces=REPLACES,
        launches=launches, **record,
    )]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
