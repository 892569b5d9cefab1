#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``accelerate_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (``nvcc``), and exits non-zero, printing no
result, when either is missing or any phase fails. Each phase prints its
wall time:

1. environment: card, power limit, and the build of every kernel (one
   ``nvcc`` per source, all started together, each source's build seconds
   printed) with its ``nvcc -Xptxas -v`` register / shared-memory report;
2. the paged decode kernels (the split walk and its combine) against their
   plain PyTorch version on the card, at five geometries (llama-1b, the
   llama-70b GQA head layout, the llama-125m head dim 64, two slots of
   4000 and 1500 positions at GQA 64/8, llama-tiny's head dim 32 at page
   size 8), in bf16 and fp32, with lengths that end mid-page, a length-0
   lane and NaN in every position past a length, two launches
   bit-identical; plus CUDA-event times of the kernels, the plain version
   and, as a yardstick only, ``F.scaled_dot_product_attention`` over a
   pre-gathered view, each with the split the host planned;
3. the serving slice in bf16: llama-1b at full width and depth (random
   weights from a seed) behind ``ServingEngine``, 16 requests to
   completion, with the kernel's launch count checked against
   layers x decode steps; then ``torch.profiler`` over ten steady decode
   steps and over a second pass of such traffic, prefill chunks included,
   with the paged walk's and combine's device time a step;
4. the same model in fp32: the engine's tokens against ``generate()``
   (dense cache, plain attention), equal except at printed near-ties; 4b,
   llama-tiny (head dim 32) the same way, and a bf16 pass of it;
5. the speculative verify kernels against their plain version at the same
   five geometries with a window of 5 (k=4) and of 1, and of 33 at
   llama-1b's and of 9 at GQA 64/8, in bf16 and fp32, two launches
   bit-identical; at W=1 also against the decode kernels; times as in
   phase 2, with SDPA over a pre-gathered view under the window mask as
   the yardstick;
6. speculative serving in bf16: llama-1b verifying llama-125m's drafts
   (k=4, linear), phase 3's traffic, with verify launches checked against
   layers x verify forwards;
7. speculative parity in fp32: llama-1b drafting for itself, linear and
   tree mode, tokens equal to the plain engine's except at near-ties, most
   drafted tokens accepted, tree mode returning every page it borrowed;
8. the fused dequant-matmul kernel against its plain version at every
   llama-1b projection shape, int8 and int4, M in {8, 40, 64, 512}, bf16
   and fp32, two launches bit-identical, timed beside cuBLAS over the
   weight dequantized beforehand;
9. quantized-resident serving: llama-1b int8 through ``dispatch_model`` and
   ``ServingEngine.from_streamed`` in bf16 with phase 3's traffic (kernel
   launches checked against 7 projections x layers x forwards, resident
   layer bytes against bf16's, the device memory ``from_streamed`` adds
   measured), profiled as in phase 3; then fp32 int8 and int4 tokens
   against ``generate()`` over the dequantized weights;
10. the flash attention forward kernel against its plain version at six
    geometries ((a) llama-125m at B=32, S=1024, causal; (b) B=8, S=4096;
    (c) B=4, S=2048, head dim 128, 32 query heads over 8 kv heads, a padded
    mask with a fully padded row; (d) non-causal under a mask; (e) B=4,
    S=512, head dim 32, 4 query heads over 2, causal; (f) bert-base's
    B=32, S=128, non-causal under a padding mask), in bf16 and
    fp32, two launches bit-identical, timed beside its bound, the plain
    version and SDPA;
11. the dq and dk/dv kernels at the same geometries against the plain
    backward and against autograd through the plain forward, the delta rows
    the dq kernel writes against the plain formula, two launches
    bit-identical; each kernel timed, and the whole backward through
    autograd (dq, then dk/dv) timed beside SDPA's backward; the backward
    must launch those two kernels and run no ATen op but allocations;
12. the fused adamw kernel bit-equal to its plain version over 5 steps on
    llama-125m's 12 leaves, timed beside ``torch.optim.AdamW(fused=True)``;
13. training: llama-125m in bf16 through ``Accelerator`` ->
    ``prepare_model`` -> ``prepare_optimizer(fused_adamw(3e-4))`` ->
    ``compiled_step`` at B=32, S=1024 and B=8, S=4096 (step p50 over 10 steps
    after 3 warm-up steps, tokens/s, MFU, peak memory, launches = 12 per
    step for each flash kernel and for adamw, one profiled step each); then
    fp32 at B=2, S=1024, 3 steps against the same steps with the plain
    attention and the plain adamw passed in; then bf16 at B=8, S=1024 on a
    64-token sub-vocabulary, whose loss must fall by 1 nat in 20 steps;
14. the training loop: llama-125m in bf16 through ``Accelerator(
    mixed_precision="bf16", gradient_accumulation_steps=2)`` and
    ``prepare(model, fused_adamw(3e-4), loader, schedule)`` over a seeded
    dataset of 264 rows of 1025 tokens (batch 16, shuffled, prefetch 2),
    2 epochs of 17 micro-batches, the last of 8 rows closing its window at
    the end of the epoch: 18 optimizer steps. Gates: every batch on the
    card holds the rows its sampler picked; run B (prefetch 0) takes a
    SIGTERM mid step 5, saves once at the boundary under
    ``CheckpointManager`` (total_limit 2 rotates out the oldest) and its
    losses equal the uninterrupted run A's; run C, a fresh Accelerator,
    resumes with ``resume("auto")`` past a torn ``.tmp`` directory and a
    damaged checkpoint, and its losses of steps 6-18 and final params equal
    run A's bit for bit (or, if two A runs differ, lie within their
    spread); launches are 12 per micro-batch for each flash kernel and 12
    per optimizer step for adamw. Printed: the step p50 through the loader
    beside phase 13's, the device busy share and the host-to-device copies'
    stream over two profiled steps, the checkpoint's bytes and its save,
    verify and load seconds, and the weight format written.

15. BERT: bert-base at full width and depth, B=32 S=128, bf16, random
    weights from seed 0, through ``compiled_step``: (a) the JAX bench's
    setup (``adamw(2e-5)``, the einsum attention the default hook takes at
    S=128) and (b) ``flash_attention_min_seq=128``, ``fused_adamw(2e-5)``
    and a right padding of seeded lengths 16-128: step p50 over 10 steps
    after 3 warm-up, steps/s, MFU, peak memory; (b) launches each flash
    kernel 12 times a step and adamw 25 (the leaves) and is profiled; (c)
    fp32 B=2, three steps through the kernels against three through the
    plain versions under the padding mask (1e-4 relative); (d) the port's
    ``nlp_example`` for one epoch, printing its metric line;
16. mixture of experts and dropout: llama-moe-tiny (4 experts, top 2, GQA
    4/2 at head dim 32) trains 5 bf16 steps at B=8 S=256 through the flash
    kernels (losses fall, the balance term is in them; peak memory of the
    dense dispatch), the same in fp32 against the plain versions,
    ``generate()`` of 8 tokens; bert-base with dropout 0.1: two runs from
    one generator seed give equal losses, another seed others;
17. activation checkpointing: llama-125m B=32 S=1024 bf16 under
    ``remat_policy`` None, "full" and "save_flash": step p50, peak memory,
    ``flash_fwd`` launches a step (12, 24, 12); fp32 B=2: one step's params
    under "full", "save_flash" and "dots_with_no_batch_dims" against no
    remat, and bert-base with dropout under "full": its grads against no
    remat (equal, or within the gap of two runs without remat);
18. two processes sharing the card over gloo (NCCL refuses two processes
    on one card), started by the port's ``debug_launcher``: (a) which of
    ``all_reduce``, ``reduce_scatter_tensor``, ``all_gather_into_tensor``
    and ``broadcast`` gloo takes on CUDA tensors; (b) llama-125m at full
    width and depth, bf16 over fp32 masters, ``fused_adamw(3e-4)``, flash
    on, global batch 16 (8 a process) at S=1024 under
    ``ParallelismConfig(fsdp=2)``: 3 ZeRO ``compiled_step``s whose losses
    both processes report alike and that lie within 5e-3 relative of one
    process's steps on the whole batch, launches a process a step (each
    flash kernel 12, ``fused_adamw`` once a shard leaf), the masters and
    optimizer state a process against ``zero_update_state_bytes``, the
    step p50 (gloo stages every collective through the host, so it says
    nothing of NCCL), and the update gate: 10 eager updates of seeded
    gradients at full width, the ZeRO update against the replicated one,
    tolerance 0. Where gloo refuses a CUDA reduce-scatter or all-gather,
    (b) runs the replicated data-parallel update and the gate is skipped.

The JSON line's launch counts of the four training kernels are phase 14's
run A; phases 15-18 print their own. The line before the last is a JSON
object describing each kernel; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu_torch import (
    Accelerator,
    AcceleratorState,
    Bert,
    CompilationConfig,
    GradientState,
    InitProcessGroupKwargs,
    Llama,
    ParallelismConfig,
    PartialState,
    QuantizationConfig,
    QuantizedWeight,
    ServingEngine,
    SpeculativeConfig,
    adamw,
    dispatch_model,
    fused_adamw,
    generate,
    get_config,
    make_layered_device_map,
    paged_decode_attention,
    paged_verify_attention,
    quant_dot,
    quant_matmul,
)
from accelerate_tpu_torch.big_modeling import StreamedModel
from accelerate_tpu_torch.checkpointing import has_safetensors
from accelerate_tpu_torch.data_loader import BatchSampler, SeedableRandomSampler
from accelerate_tpu_torch.examples import nlp_example
from accelerate_tpu_torch.fault_tolerance import build_manifest, verify_checkpoint, write_manifest
from accelerate_tpu_torch.models import train_flops_per_step
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.ops.fused_adamw import adamw_leaf, adamw_leaf_reference, bias_corrections
from accelerate_tpu_torch.ops.quant_matmul import quant_matmul_reference
from accelerate_tpu_torch.ops.runtime import build_kernel, build_log
from accelerate_tpu_torch.serving.engine import params_from_streamed
from accelerate_tpu_torch.utils.params import flatten_tree, state_leaves, tree_leaves
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
    "flash_fwd": ("accelerate_tpu_torch/csrc/flash_fwd.cu",
                  "accelerate_tpu/ops/flash_attention.py:143"),  # _fwd_kernel
    "flash_dq": ("accelerate_tpu_torch/csrc/flash_bwd.cu",
                 "accelerate_tpu/ops/flash_attention.py:279"),  # _bwd_dq_kernel
    "flash_dkv": ("accelerate_tpu_torch/csrc/flash_bwd.cu",
                  "accelerate_tpu/ops/flash_attention.py:352"),  # _bwd_dkv_kernel
    "fused_adamw": ("accelerate_tpu_torch/csrc/fused_adamw.cu",
                    "accelerate_tpu/ops/fused_adamw.py:76"),  # _adamw_kernel
}
# the sources to build: csrc/<name>.cu (flash_bwd.cu holds two kernels)
SOURCES = sorted({source.split("/")[-1][: -len(".cu")] for source, _ in KERNELS.values()})
TIE_GAP = 1e-4
SPEC_K = 4
WRAPPERS = {"paged_decode": paged_decode_attention, "paged_verify": paged_verify_attention,
            "quant_matmul": quant_matmul, "flash_fwd": fa.flash_forward,
            "flash_dq": fa.flash_backward_dq, "flash_dkv": fa.flash_backward_dkv,
            "fused_adamw": adamw_leaf}  # each counts the launches of its kernel
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

    def build(name):
        start = time.perf_counter()
        build_kernel(name)
        return time.perf_counter() - start

    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, all at once
        seconds = dict(zip(SOURCES, pool.map(build, SOURCES)))
    print(f"[env] built {len(KERNELS)} kernels from {len(SOURCES)} sources for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{name}.cu {sec:.1f} s" for name, sec in seconds.items()))
    for name in SOURCES:
        for line in ptxas_report(build_log(name) or ""):
            print(f"[env] ptxas {name}.cu {line}")
    return card


def kernel_name(mangled: str) -> str:
    """``flash_dq_bf16_kernel<64, 128>`` from an Itanium-mangled kernel
    name: the length-prefixed identifier that ends in ``_kernel``, and its
    int template arguments."""
    for run in re.finditer(r"\d+", mangled):
        for k in range(len(run.group())):  # the length may follow other digits
            ident = mangled[run.end():run.end() + int(run.group()[k:])]
            if ident.endswith("_kernel") and ident.isidentifier():
                args = re.match(r"I((?:Li\d+E)+)E", mangled[run.end() + len(ident):])
                values = re.findall(r"Li(\d+)E", args.group(1)) if args else []
                return ident + (f"<{', '.join(values)}>" if values else "")
    return mangled


def ptxas_report(log: str) -> list[str]:
    """The ``-Xptxas -v`` lines that matter, each with its kernel's name:
    registers, spills and any warning."""
    lines, kernel = [], ""
    for line in log.splitlines():
        if "Function properties for " in line:
            kernel = kernel_name(line.split("Function properties for ")[1].strip())
        elif "registers" in line or "spill" in line or "warning" in line:
            lines.append(f"{kernel}: {line.strip()}")
    return lines


GEOMETRIES = {
    # name: (slots, nh, kv, d, ps, pps, lengths)
    "a_llama1b": (8, 16, 16, 128, 16, 64, [1024, 777, 0, 513, 16, 1, 300, 1000]),
    "b_gqa64x8": (8, 64, 8, 128, 16, 64, [600, 0, 1023, 17, 250, 999, 64, 5]),
    "c_d64": (8, 12, 12, 64, 16, 64, [0, 1024, 33, 700, 2, 415, 128, 901]),
    # few slots and long walks: llama-70b's head layout, where an unsplit walk idles most SMs
    "d_long": (2, 64, 8, 128, 16, 256, [4000, 1500]),
    # llama-tiny's head layout and head dim 32, page size 8
    "e_d32": (8, 4, 2, 32, 8, 32, [256, 0, 100, 7, 64, 1, 200, 33]),
}
# verify windows of phase 5 beyond k=4 and W=1: past the old limits of W <= 32 and
# W * group * D <= 6144 (72 rows at GQA 64/8)
WINDOWS = {"a_llama1b": (SPEC_K + 1, 1, 33), "b_gqa64x8": (SPEC_K + 1, 1, 9)}


def split_line(slots, kv, rows, ps, pps) -> str:
    plan = pa.paged_plan(slots, kv, rows, ps * pps)
    return f"{plan.chunks} chunks of {plan.chunk} x {plan.row_tiles} row tiles"


def phase_kernel(card: str) -> dict:
    """Kernel vs plain version at each geometry and dtype, two launches
    bit-identical; returns the record of geometry (a) in bf16, the main
    path's shape."""
    rng = np.random.default_rng(SEED)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    record = None
    for name, (slots, nh, kv, d, ps, pps, lengths) in GEOMETRIES.items():
        for dtype in (torch.bfloat16, torch.float32):
            case = make_case(rng, slots, nh, kv, d, ps, pps, lengths, dtype)
            got = paged_decode_attention(**case)
            identical = torch.equal(got, paged_decode_attention(**case))
            want = pa.paged_decode_attention_reference(**case)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max().item())
            tol = TOLERANCE[dtype]
            group = nh // kv
            exact_v = 0 not in lengths or torch.equal(
                got[lengths.index(0)], case["v_new"][lengths.index(0)].repeat_interleave(group, dim=0)
            )
            ms = time_ms(lambda: paged_decode_attention(**case), flush)
            plain = time_ms(lambda: pa.paged_decode_attention_reference(**case), flush)
            library = time_ms(sdpa_call(case), flush)
            bound, bound_by = bound_ms(case, dtype)
            print(
                f"[kernel] {name} {str(dtype).split('.')[-1]} ({split_line(slots, kv, group, ps, pps)}): "
                f"max_abs_err {err:.3e} (tolerance {tol:.0e}), length-0 lane == v_new: {exact_v}, "
                f"two launches bit-identical: {identical}; "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library_ms {library:.4f}, "
                f"bound {bound:.4f} ms ({bound_by}), achieved {bound / ms:.1%} of bound "
                f"[{card}]"
            )
            if not (err <= tol) or not exact_v or not identical:
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
    paged = {kind: sum(us for key, us in device.items() if f"paged_{kind}_" in key)
             for kind in ("walk", "combine")}
    if any(paged.values()):
        print(f"[profile]   paged attention: walk {paged['walk'] / steps:.1f} us/step, combine "
              f"{paged['combine'] / steps:.1f} us/step")


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


def phase_tiny_serving(card: str) -> None:
    """llama-tiny (head dim 32, 4 heads over 2, page size 8) behind the
    engine: fp32 tokens == generate() up to near-ties, then a bf16 pass;
    the decode kernel launches once per layer per decode forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        model = Llama("llama-tiny", dtype=dtype, seed=SEED)
        layers = model.config.num_layers
        rng = np.random.default_rng(SEED + 4)
        prompts = [rng.integers(1, model.config.vocab_size, size=n).astype(np.int32) for n in (1, 9, 40, 150)]
        engine = ServingEngine(model, num_slots=4, max_len=256, page_size=8, prefill_chunk=64)
        reset_launches()
        rows = engine.generate_many(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        counts = launch_counts()
        decodes = engine.forward_counts["decode"]
        tag = str(dtype).split(".")[-1]
        if counts["paged_decode"] != layers * decodes or decodes == 0 or counts["paged_verify"]:
            raise AssertionError(f"llama-tiny {tag} launched {counts} over {decodes} decode forwards")
        if dtype == torch.float32:
            want, gaps = reference_rows(model, prompts, 16)
            ties = compare_rows("tiny", prompts, rows, want, gaps, "generate()")
            result = f"engine == generate() with {ties} ties"
        else:
            if not all(((r >= 0) & (r < model.config.vocab_size)).all() for r in rows):
                raise AssertionError("llama-tiny bf16 produced ids outside the vocabulary")
            result = "ids in the vocabulary"
        print(f"[tiny] llama-tiny {tag} (head dim 32), prompts {[p.size for p in prompts]} x 16 tokens: "
              f"{result}; decode kernel launches {counts['paged_decode']} = {layers} layers x "
              f"{decodes} decode forwards [{card}]")
        del engine, model
    torch.cuda.empty_cache()


def parity_prompts(vocab) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in (1, 17, 150, 333)]


def phase_verify_kernel(card: str) -> dict:
    """Verify kernel vs plain version at each geometry, window 5 (k=4), 1
    and the ``WINDOWS`` past the old limits, and dtype, two launches
    bit-identical; at W=1 also vs the decode kernel. Returns the record of
    geometry (a) in bf16 at W=5, the main path's shape."""
    rng = np.random.default_rng(SEED + 5)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    record = None
    for name, (slots, nh, kv, d, ps, pps, lengths) in GEOMETRIES.items():
        for window in WINDOWS.get(name, (SPEC_K + 1, 1)):
            for dtype in (torch.bfloat16, torch.float32):
                case = make_case(rng, slots, nh, kv, d, ps, pps, lengths, dtype, window=window)
                got = paged_verify_attention(**case)
                identical = torch.equal(got, paged_verify_attention(**case))
                want = pa.paged_verify_attention_reference(**case)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max().item())
                tol = TOLERANCE[dtype]
                # a length-0 lane's first window row sees only its own key
                exact_v = 0 not in lengths or torch.equal(
                    got[lengths.index(0), 0],
                    case["v_new"][lengths.index(0), 0].repeat_interleave(nh // kv, 0))
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
                    f"[verify] {name} W={window} {str(dtype).split('.')[-1]} "
                    f"({split_line(slots, kv, window * nh // kv, ps, pps)}): max_abs_err "
                    f"{err:.3e} (tolerance {tol:.0e}), length-0 lane row 0 == v_new: {exact_v}, "
                    f"two launches bit-identical: {identical}"
                    + (f", vs decode kernel {decode_err:.3e}" if window == 1 else "")
                    + f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, library_ms {library:.4f}, "
                    f"bound {bound:.4f} ms ({bound_by}), achieved {bound / ms:.1%} of bound [{card}]"
                )
                if not (err <= tol) or not exact_v or not identical or not (decode_err <= tol):
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
    shape, two launches bit-identical; returns the record of int8 bf16
    [2048, 5504] at M=8 (the decode step's w_gate / w_up), with those of
    M=40 (the verify window) and M=64 (the prefill chunk) under ``by_m``."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rng = np.random.default_rng(SEED + 8)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    by_m = {}
    for k, n in QUANT_SHAPES:
        w = rng.standard_normal((k, n), dtype=np.float32)
        for bits in (8, 4):
            q, scale = quantize_weight(w, bits=bits)
            q, scale = torch.tensor(q, device="cuda"), torch.tensor(scale, device="cuda")
            for dtype in (torch.bfloat16, torch.float32):
                weight = QuantizedWeight(q, scale, bits, dtype)
                dense = dequantize_weight(q, scale, bits, dtype)  # the yardstick's weight
                for m in (8, 40, 64, 512):
                    x = torch.tensor(rng.standard_normal((m, k), dtype=np.float32) / (4 * np.sqrt(k)),
                                     device="cuda").to(dtype)
                    got = quant_matmul(x, weight)
                    identical = torch.equal(got, quant_matmul(x, weight))
                    want = quant_matmul_reference(x, weight)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max().item())
                    ms = time_ms(lambda: quant_matmul(x, weight), flush, iters=20)
                    plain = time_ms(lambda: quant_matmul_reference(x, weight), flush, iters=20)
                    library = time_ms(lambda: x @ dense, flush, iters=20)
                    bound, bound_by = quant_bound_ms(m, k, n, bits, dtype)
                    print(
                        f"[quant] [{k},{n}] int{bits} {str(dtype).split('.')[-1]} M={m}: max_abs_err "
                        f"{err:.3e} (tolerance {TOLERANCE[dtype]:.0e}), two launches bit-identical: "
                        f"{identical}; kernel {ms:.4f} ms, plain "
                        f"{plain:.4f} ms, library_ms {library:.4f}, bound {bound:.4f} ms "
                        f"({bound_by}), achieved {bound / ms:.1%} of bound [{card}]"
                    )
                    if not (err <= TOLERANCE[dtype]) or not identical:
                        raise AssertionError(f"quant kernel disagrees at [{k},{n}] int{bits} {dtype} M={m}")
                    if (k, n, bits, dtype) == (2048, 5504, 8, torch.bfloat16) and m in (8, 40, 64):
                        by_m[m] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                                       bound_by=bound_by, library_ms=library)
                del dense
    return dict(by_m.pop(8), by_m=by_m)


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


# -- training: flash attention, fused adamw, the step ------------------------

FLASH_GEOMETRIES = {
    # name: (B, S, T, NH, KV, D, causal, masked)
    "a_125m_s1024": (32, 1024, 1024, 12, 12, 64, True, False),
    "b_125m_s4096": (8, 4096, 4096, 12, 12, 64, True, False),
    "c_gqa32x8_d128_masked": (4, 2048, 2048, 32, 8, 128, True, True),
    "d_bidirectional_masked": (8, 1024, 1024, 12, 12, 64, False, True),
    "e_d32_gqa4x2": (4, 512, 512, 4, 2, 32, True, False),  # llama-tiny's heads
    "f_bert_s128_masked": (32, 128, 128, 12, 12, 64, False, True),  # bert-base's attention (phase 15)
}
# bf16 grads against the plain backward / autograd: within this share of each
# gradient's largest magnitude (bf16 rounds p and dS before the products, in
# tiles of another order); fp32 within 5e-4 absolute
GRAD_TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 5e-4}


def flash_case(rng, geometry, dtype):
    """Inputs on the card; a masked case pads batch row 0 from 3/4 of T
    (mid-tile) and batch row B-1 throughout (a fully padded row)."""
    b, s, t, nh, kv, d, causal, masked = geometry
    f = lambda *shape: torch.tensor(rng.standard_normal(shape, dtype=np.float32), device="cuda").to(dtype)  # noqa: E731
    q, k, v, do = f(b, s, nh, d), f(b, t, kv, d), f(b, t, kv, d), f(b, s, nh, d)
    kv_mask = mask = limit = None
    if masked:
        valid = np.ones((b, t), np.int32)
        valid[0, 3 * t // 4 + 5:] = 0
        valid[-1] = 0
        kv_mask = torch.tensor(valid, device="cuda")
        mask, limit = fa._mask_limit(kv_mask)
    return dict(q=q, k=k, v=v, do=do, kv_mask=kv_mask, mask=mask, limit=limit, causal=causal,
                scale=1.0 / math.sqrt(d))


def attended_pairs(case) -> int:
    """(query, key) pairs the kernels score, per query head: the causal
    triangle and the mask as this run's data has them."""
    q, k = case["q"], case["k"]
    b, s, t = q.shape[0], q.shape[1], k.shape[1]
    q_pos = torch.arange(s, device="cuda")[:, None]
    k_pos = torch.arange(t, device="cuda")[None, :]
    allowed = (k_pos <= q_pos) if case["causal"] else torch.ones((s, t), dtype=torch.bool, device="cuda")
    if case["mask"] is None:
        return b * int(allowed.sum().item())
    per_key = allowed.sum(dim=0).to(torch.int64)  # queries that may see each key
    return int((case["mask"].to(torch.int64) * per_key[None, :]).sum().item())


def flash_bound_ms(case, kind: str) -> tuple[float, str]:
    """Least time of one call: every input and output once, against 2·D
    flops per product per attended pair at the dtype's dense peak. fwd: q,
    k, v, out, lse; 2 products. dq: q, k, v, dO, out, lse read, dq and
    delta written; 3 products. dkv: q, k, v, dO, lse, delta read, dk, dv
    written; 4 products. bwd, the whole backward as one function: q, k, v,
    out, dO, lse read, dq, dk, dv written; 5 products (q.k, dO.v, dS.K,
    P^T.dO, dS^T.Q, as a one-pass kernel would do them). Each counts the
    mask too."""
    q, k = case["q"], case["k"]
    esize = q.element_size()
    nq, nk = q.numel(), k.numel()
    rows = q.shape[0] * q.shape[2] * q.shape[1] * 4  # one fp32 [B, N, S] row set
    mask = 0 if case["mask"] is None else case["mask"].numel() * 4 + case["limit"].numel() * 4
    tensors = {"fwd": (2 * nq + 2 * nk) * esize + rows,
               "dq": (4 * nq + 2 * nk) * esize + 2 * rows,
               "dkv": (2 * nq + 4 * nk) * esize + 2 * rows,
               "bwd": (4 * nq + 4 * nk) * esize + rows}[kind]
    products = {"fwd": 2, "dq": 3, "dkv": 4, "bwd": 5}[kind]
    flops = 2.0 * products * q.shape[3] * q.shape[2] * attended_pairs(case)
    t_bytes = (tensors + mask) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_inputs(case, requires_grad=False):
    """[B, N, S, D] copies for SDPA (made outside the timed calls) and its
    mask: the key mask, joined with the causal triangle when both apply."""
    qh, kh, vh = (case[n].transpose(1, 2).contiguous().requires_grad_(requires_grad) for n in "qkv")
    kwargs = dict(enable_gqa=qh.shape[1] != kh.shape[1])
    if case["kv_mask"] is None:
        kwargs["is_causal"] = case["causal"]
    else:
        s, t = qh.shape[2], kh.shape[2]
        m = case["kv_mask"].bool()[:, None, None, :]
        if case["causal"]:
            m = m & torch.ones((s, t), dtype=torch.bool, device="cuda").tril()[None, None]
        kwargs["attn_mask"] = m
    return qh, kh, vh, kwargs


def phase_flash_forward(card: str) -> dict:
    """Forward kernel vs plain version at each geometry and dtype; returns
    the record of geometry (a) in bf16, the main path's shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 10)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    record = None
    for name, geometry in FLASH_GEOMETRIES.items():
        for dtype in (torch.bfloat16, torch.float32):
            c = flash_case(rng, geometry, dtype)
            args = (c["q"], c["k"], c["v"], c["mask"], c["limit"], c["causal"], c["scale"])
            out, lse = fa.flash_forward(*args)
            again, lse_again = fa.flash_forward(*args)
            identical = torch.equal(out, again) and torch.equal(lse, lse_again)
            del again, lse_again
            want, want_lse = fa.flash_forward_reference(c["q"], c["k"], c["v"], c["mask"], c["causal"], c["scale"])
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max().item())
            lse_err = float((lse - want_lse).abs().max().item())
            padded_zero = c["mask"] is None or int(torch.count_nonzero(out[-1]).item()) == 0
            del want, want_lse
            ms = time_ms(lambda: fa.flash_forward(*args), flush, iters=20)
            plain = time_ms(lambda: fa.flash_forward_reference(*args[:3], c["mask"], c["causal"], c["scale"]),
                            flush, iters=5)
            qh, kh, vh, kw = sdpa_inputs(c)
            library = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw), flush, iters=20)
            del qh, kh, vh, kw
            bound, bound_by = flash_bound_ms(c, "fwd")
            print(
                f"[flash-fwd] {name} {str(dtype).split('.')[-1]}: max_abs_err {err:.3e} (tolerance "
                f"{TOLERANCE[dtype]:.0e}), lse {lse_err:.3e}, padded row exactly 0: {padded_zero}, "
                f"two launches bit-identical: {identical}; "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library_ms {library:.4f}, bound "
                f"{bound:.4f} ms ({bound_by}), achieved {bound / ms:.1%} of bound [{card}]"
            )
            if not (err <= TOLERANCE[dtype]) or not (lse_err <= 1e-4) or not padded_zero or not identical:
                raise AssertionError(f"flash forward disagrees with its plain version at {name} {dtype}")
            if name == "a_125m_s1024" and dtype == torch.bfloat16:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                              bound_by=bound_by, library_ms=library)
            del c, args, out, lse
            torch.cuda.empty_cache()
    return record


def grad_error(got, want, dtype) -> tuple[float, float]:
    """(max abs error, its tolerance) of one gradient."""
    err = float((got.float() - want.float()).abs().max().item())
    tol = GRAD_TOLERANCE[dtype] * (float(want.float().abs().max().item()) if dtype == torch.bfloat16 else 1.0)
    return err, tol


class AtenOps(TorchDispatchMode):
    """Records the name of every ATen op that runs under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


ALLOCATIONS = {"empty", "empty_like", "empty_strided"}  # ATen ops that launch no kernel


def backward_eager_ops(args) -> tuple[list[str], tuple[int, int]]:
    """What the autograd function's backward (``fa.flash_backward``) runs
    besides its two kernels: the ATen ops other than allocations (delta is
    computed inside the dq kernel, so none), and the launches of the dq and
    dk/dv kernels (one each)."""
    before = (fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches)
    with AtenOps() as mode:
        fa.flash_backward(*args)
    launches = (fa.flash_backward_dq.launches - before[0], fa.flash_backward_dkv.launches - before[1])
    return sorted(set(mode.ops) - ALLOCATIONS), launches


def phase_flash_backward(card: str) -> tuple[dict, dict]:
    """dq and dk/dv kernels vs the plain backward and vs autograd through
    the plain forward, delta (written by the dq kernel) vs the plain
    formula, two launches bit-identical; the whole backward as autograd
    runs it (the dq kernel, then dk/dv) timed beside SDPA's backward, with
    the ATen ops of one such backward checked; returns the records of
    geometry (a) in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 11)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = None
    for name, geometry in FLASH_GEOMETRIES.items():
        for dtype in (torch.bfloat16, torch.float32):
            c = flash_case(rng, geometry, dtype)
            q, k, v, do, mask, limit = (c[n] for n in ("q", "k", "v", "do", "mask", "limit"))
            out, lse = fa.flash_forward(q, k, v, mask, limit, c["causal"], c["scale"])
            dq_args = (q, k, v, mask, limit, do, lse, out, c["causal"], c["scale"])
            dq, delta = fa.flash_backward_dq(*dq_args)
            dkv_args = (q, k, v, mask, limit, do, lse, delta, c["causal"], c["scale"])
            dk, dv = fa.flash_backward_dkv(*dkv_args)
            dq2, delta2 = fa.flash_backward_dq(*dq_args)
            dk2, dv2 = fa.flash_backward_dkv(*dkv_args)
            identical = all(torch.equal(a, b) for a, b in ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
            del dq2, delta2, dk2, dv2
            want_delta = fa.flash_delta_reference(do, out)
            torch.cuda.synchronize()
            delta_err = float((delta - want_delta).abs().max().item())
            # the same fp32 products summed in another order, relative to the largest row
            delta_tol = 1e-4 * max(float(want_delta.abs().max().item()), 1.0)
            ref_args = (q, k, v, mask, do, lse, want_delta, c["causal"], c["scale"])
            errors = {}
            want = {"dq": fa.flash_backward_dq_reference(*ref_args)}
            want.update(zip(("dk", "dv"), fa.flash_backward_dkv_reference(*ref_args)))
            for key, got in (("dq", dq), ("dk", dk), ("dv", dv)):
                errors[f"{key}/plain"] = grad_error(got, want[key], dtype)
            del want
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            ref_out, _ = fa.flash_forward_reference(*leaves, mask, c["causal"], c["scale"])
            ref_out.backward(do)
            del ref_out
            for key, got, leaf in (("dq", dq, leaves[0]), ("dk", dk, leaves[1]), ("dv", dv, leaves[2])):
                errors[f"{key}/autograd"] = grad_error(got, leaf.grad, dtype)
            del leaves
            torch.cuda.empty_cache()
            padded_zero = mask is None or all(int(torch.count_nonzero(x[-1]).item()) == 0 for x in (dq, dk, dv))
            ms_dq = time_ms(lambda: fa.flash_backward_dq(*dq_args), flush, iters=20)
            ms_dkv = time_ms(lambda: fa.flash_backward_dkv(*dkv_args), flush, iters=20)
            plain_dq = time_ms(lambda: fa.flash_backward_dq_reference(*ref_args), flush, iters=3)
            plain_dkv = time_ms(lambda: fa.flash_backward_dkv_reference(*ref_args), flush, iters=3)
            # the whole backward as autograd runs it, beside SDPA's backward the same way
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            flash_out = fa.flash_attention_core(*leaves, mask, limit, c["causal"], c["scale"])
            backward = time_ms(lambda: torch.autograd.grad(flash_out, leaves, do, retain_graph=True),
                               flush, iters=20)
            eager, launches = backward_eager_ops((q, k, v, mask, limit, do, lse, out, c["causal"], c["scale"]))
            del leaves, flash_out
            qh, kh, vh, kw = sdpa_inputs(c, requires_grad=True)
            sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, **kw)
            do_h = do.transpose(1, 2).contiguous()
            library = time_ms(lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh), do_h, retain_graph=True),
                              flush, iters=20)
            del qh, kh, vh, kw, sdpa_out, do_h
            b_dq, by_dq = flash_bound_ms(c, "dq")
            b_dkv, by_dkv = flash_bound_ms(c, "dkv")
            b_bwd, by_bwd = flash_bound_ms(c, "bwd")
            worst = ", ".join(f"{key} {e:.3e} (tol {t:.1e})" for key, (e, t) in errors.items())
            print(
                f"[flash-bwd] {name} {str(dtype).split('.')[-1]}: {worst}; delta {delta_err:.3e} (tol "
                f"{delta_tol:.1e}); padded row exactly 0: {padded_zero}; two launches bit-identical: "
                f"{identical}; dq {ms_dq:.4f} ms (plain {plain_dq:.4f}, bound {b_dq:.4f} {by_dq}, "
                f"{b_dq / ms_dq:.1%}), dkv {ms_dkv:.4f} ms (plain {plain_dkv:.4f}, bound {b_dkv:.4f} "
                f"{by_dkv}, {b_dkv / ms_dkv:.1%}); whole backward through autograd {backward:.4f} ms "
                f"(eager ops besides allocations {eager}, launches dq/dkv {launches}; bound {b_bwd:.4f} {by_bwd}, "
                f"{b_bwd / backward:.1%}), SDPA backward "
                f"through autograd library_ms {library:.4f} ({backward / library:.2f}x) [{card}]"
            )
            if (any(not (e <= t) for e, t in errors.values()) or not padded_zero or not identical
                    or not (delta_err <= delta_tol)):
                raise AssertionError(f"flash backward disagrees at {name} {dtype}: {errors}, delta "
                                     f"{delta_err}, identical {identical}")
            if eager or launches != (1, 1):
                raise AssertionError(f"the flash backward ran {eager} and launched {launches} besides dq, dk/dv")
            if name == "a_125m_s1024" and dtype == torch.bfloat16:
                common = dict(library_ms=library, backward_ms=backward, backward_bound_ms=b_bwd)
                records = (
                    dict(max_abs_err=errors["dq/plain"][0], ms=ms_dq, plain_ms=plain_dq, bound_ms=b_dq,
                         bound_by=by_dq, **common),
                    dict(max_abs_err=max(errors["dk/plain"][0], errors["dv/plain"][0]), ms=ms_dkv,
                         plain_ms=plain_dkv, bound_ms=b_dkv, bound_by=by_dkv, **common),
                )
            del c, dq_args, dkv_args, ref_args, q, k, v, do, out, lse, delta, want_delta, dq, dk, dv
            torch.cuda.empty_cache()
    return records


ADAMW_LR = 3e-4


def phase_adamw(card: str) -> dict:
    """The adamw kernel over llama-125m's 12 leaves, 5 steps, bit-equal to
    its plain version; timed for one optimizer step (12 launches) beside its
    bound and torch.optim.AdamW(fused=True) over the same leaves."""
    rng = torch.Generator(device="cuda").manual_seed(SEED + 12)
    model = Llama("llama-125m", dtype=torch.float32, seed=SEED)
    leaves = [p.detach().clone() for p in tree_leaves(model.param_tree())]
    del model
    n = sum(p.numel() for p in leaves)
    hp = fused_adamw(ADAMW_LR).hyperparams
    state = {"kernel": [[p.clone(), torch.zeros_like(p), torch.zeros_like(p)] for p in leaves],
             "plain": [[p.clone(), torch.zeros_like(p), torch.zeros_like(p)] for p in leaves]}
    grads = None
    for step in range(1, 6):
        grads = [torch.randn(p.shape, generator=rng, device="cuda") * 1e-2 for p in leaves]
        bc = bias_corrections(hp, torch.tensor(step, dtype=torch.int32, device="cuda"))
        for (p, mu, nu), g in zip(state["kernel"], grads):
            adamw_leaf(p, mu, nu, g, bc, hp)
        for i, g in enumerate(grads):
            state["plain"][i] = list(adamw_leaf_reference(*state["plain"][i], g, bc, hp))
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for x, y in zip(state["kernel"], state["plain"]) for a, b in zip(x, y))
    err = max(float((a - b).abs().max().item()) for x, y in zip(state["kernel"], state["plain"]) for a, b in zip(x, y))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    bc = bias_corrections(hp, torch.tensor(6, dtype=torch.int32, device="cuda"))

    def kernel_step():
        for (p, mu, nu), g in zip(state["kernel"], grads):
            adamw_leaf(p, mu, nu, g, bc, hp)

    def plain_step():
        for (p, mu, nu), g in zip(state["plain"], grads):
            adamw_leaf_reference(p, mu, nu, g, bc, hp)

    ms = time_ms(kernel_step, flush, iters=20)
    plain = time_ms(plain_step, flush, iters=10)
    params = [torch.nn.Parameter(p) for p, _, _ in state["plain"]]
    for p, g in zip(params, grads):
        p.grad = g
    library_opt = torch.optim.AdamW(params, lr=ADAMW_LR, weight_decay=hp.weight_decay, fused=True)
    library = time_ms(library_opt.step, flush, iters=20)
    bound = 7 * 4 * n / HBM_BYTES_PER_S * 1e3  # p, mu, nu, g read; p, mu, nu written
    print(
        f"[adamw] llama-125m, {len(leaves)} leaves, {n} params, 5 steps: kernel == plain bit for bit: "
        f"{equal} (max abs diff {err:.3e}); one step ({len(leaves)} launches) {ms:.4f} ms, plain "
        f"{plain:.4f} ms, torch.optim.AdamW(fused=True) library_ms {library:.4f}, bound {bound:.4f} ms "
        f"(bytes), achieved {bound / ms:.1%} of bound [{card}]"
    )
    if not equal:
        raise AssertionError(f"adamw kernel differs from its plain version by up to {err}")
    del state, grads, params, library_opt
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by="bytes",
                library_ms=library)


def reset_training_state() -> None:
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def train_setup(name, mixed_precision, tx, flash_min_seq=1024):
    """A seeded fp32 model prepared behind a fresh Accelerator."""
    reset_training_state()
    accelerator = Accelerator(
        mixed_precision=mixed_precision,
        compilation_config=CompilationConfig(flash_attention_min_seq=flash_min_seq),
    )
    model = Llama(name, dtype=torch.float32, seed=SEED)
    accelerator.prepare_model(model)
    accelerator.prepare_optimizer(tx)
    return accelerator, model


def random_batch(rng, batch, seq, vocab) -> dict:
    return {"input_ids": torch.tensor(rng.integers(0, vocab, (batch, seq)).astype(np.int32), device="cuda")}


def phase_training(card: str) -> tuple[dict, float]:
    """llama-125m bf16 training through the entry points at the two bench
    shapes; returns the launch counts and the step p50 (seconds) of the
    B=32, S=1024 run."""
    main_counts, main_p50 = None, None
    for batch_size, seq in ((32, 1024), (8, 4096)):
        accelerator, model = train_setup("llama-125m", "bf16", fused_adamw(ADAMW_LR))
        layers = model.config.num_layers
        step = accelerator.compiled_step(Llama.loss_fn(model))
        batch = random_batch(np.random.default_rng(SEED + 13), batch_size, seq, model.config.vocab_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times, losses = [], []
        for i in range(13):
            t0 = time.perf_counter()
            losses.append(step(batch))
            torch.cuda.synchronize()
            if i >= 3:
                times.append(time.perf_counter() - t0)
        counts = launch_counts()
        steps = 13
        p50 = float(np.median(times))
        flops = train_flops_per_step(model.config, batch_size, seq)
        losses = [float(x) for x in losses]
        print(
            f"[train] llama-125m bf16 fused_adamw B={batch_size} S={seq}: step p50 {p50 * 1e3:.3f} ms "
            f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) over 10 steps after 3 warm-up, "
            f"{batch_size * seq / p50:.1f} tokens/s, MFU {flops / p50 / PEAK_FLOPS[torch.bfloat16]:.4f} "
            f"({flops:.3e} flops a step at 989 TFLOP/s), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; launches {counts} over {steps} steps [{card}]"
        )
        want = {"flash_fwd": layers * steps, "flash_dq": layers * steps, "flash_dkv": layers * steps,
                "fused_adamw": 12 * steps}
        for key, n in want.items():
            if counts[key] != n:
                raise AssertionError(f"{key}: {counts[key]} launches, expected {n}")
        if any(counts[key] for key in ("paged_decode", "paged_verify", "quant_matmul")):
            raise AssertionError(f"training launched serving kernels: {counts}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite training loss: {losses}")
        if (batch_size, seq) == (32, 1024):
            main_counts, main_p50 = counts, p50
        profile_train_step(step, batch, card, f"B={batch_size} S={seq}")
        del accelerator, model, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    return main_counts, main_p50


def profile_train_step(step, batch, card: str, tag: str, steps: int = 2) -> None:
    """Where a training step's time goes: ``steps`` steps under
    torch.profiler, device events only."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, steps, f"llama-125m bf16 training step, {tag}", card)


def plain_attention_of(causal: bool):
    """The flash dispatch's function by the kernels' plain forward, with
    autograd through it (no kernel)."""

    def attention(q, k, v, kv_mask=None):
        mask = None if kv_mask is None else fa._mask_limit(kv_mask)[0]
        return fa.flash_forward_reference(q, k, v, mask, causal, 1.0 / math.sqrt(q.shape[-1]))[0]

    return attention


plain_attention = plain_attention_of(causal=True)


def phase_training_parity(card: str) -> None:
    """fp32, B=2, S=1024: 3 steps through the kernels against 3 steps with
    the plain attention and the plain adamw passed in explicitly, from the
    same seeded weights; then bf16 on a 64-token sub-vocabulary, whose loss
    must fall by at least 1 nat in 20 steps at lr 1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 14)
    batch = random_batch(rng, 2, 1024, 32000)
    losses = {}
    for kind in ("kernels", "plain"):
        if kind == "kernels":
            accelerator, model = train_setup("llama-125m", "no", fused_adamw(ADAMW_LR))
        else:
            accelerator, model = train_setup("llama-125m", "no", adamw(ADAMW_LR), flash_min_seq=0)
            model.attention_fn = plain_attention
        step = accelerator.compiled_step(Llama.loss_fn(model))
        reset_launches()
        losses[kind] = [float(step(batch)) for _ in range(3)]
        counts = launch_counts()
        expected = 0 if kind == "plain" else 3 * model.config.num_layers
        if counts["flash_fwd"] != expected or (kind == "plain" and any(counts.values())):
            raise AssertionError(f"{kind} fp32 run launched {counts}")
        del accelerator, model, step
        gc.collect()
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernels"], losses["plain"]))
    print(f"[train-parity] llama-125m fp32 B=2 S=1024, 3 steps: kernels {losses['kernels']} vs plain "
          f"{losses['plain']}: max relative difference {rel:.3e} (tolerance 1e-4) [{card}]")
    if not (rel <= 1e-4):
        raise AssertionError("fp32 kernel steps differ from the plain steps")

    accelerator, model = train_setup("llama-125m", "bf16", fused_adamw(1e-3))
    step = accelerator.compiled_step(Llama.loss_fn(model))
    sub_vocab = rng.choice(32000, size=64, replace=False)
    batch = {"input_ids": torch.tensor(sub_vocab[rng.integers(0, 64, (8, 1024))].astype(np.int32), device="cuda")}
    curve = [float(step(batch)) for _ in range(20)]
    print(f"[train-learn] llama-125m bf16 B=8 S=1024, 64-token sub-vocabulary, lr 1e-3: loss "
          f"{curve[0]:.4f} -> {curve[-1]:.4f} over 20 steps (needs a fall of 1 nat; log 64 = "
          f"{math.log(64):.4f}); curve {[round(x, 3) for x in curve]} [{card}]")
    if not (curve[0] - curve[-1] >= 1.0):
        raise AssertionError("the loss did not fall by 1 nat on the sub-vocabulary batch")
    del accelerator, model, step
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 14: the training loop ------------------------------------------------

LOOP_ROWS, LOOP_TOKENS = 264, 1025  # a row: 1024 inputs and the 1024 next tokens
LOOP_BATCH, LOOP_ACCUM, LOOP_EPOCHS, LOOP_SEED = 16, 2, 2, 42
LOOP_SAVE_STEP = 5  # mid epoch 0: after micro-batch 10


class TokenRows:
    """A map-style dataset: row ``i`` of a token matrix as ``{"input_ids"}``."""

    def __init__(self, tokens: np.ndarray):
        self.tokens = tokens

    def __len__(self) -> int:
        return len(self.tokens)

    def __getitem__(self, i):
        return {"input_ids": self.tokens[i]}


def loop_schedule(count):
    """The schedule handed to ``prepare``: advisory, as in the JAX package
    when the transform holds none (``fused_adamw`` takes a scalar)."""
    return ADAMW_LR / (1 + 0.05 * count)


def next_token_loss(model):
    """Cross-entropy of rows of S+1 tokens: the model reads the first S and
    predicts the last S (``Llama.loss_fn`` would attend over all S+1)."""

    def fn(params, batch):
        ids = batch["input_ids"]
        logits = model.apply(params, ids[:, :-1])
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, ids[:, 1:].long()[..., None]).mean()

    return fn


def loop_setup(dataset, prefetch: int):
    """A fresh Accelerator and the four prepared objects of the loop. The
    loader keeps the last batch of an epoch short (``even_batches=False``:
    the JAX package's shard pads it to a full batch by repeating its rows
    even at one process)."""
    reset_training_state()
    accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=LOOP_ACCUM)
    loader = accelerator.prepare_data_loader(dataset, batch_size=LOOP_BATCH, shuffle=True, seed=LOOP_SEED,
                                             even_batches=False, prefetch=prefetch)
    model, optimizer, loader, scheduler = accelerator.prepare(
        Llama("llama-125m", dtype=torch.float32, seed=SEED), fused_adamw(ADAMW_LR), loader, loop_schedule)
    return accelerator, model, optimizer, loader, scheduler


def loop_indices(epochs: int) -> list[torch.Tensor]:
    """The rows each micro-batch must hold: the sampler's batches, epoch by
    epoch, as index tensors on the card."""
    sampler = BatchSampler(SeedableRandomSampler(LOOP_ROWS, seed=LOOP_SEED), LOOP_BATCH)
    out = []
    for epoch in range(epochs):
        sampler.set_epoch(epoch)
        out += [torch.tensor(b, device="cuda") for b in sampler]
    return out


def train_loop(accelerator, model, optimizer, loader, scheduler, rows, indices, step=0, manager=None,
               resume=None, kill_at=None) -> dict:
    """The loop a user writes: ``accumulate`` -> ``backward`` -> ``step`` ->
    ``scheduler.step`` -> ``zero_grad``, over ``LOOP_EPOCHS``. Returns the
    loss of each optimizer step (the mean of its micro-batches), the step
    reached, the seconds of each save, the seconds of each step (host clock
    from the end of the previous step, loader included, to a synchronize
    after it) and the count of batch elements that differ from the
    sampler's rows (counted on the card). ``kill_at`` sends SIGTERM before
    that micro-batch of the run."""
    loss_fn = next_token_loss(model.module)
    losses, window, saves, times, seen = [], [], [], [], 0
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    last = time.perf_counter()
    for epoch in range(resume.epoch if resume else 0, LOOP_EPOCHS):
        loader.set_epoch(epoch)
        epoch_loader = manager.resumed_loader(loader, resume, epoch) if manager else loader
        offset = epoch * math.ceil(LOOP_ROWS / LOOP_BATCH) + (epoch_loader.position if resume else 0)
        for i, batch in enumerate(epoch_loader):
            if kill_at is not None and seen == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)  # the handler only sets a flag
            seen += 1
            bad += (batch["input_ids"] != rows[indices[offset + i]]).sum()
            with accelerator.accumulate(model):
                window.append(accelerator.backward(loss_fn, batch))
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad()
            if not accelerator.sync_gradients:
                continue
            step += 1
            losses.append(torch.stack(window).mean())
            window = []
            torch.cuda.synchronize()
            times.append(time.perf_counter() - last)
            if manager is not None and manager.should_save(step):
                t0 = time.perf_counter()
                manager.save(step, epoch=epoch)
                saves.append(time.perf_counter() - t0)
            last = time.perf_counter()
            if manager is not None and manager.exit_requested:
                break
        if manager is not None and manager.exit_requested:
            break
        resume = None
    return dict(losses=[float(x) for x in losses], step=step, saves=saves, times=times, bad=int(bad))


def fake_checkpoint(base: str, step: int, damaged: bool = False) -> None:
    """A small committed checkpoint (a manifest over one file), or, with
    ``damaged``, one whose file no longer matches its manifest."""
    path = os.path.join(base, f"checkpoint_{step}")
    os.makedirs(path)
    with open(os.path.join(path, "note.txt"), "w") as f:
        f.write(f"step {step}\n")
    write_manifest(path, build_manifest(path, step=step, metadata={"step": step}))
    if damaged:
        with open(os.path.join(path, "note.txt"), "a") as f:
            f.write("torn\n")


def loop_profile(accelerator, model, optimizer, loader, scheduler, card: str, p50: float) -> None:
    """Two optimizer steps through the loader under torch.profiler, tracing
    the device only (as ``profile_train_step`` does: host tracing slows the
    host and with it the wall time): the device's busy share of the profiled
    wall time and of the unprofiled step p50, and where the host-to-device
    copies ran (their stream, and whether kernels of another stream ran
    while they did)."""
    loss_fn = next_token_loss(model.module)
    loader.set_epoch(LOOP_EPOCHS)
    batches = iter(loader)
    for _ in range(2):  # the prefetch queue fills before the window
        next(batches)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2 * LOOP_ACCUM):
            batch = next(batches)
            with accelerator.accumulate(model):
                accelerator.backward(loss_fn, batch)
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    batches.close()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy, end = 0.0, -math.inf
    for start, stop in spans:  # the union of device activity
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    kernels = [e for e in device if e["cat"] == "kernel"]
    compute = {e["args"].get("stream") for e in kernels}
    h2d = [e for e in device if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    under = sum(
        any(k["args"].get("stream") != c["args"].get("stream") and k["ts"] < c["ts"] + c["dur"]
            and c["ts"] < k["ts"] + k["dur"] for k in kernels)
        for c in h2d
    )
    streams = sorted({c["args"].get("stream") for c in h2d} - {None})
    print(f"[loop-profile] llama-125m bf16 loop, 2 optimizer steps ({2 * LOOP_ACCUM} micro-batches of "
          f"{LOOP_BATCH}x{LOOP_TOKENS - 1} through the loader, prefetch=2): wall {wall_us / 2e3:.3f} ms/step under the "
          f"profiler (device tracing only), device busy {busy / 2e3:.3f} ms/step ({busy / wall_us:.1%} of that wall, "
          f"{busy / 2e3 / (p50 * 1e3):.1%} of the unprofiled step p50 {p50 * 1e3:.3f} ms; union of "
          f"kernels and copies); {len(h2d)} host-to-device copies on stream(s) {streams} (compute "
          f"kernels on {sorted(compute - {None})}), {under} of them while a kernel of another stream "
          f"ran [{card}]")


def loop_spread_gate(dataset, rows, indices, losses_a, params_a, losses_c, params_c, start, card) -> None:
    """Where run C is not bit-equal to run A: run A once more. Bit-equal
    uninterrupted runs make C's difference a fault of the resume; otherwise
    C must stay within the spread of the two uninterrupted runs."""
    accelerator, model, optimizer, loader, scheduler = loop_setup(dataset, prefetch=2)
    losses_a2 = train_loop(accelerator, model, optimizer, loader, scheduler, rows, indices)["losses"]
    params_a2 = tree_leaves(model.params)
    spread = (max(abs(a - b) for a, b in zip(losses_a, losses_a2)),
              max(float((a - b).abs().max()) for a, b in zip(params_a, params_a2)))
    off = (max(abs(a - c) for a, c in zip(losses_a[start:], losses_c)),
           max(float((a - c).abs().max()) for a, c in zip(params_a, params_c)))
    print(f"[loop-resume] run C differs from run A by {off[0]:.3e} in loss and {off[1]:.3e} in params; two "
          f"uninterrupted runs differ by {spread[0]:.3e} and {spread[1]:.3e} [{card}]")
    if spread == (0.0, 0.0) or off[0] > spread[0] or off[1] > spread[1]:
        raise AssertionError("the resumed run is outside the spread of two uninterrupted runs")


def phase_loop(card: str, compiled_p50: float) -> dict:
    """llama-125m bf16 through ``prepare(model, fused_adamw, loader,
    schedule)`` and the user's loop, 2 epochs of 17 micro-batches (the last
    of 8 rows closes its window through the end-of-dataloader branch): 18
    optimizer steps. Run A runs uninterrupted; run B (prefetch=0) takes a
    SIGTERM mid step 5 and saves once at its boundary under
    ``CheckpointManager``; run C resumes from a fresh Accelerator with
    ``resume("auto")`` past a torn staging directory and a damaged
    checkpoint, and trains to step 18. Returns run A's launch counts."""
    rng = np.random.default_rng(SEED + 15)
    tokens = rng.integers(0, get_config("llama-125m").vocab_size, (LOOP_ROWS, LOOP_TOKENS)).astype(np.int32)
    dataset = TokenRows(tokens)
    rows = torch.from_numpy(tokens).cuda()
    indices = loop_indices(LOOP_EPOCHS)
    micro = len(indices)
    steps = LOOP_EPOCHS * math.ceil(math.ceil(LOOP_ROWS / LOOP_BATCH) / LOOP_ACCUM)

    # run A: uninterrupted, timed by optimizer step
    accelerator, model, optimizer, loader, scheduler = loop_setup(dataset, prefetch=2)
    layers = model.module.config.num_layers
    leaves = len(tree_leaves(model.params))
    reset_launches()
    run_a = train_loop(accelerator, model, optimizer, loader, scheduler, rows, indices)
    counts = launch_counts()
    losses_a, reached, timer = run_a["losses"], run_a["step"], run_a["times"]
    params_a = [p.detach().clone() for p in tree_leaves(model.params)]
    p50 = float(np.median(timer[2:]))
    lr = scheduler.get_last_lr()[0]
    print(f"[loop] llama-125m bf16, prepare(model, fused_adamw({ADAMW_LR}), loader, schedule), "
          f"{micro} micro-batches of {LOOP_BATCH}x{LOOP_TOKENS - 1} (the last of each epoch "
          f"{LOOP_ROWS % LOOP_BATCH} rows) in {reached} optimizer steps (accumulation {LOOP_ACCUM}); "
          f"losses {losses_a[0]:.4f} -> {losses_a[-1]:.4f}; step p50 {p50 * 1e3:.3f} ms through the "
          f"loader (min {min(timer[2:]) * 1e3:.3f}, max {max(timer[2:]) * 1e3:.3f}, steps 3-{reached}, "
          f"the epoch's short last step included) against phase 13's compiled_step p50 "
          f"{compiled_p50 * 1e3:.3f} ms at B=32 S=1024; scheduler counter {scheduler.step_count}, "
          f"get_last_lr {lr:.6e} (advisory) beside the applied lr {ADAMW_LR:.6e}; launches {counts} [{card}]")
    want = {"flash_fwd": layers * micro, "flash_dq": layers * micro, "flash_dkv": layers * micro,
            "fused_adamw": leaves * steps}
    for key, n in want.items():
        if counts[key] != n:
            raise AssertionError(f"loop {key}: {counts[key]} launches, expected {n}")
    if any(counts[key] for key in ("paged_decode", "paged_verify", "quant_matmul")):
        raise AssertionError(f"the training loop launched serving kernels: {counts}")
    # adjust_scheduler (the default) ticks the counter on every micro-batch
    if reached != steps or scheduler.step_count != micro or not all(map(math.isfinite, losses_a)):
        raise AssertionError(f"run A reached step {reached}, scheduler {scheduler.step_count}: {losses_a}")
    loop_profile(accelerator, model, optimizer, loader, scheduler, card, p50)
    del accelerator, model, optimizer, loader, scheduler
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as ckpt:
        # run B: prefetch off, SIGTERM before micro-batch 10, one boundary save
        fake_checkpoint(ckpt, 1)
        fake_checkpoint(ckpt, 3)
        accelerator, model, optimizer, loader, scheduler = loop_setup(dataset, prefetch=0)
        manager = accelerator.checkpoint_manager(ckpt, total_limit=2)
        try:
            run_b = train_loop(accelerator, model, optimizer, loader, scheduler, rows, indices, manager=manager,
                               kill_at=LOOP_SAVE_STEP * LOOP_ACCUM - 1)
            exited = manager.exit_requested
        finally:
            manager.restore_signal_handlers()
        losses_b, stopped, saves = run_b["losses"], run_b["step"], run_b["saves"]
        kept = sorted(os.listdir(ckpt))
        saved = os.path.join(ckpt, f"checkpoint_{LOOP_SAVE_STEP}")
        nbytes = sum(os.path.getsize(os.path.join(saved, n)) for n in os.listdir(saved))
        weights = sorted(n for n in os.listdir(saved) if n.startswith("model_"))
        t1 = time.perf_counter()
        problems = verify_checkpoint(saved)
        verify_s = time.perf_counter() - t1
        print(f"[loop-ckpt] run B (prefetch=0): SIGTERM before micro-batch {LOOP_SAVE_STEP * LOOP_ACCUM}, "
              f"stopped at step {stopped} with {len(saves)} save(s), exit_requested {exited}; kept {kept} "
              f"(total_limit 2); checkpoint {nbytes} bytes ({nbytes / 2**30:.3f} GiB) saved in "
              f"{saves[0] if saves else float('nan'):.3f} s, weights as {weights} (safetensors installed: "
              f"{has_safetensors()}); verify {verify_s:.3f} s, "
              f"problems {problems}; losses 1-{stopped} equal run A's bit for bit: "
              f"{losses_b == losses_a[:stopped]} [{card}]")
        if not (stopped == LOOP_SAVE_STEP and len(saves) == 1 and exited):
            raise AssertionError(f"preemption: stopped at {stopped} with {len(saves)} saves, exit {exited}")
        if kept != ["checkpoint_3", f"checkpoint_{LOOP_SAVE_STEP}"] or problems:
            raise AssertionError(f"rotation or manifest: kept {kept}, problems {problems}")
        if losses_b != losses_a[:stopped]:
            raise AssertionError(f"prefetch=0 losses {losses_b} differ from run A's {losses_a[:stopped]}")
        del accelerator, model, optimizer, loader, scheduler, manager
        gc.collect()
        torch.cuda.empty_cache()

        # run C: a fresh Accelerator resumes past a torn and a damaged checkpoint
        os.makedirs(os.path.join(ckpt, "checkpoint_9.tmp"))
        with open(os.path.join(ckpt, "checkpoint_9.tmp", "model_0.safetensors"), "wb") as f:
            f.write(b"torn")
        fake_checkpoint(ckpt, 7, damaged=True)
        accelerator, model, optimizer, loader, scheduler = loop_setup(dataset, prefetch=2)
        manager = accelerator.checkpoint_manager(ckpt, handle_signals=())
        t1 = time.perf_counter()
        resume = manager.resume("auto")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        run_c = train_loop(accelerator, model, optimizer, loader, scheduler, rows, indices, step=resume.step,
                           manager=manager, resume=resume)
        losses_c, reached_c = run_c["losses"], run_c["step"]
        params_c = tree_leaves(model.params)
        equal = losses_c == losses_a[resume.step:] and all(torch.equal(a, c) for a, c in zip(params_a, params_c))
        print(f"[loop-resume] run C: resume('auto') -> {os.path.basename(resume.path)} (step {resume.step}, "
              f"epoch {resume.epoch}, loaders {resume.dataloaders}) past checkpoint_9.tmp and a damaged "
              f"checkpoint_7, verify + load {load_s:.3f} s; trained steps {resume.step + 1}-{reached_c}; "
              f"losses and final params bit-equal to run A: {equal}; batch elements off their sampler rows: "
              f"A {run_a['bad']}, B {run_b['bad']}, C {run_c['bad']} [{card}]")
        if not resume.path.endswith(f"checkpoint_{LOOP_SAVE_STEP}") or resume.dataloaders != [
                {"epoch": 0, "position": LOOP_SAVE_STEP * LOOP_ACCUM}]:
            raise AssertionError(f"resume picked {resume}")
        if run_a["bad"] or run_b["bad"] or run_c["bad"]:
            raise AssertionError("a batch on the card differs from its sampler rows")
        if reached_c != steps:
            raise AssertionError(f"run C reached step {reached_c}")
        del accelerator, model, optimizer, loader, scheduler, manager
        gc.collect()
        torch.cuda.empty_cache()
        if not equal:
            loop_spread_gate(dataset, rows, indices, losses_a, params_a, losses_c, params_c, resume.step, card)
        del params_a, params_c
        gc.collect()
        torch.cuda.empty_cache()
    return counts


# -- phases 15-17: BERT, MoE and dropout, activation checkpointing -------------

BERT_LR = 2e-5
BERT_BATCH, BERT_SEQ = 32, 128  # the JAX bench's bert-base row (bench.py:254-299)
BERT_LEAVES = 25  # 5 embedding, 16 layer, 2 pooler and 2 classifier leaves


def bert_setup(mixed_precision, tx, flash_min_seq=1024, config="bert-base", remat_policy=None):
    """A seeded fp32 BERT prepared behind a fresh Accelerator."""
    reset_training_state()
    accelerator = Accelerator(
        mixed_precision=mixed_precision,
        compilation_config=CompilationConfig(flash_attention_min_seq=flash_min_seq, remat_policy=remat_policy),
    )
    cfg = get_config(config) if isinstance(config, str) else config
    model = Bert(cfg, dtype=torch.float32, seed=SEED)
    accelerator.prepare_model(model)
    accelerator.prepare_optimizer(tx)
    return accelerator, model


def bert_batch(rng, batch, seq, vocab, padded: bool) -> dict:
    """Random ids, two segments, labels; with ``padded`` a right padding of
    seeded lengths 16..seq (one row at full length)."""
    ids = rng.integers(0, vocab, (batch, seq))
    out = {"input_ids": torch.tensor(ids.astype(np.int32), device="cuda"),
           "token_type_ids": torch.tensor((np.arange(seq)[None, :] >= seq // 2).repeat(batch, 0).astype(np.int32),
                                          device="cuda"),
           "labels": torch.tensor(rng.integers(0, 2, (batch,)).astype(np.int32), device="cuda")}
    if padded:
        lengths = rng.integers(16, seq + 1, batch)
        lengths[0] = seq
        out["attention_mask"] = torch.tensor((np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32),
                                             device="cuda")
    return out


def timed_steps(step, batch, warmup: int, steps: int) -> tuple[list, list]:
    """(losses as device scalars, step seconds after ``warmup``): each step
    ends in a synchronize."""
    times, losses = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return losses, times


def phase_bert(card: str) -> dict:
    """bert-base at full width and depth, B=32 S=128 bf16: (a) the bench's
    setup (adamw, the einsum hook at S=128); (b) flash from 128 tokens,
    fused adamw, a padding mask, with launch counts; (c) fp32 B=2 kernels
    against plain versions; (d) the port's nlp_example for one epoch.
    Returns (b)'s launch counts."""
    cfg = get_config("bert-base")
    counted = None
    for tag, tx, min_seq, padded in (("a: adamw, einsum attention", adamw(BERT_LR), 1024, False),
                                     ("b: fused_adamw, flash from 128, padding mask", fused_adamw(BERT_LR), 128,
                                      True)):
        accelerator, model = bert_setup("bf16", tx, min_seq)
        step = accelerator.compiled_step(Bert.loss_fn(model))
        batch = bert_batch(np.random.default_rng(SEED + 15), BERT_BATCH, BERT_SEQ, cfg.vocab_size, padded)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, times = timed_steps(step, batch, 3, 10)
        counts = launch_counts()
        p50 = float(np.median(times))
        flops = train_flops_per_step(cfg, BERT_BATCH, BERT_SEQ)
        losses = [float(x) for x in losses]
        print(f"[bert] bert-base bf16 B={BERT_BATCH} S={BERT_SEQ} ({tag}): step p50 {p50 * 1e3:.3f} ms "
              f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) over 10 steps after 3 warm-up, "
              f"{1.0 / p50:.2f} steps/s, MFU {flops / p50 / PEAK_FLOPS[torch.bfloat16]:.4f} ({flops:.3e} flops "
              f"a step at 989 TFLOP/s), peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches {counts} over 13 steps [{card}]")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite bert loss: {losses}")
        if any(counts[key] for key in ("paged_decode", "paged_verify", "quant_matmul")):
            raise AssertionError(f"bert training launched serving kernels: {counts}")
        if padded:
            want = {"flash_fwd": 12 * 13, "flash_dq": 12 * 13, "flash_dkv": 12 * 13, "fused_adamw": BERT_LEAVES * 13}
            counted = counts
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(2):
                    step(batch)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            report_profile(prof, wall_us, 2, f"bert-base bf16 training step ({tag})", card)
        else:
            want = {key: 0 for key in WRAPPERS}
        for key, n in want.items():
            if counts[key] != n:
                raise AssertionError(f"{key}: {counts[key]} launches, expected {n}")
        del accelerator, model, step, batch
        gc.collect()
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    batch = bert_batch(np.random.default_rng(SEED + 16), 2, BERT_SEQ, cfg.vocab_size, padded=True)
    losses = {}
    for kind in ("kernels", "plain"):
        if kind == "kernels":
            accelerator, model = bert_setup("no", fused_adamw(BERT_LR), 128)
        else:
            accelerator, model = bert_setup("no", adamw(BERT_LR), 0)
            model.attention_fn = plain_attention_of(causal=False)
        step = accelerator.compiled_step(Bert.loss_fn(model))
        reset_launches()
        losses[kind] = [float(step(batch)) for _ in range(3)]
        counts = launch_counts()
        expected = 0 if kind == "plain" else 3 * cfg.num_layers
        if counts["flash_fwd"] != expected or (kind == "plain" and any(counts.values())):
            raise AssertionError(f"{kind} fp32 bert run launched {counts}")
        del accelerator, model, step
        gc.collect()
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernels"], losses["plain"]))
    print(f"[bert-parity] bert-base fp32 B=2 S=128, padding mask, 3 steps: kernels {losses['kernels']} vs "
          f"plain {losses['plain']}: max relative difference {rel:.3e} (tolerance 1e-4) [{card}]")
    if not (rel <= 1e-4):
        raise AssertionError("fp32 bert kernel steps differ from the plain steps")

    reset_training_state()
    metric = nlp_example.main(["--num_epochs", "1"])
    print(f"[bert-example] accelerate_tpu_torch.examples.nlp_example, 1 epoch on the card: {metric} [{card}]")
    if set(metric) != {"accuracy", "f1"}:
        raise AssertionError(f"nlp_example returned {metric}")
    return counted


def phase_moe_dropout(card: str) -> dict:
    """llama-moe-tiny (GQA 4/2, head dim 32) trains 5 bf16 steps at B=8
    S=256 through the flash kernels, the loss carrying the balance term;
    the same in fp32 against the plain versions; ``generate()`` of 8
    tokens; bert-base with dropout 0.1: two runs from one generator seed
    give equal losses. Returns the MoE run's launch counts."""
    moe_cfg = get_config("llama-moe-tiny")
    rng = np.random.default_rng(SEED + 17)
    batch = random_batch(rng, 8, 256, moe_cfg.vocab_size)
    accelerator, model = train_setup(moe_cfg, "bf16", fused_adamw(1e-3), flash_min_seq=256)
    step = accelerator.compiled_step(Llama.loss_fn(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [float(step(batch)) for _ in range(5)]
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        _, aux = model.apply(model.param_tree(), batch["input_ids"], return_aux=True)
    print(f"[moe] llama-moe-tiny bf16 B=8 S=256 (4 experts, top-2, capacity factor 2.0 -> "
          f"{8 * 256} slots an expert): losses {[round(x, 4) for x in losses]}, aux term after them "
          f"{float(aux):.5f}; peak memory {peak / 2**30:.3f} GiB; launches {counts} [{card}]")
    want = {"flash_fwd": 2 * 5, "flash_dq": 2 * 5, "flash_dkv": 2 * 5, "fused_adamw": 12 * 5}
    for key, n in want.items():
        if counts[key] != n:
            raise AssertionError(f"{key}: {counts[key]} launches, expected {n}")
    if not (losses[-1] < losses[0] and float(aux) > 0 and all(math.isfinite(x) for x in losses)):
        raise AssertionError("llama-moe-tiny did not learn, or its loss lacks the balance term")
    new = generate(model, np.asarray([[1, 2, 3]], np.int32), max_new_tokens=8)
    print(f"[moe] generate() on llama-moe-tiny: {new.tolist()} [{card}]")
    if new.shape != (1, 11):
        raise AssertionError(f"generate gave shape {new.shape}")
    del accelerator, model, step

    torch.backends.cuda.matmul.allow_tf32 = False
    parity = {}
    for kind in ("kernels", "plain"):
        if kind == "kernels":
            accelerator, model = train_setup(moe_cfg, "no", fused_adamw(1e-3), flash_min_seq=256)
        else:
            accelerator, model = train_setup(moe_cfg, "no", adamw(1e-3), flash_min_seq=0)
            model.attention_fn = plain_attention
        step = accelerator.compiled_step(Llama.loss_fn(model))
        reset_launches()
        parity[kind] = [float(step(batch)) for _ in range(3)]
        if kind == "plain" and any(launch_counts().values()):
            raise AssertionError(f"plain fp32 moe run launched {launch_counts()}")
        del accelerator, model, step
    rel = max(abs(a - b) / abs(b) for a, b in zip(parity["kernels"], parity["plain"]))
    print(f"[moe-parity] llama-moe-tiny fp32 B=8 S=256, 3 steps: kernels {parity['kernels']} vs plain "
          f"{parity['plain']}: max relative difference {rel:.3e} (tolerance 1e-4) [{card}]")
    if not (rel <= 1e-4):
        raise AssertionError("fp32 moe kernel steps differ from the plain steps")

    dropout_cfg = get_config("bert-base").replace(dropout_rate=0.1)
    batch = bert_batch(np.random.default_rng(SEED + 18), BERT_BATCH, BERT_SEQ, dropout_cfg.vocab_size, padded=True)
    runs = []
    for seed in (5, 5, 6):
        accelerator, model = bert_setup("bf16", fused_adamw(BERT_LR), 128, config=dropout_cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        step = accelerator.compiled_step(Bert.loss_fn(model, dropout_generator=gen))
        runs.append([float(step(batch)) for _ in range(2)])
        del accelerator, model, step
    print(f"[dropout] bert-base bf16 dropout 0.1, B=32 S=128, 2 steps: generator seed 5 {runs[0]}, again "
          f"{runs[1]}, seed 6 {runs[2]} [{card}]")
    if runs[0] != runs[1] or runs[0] == runs[2]:
        raise AssertionError("dropout runs from one generator seed differ, or runs from two seeds agree")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


REMAT_POLICIES = (None, "full", "save_flash")


def max_param_gap(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def phase_remat(card: str) -> None:
    """llama-125m B=32 S=1024 bf16 under remat None, "full" and
    "save_flash": step p50, peak memory and flash_fwd launches a step
    (12 / 24 / 12); then fp32 B=2: one step's params under each policy
    against no remat, and bert-base with dropout under "full": its grads
    against no remat (equal, or within the gap of two runs without remat)."""
    rng = np.random.default_rng(SEED + 19)
    batch = random_batch(rng, 32, 1024, 32000)
    for policy in REMAT_POLICIES:
        reset_training_state()
        accelerator = Accelerator(mixed_precision="bf16", compilation_config=CompilationConfig(
            flash_attention_min_seq=1024, remat_policy=policy))
        model = Llama("llama-125m", dtype=torch.float32, seed=SEED)
        accelerator.prepare_model(model)
        accelerator.prepare_optimizer(fused_adamw(ADAMW_LR))
        step = accelerator.compiled_step(Llama.loss_fn(model))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, times = timed_steps(step, batch, 3, 10)
        counts = launch_counts()
        p50 = float(np.median(times))
        print(f"[remat] llama-125m bf16 B=32 S=1024 remat_policy={policy!r}: step p50 {p50 * 1e3:.3f} ms "
              f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) over 10 steps after 3 warm-up, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, flash_fwd "
              f"{counts['flash_fwd'] / 13:.1f} launches a step (dq {counts['flash_dq'] / 13:.1f}, dkv "
              f"{counts['flash_dkv'] / 13:.1f}); losses {float(losses[0]):.4f} -> {float(losses[-1]):.4f} [{card}]")
        forwards = 24 if policy == "full" else 12
        if (counts["flash_fwd"], counts["flash_dq"], counts["flash_dkv"]) != (forwards * 13, 12 * 13, 12 * 13):
            raise AssertionError(f"remat_policy={policy!r}: launches {counts}")
        del accelerator, model, step
        gc.collect()
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    small = random_batch(rng, 2, 1024, 32000)
    params = {}
    for policy in (None, None) + REMAT_POLICIES[1:] + ("dots_with_no_batch_dims",):
        reset_training_state()
        accelerator = Accelerator(mixed_precision="no", compilation_config=CompilationConfig(
            flash_attention_min_seq=1024, remat_policy=policy))
        model = Llama("llama-125m", dtype=torch.float32, seed=SEED)
        prepared = accelerator.prepare_model(model)
        accelerator.prepare_optimizer(fused_adamw(ADAMW_LR))
        accelerator.compiled_step(Llama.loss_fn(model))(small)
        tree = {k: v.detach().clone() for k, v in flatten_tree(prepared.params)}
        params.setdefault(policy, []).append(tree)
        del accelerator, model, prepared
    spread = max_param_gap(params[None][0], params[None][1])
    gaps = {policy: max_param_gap(params[policy][0], params[None][0]) for policy in params if policy is not None}
    print(f"[remat-parity] llama-125m fp32 B=2 S=1024, one step: params' max gap to no remat {gaps} "
          f"(two runs without remat: {spread}) [{card}]")
    if any(gap > spread for gap in gaps.values()):
        raise AssertionError("a remat policy's step differs from the step without remat")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    dropout_cfg = get_config("bert-base").replace(dropout_rate=0.1)
    batch = bert_batch(np.random.default_rng(SEED + 20), 2, BERT_SEQ, dropout_cfg.vocab_size, padded=True)
    grads = {}
    for policy in (None, None, "full"):
        accelerator, model = bert_setup("no", fused_adamw(BERT_LR), 128, config=dropout_cfg, remat_policy=policy)
        gen = torch.Generator(device="cuda").manual_seed(21)
        accelerator.backward(Bert.loss_fn(model, dropout_generator=gen), batch)
        tree = {k: v.detach().clone() for k, v in flatten_tree(accelerator._optimizers[-1].grads)}
        grads.setdefault(policy, []).append(tree)
        del accelerator, model
    spread = max_param_gap(grads[None][0], grads[None][1])
    gap = max_param_gap(grads["full"][0], grads[None][0])
    print(f"[remat-parity] bert-base fp32 dropout 0.1 B=2 S=128 under 'full': grads' max gap to no remat "
          f"{gap} (two runs without remat: {spread}) [{card}]")
    if gap > spread:
        raise AssertionError("bert's grads under full remat differ from those without remat")
    del grads
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 18: two processes sharing the card over gloo --------------------------

PROBED = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor", "broadcast")
PAIR_BATCH, PAIR_SEQ = 16, 1024  # global: 8 rows a process
PAIR_STEPS, PAIR_TIMED, GATE_STEPS = 3, 4, 10
# the two-process losses against one process's at the same global batch:
# bf16 rounds every product to 8 bits (2^-8 = 3.9e-3 relative), and the
# halves' matmuls may tile otherwise than the whole batch's
PAIR_LOSS_RTOL = 5e-3
GLOO_TIMEOUT_S = 120


def gloo_on_card() -> dict:
    """Options of an Accelerator in one of two processes on cuda:0 over gloo
    (NCCL refuses two processes on one card)."""
    from datetime import timedelta

    return dict(device="cuda:0", kwargs_handlers=[
        InitProcessGroupKwargs("gloo", timeout=timedelta(seconds=GLOO_TIMEOUT_S))])


def probe_gloo_cuda() -> dict:
    """In each of two processes on cuda:0: which collectives gloo takes on
    CUDA tensors, with their values checked ("ok"), or its refusal."""
    import torch.distributed as dist

    reset_training_state()
    Accelerator(**gloo_on_card())
    rank = dist.get_rank()
    out = {"torch": torch.__version__}
    for name in PROBED:
        x = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * rank
        try:
            if name == "all_reduce":
                dist.all_reduce(x)
                got, want = x, [10.0, 12.0, 14.0, 16.0]
            elif name == "reduce_scatter_tensor":
                got = torch.empty(2, device="cuda")
                dist.reduce_scatter_tensor(got, x)
                want = [10.0, 12.0] if rank == 0 else [14.0, 16.0]
            elif name == "all_gather_into_tensor":
                got = torch.empty(8, device="cuda")
                dist.all_gather_into_tensor(got, x)
                want = [0.0, 1.0, 2.0, 3.0, 10.0, 11.0, 12.0, 13.0]
            else:
                dist.broadcast(x, src=1)
                got, want = x, [10.0, 11.0, 12.0, 13.0]
            out[name] = "ok" if got.tolist() == want else f"wrong values {got.tolist()}"
        except (RuntimeError, ValueError, NotImplementedError) as exc:  # the probe records a refusal
            out[name] = f"refused: {type(exc).__name__}: {str(exc).splitlines()[0]}"
    return out


def pair_batches() -> list:
    rng = np.random.default_rng(SEED + 18)
    return [rng.integers(0, 32000, (PAIR_BATCH, PAIR_SEQ)).astype(np.int32) for _ in range(PAIR_STEPS)]


def train_pair(zero: bool) -> dict:
    """In each of two processes on cuda:0: llama-125m bf16 under
    ParallelismConfig(fsdp=2) (the ZeRO update; with ``zero=False`` the
    replicated data-parallel update), 3 compiled steps on this process's half of each global
    batch (launches counted), then 4 timed steps."""
    import torch.distributed as dist

    reset_training_state()
    # the replicated update runs data-parallel: fsdp's gathers need the sharded collectives
    parallelism = ParallelismConfig(fsdp=2) if zero else ParallelismConfig(zero_stage=0)
    accelerator = Accelerator(mixed_precision="bf16", parallelism=parallelism,
                              compilation_config=CompilationConfig(flash_attention_min_seq=1024), **gloo_on_card())
    model = Llama("llama-125m", dtype=torch.float32, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    prepared = accelerator.prepare_model(model)
    optimizer = accelerator.prepare_optimizer(fused_adamw(ADAMW_LR))
    step = accelerator.compiled_step(Llama.loss_fn(model))
    rank, rows = dist.get_rank(), PAIR_BATCH // 2
    shares = [{"input_ids": torch.tensor(b[rank * rows:(rank + 1) * rows], device="cuda")} for b in pair_batches()]
    torch.cuda.synchronize()
    reset_launches()
    losses = [float(step(batch)) for batch in shares]
    torch.cuda.synchronize()
    counts = launch_counts()
    times = []
    for i in range(PAIR_TIMED):
        t0 = time.perf_counter()
        step(shares[i % PAIR_STEPS])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    leaves = tree_leaves(prepared.params)
    return {
        "rank": rank, "losses": losses, "counts": counts, "times": times, "n_params": n_params,
        "shard_leaves": len(leaves),
        "stored_bytes": sum(p.numel() * p.element_size() for p in leaves),
        "state_bytes": sum(x.numel() * x.element_size() for x in state_leaves(optimizer.opt_state) if x.ndim),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def update_gate_pair() -> dict:
    """In each of two processes on cuda:0: the update-equivalence gate at
    llama-125m's full width: 10 eager updates of seeded CUDA gradients
    (each process its own draw) under the ZeRO update, then under the
    replicated one, params and optimizer state gathered; the largest gap."""
    import torch.distributed as dist

    sides = {}
    for zero_stage in (None, 0):
        reset_training_state()
        accelerator = Accelerator(parallelism=ParallelismConfig(zero_stage=zero_stage), **gloo_on_card())
        model = Llama("llama-125m", dtype=torch.float32, seed=SEED)
        shapes = {k: tuple(v.shape) for k, v in model.param_tree()["layers"].items()}
        full = {k: tuple(v.shape) for k, v in model.param_tree().items() if k != "layers"}
        prepared = accelerator.prepare_model(model)
        optimizer = accelerator.prepare_optimizer(fused_adamw(ADAMW_LR))
        gen = torch.Generator(device="cuda").manual_seed(1000 + dist.get_rank())
        draw = lambda shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
        t0 = time.perf_counter()
        for _ in range(GATE_STEPS):
            grads = {k: draw(s) for k, s in full.items()}
            grads["layers"] = {k: draw(s) for k, s in shapes.items()}
            optimizer.accumulate_grads(grads)
            optimizer.step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        state_bytes = sum(x.numel() * x.element_size() for x in state_leaves(optimizer.opt_state) if x.ndim)
        sides[zero_stage] = (tree_leaves(prepared.full_params()),
                             state_leaves(optimizer.state_dict()["opt_state"]), state_bytes, seconds)
    (p_a, s_a, bytes_a, sec_a), (p_b, s_b, bytes_b, sec_b) = sides[None], sides[0]
    with torch.no_grad():
        gap = max(float((a - b).abs().max()) for a, b in zip(p_a + s_a, p_b + s_b))
    return {"gap": gap, "state_bytes": (bytes_a, bytes_b), "seconds": (sec_a, sec_b)}


def pair_job(zero: bool) -> dict:
    out = {"train": train_pair(zero)}
    if zero:
        out["gate"] = update_gate_pair()
    return out


def phase_pair(card: str) -> None:
    """(a) the gloo probe in two processes on the card; (b) llama-125m
    through the ZeRO update (or, where gloo refuses a CUDA reduce-scatter or
    all-gather, the replicated update) in two processes sharing cuda:0, held
    against one process's steps on the same global batch, and the
    update-equivalence gate at full width."""
    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.parallel.zero import zero_update_state_bytes

    probes = debug_launcher(probe_gloo_cuda, num_processes=2, timeout=3 * GLOO_TIMEOUT_S)
    print(f"[pair] gloo on CUDA tensors, two processes on cuda:0 (torch {probes[0]['torch']}): "
          + ", ".join(f"{name}: {probes[0][name]}" for name in PROBED) + f" [{card}]")
    if probes[0] != probes[1]:
        raise AssertionError(f"the two processes probed differently: {probes}")
    sharded = all(probes[0][name] == "ok" for name in ("reduce_scatter_tensor", "all_gather_into_tensor"))
    if not (probes[0]["all_reduce"] == "ok" and probes[0]["broadcast"] == "ok"):
        raise AssertionError("gloo refuses the replicated update's collectives on CUDA tensors")
    ranks = debug_launcher(pair_job, (sharded,), num_processes=2, timeout=600)
    update = "ZeRO sharded" if sharded else "replicated (gloo refused a CUDA reduce-scatter or all-gather)"
    layers = 12
    for out in ranks:
        got = out["train"]
        p50 = float(np.median(got["times"]))
        print(f"[pair] rank {got['rank']}: llama-125m bf16 fused_adamw B={PAIR_BATCH // 2} of {PAIR_BATCH} "
              f"S={PAIR_SEQ}, {'ParallelismConfig(fsdp=2)' if sharded else 'ParallelismConfig(zero_stage=0)'}, "
              f"{update} update: losses "
              f"{[round(x, 6) for x in got['losses']]}; launches {got['counts']} over {PAIR_STEPS} steps "
              f"({got['shard_leaves']} shard leaves); step p50 {p50 * 1e3:.3f} ms (min "
              f"{min(got['times']) * 1e3:.3f}, max {max(got['times']) * 1e3:.3f}) over {PAIR_TIMED} steps: gloo "
              f"stages every collective through the host, so this says nothing of NCCL; peak memory "
              f"{got['peak_gib']:.3f} GiB [{card}]")
        want = {"flash_fwd": layers * PAIR_STEPS, "flash_dq": layers * PAIR_STEPS, "flash_dkv": layers * PAIR_STEPS,
                "fused_adamw": got["shard_leaves"] * PAIR_STEPS}
        for key, n in want.items():
            if got["counts"][key] != n:
                raise AssertionError(f"rank {got['rank']} {key}: {got['counts'][key]} launches, expected {n}")
    if ranks[0]["train"]["losses"] != ranks[1]["train"]["losses"]:
        raise AssertionError("the two processes report different global losses")
    n_params = ranks[0]["train"]["n_params"]
    per_rank, _ = zero_update_state_bytes(n_params, 4, 2 if sharded else 1)
    replicated, _ = zero_update_state_bytes(n_params, 4, 1)
    held = ranks[0]["train"]["stored_bytes"] + ranks[0]["train"]["state_bytes"]
    print(f"[pair] optimizer state and fp32 masters a process: {held} bytes, zero_update_state_bytes "
          f"{per_rank} ({'1/2 of ' if sharded else ''}the replicated layout's {replicated}) [{card}]")
    if held != per_rank:
        raise AssertionError(f"a process holds {held} bytes of masters and state, expected {per_rank}")

    reset_training_state()
    accelerator, model = train_setup("llama-125m", "bf16", fused_adamw(ADAMW_LR))
    step = accelerator.compiled_step(Llama.loss_fn(model))
    single = [float(step({"input_ids": torch.tensor(b, device="cuda")})) for b in pair_batches()]
    pair = ranks[0]["train"]["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(pair, single)]
    print(f"[pair] one process on the whole batch: losses {[round(x, 6) for x in single]}; relative gaps "
          f"{[f'{g:.3e}' for g in gaps]} (tolerance {PAIR_LOSS_RTOL}) [{card}]")
    if max(gaps) > PAIR_LOSS_RTOL:
        raise AssertionError("the two processes' losses differ from one process's")
    del accelerator, model, step
    gc.collect()
    torch.cuda.empty_cache()
    reset_training_state()
    if not sharded:
        print("[pair] update gate not run: gloo refused a sharded collective on CUDA tensors; the sharded "
              "step's card run waits for a two-card machine (NCCL)")
        return
    gate = ranks[0]["gate"]
    print(f"[pair] update gate, llama-125m full width, {GATE_STEPS} eager updates of seeded gradients: "
          f"sharded vs replicated max gap {gate['gap']} (tolerance 0); optimizer state a process "
          f"{gate['state_bytes'][0]} vs {gate['state_bytes'][1]} bytes; {gate['seconds'][0]:.3f} s vs "
          f"{gate['seconds'][1]:.3f} s over gloo [{card}]")
    if any(out["gate"]["gap"] != 0.0 for out in ranks):
        raise AssertionError("the sharded update differs from the replicated one")


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
    timed("phase 4b llama-tiny serving (head dim 32)", phase_tiny_serving, card)
    records["paged_verify"] = timed("phase 5 verify kernel", phase_verify_kernel, card)
    launches["paged_verify"] = timed("phase 6 speculative serving", phase_spec_serving, card)
    timed("phase 7 speculative parity", phase_spec_parity, card, model, prompts, rows, gaps)
    del model
    torch.cuda.empty_cache()
    records["quant_matmul"] = timed("phase 8 quant kernel", phase_quant_kernel, card)
    launches["quant_matmul"] = timed("phase 9 quantized serving", phase_quant_serving, card, prompts)
    del prompts, rows, gaps
    gc.collect()
    torch.cuda.empty_cache()  # the serving models are freed before training starts
    records["flash_fwd"] = timed("phase 10 flash forward kernel", phase_flash_forward, card)
    records["flash_dq"], records["flash_dkv"] = timed(
        "phase 11 flash backward kernels", phase_flash_backward, card)
    records["fused_adamw"] = timed("phase 12 adamw kernel", phase_adamw, card)
    _, compiled_p50 = timed("phase 13 training", phase_training, card)
    timed("phase 13 training parity and learning", phase_training_parity, card)
    counts = timed("phase 14 the training loop", phase_loop, card, compiled_p50)
    for name in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
        launches[name] = counts[name]
    timed("phase 15 bert", phase_bert, card)
    timed("phase 16 mixture of experts and dropout", phase_moe_dropout, card)
    timed("phase 17 activation checkpointing", phase_remat, card)
    timed("phase 18 two processes on the card over gloo", phase_pair, card)
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
