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
    (b) runs the replicated data-parallel update and the gate is skipped;
19. T5: t5-base at full width and depth (12 + 12 layers, random weights
    from seed 0 by ``build_model``) in bf16 over fp32 masters through
    ``Accelerator`` -> ``prepare_model`` -> ``prepare_optimizer(
    fused_adamw(1e-4))`` -> ``compiled_step(T5.loss_fn)`` with flash from
    128 tokens, B=32, 512 encoder and 128 decoder tokens under a seeded
    right padding on both sides: step p50 over 10 steps after 3 warm-up,
    positions/s and real tokens/s, MFU (each weight counted at the
    positions it multiplies, and by ``train_flops_per_step``), peak memory,
    launches a step (each flash kernel 36, 24 of them the bias variant;
    adamw 26) and one profiled step; then fp32 B=2: one backward's 26
    gradients through the kernels, no further from the plain flash's than
    the einsum path's are (t5-base's saturated softmaxes at init move
    gradients by percents with the order of fp32 sums), and the same with
    every ``wq`` leaf scaled by 1/8 (a well-conditioned point) within 1e-3 of
    the plain flash's, and 3 steps at lr 2e-5 within 1e-4 relative; then a
    64-token sub-vocabulary batch whose loss must fall by 1 nat in 20 steps;
20. the flash kernels' ring-block variants (global offsets; dq with the
    lse cotangent) on one card: every (q chunk, kv chunk) block of a causal
    ring of 4 at llama-125m's attention (B=8, chunks of 2048, 12 heads of
    64, bf16: diagonal, past and future blocks), every block of phase
    21's ring of 2 (B=4, chunks of 4096), then a seeded padding, a
    non-causal ring, GQA at head dim 32 and at 128, and fp32: forward, dq
    and dk/dv under random cotangents for out and lse against their plain
    versions, two launches bit-identical, future blocks exactly 0 with lse
    below -1e28; the blocks merged against the kernels without offsets at
    S=8192, forward and gradients; each kind of block timed beside its
    bound, its plain version and SDPA with the block's offset mask (a
    yardstick: SDPA returns no lse and takes no dlse);
21. ring attention across two processes sharing the card over gloo,
    started by ``debug_launcher``: a point-to-point probe (``isend``/
    ``irecv`` and ``batch_isend_irecv`` on host tensors, the ring's hop of a
    CUDA tensor, staged through the host on a gloo group), then llama-125m
    at full width and depth, bf16 over fp32 masters, ``fused_adamw(3e-4)``,
    under ``ParallelismConfig(sequence=2)``: global batch 4 at S=8192 (4 x
    4096 tokens a process), 3 ``compiled_step``s whose losses both
    processes report alike and that lie within 5e-3 and within 1e-4
    relative of one process's steps on the whole batch, after the first
    batch's gradients, each leaf within 5e-2 of one process's (norm of the
    gap over the leaf's norm; ``chip_ring_gate.py`` holds both gates
    against a faulty ring); launches a process (each flash
    kernel's ring variant 12 layers x 2 blocks a step), step times (gloo
    stages every hop and collective through the host) and peak memory a
    process against the one process's.

Phase 10b, run after phase 11: the bias variants of the three flash
kernels at t5-base's encoder attention (B=32, S=T=512, 12 heads of 64,
non-causal, seeded padding 256-512, broadcast fp32 bias) and decoder
self-attention (S=T=128, causal), and with a batched bias, bf16 and fp32:
forward, dq with dbias and dk/dv against their plain versions, two
launches bit-identical (dbias included), each kernel timed beside its
bound and plain version, and SDPA with the bias and mask penalty as a float
``attn_mask`` (forward, and the whole backward with the bias's gradient).

22. gpt2-1.5b at full width and depth (48 layers, H=1600, 25 heads of 64
    with no grouped K/V, vocab 50257, random weights from seed 0) behind
    ``ServingEngine`` in bf16, phase 3's traffic with 64-token prefill
    chunks (decode launches = layers x decode forwards; step p50/p99,
    tokens/s, TTFT, peak memory); in fp32 its tokens against
    ``generate()`` up to near-ties; the decode and verify kernels at its
    heads (8 slots of up to 1000 positions) against their plain versions;
23. gpt2-1.5b speculative with gpt2-124m drafts (k=4, linear): fp32
    tokens against the plain engine's, bf16 traffic through the verify
    kernel with accepted drafts reported; int8-resident gpt2-1.5b through
    ``dispatch_model`` and ``from_streamed`` (4 projections x layers x
    forwards launches of the dequant-matmul, biases and positions in
    bf16) in bf16, then fp32 int8 tokens against ``generate()`` over the
    dequantized weights; the dequant-matmul at gpt2-1.5b's four
    projection shapes (K = 1600 and 6400), M = 8 and 64, int8 and int4,
    bf16 and fp32;
24. gpt2-124m training at full width and depth: bf16 over fp32 masters,
    flash from 128, ``fused_adamw(3e-4)``, B=16 S=1024 (step p50, tokens/s,
    MFU by ``train_flops_per_step``, peak memory, launches: 12 a step for
    each flash kernel, 16 for adamw); fp32 B=2, 3 steps through the
    kernels within 1e-4 relative of the plain versions';
25. the engine's new surface on gpt2-124m in fp32: quarantine (NaN in a
    live slot's pages, the freed pages read back exactly 0, the request
    requeued and finished with ``generate()``'s tokens), the watchdog at a
    tiny ``step_timeout_s``, the dense ``paged=False`` slab against the
    paged engine, and a KV handoff between two engines on the card;
26. big-model inference: phase 3's llama-1b weights (full width, 22
    layers) written as an HF-layout checkpoint (fp32, with its
    ``config.json``, read back by ``config_from_hf_json``) in a temporary
    directory; ``init_empty_weights`` allocating 0 bytes on the card;
    (a) ``load_checkpoint_and_dispatch`` with ``device_map="auto"`` under a
    ``max_memory`` that keeps 8 layers on the card, 7 in pinned host
    memory, 7 on disk; (b) the streamed 2 x 512 bf16 forward bit-equal to
    an all-device dispatch at the default window, at groups of one layer
    (a window under one layer) and one group of all 22, its wall time,
    bytes streamed and host-to-device GB/s beside a plain pinned copy of
    the same bytes (disk layers read page-cache warm), its peak memory
    within two groups plus the all-device forward's activations, its
    busy shares under ``torch.profiler``; (c) 16 streamed fp32 tokens
    against ``generate()`` over the resident model up to near-ties, and
    the bf16 streamed decode's ms a token beside its bytes over the pinned
    copy's rate; (d) ``ServingEngine.from_streamed`` of the disk-backed
    model with phase 3's traffic, tokens equal to phase 3's, decode
    launches = layers x decode forwards, then an int8
    ``load_and_quantize_model`` under its own auto map through
    ``from_streamed`` (dequant-matmul launches = 7 x layers x forwards);
    (e) bert-base under ``cpu_offload`` bit-equal to its all-device
    dispatch, t5-base's ``Seq2SeqStreamedModel.generate`` in fp32 equal to
    the all-device dispatch's, and two llama-125m under
    ``cpu_offload_with_hook`` taking turns, the card's allocated memory
    back at its baseline after each ``offload()``.

The JSON line's launch counts of the four training kernels are phase 14's
run A, the ring variants' phase 21's rank 0; phases 15-18 print their own. The line before the last is a JSON
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
    GPT2,
    T5,
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
    make_auto_attention,
    make_layered_device_map,
    paged_decode_attention,
    paged_verify_attention,
    quant_dot,
    quant_matmul,
)
from accelerate_tpu_torch.big_modeling import (
    StreamedModel,
    cpu_offload,
    cpu_offload_with_hook,
    init_empty_weights,
    load_and_quantize_model,
    load_checkpoint_and_dispatch,
)
from accelerate_tpu_torch.checkpointing import _save_flat, has_safetensors
from accelerate_tpu_torch.data_loader import BatchSampler, SeedableRandomSampler
from accelerate_tpu_torch.examples import nlp_example
from accelerate_tpu_torch.fault_tolerance import build_manifest, verify_checkpoint, write_manifest
from accelerate_tpu_torch.models import build_model, train_flops_per_step
from accelerate_tpu_torch.models.config import config_from_hf_json
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.ops.fused_adamw import adamw_leaf, adamw_leaf_reference, bias_corrections
from accelerate_tpu_torch.ops.quant_matmul import quant_matmul_reference
from accelerate_tpu_torch.ops.runtime import build_kernel, build_log
from accelerate_tpu_torch.serving.engine import params_from_streamed
from accelerate_tpu_torch.utils.hf_import import export_hf_llama
from accelerate_tpu_torch.utils.modeling import named_component_sizes
from accelerate_tpu_torch.utils.params import flatten_tree, state_leaves, tree_leaves, tree_map
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
    # the ring-block variants (has_offsets; dq with the lse cotangent): the same sources
    "flash_fwd_ring": ("accelerate_tpu_torch/csrc/flash_fwd.cu",
                       "accelerate_tpu/ops/flash_attention.py:143"),  # _fwd_kernel
    "flash_dq_ring": ("accelerate_tpu_torch/csrc/flash_bwd.cu",
                      "accelerate_tpu/ops/flash_attention.py:279"),  # _bwd_dq_kernel
    "flash_dkv_ring": ("accelerate_tpu_torch/csrc/flash_bwd.cu",
                       "accelerate_tpu/ops/flash_attention.py:352"),  # _bwd_dkv_kernel
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
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def reset_launches() -> None:
    """Every kernel's count to 0, just before a path is driven (the flash
    wrappers' counts of bias and ring-block launches too)."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    for name in FLASH_KERNELS:
        WRAPPERS[name].bias_launches = WRAPPERS[name].ring_launches = 0


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
    int and bool template arguments (a bool as 0 or 1)."""
    for run in re.finditer(r"\d+", mangled):
        for k in range(len(run.group())):  # the length may follow other digits
            ident = mangled[run.end():run.end() + int(run.group()[k:])]
            if ident.endswith("_kernel") and ident.isidentifier():
                args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[run.end() + len(ident):])
                values = re.findall(r"L[ib](\d+)E", args.group(1)) if args else []
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


def phase_serving(card: str) -> tuple:
    """llama-1b bf16 behind the engine; returns the kernel launches and
    each request's generated tokens (phase 26 serves the same weights)."""
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
    return launches, [results[rid].generated for rid in ids]


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
    triangle (at a ring block's global offsets) and the mask as this run's
    data has them."""
    q, k = case["q"], case["k"]
    b, s, t = q.shape[0], q.shape[1], k.shape[1]
    q_off, k_off = case.get("offsets") or (0, 0)
    q_pos = q_off + torch.arange(s, device="cuda")[:, None]
    k_pos = k_off + torch.arange(t, device="cuda")[None, :]
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
    mask too, and a bias once where it is read (fp32), with dbias (as large)
    where it is written; a ring block's dq reads its lse cotangent rows
    too. A block with no attended pair (a ring block wholly in the future)
    needs only what it writes: fwd out and lse; dq dq and delta, from dO,
    out and dlse; dkv dk and dv; bwd dq, dk and dv."""
    q, k = case["q"], case["k"]
    esize = q.element_size()
    nq, nk = q.numel(), k.numel()
    rows = q.shape[0] * q.shape[2] * q.shape[1] * 4  # one fp32 [B, N, S] row set
    dlse = rows if case.get("dlse") else 0
    pairs = attended_pairs(case)
    mask = 0 if case["mask"] is None or pairs == 0 else case["mask"].numel() * 4 + case["limit"].numel() * 4
    bias = 0 if case.get("bias") is None else case["bias"].numel() * 4  # read once; dbias as big
    if pairs == 0:
        tensors = {"fwd": nq * esize + rows, "dq": 3 * nq * esize + rows + dlse, "dkv": 2 * nk * esize,
                   "bwd": (nq + 2 * nk) * esize}[kind]
    else:
        tensors = {"fwd": (2 * nq + 2 * nk) * esize + rows + bias,
                   "dq": (4 * nq + 2 * nk) * esize + 2 * rows + dlse + 2 * bias,
                   "dkv": (2 * nq + 4 * nk) * esize + 2 * rows + bias,
                   "bwd": (4 * nq + 4 * nk) * esize + rows + 2 * bias}[kind]
    products = {"fwd": 2, "dq": 3, "dkv": 4, "bwd": 5}[kind]
    flops = 2.0 * products * q.shape[3] * q.shape[2] * pairs
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


# -- phase 10b: the bias kernels -----------------------------------------------

BIAS_GEOMETRIES = {
    # name: (B, S, T, NH, KV, D, causal, (shortest, longest) key length, bias batched)
    "t5_base_encoder": (32, 512, 512, 12, 12, 64, False, (256, 512), False),
    "t5_base_decoder": (32, 128, 128, 12, 12, 64, True, (64, 128), False),
    "batched_encoder": (4, 512, 512, 12, 12, 64, False, (256, 512), True),
}


def bias_case(rng, geometry, dtype):
    """Inputs on the card, a seeded right padding of each row (row 0 at full
    length) and an fp32 bias [1|B, NH, S, T] of T5's scale (0.1)."""
    b, s, t, nh, kv, d, causal, (shortest, longest), batched = geometry
    case = flash_case(rng, (b, s, t, nh, kv, d, causal, False), dtype)
    lengths = rng.integers(shortest, longest + 1, b)
    lengths[0] = t
    case["kv_mask"] = torch.tensor((np.arange(t)[None, :] < lengths[:, None]).astype(np.int32), device="cuda")
    case["mask"], case["limit"] = fa._mask_limit(case["kv_mask"])
    case["bias"] = torch.tensor(rng.standard_normal((b if batched else 1, nh, s, t), dtype=np.float32) * 0.1,
                                device="cuda")
    case["scale"] = 1.0  # T5's
    return case


def sdpa_bias_inputs(case, requires_grad=False):
    """[B, N, S, D] copies and a bias leaf for SDPA, and its float mask: the
    bias plus the key penalty (and NEG_INF past the causal limit), in q's
    dtype as SDPA takes it."""
    qh, kh, vh = (case[n].transpose(1, 2).contiguous().requires_grad_(requires_grad) for n in "qkv")
    bias = case["bias"].detach().clone().requires_grad_(requires_grad)
    s, t = qh.shape[2], kh.shape[2]
    penalty = (case["kv_mask"].float()[:, None, None, :] - 1.0) * 1e30
    if case["causal"]:
        penalty = penalty + torch.ones((s, t), device="cuda").triu(1)[None, None] * -1e30
    mask = (bias + penalty).to(qh.dtype)
    return qh, kh, vh, bias, mask


def phase_flash_bias(card: str) -> dict:
    """The bias variants of the three flash kernels at t5-base's attention
    (encoder: B=32, S=T=512, non-causal; decoder self-attention: S=T=128,
    causal; both under a seeded padding, broadcast bias) and with a batched
    bias: forward, dq with dbias and dk/dv against the plain versions, two
    launches bit-identical (dbias included), each kernel timed beside its
    bound and the plain version, and SDPA with the bias and the mask as a
    float ``attn_mask`` (forward, and the whole backward with the bias's
    gradient) as the yardstick. Returns the bf16 records by geometry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 20)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = {}
    for name, geometry in BIAS_GEOMETRIES.items():
        for dtype in (torch.bfloat16, torch.float32):
            c = bias_case(rng, geometry, dtype)
            q, k, v, do, mask, limit, bias = (c[n] for n in ("q", "k", "v", "do", "mask", "limit", "bias"))
            causal, scale = c["causal"], c["scale"]
            fwd_args = (q, k, v, mask, limit, causal, scale, bias)

            def run():
                out, lse = fa.flash_forward(*fwd_args)
                dq, delta, dbias = fa.flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal, scale, bias)
                dk, dv = fa.flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal, scale, bias)
                return dict(out=out, lse=lse, dq=dq, delta=delta, dbias=dbias, dk=dk, dv=dv)

            got, again = run(), run()
            identical = all(torch.equal(got[key], again[key]) for key in got)
            del again
            want_out, want_lse = fa.flash_forward_reference(q, k, v, mask, causal, scale, bias)
            torch.cuda.synchronize()
            errors = {"out": (float((got["out"].float() - want_out.float()).abs().max()), TOLERANCE[dtype]),
                      "lse": (float((got["lse"] - want_lse).abs().max()), 1e-4)}
            del want_out, want_lse
            want_delta = fa.flash_delta_reference(do, got["out"])
            delta_tol = 1e-4 * max(float(want_delta.abs().max()), 1.0)
            errors["delta"] = (float((got["delta"] - want_delta).abs().max()), delta_tol)
            ref_args = (q, k, v, mask, do, got["lse"], want_delta, causal, scale, bias)
            want = dict(zip(("dq", "dbias"), fa.flash_backward_dq_reference(*ref_args)))
            for key in ("dq", "dbias"):
                errors[key] = grad_error(got[key], want[key], dtype)
            del want
            want = dict(zip(("dk", "dv"), fa.flash_backward_dkv_reference(*ref_args)))
            for key in ("dk", "dv"):
                errors[key] = grad_error(got[key], want[key], dtype)
            del want
            torch.cuda.empty_cache()
            dq_args = (q, k, v, mask, limit, do, got["lse"], got["out"], causal, scale, bias)
            dkv_args = (q, k, v, mask, limit, do, got["lse"], got["delta"], causal, scale, bias)
            ms = {"fwd": time_ms(lambda: fa.flash_forward(*fwd_args), flush, iters=20),
                  "dq": time_ms(lambda: fa.flash_backward_dq(*dq_args), flush, iters=20),
                  "dkv": time_ms(lambda: fa.flash_backward_dkv(*dkv_args), flush, iters=20)}
            plain = {"fwd": time_ms(lambda: fa.flash_forward_reference(q, k, v, mask, causal, scale, bias),
                                    flush, iters=3),
                     "dq": time_ms(lambda: fa.flash_backward_dq_reference(*ref_args), flush, iters=3),
                     "dkv": time_ms(lambda: fa.flash_backward_dkv_reference(*ref_args), flush, iters=3)}
            bounds = {kind: flash_bound_ms(c, kind) for kind in ("fwd", "dq", "dkv", "bwd")}
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
            flash_out = fa.flash_attention_core(*leaves[:3], mask, limit, causal, scale, leaves[3])
            backward = time_ms(lambda: torch.autograd.grad(flash_out, leaves, do, retain_graph=True),
                               flush, iters=20)
            del leaves, flash_out
            qh, kh, vh, bias_leaf, sdpa_mask = sdpa_bias_inputs(c)
            library_fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=sdpa_mask, scale=scale),
                                  flush, iters=20)
            del qh, kh, vh, bias_leaf, sdpa_mask
            qh, kh, vh, bias_leaf, sdpa_mask = sdpa_bias_inputs(c, requires_grad=True)
            sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=sdpa_mask, scale=scale)
            do_h = do.transpose(1, 2).contiguous()
            library_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh, bias_leaf), do_h,
                                                              retain_graph=True), flush, iters=20)
            del qh, kh, vh, bias_leaf, sdpa_mask, sdpa_out, do_h
            worst = ", ".join(f"{key} {e:.3e} (tol {t:.1e})" for key, (e, t) in errors.items())
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            chunk = fa.dbias_chunk(q.shape[0], q.shape[2], q.shape[1], sms) if bias.shape[0] == 1 else 1
            timing = "; ".join(
                f"{kind} {ms[kind]:.4f} ms (plain {plain[kind]:.4f}, bound {bounds[kind][0]:.4f} {bounds[kind][1]}, "
                f"{bounds[kind][0] / ms[kind]:.1%})" for kind in ("fwd", "dq", "dkv"))
            print(f"[flash-bias] {name} {str(dtype).split('.')[-1]} (bias [{bias.shape[0]}, ...], {chunk} batch "
                  f"rows a dq block): {worst}; two launches bit-identical (dbias included): {identical}; "
                  f"{timing}; whole backward through autograd {backward:.4f} ms (bound {bounds['bwd'][0]:.4f} "
                  f"{bounds['bwd'][1]}); SDPA with the bias as a float mask: forward library_ms {library_fwd:.4f}, "
                  f"backward with dbias library_ms {library_bwd:.4f} [{card}]")
            if any(not (e <= t) for e, t in errors.values()) or not identical:
                raise AssertionError(f"the bias kernels disagree at {name} {dtype}: {errors}, identical {identical}")
            if dtype == torch.bfloat16:
                records[name] = {kind: dict(ms=ms[kind], plain_ms=plain[kind], bound_ms=bounds[kind][0],
                                            bound_by=bounds[kind][1]) for kind in ms}
                records[name]["library_ms"] = dict(fwd=library_fwd, bwd=library_bwd, flash_bwd=backward)
            del c, q, k, v, do, mask, limit, bias, got, ref_args, dq_args, dkv_args, fwd_args
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
    config = get_config(name) if isinstance(name, str) else name
    model = (GPT2 if config.arch == "gpt2" else Llama)(config, dtype=torch.float32, seed=SEED)
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


# -- phase 19: T5 ----------------------------------------------------------------

T5_BATCH, T5_ENC, T5_DEC = 32, 512, 128  # T5's input length; targets of 128
T5_LEAVES = 26  # embedding, 2 bias tables, 2 final norms, 8 encoder and 13 decoder leaves
T5_LEARN_LR = 3e-3
# the well-conditioned point of phase 19's fp32 gradient check: wq scaled by 1/8, where the
# two packages' fp32 einsum gradients differ by 5.8e-4 of a leaf's largest (t5-base on the CPU)
T5_WQ_SCALE, T5_SCALED_TOL = 0.125, 1e-3


def t5_grads(model, hook, batch) -> tuple:
    """One fp32 backward of T5's loss with ``hook`` as the attention: the
    loss, every leaf's gradient, the dq launches."""
    model.attention_fn = hook
    leaves = {k: p.detach().clone().requires_grad_() for k, p in flatten_tree(model.param_tree())}
    params = {"encoder": {}, "layers": {}}
    for key, leaf in leaves.items():
        group, _, name = key.rpartition(".")
        (params[group] if group else params)[name] = leaf
    reset_launches()
    loss = T5.loss_fn(model)(params, batch)
    loss.backward()
    return float(loss.detach()), {k: leaf.grad for k, leaf in leaves.items()}, launch_counts()["flash_dq"]


def t5_setup(mixed_precision, tx, flash_min_seq=128, config="t5-base"):
    """A seeded fp32 T5 (``build_model``) prepared behind a fresh Accelerator."""
    reset_training_state()
    accelerator = Accelerator(
        mixed_precision=mixed_precision,
        compilation_config=CompilationConfig(flash_attention_min_seq=flash_min_seq),
    )
    model = build_model(config, dtype=torch.float32, seed=SEED)
    accelerator.prepare_model(model)
    accelerator.prepare_optimizer(tx)
    return accelerator, model


def t5_batch(rng, batch, vocab, sub_vocab=None) -> dict:
    """Encoder ids and labels (from ``sub_vocab`` when given) with a seeded
    right padding on both sides: encoder lengths 128-512, decoder 32-128,
    row 0 at full length."""
    ids = rng.integers(0, vocab, (batch, T5_ENC))
    labels = rng.integers(0, vocab, (batch, T5_DEC))
    if sub_vocab is not None:
        ids, labels = sub_vocab[ids % len(sub_vocab)], sub_vocab[labels % len(sub_vocab)]
    enc_len = rng.integers(128, T5_ENC + 1, batch)
    dec_len = rng.integers(32, T5_DEC + 1, batch)
    enc_len[0], dec_len[0] = T5_ENC, T5_DEC
    return {
        "input_ids": torch.tensor(ids.astype(np.int32), device="cuda"),
        "labels": torch.tensor(labels.astype(np.int32), device="cuda"),
        "attention_mask": torch.tensor((np.arange(T5_ENC)[None] < enc_len[:, None]).astype(np.int32), device="cuda"),
        "decoder_attention_mask": torch.tensor((np.arange(T5_DEC)[None] < dec_len[:, None]).astype(np.int32),
                                               device="cuda"),
    }


def t5_train_flops(cfg, batch: int, enc: int, dec: int) -> float:
    """Training flops of one T5 step (6 per parameter a token, as
    ``train_flops_per_token``, and 12·H·S a layer a token for the attention
    products), each weight counted at the positions it multiplies: the
    encoder's at the encoder's, the decoder's self attention, cross q and o,
    feed-forward and the tied head at the decoder's, the cross k and v at
    the encoder's; attention products: encoder self over S_enc, decoder self
    over S_dec, cross over S_enc."""
    h, i, L, v = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    inner = cfg.num_heads * cfg.dim_per_head
    te, td = batch * enc, batch * dec
    dense = 6.0 * L * ((4 * h * inner + 2 * h * i) * te + (6 * h * inner + 2 * h * i) * td + 2 * h * inner * te)
    head = 6.0 * v * h * td
    attention = 12.0 * L * h * (enc * te + dec * td + enc * td)
    return dense + head + attention


def plain_t5_attention(q, k, v, kv_mask=None, bias=None, scale=None, causal=None):
    """The flash dispatch's function by the kernels' plain forward, bias and
    all, with autograd through it (no kernel)."""
    mask = None if kv_mask is None else fa._mask_limit(kv_mask)[0]
    return fa.flash_forward_reference(q, k, v, mask, causal, scale, bias)[0]


plain_t5_attention.supports_bias = True


def phase_t5(card: str) -> None:
    """t5-base at full width and depth in bf16 over fp32 masters through
    ``Accelerator`` -> ``prepare_model`` -> ``prepare_optimizer(
    fused_adamw(1e-4))`` -> ``compiled_step(T5.loss_fn)`` with flash from
    128 tokens: B=32, 512 encoder and 128 decoder tokens, padded on both
    sides; step p50 over 10 steps after 3 warm-up, tokens/s, MFU, peak
    memory, launches a step (each flash kernel 36, 24 of them the bias
    variant; adamw 26) and one profiled step. Then fp32 B=2: one backward's
    26 gradients through the kernels, the plain flash and the einsum path
    (the kernels no further from the plain flash than the einsum path is),
    and 3 steps through the kernels against 3 through the plain versions;
    and bf16 B=8 on a 64-token sub-vocabulary, whose loss must fall by 1
    nat in 20 steps."""
    accelerator, model = t5_setup("bf16", fused_adamw(1e-4))
    cfg = model.config
    step = accelerator.compiled_step(T5.loss_fn(model))
    rng = np.random.default_rng(SEED + 19)
    batch = t5_batch(rng, T5_BATCH, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = timed_steps(step, batch, 3, 10)
    counts = launch_counts()
    bias_counts = {name: WRAPPERS[name].bias_launches for name in FLASH_KERNELS}
    p50 = float(np.median(times))
    flops = t5_train_flops(cfg, T5_BATCH, T5_ENC, T5_DEC)
    formula = train_flops_per_step(cfg, T5_BATCH, T5_ENC)
    positions = T5_BATCH * (T5_ENC + T5_DEC)
    real = int(batch["attention_mask"].sum()) + int(batch["decoder_attention_mask"].sum())
    losses = [float(x) for x in losses]
    print(f"[t5] t5-base bf16 fused_adamw B={T5_BATCH} S_enc={T5_ENC} S_dec={T5_DEC}: step p50 {p50 * 1e3:.3f} ms "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) over 10 steps after 3 warm-up, "
          f"{positions / p50:.1f} positions/s ({real / p50:.1f} real tokens/s, encoder and decoder), MFU "
          f"{flops / p50 / PEAK_FLOPS[torch.bfloat16]:.4f} ({flops:.3e} flops a step, each weight at the positions "
          f"it multiplies; train_flops_per_step at the encoder's length, every weight at every encoder position: "
          f"{formula:.3e}, MFU {formula / p50 / PEAK_FLOPS[torch.bfloat16]:.4f}; 989 TFLOP/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"launches {counts}, of them with a bias {bias_counts}, over 13 steps [{card}]")
    layers = cfg.num_layers
    want = {"flash_fwd": 3 * layers * 13, "flash_dq": 3 * layers * 13, "flash_dkv": 3 * layers * 13,
            "fused_adamw": T5_LEAVES * 13}
    for key, n in want.items():
        if counts[key] != n:
            raise AssertionError(f"{key}: {counts[key]} launches, expected {n}")
    if any(n != 2 * layers * 13 for n in bias_counts.values()):
        raise AssertionError(f"bias launches {bias_counts}, expected {2 * layers * 13} each")
    if any(counts[key] for key in ("paged_decode", "paged_verify", "quant_matmul")):
        raise AssertionError(f"t5 training launched serving kernels: {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite t5 loss: {losses}")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, 1, "t5-base bf16 training step", card)
    del accelerator, model, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    batch = t5_batch(np.random.default_rng(SEED + 21), 2, cfg.vocab_size)
    model = build_model("t5-base", dtype=torch.float32, seed=SEED)
    hooks = {"kernels": make_auto_attention(128), "plain": plain_t5_attention, "einsum": None}
    grads = {kind: t5_grads(model, hook, batch) for kind, hook in hooks.items()}

    def worst_gap(a, b, grads=grads):  # the largest gap of a leaf's gradients, over that leaf's largest magnitude
        gaps = {k: float((grads[a][1][k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                for k, g in grads[b][1].items()}
        return max(gaps.items(), key=lambda kv: kv[1])

    kernel_gap, plain_gap = worst_gap("kernels", "plain"), worst_gap("einsum", "plain")
    print(f"[t5-parity] t5-base fp32 B=2, one backward of all 26 leaves: loss kernels {grads['kernels'][0]!r}, "
          f"plain flash {grads['plain'][0]!r}, einsum {grads['einsum'][0]!r}; worst gradient gap kernels vs plain "
          f"{kernel_gap[1]:.3e} ({kernel_gap[0]}), einsum vs plain {plain_gap[1]:.3e} ({plain_gap[0]}), each of "
          f"the leaf's largest magnitude (the gate: the kernels no further from the plain version than the "
          f"einsum path is, or 1e-4); dq launches {grads['kernels'][2]}, {grads['plain'][2]}, {grads['einsum'][2]} "
          f"[{card}]")
    if (grads["kernels"][2] != 3 * layers or grads["plain"][2] or grads["einsum"][2]
            or not (kernel_gap[1] <= max(1e-4, plain_gap[1]))):
        raise AssertionError(f"t5 gradients through the kernels: {kernel_gap}, the plain paths' spread {plain_gap}")
    # the same at a well-conditioned point, where that spread does not hide a fault: every wq
    # leaf scaled by 1/8 (the softmaxes no longer saturate), the kernels against the plain flash
    # at a fixed tolerance
    with torch.no_grad():
        for key, leaf in flatten_tree(model.param_tree()):
            if key.endswith("wq"):
                leaf.mul_(T5_WQ_SCALE)
    scaled = {kind: t5_grads(model, hooks[kind], batch) for kind in ("kernels", "plain")}
    scaled_gap = worst_gap("kernels", "plain", scaled)
    print(f"[t5-parity] t5-base fp32 B=2, every wq leaf scaled by {T5_WQ_SCALE}: worst gradient gap kernels vs "
          f"plain flash {scaled_gap[1]:.3e} ({scaled_gap[0]}) of the leaf's largest magnitude (tolerance "
          f"{T5_SCALED_TOL:.0e}) [{card}]")
    if not (scaled_gap[1] <= T5_SCALED_TOL):
        raise AssertionError(f"t5 gradients through the kernels at the scaled point: {scaled_gap}")
    del model, grads, scaled
    gc.collect()
    torch.cuda.empty_cache()
    # Adam's first steps move a weight by about lr whatever its gradient's size, and t5-base's
    # gradients at init move by percents with the order of fp32 sums (above): at lr 1e-4 the
    # third losses differed by 1.27e-4 relative, the first equal in every printed digit. So the
    # steps take bert's lr, as phase 15(c)
    parity = {}
    for kind in ("kernels", "plain"):
        if kind == "kernels":
            accelerator, model = t5_setup("no", fused_adamw(BERT_LR))
        else:
            accelerator, model = t5_setup("no", adamw(BERT_LR), flash_min_seq=0)
            model.attention_fn = plain_t5_attention
        step = accelerator.compiled_step(T5.loss_fn(model))
        reset_launches()
        parity[kind] = [float(step(batch)) for _ in range(3)]
        counts = launch_counts()
        expected = 0 if kind == "plain" else 3 * 3 * layers
        if counts["flash_fwd"] != expected or (kind == "plain" and any(counts.values())):
            raise AssertionError(f"{kind} fp32 t5 run launched {counts}")
        del accelerator, model, step
        gc.collect()
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(parity["kernels"], parity["plain"]))
    print(f"[t5-parity] t5-base fp32 B=2 S_enc={T5_ENC} S_dec={T5_DEC}, padded, lr {BERT_LR}, 3 steps: kernels "
          f"{parity['kernels']} vs plain {parity['plain']}: max relative difference {rel:.3e} (tolerance 1e-4) "
          f"[{card}]")
    if not (rel <= 1e-4):
        raise AssertionError("fp32 t5 kernel steps differ from the plain steps")

    # the tied head's logits start small (the d_model^-0.5 scale): at lr 1e-3 the loss fell
    # 0.517 nat in 20 steps, evenly
    accelerator, model = t5_setup("bf16", fused_adamw(T5_LEARN_LR))
    step = accelerator.compiled_step(T5.loss_fn(model))
    rng = np.random.default_rng(SEED + 22)
    batch = t5_batch(rng, 8, cfg.vocab_size, sub_vocab=rng.choice(cfg.vocab_size, size=64, replace=False))
    curve = [float(step(batch)) for _ in range(20)]
    print(f"[t5-learn] t5-base bf16 B=8, 64-token sub-vocabulary, lr {T5_LEARN_LR}: loss {curve[0]:.4f} -> "
          f"{curve[-1]:.4f} "
          f"over 20 steps (needs a fall of 1 nat); curve {[round(x, 3) for x in curve]} [{card}]")
    if not (curve[0] - curve[-1] >= 1.0):
        raise AssertionError("the t5 loss did not fall by 1 nat on the sub-vocabulary batch")
    del accelerator, model, step, batch
    gc.collect()
    torch.cuda.empty_cache()

# -- phase 20: the ring blocks ------------------------------------------------------

RING_BATCH, RING_CHUNKS, RING_CHUNK = 8, 4, 2048  # llama-125m's attention, a causal ring of 4
RING_EXTRA = {
    # name: (B, chunks, chunk, NH, KV, D, causal, padded, dtype, (q chunk, kv chunk) pairs)
    # phase 21's blocks: llama-125m at B=4, a causal ring of 2 over S=8192
    "ring-of-2": (4, 2, 4096, 12, 12, 64, True, False, torch.bfloat16, ((0, 0), (0, 1), (1, 0), (1, 1))),
    "padded": (8, 4, 2048, 12, 12, 64, True, True, torch.bfloat16, ((2, 2), (3, 1), (1, 3))),
    "bidirectional": (8, 2, 2048, 12, 12, 64, False, False, torch.bfloat16, ((0, 1), (1, 0))),
    "gqa4x2_d32": (4, 4, 1024, 4, 2, 32, True, False, torch.bfloat16, ((1, 1), (2, 0), (0, 3))),
    "gqa16x8_d128": (2, 4, 1024, 16, 8, 128, True, True, torch.bfloat16, ((1, 1), (3, 0), (0, 2))),
    "fp32": (2, 4, 1024, 12, 12, 64, True, False, torch.float32, ((1, 1), (2, 1), (1, 2))),
}
RING_KINDS = {"diagonal": (2, 2), "past": (2, 0), "future": (0, 2)}  # the timed blocks


def ring_inputs(rng, b, chunks, chunk, nh, kv, d, dtype, padded):
    """The whole sequence's q, k, v, dO, an lse cotangent and (padded) a
    [B, S] key validity of seeded lengths (one row fully padded), on the
    card; a block takes its chunks."""
    s = chunks * chunk
    f = lambda *shape: torch.tensor(rng.standard_normal(shape, dtype=np.float32), device="cuda").to(dtype)  # noqa: E731
    out = dict(q=f(b, s, nh, d), k=f(b, s, kv, d), v=f(b, s, kv, d), do=f(b, s, nh, d),
               dlse=torch.tensor(rng.standard_normal((b, nh, s), dtype=np.float32), device="cuda"),
               valid=None, chunk=chunk, scale=1.0 / math.sqrt(d))
    if padded:
        lengths = rng.integers(s // 3, s, b)
        lengths[-1] = 0
        out["valid"] = torch.tensor((np.arange(s)[None, :] < lengths[:, None]).astype(np.int32), device="cuda")
    return out


def ring_block(inputs, i, j, causal):
    """Block (q chunk i, kv chunk j) as phase 11's case dict, with its
    offsets (None for a non-causal ring) and lse cotangent."""
    n = inputs["chunk"]
    qs, ks = slice(i * n, (i + 1) * n), slice(j * n, (j + 1) * n)
    c = dict(q=inputs["q"][:, qs].contiguous(), k=inputs["k"][:, ks].contiguous(),
             v=inputs["v"][:, ks].contiguous(), do=inputs["do"][:, qs].contiguous(),
             dlse=inputs["dlse"][:, :, qs].contiguous(), causal=causal, scale=inputs["scale"],
             offsets=(i * n, j * n) if causal else None, kv_mask=None, mask=None, limit=None)
    if inputs["valid"] is not None:
        c["kv_mask"] = inputs["valid"][:, ks].contiguous()
        c["mask"], c["limit"] = fa._mask_limit(c["kv_mask"])
    return c


def ring_sdpa_mask(c):
    """The block's offset-causal mask (and key mask) as SDPA's boolean
    ``attn_mask`` [B, 1, S, T]: a yardstick only (SDPA returns no lse and
    takes no dlse)."""
    s, t = c["q"].shape[1], c["k"].shape[1]
    q_off, k_off = c["offsets"] or (0, 0)
    m = torch.ones((s, t), dtype=torch.bool, device="cuda")
    if c["causal"]:
        m = (k_off + torch.arange(t, device="cuda"))[None, :] <= (q_off + torch.arange(s, device="cuda"))[:, None]
    m = m[None, None]
    if c["kv_mask"] is not None:
        m = m & c["kv_mask"].bool()[:, None, None, :]
    return m


def check_ring_block(c, dtype) -> dict:
    """Forward, dq (with the lse cotangent) and dk/dv kernels of one block
    against their plain versions, two launches bit-identical, a block in
    the future exactly 0; the errors and outputs."""
    q, k, v, do, mask, limit = (c[n] for n in ("q", "k", "v", "do", "mask", "limit"))
    fwd = (q, k, v, mask, limit, c["causal"], c["scale"])
    out, lse = fa.flash_forward(*fwd, offsets=c["offsets"])
    again, lse_again = fa.flash_forward(*fwd, offsets=c["offsets"])
    dq_args = (q, k, v, mask, limit, do, lse, out, c["causal"], c["scale"])
    dq, delta = fa.flash_backward_dq(*dq_args, offsets=c["offsets"], dlse=c["dlse"])
    dq2, delta2 = fa.flash_backward_dq(*dq_args, offsets=c["offsets"], dlse=c["dlse"])
    dkv_args = (q, k, v, mask, limit, do, lse, delta, c["causal"], c["scale"])
    dk, dv = fa.flash_backward_dkv(*dkv_args, offsets=c["offsets"])
    dk2, dv2 = fa.flash_backward_dkv(*dkv_args, offsets=c["offsets"])
    identical = all(torch.equal(a, b) for a, b in ((out, again), (lse, lse_again), (dq, dq2), (delta, delta2),
                                                    (dk, dk2), (dv, dv2)))
    del again, lse_again, dq2, delta2, dk2, dv2
    want_out, want_lse = fa.flash_forward_reference(q, k, v, mask, c["causal"], c["scale"], offsets=c["offsets"])
    want_delta = fa.flash_delta_reference(do, out, c["dlse"])
    ref = (q, k, v, mask, do, lse, want_delta, c["causal"], c["scale"])
    want_dq = fa.flash_backward_dq_reference(*ref, offsets=c["offsets"])
    want_dk, want_dv = fa.flash_backward_dkv_reference(*ref, offsets=c["offsets"])
    torch.cuda.synchronize()
    errors = {"out": (float((out.float() - want_out.float()).abs().max()), TOLERANCE[dtype]),
              "lse": (float((lse - want_lse).abs().max()), 1e-4),
              "delta": (float((delta - want_delta).abs().max()),
                        1e-4 * max(float(want_delta.abs().max()), 1.0))}
    for key, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
        errors[key] = grad_error(got, want, dtype)
    q_off, k_off = c["offsets"] or (0, 0)
    future = c["causal"] and q_off + q.shape[1] - 1 < k_off
    exact = not future or (int(torch.count_nonzero(out)) == 0 and bool((lse < -1e28).all())
                           and all(int(torch.count_nonzero(x)) == 0 for x in (dq, dk, dv)))
    return dict(errors=errors, identical=identical, future=future, exact=exact)


def ring_block_times(c, flush) -> dict:
    """CUDA-event times of the three kernels on one block, their plain
    versions, bounds over the attended pairs, and SDPA with the block's
    mask (forward; the whole backward for dq and dk/dv)."""
    q, k, v, do, mask, limit = (c[n] for n in ("q", "k", "v", "do", "mask", "limit"))
    off, causal, scale = c["offsets"], c["causal"], c["scale"]
    out, lse = fa.flash_forward(q, k, v, mask, limit, causal, scale, offsets=off)
    dq_args = (q, k, v, mask, limit, do, lse, out, causal, scale)
    _, delta = fa.flash_backward_dq(*dq_args, offsets=off, dlse=c["dlse"])
    dkv_args = (q, k, v, mask, limit, do, lse, delta, causal, scale)
    ref = (q, k, v, mask, do, lse, delta, causal, scale)
    t = dict(
        fwd=time_ms(lambda: fa.flash_forward(q, k, v, mask, limit, causal, scale, offsets=off), flush, iters=20),
        dq=time_ms(lambda: fa.flash_backward_dq(*dq_args, offsets=off, dlse=c["dlse"]), flush, iters=20),
        dkv=time_ms(lambda: fa.flash_backward_dkv(*dkv_args, offsets=off), flush, iters=20),
        fwd_plain=time_ms(lambda: fa.flash_forward_reference(q, k, v, mask, causal, scale, offsets=off), flush,
                          iters=3),
        dq_plain=time_ms(lambda: fa.flash_backward_dq_reference(*ref, offsets=off), flush, iters=3),
        dkv_plain=time_ms(lambda: fa.flash_backward_dkv_reference(*ref, offsets=off), flush, iters=3),
    )
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    kw = dict(attn_mask=ring_sdpa_mask(c), enable_gqa=qh.shape[1] != kh.shape[1])
    t["fwd_library"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw), flush, iters=20)
    sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, **kw)
    do_h = do.transpose(1, 2).contiguous()
    t["bwd_library"] = time_ms(lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh), do_h, retain_graph=True),
                               flush, iters=20)
    case = dict(q=q, k=k, mask=mask, limit=limit, causal=causal, offsets=off, dlse=True)
    for kind in ("fwd", "dq", "dkv"):
        t[f"{kind}_bound"], t[f"{kind}_by"] = flash_bound_ms(case, kind)
    return t


def merged_ring_check(inputs, card: str) -> None:
    """The causal ring's blocks of every q chunk merged (the ring's own
    merge, one process playing every rank) against the kernels without
    offsets at the whole length: forward, and the q, k, v gradients under
    one cotangent."""
    from accelerate_tpu_torch.parallel.ring_attention import merge_block, merge_end, merge_start

    q, k, v, do = (inputs[n].detach().clone().requires_grad_(n != "do") for n in ("q", "k", "v", "do"))
    n, chunks = inputs["chunk"], q.shape[1] // inputs["chunk"]
    outs = []
    for i in range(chunks):
        qi = q[:, i * n:(i + 1) * n]
        o, m, l = merge_start(qi)
        for j in range(chunks):
            ks = slice(j * n, (j + 1) * n)
            o_blk, lse_blk = fa.flash_attention_block(qi, k[:, ks], v[:, ks], causal=True, q_offset=i * n,
                                                      kv_offset=j * n)
            o, m, l = merge_block(o, m, l, o_blk, lse_blk)
        outs.append(merge_end(o, l, q.dtype))
    merged = torch.cat(outs, dim=1)
    got = torch.autograd.grad(merged, (q, k, v), do)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    whole = fa.flash_attention(*leaves, causal=True)
    want = torch.autograd.grad(whole, leaves, do)
    out_err = float((merged.detach().float() - whole.detach().float()).abs().max())
    errors = {name: grad_error(a, b, q.dtype) for name, a, b in zip(("dq", "dk", "dv"), got, want)}
    print(f"[ring-block] {chunks} blocks of {n} merged vs flash_attention at S={q.shape[1]} (no offsets), "
          f"B={q.shape[0]}, {str(q.dtype).split('.')[-1]}: out {out_err:.3e} (tol {TOLERANCE[q.dtype]:.0e}); "
          + ", ".join(f"{key} {e:.3e} (tol {t:.1e})" for key, (e, t) in errors.items()) + f" [{card}]")
    if not (out_err <= TOLERANCE[q.dtype]) or any(not (e <= t) for e, t in errors.values()):
        raise AssertionError("the ring's merged blocks differ from flash attention over the whole sequence")


def phase_ring_blocks(card: str) -> dict:
    """The flash kernels' ring-block variants on one card: every (q chunk,
    kv chunk) block of a causal ring of 4 at llama-125m's attention (B=8,
    chunks of 2048, 12 heads of 64, bf16: diagonal, past and future
    blocks), every block of phase 21's ring of 2 (B=4, chunks of 4096),
    then a seeded padding, a non-causal ring, GQA at head dim 32 and at
    128, and fp32; forward, dq with an lse cotangent and dk/dv
    against their plain versions, two launches bit-identical, future blocks
    exactly 0; the blocks merged against the kernels without offsets at
    S=8192; each kind of block timed. Returns the JSON records (the
    diagonal block)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 20)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cases = [("llama-125m", (RING_BATCH, RING_CHUNKS, RING_CHUNK, 12, 12, 64, True, False, torch.bfloat16,
                             tuple((i, j) for i in range(RING_CHUNKS) for j in range(RING_CHUNKS))))]
    cases += list(RING_EXTRA.items())
    for name, (b, chunks, chunk, nh, kv, d, causal, padded, dtype, pairs) in cases:
        inputs = ring_inputs(rng, b, chunks, chunk, nh, kv, d, dtype, padded)
        worst, kinds = {}, {"diagonal": 0, "past": 0, "future": 0}
        for i, j in pairs:
            got = check_ring_block(ring_block(inputs, i, j, causal), dtype)
            kinds["future" if got["future"] else ("diagonal" if i == j else "past")] += 1
            for key, (e, t) in got["errors"].items():
                if key not in worst or e > worst[key][0]:
                    worst[key] = (e, t)
            if any(not (e <= t) for e, t in got["errors"].values()) or not got["identical"] or not got["exact"]:
                raise AssertionError(f"ring block ({i}, {j}) of {name}: {got}")
            torch.cuda.empty_cache()
        print(f"[ring-block] {name} {str(dtype).split('.')[-1]} B={b} {chunks} chunks of {chunk}, {nh} heads over "
              f"{kv} of {d}, {'causal' if causal else 'non-causal'}{', padded' if padded else ''}: {len(pairs)} "
              f"blocks ({', '.join(f'{n} {k}' for k, n in kinds.items() if n)}); worst "
              + ", ".join(f"{key} {e:.3e} (tol {t:.1e})" for key, (e, t) in worst.items())
              + f"; two launches bit-identical, future blocks exactly 0 (lse < -1e28) [{card}]")
        if name == "llama-125m":
            merged_ring_check(inputs, card)
            records = {}
            for kind, (i, j) in RING_KINDS.items():
                c = ring_block(inputs, i, j, causal)
                t = ring_block_times(c, flush)
                print(f"[ring-block] {kind} block ({i}, {j}) of llama-125m bf16 B={b} chunk {chunk}: fwd "
                      f"{t['fwd']:.4f} ms (plain {t['fwd_plain']:.4f}, bound {t['fwd_bound']:.4f} {t['fwd_by']}, "
                      f"{t['fwd_bound'] / t['fwd']:.1%}; SDPA with the offset mask library_ms "
                      f"{t['fwd_library']:.4f}); dq with dlse {t['dq']:.4f} ms (plain {t['dq_plain']:.4f}, bound "
                      f"{t['dq_bound']:.4f} {t['dq_by']}, {t['dq_bound'] / t['dq']:.1%}); dkv {t['dkv']:.4f} ms "
                      f"(plain {t['dkv_plain']:.4f}, bound {t['dkv_bound']:.4f} {t['dkv_by']}, "
                      f"{t['dkv_bound'] / t['dkv']:.1%}); SDPA's whole backward with the mask library_ms "
                      f"{t['bwd_library']:.4f} (ours {t['dq'] + t['dkv']:.4f}) [{card}]")
                if kind == "diagonal":
                    got = check_ring_block(c, dtype)["errors"]
                    records = {
                        "flash_fwd_ring": dict(max_abs_err=got["out"][0], ms=t["fwd"], plain_ms=t["fwd_plain"],
                                               bound_ms=t["fwd_bound"], bound_by=t["fwd_by"],
                                               library_ms=t["fwd_library"]),
                        "flash_dq_ring": dict(max_abs_err=got["dq"][0], ms=t["dq"], plain_ms=t["dq_plain"],
                                              bound_ms=t["dq_bound"], bound_by=t["dq_by"],
                                              library_ms=t["bwd_library"]),
                        "flash_dkv_ring": dict(max_abs_err=max(got["dk"][0], got["dv"][0]), ms=t["dkv"],
                                               plain_ms=t["dkv_plain"], bound_ms=t["dkv_bound"],
                                               bound_by=t["dkv_by"], library_ms=t["bwd_library"]),
                    }
                del c, t
                torch.cuda.empty_cache()
        del inputs
        torch.cuda.empty_cache()
    return records


# -- phase 21: the ring across two processes ------------------------------------

RING_PAIR_BATCH, RING_PAIR_SEQ, RING_PAIR_STEPS = 4, 8192, 3  # 4 x 4096 tokens a process
P2P_PROBED = ("isend/irecv host", "batch_isend_irecv host", "ring hop cuda")
# the ring against one process, beside phase 18's PAIR_LOSS_RTOL: the losses' relative gap
# (3.6e-6 to 1.5e-5 on the H100), and each leaf's first gradient, the norm of its gap over
# its own norm (2.5e-3 to 2.2e-2 on the H100; a ring whose past blocks were dropped from the
# merge put every leaf 0.27-0.98 off, one whose hops sent back zero gradients 0.13-0.62 off
# all but the final norm and the head)
RING_LOSS_RTOL = 1e-4
RING_GRAD_RTOL = 5e-2


def ring_pair_batches() -> list:
    rng = np.random.default_rng(SEED + 21)
    return [rng.integers(0, 32000, (RING_PAIR_BATCH, RING_PAIR_SEQ)).astype(np.int32)
            for _ in range(RING_PAIR_STEPS)]


def probe_p2p(ring) -> dict:
    """Point-to-point sends between the two processes: ``isend``/``irecv``
    and ``batch_isend_irecv`` on host tensors (what gloo moves), and the
    ring's hop of a CUDA tensor (staged through the host by explicit
    copies on a gloo group), each with its values checked."""
    import torch.distributed as dist

    rank, peer = dist.get_rank(), 1 - dist.get_rank()
    out = {}
    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    got = torch.empty(4)
    works = [dist.isend(x, peer), dist.irecv(got, peer)]
    for work in works:
        work.wait()
    out[P2P_PROBED[0]] = "ok" if got.tolist() == (torch.arange(4) + 10 * peer).tolist() else f"wrong {got.tolist()}"
    got = torch.empty(4)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, got, peer)]):
        work.wait()
    out[P2P_PROBED[1]] = "ok" if got.tolist() == (torch.arange(4) + 10 * peer).tolist() else f"wrong {got.tolist()}"
    y = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * rank
    moved, hop = ring.rotate(y, [])
    hop.wait()
    out[P2P_PROBED[2]] = ("ok" if moved.tolist() == (torch.arange(4) + 10 * peer).tolist() else
                          f"wrong {moved.tolist()}") + (" (staged through the host)" if ring.staged(y.device) else "")
    return out


def train_ring_pair(grads_path: str) -> dict:
    """In each of two processes on cuda:0: the P2P probe, then llama-125m
    bf16 under ParallelismConfig(sequence=2): the first batch's gradients
    (summed over the ring; rank 0 saves them to ``grads_path``), then 3
    compiled steps on the whole global batch (each process runs its half
    of the sequence), launches counted, each step timed, peak memory."""
    import torch.distributed as dist

    reset_training_state()
    accelerator = Accelerator(mixed_precision="bf16", parallelism=ParallelismConfig(sequence=2), **gloo_on_card())
    model = Llama("llama-125m", dtype=torch.float32, seed=SEED)
    prepared = accelerator.prepare_model(model)
    probes = probe_p2p(model.attention_fn.ring)
    optimizer = accelerator.prepare_optimizer(fused_adamw(ADAMW_LR))
    batches = [{"input_ids": torch.tensor(b, device="cuda")} for b in ring_pair_batches()]
    first_grads(accelerator, model, optimizer, batches[0], grads_path if dist.get_rank() == 0 else None)
    step = accelerator.compiled_step(Llama.loss_fn(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    ring_counts = {name: WRAPPERS[name].ring_launches for name in FLASH_KERNELS}
    del optimizer, step
    return {"rank": dist.get_rank(), "probes": probes, "losses": losses, "times": times, "counts": counts,
            "ring_counts": ring_counts, "span": prepared.sequence_span(RING_PAIR_SEQ),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def first_grads(accelerator, model, optimizer, batch, path):
    """The gradients of ``batch``'s loss before any update (across
    processes the global ones), saved to ``path`` on the host when given,
    then cleared; returns them."""
    accelerator.backward(type(model).loss_fn(model), batch)
    grads = {k: v.detach().to("cpu") for k, v in flatten_tree(optimizer.grads)}
    optimizer.zero_grad()
    if path is not None:
        torch.save(grads, path)
    return grads


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's gradient gap, ||got - want|| over ||want||."""
    return {k: float(torch.linalg.vector_norm(got[k] - want[k]) / torch.linalg.vector_norm(want[k])) for k in want}


def phase_ring_pair(card: str) -> dict:
    """Ring attention across two processes sharing cuda:0 over gloo:
    llama-125m at full width and depth, bf16 over fp32 masters,
    ``fused_adamw(3e-4)``, ``ParallelismConfig(sequence=2)``, global batch
    4 at S=8192 (4 x 4096 tokens a process), 3 compiled steps; both
    processes' losses alike, within 5e-3 relative of one process's steps
    on the whole batch and within ``RING_LOSS_RTOL``; the first batch's
    gradients of every leaf within ``RING_GRAD_RTOL`` of one process's;
    launches a process (each flash kernel's ring variant 12 layers x 2
    blocks a step); step time and peak memory a process against the one
    process's. Returns the ring launches."""
    from accelerate_tpu_torch.launchers import debug_launcher

    with tempfile.TemporaryDirectory(prefix="chip-smoke-ring-") as tmp:
        path = os.path.join(tmp, "grads.pt")
        ranks = debug_launcher(train_ring_pair, args=(path,), num_processes=2, timeout=600)
        ring_grads = torch.load(path)
    probes = ranks[0]["probes"]
    print(f"[ring-pair] point-to-point on gloo, two processes on cuda:0: "
          + ", ".join(f"{name}: {probes[name]}" for name in P2P_PROBED) + f" [{card}]")
    if any(not out["probes"][name].startswith("ok") for out in ranks for name in P2P_PROBED):
        raise AssertionError(f"gloo point-to-point: {[out['probes'] for out in ranks]}")
    layers, blocks = 12, 2
    for got in ranks:
        print(f"[ring-pair] rank {got['rank']}: llama-125m bf16 fused_adamw B={RING_PAIR_BATCH} S={RING_PAIR_SEQ} "
              f"under ParallelismConfig(sequence=2), positions {got['span']}: losses "
              f"{[round(x, 6) for x in got['losses']]}; step times "
              f"{[round(x * 1e3, 3) for x in got['times']]} ms (p50 {np.median(got['times']) * 1e3:.3f}; gloo "
              f"stages every hop and collective through the host, so this says nothing of NCCL); launches "
              f"{got['counts']}, of them the ring variants {got['ring_counts']}, over {RING_PAIR_STEPS} steps; "
              f"peak memory {got['peak_gib']:.3f} GiB [{card}]")
        for name in FLASH_KERNELS:
            want = layers * blocks * RING_PAIR_STEPS
            if got["counts"][name] != want or got["ring_counts"][name] != want:
                raise AssertionError(f"rank {got['rank']} {name}: {got['counts'][name]} launches "
                                     f"({got['ring_counts'][name]} ring), expected {want}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError("the two processes report different losses")

    reset_training_state()
    accelerator, model = train_setup("llama-125m", "bf16", fused_adamw(ADAMW_LR))
    batches = [{"input_ids": torch.tensor(b, device="cuda")} for b in ring_pair_batches()]
    grad_gaps = leaf_gaps(ring_grads, first_grads(accelerator, model, accelerator._optimizers[-1],
                                                       batches[0], None))
    del ring_grads
    step = accelerator.compiled_step(Llama.loss_fn(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    single, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        single.append(float(step(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    gaps = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], single)]
    worst = max(grad_gaps, key=grad_gaps.get)
    print(f"[ring-pair] one process on the whole batch (flash from 1024): losses {[round(x, 6) for x in single]}; "
          f"relative gaps {[f'{g:.3e}' for g in gaps]} (tolerances {PAIR_LOSS_RTOL} and {RING_LOSS_RTOL}); first "
          f"gradients' relative gap, worst leaf {worst} {grad_gaps[worst]:.3e} (tolerance {RING_GRAD_RTOL}), "
          f"median leaf {float(np.median(list(grad_gaps.values()))):.3e}; step times "
          f"{[round(x * 1e3, 3) for x in times]} ms; peak memory {peak:.3f} GiB against "
          f"{max(r['peak_gib'] for r in ranks):.3f} a ring process [{card}]")
    if max(gaps) > PAIR_LOSS_RTOL or max(gaps) > RING_LOSS_RTOL:
        raise AssertionError("the ring's losses differ from one process's")
    if not all(g <= RING_GRAD_RTOL for g in grad_gaps.values()):
        raise AssertionError(f"the ring's gradients differ from one process's: {grad_gaps}")
    del accelerator, model, step
    gc.collect()
    torch.cuda.empty_cache()
    reset_training_state()
    return ranks[0]["ring_counts"]


# -- phases 22-25: gpt2 serving and training, the engine's new surface --------

GPT2_SHAPES = ((1600, 4800), (1600, 1600), (1600, 6400), (6400, 1600))  # gpt2-1.5b [K, N]
GPT2_PROJECTIONS = 4  # wqkv wo w_up w_down: the quantized matrices of a gpt2 layer
GPT2_LEAVES = 16  # 2 embeddings, 12 layer and 2 final-norm leaves


def gpt2_kernel_checks(card: str) -> None:
    """The paged decode and verify kernels at gpt2-1.5b's attention (25
    heads of 64, no grouped K/V, 8 slots of up to 1024 positions, NaN past
    every length) against their plain versions, bf16 and fp32, two launches
    bit-identical, timed beside their bound, plain version and SDPA over a
    pre-gathered view (phase 2's yardstick)."""
    rng = np.random.default_rng(SEED + 22)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    lengths = [1000, 700, 517, 64, 33, 17, 1, 0]
    for window in (None, SPEC_K + 1):
        for dtype in (torch.bfloat16, torch.float32):
            case = make_case(rng, 8, 25, 25, 64, 16, 64, lengths, dtype, window=window)
            fn, ref = ((paged_decode_attention, pa.paged_decode_attention_reference) if window is None
                       else (paged_verify_attention, pa.paged_verify_attention_reference))
            got = fn(**case)
            identical = torch.equal(got, fn(**case))
            err = float((got.float() - ref(**case).float()).abs().max().item())
            ms = time_ms(lambda: fn(**case), flush, iters=20)
            plain = time_ms(lambda: ref(**case), flush, iters=20)
            library = time_ms(sdpa_call(case), flush, iters=20)
            bound, bound_by = bound_ms(case, dtype)
            kind = "decode" if window is None else f"verify W={window}"
            print(f"[gpt2-paged] gpt2-1.5b {kind} {str(dtype).split('.')[-1]} "
                  f"({split_line(8, 25, window or 1, 16, 64)}): max_abs_err {err:.3e} (tolerance "
                  f"{TOLERANCE[dtype]:.0e}), two launches bit-identical: {identical}; kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, library_ms {library:.4f}, bound {bound:.4f} ms "
                  f"({bound_by}), achieved {bound / ms:.1%} of bound [{card}]")
            if not (err <= TOLERANCE[dtype]) or not identical:
                raise AssertionError(f"paged {kind} disagrees at gpt2-1.5b's heads in {dtype}")


def serve_traffic(engine, prompts, new: int, card: str):
    """Submit ``prompts`` and step the engine dry with the launch counts
    reset just before, timing each step on the host (a step ends in its
    tokens' fetch) and noting whether it ran a prefill forward; prints the
    two kinds' step times. Returns (results, ids, counts, wall seconds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    results, steps = {}, {True: [], False: []}
    while engine.busy:
        prefills = engine.forward_counts["prefill"]
        start = time.perf_counter()
        for result in engine.step():
            results[result.request_id] = result
        steps[engine.forward_counts["prefill"] > prefills].append(time.perf_counter() - start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for prefilled, what in ((False, "decode only"), (True, "with a prefill forward")):
        ms = np.asarray(steps[prefilled]) * 1e3
        if ms.size:
            print(f"[steps] {what}: {ms.size} steps, p50 {np.percentile(ms, 50):.3f} ms, p99 "
                  f"{np.percentile(ms, 99):.3f} ms, max {ms.max():.3f} ms, {ms.sum():.1f} ms in all [{card}]")
    for rid in ids:
        if results[rid].finish_reason != "length" or results[rid].generated.size != new:
            raise AssertionError(f"request {rid} ended {results[rid].finish_reason!r}")
    return results, ids, counts, wall


def serve_line(tag: str, engine, card: str) -> str:
    m = engine.metrics()
    return (f"[{tag}] decode step p50 {m['per_token_p50_ms']:.3f} ms p99 {m['per_token_p99_ms']:.3f} ms; "
            f"{m['throughput_tokens_per_sec']:.1f} generated tokens/s; TTFT p50 {m['ttft_p50_ms']:.1f} ms "
            f"p99 {m['ttft_p99_ms']:.1f} ms; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
            f"GiB [{card}]")


def phase_gpt2_serving(card: str) -> tuple:
    """gpt2-1.5b at full width and depth behind the engine: bf16 traffic
    through the decode kernel (launches = layers x decode forwards), then
    fp32 tokens against ``generate()`` up to near-ties, then kernels 5 and 6
    at its heads. Returns the fp32 model, prompts, rows and gaps."""
    model = GPT2("gpt2-1.5b", dtype=torch.bfloat16, seed=SEED)
    layers = model.config.num_layers
    engine = ServingEngine(model, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    engine.warmup()
    prompts = serving_prompts(np.random.default_rng(SEED + 22), model.config.vocab_size)
    _, _, counts, wall = serve_traffic(engine, prompts, 64, card)
    decodes = engine.forward_counts["decode"]
    m = engine.metrics()
    print(f"[gpt2-serve] gpt2-1.5b bf16 (48 layers, 25 heads of 64, vocab 50257), 16 requests x 64 "
          f"new tokens: {m['steps']} decode steps, {counts['paged_decode']} decode launches ({layers} "
          f"layers x {decodes} forwards), prefix hits {m['prefix_hits']}, prefill chunks "
          f"{m['prefill_chunks']}, wall {wall:.3f} s")
    print(serve_line("gpt2-serve", engine, card))
    if counts["paged_decode"] != layers * decodes or decodes == 0:
        raise AssertionError(f"{counts['paged_decode']} decode launches, expected {layers} x {decodes}")
    if counts["paged_verify"] or counts["quant_matmul"]:
        raise AssertionError(f"plain gpt2 serving launched other kernels: {counts}")
    profile_decode(engine, card, "gpt2-1.5b bf16")
    del engine, model
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    model = GPT2("gpt2-1.5b", dtype=torch.float32, seed=SEED)
    prompts = parity_prompts(model.config.vocab_size)
    engine = ServingEngine(model, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    rows = engine.generate_many(prompts, max_new_tokens=16)
    want, gaps = reference_rows(model, prompts, 16)
    ties = compare_rows("gpt2-parity", prompts, rows, want, gaps, "generate()")
    print(f"[gpt2-parity] gpt2-1.5b fp32, prompts {[p.size for p in prompts]} x 16 tokens: engine == "
          f"generate() with {ties} ties [{card}]")
    del engine
    gpt2_kernel_checks(card)
    return model, prompts, rows, gaps


def gpt2_quant_checks(card: str) -> None:
    """Kernel 7 at gpt2-1.5b's four projection shapes (K = 1600 is 12.5
    tiles of 128; int4 packs 800 rows), M = 8 and 64, int8 and int4, bf16
    and fp32, against its plain version, two launches bit-identical."""
    rng = np.random.default_rng(SEED + 23)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for k, n in GPT2_SHAPES:
        w = rng.standard_normal((k, n), dtype=np.float32)
        for bits in (8, 4):
            q, scale = quantize_weight(w, bits=bits)
            q, scale = torch.tensor(q, device="cuda"), torch.tensor(scale, device="cuda")
            for dtype in (torch.bfloat16, torch.float32):
                weight = QuantizedWeight(q, scale, bits, dtype)
                dense = dequantize_weight(q, scale, bits, dtype)
                for m in (8, 64):
                    x = torch.tensor(rng.standard_normal((m, k), dtype=np.float32) / (4 * np.sqrt(k)),
                                     device="cuda").to(dtype)
                    got = quant_matmul(x, weight)
                    identical = torch.equal(got, quant_matmul(x, weight))
                    err = float((got.float() - quant_matmul_reference(x, weight).float()).abs().max().item())
                    ms = time_ms(lambda: quant_matmul(x, weight), flush, iters=20)
                    plain = time_ms(lambda: quant_matmul_reference(x, weight), flush, iters=20)
                    library = time_ms(lambda: x @ dense, flush, iters=20)
                    bound, bound_by = quant_bound_ms(m, k, n, bits, dtype)
                    print(f"[gpt2-quant] [{k},{n}] int{bits} {str(dtype).split('.')[-1]} M={m}: max_abs_err "
                          f"{err:.3e} (tolerance {TOLERANCE[dtype]:.0e}), two launches bit-identical: "
                          f"{identical}; kernel {ms:.4f} ms, plain {plain:.4f} ms, library_ms {library:.4f}, "
                          f"bound {bound:.4f} ms ({bound_by}), achieved {bound / ms:.1%} of bound [{card}]")
                    if not (err <= TOLERANCE[dtype]) or not identical:
                        raise AssertionError(f"quant kernel disagrees at [{k},{n}] int{bits} {dtype} M={m}")
                del dense


def phase_gpt2_spec_quant(card: str, model, prompts, want, gaps) -> None:
    """gpt2-1.5b verifying gpt2-124m's drafts (k=4, linear): bf16 traffic
    through the verify kernel, then fp32 tokens against the plain engine's;
    int8-resident gpt2-1.5b from ``dispatch_model`` through
    ``from_streamed``: bf16 traffic through the dequant-matmul kernel, then
    fp32 tokens against ``generate()`` over the dequantized weights; kernel
    7 at gpt2-1.5b's shapes."""
    layers = model.config.num_layers
    draft = GPT2("gpt2-124m", dtype=torch.float32, seed=SEED + 6)
    engine = ServingEngine(model, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64,
                           speculative=SpeculativeConfig(draft_model=draft, k=SPEC_K))
    reset_launches()
    rows = engine.generate_many(prompts, max_new_tokens=16)
    ties = compare_rows("gpt2-spec-parity", prompts, rows, want, gaps, "plain engine")
    verifies = engine.forward_counts["verify"]
    print(f"[gpt2-spec-parity] gpt2-1.5b fp32 with gpt2-124m drafts (k={SPEC_K}): spec == plain engine "
          f"with {ties} ties; {verifies} verify forwards, {paged_verify_attention.launches} verify "
          f"launches; proposed {engine.stats.spec_proposed_tokens}, accepted "
          f"{engine.stats.spec_accepted_tokens} [{card}]")
    if paged_verify_attention.launches != layers * verifies or verifies == 0:
        raise AssertionError(f"{paged_verify_attention.launches} verify launches")
    del engine, draft, model
    gc.collect()
    torch.cuda.empty_cache()

    bf16 = GPT2("gpt2-1.5b", dtype=torch.bfloat16, seed=SEED)
    draft = GPT2("gpt2-124m", dtype=torch.bfloat16, seed=SEED + 6)
    engine = ServingEngine(bf16, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64,
                           speculative=SpeculativeConfig(draft_model=draft, k=SPEC_K))
    engine.warmup()
    traffic = serving_prompts(np.random.default_rng(SEED + 22), bf16.config.vocab_size)
    _, _, counts, wall = serve_traffic(engine, traffic, 64, card)
    verifies = engine.forward_counts["verify"]
    m = engine.metrics()
    print(f"[gpt2-spec] gpt2-1.5b bf16 verifying gpt2-124m drafts (k={SPEC_K}, linear), 16 requests x "
          f"64 new tokens: {m['steps']} steps, {counts['paged_verify']} verify launches ({layers} x "
          f"{verifies}), draft decode launches {counts['paged_decode']}; proposed "
          f"{m['spec_proposed_tokens']}, accepted {m['spec_accepted_tokens']} (random weights); wall "
          f"{wall:.3f} s")
    print(serve_line("gpt2-spec", engine, card))
    if counts["paged_verify"] != layers * verifies or verifies == 0 or counts["paged_decode"] == 0:
        raise AssertionError(f"speculative gpt2 serving launched {counts}")
    del engine, bf16, draft
    gc.collect()
    torch.cuda.empty_cache()

    source = GPT2("gpt2-1.5b", dtype=torch.float32, seed=SEED)
    t0 = time.perf_counter()
    streamed = dispatch_model(source, device_map=make_layered_device_map(source, "device"),
                              dtype=torch.bfloat16, quantization=QuantizationConfig(load_in_8bit=True))
    print(f"[gpt2-quant-serve] quantized gpt2-1.5b to int8 on the host in {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine.from_streamed(streamed, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    served = streamed.model
    if served.dot_fn is not quant_dot or not isinstance(served.layers.wqkv, QuantizedWeight):
        raise AssertionError("from_streamed did not keep gpt2's matrices packed behind quant_dot")
    if served.layers.bqkv.dtype != torch.bfloat16 or served.embed_positions.dtype != torch.bfloat16:
        raise AssertionError("gpt2's biases and positions should stay unquantized")
    engine.warmup()
    _, _, counts, wall = serve_traffic(engine, traffic, 64, card)
    forwards = engine.forward_counts["prefill"] + engine.forward_counts["decode"]
    resident, bf16_bytes = layer_bytes(served)
    m = engine.metrics()
    print(f"[gpt2-quant-serve] gpt2-1.5b int8 in bf16, 16 requests x 64 new tokens: {m['steps']} decode "
          f"steps, {forwards} forwards, {counts['quant_matmul']} kernel launches ({GPT2_PROJECTIONS} x "
          f"{layers} x {forwards} = {GPT2_PROJECTIONS * layers * forwards}), decode launches "
          f"{counts['paged_decode']}; resident layer bytes {resident} = {resident / bf16_bytes:.3f} x "
          f"bf16's; wall {wall:.3f} s")
    print(serve_line("gpt2-quant-serve", engine, card))
    if counts["quant_matmul"] != GPT2_PROJECTIONS * layers * forwards or forwards == 0:
        raise AssertionError(f"{counts['quant_matmul']} quant launches")
    if counts["paged_decode"] != layers * engine.forward_counts["decode"]:
        raise AssertionError(f"int8 gpt2 serving launched {counts}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    fp32 = as_fp32(streamed)
    reference = GPT2("gpt2-1.5b", dtype=torch.float32, seed=SEED).install(params_from_streamed(fp32))
    rows_want, rows_gaps = reference_rows(reference, prompts, 16)
    del reference
    engine = ServingEngine.from_streamed(fp32, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    rows = engine.generate_many(prompts, max_new_tokens=16)
    ties = compare_rows("gpt2-quant-int8", prompts, rows, rows_want, rows_gaps, "dequantized generate()")
    print(f"[gpt2-quant-int8] gpt2-1.5b fp32 int8, prompts {[p.size for p in prompts]} x 16 tokens: "
          f"engine == generate() over the dequantized weights with {ties} ties [{card}]")
    del engine, fp32, streamed, source
    gc.collect()
    torch.cuda.empty_cache()
    gpt2_quant_checks(card)


def phase_gpt2_training(card: str) -> None:
    """gpt2-124m at full width and depth in bf16 over fp32 masters, flash
    from 128, ``fused_adamw(3e-4)``, B=16 S=1024: step p50 over 10 steps
    after 3 warm-up, tokens/s, MFU, peak memory, launches (12 a step for
    each flash kernel, 16 for adamw); then fp32 B=2 S=1024 through the
    kernels against the plain attention and plain adamw: the first
    gradients leaf by leaf, then 3 steps' losses and each leaf's update
    (``gpt2_parity_run``; ``chip_gpt2_gate.py`` holds these gates against
    faults)."""
    batch_size, seq = 16, 1024
    accelerator, model = train_setup("gpt2-124m", "bf16", fused_adamw(ADAMW_LR), flash_min_seq=128)
    layers = model.config.num_layers
    step = accelerator.compiled_step(GPT2.loss_fn(model))
    batch = random_batch(np.random.default_rng(SEED + 24), batch_size, seq, model.config.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = timed_steps(step, batch, 3, 10)
    counts = launch_counts()
    losses = [float(x) for x in losses]
    p50 = float(np.median(times))
    flops = train_flops_per_step(model.config, batch_size, seq)
    print(f"[gpt2-train] gpt2-124m bf16 fused_adamw B={batch_size} S={seq}: step p50 {p50 * 1e3:.3f} ms "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) over 10 steps after 3 warm-up, "
          f"{batch_size * seq / p50:.1f} tokens/s, MFU {flops / p50 / PEAK_FLOPS[torch.bfloat16]:.4f} "
          f"({flops:.3e} flops a step), peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches {counts} over 13 steps [{card}]")
    want = {"flash_fwd": layers * 13, "flash_dq": layers * 13, "flash_dkv": layers * 13,
            "fused_adamw": GPT2_LEAVES * 13}
    for key, n in want.items():
        if counts[key] != n:
            raise AssertionError(f"{key}: {counts[key]} launches, expected {n}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite gpt2 training loss: {losses}")
    del accelerator, model, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    batch = gpt2_parity_batch()
    want = gpt2_parity_run("plain", batch)
    got = gpt2_parity_run("kernels", batch)
    rel, grad_gaps, update_gaps = gpt2_parity_gaps(got, want)
    print(f"[gpt2-train-parity] gpt2-124m fp32 B=2 S=1024, 3 steps: kernels {got['losses']} vs plain "
          f"{want['losses']}: {gpt2_gap_line(rel, grad_gaps, update_gaps)} [{card}]")
    if not gpt2_parity_passes(rel, grad_gaps, update_gaps):
        raise AssertionError("fp32 gpt2 kernel steps differ from the plain steps")


# fp32 gpt2-124m, kernels against the plain versions on an H100: the losses
# agreed exactly, the first gradients within 1.7e-6 of each leaf's norm and
# the 3-step updates within 3.7e-3 (bqkv, whose k bias has a null gradient
# that adam scales up to the learning rate) and 7.5e-5 elsewhere
GPT2_LOSS_RTOL = 1e-4
GPT2_GRAD_RTOL = 1e-4
GPT2_UPDATE_RTOL = 2e-2


def gpt2_parity_batch() -> dict:
    return random_batch(np.random.default_rng(SEED + 25), 2, 1024, 50257)


def gpt2_parity_run(kind: str, batch) -> dict:
    """gpt2-124m fp32 at full depth through the kernels (flash from 128,
    ``fused_adamw``) or the plain versions (plain attention, ``adamw``):
    the first gradients of ``batch`` before any update, then 3 compiled
    steps on it. Returns the losses, the gradients, each leaf's update over
    the 3 steps (host copies) and the steps' launches; fails if the kernel
    run launched no flash kernel or the plain run launched any kernel."""
    if kind == "kernels":
        accelerator, model = train_setup("gpt2-124m", "no", fused_adamw(ADAMW_LR), flash_min_seq=128)
    else:
        accelerator, model = train_setup("gpt2-124m", "no", adamw(ADAMW_LR), flash_min_seq=0)
        model.attention_fn = plain_attention
    grads = first_grads(accelerator, model, accelerator._optimizers[-1], batch, None)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = accelerator.compiled_step(GPT2.loss_fn(model))
    reset_launches()
    losses = [float(step(batch)) for _ in range(3)]
    counts = launch_counts()
    updates = {k: (p.detach() - before[k]).cpu() for k, p in model.named_parameters()}
    del accelerator, model, step, before
    gc.collect()
    torch.cuda.empty_cache()
    if (kind == "kernels") != bool(counts["flash_fwd"]) or (kind == "plain" and any(counts.values())):
        raise AssertionError(f"{kind} fp32 gpt2 run launched {counts}")
    return {"losses": losses, "grads": grads, "updates": updates, "counts": counts}


def gpt2_parity_gaps(got: dict, want: dict) -> tuple[float, dict, dict]:
    """The losses' largest relative gap, and each leaf's gap (the norm of
    the difference over the leaf's norm) in the first gradients and in the
    update over the 3 steps."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    return rel, leaf_gaps(got["grads"], want["grads"]), leaf_gaps(got["updates"], want["updates"])


def gpt2_parity_passes(rel: float, grad_gaps: dict, update_gaps: dict) -> bool:
    return (rel <= GPT2_LOSS_RTOL and max(grad_gaps.values()) <= GPT2_GRAD_RTOL
            and max(update_gaps.values()) <= GPT2_UPDATE_RTOL)


def gpt2_gap_line(rel: float, grad_gaps: dict, update_gaps: dict) -> str:
    def worst(gaps):
        key = max(gaps, key=gaps.get)
        return (f"worst leaf {key} {gaps[key]:.3e}, median {float(np.median(list(gaps.values()))):.3e}, "
                f"least {min(gaps.values()):.3e}")

    return (f"losses' max relative gap {rel:.3e} (tolerance {GPT2_LOSS_RTOL}); first gradients' gaps "
            f"{worst(grad_gaps)} (tolerance {GPT2_GRAD_RTOL}); 3-step updates' gaps {worst(update_gaps)} "
            f"(tolerance {GPT2_UPDATE_RTOL})")


def phase_engine_surface(card: str) -> None:
    """The engine's degradation, dense and handoff paths on gpt2-124m in
    fp32 on the card: quarantine (NaN in a live slot's pages: quarantined,
    freed pages read back exactly 0, requeued, finished with ``generate()``'s
    tokens; then at temperature 0.8, where the categorical draw would raise
    on the NaN lane), the watchdog (a tiny ``step_timeout_s`` counts trips), the
    dense slab (tokens equal to the paged engine's) and a KV handoff
    (``prefill_only`` -> ``extract_pages`` -> ``adopt_kv`` on a second
    engine: tokens equal to ``generate()``)."""
    model = GPT2("gpt2-124m", dtype=torch.float32, seed=SEED + 6)
    vocab = model.config.vocab_size
    prompts = parity_prompts(vocab)
    want, gaps = reference_rows(model, prompts, 16)
    kwargs = dict(num_slots=4, max_len=512, page_size=16)

    engine = ServingEngine(model, **kwargs)
    reset_launches()
    rid = engine.submit(prompts[2], max_new_tokens=16)
    while not engine.cache.active.any():
        engine.step()
    engine.step()
    pages = engine.cache.pages_of(int(np.flatnonzero(engine.cache.active)[0]))
    engine.cache.k[:, pages] = float("nan")
    engine.step()
    scrubbed = all(float(engine.cache.k[:, p].abs().max()) == 0.0 and
                   float(engine.cache.v[:, p].abs().max()) == 0.0 for p in pages)
    result = engine.run()[rid]
    row = np.concatenate([prompts[2], result.generated])
    ties = compare_rows("surface-quarantine", prompts[2:3], [row], want[2:3], gaps[2:3], "generate()")
    s = engine.stats
    print(f"[surface] quarantine: {s.slot_quarantines} quarantined, {s.requests_requeued} requeued, "
          f"{s.slot_quarantine_releases} released by the probe; {len(pages)} freed pages read back 0: "
          f"{scrubbed}; the request finished '{result.finish_reason}' == generate() with {ties} ties; "
          f"launches {launch_counts()} [{card}]")
    if (s.slot_quarantines, s.requests_requeued, s.slot_quarantine_releases) != (1, 1, 1) or not scrubbed:
        raise AssertionError("quarantine did not quarantine, scrub, requeue and release once")
    if not bool(torch.isfinite(engine.cache.k[:, 0]).all()):
        raise AssertionError("the null page went non-finite")

    sampled = ServingEngine(model, temperature=0.8, rng=torch.Generator("cuda").manual_seed(SEED), **kwargs)
    ids = [sampled.submit(p, max_new_tokens=8) for p in prompts]
    while not sampled.cache.active.any():
        sampled.step()
    sampled.step()
    sampled.cache.k[:, sampled.cache.pages_of(int(np.flatnonzero(sampled.cache.active)[0]))] = float("nan")
    results = sampled.run()
    s = sampled.stats
    reasons = [results[i].finish_reason for i in ids]
    print(f"[surface] quarantine at temperature 0.8: {s.slot_quarantines} quarantined, {s.requests_requeued} "
          f"requeued, {s.slot_quarantine_releases} released; finish reasons {reasons} [{card}]")
    if (s.slot_quarantines, s.requests_requeued, s.slot_quarantine_releases) != (1, 1, 1) or \
            reasons != ["length"] * len(ids):
        raise AssertionError("a sampled engine did not quarantine, requeue and release once")

    watched = ServingEngine(model, step_timeout_s=1e-6, **kwargs)
    watched.generate_many(prompts[:2], max_new_tokens=4)
    watched._watchdog.close()
    print(f"[surface] watchdog at step_timeout_s=1e-6: {watched.stats.watchdog_trips} trips over "
          f"{watched.stats.steps} steps [{card}]")
    if watched.stats.watchdog_trips < 1:
        raise AssertionError("the watchdog counted no trip")

    paged_rows = engine.generate_many(prompts, max_new_tokens=16)
    dense = ServingEngine(model, paged=False, **kwargs)
    reset_launches()
    dense_rows = dense.generate_many(prompts, max_new_tokens=16)
    counts = launch_counts()
    ties = compare_rows("surface-dense", prompts, dense_rows, paged_rows, gaps, "paged engine")
    print(f"[surface] paged=False slab [{tuple(dense.cache.k.shape)}]: tokens == the paged engine's with "
          f"{ties} ties; kernel launches {counts} (the dense path runs the plain attention) [{card}]")
    if any(counts.values()):
        raise AssertionError(f"the dense slab launched {counts}")

    src = ServingEngine(model, prefix_sharing=False, **kwargs)
    dst = ServingEngine(model, **kwargs)
    rows = []
    reset_launches()
    for prompt in prompts:
        rid = src.submit(prompt, max_new_tokens=16, prefill_only=True)
        parked = src.run()[rid]
        layout = src.kv_page_layout(rid)
        kb, vb = src.extract_pages(layout["pages"])
        new_id = dst.adopt_kv(prompt, 16, layout, kb, vb, request_id=rid)
        src.release_parked(rid)
        if parked.finish_reason != "prefilled":
            raise AssertionError(f"prefill_only request ended {parked.finish_reason!r}")
        rows.append(np.concatenate([prompt, dst.run()[new_id].generated]))
    ties = compare_rows("surface-handoff", prompts, rows, want, gaps, "generate()")
    print(f"[surface] handoff: {src.stats.requests_parked} parked, {dst.stats.requests_adopted} adopted, "
          f"source pages in use {src.cache.pages_in_use}; tokens == generate() with {ties} ties; "
          f"launches {launch_counts()} [{card}]")
    if src.cache.pages_in_use or src.parked_count:
        raise AssertionError("the source kept pages after the handoff")
    del engine, sampled, watched, dense, src, dst, model
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 26: big-model inference ----------------------------------------------

# llama-1b layers the auto map keeps on the card and in host memory; the rest go to disk
BIG_ON_DEVICE, BIG_ON_CPU = 8, 7
LLAMA_1B_HF_CONFIG = {
    "model_type": "llama", "vocab_size": 32000, "hidden_size": 2048, "intermediate_size": 5504,
    "num_hidden_layers": 22, "num_attention_heads": 16,
    "max_position_embeddings": 2048, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False,
}


def big_budget(model, dtype_bytes: float, layer_dtype_bytes=None) -> dict:
    """A ``max_memory`` under which the auto map holds the resident
    components and ``BIG_ON_DEVICE`` layers on the card (beside room for
    the two streamed groups), ``BIG_ON_CPU`` in host memory, the rest on disk."""
    sizes = named_component_sizes(model, dtype_bytes, layer_dtype_bytes)
    layer = sizes["layers.0"]
    resident = sum(v for k, v in sizes.items() if not k.startswith("layers."))
    return {"device": resident + (BIG_ON_DEVICE + 2) * layer, "cpu": BIG_ON_CPU * layer}


def map_counts(streamed) -> dict:
    layers = [v for k, v in streamed.hf_device_map.items() if k.startswith("layers.")]
    return {target: layers.count(target) for target in ("device", "cpu", "disk")}


def pinned_copy_gbps(nbytes: int) -> float:
    """GB/s of one plain copy of ``nbytes`` from pinned host memory to the
    card (CUDA events, the best of 3): the yardstick of the streaming."""
    host = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    best = math.inf
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    del host, dev
    return nbytes / best / 1e9


def wall(fn, *args):
    """(result, host seconds) of ``fn`` with the card synchronized around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def big_export(directory: str, card: str) -> dict:
    """Phase 3's llama-1b weights (bf16, seed 0) as fp32 numpy in the JAX
    layout, written as an HF-layout checkpoint with its ``config.json``."""
    source = Llama("llama-1b", dtype=torch.bfloat16, seed=SEED)
    host = tree_map(lambda t: t.float().cpu().numpy(), source.param_tree())
    del source
    torch.cuda.empty_cache()
    cfg = get_config("llama-1b")
    t0 = time.perf_counter()
    flat = export_hf_llama(host, cfg)
    _save_flat(flat, os.path.join(directory, "model.safetensors"))
    del flat
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(LLAMA_1B_HF_CONFIG, f)
    size = sum(os.path.getsize(os.path.join(directory, n)) for n in os.listdir(directory))
    print(f"[big] exported llama-1b (22 layers, fp32) to an HF-layout checkpoint: {size} bytes "
          f"({'safetensors' if has_safetensors() else 'npz'}) in {time.perf_counter() - t0:.1f} s [{card}]")
    if config_from_hf_json(directory) != cfg:
        raise AssertionError("config_from_hf_json does not read back llama-1b's config")
    return host


def big_forward(streamed, host: dict, ids, card: str) -> float:
    """(b): the streamed bf16 forward against an all-device dispatch of
    the same params, bit for bit, at the default window and at groups of
    one layer and of all layers; peak memory against its bound; wall time,
    bytes streamed, GB/s beside a pinned copy's, busy shares. Returns the
    pinned copy's GB/s."""
    cfg = streamed.model.config
    device_map = make_layered_device_map(streamed.model, "device")
    reference = dispatch_model(Llama(cfg, device="meta"), host, device_map, dtype=torch.bfloat16)
    reference(ids)  # cuBLAS warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want, device_s = wall(reference, ids)
    activations = torch.cuda.max_memory_allocated() - base
    del reference
    torch.cuda.empty_cache()

    got = streamed(ids)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, seconds = wall(streamed, ids)
    peak = torch.cuda.max_memory_allocated() - base
    window = 2 * streamed.group_size * streamed._layer_bytes()
    nbytes = streamed.streamed_bytes
    yardstick = pinned_copy_gbps(nbytes)
    same = torch.equal(got, want)
    variants = {}
    for label, window_bytes in (("groups of 1 (a window under one layer)", 1), ("one group of all 22", 1 << 40)):
        variant = StreamedModel(streamed.model, streamed.resident, streamed.layer_buffers,
                                streamed.layer_on_device, streamed.packer, torch.bfloat16, streamed.device,
                                stream_window_bytes=window_bytes)
        out, variant_s = wall(variant, ids)
        variants[label] = (variant.group_size, torch.equal(out, got), variant_s)
        del variant, out
    print(f"[big] streamed forward 2 x 512 bf16, group size {streamed.group_size}: {seconds * 1e3:.1f} ms "
          f"(all-device {device_s * 1e3:.1f} ms); streamed {nbytes} bytes = {nbytes / seconds / 1e9:.2f} GB/s "
          f"against a plain pinned copy's {yardstick:.2f} GB/s (disk layers read page-cache warm); logits == "
          f"all-device bit for bit: {same} [{card}]")
    for label, (size, equal, variant_s) in variants.items():
        print(f"[big]   {label}: group size {size}, {variant_s * 1e3:.1f} ms, logits == default window's: "
              f"{equal} [{card}]")
    print(f"[big] peak device memory over the placed model {peak} bytes; bound: two groups {window} + the "
          f"all-device forward's activations {activations} = {window + activations} [{card}]")
    if not same or not all(equal for _, equal, _ in variants.values()):
        raise AssertionError("streamed logits differ from the all-device dispatch's")
    if variants["groups of 1 (a window under one layer)"][0] != 1 or variants["one group of all 22"][0] != 22:
        raise AssertionError(f"window sizes gave groups {[v[0] for v in variants.values()]}")
    if peak > window + activations:
        raise AssertionError(f"streamed peak {peak} > bound {window + activations}")
    if not torch.isfinite(got).all():
        raise AssertionError("streamed logits are not finite")

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, profiled_s = wall(streamed, ids)
    copies = compute = 0.0
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA and event.self_device_time_total > 0:
            if event.key.startswith("Memcpy"):
                copies += event.self_device_time_total
            else:
                compute += event.self_device_time_total
    print(f"[profile] streamed forward: wall {profiled_s * 1e3:.1f} ms under the profiler, kernels busy "
          f"{compute / 1e3:.1f} ms ({compute / (profiled_s * 1e6):.1%} of wall), copies {copies / 1e3:.1f} ms "
          f"({copies / (profiled_s * 1e6):.1%}) [{card}]")
    return yardstick


def big_generate(streamed, host: dict, directory: str, yardstick: float, card: str) -> None:
    """(c): 16 streamed tokens in fp32 against generate() over the resident
    model (equal except at near-ties), then the bf16 streamed decode's ms a
    token beside its streamed bytes a token over the pinned yardstick."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama-1b")
    meta = Llama(cfg, device="meta")
    s32 = dispatch_model(meta, host, "auto", max_memory=big_budget(meta, 4), dtype=torch.float32,
                         offload_dir=os.path.join(directory, "offload-fp32"))
    rng = np.random.default_rng(SEED + 26)
    prompts = [rng.integers(1, cfg.vocab_size, size=32).astype(np.int32) for _ in range(2)]
    new = 16
    rows, seconds = wall(s32.generate, np.stack(prompts), new)
    placement = ", ".join(f"{n} layers on {t}" for t, n in map_counts(s32).items())
    del s32
    torch.cuda.empty_cache()
    resident = Llama(cfg, device="meta").install(tree_map(lambda a: torch.from_numpy(a).cuda(), host))
    want, gaps = reference_rows(resident, prompts, new)
    ties = compare_rows("big-generate", prompts, list(rows), want, gaps, "generate()")
    del resident
    torch.cuda.empty_cache()
    print(f"[big] streamed generate fp32 ({placement}), 2 x 32 prompt + {new} tokens in "
          f"{seconds:.2f} s: tokens == generate() over the resident model with {ties} ties [{card}]")

    ids = np.stack(prompts)
    _, one = wall(streamed.generate, ids, 1)
    _, many = wall(streamed.generate, ids, new + 1)
    per_token = streamed.streamed_bytes / (new + 1)
    ms = (many - one) / new * 1e3
    print(f"[big] streamed decode bf16, batch 2: {ms:.2f} ms a token; {per_token:.0f} bytes streamed a token, "
          f"{per_token / yardstick / 1e6:.2f} ms at the pinned copy's {yardstick:.2f} GB/s [{card}]")


def big_serving(streamed, host: dict, directory: str, phase3_rows: list, card: str) -> None:
    """(d): the disk-backed auto-placed model behind the engine with phase
    3's traffic: tokens equal phase 3's, decode launches = layers x decode
    forwards; then an int8 load through from_streamed, counting the
    dequant-matmul's launches."""
    cfg = streamed.model.config
    layers = cfg.num_layers
    engine = ServingEngine.from_streamed(streamed, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    engine.warmup()
    prompts = serving_prompts(np.random.default_rng(SEED), cfg.vocab_size)
    results, ids, counts, seconds = serve_traffic(engine, prompts, 64, card)
    decodes = engine.forward_counts["decode"]
    same = all(np.array_equal(results[rid].generated, want) for rid, want in zip(ids, phase3_rows))
    print(f"[big-serve] from_streamed of the auto-placed model (disk-backed), phase 3's 16 requests x 64 "
          f"tokens: tokens == phase 3's: {same}; decode launches {counts['paged_decode']} = {layers} layers x "
          f"{decodes} decode forwards; wall {seconds:.3f} s [{card}]")
    print(serve_line("big-serve", engine, card))
    if not same:
        raise AssertionError("the streamed model's engine gave other tokens than phase 3's")
    if counts["paged_decode"] != layers * decodes or decodes == 0 or counts["quant_matmul"]:
        raise AssertionError(f"from_streamed serving launched {counts} over {decodes} decode forwards")
    del engine, results
    torch.cuda.empty_cache()

    meta = Llama(cfg, device="meta")
    t0 = time.perf_counter()
    q8 = load_and_quantize_model(meta, QuantizationConfig(load_in_8bit=True), params=host, device_map="auto",
                                 max_memory=big_budget(meta, 2, 1), dtype=torch.bfloat16,
                                 offload_dir=os.path.join(directory, "offload-int8"))
    quantize_s = time.perf_counter() - t0
    engine = ServingEngine.from_streamed(q8, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    _, _, counts, seconds = serve_traffic(engine, prompts[:4], 16, card)
    forwards = engine.forward_counts["prefill"] + engine.forward_counts["decode"]
    print(f"[big-serve] load_and_quantize_model int8 (quantized on the host in {quantize_s:.1f} s; "
          f"{map_counts(q8)}) through from_streamed, 4 requests x 16 tokens: dequant-matmul launches "
          f"{counts['quant_matmul']} = {PROJECTIONS} x {layers} x {forwards} forwards, decode launches "
          f"{counts['paged_decode']}; wall {seconds:.3f} s [{card}]")
    if counts["quant_matmul"] != PROJECTIONS * layers * forwards or counts["paged_decode"] != (
            layers * engine.forward_counts["decode"]):
        raise AssertionError(f"int8 from_streamed launched {counts} over {forwards} forwards")
    del engine, q8
    torch.cuda.empty_cache()


def big_other_models(card: str) -> None:
    """(e): bert-base under cpu_offload bit-equal to its all-device
    dispatch, t5-base's streamed generate in fp32 equal to the all-device
    dispatch's, and two models under cpu_offload_with_hook taking turns."""
    rng = np.random.default_rng(SEED + 27)
    bert = Bert("bert-base", dtype=torch.bfloat16, seed=SEED)
    params = tree_map(lambda t: t.cpu(), bert.param_tree())
    ids = torch.tensor(rng.integers(1, 30522, (8, 128)), device="cuda")
    mask = torch.ones((8, 128), dtype=torch.int32, device="cuda")
    mask[4:, 100:] = 0
    module = bert(ids, mask)
    del bert
    meta = Bert(get_config("bert-base"), device="meta")
    offloaded = cpu_offload(meta, params, dtype=torch.bfloat16)
    resident = dispatch_model(meta, params, make_layered_device_map(meta, "device"), dtype=torch.bfloat16)
    got, want = offloaded(ids, mask), resident(ids, mask)
    gap = float((got.float() - module.float()).abs().max())
    print(f"[big-other] bert-base bf16 cpu_offload (12 layers streamed), B=8 S=128 padded: logits == the "
          f"all-device dispatch's bit for bit: {torch.equal(got, want)} (vs the module's forward {gap:.3e}) "
          f"[{card}]")
    if not torch.equal(got, want):
        raise AssertionError("bert-base's cpu_offload forward differs from the all-device dispatch's")
    del offloaded, resident, params

    torch.backends.cuda.matmul.allow_tf32 = False
    t5 = T5("t5-base", dtype=torch.float32, seed=SEED)
    params = tree_map(lambda t: t.cpu(), t5.param_tree())
    del t5
    cfg = get_config("t5-base")
    enc = rng.integers(1, cfg.vocab_size, (2, 64)).astype(np.int32)
    enc_mask = np.ones((2, 64), np.int32)
    enc_mask[1, 50:] = 0
    meta = T5(cfg, device="meta")
    streamed = cpu_offload(meta, params, dtype=torch.float32)
    resident = dispatch_model(meta, params, make_layered_device_map(meta, "device"), dtype=torch.float32)
    got = streamed.generate(enc, max_new_tokens=16, attention_mask=enc_mask)
    want = resident.generate(enc, max_new_tokens=16, attention_mask=enc_mask)
    print(f"[big-other] t5-base fp32 Seq2SeqStreamedModel.generate (12 decoder layers streamed), 2 x 64 "
          f"encoder tokens + 16: tokens == the all-device dispatch's: {np.array_equal(got, want)} [{card}]")
    if not np.array_equal(got, want) or got.shape != (2, 17):
        raise AssertionError("t5-base's streamed generate differs from the all-device dispatch's")
    del streamed, resident, params

    del ids, mask, module
    cfg = get_config("llama-125m")
    trees = []
    for seed in (1, 2):
        model = Llama(cfg, dtype=torch.bfloat16, seed=seed)
        trees.append(tree_map(lambda t: t.cpu(), model.param_tree()))
        del model
    ids = torch.tensor(rng.integers(1, cfg.vocab_size, (2, 64)), device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    lm_a, hook_a = cpu_offload_with_hook(Llama(cfg, device="meta"), trees[0], dtype=torch.bfloat16)
    lm_b, hook_b = cpu_offload_with_hook(Llama(cfg, device="meta"), trees[1], dtype=torch.bfloat16,
                                         prev_module_hook=hook_a)
    steps = [("start", torch.cuda.memory_allocated() - base)]
    out_a = lm_a(ids).cpu()
    steps.append(("a ran", torch.cuda.memory_allocated() - base))
    out_b = lm_b(ids).cpu()
    steps.append(("b ran (a evicted)", torch.cuda.memory_allocated() - base))
    hook_b.offload()
    steps.append(("b offloaded", torch.cuda.memory_allocated() - base))
    again = lm_a(ids).cpu()
    steps.append(("a ran again", torch.cuda.memory_allocated() - base))
    hook_a.offload()
    steps.append(("a offloaded", torch.cuda.memory_allocated() - base))
    model_bytes = sum(t.numel() * 2 for t in tree_leaves(trees[0]))
    print(f"[big-other] two llama-125m under cpu_offload_with_hook ({model_bytes} bytes each in bf16), device "
          f"memory over the baseline: " + ", ".join(f"{k} {v}" for k, v in steps) + f"; a's logits again equal: "
          f"{torch.equal(again, out_a)} [{card}]")
    zero = [v for k, v in steps if k in ("start", "b offloaded", "a offloaded")]
    if any(zero) or not torch.equal(again, out_a) or torch.equal(out_a, out_b):
        raise AssertionError(f"the hook chain left memory on the card or changed outputs: {steps}")
    if not all(model_bytes <= v < 1.1 * model_bytes for k, v in steps if k in ("a ran", "b ran (a evicted)")):
        raise AssertionError(f"a running model did not hold its weights alone: {steps}")
    del lm_a, lm_b, hook_a, hook_b


def phase_big_model(card: str, phase3_rows: list) -> None:
    """Phase 26 (see the module docstring)."""
    with tempfile.TemporaryDirectory(prefix="chip-smoke-big-") as directory:
        t0 = time.perf_counter()
        host = big_export(directory, card)
        export_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        meta = Llama(config_from_hf_json(directory), device="meta")
        shapes = init_empty_weights(meta)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - before
        if allocated or shapes["layers"]["wq"].shape != (22, 2048, 2048):
            raise AssertionError(f"init_empty_weights allocated {allocated} bytes")
        t0 = time.perf_counter()
        streamed = load_checkpoint_and_dispatch(meta, directory, max_memory=big_budget(meta, 2),
                                                offload_dir=os.path.join(directory, "offload"),
                                                dtype=torch.bfloat16)
        load_s = time.perf_counter() - t0
        counts = map_counts(streamed)
        print(f"[big] init_empty_weights allocated {allocated} bytes on the card; load_checkpoint_and_dispatch "
              f"with device_map='auto' in {load_s:.1f} s (export {export_s:.1f} s): {counts['device']} layers "
              f"on the card, {counts['cpu']} in pinned host memory, {counts['disk']} on disk, the resident "
              f"components on the card [{card}]")
        if not all(counts.values()):
            raise AssertionError(f"the auto map does not span device, cpu and disk: {counts}")
        ids = torch.tensor(np.random.default_rng(SEED + 25).integers(1, 32000, (2, 512)), device="cuda")
        parts = {}
        t0 = time.perf_counter()
        yardstick = big_forward(streamed, host, ids, card)
        parts["(b) forward"] = time.perf_counter() - t0
        big_generate(streamed, host, directory, yardstick, card)
        parts["(c) generate"] = time.perf_counter() - t0 - sum(parts.values())
        big_serving(streamed, host, directory, phase3_rows, card)
        parts["(d) serving"] = time.perf_counter() - t0 - sum(parts.values())
        del streamed, host
        big_other_models(card)
        parts["(e) bert, t5, hooks"] = time.perf_counter() - t0 - sum(parts.values())
    print("[big] seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f" [{card}]")
    gc.collect()
    torch.cuda.empty_cache()


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
    launches = {}
    launches["paged_decode"], serving_rows = timed("phase 3 serving", phase_serving, card)
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
    timed("phase 10b flash bias kernels", phase_flash_bias, card)
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
    timed("phase 19 t5", phase_t5, card)
    records.update(timed("phase 20 flash ring blocks", phase_ring_blocks, card))
    ring = timed("phase 21 ring attention across two processes on the card", phase_ring_pair, card)
    for name in FLASH_KERNELS:
        launches[f"{name}_ring"] = ring[name]
    gc.collect()
    torch.cuda.empty_cache()
    gpt2, prompts, rows, gaps = timed("phase 22 gpt2-1.5b serving", phase_gpt2_serving, card)
    timed("phase 23 gpt2-1.5b speculative and int8-resident", phase_gpt2_spec_quant, card, gpt2,
          prompts, rows, gaps)
    del gpt2, prompts, rows, gaps
    timed("phase 24 gpt2-124m training", phase_gpt2_training, card)
    timed("phase 25 the engine's quarantine, watchdog, dense slab and handoff", phase_engine_surface, card)
    timed("phase 26 big-model inference", phase_big_model, card, serving_rows)
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
