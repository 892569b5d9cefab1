"""Flash attention: attention by online softmax, forward and backward.

Replaces the Pallas TPU kernels of ``accelerate_tpu/ops/flash_attention.py``:
``_fwd_kernel`` with the CUDA kernel in ``csrc/flash_fwd.cu``, and
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` with the two in
``csrc/flash_bwd.cu``. The public layout is the model zoo's ``[B, S, N, D]``;
the kernels read it in place (no transposes), tile q and k by 64 rows, and
keep the reference's rounding points: bf16 operands with fp32 accumulation,
the scale applied to the fp32 scores, ``p`` rounded to v's dtype before
``P·V``, ``dS`` rounded to k's / q's dtype before ``dS·K`` and ``dSᵀ·Q``.
The running max starts at ``M_INIT = NEG_INF / 2`` and ``l`` is clamped at
1e-30, so a row that sees no valid key gives exactly 0 (the einsum path's
softmax would give a uniform row). Causal and ``[B, T]`` key-mask bounds cut
the k-tile loops: future and fully padded tiles are skipped, not masked.

What bounds them on the H100: at llama-125m's shapes (head dim 64) the
operations, ``4·B·N·D`` flops per attended (q, k) pair forward and 14 in
the two backward kernels, at 989 TFLOP/s in bf16; at short sequences the
bytes of q, k, v, out (and dO, dq, dk, dv) at 3.35 TB/s. In bf16 every
kernel runs its products by ``wgmma`` on tiles that a producer copies by
TMA into an mbarrier-guarded ring (``csrc/hopper.cuh``), and hands out its
heaviest blocks first; all keep scores, p, dS and the accumulators in
registers; fp32 runs on the CUDA cores. Head dims 32, 64 and 128 are
instantiated (at 32 the bf16 kernels keep 64-column tiles whose upper half
TMA fills with zeros, and store 32 columns). The dq kernel also computes
``delta = rowsum(dO·O)`` for its rows and writes it for the dk/dv kernel,
so the backward launches nothing else. See the sources' headers for what
they leave for later.

Under activation checkpointing (``CompilationConfig.remat_policy``) a
recomputed layer launches the forward kernel again, except under
``"save_flash"``: :func:`flash_stash_contexts` keeps each forward's ``out``
and ``lse`` from the checkpointed forward and hands them back to the
recompute, whose autograd node then runs only the backward kernels.

An additive fp32 score ``bias`` ``[1|B, N, S, T]`` (T5's relative
positions) is a compile-time variant of each kernel: added to the scaled
scores before the causal limit and the mask penalty, as the JAX package's
``_block_scores`` does, with its exact gradient ``dbias = p·(dP - delta)``
from the dq kernel, per batch row for a ``[B, ...]`` bias and summed over the
batch in a fixed order for a ``[1, ...]`` one (each dq block walks a chunk of
batch rows into its own slab; a second kernel sums the chunks in order), so
two launches give the same bits. The no-bias kernels are unchanged.

The ring-block entry :func:`flash_attention_block` (the JAX package's,
which ``parallel/ring_attention.py`` calls once per ring step) returns
``(out, lse)``, both differentiable, with causality over global positions
``q_offset + i`` and ``kv_offset + j``: each kernel has a ring variant that
takes the offsets as two runtime ints (``flash_forward_ring`` and the two
``*_ring`` backward entry points of ``csrc/``), so one build serves the
ring's diagonal, past and future blocks; a future block makes no trip and
gives ``out = 0`` and ``lse = M_INIT + log(1e-30)`` exactly. Its backward
takes the cotangent of ``lse`` too, folded into delta by the dq kernel
(``delta = rowsum(dO·O) - dlse``), as the TPU kernels do.

A tensor on the CPU takes the plain PyTorch versions
(:func:`flash_forward_reference`, :func:`flash_delta_reference`,
:func:`flash_backward_dq_reference`, :func:`flash_backward_dkv_reference`,
each with the ring's ``offsets``); a CUDA tensor launches the kernels or
raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from ..models.attention import dot_product_attention, grouped_output, grouped_scores
from .runtime import load_kernel

FWD_SOURCE = "flash_fwd"
BWD_SOURCE = "flash_bwd"
NEG_INF = -1e30
# running-max init: far below any real score, far above NEG_INF, so masked
# scores underflow exp() even when a row never sees a valid key
M_INIT = NEG_INF / 2
TILE = 64  # csrc/flash_*.cu: kBlockQ = kBlockK, rows of q and of k per tile
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)  # D = 32 runs the D = 64 tiles, zero-filled past 32 by TMA
# the JAX package's backward tiles: they only decide, with the forward's,
# whether a shape tiles (the CUDA kernels choose their own tiles)
BWD_BLOCK_Q = 512
BWD_BLOCK_K = 256


def fit_block(block: int, size: int, floor: int = 1) -> int:
    """Adapt a block size downward (halving, to ``floor``) until it divides
    ``size``: the JAX package's tile-fitting rule, kept for its dispatch."""
    block = min(block, size)
    while block > floor and size % block:
        block //= 2
    return block


_fit_block = functools.partial(fit_block, floor=128)


def _mask_limit(kv_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, T]`` validity -> (mask int32 ``[B, T]``, limit int32 ``[B]``):
    ``limit`` is the index of the last valid key (-1 when the row is fully
    padded), the kernels' dynamic k-tile bound."""
    mask = (kv_mask != 0).to(torch.int32).contiguous()
    idx = torch.arange(mask.shape[1], device=mask.device, dtype=torch.int32)
    limit = torch.where(mask != 0, idx, -1).amax(dim=1).to(torch.int32)
    return mask, limit


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, mask, causal: bool, scale: float, bias=None, offsets=None) -> torch.Tensor:
    """``[B, N, S, T]`` fp32 scores with the kernels' one recipe: q·k from
    the operands' values summed in fp32, times ``scale``, plus the fp32
    ``bias``, causal positions set to NEG_INF, then the mask penalty
    ``(m - 1)·1e30`` added. ``offsets`` ``(q_offset, kv_offset)`` place
    query row i at ``q_offset + i`` and key j at ``kv_offset + j`` for the
    causal comparison (a ring block)."""
    s = grouped_scores(q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        q_off, k_off = offsets or (0, 0)
        q_pos = q_off + torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = k_off + torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, NEG_INF)
    if mask is not None:
        s = s + (mask.float()[:, None, None, :] - 1.0) * -NEG_INF
    return s


def flash_forward_reference(q, k, v, mask=None, causal: bool = True, scale: float = 1.0, bias=None,
                            offsets=None):
    """Plain version of the forward kernel: ``(out [B, S, N, D], lse [B, N,
    S] fp32)``. ``p = exp(s - m)`` is rounded to v's dtype before ``P·V``
    (the kernel's accumulator takes the same rounded p), ``l`` sums the fp32
    p, and ``out = acc / max(l, 1e-30)``."""
    s = _scores(q, k, mask, causal, scale, bias, offsets)
    m = torch.clamp(s.amax(dim=-1), min=M_INIT)  # [B, N, S]
    p = torch.exp(s - m[..., None])
    l_safe = torch.clamp(p.sum(dim=-1), min=1e-30)
    acc = grouped_output(p.to(v.dtype).float(), v.float())  # [B, S, N, D]
    out = (acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


def flash_delta_reference(do, out, dlse=None) -> torch.Tensor:
    """``delta = rowsum(dO·O)`` in fp32, ``[B, N, S]``: the backward's row
    term, as the JAX package computes it outside its kernels; minus the
    lse cotangent ``dlse`` ``[B, N, S]`` where the lse is an output (a ring
    block), so that ``dS = p·(dP - rowsum(dO·O) + dlse)``."""
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    return delta if dlse is None else delta - dlse.float()


def _backward_terms(q, k, v, mask, do, lse, delta, causal, scale, bias=None, offsets=None):
    """``(p fp32, dS fp32, ds rounded to k's dtype)`` of the backward
    kernels: ``p = exp(s - lse)``, ``dS = p·(dP - delta)`` (the bias's
    gradient), ``ds = (dS·scale)`` rounded, with ``dP = dO·Vᵀ`` summed in
    fp32."""
    s = _scores(q, k, mask, causal, scale, bias, offsets)
    p = torch.exp(s - lse[..., None])
    dp = grouped_scores(do.float(), v.float())
    dsb = p * (dp - delta[..., None])
    return p, dsb, (dsb * scale).to(k.dtype)


def _group_sum(x: torch.Tensor, kv: int) -> torch.Tensor:
    """``[B, T, N, D]`` per query head -> ``[B, T, KV, D]`` summed over each
    kv head's group (query head h reads kv head h // group)."""
    b, t, n, d = x.shape
    return x.reshape(b, t, kv, n // kv, d).sum(dim=3)


def flash_backward_dq_reference(q, k, v, mask, do, lse, delta, causal=True, scale=1.0, bias=None,
                                offsets=None):
    """Plain version of the dq kernel: ``dq = ds·K`` summed in fp32, in q's
    dtype. With a ``bias``, ``(dq, dbias)``: ``dbias`` fp32 shaped like the
    bias, ``dS`` per batch row for a ``[B, ...]`` bias and summed over the
    batch for a ``[1, ...]`` one."""
    _, dsb, ds = _backward_terms(q, k, v, mask, do, lse, delta, causal, scale, bias, offsets)
    dq = grouped_output(ds.float(), k.float()).to(q.dtype)
    if bias is None:
        return dq
    return dq, (dsb if bias.shape[0] == q.shape[0] else dsb.sum(dim=0, keepdim=True))


def flash_backward_dkv_reference(q, k, v, mask, do, lse, delta, causal=True, scale=1.0, bias=None,
                                 offsets=None):
    """Plain version of the dk/dv kernel: ``dv = pᵀ·dO`` with p rounded to
    dO's dtype, ``dk = dsᵀ·Q``, both summed in fp32 over the kv head's query
    heads, in k's and v's dtypes."""
    p, _, ds = _backward_terms(q, k, v, mask, do, lse, delta, causal, scale, bias, offsets)
    kv = k.shape[2]
    dv = torch.einsum("bnst,bsnd->btnd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bnst,bsnd->btnd", ds.float(), q.float())
    return _group_sum(dk, kv).to(k.dtype), _group_sum(dv, kv).to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers: the CPU takes the plain version, CUDA launches or raises
# ---------------------------------------------------------------------------


# the C entry points' argument types, in order: the pointers, the ints, then scale, causal,
# dtype and the stream (tests/test_torch_flash_attention.py holds them against csrc/)
_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
ARGTYPES = {
    "flash_forward": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + _TAIL,
    "flash_backward_dq": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + _TAIL,
    "flash_backward_dkv": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + _TAIL,
    # the ring-block variants: no bias; B, S, T, NH, KV, D, q_offset, kv_offset
    "flash_forward_ring": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + _TAIL,
    "flash_backward_dq_ring": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + _TAIL,
    "flash_backward_dkv_ring": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + _TAIL,
}


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    lib = load_kernel(FWD_SOURCE)
    for name in ("flash_forward", "flash_forward_ring"):
        getattr(lib, name).argtypes = ARGTYPES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = load_kernel(BWD_SOURCE)
    for name in ("flash_backward_dq", "flash_backward_dkv", "flash_backward_dq_ring", "flash_backward_dkv_ring"):
        getattr(lib, name).argtypes = ARGTYPES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, mask, limit, *rows, bias=None) -> tuple[int, int, int, int, int, int]:
    """What a launch needs; returns ``(B, S, T, NH, KV, D)``. ``bias`` (fp32
    ``[1|B, NH, S, T]``) is exempt from the operands' one dtype."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash attention takes [B, S, N, D] tensors")
    b, s, nh, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernels (takes {_HEAD_DIMS})")
    if nh % kv:
        raise ValueError(f"num_heads {nh} is not a multiple of kv_heads {kv}")
    if s % TILE or t % TILE:
        raise ValueError(f"sequence lengths {s}, {t} must be multiples of {TILE}")
    if tuple(k.shape) != (b, t, kv, d) or tuple(v.shape) != (b, t, kv, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be [{b}, T, KV, {d}]")
    tensors = [q, k, v, *rows]
    for x in tensors:
        if x.dtype != q.dtype:
            raise TypeError(f"every operand must be {q.dtype}, one is {x.dtype}")
    if mask is not None:
        if mask.dtype != torch.int32 or tuple(mask.shape) != (b, t):
            raise ValueError(f"mask must be int32 [{b}, {t}]")
        if limit is None or limit.dtype != torch.int32 or tuple(limit.shape) != (b,):
            raise ValueError(f"limit must be int32 [{b}]")
        tensors += [mask, limit]
    if bias is not None:
        if bias.dtype != torch.float32 or bias.dim() != 4 or bias.shape[0] not in (1, b) \
                or tuple(bias.shape[1:]) != (nh, s, t):
            raise ValueError(f"bias must be float32 [1|{b}, {nh}, {s}, {t}], got {bias.dtype} {tuple(bias.shape)}")
        tensors.append(bias)
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, one is on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("the kernels take contiguous, 16-byte aligned tensors")
    return b, s, t, nh, kv, d


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _raise_on(code: int, lib: ctypes.CDLL, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {lib.flash_error_string(code).decode()} ({code})")


def _bias_operand(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The bias as the kernels take it: contiguous fp32."""
    return None if bias is None else bias.to(torch.float32).contiguous()


def _batched(bias: Optional[torch.Tensor], b: int) -> int:
    """1 when ``bias`` has a row per batch row (and B > 1), else 0."""
    return int(bias is not None and bias.shape[0] == b and b > 1)


def _ring_operands(bias, offsets) -> tuple[int, int]:
    """The ring variants' ``(q_offset, kv_offset)`` as ints; they take no bias."""
    if bias is not None:
        raise ValueError("the ring-block kernels take no bias")
    q_off, k_off = offsets
    return int(q_off), int(k_off)


def flash_forward(q, k, v, mask=None, limit=None, causal: bool = True, scale: float = 1.0, bias=None,
                  offsets=None):
    """Forward kernel: ``(out [B, S, N, D] in q's dtype, lse [B, N, S]
    fp32)``. ``mask``/``limit`` come from :func:`_mask_limit`; ``bias`` is
    an additive ``[1|B, N, S, T]`` score bias (the kernel reads it in fp32).
    ``offsets`` ``(q_offset, kv_offset)`` (ints) run the ring-block variant:
    causal over global positions, no bias."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, mask, causal, scale, bias, offsets)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    q, k, v, bias = q.contiguous(), k.contiguous(), v.contiguous(), _bias_operand(bias)
    b, s, t, nh, kv, d = _check(q, k, v, mask, limit, bias=bias)
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    lib = _fwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if offsets is None:
            code = lib.flash_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(limit), _ptr(bias),
                out.data_ptr(), lse.data_ptr(), b, s, t, nh, kv, d, _batched(bias, b), scale, int(causal),
                _DTYPE_CODES[q.dtype], stream,
            )
        else:
            code = lib.flash_forward_ring(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(limit), out.data_ptr(),
                lse.data_ptr(), b, s, t, nh, kv, d, *_ring_operands(bias, offsets), scale, int(causal),
                _DTYPE_CODES[q.dtype], stream,
            )
    _raise_on(code, lib, "flash_forward")
    flash_forward.launches += 1
    flash_forward.bias_launches += bias is not None
    flash_forward.ring_launches += offsets is not None
    return out, lse


def _backward_args(q, k, v, mask, limit, do, rows, out=None, bias=None):
    """Contiguous operands and their dims; ``rows`` are the fp32 ``[B, N,
    S]`` row inputs by name (lse, and delta for the dk/dv kernel)."""
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    if out is not None:
        out = out.contiguous()
    dims = _check(q, k, v, mask, limit, do, *([] if out is None else [out]), bias=bias)
    b, s, _, nh, _, _ = dims
    for x in (do, out):
        if x is not None and tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"dO and out must be shaped like q {tuple(q.shape)}, one is {tuple(x.shape)}")
    for name, x in rows.items():
        if x.dtype != torch.float32 or tuple(x.shape) != (b, nh, s) or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{b}, {nh}, {s}]")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return q, k, v, do, out, dims


def dbias_chunk(b: int, nh: int, s: int, sms: int) -> int:
    """Batch rows a dq block walks for a broadcast bias's gradient: the
    batch splits into chunks so that the blocks (one per 64 query rows,
    head and chunk) number about four per SM; each chunk's partial sum is
    written once, and a second kernel adds the chunks in order."""
    chunks = min(b, max(1, math.ceil(4 * sms / (nh * (s // TILE)))))
    return math.ceil(b / chunks)


def flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal: bool = True, scale: float = 1.0,
                      bias=None, offsets=None, dlse=None):
    """dq kernel: one block per (batch, head, 64 q rows at head dim 64, 192
    at 128), k tiles up to the forward's bound. It also computes ``delta =
    rowsum(dO·O)`` fp32 ``[B, N, S]`` for its rows from ``do`` and the
    forward's ``out``; returns ``(dq, delta)``, delta for
    :func:`flash_backward_dkv`. With a ``bias``, ``(dq, delta, dbias)``,
    ``dbias`` fp32 shaped like the bias. ``offsets`` or ``dlse`` (the lse
    cotangent, fp32 ``[B, N, S]``) run the ring-block variant, which writes
    ``delta = rowsum(dO·O) - dlse``."""
    if q.device.type == "cpu":
        delta = flash_delta_reference(do, out, dlse)
        args = (q, k, v, mask, do, lse, delta, causal, scale)
        if bias is None:
            return flash_backward_dq_reference(*args, offsets=offsets), delta
        dq, dbias = flash_backward_dq_reference(*args, bias)
        return dq, delta, dbias
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    bias = _bias_operand(bias)
    rows = {"lse": lse}
    ring = offsets is not None or dlse is not None
    if ring:
        q_off, k_off = _ring_operands(bias, offsets or (0, 0))
        rows["dlse"] = dlse = torch.zeros_like(lse) if dlse is None else dlse.to(torch.float32).contiguous()
    q, k, v, do, out, (b, s, t, nh, kv, d) = _backward_args(q, k, v, mask, limit, do, rows, out, bias)
    dq = torch.empty_like(q)
    delta = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    dbias = part = None
    chunk = 1
    if bias is not None:
        dbias = torch.empty_like(bias)
        part = dbias
        if not _batched(bias, b):
            chunk = dbias_chunk(b, nh, s, torch.cuda.get_device_properties(q.device).multi_processor_count)
            chunks = math.ceil(b / chunk)
            if chunks > 1:
                part = torch.empty((chunks, nh, s, t), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if ring:
            code = lib.flash_backward_dq_ring(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(limit), do.data_ptr(),
                out.data_ptr(), lse.data_ptr(), dlse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                b, s, t, nh, kv, d, q_off, k_off, scale, int(causal), _DTYPE_CODES[q.dtype], stream,
            )
        else:
            code = lib.flash_backward_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(limit), _ptr(bias), do.data_ptr(),
                out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(dbias), _ptr(part),
                b, s, t, nh, kv, d, _batched(bias, b), chunk, scale, int(causal), _DTYPE_CODES[q.dtype],
                stream,
            )
    _raise_on(code, lib, "flash_backward_dq")
    flash_backward_dq.launches += 1
    flash_backward_dq.bias_launches += bias is not None
    flash_backward_dq.ring_launches += ring
    return (dq, delta) if bias is None else (dq, delta, dbias)


def flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal: bool = True, scale: float = 1.0,
                       bias=None, offsets=None):
    """dk/dv kernel: one block per (batch, kv head, 64 keys), looping over
    the q tiles from the causal lower bound and over the kv head's query
    heads, so dk and dv accumulate without atomics. ``delta`` is what
    :func:`flash_backward_dq` returns; ``bias`` the forward's. ``offsets``
    run the ring-block variant."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, mask, do, lse, delta, causal, scale, bias, offsets)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    rows = {"lse": lse, "delta": delta}
    bias = _bias_operand(bias)
    q, k, v, do, _, (b, s, t, nh, kv, d) = _backward_args(q, k, v, mask, limit, do, rows, bias=bias)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if offsets is None:
            code = lib.flash_backward_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(limit), _ptr(bias), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, t, nh, kv, d,
                _batched(bias, b), scale, int(causal), _DTYPE_CODES[q.dtype], stream,
            )
        else:
            code = lib.flash_backward_dkv_ring(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(limit), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, t, nh, kv, d,
                *_ring_operands(bias, offsets), scale, int(causal), _DTYPE_CODES[q.dtype], stream,
            )
    _raise_on(code, lib, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    flash_backward_dkv.bias_launches += bias is not None
    flash_backward_dkv.ring_launches += offsets is not None
    return dk, dv


# launches of each kernel, and of those the bias and the ring-block variants'
for _wrapper in (flash_forward, flash_backward_dq, flash_backward_dkv):
    _wrapper.launches = _wrapper.bias_launches = _wrapper.ring_launches = 0


def flash_backward(q, k, v, mask, limit, do, lse, out, causal: bool = True, scale: float = 1.0, bias=None,
                   offsets=None, dlse=None):
    """The whole backward, ``(dq, dk, dv)``, with a ``bias`` ``(dq, dk, dv,
    dbias)``: the dq kernel (which also writes delta and dbias), then the
    dk/dv kernel. On the CPU, the plain versions with ``delta`` by
    :func:`flash_delta_reference`. ``offsets`` and ``dlse`` (a ring block's
    global positions and lse cotangent) run the ring-block variants."""
    if bias is None:
        dq, delta = flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal, scale, offsets=offsets,
                                      dlse=dlse)
        dk, dv = flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal, scale, offsets=offsets)
        return dq, dk, dv
    dq, delta, dbias = flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal, scale, bias)
    dk, dv = flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal, scale, bias)
    return dq, dk, dv, dbias


def _vjp(ctx, do):
    """The backward of both autograd functions: ``(dq, dk, dv, dbias)``,
    dbias in the bias's dtype (None without a bias)."""
    q, k, v, mask, limit, bias, out, lse = ctx.saved_tensors
    if bias is None:
        return (*flash_backward(q, k, v, mask, limit, do, lse, out, ctx.causal, ctx.scale), None)
    dq, dk, dv, dbias = flash_backward(q, k, v, mask, limit, do, lse, out, ctx.causal, ctx.scale, bias)
    return dq, dk, dv, dbias.to(bias.dtype)


class _FlashAttention(torch.autograd.Function):
    """The custom vjp of the JAX package: the forward saves ``out`` and
    ``lse``; the backward is :func:`flash_backward`. It returns ``lse`` too
    (not differentiable), for the ``save_flash`` stash."""

    @staticmethod
    def forward(ctx, q, k, v, mask, limit, bias, causal, scale):
        out, lse = flash_forward(q, k, v, mask, limit, causal, scale, *([] if bias is None else [bias]))
        ctx.save_for_backward(q, k, v, mask, limit, bias, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        dq, dk, dv, dbias = _vjp(ctx, do)
        return dq, dk, dv, None, None, dbias, None, None


class _FlashFromSaved(torch.autograd.Function):
    """The same vjp over an ``out`` and ``lse`` the forward kernel gave
    before: a recomputed layer under ``save_flash`` launches no forward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, limit, bias, out, lse, causal, scale):
        ctx.save_for_backward(q, k, v, mask, limit, bias, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv, dbias = _vjp(ctx, do)
        return dq, dk, dv, None, None, dbias, None, None, None, None


class _FlashBlock(torch.autograd.Function):
    """The ring block's vjp (the JAX package's ``_flash_attention_lse_bnsd``):
    ``out`` and ``lse`` are both outputs, and the backward takes the lse
    cotangent, folded into delta by the dq kernel. ``saved`` is a
    recompute's ``(out, lse)`` from the ``save_flash`` stash (no forward
    launch), else None."""

    @staticmethod
    def forward(ctx, q, k, v, mask, limit, causal, scale, offsets, saved):
        out, lse = saved if saved is not None else flash_forward(q, k, v, mask, limit, causal, scale,
                                                                 offsets=offsets)
        ctx.save_for_backward(q, k, v, mask, limit, out, lse)
        ctx.causal, ctx.scale, ctx.offsets = causal, scale, offsets
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, mask, limit, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, mask, limit, do, lse, out, ctx.causal, ctx.scale,
                                    offsets=ctx.offsets, dlse=dlse.contiguous())
        return dq, dk, dv, None, None, None, None, None, None


class _Stash(threading.local):
    """Per thread: ``"record"`` (a checkpointed forward keeps each flash
    forward's ``out`` and ``lse``) or ``"replay"`` (its recompute, in the
    backward's thread, takes them back in call order). A ring layer's
    blocks are kept and replayed the same way, one entry a block."""

    mode: Optional[str] = None
    saved: Optional[list] = None
    index = 0


_STASH = _Stash()


@contextlib.contextmanager
def _stash_mode(mode: str, saved: list):
    previous = (_STASH.mode, _STASH.saved, _STASH.index)
    _STASH.mode, _STASH.saved, _STASH.index = mode, saved, 0
    try:
        yield
    finally:
        _STASH.mode, _STASH.saved, _STASH.index = previous


def flash_stash_contexts():
    """``(forward, recompute)`` context managers for
    ``torch.utils.checkpoint``'s ``context_fn``: the checkpointed forward
    records every flash forward's ``out`` and ``lse``, and the recompute
    replays them instead of launching the kernel again
    (``remat_policy="save_flash"``). Plain context managers, not a dispatch
    mode: the rest of the region runs, and is recomputed, at full speed."""
    saved: list = []
    return _stash_mode("record", saved), _stash_mode("replay", saved)


def flash_attention_core(q, k, v, mask=None, limit=None, causal: bool = True, scale: float = 1.0, bias=None):
    """The differentiable flash attention over prepared operands: ``out``
    ``[B, S, N, D]`` by the forward kernel; the backward is the dq and dk/dv
    kernels. ``mask``/``limit`` come from :func:`_mask_limit`; ``bias``
    ``[1|B, N, S, T]`` gets its gradient from the dq kernel."""
    causal, scale = bool(causal), float(scale)
    if _STASH.mode == "replay":
        out, lse = _STASH.saved[_STASH.index]
        _STASH.index += 1
        return _FlashFromSaved.apply(q, k, v, mask, limit, bias, out, lse, causal, scale)
    out, lse = _FlashAttention.apply(q, k, v, mask, limit, bias, causal, scale)
    if _STASH.mode == "record":
        _STASH.saved.append((out.detach(), lse))
    return out


def flash_attention(
    q: torch.Tensor,  # [B, S, N, D] (model-zoo layout)
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    kv_mask: Optional[torch.Tensor] = None,  # [B, T] key validity (1 = attend)
    block_q: int = 256,
    block_k: int = 512,
    bwd_block_q: Optional[int] = None,
    bwd_block_k: Optional[int] = None,
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,  # [1|B, N, S, T] additive (T5 rel bias)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention with the ``attention_fn`` hook signature, and the
    JAX package's dispatch: a shape that cannot tile (a length that is no
    multiple of 128 after its blocks adapt, or causal with S != T) takes the
    einsum path; every other shape runs the kernels, masks, the non-causal
    mode and an additive ``bias`` with its exact gradient included (pass
    ``scale=1.0`` for T5, which folds 1/sqrt(d) into its init). The block
    arguments only feed that rule."""
    b, s, n, d = q.shape
    t = k.shape[1]
    bq, bk = _fit_block(block_q, s), _fit_block(block_k, t)
    bbq = _fit_block(bwd_block_q or BWD_BLOCK_Q, s)
    bbk = _fit_block(bwd_block_k or BWD_BLOCK_K, t)
    untileable = any(x % 128 for x in (bq, bk, bbq, bbk)) or s % bq or t % bk or s % bbq or t % bbk
    if untileable or (causal and s != t):
        mask = None if kv_mask is None else kv_mask[:, None, None, :].bool()
        return dot_product_attention(q, k, v, mask=mask, causal=causal, scale=scale, bias=bias)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if bias is not None and bias.shape[0] not in (1, b):
        # the kernels know a broadcast or a batched bias only
        raise ValueError(f"bias batch dim must be 1 or {b}, got {bias.shape[0]}")
    mask = limit = None
    if kv_mask is not None:
        mask, limit = _mask_limit(kv_mask)
    return flash_attention_core(q, k, v, mask, limit, causal, scale, bias)


def flash_block_core(q, k, v, mask=None, limit=None, causal: bool = False, scale: float = 1.0, offsets=None):
    """The differentiable ring block over prepared operands: ``(out [B, S,
    N, D], lse [B, N, S] fp32)`` by the forward kernel (its ring variant
    under ``offsets``); the backward is the dq and dk/dv kernels with the
    lse cotangent. Under ``save_flash`` the stash keeps and replays each
    block's ``(out, lse)`` as it does a layer's one flash call."""
    causal, scale = bool(causal), float(scale)
    saved = None
    if _STASH.mode == "replay":
        saved = _STASH.saved[_STASH.index]
        _STASH.index += 1
    out, lse = _FlashBlock.apply(q, k, v, mask, limit, causal, scale, offsets, saved)
    if _STASH.mode == "record":
        _STASH.saved.append((out.detach(), lse.detach()))
    return out, lse


def _einsum_attention_lse(q, k, v, kv_mask, causal, q_offset, kv_offset, scale):
    """The block entry's exact fallback, with its ``(out, lse)`` contract
    (the JAX package's ``_einsum_attention_lse``): a row that attends no key
    gives ``out = 0`` and ``lse = M_INIT + log(1e-30)``."""
    s, d = q.shape[1], q.shape[3]
    t = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scores = grouped_scores(q, k).to(torch.float32) * scale
    if causal:
        q_pos = (0 if q_offset is None else int(q_offset)) + torch.arange(s, device=q.device)
        k_pos = (0 if kv_offset is None else int(kv_offset)) + torch.arange(t, device=q.device)
        scores = torch.where(k_pos[None, :] <= q_pos[:, None], scores, NEG_INF)
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, :] != 0, scores, NEG_INF)
    m = torch.clamp(scores.amax(dim=-1), min=M_INIT)  # [B, N, S]
    p = torch.exp(scores - m[..., None])
    l_safe = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = grouped_output((p / l_safe[..., None]).to(q.dtype), v)
    return out, (m + torch.log(l_safe)).transpose(1, 2)


def flash_attention_block(
    q: torch.Tensor,  # [B, S, N, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    kv_mask: Optional[torch.Tensor] = None,  # [B, T] key validity
    *,
    causal: bool = False,
    q_offset: Optional[int] = None,  # global position of q[:, 0]
    kv_offset: Optional[int] = None,  # global position of k[:, 0]
    block_q: int = 256,
    block_k: int = 512,
    bwd_block_q: Optional[int] = None,
    bwd_block_k: Optional[int] = None,
    scale: Optional[float] = None,
):
    """One attention block with its online-softmax statistics: ``(out,
    lse)``, ``out`` ``[B, S, N, D]`` the block's normalized attention and
    ``lse`` ``[B, S, N]`` fp32 its log-sum-exp, what a ring merge needs.
    Both outputs are differentiable (the merge weighs blocks by lse).

    ``causal`` compares global positions ``q_offset + i >= kv_offset + j``
    (the offsets are ints: the ring's rotation index is known on the host),
    so one build of each kernel serves the ring's diagonal, past and future
    blocks (a future block makes no trip: ``out`` 0 and ``lse`` very
    negative, exactly). Without offsets causal S != T compares local
    positions (top-left). The JAX package's dispatch: an untileable shape
    takes the exact einsum fallback; the block arguments only feed that
    rule."""
    b, s, n, d = q.shape
    t = k.shape[1]
    bq, bk = _fit_block(block_q, s), _fit_block(block_k, t)
    bbq = _fit_block(bwd_block_q or BWD_BLOCK_Q, s)
    bbk = _fit_block(bwd_block_k or BWD_BLOCK_K, t)
    untileable = any(x % 128 for x in (bq, bk, bbq, bbk)) or s % bq or t % bk or s % bbq or t % bbk
    if untileable:
        return _einsum_attention_lse(q, k, v, kv_mask, causal, q_offset, kv_offset, scale)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = limit = None
    if kv_mask is not None:
        mask, limit = _mask_limit(kv_mask)
    offsets = None
    if causal and (q_offset is not None or kv_offset is not None):
        offsets = (int(q_offset or 0), int(kv_offset or 0))
    out, lse = flash_block_core(q, k, v, mask, limit, causal, scale, offsets)
    return out, lse.transpose(1, 2)


def make_auto_attention(min_seq: int = 1024, causal: bool = True):
    """Per-shape dispatch: sequences of at least ``min_seq`` tokens run the
    flash kernels, shorter ones the einsum path, a ``bias`` on either.
    ``causal`` is the model-level default; a per-call ``causal`` overrides
    it, so one hook serves T5's bidirectional encoder and causal decoder."""

    def attention(q, k, v, kv_mask=None, bias=None, scale=None, causal=None):
        causal_ = make_causal if causal is None else causal
        if q.shape[1] >= min_seq:
            return flash_attention(q, k, v, kv_mask, causal=causal_, bias=bias, scale=scale)
        mask = None if kv_mask is None else kv_mask[:, None, None, :].bool()
        return dot_product_attention(q, k, v, mask=mask, causal=causal_, scale=scale, bias=bias)

    make_causal = causal
    # the hook takes bias, scale and causal: T5 engages only a hook that says so
    attention.supports_bias = True
    return attention
