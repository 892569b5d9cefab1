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

A tensor on the CPU takes the plain PyTorch versions
(:func:`flash_forward_reference`, :func:`flash_delta_reference`,
:func:`flash_backward_dq_reference`, :func:`flash_backward_dkv_reference`);
a CUDA tensor launches the kernels or raises. The additive ``bias`` (T5,
ROADMAP item 16) and the ring ``offsets`` entry (ROADMAP item 17) raise
``NotImplementedError``.
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


def _scores(q, k, mask, causal: bool, scale: float) -> torch.Tensor:
    """``[B, N, S, T]`` fp32 scores with the kernels' one recipe: q·k from
    the operands' values summed in fp32, times ``scale``, causal positions
    set to NEG_INF, then the mask penalty ``(m - 1)·1e30`` added."""
    s = grouped_scores(q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, NEG_INF)
    if mask is not None:
        s = s + (mask.float()[:, None, None, :] - 1.0) * -NEG_INF
    return s


def flash_forward_reference(q, k, v, mask=None, causal: bool = True, scale: float = 1.0):
    """Plain version of the forward kernel: ``(out [B, S, N, D], lse [B, N,
    S] fp32)``. ``p = exp(s - m)`` is rounded to v's dtype before ``P·V``
    (the kernel's accumulator takes the same rounded p), ``l`` sums the fp32
    p, and ``out = acc / max(l, 1e-30)``."""
    s = _scores(q, k, mask, causal, scale)
    m = torch.clamp(s.amax(dim=-1), min=M_INIT)  # [B, N, S]
    p = torch.exp(s - m[..., None])
    l_safe = torch.clamp(p.sum(dim=-1), min=1e-30)
    acc = grouped_output(p.to(v.dtype).float(), v.float())  # [B, S, N, D]
    out = (acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


def flash_delta_reference(do, out) -> torch.Tensor:
    """``delta = rowsum(dO·O)`` in fp32, ``[B, N, S]``: the backward's row
    term, as the JAX package computes it outside its kernels."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _backward_terms(q, k, v, mask, do, lse, delta, causal, scale):
    """``(p fp32, ds rounded to k's dtype)`` of the backward kernels:
    ``p = exp(s - lse)``, ``dS = p·(dP - delta)``, ``ds = (dS·scale)``
    rounded, with ``dP = dO·Vᵀ`` summed in fp32."""
    s = _scores(q, k, mask, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = grouped_scores(do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(k.dtype)
    return p, ds


def _group_sum(x: torch.Tensor, kv: int) -> torch.Tensor:
    """``[B, T, N, D]`` per query head -> ``[B, T, KV, D]`` summed over each
    kv head's group (query head h reads kv head h // group)."""
    b, t, n, d = x.shape
    return x.reshape(b, t, kv, n // kv, d).sum(dim=3)


def flash_backward_dq_reference(q, k, v, mask, do, lse, delta, causal=True, scale=1.0):
    """Plain version of the dq kernel: ``dq = ds·K`` summed in fp32, in q's dtype."""
    _, ds = _backward_terms(q, k, v, mask, do, lse, delta, causal, scale)
    return grouped_output(ds.float(), k.float()).to(q.dtype)


def flash_backward_dkv_reference(q, k, v, mask, do, lse, delta, causal=True, scale=1.0):
    """Plain version of the dk/dv kernel: ``dv = pᵀ·dO`` with p rounded to
    dO's dtype, ``dk = dsᵀ·Q``, both summed in fp32 over the kv head's query
    heads, in k's and v's dtypes."""
    p, ds = _backward_terms(q, k, v, mask, do, lse, delta, causal, scale)
    kv = k.shape[2]
    dv = torch.einsum("bnst,bsnd->btnd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bnst,bsnd->btnd", ds.float(), q.float())
    return _group_sum(dk, kv).to(k.dtype), _group_sum(dv, kv).to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers: the CPU takes the plain version, CUDA launches or raises
# ---------------------------------------------------------------------------


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    lib = load_kernel(FWD_SOURCE)
    lib.flash_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.flash_forward.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = load_kernel(BWD_SOURCE)
    args = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.flash_backward_dq.argtypes = args
    lib.flash_backward_dq.restype = ctypes.c_int
    lib.flash_backward_dkv.argtypes = args
    lib.flash_backward_dkv.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, mask, limit, *rows) -> tuple[int, int, int, int, int, int]:
    """What a launch needs; returns ``(B, S, T, NH, KV, D)``."""
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


def flash_forward(q, k, v, mask=None, limit=None, causal: bool = True, scale: float = 1.0):
    """Forward kernel: ``(out [B, S, N, D] in q's dtype, lse [B, N, S]
    fp32)``. ``mask``/``limit`` come from :func:`_mask_limit`."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, s, t, nh, kv, d = _check(q, k, v, mask, limit)
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    lib = _fwd_library()
    with torch.cuda.device(q.device):
        code = lib.flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(limit),
            out.data_ptr(), lse.data_ptr(), b, s, t, nh, kv, d, scale, int(causal),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(code, lib, "flash_forward")
    flash_forward.launches += 1
    return out, lse


def _backward_args(q, k, v, mask, limit, do, rows, out=None):
    """Contiguous operands and their dims; ``rows`` are the fp32 ``[B, N,
    S]`` row inputs by name (lse, and delta for the dk/dv kernel)."""
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    if out is not None:
        out = out.contiguous()
    dims = _check(q, k, v, mask, limit, do, *([] if out is None else [out]))
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


def flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal: bool = True, scale: float = 1.0):
    """dq kernel: one block per (batch, head, 64 q rows at head dim 64, 192
    at 128), k tiles up to the forward's bound. It also computes ``delta =
    rowsum(dO·O)`` fp32 ``[B, N, S]`` for its rows from ``do`` and the
    forward's ``out``; returns ``(dq, delta)``, delta for
    :func:`flash_backward_dkv`."""
    if q.device.type == "cpu":
        delta = flash_delta_reference(do, out)
        return flash_backward_dq_reference(q, k, v, mask, do, lse, delta, causal, scale), delta
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    q, k, v, do, out, (b, s, t, nh, kv, d) = _backward_args(q, k, v, mask, limit, do, {"lse": lse}, out)
    dq = torch.empty_like(q)
    delta = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        code = lib.flash_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(limit), do.data_ptr(),
            out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, t, nh, kv, d,
            scale, int(causal), _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(code, lib, "flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq, delta


def flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal: bool = True, scale: float = 1.0):
    """dk/dv kernel: one block per (batch, kv head, 64 keys), looping over
    the q tiles from the causal lower bound and over the kv head's query
    heads, so dk and dv accumulate without atomics. ``delta`` is what
    :func:`flash_backward_dq` returns."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, mask, do, lse, delta, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    rows = {"lse": lse, "delta": delta}
    q, k, v, do, _, (b, s, t, nh, kv, d) = _backward_args(q, k, v, mask, limit, do, rows)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        code = lib.flash_backward_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(limit), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, t, nh, kv, d,
            scale, int(causal), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(code, lib, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


def flash_backward(q, k, v, mask, limit, do, lse, out, causal: bool = True, scale: float = 1.0):
    """The whole backward, ``(dq, dk, dv)``: the dq kernel (which also
    writes delta), then the dk/dv kernel. On the CPU, the plain versions
    with ``delta`` by :func:`flash_delta_reference`."""
    dq, delta = flash_backward_dq(q, k, v, mask, limit, do, lse, out, causal, scale)
    dk, dv = flash_backward_dkv(q, k, v, mask, limit, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom vjp of the JAX package: the forward saves ``out`` and
    ``lse``; the backward is :func:`flash_backward`. It returns ``lse`` too
    (not differentiable), for the ``save_flash`` stash."""

    @staticmethod
    def forward(ctx, q, k, v, mask, limit, causal, scale):
        out, lse = flash_forward(q, k, v, mask, limit, causal, scale)
        ctx.save_for_backward(q, k, v, mask, limit, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, mask, limit, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, mask, limit, do, lse, out, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


class _FlashFromSaved(torch.autograd.Function):
    """The same vjp over an ``out`` and ``lse`` the forward kernel gave
    before: a recomputed layer under ``save_flash`` launches no forward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, limit, out, lse, causal, scale):
        ctx.save_for_backward(q, k, v, mask, limit, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, limit, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, mask, limit, do, lse, out, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None


class _Stash(threading.local):
    """Per thread: ``"record"`` (a checkpointed forward keeps each flash
    forward's ``out`` and ``lse``) or ``"replay"`` (its recompute, in the
    backward's thread, takes them back in call order)."""

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


def flash_attention_core(q, k, v, mask=None, limit=None, causal: bool = True, scale: float = 1.0):
    """The differentiable flash attention over prepared operands: ``out``
    ``[B, S, N, D]`` by the forward kernel; the backward is the dq and dk/dv
    kernels. ``mask``/``limit`` come from :func:`_mask_limit`."""
    causal, scale = bool(causal), float(scale)
    if _STASH.mode == "replay":
        out, lse = _STASH.saved[_STASH.index]
        _STASH.index += 1
        return _FlashFromSaved.apply(q, k, v, mask, limit, out, lse, causal, scale)
    out, lse = _FlashAttention.apply(q, k, v, mask, limit, causal, scale)
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
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention with the ``attention_fn`` hook signature, and the
    JAX package's dispatch: a shape that cannot tile (a length that is no
    multiple of 128 after its blocks adapt, or causal with S != T) takes the
    einsum path; every other shape runs the kernels, masks and the
    non-causal mode included. The block arguments only feed that rule."""
    if bias is not None:
        raise NotImplementedError(
            "an additive attention bias and its gradient (T5) are not in the port yet "
            "(ROADMAP item 16)"
        )
    b, s, n, d = q.shape
    t = k.shape[1]
    bq, bk = _fit_block(block_q, s), _fit_block(block_k, t)
    bbq = _fit_block(bwd_block_q or BWD_BLOCK_Q, s)
    bbk = _fit_block(bwd_block_k or BWD_BLOCK_K, t)
    untileable = any(x % 128 for x in (bq, bk, bbq, bbk)) or s % bq or t % bk or s % bbq or t % bbk
    if untileable or (causal and s != t):
        mask = None if kv_mask is None else kv_mask[:, None, None, :].bool()
        return dot_product_attention(q, k, v, mask=mask, causal=causal, scale=scale)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = limit = None
    if kv_mask is not None:
        mask, limit = _mask_limit(kv_mask)
    return flash_attention_core(q, k, v, mask, limit, causal, scale)


def flash_attention_block(q, k, v, kv_mask=None, *, causal=False, q_offset=None, kv_offset=None, **_):
    """The ring-attention block entry with ``(out, lse)`` and global
    offsets: not in the port yet."""
    raise NotImplementedError(
        "flash_attention_block (ring blocks with global offsets and an lse "
        "cotangent) is not in the port yet (ROADMAP item 17)"
    )


def make_auto_attention(min_seq: int = 1024, causal: bool = True):
    """Per-shape dispatch: sequences of at least ``min_seq`` tokens run the
    flash kernels, shorter ones the einsum path. ``causal`` is the
    model-level default; a per-call ``causal`` overrides it."""

    def attention(q, k, v, kv_mask=None, bias=None, scale=None, causal=None):
        causal_ = make_causal if causal is None else causal
        if q.shape[1] >= min_seq:
            return flash_attention(q, k, v, kv_mask, causal=causal_, bias=bias, scale=scale)
        if bias is not None:
            raise NotImplementedError("an additive attention bias is not in the port yet (ROADMAP item 16)")
        mask = None if kv_mask is None else kv_mask[:, None, None, :].bool()
        return dot_product_attention(q, k, v, mask=mask, causal=causal_, scale=scale)

    make_causal = causal
    return attention
