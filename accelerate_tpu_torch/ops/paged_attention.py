"""Paged attention: one decode token, or a speculative window, per slot
over its paged KV.

Replaces the Pallas TPU kernels of ``accelerate_tpu/ops/paged_attention.py``:
``_decode_kernel`` with the CUDA kernel in ``csrc/paged_decode.cu`` and
``_verify_kernel`` with the one in ``csrc/paged_verify.cu``. Where the JAX
engine vmaps a batch-of-1 call over slots, each wrapper takes every slot at
once: one launch per layer per engine step, grid ``(slots, kv_heads)``.
:func:`paged_verify_attention` is the decode walk with a window axis: W
query positions per slot attend the slot's pages, then the window's own
keys under an in-window causal mask; at W=1 it computes decode.

What bounds it on the H100: memory. A launch must read every valid K and V
row of every slot, ``sum(lengths) * KV * D * 2`` elements, at 3.35 TB/s, and
does 4 flops per element read. The kernel never touches pages past a slot's
length, double-buffers each tile of K/V rows through shared memory with
``cp.async`` and reduces the online softmax in fp32 with warp shuffles; see
the source's header for what it leaves for later (TMA, wgmma, split pages).

A tensor on the CPU takes the plain PyTorch version
(:func:`paged_decode_attention_reference`,
:func:`paged_verify_attention_reference`) with the TPU kernel's masking
semantics. A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..models.attention import dot_product_attention, round_to_dtype
from .runtime import load_kernel

KERNEL_SOURCE = "paged_decode"
VERIFY_SOURCE = "paged_verify"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP_OUTPUTS = 128 * 16  # csrc/paged_decode.cu: kThreads * kMaxAcc
_MAX_WINDOW_OUTPUTS = 256 * 24  # csrc/paged_verify.cu: kThreads * kMaxAcc
_MAX_WINDOW = 32  # csrc/paged_verify.cu: kTile, one softmax lane per window key


def paged_decode_attention_reference(q, k_new, v_new, pool_k, pool_v, tables, lengths, scale=None):
    """Plain version: attend each slot's table-gathered view (positions
    ``< length`` valid) plus the new token as the final key. Masked
    positions get exactly zero weight and are zeroed before the products,
    so non-finite data past a length never reaches the output."""
    slots, nh, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pps, ps = tables.shape[1], pool_k.shape[1]
    t = pps * ps
    taken_k = pool_k[tables.long()].reshape(slots, t, *pool_k.shape[2:])
    taken_v = pool_v[tables.long()].reshape(slots, t, *pool_v.shape[2:])
    valid = torch.arange(t, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    zero = torch.zeros((), dtype=pool_k.dtype, device=q.device)
    taken_k = torch.where(valid[:, :, None, None], taken_k, zero)
    taken_v = torch.where(valid[:, :, None, None], taken_v, zero)
    keys = torch.cat([taken_k, k_new[:, None].to(pool_k.dtype)], dim=1).to(q.dtype)
    values = torch.cat([taken_v, v_new[:, None].to(pool_v.dtype)], dim=1).to(q.dtype)
    mask = torch.cat([valid, torch.ones((slots, 1), dtype=torch.bool, device=q.device)], dim=1)
    out = dot_product_attention(q[:, None], keys, values, mask=mask[:, None, None, :], scale=scale)
    return out[:, 0]


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_kernel(KERNEL_SOURCE)
    lib.paged_decode_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.paged_decode_attention.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_new, v_new, pool_k, pool_v, tables, lengths, window: int = 1) -> None:
    """What a launch needs. ``q`` is ``[S, window * NH, D]`` and ``k_new`` /
    ``v_new`` ``[S, window * KV, D]`` (decode: window 1)."""
    slots, nh, d = q.shape[0], q.shape[1] // window, q.shape[2]
    kv = k_new.shape[1] // window
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention takes float32 or bfloat16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (takes {_HEAD_DIMS})")
    if window == 1 and (nh % kv or (nh // kv) * d > _MAX_GROUP_OUTPUTS):
        raise ValueError(f"num_heads {nh} over kv_heads {kv} is not a supported grouping")
    for name, x, shape in (
        ("k_new", k_new, (slots, window * kv, d)),
        ("v_new", v_new, (slots, window * kv, d)),
        ("pool_v", pool_v, tuple(pool_k.shape)),
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if pool_k.dim() != 4 or tuple(pool_k.shape[2:]) != (kv, d):
        raise ValueError(f"pool_k has shape {tuple(pool_k.shape)}, expected [P, ps, {kv}, {d}]")
    if tables.dim() != 2 or tables.shape[0] != slots or tuple(lengths.shape) != (slots,):
        raise ValueError("tables must be [slots, pages_per_slot] and lengths [slots]")
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new), ("pool_k", pool_k), ("pool_v", pool_v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    for name, x in (("tables", tables), ("lengths", lengths)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    tensors = (q, k_new, v_new, pool_k, pool_v, tables, lengths)
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, one is on {x.device}")
        if not x.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")
        if x.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors")


def paged_decode_attention(
    q: torch.Tensor,  # [S, NH, D]: one decode query per slot
    k_new: torch.Tensor,  # [S, KV, D]: the current token's key (not yet in the pool)
    v_new: torch.Tensor,  # [S, KV, D]
    pool_k: torch.Tensor,  # [P, page_size, KV, D]: one layer of the page pool
    pool_v: torch.Tensor,  # [P, page_size, KV, D]
    tables: torch.Tensor,  # [S, pages_per_slot] int32 page-table rows
    lengths: torch.Tensor,  # [S] int32: positions already in the pool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Every slot's decode attention over its paged KV, ``[S, NH, D]`` in
    q's dtype. Each length must be at most ``pages_per_slot * page_size``
    and every walked table entry a page of the pool: the engine keeps both
    true, and checking them here would cost a device sync per launch."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_new, v_new, pool_k, pool_v, tables, lengths, scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_new, v_new, pool_k, pool_v, tables, lengths)
    slots, nh, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        # the kernel scales q by the scale rounded to q's dtype, rounding the
        # product to q's dtype, as the reference does before the score product
        code = lib.paged_decode_attention(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            round_to_dtype(scale, q.dtype), slots, nh, k_new.shape[1], d, pool_k.shape[1],
            tables.shape[1], _DTYPE_CODES[q.dtype], stream,
        )
    if code != 0:
        message = lib.paged_decode_error_string(code).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: {message} ({code})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_verify_attention_reference(q, k_new, v_new, pool_k, pool_v, tables, lengths, scale=None):
    """Plain version (the JAX package's ``_verify_reference``, every slot at
    once): each slot's table-gathered view (positions ``< length`` valid)
    plus the W window keys, window row ``i`` seeing window keys ``0..i``.
    Masked positions get exactly zero weight and are zeroed before the
    products, so non-finite data past a length never reaches the output."""
    slots, w, nh, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pps, ps = tables.shape[1], pool_k.shape[1]
    t = pps * ps
    taken_k = pool_k[tables.long()].reshape(slots, t, *pool_k.shape[2:])
    taken_v = pool_v[tables.long()].reshape(slots, t, *pool_v.shape[2:])
    valid = torch.arange(t, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    zero = torch.zeros((), dtype=pool_k.dtype, device=q.device)
    taken_k = torch.where(valid[:, :, None, None], taken_k, zero)
    taken_v = torch.where(valid[:, :, None, None], taken_v, zero)
    keys = torch.cat([taken_k, k_new.to(pool_k.dtype)], dim=1).to(q.dtype)
    values = torch.cat([taken_v, v_new.to(pool_v.dtype)], dim=1).to(q.dtype)
    in_window = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    mask = torch.cat(
        [valid[:, None, :].expand(slots, w, t), in_window[None].expand(slots, w, w)], dim=2
    )
    return dot_product_attention(q, keys, values, mask=mask[:, None], scale=scale)


def _verify_library() -> ctypes.CDLL:
    lib = load_kernel(VERIFY_SOURCE)
    lib.paged_verify_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    lib.paged_verify_attention.restype = ctypes.c_int
    lib.paged_verify_error_string.argtypes = [ctypes.c_int]
    lib.paged_verify_error_string.restype = ctypes.c_char_p
    return lib


def paged_verify_attention(
    q: torch.Tensor,  # [S, W, NH, D]: each slot's window queries
    k_new: torch.Tensor,  # [S, W, KV, D]: the window's keys (not yet in the pool)
    v_new: torch.Tensor,  # [S, W, KV, D]
    pool_k: torch.Tensor,  # [P, page_size, KV, D]: one layer of the page pool
    pool_v: torch.Tensor,  # [P, page_size, KV, D]
    tables: torch.Tensor,  # [S, pages_per_slot] int32 page-table rows
    lengths: torch.Tensor,  # [S] int32: committed positions in the pool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Speculative verify: every slot's W-position window attends its paged
    KV plus the window's own keys under an in-window causal mask, ``[S, W,
    NH, D]`` in q's dtype. The same preconditions as
    :func:`paged_decode_attention` hold for lengths and tables."""
    if q.device.type == "cpu":
        return paged_verify_attention_reference(
            q, k_new, v_new, pool_k, pool_v, tables, lengths, scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_attention runs on cuda or cpu, not {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [slots, window, heads, head_dim], got {tuple(q.shape)}")
    slots, w, nh, d = q.shape
    kv = k_new.shape[2]
    if w > _MAX_WINDOW or kv == 0 or nh % kv or w * (nh // kv) * d > _MAX_WINDOW_OUTPUTS:
        raise ValueError(
            f"window {w} x {nh} heads over {kv} kv heads x head dim {d} is not a "
            f"supported geometry (window <= {_MAX_WINDOW}, "
            f"window * group * head_dim <= {_MAX_WINDOW_OUTPUTS})"
        )
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if tuple(x.shape) != (slots, w, kv, d):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {(slots, w, kv, d)}")
    if not (q.is_contiguous() and k_new.is_contiguous() and v_new.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors only")
    # the window folds into the head axis for the shared checks: the kernel
    # reads q / k_new / v_new as contiguous [S, W, heads, D] rows
    _check(
        q.reshape(slots, w * nh, d), k_new.reshape(slots, w * kv, d),
        v_new.reshape(slots, w * kv, d), pool_k, pool_v, tables, lengths,
        window=w,
    )
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lib = _verify_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.paged_verify_attention(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            round_to_dtype(scale, q.dtype), slots, w, nh, kv, d, pool_k.shape[1],
            tables.shape[1], _DTYPE_CODES[q.dtype], stream,
        )
    if code != 0:
        message = lib.paged_verify_error_string(code).decode()
        raise RuntimeError(f"paged_verify_attention launch failed: {message} ({code})")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
