"""Paged attention: one decode token, or a speculative window, per slot
over its paged KV.

Replaces the Pallas TPU kernels of ``accelerate_tpu/ops/paged_attention.py``:
``_decode_kernel`` with the CUDA source ``csrc/paged_decode.cu`` and
``_verify_kernel`` with ``csrc/paged_verify.cu``, both the split page walk of
``csrc/paged_common.cuh``. Where the JAX engine vmaps a batch-of-1 call over
slots, each wrapper takes every slot at once. :func:`paged_verify_attention`
is the decode walk with a window axis: W query positions per slot attend the
slot's pages, then the window's own keys under an in-window causal mask; at
W=1 it computes decode.

What bounds it on the H100: memory. A launch must read every valid K and V
row of every slot, ``sum(lengths) * KV * D * 2`` elements, at 3.35 TB/s, and
does 4 flops per element read per query row. The walk is cut into chunks of
positions over the grid ``(row tiles, chunks + 1, slots x kv heads)``, so a
long slot is walked by many blocks; :func:`paged_plan` chooses the chunk on
the host from the pool's capacity (the lengths live on the device, and
reading them would cost a sync per launch). The last chunk column walks the
window's own keys under the in-window causal mask. Each block writes an
fp32 partial; a second kernel merges them in chunk order. bf16 scores and
P.V run on the tensor cores. See the sources' headers for the design and
what is left.

A tensor on the CPU takes the plain PyTorch version
(:func:`paged_decode_attention_reference`,
:func:`paged_verify_attention_reference`) with the TPU kernel's masking
semantics. A CUDA tensor launches the kernels or raises.
:func:`paged_split_reference` is the kernels' own algorithm (chunks,
partials, the ordered combine) in plain PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..models.attention import dot_product_attention, round_to_dtype
from .runtime import load_kernel

KERNEL_SOURCE = "paged_decode"
VERIFY_SOURCE = "paged_verify"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
NEG_INF = -1e30
M_INIT = NEG_INF / 2  # the kernels' running-max start: an empty row stays exact
# csrc/paged_common.cuh: query rows of a walk block, the chunk's unit and cap
ROW_TILE = 16
CHUNK_QUANTUM = 64
MAX_CHUNK = 2048
WIDE_CHUNK = 512  # the chunk cap of a grid already a wave wide
SMS = 132  # the H100's streaming multiprocessors
WAVE_BLOCKS = 2 * SMS  # walk blocks the plan aims for: two resident on each SM


class PagedPlan(NamedTuple):
    """How a launch splits the page walk: ``row_tiles`` blocks of 16 query
    rows, ``chunks`` chunks of ``chunk`` positions each (the last may pass
    the capacity)."""

    row_tiles: int
    chunk: int
    chunks: int


def paged_plan(slots: int, kv_heads: int, rows: int, capacity: int) -> PagedPlan:
    """The split of one launch, from host-side shapes only: ``rows`` query
    rows per (slot, kv head) (decode: the group; verify: window x group)
    and ``capacity = pages_per_slot * page_size`` positions per slot. Aims
    for about ``WAVE_BLOCKS`` walk blocks (one to two waves on 132 SMs)
    with chunks of whole 64-position units, at most ``MAX_CHUNK``; where
    the grid is a wave wide with two chunks or fewer, chunks of at most
    ``WIDE_CHUNK`` keep its later waves short. A slot shorter than the
    capacity leaves its later chunks empty. The window's keys take one
    more chunk column, not counted here."""
    row_tiles = -(-rows // ROW_TILE)
    base = max(slots * kv_heads * row_tiles, 1)
    units = max(-(-capacity // CHUNK_QUANTUM), 1)
    wanted = min(max(-(-WAVE_BLOCKS // base), 1), units)
    chunk = min(-(-units // wanted) * CHUNK_QUANTUM, WIDE_CHUNK if wanted <= 2 else MAX_CHUNK)
    return PagedPlan(row_tiles, chunk, max(-(-capacity // chunk), 1))


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


def paged_split_reference(q, k_new, v_new, pool_k, pool_v, tables, lengths, scale=None, chunk=CHUNK_QUANTUM):
    """The kernels' algorithm in plain PyTorch (for the tests): ``q`` /
    ``k_new`` / ``v_new`` with a window axis, ``[S, W, heads, D]``. Each
    chunk of ``chunk`` pool positions gives a partial (``o`` unnormalised,
    max ``m`` from M_INIT, sum ``l``; an empty chunk ``m = M_INIT, l = 0``),
    and the window's keys one more, key ``j`` seen by window rows ``>= j``.
    The merge takes the largest max ``M`` of the partials that saw a key and
    sums ``o * exp(m - M)`` and ``l * exp(m - M)`` in chunk order, one with
    ``l = 0`` contributing nothing. p is rounded to the pool's dtype before
    each P.V product. Sums in fp32."""
    slots, w, nh, d = q.shape
    kv = k_new.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pps, ps = tables.shape[1], pool_k.shape[1]
    t = pps * ps
    qs = (q * round_to_dtype(scale, q.dtype)).float().reshape(slots, w, kv, nh // kv, d)
    keys = pool_k[tables.long()].reshape(slots, t, kv, d)
    values = pool_v[tables.long()].reshape(slots, t, kv, d)
    valid = torch.arange(t, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    zero = torch.zeros((), dtype=pool_k.dtype, device=q.device)
    keys = torch.where(valid[:, :, None, None], keys, zero)
    values = torch.where(valid[:, :, None, None], values, zero)
    seen = torch.arange(w, device=q.device)[:, None] >= torch.arange(w, device=q.device)[None, :]
    parts = [  # (keys [S, P, KV, D], values, which keys each row sees [S, W, P])
        (keys[:, lo:lo + chunk], values[:, lo:lo + chunk], valid[:, None, lo:lo + chunk].expand(slots, w, -1))
        for lo in range(0, t, chunk)
    ] + [(k_new, v_new, seen[None].expand(slots, w, w))]
    partials = []
    for k_c, v_c, ok in parts:
        s = torch.einsum("swkgd,spkd->swkgp", qs, k_c.float())
        s = torch.where(ok[:, :, None, None, :], s, NEG_INF)
        m_c = torch.clamp(s.amax(dim=-1), min=M_INIT) if s.shape[-1] else torch.full(s.shape[:-1], M_INIT)
        p = torch.exp(s - m_c[..., None])
        o_c = torch.einsum("swkgp,spkd->swkgd", p.to(v_c.dtype).float(), v_c.float())
        partials.append((m_c, p.sum(dim=-1), o_c))
    top = torch.stack([torch.where(l_c > 0, m_c, M_INIT) for m_c, l_c, _ in partials]).amax(dim=0)
    l = torch.zeros_like(top)
    acc = torch.zeros_like(partials[0][2])
    for m_c, l_c, o_c in partials:
        f = torch.where(l_c > 0, torch.exp(m_c - top), 0.0)
        l = l + l_c * f
        acc = acc + o_c * f[..., None]
    return (acc / l[..., None]).to(q.dtype).reshape(slots, w, nh, d)


def argtypes(source: str) -> list:
    """The C signature of ``csrc/<source>.cu``'s entry point: 9 pointers,
    the scale, then slots, (window,) nh, kv, d, ps, pps, chunk, chunks,
    dtype, and the stream."""
    ints = 10 if source == VERIFY_SOURCE else 9
    return [ctypes.c_void_p] * 9 + [ctypes.c_float] + [ctypes.c_int] * ints + [ctypes.c_void_p]


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    """A built kernel library with its C signature declared: the decode
    entry point, or the verify one with a window argument."""
    lib = load_kernel(source)
    fn = getattr(lib, f"{source}_attention")
    fn.argtypes = argtypes(source)
    fn.restype = ctypes.c_int
    error = getattr(lib, f"{source}_error_string")
    error.argtypes = [ctypes.c_int]
    error.restype = ctypes.c_char_p
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
    if kv == 0 or nh % kv:
        raise ValueError(f"num_heads {nh} is not a multiple of kv_heads {kv}")
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


def _launch(source, q, k_new, v_new, pool_k, pool_v, tables, lengths, scale, window):
    """Plan, allocate the output and the partials' scratch, launch; ``q`` and
    friends already checked, with the window folded into the head axis."""
    slots, d = q.shape[0], q.shape[2]
    nh, kv = q.shape[1] // window, k_new.shape[1] // window
    ps, pps = pool_k.shape[1], tables.shape[1]
    plan = paged_plan(slots, kv, q.shape[1] // kv, pps * ps)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    # the partials of every chunk and of the window's keys
    scratch = torch.empty(
        slots * window * nh * (plan.chunks + 1) * (d + 2), dtype=torch.float32, device=q.device
    )
    lib = _library(source)
    window_arg = (window,) if source == VERIFY_SOURCE else ()
    with torch.cuda.device(q.device):
        # the kernels scale q by the scale rounded to q's dtype, rounding the
        # product to q's dtype, as the reference does before the score product
        code = getattr(lib, f"{source}_attention")(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), round_to_dtype(scale, q.dtype), slots, *window_arg, nh, kv, d,
            ps, pps, plan.chunk, plan.chunks, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if code != 0:
        message = getattr(lib, f"{source}_error_string")(code).decode()
        raise RuntimeError(f"{source}_attention launch failed: {message} ({code})")
    return out


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
    out = _launch(KERNEL_SOURCE, q, k_new, v_new, pool_k, pool_v, tables, lengths, scale, 1)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


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
    NH, D]`` in q's dtype. Any window and any grouping. The same
    preconditions as :func:`paged_decode_attention` hold for lengths and
    tables."""
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
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if tuple(x.shape) != (slots, w, kv, d):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {(slots, w, kv, d)}")
    if not (q.is_contiguous() and k_new.is_contiguous() and v_new.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors only")
    # the window folds into the head axis for the shared checks: the kernels
    # read q / k_new / v_new as contiguous [S, W, heads, D] rows
    q3 = q.reshape(slots, w * nh, d)
    kn3, vn3 = k_new.reshape(slots, w * kv, d), v_new.reshape(slots, w * kv, d)
    _check(q3, kn3, vn3, pool_k, pool_v, tables, lengths, window=w)
    out = _launch(VERIFY_SOURCE, q3, kn3, vn3, pool_k, pool_v, tables, lengths, scale, w)
    paged_verify_attention.launches += 1
    return out.reshape(slots, w, nh, d)


paged_verify_attention.launches = 0
