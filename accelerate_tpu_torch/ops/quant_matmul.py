"""Fused int8/int4 dequant-matmul: ``x @ dequantize(w)`` with ``w`` packed.

Replaces the Pallas TPU kernel ``_matmul_kernel`` of
``accelerate_tpu/ops/quant_matmul.py`` with the CUDA kernel in
``csrc/quant_matmul.cu``. The weight stays packed (a
:class:`~..utils.quantization.QuantizedWeight`: 1 byte per element for
int8, half a byte for int4, plus one fp32 scale per output column); each
block dequantizes the tile it reads into shared memory, rounds it to x's
dtype as the unpack path would, and accumulates in fp32. No bf16 copy of a
weight is ever made.

What bounds it on the H100: at the decode batch (M = 8 rows) the weight
read, ``K * N`` bytes for int8, at 3.35 TB/s; at prefill sizes (M of
hundreds) the arithmetic, ``2 * M * K * N`` flops. In bf16 the products run
on the tensor cores (``mma.sync`` on the transposed product, the weight's
columns as the 16-row operand) and the packed weight streams through a
shared-memory ring fed by ``cp.async``. Grids with too few output tiles for
the card split K (:func:`quant_plan`), and a second kernel adds the partial
sums in split order: the output is the same bit for bit on every launch.
fp32 stays on the CUDA cores (the tensor cores would take it as TF32). See
the source's header for what it leaves for later.

Wired in as the llama ``dot_fn`` hook (:func:`quant_dot`): every layer
projection already routes through it, so a model whose layer matrices are
``QuantizedWeight`` leaves uses the kernel with no model change, and plain
tensors take the plain matmul. A tensor on the CPU takes
:func:`quant_matmul_reference` (dequantize, then matmul); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..utils.quantization import QuantizedWeight, dequantize_weight
from .runtime import load_kernel

KERNEL_SOURCE = "quant_matmul"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/quant_matmul.cu, bf16: the columns a block owns and the K rows of a
# ring stage (one K tile)
BLOCK_N = 128
BLOCK_K = 128
MAX_M_TILE = 64  # rows a block owns: 8 .. 64, in steps of 8
SMS = 132  # streaming multiprocessors of an H100 SXM: the blocks of one wave


class QuantPlan(NamedTuple):
    """How the bf16 kernel tiles one ``[M, K] @ [K, N]`` call: a block owns
    ``m_tile`` rows, ``BLOCK_N`` columns and ``tiles_per_split`` K tiles of
    ``BLOCK_K`` rows; the grid is ``n_tiles x m_tiles x splits``."""

    m_tile: int
    m_tiles: int
    n_tiles: int
    k_tiles: int
    splits: int
    tiles_per_split: int

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.m_tiles * self.splits


@functools.lru_cache(maxsize=None)
def quant_plan(m: int, k: int, n: int, bits: int) -> QuantPlan:
    """The bf16 kernel's tiles and split of K for ``x [m, k] @ w [k, n]``
    (``bits`` does not change the tiles: a K tile holds 128 logical rows,
    packed or not). Rows go in tiles of ``ceil(m / 8) * 8`` up to 64. Where
    the output tiles leave half the SMs or more without a block, K is split
    into as many parts as keep the grid within one wave of ``SMS`` blocks
    (on the H100 one block per SM streaming several K tiles through its
    ring beat two waves, and splits that overfill a wave, at every
    llama-1b shape; PERF.md). Every split owns at least one K tile, and
    the splits together cover every K tile once."""
    if m <= 0 or k <= 0 or n <= 0 or bits not in (4, 8):
        raise ValueError(f"no plan for M={m}, K={k}, N={n}, {bits} bits")
    m_tile = min(MAX_M_TILE, 8 * math.ceil(m / 8))
    m_tiles = math.ceil(m / m_tile)
    n_tiles = math.ceil(n / BLOCK_N)
    k_tiles = math.ceil(k / BLOCK_K)
    splits = max(1, min(k_tiles, SMS // (m_tiles * n_tiles)))
    per_split = math.ceil(k_tiles / splits)
    splits = math.ceil(k_tiles / per_split)  # no split left without a tile
    return QuantPlan(m_tile, m_tiles, n_tiles, k_tiles, splits, per_split)


def quant_matmul_reference(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """Plain version: dequantize (fp32 widen, column scale, round to x's
    dtype, as the TPU kernel rounds), then one matmul."""
    return x @ dequantize_weight(w.q, w.scale, w.bits, x.dtype)


def _library() -> ctypes.CDLL:
    lib = load_kernel(KERNEL_SOURCE)
    lib.quant_matmul.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.quant_matmul.restype = ctypes.c_int
    lib.quant_matmul_error_string.argtypes = [ctypes.c_int]
    lib.quant_matmul_error_string.restype = ctypes.c_char_p
    return lib


def quant_matmul(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """``x @ dequantize(w)`` without a dequantized copy of ``w``: ``x`` is
    ``[..., K]``, ``w`` a per-layer packed weight of logical shape ``[K,
    N]``. Returns ``[..., N]`` in x's dtype. Any K and N the kernel's
    bounds checks cover (every llama width, 5504 included); int4 needs an
    even K, as its packing does."""
    *lead, k = x.shape
    if w.ndim != 2:
        raise ValueError(f"quant_matmul takes a per-layer [K, N] weight, got shape {w.shape}")
    kq, n = w.shape
    if kq != k:
        raise ValueError(f"contraction mismatch: x[..., {k}] @ quantized [{kq}, {n}]")
    if x.device.type == "cpu":
        return quant_matmul_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quant_matmul takes float32 or bfloat16 activations, got {x.dtype}")
    if w.bits not in (4, 8):
        raise ValueError(f"quant_matmul takes int8 or int4 weights, got {w.bits} bits")
    if tuple(w.scale.shape) != (n,):
        raise ValueError(f"scale has shape {tuple(w.scale.shape)}, expected {(n,)}")
    for name, t in (("q", w.q), ("scale", w.scale)):
        if t.device != x.device:
            raise ValueError(f"weight {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"weight {name} must be contiguous")
    m = 1
    for dim in lead:
        m *= dim
    x2 = x.reshape(m, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    m_tile, splits, per_split, workspace = 0, 1, 1, None
    if x.dtype == torch.bfloat16:
        plan = quant_plan(m, k, n, w.bits)
        m_tile, splits, per_split = plan.m_tile, plan.splits, plan.tiles_per_split
        if splits > 1:  # the splits' fp32 partial sums
            workspace = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.quant_matmul(
            x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            m, k, n, w.bits, _DTYPE_CODES[x.dtype], m_tile, splits, per_split, stream,
        )
    if code != 0:
        message = lib.quant_matmul_error_string(code).decode()
        raise RuntimeError(f"quant_matmul launch failed: {message} ({code})")
    quant_matmul.launches += 1
    return out.reshape(*lead, n)


quant_matmul.launches = 0


def quant_dot(a: torch.Tensor, w) -> torch.Tensor:
    """The ``dot_fn`` hook of quantized-resident serving: the fused kernel
    for a :class:`QuantizedWeight`, the plain matmul for anything else."""
    if isinstance(w, QuantizedWeight):
        return quant_matmul(a, w)
    return a @ w
