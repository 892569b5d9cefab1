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
hundreds) the arithmetic, ``2 * M * K * N`` flops. This first kernel is
SIMT (fp32 FMAs, no tensor cores) with two tilings, one for M <= 64 and one
for larger M; see the source's header for what it leaves for later.

Wired in as the llama ``dot_fn`` hook (:func:`quant_dot`): every layer
projection already routes through it, so a model whose layer matrices are
``QuantizedWeight`` leaves uses the kernel with no model change, and plain
tensors take the plain matmul. A tensor on the CPU takes
:func:`quant_matmul_reference` (dequantize, then matmul); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.quantization import QuantizedWeight, dequantize_weight
from .runtime import load_kernel

KERNEL_SOURCE = "quant_matmul"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quant_matmul_reference(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """Plain version: dequantize (fp32 widen, column scale, round to x's
    dtype, as the TPU kernel rounds), then one matmul."""
    return x @ dequantize_weight(w.q, w.scale, w.bits, x.dtype)


def _library() -> ctypes.CDLL:
    lib = load_kernel(KERNEL_SOURCE)
    lib.quant_matmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.quant_matmul(
            x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
            m, k, n, w.bits, _DTYPE_CODES[x.dtype], stream,
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
