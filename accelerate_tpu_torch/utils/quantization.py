"""Weight-only int8/int4 quantization for big-model serving.

Counterpart of ``accelerate_tpu/utils/quantization.py``. Weights are
quantized per output channel on the host (numpy, a copy of the JAX
package's quantizer), stored as int8 or nibble-packed int4, and either
dequantized to the compute dtype on the device or kept packed as a
:class:`QuantizedWeight` that the fused dequant-matmul kernel
(``ops/quant_matmul.py``) reads directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class QuantizationConfig:
    """Which quantization ``dispatch_model`` applies to the layer matrices."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    skip_modules: Optional[list[str]] = None  # leaf-name substrings kept full precision

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("Pick one of load_in_8bit / load_in_4bit.")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("QuantizationConfig needs load_in_8bit or load_in_4bit.")

    @property
    def bits(self) -> int:
        return 8 if self.load_in_8bit else 4


def quantize_weight(w: np.ndarray, bits: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel (last axis) symmetric quantization.

    Returns (q, scale): int8 values (int4 packed two-per-byte on the first
    axis) and a float32 scale of shape ``w.shape[-1:]``.
    """
    w = np.asarray(w, np.float32)
    qmax = 127.0 if bits == 8 else 7.0
    scale = np.abs(w).max(axis=tuple(range(w.ndim - 1))) / qmax
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.round(w / scale), -qmax, qmax).astype(np.int8)
    if bits == 4:
        if q.shape[0] % 2:
            raise ValueError("int4 packing needs an even leading dim")
        low = q[0::2] & 0x0F
        high = (q[1::2] & 0x0F) << 4
        q = (low | high).astype(np.int8)
    return q, scale


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """Nibble-packed int4 -> int8 values, doubling the contraction axis
    (axis -2, for a ``[K/2, N]`` matrix and its stacked ``[L, K/2, N]``
    form). Packed row ``i`` holds rows ``2i`` (low nibble) and ``2i + 1``
    (high nibble); both sign-extend through arithmetic shifts of a signed
    byte."""
    low = (q << 4) >> 4  # int8 shifts: the left one wraps, the right one sign-extends
    high = q >> 4
    out_shape = tuple(q.shape[:-2]) + (q.shape[-2] * 2, q.shape[-1])
    return torch.stack([low, high], dim=-2).reshape(out_shape)


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, bits: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_weight``, on the tensors' device: widen to fp32,
    multiply by the scale, round to ``dtype``."""
    if bits == 4:
        q = unpack_int4(q)
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


class QuantizedWeight:
    """A quantized matrix kept in its packed form: ``q`` int8 data (int4
    nibble-packed on axis -2) and ``scale`` fp32, one per output column.
    ``shape`` and ``ndim`` report the logical (dequantized) geometry, for a
    per-layer ``[K, N]`` weight and for its stacked ``[L, K, N]`` form, whose
    ``[i]`` is layer ``i``'s view. ``dtype`` is the compute dtype the weight
    dequantizes to."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int, dtype=torch.bfloat16):
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise TypeError(f"QuantizedWeight holds int8 q and fp32 scale, got {q.dtype}, {scale.dtype}")
        self.q = q
        self.scale = scale
        self.bits = int(bits)
        self.dtype = dtype

    @property
    def shape(self) -> tuple:
        shape = list(self.q.shape)
        if self.bits == 4:
            shape[-2] *= 2
        return tuple(shape)

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * self.scale.element_size()

    def __getitem__(self, index: int) -> "QuantizedWeight":
        """Layer ``index`` of a stacked weight: views, no copy."""
        if self.q.dim() < 3:
            raise IndexError("only a stacked [L, K, N] QuantizedWeight has per-layer views")
        return QuantizedWeight(self.q[index], self.scale[index], self.bits, self.dtype)

    def dequantize(self) -> torch.Tensor:
        # the stacked form's [L, N] scale needs the contraction axis inserted
        scale = self.scale[..., None, :] if self.scale.dim() > 1 else self.scale
        return dequantize_weight(self.q, scale, self.bits, self.dtype)

    def __repr__(self) -> str:
        return f"QuantizedWeight(shape={self.shape}, bits={self.bits}, dtype={self.dtype})"
