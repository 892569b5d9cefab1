"""Kernels of the port: CUDA sources under ``csrc/``, each beside its plain version."""

from .paged_attention import paged_decode_attention, paged_decode_attention_reference
from .runtime import resolve_device

__all__ = ["paged_decode_attention", "paged_decode_attention_reference", "resolve_device"]
