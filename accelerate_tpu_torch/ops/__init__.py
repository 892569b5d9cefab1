"""Kernels of the port: CUDA sources under ``csrc/``, each beside its plain version."""

# the modules flash_attention and fused_adamw share a name with their entry
# point: the functions are exported by the package, not here
from .flash_attention import (
    flash_backward,
    flash_backward_dkv,
    flash_backward_dkv_reference,
    flash_backward_dq,
    flash_backward_dq_reference,
    flash_delta_reference,
    flash_forward,
    flash_forward_reference,
    make_auto_attention,
)
from .fused_adamw import adamw, adamw_leaf, adamw_leaf_reference
from .paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_verify_attention,
    paged_verify_attention_reference,
)
from .quant_matmul import quant_dot, quant_matmul, quant_matmul_reference
from .runtime import resolve_device

__all__ = [
    "adamw",
    "adamw_leaf",
    "adamw_leaf_reference",
    "flash_backward",
    "flash_backward_dkv",
    "flash_backward_dkv_reference",
    "flash_backward_dq",
    "flash_backward_dq_reference",
    "flash_delta_reference",
    "flash_forward",
    "flash_forward_reference",
    "make_auto_attention",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "paged_verify_attention",
    "paged_verify_attention_reference",
    "quant_dot",
    "quant_matmul",
    "quant_matmul_reference",
    "resolve_device",
]
