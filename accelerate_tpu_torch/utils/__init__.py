"""Utilities of the port."""

from .params import flatten_tree, load_jax_params, tree_leaves, tree_map
from .quantization import (
    QuantizationConfig,
    QuantizedWeight,
    dequantize_weight,
    quantize_weight,
    unpack_int4,
)

__all__ = [
    "QuantizationConfig",
    "QuantizedWeight",
    "dequantize_weight",
    "flatten_tree",
    "load_jax_params",
    "tree_leaves",
    "tree_map",
    "quantize_weight",
    "unpack_int4",
]
