"""The llama family in PyTorch, with the JAX package's parameter layout."""

from .config import (
    TransformerConfig,
    get_config,
    list_models,
    param_count,
    train_flops_per_step,
    train_flops_per_token,
)
from .generation import (
    forward_window_with_cache,
    forward_with_cache,
    generate,
    init_cache,
    make_sampler,
    resolve_decode_protocol,
    resolve_window_protocol,
)
from .llama import Llama, decoder_layer, rms_norm

__all__ = [
    "Llama",
    "TransformerConfig",
    "decoder_layer",
    "forward_window_with_cache",
    "forward_with_cache",
    "generate",
    "get_config",
    "init_cache",
    "list_models",
    "make_sampler",
    "param_count",
    "resolve_decode_protocol",
    "resolve_window_protocol",
    "rms_norm",
    "train_flops_per_step",
    "train_flops_per_token",
]
