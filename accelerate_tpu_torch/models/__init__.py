"""The llama family in PyTorch, with the JAX package's parameter layout."""

from .config import TransformerConfig, get_config, list_models, param_count
from .generation import forward_with_cache, generate, init_cache, make_sampler, resolve_decode_protocol
from .llama import Llama, decoder_layer, rms_norm

__all__ = [
    "Llama",
    "TransformerConfig",
    "decoder_layer",
    "forward_with_cache",
    "generate",
    "get_config",
    "init_cache",
    "list_models",
    "make_sampler",
    "param_count",
    "resolve_decode_protocol",
    "rms_norm",
]
