"""The model zoo in PyTorch (llama, llama-MoE, gpt2, t5 and bert), with the
JAX package's parameter layout."""

from .attention import dot_product_attention, rotary_embedding
from .bert import Bert, layer_norm
from .config import (
    TransformerConfig,
    get_config,
    list_models,
    param_count,
    register_config,
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
from .gpt2 import GPT2
from .llama import Llama, decoder_layer, rms_norm
from .moe import MoEBlock, routed_mlp
from .t5 import T5

_ARCHS = {"llama": Llama, "gpt2": GPT2, "bert": Bert, "t5": T5}


def build_model(name: str, **kwargs):
    """Registry name -> model instance (``"llama-125m"``, ``"gpt2-124m"``,
    ``"t5-base"``, ``"bert-base"``); ``kwargs`` (``device``, ``dtype``,
    ``seed``) pass to the constructor."""
    config = get_config(name)
    return _ARCHS[config.arch](config, **kwargs)


__all__ = [
    "Bert",
    "GPT2",
    "Llama",
    "MoEBlock",
    "T5",
    "TransformerConfig",
    "build_model",
    "decoder_layer",
    "dot_product_attention",
    "forward_window_with_cache",
    "forward_with_cache",
    "generate",
    "get_config",
    "init_cache",
    "layer_norm",
    "list_models",
    "make_sampler",
    "param_count",
    "register_config",
    "resolve_decode_protocol",
    "resolve_window_protocol",
    "rms_norm",
    "rotary_embedding",
    "routed_mlp",
    "train_flops_per_step",
    "train_flops_per_token",
]
