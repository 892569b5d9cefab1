"""Model configurations: the llama part of the JAX package's registry.

A copy, not an import: the port never imports ``accelerate_tpu``, even its
pure-Python modules. Field names, defaults and the parameter count follow
``accelerate_tpu/models/config.py`` so configs and checkpoints line up.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class TransformerConfig:
    """Decoder geometry of the llama family."""

    arch: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # grouped-query attention; None = num_heads
    head_dim: Optional[int] = None  # None = hidden_size // num_heads
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # num_experts > 1 selects the routed-expert MLP, which the port does not have
    num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dim_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def replace(self, **kwargs) -> "TransformerConfig":
        return replace(self, **kwargs)


_REGISTRY: dict[str, TransformerConfig] = {
    "llama-tiny": TransformerConfig(
        arch="llama", vocab_size=1024, hidden_size=128, intermediate_size=352,
        num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
    ),
    "llama-125m": TransformerConfig(
        arch="llama", vocab_size=32000, hidden_size=768, intermediate_size=2048,
        num_layers=12, num_heads=12, max_seq_len=2048,
    ),
    "llama-1b": TransformerConfig(
        arch="llama", vocab_size=32000, hidden_size=2048, intermediate_size=5504,
        num_layers=22, num_heads=16, max_seq_len=2048,
    ),
    "llama-7b": TransformerConfig(
        arch="llama", vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, max_seq_len=4096,
    ),
    "llama-13b": TransformerConfig(
        arch="llama", vocab_size=32000, hidden_size=5120, intermediate_size=13824,
        num_layers=40, num_heads=40, max_seq_len=4096,
    ),
    "llama-70b": TransformerConfig(
        arch="llama", vocab_size=32000, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, max_seq_len=4096,
    ),
    "llama-moe-tiny": TransformerConfig(
        arch="llama", vocab_size=1024, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
        num_experts=4, moe_top_k=2, moe_capacity_factor=2.0,
    ),
}


def get_config(name: str) -> TransformerConfig:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def param_count(config: TransformerConfig) -> int:
    """Exact parameter count of a llama config, without materializing it."""
    if config.arch != "llama":
        raise ValueError(f"the port has only the llama family, got arch {config.arch!r}")
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    d, nh, nkv = config.dim_per_head, config.num_heads, config.kv_heads
    if config.num_experts > 1:
        mlp = h * config.num_experts + config.num_experts * 2 * h * i  # router + experts
    else:
        mlp = 3 * h * i  # gate, up, down
    per_layer = (
        h * (nh * d)          # q
        + 2 * h * (nkv * d)   # k, v
        + (nh * d) * h        # o
        + mlp
        + 2 * h               # two rmsnorms
    )
    total = v * h + config.num_layers * per_layer + h  # embed + layers + final norm
    if not config.tie_embeddings:
        total += h * v  # lm head
    return total
