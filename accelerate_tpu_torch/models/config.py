"""Model configurations: the JAX package's registry (llama, gpt2, t5, bert).

A copy, not an import: the port never imports ``accelerate_tpu``, even its
pure-Python modules. Field names, defaults and the parameter count follow
``accelerate_tpu/models/config.py`` so configs and checkpoints line up;
``config_from_hf_json`` maps a HuggingFace ``config.json`` to a config.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class TransformerConfig:
    """One config for the decoder (llama, gpt2), encoder (bert) and
    encoder-decoder (t5) stacks."""

    arch: str = "llama"  # "llama" | "gpt2" | "bert" | "t5"
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
    # encoder-only extras
    type_vocab_size: int = 2
    num_labels: int = 2
    dropout_rate: float = 0.0  # embedding and residual dropout; every registry config has 0
    # mixture-of-experts (decoder): num_experts > 1 swaps the gated MLP for a
    # top-k routed expert MLP (models/moe.py)
    num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # encoder-decoder (t5) extras: relative-position bias bucketing and the
    # decoder's BOS (t5 starts generation from the pad token)
    rel_buckets: int = 32
    rel_max_distance: int = 128
    decoder_start_token_id: int = 0

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
    # gpt2 family (decoder, learned positions, LayerNorm, tied embeddings)
    "gpt2-tiny": TransformerConfig(
        arch="gpt2", vocab_size=1024, hidden_size=128, intermediate_size=512,
        num_layers=2, num_heads=4, max_seq_len=256, tie_embeddings=True,
    ),
    "gpt2-124m": TransformerConfig(
        arch="gpt2", vocab_size=50257, hidden_size=768, intermediate_size=3072,
        num_layers=12, num_heads=12, max_seq_len=1024, tie_embeddings=True,
    ),
    "gpt2-355m": TransformerConfig(
        arch="gpt2", vocab_size=50257, hidden_size=1024, intermediate_size=4096,
        num_layers=24, num_heads=16, max_seq_len=1024, tie_embeddings=True,
    ),
    "gpt2-774m": TransformerConfig(
        arch="gpt2", vocab_size=50257, hidden_size=1280, intermediate_size=5120,
        num_layers=36, num_heads=20, max_seq_len=1024, tie_embeddings=True,
    ),
    "gpt2-1.5b": TransformerConfig(
        arch="gpt2", vocab_size=50257, hidden_size=1600, intermediate_size=6400,
        num_layers=48, num_heads=25, max_seq_len=1024, tie_embeddings=True,
    ),
    # t5 family (encoder-decoder): num_layers counts the layers of each stack;
    # v1.0 geometry (ReLU feed-forward, tied embeddings with d_model^-0.5
    # logit scaling)
    "t5-tiny": TransformerConfig(
        arch="t5", vocab_size=1024, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, head_dim=32, max_seq_len=256,
        tie_embeddings=True, rel_buckets=8, rel_max_distance=32,
    ),
    "t5-small": TransformerConfig(
        arch="t5", vocab_size=32128, hidden_size=512, intermediate_size=2048,
        num_layers=6, num_heads=8, head_dim=64, max_seq_len=512, tie_embeddings=True,
    ),
    "t5-base": TransformerConfig(
        arch="t5", vocab_size=32128, hidden_size=768, intermediate_size=3072,
        num_layers=12, num_heads=12, head_dim=64, max_seq_len=512, tie_embeddings=True,
    ),
    "t5-large": TransformerConfig(
        arch="t5", vocab_size=32128, hidden_size=1024, intermediate_size=4096,
        num_layers=24, num_heads=16, head_dim=64, max_seq_len=512, tie_embeddings=True,
    ),
    "t5-3b": TransformerConfig(
        arch="t5", vocab_size=32128, hidden_size=1024, intermediate_size=16384,
        num_layers=24, num_heads=32, head_dim=128, max_seq_len=512, tie_embeddings=True,
    ),
    "t5-11b": TransformerConfig(
        arch="t5", vocab_size=32128, hidden_size=1024, intermediate_size=65536,
        num_layers=24, num_heads=128, head_dim=128, max_seq_len=512, tie_embeddings=True,
    ),
    # bert family (encoder): the nlp_example's model (BERT-base MRPC)
    "bert-tiny": TransformerConfig(
        arch="bert", vocab_size=1024, hidden_size=128, intermediate_size=512,
        num_layers=2, num_heads=2, max_seq_len=128,
    ),
    "bert-base": TransformerConfig(
        arch="bert", vocab_size=30522, hidden_size=768, intermediate_size=3072,
        num_layers=12, num_heads=12, max_seq_len=512, norm_eps=1e-12,
    ),
    "bert-large": TransformerConfig(
        arch="bert", vocab_size=30522, hidden_size=1024, intermediate_size=4096,
        num_layers=24, num_heads=16, max_seq_len=512, norm_eps=1e-12,
    ),
}


def config_from_hf_json(source) -> TransformerConfig:
    """Map a HuggingFace ``config.json`` (a dict, a file path, or a
    directory holding one) to a :class:`TransformerConfig`, no weights
    needed: the four families (llama and mistral, gpt2, bert, t5), as the
    JAX package maps them."""
    if isinstance(source, str):
        path = os.path.join(source, "config.json") if os.path.isdir(source) else source
        with open(path) as f:
            cfg = json.load(f)
    else:
        cfg = dict(source)
    mt = cfg.get("model_type", "")
    arch = {"llama": "llama", "mistral": "llama", "gpt2": "gpt2", "bert": "bert", "t5": "t5"}.get(mt)
    if arch is None:
        raise ValueError(
            f"Unsupported model_type {mt!r} in config.json — supported: llama, mistral, gpt2, bert, t5"
        )
    if arch == "llama":
        return TransformerConfig(
            arch="llama",
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads"),
            head_dim=cfg.get("head_dim"),
            max_seq_len=cfg.get("max_position_embeddings", 2048),
            rope_theta=cfg.get("rope_theta", 10000.0),
            norm_eps=cfg.get("rms_norm_eps", 1e-5),
            tie_embeddings=cfg.get("tie_word_embeddings", False),
        )
    if arch == "gpt2":
        h = cfg["n_embd"]
        return TransformerConfig(
            arch="gpt2",
            vocab_size=cfg["vocab_size"],
            hidden_size=h,
            intermediate_size=cfg.get("n_inner") or 4 * h,
            num_layers=cfg["n_layer"],
            num_heads=cfg["n_head"],
            max_seq_len=cfg.get("n_positions", 1024),
            norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
            tie_embeddings=True,
        )
    if arch == "bert":
        return TransformerConfig(
            arch="bert",
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            max_seq_len=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 2),
            norm_eps=cfg.get("layer_norm_eps", 1e-12),
        )
    # t5: symmetric stacks only (num_layers counts the layers of one stack)
    dec = cfg.get("num_decoder_layers", cfg["num_layers"])
    if dec != cfg["num_layers"]:
        raise ValueError(
            f"asymmetric t5 stacks (encoder {cfg['num_layers']}, decoder {dec}) are not supported"
        )
    return TransformerConfig(
        arch="t5",
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["d_model"],
        intermediate_size=cfg["d_ff"],
        num_layers=cfg["num_layers"],
        num_heads=cfg["num_heads"],
        head_dim=cfg.get("d_kv", 64),
        max_seq_len=cfg.get("n_positions", 512),
        norm_eps=cfg.get("layer_norm_epsilon", 1e-6),
        tie_embeddings=cfg.get("tie_word_embeddings", True),
        rel_buckets=cfg.get("relative_attention_num_buckets", 32),
        rel_max_distance=cfg.get("relative_attention_max_distance", 128),
        decoder_start_token_id=cfg.get("decoder_start_token_id", 0),
    )


def get_config(name: str) -> TransformerConfig:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def register_config(name: str, config: TransformerConfig) -> None:
    _REGISTRY[name] = config


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def param_count(config: TransformerConfig) -> int:
    """Exact parameter count of a registry config, without materializing it."""
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    d, nh, nkv = config.dim_per_head, config.num_heads, config.kv_heads
    if config.arch == "llama":
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
    if config.arch == "gpt2":
        embed = v * h + config.max_seq_len * h  # token + learned positions (tied head)
        per_layer = (
            h * 3 * h + 3 * h     # fused qkv with bias
            + h * h + h           # o with bias
            + h * i + i           # mlp up
            + i * h + h           # mlp down
            + 4 * h               # two layernorms (scale+bias)
        )
        return embed + config.num_layers * per_layer + 2 * h  # + final layernorm
    if config.arch == "t5":
        inner = nh * d
        attn = 4 * h * inner  # q, k, v (h -> inner) and o (inner -> h)
        ff = 2 * h * i
        enc_layer = attn + ff + 2 * h  # two rmsnorms
        dec_layer = 2 * attn + ff + 3 * h  # self and cross attention, three norms
        rel = 2 * config.rel_buckets * nh  # one table per stack
        return (
            v * h  # shared embedding (tied head)
            + config.num_layers * (enc_layer + dec_layer)
            + rel
            + 2 * h  # encoder and decoder final norms
        )
    if config.arch == "bert":
        embed = v * h + config.max_seq_len * h + config.type_vocab_size * h + 2 * h
        per_layer = (
            4 * (h * h + h)       # q,k,v,o with bias
            + h * i + i           # mlp up
            + i * h + h           # mlp down
            + 4 * h               # two layernorms (scale+bias)
        )
        pooler = h * h + h
        classifier = h * config.num_labels + config.num_labels
        return embed + config.num_layers * per_layer + pooler + classifier
    raise ValueError(f"unknown arch {config.arch!r}")


def train_flops_per_token(config: TransformerConfig, seq_len: Optional[int] = None) -> float:
    """Training FLOPs per token: the standard 6·N dense estimate (fwd + bwd)
    plus 12·L·H·S for the self-attention score/context matmuls, which the
    parameter count does not see (the JAX package's MFU formula)."""
    seq = seq_len if seq_len is not None else config.max_seq_len
    dense = 6.0 * param_count(config)
    attention = 12.0 * config.num_layers * config.hidden_size * seq
    return dense + attention


def train_flops_per_step(config: TransformerConfig, batch_size: int, seq_len: int) -> float:
    """Training FLOPs for one optimizer step over ``batch_size`` sequences."""
    return batch_size * seq_len * train_flops_per_token(config, seq_len)
