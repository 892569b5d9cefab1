"""Llama-family decoder as a PyTorch ``nn.Module``.

Counterpart of ``accelerate_tpu/models/llama.py``. The parameters keep the
JAX package's key paths and layouts: ``embed_tokens`` ``[V, H]``, the layer
weights stacked on a leading layer axis under ``layers.*`` with ``[in, out]``
matrices, ``final_norm`` and ``lm_head`` ``[H, V]``. Weights therefore cross
between the packages with no transposes (``utils/params.load_jax_params``).
The stacked layers run as a Python loop where the JAX package scans.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.runtime import resolve_device
from .attention import apply_rotary, dense_init, dot_product_attention, rotary_embedding
from .config import TransformerConfig, get_config

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def decoder_layer(
    cfg: TransformerConfig,
    h: torch.Tensor,  # [B, S, H]
    lp: dict,  # one layer's params
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    causal: bool = True,
    cache: Optional[dict] = None,  # {"k","v"} [B, T, KV, D] + write offset "length"
):
    """One llama decoder layer. Returns ``(h, new_cache_or_None)``.

    ``cache`` selects the attention path:
    - with an ``attend`` hook (the serving engine's paged decode), ``attend``
      reads the page pool itself and the new token's K/V return as the cache
      delta for the engine to scatter;
    - without one (prefill, ``generate()``), K/V are written into the dense
      cache at ``length`` in place, where the JAX package returns an updated
      copy, and attention runs over the whole cache under ``mask``.
    """
    b, s = h.shape[:2]
    nh, nkv, d = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q = (x @ lp["wq"]).reshape(b, s, nh, d)
    k = (x @ lp["wk"]).reshape(b, s, nkv, d)
    v = (x @ lp["wv"]).reshape(b, s, nkv, d)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    new_cache = None
    if cache is not None and "attend" in cache:
        attn = cache["attend"](q, k, v, cache)
        new_cache = {"k": k, "v": v, "length": cache["length"]}
    elif cache is not None:
        length = int(cache["length"])
        k_cache, v_cache = cache["k"], cache["v"]
        if length + s > k_cache.shape[1]:
            raise ValueError(
                f"cache write [{length}, {length + s}) exceeds its length {k_cache.shape[1]}"
            )
        k_cache[:, length : length + s] = k.to(k_cache.dtype)
        v_cache[:, length : length + s] = v.to(v_cache.dtype)
        attn = dot_product_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask=mask)
        new_cache = {"k": k_cache, "v": v_cache, "length": length}
    else:
        attn = dot_product_attention(q, k, v, mask=mask, causal=causal)
    h = h + attn.reshape(b, s, nh * d) @ lp["wo"]
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    h = h + (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]
    return h, new_cache


class _Layers(nn.Module):
    """The stacked layer weights: one ``[L, ...]`` parameter per key."""

    def __init__(self, cfg: TransformerConfig, device, dtype):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        d, nh, nkv, L = cfg.dim_per_head, cfg.num_heads, cfg.kv_heads, cfg.num_layers
        shapes = {
            "attn_norm": (L, h),
            "wq": (L, h, nh * d),
            "wk": (L, h, nkv * d),
            "wv": (L, h, nkv * d),
            "wo": (L, nh * d, h),
            "mlp_norm": (L, h),
            "w_gate": (L, h, i),
            "w_up": (L, h, i),
            "w_down": (L, i, h),
        }
        for name in LAYER_KEYS:
            self.register_parameter(
                name,
                nn.Parameter(torch.empty(shapes[name], device=device, dtype=dtype), requires_grad=False),
            )


class Llama(nn.Module):
    """A llama-style causal LM. ``seed`` draws the initial weights from a
    ``torch.Generator`` on the model's device; they need not match the JAX
    package's threefry draws (parity tests load JAX weights instead)."""

    def __init__(
        self,
        config: TransformerConfig | str,
        device=None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        cfg = get_config(config) if isinstance(config, str) else config
        if cfg.arch != "llama":
            raise ValueError(f"Llama needs a llama config, got arch {cfg.arch!r}")
        if cfg.num_experts > 1:
            raise NotImplementedError("mixture-of-experts layers are not in the port yet")
        self.config = cfg
        device = resolve_device(device)
        h, v = cfg.hidden_size, cfg.vocab_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)

        self.embed_tokens = param(v, h)
        self.layers = _Layers(cfg, device, dtype)
        self.final_norm = param(h)
        if not cfg.tie_embeddings:
            self.lm_head = param(h, v)
        self.init(seed)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @torch.no_grad()
    def init(self, seed: int) -> "Llama":
        """Draw every weight from ``seed`` (fp32 draws, cast to the model's
        dtype), in the JAX package's order: embed, attention, MLP, lm_head."""
        cfg = self.config
        h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        d, nh, nkv, L = cfg.dim_per_head, cfg.num_heads, cfg.kv_heads, cfg.num_layers
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dev = self.device
        lay = self.layers
        self.embed_tokens.copy_(torch.randn((v, h), generator=gen, device=dev) * 0.02)
        lay.attn_norm.fill_(1.0)
        lay.wq.copy_(dense_init(gen, (L, h, nh * d), h, dev))
        lay.wk.copy_(dense_init(gen, (L, h, nkv * d), h, dev))
        lay.wv.copy_(dense_init(gen, (L, h, nkv * d), h, dev))
        lay.wo.copy_(dense_init(gen, (L, nh * d, h), nh * d, dev))
        lay.mlp_norm.fill_(1.0)
        lay.w_gate.copy_(dense_init(gen, (L, h, i), h, dev))
        lay.w_up.copy_(dense_init(gen, (L, h, i), h, dev))
        lay.w_down.copy_(dense_init(gen, (L, i, h), i, dev))
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            self.lm_head.copy_(dense_init(gen, (h, v), h, dev))
        return self

    def layer_params(self, index: int) -> dict:
        """Views of layer ``index``'s weights, keyed as in the JAX layer dict."""
        return {name: getattr(self.layers, name)[index] for name in LAYER_KEYS}

    def head(self) -> torch.Tensor:
        return self.embed_tokens.T if self.config.tie_embeddings else self.lm_head

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, S] integer ids
        attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Logits ``[B, S, V]`` in the model's dtype."""
        cfg = self.config
        s = input_ids.shape[1]
        h = self.embed_tokens[input_ids.long()]
        if positions is None:
            positions = torch.arange(s, device=h.device)[None, :]
        elif positions.dim() == 1:
            positions = positions[None, :]
        cos, sin = rotary_embedding(positions, cfg.dim_per_head, cfg.rope_theta, dtype=h.dtype)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for i in range(cfg.num_layers):
            h, _ = decoder_layer(cfg, h, self.layer_params(i), cos, sin, mask, causal=True)
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return h @ self.head().to(h.dtype)
