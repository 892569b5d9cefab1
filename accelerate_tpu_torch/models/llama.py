"""Llama-family decoder as a PyTorch ``nn.Module``.

Counterpart of ``accelerate_tpu/models/llama.py``. The parameters keep the
JAX package's key paths and layouts: ``embed_tokens`` ``[V, H]``, the layer
weights stacked on a leading layer axis under ``layers.*`` with ``[in, out]``
matrices, ``final_norm`` and ``lm_head`` ``[H, V]``; an MoE config
(``num_experts > 1``) has ``router``, ``moe_up`` and ``moe_down`` in place
of the gated MLP's three matrices. Weights therefore cross between the
packages with no transposes (``utils/params.load_jax_params``). The stacked
layers run as a Python loop where the JAX package scans; ``remat_layers``
checkpoints each layer (``utils/dataclasses.CompilationConfig``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.runtime import resolve_device
from ..utils.constants import MESH_AXIS_EXPERT, MESH_AXIS_PIPELINE, MESH_AXIS_TENSOR
from ..utils.params import flatten_tree
from .attention import (
    apply_rotary,
    dense_init,
    dot_product_attention,
    draw_seeds,
    dropout,
    resolve_dot,
    rotary_embedding,
    seeded_generator,
)
from .config import TransformerConfig, get_config
from .moe import routed_mlp


def layer_keys(cfg: TransformerConfig) -> tuple[str, ...]:
    """The keys of one layer's weights, in the JAX package's order."""
    mlp = ("router", "moe_up", "moe_down") if cfg.num_experts > 1 else ("w_gate", "w_up", "w_down")
    return ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm") + mlp


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
    dot_fn=None,  # the projection hook, e.g. ops.quant_matmul.quant_dot
    attention_fn=None,  # e.g. ops.flash_attention.make_auto_attention(...)
    kv_mask: Optional[torch.Tensor] = None,  # raw [B, S] validity for attention_fn
    dropout_generators: tuple = (None, None),  # the attention and MLP branches' masks
    dropout_rate: float = 0.0,
    return_aux: bool = False,  # also return the MoE load-balance term
):
    """One llama decoder layer. Returns ``(h, new_cache_or_None)``, plus the
    layer's MoE aux loss (the float 0.0 for a dense layer) with ``return_aux``.

    ``cache`` selects the attention path:
    - with an ``attend`` hook (the serving engine's paged decode), ``attend``
      reads the page pool itself and the new token's K/V return as the cache
      delta for the engine to scatter;
    - without one (prefill, ``generate()``), K/V are written into the dense
      cache at ``length`` in place, where the JAX package returns an updated
      copy, and attention runs over the whole cache under ``mask``.

    Without a cache, ``attention_fn(q, k, v, kv_mask)`` attends when set (the
    training step's flash hook), else the einsum path under ``mask``.
    Every projection goes through ``dot_fn`` (plain ``@`` when None); an MoE
    layer's experts do not. Residual dropout draws each branch's keep mask
    from its generator (none: no dropout).
    """
    dot = resolve_dot(dot_fn)
    b, s = h.shape[:2]
    nh, nkv, d = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q = dot(x, lp["wq"]).reshape(b, s, nh, d)
    k = dot(x, lp["wk"]).reshape(b, s, nkv, d)
    v = dot(x, lp["wv"]).reshape(b, s, nkv, d)
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
    elif attention_fn is not None:
        attn = attention_fn(q, k, v, kv_mask)
    else:
        attn = dot_product_attention(q, k, v, mask=mask, causal=causal)
    h = h + dropout(dot(attn.reshape(b, s, nh * d), lp["wo"]), dropout_rate, dropout_generators[0])
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if "router" in lp:
        mlp_out, aux = routed_mlp(
            x, lp["router"], lp["moe_up"], lp["moe_down"],
            top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
        )
    else:
        mlp_out = dot(F.silu(dot(x, lp["w_gate"])) * dot(x, lp["w_up"]), lp["w_down"])
        aux = 0.0
    h = h + dropout(mlp_out, dropout_rate, dropout_generators[1])
    if return_aux:
        return h, new_cache, aux
    return h, new_cache


def layer_shapes(cfg: TransformerConfig) -> dict:
    """The stacked ``[L, ...]`` shape of every layer weight."""
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    d, nh, nkv, L = cfg.dim_per_head, cfg.num_heads, cfg.kv_heads, cfg.num_layers
    shapes = {
        "attn_norm": (L, h),
        "wq": (L, h, nh * d),
        "wk": (L, h, nkv * d),
        "wv": (L, h, nkv * d),
        "wo": (L, nh * d, h),
        "mlp_norm": (L, h),
    }
    if e > 1:
        shapes.update(router=(L, h, e), moe_up=(L, e, h, i), moe_down=(L, e, i, h))
    else:
        shapes.update(w_gate=(L, h, i), w_up=(L, h, i), w_down=(L, i, h))
    return shapes


class _Layers(nn.Module):
    """The stacked layer weights: one ``[L, ...]`` parameter per key (or,
    once :meth:`Llama.install` put one there, a packed ``QuantizedWeight``)."""

    def __init__(self, cfg: TransformerConfig, device, dtype):
        super().__init__()
        for name, shape in layer_shapes(cfg).items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)
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
        self.config = cfg
        # the projection hook of every layer (None = plain matmul);
        # quantized-resident serving installs ops.quant_matmul.quant_dot
        self.dot_fn = None
        # the attention hook of the training forward (None = einsum);
        # Accelerator.prepare_model installs the flash dispatch
        self.attention_fn = None
        # per-layer activation checkpointing, set by Accelerator.prepare_model:
        # False = off, or a utils.dataclasses.Remat policy run around each layer
        self.remat_layers = False
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
        dtype), in the JAX package's order: embed, attention, MLP (router and
        experts for an MoE config), lm_head."""
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
        if cfg.num_experts > 1:
            e = cfg.num_experts
            lay.router.copy_(dense_init(gen, (L, h, e), h, dev))
            lay.moe_up.copy_(dense_init(gen, (L, e, h, i), h, dev))
            lay.moe_down.copy_(dense_init(gen, (L, e, i, h), i, dev))
        else:
            lay.w_gate.copy_(dense_init(gen, (L, h, i), h, dev))
            lay.w_up.copy_(dense_init(gen, (L, h, i), h, dev))
            lay.w_down.copy_(dense_init(gen, (L, i, h), i, dev))
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            self.lm_head.copy_(dense_init(gen, (h, v), h, dev))
        return self

    def layer_params(self, index: int) -> dict:
        """Views of layer ``index``'s weights, keyed as in the JAX layer dict
        (a packed layer matrix gives its per-layer ``QuantizedWeight`` view)."""
        return {name: getattr(self.layers, name)[index] for name in layer_keys(self.config)}

    def _shapes(self) -> dict:
        cfg = self.config
        shapes = {"embed_tokens": (cfg.vocab_size, cfg.hidden_size), "final_norm": (cfg.hidden_size,)}
        if not cfg.tie_embeddings:
            shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
        shapes.update({f"layers.{k}": s for k, s in layer_shapes(cfg).items()})
        return shapes

    def param_tree(self) -> dict:
        """The weights as the JAX package's nested param dict (no copies)."""
        tree: dict = {"layers": {name: getattr(self.layers, name) for name in layer_keys(self.config)}}
        for name in self._shapes():
            if not name.startswith("layers."):
                tree[name] = getattr(self, name)
        return tree

    @torch.no_grad()
    def install(self, tree: dict) -> "Llama":
        """Replace every weight by the leaf at its key path in ``tree`` (the
        JAX layout): a tensor, or for a layer matrix a stacked packed
        ``QuantizedWeight`` that stays packed. Nothing is copied; the model's
        device and dtype follow the leaves. Raises ``KeyError`` when the key
        paths differ and ``ValueError`` when a (logical) shape does."""
        leaves = dict(flatten_tree(tree))
        shapes = self._shapes()
        if set(leaves) != set(shapes):
            raise KeyError(
                f"param tree mismatch: missing {sorted(set(shapes) - set(leaves))}, "
                f"unexpected {sorted(set(leaves) - set(shapes))}"
            )
        for path, leaf in leaves.items():
            if tuple(leaf.shape) != shapes[path]:
                raise ValueError(f"{path}: leaf has shape {tuple(leaf.shape)}, expected {shapes[path]}")
            owner, name = (self.layers, path[len("layers."):]) if path.startswith("layers.") else (self, path)
            owner._parameters.pop(name, None)
            owner.__dict__.pop(name, None)
            if isinstance(leaf, torch.Tensor):
                owner.register_parameter(name, nn.Parameter(leaf, requires_grad=False))
            else:
                object.__setattr__(owner, name, leaf)  # a packed QuantizedWeight
        return self

    def partition_rules(self) -> list[tuple[str, tuple]]:
        """The JAX package's layout rules (Megatron-style tensor parallelism:
        attention by heads, the MLP by its intermediate dim; the stacked
        layers' leading dim over ``pipeline``). The port runs only the data
        and fsdp axes, so every axis named here has size 1 and the rules
        place the fsdp and ZeRO splits as the JAX package does."""
        t, p = MESH_AXIS_TENSOR, MESH_AXIS_PIPELINE
        return [
            (r"embed_tokens", (t, None)),
            (r"layers/(wq|wk|wv)", (p, None, t)),
            (r"layers/wo", (p, t, None)),
            (r"layers/(w_gate|w_up)", (p, None, t)),
            (r"layers/w_down", (p, t, None)),
            (r"layers/router", (p, None, None)),
            (r"layers/moe_up", (p, MESH_AXIS_EXPERT, None, t)),
            (r"layers/moe_down", (p, MESH_AXIS_EXPERT, t, None)),
            (r"layers/(attn_norm|mlp_norm)", (p, None)),
            (r"final_norm", (None,)),
            (r"lm_head", (None, t)),
        ]

    def head(self) -> torch.Tensor:
        return self.embed_tokens.T if self.config.tie_embeddings else self.lm_head

    def apply(
        self,
        params: dict,  # the JAX layout: param_tree(), or a cast copy of it
        input_ids: torch.Tensor,  # [B, S] integer ids
        attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real
        positions: Optional[torch.Tensor] = None,
        dropout_generator: Optional[torch.Generator] = None,
        return_aux: bool = False,
    ):
        """Logits ``[B, S, V]`` in the params' dtype, with the weights taken
        from ``params`` (the JAX package's ``apply``, which a user's
        ``loss_fn`` calls; it shadows ``nn.Module.apply``): the training
        step passes its compute-dtype cast of the fp32 masters, so gradients
        flow back to them. The stacked layers run as a loop over views
        unbound once per key.

        ``dropout_generator`` turns on ``config.dropout_rate`` residual
        dropout: one seed per layer and branch is drawn from it before the
        loop (the JAX package splits ``L * 2`` keys), and each layer builds
        its branches' generators from its seeds, so a checkpointed layer
        draws the same masks when it is recomputed. ``return_aux`` adds the
        summed MoE load-balance loss (fp32; the float 0.0 for a dense
        config) as a second output."""
        cfg = self.config
        s = input_ids.shape[1]
        h = params["embed_tokens"][input_ids.long()]
        if positions is None:
            positions = torch.arange(s, device=h.device)[None, :]
        elif positions.dim() == 1:
            positions = positions[None, :]
        cos, sin = rotary_embedding(positions, cfg.dim_per_head, cfg.rope_theta, dtype=h.dtype)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        keys = layer_keys(cfg)
        layers = params["layers"]
        per_key = {
            name: layers[name].unbind(0) if isinstance(layers[name], torch.Tensor)
            else [layers[name][i] for i in range(cfg.num_layers)]
            for name in keys
        }
        seeds = [None] * (2 * cfg.num_layers)
        if dropout_generator is not None and cfg.dropout_rate > 0.0:
            seeds = draw_seeds(dropout_generator, 2 * cfg.num_layers)

        def layer(h, lp, seed_attn, seed_mlp):
            h, _, aux = decoder_layer(
                cfg, h, lp, cos, sin, mask, causal=True, dot_fn=self.dot_fn,
                attention_fn=self.attention_fn, kv_mask=attention_mask,
                dropout_generators=(seeded_generator(seed_attn, h.device), seeded_generator(seed_mlp, h.device)),
                dropout_rate=cfg.dropout_rate, return_aux=True,
            )
            return h, aux

        total_aux = 0.0
        for i in range(cfg.num_layers):
            args = (h, {name: per_key[name][i] for name in keys}, seeds[2 * i], seeds[2 * i + 1])
            h, aux = self.remat_layers(layer, *args) if self.remat_layers else layer(*args)
            total_aux = total_aux + aux
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        head = params["embed_tokens"].T if cfg.tie_embeddings else params["lm_head"]
        logits = h @ head.to(h.dtype)
        return (logits, total_aux) if return_aux else logits

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, S] integer ids
        attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Logits ``[B, S, V]`` in the model's dtype."""
        return self.apply(self.param_tree(), input_ids, attention_mask, positions)

    @staticmethod
    def loss_fn(model: "Llama", dropout_generator: Optional[torch.Generator] = None):
        """Next-token cross-entropy over a batch ``{input_ids,
        [attention_mask]}``: log-softmax in fp32, the mask weighting the
        targets' positions, as the JAX package's ``Llama.loss_fn``; an MoE
        config adds the summed load-balance term. ``dropout_generator``
        (the port's addition) turns residual dropout on: each call draws
        its seeds from it."""

        def fn(params, batch):
            input_ids = batch["input_ids"]
            attention_mask = batch.get("attention_mask")
            logits, aux = model.apply(params, input_ids, attention_mask,
                                      dropout_generator=dropout_generator, return_aux=True)
            targets = input_ids[:, 1:].long()
            logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
            nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
            if attention_mask is not None:
                w = attention_mask[:, 1:].float()
                loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
            else:
                loss = nll.mean()
            return loss + aux

        return fn
