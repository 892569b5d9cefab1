"""Llama-family decoder as a PyTorch ``nn.Module``.

Counterpart of ``accelerate_tpu/models/llama.py``. The parameters keep the
JAX package's key paths and layouts: ``embed_tokens`` ``[V, H]``, the layer
weights stacked on a leading layer axis under ``layers.*`` with ``[in, out]``
matrices, ``final_norm`` and ``lm_head`` ``[H, V]``; an MoE config
(``num_experts > 1``) has ``router``, ``moe_up`` and ``moe_down`` in place
of the gated MLP's three matrices. Weights therefore cross between the
packages with no transposes (``utils/params.load_jax_params``). The stacked
layers run as a Python loop where the JAX package scans; ``remat_layers``
checkpoints each layer (``utils/dataclasses.CompilationConfig``). Under a
pipeline axis ``pipeline_fn`` (``parallel/pipeline.py``, wired by
``Accelerator.prepare_model``) runs the layers in the loop's place, one
layer at a time through the ``pipeline_layer`` hook.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.runtime import resolve_device
from ..parallel.pipeline import OWN_HOOK, split_seed
from ..parallel.tensor_parallel import (
    column_products,
    gather_last,
    kv_columns,
    replicas_of,
    row_product,
    split_or_none,
    vocab_embedding,
    vocab_parallel_nll,
)
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
    sequence_chunk,
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
    tensor_parallel=None,  # parallel.tensor_parallel.TensorParallel: the tensor group
    expert_parallel=None,  # parallel.tensor_parallel.ExpertParallel: the expert group
    sequence=None,  # a sequence axis's ring: the MoE routes over the whole sequence
):
    """One llama decoder layer. Returns ``(h, new_cache_or_None)``, plus the
    layer's MoE aux loss (the float 0.0 for a dense layer) with ``return_aux``.

    Where ``lp`` holds this process's slices over the tensor axis (its
    heads' q, k, v and o, its share of the MLP's hidden dim) the projections
    are column- and row-parallel and attention runs on its heads; with
    fewer kv heads than the group has processes, k and v stay whole and
    each process reads the kv head its query heads read. Whole weights run
    the plain layer whatever the groups.

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
    tp = split_or_none(tensor_parallel, lp["wq"].shape[-1], nh * d)
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    proj = column_products(x, dot, tp)
    cols = kv_columns(tp, nh, nkv, d) if tp is not None and lp["wk"].shape[-1] == nkv * d else None
    nh, nkv = lp["wq"].shape[-1] // d, (lp["wk"].shape[-1] if cols is None else d) // d
    q = proj(lp["wq"]).reshape(b, s, nh, d)
    k = proj(lp["wk"], cols).reshape(b, s, nkv, d)
    v = proj(lp["wv"], cols).reshape(b, s, nkv, d)
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
    h = h + dropout(row_product(attn.reshape(b, s, nh * d), lp["wo"], dot, tp), dropout_rate, dropout_generators[0])
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if "router" in lp:
        mlp_out, aux = routed_mlp(
            x, lp["router"], lp["moe_up"], lp["moe_down"],
            top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
            tensor_parallel=split_or_none(tensor_parallel, lp["moe_up"].shape[-1], cfg.intermediate_size),
            expert_parallel=split_or_none(expert_parallel, lp["moe_up"].shape[0], cfg.num_experts),
            sequence=sequence,
        )
    else:
        tp = split_or_none(tensor_parallel, lp["w_up"].shape[-1], cfg.intermediate_size)
        proj = column_products(x, dot, tp)
        mlp_out = row_product(F.silu(proj(lp["w_gate"])) * proj(lp["w_up"]), lp["w_down"], dot, tp)
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


@torch.no_grad()
def install_params(module: nn.Module, tree: dict, shapes: dict) -> nn.Module:
    """Bind every leaf of ``tree`` (the JAX layout) as ``module``'s weight at
    its key path, ``layers.*`` under ``module.layers``: a tensor becomes the
    parameter, a stacked packed ``QuantizedWeight`` stays packed. Nothing
    is copied. ``shapes`` holds every dotted key path and its (logical)
    shape; a key path missing or extra raises ``KeyError``, a shape off
    ``ValueError``. Returns ``module``."""
    leaves = dict(flatten_tree(tree))
    if set(leaves) != set(shapes):
        raise KeyError(
            f"param tree mismatch: missing {sorted(set(shapes) - set(leaves))}, "
            f"unexpected {sorted(set(leaves) - set(shapes))}"
        )
    for path, leaf in leaves.items():
        if tuple(leaf.shape) != shapes[path]:
            raise ValueError(f"{path}: leaf has shape {tuple(leaf.shape)}, expected {shapes[path]}")
        layers = path.startswith("layers.")
        owner, name = (module.layers, path[len("layers."):]) if layers else (module, path)
        owner._parameters.pop(name, None)
        owner.__dict__.pop(name, None)
        if isinstance(leaf, torch.Tensor):
            owner.register_parameter(name, nn.Parameter(leaf, requires_grad=False))
        else:
            object.__setattr__(owner, name, leaf)  # a packed QuantizedWeight
    return module


def next_token_loss(logits: torch.Tensor, input_ids: torch.Tensor, attention_mask, attention_fn,
                    tensor_parallel=None, vocab: Optional[int] = None):
    """Next-token cross-entropy of a causal LM's ``logits`` over ``input_ids``:
    log-softmax in fp32, the mask weighting the targets' positions, as the
    JAX package's ``loss_fn``s. Logits split over the vocab (this process's
    slice under the tensor axis, of a ``vocab``-wide head) take the
    vocab-parallel log-softmax (``parallel.tensor_parallel.vocab_parallel_nll``).

    Under a sequence axis (a ring ``attention_fn``; ``sequence_chunk``) the
    logits are this process's chunk: it takes the terms of the chunk's
    positions, normalized by the whole batch's count, so the terms summed
    over the sequence group are the loss. A chunk's last target is the next
    chunk's first token, which the global rows hold, and the sequence's
    last position has none. Returns ``(loss, counts)``: ``counts`` is False
    on a process whose whole-sequence terms count elsewhere."""
    s = input_ids.shape[1]
    start, stop, _, counts = sequence_chunk(attention_fn, s)
    vocab = vocab or logits.shape[-1]
    if stop - start == s:
        nll = vocab_parallel_nll(logits[:, :-1], input_ids[:, 1:], tensor_parallel, vocab)
        if attention_mask is not None:
            w = attention_mask[:, 1:].float()
            return (nll * w).sum() / torch.clamp(w.sum(), min=1.0), counts
        return nll.mean(), counts
    targets = input_ids[:, start + 1:stop + 1]
    nll = vocab_parallel_nll(logits[:, :targets.shape[1]], targets, tensor_parallel, vocab)
    if attention_mask is None:
        return nll.sum() / (input_ids.shape[0] * (s - 1)), True
    w = attention_mask[:, start + 1:stop + 1].float()
    return (nll * w).sum() / torch.clamp(attention_mask[:, 1:].float().sum(), min=1.0), True


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

    # under a ring hook (a sequence axis) apply runs this process's chunk
    sequence_chunks = True

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
        # the tensor and expert groups (parallel/tensor_parallel.py), set by
        # Accelerator.prepare_model under those axes; None = no group
        self.tensor_parallel = None
        self.expert_parallel = None
        # the layer stack's pipeline schedule (parallel/pipeline.py), set by
        # Accelerator.prepare_model under a pipeline axis; None = the loop
        self.pipeline_fn = None
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
        if self.device.type == "meta":  # shapes only (init_empty_weights): nothing to draw
            return self
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

    def install(self, tree: dict) -> "Llama":
        """Replace every weight by the leaf at its key path in ``tree`` (the
        JAX layout): a tensor, or for a layer matrix a stacked packed
        ``QuantizedWeight`` that stays packed. Nothing is copied; the model's
        device and dtype follow the leaves. Raises ``KeyError`` when the key
        paths differ and ``ValueError`` when a (logical) shape does."""
        return install_params(self, tree, self._shapes())

    def partition_rules(self) -> list[tuple[str, tuple]]:
        """The JAX package's layout rules (Megatron-style tensor parallelism:
        attention by heads, the MLP by its intermediate dim; the stacked
        layers' leading dim over ``pipeline``), which place every split as
        the JAX package does; :meth:`tensor_rules` go before them."""
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

    def tensor_rules(self, tensor: int) -> list[tuple[str, tuple]]:
        """Rules that go before :meth:`partition_rules` under a tensor group
        of ``tensor``: with fewer kv heads than processes, k and v stay whole
        (the JAX rule splits their columns mid-head, which GSPMD can run and
        a process running its own heads cannot), and each process reads the
        kv head its query heads read."""
        if tensor > 1 and self.config.kv_heads < tensor:
            return [(r"layers/(wk|wv)", (MESH_AXIS_PIPELINE, None, None))]
        return []

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
        gather_logits: bool = True,
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
        config) as a second output.

        Under a ring hook (a sequence axis) the batch holds the global rows
        and this process runs its chunk of the sequence from the embeddings
        on (rotary positions at the chunk's offset; ``sequence_chunk``):
        the logits are the chunk's ``[B, S/n, V]``; an MoE layer routes over
        the whole sequence.

        Params split over the tensor axis (``tensor_parallel``) run
        Megatron-style: a vocab-parallel embedding, this process's heads and
        hidden slice, a column-parallel head whose logits are gathered over
        the group unless ``gather_logits`` is False (the loss takes this
        process's slice of the vocab); ``expert_parallel`` runs the MoE
        layers' exchange.

        Under a pipeline axis (``pipeline_fn``) ``params["layers"]`` holds
        this process's chunks and the schedule runs them: dropout draws
        from one base seed folded per (layer, microbatch), and the aux is
        the mean of the microbatches' (``parallel/pipeline.py``)."""
        cfg = self.config
        tp = self.tensor_parallel
        start, stop, attention_fn, _ = sequence_chunk(self.attention_fn, input_ids.shape[1])
        ring = getattr(attention_fn, "ring", None) if stop - start < input_ids.shape[1] else None
        h = vocab_embedding(params["embed_tokens"], input_ids[:, start:stop], tp, cfg.vocab_size)
        if positions is None:
            positions = torch.arange(start, stop, device=h.device)[None, :]
        else:
            positions = (positions[None, :] if positions.dim() == 1 else positions)[..., start:stop]
        cos, sin = rotary_embedding(positions, cfg.dim_per_head, cfg.rope_theta, dtype=h.dtype)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
            attention_mask = attention_mask[:, start:stop]
        keys = layer_keys(cfg)
        layers = params["layers"]
        if self.pipeline_fn is not None:
            seed = None
            if dropout_generator is not None and cfg.dropout_rate > 0.0:
                seed = draw_seeds(dropout_generator, 1, self.pipeline_fn.replicas)[0]
            h, total_aux = self.pipeline_fn(layers, h, mask, cos, sin, attention_mask, dropout_rng=seed,
                                            attention_fn=attention_fn, sequence=ring)
            return self._head(params, h, tp, gather_logits, total_aux if return_aux else None)
        per_key = {
            name: layers[name].unbind(0) if isinstance(layers[name], torch.Tensor)
            else [layers[name][i] for i in range(cfg.num_layers)]
            for name in keys
        }
        seeds = [None] * (2 * cfg.num_layers)
        if dropout_generator is not None and cfg.dropout_rate > 0.0:
            seeds = draw_seeds(dropout_generator, 2 * cfg.num_layers, replicas_of(tp, self.expert_parallel))

        def layer(h, lp, seed_attn, seed_mlp):
            h, _, aux = decoder_layer(
                cfg, h, lp, cos, sin, mask, causal=True, dot_fn=self.dot_fn,
                attention_fn=attention_fn, kv_mask=attention_mask,
                dropout_generators=(seeded_generator(seed_attn, h.device), seeded_generator(seed_mlp, h.device)),
                dropout_rate=cfg.dropout_rate, return_aux=True,
                tensor_parallel=tp, expert_parallel=self.expert_parallel, sequence=ring,
            )
            return h, aux

        total_aux = 0.0
        for i in range(cfg.num_layers):
            args = (h, {name: per_key[name][i] for name in keys}, seeds[2 * i], seeds[2 * i + 1])
            h, aux = self.remat_layers(layer, *args) if self.remat_layers else layer(*args)
            total_aux = total_aux + aux
        return self._head(params, h, tp, gather_logits, total_aux if return_aux else None)

    def _head(self, params: dict, h, tp, gather_logits: bool, aux):
        """The final norm and the head: logits, or ``(logits, aux)``."""
        cfg = self.config
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        head = (params["embed_tokens"].T if cfg.tie_embeddings else params["lm_head"]).to(h.dtype)
        vocab_tp = split_or_none(tp, head.shape[-1], cfg.vocab_size)
        logits = column_products(h, torch.matmul, vocab_tp)(head)
        if gather_logits:
            logits = gather_last(logits, vocab_tp)
        return logits if aux is None else (logits, aux)

    # the sequence dim of the pipeline's activations and side inputs (mask,
    # cos, sin, kv_mask): under a sequence axis the schedule runs this
    # process's chunk of the sequence, through the ring
    pipeline_seq_dims = {"h": 1, "consts": (3, 1, 1, 1)}
    # cos/sin stay shape-inferred (batch-invariant [1, S, D/2] with default
    # positions, per-row [B, S, D/2] otherwise); mask/kv_mask are batched
    pipeline_const_kinds = ("mb", None, None, "mb")

    def pipeline_layer(self, lp, h, seed, mask, cos, sin, kv_mask=None, attention_fn=OWN_HOOK, sequence=None):
        """One decoder layer in the schedule's ``layer_fn`` contract,
        ``(lp, h, seed, *consts) -> (h, aux)``: ``seed`` the folded dropout
        seed of (layer, microbatch) or None, split into the two branches'
        seeds; ``aux`` the MoE balance term (0.0 for a dense layer). The
        call's attention hook and ring come from ``apply`` (the model's
        ``attention_fn`` when none is passed); fp8's ``dot_fn`` and the
        tensor and expert groups apply inside the stage as in the loop."""
        generators = (None, None)
        if seed is not None:
            generators = tuple(seeded_generator(x, h.device) for x in split_seed(seed, 2))
        h, _, aux = decoder_layer(
            self.config, h, lp, cos, sin, mask, causal=True, dot_fn=self.dot_fn,
            attention_fn=self.attention_fn if attention_fn is OWN_HOOK else attention_fn, kv_mask=kv_mask,
            dropout_generators=generators, dropout_rate=self.config.dropout_rate, return_aux=True,
            tensor_parallel=self.tensor_parallel, expert_parallel=self.expert_parallel, sequence=sequence,
        )
        return h, aux

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, S] integer ids
        attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Logits ``[B, S, V]`` in the model's dtype."""
        return self.apply(self.param_tree(), input_ids, attention_mask, positions)

    # -- streaming protocol (big_modeling.StreamedModel's forward) --------------
    # Weights come from ``resident`` (the non-layer leaves) and ``lp`` (one
    # layer's), never from the module, so a model built on ``meta`` streams.
    # No attention hook: a flash or ring ``attention_fn`` left on the model
    # stays out of the streamed layers, as in the JAX package.

    def stream_prefix(self, resident: dict, input_ids: torch.Tensor, attention_mask=None):
        """Embeddings, rotary tables and padding mask: the carry of the layers."""
        cfg = self.config
        h = resident["embed_tokens"][input_ids.long()]
        positions = torch.arange(input_ids.shape[1], device=h.device)[None, :]
        cos, sin = rotary_embedding(positions, cfg.dim_per_head, cfg.rope_theta, dtype=h.dtype)
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        return (h, cos, sin, mask)

    def stream_layer(self, carry, lp: dict):
        h, cos, sin, mask = carry
        h, _ = decoder_layer(self.config, h, lp, cos, sin, mask, causal=True, dot_fn=self.dot_fn)
        return (h, cos, sin, mask)

    def stream_suffix(self, resident: dict, carry) -> torch.Tensor:
        """fp32 logits ``[B, S, V]``."""
        h = rms_norm(carry[0], resident["final_norm"], self.config.norm_eps)
        head = resident["embed_tokens"].T if self.config.tie_embeddings else resident["lm_head"]
        return (h @ head.to(h.dtype)).float()

    # -- streamed decode protocol (big_modeling.StreamedModel.generate) --------

    def init_layer_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """One layer's dense cache ``{"k", "v"}`` ``[batch, max_len, KV, D]``."""
        cfg = self.config
        shape = (batch, max_len, cfg.kv_heads, cfg.dim_per_head)
        device = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode_prefix(self, resident: dict, input_ids: torch.Tensor, length: int, max_len: int):
        """The decode carry of ``input_ids`` at cache offset ``length``: the
        rotary tables at their positions and the causal-over-cache mask."""
        cfg = self.config
        h = resident["embed_tokens"][input_ids.long()]
        q_pos = length + torch.arange(input_ids.shape[1], device=h.device)
        cos, sin = rotary_embedding(q_pos[None, :], cfg.dim_per_head, cfg.rope_theta, dtype=h.dtype)
        mask = (torch.arange(max_len, device=h.device)[None, :] <= q_pos[:, None])[None, None]
        return (h, cos, sin, mask)

    def stream_layer_cached(self, carry, lp: dict, cache: dict, length: int):
        """One layer against its cache (written in place at ``length``)."""
        h, cos, sin, mask = carry
        h, nc = decoder_layer(self.config, h, lp, cos, sin, mask,
                              cache={"k": cache["k"], "v": cache["v"], "length": length}, dot_fn=self.dot_fn)
        return (h, cos, sin, mask), {"k": nc["k"], "v": nc["v"]}

    def decode_suffix(self, resident: dict, carry) -> torch.Tensor:
        """fp32 logits of the last position ``[B, V]``."""
        h = rms_norm(carry[0], resident["final_norm"], self.config.norm_eps)
        head = resident["embed_tokens"].T if self.config.tie_embeddings else resident["lm_head"]
        return (h[:, -1] @ head.to(h.dtype)).float()

    @staticmethod
    def loss_fn(model: "Llama", dropout_generator: Optional[torch.Generator] = None):
        """Next-token cross-entropy over a batch ``{input_ids,
        [attention_mask]}``: log-softmax in fp32, the mask weighting the
        targets' positions, as the JAX package's ``Llama.loss_fn``; an MoE
        config adds the summed load-balance term. ``dropout_generator``
        (the port's addition) turns residual dropout on: each call draws
        its seeds from it.

        Under a sequence axis each process takes the terms of its chunk's
        positions, normalized by the whole batch's count, so the terms
        summed over the sequence group are the loss (``Accelerator`` sums
        the losses and gradients there): a chunk's last target is the next
        chunk's first token, which the global rows hold, and the sequence's
        last position has none."""

        def fn(params, batch):
            input_ids = batch["input_ids"]
            attention_mask = batch.get("attention_mask")
            logits, aux = model.apply(params, input_ids, attention_mask,
                                      dropout_generator=dropout_generator, return_aux=True, gather_logits=False)
            loss, counts = next_token_loss(logits, input_ids, attention_mask, model.attention_fn,
                                           model.tensor_parallel, model.config.vocab_size)
            return loss + aux if counts else (loss + aux) * 0.0

        return fn
