"""T5-family encoder-decoder as a PyTorch ``nn.Module``.

Counterpart of ``accelerate_tpu/models/t5.py``: cross-attention, T5's
relative-position buckets, unscaled attention (the 1/sqrt(d) factor is
folded into the init, as in the paper), RMSNorm, a ReLU feed-forward and
shared embeddings with the ``d_model^-0.5`` logit scale. The parameters keep
the JAX package's key paths and layouts: ``shared_embed`` ``[V, H]``, the
tables ``enc_rel_bias`` and ``dec_rel_bias`` ``[buckets, N]``, the encoder
stack under ``encoder.*`` (8 leaves) and the decoder stack under ``layers.*``
(13 leaves), each stacked on a leading layer axis with ``[in, out]``
matrices, and ``enc_final_norm`` / ``dec_final_norm``, so weights cross
between the packages with no transposes (``utils/params.load_jax_params``).

Attention takes the hook ``Accelerator.prepare_model`` installs when it
declares ``supports_bias`` (the flash dispatch does): the encoder's
self-attention with the bidirectional relative bias, the decoder's with the
causal one, both under the padding masks, and the cross-attention without a
bias, all from one hook through its per-call ``causal``. Without the hook
the exact einsum path runs. The two stacks run as Python loops where the
JAX package scans; ``remat_layers`` checkpoints each layer of both.

The streaming and streamed-decode protocol (``stream_prefix`` ...
``decode_suffix``) serves ``big_modeling.Seq2SeqStreamedModel``: the
encoder runs once, resident, and the decoder stack streams; neither takes
the attention hook. Not in the port yet, raising ``NotImplementedError``:
the pipeline hooks (ROADMAP item 17).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.runtime import resolve_device
from ..utils.constants import MESH_AXIS_PIPELINE, MESH_AXIS_TENSOR
from .attention import dense_init, draw_seeds, dropout, resolve_dot, round_to_dtype, seeded_generator
from .bert import _Group
from .config import TransformerConfig, get_config
from .llama import rms_norm

NEG_INF = -1e30
ENCODER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wi", "wo_ff")
DECODER_KEYS = (
    "self_norm", "self_wq", "self_wk", "self_wv", "self_wo",
    "cross_norm", "cross_wq", "cross_wk", "cross_wv", "cross_wo",
    "mlp_norm", "wi", "wo_ff",
)


def relative_position_bucket(
    relative_position: torch.Tensor, bidirectional: bool, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """T5 relative-position bucketing (Raffel et al. 2020 §2.1): exact buckets
    up to num_buckets/2, log-spaced beyond, clamped at max_distance."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(relative_position.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(relative_position.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def relative_bias(
    table: torch.Tensor,  # [num_buckets, n_heads]
    q_positions: torch.Tensor,  # [S_q]
    k_positions: torch.Tensor,  # [S_k]
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """``[1, n_heads, S_q, S_k]`` additive attention bias, fp32."""
    rel = k_positions[None, :] - q_positions[:, None]  # [S_q, S_k]
    buckets = relative_position_bucket(rel, bidirectional, num_buckets, max_distance)
    return F.embedding(buckets, table).permute(2, 0, 1)[None].to(torch.float32)


def t5_attention(q, k, v, bias, mask) -> torch.Tensor:
    """Unscaled dot-product attention with an additive position bias.

    q [B,Sq,N,D], k/v [B,Sk,N,D]; bias [1,N,Sq,Sk] fp32 or None; mask
    broadcastable to [B,1,Sq,Sk] bool (True = attend) or None."""
    scores = torch.einsum("bqnd,bknd->bnqk", q, k).to(torch.float32)
    if bias is not None:
        scores = scores + bias
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", p, v)


def t5_shapes(cfg: TransformerConfig) -> dict:
    """Every weight's shape, by group and key (the top-level leaves under
    ``None``), in the JAX package's order."""
    h, i, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    inner = cfg.num_heads * cfg.dim_per_head
    attn = lambda prefix: {  # noqa: E731
        f"{prefix}wq": (L, h, inner), f"{prefix}wk": (L, h, inner),
        f"{prefix}wv": (L, h, inner), f"{prefix}wo": (L, inner, h),
    }
    return {
        None: {
            "shared_embed": (v, h),
            "enc_rel_bias": (cfg.rel_buckets, cfg.num_heads),
            "dec_rel_bias": (cfg.rel_buckets, cfg.num_heads),
            "enc_final_norm": (h,),
            "dec_final_norm": (h,),
        },
        "encoder": {
            "attn_norm": (L, h), **attn(""), "mlp_norm": (L, h), "wi": (L, h, i), "wo_ff": (L, i, h),
        },
        "layers": {
            "self_norm": (L, h), **attn("self_"), "cross_norm": (L, h), **attn("cross_"),
            "mlp_norm": (L, h), "wi": (L, h, i), "wo_ff": (L, i, h),
        },
    }


class T5(nn.Module):
    """A T5-style seq2seq LM with shared embeddings. ``seed`` draws the
    initial weights from a ``torch.Generator`` on the model's device
    (parity tests load the JAX package's weights instead)."""

    is_encoder_decoder = True

    def __init__(
        self,
        config: TransformerConfig | str,
        device=None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        cfg = get_config(config) if isinstance(config, str) else config
        if cfg.arch != "t5":
            raise ValueError(f"T5 needs a t5 config, got arch {cfg.arch!r}")
        self.config = cfg
        # hooks set by Accelerator.prepare_model (see models/llama.py); the
        # attention hook is engaged only when it declares supports_bias
        self.dot_fn = None
        self.attention_fn = None
        self.remat_layers = False
        device = resolve_device(device)
        shapes = t5_shapes(cfg)
        for name, shape in shapes[None].items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)
            )
        self.encoder = _Group(shapes["encoder"], device, dtype)
        self.layers = _Group(shapes["layers"], device, dtype)
        self.init(seed)

    @property
    def device(self) -> torch.device:
        return self.shared_embed.device

    @torch.no_grad()
    def init(self, seed: int) -> "T5":
        """Draw every weight from ``seed`` (fp32 draws, cast to the model's
        dtype) in the JAX package's order: the embedding, the two bias
        tables, the encoder's q, k, v, o, wi, wo_ff, the decoder's self and
        cross q, k, v, o and its wi, wo_ff; norms at 1."""
        if self.device.type == "meta":  # shapes only (init_empty_weights): nothing to draw
            return self
        cfg = self.config
        h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
        inner = cfg.num_heads * cfg.dim_per_head
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.shared_embed.copy_(torch.randn(self.shared_embed.shape, generator=gen, device=dev) * 0.02)
        for table in (self.enc_rel_bias, self.dec_rel_bias):
            table.copy_(torch.randn(table.shape, generator=gen, device=dev) * 0.1)
        shapes = {"wq": ((L, h, inner), h), "wk": ((L, h, inner), h), "wv": ((L, h, inner), h),
                  "wo": ((L, inner, h), inner)}
        for name, (shape, fan_in) in shapes.items():
            getattr(self.encoder, name).copy_(dense_init(gen, shape, fan_in, dev))
        self.encoder.wi.copy_(dense_init(gen, (L, h, i), h, dev))
        self.encoder.wo_ff.copy_(dense_init(gen, (L, i, h), i, dev))
        for prefix in ("self_", "cross_"):
            for name, (shape, fan_in) in shapes.items():
                getattr(self.layers, prefix + name).copy_(dense_init(gen, shape, fan_in, dev))
        self.layers.wi.copy_(dense_init(gen, (L, h, i), h, dev))
        self.layers.wo_ff.copy_(dense_init(gen, (L, i, h), i, dev))
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
        return self

    def param_tree(self) -> dict:
        """The weights as the JAX package's nested param dict (no copies)."""
        shapes = t5_shapes(self.config)
        tree: dict = {name: getattr(self, name) for name in shapes[None]}
        for group in ("encoder", "layers"):
            tree[group] = {name: getattr(getattr(self, group), name) for name in shapes[group]}
        return tree

    def partition_rules(self) -> list[tuple[str, tuple]]:
        """The JAX package's Megatron rules: q/k/v/wi column-parallel, the
        output projections row-parallel, the bias tables replicated, the
        stacked leading dims over ``pipeline``. The port runs only the data
        and fsdp axes, so every axis named here has size 1."""
        t, p = MESH_AXIS_TENSOR, MESH_AXIS_PIPELINE
        return [
            (r"shared_embed", (t, None)),
            (r"rel_bias", (None, None)),
            (r"(encoder|layers)/.*w[qkv]$", (p, None, t)),
            (r"(encoder|layers)/.*wo$", (p, t, None)),
            (r"(encoder|layers)/wi", (p, None, t)),
            (r"(encoder|layers)/wo_ff", (p, t, None)),
            (r"(encoder|layers)/.*norm", (p, None)),
            (r"norm", (None,)),
        ]

    # -- layer bodies -------------------------------------------------------

    def _attn(self, q, k, v, bias, mask, kv_mask, causal: bool, use_hook: bool = True):
        """Through the hook when it carries the bias (the flash kernels),
        else the exact einsum. ``mask`` is the 4-D mask of the einsum;
        ``kv_mask`` the raw [B, S] validity the hook takes. ``use_hook=False``
        forces the einsum (the streamed stacks, which hold 4-D masks only)."""
        fn = self.attention_fn
        if use_hook and fn is not None and getattr(fn, "supports_bias", False):
            return fn(q, k, v, kv_mask, bias=bias, scale=1.0, causal=causal)
        return t5_attention(q, k, v, bias, mask)

    def _enc_layer(self, h, lp, bias, mask, generators=(None, None), kv_mask=None, use_hook: bool = True):
        cfg = self.config
        dot = resolve_dot(self.dot_fn)
        b, s = h.shape[:2]
        nh, d = cfg.num_heads, cfg.dim_per_head
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q = dot(x, lp["wq"]).reshape(b, s, nh, d)
        k = dot(x, lp["wk"]).reshape(b, s, nh, d)
        v = dot(x, lp["wv"]).reshape(b, s, nh, d)
        attn = self._attn(q, k, v, bias, mask, kv_mask, causal=False, use_hook=use_hook)
        h = h + dropout(dot(attn.reshape(b, s, nh * d), lp["wo"]), cfg.dropout_rate, generators[0])
        x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        mlp_out = dot(torch.relu(dot(x, lp["wi"])), lp["wo_ff"])
        return h + dropout(mlp_out, cfg.dropout_rate, generators[1])

    def _dec_layer(self, h, lp, self_bias, self_mask, enc_out, enc_mask,
                   generators=(None, None, None), kv_masks=(None, None), cache=None, length=None,
                   use_hook: bool = True):
        """One decoder layer: self-attention (with the causal relative bias),
        cross-attention over ``enc_out``, feed-forward. ``cache`` ``{"k",
        "v"}`` ``[B, T, N, D]`` (the streamed decode) takes this step's K/V
        in place at ``length`` and the self-attention runs over it by the
        einsum; the layer then returns ``(h, cache)``."""
        cfg = self.config
        dot = resolve_dot(self.dot_fn)
        b, s = h.shape[:2]
        nh, d = cfg.num_heads, cfg.dim_per_head
        x = rms_norm(h, lp["self_norm"], cfg.norm_eps)
        q = dot(x, lp["self_wq"]).reshape(b, s, nh, d)
        k = dot(x, lp["self_wk"]).reshape(b, s, nh, d)
        v = dot(x, lp["self_wv"]).reshape(b, s, nh, d)
        if cache is not None:
            cache["k"][:, length : length + s] = k.to(cache["k"].dtype)
            cache["v"][:, length : length + s] = v.to(cache["v"].dtype)
            attn = t5_attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), self_bias, self_mask)
        else:
            attn = self._attn(q, k, v, self_bias, self_mask, kv_masks[0], causal=True, use_hook=use_hook)
        h = h + dropout(dot(attn.reshape(b, s, nh * d), lp["self_wo"]), cfg.dropout_rate, generators[0])

        x = rms_norm(h, lp["cross_norm"], cfg.norm_eps)
        t = enc_out.shape[1]
        q = dot(x, lp["cross_wq"]).reshape(b, s, nh, d)
        ek = dot(enc_out, lp["cross_wk"]).reshape(b, t, nh, d)
        ev = dot(enc_out, lp["cross_wv"]).reshape(b, t, nh, d)
        cross = self._attn(q, ek, ev, None, enc_mask, kv_masks[1], causal=False, use_hook=use_hook)
        h = h + dropout(dot(cross.reshape(b, s, nh * d), lp["cross_wo"]), cfg.dropout_rate, generators[1])

        x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        mlp_out = dot(torch.relu(dot(x, lp["wi"])), lp["wo_ff"])
        h = h + dropout(mlp_out, cfg.dropout_rate, generators[2])
        return h if cache is None else (h, cache)

    def _run_stack(self, layer, h, stack: dict, keys, seeds, per_layer: int, extra=()):
        """``layer(h, lp, *extra, *seeds)`` over the stacked layers (each
        checkpointed under ``remat_layers``)."""
        per_key = {name: stack[name].unbind(0) for name in keys}
        for i in range(self.config.num_layers):
            args = (h, {name: per_key[name][i] for name in keys}, *extra,
                    *seeds[per_layer * i: per_layer * (i + 1)])
            h = self.remat_layers(layer, *args) if self.remat_layers else layer(*args)
        return h

    # -- forward -----------------------------------------------------------

    def encode(
        self,
        params: dict,
        input_ids: torch.Tensor,  # [B, S] integer ids
        attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real
        dropout_generator: Optional[torch.Generator] = None,
        use_hooks: bool = True,
    ) -> torch.Tensor:
        """Encoder hidden states ``[B, S, H]`` (final norm applied).
        ``dropout_generator`` turns on residual dropout: two seeds a layer
        are drawn from it before the loop, and each layer builds its
        branches' generators from them (a recomputed layer draws the same
        masks). ``use_hooks=False`` attends by the einsum whatever hook the
        model holds (the streamed executor's encoder pass)."""
        cfg = self.config
        s = input_ids.shape[1]
        h = params["shared_embed"][input_ids.long()]
        positions = torch.arange(s, device=h.device)
        bias = relative_bias(params["enc_rel_bias"], positions, positions, bidirectional=True,
                             num_buckets=cfg.rel_buckets, max_distance=cfg.rel_max_distance)
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        seeds = [None] * (2 * cfg.num_layers)
        if dropout_generator is not None and cfg.dropout_rate > 0.0:
            seeds = draw_seeds(dropout_generator, 2 * cfg.num_layers)

        def layer(h, lp, seed_attn, seed_mlp):
            generators = (seeded_generator(seed_attn, h.device), seeded_generator(seed_mlp, h.device))
            return self._enc_layer(h, lp, bias, mask, generators, kv_mask=attention_mask, use_hook=use_hooks)

        h = self._run_stack(layer, h, params["encoder"], ENCODER_KEYS, seeds, 2)
        return rms_norm(h, params["enc_final_norm"], cfg.norm_eps)

    def apply(
        self,
        params: dict,
        input_ids: torch.Tensor,  # [B, S_enc] integer encoder inputs
        decoder_input_ids: torch.Tensor,  # [B, S_dec] (shifted-right labels)
        attention_mask: Optional[torch.Tensor] = None,
        decoder_attention_mask: Optional[torch.Tensor] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Decoder logits ``[B, S_dec, V]`` fp32 (shadows ``nn.Module.apply``,
        as ``Llama.apply`` does). ``dropout_generator`` turns on residual
        dropout in both stacks: the encoder's seeds are drawn first, then
        three a decoder layer."""
        cfg = self.config
        use_dropout = dropout_generator is not None and cfg.dropout_rate > 0.0
        enc_out = self.encode(params, input_ids, attention_mask,
                              dropout_generator=dropout_generator if use_dropout else None)
        s = decoder_input_ids.shape[1]
        h = params["shared_embed"][decoder_input_ids.long()]
        positions = torch.arange(s, device=h.device)
        self_bias = relative_bias(params["dec_rel_bias"], positions, positions, bidirectional=False,
                                  num_buckets=cfg.rel_buckets, max_distance=cfg.rel_max_distance)
        self_mask = (positions[None, :] <= positions[:, None])[None, None]  # [1, 1, S, S]
        if decoder_attention_mask is not None:
            self_mask = self_mask & decoder_attention_mask[:, None, None, :].bool()
        enc_mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        seeds = [None] * (3 * cfg.num_layers)
        if use_dropout:
            seeds = draw_seeds(dropout_generator, 3 * cfg.num_layers)

        def layer(h, lp, enc_out, seed_self, seed_cross, seed_mlp):
            generators = tuple(seeded_generator(x, h.device) for x in (seed_self, seed_cross, seed_mlp))
            return self._dec_layer(h, lp, self_bias, self_mask, enc_out, enc_mask, generators,
                                   kv_masks=(decoder_attention_mask, attention_mask))

        h = self._run_stack(layer, h, params["layers"], DECODER_KEYS, seeds, 3, extra=(enc_out,))
        h = rms_norm(h, params["dec_final_norm"], cfg.norm_eps)
        return self._lm_logits(params, h)

    def _lm_logits(self, params, h):
        """The tied head with T5's ``d_model^-0.5`` rescale (the paper folds
        the attention's 1/sqrt(d) into the init; the head keeps this
        factor), rounded to h's dtype as the JAX package's scalar is."""
        h = h * round_to_dtype(self.config.hidden_size ** -0.5, h.dtype)
        return (h @ params["shared_embed"].T.to(h.dtype)).to(torch.float32)

    def shift_right(self, labels: torch.Tensor) -> torch.Tensor:
        """Teacher-forcing decoder inputs ``[start, l0, l1, ...]``: the labels
        feed the loss, their shift the decoder."""
        start = torch.full((labels.shape[0], 1), self.config.decoder_start_token_id,
                           dtype=labels.dtype, device=labels.device)
        return torch.cat([start, labels[:, :-1]], dim=1)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None, decoder_attention_mask=None):
        """Decoder logits ``[B, S_dec, V]`` fp32 with the module's own weights."""
        return self.apply(self.param_tree(), input_ids, decoder_input_ids, attention_mask,
                          decoder_attention_mask)

    # -- streaming protocol (big_modeling.Seq2SeqStreamedModel) ---------------
    # carry = (decoder h, self_bias, self_mask, enc_out, enc_mask). Weights
    # come from ``resident`` (the encoder stack is resident) and ``lp``.

    def _dec_bias(self, resident: dict, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return relative_bias(resident["dec_rel_bias"], q_pos, k_pos, bidirectional=False,
                             num_buckets=cfg.rel_buckets, max_distance=cfg.rel_max_distance)

    def stream_prefix(self, resident: dict, input_ids, decoder_input_ids, attention_mask=None,
                      decoder_attention_mask=None):
        """The encoder pass (no hooks) and the decoder's embeddings, bias and masks."""
        enc_out = self.encode(resident, input_ids, attention_mask, use_hooks=False)
        h = resident["shared_embed"][decoder_input_ids.long()]
        positions = torch.arange(decoder_input_ids.shape[1], device=h.device)
        self_bias = self._dec_bias(resident, positions, positions)
        self_mask = (positions[None, :] <= positions[:, None])[None, None]
        if decoder_attention_mask is not None:
            self_mask = self_mask & decoder_attention_mask[:, None, None, :].bool()
        enc_mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        return (h, self_bias, self_mask, enc_out, enc_mask)

    def stream_layer(self, carry, lp: dict):
        h, self_bias, self_mask, enc_out, enc_mask = carry
        h = self._dec_layer(h, lp, self_bias, self_mask, enc_out, enc_mask, use_hook=False)
        return (h, self_bias, self_mask, enc_out, enc_mask)

    def stream_suffix(self, resident: dict, carry) -> torch.Tensor:
        """fp32 logits ``[B, S_dec, V]``."""
        return self._lm_logits(resident, rms_norm(carry[0], resident["dec_final_norm"], self.config.norm_eps))

    def init_layer_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """One decoder layer's self-attention cache ``[batch, max_len, N, D]``."""
        cfg = self.config
        shape = (batch, max_len, cfg.num_heads, cfg.dim_per_head)
        device = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode_prefix(self, resident: dict, current, length: int, max_len: int, enc_out=None, enc_mask=None):
        """The decode carry of ``current`` decoder tokens at ``length``;
        ``enc_out``/``enc_mask`` come from the one encoder pass."""
        h = resident["shared_embed"][current.long()]
        q_pos = length + torch.arange(current.shape[1], device=h.device)
        k_pos = torch.arange(max_len, device=h.device)
        self_mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
        return (h, self._dec_bias(resident, q_pos, k_pos), self_mask, enc_out, enc_mask)

    def stream_layer_cached(self, carry, lp: dict, cache: dict, length: int):
        h, self_bias, self_mask, enc_out, enc_mask = carry
        h, nc = self._dec_layer(h, lp, self_bias, self_mask, enc_out, enc_mask,
                                cache={"k": cache["k"], "v": cache["v"]}, length=length)
        return (h, self_bias, self_mask, enc_out, enc_mask), nc

    def decode_suffix(self, resident: dict, carry) -> torch.Tensor:
        """fp32 logits of the last decoder position ``[B, V]``."""
        return self.stream_suffix(resident, carry)[:, -1]

    # -- not in the port yet -------------------------------------------------

    def enc_pipeline_layer(self, *args, **kwargs):
        raise NotImplementedError("T5's pipeline stages are not in the port yet (ROADMAP item 17)")

    pipeline_layer = enc_pipeline_layer

    # -- loss --------------------------------------------------------------

    @staticmethod
    def loss_fn(model: "T5", dropout_generator: Optional[torch.Generator] = None):
        """Seq2seq cross-entropy over ``{input_ids, labels, [attention_mask],
        [decoder_attention_mask], [decoder_input_ids]}``: log-softmax in
        fp32, the mean over the decoder mask's real positions, as the JAX
        package's ``T5.loss_fn``; the decoder inputs are the shifted labels
        unless given. ``dropout_generator`` (the port's addition) turns
        residual dropout on: each call draws its seeds from it."""

        def fn(params, batch):
            labels = batch["labels"]
            decoder_input_ids = batch.get("decoder_input_ids")
            if decoder_input_ids is None:
                decoder_input_ids = model.shift_right(labels)
            logits = model.apply(
                params, batch["input_ids"], decoder_input_ids, batch.get("attention_mask"),
                batch.get("decoder_attention_mask"), dropout_generator=dropout_generator,
            ).float()
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
            mask = batch.get("decoder_attention_mask")
            if mask is not None:
                w = mask.float()
                return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
            return nll.mean()

        return fn
