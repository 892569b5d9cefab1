"""BERT-family encoder for sequence classification as a PyTorch ``nn.Module``.

Counterpart of ``accelerate_tpu/models/bert.py`` (the nlp_example's model,
bert-base on MRPC). The parameters keep the JAX package's key paths and
layouts: ``embeddings.*``, the layer weights stacked on a leading layer axis
under ``layers.*`` with ``[in, out]`` matrices, ``pooler.*`` and
``classifier.*``, so weights cross between the packages with no transposes
(``utils/params.load_jax_params``). Attention is bidirectional
(``causal_attention = False``): ``Accelerator.prepare_model`` wires the
non-causal flash dispatch, which runs the kernels from
``flash_attention_min_seq`` tokens under the padding mask. The MLP's gelu is
the tanh approximation (``jax.nn.gelu``'s default). The streaming protocol
(``stream_prefix``, ``stream_layer``, ``stream_suffix``) serves the
big-model executor; the pipeline hook (ROADMAP item 17) is not in the port
yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.runtime import resolve_device
from ..utils.constants import MESH_AXIS_PIPELINE, MESH_AXIS_TENSOR
from .attention import (
    dense_init,
    dot_product_attention,
    draw_seeds,
    dropout,
    resolve_dot,
    seeded_generator,
    sequence_chunk,
)
from .config import TransformerConfig, get_config


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def bert_shapes(cfg: TransformerConfig) -> dict:
    """Every weight's shape, by group and key, in the JAX package's order."""
    h, i, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    return {
        "embeddings": {
            "word": (v, h), "position": (cfg.max_seq_len, h), "token_type": (cfg.type_vocab_size, h),
            "norm_scale": (h,), "norm_bias": (h,),
        },
        "layers": {
            "wq": (L, h, h), "bq": (L, h), "wk": (L, h, h), "bk": (L, h),
            "wv": (L, h, h), "bv": (L, h), "wo": (L, h, h), "bo": (L, h),
            "attn_norm_scale": (L, h), "attn_norm_bias": (L, h),
            "w_up": (L, h, i), "b_up": (L, i), "w_down": (L, i, h), "b_down": (L, h),
            "mlp_norm_scale": (L, h), "mlp_norm_bias": (L, h),
        },
        "pooler": {"w": (h, h), "b": (h,)},
        "classifier": {"w": (h, cfg.num_labels), "b": (cfg.num_labels,)},
    }


class _Group(nn.Module):
    """One group of the param tree: a parameter per key."""

    def __init__(self, shapes: dict, device, dtype):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)
            )


class Bert(nn.Module):
    """An encoder with a classification head. ``seed`` draws the initial
    weights from a ``torch.Generator`` on the model's device (parity tests
    load the JAX package's weights instead)."""

    # bidirectional attention: prepare_model builds the non-causal dispatch
    causal_attention = False
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
        if cfg.arch != "bert":
            raise ValueError(f"Bert needs a bert config, got arch {cfg.arch!r}")
        self.config = cfg
        # hooks set by Accelerator.prepare_model (see models/llama.py)
        self.dot_fn = None
        self.attention_fn = None
        self.remat_layers = False
        device = resolve_device(device)
        for group, shapes in bert_shapes(cfg).items():
            setattr(self, group, _Group(shapes, device, dtype))
        self.init(seed)

    @property
    def device(self) -> torch.device:
        return self.embeddings.word.device

    @torch.no_grad()
    def init(self, seed: int) -> "Bert":
        """Draw every weight from ``seed`` (fp32 draws, cast to the model's
        dtype) in the JAX package's order: the three embeddings, q, k, v, o,
        up, down, pooler, classifier; norms at 1, biases at 0."""
        if self.device.type == "meta":  # shapes only (init_empty_weights): nothing to draw
            return self
        cfg = self.config
        h, i, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        emb, lay = self.embeddings, self.layers
        for name, rows in (("word", v), ("position", cfg.max_seq_len), ("token_type", cfg.type_vocab_size)):
            getattr(emb, name).copy_(torch.randn((rows, h), generator=gen, device=dev) * 0.02)
        for name in ("wq", "wk", "wv", "wo"):
            getattr(lay, name).copy_(dense_init(gen, (L, h, h), h, dev))
        lay.w_up.copy_(dense_init(gen, (L, h, i), h, dev))
        lay.w_down.copy_(dense_init(gen, (L, i, h), i, dev))
        self.pooler.w.copy_(dense_init(gen, (h, h), h, dev))
        self.classifier.w.copy_(dense_init(gen, (h, cfg.num_labels), h, dev))
        for group in (emb, lay, self.pooler, self.classifier):
            for name, p in group.named_parameters():
                if name.endswith("scale"):
                    p.fill_(1.0)
                elif name.startswith("b") or name.endswith("bias"):
                    p.zero_()
        return self

    def param_tree(self) -> dict:
        """The weights as the JAX package's nested param dict (no copies)."""
        return {group: {name: getattr(getattr(self, group), name) for name in shapes}
                for group, shapes in bert_shapes(self.config).items()}

    def partition_rules(self) -> list[tuple[str, tuple]]:
        """The JAX package's layout rules (every named axis has size 1 in the
        port, which runs the data and fsdp axes)."""
        t, p = MESH_AXIS_TENSOR, MESH_AXIS_PIPELINE
        return [
            (r"embeddings/word", (t, None)),
            (r"layers/(wq|wk|wv|w_up)", (p, None, t)),
            (r"layers/(bq|bk|bv|b_up)", (p, t)),
            (r"layers/(wo|w_down)", (p, t, None)),
            (r"layers/.*(norm|bo|b_down)", (p, None)),
            (r"(norm|bias|bo|b_down)", (None,)),
            (r"pooler/w", (None, t)),
            (r"classifier", (None,)),
        ]

    def apply(
        self,
        params: dict,
        input_ids: torch.Tensor,  # [B, S] integer ids
        attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Classification logits ``[B, num_labels]`` in the params' dtype
        (shadows ``nn.Module.apply``, as ``Llama.apply`` does).

        ``dropout_generator`` turns on ``config.dropout_rate`` dropout on the
        embeddings and on each residual branch: one seed for the embeddings
        and one per layer and branch are drawn from it before the loop (the
        JAX package splits its key, then ``L * 2`` keys), and each layer
        builds its generators from its seeds, so a checkpointed layer draws
        the same masks when it is recomputed.

        Under a ring hook (a sequence axis; ``sequence_chunk``) the batch
        holds the global rows and this process runs its chunk (learned
        positions at the chunk's offset) through the non-causal ring. The
        pooler reads position 0, which the chunk at offset 0 holds: the
        logits are that process's, and zeros elsewhere (still a function
        of the chunk, so every process's backward runs its ring's hops)."""
        cfg = self.config
        s = input_ids.shape[1]
        if s > cfg.max_seq_len:
            # learned positions: an index past the table would fail later and
            # less clearly (JAX's take would clamp it)
            raise ValueError(f"sequence length {s} exceeds max_seq_len {cfg.max_seq_len}")
        start, stop, attention_fn, counts = sequence_chunk(self.attention_fn, s)
        emb = params["embeddings"]
        if position_ids is None:
            position_ids = torch.arange(start, stop, device=input_ids.device)[None, :]
        else:
            position_ids = position_ids[..., start:stop]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        input_ids, token_type_ids = input_ids[:, start:stop], token_type_ids[:, start:stop]
        h = emb["word"][input_ids.long()] + emb["position"][position_ids.long()] + emb["token_type"][
            token_type_ids.long()]
        h = layer_norm(h, emb["norm_scale"], emb["norm_bias"], cfg.norm_eps)
        seeds = [None] * (1 + 2 * cfg.num_layers)
        if dropout_generator is not None and cfg.dropout_rate > 0.0:
            seeds = draw_seeds(dropout_generator, 1 + 2 * cfg.num_layers)
            h = dropout(h, cfg.dropout_rate, seeded_generator(seeds[0], h.device))
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
            attention_mask = attention_mask[:, start:stop]

        def layer(h, lp, seed_attn, seed_mlp):
            generators = (seeded_generator(seed_attn, h.device), seeded_generator(seed_mlp, h.device))
            return self._block(h, lp, mask, generators, kv_mask=attention_mask, attention_fn=attention_fn)

        per_key = {name: w.unbind(0) for name, w in params["layers"].items()}
        for i in range(cfg.num_layers):
            args = (h, {name: w[i] for name, w in per_key.items()}, seeds[1 + 2 * i], seeds[2 + 2 * i])
            h = self.remat_layers(layer, *args) if self.remat_layers else layer(*args)
        pooled = torch.tanh(h[:, 0] @ params["pooler"]["w"] + params["pooler"]["b"])
        logits = pooled @ params["classifier"]["w"] + params["classifier"]["b"]
        return logits if start == 0 and counts else logits * 0.0

    def _block(self, h, lp: dict, mask, generators=(None, None), kv_mask=None, attention_fn=None) -> torch.Tensor:
        """One encoder layer (post-norm): attention, dropout, residual,
        layernorm; gelu MLP, dropout, residual, layernorm."""
        cfg = self.config
        dot = resolve_dot(self.dot_fn)
        b, s, _ = h.shape
        nh = cfg.num_heads
        d = cfg.hidden_size // nh
        q = (dot(h, lp["wq"]) + lp["bq"]).reshape(b, s, nh, d)
        k = (dot(h, lp["wk"]) + lp["bk"]).reshape(b, s, nh, d)
        v = (dot(h, lp["wv"]) + lp["bv"]).reshape(b, s, nh, d)
        if attention_fn is not None:
            attn = attention_fn(q, k, v, kv_mask)
        else:
            attn = dot_product_attention(q, k, v, mask=mask)
        attn_out = dot(attn.reshape(b, s, nh * d), lp["wo"]) + lp["bo"]
        attn_out = dropout(attn_out, cfg.dropout_rate, generators[0])
        h = layer_norm(h + attn_out, lp["attn_norm_scale"], lp["attn_norm_bias"], cfg.norm_eps)
        up = F.gelu(dot(h, lp["w_up"]) + lp["b_up"], approximate="tanh")
        mlp_out = dropout(dot(up, lp["w_down"]) + lp["b_down"], cfg.dropout_rate, generators[1])
        return layer_norm(h + mlp_out, lp["mlp_norm_scale"], lp["mlp_norm_bias"], cfg.norm_eps)

    # -- streaming protocol (big_modeling.StreamedModel) ----------------------
    # Weights come from ``resident`` and ``lp`` only. No attention hook runs:
    # a ring hook left on the model (a sequence axis) would attend over a
    # chunk and drop the padding mask the carry holds.

    def stream_prefix(self, resident: dict, input_ids: torch.Tensor, attention_mask=None, token_type_ids=None):
        """Embeddings (layer-normed) and the padding mask: ``(h, mask)``."""
        cfg = self.config
        s = input_ids.shape[1]
        if s > cfg.max_seq_len:
            raise ValueError(f"sequence length {s} exceeds max_seq_len {cfg.max_seq_len}")
        emb = resident["embeddings"]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(s, device=input_ids.device)[None, :]
        h = emb["word"][input_ids.long()] + emb["position"][positions] + emb["token_type"][token_type_ids.long()]
        h = layer_norm(h, emb["norm_scale"], emb["norm_bias"], cfg.norm_eps)
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        return (h, mask)

    def stream_layer(self, carry, lp: dict):
        h, mask = carry
        return (self._block(h, lp, mask), mask)

    def stream_suffix(self, resident: dict, carry) -> torch.Tensor:
        """Classification logits ``[B, num_labels]`` in the weights' dtype."""
        pooled = torch.tanh(carry[0][:, 0] @ resident["pooler"]["w"] + resident["pooler"]["b"])
        return pooled @ resident["classifier"]["w"] + resident["classifier"]["b"]

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Logits ``[B, num_labels]`` in the model's dtype."""
        return self.apply(self.param_tree(), input_ids, attention_mask, token_type_ids)

    @staticmethod
    def loss_fn(model: "Bert", dropout_generator: Optional[torch.Generator] = None):
        """Softmax cross-entropy over a batch ``{input_ids, [attention_mask],
        [token_type_ids], labels}``, log-softmax in fp32, as the JAX
        package's ``Bert.loss_fn``. ``dropout_generator`` (the port's
        addition) turns dropout on: each call draws its seeds from it.
        Under a sequence axis the loss counts on the process that holds
        position 0 (``apply``) and is zero elsewhere."""

        def fn(params, batch):
            logits = model.apply(
                params, batch["input_ids"], batch.get("attention_mask"), batch.get("token_type_ids"),
                dropout_generator=dropout_generator,
            ).float()
            logp = torch.log_softmax(logits, dim=-1)
            loss = -torch.gather(logp, -1, batch["labels"].long()[:, None]).mean()
            start, _, _, counts = sequence_chunk(model.attention_fn, batch["input_ids"].shape[1])
            return loss if start == 0 and counts else loss * 0.0

        return fn
