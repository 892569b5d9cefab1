"""GPT-2-family causal LM as a PyTorch ``nn.Module``.

Counterpart of ``accelerate_tpu/models/gpt2.py``: learned absolute position
embeddings (no rotary), LayerNorm with bias, a tanh-gelu MLP, biases on
every projection and the output head tied to the token embedding. The
parameters keep the JAX package's key paths and layouts: ``embed_tokens``
``[V, H]``, ``embed_positions`` ``[max_seq_len, H]``, the layer weights
stacked on a leading layer axis under ``layers.*`` (the fused ``wqkv``
``[H, 3H]`` splits into q, k and v in that order along its last axis) and
``final_norm_scale``/``final_norm_bias``, so weights cross between the
packages with no transposes (``utils/params.load_jax_params``).

A learned position past the table is an error here, never a clamp: the
sequence length is checked on the host before any lookup (a CUDA index past
the table would end the process), and the serving engine caps its slots at
``max_seq_len`` (``learned_positions``). The model implements the decode
protocol itself (``init_cache``, ``forward_with_cache``,
``forward_window_with_cache``), built from ``decode_prefix``,
``stream_layer_cached`` and ``decode_suffix`` as the JAX package's is, and
the streaming protocol of the big-model executor (``stream_prefix``,
``stream_layer``, ``stream_suffix``, ``init_layer_cache``). Under a
pipeline axis ``pipeline_fn`` (``parallel/pipeline.py``) runs the blocks
through the ``pipeline_layer`` hook, the tied ``wte`` read by the
embedding on every stage and by the head on every stage.
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
    replicas_of,
    row_product,
    split_or_none,
    vocab_embedding,
)
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
from .bert import _Group, layer_norm
from .config import TransformerConfig, get_config
from .llama import install_params, next_token_loss

LAYER_KEYS = (
    "attn_norm_scale", "attn_norm_bias", "wqkv", "bqkv", "wo", "bo",
    "mlp_norm_scale", "mlp_norm_bias", "w_up", "b_up", "w_down", "b_down",
)


def gpt2_layer_shapes(cfg: TransformerConfig) -> dict:
    """The stacked ``[L, ...]`` shape of every layer weight."""
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    return {
        "attn_norm_scale": (L, h), "attn_norm_bias": (L, h),
        "wqkv": (L, h, 3 * h), "bqkv": (L, 3 * h), "wo": (L, h, h), "bo": (L, h),
        "mlp_norm_scale": (L, h), "mlp_norm_bias": (L, h),
        "w_up": (L, h, i), "b_up": (L, i), "w_down": (L, i, h), "b_down": (L, h),
    }


class GPT2(nn.Module):
    """A GPT-2-style causal LM. ``seed`` draws the initial weights from a
    ``torch.Generator`` on the model's device (parity tests load the JAX
    package's weights instead)."""

    # under a ring hook (a sequence axis) apply runs this process's chunk
    sequence_chunks = True
    # positions index a table of max_seq_len rows: the engine caps max_len there
    learned_positions = True

    def __init__(
        self,
        config: TransformerConfig | str,
        device=None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        cfg = get_config(config) if isinstance(config, str) else config
        if cfg.arch != "gpt2":
            raise ValueError(f"GPT2 needs a gpt2 config, got arch {cfg.arch!r}")
        self.config = cfg
        # hooks set by Accelerator.prepare_model and quantized serving (see models/llama.py)
        self.dot_fn = None
        self.attention_fn = None
        # the tensor group (parallel/tensor_parallel.py), set by Accelerator.prepare_model
        self.tensor_parallel = None
        self.remat_layers = False
        # the blocks' pipeline schedule, set by Accelerator.prepare_model under a pipeline axis
        self.pipeline_fn = None
        device = resolve_device(device)
        h = cfg.hidden_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)

        self.embed_tokens = param(cfg.vocab_size, h)
        self.embed_positions = param(cfg.max_seq_len, h)
        self.layers = _Group(gpt2_layer_shapes(cfg), device, dtype)
        self.final_norm_scale = param(h)
        self.final_norm_bias = param(h)
        self.init(seed)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @torch.no_grad()
    def init(self, seed: int) -> "GPT2":
        """Draw every weight from ``seed`` (fp32 draws, cast to the model's
        dtype) in the JAX package's order: tokens (std 0.02), positions
        (std 0.01), qkv, o, up, down; norms at 1, biases at 0."""
        if self.device.type == "meta":  # shapes only (init_empty_weights): nothing to draw
            return self
        cfg = self.config
        h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        lay = self.layers
        self.embed_tokens.copy_(torch.randn((cfg.vocab_size, h), generator=gen, device=dev) * 0.02)
        self.embed_positions.copy_(torch.randn((cfg.max_seq_len, h), generator=gen, device=dev) * 0.01)
        lay.wqkv.copy_(dense_init(gen, (L, h, 3 * h), h, dev))
        lay.wo.copy_(dense_init(gen, (L, h, h), h, dev))
        lay.w_up.copy_(dense_init(gen, (L, h, i), h, dev))
        lay.w_down.copy_(dense_init(gen, (L, i, h), i, dev))
        for name in LAYER_KEYS:
            if "norm_scale" in name:
                getattr(lay, name).fill_(1.0)
            elif name.startswith("b") or name.endswith("bias"):
                getattr(lay, name).zero_()
        self.final_norm_scale.fill_(1.0)
        self.final_norm_bias.zero_()
        return self

    def layer_params(self, index: int) -> dict:
        """Views of layer ``index``'s weights, keyed as in the JAX layer dict
        (a packed layer matrix gives its per-layer ``QuantizedWeight`` view)."""
        return {name: getattr(self.layers, name)[index] for name in LAYER_KEYS}

    def _shapes(self) -> dict:
        cfg = self.config
        h = cfg.hidden_size
        shapes = {
            "embed_tokens": (cfg.vocab_size, h), "embed_positions": (cfg.max_seq_len, h),
            "final_norm_scale": (h,), "final_norm_bias": (h,),
        }
        shapes.update({f"layers.{k}": s for k, s in gpt2_layer_shapes(cfg).items()})
        return shapes

    def param_tree(self) -> dict:
        """The weights as the JAX package's nested param dict (no copies)."""
        tree: dict = {"layers": {name: getattr(self.layers, name) for name in LAYER_KEYS}}
        for name in ("embed_tokens", "embed_positions", "final_norm_scale", "final_norm_bias"):
            tree[name] = getattr(self, name)
        return tree

    def install(self, tree: dict) -> "GPT2":
        """Bind the leaves of ``tree`` (the JAX layout) as the weights, a
        packed layer matrix staying packed (``llama.install_params``)."""
        return install_params(self, tree, self._shapes())

    def partition_rules(self) -> list[tuple[str, tuple]]:
        """The JAX package's layout rules (Megatron-style: the fused qkv and
        the MLP's up projection by columns, the output projections by rows;
        :meth:`tensor_rules` go before them)."""
        t, p = MESH_AXIS_TENSOR, MESH_AXIS_PIPELINE
        return [
            (r"embed_tokens", (t, None)),
            (r"embed_positions", (None, None)),
            (r"layers/wqkv", (p, None, t)),
            (r"layers/bqkv", (p, t)),
            (r"layers/wo", (p, t, None)),
            (r"layers/w_up", (p, None, t)),
            (r"layers/b_up", (p, t)),
            (r"layers/w_down", (p, t, None)),
            (r"layers/(attn_norm|mlp_norm|bo|b_down)", (p, None)),
            (r"final_norm", (None,)),
        ]

    def tensor_rules(self, tensor: int) -> list[tuple[str, tuple]]:
        """Rules that go before :meth:`partition_rules` under a tensor group
        of ``tensor``: the JAX rule splits the fused ``wqkv``'s and
        ``bqkv``'s ``3H`` columns into contiguous chunks (GSPMD may), where
        a process running its own heads needs their q, k and v columns:
        three blocks of the dim (``parallel/sharding.py``'s ``(3, axis)``)."""
        if tensor <= 1:
            return []
        t, p = MESH_AXIS_TENSOR, MESH_AXIS_PIPELINE
        return [(r"layers/wqkv", (p, None, (3, t))), (r"layers/bqkv", (p, (3, t)))]

    def head(self) -> torch.Tensor:
        return self.embed_tokens.T

    # -- one transformer block (shared by apply and the decode protocol) ----

    def _block(self, h, lp: dict, mask, generators=(None, None), cache=None, kv_mask=None,
               attention_fn=None):
        """One pre-norm block. Returns ``h``, or ``(h, new_cache)`` with a
        ``cache``, whose paths are llama's (``llama.decoder_layer``): the
        ``attend`` hook reads the serving engine's pool and the new K/V
        return as the delta; without one K/V are written into the dense
        cache at its int ``length`` in place and attention runs over the
        cache under ``mask``. Without a cache ``attention_fn(q, k, v,
        kv_mask)`` attends when set (the training hook), else the causal
        einsum path under ``mask``. Where ``lp`` holds this process's slices
        over the tensor axis (its heads' q, k and v columns, its share of the
        MLP's hidden dim) the products are column- and row-parallel."""
        cfg = self.config
        dot = resolve_dot(self.dot_fn)
        b, s, hidden = h.shape
        nh = cfg.num_heads
        d = hidden // nh
        tp = split_or_none(self.tensor_parallel, lp["wqkv"].shape[-1], 3 * hidden)
        x = layer_norm(h, lp["attn_norm_scale"], lp["attn_norm_bias"], cfg.norm_eps)
        qkv = column_products(x, dot, tp)(lp["wqkv"]) + lp["bqkv"]
        width = qkv.shape[-1] // 3
        q, k, v = (t.reshape(b, s, width // d, d) for t in qkv.split(width, dim=-1))
        new_cache = None
        if cache is not None and "attend" in cache:
            # the fused projection's split leaves strided views; the paged
            # kernels take contiguous operands
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
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
            attn = dot_product_attention(q, k, v, mask=mask, causal=True)
        attn_out = row_product(attn.reshape(b, s, width), lp["wo"], dot, tp) + lp["bo"]
        h = h + dropout(attn_out, cfg.dropout_rate, generators[0])
        x = layer_norm(h, lp["mlp_norm_scale"], lp["mlp_norm_bias"], cfg.norm_eps)
        tp = split_or_none(self.tensor_parallel, lp["w_up"].shape[-1], cfg.intermediate_size)
        up = F.gelu(column_products(x, dot, tp)(lp["w_up"]) + lp["b_up"], approximate="tanh")
        h = h + dropout(row_product(up, lp["w_down"], dot, tp) + lp["b_down"], cfg.dropout_rate, generators[1])
        return h if cache is None else (h, new_cache)

    def _check_positions(self, stop: int) -> None:
        if stop > self.config.max_seq_len:
            # learned positions: the table has max_seq_len rows, and a CUDA
            # index past it would end the process (JAX's take would clamp)
            raise ValueError(f"sequence length {stop} exceeds max_seq_len {self.config.max_seq_len}")

    # -- forward --------------------------------------------------------------

    def apply(
        self,
        params: dict,  # the JAX layout: param_tree(), or a cast copy of it
        input_ids: torch.Tensor,  # [B, S] integer ids
        attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real
        positions: Optional[torch.Tensor] = None,
        dropout_generator: Optional[torch.Generator] = None,
        gather_logits: bool = True,
    ) -> torch.Tensor:
        """Logits ``[B, S, V]`` in fp32 (the tied head runs in the params'
        dtype, then casts, as the JAX package's ``apply``), with the weights
        taken from ``params`` (shadows ``nn.Module.apply``, as
        ``Llama.apply`` does). ``positions`` given must lie in the table.

        ``dropout_generator`` turns on ``config.dropout_rate`` residual
        dropout: one seed per layer and branch is drawn from it before the
        loop (the JAX package splits ``L * 2`` keys), so a checkpointed
        layer draws the same masks when it is recomputed.

        Under a ring hook (a sequence axis; ``sequence_chunk``) the batch
        holds the global rows and this process runs its chunk from the
        embeddings on, learned positions at the chunk's offset: the logits
        are the chunk's ``[B, S/n, V]``. Under the tensor axis the embedding
        and the tied head are vocab-parallel where the vocab divides (not
        gpt2's 50257), the logits gathered unless ``gather_logits`` is False."""
        cfg = self.config
        s = input_ids.shape[1]
        self._check_positions(s)
        start, stop, attention_fn, _ = sequence_chunk(self.attention_fn, s)
        if positions is None:
            positions = torch.arange(start, stop, device=input_ids.device)[None, :]
        else:
            positions = (positions[None, :] if positions.dim() == 1 else positions)[..., start:stop]
            if positions.numel() and int(positions.max()) >= cfg.max_seq_len:
                raise ValueError(f"a position exceeds max_seq_len {cfg.max_seq_len}")
        h = (vocab_embedding(params["embed_tokens"], input_ids[:, start:stop], self.tensor_parallel, cfg.vocab_size)
             + params["embed_positions"][positions.long()])
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
            attention_mask = attention_mask[:, start:stop]
        dropping = dropout_generator is not None and cfg.dropout_rate > 0.0
        layers = params["layers"]
        if self.pipeline_fn is not None:
            seed = draw_seeds(dropout_generator, 1, self.pipeline_fn.replicas)[0] if dropping else None
            h, _ = self.pipeline_fn(layers, h, mask, attention_mask, dropout_rng=seed, attention_fn=attention_fn)
        else:
            seeds = [None] * (2 * cfg.num_layers)
            if dropping:
                seeds = draw_seeds(dropout_generator, 2 * cfg.num_layers, replicas_of(self.tensor_parallel))

            def layer(h, lp, seed_attn, seed_mlp):
                generators = (seeded_generator(seed_attn, h.device), seeded_generator(seed_mlp, h.device))
                return self._block(h, lp, mask, generators, kv_mask=attention_mask, attention_fn=attention_fn)

            per_key = {
                name: layers[name].unbind(0) if isinstance(layers[name], torch.Tensor)
                else [layers[name][i] for i in range(cfg.num_layers)]
                for name in LAYER_KEYS
            }
            for i in range(cfg.num_layers):
                args = (h, {name: w[i] for name, w in per_key.items()}, seeds[2 * i], seeds[2 * i + 1])
                h = self.remat_layers(layer, *args) if self.remat_layers else layer(*args)
        h = layer_norm(h, params["final_norm_scale"], params["final_norm_bias"], cfg.norm_eps)
        head = params["embed_tokens"].T.to(h.dtype)
        vocab_tp = split_or_none(self.tensor_parallel, head.shape[-1], cfg.vocab_size)
        logits = column_products(h, torch.matmul, vocab_tp)(head).float()
        return gather_last(logits, vocab_tp) if gather_logits else logits

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """fp32 logits ``[B, S, V]`` from the model's own weights."""
        return self.apply(self.param_tree(), input_ids, attention_mask, positions)

    @staticmethod
    def loss_fn(model: "GPT2", dropout_generator: Optional[torch.Generator] = None):
        """Next-token cross-entropy over ``{input_ids, [attention_mask]}``,
        masked, as the JAX package's ``GPT2.loss_fn`` (``llama.next_token_loss``:
        under a sequence axis each process takes its chunk's terms).
        ``dropout_generator`` (the port's addition) turns residual dropout on."""

        def fn(params, batch):
            input_ids = batch["input_ids"]
            attention_mask = batch.get("attention_mask")
            logits = model.apply(params, input_ids, attention_mask, dropout_generator=dropout_generator,
                                 gather_logits=False)
            loss, counts = next_token_loss(logits, input_ids, attention_mask, model.attention_fn,
                                           model.tensor_parallel, model.config.vocab_size)
            return loss if counts else loss * 0.0

        return fn

    # -- KV-cache decode protocol (models/generation.py) ----------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """Dense cache ``[L, batch, max_len, N, D]`` (the serving pools pass
        pages as the batch and the page size as ``max_len``). Raises past
        ``max_seq_len``: those positions have no embedding."""
        cfg = self.config
        if max_len > cfg.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens = {max_len} exceeds max_seq_len {cfg.max_seq_len} "
                "(learned positions)"
            )
        device = resolve_device(device)
        nh = cfg.num_heads
        shape = (cfg.num_layers, batch, max_len, nh, cfg.hidden_size // nh)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0,
        }

    def decode_prefix(self, resident: dict, input_ids: torch.Tensor, length, max_len: Optional[int] = None,
                      clamp: bool = False):
        """Embeddings at the cache's positions, and the causal-over-cache
        mask over ``max_len`` keys (None without ``max_len``: the paged
        ``attend`` hook masks inside) -> the decode carry ``(h, mask)``.

        ``length`` is an int shared by the batch (checked on the host), or a
        per-row ``[B]`` tensor from the serving engine, which bounds its
        lengths below ``max_seq_len`` itself; ``clamp`` holds a speculative
        window's positions in the table (the rows past it are never
        emitted, as in the JAX package, whose take clamps them)."""
        cfg = self.config
        s = input_ids.shape[1]
        steps = torch.arange(s, device=input_ids.device)
        if isinstance(length, torch.Tensor):
            positions = length.to(input_ids.device, torch.long)[:, None] + steps  # [B, S]
            if clamp:
                positions = torch.clamp(positions, max=cfg.max_seq_len - 1)
        else:
            self._check_positions(length + s)
            positions = (length + steps)[None, :]
        h = resident["embed_tokens"][input_ids.long()] + resident["embed_positions"][positions]
        mask = None
        if max_len is not None:
            key_pos = torch.arange(max_len, device=h.device)
            mask = (key_pos[None, :] <= positions[0][:, None])[None, None]  # [1, 1, S, T]
        return h, mask

    def stream_layer_cached(self, carry, lp: dict, cache: dict, length):
        """One layer of the decode against its cache: ``(carry, new_cache)``."""
        h, mask = carry
        h, nc = self._block(h, lp, mask, cache={**cache, "length": length})
        return (h, mask), nc

    def decode_suffix(self, resident: dict, carry, last: bool = True) -> torch.Tensor:
        """fp32 logits of the last position ``[B, V]`` (every position with
        ``last=False``) from the decode carry."""
        h, _ = carry
        h = layer_norm(h, resident["final_norm_scale"], resident["final_norm_bias"], self.config.norm_eps)
        if last:
            h = h[:, -1]
        return (h @ resident["embed_tokens"].T.to(h.dtype)).float()

    def _run_cached(self, input_ids: torch.Tensor, cache: dict, last: bool, clamp: bool = False):
        length = cache["length"]
        extra = {key: cache[key] for key in ("table", "attend") if key in cache}
        resident = {name: getattr(self, name)
                    for name in ("embed_tokens", "embed_positions", "final_norm_scale", "final_norm_bias")}
        carry = self.decode_prefix(resident, input_ids, length,
                                   max_len=None if extra else cache["k"].shape[2], clamp=clamp)
        new_k, new_v = [], []
        for i in range(self.config.num_layers):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i], **extra}
            carry, nc = self.stream_layer_cached(carry, self.layer_params(i), layer_cache, length)
            if extra:
                new_k.append(nc["k"])
                new_v.append(nc["v"])
        logits = self.decode_suffix(resident, carry, last=last)
        s = input_ids.shape[1]
        if extra:
            return logits, {"k": torch.stack(new_k), "v": torch.stack(new_v), "length": length + s}
        return logits, {"k": cache["k"], "v": cache["v"], "length": length + s}

    def forward_with_cache(self, input_ids: torch.Tensor, cache: dict):
        """``(fp32 last-position logits [B, V], updated cache)``: the decode
        protocol ``generate()`` and the serving engine drive, with the cache
        forms of ``generation.forward_with_cache`` (dense, int ``length``;
        or the engine's ``attend`` hook with per-row lengths, returning the
        new K/V ``[L, B, S, N, D]`` for the engine to scatter)."""
        return self._run_cached(input_ids, cache, last=True)

    def forward_window_with_cache(self, input_ids: torch.Tensor, cache: dict):
        """Speculative-verify window forward: all-position fp32 logits
        ``[B, S, V]``. The ``attend`` protocol only (the in-window causal
        mask lives in the hook)."""
        if "attend" not in cache:
            raise ValueError(
                "forward_window_with_cache requires the paged 'attend' protocol "
                "(the in-window causal mask lives in the attend hook)"
            )
        return self._run_cached(input_ids, cache, last=False, clamp=True)

    # -- streaming protocol (big_modeling.StreamedModel) ----------------------
    # Weights come from ``resident`` and ``lp`` only, and no attention hook
    # runs (see ``Llama.stream_prefix``).

    def init_layer_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """One layer's dense cache ``{"k", "v"}`` ``[batch, max_len, N, D]``
        for the streamed decode. Raises past ``max_seq_len``."""
        cfg = self.config
        if max_len > cfg.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens = {max_len} exceeds max_seq_len {cfg.max_seq_len} "
                "(learned positions)"
            )
        device = resolve_device(device)
        shape = (batch, max_len, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def stream_prefix(self, resident: dict, input_ids: torch.Tensor, attention_mask=None):
        """Token and position embeddings and the padding mask: ``(h, mask)``."""
        s = input_ids.shape[1]
        self._check_positions(s)
        positions = torch.arange(s, device=input_ids.device)[None, :]
        h = resident["embed_tokens"][input_ids.long()] + resident["embed_positions"][positions]
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        return (h, mask)

    def stream_layer(self, carry, lp: dict):
        h, mask = carry
        return (self._block(h, lp, mask), mask)

    def stream_suffix(self, resident: dict, carry) -> torch.Tensor:
        """fp32 logits ``[B, S, V]``."""
        return self.decode_suffix(resident, carry, last=False)

    # -- pipeline hook (parallel/pipeline.make_pipeline_layers_fn) -------------

    # the sequence dims of the activations and side inputs (mask, kv_mask)
    pipeline_seq_dims = {"h": 1, "consts": (3, 1)}
    # both side inputs carry the batch in dim 0
    pipeline_const_kinds = ("mb", "mb")

    def pipeline_layer(self, lp, h, seed, mask, kv_mask, attention_fn=OWN_HOOK):
        """``layer_fn`` contract: ``(lp, h, seed, *consts) -> (h, aux)``,
        the folded dropout seed split into the two branches'."""
        generators = (None, None)
        if seed is not None:
            generators = tuple(seeded_generator(x, h.device) for x in split_seed(seed, 2))
        h = self._block(h, lp, mask, generators, kv_mask=kv_mask,
                        attention_fn=self.attention_fn if attention_fn is OWN_HOOK else attention_fn)
        return h, 0.0
