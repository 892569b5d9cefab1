"""Autoregressive generation with a dense KV cache.

Counterpart of ``accelerate_tpu/models/generation.py``. The cache is
preallocated at ``max_len`` and written in place at ``length``; ``generate``
is the oracle for the serving engine, whose contract is token identity with
sequential ``generate()`` at temperature 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.runtime import resolve_device, same_device
from .attention import rotary_embedding
from .config import TransformerConfig
from .llama import Llama, decoder_layer, rms_norm


def init_cache(
    config: TransformerConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> dict:
    """Preallocated KV cache: stacked ``[L, B, T, KV, D]``."""
    device = resolve_device(device)
    shape = (config.num_layers, batch, max_len, config.kv_heads, config.dim_per_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": 0,
    }


def _run_layers(model: Llama, input_ids: torch.Tensor, cache: dict):
    """Embed ``input_ids`` ``[B, S]`` at the cache's positions and run every
    layer against the cache; returns the final-normed hidden states
    ``[B, S, H]`` and the updated cache (see :func:`forward_with_cache`)."""
    cfg = model.config
    s = input_ids.shape[1]
    length = cache["length"]
    h = model.embed_tokens[input_ids.long()]
    steps = torch.arange(s, device=h.device)[None, :]
    if isinstance(length, torch.Tensor):
        positions = length.to(h.device, torch.long)[:, None] + steps  # [B, S]
    else:
        positions = length + steps  # [1, S]
    cos, sin = rotary_embedding(positions, cfg.dim_per_head, cfg.rope_theta, dtype=h.dtype)

    extra = {key: cache[key] for key in ("table", "attend") if key in cache}
    if extra:
        mask = None
    else:
        t = cache["k"].shape[2]
        key_pos = torch.arange(t, device=h.device)
        mask = (key_pos[None, :] <= positions[0][:, None])[None, None]  # [1, 1, S, T]

    new_k, new_v = [], []
    for i in range(cfg.num_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i], "length": length, **extra}
        h, nc = decoder_layer(
            cfg, h, model.layer_params(i), cos, sin, mask, cache=layer_cache, dot_fn=model.dot_fn
        )
        if extra:
            new_k.append(nc["k"])
            new_v.append(nc["v"])
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    if extra:
        new_cache = {"k": torch.stack(new_k), "v": torch.stack(new_v), "length": length + s}
    else:
        new_cache = {"k": cache["k"], "v": cache["v"], "length": length + s}
    return h, new_cache


def forward_with_cache(model: Llama, input_ids: torch.Tensor, cache: dict):
    """Run ``input_ids`` ``[B, S]`` against the cache.

    Returns (fp32 logits for the LAST position ``[B, V]``, updated cache).

    Two cache forms:
    - dense: ``k``/``v`` ``[L, B, T, KV, D]`` and an int ``length`` shared by
      the batch; the new K/V are written in place and attention is masked
      to positions ``<=`` each query's;
    - paged (the serving engine's decode): ``k``/``v`` are the page pools
      ``[L, P, ps, KV, D]``, ``length`` is a per-row ``[B]`` int32 tensor,
      ``table`` the page tables and ``attend`` the hook that reads the pool.
      The returned cache's ``k``/``v`` are then the new token's K/V,
      ``[L, B, S, KV, D]``, for the engine to scatter into the pool.
    """
    h, new_cache = _run_layers(model, input_ids, cache)
    logits = h[:, -1] @ model.head().to(h.dtype)
    return logits.to(torch.float32), new_cache


def forward_window_with_cache(model: Llama, input_ids: torch.Tensor, cache: dict):
    """Speculative-verify window forward: :func:`forward_with_cache` with
    fp32 logits for EVERY position, ``[B, S, V]``. The engine scores a whole
    ``k+1``-token candidate window per slot in one step and needs the
    greedy token after each window position.

    Paged ``attend`` protocol only: the causal mask inside the window lives
    in the hook (``ops.paged_attention.paged_verify_attention``), so a cache
    without one cannot be scored correctly and raises."""
    if "attend" not in cache:
        raise ValueError(
            "forward_window_with_cache requires the paged 'attend' protocol "
            "(the in-window causal mask lives in the attend hook)"
        )
    h, new_cache = _run_layers(model, input_ids, cache)
    logits = h @ model.head().to(h.dtype)  # all positions, not just the last
    return logits.to(torch.float32), new_cache


def resolve_decode_protocol(model):
    """``(init_cache, forward_with_cache)`` for a causal model: the pair the
    serving engine and ``generate()`` drive every model through, so a model
    family added later implements the protocol once for both. A model that
    implements the protocol itself (GPT2) supplies its own methods; the
    llama family's lives in this module."""
    if hasattr(model, "forward_with_cache"):
        return model.init_cache, model.forward_with_cache
    return (
        lambda batch, max_len, dtype=torch.bfloat16, device=None: init_cache(
            model.config, batch, max_len, dtype=dtype, device=device
        ),
        lambda ids, c: forward_with_cache(model, ids, c),
    )


def resolve_window_protocol(model):
    """The window-forward half of the decode protocol, ``forward_window(ids,
    cache) -> (all-position logits [B, S, V], cache)``: the speculative
    verify drives a model only through it. A model that implements it
    (GPT2) supplies its method; the llama family's lives in this module."""
    if hasattr(model, "forward_window_with_cache"):
        return model.forward_window_with_cache
    return lambda ids, c: forward_window_with_cache(model, ids, c)


def make_sampler(temperature: float):
    """Greedy (temperature <= 0) or categorical sampler over last-position
    logits ``[B, V]`` -> int32 ids. ``generator`` is the ``torch.Generator``
    the categorical draw uses; greedy ignores it."""
    greedy = temperature <= 0.0

    def sample(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    return sample


@torch.inference_mode()
def generate(
    model,
    input_ids,  # [B, S] prompt
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    rng: Optional[torch.Generator] = None,
    eos_token_id: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Greedy (temperature 0) or sampled generation with any model of the
    decode protocol (llama, gpt2). Returns ``[B, S + new]``
    int32 ids. Once a row emits ``eos_token_id`` every later position is EOS.
    ``rng`` is the generator of a sampled run (seed 0 on the model's device
    when None)."""
    device = resolve_device(device)
    if not same_device(device, model.device):
        raise ValueError(f"model is on {model.device}, generate was asked to run on {device}")
    prompt = np.asarray(input_ids, np.int32)
    ids = torch.as_tensor(prompt, device=device)
    b, s = ids.shape
    cache_init, fwc = resolve_decode_protocol(model)
    cache = cache_init(b, s + max_new_tokens, dtype=model.dtype, device=device)
    sample = make_sampler(temperature)
    if rng is None and temperature > 0.0:
        rng = torch.Generator(device=device).manual_seed(0)

    logits, cache = fwc(ids, cache)
    token = sample(logits, rng)
    done = token == eos_token_id if eos_token_id is not None else None
    tokens = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = fwc(token[:, None], cache)
        nxt = sample(logits, rng)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        tokens.append(nxt)
        token = nxt
    out = torch.stack(tokens, dim=1).cpu().numpy()
    return np.concatenate([prompt, out], axis=1)
