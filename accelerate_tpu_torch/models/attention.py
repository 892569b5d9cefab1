"""Attention primitives of the model zoo, in PyTorch.

Counterpart of ``accelerate_tpu/models/attention.py``: the same layouts
(``[B, S, N, D]`` activations), the same GQA convention (query head ``h``
reads kv head ``h // group``), masked logits at -1e30, softmax in fp32 and
probabilities cast to q's dtype before the PV product.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def round_to_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float. Multiplying a tensor of
    that dtype by it equals JAX's product with a scalar cast to the tensor's
    dtype (the product of two such values is exact in fp32 before rounding),
    and no scalar tensor has to reach the device."""
    return torch.tensor(x, dtype=dtype).item()


def resolve_dot(dot_fn):
    """The projection-matmul hook with its default: plain ``@`` when no
    override (``ops.quant_matmul.quant_dot``) is installed."""
    return dot_fn if dot_fn is not None else (lambda a, w: a @ w)


def dense_init(generator: torch.Generator, shape: tuple, fan_in: int, device) -> torch.Tensor:
    """Scaled-normal initializer shared by the model zoo (fp32)."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w / math.sqrt(fan_in)


def dropout_keep(shape, rate: float, generator: torch.Generator, device) -> torch.Tensor:
    """The keep mask of inverted dropout: ``uniform [0, 1) < 1 - rate`` drawn
    from ``generator`` (JAX's ``bernoulli(1 - rate)`` by the same rule)."""
    return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)


def dropout_with_mask(x: torch.Tensor, rate: float, keep: torch.Tensor) -> torch.Tensor:
    """Inverted dropout under a given keep mask: ``where(keep, x / (1 - rate), 0)``."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout; the identity when ``generator`` is None (eval) or
    ``rate <= 0``. The keep mask is drawn on ``x``'s device."""
    if generator is None or rate <= 0.0:
        return x
    return dropout_with_mask(x, rate, dropout_keep(x.shape, rate, generator, x.device))


def seeded_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A fresh generator on ``device`` seeded with ``seed`` (None for None).
    The models draw one seed per dropout site before their layer loop and
    build each site's generator inside the layer, so a recomputed layer
    (activation checkpointing) draws the same mask again."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def draw_seeds(generator: torch.Generator, n: int) -> list[int]:
    """``n`` seeds from ``generator``, on its device (a CUDA generator's
    draw waits for the card once)."""
    return torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()


def sequence_chunk(attention_fn, length: int):
    """This process's share of a sequence of ``length`` under the training
    hook ``attention_fn``: ``(start, stop, attention_fn, counts)``. A ring
    hook (``parallel/ring_attention.py``: it has a ``span``) gives this
    process's chunk, which the model runs with the hook, its loss terms
    counting here; when the ring size does not divide the length, the whole
    sequence through the exact einsum path (no hook), its terms counting on
    ring index 0 only (every process computes the same ones). Any other
    hook: the whole sequence, the hook, and True."""
    span = getattr(attention_fn, "span", None)
    if span is None:
        return 0, length, attention_fn, True
    chunk = span(length)
    if chunk is None:
        return 0, length, None, attention_fn.index == 0
    return chunk[0], chunk[1], attention_fn, True


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float = 10000.0, dtype=torch.float32):
    """RoPE cos/sin tables for ``positions`` [..., S] -> two [..., S, D/2] tensors."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE to [..., S, N, D] given [..., S, D/2] tables."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B,S,N,D] x [B,T,KV,D] -> [B,N,S,T] logits; query head h reads kv head h // group."""
    b, s, n, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if n != kv:
        qg = q.reshape(b, s, kv, n // kv, d)
        return torch.einsum("bskgd,btkd->bkgst", qg, k).reshape(b, n, s, t)
    return torch.einsum("bsnd,btnd->bnst", q, k)


def grouped_output(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B,N,S,T] probabilities x [B,T,KV,D] values -> [B,S,N,D]."""
    b, n, s, t = p.shape
    kv, d = v.shape[2], v.shape[3]
    if n != kv:
        pg = p.reshape(b, kv, n // kv, s, t)
        return torch.einsum("bkgst,btkd->bskgd", pg, v).reshape(b, s, n, d)
    return torch.einsum("bnst,btnd->bsnd", p, v)


def dot_product_attention(
    q: torch.Tensor,  # [B, S, N, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, N, S, T], True = attend
    causal: bool = False,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,  # [1|B, N, S, T] additive (T5 rel bias)
) -> torch.Tensor:
    """Grouped-query attention; softmax in fp32. ``bias`` is added to the
    fp32 logits before the causal limit and the mask."""
    s, d = q.shape[1], q.shape[3]
    t = k.shape[1]
    if scale is None:
        # the JAX package rounds sqrt(d) to q's dtype before inverting
        scale = 1.0 / round_to_dtype(math.sqrt(d), q.dtype)
    logits = grouped_scores(q * round_to_dtype(scale, q.dtype), k).to(torch.float32)
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    if causal:
        causal_mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril(t - s)
        logits = torch.where(causal_mask, logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return grouped_output(probs, v)
