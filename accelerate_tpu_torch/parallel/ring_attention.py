"""Ring attention: exact attention over sequence-sharded activations.

Counterpart of ``accelerate_tpu/parallel/ring_attention.py`` on
``torch.distributed``. Each process of the mesh's ``sequence`` group holds
one chunk of the sequence (``sequence_span``); nothing is ever gathered:

- K/V, stacked, and the key-validity mask rotate around the group by
  point-to-point sends, n - 1 hops for n processes, each posted before the
  block's compute and waited on after it. GQA K/V rotate unexpanded (kv
  heads, not query heads).
- Each block is ``ops.flash_attention.flash_attention_block`` (the flash
  kernels' ring variant on the card, their plain versions on the CPU) at
  the global offsets of its q and kv chunks, so a block that lies wholly in
  the future makes no trip. Its normalized ``(out, lse)`` merge online in
  fp32 from ``NEG_INF``: the result is exact, not blockwise-approximate.
- The gradient needs no ring written by hand: a hop is an autograd function
  whose backward sends the gradient the other way round (the transpose of
  JAX's ``ppermute``), and the merge differentiates through the block's
  ``(out, lse)``. Every process posts the same hops in the same order,
  forward and backward (a recomputed layer re-runs its hops too).

On a gloo group a hop of CUDA tensors is staged through host tensors by
explicit copies (gloo moves host memory); NCCL, or gloo on CPU tensors,
sends the tensors themselves: ``parallel/compat.py``, which the pipeline's
hops share.

Memory per process: the chunk's activations and O(S/n · S/n) score blocks,
so the sequence a model trains on grows with the ring.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.flash_attention import flash_attention_block
from ..utils.constants import MESH_AXIS_SEQUENCE
from .compat import Hop

NEG_INF = -1e30


def sequence_span(length: int, index: int, size: int) -> Optional[tuple[int, int]]:
    """``(start, stop)`` of chunk ``index`` of ``size`` of a sequence of
    ``length``; None when ``size`` does not divide it (the exact fallback
    then runs the whole sequence)."""
    if length % size or length < size:
        return None
    chunk = length // size
    return index * chunk, (index + 1) * chunk


class _Rotate(torch.autograd.Function):
    """``x`` sent to the next process of the ring and ``x`` of the previous
    one received, with ``extra`` tensors (no gradient) in the same batch.
    The forward only posts: the hop goes into ``pending``, and the caller
    reads the output only after the hop's ``wait``, once the block's
    compute is launched. The backward sends the gradient to the previous
    process and takes the next one's."""

    @staticmethod
    def forward(ctx, x, ring, extra, pending):
        ctx.ring = ring
        out = torch.empty_like(x)
        pending.append(Hop([x, *extra], ring.next, ring.prev, ring.group, into=out))
        return out

    @staticmethod
    def backward(ctx, grad):
        (received,) = Hop([grad.contiguous()], ctx.ring.prev, ctx.ring.next, ctx.ring.group).wait()
        return received, None, None, None


class Ring:
    """The processes of one ``sequence`` group: this process's index on the
    axis, the group's size, the neighbours' global ranks and the group."""

    def __init__(self, mesh, axis_name: str = MESH_AXIS_SEQUENCE):
        self.group = mesh.get_group(axis_name)
        self.size = mesh.size(mesh.mesh_dim_names.index(axis_name))
        self.index = mesh.get_local_rank(axis_name)
        self.next = dist.get_global_rank(self.group, (self.index + 1) % self.size)
        self.prev = dist.get_global_rank(self.group, (self.index - 1) % self.size)

    def rotate(self, x: torch.Tensor, extra: list) -> tuple[torch.Tensor, Hop]:
        """Post the hop of ``x`` (differentiable) and ``extra``: ``(x', hop)``;
        ``x'`` holds the received tensor once ``hop.wait()`` (which returns
        ``[x', *extra']``) has returned."""
        pending: list = []
        out = _Rotate.apply(x, self, extra, pending)
        return out, pending[0]


def merge_block(o, m, l, o_blk, lse_blk):
    """One block's normalized ``(o_blk, lse_blk)`` merged into the running
    fp32 ``(o, m, l)`` (``[B, S, N, D]``, ``[B, S, N]`` twice): the block
    counts as numerator ``o_blk``, max ``lse_blk`` and sum 1."""
    m_new = torch.maximum(m, lse_blk)
    corr_old = torch.exp(m - m_new)
    corr_blk = torch.exp(lse_blk - m_new)
    o = o * corr_old[..., None] + o_blk.to(torch.float32) * corr_blk[..., None]
    return o, m_new, l * corr_old + corr_blk


def merge_start(q: torch.Tensor):
    """The merge's empty ``(o, m, l)`` for queries ``q`` ``[B, S, N, D]``."""
    b, s, nh, d = q.shape
    return (torch.zeros((b, s, nh, d), dtype=torch.float32, device=q.device),
            torch.full((b, s, nh), NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros((b, s, nh), dtype=torch.float32, device=q.device))


def merge_end(o, l, dtype: torch.dtype) -> torch.Tensor:
    return (o / torch.clamp(l[..., None], min=1e-30)).to(dtype)


def _ring_attention_local(q, k, v, kv_valid, ring: Ring, causal: bool):
    """The body each process runs on its chunk: ``q`` ``[B, S/n, N, D]``,
    ``k``/``v`` ``[B, S/n, KV, D]``, ``kv_valid`` ``[B, S/n]`` or None."""
    n, idx = ring.size, ring.index
    s_local = q.shape[1]
    q_offset = idx * s_local
    o, m, l = merge_start(q)
    kv = torch.stack((k, v))  # one hop for both
    valid = kv_valid
    for r in range(n):
        hop = None
        if r < n - 1:  # posted before the block's compute, waited on after it
            kv_next, hop = ring.rotate(kv, [] if valid is None else [valid])
        src = (idx - r) % n  # whose K/V this process holds now
        o_blk, lse_blk = flash_attention_block(
            q, kv[0], kv[1], valid, causal=causal, q_offset=q_offset, kv_offset=src * s_local,
        )
        o, m, l = merge_block(o, m, l, o_blk, lse_blk)
        if hop is not None:
            _, *extra = hop.wait()
            kv, valid = kv_next, (extra[0] if extra else None)
    return merge_end(o, l, q.dtype)


def make_ring_attention(mesh, axis_name: str = MESH_AXIS_SEQUENCE, causal: bool = True):
    """A drop-in attention hook for sequence-sharded ``[B, S/n, N, D]``
    chunks over the mesh's ``axis_name`` group (``mesh`` the
    ``DeviceMesh`` of ``PartialState``): ``attn(q, k, v, kv_mask=None)``,
    ``kv_mask`` this chunk's ``[B, S/n]`` key validity, returns this
    process's chunk of the output. ``attn.span(length)`` is this process's
    chunk of a sequence, or None when the ring size does not divide it:
    the models then run the whole sequence through the exact einsum path
    (the JAX ring's fallback), counting its terms on index 0 only.
    Every process of the group calls it on its chunk at once."""
    ring = Ring(mesh, axis_name)

    def attn(q, k, v, kv_mask=None):
        kv_valid = None if kv_mask is None else kv_mask.to(torch.bool)
        return _ring_attention_local(q, k, v, kv_valid, ring, causal)

    attn.ring = ring
    attn.index = ring.index
    attn.span = lambda length: sequence_span(length, ring.index, ring.size)
    return attn


def make_local_ring_attention(axis_name: str = MESH_AXIS_SEQUENCE, causal: bool = True):
    """The ring for code inside a pipeline stage (``parallel/pipeline.py``):
    the ring over this process's ``axis_name`` group of ``PartialState``'s
    mesh, whose members share the process's pipeline stage, so they run the
    same schedule and post the same hops in the same order. The JAX package
    needs a second entry here because its schedule is a manual region of one
    program; in the port each stage is a process and the group is the
    mesh's, so this is :func:`make_ring_attention` on that mesh."""
    from ..state import PartialState

    state = PartialState() if PartialState._shared_state.get("_ready") else None
    if state is None or state.mesh is None or state.mesh_shape[axis_name] <= 1:
        raise ValueError(f"make_local_ring_attention needs a {axis_name!r} axis above 1 on PartialState's mesh")
    return make_ring_attention(state.mesh, axis_name, causal)
