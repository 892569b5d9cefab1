"""Tensor and expert parallelism on ``torch.distributed``: the Megatron
collectives the JAX package leaves to GSPMD.

In the JAX package the ``tensor`` and ``expert`` mesh axes are partition
rules only (the models' ``partition_rules``, ``models/moe.py``'s expert
constraint), and GSPMD inserts every collective. The port writes them by
hand, as Megatron-LM does (arXiv 1909.08053):

- a column-parallel product (weight split on its output dim) takes the
  replicated input through :func:`copy_to` (identity forward, all-reduce of
  the gradient backward), a row-parallel one (weight split on its input
  dim) returns its partial sums through :func:`reduce_from` (all-reduce
  forward, identity backward). Attention runs on this process's heads;
- the vocab-parallel embedding is a masked lookup of this process's rows,
  then an all-reduce; the vocab-parallel loss (:func:`vocab_parallel_nll`)
  all-reduces the max and the sum of exps of the split logits, so it equals
  the log-softmax over the whole vocab;
- the expert exchange (:class:`ExpertParallel`) sends each expert's slots
  to the process holding it by ``all_to_all_single`` and brings the
  outputs back the same way.

Every process of a tensor group holds the same activations between the
products, so a leaf the group replicates (a norm, the router, a bias of a
row-parallel product) gets the same gradient on every process: the
``copy_to`` of each column-parallel input already summed its share. The
only replicated leaves whose uses are partial are the key and value
columns GQA shares when a model has fewer kv heads than the group has
processes: each process reads the columns of the kv head its query heads
read, through :func:`copy_to` on the weight itself, so their gradient is
summed over the group inside the backward.

A model decides by the shapes of the params it is given: a weight whole on
this process (one process, or ``unwrap_model``'s gathered params) runs the
plain product, a split one the collectives. Under ``mixed_precision="fp8"``
the products go through ``ops.fp8``'s group-aware product, whose abs-max
scales and cast cotangents are those of the whole tensors.

Every collective runs on the tensors themselves, on any backend: on a gloo
group CUDA tensors go through gloo's CUDA all-reduce, all-gather and
``all_to_all_single``, as the ZeRO update's do.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..utils.constants import MESH_AXIS_EXPERT, MESH_AXIS_TENSOR


class AxisGroup:
    """This process's group over one mesh axis: its size, its index on the
    axis (its rank in the group: members rank by process index, and the
    axis is the only coordinate they differ on) and the group."""

    def __init__(self, group, size: int, rank: int, axis: str):
        self.group = group
        self.size = size
        self.rank = rank
        self.axis = axis

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.axis}: {self.rank} of {self.size})"


class Replicas:
    """The processes that hold the same activations: those that differ only
    on the live tensor and expert axes, and the first of them (by process
    index), whose draws the others take (``broadcast``)."""

    def __init__(self, group, root: int):
        self.group = group
        self.root = root

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        dist.broadcast(x, src=self.root, group=self.group)
        return x


class TensorParallel(AxisGroup):
    """The ``tensor`` group."""


class ExpertParallel(AxisGroup):
    """The ``expert`` group."""


def model_parallel_groups(state) -> tuple[Optional[TensorParallel], Optional[ExpertParallel]]:
    """The tensor and expert groups of ``PartialState`` (None for an axis of
    size 1), each with the ``replicas`` over both. A collective: every
    process calls it at the same point."""
    from ..state import rank_coords

    sizes, coords = state.mesh_shape, state.mesh_coords
    tensor = expert = None
    if sizes[MESH_AXIS_TENSOR] > 1:
        tensor = TensorParallel(state.group((MESH_AXIS_TENSOR,)), sizes[MESH_AXIS_TENSOR],
                                coords[MESH_AXIS_TENSOR], MESH_AXIS_TENSOR)
    if sizes[MESH_AXIS_EXPERT] > 1:
        expert = ExpertParallel(state.group((MESH_AXIS_EXPERT,)), sizes[MESH_AXIS_EXPERT],
                                coords[MESH_AXIS_EXPERT], MESH_AXIS_EXPERT)
    axes = tuple(a for a in (MESH_AXIS_EXPERT, MESH_AXIS_TENSOR) if sizes[a] > 1)
    if axes:
        root = next(r for r in range(state.num_processes)
                    if all(c == coords[a] or a in axes for a, c in rank_coords(r, sizes).items()))
        replicas = Replicas(state.group(axes), root)
        for group in (tensor, expert):
            if group is not None:
                group.replicas = replicas
    return tensor, expert


def replicas_of(*groups) -> Optional[Replicas]:
    """The replicas of the first live group of ``groups`` (None: none)."""
    return next((g.replicas for g in groups if g is not None), None)


# -- the autograd functions ------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    """The last dim's slices of every process, concatenated in group order;
    backward, this process's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, axis: AxisGroup):
        ctx.axis = axis
        ctx.width = x.shape[-1]
        front = x.movedim(-1, 0).contiguous()
        out = torch.empty((axis.size * front.shape[0], *front.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, front, group=axis.group)
        return out.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        start = ctx.axis.rank * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


class _Exchange(torch.autograd.Function):
    """``x`` ``[n * a, ...]``: chunk ``i`` of its leading dim sent to group
    rank ``i``; the output's chunk ``i`` came from rank ``i``. Its own
    transpose, so the backward exchanges the gradient the same way."""

    @staticmethod
    def forward(ctx, x, axis: ExpertParallel):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.axis), None


def _exchange(x: torch.Tensor, axis: ExpertParallel) -> torch.Tensor:
    send = x.contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=axis.group)
    return out


def copy_to(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    """``x`` as the input of this process's share of a split computation:
    its gradient is summed over the group."""
    return x if axis is None else _CopyTo.apply(x, axis.group)


def reduce_from(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    """The sum of every process's partial ``x`` (a row-parallel product)."""
    return x if axis is None else _ReduceFrom.apply(x, axis.group)


def gather_last(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    """Every process's slice of the last dim, whole (split logits)."""
    return x if axis is None else _GatherLast.apply(x, axis)


def exchange(x: torch.Tensor, axis: ExpertParallel) -> torch.Tensor:
    """The expert exchange: chunk ``i`` of ``x``'s leading dim to rank ``i``."""
    return _Exchange.apply(x, axis)


# -- the products ---------------------------------------------------------------------


def column_products(x: torch.Tensor, dot: Callable, tp: Optional[TensorParallel]) -> Callable:
    """``proj(w, cols=None)``: the product of the replicated ``x`` with a
    column-parallel weight slice (``tp`` None: the plain product). One
    :func:`copy_to` serves every product of ``x`` (q, k and v), except under
    fp8, whose product sums its input's cotangent before the e4m3 cast.
    ``cols``: ``w`` is whole on every process and this process reads those
    columns of it (GQA's shared kv heads), so its gradient is summed over
    the group too (under fp8 the product is of the whole ``w``, whose scale
    is the whole weight's)."""
    from ..ops.fp8 import is_fp8_dot

    if tp is None:
        return lambda w, cols=None: dot(x, w)
    if is_fp8_dot(dot):
        def proj(w, cols=None):
            if cols is None:
                return dot.tensor_parallel(x, w, tp.group, False, True, True, False)
            return dot.tensor_parallel(x, w, tp.group, False, False, True, True)[..., cols]

        return proj
    xt = copy_to(x, tp)
    return lambda w, cols=None: dot(xt, w) if cols is None else dot(xt, copy_to(w, tp)[..., cols])


def row_product(x: torch.Tensor, w: torch.Tensor, dot: Callable, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The product of this process's slice of ``x``'s last dim with its
    rows of a row-parallel weight, summed over the group."""
    from ..ops.fp8 import is_fp8_dot

    if tp is None:
        return dot(x, w)
    if is_fp8_dot(dot):
        return reduce_from(dot.tensor_parallel(x, w, tp.group, True, True, False, False), tp)
    return reduce_from(dot(x, w), tp)


def split_or_none(axis: Optional[AxisGroup], local: int, whole: int) -> Optional[AxisGroup]:
    """``axis`` when a dim of ``whole`` is held as a slice of ``local``
    (the params were split over it), else None: whole params run plain."""
    if axis is None or local == whole:
        return None
    if local * axis.size != whole:
        raise ValueError(f"a dim of {whole} held as {local} does not split over {axis}")
    return axis


def kv_columns(tp: TensorParallel, num_heads: int, kv_heads: int, head_dim: int) -> slice:
    """The key/value columns this process reads when the group has more
    processes than kv heads: those of the one kv head its query heads read."""
    if tp.size % kv_heads or num_heads % tp.size:
        raise ValueError(
            f"{num_heads} heads with {kv_heads} kv heads do not split over a tensor group of {tp.size}"
        )
    head = (tp.rank * (num_heads // tp.size)) // (num_heads // kv_heads)
    return slice(head * head_dim, (head + 1) * head_dim)


# -- the vocab-parallel embedding and loss ---------------------------------------------


def vocab_embedding(table: torch.Tensor, ids: torch.Tensor, tp: Optional[TensorParallel],
                    vocab: int) -> torch.Tensor:
    """Rows of the embedding ``table`` for ``ids``: whole, a lookup; this
    process's rows of a vocab-parallel table, a masked lookup summed over
    the group."""
    tp = split_or_none(tp, table.shape[0], vocab)
    if tp is None:
        return table[ids.long()]
    rows = table.shape[0]
    local = ids.long() - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    h = table[torch.where(inside, local, 0)]
    return reduce_from(torch.where(inside[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device)), tp)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, tp: Optional[TensorParallel],
                       vocab: int) -> torch.Tensor:
    """``-log_softmax(logits)[target]`` in fp32 for each position: whole
    logits (of ``vocab``), the plain log-softmax; this process's slice of
    the vocab, :func:`split_vocab_nll`."""
    logits = logits.float()
    tp = split_or_none(tp, logits.shape[-1], vocab)
    if tp is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return split_vocab_nll(logits, targets, tp)


def split_vocab_nll(logits: torch.Tensor, targets: torch.Tensor, tp: AxisGroup) -> torch.Tensor:
    """The vocab-parallel ``-log_softmax[target]``: ``logits`` is this
    process's slice (rank ``r`` holds ids ``[r*w, (r+1)*w)``); the max and
    the sum of exps are all-reduced over the group, and the target's logit
    comes from the process that holds it. Padded positions and targets
    outside every slice stay finite (their weight is the caller's)."""
    logits = logits.float()
    width = logits.shape[-1]
    peak = logits.detach().amax(dim=-1).contiguous()  # only shifts the log-sum-exp: no gradient
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=tp.group)
    total = reduce_from(torch.exp(logits - peak[..., None]).sum(dim=-1), tp)
    local = targets.long() - tp.rank * width
    inside = (local >= 0) & (local < width)
    picked = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    target = reduce_from(torch.where(inside, picked, torch.zeros((), device=logits.device)), tp)
    return torch.log(total) + peak - target
