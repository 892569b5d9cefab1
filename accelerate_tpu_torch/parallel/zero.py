"""The weight update across processes: reduce-scatter, sharded adamw, all-gather.

Counterpart of ``accelerate_tpu/parallel/zero.py`` on ``torch.distributed``.
The update is elementwise, so it decomposes exactly (ZeRO, arXiv
2004.13336): reduce-scatter the gradients over the data-parallel axes,
update each process's shard of the params with its shard of the optimizer
state (the fused adamw kernel once per shard leaf), and all-gather the
params where the next forward needs them.

A :class:`ShardedLayout` holds two specs per leaf (``parallel/sharding.py``):
where the params are stored (``param_specs``) and where their update runs
(``update_specs``: the reduced gradient and the optimizer state). Every
configuration of the mesh's data and fsdp axes is one of:

- the ZeRO layout (the JAX package's default on a data-parallel mesh, and
  FSDP stage 3): params stored in the folded 1/N layout, updated in place;
- FSDP stages 1 and 2: params whole on every process, update sharded over
  ``fsdp``: each process updates a copy of its shard, then the params are
  gathered back;
- the replicated update (``zero_stage=0``, FSDP stage 3 with
  ``cpu_offload`` over a data axis): nothing folded over ``data``, so the
  gradient's reduction there is an all-reduce.

The step keeps the reference's order: gather the stored shards; the loss
with the 1/N batch-shard factor applied in the loss's own dtype; unscale,
then reduce-scatter; the sharded norm and the clip; the update.

Layouts: a spec may split a leaf along any dim (``fsdp_auto_spec`` takes
the largest: dim 1 of a stacked ``[L, 768, 768]`` layer weight), while
``reduce_scatter_tensor`` and ``all_gather_into_tensor`` split dim 0. So
every stored shard (params, gradients, moments) is its own contiguous
tensor in the JAX package's layout (a sharded checkpoint's chunks are these
tensors), and the collectives move the split dim to the front and back. A
group ranks its members by process index (data outermost), while a spec
over ``("fsdp", "data")`` numbers its chunks fsdp-major: the chunks are
permuted into group order around the collective.

Bit-exactness: the 1/N factor and the loss scale are powers of two, so they
commute exactly through the backward and the sums; at two processes a
reduce-scatter and an all-reduce add the same two terms (``a + b == b +
a``), so the sharded update equals the replicated one bit for bit. At more
processes the two collectives may add in different orders.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..state import rank_coords
from ..utils.constants import (
    CANONICAL_MESH_AXES,
    MESH_AXIS_EXPERT,
    MESH_AXIS_PIPELINE,
    MESH_AXIS_SEQUENCE,
    MESH_AXIS_TENSOR,
)
from ..utils.params import tree_leaves, tree_map, tree_unflatten
from .sharding import Spec, shardings_like, sharded_dims, zero_batch_axes

_MODEL_AXES = (MESH_AXIS_TENSOR, MESH_AXIS_SEQUENCE, MESH_AXIS_PIPELINE, MESH_AXIS_EXPERT)


def zero_ineligible_reason(sizes: dict, fsdp_plugin=None) -> Optional[str]:
    """Why the ZeRO sharded update cannot replace the replicated one on this
    configuration (None: it can): it needs a data or fsdp axis above 1, no
    model-parallel axis, and no FSDP plugin at stage 1/2 or with
    ``cpu_offload`` (those keep the params whole, or the state on the host,
    by explicit contract)."""
    if not zero_batch_axes(sizes):
        return "no nontrivial data/fsdp mesh axis to shard the update over"
    model = [a for a in _MODEL_AXES if sizes.get(a, 1) > 1]
    if model:
        return f"model-parallel axes {model} are nontrivial"
    if fsdp_plugin is not None and fsdp_plugin.stage < 3:
        return f"FullyShardedDataParallelPlugin(stage={fsdp_plugin.stage}) keeps parameters replicated by explicit contract"
    if fsdp_plugin is not None and fsdp_plugin.cpu_offload:
        return "cpu_offload keeps optimizer state in host RAM, which the ZeRO storage layout does not fold"
    return None


def tx_couples_across_leaves(tx, params_tree: dict) -> bool:
    """Whether a transform reads across gradient leaves or elements (a
    global-norm clip inside it, a trust ratio), which the sharded update
    would compute over each process's shard. Two updates on a tiny
    surrogate tree of the params' structure, one with a single element of
    the last leaf bumped: coupling shows as a change the bump cannot reach
    elementwise (the first leaf, or the last leaf's other element)."""
    leaves = tree_leaves(params_tree)
    if not leaves:
        return False
    tiny = tree_unflatten(params_tree, [torch.ones(2) for _ in leaves])
    base = tree_unflatten(params_tree, [torch.full((2,), 0.5) for _ in leaves])
    bumped_leaves = [torch.full((2,), 0.5) for _ in leaves]
    bumped_leaves[-1] = torch.tensor([0.5, 64.0])
    bumped = tree_unflatten(params_tree, bumped_leaves)
    # advance the state a step first: some transforms normalise the very
    # first update into a shape-independent form
    _, state = tx.update(base, tx.init(tiny), tiny)
    flat_a = tree_leaves(tx.update(base, state, tiny)[0])
    flat_b = tree_leaves(tx.update(bumped, state, tiny)[0])
    if not torch.equal(flat_a[-1][0], flat_b[-1][0]):
        return True
    return len(leaves) > 1 and not torch.equal(flat_a[0], flat_b[0])


def zero_update_state_bytes(n_params: int, grad_dtype_bytes: float, replicas: int) -> tuple[int, int]:
    """(optimizer-state bytes, gradient bytes) a process holds for an
    adam-family update sharded over ``replicas`` processes: two fp32 moments
    and the fp32 master params, and the reduced gradient, 1/N of each."""
    replicas = max(int(replicas), 1)
    opt_full = n_params * 4 * 3
    grad_full = int(n_params * grad_dtype_bytes)
    return -(-opt_full // replicas), -(-grad_full // replicas)


# -- the collectives over a spec ------------------------------------------------


def _chunk(coords: dict, sizes: dict, axes: tuple[str, ...]) -> int:
    """The chunk a process holds of a dim split over ``axes`` (first axis major)."""
    index = 0
    for axis in axes:
        index = index * sizes[axis] + coords[axis]
    return index


class _Mesh:
    """This process's place on the mesh and its groups, from ``PartialState``."""

    def __init__(self, state):
        self.state = state
        self.sizes = dict(state.mesh_shape)
        self.coords = state.mesh_coords
        self._orders: dict = {}

    def count(self, axes: tuple[str, ...]) -> int:
        return int(np.prod([self.sizes[a] for a in axes]))

    def chunk(self, axes: tuple[str, ...]) -> int:
        return _chunk(self.coords, self.sizes, axes)

    def order(self, axes: tuple[str, ...]) -> Optional[torch.Tensor]:
        """The chunk each member of the group over ``axes`` holds, by group
        rank; None when that is the identity."""
        if axes not in self._orders:
            mine = self.coords
            members = [
                c for c in (rank_coords(r, self.sizes) for r in range(self.state.num_processes))
                if all(c[a] == mine[a] for a in CANONICAL_MESH_AXES if a not in axes)
            ]
            order = [_chunk(c, self.sizes, axes) for c in members]
            self._orders[axes] = None if order == sorted(order) else torch.tensor(order)
        return self._orders[axes]


def shard_of(x: torch.Tensor, spec: Spec, mesh: _Mesh) -> torch.Tensor:
    """This process's shard of a whole tensor, as a contiguous tensor of its
    own (never a view of ``x``)."""
    x = x.detach()
    for dim, axes in sharded_dims(spec, mesh.sizes):
        size = x.shape[dim] // mesh.count(axes)
        x = x.narrow(dim, mesh.chunk(axes) * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def gather_full(x: torch.Tensor, spec: Spec, mesh: _Mesh) -> torch.Tensor:
    """The whole tensor from every process's shard: one all-gather per
    split dim (the inverse of :func:`shard_of`)."""
    for dim, axes in sharded_dims(spec, mesh.sizes):
        n = mesh.count(axes)
        front = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * front.shape[0], *front.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, front, group=mesh.state.group(axes))
        order = mesh.order(axes)
        if order is not None:  # group rank g holds chunk order[g]
            chunks = out.view(n, *front.shape)
            placed = torch.empty_like(chunks)
            placed[order.to(out.device)] = chunks
            out = placed.view(out.shape)
        x = out.movedim(0, dim)
    return x.contiguous()


def _reduce_scatter(g: torch.Tensor, dim: int, axes: tuple[str, ...], mesh: _Mesh) -> torch.Tensor:
    n = mesh.count(axes)
    front = g.movedim(dim, 0)
    order = mesh.order(axes)
    if order is not None:  # chunk order[g] goes to group rank g
        front = front.reshape(n, front.shape[0] // n, *front.shape[1:])[order.to(g.device)]
        front = front.reshape(-1, *front.shape[2:])
    front = front.contiguous()
    out = torch.empty((front.shape[0] // n, *front.shape[1:]), dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, front, group=mesh.state.group(axes))
    return out.movedim(0, dim).contiguous()


def make_grad_reducer(specs: list[Spec], batch_axes: tuple[str, ...], mesh: _Mesh) -> Callable:
    """``reduce(grad leaves) -> shard leaves``: each leaf reduce-scattered
    into its spec's layout (summing over the batch axes the spec splits it
    over), then all-reduced over the batch axes it does not. The gradients
    carry the 1/N batch prescale, so the sums are the global mean."""

    def reduce(grads: list) -> list:
        out = []
        for g, spec in zip(grads, specs):
            consumed: list[str] = []
            for dim, axes in sharded_dims(spec, mesh.sizes):
                if any(a in batch_axes for a in axes):
                    g = _reduce_scatter(g, dim, axes, mesh)
                    consumed.extend(a for a in axes if a in batch_axes)
            rest = tuple(a for a in batch_axes if a not in consumed)
            if rest:
                g = g.contiguous()
                dist.all_reduce(g, group=mesh.state.group(rest))
            out.append(g)
        return out

    return reduce


def sharded_global_norm(grads: list, specs: list[Spec], batch_axes: tuple[str, ...], mesh: _Mesh) -> torch.Tensor:
    """The global L2 norm of gradient leaves in their update layout. A leaf
    is disjoint across the batch axes its spec splits it over and whole
    (repeated) across the others, so each leaf's square sum is divided by
    its count of copies (a power of two: exact) before one all-reduce."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g, spec in zip(grads, specs):
        consumed = {a for _, axes in sharded_dims(spec, mesh.sizes) for a in axes if a in batch_axes}
        copies = int(np.prod([mesh.sizes[a] for a in batch_axes if a not in consumed]))
        contrib = torch.sum(g.float() * g.float())
        total = total + (contrib / copies if copies > 1 else contrib)
    if batch_axes:
        dist.all_reduce(total, group=mesh.state.group(batch_axes))
    return torch.sqrt(total)


class ShardedLayout:
    """Where a prepared model's params are stored and where their update
    runs, on the mesh of ``PartialState``; the collectives that move
    between the two. Trees are the JAX layout's nested dicts; the methods
    taking lists take leaves in ``tree_leaves`` order."""

    def __init__(self, state, param_specs: dict, update_specs: dict):
        self.mesh = _Mesh(state)
        self.param_specs = param_specs
        self.update_specs = update_specs
        self.pspecs = tree_leaves(param_specs)
        self.uspecs = tree_leaves(update_specs)
        self.batch_axes = zero_batch_axes(self.mesh.sizes)
        self.shards = 1
        for axis in self.batch_axes:
            self.shards *= self.mesh.sizes[axis]
        self.reduce = make_grad_reducer(self.uspecs, self.batch_axes, self.mesh)
        self.param_dims = [sharded_dims(s, self.mesh.sizes) for s in self.pspecs]
        update_dims = [sharded_dims(s, self.mesh.sizes) for s in self.uspecs]
        # which leaves update where they are stored (the others are stored
        # whole and update a shard: FSDP stages 1 and 2)
        self.in_place = [p == u for p, u in zip(self.param_dims, update_dims)]
        # whether any param is stored split (the module's own weights then
        # hold nothing between steps), and any update runs on a shard
        self.shards_params = any(self.param_dims)
        self.shards_update = any(update_dims)

    def store(self, full: dict) -> dict:
        """Whole params to their stored layout (new contiguous tensors)."""
        leaves = [shard_of(x, s, self.mesh) for x, s in zip(tree_leaves(full), self.pspecs)]
        return tree_unflatten(full, leaves)

    def gather_params(self, stored: dict) -> dict:
        """The whole params, gathered from the stored ones."""
        leaves = [gather_full(x, s, self.mesh) if d else x
                  for x, s, d in zip(tree_leaves(stored), self.pspecs, self.param_dims)]
        return tree_unflatten(stored, leaves)

    def update_params(self, stored: dict) -> list:
        """The leaves the update writes: the stored tensors where they are
        updated in place, else copies of this process's shard."""
        return [x if same else shard_of(x, u, self.mesh)
                for x, u, same in zip(tree_leaves(stored), self.uspecs, self.in_place)]

    @torch.no_grad()
    def write_back(self, stored: dict, updated: list) -> None:
        """Gather the updated shards of whole-stored params back into them."""
        for x, u, same, new in zip(tree_leaves(stored), self.uspecs, self.in_place, updated):
            if not same:
                x.copy_(gather_full(new, u, self.mesh))

    def global_norm(self, grads: list) -> torch.Tensor:
        if not self.shards_update:  # every leaf whole: the local norm is the global one
            return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
        return sharded_global_norm(grads, self.uspecs, self.batch_axes, self.mesh)

    def state_specs(self, opt_state, update_params: list) -> list[Spec]:
        """The spec of each optimizer-state leaf (a moment takes its param's)."""
        shaped = tree_unflatten(self.update_specs, update_params)
        return shardings_like(opt_state, shaped, self.update_specs)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch axes (every process's share of a loss)."""
        x = x.clone()
        if self.batch_axes:
            dist.all_reduce(x, group=self.mesh.state.group(self.batch_axes))
        return x

    def shard_state(self, full_leaves: list, specs: list[Spec]) -> list:
        return [shard_of(x, s, self.mesh) for x, s in zip(full_leaves, specs)]

    def gather_state(self, leaves: list, specs: list[Spec]) -> list:
        return [gather_full(x, s, self.mesh) for x, s in zip(leaves, specs)]

    def full_shape(self, shard_shape: tuple[int, ...], spec: Spec) -> tuple[int, ...]:
        """The whole leaf's shape, from this process's shard's."""
        shape = list(shard_shape)
        for dim, axes in sharded_dims(spec, self.mesh.sizes):
            shape[dim] *= self.mesh.count(axes)
        return tuple(shape)

    def chunk_start(self, shape: tuple[int, ...], spec: Spec) -> tuple[int, ...]:
        """The global offset of this process's shard of a leaf of ``shape``."""
        start = [0] * len(shape)
        for dim, axes in sharded_dims(spec, self.mesh.sizes):
            start[dim] = self.mesh.chunk(axes) * (shape[dim] // self.mesh.count(axes))
        return tuple(start)

    def writes_chunk(self, spec: Spec) -> bool:
        """Whether this process writes its shard of a leaf to a sharded
        checkpoint: exactly one process of those holding the same chunk
        (the one at index 0 on every axis the spec does not split over)."""
        split = {a for _, axes in sharded_dims(spec, self.mesh.sizes) for a in axes}
        return all(self.mesh.coords[a] == 0 for a in CANONICAL_MESH_AXES if a not in split)


def build_zero_step(*, accelerator, loss_fn: Callable, model, optimizer, clip_grad_norm: Optional[float] = None,
                    clip_grad_value: Optional[float] = None) -> Callable:
    """``step(batch) -> loss`` over this process's share of the batch: the
    sharded update of ``optimizer.layout`` (module docstring). The returned
    loss is the global one (the batch-shard losses summed over the
    processes, each carrying its 1/N), unscaled, the same on every process."""
    from ..optimizer import clip_by_value, clip_grads

    layout: ShardedLayout = optimizer.layout
    num_micro = accelerator.gradient_state.num_steps
    scaler_cfg = optimizer.scaler

    def local_loss_and_grads(full, batch, scale):
        rows = int(tree_leaves(batch)[0].shape[0]) if isinstance(batch, dict) else int(batch.shape[0])
        # equal microbatches average to the same gradients whatever the split:
        # the largest divisor of this process's rows that fits the window
        micro = int(np.gcd(num_micro, rows)) if num_micro > 1 else 1
        total_loss, total = None, None
        for i in range(micro):
            mb = batch if micro == 1 else tree_map(lambda x: _microbatch(x, i, micro), batch)
            loss, _, grads = accelerator._loss_and_grads(loss_fn, model, mb, scale, params=full,
                                                         shards=layout.shards)
            total_loss = loss if total_loss is None else total_loss + loss
            total = grads if total is None else tree_map(torch.add, total, grads)
        if micro > 1:
            total_loss, total = total_loss / micro, tree_map(lambda g: g / micro, total)
        return total_loss, total

    def step(batch):
        scale = optimizer.scale if scaler_cfg is not None else None
        full = layout.gather_params(model.params)
        loss, grads = local_loss_and_grads(full, batch, scale)
        if scale is not None:  # unscale before the scatter: it sums the replicated path's terms
            grads = tree_map(lambda g: g / scale, grads)
        grads = tree_unflatten(grads, layout.reduce(tree_leaves(grads)))
        grads = clip_by_value(grads, clip_grad_value)
        gnorm = None
        if clip_grad_norm is not None or scaler_cfg is not None:
            gnorm = layout.global_norm(tree_leaves(grads))
            grads = clip_grads(grads, gnorm, clip_grad_norm)
        loss = layout.psum(loss)
        if scale is not None:
            loss = loss / scale
        optimizer.apply_update(grads, gnorm)
        optimizer._step_count += 1
        return loss

    return step


def _microbatch(x, i: int, num_micro: int):
    if not isinstance(x, torch.Tensor):
        return x
    size = x.shape[0] // num_micro
    return x[i * size:(i + 1) * size]
