"""The partition-rule engine: from param shapes to per-leaf layouts.

A copy of ``accelerate_tpu/parallel/sharding.py``'s engine over torch
shapes and the mesh's axis sizes (no JAX): the same rules give the same
layout for the same shapes and sizes. A layout (``Spec``) is a tuple with
one entry per leading dim, as ``tuple(jax.sharding.PartitionSpec(...))``
holds it: None (the dim is whole on every process), an axis name, or a
tuple of axis names (the dim split over their product, the first axis
major). ``sharded_dims`` reads it as ``(dim, axes)`` pairs, leaving out
axes of size 1.

Rules are ``(regex, spec)`` pairs matched against each leaf's key path
(``"layers/wq"``), first match wins; an unmatched leaf takes the FSDP
auto-rule (its largest dim divisible by the ``fsdp`` size, when the leaf
has at least ``min_weight_size`` elements) or stays whole. The ZeRO helpers
(``zero_batch_axes``, ``fold_update_spec``, ``zero_update_shardings``) fold
the data-parallel axes into a spec: the storage layout of the sharded
weight update (``parallel/zero.py``).
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from ..utils.constants import MESH_AXIS_DATA, MESH_AXIS_FSDP
from ..utils.dataclasses import FullyShardedDataParallelPlugin
from ..utils.params import state_leaves, tree_map, tree_paths, tree_unflatten

Spec = tuple  # one entry per leading dim: None, an axis name or a tuple of names


def _axis_size(sizes: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= sizes[a]
        return size
    return sizes[axis]


def _spec_fits(shape: tuple[int, ...], spec: Sequence, sizes: Mapping[str, int]) -> bool:
    if len(spec) > len(shape):
        return False
    for dim, axis in zip(shape, spec):
        size = _axis_size(sizes, axis)
        if size > 1 and dim % size != 0:
            return False
    return True


def sharded_dims(spec: Spec, sizes: Mapping[str, int]) -> list[tuple[int, tuple[str, ...]]]:
    """``(dim, axes)`` for each dim ``spec`` splits over axes of size above 1."""
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,)) if sizes.get(a, 1) > 1)
        if axes:
            out.append((dim, axes))
    return out


def fsdp_auto_spec(
    shape: tuple[int, ...],
    sizes: Mapping[str, int],
    plugin: Optional[FullyShardedDataParallelPlugin] = None,
) -> Spec:
    """The largest dim divisible by the ``fsdp`` size, split over ``fsdp``
    (the ZeRO-3 layout); whole below ``min_weight_size`` elements."""
    fsdp_size = sizes.get(MESH_AXIS_FSDP, 1)
    if fsdp_size <= 1:
        return ()
    min_size = plugin.min_weight_size if plugin is not None else 2**12
    total = int(np.prod(shape)) if shape else 0
    if total < min_size:
        return ()
    for dim in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[dim] % fsdp_size == 0:
            spec = [None] * len(shape)
            spec[dim] = MESH_AXIS_FSDP
            return tuple(spec)
    return ()


class PartitionRules:
    """Ordered ``(regex, spec)`` table with the FSDP auto-fallback.
    ``apply_fsdp_to_params=False`` (FSDP stages 1 and 2) keeps the params
    whole over ``fsdp``; :meth:`with_fsdp_applied` gives the sharded layout
    of their optimizer state."""

    def __init__(
        self,
        rules: Sequence[tuple[str, tuple]] = (),
        fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None,
        combine_fsdp: bool = True,
        apply_fsdp_to_params: bool = True,
    ):
        self._raw_rules = list(rules)
        self.rules = [(re.compile(pattern), tuple(spec)) for pattern, spec in rules]
        self.fsdp_plugin = fsdp_plugin
        self.combine_fsdp = combine_fsdp
        self.apply_fsdp_to_params = apply_fsdp_to_params

    def with_fsdp_applied(self) -> "PartitionRules":
        return PartitionRules(self._raw_rules, self.fsdp_plugin, combine_fsdp=self.combine_fsdp,
                              apply_fsdp_to_params=True)

    def spec_for(self, path: str, shape: tuple[int, ...], sizes: Mapping[str, int]) -> Spec:
        for pattern, spec in self.rules:
            if pattern.search(path):
                if not _spec_fits(shape, spec, sizes):
                    break  # the rule does not divide: the auto-rule decides
                spec = list(spec) + [None] * (len(shape) - len(spec))
                if self.apply_fsdp_to_params and self.combine_fsdp and sizes.get(MESH_AXIS_FSDP, 1) > 1:
                    spec = self._fold_in_fsdp(shape, spec, sizes)
                return tuple(spec)
        if not self.apply_fsdp_to_params:
            return ()
        return fsdp_auto_spec(shape, sizes, self.fsdp_plugin)

    def _fold_in_fsdp(self, shape, spec: list, sizes: Mapping[str, int]) -> list:
        """A ruled leaf also split over ``fsdp`` on its largest free dim."""
        fsdp_size = sizes[MESH_AXIS_FSDP]
        total = int(np.prod(shape)) if shape else 0
        min_size = self.fsdp_plugin.min_weight_size if self.fsdp_plugin else 2**12
        if total < min_size:
            return spec
        for dim in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
            if spec[dim] is None and shape[dim] % fsdp_size == 0:
                spec[dim] = MESH_AXIS_FSDP
                return spec
        return spec


def infer_shardings(tree: dict, sizes: Mapping[str, int], rules: Optional[PartitionRules] = None) -> dict:
    """A param tree (tensors, or anything with ``.shape``) to the tree of
    its specs."""
    rules = rules or PartitionRules()
    return tree_unflatten(tree, [rules.spec_for(path, tuple(leaf.shape), sizes) for path, leaf in tree_paths(tree)])


# -- the ZeRO storage layout --------------------------------------------------


def zero_batch_axes(sizes: Mapping[str, int]) -> tuple[str, ...]:
    """The data-parallel axes a ZeRO update shards over: every batch axis of
    size above 1."""
    return tuple(a for a in (MESH_AXIS_DATA, MESH_AXIS_FSDP) if sizes.get(a, 1) > 1)


def _spec_axes(spec: Spec) -> set:
    axes = set()
    for entry in spec:
        if entry is None:
            continue
        axes.update(entry if isinstance(entry, tuple) else (entry,))
    return axes


def fold_update_spec(shape: tuple[int, ...], spec: Spec, sizes: Mapping[str, int],
                     zero_axes: Sequence[str]) -> Spec:
    """``spec`` with ``zero_axes`` folded in: one more dim split over the
    update axes, preferring a dim already split (the reduce-scatter then
    extends that split), else the largest divisible free dim. Axes already
    in the spec are skipped; a leaf with no divisible dim keeps its spec (its
    update runs whole: bias-sized, so the state saving is negligible)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    fold = tuple(a for a in zero_axes if a not in _spec_axes(spec))
    zsize = 1
    for a in fold:
        zsize *= sizes[a]
    if zsize == 1 or not shape:
        return spec

    def _axis_count(entry) -> int:
        if entry is None:
            return 1
        return _axis_size(sizes, entry if isinstance(entry, tuple) else (entry,))

    order = sorted(range(len(shape)), key=lambda i: (_axis_count(spec[i]) == 1, -shape[i]))
    for dim in order:
        if shape[dim] % (_axis_count(spec[dim]) * zsize) == 0:
            entry = spec[dim]
            base = entry if isinstance(entry, tuple) else ((entry,) if entry is not None else ())
            merged = tuple(base) + fold
            folded = list(spec)
            folded[dim] = merged if len(merged) > 1 else merged[0]
            return tuple(folded)
    return spec


def zero_update_shardings(tree: dict, specs: dict, sizes: Mapping[str, int]) -> dict:
    """A param tree and its specs to the ZeRO-folded specs: the storage
    layout of the params, their reduced gradients and their optimizer
    moments."""
    axes = zero_batch_axes(sizes)
    return tree_map(lambda leaf, spec: fold_update_spec(tuple(leaf.shape), spec, sizes, axes), tree, specs)


def shardings_like(state: Any, params: dict, param_specs: dict) -> list[Spec]:
    """The spec of each optimizer-state leaf, in ``state_leaves`` order: a
    leaf that copies a param (an Adam moment) takes the spec of the param
    whose key path is the longest suffix of its own with an equal shape;
    scalars and everything else stay whole."""
    from ..utils.params import state_paths

    by_path = {path: (tuple(leaf.shape), spec)
               for (path, leaf), (_, spec) in zip(tree_paths(params), tree_paths(param_specs))}
    out = []
    for path, leaf in zip(state_paths(state), state_leaves(state)):
        shape = tuple(leaf.shape)
        best = None
        if shape:
            for p_path, (p_shape, spec) in by_path.items():
                if p_shape == shape and (path == p_path or path.endswith("/" + p_path)):
                    if best is None or len(p_path) > len(best[0]):
                        best = (p_path, spec)
        out.append(best[1] if best is not None else ())
    return out
