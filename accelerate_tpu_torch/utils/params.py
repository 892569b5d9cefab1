"""Weights across packages: the JAX param tree into a port module.

The JAX package keeps parameters as nested dicts (``{"layers": {"wq": ...}}``);
the port's modules (llama, llama-MoE, bert, ``MoEBlock``) keep the same key
paths as dotted parameter names (``layers.wq``, ``embeddings.word``) with
the same shapes, so loading is a copy per leaf with no transposes. Every key
path and shape is checked.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch import nn


def flatten_tree(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """``(dotted key path, leaf)`` pairs of a nested param dict."""
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from flatten_tree(value, path + ".")
        else:
            yield path, value


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in the JAX package's pytree order (keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def state_leaves(tree) -> list:
    """Leaves of an optimizer state in ``jax.tree.leaves`` order: the fields
    of a NamedTuple and the items of a tuple or list in order, a dict's keys
    sorted, and no leaf for ``EmptyState()`` or None. This is the order of
    the ``leaf_<j>`` entries of a checkpoint's ``optimizer_<i>.npz``."""
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in state_leaves(item)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in state_leaves(tree[key])]
    if tree is None:
        return []
    return [tree]


def state_unflatten(template, leaves: list):
    """``template``'s structure with its leaves replaced by ``leaves``, taken
    in :func:`state_leaves` order."""
    want = len(state_leaves(template))
    if len(leaves) != want:
        raise ValueError(f"the state holds {want} leaves, got {len(leaves)}")
    it = iter(leaves)

    def build(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(item) for item in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(item) for item in node)
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if node is None:
            return None
        return next(it)

    return build(template)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in sorted(tree)}
    return fn(tree, *rest)


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: dict) -> nn.Module:
    """Fill ``model``'s parameters from a JAX param tree given as nested
    dicts of numpy arrays (bf16 leaves included). Raises ``KeyError`` when
    the key paths differ and ``ValueError`` when a shape does. Values are
    cast to each parameter's dtype and device. Returns ``model``."""
    leaves = dict(flatten_tree(tree))
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    unexpected = sorted(set(leaves) - set(params))
    if missing or unexpected:
        raise KeyError(f"param tree mismatch: missing {missing}, unexpected {unexpected}")
    for name, param in params.items():
        array = np.asarray(leaves[name], dtype=np.float32)
        if tuple(array.shape) != tuple(param.shape):
            raise ValueError(
                f"{name}: tree leaf has shape {tuple(array.shape)}, "
                f"the module expects {tuple(param.shape)}"
            )
        param.copy_(torch.tensor(array))
    return model
