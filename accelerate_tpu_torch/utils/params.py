"""Weights across packages: the JAX param tree into a port module.

The JAX package keeps parameters as nested dicts (``{"layers": {"wq": ...}}``);
the port's modules keep the same key paths as dotted parameter names
(``layers.wq``) with the same shapes, so loading is a copy per leaf with no
transposes. Every key path and shape is checked.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: dict) -> nn.Module:
    """Fill ``model``'s parameters from a JAX param tree given as nested
    dicts of numpy arrays (bf16 leaves included). Raises ``KeyError`` when
    the key paths differ and ``ValueError`` when a shape does. Values are
    cast to each parameter's dtype and device. Returns ``model``."""
    leaves = dict(_flatten(tree))
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
