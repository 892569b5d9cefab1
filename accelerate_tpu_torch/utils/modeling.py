"""Model placement: sizes, memory budgets, auto device maps.

Counterpart of ``accelerate_tpu/utils/modeling.py``. The unit of placement
is a *component* of the param tree in the JAX layout: every non-layer leaf
by its dotted path (``"embed_tokens"``, ``"pooler.w"``) and ``"layers.<i>"``
for one slice of the stacked layers. The targets are ``"device"`` (the
card), ``"cpu"`` (host memory, streamed through the card per layer group)
and ``"disk"`` (memmaps, streamed the same way).

Sizes come from shapes alone (:func:`abstract_params`, a tree of ``meta``
tensors): an auto map for llama-70b allocates nothing.
"""

from __future__ import annotations

import collections
import re
from typing import Mapping, Optional

import numpy as np
import torch

from ..ops.runtime import resolve_device

# the JAX package's stand-in for the device budget where there is no card
CPU_DEVICE_BUDGET = 2**34
HEADROOM = 0.9  # the share of free device memory a map may fill


def _iter_flat(tree, prefix: str = ""):
    """Depth-first ``(key, leaf)`` pairs with "/"-joined keys, sorted per
    level: the component and packing order of the JAX package."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _iter_flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def abstract_params(model) -> dict:
    """The model's param tree (JAX key paths) as ``meta`` tensors of its
    shapes and dtypes: zero bytes anywhere. ``model`` is any model with a
    ``param_tree()``, on any device (``device="meta"`` builds one that never
    held a weight)."""
    return _unflatten({
        key: torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device="meta")
        for key, leaf in _iter_flat(model.param_tree())
    })


def dtype_byte_size(dtype) -> float:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize if not str(dtype).startswith("float8") else 1


def named_component_sizes(model, dtype_bytes: float = 4, layer_dtype_bytes: Optional[float] = None) -> dict[str, int]:
    """Bytes per placement component, from shapes only. ``layer_dtype_bytes``
    sizes the streamed layers apart from the resident components: weight-only
    quantization shrinks a layer to 1 (int8) or 0.5 (int4) bytes a weight
    while the embeddings and head stay at the compute dtype (the fp32 scale
    sidecar, about 1/hidden of the weights, is left out)."""
    if layer_dtype_bytes is None:
        layer_dtype_bytes = dtype_bytes
    sizes: dict[str, int] = {}
    layer_total = 0
    num_layers = 0
    for key, leaf in _iter_flat(abstract_params(model)):
        count = int(np.prod(tuple(leaf.shape)))
        if key.startswith("layers/"):
            layer_total += int(count * layer_dtype_bytes)
            num_layers = max(num_layers, int(leaf.shape[0]))
        else:
            sizes[key.replace("/", ".")] = int(count * dtype_bytes)
    cfg = getattr(model, "config", None)
    if cfg is not None and getattr(cfg, "num_layers", None):
        num_layers = cfg.num_layers
    if num_layers:
        per_layer = layer_total // num_layers
        for i in range(num_layers):
            sizes[f"layers.{i}"] = per_layer
    return sizes


def find_tied_parameters(tree) -> list[list[str]]:
    """Groups of tree paths that hold one buffer: the same tensor object, or
    views of the same bytes (same address and span); sorted, largest group
    first. Structural ties (llama's ``embed_tokens.T`` head) live in the
    model code and are not seen here."""
    groups: dict[object, list[str]] = collections.defaultdict(list)
    for key, leaf in _iter_flat(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
            token: object = ("tensor", leaf.device, leaf.data_ptr(), leaf.numel() * leaf.element_size())
        elif isinstance(leaf, np.ndarray):
            token = ("np", leaf.__array_interface__["data"][0], leaf.nbytes)
        elif hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
            token = ("obj", id(leaf))
        else:
            continue
        groups[token].append(key)
    tied = [sorted(paths) for paths in groups.values() if len(paths) > 1]
    return sorted(tied, key=len, reverse=True)


def retie_parameters(tree, tied_groups: list[list[str]]):
    """Point every path of each group at the group's first leaf (in place);
    returns ``tree``."""

    def _node(path: str):
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node[part]
        return node, parts[-1]

    for group in tied_groups:
        node, name = _node(group[0])
        anchor = node[name]
        for path in group[1:]:
            node, name = _node(path)
            node[name] = anchor
    return tree


def _to_bytes(value) -> int:
    if isinstance(value, int):
        return value
    match = re.fullmatch(r"(\d+(?:\.\d+)?)\s*([KMGT]?i?B)", str(value).strip(), re.IGNORECASE)
    if not match:
        raise ValueError(f"Cannot parse memory {value!r}")
    unit = match.group(2).upper().replace("IB", "B")
    mult = {"B": 1, "KB": 2**10, "MB": 2**20, "GB": 2**30, "TB": 2**40}[unit]
    return int(float(match.group(1)) * mult)


def _host_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable"):
                return int(line.split()[1]) * 1024
    return CPU_DEVICE_BUDGET


def get_max_memory(max_memory: Optional[dict] = None, device=None) -> dict[str, int]:
    """Memory budget per placement target: ``"device"`` 0.9 of the card's
    free memory (``torch.cuda.mem_get_info``; on ``device="cpu"`` the JAX
    package's 2**34 stand-in), ``"cpu"`` 0.9 of the host's available memory,
    ``"disk"`` unbounded. Explicit entries (bytes or "12GB") win."""
    budget: dict[str, int] = {}
    if max_memory:
        budget.update({k: _to_bytes(v) for k, v in max_memory.items()})
    if "device" not in budget:
        device = resolve_device(device)
        free = torch.cuda.mem_get_info(device)[0] if device.type == "cuda" else CPU_DEVICE_BUDGET
        budget["device"] = int(free * HEADROOM)
    if "cpu" not in budget:
        budget["cpu"] = int(_host_available() * HEADROOM)
    budget.setdefault("disk", 1 << 62)
    return budget


def infer_auto_device_map(
    model,
    max_memory: Optional[dict] = None,
    dtype_bytes: float = 2,
    layer_dtype_bytes: Optional[float] = None,
    no_split: bool = True,  # noqa: ARG001 - a layer is never split further
    device=None,
) -> dict[str, str]:
    """Greedy placement: fill ``"device"`` in forward order (the resident
    components, then the layers by index), then ``"cpu"``, then ``"disk"``,
    keeping room on the device for two of the largest layer streamed
    through it (the double buffer)."""
    sizes = named_component_sizes(model, dtype_bytes, layer_dtype_bytes)
    budget = dict(get_max_memory(max_memory, device=device))
    largest_layer = max(size for key, size in sizes.items() if key.startswith("layers."))
    budget["device"] = max(budget.get("device", 0) - 2 * largest_layer, 0)

    layer_keys = sorted((k for k in sizes if k.startswith("layers.")), key=lambda k: int(k.split(".")[1]))
    order = sorted(k for k in sizes if not k.startswith("layers.")) + layer_keys
    targets = ["device", "cpu", "disk"]
    device_map: dict[str, str] = {}
    t = 0
    for key in order:
        while t < len(targets) and budget.get(targets[t], 0) < sizes[key]:
            t += 1
        if t >= len(targets):
            raise RuntimeError("Model does not fit even with disk offload")
        device_map[key] = targets[t]
        budget[targets[t]] -= sizes[key]
    return device_map


def check_device_map(model, device_map: dict[str, str]) -> None:
    """Every component covered, every target known."""
    missing = sorted(set(named_component_sizes(model)) - set(device_map))
    if missing:
        raise ValueError(f"device_map does not cover: {missing[:8]}{'...' if len(missing) > 8 else ''}")
    unknown = set(device_map.values()) - {"device", "cpu", "disk"}
    if unknown:
        raise ValueError(f"Unknown device_map targets: {unknown} (use device/cpu/disk)")


def compute_module_sizes(model, dtype_bytes: int = 4) -> dict[str, int]:
    """Per-component sizes and their total under ``""``."""
    sizes = named_component_sizes(model, dtype_bytes)
    sizes[""] = sum(sizes.values())
    return sizes


def get_balanced_memory(model, max_memory: Optional[dict] = None, device=None, **kwargs) -> dict[str, int]:
    """The placement budget (:func:`get_max_memory`): the port places a model
    on one card, so there is nothing to balance across cards."""
    del model, kwargs
    return get_max_memory(max_memory, device=device)
