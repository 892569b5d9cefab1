"""Disk-offload weight store: raw memmaps plus a JSON index.

Counterpart of ``accelerate_tpu/utils/offload.py``, in its on-disk format,
so a folder written by either package reads in the other: each weight is a
raw ``<name>.dat`` file and ``index.json`` records its ``"dtype"`` and
``"shape"``. The JAX package reads bfloat16 through ``ml_dtypes``; here a
bfloat16 weight is stored and read as its 2-byte words, viewed as
``torch.bfloat16``, under the same ``"bfloat16"`` index entry.

A loaded weight is a CPU tensor over a copy-on-write map of its file: its
pages come from the file (through the page cache) when first read, and a
write to the tensor stays in this process's memory, never in the file.
Writes and reads retry under the stack-wide I/O policy
(``resilience.retry.DEFAULT_IO_RETRY``).
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from ..resilience.retry import DEFAULT_IO_RETRY

# index dtype name -> (the numpy dtype of the stored words, the tensor dtype)
_TORCH_DTYPES = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.int8, torch.float8_e4m3fn),
    "float8_e5m2": (np.int8, torch.float8_e5m2),
}
_NAMES = {tensor: name for name, (_, tensor) in _TORCH_DTYPES.items()}


def _as_words(weight) -> tuple[np.ndarray, str]:
    """A weight as a host numpy array of its stored words, and its index
    dtype name (a bfloat16 or float8 tensor as its raw words)."""
    if isinstance(weight, torch.Tensor):
        tensor = weight.detach().cpu()
        if tensor.dtype in _NAMES:
            view = torch.int16 if tensor.element_size() == 2 else torch.int8
            return tensor.contiguous().view(view).numpy(), _NAMES[tensor.dtype]
        return tensor.numpy(), tensor.numpy().dtype.name
    array = np.asarray(weight)
    return array, array.dtype.name


@DEFAULT_IO_RETRY.wrap
def offload_weight(weight, weight_name: str, offload_folder: str, index: Optional[dict] = None) -> dict:
    """Write one weight (a tensor or an array) as a raw memmap file and
    record it in ``index``; returns the index."""
    words, dtype_name = _as_words(weight)
    array_path = os.path.join(offload_folder, f"{weight_name}.dat")
    if index is not None:
        index[weight_name] = {"dtype": dtype_name, "shape": list(words.shape)}
    if words.ndim == 0:
        words = words[None]
    file_array = np.memmap(array_path, dtype=words.dtype, mode="w+", shape=words.shape)
    file_array[:] = words[:]
    file_array.flush()
    del file_array
    return index if index is not None else {}


@DEFAULT_IO_RETRY.wrap
def load_offloaded_weight(weight_file: str, weight_info: dict) -> torch.Tensor:
    """Open one offloaded weight as a CPU tensor over a copy-on-write map of
    its file (nothing is read until it is used)."""
    shape = tuple(weight_info["shape"])
    stored = shape if shape else (1,)
    name = weight_info["dtype"]
    # a numpy dtype only for names numpy knows without ml_dtypes
    words, tensor_dtype = _TORCH_DTYPES[name] if name in _TORCH_DTYPES else (np.dtype(name), None)
    array = np.memmap(weight_file, dtype=words, mode="c", shape=stored)
    tensor = torch.from_numpy(array)
    if tensor_dtype is not None:
        tensor = tensor.view(tensor_dtype)
    return tensor.reshape(shape)


def save_offload_index(index: dict, offload_folder: str) -> None:
    with open(os.path.join(offload_folder, "index.json"), "w") as f:
        json.dump(index, f, indent=2)


def offload_state_dict(save_dir: str, state_dict: Mapping[str, Any]) -> None:
    """Offload a whole flat dict to ``save_dir``, with its index."""
    os.makedirs(save_dir, exist_ok=True)
    index: dict = {}
    for name, value in state_dict.items():
        index = offload_weight(value, name, save_dir, index)
    save_offload_index(index, save_dir)


class OffloadedWeightsLoader(Mapping):
    """A lazy mapping over in-memory weights and an offload folder's."""

    def __init__(self, state_dict: Optional[dict] = None, save_folder: Optional[str] = None,
                 index: Optional[dict] = None):
        if state_dict is None and save_folder is None:
            raise ValueError("Need either state_dict or save_folder")
        self.state_dict = dict(state_dict or {})
        self.save_folder = save_folder
        if index is None and save_folder is not None:
            with open(os.path.join(save_folder, "index.json")) as f:
                index = json.load(f)
        self.index = dict(index or {})
        self.all_keys = list(self.state_dict) + [k for k in self.index if k not in self.state_dict]

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        return load_offloaded_weight(os.path.join(self.save_folder, f"{key}.dat"), self.index[key])

    def __iter__(self):
        return iter(self.all_keys)

    def __len__(self):
        return len(self.all_keys)


class PrefixedDataset(Mapping):
    """A view of a mapping under a key prefix."""

    def __init__(self, dataset: Mapping, prefix: str):
        self.dataset = dataset
        self.prefix = prefix

    def __getitem__(self, key):
        return self.dataset[f"{self.prefix}{key}"]

    def __iter__(self):
        return iter(k[len(self.prefix):] for k in self.dataset if k.startswith(self.prefix))

    def __len__(self):
        return len([k for k in self.dataset if k.startswith(self.prefix)])
