"""Seeding of the port: Python, numpy and an explicit ``torch.Generator``.

Counterpart of ``accelerate_tpu/utils/random.py``. Where the JAX package
keeps a root key and splits subkeys off it, the port keeps one
``torch.Generator`` per device type that code draws from explicitly
(``generator(device)``); the global torch RNG is seeded too, for code that
draws without one. JAX's threefry and torch's Philox give different numbers
from one seed, so parity tests make their inputs with numpy.
"""

from __future__ import annotations

import random as _py_random

import numpy as np
import torch

_SEED = {"value": 0}
_GENERATORS: dict[str, torch.Generator] = {}


def set_seed(seed: int, device_specific: bool = False) -> None:
    """Seed Python, numpy, torch and the port's generators. With
    ``device_specific`` the seed is offset by the process index, which is 0
    for the single process this slice runs."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState().process_index
    _py_random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    _SEED["value"] = seed
    _GENERATORS.clear()


def generator(device="cpu") -> torch.Generator:
    """The port's generator for ``device``'s type, seeded from the last
    ``set_seed`` (0 before any)."""
    device = torch.device(device)
    gen = _GENERATORS.get(device.type)
    if gen is None:
        gen = _GENERATORS[device.type] = torch.Generator(device=device).manual_seed(_SEED["value"])
    return gen
