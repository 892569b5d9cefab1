"""Seeding of the port: Python, numpy and an explicit ``torch.Generator``.

Counterpart of ``accelerate_tpu/utils/random.py``. Where the JAX package
keeps a root key and splits subkeys off it, the port keeps one
``torch.Generator`` per device type that code draws from explicitly
(``generator(device)``); the global torch RNG is seeded too, for code that
draws without one. JAX's threefry and torch's Philox give different numbers
from one seed, so parity tests make their inputs with numpy.

:func:`rng_state` is the snapshot a checkpoint stores
(``random_states_<p>.pkl``). It holds the keys the JAX package writes
(``python``, ``numpy``, ``jax_keystore``) and the port's own: the global
torch CPU and CUDA states and each generator of ``generator()``, as numpy
``uint8`` arrays, so unpickling the file needs numpy but no torch. What each
package restores from the other's file:

- the JAX package, from the port's: Python's and numpy's states, and its
  keystore from ``jax_keystore``, which is the seed of the last
  ``set_seed`` with ``count`` 0, what the keystore holds right after
  ``set_seed``. The torch entries are ignored;
- the port, from the JAX package's: Python's and numpy's states. The file
  holds no torch state, so the torch RNGs and the generators are seeded
  from the keystore's seed, as ``set_seed`` would leave them (its split
  count has no torch counterpart).
"""

from __future__ import annotations

import random as _py_random
import warnings

import numpy as np
import torch

_SEED = {"value": 0, "set": None}  # "set": the seed of the last set_seed, None before any
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
    _seed_torch(seed)


def _seed_torch(seed: int) -> None:
    torch.manual_seed(seed)
    _SEED["value"] = _SEED["set"] = seed
    _GENERATORS.clear()


def generator(device="cpu") -> torch.Generator:
    """The port's generator for ``device``'s type, seeded from the last
    ``set_seed`` (0 before any)."""
    device = torch.device(device)
    gen = _GENERATORS.get(device.type)
    if gen is None:
        gen = _GENERATORS[device.type] = torch.Generator(device=device).manual_seed(_SEED["value"])
    return gen


def _as_numpy(state: torch.Tensor) -> np.ndarray:
    return state.cpu().numpy().copy()


def rng_state() -> dict:
    """A checkpointable snapshot of every RNG the port draws from."""
    state = {
        "python": _py_random.getstate(),
        "numpy": np.random.get_state(),
        "jax_keystore": {"seed": _SEED["set"], "count": 0},
        "torch_seed": _SEED["value"],
        "torch_cpu": _as_numpy(torch.get_rng_state()),
        "torch_generators": {kind: _as_numpy(gen.get_state()) for kind, gen in _GENERATORS.items()},
    }
    if torch.cuda.is_initialized():
        state["torch_cuda"] = [_as_numpy(s) for s in torch.cuda.get_rng_state_all()]
    return state


def restore_rng_state(state: dict) -> None:
    """Restore a snapshot of :func:`rng_state`, or the JAX package's (see
    the module docstring). The snapshot's global CUDA states go to the cards
    of the same index, as many as both have; a saved state with no card to
    take it (and a CUDA generator's state in a process without a card) is
    left out with a warning, since the run then draws other numbers."""
    _py_random.setstate(state["python"])
    np.random.set_state(state["numpy"])
    if "torch_cpu" not in state:
        seed = state.get("jax_keystore", {}).get("seed")
        _seed_torch(0 if seed is None else int(seed))
        return
    torch.set_rng_state(torch.from_numpy(np.asarray(state["torch_cpu"], np.uint8)))
    cuda = state.get("torch_cuda") or []
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for index, saved in enumerate(cuda[:cards]):
        torch.cuda.set_rng_state(torch.from_numpy(np.asarray(saved, np.uint8)), index)
    if len(cuda) > cards:
        warnings.warn(
            f"the RNG snapshot holds the CUDA states of {len(cuda)} cards and this process sees "
            f"{cards}: the states of cards {cards}-{len(cuda) - 1} are not restored",
            stacklevel=2,
        )
    _SEED["value"] = int(state["torch_seed"])
    _SEED["set"] = state["jax_keystore"]["seed"]
    _GENERATORS.clear()
    for kind, saved in state["torch_generators"].items():
        if kind == "cuda" and not torch.cuda.is_available():
            warnings.warn("the RNG snapshot's CUDA generator is not restored: this process has no card",
                          stacklevel=2)
            continue
        generator(kind).set_state(torch.from_numpy(np.asarray(saved, np.uint8)))


def synchronize_rng_states() -> None:
    """Give every process process 0's RNG states: nothing to do at one
    process (the parallel slice, ROADMAP item 9(b), broadcasts them)."""
    from ..state import PartialState

    if PartialState().num_processes > 1:
        raise NotImplementedError("synchronize_rng_states across processes (ROADMAP item 9(b))")
