"""Process, device and precision state: one process on one device.

Counterpart of ``accelerate_tpu/state.py`` (``PartialState``,
``AcceleratorState``, ``GradientState``), keeping its shared-state (Borg)
singletons so every component sees one device and one precision policy.
Where the JAX package builds a mesh over every chip, this slice runs one
process on one device: ``resolve_device`` picks it (CUDA unless the caller
asks for the CPU, and no card raises). A ``ParallelismConfig`` or a world
size above 1 waits for the parallel slice (ROADMAP item 9).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from .ops.runtime import resolve_device
from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
)


def _world_size() -> int:
    return int(os.environ.get("WORLD_SIZE") or os.environ.get("ACCELERATE_NUM_PROCESSES") or 1)


class PartialState:
    """The process and its device. ``device=None`` means CUDA."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, device=None, parallelism: Any = None) -> None:
        self.__dict__ = PartialState._shared_state
        if parallelism is not None or _world_size() > 1:
            raise NotImplementedError(
                "parallelism across processes or devices (ParallelismConfig, WORLD_SIZE > 1) "
                "is not in the port yet (ROADMAP item 9)"
            )
        if self.initialized:
            if device is not None and not _same(resolve_device(device), self.device):
                raise ValueError(
                    f"PartialState is already initialized on {self.device}; call "
                    "PartialState._reset_state() first (tests) or construct it once."
                )
            return
        self.device = resolve_device(device)
        self._ready = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_ready", False)

    @property
    def num_processes(self) -> int:
        return 1

    @property
    def process_index(self) -> int:
        return 0

    @property
    def is_main_process(self) -> bool:
        return True

    @property
    def distributed_type(self) -> DistributedType:
        return DistributedType.NO

    def wait_for_everyone(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __repr__(self) -> str:
        return f"PartialState(num_processes=1, process_index=0, device={self.device})"

    @classmethod
    def _reset_state(cls) -> None:
        """Test hygiene: drop the shared dict."""
        cls._shared_state.clear()


def _same(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.type != "cuda" or a.index == b.index)


class AcceleratorState:
    """``PartialState`` plus the precision policy."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, parallelism: Any = None, device=None) -> None:
        self.__dict__ = AcceleratorState._shared_state
        self._partial = PartialState(device=device, parallelism=parallelism)
        if not getattr(self, "_as_ready", False):
            if mixed_precision is None:
                mixed_precision = os.environ.get("ACCELERATE_MIXED_PRECISION", "no")
            self.precision_policy = MixedPrecisionPolicy(PrecisionType(mixed_precision))
            self._as_ready = True
        elif mixed_precision is not None and mixed_precision != self.mixed_precision:
            raise ValueError(
                f"AcceleratorState is already initialized with mixed_precision="
                f"{self.mixed_precision!r}; got conflicting {mixed_precision!r}. "
                "Call AcceleratorState._reset_state() first (tests) or construct it once."
            )

    def __getattr__(self, name: str):
        partial = self.__dict__.get("_partial")
        if partial is not None and hasattr(partial, name):
            return getattr(partial, name)
        raise AttributeError(name)

    @property
    def mixed_precision(self) -> str:
        return self.precision_policy.mixed_precision.value

    def __repr__(self) -> str:
        return f"{self._partial!r} mixed_precision={self.mixed_precision}"

    @classmethod
    def _reset_state(cls, reset_partial_state: bool = True) -> None:
        cls._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()


class GradientState:
    """Gradient-accumulation bookkeeping: whether this step's gradients are
    applied (``sync_gradients``) and the accumulation window. Prepared data
    loaders, which end a window at the end of an epoch, come with ROADMAP
    item 10."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = GradientState._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.plugin_kwargs = {}
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_kwargs()

    @property
    def initialized(self) -> bool:
        return GradientState._shared_state != {}

    @property
    def num_steps(self) -> int:
        return self.plugin_kwargs.get("num_steps", 1)

    @property
    def sync_each_batch(self) -> bool:
        return self.plugin_kwargs.get("sync_each_batch", False)

    def _set_sync_gradients(self, value: bool) -> None:
        self.sync_gradients = value

    def __repr__(self) -> str:
        return f"GradientState(sync_gradients={self.sync_gradients}, num_steps={self.num_steps})"

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()
