"""Process, device and precision state: one process on one device.

Counterpart of ``accelerate_tpu/state.py`` (``PartialState``,
``AcceleratorState``, ``GradientState``), keeping its shared-state (Borg)
singletons so every component sees one device and one precision policy.
Where the JAX package builds a mesh over every chip, this slice runs one
process on one device: ``resolve_device`` picks it (CUDA unless the caller
asks for the CPU, and no card raises). The process helpers
(``main_process_first``, ``split_between_processes``, ``on_main_process``,
``any_process``, ``print``) run their one-process paths. A
``ParallelismConfig`` or a world size above 1 waits for the parallel slice
across processes (ROADMAP item 9(b)).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from functools import wraps
from typing import Any, Callable, Optional

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
                "is not in the port yet (ROADMAP item 9(b))"
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
    def local_process_index(self) -> int:
        return 0

    @property
    def num_devices(self) -> int:
        return 1

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    @property
    def use_distributed(self) -> bool:
        return self.num_devices > 1

    @property
    def distributed_type(self) -> DistributedType:
        return DistributedType.NO

    def wait_for_everyone(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def any_process(self, flag: bool) -> bool:
        """Logical OR of a process-local flag over every process: the
        preemption agreement of ``fault_tolerance.CheckpointManager``."""
        return bool(flag)

    @contextmanager
    def main_process_first(self):
        """The main process runs the body first, the others after it."""
        if not self.is_main_process:
            self.wait_for_everyone()
        yield
        if self.is_main_process:
            self.wait_for_everyone()

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):  # noqa: ARG002 - one process
        """This process's share of ``inputs``: all of them at one process."""
        yield inputs

    def on_main_process(self, function: Callable) -> Callable:
        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.is_main_process:
                return function(*args, **kwargs)

        return wrapper

    def on_last_process(self, function: Callable) -> Callable:
        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.is_last_process:
                return function(*args, **kwargs)

        return wrapper

    def on_process(self, function: Optional[Callable] = None, process_index: int = 0) -> Callable:
        def decorator(fn):
            @wraps(fn)
            def wrapper(*args, **kwargs):
                if self.process_index == process_index:
                    return fn(*args, **kwargs)

            return wrapper

        return decorator(function) if function is not None else decorator

    def print(self, *args, **kwargs) -> None:
        if self.is_main_process:
            print(*args, **kwargs)

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
    applied (``sync_gradients``), the accumulation window, and the prepared
    data loaders being iterated, so that the last partial window of an
    epoch still steps (``sync_with_dataloader``)."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = GradientState._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references: list = [None]
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
    def adjust_scheduler(self) -> bool:
        return self.plugin_kwargs.get("adjust_scheduler", True)

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def sync_each_batch(self) -> bool:
        return self.plugin_kwargs.get("sync_each_batch", False)

    @property
    def end_of_dataloader(self) -> bool:
        if not self.in_dataloader:
            return False
        return self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        if not self.in_dataloader:
            return -1
        return self.active_dataloader.remainder

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    def _add_dataloader(self, dataloader) -> None:
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader) -> None:
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]

    def _set_sync_gradients(self, value: bool) -> None:
        self.sync_gradients = value

    def __repr__(self) -> str:
        return (
            f"GradientState(sync_gradients={self.sync_gradients}, num_steps={self.num_steps}, "
            f"end_of_dataloader={self.end_of_dataloader}, remainder={self.remainder})"
        )

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()
