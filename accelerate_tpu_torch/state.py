"""Process, device, mesh and precision state.

Counterpart of ``accelerate_tpu/state.py`` (``PartialState``,
``AcceleratorState``, ``GradientState``), keeping its shared-state (Borg)
singletons so every component sees one topology and one precision policy.

Where the JAX package runs one process per host over all of its chips, the
port runs one process per device, as ``torchrun`` starts them: the world
size is the device count. With more than one process (``WORLD_SIZE`` or the
JAX package's ``ACCELERATE_NUM_PROCESSES``, ``utils.environment.
get_multihost_env``) ``PartialState`` joins the process group
(``torch.distributed.init_process_group``: NCCL for a CUDA device, gloo for
the CPU, unless ``InitProcessGroupKwargs.backend`` names one) and builds a
``DeviceMesh`` over the canonical axes (data outermost) from the
``ParallelismConfig``; a group that is already initialized is adopted;
``group(axes)`` gives the process group over any of its axes (the tensor
and expert groups of ``parallel/tensor_parallel.py``, ranked in the JAX
mesh's order, ``rank_coords``), and ``pipeline_stages()`` the pipeline
group with this process's stage and its neighbours
(``parallel/pipeline.py``). The
device is ``cuda:LOCAL_RANK`` unless the caller names one (``device="cpu"``
for the CPU). The process helpers (``wait_for_everyone``, ``any_process``,
``aggregate_metrics``, ``split_between_processes``,
``main_process_first``, the ``on_*`` decorators) run across the processes.
Elastic training (``resilience/elastic.py``) leaves a group and forms a new
one over the current members (``rejoin``, ``leave``, ``rebuild_mesh``).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from functools import wraps
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .ops.runtime import resolve_device
from .utils.constants import CANONICAL_MESH_AXES, MESH_AXIS_PIPELINE
from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    InitProcessGroupKwargs,
    MixedPrecisionPolicy,
    ParallelismConfig,
    PrecisionType,
)
from .utils.environment import get_multihost_env, parse_flag_from_env


def rank_coords(rank: int, sizes: dict) -> dict[str, int]:
    """A process's index on each mesh axis: row-major over the canonical
    axes, data outermost."""
    coords = {}
    for axis in reversed(CANONICAL_MESH_AXES):
        coords[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return {axis: coords[axis] for axis in CANONICAL_MESH_AXES}


def job_world_size() -> int:
    """The number of processes in the job: the process group's, else the
    environment's (1 when it names none)."""
    if PartialState._shared_state.get("_ready"):
        return PartialState().num_processes
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return get_multihost_env()["num_processes"] or 1


def job_process_index() -> int:
    """This process's index in the job, read as :func:`job_world_size` reads
    the size: without making a ``PartialState`` (which would pick a device)."""
    if PartialState._shared_state.get("_ready"):
        return PartialState().process_index
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return get_multihost_env()["process_id"] or 0


def leave_process_group() -> None:
    """Leave the default process group without a collective: under NCCL
    its communicator is aborted first (a peer lost mid-collective leaves it
    waiting), then the group is destroyed. A process that leaves an elastic
    job calls it, as do the survivors before their next rendezvous."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        group = dist.group.WORLD
        backend = group._get_backend(torch.device("cuda")) if hasattr(group, "_get_backend") else None
        if backend is not None and hasattr(backend, "abort"):
            backend.abort()
    dist.destroy_process_group()


class PartialState:
    """The process, its device and the mesh over every process.
    ``device=None`` means CUDA (``cuda:LOCAL_RANK`` in a job of several
    processes)."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, device=None, parallelism: Optional[ParallelismConfig] = None,
                 init_kwargs: Optional[InitProcessGroupKwargs] = None) -> None:
        self.__dict__ = PartialState._shared_state
        if self.initialized:
            if device is not None and not _same(resolve_device(device), self.device):
                raise ValueError(
                    f"PartialState is already initialized on {self.device}; call "
                    "PartialState._reset_state() first (tests) or construct it once."
                )
            if parallelism is not None and parallelism != self.parallelism:
                raise ValueError(
                    "PartialState is already initialized with a different ParallelismConfig; "
                    "call PartialState._reset_state() first (tests) or construct it once."
                )
            return
        env = get_multihost_env()
        if dist.is_available() and dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
        else:
            world, rank = env["num_processes"] or 1, env["process_id"] or 0
        self._world, self._rank = world, rank
        self._local_rank = env["local_rank"] if env["local_rank"] is not None else rank
        self.debug = parse_flag_from_env("ACCELERATE_DEBUG_MODE")
        self.parallelism = parallelism or ParallelismConfig.from_env()
        if device is None and world > 1:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available: pass device='cpu' to run on the CPU")
            device = torch.device("cuda", self._local_rank)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # before the group and the mesh: NCCL and DeviceMesh take the current card
            torch.cuda.set_device(self.device)
        self.mesh_shape = self.parallelism.axis_sizes(world)
        self.mesh = None
        self.backend = None
        # bumped by every rebuild of the mesh (an elastic shrink or regrow):
        # what a batch placed for an older group is told apart by
        self.generation = 0
        if world > 1:
            self._join(world, rank, env, init_kwargs or InitProcessGroupKwargs())
        self._ready = True

    def _join(self, world: int, rank: int, env: dict, kwargs: InitProcessGroupKwargs) -> None:
        """Join the process group (unless it is up) and build the mesh."""
        from torch.distributed.device_mesh import init_device_mesh

        self._pg_timeout = kwargs.timeout  # a rejoin keeps the group's timeout
        if not dist.is_initialized():
            backend = kwargs.backend or ("nccl" if self.device.type == "cuda" else "gloo")
            init_method = kwargs.init_method or env["init_method"]
            if init_method is None:
                raise RuntimeError(
                    f"a job of {world} processes needs a rendezvous: set MASTER_ADDR and MASTER_PORT "
                    "(torchrun does), ACCELERATE_INIT_METHOD, or InitProcessGroupKwargs(init_method=...)"
                )
            extra = {"timeout": kwargs.timeout} if kwargs.timeout is not None else {}
            dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **extra)
        self.backend = dist.get_backend()
        shape = tuple(self.mesh_shape[axis] for axis in CANONICAL_MESH_AXES)
        self.mesh = init_device_mesh(self.device.type, shape, mesh_dim_names=CANONICAL_MESH_AXES)

    def rebuild_mesh(self, parallelism: Optional[ParallelismConfig] = None):
        """Rebuild the mesh over the current process group, under
        ``parallelism`` when given (it must cover the group's size): the
        elastic shrink and regrow seam (``resilience/elastic.py``). The
        groups made over the old mesh's axes are dropped; state laid out
        for the old mesh is the caller's to move."""
        if parallelism is not None:
            self.parallelism = parallelism
        self.mesh_shape = self.parallelism.axis_sizes(self._world)
        self.__dict__.pop("_axis_groups", None)
        self.__dict__.pop("_pipeline_stages", None)
        self.mesh = None
        if self._world > 1:
            from torch.distributed.device_mesh import init_device_mesh

            shape = tuple(self.mesh_shape[axis] for axis in CANONICAL_MESH_AXES)
            self.mesh = init_device_mesh(self.device.type, shape, mesh_dim_names=CANONICAL_MESH_AXES)
        self.generation += 1
        return self.mesh

    def leave(self) -> None:
        """Leave the process group: the mesh and the groups made over it
        are dropped first, so the group's connections close with it and a
        peer still blocked in one of its collectives fails at once rather
        than at the group's timeout."""
        import gc

        self.mesh = None
        self.__dict__.pop("_axis_groups", None)
        self.__dict__.pop("_pipeline_stages", None)
        gc.collect()
        leave_process_group()
        gc.collect()

    def rejoin(self, rank: int, world: int, init_method: str, parallelism: Optional[ParallelismConfig] = None,
               timeout=None, rendezvous_timeout=None):
        """The elastic re-rendezvous (``resilience/membership.py``): leave
        the current process group, which may still count a dead peer, join
        a new one of ``world`` processes at ``init_method`` as ``rank``
        (the members renumbered in their old order; the membership epoch
        names the rendezvous, so a process of an older epoch cannot join
        it), and rebuild the mesh over it. The device stays. Under NCCL the
        old group's communicator is aborted first: a peer that died
        mid-collective would otherwise keep it waiting. ``timeout`` is the
        new group's (default: the old one's); ``rendezvous_timeout`` how
        long a ``file://`` rendezvous waits for its members (a survivor
        held in a collective until the group's timeout arrives late)."""
        backend = self.backend or ("nccl" if self.device.type == "cuda" else "gloo")
        self.leave()
        timeout = timeout if timeout is not None else self.__dict__.get("_pg_timeout")
        extra = {"timeout": timeout} if timeout is not None else {}
        if rendezvous_timeout is not None and init_method.startswith("file://"):
            store = dist.FileStore(init_method[len("file://"):], world)
            store.set_timeout(rendezvous_timeout)
            extra["store"] = store
        else:
            extra["init_method"] = init_method
        dist.init_process_group(backend, world_size=world, rank=rank, **extra)
        self.backend = dist.get_backend()
        self._world, self._rank = int(world), int(rank)
        return self.rebuild_mesh(parallelism)

    # -- topology ------------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_ready", False)

    @property
    def num_processes(self) -> int:
        return self._world

    @property
    def process_index(self) -> int:
        return self._rank

    @property
    def local_process_index(self) -> int:
        return self._local_rank

    @property
    def num_devices(self) -> int:
        """One device per process."""
        return self._world

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
        if self.num_devices == 1:
            return DistributedType.NO
        return self.parallelism.distributed_type

    @property
    def mesh_coords(self) -> dict[str, int]:
        """This process's index on each mesh axis (row-major, data outermost)."""
        return rank_coords(self.process_index, self.mesh_shape)

    def group(self, axes: tuple[str, ...]):
        """The process group over the mesh axes ``axes`` (each of size above
        1): members differ only on those axes, ranked in ascending process
        index. Every nontrivial axis together is the whole world; one axis is
        the mesh's group; several axes of a mesh with more live axes (the
        batch axes and ``sequence`` on a mesh of three) are made on first
        use, one group for each set of members, by every process in the same
        order: a collective call."""
        live = {axis for axis in CANONICAL_MESH_AXES if self.mesh_shape[axis] > 1}
        if set(axes) == live:
            return dist.group.WORLD
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        if not set(axes) <= live:
            raise ValueError(f"no process group over {axes} on the mesh {self.mesh_shape}")
        key = tuple(sorted(axes))
        groups = self.__dict__.setdefault("_axis_groups", {})
        if key not in groups:
            members: dict = {}
            for rank in range(self.num_processes):
                coords = rank_coords(rank, self.mesh_shape)
                members.setdefault(tuple(coords[a] for a in CANONICAL_MESH_AXES if a not in axes), []).append(rank)
            for ranks in members.values():  # every process makes every group
                made = dist.new_group(ranks)
                if self.process_index in ranks:
                    groups[key] = made
        return groups[key]

    def pipeline_stages(self) -> "PipelineStages":
        """This process's pipeline group: its stage on the ``pipeline`` axis,
        the axis's size, the next and previous stages' global ranks (the
        ring wraps from the last stage to the first) and the group (None at
        one stage)."""
        stages = self.__dict__.get("_pipeline_stages")
        if stages is None:
            size = self.mesh_shape[MESH_AXIS_PIPELINE]
            index = self.mesh_coords[MESH_AXIS_PIPELINE]
            if size > 1:
                group = self.group((MESH_AXIS_PIPELINE,))
                stages = PipelineStages(group, size, index, dist.get_global_rank(group, (index + 1) % size),
                                        dist.get_global_rank(group, (index - 1) % size))
            else:
                stages = PipelineStages(None, 1, 0, self.process_index, self.process_index)
            self._pipeline_stages = stages
        return stages

    @property
    def batch_shards(self) -> int:
        """How many shards a global batch splits into: the data and fsdp
        axes' sizes (the processes of one pipeline, sequence, tensor or
        expert group take the same rows)."""
        return self.mesh_shape["data"] * self.mesh_shape["fsdp"]

    @property
    def batch_shard_index(self) -> int:
        """Which shard of a global batch this process takes (data-major)."""
        coords = self.mesh_coords
        return coords["data"] * self.mesh_shape["fsdp"] + coords["fsdp"]

    @property
    def comm_device(self) -> torch.device:
        """Where the small tensors of the control collectives live: the card
        under NCCL, the host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    # -- process control -----------------------------------------------------

    def wait_for_everyone(self) -> None:
        """A barrier across the processes (a device synchronize at one)."""
        if self.num_processes > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def any_process(self, flag: bool) -> bool:
        """Logical OR of a process-local flag over every process: the
        preemption agreement of ``fault_tolerance.CheckpointManager``. A
        collective: every process calls it at the same point."""
        if self.num_processes <= 1:
            return bool(flag)
        vote = torch.tensor([1 if flag else 0], dtype=torch.int32, device=self.comm_device)
        dist.all_reduce(vote, op=dist.ReduceOp.MAX)
        return bool(vote.item())

    def aggregate_metrics(self, metrics: dict[str, Any]) -> dict[str, dict[str, float]]:
        """min/max/mean of each numeric metric across the processes (a
        collective above one process; processes may carry different keys)."""
        numeric = {
            k: float(v)
            for k, v in metrics.items()
            if isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)
        }
        if self.num_processes == 1:
            return {k: {"min": v, "max": v, "mean": v} for k, v in numeric.items()}
        from .ops.operations import gather_object

        rows = gather_object([numeric])
        out = {}
        for key in sorted({k for row in rows for k in row}):
            values = [row[key] for row in rows if key in row]
            out[key] = {"min": min(values), "max": max(values), "mean": sum(values) / len(values)}
        return out

    @contextmanager
    def main_process_first(self):
        """The main process runs the body first, the others after it."""
        if not self.is_main_process:
            self.wait_for_everyone()
        yield
        if self.is_main_process:
            self.wait_for_everyone()

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's share of ``inputs`` (a list, tuple, array, tensor or
        dict of them): contiguous slices, the first processes one longer when
        the length does not divide. ``apply_padding`` repeats the last
        element so every share is as long (what a collective over the results
        needs)."""
        if self.num_processes == 1:
            yield inputs
            return
        length = len(inputs) if not isinstance(inputs, dict) else len(next(iter(inputs.values())))
        base, extra = divmod(length, self.num_processes)
        sizes = [base + (1 if p < extra else 0) for p in range(self.num_processes)]
        start = sum(sizes[: self.process_index])
        end = start + sizes[self.process_index]

        def _slice(seq):
            piece = seq[start:end]
            if apply_padding and len(piece) < max(sizes) and len(seq):
                pad_count = max(sizes) - len(piece)
                if isinstance(piece, torch.Tensor):
                    piece = torch.cat([piece, seq[-1:].repeat_interleave(pad_count, dim=0)])
                elif isinstance(piece, np.ndarray):
                    piece = np.concatenate([piece, np.repeat(seq[-1:], pad_count, axis=0)])
                elif isinstance(piece, tuple):
                    piece = piece + (seq[-1],) * pad_count
                else:
                    piece = list(piece) + [seq[-1]] * pad_count
            return piece

        if isinstance(inputs, dict):
            yield {k: _slice(v) for k, v in inputs.items()}
        else:
            yield _slice(inputs)

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
        mesh = {axis: size for axis, size in self.mesh_shape.items() if size > 1}
        return (
            f"PartialState(num_processes={self.num_processes}, process_index={self.process_index}, "
            f"device={self.device}, mesh={mesh}, distributed_type={self.distributed_type})"
        )

    @classmethod
    def _reset_state(cls) -> None:
        """Test hygiene: drop the shared dict (a process group stays up and
        is adopted by the next ``PartialState``)."""
        cls._shared_state.clear()


class PipelineStages:
    """A process's place on the ``pipeline`` axis: ``group`` (None at one
    stage), ``size`` stages, this process's ``index``, and the global ranks
    of the ``next`` and ``prev`` stages."""

    def __init__(self, group, size: int, index: int, next: int, prev: int):  # noqa: A002 - the neighbour
        self.group, self.size, self.index, self.next, self.prev = group, size, index, next, prev

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def __repr__(self) -> str:
        return f"PipelineStages(index={self.index}, size={self.size}, next={self.next}, prev={self.prev})"


def _same(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.type != "cuda" or a.index == b.index)


class AcceleratorState:
    """``PartialState`` plus the precision policy."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, parallelism: Optional[ParallelismConfig] = None,
                 device=None, init_kwargs: Optional[InitProcessGroupKwargs] = None) -> None:
        self.__dict__ = AcceleratorState._shared_state
        self._partial = PartialState(device=device, parallelism=parallelism, init_kwargs=init_kwargs)
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
