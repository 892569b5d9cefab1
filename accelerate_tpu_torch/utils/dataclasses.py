"""Config dataclasses and enums of the training step and its processes.

Copies of the parts of ``accelerate_tpu/utils/dataclasses.py`` the port
needs, not imports: the port never imports the JAX package. Field names and
defaults follow the reference, so user configs carry over. Values that need
a later slice raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import enum
import functools
import os
from dataclasses import asdict, dataclass
from datetime import timedelta
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from .constants import (
    CANONICAL_MESH_AXES,
    MESH_AXIS_DATA,
    MESH_AXIS_EXPERT,
    MESH_AXIS_FSDP,
    MESH_AXIS_PIPELINE,
    MESH_AXIS_SEQUENCE,
    MESH_AXIS_TENSOR,
)
from .environment import parse_flag_from_env, parse_int_from_env


class _StrEnum(str, enum.Enum):
    def __str__(self) -> str:  # so f-strings show the bare value
        return self.value


class DistributedType(_StrEnum):
    """Primary distribution strategy, named as the JAX package names it. One
    device is ``NO``; ``MULTI_GPU`` (the reference's name) is an alias of
    ``DATA_PARALLEL``."""

    NO = "NO"
    DATA_PARALLEL = "DATA_PARALLEL"
    MULTI_GPU = "DATA_PARALLEL"
    FSDP = "FSDP"
    TENSOR_PARALLEL = "TENSOR_PARALLEL"
    PIPELINE_PARALLEL = "PIPELINE_PARALLEL"
    HYBRID = "HYBRID"


class PrecisionType(_StrEnum):
    NO = "no"
    FP16 = "fp16"
    BF16 = "bf16"
    FP8 = "fp8"


@dataclass
class TensorInformation:
    """A tensor's shape and dtype (``ops.operations.get_data_structure``)."""

    shape: tuple
    dtype: Any


@dataclass
class KwargsHandler:
    def to_kwargs(self) -> dict[str, Any]:
        return asdict(self)


@dataclass
class InitProcessGroupKwargs(KwargsHandler):
    """How the processes of a job meet: the arguments of
    ``torch.distributed.init_process_group``, positional as the reference's
    ``(backend, init_method, timeout)``. ``backend`` is ``"nccl"`` or
    ``"gloo"``; None picks NCCL for a CUDA device and gloo for the CPU.
    ``init_method`` (None: the environment's, ``utils.environment.
    get_multihost_env``) and ``timeout`` (None: PyTorch's default) go to
    ``init_process_group`` as they are."""

    backend: Optional[str] = None
    init_method: Optional[str] = None
    timeout: Optional[timedelta] = None

    _KNOWN_BACKENDS = ("nccl", "gloo")

    def __post_init__(self):
        if self.backend is not None and self.backend not in self._KNOWN_BACKENDS:
            raise ValueError(f"backend={self.backend!r}: the port runs {self._KNOWN_BACKENDS} (or None)")
        if self.timeout is not None and not isinstance(self.timeout, timedelta):
            raise TypeError(f"timeout must be a datetime.timedelta, got {type(self.timeout).__name__}")


@dataclass
class LossScaleKwargs(KwargsHandler):
    """Dynamic loss scaling for fp16 (reference ``GradScalerKwargs``). bf16
    needs no scaling; this only activates for fp16."""

    init_scale: float = 2.0**15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    """Gradient-accumulation window semantics of the reference:
    ``adjust_scheduler`` ticks the scheduler on the micro-steps the
    optimizer skips, ``sync_with_dataloader`` closes a window at the end of
    an epoch."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False


@dataclass
class ProjectConfiguration:
    """Checkpoint and logging directories (reference
    ``ProjectConfiguration``): with ``automatic_checkpoint_naming``,
    ``save_state`` writes ``<project_dir>/checkpoints/checkpoint_<iteration>``
    and keeps the newest ``total_limit``."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: Optional[str] = None) -> None:
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        if self.logging_dir is None:
            self.logging_dir = self.project_dir


# ---------------------------------------------------------------------------
# Parallelism: one mesh over the processes
# ---------------------------------------------------------------------------

# the model-parallel axes the port does not run yet: their collectives live inside the forward
_MODEL_AXES = (MESH_AXIS_PIPELINE, MESH_AXIS_EXPERT, MESH_AXIS_TENSOR)


@dataclass
class ParallelismConfig:
    """Sizes of the mesh axes; ``data`` defaults to every process the other
    axes leave over. A process is one device, so the sizes multiply to the
    world size. The port runs the ``data``, ``fsdp`` and ``sequence`` axes (a
    sequence axis: ring attention over its processes,
    ``parallel/ring_attention.py``); ``pipeline``, ``expert`` and ``tensor``
    above 1 raise, naming ROADMAP item 17. ``zero_stage``: None shards the weight update over the data
    axes wherever the configuration allows it (``parallel/zero.py``), 0
    keeps the replicated update, 1 or more requires the sharded one."""

    data: Optional[int] = None
    fsdp: int = 1
    pipeline: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1
    zero_stage: Optional[int] = None

    def __post_init__(self):
        above = {axis: getattr(self, axis) for axis in _MODEL_AXES if getattr(self, axis) > 1}
        if above:
            raise NotImplementedError(
                f"model-parallel mesh axes {above} (pipeline, expert and tensor "
                "parallelism) are not in the port yet (ROADMAP item 17)"
            )

    @classmethod
    def from_env(cls) -> "ParallelismConfig":
        return cls(
            data=parse_int_from_env("ACCELERATE_DATA_PARALLEL_SIZE"),
            fsdp=parse_int_from_env("ACCELERATE_FSDP_SIZE", 1),
            pipeline=parse_int_from_env("ACCELERATE_PIPELINE_SIZE", 1),
            expert=parse_int_from_env("ACCELERATE_EXPERT_SIZE", 1),
            sequence=parse_int_from_env("ACCELERATE_SEQUENCE_SIZE", 1),
            tensor=parse_int_from_env("ACCELERATE_TENSOR_SIZE", 1),
            zero_stage=parse_int_from_env("ACCELERATE_ZERO_STAGE"),
        )

    def axis_sizes(self, num_devices: int) -> dict[str, int]:
        """Each canonical axis's size over ``num_devices`` devices."""
        fixed = {
            MESH_AXIS_FSDP: self.fsdp,
            MESH_AXIS_PIPELINE: self.pipeline,
            MESH_AXIS_EXPERT: self.expert,
            MESH_AXIS_SEQUENCE: self.sequence,
            MESH_AXIS_TENSOR: self.tensor,
        }
        prod = 1
        for size in fixed.values():
            prod *= size
        if self.data is None:
            if num_devices % prod != 0:
                raise ValueError(
                    f"Device count {num_devices} not divisible by model axes product {prod} "
                    f"({fixed}); fix the axis sizes or the topology."
                )
            data = num_devices // prod
        else:
            data = self.data
            if data * prod != num_devices:
                raise ValueError(
                    f"Mesh {dict(data=data, **fixed)} covers {data * prod} devices "
                    f"but {num_devices} are present."
                )
        sizes = {MESH_AXIS_DATA: data, **fixed}
        return {axis: sizes[axis] for axis in CANONICAL_MESH_AXES}

    @property
    def distributed_type(self) -> DistributedType:
        """The JAX package's naming: one live model axis names the type (a
        sequence axis ``TENSOR_PARALLEL``, as there), two or more ``HYBRID``."""
        active = [axis for axis, size in ((MESH_AXIS_FSDP, self.fsdp), (MESH_AXIS_SEQUENCE, self.sequence))
                  if size > 1]
        if len(active) > 1:
            return DistributedType.HYBRID
        if not active:
            return DistributedType.DATA_PARALLEL
        return DistributedType.FSDP if active[0] == MESH_AXIS_FSDP else DistributedType.TENSOR_PARALLEL


@dataclass
class FullyShardedDataParallelPlugin:
    """Parameter and optimizer-state sharding over the ``fsdp`` axis (the
    reference's plugin, in the JAX package's mesh terms):

    - ``stage`` 1 and 2: params replicated, the optimizer state (and the
      reduced gradient) sharded over ``fsdp``: each process updates its
      shard and the params are gathered again;
    - ``stage`` 3: the params sharded too, gathered for each step's forward;
    - ``cpu_offload``: the optimizer state lives in pinned host memory
      between steps and is brought to the device for the update;
    - ``min_weight_size``: tensors with fewer elements stay replicated;
    - ``activation_checkpointing``: each layer recomputed in the backward
      except the flash forward's out and lse (``remat_policy="save_flash"``).
    """

    fsdp_size: Optional[int] = None  # None = every process the other axes leave
    stage: int = 3
    min_weight_size: int = 2**12
    cpu_offload: bool = False
    activation_checkpointing: bool = False
    state_dict_type: str = "SHARDED_STATE_DICT"  # or FULL_STATE_DICT

    @classmethod
    def from_env(cls) -> "FullyShardedDataParallelPlugin":
        return cls(
            fsdp_size=parse_int_from_env("ACCELERATE_FSDP_SIZE"),
            stage=parse_int_from_env("ACCELERATE_FSDP_STAGE", 3),
            min_weight_size=parse_int_from_env("ACCELERATE_FSDP_MIN_WEIGHT_SIZE", 2**12),
            cpu_offload=parse_flag_from_env("ACCELERATE_FSDP_CPU_OFFLOAD", False),
            activation_checkpointing=parse_flag_from_env("ACCELERATE_FSDP_ACTIVATION_CHECKPOINTING", False),
            state_dict_type=os.environ.get("ACCELERATE_FSDP_STATE_DICT_TYPE", "SHARDED_STATE_DICT"),
        )


# matrix products without and with a batch dimension, as ATen runs them
# (``x @ w`` of a [B, S, H] activation reaches ATen as ``mm``, an einsum as ``bmm``)
_DOTS = ("aten::mm", "aten::addmm")
_BATCHED_DOTS = ("aten::bmm", "aten::baddbmm")
# what each remat policy saves inside a checkpointed region (None: nothing,
# a plain non-reentrant checkpoint); the names of the JAX package's
# CompilationConfig.checkpoint_policy. "save_flash" keeps only the flash
# forward's out and lse, through the flash module's own stash (Remat below)
_SAVED_OPS = {
    "full": None,
    "nothing_saveable": None,
    "save_flash": None,
    "dots": _DOTS + _BATCHED_DOTS,
    "dots_saveable": _DOTS + _BATCHED_DOTS,
    "dots_with_no_batch_dims": _DOTS,
}


class Remat:
    """An activation-checkpointing policy: ``remat(fn, *args)`` runs ``fn``
    under ``torch.utils.checkpoint`` (non-reentrant), so its activations
    are recomputed in the backward. With ``saved_ops`` the region runs under
    a selective-checkpoint context that keeps those ops' outputs
    (``CheckpointPolicy.MUST_SAVE``) and recomputes the rest; that context
    is a dispatch mode, which sees every op of the region in Python.
    ``save_flash`` keeps the flash forward's out and lse without one: the
    kernel launches through ``ctypes`` inside an autograd function, which no
    dispatch-mode policy sees, and the flash module's stash
    (``ops.flash_attention.flash_stash_contexts``) costs the region nothing
    else."""

    def __init__(self, name: str, saved_ops: Optional[tuple[str, ...]] = None):
        self.name = name
        self.saved_ops = frozenset(saved_ops or ())

    def _policy(self, ctx, op, *args, **kwargs):
        if op._schema.name in self.saved_ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def __call__(self, fn: Callable, *args):
        if self.name == "save_flash":
            from ..ops.flash_attention import flash_stash_contexts

            return checkpoint(fn, *args, use_reentrant=False, context_fn=flash_stash_contexts)
        if not self.saved_ops:
            return checkpoint(fn, *args, use_reentrant=False)
        context_fn = functools.partial(create_selective_checkpoint_contexts, self._policy)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    def __repr__(self) -> str:
        return f"Remat({self.name!r})"


@dataclass
class CompilationConfig:
    """Step options; the reference's donation and scan flags have no
    counterpart in eager PyTorch. ``flash_attention_min_seq``: sequences at
    least this long route attention through the flash kernels
    (``ops/flash_attention``); 0 disables. The port wires the hook on every device (the JAX package
    only on a TPU), so a CPU run takes the kernels' plain versions.
    ``remat_policy`` names what activation checkpointing keeps: None /
    ``"none"`` (off), ``"full"`` / ``"nothing_saveable"`` (recompute
    everything), ``"save_flash"`` (keep the flash forward's out and lse),
    ``"dots"`` / ``"dots_saveable"`` (keep every matrix product) or
    ``"dots_with_no_batch_dims"`` (keep the products without a batch
    dimension, the projections)."""

    remat_policy: Optional[str] = None
    flash_attention_min_seq: int = 1024

    def __post_init__(self):
        if self.remat_policy not in (None, "none") and self.remat_policy not in _SAVED_OPS:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; known: "
                f"{sorted(['none', *_SAVED_OPS])} or None"
            )

    def checkpoint_policy(self) -> Optional[Remat]:
        """The policy as a :class:`Remat`, or None when remat is off."""
        if self.remat_policy in (None, "none"):
            return None
        return Remat(self.remat_policy, _SAVED_OPS[self.remat_policy])


@dataclass
class MixedPrecisionPolicy:
    """Dtype policy: fp32 master params, compute in ``compute_dtype``. The
    step casts params and batch to it inside the autograd graph, so grads
    land on the fp32 masters; it is a cast, not autocast."""

    mixed_precision: PrecisionType = PrecisionType.NO

    def __post_init__(self):
        self.mixed_precision = PrecisionType(self.mixed_precision)
        if self.mixed_precision == PrecisionType.FP8:
            raise NotImplementedError(
                "mixed_precision='fp8' (scaled e4m3 projections, ops/fp8.py) is not in "
                "the port yet (ROADMAP item 16)"
            )

    @property
    def compute_dtype(self) -> torch.dtype:
        return {
            PrecisionType.NO: torch.float32,
            PrecisionType.FP16: torch.float16,
            PrecisionType.BF16: torch.bfloat16,
        }[self.mixed_precision]

    @property
    def requires_loss_scaling(self) -> bool:
        return self.mixed_precision == PrecisionType.FP16
