"""accelerate-tpu on PyTorch and CUDA: the port of ``accelerate_tpu`` to an
NVIDIA H100.

The port trains llama (dense and mixture-of-experts) and BERT models, on
one device or across processes (data-parallel, ZeRO and FSDP over
``torch.distributed``: ``ParallelismConfig``,
``FullyShardedDataParallelPlugin``, ``debug_launcher``), and serves llama
models on one device. Training runs the
JAX package's entry points: ``Accelerator(mixed_precision=...)``,
``prepare_model``, ``prepare_optimizer`` and ``compiled_step(loss_fn)`` (or
the eager ``backward`` + ``optimizer.step()``), with bf16 compute over fp32
master params, flash attention for sequences of at least
``flash_attention_min_seq`` tokens and the optax-formula ``fused_adamw``;
and the training loop around them: ``prepare(model, optimizer, loader,
schedule)``, the data loader with its prefetch and resume, the scheduler,
``save_state`` / ``load_state`` in the JAX package's checkpoint format, and
``CheckpointManager`` (atomic saves, preemption, auto-resume); residual
dropout from explicit generators, and activation checkpointing under
``CompilationConfig(remat_policy=...)``. ``examples/nlp_example.py`` is the
reference's canonical loop (BERT on the bundled MRPC-like data).
Serving runs a paged continuous-batching engine, with speculative decoding
and quantized-resident (int8/int4) weights.

Its kernels are hand-written CUDA for ``sm_90a``: flash attention forward
(``csrc/flash_fwd.cu``) and backward (``csrc/flash_bwd.cu``), fused adamw
(``csrc/fused_adamw.cu``), paged decode attention (``csrc/paged_decode.cu``),
the speculative verify attention (``csrc/paged_verify.cu``) and the fused
dequant-matmul (``csrc/quant_matmul.cu``). Entry points run on CUDA unless
the caller passes ``device="cpu"``; on the CPU every kernel takes its plain
PyTorch version.
"""

from . import ops
from .accelerator import Accelerator, PreparedModel
from .big_modeling import dispatch_model, make_layered_device_map
from .data_loader import prepare_data_loader, skip_first_batches
from .fault_tolerance import CheckpointManager, ResumePoint, latest_valid_checkpoint, verify_checkpoint
from .launchers import debug_launcher
from .logging import get_logger
from .models import Bert, Llama, MoEBlock, generate, get_config
from .ops.flash_attention import flash_attention, make_auto_attention
from .ops.fused_adamw import adamw, fused_adamw
from .ops.paged_attention import paged_decode_attention, paged_verify_attention
from .ops.quant_matmul import quant_dot, quant_matmul
from .optimizer import AcceleratedOptimizer
from .resilience import RetryPolicy
from .scheduler import AcceleratedScheduler, warmup_cosine_decay_schedule
from .serving import ServingEngine, SpeculativeConfig
from .state import AcceleratorState, GradientState, PartialState
from .utils.dataclasses import (
    CompilationConfig,
    DistributedType,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    InitProcessGroupKwargs,
    LossScaleKwargs,
    ParallelismConfig,
    ProjectConfiguration,
)
from .utils.memory import find_executable_batch_size
from .utils.params import load_jax_params
from .utils.quantization import QuantizationConfig, QuantizedWeight
from .utils.random import set_seed

__all__ = [
    "AcceleratedOptimizer",
    "AcceleratedScheduler",
    "Accelerator",
    "AcceleratorState",
    "Bert",
    "CheckpointManager",
    "CompilationConfig",
    "DistributedType",
    "FullyShardedDataParallelPlugin",
    "GradientAccumulationPlugin",
    "GradientState",
    "InitProcessGroupKwargs",
    "Llama",
    "LossScaleKwargs",
    "MoEBlock",
    "ParallelismConfig",
    "PartialState",
    "PreparedModel",
    "ProjectConfiguration",
    "QuantizationConfig",
    "QuantizedWeight",
    "ResumePoint",
    "RetryPolicy",
    "ServingEngine",
    "SpeculativeConfig",
    "adamw",
    "debug_launcher",
    "dispatch_model",
    "find_executable_batch_size",
    "flash_attention",
    "fused_adamw",
    "generate",
    "get_config",
    "get_logger",
    "latest_valid_checkpoint",
    "load_jax_params",
    "make_auto_attention",
    "make_layered_device_map",
    "ops",
    "paged_decode_attention",
    "paged_verify_attention",
    "prepare_data_loader",
    "quant_dot",
    "quant_matmul",
    "set_seed",
    "skip_first_batches",
    "verify_checkpoint",
    "warmup_cosine_decay_schedule",
]
