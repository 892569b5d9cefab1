"""Utilities of the port, exported as the JAX package's ``utils`` exports
them where the port has the module (``tests/test_torch_imports.py`` lists
the rest with the ROADMAP item that brings each)."""

from .constants import (
    CANONICAL_MESH_AXES,
    MESH_AXIS_DATA,
    MESH_AXIS_EXPERT,
    MESH_AXIS_FSDP,
    MESH_AXIS_PIPELINE,
    MESH_AXIS_SEQUENCE,
    MESH_AXIS_TENSOR,
)
from .dataclasses import (
    CompilationConfig,
    DistributedType,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    InitProcessGroupKwargs,
    KwargsHandler,
    LossScaleKwargs,
    MixedPrecisionPolicy,
    ModelParallelPlugin,
    ParallelismConfig,
    PrecisionType,
    ProjectConfiguration,
    TensorInformation,
)
from .environment import get_multihost_env, parse_flag_from_env, parse_int_from_env, str_to_bool
from .imports import is_tensorboard_available, is_wandb_available
from .hf_import import export_hf_llama, import_hf_llama, load_checkpoint_in_model, load_hf_state_dict
from .memory import find_executable_batch_size, release_memory, should_reduce_batch_size
from .params import flatten_tree, load_jax_params, tree_leaves, tree_map
from .quantization import (
    QuantizationConfig,
    QuantizedWeight,
    dequantize_weight,
    quantize_weight,
    unpack_int4,
)
from .random import restore_rng_state, rng_state, set_seed, synchronize_rng_states

__all__ = [
    "CANONICAL_MESH_AXES",
    "CompilationConfig",
    "DistributedType",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GradientAccumulationPlugin",
    "InitProcessGroupKwargs",
    "KwargsHandler",
    "LossScaleKwargs",
    "MESH_AXIS_DATA",
    "MESH_AXIS_EXPERT",
    "MESH_AXIS_FSDP",
    "MESH_AXIS_PIPELINE",
    "MESH_AXIS_SEQUENCE",
    "MESH_AXIS_TENSOR",
    "MixedPrecisionPolicy",
    "ModelParallelPlugin",
    "ParallelismConfig",
    "PrecisionType",
    "ProjectConfiguration",
    "QuantizationConfig",
    "QuantizedWeight",
    "TensorInformation",
    "dequantize_weight",
    "export_hf_llama",
    "find_executable_batch_size",
    "flatten_tree",
    "get_multihost_env",
    "import_hf_llama",
    "is_tensorboard_available",
    "is_wandb_available",
    "load_checkpoint_in_model",
    "load_hf_state_dict",
    "load_jax_params",
    "parse_flag_from_env",
    "parse_int_from_env",
    "quantize_weight",
    "release_memory",
    "restore_rng_state",
    "rng_state",
    "set_seed",
    "should_reduce_batch_size",
    "str_to_bool",
    "synchronize_rng_states",
    "tree_leaves",
    "tree_map",
    "unpack_int4",
]
