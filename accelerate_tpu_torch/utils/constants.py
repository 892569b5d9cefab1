"""File names, mesh axes and launcher names of the port.

A copy of ``accelerate_tpu/utils/constants.py``: the names it gives the
checkpoint layout, so a checkpoint written by either package resumes in the
other; its canonical mesh axes, so a ``ParallelismConfig`` and the
partition rules name the same axes in both packages; and the launcher's
environment prefix and default rendezvous port.
"""

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
RNG_STATE_NAME = "random_states"
CUSTOM_OBJECT_NAME = "custom_checkpoint"

# the sharded-array checkpoint: every process writes ``<name>.shard_<p>.npz``
# and one ``<name>.index.json`` lists them
WEIGHTS_NAME = f"{MODEL_NAME}.msgpack"
WEIGHTS_INDEX_NAME = f"{MODEL_NAME}.index.json"
SHARD_PATTERN = "{name}.shard_{process:05d}.npz"

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"

# the launcher writes its settings into these names; library code reads them
# back (explicit argument > environment > config file > default)
ENV_PREFIX = "ACCELERATE_"

# the rendezvous port of ``launch --coordinator_address host`` without one
DEFAULT_COORDINATOR_PORT = 8476

CHECKPOINT_DIR_PREFIX = "checkpoint"

# saves stage into ``<dir>.tmp`` and are renamed into place only after the
# manifest is written (fault_tolerance.py)
CHECKPOINT_TMP_SUFFIX = ".tmp"
CHECKPOINT_MANIFEST_NAME = "manifest.json"

# Mesh axis names, in canonical (outer -> inner) order: a rank's index is
# row-major over them, data outermost. The port runs every axis.
MESH_AXIS_DATA = "data"
MESH_AXIS_FSDP = "fsdp"
MESH_AXIS_PIPELINE = "pipeline"
MESH_AXIS_EXPERT = "expert"
MESH_AXIS_SEQUENCE = "sequence"
MESH_AXIS_TENSOR = "tensor"
CANONICAL_MESH_AXES = (
    MESH_AXIS_DATA,
    MESH_AXIS_FSDP,
    MESH_AXIS_PIPELINE,
    MESH_AXIS_EXPERT,
    MESH_AXIS_SEQUENCE,
    MESH_AXIS_TENSOR,
)
