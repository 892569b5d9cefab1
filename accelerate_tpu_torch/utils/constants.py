"""Checkpoint names and mesh axes of the port.

A copy of the names ``accelerate_tpu/utils/constants.py`` gives the
checkpoint layout, so a checkpoint written by either package resumes in the
other, and of its canonical mesh axes, so a ``ParallelismConfig`` and the
partition rules name the same axes in both packages. The rest of that
module (launcher environment, version floors) comes with the CLI (ROADMAP
item 20).
"""

CHECKPOINT_DIR_PREFIX = "checkpoint"

# saves stage into ``<dir>.tmp`` and are renamed into place only after the
# manifest is written (fault_tolerance.py)
CHECKPOINT_TMP_SUFFIX = ".tmp"
CHECKPOINT_MANIFEST_NAME = "manifest.json"

# Mesh axis names, in canonical (outer -> inner) order: a rank's index is
# row-major over them, data outermost. The port runs the data and fsdp axes;
# the other four wait for model parallelism (ROADMAP item 17).
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
