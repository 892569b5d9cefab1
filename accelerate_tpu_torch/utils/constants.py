"""Checkpoint names of the port.

A copy of the names ``accelerate_tpu/utils/constants.py`` gives the
checkpoint layout, so a checkpoint written by either package resumes in the
other. The rest of that module (mesh axes, launcher environment, version
floors) comes with the CLI (ROADMAP item 20).
"""

CHECKPOINT_DIR_PREFIX = "checkpoint"

# saves stage into ``<dir>.tmp`` and are renamed into place only after the
# manifest is written (fault_tolerance.py)
CHECKPOINT_TMP_SUFFIX = ".tmp"
CHECKPOINT_MANIFEST_NAME = "manifest.json"
