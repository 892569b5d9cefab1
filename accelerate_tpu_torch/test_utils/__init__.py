"""Test helpers of the port and the sanity scripts ``accelerate-tpu-torch
test`` runs (counterpart of ``accelerate_tpu/test_utils``)."""

from .testing import (
    DEFAULT_LAUNCH_COMMAND,
    execute_subprocess,
    get_launch_command,
    require_cuda,
    require_multi_device,
    skip,
)
from .training import RegressionDataset, RegressionModel
