"""Test harness helpers: hardware gates, the launch command, subprocesses.

Counterpart of ``accelerate_tpu/test_utils/testing.py``. ``require_tpu``
becomes :func:`require_cuda`, and :func:`require_multi_device` asks for two
cards. A gate skips; it never fakes the hardware.
"""

from __future__ import annotations

import os
import subprocess
import sys
import unittest
from typing import Sequence

import torch


def skip(reason: str):
    import pytest

    return pytest.mark.skip(reason=reason)


def require_cuda(test_case):
    """Skip unless a CUDA card is attached."""
    import pytest

    return pytest.mark.skipif(not torch.cuda.is_available(), reason="test requires a CUDA card")(test_case)


def require_multi_device(test_case):
    import pytest

    return pytest.mark.skipif(torch.cuda.device_count() < 2, reason="test requires two CUDA cards")(test_case)


def get_launch_command(**kwargs) -> list[str]:
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.cli", "launch"]
    for key, value in kwargs.items():
        if value is True:
            cmd.append(f"--{key}")
        elif value is not False and value is not None:
            cmd.append(f"--{key}={value}")
    return cmd


DEFAULT_LAUNCH_COMMAND = get_launch_command()


def execute_subprocess(cmd: Sequence[str], env: dict | None = None, timeout: int = 360) -> subprocess.CompletedProcess:
    """Run a command with this package importable, raising with its output
    when it fails."""
    child_env = dict(env) if env is not None else os.environ.copy()
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = (
        pkg_root + os.pathsep + child_env["PYTHONPATH"] if child_env.get("PYTHONPATH") else pkg_root
    )
    result = subprocess.run(list(cmd), env=child_env, capture_output=True, text=True, timeout=timeout)
    if result.returncode != 0:
        raise RuntimeError(
            f"Command {' '.join(cmd)} failed with code {result.returncode}\n"
            f"stdout:\n{result.stdout}\nstderr:\n{result.stderr}"
        )
    return result


class AccelerateTestCase(unittest.TestCase):
    """Resets the shared states between tests."""

    def tearDown(self):
        from ..state import AcceleratorState, GradientState, PartialState

        AcceleratorState._reset_state()
        GradientState._reset_state()
        PartialState._reset_state()
        super().tearDown()
