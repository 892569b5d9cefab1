"""Whether an optional package is installed, without importing it.

Counterpart of the checks of ``accelerate_tpu/utils/imports.py`` that the
trackers (``tracking.py``) read. Nothing here is installed by the port: a
tracker whose package is missing is skipped with a warning.
"""

from __future__ import annotations

import importlib.util
from functools import lru_cache


@lru_cache
def _is_package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def is_tensorboard_available() -> bool:
    return _is_package_available("tensorboard") or _is_package_available("tensorboardX")


def is_wandb_available() -> bool:
    return _is_package_available("wandb")


def is_mlflow_available() -> bool:
    return _is_package_available("mlflow")


def is_comet_ml_available() -> bool:
    return _is_package_available("comet_ml")


def is_aim_available() -> bool:
    return _is_package_available("aim")


def is_clearml_available() -> bool:
    return _is_package_available("clearml")


def is_dvclive_available() -> bool:
    return _is_package_available("dvclive")
