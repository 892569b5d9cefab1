"""Whether an optional package is installed, without importing it.

Counterpart of ``accelerate_tpu/utils/imports.py``. Nothing here is
installed by the port: a tracker whose package is missing is skipped with
a warning. The JAX package's probes of its own stack have counterparts
here: ``is_tpu_available`` is :func:`is_cuda_available`, and
``is_flax_available``, ``is_optax_available`` and ``is_orbax_available``
have none, since the port's models, optimizers and checkpoints are its own
(``tests/test_torch_imports.py`` keeps the map).
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


def is_safetensors_available() -> bool:
    return _is_package_available("safetensors")


def is_transformers_available() -> bool:
    return _is_package_available("transformers")


def is_datasets_available() -> bool:
    return _is_package_available("datasets")


def is_torch_available() -> bool:
    return _is_package_available("torch")


def is_rich_available() -> bool:
    return _is_package_available("rich")


def is_pandas_available() -> bool:
    return _is_package_available("pandas")


def is_cuda_available() -> bool:
    """True when torch sees at least one CUDA card."""
    import torch

    return torch.cuda.is_available()


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
