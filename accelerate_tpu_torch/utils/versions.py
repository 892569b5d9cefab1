"""Version comparison: ``compare_versions`` and ``is_torch_version``.

Counterpart of ``accelerate_tpu/utils/versions.py``; ``is_torch_version``
takes the place of ``is_jax_version``.
"""

from __future__ import annotations

import importlib.metadata
import operator

_OPS = {
    "<": operator.lt,
    "<=": operator.le,
    "==": operator.eq,
    "!=": operator.ne,
    ">=": operator.ge,
    ">": operator.gt,
}


def _as_tuple(version: str) -> tuple[int, ...]:
    parts = []
    for chunk in version.split("+")[0].split(".")[:3]:
        digits = "".join(ch for ch in chunk if ch.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


def compare_versions(library_or_version: str, op: str, requirement_version: str) -> bool:
    """``library_or_version`` (an installed package's name, or a version
    string) against ``requirement_version`` under ``op``."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {list(_OPS)}, got {op}")
    version = library_or_version
    try:
        version = importlib.metadata.version(library_or_version)
    except importlib.metadata.PackageNotFoundError:
        pass
    return _OPS[op](_as_tuple(version), _as_tuple(requirement_version))


def is_torch_version(op: str, version: str) -> bool:
    import torch

    if op not in _OPS:
        raise ValueError(f"op must be one of {list(_OPS)}, got {op}")
    return _OPS[op](_as_tuple(torch.__version__), _as_tuple(version))
