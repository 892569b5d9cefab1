"""The port stands alone: no file of ``accelerate_tpu_torch/``, nor
``chip_smoke.py``, imports ``jax``, ``optax`` or ``accelerate_tpu``. Checked
on the source (an AST scan), since the test process imports JAX anyway."""

import ast
import os

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "accelerate_tpu")


def _port_sources():
    files = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO_ROOT, "accelerate_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            yield from (a.value for a in node.args[:1] if isinstance(a, ast.Constant))


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_port_file_imports_nothing_of_jax(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{os.path.relpath(path, REPO_ROOT)} imports {bad}"


def test_scan_catches_a_jax_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import numpy\nfrom accelerate_tpu.models import Llama\nimport jax.numpy as jnp\n")
    assert sorted(m for m in _imported_modules(str(probe)) if _forbidden(m)) == [
        "accelerate_tpu.models", "jax.numpy",
    ]
    assert not _forbidden("accelerate_tpu_torch.models")
