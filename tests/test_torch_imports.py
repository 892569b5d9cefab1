"""The port stands alone: no file of ``accelerate_tpu_torch/``, nor
``chip_smoke.py``, ``chip_compare.py``, ``chip_ring_gate.py`` or ``chip_gpt2_gate.py``, imports
``jax``, ``optax``, ``ml_dtypes`` (the card's machine has none) or
``accelerate_tpu``. Checked on the source (an AST scan), since the test
process imports JAX anyway."""

import ast
import os

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "ml_dtypes", "accelerate_tpu")


def _port_sources():
    scripts = ("chip_smoke.py", "chip_compare.py", "chip_ring_gate.py", "chip_gpt2_gate.py")
    files = [os.path.join(REPO_ROOT, name) for name in scripts]
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


def test_scan_covers_the_model_zoo_and_the_examples():
    scanned = {os.path.relpath(p, REPO_ROOT) for p in _port_sources()}
    for name in ("models/bert.py", "models/moe.py", "models/gpt2.py", "examples/nlp_example.py",
                 "examples/example_utils.py"):
        assert os.path.join("accelerate_tpu_torch", name) in scanned


# Names the JAX package's subpackages export that the port does not yet, with
# the ROADMAP item that brings each (queue 1)
NOT_YET = {
    "utils": {
        "AutocastKwargs": "20", "ComputeEnvironment": "20", "DistributedInitKwargs": "20",
        "clear_environment": "20", "parse_choice_from_env": "20",
        "patch_environment": "20", "compare_versions": "20", "is_jax_version": "20",
        "is_datasets_available": "20", "is_flax_available": "20", "is_optax_available": "20",
        "is_orbax_available": "20", "is_safetensors_available": "20", "is_tensorboard_available": "20",
        "is_tpu_available": "20", "is_transformers_available": "20", "is_wandb_available": "20",
        "next_rng_key": "20", "FP8RecipeKwargs": "16", "ModelParallelPlugin": "17(f)",
    },
    "models": {},
    "ops": {},
    "parallel": {
        "LocalSGD": "17(d)", "EpochFence": "17(e)", "RedistributeConfig": "17(e)", "RedistributeError": "17(e)",
        "RedistributePlan": "17(e)", "RedistributeStageFailure": "17(e)", "plan_redistribute": "17(e)",
        "redistribute": "17(e)", "param_path": "17(e)", "replicated": "17(e)", "shard_tree": "17(e)",
    },
}


def _exports(path):
    """The names an ``__init__.py`` exports: its ``__all__``, else every
    name it imports. Read as text, so nothing of the package is imported."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return {ast.literal_eval(e) for e in node.value.elts}
    return {alias.asname or alias.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for alias in node.names}


@pytest.mark.parametrize("package", sorted(NOT_YET))
def test_subpackage_exports_match_the_jax_package(package):
    """Every name a JAX subpackage's ``__init__`` exports, the port's
    exports too, or it is listed in ``NOT_YET`` with its item; no name is
    listed that the port has, and every exported name resolves."""
    import importlib

    jax_names = _exports(os.path.join(REPO_ROOT, "accelerate_tpu", package, "__init__.py"))
    port_names = _exports(os.path.join(REPO_ROOT, "accelerate_tpu_torch", package, "__init__.py"))
    missing = jax_names - port_names
    assert missing == set(NOT_YET[package]), (sorted(missing - set(NOT_YET[package])),
                                              sorted(set(NOT_YET[package]) - missing))
    module = importlib.import_module(f"accelerate_tpu_torch.{package}")
    assert all(hasattr(module, name) for name in port_names)
