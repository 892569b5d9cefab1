"""The port stands alone: no file of ``accelerate_tpu_torch/``, nor
``chip_smoke.py``, ``chip_compare.py`` or the gate scripts ``chip_ring_gate.py``,
``chip_gpt2_gate.py`` and ``chip_fp8_gate.py``, imports
``jax``, ``optax``, ``ml_dtypes`` (the card's machine has none) or
``accelerate_tpu``. Checked on the source (an AST scan), since the test
process imports JAX anyway."""

import ast
import os

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "ml_dtypes", "accelerate_tpu")


def _port_sources():
    scripts = ("chip_smoke.py", "chip_compare.py", "chip_ring_gate.py", "chip_gpt2_gate.py", "chip_fp8_gate.py")
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
                 "examples/example_utils.py", "serving/router.py", "serving/autoscale.py",
                 "commands/serve_bench.py", "telemetry/tracing.py", "resilience/chaos.py",
                 "parallel/redistribute.py", "resilience/membership.py", "resilience/elastic.py",
                 "parallel/local_sgd.py", "commands/launch.py", "commands/estimate.py",
                 "test_utils/scripts/test_script.py"):
        assert os.path.join("accelerate_tpu_torch", name) in scanned


# Names the JAX package's subpackages export that the port does not yet, with
# the ROADMAP item that brings each (queue 1)
NOT_YET = {
    "utils": {},
    "models": {},
    "ops": {},
    "parallel": {},
    "serving": {},
    "telemetry": {},
    "resilience": {},
}

# Names of the JAX package's stack, which the port exports a counterpart of
# in its place (None: none is needed), each with its reason
COUNTERPARTS = {
    "utils": {
        # the accelerator probe: CUDA cards where the JAX package asks for TPU chips
        "is_tpu_available": "is_cuda_available",
        # the framework's version: torch's where the JAX package asks for jax's
        "is_jax_version": "is_torch_version",
        # the split root key's counterpart: the port draws from explicit torch.Generators
        "next_rng_key": "generator",
        # the models' library: the port's modules are torch.nn.Modules
        "is_flax_available": "is_torch_available",
        # checkpoints: the port writes safetensors (or .npz) itself, never through orbax
        "is_orbax_available": "is_safetensors_available",
        # the transforms are the port's own (ops/fused_adamw.py): no optional package to probe
        "is_optax_available": None,
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
    exports too, or exports its counterpart (``COUNTERPARTS``), or it is
    listed in ``NOT_YET`` with its item; no name is listed that the port
    has, and every exported name resolves."""
    import importlib

    jax_names = _exports(os.path.join(REPO_ROOT, "accelerate_tpu", package, "__init__.py"))
    port_names = _exports(os.path.join(REPO_ROOT, "accelerate_tpu_torch", package, "__init__.py"))
    counterparts = COUNTERPARTS.get(package, {})
    missing = jax_names - port_names - set(counterparts)
    assert missing == set(NOT_YET[package]), (sorted(missing - set(NOT_YET[package])),
                                              sorted(set(NOT_YET[package]) - missing))
    assert set(counterparts) <= jax_names - port_names  # a counterpart never hides a name the port has
    assert {name for name in counterparts.values() if name is not None} <= port_names
    module = importlib.import_module(f"accelerate_tpu_torch.{package}")
    assert all(hasattr(module, name) for name in port_names)
