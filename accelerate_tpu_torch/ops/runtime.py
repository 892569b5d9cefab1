"""Device policy and the kernel build of the port.

Counterpart of ``accelerate_tpu/ops/runtime.py``. The JAX package decides
between Mosaic and the Pallas interpreter; the port has no interpreter for
its CUDA kernels. The rule instead: a tensor on the CPU takes a kernel's
plain PyTorch version, a CUDA tensor launches the kernel or raises. There is
no override that swaps a kernel out.

Kernels are CUDA C++ sources under ``accelerate_tpu_torch/csrc/``, each with
a plain C interface (headers shared between sources end in ``.cuh``). The
first use of a source compiles it with ``nvcc`` for ``sm_90a`` into a
shared library under ``accelerate_tpu_torch/_build/`` (named by a hash of
the source and the headers, so an edited source rebuilds) and loads it with
``ctypes``. The build takes seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. ``None`` means CUDA; without a
    card that raises instead of quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.type != "cuda" or a.index == b.index)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    candidate = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    if not os.path.exists(candidate):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return candidate


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` goes: named by the hash of the
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for file_name in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, file_name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_kernel(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its build exists; returns the
    library path. The compiler's ``-Xptxas -v`` report is kept beside the
    library (``<lib>.log``). Concurrent processes each write a private file
    and rename it into place, so none ever loads a half-written library."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    with open(path + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def build_log(name: str) -> Optional[str]:
    """The ``nvcc -Xptxas -v`` report of the current build, if built."""
    log = library_path(name) + ".log"
    if not os.path.exists(log):
        return None
    with open(log) as f:
        return f.read()


@functools.cache
def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(build_kernel(name))
