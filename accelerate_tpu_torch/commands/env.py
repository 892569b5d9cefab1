"""`accelerate-tpu-torch env`: the environment report for a bug report.

Counterpart of ``accelerate_tpu/commands/env.py``. Where the JAX package
reports its backend and devices, the port reports torch and CUDA, and each
card's name, power limit (``nvidia-smi``) and memory; the world size is
the number of processes ``launch`` would start (the environment's
``ACCELERATE_NUM_PROCESSES`` or ``WORLD_SIZE``, else one per card). With
no card the report says so and exits 1: nothing here runs without one.
"""

from __future__ import annotations

import os
import platform
import subprocess


def register_subcommand(subparsers):
    parser = subparsers.add_parser("env", help="Print environment information for bug reports")
    parser.set_defaults(func=run)
    return parser


def power_limits() -> list[str]:
    """Each card's power limit as ``nvidia-smi`` reports it ("not read"
    where it cannot be asked)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()] if out.returncode == 0 else []


def run(args) -> int:  # noqa: ARG001 - the subcommand's signature
    import torch

    import accelerate_tpu_torch
    from ..utils.environment import get_cards_memory_info, get_multihost_env

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info = {
        "accelerate_tpu_torch version": accelerate_tpu_torch.__version__,
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch version": torch.__version__,
        "CUDA version (torch)": torch.version.cuda,
        "card count": count,
    }
    limits = power_limits()
    for index, memory in enumerate(get_cards_memory_info()):
        limit = limits[index] if index < len(limits) else "not read"
        info[f"card {index}"] = (f"{torch.cuda.get_device_name(index)}, power limit {limit}, "
                                 f"{memory['total_bytes'] / 2**30:.2f} GiB ({memory['free_bytes'] / 2**30:.2f} free)")
    info["world size"] = get_multihost_env()["num_processes"] or count
    accelerate_env = {k: v for k, v in sorted(os.environ.items()) if k.startswith("ACCELERATE_")}
    print("\nCopy-and-paste the text below in your GitHub issue\n")
    for key, value in info.items():
        print(f"- {key}: {value}")
    print(f"- ACCELERATE_* env: {accelerate_env or '{}'}")
    if count == 0:
        print("- no CUDA card: the port's entry points need one (a script runs on the CPU only when asked)")
        return 1
    return 0
