"""`accelerate-tpu-torch config`: write the launch config YAML.

Counterpart of ``accelerate_tpu/commands/config.py``, with its schema: a
config the JAX package wrote loads here unchanged, and ``--default``
writes the same dict. Two things differ, both from the process model:

- ``num_processes`` is the world size, one process per card (the JAX
  package's is one process per host), and ``launch`` starts that many;
- the default file is the port's own,
  ``~/.cache/accelerate_tpu_torch/default_config.yaml`` (under
  ``XDG_CACHE_HOME`` when set), so the two CLIs never overwrite each
  other's default. ``ACCELERATE_CONFIG_FILE`` names another file, in both.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CONFIG_DIR = os.path.join(
    os.environ.get("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")), "accelerate_tpu_torch"
)
DEFAULT_CONFIG_FILE = os.path.join(DEFAULT_CONFIG_DIR, "default_config.yaml")


def register_subcommand(subparsers):
    parser = subparsers.add_parser("config", help="Create the launch config file")
    parser.add_argument("--config_file", default=None, help="Path to write the config YAML")
    parser.add_argument("--default", action="store_true", help="Write the default config without prompting")
    parser.set_defaults(func=run)
    return parser


def _ask(prompt: str, default, cast=str):
    raw = input(f"{prompt} [{default}]: ").strip()
    if not raw:
        return default
    if cast is bool:
        return raw.lower() in ("y", "yes", "true", "1")
    return cast(raw)


def default_config() -> dict:
    return {
        "compute_environment": "LOCAL_MACHINE",
        "mixed_precision": "bf16",
        "num_processes": 1,
        "coordinator_address": None,
        "parallelism": {"data": None, "fsdp": 1, "pipeline": 1, "expert": 1, "sequence": 1, "tensor": 1},
        "gradient_accumulation_steps": 1,
        "seed": None,
    }


def build_config_interactive() -> dict:
    config = default_config()
    config["num_processes"] = _ask("How many processes (one per card, over every machine) will you launch", 1, int)
    if config["num_processes"] > 1:
        config["coordinator_address"] = _ask("Coordinator address (host:port) for rendezvous", "localhost:8476")
    from .menu import select

    config["mixed_precision"] = select("Mixed precision?", ["no", "fp16", "bf16"], "bf16")
    par = config["parallelism"]
    par["fsdp"] = _ask("FSDP (parameter-sharding) axis size", 1, int)
    par["tensor"] = _ask("Tensor-parallel axis size", 1, int)
    par["sequence"] = _ask("Sequence-parallel axis size", 1, int)
    par["pipeline"] = _ask("Pipeline-parallel axis size", 1, int)
    config["gradient_accumulation_steps"] = _ask("Gradient accumulation steps", 1, int)
    return config


def load_config_from_file(config_file: str | None = None) -> dict:
    path = config_file or os.environ.get("ACCELERATE_CONFIG_FILE", DEFAULT_CONFIG_FILE)
    if not os.path.exists(path):
        return {}
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def run(args) -> int:
    import yaml

    config = default_config() if args.default else build_config_interactive()
    path = Path(args.config_file or DEFAULT_CONFIG_FILE)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    print(f"Configuration saved to {path}")
    return 0
