"""`accelerate-tpu-torch`: the port's command-line entry point.

Counterpart of ``accelerate_tpu/commands/cli.py``, registering the
subcommands the port has: ``config``, ``env``, ``estimate-memory``,
``launch``, ``profile``, ``serve-bench``, ``test``, ``trace`` and
``verify-checkpoint``. The JAX package's TPU-pod commands (``pod-launch``,
``tpu-config``, ``cloud``) and ``analyze`` wait for later slices
(``ROADMAP.md`` item 20). Run it as ``accelerate-tpu-torch <command>`` once
installed, or ``python -m accelerate_tpu_torch.commands.cli <command>``.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "accelerate-tpu-torch", description="Training orchestration CLI of the PyTorch/CUDA port",
        usage="accelerate-tpu-torch <command> [<args>]",
    )
    subparsers = parser.add_subparsers(dest="command")

    from . import config, env, estimate, launch, profile, serve_bench, test, trace, verify

    for module in (config, env, estimate, launch, profile, serve_bench, test, trace, verify):
        module.register_subcommand(subparsers)
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return 1
    return args.func(args) or 0


if __name__ == "__main__":
    sys.exit(main())
