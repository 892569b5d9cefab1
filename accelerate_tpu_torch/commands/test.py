"""`accelerate-tpu-torch test`: the sanity script through the launcher.

Counterpart of ``accelerate_tpu/commands/test.py``: it launches
``test_utils/scripts/test_script.py`` as ``launch`` does, one process per
card, and prints the success line when every process passed. One flag is
the port's own: ``--device`` (default ``cuda``) is handed to the script,
since ``launch`` never moves a script off the card; ``--device cpu`` runs
it on the CPU, in one process unless the config or
``ACCELERATE_NUM_PROCESSES`` asks for more.
"""

from __future__ import annotations

import os
import subprocess
import sys


def register_subcommand(subparsers):
    parser = subparsers.add_parser("test", help="Run a sanity check of the install/topology")
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="Where the script runs: one process per card (default) or the CPU")
    parser.set_defaults(func=run)
    return parser


def run(args) -> int:
    from .config import load_config_from_file

    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.cli", "launch"]
    if args.config_file:
        cmd += ["--config_file", args.config_file]
    counted = os.environ.get("ACCELERATE_NUM_PROCESSES") or load_config_from_file(args.config_file).get(
        "num_processes")
    if args.device == "cpu" and not counted:
        cmd += ["--num_processes", "1"]  # no card to count the processes by
    cmd += ["-m", "accelerate_tpu_torch.test_utils.scripts.test_script", "--device", args.device]
    result = subprocess.run(cmd)
    if result.returncode == 0:
        print("Test is a success! You are ready for your distributed training!")
    return result.returncode
