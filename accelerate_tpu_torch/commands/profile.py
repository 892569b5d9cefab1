"""`accelerate-tpu-torch profile`: a training script under a step-aligned
``torch.profiler`` window.

Counterpart of ``accelerate_tpu/commands/profile.py``. It arms the window
through the ``ACCELERATE_PROFILE_*`` names, which the telemetry hub's
``telemetry/profiler.py`` reads every ``telemetry.step()``, and launches the
script as ``launch`` does, as one process per card
(``commands/launch.py``):

    accelerate-tpu-torch profile --output-dir traces --start-step 100 --num-steps 20 \\
        train.py --epochs 1

Every process starts its trace at the same step number, so the timelines
under ``<output-dir>/host_<i>`` line up by step, not by wall clock.
``--port`` raises: the JAX package starts ``jax.profiler``'s live-capture
server there, and PyTorch has none.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from ..telemetry.profiler import NO_SERVER
from . import launch


def register_subcommand(subparsers):
    parser = subparsers.add_parser(
        "profile",
        help="Run a training script with a step-aligned torch.profiler trace window",
    )
    parser.add_argument("--output-dir", required=True, help="Where per-process traces land")
    parser.add_argument("--start-step", type=int, default=0, help="Step the trace starts at")
    parser.add_argument("--num-steps", type=int, default=5, help="How many steps to capture")
    parser.add_argument("--port", type=int, default=None,
                        help="The JAX package's live profiler server: raises here (torch.profiler has none)")
    # the launch-compatible topology surface (pass-through to the same env)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--coordinator_address", default=None)
    parser.add_argument("--mixed_precision", default=None, choices=[None, "no", "fp16", "bf16", "fp8"])
    parser.add_argument("-m", "--module", action="store_true", help="Treat script as a python module")
    parser.add_argument("training_script", help="Script (or module) to run under the profiler window")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    parser.set_defaults(func=run)
    return parser


def build_env(args) -> dict[str, str]:
    if args.port is not None:
        raise ValueError(NO_SERVER)
    env = dict(os.environ)
    env["ACCELERATE_PROFILE_DIR"] = os.path.abspath(args.output_dir)
    env["ACCELERATE_PROFILE_START_STEP"] = str(args.start_step)
    env["ACCELERATE_PROFILE_STEPS"] = str(args.num_steps)
    env["ACCELERATE_TELEMETRY"] = "1"  # the window rides the telemetry hub

    def put(key: str, value) -> None:
        if value is not None:
            env[key] = str(value)

    put("ACCELERATE_NUM_PROCESSES", args.num_processes)
    put("ACCELERATE_PROCESS_ID", args.process_id)
    put("ACCELERATE_COORDINATOR_ADDRESS", args.coordinator_address)
    put("ACCELERATE_MIXED_PRECISION", args.mixed_precision)
    return env


def run(args) -> int:
    env = build_env(args)
    topology = argparse.Namespace(num_machines=1, machine_rank=None, process_id=None)
    with tempfile.TemporaryDirectory(prefix="accelerate-launch-") as store_dir:
        code = launch.launch_processes(launch.script_command(args), launch.process_envs(topology, env, store_dir))
    if code == 0:
        print(f"Profiler traces (one dir per process) under: {env['ACCELERATE_PROFILE_DIR']}")
    return code
