"""`accelerate-tpu-torch launch`: run a training script as a tree of
processes, one per card.

Counterpart of ``accelerate_tpu/commands/launch.py``, with its flags and its
resolution order (flag > environment > config file > default) into the same
``ACCELERATE_*`` names (:func:`build_env`). Where the JAX package runs one
process per host over every chip and so execs the script once, the port
runs one process per card, as ``torchrun`` does; so ``launch`` starts
``--num_processes`` processes of the script on this machine (their
``--num_processes / --num_machines`` share of the world with
``--num_machines``), gives each its coordinates
(``launchers.process_env``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, the
same as ``ACCELERATE_PROCESS_ID`` and ``ACCELERATE_NUM_PROCESSES``, and the
rendezvous ``ACCELERATE_INIT_METHOD``), waits for them and exits with the
first failing process's code, the others stopped a few seconds after it
failed (``launchers.wait_for_processes``, which ``debug_launcher`` uses too).
The differences, each from that process model:

- ``--num_processes`` is the world size, one process per card (the JAX
  package's counts hosts). Without it, the environment's or the config
  file's, it is ``torch.cuda.device_count()``; with no card that raises
  and names the flag. ``launch`` never moves a script off the card: a
  script that should run on the CPU says so in its own arguments (the
  sanity scripts' ``--device cpu``).
- ``--num_machines`` and ``--machine_rank`` (the reference's, which the
  JAX package folds into one process per host) spread the world over
  several machines: each runs ``launch`` with its rank, and the processes
  meet at ``tcp://`` ``--coordinator_address`` (required then; port 8476
  when it names none). ``--process_id``, the JAX package's host index, is
  read as the machine rank when ``--machine_rank`` is not given.
- The rendezvous is ``tcp://`` ``--coordinator_address`` when one is given
  (by flag, environment or config), else a ``FileStore`` in a temporary
  directory of this launch.
- Each process gets ``OMP_NUM_THREADS=1`` unless the environment sets it,
  and the directory that holds this package first on ``PYTHONPATH``, so
  the script imports the package the launcher runs from.

Every name :func:`build_env` writes is honoured by the port:
``ACCELERATE_MIXED_PRECISION`` (``AcceleratorState``), the axis sizes
(``ParallelismConfig.from_env``), ``ACCELERATE_GRADIENT_ACCUMULATION_STEPS``
and ``ACCELERATE_SEED`` (``Accelerator``), ``ACCELERATE_DEBUG_MODE``
(``PartialState.debug``), ``ACCELERATE_NUM_PROCESSES``,
``ACCELERATE_PROCESS_ID`` and ``ACCELERATE_COORDINATOR_ADDRESS``
(``utils.environment.get_multihost_env``, the first two rewritten for each
process).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile

from ..launchers import process_env, stop_processes, wait_for_processes
from ..utils.constants import DEFAULT_COORDINATOR_PORT
from .config import load_config_from_file

# the directory that holds the package: first on each process's PYTHONPATH
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def register_subcommand(subparsers):
    parser = subparsers.add_parser("launch", help="Launch a training script on this host's devices")
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--mixed_precision", default=None, choices=[None, "no", "fp16", "bf16", "fp8"])
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Total number of processes in the job, one per card (default: this host's cards)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="This host's index (multi-host): --machine_rank when that is not given")
    parser.add_argument("--coordinator_address", default=None, help="host:port of the rendezvous (multi-host)")
    parser.add_argument("--num_machines", type=int, default=1, help="Machines the processes are spread over")
    parser.add_argument("--machine_rank", type=int, default=None, help="This machine's index (0 .. num_machines-1)")
    parser.add_argument("--data_parallel_size", type=int, default=None)
    parser.add_argument("--fsdp_size", type=int, default=None)
    parser.add_argument("--tensor_size", type=int, default=None)
    parser.add_argument("--sequence_size", type=int, default=None)
    parser.add_argument("--pipeline_size", type=int, default=None)
    parser.add_argument("--expert_size", type=int, default=None)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=None)
    parser.add_argument("--debug", action="store_true", help="Enable debug-mode collective verification")
    parser.add_argument("-m", "--module", action="store_true", help="Treat script as a python module")
    parser.add_argument("training_script", help="Script (or module) to launch")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER, help="Arguments for the script")
    parser.set_defaults(func=run)
    return parser


def build_env(args) -> dict[str, str]:
    """Resolution order: CLI flag > existing env > YAML config > default.
    The JAX package's names and values, for the same flags, environment and
    config."""
    config = load_config_from_file(args.config_file)
    par = config.get("parallelism", {}) or {}
    env = dict(os.environ)

    def put(key: str, cli_value, config_value=None):
        if cli_value is not None:
            env[key] = str(cli_value)
        elif key not in env and config_value is not None:
            env[key] = str(config_value)

    put("ACCELERATE_MIXED_PRECISION", args.mixed_precision, config.get("mixed_precision"))
    put("ACCELERATE_NUM_PROCESSES", args.num_processes, config.get("num_processes"))
    put("ACCELERATE_PROCESS_ID", args.process_id)
    put("ACCELERATE_COORDINATOR_ADDRESS", args.coordinator_address, config.get("coordinator_address"))
    put("ACCELERATE_DATA_PARALLEL_SIZE", args.data_parallel_size, par.get("data"))
    put("ACCELERATE_FSDP_SIZE", args.fsdp_size, par.get("fsdp"))
    put("ACCELERATE_TENSOR_SIZE", args.tensor_size, par.get("tensor"))
    put("ACCELERATE_SEQUENCE_SIZE", args.sequence_size, par.get("sequence"))
    put("ACCELERATE_PIPELINE_SIZE", args.pipeline_size, par.get("pipeline"))
    put("ACCELERATE_EXPERT_SIZE", args.expert_size, par.get("expert"))
    put(
        "ACCELERATE_GRADIENT_ACCUMULATION_STEPS",
        args.gradient_accumulation_steps,
        config.get("gradient_accumulation_steps"),
    )
    put("ACCELERATE_SEED", None, config.get("seed"))
    if args.debug:
        env["ACCELERATE_DEBUG_MODE"] = "1"
    return env


def world_size(env: dict[str, str]) -> int:
    """The job's process count: the resolved ``ACCELERATE_NUM_PROCESSES``,
    else this host's cards. Raises, naming the flag, when that is none."""
    if env.get("ACCELERATE_NUM_PROCESSES"):
        world = int(env["ACCELERATE_NUM_PROCESSES"])
    else:
        import torch

        world = torch.cuda.device_count()
        if world == 0:
            raise RuntimeError(
                "launch: no CUDA card here and no process count given: pass --num_processes "
                "(a script that runs on the CPU asks for it in its own arguments, e.g. --device cpu)"
            )
    if world < 1:
        raise ValueError(f"launch: --num_processes must be at least 1, got {world}")
    return world


def machine_layout(args, world: int) -> tuple[int, int]:
    """``(processes on this machine, this machine's rank)``."""
    machines = args.num_machines
    rank = args.machine_rank if args.machine_rank is not None else (args.process_id or 0)
    if args.machine_rank is not None and args.process_id is not None and args.process_id != args.machine_rank:
        raise ValueError(f"launch: --process_id {args.process_id} and --machine_rank {args.machine_rank} disagree")
    if machines < 1 or not 0 <= rank < machines:
        raise ValueError(f"launch: machine rank {rank} is outside 0..{machines - 1}")
    if world % machines:
        raise ValueError(f"launch: {world} processes do not split evenly over {machines} machines")
    return world // machines, rank


def rendezvous(env: dict[str, str], machines: int, store_dir: str) -> str:
    """``tcp://`` the coordinator when there is one, else a ``FileStore``
    in ``store_dir`` (one machine only)."""
    coordinator = env.get("ACCELERATE_COORDINATOR_ADDRESS")
    if coordinator:
        if ":" not in coordinator:
            coordinator = f"{coordinator}:{DEFAULT_COORDINATOR_PORT}"
        return f"tcp://{coordinator}"
    if machines > 1:
        raise ValueError("launch: --num_machines > 1 needs --coordinator_address (host:port of machine 0)")
    return f"file://{os.path.join(store_dir, 'store')}"


def process_envs(args, env: dict[str, str], store_dir: str) -> list[dict[str, str]]:
    """Each process's environment on this machine: the resolved ``env``
    with its coordinates."""
    world = world_size(env)
    local, machine = machine_layout(args, world)
    init_method = rendezvous(env, args.num_machines, store_dir)
    path = env.get("PYTHONPATH")
    python_path = _PACKAGE_PARENT + (os.pathsep + path if path else "")
    return [{**env, "PYTHONPATH": python_path,
             **process_env(machine * local + i, world, i, init_method)} for i in range(local)]


def script_command(args) -> list[str]:
    cmd = [sys.executable]
    cmd += ["-m", args.training_script] if args.module else [args.training_script]
    return cmd + list(args.training_script_args)


def launch_processes(cmd: list[str], envs: list[dict[str, str]]) -> int:
    """Start one process of ``cmd`` per environment; returns 0, or the
    first failing process's exit code once every process has ended (the
    others are stopped a few seconds after it failed). A SIGTERM to the
    launcher stops the processes too."""
    procs: list[subprocess.Popen] = []
    previous = signal.getsignal(signal.SIGTERM)

    def _terminate(signum, frame):  # noqa: ARG001 - the handler's signature
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _terminate)
    try:
        for env in envs:
            procs.append(subprocess.Popen(cmd, env=env))
        failed = wait_for_processes(procs)
    finally:
        stop_processes(procs)
        signal.signal(signal.SIGTERM, previous)
    if failed is None:
        return 0
    code = procs[failed].returncode
    print(f"launch: process {failed} of {len(procs)} exited with code {code}", file=sys.stderr)
    return code if code > 0 else 128 - code  # killed by a signal: the shell's code for it


def run(args) -> int:
    env = build_env(args)
    with tempfile.TemporaryDirectory(prefix="accelerate-launch-") as store_dir:
        return launch_processes(script_command(args), process_envs(args, env, store_dir))
