"""Launchers: ``notebook_launcher``, ``debug_launcher`` and the process tree
that ``launch`` (``commands/launch.py``) starts.

Counterpart of ``accelerate_tpu/launchers.py``. The JAX package runs one
process per host over every chip, so its ``notebook_launcher`` calls the
function in place and its ``debug_launcher`` simulates an N-device mesh in
one fresh process. The port runs one process per device, as ``torchrun``
would: each launcher starts its processes fresh (a function through the
``spawn`` start method, a script as a child process: nothing of this
process, a CUDA context least of all, is inherited) and gives each its
coordinates in the environment (:func:`process_env`): ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, the same two as ``ACCELERATE_PROCESS_ID``
and ``ACCELERATE_NUM_PROCESSES`` (which ``PartialState`` reads first), and
``ACCELERATE_INIT_METHOD``, by default a ``FileStore`` in a temporary
directory of its own, so launches that run at the same time never meet.
As ``torchrun`` does, each process runs one CPU thread for its own ops
unless ``OMP_NUM_THREADS`` says otherwise (several processes that each take
every core slow one another down by an order of magnitude). The function
or script builds its ``Accelerator`` (or ``PartialState``) as usual, which
joins the process group: gloo on the CPU (``device="cpu"``), NCCL on the
cards unless ``InitProcessGroupKwargs("gloo")`` asks for gloo.

Every launcher fails fast (:func:`wait_for_processes`): when a process
fails, the others, which may wait in a collective for it, are stopped a
few seconds later.

A launched function's return value comes back through a file, so the
function must be picklable (a module-level function) and return plain data
(numpy, not tensors on a card). A process that raises fails the launch:
its traceback is in the error.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import subprocess
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

from .logging import get_logger

logger = get_logger(__name__)

# seconds the other processes get to end on their own once one has failed
_GRACE = 3.0


def process_env(rank: int, world: int, local_rank: int, init_method: str) -> dict[str, str]:
    """The coordinates of one process of a job, as environment names."""
    env = {
        "RANK": str(rank),
        "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(local_rank),
        "ACCELERATE_PROCESS_ID": str(rank),
        "ACCELERATE_NUM_PROCESSES": str(world),
        "ACCELERATE_INIT_METHOD": init_method,
    }
    if "OMP_NUM_THREADS" not in os.environ:
        env["OMP_NUM_THREADS"] = "1"
    return env


def _exit_code(proc) -> Optional[int]:
    """A child process's exit code (None while it runs): a
    ``subprocess.Popen`` or a ``multiprocessing`` process."""
    return proc.poll() if isinstance(proc, subprocess.Popen) else proc.exitcode


def _join(proc, timeout: float) -> None:
    if isinstance(proc, subprocess.Popen):
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
    else:
        proc.join(timeout=timeout)


def wait_for_processes(procs: list, deadline: Optional[float] = None) -> Optional[int]:
    """Wait for every process (``subprocess.Popen`` or ``multiprocessing``
    processes); returns the rank of the first that failed, after the others
    got ``_GRACE`` seconds to end on their own, or None. Returns at
    ``deadline`` (``time.monotonic()``; None: no limit) with the hung
    processes still running."""
    pending = set(range(len(procs)))
    while pending:
        if deadline is not None and time.monotonic() >= deadline:
            return None
        for rank in sorted(pending):
            code = _exit_code(procs[rank])
            if code is None:
                continue
            pending.discard(rank)
            if code != 0:
                grace = time.monotonic() + _GRACE
                for other in pending:
                    _join(procs[other], max(grace - time.monotonic(), 0))
                return rank
        if pending:
            time.sleep(0.05)
    return None


def stop_processes(procs: list) -> None:
    """Kill every process still running and reap it."""
    for proc in procs:
        if _exit_code(proc) is None:
            proc.kill()
        _join(proc, 10)


def _run_rank(function: Callable, args: tuple, env: dict, out_dir: str) -> None:
    """One process's body: its coordinates into the environment, the
    function, its result (or traceback) into ``out_dir``."""
    import torch
    import torch.distributed as dist

    os.environ.update(env)
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    try:
        result = function(*args)
        if dist.is_available() and dist.is_initialized():
            # a process that left now would break the others' last collective
            dist.barrier()
    except BaseException:
        with open(os.path.join(out_dir, "error.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
        pickle.dump(result, f)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _launch_function(function: Callable, args: tuple, num_processes: int, extra_env: dict,
                     timeout: Optional[float], caller: str) -> list[Any]:
    """``function(*args)`` in ``num_processes`` spawned processes; each
    one's return value, by rank."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="accelerate-launch-") as root:
        init_method = f"file://{os.path.join(root, 'store')}"
        procs, dirs = [], []
        for rank in range(num_processes):
            out_dir = os.path.join(root, f"rank{rank}")
            os.makedirs(out_dir)
            env = {**extra_env, **process_env(rank, num_processes, rank, init_method)}
            proc = ctx.Process(target=_run_rank, args=(function, args, env, out_dir),
                               name=f"accelerate-rank{rank}")
            proc.start()
            procs.append(proc)
            dirs.append(out_dir)
        try:
            failed = wait_for_processes(procs, None if timeout is None else time.monotonic() + timeout)
        finally:
            stop_processes(procs)
        if failed is not None:
            detail = f"exit code {procs[failed].exitcode}"
            error = os.path.join(dirs[failed], "error.txt")
            if os.path.exists(error):
                with open(error) as f:
                    detail = f.read()
            raise RuntimeError(f"{caller}: process {failed} of {num_processes} failed:\n{detail}")
        hung = [rank for rank, proc in enumerate(procs) if proc.exitcode != 0]
        if hung:
            raise TimeoutError(f"{caller}: processes {hung} of {num_processes} did not finish "
                               f"within {timeout} s")
        results = []
        for out_dir in dirs:
            with open(os.path.join(out_dir, "result.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by this launch's own processes
        return results


def debug_launcher(function: Callable, args: tuple = (), num_processes: int = 2,
                   timeout: float = 600.0) -> list[Any]:
    """Run ``function(*args)`` in ``num_processes`` processes; returns each
    process's return value, by rank. Raises ``RuntimeError`` when a process
    fails and ``TimeoutError`` when the launch outlasts ``timeout`` seconds."""
    return _launch_function(function, args, num_processes, {}, timeout, "debug_launcher")


def notebook_launcher(function: Callable, args: tuple = (), num_processes: Optional[int] = None,
                      mixed_precision: str = "no", use_port: str = "29500", **kwargs) -> Any:
    """Run a training function from a notebook on every card: one process
    per card (``num_processes=None``: ``torch.cuda.device_count()``),
    started as :func:`debug_launcher` starts them, with
    ``ACCELERATE_MIXED_PRECISION`` set for the ``Accelerator`` each builds;
    returns each process's return value, by rank. With one process the
    function runs here, in this process, on fresh state (the objects it
    makes stay usable afterwards), and returns its value.

    ``use_port`` is taken for the reference's signature: the processes meet
    at a ``FileStore``, so launches never collide on a port. Other keyword
    arguments of the reference's are ignored with a warning."""
    del use_port
    if mixed_precision not in ("no", "fp16", "bf16", "fp8"):
        raise ValueError(f"Unknown mixed_precision {mixed_precision!r}")
    if kwargs:
        logger.warning(f"notebook_launcher ignoring unsupported arguments: {sorted(kwargs)}")
    if num_processes is None:
        import torch

        num_processes = torch.cuda.device_count()
        if num_processes == 0:
            raise RuntimeError("notebook_launcher: no CUDA card; pass num_processes=1 to run the function here")
    if num_processes > 1:
        return _launch_function(function, args, num_processes, {"ACCELERATE_MIXED_PRECISION": mixed_precision},
                                None, "notebook_launcher")
    from .state import AcceleratorState, GradientState, PartialState

    previous = os.environ.get("ACCELERATE_MIXED_PRECISION")
    os.environ["ACCELERATE_MIXED_PRECISION"] = mixed_precision
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    try:
        return function(*args)
    finally:
        if previous is None:
            os.environ.pop("ACCELERATE_MIXED_PRECISION", None)
        else:
            os.environ["ACCELERATE_MIXED_PRECISION"] = previous
