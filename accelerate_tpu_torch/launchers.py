"""``debug_launcher``: a function run in several processes on one machine.

Counterpart of ``debug_launcher`` in ``accelerate_tpu/launchers.py``. The JAX
package simulates an N-device mesh inside one fresh process; the port runs
one process per device, as ``torchrun`` would, so the launcher starts
``num_processes`` fresh processes (the ``spawn`` start method: nothing of
this process, a CUDA context least of all, is inherited) and gives each its
coordinates in the environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``ACCELERATE_INIT_METHOD``, a ``FileStore`` in a temporary directory of
its own, so launches that run at the same time never meet. As ``torchrun``
does, each process runs one CPU thread for its own ops unless
``OMP_NUM_THREADS`` says otherwise (several processes that each take every
core slow one another down by an order of magnitude). The function
builds its ``Accelerator`` (or ``PartialState``) as usual, which joins the
process group: gloo on the CPU (``device="cpu"``), NCCL on the cards unless
``InitProcessGroupKwargs("gloo")`` asks for gloo.

Each process's return value comes back through a file, so the function
must be picklable (a module-level function) and return plain data (numpy,
not tensors on a card). A process that raises fails the launch: its
traceback is in the error, and the other processes, which may wait in a
collective for it, are stopped a few seconds later. ``timeout`` bounds the
whole launch.

``notebook_launcher`` and the CLI (``accelerate-tpu launch``) come with
ROADMAP item 20.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable

# seconds the other processes get to end on their own once one has failed
_GRACE = 3.0


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


def debug_launcher(function: Callable, args: tuple = (), num_processes: int = 2,
                   timeout: float = 600.0) -> list[Any]:
    """Run ``function(*args)`` in ``num_processes`` processes; returns each
    process's return value, by rank. Raises ``RuntimeError`` when a process
    fails and ``TimeoutError`` when the launch outlasts ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="accelerate-launch-") as root:
        store = os.path.join(root, "store")
        procs, dirs = [], []
        for rank in range(num_processes):
            out_dir = os.path.join(root, f"rank{rank}")
            os.makedirs(out_dir)
            env = {
                "RANK": str(rank),
                "WORLD_SIZE": str(num_processes),
                "LOCAL_RANK": str(rank),
                "ACCELERATE_INIT_METHOD": f"file://{store}",
            }
            proc = ctx.Process(target=_run_rank, args=(function, args, env, out_dir),
                               name=f"accelerate-rank{rank}")
            proc.start()
            procs.append(proc)
            dirs.append(out_dir)
        try:
            failed = _wait(procs, time.monotonic() + timeout)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=10)
        if failed is not None:
            detail = f"exit code {procs[failed].exitcode}"
            error = os.path.join(dirs[failed], "error.txt")
            if os.path.exists(error):
                with open(error) as f:
                    detail = f.read()
            raise RuntimeError(f"debug_launcher: process {failed} of {num_processes} failed:\n{detail}")
        hung = [rank for rank, proc in enumerate(procs) if proc.exitcode != 0]
        if hung:
            raise TimeoutError(f"debug_launcher: processes {hung} of {num_processes} did not finish "
                               f"within {timeout} s")
        results = []
        for out_dir in dirs:
            with open(os.path.join(out_dir, "result.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by this launch's own processes
        return results


def _wait(procs: list, deadline: float):
    """Wait for every process; returns the rank of the first that failed
    (the others then get ``_GRACE`` seconds), or None. Returns at the
    deadline with the hung processes still running."""
    pending = set(range(len(procs)))
    while pending:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None
        multiprocessing.connection.wait([procs[r].sentinel for r in pending], timeout=min(remaining, 1.0))
        for rank in sorted(pending):
            code = procs[rank].exitcode
            if code is None:
                continue
            pending.discard(rank)
            if code != 0:
                grace = time.monotonic() + _GRACE
                for other in pending:
                    procs[other].join(timeout=max(grace - time.monotonic(), 0))
                return rank
    return None
