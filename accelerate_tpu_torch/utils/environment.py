"""Environment parsing: flags, integers and the coordinates of a process.

Counterpart of the parts of ``accelerate_tpu/utils/environment.py`` the
port needs. :func:`get_multihost_env` reads the JAX package's
``ACCELERATE_*`` names and, beside them, those ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
"""

from __future__ import annotations

import os
from typing import Any, Optional


def str_to_bool(value: str) -> bool:
    value = value.lower().strip()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return True
    if value in ("n", "no", "f", "false", "off", "0", ""):
        return False
    raise ValueError(f"invalid truth value {value!r}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    value = os.environ.get(key)
    if value is None:
        return default
    return str_to_bool(value)


def parse_int_from_env(key: str, default: Optional[int] = None) -> Optional[int]:
    value = os.environ.get(key)
    if value is None or value == "":
        return default
    return int(value)


def _first_int(*keys: str) -> Optional[int]:
    for key in keys:
        value = parse_int_from_env(key)
        if value is not None:
            return value
    return None


def get_multihost_env() -> dict[str, Any]:
    """This process's coordinates in a job, from the environment.

    - ``num_processes``: ``ACCELERATE_NUM_PROCESSES``, ``WORLD_SIZE``,
      ``SLURM_NTASKS`` or ``OMPI_COMM_WORLD_SIZE``;
    - ``process_id``: ``ACCELERATE_PROCESS_ID``, ``RANK``, ``SLURM_PROCID``
      or ``OMPI_COMM_WORLD_RANK``;
    - ``local_rank``: ``LOCAL_RANK`` (else the process id): the card a
      process takes when it names none;
    - ``init_method``: the rendezvous as ``init_process_group`` takes it:
      ``ACCELERATE_INIT_METHOD`` (say ``file:///shared/store``), else
      ``tcp://`` to ``ACCELERATE_COORDINATOR_ADDRESS``, else ``env://``
      when ``MASTER_ADDR`` and ``MASTER_PORT`` are set, else None.
    """
    num_processes = _first_int("ACCELERATE_NUM_PROCESSES", "WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
    process_id = _first_int("ACCELERATE_PROCESS_ID", "RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
    local_rank = _first_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = process_id
    coordinator = os.environ.get("ACCELERATE_COORDINATOR_ADDRESS") or os.environ.get("COORDINATOR_ADDRESS")
    init_method = os.environ.get("ACCELERATE_INIT_METHOD")
    if not init_method and coordinator:
        init_method = f"tcp://{coordinator}"
    if not init_method and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    return {
        "coordinator_address": coordinator,
        "num_processes": num_processes,
        "process_id": process_id,
        "local_rank": local_rank,
        "init_method": init_method,
    }
