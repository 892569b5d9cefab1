"""Environment parsing, the process's coordinates and hardware probes.

Counterpart of ``accelerate_tpu/utils/environment.py``.
:func:`get_multihost_env` reads the JAX package's ``ACCELERATE_*`` names
and, beside them, those ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). The probes ask CUDA where
the JAX package asks ``jax.devices()``: :func:`get_device_memory_info` reads
this process's card (the caching allocator's counters, which the telemetry
hub polls), :func:`check_fp8_capability` whether the card has fp8 tensor
cores (compute capability 8.9 or later; the JAX package's TPU v5 and later).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
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


def parse_choice_from_env(key: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(key, default)


@contextmanager
def clear_environment():
    """Every environment variable removed for the block, restored after."""
    saved = dict(os.environ)
    os.environ.clear()
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


@contextmanager
def patch_environment(**kwargs: Any):
    """Environment variables set for the block (keys upper-cased), then
    restored or removed."""
    saved: dict[str, Optional[str]] = {}
    for key, value in kwargs.items():
        key = key.upper()
        saved[key] = os.environ.get(key)
        os.environ[key] = str(value)
    try:
        yield
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


def get_device_memory_info() -> list[dict[str, int]]:
    """``[{bytes_limit, bytes_in_use, peak_bytes_in_use}]`` of this
    process's card from the caching allocator (no synchronization); empty on
    the CPU and where CUDA was never initialized."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    device = torch.cuda.current_device()
    stats = torch.cuda.memory_stats(device)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    return [{
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
        "bytes_in_use": in_use,
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", in_use)),
    }]


def get_cards_memory_info() -> list[dict[str, int]]:
    """``[{free_bytes, total_bytes}]`` of every visible card, as the driver
    reports them (``torch.cuda.mem_get_info``: every process's use, not only
    this one's); empty without a card."""
    import torch

    if not torch.cuda.is_available():
        return []
    cards = []
    for index in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(index)
        cards.append({"free_bytes": int(free), "total_bytes": int(total)})
    return cards


def get_host_memory_info() -> dict[str, int]:
    """This process's RSS ``{rss_bytes, peak_rss_bytes}`` via ``resource``
    and ``/proc/self/statm``: the watermark every backend has."""
    try:
        import resource

        peak = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024  # KiB on Linux
    except Exception:  # noqa: BLE001 - a platform without getrusage reports none
        return {}
    rss = peak
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    return {"rss_bytes": int(rss), "peak_rss_bytes": peak}


def check_fp8_capability() -> bool:
    """Whether this process's card multiplies fp8 natively: compute
    capability 8.9 (Ada) or later, the H100's 9.0 included. False without a
    card."""
    import torch

    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability() >= (8, 9)


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
