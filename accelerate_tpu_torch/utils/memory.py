"""Out-of-memory and transient-I/O helpers.

Counterpart of ``accelerate_tpu/utils/memory.py``. The out-of-memory
classifier recognises ``torch.cuda.OutOfMemoryError`` and the CUDA and
cuDNN messages where the JAX package looks for XLA's
``RESOURCE_EXHAUSTED``; ``release_memory`` also returns the caching
allocator's free blocks to the card. The transient-I/O classifier and the
two retrying decorators are as in the reference.
"""

from __future__ import annotations

import errno
import functools
import gc
import inspect
import time
from typing import Callable

import torch


def release_memory(*objects):
    """Drop the references, collect, and return the caching allocator's
    free blocks to the card. Returns ``None`` for each object, so
    ``a, b = release_memory(a, b)`` rebinds the caller's names."""
    released = [None for _ in objects]
    del objects
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return released if len(released) != 1 else released[0]


_OOM_MARKERS = (
    "CUDA out of memory",
    "CUDA error: out of memory",
    "CUDNN_STATUS_NOT_SUPPORTED",
    "CUDNN_STATUS_ALLOC_FAILED",
    "DefaultCPUAllocator: can't allocate memory",
)


def should_reduce_batch_size(exception: Exception) -> bool:
    """Whether ``exception`` is a memory exhaustion that a smaller batch may
    get past."""
    if isinstance(exception, torch.cuda.OutOfMemoryError):
        return True
    if isinstance(exception, RuntimeError) and len(exception.args) == 1:
        return any(marker in str(exception.args[0]) for marker in _OOM_MARKERS)
    return False


# errno values and message markers of transient I/O failures: the weather of
# network filesystems (GCS-fuse, NFS), not a bug
_TRANSIENT_IO_ERRNOS = frozenset(
    code
    for code in (
        errno.EIO,
        errno.EAGAIN,
        errno.EBUSY,
        errno.ETIMEDOUT,
        getattr(errno, "ESTALE", None),
        getattr(errno, "EREMOTEIO", None),
    )
    if code is not None
)
_TRANSIENT_IO_MARKERS = (
    "Input/output error",
    "Resource temporarily unavailable",
    "Stale file handle",
    "Transport endpoint is not connected",
    "Connection reset",
    "Connection timed out",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "Too Many Requests",
    "Service Unavailable",
)


def is_transient_io_error(exception: Exception) -> bool:
    """Whether ``exception`` is flaky-filesystem weather worth retrying. An
    ``OSError``'s errno decides when it has one: its message holds the file
    path, which must never flip the verdict."""
    if isinstance(exception, OSError):
        if exception.errno is not None:
            return exception.errno in _TRANSIENT_IO_ERRNOS
        return any(marker in str(exception) for marker in _TRANSIENT_IO_MARKERS)
    if isinstance(exception, RuntimeError):
        return any(marker in str(exception) for marker in _TRANSIENT_IO_MARKERS)
    return False


def retry_transient_io(
    function: Callable | None = None,
    max_attempts: int = 4,
    base_delay: float = 0.5,
    max_delay: float = 8.0,
):
    """Decorator retrying ``function`` on transient I/O errors with
    exponential backoff and no jitter, over ``resilience.retry.RetryPolicy``."""
    if function is None:
        return functools.partial(
            retry_transient_io, max_attempts=max_attempts, base_delay=base_delay, max_delay=max_delay
        )

    from ..resilience.retry import RetryPolicy

    policy = RetryPolicy(
        max_attempts=max_attempts,
        base_delay=base_delay,
        max_delay=max_delay,
        jitter=0.0,
        # late-bound through this module, so a test can patch time.sleep here
        sleep=lambda seconds: time.sleep(seconds),
    )

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        return policy.call(function, *args, **kwargs)

    return wrapper


def find_executable_batch_size(function: Callable | None = None, starting_batch_size: int = 128):
    """Decorator that calls ``function(batch_size, ...)`` and halves the
    batch size after each out-of-memory error, down to zero."""
    if function is None:
        return functools.partial(find_executable_batch_size, starting_batch_size=starting_batch_size)

    batch_size_box = {"value": starting_batch_size}

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        params = list(inspect.signature(function).parameters.keys())
        if not params or params[0] != "batch_size":
            raise TypeError(
                f"Batch size was passed into `{function.__name__}` as the first argument, "
                f"but `{function.__name__}({', '.join(params)})` does not accept `batch_size` first."
            )
        while True:
            if batch_size_box["value"] == 0:
                raise RuntimeError("No executable batch size found, reached zero.")
            try:
                return function(batch_size_box["value"], *args, **kwargs)
            except Exception as e:  # noqa: BLE001 - the classifier decides
                if should_reduce_batch_size(e):
                    release_memory()
                    batch_size_box["value"] //= 2
                else:
                    raise

    return wrapper
