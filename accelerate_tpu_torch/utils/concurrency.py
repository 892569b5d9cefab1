"""Named locks: the port's copy of ``named_lock`` from the JAX package's
``analysis/concurrency.py``.

A named lock is a ``threading.Lock`` that carries the name it was made
under (``"hub.write"``, ``"compile_tracker.events"``), so a stack dump or a
lock's ``repr`` says which of the hub's locks a thread waits on. The JAX
package also feeds each transition to its lock-order recorder; that
recorder belongs to program analysis (ROADMAP item 21) and is not here.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class _NamedLock:
    """``acquire``/``release``/``locked`` and the context manager of a
    ``threading.Lock``, with a ``name``."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner: Optional[Any] = None):
        self.name = name
        self._inner = threading.Lock() if inner is None else inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._inner.acquire(blocking, timeout)

    def release(self) -> None:
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_NamedLock":
        self._inner.acquire()
        return self

    def __exit__(self, *exc_info) -> None:
        self._inner.release()

    def __repr__(self) -> str:
        state = "locked" if self.locked() else "unlocked"
        return f"<named_lock {self.name!r} {state}>"


def named_lock(name: str, inner: Optional[Any] = None) -> _NamedLock:
    """A lock (or ``inner`` wrapped) under ``name``."""
    return _NamedLock(name, inner)
