"""Compile-event capture.

Counterpart of ``accelerate_tpu/telemetry/compile_tracker.py``. What a
"compile" is differs between the two packages: the JAX package counts XLA
compilations; the port runs eagerly and has no ``torch.compile``, so its
only compiles are the ``nvcc`` builds of the kernel sources at their first
use (``ops/runtime.py`` ``build_kernel``). Each feeds the same snapshot keys:

- an ``nvcc`` build is one compile (``compile_count``, ``compile_seconds``,
  under the event name :data:`BACKEND_COMPILE_EVENT`) and one cache miss,
  its seconds also in ``jit_cache_build_seconds``;
- loading a library already built under ``_build/`` (by an earlier process,
  or another source's build in this one) is a cache hit.

A process loads each library once, so a steady-state step compiles
nothing; a compile record after the first step names a kernel built late
(a path first reached mid-run). The runtime has one hook
(``ops.runtime.build_event_hook``); this module installs ONE dispatcher
(lazily, once) that fans out to the active trackers through a weak set, so
trackers start and stop freely.
"""

from __future__ import annotations

import weakref
from typing import Any

from ..utils.concurrency import named_lock

BACKEND_COMPILE_EVENT = "/accelerate_tpu_torch/kernel/nvcc_build_duration"

_active_trackers: "weakref.WeakSet[CompileTracker]" = weakref.WeakSet()
_dispatcher_installed = False
_install_lock = named_lock("compile_tracker.install")


def _dispatch_build_event(event: str, key: Any) -> None:
    for tracker in list(_active_trackers):
        if event == "build":
            tracker._on_event(BACKEND_COMPILE_EVENT, key[1])
        tracker._on_cache_event(event, key)


def _install_dispatcher() -> None:
    global _dispatcher_installed
    with _install_lock:
        if _dispatcher_installed:
            return
        from ..ops import runtime

        runtime.build_event_hook = _dispatch_build_event
        _dispatcher_installed = True


class CompileTracker:
    """Accumulates build counts/durations and build-cache hit/miss counts.

    Thread-safe: kernels may first be built from another thread (autograd's
    backward, a serving watchdog)."""

    def __init__(self):
        self._lock = named_lock("compile_tracker.events")
        self._events: dict[str, list] = {}  # name -> [count, total_seconds]
        self.cache_hits = 0
        self.cache_misses = 0
        # which kernel sources missed (bounded ring)
        self.recent_miss_keys: list[str] = []
        self.cache_build_seconds = 0.0
        self._active = False

    def start(self) -> "CompileTracker":
        _install_dispatcher()
        self._active = True
        _active_trackers.add(self)
        return self

    def stop(self) -> None:
        self._active = False
        _active_trackers.discard(self)

    def __enter__(self) -> "CompileTracker":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    # -- event intake --------------------------------------------------------

    def _on_event(self, event: str, duration: float) -> None:
        if not self._active:
            return
        with self._lock:
            entry = self._events.setdefault(event, [0, 0.0])
            entry[0] += 1
            entry[1] += float(duration)

    def _on_cache_event(self, event: str, key: Any = None) -> None:
        if not self._active:
            return
        with self._lock:
            if event == "hit":
                self.cache_hits += 1
            elif event == "miss":
                self.cache_misses += 1
                self.recent_miss_keys.append(repr(key)[:200])
                if len(self.recent_miss_keys) > 8:
                    self.recent_miss_keys.pop(0)
            elif event == "build":
                self.cache_build_seconds += float(key[1])

    # -- readout -------------------------------------------------------------

    @property
    def compile_count(self) -> int:
        with self._lock:
            return self._events.get(BACKEND_COMPILE_EVENT, [0, 0.0])[0]

    @property
    def compile_seconds(self) -> float:
        with self._lock:
            return self._events.get(BACKEND_COMPILE_EVENT, [0, 0.0])[1]

    def snapshot(self) -> dict:
        with self._lock:
            events = {
                name: {"count": count, "seconds": round(seconds, 4)}
                for name, (count, seconds) in sorted(self._events.items())
            }
            backend = self._events.get(BACKEND_COMPILE_EVENT, [0, 0.0])
            return {
                "compile_count": backend[0],
                "compile_seconds": round(backend[1], 4),
                "jit_cache_hits": self.cache_hits,
                "jit_cache_misses": self.cache_misses,
                "jit_cache_build_seconds": round(self.cache_build_seconds, 4),
                "recent_miss_keys": list(self.recent_miss_keys),
                "events": events,
            }
