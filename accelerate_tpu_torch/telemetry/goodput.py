"""Goodput accounting: productive step time vs. everything else.

The port's copy of ``accelerate_tpu/telemetry/goodput.py``, unchanged but
for what feeds ``compile``.

Goodput = productive_time / (productive_time + lost_time) — the single number
that says whether fault-tolerance machinery pays for itself (the metric the
MPMD-pipeline literature optimises for, arXiv:2412.14374). The ledger's
categories match where production runs actually bleed time:

- ``checkpoint_save``      — atomic save protocol (stage + manifest + commit)
- ``checkpoint_restore``   — load_state on resume
- ``dataloader_rewind``    — skip_first_batches replaying consumed batches
- ``compile``              — kernel builds (nvcc, fed from CompileTracker)
- ``startup``              — process start → first training step (imports,
                             process group, rendezvous)
- ``guard_skipped``        — steps the numerical guard skipped (wall time
                             burned without advancing training; resilience)
- ``guard_restore``        — last-known-good restore after consecutive
                             non-finite steps (resilience/guards.py)
- ``elastic_reshard``      — in-memory host-loss recovery: reassembling
                             surviving/buddy shards, resharding onto the
                             shrunken mesh, and the regrow
                             (resilience/elastic.py)

Productive time comes from the StepTimer (measured window time extrapolated
over all steps), so the ratio needs no extra synchronization. The ledger is
host-local; the hub's flush aggregates min/max/mean across hosts.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

CATEGORIES = (
    "checkpoint_save",
    "checkpoint_restore",
    "dataloader_rewind",
    "compile",
    "startup",
    "guard_skipped",
    "guard_restore",
    "elastic_reshard",
)


class GoodputTracker:
    def __init__(self):
        self._lost: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self.restarts = 0  # resumes observed by THIS process (≥1 ⇒ run restarted)

    def record(self, category: str, seconds: float) -> None:
        self._lost[category] = self._lost.get(category, 0.0) + max(float(seconds), 0.0)
        self._counts[category] = self._counts.get(category, 0) + 1

    @contextmanager
    def timer(self, category: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.record(category, time.perf_counter() - start)

    def mark_restart(self) -> None:
        self.restarts += 1

    def lost_seconds(self, extra_compile_seconds: float = 0.0) -> float:
        # compile time the monitoring feed saw but nothing recorded here yet
        recorded_compile = self._lost.get("compile", 0.0)
        lost = sum(self._lost.values())
        if extra_compile_seconds > recorded_compile:
            lost += extra_compile_seconds - recorded_compile
        return lost

    def snapshot(self, productive_seconds: float, compile_seconds: float = 0.0) -> dict:
        lost = self.lost_seconds(compile_seconds)
        total = productive_seconds + lost
        overhead = {k: round(v, 4) for k, v in sorted(self._lost.items())}
        if compile_seconds > self._lost.get("compile", 0.0):
            overhead["compile"] = round(compile_seconds, 4)
        return {
            "productive_s": round(productive_seconds, 4),
            "lost_s": round(lost, 4),
            "overhead_s": overhead,
            "event_counts": dict(sorted(self._counts.items())),
            "restarts": self.restarts,
            "goodput": round(productive_seconds / total, 4) if total > 0 else None,
        }
