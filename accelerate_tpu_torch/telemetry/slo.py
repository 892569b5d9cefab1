"""SLO burn-rate monitoring over the request-trace stream.

Counterpart of ``accelerate_tpu/telemetry/slo.py``. An objective says what
fraction of requests (``target``) over a rolling window must be good: TTFT
under a threshold, latency under a threshold, the request not failing, the
handoff not falling back to re-prefill. The monitor classifies each
completed trace (``tracing.py``) against every objective, and
``evaluate()`` returns one record per objective (written as ``{"kind":
"slo"}`` when a telemetry sink is attached):

- ``bad_rate``: bad / observed in the window;
- ``budget``: the allowed bad fraction, ``1 - target``;
- ``burn_rate``: ``bad_rate / budget``; above 1.0 the objective is breached.

Per-replica accounting rides on :class:`~.serving.ServingStats`
(``slo_good_events`` / ``slo_bad_events``), which the fleet rollup sums:
rates are recomputed from merged sums, never averaged across replicas.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class SLObjective:
    """One declarative objective.

    ``metric`` selects the classifier:

    - ``"ttft"``     — good when the trace's ``ttft_s`` ≤ ``threshold_s``
      (a trace that never produced a first token is bad);
    - ``"latency"``  — good when ``latency_s`` ≤ ``threshold_s``;
    - ``"error_rate"`` — good unless the finish reason is ``failed`` or
      ``expired`` (cancellation is the client's choice, not a failure);
    - ``"handoff_fallback_rate"`` — good unless the trace carries a
      ``fell_back`` handoff outcome (the disagg ladder's last rung — the
      request completed, but the live-KV transfer did not).
    """

    name: str
    metric: str
    threshold_s: Optional[float] = None
    target: float = 0.99
    window_s: float = 60.0

    def __post_init__(self):
        if self.metric not in ("ttft", "latency", "error_rate", "handoff_fallback_rate"):
            raise ValueError(f"unknown SLO metric {self.metric!r}")
        if self.metric in ("ttft", "latency") and self.threshold_s is None:
            raise ValueError(f"SLO metric {self.metric!r} needs threshold_s=")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")

    def is_good(self, trace: dict) -> bool:
        if self.metric == "ttft":
            ttft = trace.get("ttft_s")
            return ttft is not None and ttft <= self.threshold_s
        if self.metric == "latency":
            latency = trace.get("latency_s")
            return latency is not None and latency <= self.threshold_s
        if self.metric == "error_rate":
            return trace.get("reason") not in ("failed", "expired")
        return not any(
            s.get("outcome") == "fell_back"
            for s in trace.get("spans", ())
            if s.get("kind") in ("handoff_attempt", "parked")
        )


def default_objectives(
    ttft_s: float = 60.0, window_s: float = 60.0
) -> list[SLObjective]:
    """The serve-bench defaults: TTFT p99-style objective (99% of requests
    under ``ttft_s`` — generous by default because CPU bench scale is slow),
    error rate under 1%, handoff fallback rate under 5%."""
    return [
        SLObjective("ttft", "ttft", threshold_s=ttft_s, target=0.99, window_s=window_s),
        SLObjective("errors", "error_rate", target=0.99, window_s=window_s),
        SLObjective(
            "handoff_fallbacks", "handoff_fallback_rate", target=0.95, window_s=window_s
        ),
    ]


class SLOMonitor:
    """Rolling-window burn-rate evaluation over completed traces.

    Attach to a :class:`~.tracing.RequestTracer` (``tracer.slo = monitor``,
    or the ``slo=`` constructor arg) and every retired trace flows through
    :meth:`observe`; call :meth:`evaluate` on whatever cadence the caller
    flushes telemetry (serve-bench does it once per sweep point)."""

    def __init__(self, objectives, telemetry: Any = None):
        self.objectives = list(objectives)
        if not self.objectives:
            raise ValueError("an SLO monitor needs at least one objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.telemetry = telemetry
        # per objective: (stamp, good) samples inside the rolling window,
        # plus all-time totals (the window forgets, the totals do not)
        self._windows: dict[str, deque] = {o.name: deque() for o in self.objectives}
        self.total_good: dict[str, int] = {o.name: 0 for o in self.objectives}
        self.total_bad: dict[str, int] = {o.name: 0 for o in self.objectives}
        self.breaches: dict[str, int] = {o.name: 0 for o in self.objectives}

    def observe(
        self, trace: dict, stats: Any = None, stamp: Optional[float] = None
    ) -> None:
        """Classify one completed trace against every objective. ``stats=``
        (the terminal replica's ServingStats) takes the per-replica
        good/bad counters the fleet rollup sums."""
        t = stamp if stamp is not None else time.perf_counter()
        for objective in self.objectives:
            good = objective.is_good(trace)
            self._windows[objective.name].append((t, good))
            if good:
                self.total_good[objective.name] += 1
            else:
                self.total_bad[objective.name] += 1
            if stats is not None:
                stats.record_slo_event(good)

    def _trim(self, objective: SLObjective, now: float) -> deque:
        window = self._windows[objective.name]
        horizon = now - objective.window_s
        while window and window[0][0] < horizon:
            window.popleft()
        return window

    def evaluate(self, stamp: Optional[float] = None) -> list[dict]:
        """One burn-rate record per objective over its current window,
        emitted as ``{"kind": "slo"}`` when a telemetry hub is attached.
        An empty window is reported with ``burn_rate`` None (no data is not
        the same claim as no burn)."""
        now = stamp if stamp is not None else time.perf_counter()
        records = []
        for objective in self.objectives:
            window = self._trim(objective, now)
            observed = len(window)
            bad = sum(1 for _, good in window if not good)
            budget = 1.0 - objective.target
            bad_rate = (bad / observed) if observed else None
            burn = (bad_rate / budget) if bad_rate is not None else None
            # strict float-tolerant ">": burning EXACTLY the budget is the
            # allowed rate, not a breach (and 0.1/(1-0.9) must not trip on
            # the representation error of 1-0.9)
            breached = burn is not None and burn > 1.0 + 1e-9
            if breached:
                self.breaches[objective.name] += 1
            record = {
                "objective": objective.name,
                "metric": objective.metric,
                "threshold_s": objective.threshold_s,
                "target": objective.target,
                "window_s": objective.window_s,
                "window_observed": observed,
                "window_bad": bad,
                "bad_rate": round(bad_rate, 6) if bad_rate is not None else None,
                "budget": round(budget, 6),
                "burn_rate": round(burn, 4) if burn is not None else None,
                "breached": breached,
            }
            records.append(record)
            if self.telemetry is not None:
                self.telemetry.write_record("slo", record)
        return records

    def snapshot(self) -> dict:
        """Flat all-time counters (the bench / metrics view)."""
        out = {}
        for objective in self.objectives:
            good = self.total_good[objective.name]
            bad = self.total_bad[objective.name]
            out[f"slo_{objective.name}_good"] = good
            out[f"slo_{objective.name}_bad"] = bad
            out[f"slo_{objective.name}_breaches"] = self.breaches[objective.name]
            if good + bad:
                out[f"slo_{objective.name}_bad_rate"] = round(bad / (good + bad), 6)
        return out


__all__ = ["SLObjective", "SLOMonitor", "default_objectives"]
