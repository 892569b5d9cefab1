"""Offered-load generation for serving benchmarks.

Counterpart of ``accelerate_tpu/serving/loadgen.py``. Replays a request
trace against a :class:`~.engine.ServingEngine` or a
:class:`~.router.ServingRouter` (the same surface) at a fixed offered rate
(requests a second, ``inf`` = all at once, uniform spacing) or at explicit
arrival times (:func:`make_burst_trace`, :func:`make_diurnal_trace`),
stepping the target between arrivals.

A shed arrival (:class:`~.scheduler.QueueFull`) is a well-behaved client:
it backs off by the quote's ``retry_after_s``, jittered from the seeded
generator, and re-offers the request then, backdated to its intended
arrival so the queue wait lands in TTFT. Sheds and retries are counted
apart: at drain time ``sheds == retries`` and ``completed == offered``
unless something was lost.
"""

from __future__ import annotations

import heapq
import math
import time
from typing import Optional, Sequence

import numpy as np

from .scheduler import QueueFull


def make_prompts(
    n: int, vocab_size: int, min_len: int, max_len: int, seed: int = 0
) -> list[np.ndarray]:
    """Deterministic mixed-length prompt trace (uniform lengths)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, n)
    return [rng.integers(0, vocab_size, (int(s),)).astype(np.int32) for s in lens]


def make_mixed_prompts(
    n: int,
    vocab_size: int,
    min_len: int,
    max_len: int,
    long_fraction: float = 0.1,
    long_multiplier: int = 8,
    shared_prefix: int = 0,
    seed: int = 0,
) -> list[np.ndarray]:
    """The ROADMAP's gating trace: mostly-short traffic with a long-prompt
    tail, optionally behind a fleet-wide system prompt.

    ``long_fraction`` of the prompts stretch to ``long_multiplier``–
    ``2×long_multiplier`` times the median short length — the arrival that
    stalls every admitted request's decode behind a monolithic prefill, and
    exactly what chunked prefill (``prefill_chunk``) exists to absorb.
    ``shared_prefix`` prepends the SAME ``shared_prefix`` tokens to every
    prompt (one deterministic system prompt per seed), so a paged engine
    with prefix sharing prefills it once and every later request forks its
    pages; the dense engine re-prefills it per request. Long positions are
    interleaved deterministically across the trace (not clustered at the
    end) so a sweep at any offered rate meets the long tail mid-stream."""
    if not 0.0 <= long_fraction <= 1.0:
        raise ValueError(f"long_fraction must be in [0, 1], got {long_fraction}")
    rng = np.random.default_rng(seed)
    median = (min_len + max_len) // 2
    prompts: list[np.ndarray] = []
    n_long = int(round(n * long_fraction))
    # spread long arrivals evenly through the trace: a long prompt mid-burst
    # is the TTFT-spike scenario, a trailing cluster is not
    long_at = set(np.linspace(0, n - 1, n_long, dtype=int).tolist()) if n_long else set()
    prefix = (
        rng.integers(0, vocab_size, (shared_prefix,)).astype(np.int32)
        if shared_prefix > 0
        else None
    )
    for i in range(n):
        if i in long_at:
            s = int(rng.integers(long_multiplier * median, 2 * long_multiplier * median + 1))
        else:
            s = int(rng.integers(min_len, max_len + 1))
        body = rng.integers(0, vocab_size, (s,)).astype(np.int32)
        prompts.append(body if prefix is None else np.concatenate([prefix, body]))
    return prompts


def make_burst_trace(
    n: int,
    base_rps: float,
    burst_multiplier: float = 4.0,
    burst_fraction: float = 0.5,
    seed: int = 0,
) -> list[float]:
    """Poisson arrival trace with a flash crowd in the middle.

    Arrivals are a Poisson process (i.i.d. exponential gaps — the honest
    model of independent clients, and burstier at every timescale than the
    uniform spacing ``offered_rps`` produces). The middle ``burst_fraction``
    of the requests arrive at ``burst_multiplier × base_rps``; the head and
    tail at ``base_rps``. That is the autoscaler's drill: steady traffic the
    fixed fleet shape handles, then an offered rate it cannot serve, then
    steady again — so the trace exercises both the scale-up trigger and the
    scale-down (or hold, under hysteresis) after the wave passes. Returns
    strictly increasing arrival times in seconds for
    ``run_offered_load(..., arrival_times=...)``."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    if base_rps <= 0:
        raise ValueError(f"base_rps must be positive, got {base_rps}")
    if burst_multiplier < 1.0:
        raise ValueError(f"burst_multiplier must be >= 1, got {burst_multiplier}")
    if not 0.0 <= burst_fraction <= 1.0:
        raise ValueError(f"burst_fraction must be in [0, 1], got {burst_fraction}")
    rng = np.random.default_rng(seed)
    lo = int(round(n * (1.0 - burst_fraction) / 2.0))
    hi = n - lo
    times: list[float] = []
    t = 0.0
    for i in range(n):
        rate = base_rps * (burst_multiplier if lo <= i < hi else 1.0)
        t += float(rng.exponential(1.0 / rate))
        times.append(t)
    return times


def make_diurnal_trace(
    n: int,
    base_rps: float,
    period_s: float = 10.0,
    amplitude: float = 0.5,
    seed: int = 0,
) -> list[float]:
    """Sinusoidal-rate Poisson arrivals: a compressed diurnal cycle.

    The instantaneous rate is ``base_rps × (1 + amplitude·sin(2πt/period_s))``
    — peaks at ``(1+amplitude)×base``, troughs at ``(1-amplitude)×base`` —
    sampled by thinning-free inversion: each gap is drawn exponential at the
    CURRENT rate, which is exact in the limit of gaps short against the
    period and plenty for a drill whose period spans many arrivals. This is
    the slow-swing complement to :func:`make_burst_trace`: rate change the
    hysteresis deadband should RIDE THROUGH without flapping the fleet
    shape. ``amplitude`` must stay below 1 (rate must remain positive).
    Returns strictly increasing arrival times in seconds."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    if base_rps <= 0:
        raise ValueError(f"base_rps must be positive, got {base_rps}")
    if period_s <= 0:
        raise ValueError(f"period_s must be positive, got {period_s}")
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    rng = np.random.default_rng(seed)
    times: list[float] = []
    t = 0.0
    for _ in range(n):
        rate = base_rps * (1.0 + amplitude * math.sin(2.0 * math.pi * t / period_s))
        t += float(rng.exponential(1.0 / rate))
        times.append(t)
    return times


def _percentile_ms(values: list[float], q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values), q)) * 1e3


def run_offered_load(
    engine,
    prompts: Sequence[np.ndarray],
    max_new_tokens: int,
    offered_rps: float = math.inf,
    backoff_jitter: float = 0.25,
    min_backoff_s: float = 0.005,
    seed: int = 0,
    arrival_times: Optional[Sequence[float]] = None,
    deadline_s: Optional[float] = None,
) -> dict:
    """Submit ``prompts`` at ``offered_rps`` and drive the engine dry.

    Returns the engine's ``metrics()`` snapshot plus the offered rate,
    completed-request count, and the loadgen's own ledger: shed/retry
    counts, client-observed TTFT and latency percentiles (measured from the
    results the engine hands back — the numbers a caller would see, not the
    engine's internal books), and the finish-reason histogram. A
    ``QueueFull`` arrival is re-offered after a jittered backoff of the
    exception's ``retry_after_s`` hint (never immediately — hammering a full
    queue just measures the shed path), and the eventual submit is backdated
    to the INTENDED arrival time so backlog wait shows up in TTFT, which is
    the honest place for it.

    ``arrival_times`` replaces the uniform spacing with an explicit trace
    (seconds, non-decreasing, one per prompt) — the escape hatch
    :func:`make_burst_trace` and :func:`make_diurnal_trace` feed.
    ``deadline_s`` stamps every request with a completion deadline; against
    a router with deadline-aware admission, hopeless arrivals shed EARLY
    (before burning a prefill) and the early sheds show up in this ledger
    as retries like any other shed — the accounting stays exact either way.
    """
    if arrival_times is not None:
        if len(arrival_times) != len(prompts):
            raise ValueError(
                f"arrival_times has {len(arrival_times)} entries for "
                f"{len(prompts)} prompts — one arrival per prompt"
            )
        arrivals = [float(at) for at in arrival_times]
        if any(b < a for a, b in zip(arrivals, arrivals[1:])):
            raise ValueError("arrival_times must be non-decreasing")
    else:
        arrivals = [
            0.0 if math.isinf(offered_rps) else i / offered_rps for i in range(len(prompts))
        ]
    rng = np.random.default_rng(seed)
    # (offer_time, index, attempt): a heap, because backoffs reorder arrivals
    ready: list[tuple[float, int, int]] = [(at, i, 0) for i, at in enumerate(arrivals)]
    heapq.heapify(ready)
    t0 = time.perf_counter()
    completed = 0
    sheds = 0  # QueueFull events absorbed by backoff
    retries = 0  # re-offers (each shed schedules exactly one)
    ttfts: list[float] = []
    latencies: list[float] = []
    reasons: dict[str, int] = {}

    def _ledger(results) -> int:
        nonlocal completed
        for result in results:
            completed += 1
            reasons[result.finish_reason] = reasons.get(result.finish_reason, 0) + 1
            if result.ttft_s is not None:
                ttfts.append(result.ttft_s)
            if result.latency_s is not None:
                latencies.append(result.latency_s)
        return completed

    while ready or engine.busy:
        now = time.perf_counter() - t0
        while ready and ready[0][0] <= now:
            _, idx, attempt = heapq.heappop(ready)
            if attempt:
                retries += 1
            try:
                engine.submit(
                    prompts[idx],
                    max_new_tokens,
                    submitted_at=t0 + arrivals[idx],
                    deadline_s=deadline_s,
                )
            except QueueFull as e:
                sheds += 1
                hint = e.retry_after_s if e.retry_after_s else min_backoff_s
                delay = max(hint, min_backoff_s) * (
                    1.0 + backoff_jitter * (2.0 * float(rng.random()) - 1.0)
                )
                heapq.heappush(ready, (now + delay, idx, attempt + 1))
        if engine.busy:
            _ledger(engine.step())
        elif ready:
            time.sleep(min(max(ready[0][0] - now, 0.0), 0.05))
    out = engine.metrics()
    out["offered_rps"] = (
        None if arrival_times is not None or math.isinf(offered_rps) else offered_rps
    )
    out["offered_requests"] = len(prompts)
    out["requests_completed"] = completed
    out["loadgen_sheds"] = sheds
    out["loadgen_retries"] = retries
    out["loadgen_ttft_p50_ms"] = _percentile_ms(ttfts, 50)
    out["loadgen_ttft_p99_ms"] = _percentile_ms(ttfts, 99)
    out["loadgen_latency_p50_ms"] = _percentile_ms(latencies, 50)
    out["loadgen_latency_p99_ms"] = _percentile_ms(latencies, 99)
    out["loadgen_finish_reasons"] = dict(sorted(reasons.items()))
    return out


__all__ = [
    "make_burst_trace",
    "make_diurnal_trace",
    "make_mixed_prompts",
    "make_prompts",
    "run_offered_load",
]
