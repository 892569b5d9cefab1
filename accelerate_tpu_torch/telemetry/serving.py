"""Serving-side telemetry: per-request latency and engine utilization.

Counterpart of the ``ServingStats`` surface in
``accelerate_tpu/telemetry/serving.py`` that the paged engine feeds: time to
first token, per-step time, throughput, slot occupancy, the page economy,
the degradation counters (requeues, quarantine, watchdog trips, re-homed
requests), the parked/adopted handoff counters and the speculative-decoding
counters. The trace, SLO and fleet rollup parts, and the handoff transfer
ledger the router records, wait for ROADMAP item 14.
The engine's per-step host fetch of the sampled tokens is the timing fence,
so step durations are wall times with no extra synchronisation.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def _percentiles_ms(samples: list[float], prefix: str, qs=(50, 90, 99)) -> dict:
    if not samples:
        return {}
    arr = np.asarray(samples, np.float64) * 1e3
    return {f"{prefix}_p{q}_ms": float(np.percentile(arr, q)) for q in qs}


class ServingStats:
    """Accumulates engine-step and request-lifecycle samples."""

    def __init__(self, num_slots: int, num_pages: Optional[int] = None, page_size: Optional[int] = None):
        self.num_slots = num_slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.first_decode_at: Optional[float] = None
        self.steps = 0
        self.decode_seconds = 0.0
        self.step_seconds: list[float] = []  # wall time per decode step
        self.ttft_seconds: list[float] = []  # submit -> first token, per request
        self.latency_seconds: list[float] = []  # submit -> finish, per request
        self.tokens_generated = 0
        self.prefill_tokens = 0
        self.occupancy_sum = 0.0
        self.queue_depth_sum = 0.0
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_rejected = 0
        self.requests_expired = 0
        self.requests_cancelled = 0
        self.requests_failed = 0
        self.max_active = 0
        # degradation counters: every graceful-failure path is countable
        self.requests_requeued = 0
        self.requests_rehomed = 0  # drained out of this engine for another replica
        self.slot_quarantines = 0
        self.slot_quarantine_releases = 0
        self.watchdog_trips = 0
        # the handoff: parked/adopted count on the engine that did the work
        self.requests_parked = 0
        self.requests_adopted = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_reused = 0
        self.prefill_chunks = 0
        self.requests_preempted = 0
        self.cow_page_copies = 0
        self.page_pressure_events = 0
        self.page_occupancy_sum = 0.0
        self.peak_pages_in_use = 0
        self.last_pages_in_use = 0
        # speculative decoding: accepted lengths are raw per-step samples
        # (token counts, not seconds)
        self.spec_steps = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_fallbacks = 0
        self.spec_accepted_lengths: list[int] = []

    def record_submit(self) -> None:
        self.requests_submitted += 1

    def record_reject(self) -> None:
        self.requests_rejected += 1

    def record_expired(self) -> None:
        self.requests_expired += 1

    def record_cancelled(self) -> None:
        self.requests_cancelled += 1

    def record_requeue(self) -> None:
        self.requests_requeued += 1

    def record_rehomed(self) -> None:
        self.requests_rehomed += 1

    def record_quarantine(self) -> None:
        self.slot_quarantines += 1

    def record_quarantine_release(self) -> None:
        self.slot_quarantine_releases += 1

    def record_watchdog_trip(self) -> None:
        self.watchdog_trips += 1

    def record_parked(self) -> None:
        self.requests_parked += 1

    def record_adopted(self) -> None:
        self.requests_adopted += 1

    def record_failed(self) -> None:
        self.requests_failed += 1

    def record_prefill(self, span: int) -> None:
        self.prefill_tokens += span

    def record_prefill_chunk(self) -> None:
        self.prefill_chunks += 1

    def record_prefix_hit(self, tokens_reused: int) -> None:
        self.prefix_hits += 1
        self.prefix_tokens_reused += tokens_reused

    def record_prefix_miss(self) -> None:
        self.prefix_misses += 1

    def record_preempted(self) -> None:
        self.requests_preempted += 1

    def record_cow_copy(self) -> None:
        self.cow_page_copies += 1

    def record_page_pressure(self) -> None:
        self.page_pressure_events += 1

    def record_spec_step(self, proposed: int, accepted_lengths) -> None:
        """One speculative engine step: ``proposed`` draft tokens offered to
        the verifier and the per-slot accepted lengths."""
        self.spec_steps += 1
        self.spec_proposed_tokens += proposed
        self.spec_accepted_tokens += int(sum(accepted_lengths))
        self.spec_accepted_lengths.extend(int(a) for a in accepted_lengths)

    def record_spec_fallback(self) -> None:
        self.spec_fallbacks += 1

    def record_step(
        self,
        duration_s: float,
        active: int,
        waiting: int,
        tokens: Optional[int] = None,
        pages_in_use: Optional[int] = None,
    ) -> None:
        """One decode step: ``tokens`` delivered (defaults to ``active``),
        ``pages_in_use`` for the page economy."""
        if self.first_decode_at is None:
            self.first_decode_at = time.perf_counter() - duration_s
        self.steps += 1
        self.decode_seconds += duration_s
        self.step_seconds.append(duration_s)
        self.tokens_generated += active if tokens is None else tokens
        self.occupancy_sum += active / self.num_slots
        self.queue_depth_sum += waiting
        self.max_active = max(self.max_active, active)
        if pages_in_use is not None and self.num_pages:
            self.last_pages_in_use = pages_in_use
            self.peak_pages_in_use = max(self.peak_pages_in_use, pages_in_use)
            self.page_occupancy_sum += pages_in_use / max(self.num_pages - 1, 1)

    def record_first_token(self, ttft_s: float) -> None:
        self.ttft_seconds.append(ttft_s)

    def record_finish(self, latency_s: float) -> None:
        self.requests_completed += 1
        self.latency_seconds.append(latency_s)

    @property
    def elapsed_seconds(self) -> float:
        if self.first_decode_at is None:
            return 0.0
        return time.perf_counter() - self.first_decode_at

    @property
    def throughput_tokens_per_sec(self) -> float:
        elapsed = self.elapsed_seconds
        return self.tokens_generated / elapsed if elapsed > 0 else 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0

    def snapshot(self) -> dict:
        """Flat scalar metrics, keyed as in the JAX package's snapshot."""
        out = {
            "num_slots": self.num_slots,
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "prefill_tokens": self.prefill_tokens,
            "requests_submitted": self.requests_submitted,
            "requests_completed": self.requests_completed,
            "requests_rejected": self.requests_rejected,
            "requests_expired": self.requests_expired,
            "requests_cancelled": self.requests_cancelled,
            "requests_requeued": self.requests_requeued,
            "requests_failed": self.requests_failed,
            "requests_rehomed": self.requests_rehomed,
            "slot_quarantines": self.slot_quarantines,
            "slot_quarantine_releases": self.slot_quarantine_releases,
            "watchdog_trips": self.watchdog_trips,
            "requests_parked": self.requests_parked,
            "requests_adopted": self.requests_adopted,
            "throughput_tokens_per_sec": self.throughput_tokens_per_sec,
            "slot_occupancy": self.mean_occupancy,
            "max_active_slots": self.max_active,
        }
        if self.steps:
            out["queue_depth_mean"] = self.queue_depth_sum / self.steps
            out["decode_seconds"] = self.decode_seconds
        if self.num_pages:
            looked_up = self.prefix_hits + self.prefix_misses
            out.update(
                num_pages=self.num_pages,
                page_size=self.page_size,
                pages_in_use=self.last_pages_in_use,
                peak_pages_in_use=self.peak_pages_in_use,
                prefix_hits=self.prefix_hits,
                prefix_misses=self.prefix_misses,
                prefix_tokens_reused=self.prefix_tokens_reused,
                prefix_hit_rate=self.prefix_hits / looked_up if looked_up else 0.0,
                prefill_chunks=self.prefill_chunks,
                requests_preempted=self.requests_preempted,
                cow_page_copies=self.cow_page_copies,
                page_pressure_events=self.page_pressure_events,
            )
            if self.steps:
                out["page_occupancy"] = self.page_occupancy_sum / self.steps
        out.update(
            spec_steps=self.spec_steps,
            spec_proposed_tokens=self.spec_proposed_tokens,
            spec_accepted_tokens=self.spec_accepted_tokens,
            spec_fallbacks=self.spec_fallbacks,
        )
        if self.spec_accepted_lengths:
            # token counts, not durations: percentiles taken directly
            arr = np.asarray(self.spec_accepted_lengths, np.float64)
            out["spec_accepted_len_p50"] = round(float(np.percentile(arr, 50)), 3)
            out["spec_accepted_len_p99"] = round(float(np.percentile(arr, 99)), 3)
        out.update(_percentiles_ms(self.step_seconds, "per_token"))
        out.update(_percentiles_ms(self.ttft_seconds, "ttft"))
        out.update(_percentiles_ms(self.latency_seconds, "request_latency"))
        return out
