"""Request-scoped tracing for the serving fleet.

Counterpart of ``accelerate_tpu/telemetry/tracing.py``: where did one
request's latency go (queue wait, prefill chunks, parked KV, handoff
attempts, decode), now that a request can cross replicas and pools.

One :class:`RequestTracer` is shared by every engine and the router of a
fleet, so a request that crosses replicas keeps one trace: spans are keyed
by the fleet-unique request id, and each carries the name of the replica
that did the work. The spans:

========================  ====================================================
span                      covers
========================  ====================================================
``queued``                submit → admission (re-opened on requeue/failover —
                          a re-homed request honestly waits again)
``admitted``              instant: a lane + first-span pages were claimed
``prefill[i]``            one prefill program span (chunked prefill: one per
                          chunk; monolithic: one total), dispatch → the step
                          fence that sequences after it
``parked``                prefill-only KV parked for handoff → released /
                          adopted / resumed / lost with its replica
``handoff_attempt[j]``    one live-KV transfer attempt, with ``outcome``
                          adopted / retried / fell_back / deferred
``decode``                decode-visible → retirement; step-granular marks
                          are SAMPLED on the tracer cadence (never an extra
                          per-step host sync — the decode fence the engine
                          already pays is the only timestamp source)
``draft[i]``              one SAMPLED speculative-draft window: the draft
                          model proposing k candidates for this request,
                          chain dispatch → last draft-step fence
``verify[i]``             the paired one-step target verification of that
                          window; carries ``proposed`` / ``accepted`` /
                          ``emitted`` so per-request acceptance is readable
                          straight off the trace
``first_token``           instant: TTFT boundary
``retired``               instant, terminal: carries the finish reason, which
                          must equal the engine's ``finish_reason``
========================  ====================================================

Timestamps are host-clock ``time.perf_counter()`` reads at points the
engine already synchronizes: submission, admission, park, retirement and
handoff boundaries, and the per-step fetch of the sampled tokens (the
decode fence). The tracer adds no device work and no synchronization of
its own; decode marks are sampled every ``sample_every`` steps from the
fence the engine already paid.

A completed trace is written as one ``{"kind": "trace"}`` record when a
telemetry sink is attached, and feeds the SLO monitor (``slo.py``) when one
is attached; :func:`to_perfetto` exports the records as Chrome/Perfetto
trace-event JSON.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Any, Optional

# span kinds that are always indexed (several per trace is the normal case:
# one per prefill chunk, one per handoff attempt, one per sampled
# draft/verify window); other kinds index only their repeats (a queued[1]
# after a failover re-home)
_INDEXED_KINDS = ("prefill", "handoff_attempt", "draft", "verify")

# trace-id sequence, PROCESS-wide: two tracers sharing one telemetry hub
# (an engine's and a router's, or two fleets) must never mint the same id —
# a per-instance counter would emit colliding tr-<pid>-000000 from each and
# a lookup by trace id would merge two unrelated requests
_trace_seq = itertools.count()

# finish reasons that END a trace. "prefilled" is deliberately absent: a
# prefill-pool engine parking KV for handoff is an internal hop, and the
# trace stays open until the request terminates somewhere in the fleet.
TERMINAL_REASONS = ("eos", "length", "expired", "cancelled", "failed")


class Trace:
    """One request's span tree, accumulated across every replica it visits."""

    __slots__ = ("trace_id", "request_id", "t0", "spans", "_open", "_counts", "meta")

    def __init__(self, trace_id: str, request_id: int, t0: float, meta: dict):
        self.trace_id = trace_id
        self.request_id = request_id
        self.t0 = t0
        self.spans: list[dict] = []
        self._open: dict[str, dict] = {}  # kind -> the span still running
        self._counts: dict[str, int] = {}
        self.meta = meta


class RequestTracer:
    """Fleet-wide span collection, keyed by request id.

    Every method is a cheap host-side no-op for ids it never saw (engine
    warmup probes, chaos bursts) — the tracer only follows requests that
    went through ``begin()``, which engines call at submit (outside warmup)
    and which is idempotent per id, so the router and N engines sharing one
    tracer cannot double-open a trace.

    ``telemetry=`` flushes each completed trace as a ``{"kind": "trace"}``
    record; ``slo=`` feeds an :class:`~.slo.SLOMonitor`; ``keep`` bounds the
    in-memory ring of completed traces (the exporter's and serve-bench's
    source). ``sample_every`` is the decode-mark cadence engines consult —
    the tracer never forces a fence of its own.
    """

    def __init__(
        self,
        telemetry: Any = None,
        sample_every: int = 16,
        keep: int = 4096,
        slo: Any = None,
    ):
        self.telemetry = telemetry
        self.sample_every = max(int(sample_every), 1)
        self.slo = slo
        self.completed: deque[dict] = deque(maxlen=keep)
        self.traces_started = 0
        self.traces_completed = 0
        self._traces: dict[int, Trace] = {}

    # -- lifecycle -----------------------------------------------------------

    def begin(
        self,
        request_id: int,
        stamp: Optional[float] = None,
        **meta,
    ) -> str:
        """Open (or return) the trace for ``request_id``. Idempotent: in a
        routed fleet the first engine to see the id wins and every later
        ``begin`` (failover re-submit, adopt) joins the existing trace."""
        trace = self._traces.get(request_id)
        if trace is not None:
            return trace.trace_id
        t0 = stamp if stamp is not None else time.perf_counter()
        trace_id = f"tr-{os.getpid():x}-{next(_trace_seq):06x}"
        self._traces[request_id] = Trace(trace_id, request_id, t0, meta)
        self.traces_started += 1
        return trace_id

    def has(self, request_id: int) -> bool:
        return request_id in self._traces

    def trace_id(self, request_id) -> Optional[str]:
        """The open trace's id for a request, else None — the value threaded
        into ``{"kind": "resilience"}`` / handoff records so one grep of
        the records reconstructs a request's full story."""
        if request_id is None:
            return None
        trace = self._traces.get(request_id)
        return trace.trace_id if trace is not None else None

    @property
    def open_count(self) -> int:
        """Traces begun but not yet retired — must be 0 after a fleet drain
        (the exact-accounting invariant: no orphan span trees)."""
        return len(self._traces)

    # -- spans ---------------------------------------------------------------

    def _name(self, trace: Trace, kind: str) -> str:
        idx = trace._counts.get(kind, 0)
        trace._counts[kind] = idx + 1
        if kind in _INDEXED_KINDS or idx:
            return f"{kind}[{idx}]"
        return kind

    def span_start(
        self,
        request_id: int,
        kind: str,
        stamp: Optional[float] = None,
        replica: Optional[str] = None,
        **args,
    ) -> None:
        """Open one span. A span of ``kind`` already open for the request is
        left alone (e.g. a drained request re-queued elsewhere is still in
        its one honest ``queued`` span)."""
        trace = self._traces.get(request_id)
        if trace is None or kind in trace._open:
            return
        span = {
            "name": self._name(trace, kind),
            "kind": kind,
            "t0": stamp if stamp is not None else time.perf_counter(),
            "t1": None,
        }
        if replica is not None:
            span["replica"] = replica
        span.update(args)
        trace._open[kind] = span
        trace.spans.append(span)

    def span_end(
        self,
        request_id: int,
        kind: str,
        stamp: Optional[float] = None,
        stats: Any = None,
        **args,
    ) -> Optional[float]:
        """Close the open ``kind`` span; returns its duration (None when
        nothing was open). ``stats=`` additionally records the duration as a
        raw sample on that replica's :class:`~.serving.ServingStats`, which
        is what the fleet rollup merges percentiles from."""
        trace = self._traces.get(request_id)
        if trace is None:
            return None
        span = trace._open.pop(kind, None)
        if span is None:
            return None
        span["t1"] = stamp if stamp is not None else time.perf_counter()
        span.update(args)
        duration = span["t1"] - span["t0"]
        if stats is not None:
            stats.record_span(kind, duration)
        return duration

    def event(
        self,
        request_id: int,
        kind: str,
        stamp: Optional[float] = None,
        replica: Optional[str] = None,
        **args,
    ) -> None:
        """A zero-duration span (instant): admitted, first_token, ..."""
        trace = self._traces.get(request_id)
        if trace is None:
            return
        t = stamp if stamp is not None else time.perf_counter()
        span = {"name": self._name(trace, kind), "kind": kind, "t0": t, "t1": t}
        if replica is not None:
            span["replica"] = replica
        span.update(args)
        trace.spans.append(span)

    def mark_decode(self, request_id: int, step: int, stamp: float) -> None:
        """One SAMPLED step-boundary mark inside the open decode span — the
        engine calls this on the tracer cadence with the fence stamp it
        already paid for, so decode gets step-granular boundaries without a
        single extra host sync."""
        trace = self._traces.get(request_id)
        if trace is None:
            return
        span = trace._open.get("decode")
        if span is None:
            return
        span.setdefault("marks", []).append({"step": step, "t": stamp})

    def interrupt(
        self, request_id: int, stamp: Optional[float] = None, **args
    ) -> None:
        """Close every open span without retiring the trace — the request's
        current residence ended abruptly (replica death, quarantine requeue,
        page-pressure preemption) and its next spans happen elsewhere."""
        trace = self._traces.get(request_id)
        if trace is None:
            return
        t = stamp if stamp is not None else time.perf_counter()
        for span in trace._open.values():
            span["t1"] = t
            span.update(args)
        trace._open.clear()

    # -- completion ----------------------------------------------------------

    def retire(
        self,
        request_id: int,
        reason: str,
        stamp: Optional[float] = None,
        stats: Any = None,
        replica: Optional[str] = None,
        observe_slo: bool = True,
        **args,
    ) -> Optional[dict]:
        """Terminal: close every open span, append the ``retired`` instant
        (whose ``reason`` is the engine's ``finish_reason``), flush the
        completed record, and feed the SLO monitor. Exactly-once by
        construction — the trace is popped, so a second retire for the same
        id is a no-op and no request can ever own two span trees.

        ``observe_slo=False`` keeps the trace out of SLO classification —
        for infrastructure traces (an autoscale role flip's ``role_flip``
        span) that are not requests: grading one against a TTFT objective
        would burn error budget on a trace that never had a first token."""
        trace = self._traces.pop(request_id, None)
        if trace is None:
            return None
        t = stamp if stamp is not None else time.perf_counter()
        for kind, span in list(trace._open.items()):
            span["t1"] = t
            if stats is not None:
                stats.record_span(kind, span["t1"] - span["t0"])
        trace._open.clear()
        retired = {"name": "retired", "kind": "retired", "t0": t, "t1": t,
                   "reason": reason}
        if replica is not None:
            retired["replica"] = replica
        retired.update(args)
        trace.spans.append(retired)
        ttft = next(
            (s["t0"] - trace.t0 for s in trace.spans if s["kind"] == "first_token"),
            None,
        )
        record = {
            "trace_id": trace.trace_id,
            "request_id": trace.request_id,
            "reason": reason,
            "t0": trace.t0,
            "t1": t,
            "latency_s": round(t - trace.t0, 6),
            "ttft_s": round(ttft, 6) if ttft is not None else None,
            "spans": [
                {
                    **span,
                    "dur_s": round(span["t1"] - span["t0"], 6)
                    if span["t1"] is not None
                    else None,
                }
                for span in trace.spans
            ],
            **trace.meta,
        }
        self.traces_completed += 1
        self.completed.append(record)
        if stats is not None:
            stats.record_trace_completed()
        if self.telemetry is not None:
            self.telemetry.write_record("trace", record)
        if self.slo is not None and observe_slo:
            self.slo.observe(record, stats=stats, stamp=t)
        return record


# -- Perfetto / Chrome trace-event export -------------------------------------


def trace_summary(record: dict, top: int = 3) -> str:
    """One human line for a trace: the top ``top`` spans by duration — the
    serve-bench drill line's "where did the failed-over request spend its
    budget". Instants (retired, admitted) are skipped; replica names ride
    along so a cross-pool trace reads as one story."""
    spans = [
        s for s in record.get("spans", [])
        if s.get("dur_s") and s["kind"] != "retired"
    ]
    spans.sort(key=lambda s: -s["dur_s"])
    parts = []
    for span in spans[:top]:
        where = f"@{span['replica']}" if span.get("replica") else ""
        outcome = f"({span['outcome']})" if span.get("outcome") else ""
        parts.append(f"{span['name']}{outcome}{where} {span['dur_s'] * 1e3:.1f}ms")
    return (
        f"request {record['request_id']} [{record['trace_id']}] "
        f"{record['reason']} in {record['latency_s'] * 1e3:.1f}ms: "
        + (", ".join(parts) if parts else "no timed spans")
    )


def to_perfetto(records: list[dict]) -> dict:
    """Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto legacy
    format, which Perfetto's UI loads directly) from ``{"kind": "trace"}``
    records.

    Layout: one "process" per replica (named, so the prefill and decode
    pools are separate swimlane groups and a handed-off request visibly
    crosses them), one "thread" per request within it. Spans are complete
    ``"X"`` events carrying ``trace_id`` in args; sampled decode marks are
    instant ``"i"`` events. Timestamps are microseconds relative to the
    earliest trace start, which keeps the numbers small and the viewer
    happy whatever ``perf_counter``'s epoch was."""
    events: list[dict] = []
    if not records:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    base = min(r["t0"] for r in records)
    replicas = sorted(
        {s.get("replica") or "engine" for r in records for s in r.get("spans", [])}
    )
    pid_of = {name: i + 1 for i, name in enumerate(replicas)}
    for name, pid in pid_of.items():
        events.append(
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": name}}
        )
    for lane, record in enumerate(sorted(records, key=lambda r: r["t0"])):
        tid = lane + 1
        seen_pids = set()
        for span in record.get("spans", []):
            pid = pid_of[span.get("replica") or "engine"]
            if pid not in seen_pids:
                seen_pids.add(pid)
                events.append(
                    {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                     "args": {"name": f"req {record['request_id']} "
                                      f"[{record['trace_id']}]"}}
                )
            ts = (span["t0"] - base) * 1e6
            args = {
                k: v for k, v in span.items()
                if k not in ("name", "kind", "t0", "t1", "dur_s", "marks")
            }
            args["trace_id"] = record["trace_id"]
            args["request_id"] = record["request_id"]
            name = span["name"]
            if span["kind"] == "retired":
                name = f"retired({span.get('reason', '?')})"
            elif span.get("outcome"):
                name = f"{name}({span['outcome']})"
            if span["t1"] is not None and span["t1"] > span["t0"]:
                events.append(
                    {"ph": "X", "name": name, "cat": span["kind"], "ts": ts,
                     "dur": (span["t1"] - span["t0"]) * 1e6, "pid": pid,
                     "tid": tid, "args": args}
                )
            else:
                events.append(
                    {"ph": "i", "s": "t", "name": name, "cat": span["kind"],
                     "ts": ts, "pid": pid, "tid": tid, "args": args}
                )
            for mark in span.get("marks", ()):
                events.append(
                    {"ph": "i", "s": "t", "name": f"decode step {mark['step']}",
                     "cat": "decode_mark", "ts": (mark["t"] - base) * 1e6,
                     "pid": pid, "tid": tid,
                     "args": {"trace_id": record["trace_id"]}}
                )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


__all__ = [
    "RequestTracer",
    "TERMINAL_REASONS",
    "Trace",
    "to_perfetto",
    "trace_summary",
]
