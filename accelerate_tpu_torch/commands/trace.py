"""`accelerate-tpu-torch trace`: request traces to Perfetto.

Counterpart of ``accelerate_tpu/commands/trace.py``, over the port's
``telemetry/tracing.py``. It reads the ``{"kind": "trace"}`` records a
traced serving run appended to ``telemetry.jsonl``
(``ServingEngine(tracer=...)``, ``ServingRouter(tracer=...)``,
``serve-bench --trace``) and writes Chrome trace-event JSON that
``https://ui.perfetto.dev`` loads: one swimlane group per replica, one lane
per request, spans for queued, prefill[i], parked, handoff_attempt[j],
decode and the terminal ``retired(reason)``. A handed-off request's spans
cross the prefill and decode pools' lanes under one trace id.

::

    accelerate-tpu-torch trace telemetry.jsonl --out trace.json
    accelerate-tpu-torch trace telemetry.jsonl --trace-id tr-1a2b-000003 --summary

``--summary`` also prints the slowest requests' top spans (the serve-bench
drill line's format).
"""

from __future__ import annotations

import json
import os


def register_subcommand(subparsers):
    parser = subparsers.add_parser(
        "trace", help="Export request traces from telemetry.jsonl to Perfetto JSON"
    )
    parser.add_argument(
        "path",
        help="telemetry.jsonl (or a directory containing one) from a traced run",
    )
    parser.add_argument(
        "--out", default="trace.json",
        help="Output Chrome/Perfetto trace-event JSON path (default: trace.json)",
    )
    parser.add_argument(
        "--trace-id", default=None, help="Export only this trace id"
    )
    parser.add_argument(
        "--request-id", type=int, default=None, help="Export only this request id"
    )
    parser.add_argument(
        "--summary", action="store_true",
        help="Also print the slowest requests' top spans by duration "
        "(the Perfetto JSON is still written to --out)",
    )
    parser.add_argument(
        "--top", type=int, default=10,
        help="How many slowest requests --summary prints (default: 10)",
    )
    parser.set_defaults(func=run)
    return parser


def load_trace_records(path: str) -> list[dict]:
    """Every ``{"kind": "trace"}`` record in a telemetry.jsonl (a directory
    resolves to the ``telemetry.jsonl`` inside it). Unparseable lines are
    skipped — a crashed run's torn last line must not block the export."""
    if os.path.isdir(path):
        path = os.path.join(path, "telemetry.jsonl")
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if record.get("kind") == "trace":
                records.append(record)
    return records


def run(args) -> int:
    from ..telemetry.tracing import to_perfetto, trace_summary

    try:
        records = load_trace_records(args.path)
    except OSError as error:
        print(f"cannot read {args.path}: {error}")
        return 1
    if args.trace_id is not None:
        records = [r for r in records if r.get("trace_id") == args.trace_id]
    if args.request_id is not None:
        records = [r for r in records if r.get("request_id") == args.request_id]
    if not records:
        print(
            "no {\"kind\": \"trace\"} records matched — was the run traced "
            "(serve-bench --trace, or ServingEngine(tracer=...))?"
        )
        return 1

    if args.summary:
        slowest = sorted(records, key=lambda r: -(r.get("latency_s") or 0.0))
        print(f"{len(records)} trace(s); slowest {min(args.top, len(slowest))}:")
        for record in slowest[: args.top]:
            print(f"  {trace_summary(record)}")

    payload = to_perfetto(records)
    with open(args.out, "w") as f:
        json.dump(payload, f)
    replicas = sum(1 for e in payload["traceEvents"] if e.get("name") == "process_name")
    print(
        f"wrote {args.out}: {len(records)} trace(s), "
        f"{len(payload['traceEvents'])} events across {replicas} replica lane(s) "
        "— open in https://ui.perfetto.dev"
    )
    return 0
