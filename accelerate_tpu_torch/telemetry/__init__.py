"""Serving telemetry of the port: the engines' statistics and their fleet
rollup, request tracing with its Perfetto export, and SLO burn rates. The
telemetry hub and the training trackers come with ROADMAP item 19."""

from .serving import ServingStats, fleet_rollup
from .slo import SLObjective, SLOMonitor, default_objectives
from .tracing import RequestTracer, to_perfetto, trace_summary

__all__ = [
    "RequestTracer",
    "SLOMonitor",
    "SLObjective",
    "ServingStats",
    "default_objectives",
    "fleet_rollup",
    "to_perfetto",
    "trace_summary",
]
