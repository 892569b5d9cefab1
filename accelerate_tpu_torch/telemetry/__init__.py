"""Telemetry of the port: step-time/goodput metrics, kernel-build tracking,
memory watermarks, throughput/MFU derivation, profiler windows, and the
serving side (the engines' statistics and their fleet rollup, request
tracing with its Perfetto export, SLO burn rates).

Counterpart of ``accelerate_tpu/telemetry``. Entry point is the
:class:`Telemetry` hub hanging off every ``Accelerator``
(``accelerator.telemetry``); the pieces are usable standalone too.
"""

from .compile_tracker import CompileTracker
from .flops import PEAK_BF16_FLOPS, device_peak_flops
from .goodput import GoodputTracker
from .hub import Telemetry, TelemetryConfig
from .memory import MemoryMonitor
from .profiler import ProfileWindow
from .serving import ServingStats, fleet_rollup
from .slo import SLObjective, SLOMonitor, default_objectives
from .step_timer import StepTimer, drain_local_devices
from .tracing import RequestTracer, to_perfetto, trace_summary

__all__ = [
    "CompileTracker",
    "GoodputTracker",
    "MemoryMonitor",
    "PEAK_BF16_FLOPS",
    "ProfileWindow",
    "RequestTracer",
    "ServingStats",
    "SLObjective",
    "SLOMonitor",
    "default_objectives",
    "fleet_rollup",
    "StepTimer",
    "Telemetry",
    "TelemetryConfig",
    "device_peak_flops",
    "drain_local_devices",
    "to_perfetto",
    "trace_summary",
]
