"""Resilience of the port: the retry policy that checkpoint I/O, the data
loader and the serving fleet ride, the fleet's and the handoff's transient
classifiers, the deterministic chaos plan and the wall-clock silence
detector. Guards, membership, elastic training and the hub come with
ROADMAP item 18."""

from .chaos import FaultPlan
from .detector import SilenceDetector
from .retry import (
    DEFAULT_IO_RETRY,
    FLEET_RETRY,
    HANDOFF_RETRY,
    RetryPolicy,
    is_fleet_transient,
    is_handoff_transient,
)

__all__ = [
    "DEFAULT_IO_RETRY",
    "FLEET_RETRY",
    "FaultPlan",
    "HANDOFF_RETRY",
    "RetryPolicy",
    "SilenceDetector",
    "is_fleet_transient",
    "is_handoff_transient",
]
