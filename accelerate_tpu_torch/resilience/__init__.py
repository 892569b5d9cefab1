"""Resilience of the port: the numerical guard and the resilience hub that
wires it and the chaos plan into an ``Accelerator``, the retry policy that
checkpoint I/O, the data loader and the serving fleet ride, the fleet's and
the handoff's transient classifiers, the deterministic chaos plan and the
wall-clock silence detector. Membership and elastic training come with
ROADMAP item 18."""

from .chaos import FaultPlan
from .detector import SilenceDetector
from .guards import GuardPolicy, NumericalGuard, tree_all_finite, zero_guard_state
from .hub import Resilience, ResilienceConfig
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
    "GuardPolicy",
    "HANDOFF_RETRY",
    "NumericalGuard",
    "Resilience",
    "ResilienceConfig",
    "RetryPolicy",
    "SilenceDetector",
    "is_fleet_transient",
    "is_handoff_transient",
    "tree_all_finite",
    "zero_guard_state",
]
