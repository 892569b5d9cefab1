"""Resilience of the port: the numerical guard and the resilience hub that
wires it and the chaos plan into an ``Accelerator``, the retry policy that
checkpoint I/O, the data loader and the serving fleet ride, the fleet's and
the handoff's transient classifiers, the deterministic chaos plan, the
wall-clock silence detector, the epoch-fenced membership service that names
a lost host (``membership.py``) and elastic training across processes
(``elastic.py``: the buddy mirror, the shrink onto the survivors' new
process group, the checkpoint rung, the regrow)."""

from .chaos import FaultPlan
from .detector import SilenceDetector
from .elastic import ElasticConfig, ElasticCoordinator, ElasticFailure
from .guards import GuardPolicy, NumericalGuard, tree_all_finite, zero_guard_state
from .hub import Resilience, ResilienceConfig
from .membership import (
    STORE_RETRY,
    CollectiveHangWatchdog,
    DictStore,
    FilesystemStore,
    MembershipConfig,
    MembershipService,
    MembershipStore,
    StaleEpochError,
    publish_supervisor_loss,
)
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
    "STORE_RETRY",
    "CollectiveHangWatchdog",
    "DictStore",
    "ElasticConfig",
    "ElasticCoordinator",
    "ElasticFailure",
    "FaultPlan",
    "FilesystemStore",
    "GuardPolicy",
    "HANDOFF_RETRY",
    "MembershipConfig",
    "MembershipService",
    "MembershipStore",
    "NumericalGuard",
    "Resilience",
    "ResilienceConfig",
    "RetryPolicy",
    "SilenceDetector",
    "StaleEpochError",
    "publish_supervisor_loss",
    "is_fleet_transient",
    "is_handoff_transient",
    "tree_all_finite",
    "zero_guard_state",
]
