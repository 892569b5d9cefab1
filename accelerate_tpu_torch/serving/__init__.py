"""Continuous-batching serving over a paged KV pool, and the fleet above it:
a health-aware router over engine replicas (failover, disaggregated prefill
and decode pools with the live KV handoff), offered-load generation and
pool autoscaling."""

from .autoscale import AutoscalePolicy, RoleRebalancer, fleet_signals
from .engine import (
    ServingEngine,
    ServingResult,
    StepWatchdog,
    generation_row,
    params_from_streamed,
    quantized_resident_params,
)
from .fleet import REPLICA_ROLES, EngineReplica, HandoffLost, HealthPolicy, ReplicaLost, ReplicaState
from .kv_cache import (
    SlotAllocator,
    SlotKVCache,
    bucket_for,
    kv_cache_bytes,
    paged_kv_cache_bytes,
    prefill_buckets,
)
from .loadgen import make_burst_trace, make_diurnal_trace, make_mixed_prompts, make_prompts, run_offered_load
from .paging import PageAllocator, PagedKVCache, PrefixCache, paged_buckets, pages_for
from .router import RoutedRequest, ServingRouter
from .scheduler import ContinuousBatchingScheduler, QueueFull, Request
from .speculative import SpeculativeConfig, SpeculativeState

__all__ = [
    "AutoscalePolicy",
    "ContinuousBatchingScheduler",
    "EngineReplica",
    "HandoffLost",
    "HealthPolicy",
    "PageAllocator",
    "PagedKVCache",
    "PrefixCache",
    "QueueFull",
    "REPLICA_ROLES",
    "ReplicaLost",
    "ReplicaState",
    "Request",
    "RoleRebalancer",
    "RoutedRequest",
    "ServingEngine",
    "ServingResult",
    "ServingRouter",
    "SlotAllocator",
    "SlotKVCache",
    "SpeculativeConfig",
    "SpeculativeState",
    "StepWatchdog",
    "bucket_for",
    "fleet_signals",
    "generation_row",
    "kv_cache_bytes",
    "make_burst_trace",
    "make_diurnal_trace",
    "make_mixed_prompts",
    "make_prompts",
    "paged_buckets",
    "paged_kv_cache_bytes",
    "pages_for",
    "params_from_streamed",
    "prefill_buckets",
    "quantized_resident_params",
    "run_offered_load",
]
