"""Continuous-batching serving over a paged KV pool."""

from .engine import ServingEngine, ServingResult, generation_row
from .kv_cache import SlotAllocator, bucket_for, paged_kv_cache_bytes, prefill_buckets
from .paging import PageAllocator, PagedKVCache, PrefixCache, paged_buckets, pages_for
from .scheduler import ContinuousBatchingScheduler, QueueFull, Request

__all__ = [
    "ContinuousBatchingScheduler",
    "PageAllocator",
    "PagedKVCache",
    "PrefixCache",
    "QueueFull",
    "Request",
    "ServingEngine",
    "ServingResult",
    "SlotAllocator",
    "bucket_for",
    "generation_row",
    "paged_buckets",
    "paged_kv_cache_bytes",
    "pages_for",
    "prefill_buckets",
]
