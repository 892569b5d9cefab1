"""Prefill buckets, the lane allocator and KV sizing for the serving engine.

Counterpart of the parts of ``accelerate_tpu/serving/kv_cache.py`` the paged
engine uses. The dense per-slot slab (``SlotKVCache``) is not in the port.
"""

from __future__ import annotations

from typing import Optional, Sequence


def prefill_buckets(max_prefill: int, min_bucket: int = 16) -> tuple[int, ...]:
    """Power-of-two prefill lengths covering ``1..max_prefill``, the last
    clamped to ``max_prefill``."""
    if max_prefill < 1:
        raise ValueError(f"max_prefill must be >= 1, got {max_prefill}")
    buckets: list[int] = []
    b = min_bucket
    while b < max_prefill:
        buckets.append(b)
        b *= 2
    buckets.append(max_prefill)
    return tuple(buckets)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` prefill tokens."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prefill length {n} exceeds largest bucket {buckets[-1]}")


def paged_kv_cache_bytes(
    config,
    batch: int,
    max_seq_len: Optional[int] = None,
    page_size: int = 16,
    num_pages: Optional[int] = None,
    dtype_bytes: int = 2,
) -> tuple[int, int]:
    """Device bytes of a paged KV pool: ``(pool_bytes, table_bytes)``.
    ``num_pages`` defaults to ``batch * ceil(S / page_size)`` plus the null
    page, the engine's own default."""
    seq = max_seq_len if max_seq_len is not None else config.max_seq_len
    pages_per_seq = -(-seq // page_size)
    if num_pages is None:
        num_pages = batch * pages_per_seq + 1
    pool = int(
        2 * config.num_layers * config.kv_heads * config.dim_per_head
        * num_pages * page_size * dtype_bytes
    )
    table = int(batch * pages_per_seq * 4)
    return pool, table


class SlotAllocator:
    """Free-slot stack: O(1) admit/retire, slots reused LIFO."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self._free = list(range(num_slots - 1, -1, -1))  # pop() yields slot 0 first
        self._in_use: set[int] = set()

    def admit(self) -> Optional[int]:
        """Claim a free slot, or None when every slot is occupied."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        return slot

    def retire(self, slot: int) -> None:
        """Release ``slot`` for immediate reuse (the very next admit)."""
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not in use")
        self._in_use.discard(slot)
        self._free.append(slot)

    @property
    def free_count(self) -> int:
        return len(self._free)
