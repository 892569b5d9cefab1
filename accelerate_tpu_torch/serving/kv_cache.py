"""Prefill buckets, the lane allocator, the dense slot slab and KV sizing.

Counterpart of ``accelerate_tpu/serving/kv_cache.py``: the bucket
arithmetic, :class:`SlotAllocator` (with quarantine), :class:`SlotKVCache`
(the ``paged=False`` engine's one ``[L, num_slots, max_len, KV, D]`` slab)
and the sizing formulas of both cache layouts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


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


def kv_cache_bytes(config, batch: int, max_seq_len: Optional[int] = None, dtype_bytes: int = 2) -> int:
    """Device bytes of the dense slot-slab KV cache: ``2 (k+v) x layers x
    kv_heads x head_dim x max_len x batch x dtype_bytes``."""
    seq = max_seq_len if max_seq_len is not None else config.max_seq_len
    return int(2 * config.num_layers * config.kv_heads * config.dim_per_head * seq * batch * dtype_bytes)


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
    """Free-slot stack: O(1) admit/retire, slots reused LIFO.

    A slot that produced non-finite logits can be quarantined: it leaves
    the in-use set without returning to the free stack, so no request lands
    on it until a finite-logits probe passes and ``release`` returns it."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self._free = list(range(num_slots - 1, -1, -1))  # pop() yields slot 0 first
        self._in_use: set[int] = set()
        self._quarantined: set[int] = set()

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

    def quarantine(self, slot: int) -> None:
        """Pull an in-use slot out of circulation (no free-stack return)."""
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not in use")
        self._in_use.discard(slot)
        self._quarantined.add(slot)

    def release(self, slot: int) -> None:
        """A quarantined slot passed its probe: back to the free stack."""
        if slot not in self._quarantined:
            raise ValueError(f"slot {slot} is not quarantined")
        self._quarantined.discard(slot)
        self._free.append(slot)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._in_use)

    @property
    def quarantined(self) -> frozenset:
        return frozenset(self._quarantined)

    @property
    def occupancy(self) -> float:
        return len(self._in_use) / self.num_slots

    def __contains__(self, slot: int) -> bool:
        return slot in self._in_use


class SlotKVCache:
    """The dense layout: one preallocated slab per K and V plus host
    mirrors of the slot state.

    ``k``/``v`` are what the model's ``init_cache(num_slots, max_len)``
    allocates (``[L, num_slots, max_len, KV, D]`` for the zoo), slot ``i``
    at index ``i`` of the batch axis, on ``device``. ``lengths``/``active``
    are host arrays shipped to the device per step."""

    def __init__(self, init_cache, num_slots: int, max_len: int, dtype=torch.bfloat16, device=None):
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 (prompt + one token), got {max_len}")
        cache = init_cache(num_slots, max_len, dtype=dtype, device=device)
        self.k, self.v = cache["k"], cache["v"]
        self.num_slots = num_slots
        self.max_len = max_len
        self.dtype = dtype
        self.lengths = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.allocator = SlotAllocator(num_slots)

    @property
    def nbytes(self) -> int:
        return int(self.k.nbytes + self.v.nbytes)

    @property
    def occupancy(self) -> float:
        return self.allocator.occupancy

    def admit(self, length: int) -> Optional[int]:
        """Claim a slot for a request whose cache will hold ``length`` valid
        positions (the prefilled ``prompt[:-1]``)."""
        slot = self.allocator.admit()
        if slot is None:
            return None
        self.lengths[slot] = length
        self.active[slot] = True
        return slot

    def retire(self, slot: int) -> None:
        """Free ``slot``. No device work: stale K/V past a slot's length are
        masked, and the next occupant's prefill overwrites the prefix."""
        self.allocator.retire(slot)
        self.lengths[slot] = 0
        self.active[slot] = False

    def quarantine(self, slot: int) -> None:
        """Take a poisoned slot out of circulation. ``length`` resets to 0,
        so the probe decode (token 0 over an empty cache) exercises the
        slot without reading the suspect prefix."""
        self.allocator.quarantine(slot)
        self.lengths[slot] = 0
        self.active[slot] = False

    def release_quarantined(self, slot: int) -> None:
        """Probe passed: the slot may serve requests again."""
        self.allocator.release(slot)
        self.lengths[slot] = 0
        self.active[slot] = False

    @property
    def quarantined(self) -> frozenset:
        return self.allocator.quarantined
