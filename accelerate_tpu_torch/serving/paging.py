"""Paged KV memory for the serving engine: block pool, page tables, COW
prefix sharing.

Counterpart of ``accelerate_tpu/serving/paging.py``. One pool of
``page_size``-token blocks per layer, ``[L, num_pages, page_size, KV, D]``,
holds every request's K/V; a fixed-shape int32 page table per slot
(``[num_slots, pages_per_slot]``) maps positions to pages.

- :class:`PageAllocator`: LIFO free list and per-page reference counts.
  Page 0 is the null page: unused table entries point at it, inactive decode
  lanes write zeros to it, and it is never allocated.
- :class:`PrefixCache`: copy-on-write prefix sharing keyed by a chained
  sha256 of each full page of prompt tokens; every hit is compared token for
  token, so a digest collision degrades to a re-prefill, never to wrong K/V.
- :class:`PagedKVCache`: pools, tables and the host mirrors the engine
  drives. The pools are torch tensors on the engine's device; tables,
  lengths and flags are host numpy arrays shipped to the device per step.

Sharing is page-aligned, so a slot's write position normally lands in a
private page; ``prepare_write`` is the backstop that copies a shared page
before a write reaches it.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from .kv_cache import SlotAllocator


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` positions."""
    return -(-tokens // page_size)


def paged_buckets(buckets: Sequence[int], page_size: int, capacity: int) -> tuple[int, ...]:
    """Round prefill buckets up to page multiples (a prefill span scatters
    whole pages), capped at the pool-backed capacity."""
    rounded = sorted(
        {min(pages_for(b, page_size) * page_size, capacity) for b in buckets if b > 0}
    )
    if not rounded:
        raise ValueError(f"no usable prefill buckets in {tuple(buckets)}")
    return tuple(rounded)


class PageAllocator:
    """Free list + refcounts over ``num_pages`` pages; page 0 is pinned."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (null page + one real), got {num_pages}")
        self.num_pages = num_pages
        self.refcounts = np.zeros((num_pages,), np.int32)
        self.refcounts[0] = 1  # the null page: pinned, never allocated or freed
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields page 1 first

    def alloc(self) -> Optional[int]:
        """Claim one free page (refcount 1), or None when the pool is dry."""
        if not self._free:
            return None
        page = self._free.pop()
        self.refcounts[page] = 1
        return page

    def alloc_many(self, n: int) -> Optional[list[int]]:
        """All-or-nothing allocation of ``n`` pages."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if len(self._free) < n:
            return None
        return [self.alloc() for _ in range(n)]

    def incref(self, page: int) -> None:
        if page == 0:
            return
        if self.refcounts[page] <= 0:
            raise ValueError(f"page {page} is free — cannot share it")
        self.refcounts[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one holder; True when the page just became free."""
        if page == 0:
            return False
        if self.refcounts[page] <= 0:
            raise ValueError(f"page {page} is already free")
        self.refcounts[page] -= 1
        if self.refcounts[page] == 0:
            self._free.append(page)
            return True
        return False

    def fork(self, pages: Sequence[int]) -> None:
        """A second table now references ``pages``; no copy until a write."""
        for page in pages:
            self.incref(page)

    def is_shared(self, page: int) -> bool:
        return page != 0 and self.refcounts[page] > 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Pages holding live data (the null page is not counted)."""
        return self.num_pages - 1 - len(self._free)

    @property
    def occupancy(self) -> float:
        capacity = self.num_pages - 1
        return self.used_count / capacity if capacity else 0.0


class PrefixCache:
    """Page-granular prefix registry: chained token hash -> physical page.
    The registry holds one reference per registered page; entries evict LRU
    when the allocator runs dry."""

    def __init__(self, allocator: PageAllocator, page_size: int, max_entries: int = 256):
        self.allocator = allocator
        self.page_size = page_size
        self.max_entries = max_entries
        # digest -> (page, block_tokens) in LRU order (last = most recent)
        self._entries: "OrderedDict[bytes, tuple[int, np.ndarray]]" = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _chain(parent: bytes, block: np.ndarray) -> bytes:
        return hashlib.sha256(parent + np.ascontiguousarray(block, np.int32).tobytes()).digest()

    def lookup(self, tokens: np.ndarray) -> tuple[int, list[int]]:
        """Longest page-aligned cached prefix of ``tokens``: ``(hit_tokens,
        pages)``. The pages are not referenced yet; the caller forks them."""
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        pages: list[int] = []
        digest = b""
        for j in range(tokens.size // ps):
            block = tokens[j * ps : (j + 1) * ps]
            digest = self._chain(digest, block)
            entry = self._entries.get(digest)
            if entry is None or not np.array_equal(entry[1], block):
                break
            self._entries.move_to_end(digest)  # LRU touch
            pages.append(entry[0])
        return len(pages) * ps, pages

    def register_chain(self, tokens: np.ndarray, pages: Sequence[int]) -> int:
        """File each full page of a completed prefill; returns the number of
        new entries. Pages already filed under the same chain keep their entry."""
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        if tokens.size % ps:
            raise ValueError(f"prefix length {tokens.size} is not page-aligned (page_size={ps})")
        digest, created = b"", 0
        for j, page in enumerate(pages):
            block = tokens[j * ps : (j + 1) * ps]
            digest = self._chain(digest, block)
            if digest in self._entries:
                self._entries.move_to_end(digest)
                continue
            self.allocator.incref(int(page))
            self._entries[digest] = (int(page), block.copy())
            created += 1
            while len(self._entries) > self.max_entries:
                self._evict_one()
        return created

    def _evict_one(self) -> bool:
        if not self._entries:
            return False
        _, (page, _) = self._entries.popitem(last=False)
        self.evictions += 1
        return self.allocator.decref(page)

    def evict_for_pressure(self, needed: int) -> None:
        """Evict LRU entries until ``needed`` pages are free or none remain."""
        while self.allocator.free_count < needed and self._entries:
            self._evict_one()


class PagedKVCache:
    """Pools + page tables + host mirrors behind the engine.

    ``init_cache(num_pages, page_size, dtype=, device=)`` is the model's
    decode-protocol cache constructor: pages ride its batch axis, so the
    pools are ``[L, num_pages, page_size, KV, D]``."""

    def __init__(
        self,
        init_cache,
        num_slots: int,
        max_len: int,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        dtype: torch.dtype = torch.bfloat16,
        prefix_entries: int = 256,
        device=None,
    ):
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 (prompt + one token), got {max_len}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.pages_per_slot = pages_for(max_len, page_size)
        self.view_len = self.pages_per_slot * page_size
        if num_pages is None:
            num_pages = num_slots * self.pages_per_slot + 1
        cache = init_cache(num_pages, page_size, dtype=dtype, device=device)
        self.k, self.v = cache["k"], cache["v"]
        self.num_pages = num_pages
        self.num_slots = num_slots
        self.max_len = max_len
        self.dtype = dtype
        self.lengths = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.tables = np.zeros((num_slots, self.pages_per_slot), np.int32)  # 0 = null page
        self.held = np.zeros((num_slots,), np.int32)  # valid leading entries per row
        self.lanes = SlotAllocator(num_slots)
        self.pages = PageAllocator(num_pages)
        self.prefix = PrefixCache(self.pages, page_size, max_entries=prefix_entries)

    @property
    def pages_in_use(self) -> int:
        return self.pages.used_count

    def pages_of(self, slot: int) -> list[int]:
        return [int(p) for p in self.tables[slot, : int(self.held[slot])]]

    def _alloc(self, n: int) -> Optional[list[int]]:
        """Allocate ``n`` pages, evicting LRU prefix entries under pressure."""
        if self.pages.free_count < n:
            self.prefix.evict_for_pressure(n)
        return self.pages.alloc_many(n)

    def admit(self, shared_pages: Sequence[int], new_pages: int) -> Optional[int]:
        """Claim a lane + pages: ``shared_pages`` forked, ``new_pages`` fresh.
        None when lanes or pages are exhausted."""
        slot = self.lanes.admit()
        if slot is None:
            return None
        # fork BEFORE allocating: eviction under pressure could otherwise free
        # a hit page whose only reference was the registry's and hand it back
        # out as a fresh page of the same row
        self.pages.fork(shared_pages)
        fresh = self._alloc(new_pages)
        if fresh is None:
            for page in shared_pages:
                self.pages.decref(page)
            self.lanes.retire(slot)
            return None
        row = list(shared_pages) + fresh
        self.tables[slot, : len(row)] = row
        self.tables[slot, len(row):] = 0
        self.held[slot] = len(row)
        self.lengths[slot] = 0
        self.active[slot] = False  # decode-visible only once prefill completes
        return slot

    def grow(self, slot: int, n: int) -> bool:
        """Append ``n`` fresh pages to a slot's table; False = page pressure."""
        if n <= 0:
            return True
        fresh = self._alloc(n)
        if fresh is None:
            return False
        held = int(self.held[slot])
        self.tables[slot, held : held + n] = fresh
        self.held[slot] = held + n
        return True

    def prepare_write(self, slot: int) -> tuple[str, int, int]:
        """Make position ``lengths[slot]`` writable: ``("ok", 0, 0)``,
        ``("grow", 0, 0)`` after allocating a page, ``("cow", src, dst)`` when
        the page was shared (the caller copies ``src`` to ``dst`` on device),
        or ``("pressure", 0, 0)`` when the pool is dry."""
        idx = int(self.lengths[slot]) // self.page_size
        if idx >= int(self.held[slot]):
            if not self.grow(slot, idx - int(self.held[slot]) + 1):
                return ("pressure", 0, 0)
            return ("grow", 0, 0)
        page = int(self.tables[slot, idx])
        if not self.pages.is_shared(page):
            return ("ok", 0, 0)
        replacement = self._alloc(1)
        if replacement is None:
            return ("pressure", 0, 0)
        dst = replacement[0]
        self.tables[slot, idx] = dst
        self.pages.decref(page)
        return ("cow", page, dst)

    def retire(self, slot: int) -> None:
        """Free the lane and drop the slot's page references. Stale K/V in a
        freed page is unreachable: reads stop at a slot's length and a new
        holder's prefill overwrites whole pages first."""
        self.lanes.retire(slot)
        for page in self.pages_of(slot):
            self.pages.decref(page)
        self.tables[slot, :] = 0
        self.held[slot] = 0
        self.lengths[slot] = 0
        self.active[slot] = False
