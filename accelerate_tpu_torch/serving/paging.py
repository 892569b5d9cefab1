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
- :func:`decode_into_pool` / :func:`prefill_into_pool`: the device half,
  one model forward against a pair of pools with the write-back. The
  engine runs them on its pools, the speculative draft on its own pools
  through the same tables.

Sharing is page-aligned, so a slot's write position normally lands in a
private page; ``prepare_write`` is the backstop that copies a shared page
before a write reaches it. ``quarantine`` pulls a poisoned lane out of
circulation and returns the pages it freed for the engine to scrub;
``park`` and ``seat`` move a request's pages between lanes and engines (the
KV handoff) without dropping their references.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.paged_attention import paged_decode_attention
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

    def invalidate_pages(self, pages: Sequence[int]) -> int:
        """Drop every entry referencing ``pages`` (their content is suspect:
        the quarantine path). Returns the number of entries dropped."""
        doomed = {int(p) for p in pages}
        victims = [d for d, (page, _) in self._entries.items() if page in doomed]
        for digest in victims:
            page, _ = self._entries.pop(digest)
            self.allocator.decref(page)
        return len(victims)


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

    @property
    def quarantined(self) -> frozenset:
        return self.lanes.quarantined

    def pages_of(self, slot: int) -> list[int]:
        return [int(p) for p in self.tables[slot, : int(self.held[slot])]]

    def alloc(self, n: int) -> Optional[list[int]]:
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
        fresh = self.alloc(new_pages)
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
        fresh = self.alloc(n)
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
        replacement = self.alloc(1)
        if replacement is None:
            return ("pressure", 0, 0)
        dst = replacement[0]
        self.tables[slot, idx] = dst
        self.pages.decref(page)
        return ("cow", page, dst)

    def trim_to_length(self, slot: int) -> list[int]:
        """Speculative rollback: drop the trailing pages beyond what
        ``lengths[slot]`` committed positions need. Before a verify step the
        engine grows the slot to hold the whole candidate window; when
        acceptance lands short the surplus is released here (a forked tree
        branch's surplus un-shares, the last holder frees the page) and the
        table's tail points at the null page again. Returns the pages that
        became free."""
        keep = pages_for(int(self.lengths[slot]), self.page_size)
        held = int(self.held[slot])
        if keep >= held:
            return []
        freed = []
        for idx in range(keep, held):
            page = int(self.tables[slot, idx])
            if page and self.pages.decref(page):
                freed.append(page)
            self.tables[slot, idx] = 0
        self.held[slot] = keep
        return freed

    def _release_pages(self, slot: int) -> list[int]:
        """Drop the slot's page references; returns the pages that became free."""
        freed = [p for p in self.pages_of(slot) if self.pages.decref(p)]
        self.tables[slot, :] = 0
        self.held[slot] = 0
        self.lengths[slot] = 0
        self.active[slot] = False
        return freed

    def park(self, slot: int) -> list[int]:
        """Detach a slot's pages without dropping their references: the lane
        frees (the next prefill can admit at once) while every page keeps
        this slot's reference, so the allocator cannot recycle it. The
        source half of a KV handoff: the caller drops each parked page once
        the destination adopted it (or the handoff fell back). Returns the
        parked pages in position order."""
        pages = self.pages_of(slot)
        self.lanes.retire(slot)
        self.tables[slot, :] = 0
        self.held[slot] = 0
        self.lengths[slot] = 0
        self.active[slot] = False
        return pages

    def seat(self, pages: Sequence[int], length: int) -> Optional[int]:
        """Claim a lane for pages the caller already owns (freshly allocated
        by an adoption, or a parked row resumed in place) and make it
        decode-visible at ``length``. None when no lane is free: the caller
        keeps its page references."""
        slot = self.lanes.admit()
        if slot is None:
            return None
        self.tables[slot, : len(pages)] = list(pages)
        self.tables[slot, len(pages):] = 0
        self.held[slot] = len(pages)
        self.lengths[slot] = length
        self.active[slot] = True
        return slot

    def retire(self, slot: int) -> None:
        """Free the lane and drop the slot's page references. Stale K/V in a
        freed page is unreachable: reads stop at a slot's length and a new
        holder's prefill overwrites whole pages first."""
        self.lanes.retire(slot)
        self._release_pages(slot)

    def quarantine(self, slot: int) -> list[int]:
        """Poisoned lane: pull it from circulation and release its pages.
        Prefix entries on the slot's pages are dropped first (their content
        is suspect). Returns the pages that became free, which the caller
        must scrub on the device before the pool recycles them: pages
        still shared by live slots stay as they are."""
        pages = self.pages_of(slot)
        self.lanes.quarantine(slot)
        self.prefix.invalidate_pages(pages)
        return self._release_pages(slot)

    def release_quarantined(self, slot: int) -> None:
        """Probe passed: the lane may serve requests again."""
        self.lanes.release(slot)
        self.lengths[slot] = 0
        self.active[slot] = False


def attend_pool(q, k_new, v_new, cache):
    """The decode-cache ``attend`` hook: every slot's attention over its
    pages, from the layer's pool view and the step's tables and lengths."""
    out = paged_decode_attention(
        q[:, 0], k_new[:, 0], v_new[:, 0], cache["k"], cache["v"], cache["table"], cache["length"]
    )
    return out[:, None]


def decode_into_pool(fwc, pool_k, pool_v, tokens, lengths, tables, active, page_size: int):
    """One decode forward over every lane (``tokens`` ``[S]``, device
    tensors throughout) through the paged decode kernel; returns the fp32
    logits ``[S, V]``. Active lanes write their new K/V at ``(table[length
    // ps], length % ps)``; inactive lanes write zeros to the null page,
    which keeps it finite. In place: the pools are never copied (the JAX
    engine donates them instead)."""
    cache = {"k": pool_k, "v": pool_v, "length": lengths, "table": tables, "attend": attend_pool}
    logits, delta = fwc(tokens[:, None], cache)
    idx = (lengths // page_size).long()[:, None]
    wpage = torch.where(active, tables.gather(1, idx)[:, 0], 0).long()
    woff = torch.where(active, lengths % page_size, 0).long()
    lane = active[None, :, None, None]
    zero = torch.zeros((), dtype=pool_k.dtype, device=pool_k.device)
    pool_k[:, wpage, woff] = torch.where(lane, delta["k"][:, :, 0].to(pool_k.dtype), zero)
    pool_v[:, wpage, woff] = torch.where(lane, delta["v"][:, :, 0].to(pool_v.dtype), zero)
    return logits


def prefill_into_pool(fwc, pool_k, pool_v, span: int, ids, row, start: int, page_size: int) -> None:
    """Prefill ``span`` tokens (``ids`` ``[1, span]`` on the pools' device)
    at the page-aligned ``start``: gather the pages of ``row`` up to
    ``start + span`` into a dense view, run the dense forward over it, and
    scatter the span's pages back into the pools."""
    n_pages = span // page_size
    needed = (start + span) // page_size
    row_t = torch.tensor(np.asarray(row[:needed]), dtype=torch.long, device=pool_k.device)
    layers = pool_k.shape[0]
    view_shape = (layers, 1, needed * page_size) + tuple(pool_k.shape[3:])
    view = {
        "k": pool_k[:, row_t].reshape(view_shape),
        "v": pool_v[:, row_t].reshape(view_shape),
        "length": start,
    }
    fwc(ids, view)  # logits dropped by design
    page_shape = (layers, n_pages, page_size) + tuple(pool_k.shape[3:])
    wids = row_t[start // page_size : start // page_size + n_pages]
    pool_k[:, wids] = view["k"][:, 0, start : start + span].reshape(page_shape)
    pool_v[:, wids] = view["v"][:, 0, start : start + span].reshape(page_shape)
