"""Speculative decoding: a small model drafts, the target verifies.

Counterpart of ``accelerate_tpu/serving/speculative.py``. A draft model
proposes ``k`` candidate tokens per slot; the target scores the ``k+1``-token
window (the pending input token plus the candidates) in one step through
the paged verify kernel (``ops/paged_attention.paged_verify_attention``),
and the engine accepts the longest prefix of candidates that agrees with the
target's own greedy choices. At temperature 0 the emitted stream is
token-equal to plain decode: the draft changes how many tokens land per
step, never which.

This module owns the draft half:

- the draft model's own K/V pools, which share the engine's page tables,
  lengths and geometry, so one set of page bookkeeping (allocation, COW,
  prefix sharing, rollback) covers both models;
- the draft decode and the mirrored prefill spans. The JAX draft decode
  attends over a gathered dense view of each slot's pages; here it attends
  through the port's paged decode kernel (``paging.decode_into_pool``, the
  engine's own decode), which computes the same masked function and reads
  only the valid pages;
- per-slot host state: ``draft_len`` (how far the draft pool tracks the
  slot's committed history; drafting needs it to equal the target length)
  and ``draft_ok`` (a draft that produced non-finite logits stops drafting
  for that slot; verify never consumed a draft activation).

The draft pools hold K/V in the draft model's dtype: the decode kernel reads
query and pool in one type. The engine drives all of this from its step
loop; this module never imports the engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..models.generation import resolve_decode_protocol
from .paging import decode_into_pool, prefill_into_pool


@dataclass
class SpeculativeConfig:
    """How a :class:`~.engine.ServingEngine` should speculate.

    ``draft_model`` — any model with the decode protocol, typically a
    smaller llama sharing the target's vocabulary; it carries its weights
    (the JAX config's ``draft_params`` has no counterpart). ``k`` — candidate
    tokens drafted per step; the verify window is ``k + 1``. ``mode`` —
    ``"linear"`` verifies one greedy draft chain; ``"tree"`` forks
    ``num_branches`` branches off the draft's top-``num_branches`` first
    tokens, COW-sharing the committed prefix pages through
    ``PageAllocator.fork``, and commits the branch the target agrees with
    longest."""

    draft_model: Any
    k: int = 4
    mode: str = "linear"
    num_branches: int = 2

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculative k must be >= 1, got {self.k}")
        if self.mode not in ("linear", "tree"):
            raise ValueError(f"mode must be 'linear' or 'tree', got {self.mode!r}")
        if self.mode == "tree" and self.num_branches < 2:
            raise ValueError(f"tree mode needs num_branches >= 2, got {self.num_branches}")


class SpeculativeState:
    """The draft model's pools and per-slot tracking.

    Built by the engine at construction. The draft pools index through the
    engine's page tables (same page ids, same geometry), so growing,
    COW-copying, forking and rolling back a slot's pages applies to both
    models' K/V. ``draft_len[slot] == cache.lengths[slot]`` is the drafting
    precondition, kept by mirroring every prefill span and advancing with
    each accepted window."""

    def __init__(self, config: SpeculativeConfig, cache):
        self.config = config
        self.model = config.draft_model
        init_cache, self._fwc = resolve_decode_protocol(self.model)
        # pages ride the batch axis, exactly like the engine's own pool
        pools = init_cache(
            cache.num_pages, cache.page_size, dtype=self.model.dtype, device=cache.k.device
        )
        self.k, self.v = pools["k"], pools["v"]
        self.num_slots = int(cache.num_slots)
        self.page_size = int(cache.page_size)
        self.num_pages = int(cache.num_pages)
        self.draft_len = np.zeros((self.num_slots,), np.int32)
        self.draft_ok = np.ones((self.num_slots,), bool)
        self.enabled = True
        self.disabled_reason: Optional[str] = None

    def decode(self, tokens, lengths, active, tables, top_b: int = 0):
        """One draft launch over every lane: each active lane consumes one
        token at its draft position and appends that position's draft K/V
        to the draft pool. Greedy, as the verify acceptance tests against
        the argmax; ``top_b > 0`` returns the top-B candidates per slot
        instead (tree mode's branch seeds). Returns host ``(next_tokens,
        finite)``: the chain is sequential, so the host fetch per launch is
        the protocol."""
        dev = self.k.device
        active_t = torch.tensor(np.asarray(active, bool), device=dev)
        logits = decode_into_pool(
            self._fwc, self.k, self.v,
            torch.tensor(np.asarray(tokens, np.int32), device=dev),
            torch.tensor(np.asarray(lengths, np.int32), device=dev),
            torch.tensor(np.asarray(tables, np.int32), device=dev),
            active_t, self.page_size,
        )
        ok = torch.isfinite(logits).all(dim=-1)
        if top_b:
            nxt = torch.topk(logits, top_b, dim=-1).indices.to(torch.int32)
            nxt = torch.where(active_t[:, None], nxt, 0)
        else:
            nxt = torch.where(active_t, torch.argmax(logits, dim=-1).to(torch.int32), 0)
        return nxt.cpu().numpy(), ok.cpu().numpy()

    def prefill(self, span: int, ids: np.ndarray, row: np.ndarray, start: int) -> None:
        """Mirror one engine prefill span (same ids, same table row, same
        start) into the draft pool, so the slot can draft the moment it
        decodes and pages filed in the prefix cache carry draft content."""
        ids_t = torch.tensor(ids, device=self.k.device)
        prefill_into_pool(self._fwc, self.k, self.v, span, ids_t, row, start, self.page_size)

    def copy_page(self, src: int, dst: int) -> None:
        """COW mirror: the privatized page carries its draft content too."""
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]

    def scrub_pages(self, pages) -> None:
        """Zero draft-pool pages before the allocator recycles them (a
        non-finite draft launch wrote into them; 0 x NaN = NaN for the next
        holder's masked reads). The null page is never scrubbed."""
        pages = sorted({int(p) for p in pages if p})
        if not pages:
            return
        idx = torch.tensor(pages, dtype=torch.long, device=self.k.device)
        self.k[:, idx] = 0
        self.v[:, idx] = 0

    def fail_slot(self, slot: int, tables, held: int) -> None:
        """The draft went non-finite for ``slot``: stop drafting it and scrub
        the draft pages its launches could have written (from the page
        holding ``draft_len`` to the slot's held tail)."""
        self.draft_ok[slot] = False
        first = int(self.draft_len[slot]) // self.page_size
        self.scrub_pages([int(tables[slot, idx]) for idx in range(first, held)])

    def disable(self, reason: str) -> None:
        """Permanent engine-wide opt-out: the engine returns to plain paged
        decode, with identical pending/length semantics, so the token
        stream continues without a drop or a duplicate."""
        self.enabled = False
        self.disabled_reason = reason
