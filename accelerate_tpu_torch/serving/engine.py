"""The continuous-batching serving engine over a paged KV pool.

Counterpart of the paged core of ``accelerate_tpu/serving/engine.py``:

- **memory** is paged (``paging.py``): one pool of ``page_size``-token blocks
  per layer and an int32 page table per slot. A request holds pages for the
  tokens it has, a shared prompt prefix is prefilled once and
  reference-counted, and admission is gated on free pages;
- **decode** is one forward over ``[num_slots, 1]`` tokens with per-slot
  positions and lengths (the JAX engine vmaps a batch-of-1 call instead).
  Attention reads the pool through the paged decode kernel
  (``ops/paged_attention.py``), one launch per layer per step, and the new
  tokens' K/V are then scattered into the pool;
- **prefill** runs the dense-cache forward over a slot's gathered pages with
  the plain attention of ``models/attention.py``, in page-aligned spans: with
  ``prefill_chunk`` a long prompt advances one chunk per step, so decoding
  requests never stall behind it. Only ``prompt[:-1]`` prefills; the last
  prompt token is the first decode input;
- **scheduling** is host-side (``scheduler.py``): FIFO admission into free
  slots and pages, retirement on EOS or budget, and preemption of the
  youngest request under page pressure.

The pools are updated in place (prefill scatter, decode write-back, the
copy-on-write page copy), which is what buffer donation buys the JAX engine.

Not in this port yet: speculative decoding, quantized-resident weights, the
dense ``paged=False`` slab, quarantine and scrub, chaos fault plans, the
step watchdog, request tracing, the telemetry hub, disaggregated
park/adopt/extract and program analysis.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.generation import make_sampler, resolve_decode_protocol
from ..ops.paged_attention import paged_decode_attention
from ..ops.runtime import resolve_device, same_device
from ..telemetry.serving import ServingStats
from .kv_cache import bucket_for, prefill_buckets
from .paging import PagedKVCache, paged_buckets, pages_for
from .scheduler import ContinuousBatchingScheduler, QueueFull, Request


@dataclass
class ServingResult:
    """One finished request: ids + the latency the user saw."""

    request_id: int
    prompt: np.ndarray  # [S]
    generated: np.ndarray  # [<= max_new_tokens], ends with EOS when hit
    finish_reason: str  # "eos" | "length" | "expired" | "cancelled" | "failed"
    ttft_s: Optional[float]
    latency_s: Optional[float]

    @property
    def tokens(self) -> np.ndarray:
        """Full sequence, prompt + generated."""
        return np.concatenate([self.prompt, self.generated])


def generation_row(prompt, result: ServingResult, max_new_tokens: int, eos_token_id) -> np.ndarray:
    """``generate()``'s output contract for one finished request: a
    ``[S + max_new_tokens]`` row, EOS-filled past the first EOS. A request
    that did not finish naturally raises."""
    if result.finish_reason not in ("eos", "length"):
        raise RuntimeError(
            f"request {result.request_id} terminated as "
            f"'{result.finish_reason}', not a completion — no output row"
        )
    row = np.concatenate([np.asarray(prompt, np.int32), result.generated])
    full = np.asarray(prompt).size + max_new_tokens
    if row.size < full:
        row = np.concatenate([row, np.full((full - row.size,), eos_token_id, np.int32)])
    return row


def _attend(q, k_new, v_new, cache):
    """The decode-cache ``attend`` hook: every slot's attention over its
    pages, from the layer's pool view and the step's tables and lengths."""
    out = paged_decode_attention(
        q[:, 0], k_new[:, 0], v_new[:, 0], cache["k"], cache["v"], cache["table"], cache["length"]
    )
    return out[:, None]


class ServingEngine:
    """Slot-multiplexed decode of a model with the decode protocol.

    ``submit()`` / ``step()`` / ``run()`` are the surface a server loops on;
    ``generate_many()`` is the blocking call with ``generate()``'s output
    contract (the same ids at temperature 0). The engine runs on ``device``
    (None = CUDA), which must be the model's device."""

    def __init__(
        self,
        model,
        num_slots: int = 8,
        max_len: int = 512,
        buckets: Optional[Sequence[int]] = None,
        eos_token_id: Optional[int] = None,
        temperature: float = 0.0,
        rng: Optional[torch.Generator] = None,
        max_queue: Optional[int] = None,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prefix_sharing: bool = True,
        prefix_cache_entries: int = 256,
        device=None,
    ):
        self.device = resolve_device(device)
        if not same_device(self.device, model.device):
            raise ValueError(f"model is on {model.device}, the engine was asked for {self.device}")
        self.model = model
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self._sample = make_sampler(temperature)
        self._init_cache, self._fwc = resolve_decode_protocol(model)
        # the pool holds K/V in the model's dtype: the kernel reads both in one type
        self.cache = PagedKVCache(
            self._init_cache, num_slots, max_len, page_size=page_size, num_pages=num_pages,
            dtype=model.dtype, prefix_entries=prefix_cache_entries, device=self.device,
        )
        base_buckets = tuple(buckets) if buckets is not None else prefill_buckets(max_len - 1)
        if prefill_chunk is not None:
            if prefill_chunk < page_size or prefill_chunk % page_size:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must be a multiple of page_size {page_size}"
                )
            base_buckets = base_buckets + (prefill_chunk,)
        # prefill spans scatter whole pages: buckets round to page multiples
        self.buckets = paged_buckets(base_buckets, page_size, self.cache.view_len)
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        self.scheduler = ContinuousBatchingScheduler(num_slots, max_queue=max_queue)
        self._pending = np.zeros((num_slots,), np.int32)  # next input token per slot
        if rng is None and self.temperature > 0.0:
            rng = torch.Generator(device=self.device).manual_seed(0)
        self._rng = rng
        self.stats = ServingStats(num_slots, num_pages=self.cache.num_pages, page_size=page_size)
        self._warming = False  # warmup(): synthetic prompts skip the prefix cache

    # -- device work --------------------------------------------------------

    def _host_to_device(self, array: np.ndarray) -> torch.Tensor:
        # a copy: the host mirrors change right after the step
        return torch.tensor(array, device=self.device)

    def _decode(self) -> np.ndarray:
        """One decode step over every slot; returns the sampled tokens
        (0 on inactive lanes). Active lanes write their new K/V at
        ``(table[length // ps], length % ps)``; inactive lanes write zeros
        to the null page, which keeps it finite."""
        ps = self.cache.page_size
        tokens = self._host_to_device(self._pending)
        lengths = self._host_to_device(self.cache.lengths)
        tables = self._host_to_device(self.cache.tables)
        active = self._host_to_device(self.cache.active)
        cache = {"k": self.cache.k, "v": self.cache.v, "length": lengths,
                 "table": tables, "attend": _attend}
        logits, delta = self._fwc(tokens[:, None], cache)
        nxt = self._sample(logits, self._rng)
        idx = (lengths // ps).long()[:, None]
        wpage = torch.where(active, tables.gather(1, idx)[:, 0], 0).long()
        woff = torch.where(active, lengths % ps, 0).long()
        lane = active[None, :, None, None]
        pool_k, pool_v = self.cache.k, self.cache.v
        zero = torch.zeros((), dtype=pool_k.dtype, device=self.device)
        # in place: the pool is never copied (the JAX engine donates it instead)
        pool_k[:, wpage, woff] = torch.where(lane, delta["k"][:, :, 0].to(pool_k.dtype), zero)
        pool_v[:, wpage, woff] = torch.where(lane, delta["v"][:, :, 0].to(pool_v.dtype), zero)
        nxt = torch.where(active, nxt, 0)
        return nxt.cpu().numpy()  # the host fetch is the per-step fence

    def _prefill(self, span: int, ids: np.ndarray, row: np.ndarray, start: int) -> None:
        """Prefill ``span`` tokens at the page-aligned ``start``: gather the
        slot's pages up to ``start + span`` into a dense view, run the dense
        forward over it, and scatter the span's pages back into the pool."""
        ps = self.cache.page_size
        n_pages = span // ps
        needed = (start + span) // ps
        row_t = torch.tensor(row[:needed], dtype=torch.long, device=self.device)
        pool_k, pool_v = self.cache.k, self.cache.v
        layers = pool_k.shape[0]
        view_shape = (layers, 1, needed * ps) + tuple(pool_k.shape[3:])
        view = {
            "k": pool_k[:, row_t].reshape(view_shape),
            "v": pool_v[:, row_t].reshape(view_shape),
            "length": start,
        }
        self._fwc(self._host_to_device(ids), view)  # logits dropped by design
        page_shape = (layers, n_pages, ps) + tuple(pool_k.shape[3:])
        wids = row_t[start // ps : start // ps + n_pages]
        pool_k[:, wids] = view["k"][:, 0, start : start + span].reshape(page_shape)
        pool_v[:, wids] = view["v"][:, 0, start : start + span].reshape(page_shape)

    def _copy_page(self, src: int, dst: int) -> None:
        """The device half of copy-on-write: one page, every layer."""
        self.cache.k[:, dst] = self.cache.k[:, src]
        self.cache.v[:, dst] = self.cache.v[:, src]

    # -- request intake ------------------------------------------------------

    def warmup(self) -> None:
        """Run one synthetic single-token request per prefill bucket, each
        prompt a distinct token so no prefix hit skips a bucket. This builds
        the kernels and touches every prefill span and the decode step
        before traffic arrives. The synthetic requests stay out of the
        prefix cache, and the statistics restart afterwards."""
        self._warming = True
        cap, self.scheduler.max_queue = self.scheduler.max_queue, None
        try:
            for i, bucket in enumerate(self.buckets):
                length = min(bucket + 1, self.cache.max_len)
                self.submit(np.full((length,), i + 1, np.int32), max_new_tokens=1)
            self.run()
        finally:
            self.scheduler.max_queue = cap
            self._warming = False
        self.stats = ServingStats(
            self.cache.num_slots, num_pages=self.cache.num_pages, page_size=self.cache.page_size
        )

    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        request_id: Optional[int] = None,
        submitted_at: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> int:
        """Enqueue one request; returns its id. Raises ``ValueError`` for a
        request the engine can never serve and :class:`QueueFull` when
        admission control sheds."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        prefill_len = prompt.size - 1
        if prefill_len > max(self.buckets):
            raise ValueError(
                f"prompt length {prompt.size} exceeds the largest prefill bucket "
                f"{max(self.buckets)} + 1"
            )
        if prefill_len + max_new_tokens > self.cache.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the slot capacity max_len={self.cache.max_len}"
            )
        # feasibility: the pages the request will ever pin, and the peak of
        # its bucket-padded prefill schedule, must fit the pool
        ps = self.cache.page_size
        need = max(pages_for(prefill_len + max_new_tokens, ps), 1)
        done = 0
        while done < prefill_len:
            span = self._next_span(prefill_len - done, done)
            need = max(need, (done + span) // ps)
            done += min(span, prefill_len - done)
        if need > self.cache.num_pages - 1:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) needs "
                f"{need} pages but the pool holds {self.cache.num_pages - 1} × {ps} tokens"
            )
        try:
            request = self.scheduler.submit(
                prompt, max_new_tokens, request_id=request_id,
                submitted_at=submitted_at, deadline_s=deadline_s,
            )
        except QueueFull as e:
            self.stats.record_reject()
            hint = self.retry_after_hint()
            raise QueueFull(
                f"{e} — retry in ~{hint:.3f}s", queue_depth=e.queue_depth, retry_after_s=hint
            ) from None
        self.stats.record_submit()
        return request.id

    def cancel(self, request_id: int) -> bool:
        """Client cancellation: the request retires as ``cancelled`` at the
        top of the next ``step()``. Returns whether it was in flight."""
        return self.scheduler.cancel(request_id)

    def retry_after_hint(self) -> float:
        """Seconds until a queue position frees: the backlog drains in waves
        of ``num_slots`` requests, each (mean tokens per request) x (mean
        step time) long. Before any history, a conservative constant."""
        s = self.stats
        mean_step = s.decode_seconds / s.steps if s.steps else 0.01
        mean_tokens = s.tokens_generated / s.requests_completed if s.requests_completed else 16.0
        waves = math.ceil((self.scheduler.waiting + 1) / self.cache.num_slots)
        return max(waves * mean_tokens * mean_step, mean_step)

    def _free_slot(self, request: Request) -> Optional[int]:
        """The ``admit_ready`` callback: a free lane AND pages for the first
        prefill span, after a prefix-cache lookup; None leaves it queued."""
        if self.cache.lanes.free_count == 0:
            return None
        prefill_len = request.prompt.size - 1
        ps = self.cache.page_size
        sharing = self.prefix_sharing and not self._warming
        hit_len, shared = 0, []
        if sharing and prefill_len >= ps:
            hit_len, shared = self.cache.prefix.lookup(request.prompt[:prefill_len])
        # a long hit can leave a tail whose padded span overflows the table:
        # re-prefill enough of the prefix that the schedule fits
        while hit_len and not self._prefill_fits(prefill_len - hit_len, hit_len):
            hit_len -= ps
        shared = shared[: hit_len // ps]
        suffix = prefill_len - hit_len
        new_pages = self._next_span(suffix, hit_len) // ps if suffix > 0 else 1
        slot = self.cache.admit(shared, new_pages)
        if slot is None:
            return None
        request.prefilled = hit_len
        request.prefix_hit = hit_len
        if hit_len:
            self.stats.record_prefix_hit(hit_len)
        elif sharing and prefill_len >= ps:
            self.stats.record_prefix_miss()
        return slot

    def _next_span(self, remaining: int, position: int) -> int:
        """Tokens the next prefill span covers from ``position``: a full
        chunk while more than a chunk remains and the chunk cadence's padded
        final span still fits the table, else the bucket fitting the rest."""
        if (
            self.prefill_chunk is not None
            and remaining > self.prefill_chunk
            and self._chunk_cadence_fits(remaining, position)
        ):
            return self.prefill_chunk
        return bucket_for(remaining, self.buckets)

    def _chunk_cadence_fits(self, remaining: int, position: int) -> bool:
        chunk = self.prefill_chunk
        full = (remaining - 1) // chunk
        tail = remaining - full * chunk
        return position + full * chunk + bucket_for(tail, self.buckets) <= self.cache.view_len

    def _prefill_fits(self, remaining: int, position: int) -> bool:
        """Whether some prefill schedule for ``remaining`` tokens from
        ``position`` fits the page table (always true at position 0)."""
        if remaining <= 0:
            return True
        if (
            self.prefill_chunk is not None
            and remaining > self.prefill_chunk
            and self._chunk_cadence_fits(remaining, position)
        ):
            return True
        return position + bucket_for(remaining, self.buckets) <= self.cache.view_len

    # -- paged prefill / page pressure --------------------------------------

    def _advance_prefills(self) -> list[ServingResult]:
        """One prefill span per still-prefilling slot; returns requests
        failed by page pressure."""
        failed: list[ServingResult] = []
        for slot in list(self.scheduler.active_slots):
            request = self.scheduler.slots[slot]
            if request is None or self.cache.active[slot]:
                continue
            prefill_len = request.prompt.size - 1
            remaining = prefill_len - request.prefilled
            if remaining <= 0:
                self._finish_prefill(slot, request)
                continue
            span = self._next_span(remaining, request.prefilled)
            target = (request.prefilled + span) // self.cache.page_size
            need = target - int(self.cache.held[slot])
            if need > 0 and not self.cache.grow(slot, need):
                self.stats.record_page_pressure()
                status = self._reclaim_pages(
                    slot, request, retry=lambda: self.cache.grow(slot, need)
                )
                if status == "failed":
                    failed.append(self._fail_for_pages(slot, request))
                    continue
                if status == "yielded":
                    continue
            take = min(span, remaining)
            ids = np.zeros((1, span), np.int32)
            ids[0, :take] = request.prompt[request.prefilled : request.prefilled + take]
            chunked_span = not self._warming and (
                take < remaining or request.prefilled > request.prefix_hit
            )
            self._prefill(span, ids, self.cache.tables[slot], request.prefilled)
            request.prefilled += take
            self.stats.record_prefill(span)
            if chunked_span:
                self.stats.record_prefill_chunk()
            if request.prefilled >= prefill_len:
                self._finish_prefill(slot, request)
        return failed

    def _finish_prefill(self, slot: int, request: Request) -> None:
        """Every prompt token is in the pool: file the aligned prefix for
        future sharers and make the slot decode-visible."""
        prefill_len = request.prompt.size - 1
        if self.prefix_sharing and not self._warming:
            blocks = prefill_len // self.cache.page_size
            if blocks:
                self.cache.prefix.register_chain(
                    request.prompt[: blocks * self.cache.page_size],
                    self.cache.tables[slot, :blocks],
                )
        self.cache.lengths[slot] = prefill_len
        self.cache.active[slot] = True
        self._pending[slot] = request.prompt[-1]

    def _preempt_slot(self, slot: int) -> None:
        """Recompute-style eviction: back to the queue head, pages freed."""
        self.scheduler.preempt_slot(slot)
        self.cache.retire(slot)
        self._pending[slot] = 0
        self.stats.record_preempted()

    def _reclaim_pages(self, slot: int, request: Request, retry) -> str:
        """Page pressure on ``slot``: preempt strictly younger requests,
        youngest first, re-running ``retry()`` after each. If none is
        younger the requester yields (``"yielded"``); ``"failed"`` only when
        it is the lone active request and the pool is still dry."""
        while True:
            active = [
                s for s in self.scheduler.active_slots
                if s != slot and self.scheduler.slots[s] is not None
            ]
            younger = [s for s in active if self.scheduler.slots[s].id > request.id]
            if younger:
                victim = max(younger, key=lambda s: self.scheduler.slots[s].id)
                self._preempt_slot(victim)
                if retry():
                    return "ok"
                continue
            if active:
                self._preempt_slot(slot)
                return "yielded"
            return "failed"

    def _fail_for_pages(self, slot: int, request: Request) -> ServingResult:
        self.cache.retire(slot)
        done = self.scheduler.retire(slot, "failed")
        self._pending[slot] = 0
        self.stats.record_failed()
        return self._result_for(done)

    def _prepare_decode_writes(self) -> list[ServingResult]:
        """Back every decode-visible slot's write position with a private
        page: grow across boundaries, copy a shared page before the write."""
        failed: list[ServingResult] = []
        for slot in list(self.scheduler.active_slots):
            request = self.scheduler.slots[slot]
            if request is None or not self.cache.active[slot]:
                continue
            status, src, dst = self.cache.prepare_write(slot)
            if status == "pressure":
                self.stats.record_page_pressure()
                outcome: list = []

                def retry(slot=slot, outcome=outcome):
                    outcome[:] = [self.cache.prepare_write(slot)]
                    return outcome[0][0] != "pressure"

                reclaimed = self._reclaim_pages(slot, request, retry=retry)
                if reclaimed == "failed":
                    failed.append(self._fail_for_pages(slot, request))
                    continue
                if reclaimed == "yielded":
                    continue
                status, src, dst = outcome[0]
            if status == "cow":
                self._copy_page(src, dst)
                self.stats.record_cow_copy()
        return failed

    # -- the step -------------------------------------------------------------

    def _result_for(self, request: Request) -> ServingResult:
        return ServingResult(
            request_id=request.id,
            prompt=request.prompt,
            generated=np.asarray(request.generated, np.int32),
            finish_reason=request.finish_reason,
            ttft_s=request.ttft_s,
            latency_s=request.latency_s,
        )

    def _retire_degraded(self, now: float) -> list[ServingResult]:
        """Cancelled and past-deadline requests, queued and active, retire
        before admission, so their slots serve the queue this step."""
        results = []
        for request in self.scheduler.sweep_queue(now):
            self._record_degraded(request)
            results.append(self._result_for(request))
        for slot in self.scheduler.active_slots:
            request = self.scheduler.slots[slot]
            if request.cancelled:
                reason = "cancelled"
            elif request.past_deadline(now):
                reason = "expired"
            else:
                continue
            self.cache.retire(slot)
            done = self.scheduler.retire(slot, reason)
            self._record_degraded(done)
            results.append(self._result_for(done))
        return results

    def _record_degraded(self, request: Request) -> None:
        if request.finish_reason == "cancelled":
            self.stats.record_cancelled()
        else:
            self.stats.record_expired()

    @torch.no_grad()
    def step(self) -> list[ServingResult]:
        """One engine iteration: retire cancelled/expired requests, admit,
        advance prefills, run one decode step over every slot, deliver and
        retire. Returns the requests that finished this step."""
        t0 = time.perf_counter()
        finished = self._retire_degraded(t0)
        for _ in self.scheduler.admit_ready(self._free_slot):
            pass  # admission only claims capacity; prefill runs below
        finished.extend(self._advance_prefills())
        finished.extend(self._prepare_decode_writes())
        active_idx = self.scheduler.active_slots
        if not any(self.cache.active[s] for s in active_idx):
            # no request is decode-visible yet: no device step
            return finished

        tokens = self._decode()
        now = time.perf_counter()
        delivered = 0
        for slot in active_idx:
            request = self.scheduler.slots[slot]
            if request is None or not self.cache.active[slot]:
                continue  # still prefilling: its lane ran inactive
            if request.cancelled:
                # a cancel that landed during the step wins over retirement
                self.cache.retire(slot)
                done = self.scheduler.retire(slot, "cancelled")
                self._record_degraded(done)
                finished.append(self._result_for(done))
                continue
            delivered += 1
            token = int(tokens[slot])
            request.generated.append(token)
            self.cache.lengths[slot] += 1
            if request.first_token_at is None:
                request.first_token_at = now
                self.stats.record_first_token(request.ttft_s)
            hit_eos = self.eos_token_id is not None and token == self.eos_token_id
            if hit_eos or len(request.generated) >= request.max_new_tokens:
                self.cache.retire(slot)
                done = self.scheduler.retire(slot, "eos" if hit_eos else "length")
                self.stats.record_finish(done.latency_s)
                finished.append(self._result_for(done))
            elif request.past_deadline(now):
                self.cache.retire(slot)
                done = self.scheduler.retire(slot, "expired")
                self._record_degraded(done)
                finished.append(self._result_for(done))
            else:
                self._pending[slot] = token
        self.stats.record_step(
            now - t0, active=len(active_idx), waiting=self.scheduler.waiting,
            tokens=delivered, pages_in_use=self.cache.pages_in_use,
        )
        return finished

    @property
    def busy(self) -> bool:
        return self.scheduler.busy

    def run(self) -> dict[int, ServingResult]:
        """Drive ``step()`` until queue and slots drain; results by id."""
        results: dict[int, ServingResult] = {}
        while self.busy:
            for result in self.step():
                results[result.request_id] = result
        return results

    def generate_many(self, prompts: Sequence[np.ndarray], max_new_tokens: int = 32) -> list[np.ndarray]:
        """One ``[S_i + max_new_tokens]`` row per prompt, EOS-filled past the
        first EOS: at temperature 0 the same ids as per-request ``generate()``."""
        ids = [self.submit(p, max_new_tokens) for p in prompts]
        results = self.run()
        return [
            generation_row(p, results[rid], max_new_tokens, self.eos_token_id)
            for p, rid in zip(prompts, ids)
        ]

    def metrics(self) -> dict:
        """Engine metrics, flat scalars."""
        return self.stats.snapshot()
