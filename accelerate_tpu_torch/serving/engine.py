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
  youngest request under page pressure;
- **quantized-resident weights** (:meth:`ServingEngine.from_streamed` over
  ``dispatch_model(..., quantization=QuantizationConfig(...))``): the layer
  matrices stay packed int8/int4 on the device and every projection runs
  through the fused dequant-matmul kernel (``ops/quant_matmul.py``);
- **speculative decoding** (``speculative=SpeculativeConfig(...)``,
  ``speculative.py``): a draft model proposes ``k`` tokens per slot and one
  forward over ``[num_slots, k + 1]`` verifies them through the paged verify
  kernel, one launch per layer; the longest agreeing prefix is committed,
  so at temperature 0 the tokens equal plain decode's. Linear and tree
  (COW-forked branches) modes.

The pools are updated in place (prefill scatter, decode write-back, the
copy-on-write page copy), which is what buffer donation buys the JAX engine.

Not in this port yet: the dense ``paged=False`` slab, quarantine and scrub,
chaos fault plans (and the speculation chaos knob), the step watchdog,
request tracing (and the draft/verify spans), the telemetry hub and its
speculative records, disaggregated park/adopt/extract and program analysis.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..big_modeling import QuantizedLayerPacker, StreamedModel
from ..models.generation import make_sampler, resolve_decode_protocol, resolve_window_protocol
from ..ops.quant_matmul import quant_dot
from ..ops.paged_attention import paged_verify_attention
from ..ops.runtime import resolve_device, same_device
from ..telemetry.serving import ServingStats
from ..utils.quantization import QuantizedWeight
from .kv_cache import bucket_for, prefill_buckets
from .paging import PagedKVCache, decode_into_pool, paged_buckets, pages_for, prefill_into_pool
from .scheduler import ContinuousBatchingScheduler, QueueFull, Request
from .speculative import SpeculativeConfig, SpeculativeState


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


def params_from_streamed(streamed: StreamedModel, quantized_resident: bool = False) -> dict:
    """Reassemble a :class:`~..big_modeling.StreamedModel` as a device-resident
    param tree in the JAX layout: host-placed components move to the device
    and every layer leaf is a ``[L, ...]`` view of one stacked buffer.

    The layers' packed buffers are copied one by one into that stacked
    buffer on the device, and each device-placed layer of the streamer is
    rebound to its row as it is copied: the card holds every layer once,
    whether or not the caller keeps the streamer.

    Without ``quantized_resident`` a quantized streamer's layers dequantize
    on the device to the streamer's dtype (W8A16/W4A16, a full-precision
    copy of every matrix). With it, matrix leaves stay packed as stacked
    :class:`~..utils.quantization.QuantizedWeight` views (int8 ``q`` and fp32
    ``scale``) for the fused dequant-matmul; vectors dequantize as before."""
    params = streamed.resident_tree()
    packer = streamed.packer
    quantized = isinstance(packer, QuantizedLayerPacker)
    layers = streamed.layer_buffers

    def parts(buf):  # a quantized layer is an (int8 data, fp32 sidecar) pair
        return buf if quantized else (buf,)

    stacked = tuple(
        torch.empty((len(layers),) + tuple(part.shape), dtype=part.dtype, device=streamed.device)
        for part in parts(layers[0])
    )
    for i, buf in enumerate(layers):
        for dst, src in zip(stacked, parts(buf)):
            dst[i].copy_(src)
        if streamed.layer_on_device[i]:  # drop the layer's own buffer
            rows = tuple(dst[i] for dst in stacked)
            layers[i] = rows if quantized else rows[0]
    bufs = stacked if quantized else stacked[0]
    params["layers"] = packer.unpack(bufs, quantized_resident) if quantized else packer.unpack(bufs)
    return params


def quantized_resident_params(streamed: StreamedModel) -> Optional[dict]:
    """The install policy of fused-dequant serving: on a quantized streamer,
    build the packed-resident params and install ``quant_dot`` as the
    model's ``dot_fn``. Returns the params, or None when the streamer is not
    quantized. Raises when another hook already owns the projections: that
    one is never replaced, and serving dequantized weights through it would
    run something else in the kernel's place."""
    if not isinstance(streamed.packer, QuantizedLayerPacker):
        return None
    current = streamed.model.dot_fn
    if current is not None and current is not quant_dot:
        raise ValueError(
            f"quantized-resident serving needs model.dot_fn to be quant_dot or None, "
            f"got {getattr(current, '__name__', current)!r}"
        )
    params = params_from_streamed(streamed, quantized_resident=True)
    streamed.model.dot_fn = quant_dot
    return params


def _attend_window(q, k_new, v_new, cache):
    """The verify ``attend`` hook: every slot's window over its pages plus
    the window's own keys, causal inside the window."""
    return paged_verify_attention(
        q, k_new, v_new, cache["k"], cache["v"], cache["table"], cache["length"]
    )


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
        speculative: Optional[SpeculativeConfig] = None,
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
        # target-model forwards by kind, for checks that count kernel launches
        self.forward_counts = {"prefill": 0, "decode": 0, "verify": 0}
        # speculative decoding (speculative.py): the draft's pools and tracking
        # live in SpeculativeState, the verify and the window bookkeeping here.
        # Temperature 0 only: acceptance is exact greedy match, which is what
        # makes the output token-equal to plain decode
        self.spec: Optional[SpeculativeState] = None
        if speculative is not None:
            if self.temperature != 0.0:
                raise ValueError(
                    "speculative decoding is temperature-0 only (acceptance is exact "
                    f"greedy match), got temperature={self.temperature}"
                )
            draft = speculative.draft_model
            if draft.config.vocab_size != model.config.vocab_size:
                raise ValueError(
                    f"draft vocab_size {draft.config.vocab_size} != target vocab_size "
                    f"{model.config.vocab_size}: drafted token ids would not be target tokens"
                )
            if not same_device(self.device, draft.device):
                raise ValueError(f"draft model is on {draft.device}, the engine on {self.device}")
            self.spec = SpeculativeState(speculative, self.cache)
            self._fwd_window = resolve_window_protocol(model)

    @classmethod
    def from_streamed(cls, streamed: StreamedModel, **kwargs) -> "ServingEngine":
        """Serve a :class:`~..big_modeling.StreamedModel`: the big-model
        placement (device maps, int8/int4 quantization) becomes the serving
        checkpoint path. The params reassemble on the device and are
        installed into ``streamed.model``, which the engine then serves;
        ``kwargs`` go to the constructor (``device`` must be the
        streamer's).

        On a quantized streamer the matrices stay packed on the device and
        ``quant_dot`` becomes the model's ``dot_fn``
        (:func:`quantized_resident_params`): serving reads 1-byte (int8) or
        half-byte (int4) weights through the fused dequant-matmul kernel and
        no full-precision copy of a layer matrix exists. An unquantized
        streamer serves its weights as they are."""
        params = quantized_resident_params(streamed)
        if params is None:
            params = params_from_streamed(streamed)
        streamed.model.install(params)
        return cls(streamed.model, **kwargs)

    # -- device work --------------------------------------------------------

    def _host_to_device(self, array: np.ndarray) -> torch.Tensor:
        # a copy: the host mirrors change right after the step
        return torch.tensor(array, device=self.device)

    def _decode(self) -> np.ndarray:
        """One decode step over every slot (``paging.decode_into_pool``);
        returns the sampled tokens (0 on inactive lanes)."""
        active = self._host_to_device(self.cache.active)
        logits = decode_into_pool(
            self._fwc, self.cache.k, self.cache.v, self._host_to_device(self._pending),
            self._host_to_device(self.cache.lengths), self._host_to_device(self.cache.tables),
            active, self.cache.page_size,
        )
        self.forward_counts["decode"] += 1
        nxt = torch.where(active, self._sample(logits, self._rng), 0)
        return nxt.cpu().numpy()  # the host fetch is the per-step fence

    def _prefill(self, span: int, ids: np.ndarray, row: np.ndarray, start: int) -> None:
        """Prefill ``span`` tokens at the page-aligned ``start``
        (``paging.prefill_into_pool``)."""
        prefill_into_pool(
            self._fwc, self.cache.k, self.cache.v, span, self._host_to_device(ids), row, start,
            self.cache.page_size,
        )
        self.forward_counts["prefill"] += 1

    def _verify(self, window: np.ndarray, active: np.ndarray, limits: np.ndarray, tables: np.ndarray):
        """Speculative verify: score every slot's ``k+1``-token window (the
        pending token plus the candidates) in one target forward through
        the paged verify kernel, and commit the longest agreeing prefix.

        Acceptance is greedy agreement: with ``toks[j]`` the argmax after
        window position ``j``, candidate ``window[j+1]`` is accepted iff it
        equals ``toks[j]`` and every earlier candidate was, so ``accepted =
        sum(cumprod(eq))``. The emitted run is ``toks[:emit]`` with ``emit =
        min(accepted + 1, limits)``: every emitted token is the target's own
        argmax on inputs the rule proved right, hence equal to plain decode,
        and a slot with no draft emits exactly its plain-decode token under
        ``limits = 1``. The write-back is the decode scatter widened to the
        window: positions ``length .. length+emit-1`` land in the slot's
        pages (grown by the host beforehand), every other row goes to the
        null page as zeros. Returns host ``(toks [S, w], accepted [S], emit
        [S])``."""
        ps = self.cache.page_size
        pps = self.cache.pages_per_slot
        w = window.shape[1]
        win = self._host_to_device(window)
        lengths = self._host_to_device(self.cache.lengths)
        tables_t = self._host_to_device(tables)
        active_t = self._host_to_device(active)
        cache = {"k": self.cache.k, "v": self.cache.v, "length": lengths,
                 "table": tables_t, "attend": _attend_window}
        logits, delta = self._fwd_window(win, cache)  # [S, w, V], K/V [L, S, w, KV, D]
        self.forward_counts["verify"] += 1
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        eq = (win[:, 1:] == toks[:, :-1]).to(torch.int32)
        accepted = torch.cumprod(eq, dim=1).sum(dim=1).to(torch.int32)
        emit = torch.where(
            active_t, torch.minimum(accepted + 1, self._host_to_device(limits)), 0
        ).to(torch.int32)
        steps = torch.arange(w, device=self.device)[None, :]
        pos = lengths[:, None] + steps  # [S, w]
        write = active_t[:, None] & (steps < emit[:, None])
        page_idx = torch.clamp(pos // ps, max=pps - 1).long()
        wpage = torch.where(write, tables_t.gather(1, page_idx), 0).long().reshape(-1)
        woff = torch.where(write, pos % ps, 0).long().reshape(-1)
        lane = write[None, :, :, None, None]
        pool_k, pool_v = self.cache.k, self.cache.v
        zero = torch.zeros((), dtype=pool_k.dtype, device=self.device)
        layers = pool_k.shape[0]
        flat = (layers, wpage.numel()) + tuple(pool_k.shape[3:])
        pool_k[:, wpage, woff] = torch.where(lane, delta["k"].to(pool_k.dtype), zero).reshape(flat)
        pool_v[:, wpage, woff] = torch.where(lane, delta["v"].to(pool_v.dtype), zero).reshape(flat)
        host = torch.cat([toks, accepted[:, None], emit[:, None]], dim=1).cpu().numpy()
        return host[:, :w], host[:, w], host[:, w + 1]

    def _copy_page(self, src: int, dst: int) -> None:
        """The device half of copy-on-write: one page, every layer (the
        draft pool's too, which indexes through the same table rows)."""
        self.cache.k[:, dst] = self.cache.k[:, src]
        self.cache.v[:, dst] = self.cache.v[:, src]
        if self.spec is not None and self.spec.enabled:
            self.spec.copy_page(src, dst)

    # -- request intake ------------------------------------------------------

    def warmup(self) -> None:
        """Run one synthetic single-token request per prefill bucket, each
        prompt a distinct token so no prefix hit skips a bucket. This builds
        the kernels and touches every prefill span and the decode (or
        verify) step before traffic arrives. The synthetic requests stay out
        of the prefix cache, and the statistics and forward counts restart
        afterwards."""
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
        self.forward_counts = dict.fromkeys(self.forward_counts, 0)

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
            if self.spec is not None and self.spec.enabled:
                # mirror the span into the draft pool (same ids, row and
                # start) so the slot can draft the moment it decodes, and so
                # pages filed in the prefix cache carry draft content too
                self.spec.prefill(span, ids, self.cache.tables[slot], request.prefilled)
                if int(self.spec.draft_len[slot]) == request.prefilled:
                    self.spec.draft_len[slot] = request.prefilled + take
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

    # -- speculative decoding (speculative.py) --------------------------------

    def disable_speculation(self, reason: str) -> None:
        """Permanent opt-out: plain paged decode from the next step on. Both
        paths consume ``_pending[slot]`` at position ``lengths[slot]`` and
        advance by what they emit, so no token is dropped or duplicated."""
        if self.spec is None or not self.spec.enabled:
            return
        self.spec.disable(reason)
        self.stats.record_spec_fallback()

    def _spec_catch_up(self, slot: int, request: Request) -> None:
        """Bring the draft pool's content for ``slot`` up to the committed
        length with mirrored prefill spans (a slot that spent a stretch not
        drafting). The input at position ``p`` is ``concat(prompt,
        generated)[p]`` for every ``p < length``; spans start at
        ``draft_len``'s page, and padded span tails land in the null page."""
        spec = self.spec
        ps = self.cache.page_size
        length = int(self.cache.lengths[slot])
        history = np.concatenate([request.prompt, np.asarray(request.generated, np.int32)])
        while int(spec.draft_len[slot]) < length:
            start = (int(spec.draft_len[slot]) // ps) * ps
            span = self._next_span(length - start, start)
            take = min(span, length - start)
            ids = np.zeros((1, span), np.int32)
            ids[0, :take] = history[start : start + take]
            spec.prefill(span, ids, self.cache.tables[slot], start)
            spec.draft_len[slot] = start + take

    def _spec_limits(self, active_idx) -> tuple[np.ndarray, np.ndarray]:
        """Per-slot emit caps for one speculative step. Decode-visible lanes
        get at least 1 (verifying a bare pending token is the plain decode);
        slots that can draft (healthy, draft pool caught up, more than one
        token of budget left, window pages securable) get ``min(k,
        budget)``. The cap stays at ``k``, not ``k + 1``: without the bonus
        token ``draft_len == lengths`` holds in steady state."""
        spec = self.spec
        k = spec.config.k
        ps = self.cache.page_size
        limits = np.ones((self.cache.num_slots,), np.int32)
        drafting = np.zeros((self.cache.num_slots,), bool)
        for slot in active_idx:
            request = self.scheduler.slots[slot]
            if request is None or not self.cache.active[slot]:
                continue
            budget = request.max_new_tokens - len(request.generated)
            if budget <= 1 or not spec.draft_ok[slot]:
                continue
            length = int(self.cache.lengths[slot])
            if int(spec.draft_len[slot]) < length:
                self._spec_catch_up(slot, request)
            if int(spec.draft_len[slot]) != length:
                continue
            want = min(k, budget)
            need = pages_for(length + want, ps) - int(self.cache.held[slot])
            if need > 0 and not self.cache.grow(slot, need):
                # page pressure: the slot decodes at the plain rate this step
                self.stats.record_page_pressure()
                continue
            limits[slot] = want
            drafting[slot] = True
        return limits, drafting

    def _spec_device_step(self, active_idx):
        """One speculative step over every lane, in place of the plain
        decode: draft up to ``k`` candidates per eligible slot, verify every
        slot's window in one target forward, commit the longest agreeing
        prefix. Returns ``(tokens [S, w], emit [S], drafted [S])``;
        ``drafted`` marks the slots to trim and advance after the step."""
        spec = self.spec
        limits, drafting = self._spec_limits(active_idx)
        window = np.zeros((self.cache.num_slots, spec.config.k + 1), np.int32)
        window[:, 0] = self._pending
        if spec.config.mode == "tree" and drafting.any():
            tokens, emit, drafted, proposed = self._spec_tree_step(window, limits, drafting)
        else:
            tokens, emit, drafted, proposed = self._spec_linear_step(window, limits, drafting)
        if not self._warming and drafted.any():
            accepted = [max(int(emit[s]) - 1, 0) for s in np.flatnonzero(drafted)]
            self.stats.record_spec_step(proposed=proposed, accepted_lengths=accepted)
        return tokens, emit, drafted

    def _spec_linear_step(self, window, limits, drafting):
        """Linear mode: one greedy draft chain per drafting slot (launch
        ``i`` consumes launch ``i-1``'s token at position ``length + i``),
        then one verify. Each launch is masked to the slots whose cap it
        still serves, so draft writes never pass ``length + limits - 1``,
        inside the pages ``_spec_limits`` secured."""
        spec = self.spec
        drafted = drafting.copy()
        lengths0 = self.cache.lengths.copy()
        chain = self._pending.copy()
        proposed = 0
        for i in range(int(limits.max()) if drafting.any() else 0):
            step_active = drafting & (i < limits)
            if not step_active.any():
                break
            nxt, ok = spec.decode(
                np.where(step_active, chain, 0), lengths0 + i, step_active, self.cache.tables
            )
            proposed += int(step_active.sum())
            for slot in np.flatnonzero(step_active & ~ok):
                # the draft went non-finite: stop extending this chain; the
                # candidates already in the window stay usable (verify decides)
                spec.fail_slot(int(slot), self.cache.tables, int(self.cache.held[slot]))
                drafting[slot] = False
            good = step_active & ok
            window[good, i + 1] = nxt[good]
            chain = np.where(good, nxt, chain).astype(np.int32)
        tokens, _, emit = self._verify(window, self.cache.active, limits, self.cache.tables)
        return tokens, emit, drafted, proposed

    def _spec_tree_step(self, window, limits, drafting):
        """Tree mode: fork up to ``num_branches`` branches per drafting slot
        off the draft's top-B first tokens, verify each branch, commit the
        one the target agrees with longest.

        Page protocol, in this order: the seed launch runs on the slots' own
        rows and writes the pending position's draft K/V into the boundary
        page; then branch rows fork. Committed pages below the boundary are
        shared by refcount (verify never writes them), the boundary page is
        copied in both pools (``_copy_page``), each branch's tail is fresh
        pages. Commit swaps the winner's segment into the slot's table row
        (which serves both pools) and drops every other reference. Pressure
        drops branches (worst case: branch 0 alone, which is linear mode).
        Top-B seeds are distinct, so only one branch can start with the
        target's first choice: every branch emits a prefix of the
        temperature-0 stream, and the winner (lowest branch on ties) keeps
        the output equal to plain decode."""
        spec = self.spec
        B = spec.config.num_branches
        ps = self.cache.page_size
        S = self.cache.num_slots
        drafted = drafting.copy()
        lengths0 = self.cache.lengths.copy()
        seeds, ok = spec.decode(
            np.where(drafting, self._pending, 0), lengths0, drafting, self.cache.tables, top_b=B
        )
        for slot in np.flatnonzero(drafting & ~ok):
            spec.fail_slot(int(slot), self.cache.tables, int(self.cache.held[slot]))
            drafting[slot] = False
            limits[slot] = 1
        proposed = int(drafting.sum())
        # branches[slot] = (idx0, target, rows): rows[0] is the slot's own
        # row, rows[b >= 1] a private boundary copy plus a fresh tail
        branches: dict[int, tuple[int, int, list[np.ndarray]]] = {}
        for slot in np.flatnonzero(drafting):
            slot = int(slot)
            length = int(lengths0[slot])
            idx0 = length // ps
            target = pages_for(length + int(limits[slot]), ps)
            rows = [self.cache.tables[slot].copy()]
            committed = [int(p) for p in self.cache.tables[slot, :idx0] if p]
            src = int(self.cache.tables[slot, idx0])
            for _ in range(1, B):
                fresh = self.cache._alloc(target - idx0)
                if fresh is None:
                    break  # pressure: fewer branches this step
                self.cache.pages.fork(committed)
                row = self.cache.tables[slot].copy()
                row[idx0:target] = fresh
                self._copy_page(src, fresh[0])
                self.stats.record_cow_copy()
                rows.append(row)
            branches[slot] = (idx0, target, rows)
        nb = np.zeros((S,), np.int32)
        for slot, (_, _, rows) in branches.items():
            nb[slot] = len(rows)
        bmax = int(nb.max()) if branches else 0
        wins, tabs, chains = [], [], []
        for b in range(bmax):
            tb = self.cache.tables.copy()
            wb = window.copy()
            for slot, (_, _, rows) in branches.items():
                if b < len(rows):
                    tb[slot] = rows[b]
                    wb[slot, 1] = seeds[slot, b]
            wins.append(wb)
            tabs.append(tb)
            chains.append(wb[:, 1].copy())
        # branch chains: launch (i, b) advances branch b of every tree slot
        for i in range(1, int(limits.max()) if branches else 0):
            for b in range(bmax):
                act = drafting & (nb > b) & (i < limits)
                if not act.any():
                    continue
                nxt, ok = spec.decode(np.where(act, chains[b], 0), lengths0 + i, act, tabs[b])
                proposed += int(act.sum())
                for slot in np.flatnonzero(act & ~ok):
                    # a branch chain went non-finite: the slot stops drafting
                    # (every branch's draft pages scrubbed) and emits its one
                    # plain-decode token
                    slot = int(slot)
                    idx0_, target_, rows = branches[slot]
                    spec.draft_ok[slot] = False
                    spec.scrub_pages({int(r[j]) for r in rows for j in range(idx0_, target_)})
                    drafting[slot] = False
                    limits[slot] = 1
                good = act & ok
                wins[b][good, i + 1] = nxt[good]
                chains[b] = np.where(good, nxt, chains[b]).astype(np.int32)
        toks_b, acc_b, emit_b = [], [], []
        for b in range(max(bmax, 1)):
            wb = wins[b] if b < len(wins) else window
            tb = tabs[b] if b < len(tabs) else self.cache.tables
            # lanes whose slot has no branch b are masked off: their writes
            # would land through the original row over branch 0's window K/V
            act = self.cache.active & ~(drafted & (nb <= b)) if b else self.cache.active
            toks, accepted, emit = self._verify(wb, act, limits, tb)
            toks_b.append(toks)
            acc_b.append(accepted)
            emit_b.append(emit)
        tokens = toks_b[0].copy()
        emit = emit_b[0].copy()
        # commit: each tree slot's winner swaps in; every branch reference
        # drops (forked committed refs, loser pages and, for a winner b >= 1,
        # the replaced originals)
        for slot, (idx0, target, rows) in branches.items():
            accs = [int(acc_b[b][slot]) for b in range(len(rows))]
            win = int(np.argmax(accs)) if drafting[slot] else 0
            committed = [int(p) for p in rows[0][:idx0] if p]
            for b in range(1, len(rows)):
                for p in committed:
                    self.cache.pages.decref(p)
                if b != win:
                    for j in range(idx0, target):
                        if int(rows[b][j]):
                            self.cache.pages.decref(int(rows[b][j]))
            if win > 0:
                for j in range(idx0, target):
                    if int(self.cache.tables[slot, j]):
                        self.cache.pages.decref(int(self.cache.tables[slot, j]))
                self.cache.tables[slot, idx0:target] = rows[win][idx0:target]
                tokens[slot] = toks_b[win][slot]
                emit[slot] = emit_b[win][slot]
        return tokens, emit, drafted, proposed

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
        for slot, request in self.scheduler.admit_ready(self._free_slot):
            # admission only claims capacity; prefill runs below
            if self.spec is not None:
                # draft health is per request, and a prefix hit's shared pages
                # carry the first holder's mirrored draft content, so drafting
                # resumes from the hit rather than from position 0
                self.spec.draft_ok[slot] = True
                self.spec.draft_len[slot] = request.prefilled
        finished.extend(self._advance_prefills())
        finished.extend(self._prepare_decode_writes())
        active_idx = self.scheduler.active_slots
        if not any(self.cache.active[s] for s in active_idx):
            # no request is decode-visible yet: no device step
            return finished

        drafted = None
        if self.spec is not None and self.spec.enabled:
            # the speculative step replaces the plain decode: every active
            # lane rides the verify (a lane with no draft verifies just its
            # pending token: emit 1, the plain-decode token)
            tokens, emit, drafted = self._spec_device_step(active_idx)
        else:
            tokens = self._decode()[:, None]
            emit = np.ones((self.cache.num_slots,), np.int32)
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
            # up to emit[slot] tokens; the retire gates (EOS, budget) apply
            # per token in order, so a window whose middle token is EOS
            # retires there and drops the tail, as plain decode would
            retired = False
            for j in range(int(emit[slot])):
                delivered += 1
                token = int(tokens[slot, j])
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
                    retired = True
                    break
            if retired:
                continue
            if request.past_deadline(now):
                self.cache.retire(slot)
                done = self.scheduler.retire(slot, "expired")
                self._record_degraded(done)
                finished.append(self._result_for(done))
            else:
                self._pending[slot] = token
        if drafted is not None:
            # speculative rollback: a slot that drafted grew its table for the
            # whole window; release what the accepted prefix did not reach
            # and advance the draft pool's high-water mark
            for slot in np.flatnonzero(drafted):
                if self.scheduler.slots[slot] is None or not self.cache.active[slot]:
                    continue  # retired mid-window: its pages are already released
                self.cache.trim_to_length(slot)
                if self.spec.draft_ok[slot]:
                    self.spec.draft_len[slot] = int(self.cache.lengths[slot])
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
