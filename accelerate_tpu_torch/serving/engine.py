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
  (COW-forked branches) modes;
- **the dense slab** (``paged=False``): one ``[L, num_slots, max_len, KV,
  D]`` cache the caller names instead of the pool. Prefill writes a slot's
  bucket into the slab; decode attends each slot's slab positions below its
  length plus its new key by the models' plain attention (the JAX engine's
  dense path runs no kernel either). No prefix sharing, chunking or
  speculation;
- **degradation**: a per-slot finite verdict on the logits, computed on the
  device and fetched with the tokens (a non-finite lane samples from zeros,
  so the categorical draw at temperature > 0 never sees it), quarantines a
  poisoned slot (its
  request requeues at the head of the queue, or fails after
  ``max_request_requeues``), scrubs its freed pages (the draft pool's
  copies too) or its slab row, and a probe decode of the empty slot
  releases it (``max_probe_failures``). ``step_timeout_s`` arms a
  wall-clock :class:`StepWatchdog` around each decode and reports an
  oversized step that completed;
- **drain and handoff**: ``drain`` stops admission and hands the queue back
  for re-homing; ``submit(prefill_only=True)`` parks a prefilled request's
  pages, ``extract_pages`` copies them to the host and ``adopt_kv`` seats
  them on another engine, which decodes on from the parked position. The
  router (``router.py``) drives these across a fleet;
- **request tracing** (``tracer=``, ``telemetry/tracing.py``): the queued,
  admitted, prefill, parked, decode, draft, verify, first-token and retired
  spans of every request, stamped with ``name`` (the replica's name in a
  fleet). Every stamp is a host-clock read at a point the engine already
  synchronizes (submission, admission, park, retirement, the per-step token
  fetch); decode marks and draft/verify spans are sampled every
  ``tracer.sample_every`` steps.

- **telemetry** (``telemetry=``, a ``telemetry.Telemetry`` hub): one
  ``{"kind": "kernels"}`` record at the first step (:meth:`kernel_summary`:
  which kernels the engine runs, and the launches of each it has made),
  ``{"kind": "resilience"}`` records for every degradation (shed, drain,
  expiry, cancellation, quarantine and its release, failure, preemption,
  parking, the watchdog, a speculation fallback), ``{"kind":
  "speculative"}`` records, and ``{"kind": "serving"}`` from
  :meth:`flush_telemetry`;
- **chaos** (``fault_plan=``, else the plan ``resilience.chaos.activate``
  registered): ``serving_burst`` pushes synthetic requests past admission
  control at a scheduled step, ``spec_disable`` turns speculation off
  mid-stream (the tokens stay those of plain decode).

The pools are updated in place (prefill scatter, decode write-back, the
copy-on-write page copy, the scrub), which is what buffer donation buys the
JAX engine. Program analysis (``analyze``) waits for ROADMAP item 21.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..big_modeling import QuantizedLayerPacker, StreamedModel
from ..models.attention import dot_product_attention
from ..models.generation import make_sampler, resolve_decode_protocol, resolve_window_protocol
from ..ops.quant_matmul import quant_dot, quant_matmul
from ..ops.paged_attention import paged_decode_attention, paged_verify_attention
from ..ops.runtime import resolve_device, same_device
from ..telemetry.serving import ServingStats
from ..utils.quantization import QuantizedWeight
from .kv_cache import SlotKVCache, bucket_for, prefill_buckets
from .paging import PagedKVCache, decode_into_pool, paged_buckets, pages_for, prefill_into_pool
from .scheduler import ContinuousBatchingScheduler, QueueFull, Request
from .speculative import SpeculativeConfig, SpeculativeState


# the kernels an engine's steps launch, by the name the launch counts go under
KERNEL_WRAPPERS = {"paged_decode": paged_decode_attention, "paged_verify": paged_verify_attention,
                   "quant_matmul": quant_matmul}


@dataclass
class ServingResult:
    """One finished request: ids + the latency the user saw."""

    request_id: int
    prompt: np.ndarray  # [S]
    generated: np.ndarray  # [<= max_new_tokens], ends with EOS when hit
    finish_reason: str  # "eos" | "length" | "expired" | "cancelled" | "failed" | "prefilled"
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
    param tree in the JAX layout: host- and disk-placed components move to
    the device and every layer leaf is a ``[L, ...]`` view of one stacked
    buffer. A streamer that a hook chain evicted is restored first.

    The layers' packed buffers (int8 packs still quantized; a disk layer
    read from its memmap) are copied one by one into that stacked buffer on
    the device, and each device-placed layer of the streamer is rebound to
    its row as it is copied: the card holds every layer once, whether or
    not the caller keeps the streamer.

    Without ``quantized_resident`` a quantized streamer's layers dequantize
    on the device to the streamer's dtype (W8A16/W4A16, a full-precision
    copy of every matrix). With it, matrix leaves stay packed as stacked
    :class:`~..utils.quantization.QuantizedWeight` views (int8 ``q`` and fp32
    ``scale``) for the fused dequant-matmul; vectors dequantize as before."""
    streamed._before_execute()
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


def _attend_slab(q, k_new, v_new, cache):
    """The dense slab's ``attend`` hook: each slot's query over its slab
    positions below its length (zeroed past it, so nothing non-finite there
    reaches the products) plus its new key, by the models' plain attention
    under a ``[slots, 1, 1, T + 1]`` mask."""
    slab_k, slab_v, lengths = cache["k"], cache["v"], cache["length"]  # [S, T, KV, D], [S]
    valid = torch.arange(slab_k.shape[1], device=q.device)[None, :] < lengths[:, None]
    zero = torch.zeros((), dtype=slab_k.dtype, device=q.device)
    lane = valid[:, :, None, None]
    keys = torch.cat([torch.where(lane, slab_k, zero), k_new.to(slab_k.dtype)], dim=1).to(q.dtype)
    values = torch.cat([torch.where(lane, slab_v, zero), v_new.to(slab_v.dtype)], dim=1).to(q.dtype)
    mask = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)[:, None, None, :]
    return dot_product_attention(q, keys, values, mask=mask)


class StepWatchdog:
    """Wall-clock monitor of the blocking decode step.

    A wedged step blocks the host thread that would report it, so one daemon
    thread watches a deadline the engine arms around every decode: one trip
    per armed step, reported through ``on_hang(elapsed_s)``. The thread only
    records; it never touches the card. ``close()`` stops it."""

    def __init__(self, timeout_s: float, on_hang, poll_s: Optional[float] = None):
        self.timeout_s = float(timeout_s)
        self.on_hang = on_hang
        self.poll_s = poll_s if poll_s is not None else max(self.timeout_s / 4.0, 0.01)
        self.fired = False
        self._deadline: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def arm(self) -> None:
        # `fired` goes False -> True once per armed window, and is reset
        # here before the deadline is published
        self.fired = False
        self._deadline = time.monotonic() + self.timeout_s
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="serving-step-watchdog", daemon=True)
            self._thread.start()

    def disarm(self) -> None:
        self._deadline = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            deadline = self._deadline
            if deadline is not None and not self.fired and time.monotonic() > deadline:
                self.fired = True
                try:
                    self.on_hang(time.monotonic() - deadline + self.timeout_s)
                except Exception:  # noqa: BLE001 - the monitor keeps monitoring
                    pass

    def close(self) -> None:
        self._stop.set()


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
        step_timeout_s: Optional[float] = None,
        max_probe_failures: int = 16,
        max_request_requeues: int = 2,
        paged: bool = True,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prefix_sharing: bool = True,
        prefix_cache_entries: int = 256,
        speculative: Optional[SpeculativeConfig] = None,
        name: Optional[str] = None,
        tracer=None,
        telemetry=None,
        fault_plan=None,
        device=None,
    ):
        self.device = resolve_device(device)
        if not same_device(self.device, model.device):
            raise ValueError(f"model is on {model.device}, the engine was asked for {self.device}")
        if getattr(model, "learned_positions", False) and max_len > model.config.max_seq_len:
            # a position past the table has no embedding (a CUDA lookup past
            # it ends the process): the slots stop at max_seq_len
            raise ValueError(
                f"max_len {max_len} exceeds the model's max_seq_len {model.config.max_seq_len} "
                "(learned positions)"
            )
        if speculative is not None and not paged:
            raise ValueError(
                "speculative decoding needs the paged engine (paged=True): "
                "the draft pool shares the page tables"
            )
        self.model = model
        # ``name`` tags this engine's trace spans: a router names each replica
        self.name = name
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self._sample = make_sampler(temperature)
        self._init_cache, self._fwc = resolve_decode_protocol(model)
        self.paged = paged
        base_buckets = tuple(buckets) if buckets is not None else prefill_buckets(max_len - 1)
        if paged:
            # the pool holds K/V in the model's dtype: the kernel reads both in one type
            self.cache = PagedKVCache(
                self._init_cache, num_slots, max_len, page_size=page_size, num_pages=num_pages,
                dtype=model.dtype, prefix_entries=prefix_cache_entries, device=self.device,
            )
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
        else:
            self.cache = SlotKVCache(self._init_cache, num_slots, max_len, dtype=model.dtype, device=self.device)
            self.buckets = base_buckets
            if max(self.buckets) > max_len:
                raise ValueError(f"largest bucket {max(self.buckets)} exceeds max_len {max_len}")
            self.prefill_chunk = None
            self.prefix_sharing = False
        self.scheduler = ContinuousBatchingScheduler(num_slots, max_queue=max_queue)
        self._pending = np.zeros((num_slots,), np.int32)  # next input token per slot
        if rng is None and self.temperature > 0.0:
            rng = torch.Generator(device=self.device).manual_seed(0)
        self._rng = rng
        self.stats = self._new_stats()
        # wait-quote baseline (reset_service_estimate): quotes price from the
        # stats' deltas past this snapshot
        self._quote_base = (0, 0.0, 0, 0)
        self._warming = False  # warmup(): synthetic prompts skip the prefix cache
        # target-model forwards by kind, for checks that count kernel launches
        self.forward_counts = {"prefill": 0, "decode": 0, "verify": 0}
        # degradation: the watchdog, and the quarantine's probe and requeue caps.
        # A request re-quarantined max_request_requeues times is failing on its
        # own input, not a bad slot's: it fails instead of requeueing for ever
        self.step_timeout_s = step_timeout_s
        self._watchdog = StepWatchdog(step_timeout_s, self._on_watchdog_trip) if step_timeout_s is not None else None
        self._decode_warm = False  # a decode has run: the kernels are built
        self.max_probe_failures = max_probe_failures
        self.max_request_requeues = max_request_requeues
        self._probe_failures: dict[int, int] = {}
        # request tracing: a fleet's engines and router share one tracer, so
        # a handed-off request keeps one trace. Decode steps run so far (not
        # reset by warmup) pace its sampled marks
        self.tracer = tracer
        # the telemetry hub's sink, and the chaos plan: an explicit plan wins,
        # else whatever resilience.chaos.activate registered process-wide
        self.telemetry = telemetry
        self._kernels_reported = False
        self._launches = dict.fromkeys(KERNEL_WRAPPERS, 0)
        if fault_plan is None:
            from ..resilience import chaos as _chaos_mod

            fault_plan = _chaos_mod.active_plan()
        self.chaos = fault_plan
        self._steps = 0
        self._prefill_open: set[int] = set()  # request ids with an open prefill span
        self._draining = False  # drain(): admit nothing, finish the active slots
        # prefill-only requests whose finished KV awaits a handoff: id -> layout
        # (pages still referenced in the pool, lane already free)
        self._parked: dict[int, dict] = {}
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

    def _new_stats(self) -> ServingStats:
        if self.paged:
            return ServingStats(self.cache.num_slots, num_pages=self.cache.num_pages, page_size=self.cache.page_size)
        return ServingStats(self.cache.num_slots)

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

    def _sample_with_verdict(self, logits: torch.Tensor, active: torch.Tensor):
        """Sampled tokens (0 on inactive lanes) and each lane's finite
        verdict on its logits, fetched to the host in one copy: the fetch is
        the per-step fence, and the verdict costs no synchronisation of its
        own. Returns host ``(tokens [S], finite [S])``."""
        ok = torch.isfinite(logits).all(dim=-1)
        # a non-finite lane samples from zeros: the categorical draw raises on NaN
        nxt = torch.where(active, self._sample(torch.where(ok[:, None], logits, 0), self._rng), 0)
        ok = ok.to(torch.int32)
        host = torch.stack([nxt.to(torch.int32), ok], dim=1).cpu().numpy()
        return host[:, 0], host[:, 1].astype(bool)

    def _decode(self):
        """One decode step over every slot: the paged decode
        (``paging.decode_into_pool``), or the dense slab's. Returns host
        ``(tokens [S], finite [S])``; a quarantined slot's lane is the probe
        (inactive, length 0: its verdict is all that is read)."""
        if not self.paged:
            return self._decode_dense()
        active = self._host_to_device(self.cache.active)
        logits = decode_into_pool(
            self._fwc, self.cache.k, self.cache.v, self._host_to_device(self._pending),
            self._host_to_device(self.cache.lengths), self._host_to_device(self.cache.tables),
            active, self.cache.page_size,
        )
        self.forward_counts["decode"] += 1
        return self._sample_with_verdict(logits, active)

    def _decode_dense(self):
        """The dense slab's decode: one forward over ``[num_slots, 1]``
        through the slab's ``attend`` hook, then each active slot's new K/V
        written at its length (the host knows which slots and where)."""
        active = self._host_to_device(self.cache.active)
        cache = {"k": self.cache.k, "v": self.cache.v,
                 "length": self._host_to_device(self.cache.lengths), "attend": _attend_slab}
        logits, delta = self._fwc(self._host_to_device(self._pending)[:, None], cache)
        self.forward_counts["decode"] += 1
        slots = np.flatnonzero(self.cache.active)
        if slots.size:
            rows = torch.tensor(slots, dtype=torch.long, device=self.device)
            cols = torch.tensor(self.cache.lengths[slots], dtype=torch.long, device=self.device)
            self.cache.k[:, rows, cols] = delta["k"][:, rows, 0].to(self.cache.k.dtype)
            self.cache.v[:, rows, cols] = delta["v"][:, rows, 0].to(self.cache.v.dtype)
        return self._sample_with_verdict(logits, active)

    def _prefill_dense(self, slot: int, request: Request) -> None:
        """Prefill ``prompt[:-1]`` into the slot's slab row at admission,
        padded to its bucket: the dense cache forward writes the slab in
        place through a view."""
        prefill_len = request.prompt.size - 1
        if prefill_len > 0:
            bucket = bucket_for(prefill_len, self.buckets)
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :prefill_len] = request.prompt[:-1]
            if self.tracer is not None:
                # closed at this step's token fetch, the first host stamp
                # after the prefill's device work
                self.tracer.span_start(
                    request.id, "prefill", replica=self.name, tokens=prefill_len, bucket=bucket
                )
                self._prefill_open.add(request.id)
            view = {"k": self.cache.k[:, slot : slot + 1, :bucket],
                    "v": self.cache.v[:, slot : slot + 1, :bucket], "length": 0}
            self._fwc(self._host_to_device(ids), view)  # logits dropped by design
            self.forward_counts["prefill"] += 1
            self.stats.record_prefill(bucket)
        request.prefilled = prefill_len
        self._pending[slot] = request.prompt[-1]
        if self.tracer is not None:
            self.tracer.span_start(request.id, "decode", replica=self.name, slot=slot)

    def _scrub(self, freed: list[int], slot: int) -> None:
        """Zero what a quarantined slot leaves behind before it is reused:
        the pool pages that became free (the draft pool's copies too), or
        the slot's slab row. Masked reads give a position weight 0, but 0 x
        NaN is NaN wherever a read is not zeroed first."""
        if not self.paged:
            self.cache.k[:, slot] = 0
            self.cache.v[:, slot] = 0
            return
        pages = sorted({int(p) for p in freed if p})  # the null page stays as it is
        if pages:
            idx = torch.tensor(pages, dtype=torch.long, device=self.device)
            self.cache.k[:, idx] = 0
            self.cache.v[:, idx] = 0
            if self.spec is not None:
                self.spec.scrub_pages(pages)

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
        [S], finite [S])``, ``finite`` the target's verdict on each slot's
        window logits (the quarantine trigger and probe)."""
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
        ok = torch.isfinite(logits).all(dim=-1).all(dim=-1).to(torch.int32)
        host = torch.cat([toks, accepted[:, None], emit[:, None], ok[:, None]], dim=1).cpu().numpy()
        return host[:, :w], host[:, w], host[:, w + 1], host[:, w + 2].astype(bool)

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
        self.stats = self._new_stats()
        self._quote_base = (0, 0.0, 0, 0)
        self.forward_counts = dict.fromkeys(self.forward_counts, 0)

    @property
    def queue_available(self) -> bool:
        """Whether ``submit`` would pass admission control right now."""
        max_queue = self.scheduler.max_queue
        return not self._draining and (max_queue is None or self.scheduler.waiting < max_queue)

    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        request_id: Optional[int] = None,
        submitted_at: Optional[float] = None,
        deadline_s: Optional[float] = None,
        prefill_only: bool = False,
    ) -> int:
        """Enqueue one request; returns its id. Raises ``ValueError`` for a
        request the engine can never serve and :class:`QueueFull` when
        admission control sheds or the engine is draining.

        ``prefill_only`` is the disaggregated intake: the engine prefills the
        prompt (chunked as usual), then parks the finished KV (lane freed,
        pages still referenced) and returns a ``"prefilled"`` result instead
        of decoding; ``kv_page_layout``/``extract_pages`` then hand it to
        another engine's ``adopt_kv``, and ``release_parked`` drops it here.
        Paged engines only."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prefill_only and not self.paged:
            raise ValueError("prefill_only serving needs a paged engine (paged=True)")
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
        if self.paged:
            # feasibility: the pages the request will ever pin, and the peak
            # of its bucket-padded prefill schedule, must fit the pool
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
        if self._draining:
            self.stats.record_reject()
            hint = self.retry_after_hint()
            self._resilience({"event": "shed", "reason": "draining",
                              "queue_depth": self.scheduler.waiting, "retry_after_s": hint})
            raise QueueFull(
                "engine is draining — not admitting new requests",
                queue_depth=self.scheduler.waiting, retry_after_s=hint,
            )
        try:
            request = self.scheduler.submit(
                prompt, max_new_tokens, request_id=request_id,
                submitted_at=submitted_at, deadline_s=deadline_s,
            )
        except QueueFull as e:
            self.stats.record_reject()
            hint = self.retry_after_hint()
            self._resilience({"event": "shed", "queue_depth": e.queue_depth, "retry_after_s": hint})
            raise QueueFull(
                f"{e} — retry in ~{hint:.3f}s", queue_depth=e.queue_depth, retry_after_s=hint
            ) from None
        request.prefill_only = prefill_only
        if self.tracer is not None and not self._warming:
            # begin() is idempotent per id: a failover re-submit (or a
            # handoff's fallback re-prefill) joins the request's trace with a
            # fresh queued span that starts now; only the first queued span
            # starts at submitted_at
            rejoining = self.tracer.has(request.id)
            self.tracer.begin(
                request.id, stamp=request.submitted_at,
                prompt_len=int(prompt.size), max_new_tokens=max_new_tokens,
            )
            self.tracer.span_start(
                request.id, "queued", stamp=None if rejoining else request.submitted_at,
                replica=self.name,
            )
        self.stats.record_submit()
        return request.id

    def cancel(self, request_id: int) -> bool:
        """Client cancellation: the request retires as ``cancelled`` at the
        top of the next ``step()`` (or, landing mid-step, at its end).
        Returns whether it was in flight. A parked request is no longer in
        flight here: ``release_parked`` drops it."""
        return self.scheduler.cancel(request_id)

    # -- drain and the service estimate ----------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> tuple[list[dict], list[ServingResult]]:
        """Stop admitting and hand the waiting queue back for re-homing. After
        this ``submit`` sheds and ``step()`` runs the active slots to their
        end. Returns ``(payloads, retired)``: the queued requests'
        re-submittable payloads (``Request.payload``), and the results of
        queued requests already cancelled or past their deadline, which end
        here rather than elsewhere."""
        self._draining = True
        retired = []
        for request in self.scheduler.sweep_queue(time.perf_counter()):
            self._record_degraded(request)
            retired.append(self._result_for(request))
        drained = self.scheduler.drain_queue()
        for _ in drained:
            self.stats.record_rehomed()
        self._resilience({"event": "drain", "queued_rehomed": len(drained),
                          "active": len(self.scheduler.active_slots)})
        return [request.payload for request in drained], retired

    def resume_admission(self) -> None:
        """Undo :meth:`drain`: the engine admits again."""
        self._draining = False

    def snapshot_requests(self, include_active: bool = True) -> list[dict]:
        """The payloads of every request in flight (queued and, by default,
        active), without removing any: what a router re-homes when this
        engine is lost. Cancelled requests are left out."""
        payloads = [r.payload for r in self.scheduler.queue if not r.cancelled]
        if include_active:
            payloads += [
                self.scheduler.slots[slot].payload for slot in self.scheduler.active_slots
                if not self.scheduler.slots[slot].cancelled
            ]
        return payloads

    def reset_service_estimate(self) -> None:
        """Forget the service-rate history the wait quotes are priced from
        (the statistics' counters stay): after a role change the old rates
        say nothing, and the quotes return to the no-history prior until
        new ones are measured."""
        s = self.stats
        self._quote_base = (s.steps, s.decode_seconds, s.tokens_generated, s.requests_completed)

    def _service_rates(self) -> tuple[float, float]:
        """(mean step seconds, mean tokens per completed request) since the
        last ``reset_service_estimate``; conservative constants before any
        history."""
        s = self.stats
        base_steps, base_seconds, base_tokens, base_completed = self._quote_base
        steps = s.steps - base_steps
        mean_step = (s.decode_seconds - base_seconds) / steps if steps else 0.01
        completed = s.requests_completed - base_completed
        mean_tokens = (s.tokens_generated - base_tokens) / completed if completed else 16.0
        return mean_step, mean_tokens

    def retry_after_hint(self) -> float:
        """Seconds until a queue position frees: the backlog drains in waves
        of ``num_slots`` requests, each (mean tokens per request) x (mean
        step time) long."""
        mean_step, mean_tokens = self._service_rates()
        waves = math.ceil((self.scheduler.waiting + 1) / self.cache.num_slots)
        return max(waves * mean_tokens * mean_step, mean_step)

    def drain_eta_hint(self) -> float:
        """Seconds until every active slot finishes: the wait quote of a
        draining engine, which admits nothing before then."""
        mean_step, _ = self._service_rates()
        remaining = 0
        for slot in self.scheduler.active_slots:
            request = self.scheduler.slots[slot]
            remaining = max(remaining, request.max_new_tokens - len(request.generated))
        return max(remaining * mean_step, mean_step)

    def _free_slot(self, request: Request) -> Optional[int]:
        """The ``admit_ready`` callback: a free slot (dense), or a free lane
        AND pages for the first prefill span after a prefix-cache lookup
        (paged); None leaves it queued."""
        prefill_len = request.prompt.size - 1
        if not self.paged:
            return self.cache.admit(prefill_len)
        if self.cache.lanes.free_count == 0:
            return None
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
        failed by page pressure and the ``"prefilled"`` results of parked
        prefill-only requests."""
        failed: list[ServingResult] = []
        for slot in list(self.scheduler.active_slots):
            request = self.scheduler.slots[slot]
            if request is None or self.cache.active[slot]:
                continue
            prefill_len = request.prompt.size - 1
            remaining = prefill_len - request.prefilled
            if remaining <= 0:
                parked = self._finish_prefill(slot, request)
                if parked is not None:
                    failed.append(parked)
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
            if self.tracer is not None:
                # one span per chunk, closed at the next token fetch
                self.tracer.span_start(
                    request.id, "prefill", replica=self.name,
                    tokens=take, span=span, position=request.prefilled,
                )
                self._prefill_open.add(request.id)
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
                parked = self._finish_prefill(slot, request)
                if parked is not None:
                    failed.append(parked)
        return failed

    def _finish_prefill(self, slot: int, request: Request) -> Optional[ServingResult]:
        """Every prompt token is in the pool: file the aligned prefix for
        future sharers and make the slot decode-visible, or, for a
        ``prefill_only`` request, park the finished KV for a handoff (the
        lane frees now, the pages stay referenced until ``release_parked``
        or ``resume_parked``) and return its ``"prefilled"`` result."""
        prefill_len = request.prompt.size - 1
        if self.prefix_sharing and not self._warming:
            blocks = prefill_len // self.cache.page_size
            if blocks:
                self.cache.prefix.register_chain(
                    request.prompt[: blocks * self.cache.page_size],
                    self.cache.tables[slot, :blocks],
                )
        if request.prefill_only:
            if self.tracer is not None:
                # the park ends this request's prefill here: the chunk span
                # closes now, and `parked` stays open until the handoff acks,
                # falls back or resumes
                self._prefill_open.discard(request.id)
                self.tracer.span_end(request.id, "prefill", stats=self.stats)
            pages = self.cache.park(slot)
            self._parked[request.id] = {
                "pages": pages,
                "page_size": self.cache.page_size,
                "length": prefill_len,
                "last_token": int(request.prompt[-1]),
                "page_shape": self._page_shape(),
                "dtype": str(self.cache.dtype),
            }
            self._pending[slot] = 0
            if self.tracer is not None:
                self.tracer.span_start(request.id, "parked", replica=self.name, pages=len(pages))
            done = self.scheduler.retire(slot, "prefilled")
            self.stats.record_parked()
            self._resilience({"event": "prefilled", "request_id": done.id, "pages": len(pages)})
            return self._result_for(done)
        self.cache.lengths[slot] = prefill_len
        self.cache.active[slot] = True
        self._pending[slot] = request.prompt[-1]
        if self.tracer is not None:
            self.tracer.span_start(request.id, "decode", replica=self.name, slot=slot)
        return None

    def _preempt_slot(self, slot: int, reason: str) -> None:
        """Recompute-style eviction: back to the queue head, pages freed."""
        preempted = self.scheduler.preempt_slot(slot)
        self.cache.retire(slot)
        self._pending[slot] = 0
        if self.tracer is not None:
            # the residence ended: its spans close and the request waits again
            self._prefill_open.discard(preempted.id)
            self.tracer.interrupt(preempted.id, outcome="preempted")
            self.tracer.span_start(preempted.id, "queued", replica=self.name, after="preempted")
        self.stats.record_preempted()
        self._resilience({"event": "preempted", "request_id": preempted.id, "slot": slot, "reason": reason})

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
                self._preempt_slot(victim, "page_pressure")
                if retry():
                    return "ok"
                continue
            if active:
                self._preempt_slot(slot, "page_pressure_yield")
                return "yielded"
            return "failed"

    def _fail_for_pages(self, slot: int, request: Request) -> ServingResult:
        self.cache.retire(slot)
        done = self.scheduler.retire(slot, "failed")
        self._pending[slot] = 0
        self.stats.record_failed()
        self._resilience({"event": "failed", "slot": slot, "request_id": done.id, "reason": "page_pressure"})
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
        self._resilience({"event": "spec_disabled", "reason": reason})
        if self.telemetry is not None:
            payload = {"event": "disabled", "fallback_reason": reason,
                       "k": self.spec.config.k, "mode": self.spec.config.mode}
            if self.name is not None:
                payload = {"engine": self.name, **payload}
            self.telemetry.write_record("speculative", payload)

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
        prefix. Returns ``(tokens [S, w], emit [S], finite [S], drafted
        [S])``: ``finite`` is the target's verdict (a non-finite draft never
        reaches it), ``drafted`` marks the slots to trim and advance after
        the step."""
        spec = self.spec
        limits, drafting = self._spec_limits(active_idx)
        window = np.zeros((self.cache.num_slots, spec.config.k + 1), np.int32)
        window[:, 0] = self._pending
        # sampled draft/verify spans: one window every tracer.sample_every steps
        spanned = []
        if (
            self.tracer is not None
            and not self._warming
            and (self._steps + 1) % self.tracer.sample_every == 0
        ):
            for slot in np.flatnonzero(drafting):
                request = self.scheduler.slots[int(slot)]
                if request is not None:
                    spanned.append(int(slot))
                    self.tracer.span_start(
                        request.id, "draft", replica=self.name, k=spec.config.k, mode=spec.config.mode
                    )
        if spec.config.mode == "tree" and drafting.any():
            tokens, emit, finite, drafted, proposed = self._spec_tree_step(window, limits, drafting, spanned)
        else:
            tokens, emit, finite, drafted, proposed = self._spec_linear_step(window, limits, drafting, spanned)
        if not self._warming and drafted.any():
            accepted = [max(int(emit[s]) - 1, 0) for s in np.flatnonzero(drafted)]
            self.stats.record_spec_step(proposed=proposed, accepted_lengths=accepted)
        return tokens, emit, finite, drafted

    def _spans_to_verify(self, spanned, args) -> None:
        """The sampled draft spans end and their verify spans start, with
        ``args(slot)`` as the verify span's attributes."""
        for slot in spanned:
            request = self.scheduler.slots[slot]
            if request is not None:
                self.tracer.span_end(request.id, "draft", stats=self.stats)
                self.tracer.span_start(request.id, "verify", replica=self.name, **args(slot))

    def _end_verify_spans(self, spanned, accepted, emit) -> None:
        for slot in spanned:
            request = self.scheduler.slots[slot]
            if request is not None:
                self.tracer.span_end(
                    request.id, "verify", stats=self.stats,
                    accepted=int(accepted[slot]), emitted=int(emit[slot]),
                )

    def _spec_linear_step(self, window, limits, drafting, spanned=()):
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
        self._spans_to_verify(spanned, lambda slot: {"window": len(window[slot])})
        tokens, accepted, emit, finite = self._verify(window, self.cache.active, limits, self.cache.tables)
        self._end_verify_spans(spanned, accepted, emit)
        return tokens, emit, finite, drafted, proposed

    def _spec_tree_step(self, window, limits, drafting, spanned=()):
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
                fresh = self.cache.alloc(target - idx0)
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
        self._spans_to_verify(spanned, lambda slot: {"branches": int(nb[slot])})
        toks_b, acc_b, emit_b = [], [], []
        finite = None
        for b in range(max(bmax, 1)):
            wb = wins[b] if b < len(wins) else window
            tb = tabs[b] if b < len(tabs) else self.cache.tables
            # lanes whose slot has no branch b are masked off: their writes
            # would land through the original row over branch 0's window K/V
            act = self.cache.active & ~(drafted & (nb <= b)) if b else self.cache.active
            toks, accepted, emit, ok = self._verify(wb, act, limits, tb)
            if finite is None:
                finite = ok  # launch 0 carries the probe
            toks_b.append(toks)
            acc_b.append(accepted)
            emit_b.append(emit)
        tokens = toks_b[0].copy()
        emit = emit_b[0].copy()
        accepted = acc_b[0].copy()
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
                accepted[slot] = acc_b[win][slot]
        self._end_verify_spans(spanned, accepted, emit)
        return tokens, emit, finite, drafted, proposed

    # -- the step -------------------------------------------------------------

    def _result_for(self, request: Request) -> ServingResult:
        if self.tracer is not None and request.finish_reason is not None:
            if request.finish_reason == "prefilled":
                # not terminal: the router hands the parked KV on and the
                # trace continues on the replica that decodes
                self.tracer.event(request.id, "prefilled", stamp=request.finished_at, replica=self.name)
            else:
                self._prefill_open.discard(request.id)
                self.tracer.retire(
                    request.id, request.finish_reason, stamp=request.finished_at,
                    stats=self.stats, replica=self.name,
                )
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
            self._record_degraded(done, slot=slot)
            results.append(self._result_for(done))
        return results

    def _record_degraded(self, request: Request, slot: Optional[int] = None) -> None:
        if request.finish_reason == "cancelled":
            self.stats.record_cancelled()
        else:
            self.stats.record_expired()
        payload = {"event": request.finish_reason, "request_id": request.id}
        if slot is not None:
            payload["slot"] = slot
        self._resilience(payload)

    def _inject_chaos_burst(self) -> None:
        """The chaos plan's queue-pressure burst: synthetic requests pushed
        straight into the scheduler's queue, past admission control, so real
        submits shed."""
        if self._draining:  # a draining engine admits nothing, chaos included
            return
        burst = self.chaos.serving_burst(self._steps) if self.chaos is not None else 0
        if not burst:
            return
        rng = np.random.default_rng(self.chaos.seed)
        for _ in range(burst):
            request = Request(id=next(self.scheduler._ids), prompt=rng.integers(0, 64, (2,)).astype(np.int32),
                              max_new_tokens=1)
            self.scheduler.queue.append(request)  # straight past admission control
            self.stats.record_submit()

    def _on_watchdog_trip(self, elapsed_s: float) -> None:
        """A step outlasted ``step_timeout_s`` (from the watchdog's thread, or
        synchronously for a step that completed): it only records."""
        self.stats.record_watchdog_trip()
        self._resilience({"event": "watchdog", "step": self._steps, "elapsed_s": round(elapsed_s, 4),
                          "timeout_s": self.step_timeout_s})

    def _quarantine(self, slot: int, request: Request, finished: list) -> None:
        """The slot produced non-finite logits: quarantine and scrub it. The
        request requeues at the head of the queue, unless it has been
        requeued ``max_request_requeues`` times: then the request is what
        drives the model non-finite, and it fails instead of livelocking
        the engine."""
        if request.requeues >= self.max_request_requeues:
            done = self.scheduler.retire(slot, "failed")
            self.stats.record_failed()
            self._resilience({"event": "failed", "slot": slot, "request_id": done.id, "requeues": done.requeues})
            finished.append(self._result_for(done))
        else:
            self.scheduler.requeue_front(slot)
            if self.tracer is not None:
                self._prefill_open.discard(request.id)
                self.tracer.interrupt(request.id, outcome="quarantined")
                self.tracer.span_start(request.id, "queued", replica=self.name, after="quarantine")
            self.stats.record_requeue()
            self._resilience({"event": "quarantine", "slot": slot, "request_id": request.id})
        freed = self.cache.quarantine(slot)  # the slab's quarantine frees no pages
        self._scrub(freed or [], slot)
        if self.spec is not None:
            self.spec.draft_len[slot] = 0
        self._pending[slot] = 0
        self._probe_failures[slot] = 0
        self.stats.record_quarantine()

    @torch.no_grad()
    def step(self) -> list[ServingResult]:
        """One engine iteration: retire cancelled/expired requests, admit,
        advance prefills, run one decode step over every slot (the probe of
        a quarantined slot rides it), quarantine slots whose logits went
        non-finite, deliver and retire. Returns the requests that finished
        this step."""
        before = {name: wrapper.launches for name, wrapper in KERNEL_WRAPPERS.items()}
        try:
            return self._step()
        finally:
            for name, wrapper in KERNEL_WRAPPERS.items():
                self._launches[name] += wrapper.launches - before[name]

    def _step(self) -> list[ServingResult]:
        t0 = time.perf_counter()
        self._report_kernels()
        finished = self._retire_degraded(t0)
        self._inject_chaos_burst()
        for slot, request in self.scheduler.admit_ready(self._free_slot):
            if self.tracer is not None:
                self.tracer.span_end(request.id, "queued", stamp=request.admitted_at, stats=self.stats)
                self.tracer.event(
                    request.id, "admitted", stamp=request.admitted_at,
                    replica=self.name, slot=slot, prefix_hit=request.prefix_hit,
                )
            if not self.paged:
                self._prefill_dense(slot, request)
            elif self.spec is not None:
                # admission only claims capacity; prefill runs below. Draft
                # health is per request, and a prefix hit's shared pages
                # carry the first holder's mirrored draft content, so
                # drafting resumes from the hit rather than from position 0
                self.spec.draft_ok[slot] = True
                self.spec.draft_len[slot] = request.prefilled
        if self.paged:
            finished.extend(self._advance_prefills())
            finished.extend(self._prepare_decode_writes())
        active_idx = self.scheduler.active_slots
        quarantined = sorted(self.cache.quarantined)
        if not quarantined and not any(self.cache.active[s] for s in active_idx):
            # no request is decode-visible yet and no probe is due: no device step
            return finished
        if not active_idx and quarantined and self.scheduler.waiting and all(
            self._probe_failures.get(s, 0) >= self.max_probe_failures for s in quarantined
        ):
            raise RuntimeError(
                f"all {len(quarantined)} slots quarantined and the finite-logits probe failed "
                f"{self.max_probe_failures}x on each: the model produces non-finite logits "
                "unconditionally"
            )

        # the watchdog watches steady-state decode: the first decode builds
        # the kernels and may take seconds
        if self._watchdog is not None and self._decode_warm:
            self._watchdog.arm()
        drafted = None
        if self.spec is not None and self.spec.enabled and self.chaos is not None and self.chaos.spec_disable(self._steps):
            # the chaos drill: plain decode from this very step on, for good;
            # the stream goes on without a dropped or repeated token
            self.disable_speculation("chaos")
        if self.spec is not None and self.spec.enabled:
            # the speculative step replaces the plain decode: every active
            # lane rides the verify (a lane with no draft verifies just its
            # pending token: emit 1, the plain-decode token)
            tokens, emit, finite, drafted = self._spec_device_step(active_idx)
        else:
            nxt, finite = self._decode()
            tokens = nxt[:, None]
            emit = np.ones((self.cache.num_slots,), np.int32)
        if self._watchdog is not None:
            self._watchdog.disarm()
        self._steps += 1
        now = time.perf_counter()
        if (
            self.step_timeout_s is not None
            and self._decode_warm
            and now - t0 > self.step_timeout_s
            and not (self._watchdog is not None and self._watchdog.fired)
        ):
            # an oversized step that completed before the thread's poll saw it
            self._on_watchdog_trip(now - t0)
        self._decode_warm = True
        if self.tracer is not None:
            # `now` follows the token fetch: every prefill dispatched so far
            # ran before it, and the sampled decode marks take its stamp
            for rid in self._prefill_open:
                self.tracer.span_end(rid, "prefill", stamp=now, stats=self.stats)
            self._prefill_open.clear()
            if self._steps % self.tracer.sample_every == 0:
                for slot in active_idx:
                    marked = self.scheduler.slots[slot]
                    if marked is not None and self.cache.active[slot]:
                        self.tracer.mark_decode(marked.id, self._steps, now)
        delivered = 0
        for slot in active_idx:
            request = self.scheduler.slots[slot]
            if request is None or not self.cache.active[slot]:
                continue  # still prefilling: its lane ran inactive
            if not finite[slot]:
                self._quarantine(slot, request, finished)
                continue
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
                    if self.tracer is not None:
                        self.tracer.event(request.id, "first_token", stamp=now, replica=self.name)
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
        for slot in quarantined:
            # the probe is this step's decode of the (empty) quarantined slot
            if finite[slot]:
                self.cache.release_quarantined(slot)
                self._probe_failures.pop(slot, None)
                self.stats.record_quarantine_release()
                self._resilience({"event": "quarantine_release", "slot": slot})
            else:
                self._probe_failures[slot] = self._probe_failures.get(slot, 0) + 1
        if drafted is not None:
            # speculative rollback: a slot that drafted grew its table for the
            # whole window; release what the accepted prefix did not reach
            # and advance the draft pool's high-water mark
            for slot in np.flatnonzero(drafted):
                if self.scheduler.slots[slot] is None or not self.cache.active[slot]:
                    continue  # retired or quarantined mid-window: its pages are released
                self.cache.trim_to_length(slot)
                if self.spec.draft_ok[slot]:
                    self.spec.draft_len[slot] = int(self.cache.lengths[slot])
        self.stats.record_step(
            now - t0, active=len(active_idx), waiting=self.scheduler.waiting,
            tokens=delivered, pages_in_use=self.cache.pages_in_use if self.paged else None,
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

    # -- the KV handoff between engines ---------------------------------------

    def _page_shape(self) -> tuple:
        """One page's block shape ``[L, page_size, KV, D]``: the unit a
        handoff moves."""
        return tuple(int(d) for i, d in enumerate(self.cache.k.shape) if i != 1)

    @property
    def parked_count(self) -> int:
        """Prefill-only requests whose finished KV awaits a handoff here."""
        return len(self._parked)

    def kv_page_layout(self, request_id: int) -> Optional[dict]:
        """The page-granular layout of one request's KV: which pages, in
        position order, holding how many positions, in what page shape and
        dtype. A parked request (``parked: True``, with the ``last_token``
        its destination decodes first) is the one a handoff moves. None on
        a dense engine or when the request holds no pages here."""
        if not self.paged:
            return None
        parked = self._parked.get(request_id)
        if parked is not None:
            return {"slot": None, "parked": True, **parked}
        for slot, request in enumerate(self.scheduler.slots):
            if request is None or request.id != request_id:
                continue
            pages = self.cache.pages_of(slot)
            if not pages:
                return None
            return {
                "slot": slot, "pages": pages, "page_size": self.cache.page_size,
                "length": int(self.cache.lengths[slot]), "prefilled": request.prefilled,
                "page_shape": self._page_shape(), "dtype": str(self.cache.dtype),
            }
        return None

    def extract_pages(self, pages: Sequence[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Host copies of ``pages``' K and V blocks, ``[n, L, page_size, KV,
        D]`` each in the pool's dtype (CPU tensors: numpy has no bf16): the
        source half of a handoff, one gather and one copy per pool."""
        idx = torch.tensor([int(p) for p in pages], dtype=torch.long, device=self.device)
        return (self.cache.k[:, idx].movedim(1, 0).cpu(), self.cache.v[:, idx].movedim(1, 0).cpu())

    def adopt_kv(
        self,
        prompt,
        max_new_tokens: int,
        layout: dict,
        k_blocks,
        v_blocks,
        request_id: Optional[int] = None,
        submitted_at: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> int:
        """Adopt a request whose prefill ran on another engine: claim a lane
        and pages, write the transferred blocks into them, and decode on
        from the position the source parked. ``layout["length"]`` must equal
        ``len(prompt) - 1`` (every prompt position is in the blocks and the
        first decode input is the prompt's last token, so no token is
        computed twice or skipped). A layout this pool cannot hold (page
        size, page shape or dtype) raises ``ValueError``; no free lane or
        pages right now raises :class:`QueueFull`. Returns the request id."""
        if not self.paged:
            raise ValueError("adopt_kv needs a paged engine (paged=True)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        length = int(layout["length"])
        k_blocks, v_blocks = torch.as_tensor(k_blocks), torch.as_tensor(v_blocks)
        n = k_blocks.shape[0]
        if length != prompt.size - 1:
            raise ValueError(
                f"adoption is not token-exact: layout holds {length} positions "
                f"but the prompt prefills {prompt.size - 1}"
            )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if n < 1 or n != v_blocks.shape[0]:
            raise ValueError(f"got {n} k-blocks / {v_blocks.shape[0]} v-blocks")
        if int(layout["page_size"]) != self.cache.page_size:
            raise ValueError(
                f"page_size mismatch: source {layout['page_size']}, this pool {self.cache.page_size}"
            )
        if tuple(layout["page_shape"]) != self._page_shape() or tuple(k_blocks.shape[1:]) != self._page_shape():
            raise ValueError(
                f"page_shape mismatch: source {tuple(layout['page_shape'])}, this pool {self._page_shape()}"
            )
        if str(layout.get("dtype", self.cache.dtype)) != str(self.cache.dtype):
            raise ValueError(f"dtype mismatch: source {layout['dtype']}, this pool {self.cache.dtype}")
        need = max(n, pages_for(length + max_new_tokens, self.cache.page_size))
        if n > self.cache.pages_per_slot or need > self.cache.num_pages - 1:
            raise ValueError(
                f"adopted request needs {need} pages but the pool holds "
                f"{self.cache.num_pages - 1} ({self.cache.pages_per_slot} per slot)"
            )
        if length + max_new_tokens > self.cache.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the slot capacity max_len={self.cache.max_len}"
            )
        if self._draining:
            raise QueueFull("engine is draining — not adopting new requests",
                            queue_depth=self.scheduler.waiting, retry_after_s=self.retry_after_hint())
        fresh = self.cache.alloc(n)
        if fresh is None:
            raise QueueFull(f"page pool cannot hold {n} adopted pages right now",
                            queue_depth=self.scheduler.waiting, retry_after_s=self.retry_after_hint())
        slot = self.cache.seat(fresh, length)
        if slot is None:
            for page in fresh:
                self.cache.pages.decref(page)
            raise QueueFull("no free lane for the adopted request",
                            queue_depth=self.scheduler.waiting, retry_after_s=self.retry_after_hint())
        idx = torch.tensor(fresh, dtype=torch.long, device=self.device)
        self.cache.k[:, idx] = k_blocks.to(self.device, self.cache.k.dtype).movedim(0, 1)
        self.cache.v[:, idx] = v_blocks.to(self.device, self.cache.v.dtype).movedim(0, 1)
        request = Request(
            id=request_id if request_id is not None else self.scheduler.next_id(),
            prompt=prompt, max_new_tokens=max_new_tokens, deadline_s=deadline_s,
        )
        if submitted_at is not None:
            request.submitted_at = submitted_at
        request.prefilled = length
        self.scheduler.adopt(request, slot)
        self._pending[slot] = prompt[-1]
        if self.spec is not None:
            # the handoff moved the target's K/V only: draft_len = 0 marks the
            # whole history for the draft pool's catch-up before it drafts
            self.spec.draft_ok[slot] = True
            self.spec.draft_len[slot] = 0
        if self.tracer is not None:
            # a handed-off request joins its trace here: the decode span names
            # the pool that streams
            self.tracer.begin(request.id, prompt_len=int(prompt.size), max_new_tokens=max_new_tokens)
            self.tracer.span_start(request.id, "decode", replica=self.name, slot=slot, adopted=True)
        self.stats.record_adopted()
        return request.id

    def can_adopt(self, n_pages: int) -> bool:
        """Whether an adoption of ``n_pages`` could land now: a free lane and
        enough pages (prefix entries count, ``alloc`` evicts them)."""
        if self._draining or not self.paged or self.cache.lanes.free_count == 0:
            return False
        return self.cache.pages.free_count + len(self.cache.prefix) >= n_pages

    def release_parked(self, request_id: int) -> bool:
        """Drop a parked request's page references (its destination adopted
        the content, or it was cancelled). Pages filed in the prefix cache
        keep the registry's reference. Returns whether it was parked here."""
        parked = self._parked.pop(request_id, None)
        if parked is None:
            return False
        if self.tracer is not None:
            self.tracer.span_end(request_id, "parked", stats=self.stats, outcome="released")
        for page in parked["pages"]:
            self.cache.pages.decref(page)
        return True

    def resume_parked(
        self,
        request_id: int,
        prompt,
        max_new_tokens: int,
        submitted_at: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> bool:
        """Re-seat a parked request on this engine with no copy (the
        handoff's source is its destination): a lane whose table points at
        the parked pages again. False when no lane is free (it stays
        parked) or the id is not parked here."""
        parked = self._parked.get(request_id)
        if parked is None:
            return False
        slot = self.cache.seat(parked["pages"], parked["length"])
        if slot is None:
            return False
        self._parked.pop(request_id)
        request = Request(
            id=request_id, prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens, deadline_s=deadline_s,
        )
        if submitted_at is not None:
            request.submitted_at = submitted_at
        request.prefilled = parked["length"]
        self.scheduler.adopt(request, slot)
        self._pending[slot] = request.prompt[-1]
        if self.spec is not None:
            # the parked pages are this engine's own, their draft halves
            # mirrored when the prefill ran here
            self.spec.draft_ok[slot] = True
            self.spec.draft_len[slot] = parked["length"]
        if self.tracer is not None:
            self.tracer.span_end(request_id, "parked", stats=self.stats, outcome="resumed")
            self.tracer.span_start(request.id, "decode", replica=self.name, slot=slot, resumed=True)
        self.stats.record_adopted()
        return True

    def metrics(self) -> dict:
        """Engine metrics, flat scalars."""
        return self.stats.snapshot()

    # -- telemetry --------------------------------------------------------------

    def kernel_summary(self) -> dict:
        """Which kernels this engine runs and the launches of each it has
        made (its warm-up included): the payload of the ``{"kind":
        "kernels"}`` record. On the CPU every kernel takes its plain
        version; the dense slab attends by the models' plain attention."""
        on_card = self.device.type == "cuda"
        return {
            "paged": self.paged,
            "decode_attention": ("cuda" if on_card else "plain") if self.paged else "dense_reference",
            "verify_attention": ("cuda" if on_card else "plain") if self.spec is not None else None,
            "quant_matmul": ("cuda" if on_card else "plain") if getattr(self.model, "dot_fn", None) is quant_dot
            else None,
            "launches": dict(self._launches),
        }

    def _report_kernels(self) -> None:
        """One ``{"kind": "kernels"}`` record per engine, at its first step
        (the hub may be attached after construction)."""
        if self._kernels_reported or self.telemetry is None:
            return
        self._kernels_reported = True
        payload = self.kernel_summary()
        if self.name is not None:
            payload = {"engine": self.name, **payload}
        self.telemetry.write_record("kernels", payload)

    def flush_telemetry(self) -> Optional[dict]:
        """One ``{"kind": "serving"}`` record of :meth:`metrics` through the
        hub (None without one)."""
        if self.telemetry is None:
            return None
        return self.telemetry.write_record("serving", {"serving": self.metrics()})

    def _resilience(self, payload: dict) -> None:
        """One ``{"kind": "resilience"}`` degradation record, tagged with the
        engine's name and the request's trace id (null without tracing or
        for a record of no request); nothing without a hub."""
        if self.telemetry is None:
            return
        if self.name is not None:
            payload = {"engine": self.name, **payload}
        if "trace_id" not in payload:
            request_id = payload.get("request_id")
            trace_id = self.tracer.trace_id(request_id) if self.tracer is not None and request_id is not None else None
            payload = {**payload, "trace_id": trace_id}
        self.telemetry.write_record("resilience", payload)

