"""The port's engine on gpt2 and its degradation, dense and handoff paths
(accelerate_tpu_torch/serving/engine.py, kv_cache.py, paging.py,
scheduler.py) against the JAX package's, on the CPU in fp32 with
``gpt2-tiny`` and the JAX package's weights.

The bar is token equality at temperature 0: the port's engine against the
JAX engine (``use_kernels=False``, its tests' setting) and against the
port's own ``generate()``, through chunked prefill, linear speculation,
int8 weights served from a streamer, the dense ``paged=False`` slab, a
quarantine's requeue and a KV handoff between two engines. The degradation
tests follow ``tests/test_serving.py``, ``tests/test_paging.py``,
``tests/test_fleet.py`` and ``tests/test_disagg.py``."""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.big_modeling import dispatch_model as jax_dispatch_model
from accelerate_tpu.big_modeling import make_layered_device_map as jax_layered_map
from accelerate_tpu.models import GPT2 as JaxGPT2
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import SpeculativeConfig as JaxSpeculativeConfig
from accelerate_tpu.serving.engine import params_from_streamed as jax_params_from_streamed
from accelerate_tpu.utils import quantization as jax_quant
from accelerate_tpu_torch import (
    GPT2,
    QuantizationConfig,
    QuantizedWeight,
    ServingEngine,
    SpeculativeConfig,
    dispatch_model,
    generate,
    load_jax_params,
    make_layered_device_map,
    quant_dot,
)
from accelerate_tpu_torch.serving import kv_cache, scheduler
from accelerate_tpu_torch.serving.engine import StepWatchdog, params_from_streamed

MODEL = "gpt2-tiny"


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, numpy tree, port model) of gpt2-tiny."""
    jax_model = JaxGPT2(MODEL)
    params = jax_model.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return jax_model, params, tree, load_jax_params(GPT2(MODEL, device="cpu"), tree)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1024, (n,)).astype(np.int32) for n in lengths]


def _want(port, prompt, new):
    return generate(port, prompt[None], max_new_tokens=new, device="cpu")[0]


def _engine(port, **kwargs):
    return ServingEngine(port, **{"num_slots": 2, "max_len": 32, "page_size": 8, "device": "cpu", **kwargs})


def _poison(engine, slot):
    """NaN one slot's live K: its pages (paged), its slab row (dense)."""
    if engine.paged:
        engine.cache.k[:, engine.cache.pages_of(slot)] = float("nan")
    else:
        engine.cache.k[:, slot] = float("nan")


# -- gpt2 through the engine, against the JAX engine ---------------------------


@pytest.mark.parametrize("mode", ["chunked", "speculative"])
def test_gpt2_engine_matches_jax_engine_and_generate(pair, mode):
    """Mixed prompt lengths (one token, sub-page, page-straddling,
    multi-page) through 16-token prefill chunks, or linear speculation with
    the model drafting for itself (k=3): tokens equal to the JAX engine's
    and to ``generate()``."""
    jax_model, params, _, port = pair
    prompts = _prompts((3, 17, 33, 1), seed=1)
    geometry = dict(num_slots=4, max_len=96, page_size=16)
    if mode == "chunked":
        jax_kw, kw = dict(prefill_chunk=16), dict(prefill_chunk=16)
    else:
        jax_kw = dict(speculative=JaxSpeculativeConfig(draft_model=jax_model, draft_params=params, k=3))
        kw = dict(speculative=SpeculativeConfig(draft_model=port, k=3))
    jax_engine = JaxServingEngine(jax_model, params, use_kernels=False, **geometry, **jax_kw)
    want = jax_engine.generate_many(prompts, max_new_tokens=6)
    engine = ServingEngine(port, device="cpu", **geometry, **kw)
    got = engine.generate_many(prompts, max_new_tokens=6)
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, _want(port, p, 6))
    if mode == "chunked":
        assert engine.stats.prefill_chunks > 0
    else:
        assert engine.stats.spec_accepted_tokens == jax_engine.stats.spec_accepted_tokens > 0


def test_gpt2_int8_from_streamed_matches_jax(pair):
    """int8 gpt2 through ``dispatch_model`` with its layers in host memory,
    then ``from_streamed``: the matrices stay packed behind ``quant_dot``,
    biases and norms unquantized, and the tokens equal the JAX engine's and
    ``generate()`` over the dequantized weights."""
    jax_model, params, tree, _ = pair
    prompts = _prompts((5, 9), seed=8)
    geometry = dict(num_slots=2, max_len=48, page_size=16)
    fresh = JaxGPT2(MODEL)  # from_streamed installs its hook on the model
    jax_streamed = jax_dispatch_model(
        fresh, jax.tree.map(jnp.array, params), jax_layered_map(fresh, "cpu"), dtype=jnp.float32,
        quantization=jax_quant.QuantizationConfig(load_in_8bit=True),
    )
    want = JaxServingEngine.from_streamed(jax_streamed, **geometry).generate_many(prompts, max_new_tokens=4)

    model = load_jax_params(GPT2(MODEL, device="cpu"), tree)
    streamed = dispatch_model(model, tree, make_layered_device_map(model, "cpu"), dtype=torch.float32,
                              quantization=QuantizationConfig(load_in_8bit=True), device="cpu")
    reference = load_jax_params(GPT2(MODEL, device="cpu"), tree).install(params_from_streamed(streamed))
    np.testing.assert_array_equal(
        reference.layers.wqkv.detach().numpy(),
        np.asarray(jax_params_from_streamed(jax_streamed)["layers"]["wqkv"]))
    engine = ServingEngine.from_streamed(streamed, device="cpu", **geometry)
    assert model.dot_fn is quant_dot and isinstance(model.layers.w_up, QuantizedWeight)
    assert model.layers.bqkv.dtype == torch.float32 and model.embed_positions.dtype == torch.float32
    got = engine.generate_many(prompts, max_new_tokens=4)
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, _want(reference, p, 4))


# -- the dense slab -------------------------------------------------------------


def test_dense_slab_matches_paged_engine_and_jax(pair):
    """``paged=False``: one [L, slots, max_len, N, D] slab, tokens equal to
    the paged engine's and to the JAX dense engine's; speculation and
    prefill-only intake need the pool and raise."""
    jax_model, params, _, port = pair
    prompts = _prompts((3, 17, 33, 1), seed=2)
    want = JaxServingEngine(jax_model, params, num_slots=4, max_len=96, paged=False).generate_many(
        prompts, max_new_tokens=6)
    dense = ServingEngine(port, num_slots=4, max_len=96, paged=False, device="cpu")
    paged = ServingEngine(port, num_slots=4, max_len=96, device="cpu")
    assert tuple(dense.cache.k.shape) == (2, 4, 96, 4, 32)
    assert dense.cache.nbytes == kv_cache.kv_cache_bytes(port.config, 4, 96, dtype_bytes=4)
    got = dense.generate_many(prompts, max_new_tokens=6)
    for g, p, w, q in zip(got, paged.generate_many(prompts, max_new_tokens=6), want, prompts):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, np.asarray(w))
    assert dense.stats.requests_completed == 4 and "pages_in_use" not in dense.metrics()
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(port, max_len=96, paged=False, speculative=SpeculativeConfig(draft_model=port), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        dense.submit(prompts[0], max_new_tokens=2, prefill_only=True)


def test_slot_allocator_and_slab_walk_match_jax():
    """The same quarantine walk through both packages' slot allocators."""
    import accelerate_tpu.serving.kv_cache as jax_kv

    def walk(mod):
        alloc = mod.SlotAllocator(3)
        trace = [alloc.admit(), alloc.admit()]
        alloc.quarantine(trace[0])
        trace += [alloc.free_count, alloc.used_count, sorted(alloc.quarantined), trace[0] in alloc]
        trace += [alloc.admit(), alloc.admit(), alloc.occupancy]
        alloc.release(trace[0])
        trace += [alloc.admit(), sorted(alloc.quarantined)]
        with pytest.raises(ValueError):
            alloc.release(1)
        return trace

    assert walk(kv_cache) == walk(jax_kv)
    from accelerate_tpu_torch.models import get_config

    assert kv_cache.kv_cache_bytes(get_config(MODEL), 8, 256) == jax_kv.kv_cache_bytes(JaxGPT2(MODEL).config, 8, 256)


# -- quarantine, the probe, the scrub ----------------------------------------------


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_quarantine_requeue_and_probe_release(pair, paged):
    """A slot producing non-finite logits is quarantined, its request
    requeues and completes with ``generate()``'s tokens; the slot returns
    only after the finite-logits probe passes."""
    port = pair[3]
    prompt = _prompts([5], seed=27)[0]
    engine = _engine(port, num_slots=1, paged=paged)
    rid = engine.submit(prompt, max_new_tokens=4)
    engine.step()
    _poison(engine, 0)
    results = engine.run()
    s = engine.stats
    assert (s.slot_quarantines, s.requests_requeued, s.slot_quarantine_releases) == (1, 1, 1)
    assert engine.cache.quarantined == frozenset()
    np.testing.assert_array_equal(results[rid].generated, _want(port, prompt, 4)[prompt.size:])
    assert results[rid].finish_reason == "length"
    if not paged:  # the slab row was scrubbed
        assert bool(torch.isfinite(engine.cache.k[:, 0]).all())


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_quarantine_at_temperature_matches_jax_engine(pair, paged):
    """At temperature > 0 the poisoned lane's NaN logits reach the
    categorical sampler in the same step as its verdict: the slot is
    quarantined and released, and both requests finish, with the JAX
    engine's finish reasons and counters (seeded; the two samplers draw
    different tokens)."""
    jax_model, params, _, port = pair
    prompts = _prompts([5, 7], seed=32)
    jax_poison = {True: lambda e: e.cache.pages_of(0), False: lambda e: 0}[paged]
    runs = []
    for engine in (
        JaxServingEngine(jax_model, params, num_slots=2, max_len=32, page_size=8, paged=paged,
                         temperature=0.8, rng=jax.random.key(5), use_kernels=False),
        _engine(port, paged=paged, temperature=0.8, rng=torch.Generator().manual_seed(5)),
    ):
        ids = [engine.submit(p, max_new_tokens=4) for p in prompts]
        engine.step()
        if isinstance(engine, JaxServingEngine):
            engine.cache.k = engine.cache.k.at[:, np.asarray(jax_poison(engine), np.int32)].set(jnp.nan)
        else:
            _poison(engine, 0)
        results = engine.run()
        s = engine.stats
        runs.append(([results[i].finish_reason for i in ids], [len(results[i].generated) for i in ids],
                     (s.slot_quarantines, s.requests_requeued, s.slot_quarantine_releases, s.requests_failed)))
        assert engine.cache.quarantined == frozenset()
        for i in ids:
            assert np.all((np.asarray(results[i].generated) >= 0)
                          & (np.asarray(results[i].generated) < port.config.vocab_size))
    assert runs[1] == runs[0]
    assert runs[1][0] == ["length", "length"] and runs[1][2] == (1, 1, 1, 0)


def test_quarantined_slot_never_serves_until_probe_passes(pair):
    engine = _engine(pair[3], num_slots=1)
    engine.submit(_prompts([4], seed=28)[0], max_new_tokens=2)
    engine.step()
    _poison(engine, 0)
    engine.step()  # quarantine fires; the request is back at the queue head
    assert engine.cache.quarantined == frozenset({0})
    assert engine.scheduler.waiting == 1 and engine.scheduler.active_slots == []
    engine.step()  # the probe-only step releases the slot at its end
    assert engine.cache.quarantined == frozenset() and engine.scheduler.waiting == 1
    assert all(r.finish_reason == "length" for r in engine.run().values())


def test_request_fails_after_max_requeues_instead_of_livelocking(pair):
    engine = _engine(pair[3], num_slots=1)
    rid = engine.submit(_prompts([4], seed=30)[0], max_new_tokens=4)
    engine.step()
    engine.scheduler.slots[0].requeues = engine.max_request_requeues
    _poison(engine, 0)
    results = engine.run()
    assert results[rid].finish_reason == "failed"
    assert engine.stats.requests_failed == 1 and engine.stats.requests_requeued == 0
    assert len(engine.generate_many([_prompts([3], seed=31)[0]], max_new_tokens=2)) == 1


def test_quarantine_scrubs_freed_pages_and_the_null_page_stays_finite(pair):
    """A poisoned lane's freed pages are zeroed (the draft pool's too)
    before the pool recycles them, the prefix entries on them dropped; the
    null page idle lanes write to stays finite."""
    port = pair[3]
    engine = _engine(port, num_slots=4, speculative=SpeculativeConfig(draft_model=port, k=2))
    prompt = _prompts([17], seed=54)[0]
    rid = engine.submit(prompt, max_new_tokens=6)
    engine.step()
    pages = engine.cache.pages_of(0)
    assert len(engine.cache.prefix) == 2
    engine.cache.k[:, pages] = float("nan")
    engine.spec.k[:, pages] = float("nan")
    engine.step()
    assert engine.stats.slot_quarantines == 1 and len(engine.cache.prefix) == 0
    for pool in (engine.cache.k, engine.cache.v, engine.spec.k, engine.spec.v):
        assert float(pool[:, pages].abs().max()) == 0.0
    results = engine.run()
    np.testing.assert_array_equal(results[rid].generated, _want(port, prompt, 6)[prompt.size:])
    for pool in (engine.cache.k, engine.cache.v):
        assert bool(torch.isfinite(pool[:, 0]).all())


def test_nan_in_a_recycled_page_tail_never_reaches_its_next_holder(pair):
    """Pages recycled with NaN past what the next holder writes (no scrub):
    the paged reads stop at each slot's length, so tokens stay
    ``generate()``'s."""
    port = pair[3]
    engine = _engine(port, num_slots=1, max_len=32)
    engine.cache.k[:, 1:] = float("nan")
    engine.cache.v[:, 1:] = float("nan")
    prompt = _prompts((11,), seed=55)[0]
    np.testing.assert_array_equal(engine.generate_many([prompt], max_new_tokens=7)[0], _want(port, prompt, 7))


# -- the watchdog -------------------------------------------------------------------


def test_watchdog_reports_oversized_step(pair):
    engine = _engine(pair[3], num_slots=1, step_timeout_s=1e-9)
    engine.generate_many([_prompts([3], seed=29)[0]], max_new_tokens=2)
    assert engine.stats.watchdog_trips >= 1 and "watchdog_trips" in engine.metrics()
    engine._watchdog.close()


def test_step_watchdog_thread_fires_on_hang():
    trips = []
    watchdog = StepWatchdog(0.05, trips.append, poll_s=0.01)
    try:
        watchdog.arm()
        deadline = time.monotonic() + 2.0
        while not trips and time.monotonic() < deadline:
            time.sleep(0.01)  # the "hung" step
        assert len(trips) == 1 and trips[0] >= 0.05
        watchdog.disarm()
    finally:
        watchdog.close()


# -- drain and the scheduler's new hooks ---------------------------------------------


def test_engine_drain_and_snapshot(pair):
    engine = _engine(pair[3], num_slots=1)
    active = engine.submit(_prompts([4], seed=11)[0], max_new_tokens=3)
    queued = engine.submit(_prompts([5], seed=12)[0], max_new_tokens=3)
    doomed = engine.submit(_prompts([6], seed=13)[0], max_new_tokens=3)
    engine.step()
    engine.cancel(doomed)
    assert {p["request_id"] for p in engine.snapshot_requests()} == {active, queued}
    assert {p["request_id"] for p in engine.snapshot_requests(include_active=False)} == {queued}
    payloads, retired = engine.drain()
    assert engine.draining and not engine.queue_available
    assert [p["request_id"] for p in payloads] == [queued] and payloads[0]["max_new_tokens"] == 3
    assert [(r.request_id, r.finish_reason) for r in retired] == [(doomed, "cancelled")]
    assert engine.stats.requests_rehomed == 1
    with pytest.raises(scheduler.QueueFull, match="draining"):
        engine.submit(_prompts([3], seed=14)[0], max_new_tokens=2)
    assert engine.drain_eta_hint() > 0
    assert engine.run()[active].finish_reason == "length"
    engine.resume_admission()
    engine.reset_service_estimate()
    assert engine.retry_after_hint() == pytest.approx(16 * 0.01)
    assert len(engine.generate_many([_prompts([3], seed=15)[0]], max_new_tokens=2)) == 1


def test_scheduler_walk_matches_jax():
    """requeue_front, adopt and drain_queue: the same walk through both."""
    import accelerate_tpu.serving.scheduler as jax_scheduler

    def walk(mod):
        sched = mod.ContinuousBatchingScheduler(3)
        ids = [sched.submit(np.arange(n, dtype=np.int32), 4).id for n in (1, 2, 3)]
        free = iter([0, 1, None])
        admitted = [(s, r.id) for s, r in sched.admit_ready(lambda r: next(free))]
        sched.slots[0].generated = [7]
        back = sched.requeue_front(0)
        trace = [ids, admitted, back.requeues, back.generated, [r.id for r in sched.queue]]
        adopted = mod.Request(id=99, prompt=np.arange(2, dtype=np.int32), max_new_tokens=3)
        trace += [sched.adopt(adopted, 2).slot, sched.active_slots]
        with pytest.raises(ValueError):
            sched.adopt(adopted, 2)
        trace += [[r.id for r in sched.drain_queue()], sched.waiting, sorted(back.payload)]
        return trace

    assert repr(walk(scheduler)) == repr(walk(jax_scheduler))


# -- the KV handoff --------------------------------------------------------------------


def _handoff(src, dst, prompt, new, **kwargs):
    rid = src.submit(prompt, max_new_tokens=new, prefill_only=True)
    assert src.run()[rid].finish_reason == "prefilled"
    layout = src.kv_page_layout(rid)
    assert layout["parked"] and layout["length"] == prompt.size - 1
    kb, vb = src.extract_pages(layout["pages"])
    new_id = dst.adopt_kv(prompt, new, layout, kb, vb, request_id=rid, **kwargs)
    assert src.release_parked(rid) and not src.release_parked(rid)
    return new_id


def test_handoff_matches_generate_and_frees_the_source(pair):
    """prefill_only on one engine, extract_pages, adopt_kv on another: the
    tokens equal ``generate()``, and the source holds no page afterwards."""
    port = pair[3]
    src = _engine(port, max_len=64, prefill_chunk=8, prefix_sharing=False)
    dst = _engine(port, max_len=64)
    for prompt in _prompts((19, 1, 8), seed=16):
        new_id = _handoff(src, dst, prompt, 7)
        np.testing.assert_array_equal(dst.run()[new_id].generated, _want(port, prompt, 7)[prompt.size:])
    assert src.stats.requests_parked == 3 and dst.stats.requests_adopted == 3
    assert src.cache.pages_in_use == 0 and src.parked_count == 0 and dst.cache.pages_in_use == 0


def test_adopt_kv_rejects_inexact_and_mismatched_layouts(pair):
    port = pair[3]
    src, dst = _engine(port, max_len=64), _engine(port, max_len=64)
    p = _prompts([6], seed=9)[0]
    rid = src.submit(p, max_new_tokens=4, prefill_only=True)
    src.run()
    layout = src.kv_page_layout(rid)
    kb, vb = src.extract_pages(layout["pages"])
    assert tuple(kb.shape) == (len(layout["pages"]), 2, 8, 4, 32) and kb.dtype == torch.float32
    with pytest.raises(ValueError, match="token-exact"):
        dst.adopt_kv(p[:-1], 4, layout, kb, vb)
    with pytest.raises(ValueError, match="page_size mismatch"):
        dst.adopt_kv(p, 4, dict(layout, page_size=16), kb, vb)
    with pytest.raises(ValueError, match="page_shape mismatch"):
        dst.adopt_kv(p, 4, dict(layout, page_shape=(1, 2, 3)), kb, vb)
    with pytest.raises(ValueError, match="dtype mismatch"):
        dst.adopt_kv(p, 4, dict(layout, dtype="torch.bfloat16"), kb, vb)
    with pytest.raises(ValueError, match="paged"):
        _engine(port, paged=False).adopt_kv(p, 4, layout, kb, vb)
    assert dst.cache.pages_in_use == 0 and dst.scheduler.active_slots == []


def test_released_parked_request_frees_its_pages_and_resume_reseats(pair):
    """A parked request pins its pages until ``release_parked`` (the
    cancelled handoff) frees them; ``resume_parked`` re-seats one in place
    and decodes ``generate()``'s tokens."""
    port = pair[3]
    engine = _engine(port, max_len=64, prefix_sharing=False)
    p, q = _prompts((6, 13), seed=7)
    gone = engine.submit(p, max_new_tokens=8, prefill_only=True)
    kept = engine.submit(q, max_new_tokens=5, prefill_only=True)
    engine.run()
    assert engine.parked_count == 2 and engine.cache.pages_in_use > 0
    assert not engine.cancel(gone)  # parked: no longer in flight here
    assert engine.release_parked(gone) and engine.parked_count == 1
    assert engine.can_adopt(1)
    assert engine.resume_parked(kept, q, 5)
    np.testing.assert_array_equal(engine.run()[kept].generated, _want(port, q, 5)[q.size:])
    assert engine.cache.pages_in_use == 0 and engine.stats.requests_adopted == 1


def test_adopted_slot_catches_the_draft_up_and_speculates(pair):
    """Adopt live KV on a speculating engine: the draft pool catches up by
    mirrored prefill spans, then drafts; tokens equal plain decode's."""
    port = pair[3]
    prompt = _prompts([19], seed=17)[0]
    src = _engine(port, max_len=64, prefix_sharing=False)
    dst = _engine(port, max_len=64, prefix_sharing=False, speculative=SpeculativeConfig(draft_model=port, k=3))
    new_id = _handoff(src, dst, prompt, 8)
    np.testing.assert_array_equal(dst.run()[new_id].generated, _want(port, prompt, 8)[prompt.size:])
    assert dst.stats.spec_accepted_tokens > 0 and dst.cache.pages_in_use == 0


def test_snapshot_keys_cover_the_jax_degradation_and_handoff_counters():
    """Every request, slot and watchdog counter key of the JAX
    ``ServingStats.snapshot`` is in the port's and records the same way,
    the handoff's parked/adopted counts included, and so is the router's
    transfer ledger (``handoff*``, recorded through ``record_handoff*``)."""
    from accelerate_tpu.telemetry.serving import ServingStats as JaxServingStats
    from accelerate_tpu_torch.telemetry.serving import ServingStats

    want, got = JaxServingStats(2), ServingStats(2)
    for stats in (want, got):
        for name in ("requeue", "rehomed", "quarantine", "quarantine_release", "watchdog_trip", "parked",
                     "adopted"):
            getattr(stats, f"record_{name}")()
    keys = [k for k in want.snapshot() if k.startswith(("requests_", "slot_", "watchdog"))]
    assert len(keys) >= 14
    for key in keys:
        assert got.snapshot()[key] == want.snapshot()[key], key
    for stats in (want, got):
        stats.record_handoff_attempt()
        stats.record_handoff_retry()
        stats.record_handoff_fallback()
        stats.record_handoff(2, 4096, 0.001)
    ledger = [k for k in want.snapshot() if k.startswith("handoff")]
    assert len(ledger) >= 6
    for key in ledger:
        assert got.snapshot()[key] == pytest.approx(want.snapshot()[key], abs=5e-4), key
    assert sorted(n for n in dir(got) if n.startswith("record_handoff")) == sorted(
        n for n in dir(want) if n.startswith("record_handoff"))
