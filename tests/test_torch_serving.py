"""The port's serving slice (accelerate_tpu_torch/serving) against the JAX
package's: the host logic (page allocator, prefix cache, scheduler, bucket
arithmetic) driven through identical walks on both, and the port's
``ServingEngine.generate_many`` against the JAX ``ServingEngine``
(``use_kernels=False``) on ``llama-tiny`` with the same weights: tokens
equal at temperature 0. fp32 on the CPU."""

import numpy as np
import pytest

import jax
import torch

import accelerate_tpu.serving.kv_cache as jax_kv_cache
import accelerate_tpu.serving.paging as jax_paging
import accelerate_tpu.serving.scheduler as jax_scheduler
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch import Llama, ServingEngine, generate, load_jax_params
from accelerate_tpu_torch.serving import kv_cache, paging, scheduler

IMPLEMENTATIONS = {"jax": (jax_kv_cache, jax_paging, jax_scheduler), "port": (kv_cache, paging, scheduler)}


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
    jax_model = JaxLlama("llama-tiny")
    params = jax_model.init(jax.random.key(0))
    port = load_jax_params(Llama("llama-tiny", device="cpu"), jax.tree.map(np.asarray, params))
    return jax_model, params, port


def _prompts(lengths, seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lengths]


# -- host logic: the same walk through both packages ------------------------


def _page_walk(paging_mod):
    alloc = paging_mod.PageAllocator(6)
    trace = [alloc.alloc(), alloc.alloc(), alloc.alloc()]
    alloc.fork([trace[1]])
    trace += [alloc.is_shared(trace[1]), alloc.decref(trace[1]), alloc.decref(trace[1])]
    trace += [alloc.alloc(), alloc.alloc_many(3), alloc.alloc_many(1), alloc.free_count]
    trace += [alloc.used_count, alloc.occupancy, alloc.decref(0), list(alloc.refcounts)]
    with pytest.raises(ValueError):
        alloc.incref(5)
    return trace


def _prefix_walk(paging_mod):
    alloc = paging_mod.PageAllocator(8)
    cache = paging_mod.PrefixCache(alloc, page_size=4, max_entries=2)
    tokens = np.arange(12, dtype=np.int32)
    pages = [alloc.alloc() for _ in range(3)]
    trace = [cache.register_chain(tokens, pages), list(alloc.refcounts)]
    trace += [cache.lookup(tokens), cache.lookup(tokens[:7]), cache.lookup(tokens + 1)]
    trace += [cache.evictions, len(cache)]
    cache.evict_for_pressure(alloc.free_count + 1)
    trace += [len(cache), alloc.free_count]
    return trace


def _scheduler_walk(scheduler_mod):
    sched = scheduler_mod.ContinuousBatchingScheduler(2, max_queue=3)
    ids = [sched.submit(np.arange(n, dtype=np.int32), 4).id for n in (1, 2, 3)]
    with pytest.raises(scheduler_mod.QueueFull):
        sched.submit(np.arange(2, dtype=np.int32), 4)
    free = iter([1, 0, None])
    admitted = [(slot, r.id) for slot, r in sched.admit_ready(lambda r: next(free))]
    sched.slots[1].generated = [5, 6]
    preempted = sched.preempt_slot(1)
    trace = [ids, admitted, preempted.id, preempted.generated, preempted.preemptions]
    trace += [[r.id for r in sched.queue], sched.active_slots, sched.cancel(ids[2]), sched.cancel(99)]
    swept = sched.sweep_queue(0.0)
    trace += [[(r.id, r.finish_reason) for r in swept], sched.retire(0, "length").finish_reason]
    trace += [sched.waiting, sched.busy]
    return trace


def _bucket_walk(kv_mod, paging_mod):
    from accelerate_tpu_torch.models import get_config

    cfg = get_config("llama-1b")
    return [
        kv_mod.prefill_buckets(1023), kv_mod.prefill_buckets(5), kv_mod.bucket_for(17, (16, 32)),
        paging_mod.pages_for(17, 16), paging_mod.paged_buckets((8, 16, 31, 64), 16, 48),
        kv_mod.paged_kv_cache_bytes(cfg, 8, 1024, page_size=16),
    ]


@pytest.mark.parametrize("walk", ["pages", "prefix", "scheduler", "buckets"])
def test_host_logic_walks_match_jax(walk):
    """Identical operation sequences give identical results in both packages."""
    traces = {}
    for name, (kv_mod, paging_mod, scheduler_mod) in IMPLEMENTATIONS.items():
        traces[name] = {
            "pages": lambda: _page_walk(paging_mod),
            "prefix": lambda: _prefix_walk(paging_mod),
            "scheduler": lambda: _scheduler_walk(scheduler_mod),
            "buckets": lambda: _bucket_walk(kv_mod, paging_mod),
        }[walk]()
    assert repr(traces["port"]) == repr(traces["jax"])


def test_paged_cache_cow_grow_and_pressure():
    """prepare_write's four answers, and the engine's one-page COW copy."""
    model = Llama("llama-tiny", device="cpu")
    engine = ServingEngine(model, num_slots=2, max_len=16, page_size=4, num_pages=6, device="cpu")
    cache = engine.cache
    donor = cache.pages.alloc()
    cache.k[:, donor] = 1.0
    slot = cache.admit([donor], new_pages=1)
    cache.lengths[slot] = 2
    status, src, dst = cache.prepare_write(slot)
    assert (status, src) == ("cow", donor) and dst not in (0, donor)
    engine._copy_page(src, dst)
    assert torch.equal(cache.k[:, dst], cache.k[:, donor])
    assert cache.pages.refcounts[donor] == 1
    assert cache.prepare_write(slot) == ("ok", 0, 0)
    cache.lengths[slot] = 8
    assert cache.prepare_write(slot)[0] == "grow"
    assert cache.grow(slot, 1) and cache.pages.free_count == 0
    cache.lengths[slot] = 12
    cache.held[slot] = 3
    assert cache.prepare_write(slot) == ("pressure", 0, 0)


# -- the engine against the JAX engine --------------------------------------


def _jax_rows(jax_model, params, prompts, new, **kwargs):
    engine = JaxServingEngine(
        jax_model, params, num_slots=4, max_len=96, page_size=16, use_kernels=False, **kwargs
    )
    return engine.generate_many(prompts, max_new_tokens=new), engine


def _port_rows(port, prompts, new, **kwargs):
    engine = ServingEngine(port, num_slots=4, max_len=96, page_size=16, device="cpu", **kwargs)
    return engine.generate_many(prompts, max_new_tokens=new), engine


def test_generate_many_matches_jax_engine_chunked_prefill(pair):
    """Mixed prompt lengths (sub-page, page-straddling, multi-page, one
    token) with 16-token prefill chunks: tokens equal to the JAX engine's
    and to the port's own generate()."""
    jax_model, params, port = pair
    prompts = _prompts((3, 17, 33, 1))
    want, _ = _jax_rows(jax_model, params, prompts, 6, prefill_chunk=16)
    got, engine = _port_rows(port, prompts, 6, prefill_chunk=16)
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, generate(port, p[None], max_new_tokens=6, device="cpu")[0])
    assert engine.stats.prefill_chunks > 0
    assert engine.stats.requests_completed == 4


def test_generate_many_matches_jax_engine_shared_prefix(pair):
    """Two prompts on one 32-token prefix, run one after the other: the second
    reuses the first's pages (COW prefix sharing) and the tokens match the
    JAX engine's."""
    jax_model, params, port = pair
    prefix = _prompts((32,), seed=1)[0]
    tails = _prompts((5, 20), seed=2)
    prompts = [np.concatenate([prefix, t]) for t in tails]
    want, got = [], []
    jax_engine = JaxServingEngine(
        jax_model, params, num_slots=4, max_len=96, page_size=16, use_kernels=False
    )
    port_engine = ServingEngine(port, num_slots=4, max_len=96, page_size=16, device="cpu")
    for p in prompts:
        want += jax_engine.generate_many([p], max_new_tokens=5)
        got += port_engine.generate_many([p], max_new_tokens=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port_engine.stats.prefix_hits == jax_engine.stats.prefix_hits == 1
    assert port_engine.stats.prefix_tokens_reused == 32


def test_preemption_under_page_pressure_completes_with_the_same_tokens(pair):
    """A pool too small for every request at once: younger requests are
    preempted and restarted, and every output still equals generate()."""
    _, _, port = pair
    prompts = _prompts((5, 5), seed=52)
    engine = ServingEngine(
        port, num_slots=2, max_len=16, page_size=4, num_pages=6, prefill_chunk=4, device="cpu"
    )
    rows = engine.generate_many(prompts, max_new_tokens=11)
    assert engine.stats.requests_preempted >= 1
    assert engine.stats.page_pressure_events >= 1
    for row, p in zip(rows, prompts):
        np.testing.assert_array_equal(row, generate(port, p[None], max_new_tokens=11, device="cpu")[0])


def test_warmup_cancel_and_deadline(pair):
    """warmup() touches every bucket without filing prefixes or leaving
    statistics behind; cancel and deadlines retire requests with reasons."""
    _, _, port = pair
    engine = ServingEngine(port, num_slots=2, max_len=64, page_size=16, device="cpu")
    engine.warmup()
    assert len(engine.cache.prefix) == 0 and engine.stats.requests_submitted == 0
    assert engine.cache.pages_in_use == 0
    keep = engine.submit(_prompts((4,))[0], max_new_tokens=3)
    dropped = engine.submit(_prompts((6,))[0], max_new_tokens=3)
    late = engine.submit(_prompts((5,))[0], max_new_tokens=3, deadline_s=0.0)
    assert engine.cancel(dropped)
    results = engine.run()
    assert results[keep].finish_reason == "length"
    assert results[dropped].finish_reason == "cancelled"
    assert results[late].finish_reason == "expired"
    assert engine.cache.pages_in_use == 0


def test_submit_rejects_what_cannot_be_served(pair):
    _, _, port = pair
    engine = ServingEngine(port, num_slots=2, max_len=32, page_size=16, max_queue=1, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        engine.submit(_prompts((20,))[0], max_new_tokens=20)
    engine.submit(_prompts((3,))[0], max_new_tokens=2)
    with pytest.raises(scheduler.QueueFull) as err:
        engine.submit(_prompts((3,))[0], max_new_tokens=2)
    assert err.value.retry_after_s > 0


def test_engine_without_device_raises_without_cuda(monkeypatch):
    """device=None means CUDA; on a machine without it the engine raises and
    names device='cpu' instead of serving from the CPU."""
    model = Llama("llama-tiny", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, num_slots=2, max_len=32)
