"""The port's speculative decoding (accelerate_tpu_torch/serving/speculative.py,
the verify step of serving/engine.py, ops/paged_attention.paged_verify_attention)
against the JAX package's, on the CPU in fp32.

The JAX side runs as ``tests/test_speculative.py`` runs it with
``use_kernels=True``: the Pallas verify kernel in interpret mode. Weights
cross through ``load_jax_params``. The bar is token equality: at
temperature 0 the speculative engine emits exactly the plain engine's
tokens, and the port's speculative engine the JAX one's, with the same
proposed/accepted counts.

Tolerance of the verify plain version against the JAX kernel: rtol 1e-5,
atol 1e-5 in fp32 (online softmax over pages vs one softmax)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.models.generation import forward_window_with_cache as jax_forward_window
from accelerate_tpu.ops.paged_attention import _verify_reference
from accelerate_tpu.ops.paged_attention import paged_verify_attention as jax_paged_verify
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import SpeculativeConfig as JaxSpeculativeConfig
from accelerate_tpu_torch import Llama, ServingEngine, load_jax_params
from accelerate_tpu_torch.models import forward_window_with_cache
from accelerate_tpu_torch.ops.paged_attention import (
    paged_decode_attention_reference,
    paged_split_reference,
    paged_verify_attention,
    paged_verify_attention_reference,
)
from accelerate_tpu_torch.serving import SpeculativeConfig

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model) for llama-tiny (4 q heads on 2
    kv heads) and a shrunk draft (half the layers, other weights), as
    ``tests/test_speculative.py::_shrunk_draft`` builds it."""
    jax_model = JaxLlama("llama-tiny")
    params = jax_model.init(jax.random.key(0))
    draft_cfg = jax_model.config.replace(num_layers=max(1, jax_model.config.num_layers // 2))
    jax_draft = JaxLlama(draft_cfg)
    draft_params = jax_draft.init(jax.random.key(7))

    def port(cfg, tree):
        return load_jax_params(Llama(cfg, device="cpu"), jax.tree.map(np.asarray, tree))

    return {
        "target": (jax_model, params, port(jax_model.config, params)),
        "shrunk": (jax_draft, draft_params, port(draft_cfg, draft_params)),
    }


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1024, (n,)).astype(np.int32) for n in lengths]


# -- config validation ----------------------------------------------------------


@pytest.mark.parametrize(
    "case, error",
    [
        ("k", "k must be >= 1"),
        ("mode", "mode"),
        ("branches", "num_branches"),
        ("temperature", "temperature-0"),
        ("vocab", "vocab_size"),
    ],
)
def test_speculative_config_validation(models, case, error):
    """The JAX package's checks, each raising ValueError with its message."""
    port = models["target"][2]
    with pytest.raises(ValueError, match=error):
        if case == "k":
            SpeculativeConfig(draft_model=port, k=0)
        elif case == "mode":
            SpeculativeConfig(draft_model=port, mode="dag")
        elif case == "branches":
            SpeculativeConfig(draft_model=port, mode="tree", num_branches=1)
        elif case == "temperature":
            ServingEngine(port, num_slots=2, max_len=64, temperature=0.7, device="cpu",
                          speculative=SpeculativeConfig(draft_model=port, k=3))
        else:
            bad = Llama(port.config.replace(vocab_size=512), device="cpu")
            ServingEngine(port, num_slots=2, max_len=64, device="cpu",
                          speculative=SpeculativeConfig(draft_model=bad))


# -- the verify attention ---------------------------------------------------------


def _verify_case(seed, w, nh=4, kv=2, d=16, ps=8, pps=3, lengths=(0, 13, 24), nan_unwalked=True):
    """Numpy inputs, each slot on its own pages: lengths 0, mid-page and
    full. A partial last page's tail holds stale finite values (1e6), every
    page past a slot's walk NaN (the JAX kernel never reads those; its
    gather reference would, so ``nan_unwalked=False`` serves that one)."""
    rng = np.random.default_rng(seed)
    slots = len(lengths)
    num_pages = slots * pps + 1
    pool_k = rng.normal(size=(num_pages, ps, kv, d)).astype(np.float32)
    pool_v = rng.normal(size=(num_pages, ps, kv, d)).astype(np.float32)
    tables = (1 + rng.permutation(num_pages - 1)).reshape(slots, pps).astype(np.int32)
    for s, length in enumerate(lengths):
        walked = -(-length // ps)
        if length % ps:
            pool_k[tables[s, walked - 1], length % ps :] = 1e6
            pool_v[tables[s, walked - 1], length % ps :] = -1e6
        if nan_unwalked:
            pool_k[tables[s, walked:]] = np.nan
            pool_v[tables[s, walked:]] = np.nan
    return {
        "q": rng.normal(size=(slots, w, nh, d)).astype(np.float32),
        "k_new": rng.normal(size=(slots, w, kv, d)).astype(np.float32),
        "v_new": rng.normal(size=(slots, w, kv, d)).astype(np.float32),
        "pool_k": pool_k,
        "pool_v": pool_v,
        "tables": tables,
        "lengths": np.asarray(lengths, np.int32),
    }


def _torch(case):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()}


def _jax_per_slot(fn, case, **kwargs):
    """The JAX functions take one slot (the engine vmaps them)."""
    outs = []
    for s in range(case["q"].shape[0]):
        out = fn(
            jnp.asarray(case["q"][s][None]), jnp.asarray(case["k_new"][s][None]),
            jnp.asarray(case["v_new"][s][None]), jnp.asarray(case["pool_k"]),
            jnp.asarray(case["pool_v"]), jnp.asarray(case["tables"][s]),
            jnp.int32(case["lengths"][s]), **kwargs,
        )
        outs.append(np.asarray(out)[0])
    return np.stack(outs)


@pytest.mark.parametrize("w", [1, 3, 5])
def test_verify_plain_matches_jax_kernel_and_reference(w):
    """GQA 4/2, lengths 0, mid-page and full: the port's plain version
    against the Pallas verify kernel (interpret mode) with NaN past every
    walk, and against the gather reference ``_verify_reference``."""
    case = _verify_case(0, w)
    got = paged_verify_attention(**_torch(case)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_per_slot(jax_paged_verify, case), rtol=RTOL, atol=ATOL)
    clean = _verify_case(1, w, nan_unwalked=False)
    np.testing.assert_allclose(
        paged_verify_attention(**_torch(clean)).numpy(),
        _jax_per_slot(_verify_reference, clean, scale=1.0 / 16**0.5),
        rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize(
    "w, nh, kv, ps, pps, lengths",
    [(9, 64, 8, 8, 3, (0, 13, 24)), (33, 4, 2, 8, 3, (0, 13, 24)), (33, 4, 2, 5, 8, (40, 0, 7))],
    ids=["w9_gqa64x8", "w33_gqa4x2", "w33_ps5"],
)
def test_verify_plain_matches_jax_at_head_dim_32_and_wide_windows(w, nh, kv, ps, pps, lengths):
    """Windows the first CUDA kernel refused (W > 32, W * group * D >
    6144 at llama-70b's GQA 64/8, here narrowed to head dim 32): the plain
    version, and the split form at chunks of 64 positions, against the
    Pallas verify kernel (interpret mode), NaN past every walk."""
    case = _verify_case(8, w, nh=nh, kv=kv, d=32, ps=ps, pps=pps, lengths=lengths)
    want = _jax_per_slot(jax_paged_verify, case)
    got = paged_verify_attention(**_torch(case)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    split = paged_split_reference(**_torch(case), chunk=64).numpy()
    np.testing.assert_allclose(split, want, rtol=RTOL, atol=ATOL)


def test_verify_at_window_1_is_decode():
    """W=1 is the decode function: the verify plain version equals the
    decode plain version exactly, and the wrapper launches nothing on CPU."""
    args = _torch(_verify_case(2, 1))
    before = paged_verify_attention.launches
    got = paged_verify_attention(**args)
    assert paged_verify_attention.launches == before
    decode_args = {**args, "q": args["q"][:, 0], "k_new": args["k_new"][:, 0], "v_new": args["v_new"][:, 0]}
    torch.testing.assert_close(
        got[:, 0], paged_decode_attention_reference(**decode_args), rtol=0, atol=0
    )
    torch.testing.assert_close(got, paged_verify_attention_reference(**args), rtol=0, atol=0)


def test_forward_window_matches_jax(models):
    """The window forward over one slot's paged pool: all-position logits
    and the window's K/V against the JAX forward with the verify kernel."""
    jax_model, params, port = models["target"]
    cfg = jax_model.config
    rng = np.random.default_rng(4)
    ps, pps, length, w = 8, 4, 11, 5
    shape = (cfg.num_layers, pps + 1, ps, cfg.kv_heads, cfg.dim_per_head)
    pool_k = rng.normal(size=shape).astype(np.float32)
    pool_v = rng.normal(size=shape).astype(np.float32)
    table = np.asarray([3, 1, 4, 2], np.int32)
    ids = rng.integers(0, cfg.vocab_size, (1, w)).astype(np.int32)

    def jax_attend(q, kn, vn, c):
        return jax_paged_verify(q, kn, vn, c["k"], c["v"], c["table"], c["length"])

    want, want_cache = jax_forward_window(jax_model, params, jnp.asarray(ids), {
        "k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v), "length": jnp.int32(length),
        "table": jnp.asarray(table), "attend": jax_attend,
    })

    def attend(q, kn, vn, c):
        return paged_verify_attention(q, kn, vn, c["k"], c["v"], c["table"], c["length"])

    got, got_cache = forward_window_with_cache(port, torch.from_numpy(ids), {
        "k": torch.from_numpy(pool_k), "v": torch.from_numpy(pool_v),
        "length": torch.tensor([length], dtype=torch.int32),
        "table": torch.from_numpy(table[None]), "attend": attend,
    })
    assert tuple(got.shape) == (1, w, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_cache["k"].numpy(), np.asarray(want_cache["k"]), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="attend"):
        forward_window_with_cache(port, torch.from_numpy(ids), {"k": None, "v": None, "length": 0})


# -- the engines ------------------------------------------------------------------


ENGINE_CASES = {
    # name: (mode, draft, prompt lengths, prompt seed, new tokens, extra engine kwargs)
    "linear_shrunk": ("linear", "shrunk", (3, 7, 12, 17), 3, 6, {}),
    "linear_self": ("linear", "target", (3, 7, 12, 5), 9, 8, {}),
    "tree_shrunk": ("tree", "shrunk", (3, 9, 14), 5, 6, {"prefix_sharing": False}),
    "tree_self": ("tree", "target", (3, 7, 12, 5), 9, 8, {"prefix_sharing": False}),
    "chunked_prefill": ("linear", "shrunk", (40, 5, 23), 11, 6, {"prefill_chunk": 16}),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_speculative_engine_matches_jax_and_plain(models, name):
    """k=3, two slots, page 16, max_len 96: the port's speculative engine
    gives the port's plain engine's tokens and the JAX speculative engine's
    (Pallas verify in interpret mode), with the same proposed and accepted
    counts. Tree mode returns every page (the allocator drains to 0); a
    self draft accepts k-1 = 2 extra tokens on full windows."""
    mode, draft_name, lengths, seed, new, extra = ENGINE_CASES[name]
    jax_model, params, port = models["target"]
    jax_draft, draft_params, port_draft = models[draft_name]
    prompts = _prompts(lengths, seed)
    geometry = dict(num_slots=2, max_len=96, page_size=16, **extra)

    jax_engine = JaxServingEngine(
        jax_model, params, use_kernels=True, **geometry,
        speculative=JaxSpeculativeConfig(
            draft_model=jax_draft, draft_params=draft_params, k=3, mode=mode, num_branches=2
        ),
    )
    want = jax_engine.generate_many(prompts, max_new_tokens=new)
    engine = ServingEngine(
        port, device="cpu", **geometry,
        speculative=SpeculativeConfig(draft_model=port_draft, k=3, mode=mode, num_branches=2),
    )
    got = engine.generate_many(prompts, max_new_tokens=new)
    plain = ServingEngine(port, device="cpu", **geometry).generate_many(prompts, max_new_tokens=new)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    stats = engine.stats
    assert stats.spec_steps > 0
    assert stats.spec_proposed_tokens == jax_engine.stats.spec_proposed_tokens
    assert stats.spec_accepted_tokens == jax_engine.stats.spec_accepted_tokens
    assert stats.spec_accepted_lengths == jax_engine.stats.spec_accepted_lengths
    if draft_name == "target":
        assert max(stats.spec_accepted_lengths) == 2
    if mode == "tree":
        assert engine.cache.pages.used_count == 0 == jax_engine.cache.pages.used_count
    if "prefill_chunk" in extra:
        assert stats.prefill_chunks > 0
    snap = engine.metrics()
    assert snap["spec_proposed_tokens"] == stats.spec_proposed_tokens
    assert engine.forward_counts["decode"] == 0 and engine.forward_counts["verify"] > 0


def test_disable_speculation_continues_the_stream(models):
    """Switching to plain decode mid-stream drops and duplicates nothing."""
    port = models["target"][2]
    prompts = _prompts((3, 7, 12), 21)
    engine = ServingEngine(port, num_slots=2, max_len=96, page_size=16, device="cpu",
                           speculative=SpeculativeConfig(draft_model=port, k=3))
    plain = ServingEngine(port, num_slots=2, max_len=96, page_size=16, device="cpu")
    ids = [engine.submit(p, max_new_tokens=8) for p in prompts]
    results = {r.request_id: r for _ in range(3) for r in engine.step()}
    engine.disable_speculation("operator")
    results.update(engine.run())
    want = plain.generate_many(prompts, max_new_tokens=8)
    for rid, p, row in zip(ids, prompts, want):
        np.testing.assert_array_equal(results[rid].tokens, row)
    assert engine.stats.spec_fallbacks == 1 and engine.forward_counts["decode"] > 0
