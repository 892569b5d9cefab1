"""The port's llama (accelerate_tpu_torch/models) against the JAX package's on
the same weights: the JAX ``llama-tiny`` params, drawn from a seed, cross
into the port through ``load_jax_params`` as numpy arrays. fp32 on the CPU.

Tolerances: logits rtol 1e-4 (atol 1e-5), the two frameworks summing the
same products in different orders; generated tokens equal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.models.config import get_config as jax_get_config
from accelerate_tpu.models.config import param_count as jax_param_count
from accelerate_tpu.models.generation import forward_with_cache as jax_forward_with_cache
from accelerate_tpu.models.generation import generate as jax_generate
from accelerate_tpu.models.generation import init_cache as jax_init_cache
from accelerate_tpu_torch import Llama, generate, load_jax_params
from accelerate_tpu_torch.models import (
    forward_with_cache,
    get_config,
    init_cache,
    list_models,
    param_count,
)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) with the same weights."""
    jax_model = JaxLlama("llama-tiny")
    params = jax_model.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    port = load_jax_params(Llama("llama-tiny", device="cpu"), tree)
    return jax_model, params, port


def _ids(shape, seed=0, vocab=1024):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(np.int32)


def test_logits_match_jax(pair):
    jax_model, params, port = pair
    ids = _ids((2, 12))
    want = np.asarray(jax_model.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_logits_with_attention_mask_match_jax(pair):
    jax_model, params, port = pair
    ids = _ids((2, 9), seed=1)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    want = np.asarray(jax_model.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_forward_with_cache_prefill_then_decode_match_jax(pair):
    """Prefill a block into the dense cache, then decode two single tokens:
    each step's last-position logits and the cache contents match."""
    jax_model, params, port = pair
    cfg = port.config
    ids = _ids((2, 7), seed=2)
    steps = [ids, _ids((2, 1), seed=3), _ids((2, 1), seed=4)]
    jcache = jax_init_cache(jax_model.config, 2, 16, dtype=jnp.float32)
    pcache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for block in steps:
        jlogits, jcache = jax_forward_with_cache(jax_model, params, jnp.asarray(block), jcache)
        with torch.no_grad():
            plogits, pcache = forward_with_cache(port, torch.from_numpy(block), pcache)
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    assert pcache["length"] == int(jcache["length"]) == 9
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pcache["v"].numpy(), np.asarray(jcache["v"]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("eos", [None, 7], ids=["no_eos", "eos"])
def test_generate_tokens_match_jax(pair, eos):
    jax_model, params, port = pair
    ids = _ids((2, 5), seed=5)
    want = jax_generate(jax_model, params, ids, max_new_tokens=8, eos_token_id=eos)
    got = generate(port, ids, max_new_tokens=8, eos_token_id=eos, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sampled_generate_is_seeded(pair):
    """temperature > 0 draws from the explicit generator: same seed, same ids."""
    _, _, port = pair
    ids = _ids((1, 4), seed=6)
    runs = [
        generate(port, ids, max_new_tokens=6, temperature=1.0, device="cpu",
                 rng=torch.Generator().manual_seed(3))
        for _ in range(2)
    ]
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("name", list_models())
def test_config_and_param_count_match_jax(name):
    cfg, ref = get_config(name), jax_get_config(name)
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
                  "num_heads", "kv_heads", "dim_per_head", "rope_theta", "norm_eps"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert param_count(cfg) == jax_param_count(ref)


def test_module_parameters_keep_jax_key_paths_and_count(pair):
    jax_model, params, port = pair
    flat = {
        ".".join(str(k.key) for k in path): leaf.shape
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} == flat
    assert sum(p.numel() for p in port.parameters()) == param_count(port.config)


def test_load_jax_params_checks_keys_and_shapes(pair):
    _, params, _ = pair
    tree = jax.tree.map(np.asarray, params)
    model = Llama("llama-tiny", device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        load_jax_params(model, missing)
    bad = {**tree, "final_norm": np.ones((3,), np.float32)}
    with pytest.raises(ValueError, match="final_norm"):
        load_jax_params(model, bad)


def test_seeded_init_is_reproducible_and_moe_is_refused():
    a, b = Llama("llama-tiny", device="cpu", seed=4), Llama("llama-tiny", device="cpu", seed=4)
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    with pytest.raises(NotImplementedError):
        Llama("llama-moe-tiny", device="cpu")


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """device=None means CUDA: without a card the model and generate()
    raise, naming device='cpu', instead of quietly running on the CPU."""
    model = Llama("llama-tiny", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Llama("llama-tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, _ids((1, 3)), max_new_tokens=2)
