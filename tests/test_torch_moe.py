"""The port's mixture-of-experts (accelerate_tpu_torch/models/moe.py and the
MoE layers of models/llama.py) against the JAX package's, on the CPU in
fp32, with the JAX package's params and the same numpy inputs.

Tolerances, and why:
- ``routed_mlp`` outputs rtol 1e-5, atol 1e-6, the aux loss rtol 1e-6: the
  same products summed in other orders; which (token, choice) pairs the
  capacity drops is compared exactly;
- llama-moe-tiny logits rtol 1e-4, atol 1e-5 (as ``test_torch_models.py``),
  the loss rtol 1e-5, gradients within 1e-4 of each leaf's largest
  magnitude."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.models import MoEBlock as JaxMoEBlock
from accelerate_tpu.models.moe import routed_mlp as jax_routed_mlp
from accelerate_tpu_torch import Accelerator, Llama, MoEBlock, adamw, generate, load_jax_params
from accelerate_tpu_torch.models import routed_mlp
from accelerate_tpu_torch.models.llama import layer_keys
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig
from accelerate_tpu_torch.utils.params import flatten_tree, tree_leaves, tree_map


def _reset():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _x(b=4, s=8, h=32, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, h)).astype(np.float32)


_jax_routed_mlp = jax.jit(jax_routed_mlp, static_argnames=("top_k", "capacity_factor"))


def _both(params, x, **kwargs):
    """(jax (y, aux), port (y, aux)) of routed_mlp on the same numpy inputs."""
    j = _jax_routed_mlp(jnp.asarray(x), *(jnp.asarray(params[k]) for k in ("router", "w_up", "w_down")), **kwargs)
    p = routed_mlp(torch.from_numpy(x), *(torch.from_numpy(np.array(params[k])) for k in ("router", "w_up", "w_down")),
                   **kwargs)
    return [np.asarray(v) for v in j], [v.numpy() for v in p]


@pytest.mark.parametrize("top_k,capacity_factor", [(2, 1.25), (1, 1.0), (2, 0.5), (3, 2.0)])
def test_routed_mlp_matches_jax(top_k, capacity_factor):
    """Outputs, aux loss and the tokens the capacity drops, over a router
    drawn at init (near-uniform) and one scaled up (confident, unbalanced)."""
    params = jax.tree.map(np.asarray, JaxMoEBlock(32, 64, 4).init(jax.random.key(top_k)))
    for scale in (1.0, 8.0):
        p = dict(params, router=params["router"] * scale)
        (jy, jaux), (py, paux) = _both(p, _x(seed=top_k), top_k=top_k, capacity_factor=capacity_factor)
        np.testing.assert_allclose(py, jy, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(paux, jaux, rtol=1e-6)
        np.testing.assert_array_equal(np.abs(py).sum(-1) > 0, np.abs(jy).sum(-1) > 0)


def test_capacity_overflow_drops_the_same_tokens_as_jax():
    """``tests/test_moe_local_sgd.py``'s case: a zero router ties every
    logit, so top-1 takes expert 0 for every token; capacity ceil(1 * 8 / 2 *
    0.51) = 3, so tokens 0-2 are kept and 5 of 8 dropped. With top-2 the
    tie order puts expert 1 second, and choice 0 of every token is served
    before choice 1 of any."""
    block = JaxMoEBlock(hidden_size=8, intermediate_size=16, num_experts=2, top_k=1, capacity_factor=0.51)
    params = dict(jax.tree.map(np.asarray, block.init(jax.random.key(2))))
    params["router"] = np.zeros_like(params["router"])
    x = _x(1, 8, 8, seed=2)
    (jy, _), (py, _) = _both(params, x, top_k=1, capacity_factor=0.51)
    kept = np.abs(py[0]).sum(-1) > 1e-6
    assert kept.tolist() == [True] * 3 + [False] * 5
    np.testing.assert_array_equal(kept, np.abs(jy[0]).sum(-1) > 1e-6)
    np.testing.assert_allclose(py, jy, rtol=1e-5, atol=1e-6)
    (jy, jaux), (py, paux) = _both(params, x, top_k=2, capacity_factor=0.51)  # capacity 4 per expert
    np.testing.assert_allclose(py, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(paux, jaux, rtol=1e-6)


def test_moe_block_loads_jax_params_and_matches():
    jax_block = JaxMoEBlock(16, 32, num_experts=4, top_k=2, capacity_factor=2.0)
    params = jax.tree.map(np.asarray, jax_block.init(jax.random.key(1)))
    block = load_jax_params(MoEBlock(16, 32, num_experts=4, top_k=2, capacity_factor=2.0, device="cpu"), params)
    x = _x(2, 4, 16, seed=1)
    jy, jaux = jax.jit(lambda p, x: jax_block.apply(p, x, return_aux=True))(params, jnp.asarray(x))
    with torch.no_grad():
        py, paux = block(torch.from_numpy(x), return_aux=True)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)
    assert block.capacity(8) == jax_block.capacity(8)
    with pytest.raises(ValueError, match="top_k"):
        MoEBlock(8, 16, num_experts=2, top_k=3, device="cpu")


def test_moe_block_trains_under_accelerator():
    """``prepare_model`` takes the block on its own (as the JAX test does):
    12 eager steps of ``backward`` + ``step`` on MSE + aux lose 30%."""
    _reset()
    acc = Accelerator(device="cpu")
    block = MoEBlock(16, 32, num_experts=4, top_k=2, capacity_factor=2.0, device="cpu", seed=3)
    acc.prepare_model(block)
    opt = acc.prepare_optimizer(adamw(1e-2, weight_decay=0.0))
    x = torch.from_numpy(_x(4, 8, 16, seed=3))
    target = torch.tanh(x.flip(-1))

    def loss_fn(params, batch):
        y, aux = block.apply(params, batch["x"], return_aux=True)
        return torch.mean((y - batch["y"]) ** 2) + aux

    losses = []
    for _ in range(12):
        losses.append(float(acc.backward(loss_fn, {"x": x, "y": target})))
        opt.step()
        opt.zero_grad()
    assert losses[-1] < losses[0] * 0.7


def test_expert_axis_above_one_raises_naming_the_parallel_slice():
    """An expert axis above 1 raises naming item 17 (model parallelism; the
    parallel slice runs the data and fsdp axes)."""
    _reset()
    with pytest.raises(NotImplementedError, match="item 17"):
        Accelerator(device="cpu", parallelism=ParallelismConfig(expert=2))


@pytest.fixture(scope="module")
def moe_pair():
    model = JaxLlama("llama-moe-tiny")
    params = model.init(jax.random.key(0))
    return model, params, load_jax_params(Llama("llama-moe-tiny", device="cpu"), jax.tree.map(np.asarray, params))


def test_moe_llama_keys_follow_jax(moe_pair):
    _, params, port = moe_pair
    assert layer_keys(port.config) == ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", "moe_up", "moe_down")
    assert set(layer_keys(port.config)) == set(params["layers"])
    assert {k: tuple(v.shape) for k, v in flatten_tree(port.param_tree())} == {
        k: tuple(v.shape) for k, v in flatten_tree(jax.tree.map(np.asarray, params))}


def test_moe_llama_loss_and_grads_match_jax(moe_pair):
    """llama-moe-tiny, B=2 S=32 with a padded row: logits and aux of
    ``apply(return_aux=True)``, then the loss (CE + the summed balance
    term) and every gradient."""
    jax_model, params, port = moe_pair
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1024, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[1, 20:] = 0
    jb = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}
    jlogits, jaux = jax.jit(lambda p, b: jax_model.apply(p, b["input_ids"], b["attention_mask"],
                                                         return_aux=True))(params, jb)
    assert float(jaux) > 0
    want_loss, want_grads = jax.jit(jax.value_and_grad(JaxLlama.loss_fn(jax_model)))(params, jb)
    with torch.no_grad():
        plogits, paux = port.apply(port.param_tree(), torch.from_numpy(ids), torch.from_numpy(mask), return_aux=True)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-5)
    tree = tree_map(lambda p: p.detach().clone().requires_grad_(), port.param_tree())
    loss = Llama.loss_fn(port)(tree, {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)})
    grads = iter(torch.autograd.grad(loss, tree_leaves(tree)))
    got = {k: v.numpy() for k, v in flatten_tree(tree_map(lambda _: next(grads), tree))}
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for key, want in flatten_tree(jax.tree.map(np.asarray, want_grads)):
        scale = max(np.abs(want).max(), 1e-4)
        np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-4 * scale, err_msg=key)


def test_moe_llama_generates_like_jax(moe_pair):
    """``generate()`` on an MoE config (the JAX test takes 4 tokens from
    [1, 2, 3]): greedy tokens equal to the JAX package's."""
    from accelerate_tpu.models.generation import generate as jax_generate

    jax_model, params, port = moe_pair
    prompt = np.asarray([[1, 2, 3]], np.int32)
    want = np.asarray(jax_generate(jax_model, params, jnp.asarray(prompt), max_new_tokens=4))
    got = generate(port, prompt, max_new_tokens=4, device="cpu")
    assert got.shape == (1, 7)
    np.testing.assert_array_equal(got, want)
