"""Activation checkpointing in the port: ``CompilationConfig.remat_policy``
on the CPU.

Every policy recomputes the same operations on the same inputs in the
backward, so one step under it must leave the params bit-equal to one step
without remat (tolerance 0), dropout on or off: each layer builds its
dropout generators from seeds drawn before the layer loop, so the recompute
draws the same masks. ``save_flash`` keeps the flash forward's ``out`` and
``lse``: the forward runs once per layer, where ``"full"`` runs it twice.
Bit equality on the CPU needs ``torch.use_deterministic_algorithms(True)``:
without it two runs without remat differ in the last bits, since the
embedding's backward accumulates rows from several threads in no fixed
order."""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import Accelerator, Bert, CompilationConfig, Llama, MoEBlock, adamw, get_config
from accelerate_tpu_torch.models import moe
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import Remat
from accelerate_tpu_torch.utils.params import flatten_tree
from torch.utils.checkpoint import CheckpointPolicy

POLICIES = [None, "none", "full", "nothing_saveable", "save_flash", "dots", "dots_saveable",
            "dots_with_no_batch_dims"]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module", autouse=True)
def deterministic():
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(previous)


def _setup(model, policy, flash_min_seq=128):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    acc = Accelerator(device="cpu", compilation_config=CompilationConfig(
        remat_policy=policy, flash_attention_min_seq=flash_min_seq))
    prepared = acc.prepare_model(model)
    acc.prepare_optimizer(adamw(1e-3))
    return acc, prepared


def _llama_step(policy, dropout_rate=0.0):
    """One compiled step of llama-tiny (2 layers, GQA 4/2, head dim 32) at
    B=2 S=128 through the flash path; returns the params."""
    cfg = get_config("llama-tiny").replace(dropout_rate=dropout_rate)
    model = Llama(cfg, device="cpu", seed=0)
    acc, prepared = _setup(model, policy)
    gen = torch.Generator().manual_seed(7) if dropout_rate else None
    step = acc.compiled_step(Llama.loss_fn(model, dropout_generator=gen))
    ids = torch.tensor(np.random.default_rng(0).integers(0, 1024, (2, 128)), dtype=torch.int32)
    mask = torch.ones((2, 128), dtype=torch.int32)
    mask[1, 90:] = 0
    step({"input_ids": ids, "attention_mask": mask})
    return {k: v.detach().clone() for k, v in flatten_tree(prepared.params)}


@pytest.fixture(scope="module")
def baseline():
    return _llama_step(None)


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_every_policy_leaves_one_step_params_equal_to_no_remat(baseline, policy):
    got = _llama_step(policy)
    assert set(got) == set(baseline)
    for key, want in baseline.items():
        assert torch.equal(got[key], want), key


@pytest.mark.parametrize("policy", ["full", "save_flash"])
def test_llama_with_dropout_under_remat_equals_no_remat(policy):
    want = _llama_step(None, dropout_rate=0.1)
    got = _llama_step(policy, dropout_rate=0.1)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _bert_grads(policy):
    """bert-tiny with dropout 0.1 at B=2 S=128 (flash path, padding mask):
    the grads of one backward, from one generator seed."""
    model = Bert(get_config("bert-tiny").replace(dropout_rate=0.1), device="cpu", seed=0)
    acc, prepared = _setup(model, policy)
    rng = np.random.default_rng(1)
    mask = np.ones((2, 128), np.int32)
    mask[0, 70:] = 0
    batch = {"input_ids": torch.tensor(rng.integers(0, 1024, (2, 128)), dtype=torch.int32),
             "attention_mask": torch.tensor(mask), "labels": torch.tensor([0, 1], dtype=torch.int32)}
    loss = acc.backward(Bert.loss_fn(model, dropout_generator=torch.Generator().manual_seed(3)), batch)
    return float(loss), {k: v.clone() for k, v in flatten_tree(acc._optimizers[-1].grads)}


def test_bert_with_dropout_under_full_remat_gives_the_same_grads():
    want_loss, want = _bert_grads(None)
    got_loss, got = _bert_grads("full")
    assert got_loss == want_loss
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("policy,forwards", [(None, 1), ("full", 2), ("save_flash", 1), ("dots", 2)])
def test_flash_forward_runs_once_per_layer_under_save_flash(monkeypatch, policy, forwards):
    """The flash forward's calls in one step (on the CPU its plain version;
    on the card the same count is the kernel's launches): a layer's forward
    once without remat and under ``save_flash``, twice when recomputed;
    the backward once a layer under every policy."""
    calls = {"fwd": 0, "bwd": 0}
    forward, backward = fa.flash_forward, fa.flash_backward

    def counted_forward(*args):
        calls["fwd"] += 1
        return forward(*args)

    def counted_backward(*args):
        calls["bwd"] += 1
        return backward(*args)

    monkeypatch.setattr(fa, "flash_forward", counted_forward)
    monkeypatch.setattr(fa, "flash_backward", counted_backward)
    _llama_step(policy)
    layers = get_config("llama-tiny").num_layers
    assert calls == {"fwd": forwards * layers, "bwd": layers}


def test_a_model_without_the_layer_hook_gets_the_outer_wrap(monkeypatch):
    """``MoEBlock`` has no ``remat_layers``: the step checkpoints the whole
    loss function, so the block's forward runs twice, and the grads equal
    those without remat."""
    calls = {"n": 0}
    routed = moe.routed_mlp

    def counted(*args, **kwargs):
        calls["n"] += 1
        return routed(*args, **kwargs)

    monkeypatch.setattr(moe, "routed_mlp", counted)
    x = torch.tensor(np.random.default_rng(2).normal(size=(2, 8, 16)), dtype=torch.float32)
    grads = {}
    for policy in (None, "full"):
        block = MoEBlock(16, 32, num_experts=4, top_k=2, device="cpu", seed=1)
        acc, _ = _setup(block, policy)

        def loss_fn(params, batch):
            y, aux = block.apply(params, batch["x"], return_aux=True)
            return (y ** 2).mean() + aux

        calls["n"] = 0
        acc.backward(loss_fn, {"x": x})
        grads[policy] = ({k: v.clone() for k, v in flatten_tree(acc._optimizers[-1].grads)}, calls["n"])
    assert grads[None][1] == 1 and grads["full"][1] == 2
    for key, want in grads[None][0].items():
        assert torch.equal(grads["full"][0][key], want), key


def test_prepare_model_sets_the_layer_hook():
    model = Llama("llama-tiny", device="cpu")
    _setup(model, "save_flash")
    assert isinstance(model.remat_layers, Remat) and model.remat_layers.name == "save_flash"
    _setup(model, None)
    assert model.remat_layers is False


def test_policies_save_what_they_name():
    """The dot policies keep the matrix products (``bmm`` only when it may
    have a batch dimension) through a selective-checkpoint context; "full"
    and ``save_flash`` keep no ATen op (``save_flash`` keeps the flash
    forward's outputs by the flash module's stash, counted above)."""
    mm, bmm, add = torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.add.Tensor
    save, recompute = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    want = {
        "dots": (save, save, recompute),
        "dots_saveable": (save, save, recompute),
        "dots_with_no_batch_dims": (save, recompute, recompute),
    }
    for name, decisions in want.items():
        policy = CompilationConfig(remat_policy=name).checkpoint_policy()
        assert tuple(policy._policy(None, op) for op in (mm, bmm, add)) == decisions, name
    for name in ("full", "nothing_saveable", "save_flash"):
        assert CompilationConfig(remat_policy=name).checkpoint_policy().saved_ops == frozenset()
    assert CompilationConfig(remat_policy="none").checkpoint_policy() is None


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        CompilationConfig(remat_policy="everything")
