"""The port's adamw (accelerate_tpu_torch/ops/fused_adamw.py) against the JAX
package's ``fused_adamw`` (its Pallas kernel in interpret mode, as
``tests/test_fused_adamw.py`` runs it on the CPU) and ``optax.adamw``: the
same gradients from numpy, 10 steps, on a tree of mixed leaf shapes.

On the CPU the port's ``fused_apply`` runs the kernel's plain version; the
CUDA kernel is held bit-equal to that plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances. Against the reference formula evaluated op by op in IEEE fp32
(numpy), in the JAX package's order: 0. Against JAX itself, not 0: XLA's CPU
compiler does not evaluate the formula op by op. It contracts
``(1-b1)·g + b1·mu`` into one fused multiply-add and rewrites divisions by
a scalar, so the JAX results differ from the op-by-op ones (by up to 10
units in the last place in ``p`` at the first step, measured on this
formula). From the same inputs, one step then agrees within one rounding per
op: ``nu`` within 1 unit in the last place, ``mu`` within 1 unit of its
larger summand (the two summands cancel, so a unit of the result can be
far smaller), ``p`` within 4 units of ``|p| + |its step|`` (the same
cancellation, where the step nearly undoes p). Run free over 10 steps the differences
compound through Adam, which divides by the square root of nu, so params are
held within 1e-4 there."""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.ops.fused_adamw import fused_adamw as jax_fused_adamw
from accelerate_tpu_torch.ops.fused_adamw import (
    EmptyState,
    ScaleByAdamState,
    adamw,
    bias_corrections,
    fused_adamw,
)
from accelerate_tpu_torch.optimizer import apply_updates

SHAPES = {"a": (16, 64), "b": (7,), "c": (4, 8, 32), "d": (3, 5)}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units of the last place between two fp32 arrays."""
    ia, ib = a.astype(np.float32).view(np.int32), b.astype(np.float32).view(np.int32)
    return np.abs(ia.astype(np.int64) - ib.astype(np.int64))


def _tree(rng, cast=np.asarray):
    return {k: cast(rng.normal(size=s).astype(np.float32)) for k, s in SHAPES.items()}


def _oracle_step(p, mu, nu, g, count, lr, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4):
    """The reference formula op by op in IEEE fp32 (numpy), with optax's
    bias corrections (the fp32 beta's power, correctly rounded)."""
    f = np.float32
    bc1 = f(1) - f(np.float64(f(b1)) ** count)
    bc2 = f(1) - f(np.float64(f(b2)) ** count)
    mu = f(1.0 - b1) * g + f(b1) * mu
    nu = f(1.0 - b2) * (g * g) + f(b2) * nu
    u = (mu / bc1) / (np.sqrt(nu / bc2 + f(0.0)) + f(eps))
    u = u + f(wd) * p
    return p + f(-lr) * u, mu, nu


def _port_step(tx, fused: bool):
    def step(p, state, g):
        if fused:
            return tx.fused_apply(p, state, g)
        updates, state = tx.update(g, state, p)
        return apply_updates(p, updates), state

    return step


@pytest.mark.parametrize("fused", [True, False], ids=["fused_apply", "update"])
def test_port_equals_the_op_by_op_formula(fused):
    """10 steps: p, mu, nu bit-equal to the op-by-op IEEE evaluation."""
    rng = np.random.default_rng(0)
    lr = 3e-3
    params = _tree(rng)
    tx = fused_adamw(lr) if fused else adamw(lr)
    p = {k: torch.tensor(v) for k, v in params.items()}
    state = tx.init(p)
    want = {k: (v, np.zeros_like(v), np.zeros_like(v)) for k, v in params.items()}
    step = _port_step(tx, fused)
    for count in range(1, 11):
        g = _tree(rng)
        p, state = step(p, state, {k: torch.tensor(v) for k, v in g.items()})
        want = {k: _oracle_step(*want[k], g[k], count, lr) for k in SHAPES}
        for k in SHAPES:
            np.testing.assert_array_equal(p[k].numpy(), want[k][0])
            np.testing.assert_array_equal(state[0].mu[k].numpy(), want[k][1])
            np.testing.assert_array_equal(state[0].nu[k].numpy(), want[k][2])
    assert int(state[0].count) == 10


def _jax_tx(name, lr):
    if name == "jax_fused":
        return jax.jit(jax_fused_adamw(lr).fused_apply), jax_fused_adamw(lr)
    tx = optax.adamw(lr)

    @jax.jit
    def step(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    return step, tx


def _as_port_state(state, tx):
    adam = state[0]
    to_t = lambda tree: {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}  # noqa: E731
    return (ScaleByAdamState(torch.tensor(int(adam.count), dtype=torch.int32), to_t(adam.mu),
                             to_t(adam.nu)), EmptyState(), EmptyState())


@pytest.mark.parametrize("fused", [True, False], ids=["fused_apply", "update"])
@pytest.mark.parametrize("reference", ["jax_fused", "optax"])
def test_port_matches_jax_step_by_step(reference, fused):
    """Each of 10 steps from JAX's own state: one rounding per op apart."""
    rng = np.random.default_rng(1)
    lr = 3e-3
    jstep, jtx = _jax_tx(reference, lr)
    tx = fused_adamw(lr) if fused else adamw(lr)
    step = _port_step(tx, fused)
    p = _tree(rng, jnp.asarray)
    state = jtx.init(p)
    for _ in range(10):
        g = _tree(rng)
        port_p = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
        port_p, port_state = step(port_p, _as_port_state(state, tx), {k: torch.tensor(v) for k, v in g.items()})
        mu_before = {k: np.asarray(v) for k, v in state[0].mu.items()}
        p_before = {k: np.asarray(v) for k, v in p.items()}
        p, state = jstep(p, state, {k: jnp.asarray(v) for k, v in g.items()})
        for k in SHAPES:
            want = np.asarray(p[k])
            p_scale = np.abs(p_before[k]) + np.abs(want - p_before[k])
            assert (np.abs(port_p[k].numpy() - want) <= 4 * 2.0**-24 * p_scale).all()
            assert _ulps(port_state[0].nu[k].numpy(), np.asarray(state[0].nu[k])).max() <= 1
            scale = np.abs(np.float32(0.1) * g[k]) + np.abs(np.float32(0.9) * mu_before[k])
            mu_err = np.abs(port_state[0].mu[k].numpy() - np.asarray(state[0].mu[k]))
            assert (mu_err <= scale * 2.0**-23).all()
        assert int(port_state[0].count) == int(state[0].count)


@pytest.mark.parametrize("reference", ["jax_fused", "optax"])
def test_port_tracks_jax_over_10_free_steps(reference):
    """10 steps, each side on its own state: params within 1e-4 (Adam
    compounds the one-rounding differences above)."""
    rng = np.random.default_rng(2)
    lr = 3e-3
    jstep, jtx = _jax_tx(reference, lr)
    tx = fused_adamw(lr)
    params = _tree(rng)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = jtx.init(p)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = tx.init(tp)
    for _ in range(10):
        g = _tree(rng)
        p, state = jstep(p, state, {k: jnp.asarray(v) for k, v in g.items()})
        tp, tstate = tx.fused_apply(tp, tstate, {k: torch.tensor(v) for k, v in g.items()})
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(p[k]), rtol=0, atol=1e-4)


def test_bias_corrections_match_jax():
    """1 - b^t in fp32 as optax computes it under XLA, for t = 1..1500."""
    f = jax.jit(lambda c: jnp.stack([1 - 0.9**c, 1 - 0.999**c]))
    counts = np.arange(1, 1501, dtype=np.int32)
    want = np.stack([np.asarray(f(jnp.int32(c))) for c in counts])
    hp = fused_adamw(1e-3).hyperparams
    got = np.stack([bias_corrections(hp, torch.tensor(int(c), dtype=torch.int32)).numpy() for c in counts])
    np.testing.assert_array_equal(got, want)


def test_state_structure_mirrors_optax():
    """(ScaleByAdamState(count int32, mu, nu), EmptyState(), EmptyState()):
    optax's layout, leaf for leaf, fp32 moments of the params' shapes."""
    params = {"w": torch.ones((4, 4)), "b": {"x": torch.ones((3,))}}
    state = fused_adamw(1e-3).init(params)
    ref = optax.adamw(1e-3).init({"w": jnp.ones((4, 4)), "b": {"x": jnp.ones((3,))}})
    assert len(state) == len(ref) == 3
    assert isinstance(state[0], ScaleByAdamState) and type(ref[0]).__name__ == "ScaleByAdamState"
    assert state[0]._fields == ref[0]._fields == ("count", "mu", "nu")
    assert all(isinstance(s, EmptyState) for s in state[1:])
    assert [type(s).__name__ for s in ref[1:]] == ["EmptyState", "EmptyState"]
    assert state[0].count.dtype == torch.int32 and int(state[0].count) == 0
    for tree in (state[0].mu, state[0].nu):
        assert tree["w"].shape == (4, 4) and tree["b"]["x"].shape == (3,)
        assert tree["w"].dtype == torch.float32 and not tree["w"].any()


def test_fused_adamw_rejects_schedules():
    """``fused_adamw`` takes a scalar learning rate, as the JAX package's
    does; the plain ``adamw`` takes a schedule, as ``optax.adamw`` does
    (``tests/test_torch_scheduler.py`` holds it to optax)."""
    with pytest.raises(ValueError, match="scalar learning_rate"):
        fused_adamw(lambda step: 1e-3)
    state = adamw(lambda step: 1e-3).init({"w": torch.ones(2)})
    assert type(state[2]).__name__ == "ScaleByScheduleState" and int(state[2].count) == 0


def test_weight_decay_defaults_to_optax_not_torch():
    """wd 1e-4 (optax's default, not torch.optim.AdamW's 1e-2), added to the
    update before the learning rate: with a zero gradient, p moves by
    exactly -lr * wd * p."""
    hp = fused_adamw(1e-2).hyperparams
    assert hp.weight_decay == 1e-4 == adamw(1e-2).hyperparams.weight_decay
    p = {"w": torch.full((8,), 2.0)}
    tx = fused_adamw(1e-2)
    p, state = tx.fused_apply(p, tx.init(p), {"w": torch.zeros(8)})
    want = np.float32(2.0) + np.float32(-1e-2) * (np.float32(1e-4) * np.float32(2.0))
    np.testing.assert_array_equal(p["w"].numpy(), np.full(8, want, np.float32))
    assert int(state[0].count) == 1


def test_fused_apply_updates_in_place():
    """The update aliases as the JAX kernel does: the returned params and
    moments are the tensors that went in."""
    p = {"w": torch.ones((5, 3))}
    tx = fused_adamw(1e-3)
    state = tx.init(p)
    w, mu = p["w"], state[0].mu["w"]
    p2, state2 = tx.fused_apply(p, state, {"w": torch.ones((5, 3))})
    assert p2["w"] is w and state2[0].mu["w"] is mu
    assert not torch.equal(w, torch.ones((5, 3)))
