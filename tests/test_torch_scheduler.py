"""The port's scheduler (``accelerate_tpu_torch/scheduler.py``) and its
scheduled ``adamw`` against the JAX package's ``AcceleratedScheduler`` and
``optax.adamw(schedule)``.

The counter is compared exactly: the same loop over the same loader through
each package's ``Accelerator`` (``accumulate`` -> ``scheduler.step()``),
with accumulation windows closed every N micro-batches and by the end of
the loader. The JAX package ticks by its mesh's data extent where
``split_batches=False`` (8 on the test host's virtual CPU mesh); the port
by its data shards, 1 at one device, so the two are compared with
``split_batches=True`` and the port's tick of 1 is checked on its own.

``adamw(schedule)`` is held to ``optax.adamw(schedule)`` step by step from
optax's own state, within one rounding per op as
``tests/test_torch_fused_adamw.py`` explains: XLA contracts and rewrites
the formula (the schedule's division included), so ``nu`` is within 1 unit
in the last place, ``mu`` within 1 unit of its larger summand and ``p``
within 4 units of ``|p| + |its step|``; the counts are exact."""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.scheduler import AcceleratedScheduler as JaxScheduler
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils.dataclasses import GradientAccumulationPlugin as JaxPlugin
from accelerate_tpu_torch import Accelerator, GradientAccumulationPlugin, adamw, fused_adamw
from accelerate_tpu_torch.ops.fused_adamw import EmptyState, ScaleByAdamState, ScaleByScheduleState
from accelerate_tpu_torch.optimizer import apply_updates
from accelerate_tpu_torch.scheduler import AcceleratedScheduler
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.params import state_leaves

SHAPES = {"a": (16, 64), "b": (7,), "c": (4, 8, 32)}


def _reset():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def schedule(count):
    return 1e-3 / (1 + 0.05 * count)


def _counters(make_accelerator, plugin, n_rows, step_with_optimizer):
    """The scheduler's counter after each micro-batch of 2 epochs, and the
    micro-batches whose gradients sync."""
    acc = make_accelerator(plugin, step_with_optimizer)
    scheduler = acc.prepare_scheduler(schedule)
    loader = acc.prepare_data_loader([{"x": np.float32(i)} for i in range(n_rows)], batch_size=4,
                                     even_batches=False, prefetch=0)
    counters, syncs = [], []
    for epoch in range(2):
        loader.set_epoch(epoch)
        for _ in loader:
            with acc.accumulate():
                scheduler.step()
            counters.append(scheduler.step_count)
            syncs.append(acc.sync_gradients)
    return counters, syncs, scheduler.get_last_lr()


def _jax_accelerator(plugin, step_with_optimizer):
    _reset()
    return JaxAccelerator(gradient_accumulation_plugin=JaxPlugin(**plugin), split_batches=True,
                          step_scheduler_with_optimizer=step_with_optimizer)


def _port_accelerator(plugin, step_with_optimizer):
    _reset()
    return Accelerator(gradient_accumulation_plugin=GradientAccumulationPlugin(**plugin), split_batches=True,
                       step_scheduler_with_optimizer=step_with_optimizer, device="cpu")


@pytest.mark.parametrize(
    "plugin, step_with_optimizer",
    [
        ({"num_steps": 3}, True),
        ({"num_steps": 3, "adjust_scheduler": False}, True),
        ({"num_steps": 2, "sync_with_dataloader": False}, True),
        ({"num_steps": 2, "sync_each_batch": True, "adjust_scheduler": False}, True),
        ({"num_steps": 3}, False),
    ],
    ids=["accum3", "accum3_no_adjust", "accum2_no_dataloader_sync", "sync_each_batch", "not_with_optimizer"],
)
def test_counter_matches_jax_under_accumulation(plugin, step_with_optimizer):
    """22 rows in batches of 4 (the last of 2) over 2 epochs: the same
    counter after every micro-batch, the same syncing micro-batches (the
    end of the loader closes a partial window unless
    ``sync_with_dataloader=False``) and the same last lr."""
    want = _counters(_jax_accelerator, plugin, 22, step_with_optimizer)
    got = _counters(_port_accelerator, plugin, 22, step_with_optimizer)
    assert got[0] == want[0]
    assert got[1] == want[1]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-7)
    _reset()


class _Optimizer:
    def __init__(self, skipped):
        self.step_was_skipped = skipped


@pytest.mark.parametrize("skipped", [False, True])
def test_skipped_step_holds_the_counter_like_jax(skipped):
    """A step the fp16 loss scale skipped does not tick the schedule."""
    _reset()
    JaxGradientState()
    PartialState(device="cpu")
    jax_sched = JaxScheduler(schedule, optimizer=_Optimizer(skipped), split_batches=True)
    sched = AcceleratedScheduler(schedule, optimizer=_Optimizer(skipped), split_batches=True)
    for _ in range(3):
        jax_sched.step()
        sched.step()
    assert sched.step_count == jax_sched.step_count == (0 if skipped else 3)
    _reset()


def test_split_batches_false_ticks_by_data_shards_and_state_round_trips():
    """At one device the port ticks by 1 a step where ``split_batches`` is
    off; ``state_dict`` / ``load_state_dict`` carry the counter."""
    _reset()
    PartialState(device="cpu")
    sched = AcceleratedScheduler(schedule)
    for _ in range(4):
        sched.step()
    assert sched.state_dict() == {"counter": 4}
    other = AcceleratedScheduler(schedule)
    other.load_state_dict(sched.state_dict())
    assert other.step_count == 4 and other.get_last_lr() == [schedule(4)]
    _reset()


def _tree(rng):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia, ib = a.astype(np.float32).view(np.int32), b.astype(np.float32).view(np.int32)
    return np.abs(ia.astype(np.int64) - ib.astype(np.int64))


def test_scheduled_adamw_state_mirrors_optax_leaf_for_leaf():
    """(ScaleByAdamState, EmptyState(), ScaleByScheduleState(count)): optax's
    layout, the same leaves in the same order."""
    params = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}
    state = adamw(schedule).init({k: torch.tensor(v) for k, v in params.items()})
    ref = optax.adamw(schedule).init({k: jnp.asarray(v) for k, v in params.items()})
    assert [type(s).__name__ for s in state] == [type(s).__name__ for s in ref]
    assert isinstance(state[0], ScaleByAdamState) and isinstance(state[1], EmptyState)
    assert isinstance(state[2], ScaleByScheduleState) and state[2]._fields == ref[2]._fields == ("count",)
    got, want = state_leaves(state), jax.tree.leaves(ref)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    assert [str(x.dtype).split(".")[-1] for x in got] == [str(x.dtype) for x in want]


def _as_port_state(state):
    adam, _, sched = state
    to_t = lambda tree: {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}  # noqa: E731
    return (ScaleByAdamState(torch.tensor(int(adam.count), dtype=torch.int32), to_t(adam.mu), to_t(adam.nu)),
            EmptyState(), ScaleByScheduleState(torch.tensor(int(sched.count), dtype=torch.int32)))


def test_scheduled_adamw_matches_optax_step_by_step():
    """5 steps, each from optax's own state: one rounding per op apart, the
    schedule read at the count before its increment."""
    rng = np.random.default_rng(3)
    jtx = optax.adamw(schedule)
    tx = adamw(schedule)

    @jax.jit
    def jstep(p, s, g):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s

    p = {k: jnp.asarray(v) for k, v in _tree(rng).items()}
    state = jtx.init(p)
    for _ in range(5):
        g = _tree(rng)
        updates, port_state = tx.update({k: torch.tensor(v) for k, v in g.items()}, _as_port_state(state),
                                        {k: torch.tensor(np.asarray(v)) for k, v in p.items()})
        port_p = apply_updates({k: torch.tensor(np.asarray(v)) for k, v in p.items()}, updates)
        mu_before = {k: np.asarray(v) for k, v in state[0].mu.items()}
        p_before = {k: np.asarray(v) for k, v in p.items()}
        p, state = jstep(p, state, {k: jnp.asarray(v) for k, v in g.items()})
        for k in SHAPES:
            want = np.asarray(p[k])
            p_scale = np.abs(p_before[k]) + np.abs(want - p_before[k])
            assert (np.abs(port_p[k].numpy() - want) <= 4 * 2.0**-24 * p_scale).all()
            assert _ulps(port_state[0].nu[k].numpy(), np.asarray(state[0].nu[k])).max() <= 1
            scale = np.abs(np.float32(0.1) * g[k]) + np.abs(np.float32(0.9) * mu_before[k])
            assert (np.abs(port_state[0].mu[k].numpy() - np.asarray(state[0].mu[k])) <= scale * 2.0**-23).all()
        assert int(port_state[0].count) == int(state[0].count)
        assert int(port_state[2].count) == int(state[2].count)
    assert int(state[2].count) == 5


def test_schedule_moves_the_learning_rate():
    """With a zero gradient adam's step is 0, so p moves by the decay
    alone: ``-schedule(count) * wd * p`` at count 0, then 1."""
    tx = adamw(schedule)
    p = {"w": torch.full((4,), 2.0)}
    state = tx.init(p)
    for count in range(2):
        before = p["w"].clone()
        updates, state = tx.update({"w": torch.zeros(4)}, state, p)
        p = apply_updates(p, updates)
        lr = schedule(torch.tensor(count, dtype=torch.int32)).float()
        want = before + (-lr) * (np.float32(1e-4) * before)
        torch.testing.assert_close(p["w"], want, rtol=0, atol=0)
    assert int(state[2].count) == 2


def test_fused_adamw_still_refuses_a_schedule():
    with pytest.raises(ValueError, match="scalar learning_rate"):
        fused_adamw(schedule)
