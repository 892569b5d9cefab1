"""The port's numerical guard, resilience hub and chaos probes against the
JAX package's, on the CPU.

The two packages get the same inputs: a linear model ``x @ w`` (8 x 4) with
``w`` drawn by numpy from a seed, numpy batches, ``fused_adamw(1e-2)`` (the
JAX kernel in interpret mode, the port's kernel's plain version), and the
same ``FaultPlan``. On the CPU the port's fused adamw takes the skip flag
through ``torch.where`` beside the plain update, the kernel's guarded
variant runs on the card only (``chip_smoke.py`` phase 30).

Tolerances, and why:
- params against the JAX package's after a guarded run: 1e-5 absolute
  (a few Adam steps of size ``lr``; the two frameworks sum the gradient's
  rows in other orders, and Adam turns a rounding difference of a gradient
  element into at most a few ulps of its step);
- a skipped step against the port's own clean run over the same batches
  without the poisoned ones: bit-equal (params, both moments and the count:
  the skip writes nothing), as in the JAX package's test.
"""

import json
import os
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu.ops.fused_adamw import fused_adamw as jax_fused_adamw
from accelerate_tpu.resilience import FaultPlan as JaxFaultPlan
from accelerate_tpu.resilience import GuardPolicy as JaxGuardPolicy
from accelerate_tpu.resilience import ResilienceConfig as JaxResilienceConfig
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.telemetry import TelemetryConfig as JaxTelemetryConfig
from accelerate_tpu_torch import Accelerator, CheckpointManager, Llama, adamw, fused_adamw
from accelerate_tpu_torch.fault_tolerance import verify_checkpoint
from accelerate_tpu_torch.resilience import (
    FaultPlan,
    GuardPolicy,
    ResilienceConfig,
    tree_all_finite,
    zero_guard_state,
)
from accelerate_tpu_torch.resilience import chaos as chaos_mod
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.telemetry import TelemetryConfig
from accelerate_tpu_torch.utils.params import state_leaves

LR = 1e-2
PARAMS_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


class Tiny(torch.nn.Module):
    """The JAX tests' ``Tiny``: ``x @ w``, one (8, 4) weight."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(np.array(w), dtype=torch.float32))

    def param_tree(self):
        return {"w": self.w}

    @staticmethod
    def apply(params, x):
        return x @ params["w"]


class JaxTiny:
    def init(self, rng):  # noqa: ARG002 - the weights come from numpy
        return {"w": jnp.asarray(W0)}

    @staticmethod
    def apply(params, x):
        return x @ params["w"]


W0 = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
BATCHES = [np.random.default_rng(100 + i).standard_normal((8, 8)).astype(np.float32) for i in range(12)]


def _loss(params, batch):
    return torch.mean(Tiny.apply(params, batch) ** 2)


def _jax_loss(params, batch):
    return jnp.mean(JaxTiny.apply(params, batch) ** 2)


def _reset():
    for cls in (JaxAcceleratorState, JaxGradientState, JaxPartialState, AcceleratorState, GradientState,
                PartialState):
        cls._reset_state()
    chaos_mod.deactivate()


def _port(plan=None, policy=None, telemetry_dir=None, tx=None, resilience=True):
    _reset()
    config = ResilienceConfig(guard=policy if policy is not None else GuardPolicy(check_every=2),
                              fault_plan=plan) if resilience else None
    telemetry = TelemetryConfig(dir=telemetry_dir, sample_every=2) if telemetry_dir else None
    acc = Accelerator(device="cpu", resilience_config=config, telemetry_config=telemetry)
    model = acc.prepare_model(Tiny(W0))
    opt = acc.prepare_optimizer(tx if tx is not None else fused_adamw(LR))
    return acc, model, opt


def _jax(plan=None, policy=None, telemetry_dir=None):
    _reset()
    config = JaxResilienceConfig(guard=policy if policy is not None else JaxGuardPolicy(check_every=2),
                                 fault_plan=plan)
    telemetry = JaxTelemetryConfig(dir=telemetry_dir, sample_every=2) if telemetry_dir else None
    acc = JaxAccelerator(resilience_config=config, telemetry_config=telemetry,
                         parallelism=JaxParallelismConfig(zero_stage=0))
    model = acc.prepare_model(JaxTiny(), params={"w": jnp.asarray(W0)})
    opt = acc.prepare_optimizer(jax_fused_adamw(LR))
    return acc, model, opt


def _run(step, batches, torch_batches=True):
    return [step(torch.as_tensor(b) if torch_batches else jnp.asarray(b)) for b in batches]


def _state_arrays(opt) -> list:
    return [x.detach().numpy().copy() for x in state_leaves(opt.opt_state)]


def _clean(batches, tx=None):
    acc, model, opt = _port(tx=tx, resilience=False)
    _run(acc.compiled_step(_loss), batches)
    return model.params["w"].detach().numpy().copy(), _state_arrays(opt)


def test_tree_all_finite():
    assert bool(tree_all_finite({"a": torch.ones(3), "b": torch.zeros(2)}))
    assert not bool(tree_all_finite({"a": torch.ones(3), "b": torch.tensor(float("nan"))}))
    assert bool(tree_all_finite({"ints": torch.arange(3)}))  # non-float leaves ignored
    assert bool(tree_all_finite((torch.ones(2), [torch.zeros(1)])))
    state = zero_guard_state()
    assert sorted(state) == ["consecutive", "escalate", "skipped"]
    assert all(v.dtype == torch.int32 and v.ndim == 0 for v in state.values())


@pytest.mark.parametrize("target", ["grads", "loss"])
def test_guard_skips_nan_steps_bit_exactly_and_matches_jax(target):
    """6 guarded steps with NaN injected at 2 and 5 leave params, both moments
    and the count EXACTLY as a clean run over the 4 other batches, and
    within 1e-5 of the JAX package's guarded run."""
    plan = dict(nan_steps=(2, 5), nan_target=target)
    acc, model, opt = _port(plan=FaultPlan(**plan))
    losses = [float(x) for x in _run(acc.compiled_step(_loss), BATCHES[:6])]
    guard = acc.resilience.guard
    guard.check(model, opt)
    assert guard.skipped_steps == 2
    if target == "loss":
        assert np.isnan(losses[1]) and np.isnan(losses[4]) and np.isfinite(losses[2])
    got, got_state = model.params["w"].detach().numpy().copy(), _state_arrays(opt)
    want, want_state = _clean([BATCHES[i] for i in (0, 2, 3, 5)])
    np.testing.assert_array_equal(got, want)
    for a, b in zip(got_state, want_state):
        np.testing.assert_array_equal(a, b)
    assert int(opt.opt_state[0].count) == 4

    jacc, jmodel, jopt = _jax(plan=JaxFaultPlan(**plan))
    jlosses = [float(x) for x in _run(jacc.compiled_step(_jax_loss), BATCHES[:6], torch_batches=False)]
    jacc.resilience.guard.check(jmodel, jopt)
    assert jacc.resilience.guard.skipped_steps == 2
    np.testing.assert_allclose(got, np.asarray(jmodel.params["w"]), atol=PARAMS_ATOL, rtol=0)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


def test_guarded_llama_step_skip_is_bit_equal_to_clean_run():
    """llama-tiny through the fused adamw: a poisoned step leaves every param
    leaf, both moments and the count as the clean run over the other
    batches (the guard computes the global norm; without a clip it only
    reads the gradients)."""
    rng = np.random.default_rng(7)
    batches = [{"input_ids": torch.as_tensor(rng.integers(0, 1024, (2, 32)).astype(np.int64))} for _ in range(4)]

    def run(plan, feed):
        _reset()
        config = ResilienceConfig(guard=GuardPolicy(check_every=2), fault_plan=plan) if plan else None
        acc = Accelerator(device="cpu", resilience_config=config)
        torch.manual_seed(0)
        module = Llama("llama-tiny", device="cpu", seed=0)
        prepared = acc.prepare_model(module)
        opt = acc.prepare_optimizer(fused_adamw(1e-3))
        step = acc.compiled_step(Llama.loss_fn(module))
        for batch in feed:
            step(batch)
        return ([p.detach().numpy().copy() for p in state_leaves(prepared.params)], _state_arrays(opt))

    got = run(FaultPlan(nan_steps=(3,)), batches)
    want = run(None, [batches[i] for i in (0, 1, 3)])
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)


def test_guard_skip_through_torch_where_for_plain_adamw():
    """A transform without the fused kernel skips by ``torch.where`` over
    params and state: bit-equal to the clean run, count included."""
    acc, model, opt = _port(plan=FaultPlan(nan_steps=(2,)), tx=adamw(LR))
    _run(acc.compiled_step(_loss), BATCHES[:3])
    want, want_state = _clean([BATCHES[0], BATCHES[2]], tx=adamw(LR))
    np.testing.assert_array_equal(model.params["w"].detach().numpy(), want)
    for a, b in zip(_state_arrays(opt), want_state):
        np.testing.assert_array_equal(a, b)


def test_guard_escalates_clip_after_bad_step():
    """For escalate_steps after a bad step the global-norm clip tightens to
    escalate_clip, chosen on the device: near zero, the post-NaN gradient
    reaches Adam as ~0 (its step then comes from the first moment alone),
    so the weights part from the unescalated control's; the params match
    the JAX package's."""
    policy = dict(check_every=2, escalate_clip=1e-8, escalate_steps=4)
    acc, model, opt = _port(plan=FaultPlan(nan_steps=(2,)), policy=GuardPolicy(**policy))
    step = acc.compiled_step(_loss)
    step(torch.as_tensor(BATCHES[0]))
    after_1 = model.params["w"].detach().numpy().copy()
    step(torch.as_tensor(BATCHES[1]))  # NaN: skipped, escalation armed
    step(torch.as_tensor(BATCHES[2]))  # escalated clip: a tiny update
    after_3 = model.params["w"].detach().numpy().copy()
    state = {k: int(v) for k, v in acc.resilience.guard.state.items()}
    assert state["escalate"] == 3  # armed at 4 on the bad step, one good step since

    jacc, jmodel, _ = _jax(plan=JaxFaultPlan(nan_steps=(2,)), policy=JaxGuardPolicy(**policy))
    _run(jacc.compiled_step(_jax_loss), BATCHES[:3], torch_batches=False)
    np.testing.assert_allclose(after_3, np.asarray(jmodel.params["w"]), atol=PARAMS_ATOL, rtol=0)

    control, cmodel, _ = _port(plan=FaultPlan(nan_steps=(2,)))
    _run(control.compiled_step(_loss), BATCHES[:3])
    moved = np.abs(cmodel.params["w"].detach().numpy() - after_1).max()
    escalated = np.abs(after_3 - after_1).max()
    assert np.abs(cmodel.params["w"].detach().numpy() - after_3).max() > 1e-3
    assert escalated < moved


def test_guard_restores_last_known_good_after_k_consecutive_bad_steps(tmp_path):
    """restore_after consecutive bad steps at a check boundary roll params
    AND optimizer state back to the snapshot (taken before the first step),
    and training goes on from there as a clean run from the start would."""
    plan = FaultPlan(nan_steps=(3, 4))
    policy = GuardPolicy(check_every=4, restore_after=2, snapshot_every=1)
    acc, model, opt = _port(plan=plan, policy=policy, telemetry_dir=str(tmp_path))
    initial_state = _state_arrays(opt)
    step = acc.compiled_step(_loss)
    _run(step, BATCHES[:4])  # good, good, NaN, NaN: the check at 4 sees consecutive=2
    guard = acc.resilience.guard
    assert guard.restores == 1
    np.testing.assert_array_equal(model.params["w"].detach().numpy(), W0)
    for a, b in zip(_state_arrays(opt), initial_state):
        np.testing.assert_array_equal(a, b)
    state = {k: int(v) for k, v in guard.state.items()}
    assert state == {"skipped": 2, "consecutive": 0, "escalate": 0}
    _run(step, BATCHES[4:6])
    guard.check(model, opt)
    assert guard.restores == 1
    want, _ = _clean(BATCHES[4:6])
    np.testing.assert_array_equal(model.params["w"].detach().numpy(), want)
    acc.end_training()
    records = [json.loads(line) for line in open(tmp_path / "telemetry.jsonl")]
    events = [r.get("event") for r in records if r["kind"] == "resilience"]
    assert "guard_restore" in events and "guard_skip" in events
    snapshot = acc.telemetry.goodput.snapshot(acc.telemetry.timer.productive_seconds)
    assert snapshot["event_counts"].get("guard_restore") == 1


def test_guard_skipped_time_feeds_goodput_ledger_and_shares_the_fence(tmp_path):
    """A skip lands in the goodput ledger; the guard's read of its state is
    the step timer's fence at the shared cadence (no second fence)."""
    acc, model, opt = _port(plan=FaultPlan(nan_steps=(2,)), telemetry_dir=str(tmp_path))
    step = acc.compiled_step(_loss)
    for b in BATCHES[:4]:
        acc.telemetry.step(step(torch.as_tensor(b)))
    snapshot = acc.telemetry.goodput.snapshot(acc.telemetry.timer.productive_seconds)
    assert snapshot["event_counts"].get("guard_skipped") == 1
    timer = acc.telemetry.timer
    assert timer.fence_count == 2 and timer.shared_fences == 2  # boundaries at 2 and 4: the guard's reads


def test_resilience_disabled_is_inert():
    acc, model, opt = _port(resilience=False)
    assert acc.resilience.enabled is False
    assert acc.resilience.guard is None and acc.resilience.chaos is None
    step = acc.compiled_step(_loss)
    assert np.isfinite(float(step(torch.as_tensor(BATCHES[0]))))
    acc.end_training()  # finish() is a no-op, never raises
    jacc = JaxAccelerator()
    assert jacc.resilience.enabled is False


def test_chaos_stall_injects_host_delay():
    plan = FaultPlan(stall_steps=(2,), stall_seconds=0.15)
    acc, model, opt = _port(plan=plan)
    step = acc.compiled_step(_loss)
    step(torch.as_tensor(BATCHES[0]))
    start = time.perf_counter()
    step(torch.as_tensor(BATCHES[1]))
    assert time.perf_counter() - start >= 0.15
    assert [e["fault"] for e in plan.events] == ["stall"]


def test_chaos_end_to_end_nan_io_sigterm_resume(tmp_path, monkeypatch):
    """A 12-step run absorbs 2 NaN steps, 1 transient checkpoint-save
    failure (the manifest write's ``probe_io``, ridden out by its retry) and
    a SIGTERM, and ends with EXACTLY the weights of a clean 10-step run over
    the same batches, through a bit-exact resume; every event is a
    resilience record in telemetry.jsonl."""
    monkeypatch.setattr("accelerate_tpu_torch.utils.memory.time.sleep", lambda s: None)
    telemetry_dir, ckpt_dir = str(tmp_path / "telemetry"), str(tmp_path / "ckpts")
    total, sigterm_at = 12, 5
    plan1 = FaultPlan(nan_steps=(3,), sigterm_step=sigterm_at, io_failures=1)
    acc, model, opt = _port(plan=plan1, telemetry_dir=telemetry_dir)
    step = acc.compiled_step(_loss)
    with CheckpointManager(acc, checkpoint_dir=ckpt_dir) as manager:
        last = 0
        for i in range(1, total + 1):
            acc.telemetry.step(step(torch.as_tensor(BATCHES[i - 1])))
            last = i
            if manager.save_on_preemption(step=i):
                break
    assert last == sigterm_at and manager.exit_requested
    assert [e["fault"] for e in plan1.events] == ["nan", "sigterm", "io_error"]
    assert verify_checkpoint(os.path.join(ckpt_dir, f"checkpoint_{sigterm_at}")) == []
    phase1 = model.params["w"].detach().numpy().copy()
    acc.end_training()

    plan2 = FaultPlan(nan_steps=(2,))  # global step 7
    acc2, model2, opt2 = _port(plan=plan2, telemetry_dir=telemetry_dir)
    with torch.no_grad():
        model2.params["w"].zero_()  # junk: the resume must overwrite it
    resume = CheckpointManager(acc2, checkpoint_dir=ckpt_dir, handle_signals=()).resume("auto")
    assert resume is not None and resume.step == sigterm_at
    np.testing.assert_array_equal(phase1, model2.params["w"].detach().numpy())
    step2 = acc2.compiled_step(_loss)
    for i in range(sigterm_at + 1, total + 1):
        acc2.telemetry.step(step2(torch.as_tensor(BATCHES[i - 1])))
    acc2.resilience.guard.check(model2, opt2)
    assert acc2.resilience.guard.skipped_steps == 1
    acc2.end_training()
    want, _ = _clean([BATCHES[i - 1] for i in range(1, total + 1) if i not in (3, 7)])
    np.testing.assert_array_equal(model2.params["w"].detach().numpy(), want)

    records = [json.loads(line) for line in open(os.path.join(telemetry_dir, "telemetry.jsonl"))]
    res = [r for r in records if r["kind"] == "resilience"]
    faults = [r["fault"] for r in res if r.get("event") == "fault_injected"]
    assert sorted(faults) == ["io_error", "nan", "nan", "sigterm"]
    assert sum(r["count"] for r in res if r.get("event") == "guard_skip") == 2
    assert any(r.get("event") == "retry" for r in res)  # the backoff was recorded
    assert sum(r.get("event") == "summary" for r in res) == 2
    goodput = [r for r in records if r["kind"] == "telemetry"][-1]["goodput"]
    assert goodput["restarts"] == 1 and goodput["overhead_s"]["checkpoint_restore"] > 0


def test_chaos_probe_io_is_a_noop_without_a_plan_and_counts_its_budget():
    chaos_mod.deactivate()
    chaos_mod.probe_io("checkpoint_save")  # no plan: nothing happens
    plan = chaos_mod.activate(FaultPlan(io_failures=2))
    try:
        for _ in range(2):
            with pytest.raises(OSError):
                chaos_mod.probe_io("checkpoint_load")
        chaos_mod.probe_io("checkpoint_load")  # the budget is spent
        assert [e["site"] for e in plan.events] == ["checkpoint_load", "checkpoint_load"]
    finally:
        chaos_mod.deactivate()
