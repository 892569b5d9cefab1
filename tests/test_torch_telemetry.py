"""The port's telemetry hub against the JAX package's, on the CPU: the step
timer's fence cadence and discarded windows, MFU against hand-computed
flops, the goodput ledger's math, kernel-build tracking, memory
watermarks, the profiler window and ``Accelerator.profile``, flush cadence,
an idempotent finish, a disabled hub, and ``telemetry.jsonl`` end to end
through a save and a resume, held record by record against the JAX
package's file for the same run (kinds, keys, step and token counts,
goodput categories; not times).

Both packages train the JAX tests' linear model ``x @ w`` (8 x 4, all
ones) with ``fused_adamw(1e-2)`` (the JAX kernel in interpret mode, the
port's kernel's plain version) on the same numpy batches. The ledger math
is exact (the same arithmetic on the same floats), so it is compared for
equality; MFU and throughput are compared to 1e-12 relative.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import CheckpointManager as JaxCheckpointManager
from accelerate_tpu.models.config import get_config as jax_get_config
from accelerate_tpu.models.config import train_flops_per_step as jax_train_flops
from accelerate_tpu.ops.fused_adamw import fused_adamw as jax_fused_adamw
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.telemetry import GoodputTracker as JaxGoodputTracker
from accelerate_tpu.telemetry import TelemetryConfig as JaxTelemetryConfig
from accelerate_tpu_torch import Accelerator, CheckpointManager, Telemetry, TelemetryConfig, fused_adamw
from accelerate_tpu_torch.models.config import get_config, train_flops_per_step
from accelerate_tpu_torch.ops import runtime
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.telemetry import (
    PEAK_BF16_FLOPS,
    CompileTracker,
    GoodputTracker,
    MemoryMonitor,
    ProfileWindow,
    StepTimer,
    device_peak_flops,
)
from accelerate_tpu_torch.telemetry.memory import state_bytes_per_chip


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones((8, 4), dtype=torch.float32))

    def param_tree(self):
        return {"w": self.w}

    @staticmethod
    def apply(params, x):
        return x @ params["w"]


class JaxTiny:
    def init(self, rng):  # noqa: ARG002
        return {"w": jnp.ones((8, 4), jnp.float32)}

    @staticmethod
    def apply(params, x):
        return x @ params["w"]


def _loss(params, batch):
    return torch.mean(Tiny.apply(params, batch) ** 2)


def _jax_loss(params, batch):
    return jnp.mean(JaxTiny.apply(params, batch) ** 2)


def _reset():
    for cls in (JaxAcceleratorState, JaxGradientState, JaxPartialState, AcceleratorState, GradientState,
                PartialState):
        cls._reset_state()


def _accelerator(config=None, **kwargs):
    acc = Accelerator(device="cpu", telemetry_config=config, **kwargs)
    acc.prepare(Tiny())
    opt = acc.prepare_optimizer(fused_adamw(1e-2))
    return acc, opt


# ---------------------------------------------------------------------------
# step timer
# ---------------------------------------------------------------------------


def test_step_timer_fences_only_on_sampling_cadence():
    timer = StepTimer(sample_every=8)
    x = torch.ones(())
    for _ in range(33):
        timer.step(x)
    # 33 steps at cadence 8: boundaries at 8, 16, 24, 32, exactly 4 fences
    assert timer.fence_count == 4
    assert len(timer.samples) == 3  # the first boundary only sets the baseline
    assert timer.steps == 33
    summary = timer.summary()
    assert summary["sampled_windows"] == 3
    assert summary["step_time_p50_ms"] > 0 and summary["steps_per_sec"] > 0


def test_step_timer_discard_window_drops_stall_and_takes_a_noted_fence():
    timer = StepTimer(sample_every=2)
    x = torch.ones(())
    for _ in range(4):
        timer.step(x)
    n = len(timer.samples)
    timer.discard_window()  # a checkpoint save happened here
    for _ in range(2):
        timer.step(x)
    assert len(timer.samples) == n  # the window spanning the discard gives no sample
    for _ in range(2):
        timer.step(x)
    assert len(timer.samples) == n + 1
    timer.note_fence()  # a caller's blocking read at this step: the boundary takes it
    timer.step(x)
    timer.note_fence()
    timer.step(x)
    assert timer.fence_count == 5 and timer.shared_fences == 1


def test_step_timer_rejects_bad_cadence():
    with pytest.raises(ValueError):
        StepTimer(sample_every=0)


# ---------------------------------------------------------------------------
# FLOPs / MFU math
# ---------------------------------------------------------------------------


def test_train_flops_match_the_jax_package_and_the_hand_computation():
    cfg = get_config("llama-tiny")
    seq, batch = 64, 4
    from accelerate_tpu_torch.models.config import param_count

    by_hand = batch * seq * (6.0 * param_count(cfg) + 12.0 * cfg.num_layers * cfg.hidden_size * seq)
    assert train_flops_per_step(cfg, batch, seq) == by_hand
    assert jax_train_flops(jax_get_config("llama-tiny"), batch, seq) == by_hand


def test_mfu_derivation_against_hand_computed_flops():
    acc = Accelerator(device="cpu", telemetry_config=TelemetryConfig(sample_every=4))
    telemetry = acc.telemetry
    cfg = get_config("llama-tiny")
    peak = 1e12
    telemetry.configure_throughput(cfg, batch_size=8, seq_len=32, peak_flops_per_device=peak)
    telemetry.timer._record(0.1, 10)  # a known step time: 10 ms a step
    telemetry.timer.steps = 10
    metrics = telemetry.metrics()
    flops = train_flops_per_step(cfg, 8, 32)
    assert metrics["mfu"] == pytest.approx(flops * 100.0 / peak, rel=1e-12)  # one process, one card
    assert metrics["tokens_per_sec"] == pytest.approx(8 * 32 * 100.0, rel=1e-12)
    assert metrics["examples_per_sec"] == pytest.approx(8 * 100.0, rel=1e-12)


def test_device_peak_flops_is_the_h100s_and_none_on_the_cpu():
    assert PEAK_BF16_FLOPS == {"H100 80GB HBM3": 989e12}
    assert device_peak_flops("cpu") is None
    acc = Accelerator(device="cpu")
    acc.telemetry.configure_throughput(flops_per_step=1e9)
    acc.telemetry.timer._record(0.1, 1)
    assert "mfu" not in acc.telemetry.metrics()  # no peak on the CPU: no MFU, never a guess


# ---------------------------------------------------------------------------
# kernel-build tracking and step-signature attribution
# ---------------------------------------------------------------------------


def test_compile_tracker_counts_builds_and_library_hits():
    with CompileTracker() as tracker:
        runtime._build_event("miss", "fused_adamw")
        runtime._build_event("build", ("fused_adamw", 1.5))
        runtime._build_event("hit", "flash_fwd")
    snap = tracker.snapshot()
    assert snap["compile_count"] == 1 and snap["compile_seconds"] == 1.5
    assert snap["jit_cache_misses"] == 1 and snap["jit_cache_hits"] == 1
    assert snap["jit_cache_build_seconds"] == 1.5
    assert snap["recent_miss_keys"] == ["'fused_adamw'"]
    runtime._build_event("build", ("paged_decode", 2.0))  # a stopped tracker stops counting
    assert tracker.snapshot()["compile_count"] == 1
    jax_keys = set(JaxAccelerator().telemetry.compiles.snapshot())
    assert set(snap) == jax_keys


def test_a_late_build_writes_a_compile_record_naming_the_changed_leaf(tmp_path):
    acc = Accelerator(device="cpu", telemetry_config=TelemetryConfig(dir=str(tmp_path)))
    telemetry = acc.telemetry
    telemetry.note_step_signature({"input_ids": torch.zeros((2, 8), dtype=torch.int64)})
    telemetry.step()
    telemetry.note_step_signature({"input_ids": torch.zeros((2, 16), dtype=torch.int64)})
    runtime._build_event("build", ("flash_fwd", 0.5))  # a new shape reached a kernel first
    telemetry.step()
    telemetry.finish(flush=False)
    [record] = [json.loads(line) for line in open(tmp_path / "telemetry.jsonl")]
    assert record["kind"] == "compile" and record["new_compiles"] == 1
    assert record["explain"]["changed"] == {"['input_ids']": ["(2, 8)/int64", "(2, 16)/int64"]}


# ---------------------------------------------------------------------------
# goodput
# ---------------------------------------------------------------------------


def test_goodput_ledger_math_equals_the_jax_packages():
    snaps = []
    for cls in (GoodputTracker, JaxGoodputTracker):
        tracker = cls()
        tracker.record("checkpoint_save", 2.0)
        tracker.record("checkpoint_save", 1.0)
        tracker.record("dataloader_rewind", 0.25)
        tracker.record("guard_skipped", -1.0)  # clamped to 0
        tracker.mark_restart()
        snaps.append(tracker.snapshot(productive_seconds=12.0, compile_seconds=3.0))
    assert snaps[0] == snaps[1]
    snap = snaps[0]
    assert snap["lost_s"] == pytest.approx(3.0 + 0.25 + 3.0)
    assert snap["goodput"] == pytest.approx(12.0 / (12.0 + snap["lost_s"]), abs=1e-4)
    assert snap["event_counts"]["checkpoint_save"] == 2 and snap["restarts"] == 1


def test_goodput_bookkeeping_across_preemption_save_and_resume(tmp_path):
    acc, opt = _accelerator(TelemetryConfig(sample_every=2, dir=str(tmp_path)))
    manager = CheckpointManager(acc, checkpoint_dir=str(tmp_path / "ckpts"), handle_signals=())
    batch = torch.ones((4, 8))
    for _ in range(4):
        loss = acc.backward(_loss, batch)
        opt.step()
        opt.zero_grad()
        acc.telemetry.step(loss)
    assert acc.telemetry.optimizer_steps == 4  # the eager step counts too
    manager.request_preemption()
    assert manager.should_save(4)
    manager.save(4)
    assert acc.telemetry.goodput._lost.get("checkpoint_save", 0) > 0
    assert acc.telemetry.goodput._counts["checkpoint_save"] == 1

    _reset()
    acc2, opt2 = _accelerator(TelemetryConfig(sample_every=2, dir=str(tmp_path)))
    resume = CheckpointManager(acc2, checkpoint_dir=str(tmp_path / "ckpts"), handle_signals=()).resume("auto")
    assert resume is not None and resume.step == 4
    assert acc2.telemetry.goodput.restarts == 1
    for _ in range(4):
        loss = acc2.backward(_loss, batch)
        opt2.step()
        opt2.zero_grad()
        acc2.telemetry.step(loss)
    goodput = acc2.telemetry.flush()["goodput"]
    assert goodput["restarts"] == 1 and goodput["overhead_s"]["checkpoint_restore"] > 0
    assert 0 < goodput["goodput"] <= 1


def test_aggregate_single_process_is_the_process_own_spread():
    acc = Accelerator(device="cpu")
    record = acc.telemetry.flush()
    assert record["aggregate"]["steps"] == {"min": 0.0, "max": 0.0, "mean": 0.0}
    agg = PartialState().aggregate_metrics({"a": 2.0, "b": 3, "skip": "str", "flag": True})
    assert agg == {"a": {"min": 2.0, "max": 2.0, "mean": 2.0}, "b": {"min": 3.0, "max": 3.0, "mean": 3.0}}


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------


def test_memory_monitor_reports_host_rss_on_the_cpu_and_state_bytes():
    monitor = MemoryMonitor()
    monitor.sample()
    snap = monitor.snapshot()
    assert monitor.hbm_high_watermark_bytes is None  # no device stats on the CPU
    assert snap["host_peak_rss_bytes"] > 0 and snap["samples"] == 1
    _, opt = _accelerator()
    # count int32 + mu and nu of 8 x 4 fp32
    assert state_bytes_per_chip(opt.opt_state) == 4 + 2 * 32 * 4


# ---------------------------------------------------------------------------
# telemetry.jsonl end to end, against the JAX package's file
# ---------------------------------------------------------------------------


def _records(path):
    return [json.loads(line) for line in open(path)]


def _port_run(directory):
    config = TelemetryConfig(sample_every=4, dir=directory)
    cfg = get_config("llama-tiny")
    acc, _ = _accelerator(config)
    step = acc.compiled_step(_loss)
    acc.telemetry.configure_throughput(cfg, batch_size=16, seq_len=8, peak_flops_per_device=1e12)
    manager = CheckpointManager(acc, checkpoint_dir=os.path.join(directory, "ckpts"), handle_signals=())
    batch = torch.ones((16, 8))
    for _ in range(8):
        acc.telemetry.step(step(batch))
    manager.request_preemption()
    manager.save(8)
    _reset()
    acc2, _ = _accelerator(config)
    step2 = acc2.compiled_step(_loss)
    acc2.telemetry.configure_throughput(cfg, batch_size=16, seq_len=8, peak_flops_per_device=1e12)
    assert CheckpointManager(acc2, checkpoint_dir=os.path.join(directory, "ckpts"),
                             handle_signals=()).resume("auto").step == 8
    for _ in range(16):
        acc2.telemetry.step(step2(batch))
    assert acc2.telemetry.timer.fence_count == 16 // 4  # no fence outside the cadence
    acc2.telemetry.finish()
    return _records(os.path.join(directory, "telemetry.jsonl"))


def _jax_run(directory):
    config = JaxTelemetryConfig(sample_every=4, dir=directory)
    cfg = jax_get_config("llama-tiny")

    def setup():
        acc = JaxAccelerator(telemetry_config=config)
        acc.prepare(JaxTiny())
        acc.prepare_optimizer(jax_fused_adamw(1e-2))
        step = acc.compiled_step(_jax_loss)
        acc.telemetry.configure_throughput(cfg, batch_size=16, seq_len=8, peak_flops_per_device=1e12)
        return acc, step

    acc, step = setup()
    manager = JaxCheckpointManager(acc, checkpoint_dir=os.path.join(directory, "ckpts"), handle_signals=())
    batch = jnp.ones((16, 8), jnp.float32)
    for _ in range(8):
        acc.telemetry.step(step(batch))
    manager.request_preemption()
    manager.save(8)
    _reset()
    acc2, step2 = setup()
    JaxCheckpointManager(acc2, checkpoint_dir=os.path.join(directory, "ckpts"), handle_signals=()).resume("auto")
    for _ in range(16):
        acc2.telemetry.step(step2(batch))
    acc2.telemetry.finish()
    return _records(os.path.join(directory, "telemetry.jsonl"))


def test_telemetry_jsonl_end_to_end_with_save_resume_matches_the_jax_packages(tmp_path):
    got = _port_run(str(tmp_path / "port"))
    want = _jax_run(str(tmp_path / "jax"))
    assert [(r["kind"], r["step"]) for r in got] == [(r["kind"], r["step"]) for r in want]
    for a, b in zip(got, want):
        assert set(a) == set(b), a["kind"]
    final, jax_final = got[-1], want[-1]
    assert final["kind"] == "telemetry" and final["step"] == 16
    assert set(final["metrics"]) == set(jax_final["metrics"])
    assert set(final["compiles"]) == set(jax_final["compiles"])
    assert set(final["memory"]) == set(jax_final["memory"])
    for key in ("steps", "sampled_windows", "sample_every", "optimizer_steps"):
        assert final["metrics"][key] == jax_final["metrics"][key], key
    # the step times differ between the runs; the tokens and examples a step do not
    for key in ("tokens_per_sec", "examples_per_sec"):
        per_step = final["metrics"][key] / final["metrics"]["steps_per_sec"]
        assert per_step == pytest.approx(jax_final["metrics"][key] / jax_final["metrics"]["steps_per_sec"])
    assert final["metrics"]["mfu"] > 0 and 0 < final["metrics"]["goodput"] <= 1
    # the JAX run's compile time is XLA's; the port on the CPU builds no kernel
    assert set(final["goodput"]["overhead_s"]) == set(jax_final["goodput"]["overhead_s"]) - {"compile"}
    assert final["goodput"]["event_counts"] == jax_final["goodput"]["event_counts"]
    assert final["goodput"]["restarts"] == jax_final["goodput"]["restarts"] == 1
    assert final["aggregate"]["steps"]["mean"] == 16
    kernels = [r for r in got if r["kind"] == "kernels"]
    assert [r["fused_adamw"] for r in kernels] == ["plain", "plain"]


# ---------------------------------------------------------------------------
# profile windows, flush cadence, finish, disabled
# ---------------------------------------------------------------------------


def test_profile_is_reentrancy_safe_and_snapshots_memory(tmp_path):
    acc = Accelerator(device="cpu")
    with acc.profile(str(tmp_path / "trace"), host_metadata={"run": "t1"}) as capture:
        with pytest.raises(RuntimeError, match="already active"):
            with acc.profile(str(tmp_path / "nested")):
                pass
        torch.ones((4, 4)) @ torch.ones((4, 4))
    assert isinstance(capture, str) and capture == str(tmp_path / "trace")
    assert capture.memory_before == [] and capture.memory_after == []  # the CPU has no device stats
    meta = json.load(open(tmp_path / "trace" / "host_metadata.json"))
    assert meta["run"] == "t1" and meta["process_index"] == 0 and meta["device_kind"] == "cpu"
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with acc.profile(str(tmp_path / "trace2")):  # the guard released
        pass
    with pytest.raises(ValueError, match="no counterpart"):
        with acc.profile(str(tmp_path / "trace3"), port=9999):
            pass


def test_profile_window_env_arming_and_step_boundaries(tmp_path, monkeypatch):
    monkeypatch.setenv("ACCELERATE_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("ACCELERATE_PROFILE_START_STEP", "3")
    monkeypatch.setenv("ACCELERATE_PROFILE_STEPS", "2")
    window = ProfileWindow.from_env()
    assert window is not None and window.armed
    started, stopped = [], []
    monkeypatch.setattr(window, "_start", lambda: (started.append(True), setattr(window, "active", True)))

    def stop():
        stopped.append(True)
        window.active = False
        window.completed = True

    monkeypatch.setattr(window, "_stop", stop)
    for step in range(8):
        window.on_step(step)
    assert len(started) == 1 and len(stopped) == 1
    assert not window.armed  # one-shot: never rearms
    monkeypatch.setenv("ACCELERATE_PROFILE_PORT", "9999")
    with pytest.raises(ValueError, match="no counterpart"):
        ProfileWindow.from_env()


def test_profile_window_writes_real_trace(tmp_path):
    window = ProfileWindow(output_dir=str(tmp_path), start_step=1, num_steps=2)
    for step in range(5):
        torch.ones((4, 4)) * step
        window.on_step(step)
    assert window.completed
    assert os.path.exists(os.path.join(str(tmp_path), "host_0", "trace.json"))


def test_flush_every_and_canonical_loop_emit_one_record_per_boundary(tmp_path):
    acc = Accelerator(device="cpu", telemetry_config=TelemetryConfig(sample_every=2, flush_every=4,
                                                                     dir=str(tmp_path)))
    telemetry = acc.telemetry
    for _ in range(8):
        telemetry.step(torch.ones(()))
        if telemetry.should_flush():
            telemetry.flush(step=telemetry.steps)
    telemetry.finish(flush=False)
    telemetry.finish(flush=False)  # idempotent
    assert [r["step"] for r in _records(tmp_path / "telemetry.jsonl")] == [4, 8]


def test_finish_is_idempotent_no_duplicate_final_record(tmp_path):
    acc = Accelerator(device="cpu", telemetry_config=TelemetryConfig(sample_every=2, dir=str(tmp_path)))
    for _ in range(4):
        acc.telemetry.step(torch.ones(()))
    acc.telemetry.finish()
    acc.end_training()  # calls finish() again: a no-op
    assert len(_records(tmp_path / "telemetry.jsonl")) == 1


def test_telemetry_disabled_is_inert(tmp_path, monkeypatch):
    acc = Accelerator(device="cpu", telemetry_config=TelemetryConfig(enabled=False, dir=str(tmp_path)))
    acc.telemetry.step(torch.ones(()))
    assert acc.telemetry.flush() is None
    acc.telemetry.finish()
    assert acc.telemetry.timer.steps == 0
    assert not os.path.exists(tmp_path / "telemetry.jsonl")
    monkeypatch.setenv("ACCELERATE_TELEMETRY", "0")
    assert Telemetry().enabled is False
    monkeypatch.delenv("ACCELERATE_TELEMETRY")
    assert Telemetry().enabled is True  # on by default, as the JAX package's
