"""The Telemetry hub: one object wiring timers, compile capture, memory
watermarks, goodput, throughput/MFU derivation, and the profiler window into
an Accelerator, with multi-process aggregation and a machine-readable sink.

Counterpart of ``accelerate_tpu/telemetry/hub.py``: the same configuration
(fields, ``ACCELERATE_TELEMETRY*`` names, defaults: on unless
``ACCELERATE_TELEMETRY=0``), the same ``telemetry.jsonl`` records and keys.

Canonical loop::

    accelerator = Accelerator()                      # hub comes attached
    telemetry = accelerator.telemetry
    telemetry.configure_throughput(model.config, batch_size=32, seq_len=128)
    for batch in loader:
        loss = step(batch)
        telemetry.step(loss)                         # fences only on cadence
        if telemetry.should_flush():
            telemetry.flush(step=telemetry.steps)    # collective across processes
    telemetry.finish()

Steady-state cost: ``step()`` outside a sampling boundary is a few integer
compares: no synchronize, no device read, no launch. ``flush()`` IS a
collective when ``num_processes > 1`` (it aggregates min/max/mean across
processes), so every process must call it at the same step, as
``save_state``. Records land in ``telemetry.jsonl`` (main process) and fan
out to any active ``tracking.py`` trackers.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional

from ..logging import get_logger
from ..utils.concurrency import named_lock
from ..utils.environment import parse_flag_from_env, parse_int_from_env
from .compile_tracker import CompileTracker
from .goodput import GoodputTracker
from .memory import MemoryMonitor
from .profiler import ProfileWindow
from .step_timer import StepTimer

logger = get_logger(__name__)


@dataclass
class TelemetryConfig:
    enabled: bool = True
    sample_every: int = 16      # steps between forced fences (and memory polls)
    flush_every: int = 0        # steps between automatic flushes; 0 = manual only
    dir: Optional[str] = None   # telemetry.jsonl directory (default: logging_dir)
    track_compiles: bool = True
    peak_flops_per_device: Optional[float] = None  # override for MFU (None = probe)

    @classmethod
    def from_env(cls) -> "TelemetryConfig":
        return cls(
            enabled=parse_flag_from_env("ACCELERATE_TELEMETRY", True),
            sample_every=parse_int_from_env("ACCELERATE_TELEMETRY_SAMPLE_EVERY", 16),
            flush_every=parse_int_from_env("ACCELERATE_TELEMETRY_FLUSH_EVERY", 0),
            dir=os.environ.get("ACCELERATE_TELEMETRY_DIR"),
        )


class Telemetry:
    def __init__(self, accelerator: Any = None, config: Optional[TelemetryConfig] = None):
        self.accelerator = accelerator
        self.config = config or TelemetryConfig.from_env()
        self.enabled = self.config.enabled
        self.timer = StepTimer(sample_every=self.config.sample_every)
        self.compiles = CompileTracker()
        self.memory = MemoryMonitor()
        self.goodput = GoodputTracker()
        self.profile_window = ProfileWindow.from_env() if self.enabled else None
        self._created = time.perf_counter()
        self._first_step_done = False
        self.optimizer_steps = 0
        self._file = None
        # serving's step watchdog reports hangs from a side thread; the jsonl
        # sink must not interleave lines or double-open under that race
        self._write_lock = named_lock("hub.write")
        self._finished = False
        self._last_flush_step: Optional[int] = None
        self._throughput: dict[str, float] = {}
        # late-build attribution: the step notes its abstract signature per
        # step; when a kernel build fires after warmup, the diff of the last
        # two signatures names the leaf that changed (a new shape reaching a
        # kernel first) — attached to the compile record
        self._step_signature: Optional[dict] = None
        self._prev_step_signature: Optional[dict] = None
        self._signature_changed = False
        self._last_step_compile_count: Optional[int] = None
        if self.enabled and self.config.track_compiles:
            self.compiles.start()

    # -- configuration -----------------------------------------------------

    def configure_throughput(
        self,
        model_config: Any = None,
        batch_size: Optional[int] = None,
        seq_len: Optional[int] = None,
        flops_per_step: Optional[float] = None,
        tokens_per_step: Optional[int] = None,
        examples_per_step: Optional[int] = None,
        peak_flops_per_device: Optional[float] = None,
    ) -> None:
        """Teach the hub what one step computes so flush can derive
        tokens/sec, examples/sec, and MFU. Either pass a zoo
        ``TransformerConfig`` (+ batch/seq) for the built-in FLOPs estimator,
        or raw ``flops_per_step``/``tokens_per_step`` for custom models.
        ``batch_size``/``seq_len`` are GLOBAL (whole-job) sizes."""
        if model_config is not None and batch_size is not None and seq_len is not None:
            from ..models.config import train_flops_per_step

            flops_per_step = train_flops_per_step(model_config, batch_size, seq_len)
            tokens_per_step = tokens_per_step or batch_size * seq_len
            examples_per_step = examples_per_step or batch_size
        if flops_per_step is not None:
            self._throughput["flops_per_step"] = float(flops_per_step)
        if tokens_per_step is not None:
            self._throughput["tokens_per_step"] = float(tokens_per_step)
        if examples_per_step is not None:
            self._throughput["examples_per_step"] = float(examples_per_step)
        if peak_flops_per_device is not None:
            self.config.peak_flops_per_device = float(peak_flops_per_device)

    # -- per-step hot path -------------------------------------------------

    @property
    def steps(self) -> int:
        return self.timer.steps

    def step(self, outputs: Any = None) -> None:
        """Record one completed training step. Pass the step's outputs (loss)
        so sampling fences wait on real work instead of a marker op."""
        if not self.enabled:
            return
        if not self._first_step_done:
            self._first_step_done = True
            # startup = process/hub creation → end of first step, minus the
            # compile time monitoring already attributed (the goodput ledger
            # counts compile separately; without the subtraction the first
            # program's compile would be charged twice)
            startup = time.perf_counter() - self._created - self.compiles.compile_seconds
            self.goodput.record("startup", max(startup, 0.0))
        if self.profile_window is not None:
            self.profile_window.on_step(self.timer.steps)
        self.timer.step(outputs)
        if self.timer.steps % self.config.sample_every == 0:
            self.memory.sample()
        if self.config.track_compiles:
            self._observe_compiles()
        if self.config.flush_every and self.timer.steps % self.config.flush_every == 0:
            self.flush(step=self.timer.steps)

    def _on_optimizer_step(self) -> None:
        self.optimizer_steps += 1

    def note_step_signature(self, args: Any) -> None:
        """Record the step's abstract call signature (shapes/dtypes per pytree
        leaf — no device access). ``compiled_step`` calls this per step; the
        cost is one host-side walk of the batch's few leaves. When
        :meth:`step` later observes a compile after the first step, the last
        two distinct signatures are diffed (:func:`explain_recompile`) and
        the leaf that changed is named in the compile record."""
        if not self.enabled:
            return
        signature = signature_of(args)
        if signature != self._step_signature:
            self._prev_step_signature = self._step_signature
            self._step_signature = signature
            self._signature_changed = True

    def _observe_compiles(self) -> None:
        """Steady-state build detection: kernel builds at step 1 are warmup;
        a compile on any later step gets a ``{"kind": "compile"}`` record in
        telemetry.jsonl carrying the signature diff when one was noted."""
        count = self.compiles.compile_count
        last = self._last_step_compile_count
        signature_changed = self._signature_changed
        self._last_step_compile_count = count
        self._signature_changed = False
        if last is None or count <= last or self.timer.steps <= 1:
            return
        payload: dict[str, Any] = {
            "compile_count": count,
            "new_compiles": count - last,
            "compile_seconds": self.compiles.compile_seconds,
        }
        # compile_count is process-wide: only blame the step's arguments when
        # the noted step signature actually changed on THIS step — otherwise
        # the build came from elsewhere (an eval or serving path) and a diff
        # of older signatures would misdirect
        if signature_changed and self._prev_step_signature is not None:
            payload["explain"] = explain_recompile(
                self._prev_step_signature, self._step_signature
            )
        elif self._step_signature is not None:
            payload["note"] = (
                "step signature unchanged at this step — the build came from "
                "another path (eval/serving) reaching a kernel for the first time"
            )
        self.write_record("compile", payload)

    @contextmanager
    def pause(self, category: str):
        """Bracket non-step overhead (checkpoint save, manual eval, ...): the
        elapsed time lands in the goodput ledger under ``category`` and the
        step-timer's in-flight window is discarded so the stall never
        pollutes the step-time distribution."""
        if not self.enabled:
            yield
            return
        try:
            with self.goodput.timer(category):
                yield
        finally:
            # even when the paused work raises: the stall must never leak
            # into the step-time distribution (it is already in the ledger)
            self.timer.discard_window()

    def should_flush(self) -> bool:
        """Whether the canonical loop should flush now. False when step()'s
        auto-flush already emitted this boundary's record — the two patterns
        compose without double-writing (or double-running the collective)."""
        return bool(
            self.enabled
            and self.config.flush_every
            and self.timer.steps % self.config.flush_every == 0
            and self._last_flush_step != self.timer.steps
        )

    # -- derived metrics ---------------------------------------------------

    def _peak_flops(self) -> Optional[float]:
        if self.config.peak_flops_per_device is not None:
            return self.config.peak_flops_per_device
        from .flops import device_peak_flops

        return device_peak_flops(getattr(self.accelerator, "device", None))

    def metrics(self) -> dict:
        """Flat scalar metrics — what aggregates across hosts and feeds the
        trackers. Nested detail (per-device memory, per-event compiles) goes
        in the jsonl record only."""
        out: dict[str, Any] = dict(self.timer.summary())
        mean = self.timer.mean_step_seconds
        if mean and mean > 0:
            steps_per_sec = 1.0 / mean
            tokens = self._throughput.get("tokens_per_step")
            if tokens:
                out["tokens_per_sec"] = tokens * steps_per_sec
            examples = self._throughput.get("examples_per_step")
            if examples:
                out["examples_per_sec"] = examples * steps_per_sec
            flops = self._throughput.get("flops_per_step")
            peak = self._peak_flops()
            if flops and peak:
                from ..state import job_world_size

                # one card a process: the job's cards are its processes
                out["mfu"] = flops * steps_per_sec / (peak * job_world_size())
        compiles = self.compiles.snapshot()
        out["compile_count"] = compiles["compile_count"]
        out["compile_seconds"] = compiles["compile_seconds"]
        out["jit_cache_hits"] = compiles["jit_cache_hits"]
        out["jit_cache_misses"] = compiles["jit_cache_misses"]
        hbm = self.memory.hbm_high_watermark_bytes
        if hbm is not None:
            out["hbm_high_watermark_bytes"] = hbm
        host_peak = self.memory.snapshot().get("host_peak_rss_bytes")
        if host_peak is not None:
            out["host_peak_rss_bytes"] = host_peak
        goodput = self.goodput.snapshot(self.timer.productive_seconds, compiles["compile_seconds"])
        if goodput["goodput"] is not None:
            out["goodput"] = goodput["goodput"]
        out["optimizer_steps"] = self.optimizer_steps
        return out

    # -- flush / sinks -----------------------------------------------------

    def flush(self, step: Optional[int] = None) -> Optional[dict]:
        """Aggregate + emit one telemetry record. COLLECTIVE on multi-host
        jobs (min/max/mean ride a host allgather): call it on every host at
        the same step, like ``save_state``. Returns the record (every host)."""
        if not self.enabled:
            return None
        from ..state import PartialState, job_process_index, job_world_size

        index, count = job_process_index(), job_world_size()
        self._last_flush_step = self.timer.steps
        self.memory.sample()  # fresh watermark at the flush boundary
        metrics = self.metrics()
        compiles = self.compiles.snapshot()
        goodput = self.goodput.snapshot(self.timer.productive_seconds, compiles["compile_seconds"])
        record = {
            "kind": "telemetry",
            "step": self.timer.steps if step is None else step,
            "time": time.time(),
            "process_index": index,
            "num_processes": count,
            "metrics": metrics,
            "compiles": compiles,
            "memory": self.memory.snapshot(),
            "goodput": goodput,
            # alone, the spread is the process's own (no state made for it)
            "aggregate": PartialState().aggregate_metrics(metrics) if count > 1 else _own_spread(metrics),
        }
        if index == 0:
            self._write(record)
            accelerator = self.accelerator
            if accelerator is not None and getattr(accelerator, "trackers", None):
                scalars = {
                    f"telemetry/{k}": v
                    for k, v in metrics.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)
                }
                accelerator.log(scalars, step=record["step"])
        return record

    def write_record(self, kind: str, payload: dict) -> Optional[dict]:
        """Append one non-step record (e.g. ``kind="serving"`` from a
        ``ServingEngine``) to the jsonl sink. Local, NOT a collective —
        payloads here are per-process observations, main process writes."""
        if not self.enabled:
            return None
        from ..state import job_process_index

        index = job_process_index()
        record = {
            "kind": kind,
            "step": self.timer.steps,
            "time": time.time(),
            "process_index": index,
            **payload,
        }
        if index == 0:
            self._write(record)
        return record

    def _sink_path(self) -> str:
        directory = self.config.dir
        if directory is None and self.accelerator is not None:
            project = getattr(self.accelerator, "project_configuration", None)
            directory = getattr(project, "logging_dir", None) or getattr(project, "project_dir", None)
        directory = directory or "."
        os.makedirs(directory, exist_ok=True)
        return os.path.join(directory, "telemetry.jsonl")

    def _write(self, record: dict) -> None:
        from ..tracking import dumps_robust

        line = dumps_robust(record) + "\n"
        with self._write_lock:
            if self._file is None:
                self._file = open(self._sink_path(), "a")
            self._file.write(line)
            self._file.flush()

    def finish(self, flush: bool = True) -> None:
        """Final flush + release hooks. Collective when multi-host (the final
        flush aggregates); idempotent — the second call (e.g. an explicit
        finish() followed by end_training()) is a no-op, so it can never
        append a duplicate record or run an unmatched collective."""
        if not self.enabled or self._finished:
            return
        self._finished = True
        if self.profile_window is not None:
            self.profile_window.close()
        if flush and self.timer.steps:
            self.flush(step=self.timer.steps)
        self.compiles.stop()
        # detach the sink under the lock, then flush/fsync/close OUTSIDE
        # it: fsync can take tens of milliseconds and a tracer retire calling
        # write_record() must never block on a durability barrier
        with self._write_lock:
            file, self._file = self._file, None
        if file is not None:
            try:
                file.flush()
                os.fsync(file.fileno())
            except (OSError, ValueError):
                pass
            finally:
                file.close()

    def to_json(self) -> str:
        from ..tracking import dumps_robust

        return dumps_robust(self.metrics())

    def __repr__(self) -> str:
        return (
            f"Telemetry(enabled={self.enabled}, steps={self.timer.steps}, "
            f"sample_every={self.config.sample_every}, "
            f"compiles={self.compiles.compile_count})"
        )


def _own_spread(metrics: dict) -> dict:
    """``PartialState.aggregate_metrics`` of one process: each numeric
    metric as its own min, max and mean."""
    return {
        k: {"min": float(v), "max": float(v), "mean": float(v)}
        for k, v in metrics.items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    }


def _keystr(path: tuple) -> str:
    return "".join(f"[{key!r}]" for key in path)


def signature_of(tree: Any, path: tuple = ()) -> dict[str, str]:
    """Abstract signature of a tree of call arguments: ``path ->
    "shape/dtype"`` for tensor and array leaves, ``repr`` for the rest. Dicts
    walk in sorted key order, as ``jax.tree_util`` does, with the same
    ``['key']`` paths. Cheap: no device access, no hashing of data."""
    out: dict[str, str] = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            out.update(signature_of(tree[key], path + (key,)))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            out.update(signature_of(item, path + (i,)))
    elif hasattr(tree, "shape") and hasattr(tree, "dtype"):
        dtype = str(tree.dtype).replace("torch.", "")
        out[_keystr(path)] = f"{tuple(tree.shape)}/{dtype}"
    else:
        out[_keystr(path)] = f"static:{tree!r}"[:120]
    return out


def explain_recompile(before: Optional[dict], after: Optional[dict]) -> dict:
    """Diff two abstract signatures and name the leaves that changed:
    ``{changed, added, removed, summary}``, ``changed`` mapping paths to
    ``(old, new)``."""
    before = before or {}
    after = after or {}
    changed = {k: (before[k], after[k]) for k in before if k in after and before[k] != after[k]}
    added = {k: after[k] for k in after if k not in before}
    removed = {k: before[k] for k in before if k not in after}
    if not (changed or added or removed):
        summary = "identical abstract signatures — the build came from a new path, not the arguments"
    else:
        parts = [f"{k}: {a} -> {b}" for k, (a, b) in list(changed.items())[:4]]
        parts += [f"+{k}: {added[k]}" for k in list(added)[:2]]
        parts += [f"-{k}: {removed[k]}" for k in list(removed)[:2]]
        summary = "; ".join(parts)
    return {"changed": changed, "added": added, "removed": removed, "summary": summary}
