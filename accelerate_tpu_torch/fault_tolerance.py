"""Fault-tolerant checkpointing: atomic commits, preemption handling, auto-resume.

Counterpart of ``accelerate_tpu/fault_tolerance.py``, at one process:

1. **The atomic commit** (``checkpointing.save_accelerator_state``): a save
   stages into ``<dir>.tmp``, a ``manifest.json`` records each file's size
   and CRC32 with the step and the loader positions, and only then is the
   staging directory renamed to its final name. Old checkpoints rotate
   after the commit, so a kill at any instant leaves at least one complete,
   verifiable checkpoint; the torn ``.tmp`` directory is collected by the
   next save.
2. **Preemption** (``CheckpointManager``): a SIGTERM or SIGINT handler only
   sets a flag (mid-step state is inconsistent), and ``should_save`` turns
   it into exactly one save at the next step boundary, after which
   ``exit_requested`` is true.
3. **Auto-resume** (``CheckpointManager.resume("auto")``): the newest
   checkpoint whose manifest verifies is loaded, and ``resumed_loader``
   rewinds a loader with ``set_epoch`` and ``skip_first_batches`` so the
   next batch is the one the stopped run would have consumed.

The agreement of several processes on a preemption save, and on the
checkpoint to resume, comes with the parallel slice (ROADMAP item 9(b));
the chaos harness's I/O probe with the resilience slice (item 18); and the
telemetry hub that ``_telemetry_pause`` will report save and restore time
to with item 19.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import time
import zlib
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .logging import get_logger
from .resilience.retry import DEFAULT_IO_RETRY, RetryPolicy
from .state import PartialState
from .utils.constants import CHECKPOINT_DIR_PREFIX, CHECKPOINT_MANIFEST_NAME, CHECKPOINT_TMP_SUFFIX
from .utils.memory import retry_transient_io

logger = get_logger(__name__)

MANIFEST_FORMAT_VERSION = 1

# Test seam: when set, called as ``hook(stage, directory)`` at the points of
# the commit protocol ("staged": every state file written; "manifest": the
# manifest written; both before the rename). A test raises from it to kill
# the save at that instant.
fault_injection_hook: Optional[Callable[[str, str], None]] = None


def _run_fault_hook(stage: str, directory: str) -> None:
    if fault_injection_hook is not None:
        fault_injection_hook(stage, directory)


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------


def _file_crc32(path: str, chunk_bytes: int = 1 << 20) -> str:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return format(crc & 0xFFFFFFFF, "08x")


def build_manifest(directory: str, step: Optional[int] = None, metadata: Optional[dict] = None) -> dict:
    """Every file under ``directory`` with its size and CRC32, and the step
    and topology a resume checks."""
    files: dict[str, dict] = {}
    for root, _, names in os.walk(directory):
        for name in sorted(names):
            if name == CHECKPOINT_MANIFEST_NAME:
                continue
            full = os.path.join(root, name)
            files[os.path.relpath(full, directory)] = {"size": os.path.getsize(full), "crc32": _file_crc32(full)}
    state = PartialState()
    manifest = {
        "format_version": MANIFEST_FORMAT_VERSION,
        "step": step,
        "files": files,
        "topology": {"num_processes": state.num_processes, "num_devices": state.num_devices, "mesh": {}},
        "created": time.time(),
    }
    if metadata:
        manifest["metadata"] = metadata
    return manifest


@retry_transient_io
def write_manifest(directory: str, manifest: dict) -> str:
    """Write ``manifest.json`` durably (fsync'd: the rename that follows must
    never promote a directory whose manifest is still in the page cache)."""
    path = os.path.join(directory, CHECKPOINT_MANIFEST_NAME)
    tmp = path + ".part"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_manifest(directory: str) -> Optional[dict]:
    path = os.path.join(directory, CHECKPOINT_MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verify_checkpoint(directory: str, check_checksums: bool = True) -> list[str]:
    """The problems of a checkpoint directory against its manifest: an empty
    list means it is complete and verifiable."""
    if not os.path.isdir(directory):
        return [f"{directory} is not a directory"]
    if directory.rstrip(os.sep).endswith(CHECKPOINT_TMP_SUFFIX):
        return [f"{directory} is an uncommitted staging dir ({CHECKPOINT_TMP_SUFFIX})"]
    path = os.path.join(directory, CHECKPOINT_MANIFEST_NAME)
    if not os.path.exists(path):
        return [f"missing {CHECKPOINT_MANIFEST_NAME}"]
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable manifest: {e}"]
    files = manifest.get("files")
    if not isinstance(files, dict) or not files:
        return ["manifest lists no files"]
    problems = []
    for rel, meta in files.items():
        full = os.path.join(directory, rel)
        if not os.path.exists(full):
            problems.append(f"missing file {rel}")
            continue
        size = os.path.getsize(full)
        if size != meta.get("size"):
            problems.append(f"size mismatch for {rel}: manifest {meta.get('size')}, on disk {size}")
            continue
        if check_checksums and _file_crc32(full) != meta.get("crc32"):
            problems.append(f"checksum mismatch for {rel}")
    return problems


# ---------------------------------------------------------------------------
# the atomic commit and torn directories
# ---------------------------------------------------------------------------


def staging_dir_for(final_dir: str) -> str:
    return final_dir.rstrip(os.sep) + CHECKPOINT_TMP_SUFFIX


@retry_transient_io
def commit_checkpoint(staging_dir: str, final_dir: str) -> str:
    """Promote a complete staging directory to its final name by a rename.
    Saving again into an existing ``final_dir`` first renames the old tree
    to ``<final_dir>.old`` (not the ``.tmp`` suffix the torn-directory
    collection matches, so a kill between the two renames leaves both
    copies to recover), then removes it after the commit."""
    doomed = final_dir.rstrip(os.sep) + ".old"
    if os.path.exists(final_dir):
        if os.path.exists(doomed):
            shutil.rmtree(doomed, ignore_errors=True)
        os.rename(final_dir, doomed)
    os.rename(staging_dir, final_dir)
    shutil.rmtree(doomed, ignore_errors=True)
    return final_dir


def garbage_collect_torn(base: str) -> list[str]:
    """Remove the ``*.tmp`` staging directories under ``base`` that a killed
    save left behind; returns what it removed."""
    removed = []
    if not os.path.isdir(base):
        return removed
    for name in os.listdir(base):
        full = os.path.join(base, name)
        if name.endswith(CHECKPOINT_TMP_SUFFIX) and os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
            removed.append(full)
            logger.info(f"Garbage-collected torn checkpoint staging dir {full}")
    return removed


# ---------------------------------------------------------------------------
# finding checkpoints
# ---------------------------------------------------------------------------


def list_checkpoints(base: str) -> list[str]:
    """The committed ``checkpoint_<n>`` directories under ``base``, oldest first."""
    if not os.path.isdir(base):
        return []
    entries = []
    for name in os.listdir(base):
        match = re.fullmatch(rf"{CHECKPOINT_DIR_PREFIX}_(\d+)", name)
        if match and os.path.isdir(os.path.join(base, name)):
            entries.append((int(match.group(1)), os.path.join(base, name)))
    return [path for _, path in sorted(entries)]


def latest_valid_checkpoint(base: str, check_checksums: bool = True) -> Optional[str]:
    """The newest checkpoint under ``base`` whose manifest verifies; ``.tmp``
    staging directories never match, and a damaged one is skipped with a
    warning."""
    for path in reversed(list_checkpoints(base)):
        problems = verify_checkpoint(path, check_checksums=check_checksums)
        if not problems:
            return path
        logger.warning(
            f"Skipping invalid checkpoint {path}: {'; '.join(problems[:3])}"
            + (f" (+{len(problems) - 3} more)" if len(problems) > 3 else "")
        )
    return None


def checkpoint_step(directory: str, manifest: Optional[dict] = None) -> int:
    """The step a checkpoint was saved at: its manifest's ``metadata.step``,
    else the manifest's ``step``, else 0."""
    if manifest is None:
        manifest = read_manifest(directory) or {}
    meta = manifest.get("metadata", {})
    return int(meta.get("step", manifest.get("step") or 0))


@dataclass
class ResumePoint:
    """What ``CheckpointManager.resume`` restored: the checkpoint and the
    positions that rewind the loaders to their next batch."""

    path: str
    step: int = 0
    epoch: int = 0
    dataloaders: list = field(default_factory=list)  # [{"epoch": e, "position": n}, ...]
    metadata: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


class CheckpointManager:
    """A run's checkpoints: periodic atomic saves, rotation, a save at the
    step boundary after a preemption signal, and auto-resume::

        manager = accelerator.checkpoint_manager("ckpts", save_interval=500)
        resume = manager.resume("auto")           # None on a fresh run
        step = resume.step if resume else 0
        for epoch in range(resume.epoch if resume else 0, num_epochs):
            loader.set_epoch(epoch)
            for batch in manager.resumed_loader(loader, resume, epoch):
                ...                               # one training step
                step += 1
                if manager.should_save(step):
                    manager.save(step, epoch=epoch)
                if manager.exit_requested:        # the preemption save landed
                    return
            resume = None

    The manager installs handlers for ``handle_signals``; restore the
    previous ones with ``restore_signal_handlers()`` or by using the manager
    as a context manager.
    """

    def __init__(
        self,
        accelerator: Any,
        checkpoint_dir: Optional[str] = None,
        save_interval: Optional[int] = None,
        total_limit: Optional[int] = None,
        sharded: bool = False,
        handle_signals: tuple = (signal.SIGTERM, signal.SIGINT),
        check_checksums: bool = True,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self.accelerator = accelerator
        project = accelerator.project_configuration
        if project.automatic_checkpoint_naming:
            raise ValueError(
                "CheckpointManager names checkpoints by training step and "
                "cannot run with ProjectConfiguration(automatic_checkpoint_naming"
                "=True); disable it: the manager handles naming and rotation."
            )
        self.checkpoint_dir = checkpoint_dir or os.path.join(project.project_dir or ".", "checkpoints")
        self.save_interval = save_interval
        self.total_limit = total_limit if total_limit is not None else project.total_limit
        self.sharded = sharded
        self.check_checksums = check_checksums
        self.retry_policy = retry_policy if retry_policy is not None else DEFAULT_IO_RETRY
        self._preempted = False
        self._preempt_signum: Optional[int] = None
        self._saved_on_preemption = False
        self._prev_handlers: dict = {}
        self._swapped_loaders: dict = {}  # id(original loader) -> its skipping stand-in
        if handle_signals:
            self._install_handlers(handle_signals)

    def _telemetry_pause(self, category: str):  # noqa: ARG002 - the hub's seam
        """The bracket around a save or a restore that the telemetry hub will
        count as paused time (ROADMAP item 19); no-op until then."""
        return nullcontext()

    # -- preemption --------------------------------------------------------

    def _install_handlers(self, signals_to_handle) -> None:
        for sig in signals_to_handle:
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                # not the main thread: preemption then needs request_preemption()
                logger.warning(
                    "CheckpointManager could not install signal handlers outside "
                    "the main thread; call request_preemption() manually."
                )
                break

    def _on_signal(self, signum, frame) -> None:  # noqa: ARG002
        # a flag only: the signal can land mid-step; should_save turns it into
        # one save at the next step boundary
        self._preempted = True
        self._preempt_signum = signum

    def request_preemption(self) -> None:
        """What a preemption signal does, for tests and external schedulers."""
        self._preempted = True

    @property
    def preemption_requested(self) -> bool:
        """Whether any process caught a preemption signal."""
        return PartialState().any_process(self._preempted)

    @property
    def exit_requested(self) -> bool:
        """True once the preemption save has landed: the loop should exit."""
        return self._saved_on_preemption

    def restore_signal_handlers(self) -> None:
        for sig, handler in self._prev_handlers.items():
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass
        self._prev_handlers.clear()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc_info) -> None:
        self.restore_signal_handlers()

    # -- save --------------------------------------------------------------

    def should_save(self, step: int) -> bool:
        """True at a periodic boundary, or once when a preemption is pending."""
        if not self._saved_on_preemption and self.preemption_requested:
            return True
        return self.save_interval is not None and step > 0 and step % self.save_interval == 0

    def save_on_preemption(self, step: int, epoch: int = 0, metadata: Optional[dict] = None) -> bool:
        """The one save of a pending preemption; returns whether the loop
        should exit."""
        if self.preemption_requested and not self._saved_on_preemption:
            self.save(step, epoch=epoch, metadata=metadata)
        return self.exit_requested

    def _dataloader_positions(self) -> list[dict]:
        return [
            {"epoch": int(getattr(loader, "epoch", 0)), "position": int(getattr(loader, "position", 0))}
            for loader in getattr(self.accelerator, "_dataloaders", [])
        ]

    def save(self, step: int, epoch: int = 0, metadata: Optional[dict] = None) -> str:
        """One atomic checkpoint ``checkpoint_<step>``: collect torn staging
        directories, stage and commit, then rotate (after the commit, so the
        previous good checkpoint survives a kill during this call). The whole
        call retries transient I/O errors."""
        garbage_collect_torn(self.checkpoint_dir)
        target = os.path.join(self.checkpoint_dir, f"{CHECKPOINT_DIR_PREFIX}_{step}")
        meta = {"step": int(step), "epoch": int(epoch), "dataloaders": self._dataloader_positions()}
        if metadata:
            meta.update(metadata)
        with self._telemetry_pause("checkpoint_save"):
            self.retry_policy.wrap(self.accelerator.save_state)(
                target, sharded=self.sharded, manifest_metadata=meta
            )
        if self.preemption_requested:
            self._saved_on_preemption = True
            logger.info(f"Preemption save committed at step {step} -> {target}; exit when convenient.")
        self._rotate(keep=target)
        return target

    def _rotate(self, keep: str) -> None:
        if self.total_limit is None:
            return
        existing = list_checkpoints(self.checkpoint_dir)
        doomed = [p for p in existing if p != keep]
        for stale in doomed[: max(len(existing) - self.total_limit, 0)]:
            logger.info(f"Rotating out {stale} (total_limit={self.total_limit})")
            shutil.rmtree(stale, ignore_errors=True)

    # -- resume ------------------------------------------------------------

    def latest_valid(self) -> Optional[str]:
        """The newest checkpoint whose manifest verifies."""
        return latest_valid_checkpoint(self.checkpoint_dir, check_checksums=self.check_checksums)

    def resume(self, resume_from_checkpoint: "str | None" = "auto") -> Optional[ResumePoint]:
        """Restore the run: ``"auto"`` loads the newest valid checkpoint (None
        when there is none: a fresh run), a path loads that checkpoint after
        verifying it. Restores model, optimizer, scheduler, RNG and
        registered objects through ``load_state`` and returns the positions
        that rewind the loaders."""
        if resume_from_checkpoint in (None, False):
            return None
        if resume_from_checkpoint == "auto":
            path = self.latest_valid()
            if path is None:
                logger.info(f"No valid checkpoint under {self.checkpoint_dir}; starting fresh.")
                return None
        else:
            path = resume_from_checkpoint
            problems = verify_checkpoint(path, check_checksums=self.check_checksums)
            if problems:
                raise ValueError(f"Refusing to resume from {path}: {'; '.join(problems[:5])}")
        with self._telemetry_pause("checkpoint_restore"):
            self.retry_policy.wrap(self.accelerator.load_state)(path)
        manifest = read_manifest(path) or {}
        meta = manifest.get("metadata", {})
        point = ResumePoint(
            path=path,
            step=checkpoint_step(path, manifest),
            epoch=int(meta.get("epoch", 0)),
            dataloaders=meta.get("dataloaders", []),
            metadata=meta,
        )
        logger.info(f"Resumed from {path} (step {point.step}, epoch {point.epoch})")
        return point

    def resumed_loader(self, loader, resume: Optional[ResumePoint], epoch: int, index: int = 0):
        """The loader to iterate in ``epoch`` after a resume: in the resumed
        epoch, ``loader`` without the batches the stopped run consumed;
        otherwise ``loader`` itself. Call it every epoch: it also keeps the
        positions that saves record pointed at the loader being iterated."""
        loaders = getattr(self.accelerator, "_dataloaders", None)
        # once the resumed epoch is over, saves record the live loader again
        prev = self._swapped_loaders.pop(id(loader), None)
        if prev is not None and loaders is not None and prev in loaders:
            loaders[loaders.index(prev)] = loader
        if resume is None or index >= len(resume.dataloaders):
            return loader
        info = resume.dataloaders[index]
        if int(info.get("epoch", 0)) != epoch:
            return loader
        position = int(info.get("position", 0))
        if position == 0:
            return loader
        from .data_loader import skip_first_batches

        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        skipped = skip_first_batches(loader, position)
        skipped._skip_offset = position
        skipped.epoch = epoch
        if loaders is not None and loader in loaders:
            loaders[loaders.index(loader)] = skipped
            self._swapped_loaders[id(loader)] = skipped
        return skipped
