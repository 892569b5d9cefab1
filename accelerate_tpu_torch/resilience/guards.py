"""Numerical guards: device-side all-finite checks inside the train step.

Counterpart of ``accelerate_tpu/resilience/guards.py``. A NaN/Inf blowup
between checkpoints poisons the params within one step, and every later
checkpoint with them. The guard closes that hole without a host read per
step: the verdict is two scalar ``isfinite`` ops on the card, on the loss
and on the gradients' global norm (which a clip computes anyway), and it
reaches the update as a device flag:

- **skip-and-log**: a non-finite step applies no update. The fused adamw
  kernel takes the flag (``ops/fused_adamw.py``, a compile-time variant of
  the kernel that exits before it writes when the flag is set: params,
  moments and the step count stay bit-equal); any other transform's update
  is undone by ``torch.where`` over params and state, which reads the state
  a second time (``optimizer.scaled_optimizer_update``). The fp16 scaler
  keeps its own host read, and backs its scale off on a guard skip as on
  an overflow;
- **escalating grad-clip**: for ``escalate_steps`` after a bad step the
  global-norm clip tightens to ``escalate_clip``, its threshold chosen on
  the card from the escalation counter (:func:`clip_limit`);
- **last-known-good restore**: every clean check refreshes a snapshot of
  (params, optimizer state) on the card, made only when ``restore_after``
  is set; ``restore_after`` consecutive bad steps at a check boundary copy
  both back.

The verdict and the policy's counters live on the card (three int32
scalars, :func:`zero_guard_state`), and the host reads them only every
``check_every`` steps, by default the telemetry's sampling cadence. That
read waits for the step's work, so it is also that boundary's fence: the
guard tells the step timer (``StepTimer.note_fence``), which then does not
synchronize again. The guard thus adds no synchronizing call beyond the
fence cadence.

Skipped-step and restore time feed the goodput ledger (``guard_skipped``,
``guard_restore``), and every action writes a ``{"kind": "resilience"}``
record through the telemetry hub.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..logging import get_logger
from ..utils.params import state_leaves, state_unflatten, tree_map

logger = get_logger(__name__)

STATE_KEYS = ("skipped", "consecutive", "escalate")


@dataclass
class GuardPolicy:
    """What the guard does about a non-finite step."""

    skip_nonfinite: bool = True      # apply no update on a bad step
    escalate_clip: Optional[float] = None  # tighter global-norm clip after a bad step
    escalate_steps: int = 8          # how many steps the escalation persists
    restore_after: int = 3           # K consecutive bad steps → restore last-known-good
    snapshot_every: int = 1          # refresh the LKG snapshot every N clean checks (0 = never refresh)
    check_every: Optional[int] = None  # host-check cadence (None = telemetry sample_every)


def zero_guard_state(device=None) -> dict:
    """The device-side guard state the step carries: three int32 scalars."""
    return {key: torch.zeros((), dtype=torch.int32, device=device) for key in STATE_KEYS}


def next_guard_state(gstate: dict, finite: torch.Tensor, escalate_steps: int) -> dict:
    """The state's transition on the card, from the step's verdict."""
    bad = ~finite
    return {
        "skipped": gstate["skipped"] + bad.to(torch.int32),
        "consecutive": torch.where(bad, gstate["consecutive"] + 1, 0).to(torch.int32),
        "escalate": torch.where(bad, escalate_steps, torch.clamp(gstate["escalate"] - 1, min=0)).to(torch.int32),
    }


def tree_all_finite(tree: Any) -> torch.Tensor:
    """A device bool scalar: every floating leaf of ``tree`` (nested dicts,
    tuples, lists) is finite. For manual loops that want the verdict
    without the guarded step."""
    leaves = [torch.isfinite(x).all() for x in state_leaves(tree)
              if isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex())]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(leaves).all()


def step_verdict(loss: torch.Tensor, gnorm: torch.Tensor) -> torch.Tensor:
    """The step is finite: its loss and its gradients' global norm (a NaN
    or Inf in any gradient makes the norm non-finite)."""
    return torch.isfinite(loss) & torch.isfinite(gnorm)


def clip_limit(policy: Optional[GuardPolicy], gstate: Optional[dict], clip_grad_norm: Optional[float]):
    """The global-norm clip threshold of this step: ``clip_grad_norm``, or
    while the escalation counter runs the tighter ``escalate_clip`` (a
    device scalar chosen by ``torch.where``, so no host read). None when
    the step clips nothing."""
    escalating = policy is not None and policy.escalate_clip is not None
    if clip_grad_norm is None and not escalating:
        return None
    base = float(clip_grad_norm) if clip_grad_norm is not None else float("inf")
    if not escalating:
        return base
    tight = min(float(policy.escalate_clip), base)
    return torch.where(gstate["escalate"] > 0, tight, base).to(torch.float32)


def poison(loss: torch.Tensor, grads: dict, target: Optional[str]):
    """The chaos plan's NaN for this step (``FaultPlan.corrupt_target``):
    the loss or every gradient times NaN, where a real blowup would land,
    before the guard's verdict; as they are when ``target`` is None."""
    if target is None:
        return loss, grads
    if target == "loss":
        return loss * float("nan"), grads
    return loss, tree_map(lambda g: g * float("nan"), grads)


def guarded_update(guard: Optional["NumericalGuard"], loss: torch.Tensor, grads: dict, gnorm: torch.Tensor,
                   clip_grad_norm: Optional[float], update) -> None:
    """The guard's ladder between the gradients and the update, all on the
    card: the clip (escalated while the guard's counter runs), the verdict
    from the loss and the global norm, ``update(grads, skip)`` with the skip
    flag (None when the guard does not skip), and the guard state's
    transition. Shared by ``Accelerator.compiled_step`` and the ZeRO step
    (``parallel/zero.py``), which pass the global loss and norm, so every
    process takes the same verdict."""
    from ..optimizer import clip_grads

    policy = guard.policy if guard is not None else None
    limit = clip_limit(policy, guard.state if guard is not None else None, clip_grad_norm)
    if limit is not None:
        grads = clip_grads(grads, gnorm, limit)
    finite = step_verdict(loss, gnorm) if guard is not None else None
    update(grads, ~finite if guard is not None and policy.skip_nonfinite else None)
    if guard is not None:
        guard.state = next_guard_state(guard.state, finite, policy.escalate_steps)


def _copy_tree(tree: Any) -> Any:
    """Fresh copies of a tree's tensors, where each lies (a snapshot must
    survive the in-place updates of the live masters and moments)."""
    if isinstance(tree, dict):
        return tree_map(lambda x: x.detach().clone(), tree)
    return state_unflatten(tree, [x.detach().clone() for x in state_leaves(tree)])


@torch.no_grad()
def _copy_into(live: Any, saved: Any) -> None:
    for dst, src in zip(state_leaves(live), state_leaves(saved)):
        dst.copy_(src)


class NumericalGuard:
    """Host-side companion of the device check: owns the device state, the
    last-known-good snapshot, and the check-cadence decisions. Made by the
    resilience hub; driven by ``Accelerator.compiled_step``."""

    def __init__(self, policy: Optional[GuardPolicy] = None, telemetry: Any = None):
        self.policy = policy or GuardPolicy()
        self.telemetry = telemetry
        self.check_every = self.policy.check_every or 16
        self.state: Optional[dict] = None  # device int32 scalars
        self.steps = 0
        self.skipped_steps = 0
        self.restores = 0
        self._seen_skipped = 0
        self._clean_checks = 0
        self._snapshot = None  # (params, opt_state) copies on their devices
        self._bound: Optional[tuple] = None  # (model, optimizer) of the guarded step

    # -- lifecycle ----------------------------------------------------------

    def arm(self, model: Any, optimizer: Any) -> None:
        """The device state and, with ``restore_after``, the first snapshot
        (before the first guarded step)."""
        self.state = zero_guard_state(optimizer.device)
        self._bound = (model, optimizer)
        if self.policy.restore_after:
            self._snapshot = (_copy_tree(model.params), _copy_tree(optimizer.opt_state))

    # -- per-step (hot path: two integer ops off the check cadence) ---------

    def after_step(self, model: Any, optimizer: Any) -> None:
        self.steps += 1
        if self.steps % self.check_every:
            return
        self.check(model, optimizer)

    # -- the check, on its cadence --------------------------------------------

    def check(self, model: Any, optimizer: Any) -> dict:
        """Read the device state (the only host read, on the check cadence;
        it is the step timer's fence at this step) and act on it: log and
        ledger skipped steps, restore or refresh the snapshot."""
        values = torch.stack([self.state[key] for key in STATE_KEYS]).tolist()
        if self.telemetry is not None:
            self.telemetry.timer.note_fence()
        snap = dict(zip(STATE_KEYS, values))
        new_skipped = snap["skipped"] - self._seen_skipped
        if new_skipped > 0:
            self._seen_skipped = snap["skipped"]
            self.skipped_steps += new_skipped
            if self.telemetry is not None:
                mean = self.telemetry.timer.mean_step_seconds
                # skipped steps burned a step's wall time without advancing training
                self.telemetry.goodput.record("guard_skipped", new_skipped * (mean or 0.0))
            logger.warning(
                f"numerical guard skipped {new_skipped} non-finite step(s) "
                f"(total {snap['skipped']}, consecutive {snap['consecutive']})"
            )
            self._emit({
                "event": "guard_skip",
                "count": new_skipped,
                "skipped_total": snap["skipped"],
                "consecutive": snap["consecutive"],
            })
        if (
            self.policy.restore_after
            and snap["consecutive"] >= self.policy.restore_after
            and self._snapshot is not None
        ):
            self._restore(model, optimizer, snap["consecutive"])
        elif snap["consecutive"] == 0 and self._snapshot is not None:
            self._clean_checks += 1
            if self.policy.snapshot_every and self._clean_checks % self.policy.snapshot_every == 0:
                # rolling refresh: copies on the card, queued behind the step
                _copy_into(self._snapshot[0], model.params)
                _copy_into(self._snapshot[1], optimizer.opt_state)
        return snap

    def _restore(self, model: Any, optimizer: Any, consecutive: int) -> None:
        pause = self.telemetry.pause("guard_restore") if self.telemetry is not None else nullcontext()
        with pause:
            params, opt_state = self._snapshot
            # in place: the masters and the moments are the live tensors the
            # model, the optimizer and the kernels hold
            _copy_into(model.params, params)
            _copy_into(optimizer.opt_state, opt_state)
        # keep the skipped total, clear the bad streak and the escalation
        self.state = zero_guard_state(optimizer.device)
        self.state["skipped"].fill_(self._seen_skipped)
        self.restores += 1
        logger.error(
            f"numerical guard restored last-known-good params/opt_state after "
            f"{consecutive} consecutive non-finite steps"
        )
        self._emit({"event": "guard_restore", "consecutive": consecutive})

    def _emit(self, payload: dict) -> None:
        if self.telemetry is not None:
            self.telemetry.write_record("resilience", payload)

    def summary(self) -> dict:
        return {
            "guard_steps": self.steps,
            "guard_skipped_steps": self.skipped_steps,
            "guard_restores": self.restores,
        }
