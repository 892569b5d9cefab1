"""Optimizer wrapper: gradient accumulation, clipping and fp16 loss scaling.

Counterpart of ``accelerate_tpu/optimizer.py``. Gradients are accumulated
into a buffer by ``Accelerator.backward`` (summed; ``step`` divides by the
window); ``step()`` unscales, clips and updates through
:func:`scaled_optimizer_update`, the one state machine the eager path and
``Accelerator.compiled_step`` share, and is a no-op while
``sync_gradients`` is False. Transforms are the port's optax-formula
transforms (``ops.fused_adamw``: ``adamw``, ``fused_adamw``); a transform
with a ``fused_apply`` updates params and state in one kernel pass per leaf.

Where the JAX package donates buffers to a jitted update, the port updates
the fp32 master parameters in place. Offloading the optimizer state to the
host waits for the memory part of the parallel slice (ROADMAP item 9(c)).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .state import AcceleratorState, GradientState
from .utils.dataclasses import LossScaleKwargs
from .utils.params import state_leaves, state_unflatten, tree_leaves, tree_map


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """optax's ``apply_updates``, in place: ``p = p + u`` per leaf."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))
    return params


@torch.no_grad()
def scaled_optimizer_update(tx, params, opt_state, grads, gnorm, scale, growth_tracker, scaler_cfg):
    """The single grads -> update state machine shared by the eager path
    (``AcceleratedOptimizer.step``) and ``Accelerator.compiled_step``.

    ``grads`` must already be unscaled and clipped; ``gnorm`` is their global
    norm. With ``scaler_cfg`` (fp16): skip the update when ``gnorm`` is not
    finite and back the scale off; grow it after ``growth_interval``
    consecutive finite steps. The JAX package branches with ``lax.cond``;
    eager PyTorch reads the finite flag on the host (one sync per fp16 step).
    Without a scaler it is a plain update. A transform with ``fused_apply``
    (``ops.fused_adamw``) updates params and state in one pass per leaf,
    instead of ``tx.update`` + :func:`apply_updates`.

    Returns ``(params, opt_state, scale, growth_tracker, skipped)``.
    """
    fused_apply = getattr(tx, "fused_apply", None)

    def do_update():
        if fused_apply is not None:
            return fused_apply(params, opt_state, grads)
        updates, new_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), new_state

    if scaler_cfg is None:
        params, opt_state = do_update()
        return params, opt_state, scale, growth_tracker, torch.zeros((), dtype=torch.bool)
    finite = torch.isfinite(gnorm)
    if bool(finite):
        params, opt_state = do_update()
    growth_tracker = torch.where(finite, growth_tracker + 1, 0).to(torch.int32)
    grew = growth_tracker >= scaler_cfg.growth_interval
    scale = torch.where(
        finite,
        torch.where(grew, scale * scaler_cfg.growth_factor, scale),
        scale * scaler_cfg.backoff_factor,
    )
    growth_tracker = torch.where(grew, 0, growth_tracker).to(torch.int32)
    return params, opt_state, scale, growth_tracker, ~finite


def global_norm(grads: dict) -> torch.Tensor:
    """optax's ``global_norm``: the square root of every leaf's sum of squares."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in tree_leaves(grads)))


def clip_by_global_norm(grads: dict, clip_norm: Optional[float]):
    """Global-norm clip shared by both update paths; returns ``(grads, gnorm)``."""
    gnorm = global_norm(grads)
    if clip_norm is not None:
        factor = torch.clamp(clip_norm / (gnorm + 1e-6), max=1.0)
        grads = tree_map(lambda g: g * factor, grads)
    return grads, gnorm


def clip_by_value(grads: dict, clip_value: Optional[float]) -> dict:
    """Elementwise clamp to ``[-clip_value, clip_value]``; identity when None."""
    if clip_value is None:
        return grads
    return tree_map(lambda g: torch.clamp(g, -clip_value, clip_value), grads)


class AcceleratedOptimizer:
    """A transform bound to a prepared model's fp32 master parameters."""

    def __init__(
        self,
        tx,
        params: dict,  # the prepared model's master params, in the JAX layout
        scaler: Optional[LossScaleKwargs] = None,
    ):
        self.tx = tx
        self.gradient_state = GradientState()
        self.accelerator_state = AcceleratorState()
        self.scaler = scaler
        self.params = params
        self.opt_state = tx.init(params)
        self._grads = None  # accumulated (summed) grads
        self._accum_count = 0
        self._step_count = 0
        device = tree_leaves(params)[0].device
        self._skipped = torch.zeros((), dtype=torch.bool, device=device)
        if scaler is not None:
            self.scale = torch.tensor(scaler.init_scale, dtype=torch.float32, device=device)
            self.growth_tracker = torch.zeros((), dtype=torch.int32, device=device)
        else:
            self.scale = None
            self.growth_tracker = None
        self._clip_norm: Optional[float] = None
        self._clip_value: Optional[float] = None

    # -- gradient intake (called by Accelerator.backward) -------------------

    def accumulate_grads(self, grads: dict) -> None:
        if self._grads is None:
            self._grads = grads
        else:
            self._grads = tree_map(torch.add, self._grads, grads)
        self._accum_count += 1

    @property
    def grads(self) -> Optional[dict]:
        """Current accumulated gradient (mean over the window so far), unscaled."""
        if self._grads is None:
            return None
        denom = float(self._accum_count) * (self.scale if self.scale is not None else 1.0)
        return tree_map(lambda g: g.float() / denom, self._grads)

    def set_clip_grad_norm(self, max_norm: Optional[float]) -> None:
        self._clip_norm = max_norm

    def set_clip_grad_value(self, clip_value: Optional[float]) -> None:
        self._clip_value = clip_value

    # -- the update --------------------------------------------------------

    def step(self) -> None:
        if not self.gradient_state.sync_gradients or self._grads is None:
            return
        count = self._accum_count
        if self.scaler is not None:
            denom = float(count) * self.scale
            grads = tree_map(lambda g: g.float() / denom, self._grads)
        elif count != 1:
            grads = tree_map(lambda g: g.float() / float(count), self._grads)
        else:
            grads = tree_map(lambda g: g.float(), self._grads)
        grads = clip_by_value(grads, self._clip_value)
        grads, gnorm = clip_by_global_norm(grads, self._clip_norm)
        self.params, self.opt_state, scale, growth, self._skipped = scaled_optimizer_update(
            self.tx, self.params, self.opt_state, grads, gnorm, self.scale,
            self.growth_tracker, self.scaler,
        )
        if self.scaler is not None:
            self.scale, self.growth_tracker = scale, growth
        self._grads = None
        self._accum_count = 0
        self._step_count += 1

    def zero_grad(self, set_to_none: bool = True) -> None:  # noqa: ARG002 - parity
        if self.gradient_state.sync_gradients:
            self._grads = None
            self._accum_count = 0

    # -- introspection ------------------------------------------------------

    @property
    def step_was_skipped(self) -> bool:
        """Whether the last ``step`` was skipped for non-finite grads."""
        if self.scaler is None:
            return False
        return bool(self._skipped)

    @property
    def step_count(self) -> int:
        return self._step_count

    def state_dict(self) -> dict:
        state: dict[str, Any] = {"opt_state": self.opt_state, "step_count": self._step_count}
        if self.scaler is not None:
            state["scale"] = self.scale
            state["growth_tracker"] = self.growth_tracker
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` whose ``opt_state`` leaves may be
        numpy arrays (a checkpoint's): each leaf goes to the params' device
        in the dtype of the state it replaces, and the fp16 loss scale and
        growth tracker are restored."""
        device = tree_leaves(self.params)[0].device
        current, loaded = state_leaves(self.opt_state), state_leaves(state["opt_state"])
        if len(loaded) != len(current):
            raise ValueError(f"the optimizer state holds {len(current)} leaves, got {len(loaded)}")
        leaves = [
            torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x)).to(
                device=device, dtype=old.dtype, copy=True
            ).contiguous()
            for old, x in zip(current, loaded)
        ]
        self.opt_state = state_unflatten(self.opt_state, leaves)
        self._step_count = int(state.get("step_count", 0))
        if self.scaler is not None and "scale" in state:
            self.scale = torch.tensor(float(state["scale"]), dtype=torch.float32, device=device)
            self.growth_tracker = torch.tensor(int(state["growth_tracker"]), dtype=torch.int32, device=device)
