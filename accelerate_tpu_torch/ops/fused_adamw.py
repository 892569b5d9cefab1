"""Fused adamw: the whole moment / bias-correction / decay / apply update of
one parameter in one pass, in place.

Replaces the Pallas TPU kernel ``_adamw_kernel`` of
``accelerate_tpu/ops/fused_adamw.py`` with the CUDA kernel in
``csrc/fused_adamw.cu``. Per leaf the kernel reads p, mu, nu and g once and
writes p, mu and nu once, in place (the JAX kernel aliases its outputs to
its inputs): 28 bytes an element in fp32, so at llama-125m's 134.1M
parameters the bound is 1.121 ms at 3.35 TB/s, over 12 launches (one per
leaf). It replays optax's elementwise order with rounded multiplies and
adds that cannot contract into FMAs, IEEE division and square root, so on
the card it equals its plain version bit for bit.

:func:`fused_adamw` is the drop-in for the port's ``adamw`` (optax's
formula, not ``torch.optim.AdamW``: weight decay 1e-4 by default, added to
the update before the learning rate multiplies it). Its state mirrors
optax's ``(ScaleByAdamState(count int32, mu, nu), EmptyState(),
EmptyState())``; ``update`` is the plain transform's; ``fused_apply`` is
the one-pass update the shared seam ``optimizer.scaled_optimizer_update``
prefers. A CPU tensor takes :func:`adamw_leaf_reference`, a CUDA tensor
launches the kernel or raises.

:func:`adamw` also takes a schedule, ``learning_rate(count) -> lr``, as
``optax.adamw(schedule)`` does: its state is then optax's
``(ScaleByAdamState, EmptyState(), ScaleByScheduleState(count))`` and a
step scales by ``-learning_rate(count)`` before the count goes up. The
schedule is called on the int32 count tensor on the params' device (optax
calls it on a traced int32 array), so a schedule written with arithmetic
operators needs no host sync. :func:`fused_adamw` keeps a scalar learning
rate and raises on a schedule, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Union

import torch

from ..utils.params import tree_leaves, tree_map
from .runtime import load_kernel

KERNEL_SOURCE = "fused_adamw"
INT32_MAX = 2**31 - 1


class AdamWHyperparams(NamedTuple):
    """Scalar hyperparameters; :func:`adamw`'s learning rate may be a schedule."""

    learning_rate: Union[float, Callable]
    b1: float
    b2: float
    eps: float
    eps_root: float
    weight_decay: float


class ScaleByAdamState(NamedTuple):
    """optax's adam state: an int32 step count and fp32 moments like params."""

    count: torch.Tensor
    mu: dict
    nu: dict


class EmptyState(NamedTuple):
    """optax's state of a stateless transform (decay, learning rate)."""


class ScaleByScheduleState(NamedTuple):
    """optax's state of a scheduled learning rate: the int32 count the
    schedule is called on."""

    count: torch.Tensor


def safe_int32_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, saturating at the int32 maximum as optax's does."""
    return torch.where(count < INT32_MAX, count + 1, count)


def bias_corrections(hp: AdamWHyperparams, count: torch.Tensor) -> torch.Tensor:
    """``[1 - b1^count, 1 - b2^count]`` fp32 on count's device, rounded as
    optax computes them under XLA: the power of the fp32 beta to the step
    count, correctly rounded to fp32 (taken here in fp64), then 1 minus it
    in fp32."""
    betas = torch.tensor([hp.b1, hp.b2], dtype=torch.float32, device=count.device)
    powers = (betas.double() ** count.double()).float()
    return torch.ones((), dtype=torch.float32, device=count.device) - powers


def adamw_leaf_reference(p, mu, nu, g, bc, hp: AdamWHyperparams):
    """Plain version of the kernel, op by op in the JAX reference's order
    (``_reference_leaf``): returns ``(p', mu', nu')``. ``bc`` is the fp32
    pair from :func:`bias_corrections`, a tensor on p's device (a divisor
    kept off the host, so the card divides instead of multiplying by a
    reciprocal)."""
    g32 = g.float()
    mu_new = (1.0 - hp.b1) * g32 + hp.b1 * mu.float()
    nu_new = (1.0 - hp.b2) * (g32 * g32) + hp.b2 * nu.float()
    mu_hat = mu_new / bc[0]
    nu_hat = nu_new / bc[1]
    u = mu_hat / (torch.sqrt(nu_hat + hp.eps_root) + hp.eps)
    u = u + hp.weight_decay * p.float()
    p_new = (p.float() + (-hp.learning_rate) * u).to(p.dtype)
    return p_new, mu_new.to(mu.dtype), nu_new.to(nu.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_kernel(KERNEL_SOURCE)
    lib.fused_adamw.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 8 + [
        ctypes.c_void_p
    ]
    lib.fused_adamw.restype = ctypes.c_int
    lib.fused_adamw_error_string.argtypes = [ctypes.c_int]
    lib.fused_adamw_error_string.restype = ctypes.c_char_p
    return lib


@torch.no_grad()
def adamw_leaf(p, mu, nu, g, bc, hp: AdamWHyperparams) -> None:
    """One leaf's update, in place on ``p``, ``mu`` and ``nu``: the kernel
    for CUDA tensors (fp32, contiguous), the plain version on the CPU."""
    if p.device.type == "cpu":
        p_new, mu_new, nu_new = adamw_leaf_reference(p, mu, nu, g, bc, hp)
        p.copy_(p_new)
        mu.copy_(mu_new)
        nu.copy_(nu_new)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused adamw runs on cuda or cpu, not {p.device}")
    for name, x in (("p", p), ("mu", mu), ("nu", nu), ("g", g), ("bc", bc)):
        if x.dtype != torch.float32:
            raise TypeError(f"fused adamw takes float32 {name}, got {x.dtype}")
        if x.device != p.device:
            raise ValueError(f"{name} is on {x.device}, p on {p.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"fused adamw takes contiguous, 16-byte aligned tensors ({name})")
    for name, x in (("mu", mu), ("nu", nu), ("g", g)):
        if x.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, p {tuple(p.shape)}")
    if bc.numel() != 2:
        raise ValueError("bc must hold the two bias corrections")
    lib = _library()
    with torch.cuda.device(p.device):
        code = lib.fused_adamw(
            p.data_ptr(), mu.data_ptr(), nu.data_ptr(), g.data_ptr(), bc.data_ptr(), p.numel(),
            1.0 - hp.b1, hp.b1, 1.0 - hp.b2, hp.b2, hp.eps, hp.eps_root, hp.weight_decay,
            -hp.learning_rate, torch.cuda.current_stream(p.device).cuda_stream,
        )
    if code != 0:
        message = lib.fused_adamw_error_string(code).decode()
        raise RuntimeError(f"fused_adamw launch failed: {message} ({code})")
    adamw_leaf.launches += 1


adamw_leaf.launches = 0


class AdamW:
    """optax's ``adamw`` in PyTorch: ``scale_by_adam``, then
    ``add_decayed_weights``, then ``scale_by_learning_rate``. ``update``
    returns the updates (the generic path applies them with
    ``optimizer.apply_updates``)."""

    def __init__(self, hp: AdamWHyperparams):
        self.hyperparams = hp

    def init(self, params: dict):
        device = tree_leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        count = lambda: torch.zeros((), dtype=torch.int32, device=device)  # noqa: E731
        lr_state = ScaleByScheduleState(count()) if callable(self.hyperparams.learning_rate) else EmptyState()
        return (ScaleByAdamState(count(), tree_map(zeros, params), tree_map(zeros, params)),
                EmptyState(), lr_state)

    def _step_size(self, lr_state):
        """optax's ``scale_by_learning_rate``: ``(-lr, state')``, with a
        schedule ``-schedule(count)`` at the count before its increment."""
        lr = self.hyperparams.learning_rate
        if not callable(lr):
            return -lr, lr_state
        count = lr_state.count
        step = torch.as_tensor(lr(count), dtype=torch.float32, device=count.device)
        return -step, ScaleByScheduleState(safe_int32_increment(count))

    @torch.no_grad()
    def update(self, updates: dict, state, params: dict):
        hp = self.hyperparams
        adam = state[0]
        count = safe_int32_increment(adam.count)
        bc = bias_corrections(hp, count)
        mu = tree_map(lambda g, m: (1.0 - hp.b1) * g + hp.b1 * m, updates, adam.mu)
        nu = tree_map(lambda g, v: (1.0 - hp.b2) * (g * g) + hp.b2 * v, updates, adam.nu)
        u = tree_map(lambda m, v: (m / bc[0]) / (torch.sqrt(v / bc[1] + hp.eps_root) + hp.eps), mu, nu)
        u = tree_map(lambda x, p: x + hp.weight_decay * p, u, params)
        step_size, lr_state = self._step_size(state[2])
        u = tree_map(lambda x: step_size * x, u)
        return u, (ScaleByAdamState(count, mu, nu), state[1], lr_state)


class FusedAdamW(AdamW):
    """:class:`AdamW` whose ``fused_apply`` updates params and state in one
    kernel launch per leaf, in place."""

    @torch.no_grad()
    def fused_apply(self, params: dict, opt_state, grads: dict):
        """``(params, opt_state, grads) -> (params', state')``: params, mu
        and nu are updated in place (the returned trees hold the same
        tensors); the count is a new tensor."""
        hp = self.hyperparams
        adam = opt_state[0]
        count = safe_int32_increment(adam.count)
        bc = bias_corrections(hp, count)
        for p, mu, nu, g in zip(tree_leaves(params), tree_leaves(adam.mu),
                                tree_leaves(adam.nu), tree_leaves(grads)):
            adamw_leaf(p, mu, nu, g, bc, hp)
        return params, (ScaleByAdamState(count, adam.mu, adam.nu),) + tuple(opt_state[1:])


def _hyperparams(learning_rate, b1, b2, eps, eps_root, weight_decay) -> AdamWHyperparams:
    lr = learning_rate if callable(learning_rate) else float(learning_rate)
    return AdamWHyperparams(lr, float(b1), float(b2), float(eps), float(eps_root), float(weight_decay))


def adamw(learning_rate: Union[float, Callable], b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4) -> AdamW:
    """optax's ``adamw`` formula as a transform, the non-fused path. The
    learning rate is a float or a schedule ``count -> lr``."""
    return AdamW(_hyperparams(learning_rate, b1, b2, eps, eps_root, weight_decay))


def fused_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                eps_root: float = 0.0, weight_decay: float = 1e-4) -> FusedAdamW:
    """Drop-in for :func:`adamw` with the fused-kernel update. Scalar
    hyperparameters only: a schedule raises ``ValueError``, as the JAX
    package's ``fused_adamw`` does (a schedule keeps :func:`adamw`)."""
    if callable(learning_rate):
        raise ValueError(
            "fused_adamw takes a scalar learning_rate (a schedule keeps the plain adamw path)"
        )
    return FusedAdamW(_hyperparams(learning_rate, b1, b2, eps, eps_root, weight_decay))
