"""Mixture-of-experts MLP: top-k routing with GShard/Switch dense dispatch.

Counterpart of ``accelerate_tpu/models/moe.py``. Routing runs in fp32; each
token takes its top-k experts, with the gates renormalised over them; every
expert holds ``capacity`` slots (the Switch formula), filled choice-major
then in token order, so choice 0 of every token beats choice 1 of any
token, and a (token, choice) past its expert's capacity is dropped (its
combine weight is 0). Dispatch and combine are dense one-hot products, as
the reference computes them: the ``[T, k, E, C]`` one-hot grows with the
square of the tokens. The experts are gelu MLPs (the tanh approximation,
``jax.nn.gelu``'s default), and the GShard load-balance loss rides along.

The reference pins the expert dimension to an ``expert`` mesh axis
(``_constrain_expert``); at one process there is nothing to pin, and an
expert axis above 1 comes with ``ParallelismConfig``, which raises naming
ROADMAP item 9(b) (``state.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.runtime import resolve_device
from .attention import dense_init


def capacity(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Per-expert token slots (Switch Transformer capacity formula)."""
    return max(int(math.ceil(top_k * num_tokens / num_experts * capacity_factor)), 1)


def top_k_experts(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest probabilities of each row,
    the lower expert index first among equal values (``lax.top_k``'s order;
    ``torch.topk`` promises none), by a stable descending sort."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def routed_mlp(
    x: torch.Tensor,  # [B, S, H]
    router: torch.Tensor,  # [H, E]
    w_up: torch.Tensor,  # [E, H, F]
    w_down: torch.Tensor,  # [E, F, H]
    top_k: int = 2,
    capacity_factor: float = 1.25,
    aux_loss_weight: float = 0.01,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense-dispatch expert MLP shared by :class:`MoEBlock` and the
    llama MoE layers. Returns ``(y [B, S, H] in x's dtype, aux fp32 scalar)``."""
    b, s, h = x.shape
    e = router.shape[-1]
    k = top_k
    if k > e:
        raise ValueError(f"top_k={k} > num_experts={e}")
    t = b * s
    c = capacity(t, e, k, capacity_factor)
    tokens = x.reshape(t, h)

    # routing stays fp32: near-tied logits in bf16 flip top-k selections
    router_logits = tokens.float() @ router.float()  # [T, E]
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, expert_idx = top_k_experts(probs, k)  # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # each (token, choice)'s position in its expert's queue: one-hot cumsums,
    # choice-major so choice 0 of every token comes before choice 1 of any
    onehot = F.one_hot(expert_idx, e).float()  # [T, k, E]
    flat_choice = onehot.transpose(0, 1).reshape(k * t, e)  # [k*T, E]
    position = (torch.cumsum(flat_choice, dim=0) - 1.0) * flat_choice
    within_cap = (position < c) & (flat_choice > 0)
    position = position.reshape(k, t, e).transpose(0, 1)  # [T, k, E]
    within_cap = within_cap.reshape(k, t, e).transpose(0, 1)

    # jax.nn.one_hot of a position past the capacity is all zeros
    slots = torch.arange(c, device=x.device, dtype=torch.float32)
    cap_onehot = (position[..., None] == slots).float() * within_cap[..., None]  # [T, k, E, C]
    dispatch = (onehot[..., None] * cap_onehot).sum(dim=1)  # [T, E, C]
    combine = (gate_vals[..., None, None] * onehot[..., None] * cap_onehot).sum(dim=1)

    expert_in = torch.einsum("tec,th->ech", dispatch.to(x.dtype), tokens)
    h1 = F.gelu(torch.einsum("ech,ehf->ecf", expert_in, w_up.to(x.dtype)), approximate="tanh")
    expert_out = torch.einsum("ecf,efh->ech", h1, w_down.to(x.dtype))
    y = torch.einsum("tec,ech->th", combine.to(x.dtype), expert_out).reshape(b, s, h)

    # load-balance loss (GShard eq. 4): E * sum_e mean_prob_e * first-choice share_e
    dispatch_frac = onehot[:, 0].sum(0) / t
    mean_prob = probs.mean(0)
    aux = aux_loss_weight * e * torch.sum(dispatch_frac * mean_prob)
    return y, aux


class MoEBlock(nn.Module):
    """Top-k-routed expert MLP ``[B, S, H] -> [B, S, H]`` (+ aux loss), usable
    on its own or as the MLP of a layer. Parameters keep the JAX layout:
    ``router [H, E]``, ``w_up [E, H, F]``, ``w_down [E, F, H]``. ``apply``
    and ``param_tree`` follow the model-zoo protocol, so
    ``Accelerator.prepare_model`` takes it directly."""

    def __init__(
        self,
        hidden_size: int,
        intermediate_size: int,
        num_experts: int,
        top_k: int = 2,
        capacity_factor: float = 1.25,
        aux_loss_weight: float = 0.01,
        device=None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        if top_k > num_experts:
            raise ValueError(f"top_k={top_k} > num_experts={num_experts}")
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        device = resolve_device(device)
        h, f, e = hidden_size, intermediate_size, num_experts

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)

        self.router = param(h, e)
        self.w_up = param(e, h, f)
        self.w_down = param(e, f, h)
        self.init(seed)

    @torch.no_grad()
    def init(self, seed: int) -> "MoEBlock":
        """Draw the weights from ``seed`` in the JAX order: router, up, down."""
        h, f, e = self.hidden_size, self.intermediate_size, self.num_experts
        dev = self.router.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.router.copy_(dense_init(gen, (h, e), h, dev))
        self.w_up.copy_(dense_init(gen, (e, h, f), h, dev))
        self.w_down.copy_(dense_init(gen, (e, f, h), f, dev))
        return self

    def capacity(self, num_tokens: int) -> int:
        return capacity(num_tokens, self.num_experts, self.top_k, self.capacity_factor)

    def param_tree(self) -> dict:
        return {"router": self.router, "w_up": self.w_up, "w_down": self.w_down}

    def apply(self, params: dict, x: torch.Tensor, return_aux: bool = False):
        """``y``, or ``(y, aux_loss)`` with ``return_aux`` (shadows
        ``nn.Module.apply``, as the model zoo's ``apply`` does)."""
        y, aux = routed_mlp(
            x, params["router"], params["w_up"], params["w_down"],
            top_k=self.top_k, capacity_factor=self.capacity_factor,
            aux_loss_weight=self.aux_loss_weight,
        )
        return (y, aux) if return_aux else y

    def forward(self, x: torch.Tensor, return_aux: bool = False):
        return self.apply(self.param_tree(), x, return_aux)

