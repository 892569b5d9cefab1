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
(``_constrain_expert``) and GSPMD moves the slots. The port moves them by
hand (``parallel/tensor_parallel.py``): every process of an expert group
routes the same tokens, takes one share of every expert's slots, sends
each expert's share to the process holding that expert (an
``all_to_all_single``), runs its own experts on every share and sends the
outputs back the same way; the shares' combines are summed over the group.
Inside each expert the ``tensor`` axis splits the hidden dim (``moe_up``
column-parallel, ``moe_down`` row-parallel). Under a sequence axis each
process routes its chunk's tokens, but every slot position, the capacity
and the load-balance term are those of the whole sequence, as in the JAX
package: the processes of the sequence group exchange their routing
choices, and the load-balance term's value is shared among them while
each keeps its whole gradient. Routing and the balance loss stay fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

import torch.distributed as dist

from ..ops.runtime import resolve_device
from ..parallel.tensor_parallel import copy_to, exchange, reduce_from
from ..utils.constants import MESH_AXIS_EXPERT
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


def _sequence_choices(expert_idx: torch.Tensor, b: int, s: int, sequence) -> torch.Tensor:
    """Every process's ``[B*S_l, k]`` choices of a sequence group, as the
    whole sequence's ``[B*S, k]`` in token order (row-major over [B, S])."""
    local = expert_idx.reshape(b, s, -1).contiguous()
    out = torch.empty((sequence.size * b, s, local.shape[-1]), dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local, group=sequence.group)
    return out.view(sequence.size, b, s, -1).transpose(0, 1).reshape(b * sequence.size * s, -1)


def _expert_mlp(expert_in, w_up, w_down, dtype, tensor_parallel) -> torch.Tensor:
    """The gelu experts on their slots ``[E, C, H]``; under the tensor axis
    each process holds a slice of the hidden dim (up column-, down
    row-parallel)."""
    expert_in = copy_to(expert_in, tensor_parallel)
    h1 = F.gelu(torch.einsum("ech,ehf->ecf", expert_in, w_up.to(dtype)), approximate="tanh")
    return reduce_from(torch.einsum("ecf,efh->ech", h1, w_down.to(dtype)), tensor_parallel)


def _experts(tokens, dispatch, combine, w_up, w_down, dtype, tensor_parallel, expert_parallel) -> torch.Tensor:
    """Dispatch, the experts, combine: ``[T, H]``. Under an expert group of
    n processes this one takes slots ``[j*share, (j+1)*share)`` of every
    expert (the capacity padded to a multiple of n), exchanges them so that
    each process holds every share of its own experts, and exchanges the
    outputs back; the shares' combines are summed over the group."""
    if expert_parallel is None:
        expert_in = torch.einsum("tec,th->ech", dispatch.to(dtype), tokens)
        expert_out = _expert_mlp(expert_in, w_up, w_down, dtype, tensor_parallel)
        return torch.einsum("tec,ech->th", combine.to(dtype), expert_out)
    n, j = expert_parallel.size, expert_parallel.rank
    h, local = tokens.shape[-1], w_up.shape[0]
    share = -(-dispatch.shape[-1] // n)
    pad = share * n - dispatch.shape[-1]
    dispatch, combine = F.pad(dispatch, (0, pad)), F.pad(copy_to(combine, expert_parallel), (0, pad))
    mine = slice(j * share, (j + 1) * share)
    expert_in = torch.einsum("tec,th->ech", dispatch[..., mine].to(dtype), copy_to(tokens, expert_parallel))
    expert_in = exchange(expert_in, expert_parallel).view(n, local, share, h).transpose(0, 1)
    expert_out = _expert_mlp(expert_in.reshape(local, n * share, h), w_up, w_down, dtype, tensor_parallel)
    back = expert_out.view(local, n, share, h).transpose(0, 1).contiguous()
    expert_out = exchange(back, expert_parallel).reshape(n * local, share, h)
    return reduce_from(torch.einsum("tec,ech->th", combine[..., mine].to(dtype), expert_out), expert_parallel)


def routed_mlp(
    x: torch.Tensor,  # [B, S, H]
    router: torch.Tensor,  # [H, E]
    w_up: torch.Tensor,  # [E, H, F] (this process's experts and hidden slice under the axes)
    w_down: torch.Tensor,  # [E, F, H]
    top_k: int = 2,
    capacity_factor: float = 1.25,
    aux_loss_weight: float = 0.01,
    tensor_parallel=None,  # parallel.tensor_parallel.TensorParallel: F is split
    expert_parallel=None,  # parallel.tensor_parallel.ExpertParallel: E is split
    sequence=None,  # the ring of a sequence axis (group, size, index): x is a chunk
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense-dispatch expert MLP shared by :class:`MoEBlock` and the
    llama MoE layers. Returns ``(y [B, S, H] in x's dtype, aux fp32 scalar)``.
    Under a sequence axis ``aux`` is this process's share of the whole
    sequence's term (its value divided among the group, its gradient whole),
    so the group's sum is the term."""
    b, s, h = x.shape
    e = router.shape[-1]
    k = top_k
    if k > e:
        raise ValueError(f"top_k={k} > num_experts={e}")
    t = b * s
    tokens = x.reshape(t, h)

    # routing stays fp32: near-tied logits in bf16 flip top-k selections
    router_logits = tokens.float() @ router.float()  # [T, E]
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, expert_idx = top_k_experts(probs, k)  # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # each (token, choice)'s position in its expert's queue: one-hot cumsums,
    # choice-major so choice 0 of every token comes before choice 1 of any
    onehot = F.one_hot(expert_idx, e).float()  # [T, k, E]
    # the queues fill over every token of the sequence: under a sequence
    # axis the group's choices, this chunk's rows taken after
    queue = onehot if sequence is None else F.one_hot(_sequence_choices(expert_idx, b, s, sequence), e).float()
    t_all = queue.shape[0]
    c = capacity(t_all, e, k, capacity_factor)
    flat_choice = queue.transpose(0, 1).reshape(k * t_all, e)  # [k*T, E]
    position = (torch.cumsum(flat_choice, dim=0) - 1.0) * flat_choice
    within_cap = (position < c) & (flat_choice > 0)
    position = position.reshape(k, t_all, e).transpose(0, 1)  # [T, k, E]
    within_cap = within_cap.reshape(k, t_all, e).transpose(0, 1)
    if sequence is not None:
        n, j = sequence.size, sequence.index
        rows = (torch.arange(b, device=x.device)[:, None] * (n * s) + j * s
                + torch.arange(s, device=x.device)[None, :]).reshape(-1)
        position, within_cap = position[rows], within_cap[rows]

    # jax.nn.one_hot of a position past the capacity is all zeros
    slots = torch.arange(c, device=x.device, dtype=torch.float32)
    cap_onehot = (position[..., None] == slots).float() * within_cap[..., None]  # [T, k, E, C]
    dispatch = (onehot[..., None] * cap_onehot).sum(dim=1)  # [T, E, C]
    combine = (gate_vals[..., None, None] * onehot[..., None] * cap_onehot).sum(dim=1)

    y = _experts(tokens, dispatch, combine, w_up, w_down, x.dtype, tensor_parallel, expert_parallel).reshape(b, s, h)

    # load-balance loss (GShard eq. 4): E * sum_e mean_prob_e * first-choice share_e
    dispatch_frac = queue[:, 0].sum(0) / t_all
    if sequence is None:
        mean_prob = probs.mean(0)
    else:
        mean_prob = reduce_from(probs.sum(0), sequence) / t_all
    aux = aux_loss_weight * e * torch.sum(dispatch_frac * mean_prob)
    if sequence is not None:  # the value shared among the group, the gradient whole on each
        aux = aux + aux.detach() * (1.0 / sequence.size - 1.0)
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
        # the expert group (Accelerator.prepare_model sets it under an expert axis)
        self.expert_parallel = None
        self.init(seed)

    @torch.no_grad()
    def partition_rules(self) -> list[tuple[str, tuple]]:
        """The JAX package's layout rules: the experts over ``expert``."""
        return [
            (r"router", (None, None)),
            (r"w_(up|down)", (MESH_AXIS_EXPERT, None, None)),
        ]

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
        from ..parallel.tensor_parallel import split_or_none

        y, aux = routed_mlp(
            x, params["router"], params["w_up"], params["w_down"],
            top_k=self.top_k, capacity_factor=self.capacity_factor,
            aux_loss_weight=self.aux_loss_weight,
            expert_parallel=split_or_none(self.expert_parallel, params["w_up"].shape[0], self.num_experts),
        )
        return (y, aux) if return_aux else y

    def forward(self, x: torch.Tensor, return_aux: bool = False):
        return self.apply(self.param_tree(), x, return_aux)

