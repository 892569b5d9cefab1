"""fp8 (e4m3) projection products with per-tensor current scaling.

Counterpart of ``accelerate_tpu/ops/fp8.py``: each operand is scaled by its
own abs-max onto the e4m3 range (less ``margin`` headroom bits), cast to
``float8_e4m3fn``, multiplied with fp32 accumulation, and the product
times ``sx * sw`` is cast to ``x``'s dtype. ``Accelerator.prepare_model``
installs it as the model zoo's ``dot_fn`` under ``mixed_precision="fp8"``.

On CUDA tensors the product is ``torch._scaled_mm`` (cuBLAS's fp8 GEMM,
``out_dtype=float32``, ``use_fast_accum=False``); on CPU tensors its plain
version, the fp32 product of the e4m3 values. The JAX package's product is
XLA's ``dot_general`` outside any Pallas kernel, so a library product is
the port's counterpart, as ``torch.matmul`` is of a plain product.

The gradient is ``jax.grad`` of the JAX function, which differentiates
through the casts and through the abs-max scale, not straight through:

- the cotangent of each e4m3 operand is the fp32 product of the output's
  cotangent (times ``sx * sw``) with the other e4m3 operand, cast to e4m3
  unscaled (the transpose of ``dot_general`` returns its operand's dtype),
  then back to fp32 (the transpose of the cast);
- the operand's gradient is that over its scale, plus the scale's own
  gradient, which ``max(abs(x))`` routes to the elements at the abs-max
  (shared among ties, signed, with ``abs``'s +1 at 0), and which is 0 when
  the abs-max is below the 1e-12 floor (half at the floor itself).

``_scaled_mm`` has no autograd, so the whole product is one
``torch.autograd.Function`` whose backward computes that formula; it keeps
the e4m3 operands (a byte an element), and the output scale's cotangent
comes from the input's product, so the forward product is not run again.
Its two backward products are fp32, as the JAX gradient's on the CPU.

Across processes the JAX scale is the abs-max of the whole tensor, since
GSPMD reduces ``jnp.max`` across the mesh: a split operand's abs-max and
its sums are all-reduced over the processes holding its slices (the
activations' rows over the batch axes, a tensor-parallel slice over the
tensor group), and an operand's cotangent that is partial on each process
is summed before its e4m3 cast, as the JAX transpose casts the whole one:
a column-parallel input's over the tensor group, a weight's over the batch
axes (the first process of the batch group then returns it, the others
zeros, for the update sums every process's gradient).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

E4M3_MAX = 448.0  # largest finite float8_e4m3fn value
E4M3 = torch.float8_e4m3fn
_FLOOR = 1e-12  # the scale's floor: an all-zero operand quantizes to zeros
_MM_ALIGN = 16  # _scaled_mm: every dim a multiple of 16


def _div_max(t: torch.Tensor) -> torch.Tensor:
    """``t / E4M3_MAX`` correctly rounded: CUDA divides by a Python scalar
    through its reciprocal, one ulp off the JAX scale now and then, which
    moves an element at a rounding tie to the other e4m3 neighbour."""
    return t / torch.full_like(t, E4M3_MAX)


def _scale(amax: torch.Tensor, margin: int) -> torch.Tensor:
    return _div_max(torch.clamp(amax, min=_FLOOR) * (2.0**margin))


def quantize_e4m3(x: torch.Tensor, margin: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor scale onto the e4m3 range (less ``margin`` headroom bits):
    ``(quantized, scale)``, the scale an fp32 scalar."""
    x = x.float()
    scale = _scale(torch.max(torch.abs(x)), margin)
    return (x / scale).to(E4M3), scale


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def _global_amax(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(torch.max(torch.abs(x)).reshape(1), group, dist.ReduceOp.MAX)[0]


def fp8_matmul(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """The fp32 product of e4m3 ``qx`` ``[M, K]`` and ``qw`` ``[K, N]``: on a
    card ``torch._scaled_mm`` (row-major A, column-major B, unit scales),
    on the CPU the product of their fp32 values."""
    if qx.device.type != "cuda":
        return qx.float() @ qw.float()
    m, k = qx.shape
    n = qw.shape[1]
    if m % _MM_ALIGN or k % _MM_ALIGN or n % _MM_ALIGN:
        raise ValueError(
            f"fp8 product [{m}, {k}] x [{k}, {n}]: torch._scaled_mm needs every dim a multiple of {_MM_ALIGN}"
        )
    one = torch.ones((), dtype=torch.float32, device=qx.device)
    b = qw.t().contiguous().t()  # column-major
    return torch._scaled_mm(qx.contiguous(), b, scale_a=one, scale_b=one, out_dtype=torch.float32,
                            use_fast_accum=False)


def _scale_grad(ct_scale, amax, count, margin: int) -> torch.Tensor:
    """The cotangent of one element at the abs-max: the scale's cotangent
    through the division by ``E4M3_MAX``, the margin, the floor's max
    (1 above the floor, 0 below, half at it) and ``reduce_max`` (shared
    among the ``count`` elements at the abs-max)."""
    floored = torch.clamp(amax, min=_FLOOR)
    gate = (amax == floored).float() / torch.where(floored == _FLOOR, 2.0, 1.0)
    return (_div_max(ct_scale) * (2.0**margin)) * gate / count


def _operand_grad(ct_q, scale, x, amax, count, ct_scale, margin: int) -> torch.Tensor:
    """``d/dx`` of ``quantize_e4m3``'s operand: ``ct_q / scale`` plus the
    scale's gradient at the elements at the abs-max, signed (+1 at 0)."""
    at_max = (torch.abs(x) == amax).float()
    spread = _scale_grad(ct_scale, amax, count, margin) * at_max
    return ct_q / scale + torch.where(x >= 0, spread, -spread)


class Fp8Groups(NamedTuple):
    """The groups one product's reductions run over (None: this process
    alone): ``x``/``w`` the processes holding slices of that operand (its
    abs-max, its ties, its scale's sum), ``out`` those holding parts of the
    output, ``dx``/``dw`` those whose cotangent of a whole operand is
    partial, summed before its e4m3 cast. ``keep_dw``: this process
    returns ``w``'s gradient; the other processes of a ``dw`` sum over the
    batch axes return zeros, since the update sums every process's."""

    x: object = None
    w: object = None
    out: object = None
    dx: object = None
    dw: object = None
    keep_dw: bool = True


class Fp8Rows(NamedTuple):
    """The batch axes' group, over which activation rows are split: its
    group, the group over it and the tensor axis (None without one), and
    whether this process is the group's first."""

    group: object
    with_tensor: object
    first: bool


class _Fp8Dot(torch.autograd.Function):
    """``fp8_dot`` on ``x`` ``[..., K]`` and ``w`` ``[K, N]`` under the
    groups of :class:`Fp8Groups`."""

    @staticmethod
    def forward(ctx, x, w, margin, groups):
        x32, w32 = x.float(), w.float()
        amax_x, amax_w = _global_amax(x32, groups.x), _global_amax(w32, groups.w)
        sx, sw = _scale(amax_x, margin), _scale(amax_w, margin)
        qx = (x32 / sx).to(E4M3).reshape(-1, x.shape[-1])
        qw = (w32 / sw).to(E4M3)
        dot = fp8_matmul(qx, qw)
        ctx.save_for_backward(x, w, qx, qw, amax_x, amax_w)
        ctx.args = (margin, groups)
        return (dot * (sx * sw)).reshape(*x.shape[:-1], w.shape[1]).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        x, w, qx, qw, amax_x, amax_w = ctx.saved_tensors
        margin, groups = ctx.args
        x32, w32 = x.float(), w.float()
        sx, sw = _scale(amax_x, margin), _scale(amax_w, margin)
        ct_dot = ct.float().reshape(-1, w.shape[1]) * (sx * sw)
        qx32, qw32 = qx.float(), qw.float()
        ct_qw = _all_reduce(qx32.t() @ ct_dot, groups.dw).to(E4M3).float()
        local_qx = ct_dot @ qw32.t()
        # the cotangent of the output's scaling sx * sw: sum(dot * ct), which is
        # sum(qx * (ct_dot @ qw.T)) / (sx * sw), read off this process's part
        ct_bo = _all_reduce((torch.sum(qx32 * local_qx) / (sx * sw)).reshape(1), groups.out)[0]
        ct_qx = _all_reduce(local_qx, groups.dx).to(E4M3).float().reshape(x.shape)
        # the scales' cotangents: through the output's scaling and the divisions
        sum_x = _all_reduce(torch.sum(ct_qx * (1.0 / (sx * sx)) * x32).reshape(1), groups.x)[0]
        sum_w = _all_reduce(torch.sum(ct_qw * (1.0 / (sw * sw)) * w32).reshape(1), groups.w)[0]
        ct_sx = ct_bo * sw - sum_x
        ct_sw = sx * ct_bo - sum_w
        count_x = _all_reduce((torch.abs(x32) == amax_x).float().sum().reshape(1), groups.x)[0]
        count_w = _all_reduce((torch.abs(w32) == amax_w).float().sum().reshape(1), groups.w)[0]
        gx = _operand_grad(ct_qx, sx, x32, amax_x, count_x, ct_sx, margin)
        gw = _operand_grad(ct_qw, sw, w32, amax_w, count_w, ct_sw, margin)
        if not groups.keep_dw:
            gw = torch.zeros_like(gw)
        return gx.to(x.dtype), gw.to(w.dtype), None, None


def make_fp8_dot(margin: int = 0, rows: Optional[Fp8Rows] = None):
    """The fp8 projection product with ``margin`` headroom bits in the scale
    (``FP8RecipeKwargs.margin``): ``dot(x, w)``, ``x`` ``[..., K]``, ``w``
    ``[K, N]``, the output in ``x``'s dtype. ``rows``: the activation rows
    are split over the batch axes, whose processes the scales and
    cotangents of the whole batch span. ``dot.tensor_parallel(x, w, group,
    x_split, w_split, reduce_dx, reduce_dw)`` is the same product on one
    process's operands under the tensor ``group``: ``x_split``/``w_split``,
    the operand is this process's slice; ``reduce_dx``/``reduce_dw``, it is
    whole on every process and its use here partial (a column-parallel
    input; GQA's shared kv columns)."""
    plain = Fp8Groups() if rows is None else Fp8Groups(
        x=rows.group, out=rows.group, dw=rows.group, keep_dw=rows.first)

    def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _Fp8Dot.apply(x, w, margin, plain)

    def tensor_parallel(x, w, group, x_split: bool, w_split: bool, reduce_dx: bool,
                        reduce_dw: bool) -> torch.Tensor:
        if rows is None:
            groups = Fp8Groups(x=group if x_split else None, w=group if w_split else None, out=group,
                               dx=group if reduce_dx else None, dw=group if reduce_dw else None)
        else:
            both = rows.with_tensor
            groups = Fp8Groups(x=both if x_split else rows.group, w=group if w_split else None, out=both,
                               dx=group if reduce_dx else None, dw=both if reduce_dw else rows.group,
                               keep_dw=rows.first)
        return _Fp8Dot.apply(x, w, margin, groups)

    dot.margin = margin
    dot.tensor_parallel = tensor_parallel
    return dot


def fp8_dot_reference(x: torch.Tensor, w: torch.Tensor, margin: int = 0) -> torch.Tensor:
    """The plain fp8 product (no autograd function): quantize both operands,
    the fp32 product of the e4m3 values, times ``sx * sw``, in ``x``'s dtype."""
    qx, sx = quantize_e4m3(x, margin)
    qw, sw = quantize_e4m3(w, margin)
    dot = qx.float().reshape(-1, x.shape[-1]) @ qw.float()
    return (dot * (sx * sw)).reshape(*x.shape[:-1], w.shape[1]).to(x.dtype)


# the default recipe: no margin
fp8_dot = make_fp8_dot()


def is_fp8_dot(dot_fn: Optional[object]) -> bool:
    """Whether a model's ``dot_fn`` is an fp8 product of this module."""
    return dot_fn is not None and hasattr(dot_fn, "tensor_parallel")
