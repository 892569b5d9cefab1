"""Tree-recursive tensor utilities and the collectives, at one process.

Counterpart of ``accelerate_tpu/ops/operations.py``, on torch tensors. Every
function recurses over nested list, tuple (namedtuples included) and dict
trees. Placement is an explicit ``torch.device``: ``send_to_device`` copies
each tensor leaf (and turns each numpy leaf into a tensor) there, with
``non_blocking`` where the source is pinned host memory.

The collectives (``gather``, ``gather_object``, ``reduce``, ``broadcast``,
``broadcast_object_list``, ``pad_across_processes``) run their one-process
paths; with more than one process they raise until the parallel slice runs
them on ``torch.distributed`` (ROADMAP item 9(b)). The reference's debug-mode
check that every process's operand has the same shapes compares nothing at
one process, so it comes with that slice too.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..state import PartialState


def _one_process(operation: str) -> PartialState:
    state = PartialState()
    if state.num_processes > 1:
        raise NotImplementedError(
            f"{operation} across {state.num_processes} processes is not in the port yet "
            "(ROADMAP item 9(b))"
        )
    return state


# ---------------------------------------------------------------------------
# tree recursion
# ---------------------------------------------------------------------------


def honor_type(obj, generator):
    """Rebuild ``obj``'s container type (namedtuples included) from ``generator``."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def is_array(x) -> bool:
    """A torch tensor or a numpy array (not a numpy scalar)."""
    return isinstance(x, (torch.Tensor, np.ndarray)) and not isinstance(x, np.generic)


def recursively_apply(
    func: Callable,
    data: Any,
    *args,
    test_type: Callable = is_tensor,
    error_on_other_type: bool = False,
    **kwargs,
):
    """Apply ``func`` to every leaf of a nested container that passes ``test_type``."""
    if isinstance(data, (tuple, list)):
        return honor_type(
            data,
            (
                recursively_apply(
                    func, o, *args, test_type=test_type, error_on_other_type=error_on_other_type, **kwargs
                )
                for o in data
            ),
        )
    if isinstance(data, Mapping):
        return type(data)(
            {
                k: recursively_apply(
                    func, v, *args, test_type=test_type, error_on_other_type=error_on_other_type, **kwargs
                )
                for k, v in data.items()
            }
        )
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(
            f"Unsupported type {type(data)} passed to {getattr(func, '__name__', func)}; only nested "
            "list/tuple/dict of tensors are supported."
        )
    return data


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def send_to_device(tensor, device=None, non_blocking: bool = False, skip_keys=None):
    """Copy every tensor leaf to ``device`` (numpy leaves become tensors
    first). ``device=None`` is the process's device (``PartialState``).
    ``non_blocking`` takes effect where a leaf is pinned host memory.
    ``skip_keys`` names dict entries, at any level, that stay where they are."""
    device = PartialState().device if device is None else torch.device(device)
    if isinstance(skip_keys, str):
        skip_keys = [skip_keys]

    def _send(t):
        if isinstance(t, np.ndarray):
            if t.dtype.kind not in "biuf":  # strings and objects stay on the host
                return t
            t = torch.from_numpy(np.ascontiguousarray(t))
        return t.to(device, non_blocking=non_blocking)

    if skip_keys:
        if isinstance(tensor, Mapping):
            return type(tensor)(
                {
                    k: (v if k in skip_keys else send_to_device(v, device, non_blocking, skip_keys))
                    for k, v in tensor.items()
                }
            )
        if isinstance(tensor, (tuple, list)):
            return honor_type(tensor, (send_to_device(v, device, non_blocking, skip_keys) for v in tensor))
    return recursively_apply(_send, tensor, test_type=is_array)


def to_numpy(tensor):
    """Every tensor leaf as host numpy. numpy has no bf16, so a bf16 leaf
    goes through fp32 (exact: every bf16 value is an fp32 value)."""

    def _get(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    return recursively_apply(_get, tensor)


# ---------------------------------------------------------------------------
# introspection
# ---------------------------------------------------------------------------


def find_batch_size(data):
    """Leading-dim size of the first array leaf with a dim, or None."""
    if isinstance(data, Mapping):
        for v in data.values():
            b = find_batch_size(v)
            if b is not None:
                return b
    elif isinstance(data, (tuple, list)):
        for v in data:
            b = find_batch_size(v)
            if b is not None:
                return b
    elif is_array(data) and data.ndim >= 1:
        return data.shape[0]
    return None


def get_shape(data):
    return recursively_apply(lambda t: list(t.shape), data)


def slice_tensors(data, tensor_slice, process_index=None, num_processes=None):  # noqa: ARG001 - parity
    return recursively_apply(lambda t: t[tensor_slice], data)


def concatenate(data, dim: int = 0):
    """Concatenate a list of trees of one structure leaf by leaf."""
    first = data[0]
    if isinstance(first, (tuple, list)):
        return honor_type(first, (concatenate([d[i] for d in data], dim=dim) for i in range(len(first))))
    if isinstance(first, Mapping):
        return type(first)({k: concatenate([d[k] for d in data], dim=dim) for k in first.keys()})
    if isinstance(first, torch.Tensor):
        return torch.cat(data, dim=dim)
    return np.concatenate(data, axis=dim)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def gather(tensor):
    """Every process's tensors concatenated along the leading dim: at one
    process, the tensors themselves."""
    _one_process("gather")
    return recursively_apply(lambda t: t, tensor, test_type=is_array, error_on_other_type=True)


def gather_object(obj: list):
    """Every process's list of objects, concatenated."""
    _one_process("gather_object")
    return list(obj)


def broadcast(tensor, from_process: int = 0):  # noqa: ARG001 - one process
    """Each tensor leaf from ``from_process``."""
    _one_process("broadcast")
    return recursively_apply(lambda t: t, tensor, test_type=is_array, error_on_other_type=True)


def broadcast_object_list(object_list: list, from_process: int = 0):  # noqa: ARG001 - one process
    """``object_list`` replaced in place by ``from_process``'s."""
    _one_process("broadcast_object_list")
    return object_list


def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """Each leaf summed (``"sum"``) or averaged (``"mean"``) over the
    processes, times ``scale``."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    _one_process("reduce")
    return recursively_apply(lambda t: t * scale, tensor, test_type=is_array, error_on_other_type=True)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):  # noqa: ARG001
    """Each leaf padded along ``dim`` to the largest size over the
    processes: at one process, unchanged."""
    _one_process("pad_across_processes")
    return recursively_apply(lambda t: t, tensor, test_type=is_array, error_on_other_type=True)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Leaves of ``batch_size`` rows along ``dim`` padded, by repeating the
    last row, to a multiple of ``num_processes``."""
    remainder = batch_size % num_processes
    if remainder == 0:
        return tensor
    pad_count = num_processes - remainder

    def _pad(t):
        if t.shape[dim] != batch_size:
            return t
        tail = t.narrow(dim, t.shape[dim] - 1, 1)
        reps = [1] * t.ndim
        reps[dim] = pad_count
        return torch.cat([t, tail.repeat(*reps)], dim=dim)

    return recursively_apply(_pad, tensor, error_on_other_type=True)


# ---------------------------------------------------------------------------
# dtype conversion
# ---------------------------------------------------------------------------


def convert_to_fp32(tensor):
    """fp16 and bf16 leaves cast to fp32; other leaves unchanged."""

    def _upcast(t):
        return t.float() if t.dtype in (torch.float16, torch.bfloat16) else t

    return recursively_apply(_upcast, tensor)


class ConvertOutputsToFp32:
    """A picklable callable that upcasts a function's outputs to fp32."""

    def __init__(self, model_forward: Callable):
        self.model_forward = model_forward

    def __call__(self, *args, **kwargs):
        return convert_to_fp32(self.model_forward(*args, **kwargs))

    def __getstate__(self):
        return {"model_forward": self.model_forward}

    def __setstate__(self, state):
        self.model_forward = state["model_forward"]


def convert_outputs_to_fp32(model_forward: Callable) -> Callable:
    return ConvertOutputsToFp32(model_forward)
