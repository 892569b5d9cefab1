"""Tree-recursive tensor utilities and the collectives across processes.

Counterpart of ``accelerate_tpu/ops/operations.py``, on torch tensors. Every
function recurses over nested list, tuple (namedtuples included) and dict
trees. Placement is an explicit ``torch.device``: ``send_to_device`` copies
each tensor leaf (and turns each numpy leaf into a tensor) there, with
``non_blocking`` where the source is pinned host memory.

The collectives (``gather``, ``gather_object``, ``reduce``, ``broadcast``,
``broadcast_object_list``, ``pad_across_processes``) run on
``torch.distributed`` over every process of the job (``PartialState``) and
return their inputs at one process. A tensor leaf stays a tensor (on the
device it came from); a numpy leaf goes through a tensor on the
collectives' device and comes back numpy. With ``ACCELERATE_DEBUG_MODE``
set, the tensor collectives first check that every process passes the same
shapes and raise ``DistributedOperationException`` naming each process's.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..state import PartialState


class DistributedOperationException(Exception):
    """A collective's operands differ in shape across the processes."""


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


def find_device(data):
    """The device of the first tensor in the tree, or None."""
    if isinstance(data, Mapping):
        for v in data.values():
            d = find_device(v)
            if d is not None:
                return d
    elif isinstance(data, (tuple, list)):
        for v in data:
            d = find_device(v)
            if d is not None:
                return d
    elif isinstance(data, torch.Tensor):
        return data.device
    return None


def get_shape(data):
    return recursively_apply(lambda t: list(t.shape), data)


def get_data_structure(data):
    """The tree's skeleton, a ``TensorInformation`` (shape, dtype) per tensor."""
    from ..utils.dataclasses import TensorInformation

    return recursively_apply(lambda t: TensorInformation(shape=tuple(t.shape), dtype=t.dtype), data)


def initialize_tensors(data_structure):
    """Empty tensors (on the host) shaped as a :func:`get_data_structure` skeleton."""
    from ..utils.dataclasses import TensorInformation

    return recursively_apply(lambda ti: torch.empty(ti.shape, dtype=ti.dtype), data_structure,
                             test_type=lambda x: isinstance(x, TensorInformation))


def listify(data):
    """Tensors and arrays as nested Python lists."""
    return recursively_apply(lambda t: np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t).tolist(), data,
                             test_type=is_array)


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


def _verify_same_shapes(operation: str, tensor) -> None:
    """Under ``ACCELERATE_DEBUG_MODE``: raise when the processes pass
    operands of different shapes (a collective would hang or mix them)."""
    state = PartialState()
    if not state.debug or state.num_processes == 1:
        return
    shapes = gather_object([get_shape(recursively_apply(_as_tensor, tensor, test_type=is_array))])
    if any(s != shapes[0] for s in shapes):
        table = "\n".join(f"  - Process {i}: {s}" for i, s in enumerate(shapes))
        raise DistributedOperationException(
            f"Cannot apply the desired operation ({operation}) due to shape mismatches across processes:\n{table}"
        )


def _as_tensor(t) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(t)) if isinstance(t, np.ndarray) else t


def _across(fn):
    """A per-leaf collective ``fn(tensor on the collectives' device) ->
    tensor`` as a leaf function: numpy leaves come back numpy, tensor leaves
    return to their device."""
    state = PartialState()

    def _leaf(t):
        x = _as_tensor(t)
        out = fn(x.to(state.comm_device).contiguous())
        if isinstance(t, np.ndarray):
            return out.cpu().numpy()
        return out.to(x.device)

    return _leaf


def gather(tensor):
    """Every process's leaves concatenated along the leading dim (each
    process passes the same shapes: ``pad_across_processes`` first where
    they differ)."""
    _verify_same_shapes("gather", tensor)
    state = PartialState()
    if state.num_processes == 1:
        return recursively_apply(lambda t: t, tensor, test_type=is_array, error_on_other_type=True)

    def _gather(x):
        x = x.reshape(1) if x.ndim == 0 else x
        out = torch.empty((x.shape[0] * state.num_processes, *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out

    return recursively_apply(_across(_gather), tensor, test_type=is_array, error_on_other_type=True)


def gather_object(obj: list):
    """Every process's list of picklable objects, concatenated in process order."""
    state = PartialState()
    if state.num_processes == 1:
        return list(obj)
    rows: list = [None] * state.num_processes
    dist.all_gather_object(rows, list(obj))
    return [item for row in rows for item in row]


def broadcast(tensor, from_process: int = 0):
    """Each leaf as ``from_process`` holds it (every process passes leaves
    of the same shapes)."""
    _verify_same_shapes("broadcast", tensor)
    state = PartialState()
    if state.num_processes == 1:
        return recursively_apply(lambda t: t, tensor, test_type=is_array, error_on_other_type=True)

    def _bcast(x):
        x = x.clone()
        dist.broadcast(x, src=from_process)
        return x

    return recursively_apply(_across(_bcast), tensor, test_type=is_array, error_on_other_type=True)


def broadcast_object_list(object_list: list, from_process: int = 0):
    """``object_list`` replaced in place by ``from_process``'s (picklable
    objects); returns it."""
    state = PartialState()
    if state.num_processes == 1:
        return object_list
    dist.broadcast_object_list(object_list, src=from_process, device=state.comm_device)
    return object_list


def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """Each leaf summed (``"sum"``) or averaged (``"mean"``) over the
    processes, times ``scale``."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    _verify_same_shapes("reduce", tensor)
    state = PartialState()
    if state.num_processes == 1:
        return recursively_apply(lambda t: t * scale, tensor, test_type=is_array, error_on_other_type=True)

    def _reduce(x):
        x = x.clone()
        dist.all_reduce(x)
        if reduction == "mean":
            x = x / state.num_processes
        return x * scale

    return recursively_apply(_across(_reduce), tensor, test_type=is_array, error_on_other_type=True)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Each leaf padded with ``pad_index`` along ``dim`` to the largest size
    over the processes (at the front with ``pad_first``)."""
    state = PartialState()
    if state.num_processes == 1:
        return recursively_apply(lambda t: t, tensor, test_type=is_array, error_on_other_type=True)

    def _pad(t):
        if t.ndim == 0:
            return t
        sizes = gather_object([int(t.shape[dim])])
        max_size = max(sizes)
        if t.shape[dim] == max_size:
            return t
        new_shape = list(t.shape)
        new_shape[dim] = max_size
        index = [slice(None)] * t.ndim
        index[dim] = slice(max_size - t.shape[dim], max_size) if pad_first else slice(0, t.shape[dim])
        if isinstance(t, np.ndarray):
            out = np.full(new_shape, pad_index, dtype=t.dtype)
        else:
            out = torch.full(new_shape, pad_index, dtype=t.dtype, device=t.device)
        out[tuple(index)] = t
        return out

    return recursively_apply(_pad, tensor, test_type=is_array, error_on_other_type=True)


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
