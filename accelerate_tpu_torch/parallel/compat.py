"""The one backend difference the ring and the pipeline both meet.

Counterpart of ``accelerate_tpu/parallel/compat.py`` by name only: that
file bridges jax versions (``shard_map``'s ``axis_names`` against ``auto``,
``HAS_PCAST``), and none of its lines has a torch counterpart. What both of
the port's point-to-point users meet instead is the backend: gloo moves
host memory only, so a hop of CUDA tensors on a gloo group is staged
through host tensors by explicit copies; NCCL, or gloo on CPU tensors,
sends the tensors themselves. The choice is made by the group's backend
and the tensors' device (:func:`staged`), never by trying one and catching
the other's error. Ring attention (``parallel/ring_attention.py``, K/V
around the sequence group) and the pipeline schedule
(``parallel/pipeline.py``, activations stage to stage) post their hops
through :class:`Hop`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def staged(group, device: torch.device) -> bool:
    """Whether a hop of tensors on ``device`` over ``group`` goes through
    host copies: gloo moves host memory only."""
    return dist.get_backend(group) == "gloo" and device.type != "cpu"


class Hop:
    """One point-to-point exchange in flight: every tensor of ``tensors``
    sent to global rank ``dst`` and a tensor like it received from ``src``,
    posted as one batch of point-to-point ops on ``group``; :meth:`wait`
    returns the received ones on the tensors' device. ``into`` is a tensor
    like the first to receive it in (an autograd function's output)."""

    def __init__(self, tensors: list, dst: int, src: int, group, into: Optional[torch.Tensor] = None):
        self.device = tensors[0].device
        self.staged = staged(group, self.device)
        self.into = into
        sends = [x.to("cpu") if self.staged else x.contiguous() for x in tensors]
        self.received = [torch.empty_like(x) for x in sends]
        if into is not None and not self.staged:
            self.received[0] = into
        ops = []
        for tag, (x, y) in enumerate(zip(sends, self.received)):
            ops.append(dist.P2POp(dist.isend, x, dst, group, tag))
            ops.append(dist.P2POp(dist.irecv, y, src, group, tag))
        self.works = dist.batch_isend_irecv(ops)

    def wait(self) -> list:
        for work in self.works:
            work.wait()
        if not self.staged:
            return self.received
        out = [x.to(self.device) for x in self.received]
        if self.into is not None:
            with torch.no_grad():
                self.into.copy_(out[0])
            out[0] = self.into
        return out
