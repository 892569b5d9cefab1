"""LocalSGD: independent updates on each process, parameters averaged every k steps.

Counterpart of ``accelerate_tpu/parallel/local_sgd.py``. The JAX package
stacks one replica a worker along a leading axis sharded over ``data`` and
``vmap``s the update; here each process is one worker: inside the context
it keeps its own whole replica of the params and its own optimizer state,
its local step reduces no gradient (the fused adamw kernel updates each
replica leaf in place), and every ``local_sgd_steps`` steps the replicas
are averaged by one all-reduce a leaf over the batch axes (bit-equal on
every process after it: each takes the same reduced sum and divides it the
same way). On exit the average is written back into the model's stored
layout (its shards under ZeRO). ``enabled=False`` is the plain synchronous
step in the same loop: the gradients all-reduced every step, one update on
the global batch's mean, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..utils.params import tree_leaves, tree_map


class LocalSGD:
    """Context manager running a prepared model's training with one replica
    a process::

        with LocalSGD(accelerator, model, fused_adamw(1e-3), local_sgd_steps=8) as lsgd:
            for batch in loader:                 # this process's share
                loss = lsgd.step(loss_fn, batch)  # the mean over the workers
        # on exit: replicas averaged and written back to model.params

    ``optimizer_tx`` is a transform (``ops.fused_adamw``): each process keeps
    its own state of it, and only the params are averaged."""

    def __init__(self, accelerator=None, model=None, optimizer_tx=None, local_sgd_steps: int = 8,
                 enabled: bool = True):
        if accelerator is None or model is None or optimizer_tx is None:
            raise ValueError("LocalSGD needs the Accelerator, a prepared model and an optimizer transform.")
        state = accelerator.state
        model_axes = [a for a in ("tensor", "sequence", "pipeline", "expert") if state.mesh_shape[a] > 1]
        if model_axes:
            raise NotImplementedError(f"LocalSGD keeps a whole replica a process: the model axes {model_axes} "
                                      "split it")
        self.accelerator = accelerator
        self.model = model
        self.tx = optimizer_tx
        self.enabled = enabled
        self.local_sgd_steps = max(int(local_sgd_steps), 1)
        self.num_workers = state.batch_shards
        self._counter = 0
        self._params = None
        self._opt = None

    def __enter__(self) -> "LocalSGD":
        self._counter = 0
        whole = self.model.full_params()  # a collective where the params are stored split
        self._params = tree_map(lambda x: x.detach().clone(memory_format=torch.contiguous_format), whole)
        self._opt = self.tx.init(self._params)
        return self

    def __exit__(self, *exc) -> None:
        if self._params is None:
            return
        if self.enabled and self._counter % self.local_sgd_steps:  # a step's sync averaged them already
            self._sync()
        self._write_back()
        self._params = self._opt = None

    @torch.no_grad()
    def _write_back(self) -> None:
        """The replica (the average, after the sync) into the model's stored
        layout, in place: the optimizer prepared for the model stays bound."""
        layout = self.model.layout
        stored = tree_leaves(self.model.params)
        if layout is None:
            for x, new in zip(stored, tree_leaves(self._params)):
                x.copy_(new)
            return
        from .zero import shard_of

        for x, new, spec in zip(stored, tree_leaves(self._params), layout.pspecs):
            x.copy_(shard_of(new, spec, layout.mesh))

    def _group(self):
        state = self.accelerator.state
        axes = tuple(a for a in ("data", "fsdp") if state.mesh_shape[a] > 1)
        return state.group(axes) if axes else None

    def step(self, loss_fn: Callable, batch: Any) -> torch.Tensor:
        """One update of this process's replica on its share of the batch
        (no gradient reduction; with ``enabled=False`` the gradients are
        all-reduced first: the synchronous step); returns the mean loss over
        the workers. Every ``local_sgd_steps`` calls the replicas are
        averaged."""
        if self._params is None:
            raise RuntimeError("LocalSGD.step() outside the context manager.")
        from ..optimizer import scaled_optimizer_update

        group = self._group()
        workers = self.num_workers if group is not None else 1
        # the synchronous step: each share's loss carries 1/W, so summing the
        # gradients over the workers gives the global mean
        shards = 1 if self.enabled else workers
        loss, _, grads = self.accelerator._loss_and_grads(loss_fn, self.model, batch, None, params=self._params,
                                                          shards=shards)
        if not self.enabled and group is not None:
            for g in tree_leaves(grads):
                dist.all_reduce(g, group=group)
        self._params, self._opt, *_ = scaled_optimizer_update(self.tx, self._params, self._opt, grads, None, None,
                                                              None, None)
        self._counter += 1
        if self.enabled and self._counter % self.local_sgd_steps == 0:
            self._sync()
        if group is not None:
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            if self.enabled:
                loss = loss / workers
        return loss

    @torch.no_grad()
    def _sync(self) -> None:
        """Average the replicas: one all-reduce a leaf, then the division by
        the worker count, the same on every process."""
        group = self._group()
        if group is None:
            return
        for x in tree_leaves(self._params):
            dist.all_reduce(x, group=group)
            x.div_(self.num_workers)

    @property
    def params(self) -> Any:
        """This process's replica (between syncs, its own)."""
        return self._params

    @property
    def opt_state(self) -> Any:
        return self._opt
