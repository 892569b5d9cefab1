"""The Accelerator facade for one device: prepare, backward, the training step.

Counterpart of ``accelerate_tpu/accelerator.py``, keeping its seam: the
loss is a function ``loss_fn(params, batch)`` over the JAX layout's param
tree, and the step is built around it::

    accelerator = Accelerator(mixed_precision="bf16")
    model = accelerator.prepare_model(Llama("llama-125m"))
    optimizer = accelerator.prepare_optimizer(fused_adamw(3e-4))
    step = accelerator.compiled_step(Llama.loss_fn(model.module))
    loss = step({"input_ids": ids})

or eagerly, ``accelerator.backward(loss_fn, batch)`` then
``optimizer.step()`` and ``optimizer.zero_grad()``.

Mixed precision is a cast, not autocast: the fp32 master parameters (and
the batch's floating leaves) are cast to the compute dtype inside the
autograd graph, so every op computes in that dtype as in the JAX package
and the gradients land on the masters in fp32. ``compiled_step`` runs
eagerly in this slice (no ``torch.compile``, no CUDA graph: ROADMAP item
15); it keeps the reference's microbatch split, cast, clip and update seam.
The mesh, ZeRO, resilience and telemetry branches wait for later slices
(ROADMAP items 9, 18, 19).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Optional

import torch

from .optimizer import AcceleratedOptimizer, clip_by_global_norm, clip_by_value, scaled_optimizer_update
from .state import AcceleratorState, GradientState
from .utils.dataclasses import (
    CompilationConfig,
    GradientAccumulationPlugin,
    KwargsHandler,
    LossScaleKwargs,
)
from .utils.params import tree_leaves, tree_map

# distinguishes "argument omitted" from an explicit None (= clear the setting)
_UNSET = object()


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor leaf of a nested dict cast to ``dtype`` (a
    differentiable cast: grads of the cast come back in the leaf's dtype)."""
    def _cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    if isinstance(tree, dict):
        return {key: cast_floating(value, dtype) for key, value in tree.items()}
    return _cast(tree)


class PreparedModel:
    """A model bound to its fp32 master parameters: ``params`` is the JAX
    layout's tree of the module's own ``Parameter``s, which the optimizer
    updates in place; ``module`` is the original."""

    def __init__(self, module: Any, params: dict):
        self.module = module
        self.params = params


class Accelerator:
    def __init__(
        self,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: Optional[int] = None,
        compilation_config: Optional[CompilationConfig] = None,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        kwargs_handlers: Optional[list[KwargsHandler]] = None,
        parallelism: Any = None,
        device=None,
    ):
        """``device=None`` means CUDA (and raises without a card);
        ``device="cpu"`` runs every kernel's plain version."""
        self.loss_scale_kwargs: Optional[LossScaleKwargs] = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, LossScaleKwargs):
                self.loss_scale_kwargs = handler
        self.state = AcceleratorState(mixed_precision=mixed_precision, parallelism=parallelism, device=device)
        self.compilation_config = compilation_config or CompilationConfig()
        if self.state.mixed_precision == "fp16" and self.loss_scale_kwargs is None:
            self.loss_scale_kwargs = LossScaleKwargs()
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=gradient_accumulation_steps or 1)
        elif gradient_accumulation_steps is not None:
            raise ValueError(
                "Pass either gradient_accumulation_steps or gradient_accumulation_plugin, not both."
            )
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self._models: list[PreparedModel] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._accum_step = 0

    # -- topology passthrough ------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    # -- prepare ---------------------------------------------------------------

    def prepare_model(self, model: Any, params: Optional[dict] = None) -> PreparedModel:
        """Bind a model to its fp32 master parameters: the module's own
        parameters (its ``param_tree()``), moved to the device if needed
        and marked ``requires_grad``, or ``params`` loaded into them. Wires
        the attention hook: the flash dispatch whenever
        ``flash_attention_min_seq`` is set (on any device; a CPU run takes
        the kernels' plain versions), else the einsum path."""
        if isinstance(model, PreparedModel):
            return model
        with torch.no_grad():
            if any(p.dtype != torch.float32 for p in model.parameters()):
                raise ValueError("prepare_model keeps fp32 master params: build the model in float32")
            model.to(self.device)
            if params is not None:
                from .utils.params import load_jax_params

                load_jax_params(model, params)
        for p in model.parameters():
            p.requires_grad_(True)
        if hasattr(model, "attention_fn"):
            causal = getattr(model, "causal_attention", True)
            if self.compilation_config.flash_attention_min_seq:
                from .ops.flash_attention import make_auto_attention

                model.attention_fn = make_auto_attention(
                    self.compilation_config.flash_attention_min_seq, causal=causal
                )
            else:
                model.attention_fn = None
        if hasattr(model, "dot_fn"):
            model.dot_fn = None
        if hasattr(model, "remat_layers"):
            model.remat_layers = False
        prepared = PreparedModel(model, model.param_tree())
        self._models.append(prepared)
        return prepared

    def prepare_optimizer(self, tx: Any, model: Optional[PreparedModel] = None) -> AcceleratedOptimizer:
        if isinstance(tx, AcceleratedOptimizer):
            return tx
        if model is None:
            if not self._models:
                raise ValueError("Prepare (or pass) the model before its optimizer.")
            model = self._models[-1]
        optimizer = AcceleratedOptimizer(
            tx,
            model.params,
            scaler=self.loss_scale_kwargs if self.state.precision_policy.requires_loss_scaling else None,
        )
        self._optimizers.append(optimizer)
        return optimizer

    def prepare(self, *args: Any) -> Any:
        """Prepare models (anything with ``apply`` and ``param_tree``) first,
        then transforms (``init`` and ``update``); other objects pass
        through. Data loaders and schedules come with ROADMAP item 9."""
        prepared: dict[int, Any] = {}
        for i, obj in enumerate(args):
            if isinstance(obj, PreparedModel) or (hasattr(obj, "apply") and hasattr(obj, "param_tree")):
                prepared[i] = self.prepare_model(obj)
        for i, obj in enumerate(args):
            if i in prepared:
                continue
            if hasattr(obj, "init") and hasattr(obj, "update"):
                prepared[i] = self.prepare_optimizer(obj)
            else:
                prepared[i] = obj
        result = tuple(prepared[i] for i in range(len(args)))
        return result if len(result) != 1 else result[0]

    # -- the step: backward / clip / accumulate ------------------------------------

    def _optimizer_for(self, model: PreparedModel) -> AcceleratedOptimizer:
        optimizer = next((opt for opt in self._optimizers if opt.params is model.params), None)
        if optimizer is None:
            raise ValueError(
                "no optimizer is prepared for this model, so its gradients would be "
                "dropped: call prepare_optimizer first"
            )
        return optimizer

    def _loss_and_grads(self, loss_fn, params, batch, scale, has_aux: bool = False):
        """``(loss fp32, aux, grads)`` of ``loss_fn`` over the compute-dtype
        cast of ``params`` and ``batch``, times ``scale`` when given; the
        grads are fp32, like the masters."""
        policy = self.state.precision_policy
        leaves = tree_leaves(params)
        with torch.enable_grad():
            out = loss_fn(cast_floating(params, policy.compute_dtype),
                          cast_floating(batch, policy.compute_dtype))
            loss, aux = out if has_aux else (out, None)
            loss = loss.float()
            scaled = loss if scale is None else loss * scale
            grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        it = iter(grads)
        return loss.detach(), aux, tree_map(lambda _: next(it), params)

    def backward(self, loss_fn: Callable, batch: Any = None, model: Optional[PreparedModel] = None,
                 has_aux: bool = False):
        """Compute gradients of ``loss_fn(params, batch)`` and accumulate
        them on the model's optimizer; returns the (unscaled) loss, with
        ``has_aux`` ``(loss, aux)``."""
        if model is None:
            if not self._models:
                raise ValueError("backward() needs a prepared model.")
            model = self._models[-1]
        optimizer = self._optimizer_for(model)
        loss, aux, grads = self._loss_and_grads(loss_fn, model.params, batch, optimizer.scale, has_aux)
        optimizer.accumulate_grads(grads)
        return (loss, aux) if has_aux else loss

    def clip_grad_norm_(self, model_or_max_norm=_UNSET, max_norm=_UNSET, norm_type: int = 2):
        """Register global-norm clipping for later optimizer steps (sticky;
        an explicit None clears it). Accepts ``(parameters, max_norm)`` or
        ``(max_norm)``."""
        if norm_type != 2:
            raise ValueError("Only the L2 grad norm is supported.")
        if max_norm is _UNSET:
            max_norm = model_or_max_norm
        if max_norm is _UNSET:
            raise ValueError("clip_grad_norm_ needs max_norm")
        for optimizer in self._optimizers:
            optimizer.set_clip_grad_norm(None if max_norm is None else float(max_norm))

    def clip_grad_value_(self, model_or_clip_value=_UNSET, clip_value=_UNSET):
        """Register elementwise clamping to ``[-clip_value, clip_value]``,
        applied before any norm clip (sticky; None clears it)."""
        if clip_value is _UNSET:
            clip_value = model_or_clip_value
        if clip_value is _UNSET:
            raise ValueError("clip_grad_value_ needs clip_value")
        for optimizer in self._optimizers:
            optimizer.set_clip_grad_value(None if clip_value is None else float(clip_value))

    def _do_sync(self) -> None:
        self._accum_step += 1
        sync = (self._accum_step % self.gradient_state.num_steps == 0) or self.gradient_state.sync_each_batch
        self.gradient_state._set_sync_gradients(sync)

    @contextmanager
    def accumulate(self, *models):  # noqa: ARG002 - models accepted for parity
        """Gradient-accumulation window: ``optimizer.step()`` and
        ``zero_grad()`` act once every ``gradient_accumulation_steps``."""
        self._do_sync()
        yield

    # -- the fused step ---------------------------------------------------------

    def compiled_step(
        self,
        loss_fn: Callable,
        model: Optional[PreparedModel] = None,
        clip_grad_norm: Optional[float] = None,
        clip_grad_value: Optional[float] = None,
    ):
        """``step(batch) -> loss``: grads (summed over
        ``gradient_accumulation_steps`` microbatches split off the batch's
        leading dim, then averaged) -> unscale -> clip -> the update seam.
        Run eagerly; the returned loss is a device scalar (no host sync)."""
        if model is None:
            model = self._models[-1]
        optimizer = self._optimizer_for(model)
        num_micro = self.gradient_state.num_steps
        tx = optimizer.tx
        scaler_cfg = optimizer.scaler

        def loss_and_grads(batch, scale):
            """The (unscaled) loss and the scaled grads, averaged over the
            microbatches."""
            if num_micro == 1:
                loss, _, grads = self._loss_and_grads(loss_fn, model.params, batch, scale)
                return loss, grads
            total_loss, total = None, None
            for i in range(num_micro):
                mb = tree_map(lambda x: _microbatch(x, i, num_micro), batch)
                loss, _, grads = self._loss_and_grads(loss_fn, model.params, mb, scale)
                total_loss = loss if total_loss is None else total_loss + loss
                total = grads if total is None else tree_map(torch.add, total, grads)
            return total_loss / num_micro, tree_map(lambda g: g / num_micro, total)

        def step(batch):
            scale = optimizer.scale if scaler_cfg is not None else None
            loss, grads = loss_and_grads(batch, scale)
            if scale is not None:
                grads = tree_map(lambda g: g / scale, grads)
            grads = clip_by_value(grads, clip_grad_value)
            gnorm = None
            if clip_grad_norm is not None or scaler_cfg is not None:
                grads, gnorm = clip_by_global_norm(grads, clip_grad_norm)
            _, optimizer.opt_state, new_scale, growth, optimizer._skipped = scaled_optimizer_update(
                tx, model.params, optimizer.opt_state, grads, gnorm, scale,
                optimizer.growth_tracker, scaler_cfg,
            )
            if scaler_cfg is not None:
                optimizer.scale, optimizer.growth_tracker = new_scale, growth
            optimizer._step_count += 1
            return loss

        return step


def _microbatch(x, i: int, num_micro: int):
    """Microbatch ``i`` of ``num_micro`` split off a leaf's leading dim."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.shape[0] % num_micro:
        raise ValueError(f"batch dim {x.shape[0]} does not split into {num_micro} microbatches")
    size = x.shape[0] // num_micro
    return x[i * size:(i + 1) * size]
