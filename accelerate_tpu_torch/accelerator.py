"""The Accelerator facade for one device: prepare, backward, the training
loop, checkpoints.

Counterpart of ``accelerate_tpu/accelerator.py``, keeping its seam: the
loss is a function ``loss_fn(params, batch)`` over the JAX layout's param
tree, and the step is built around it::

    accelerator = Accelerator(mixed_precision="bf16")
    model = accelerator.prepare_model(Llama("llama-125m"))
    optimizer = accelerator.prepare_optimizer(fused_adamw(3e-4))
    step = accelerator.compiled_step(Llama.loss_fn(model.module))
    loss = step({"input_ids": ids})

or the loop every Accelerate user writes, with a data loader, a schedule
and checkpoints::

    model, optimizer, loader, scheduler = accelerator.prepare(
        Llama("llama-125m"), fused_adamw(3e-4),
        accelerator.prepare_data_loader(dataset, batch_size=16, shuffle=True), schedule)
    for batch in loader:
        with accelerator.accumulate(model):
            loss = accelerator.backward(loss_fn, batch)
            optimizer.step()
            scheduler.step()
            optimizer.zero_grad()
    accelerator.save_state("ckpt")        # later: accelerator.load_state("ckpt")

``accelerator.checkpoint_manager(...)`` adds periodic atomic saves, a save
at the step boundary after SIGTERM, and ``resume("auto")``.

Mixed precision is a cast, not autocast: the fp32 master parameters (and
the batch's floating leaves) are cast to the compute dtype inside the
autograd graph, so every op computes in that dtype as in the JAX package
and the gradients land on the masters in fp32. ``compiled_step`` runs
eagerly in this slice (no ``torch.compile``, no CUDA graph: ROADMAP item
15); it keeps the reference's microbatch split, cast, clip and update seam.

Across processes (``torchrun``, or ``launchers.debug_launcher``) each
process feeds its share of every batch, and the mesh's ``data`` and
``fsdp`` axes (``ParallelismConfig``, ``FullyShardedDataParallelPlugin``)
decide where params and optimizer state live (``parallel/sharding.py``)
and how the update runs (``parallel/zero.py``): by default the ZeRO
sharded update, the JAX package's default on such a mesh, with params
stored in the folded 1/N layout; ``ParallelismConfig(zero_stage=0)`` keeps
the replicated update, whose gradients are all-reduced to the mean; FSDP
stages 1/2 keep the params whole and shard the update, and ``cpu_offload``
keeps the optimizer state in host memory. The resilience, telemetry and
analysis branches wait for later slices (ROADMAP items 18, 19, 21): their
methods raise ``NotImplementedError`` naming the item.
"""

from __future__ import annotations

import dataclasses
import inspect
from contextlib import contextmanager
from typing import Any, Callable, Optional

import torch

from .data_loader import BaseDataLoader, prepare_data_loader, skip_first_batches
from .logging import get_logger
from .ops import operations as ops
from .optimizer import AcceleratedOptimizer, clip_by_global_norm, clip_by_value, scaled_optimizer_update
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState, job_world_size
from .utils.dataclasses import (
    CompilationConfig,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    InitProcessGroupKwargs,
    KwargsHandler,
    LossScaleKwargs,
    ParallelismConfig,
    ProjectConfiguration,
)
from .utils.memory import release_memory
from .utils.params import tree_leaves, tree_map, tree_unflatten

logger = get_logger(__name__)

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
    updates in place; ``module`` is the original. Across processes
    ``layout`` (``parallel.zero.ShardedLayout``) says where each param is
    stored; where it splits them, ``params`` holds this process's shards
    and the module's own weights hold nothing until ``unwrap_model``."""

    def __init__(self, module: Any, params: dict, layout=None):
        self.module = module
        self.params = params
        self.layout = layout

    def full_params(self) -> dict:
        """The whole params (gathered from the shards: a collective when
        they are split, which every process calls)."""
        if self.layout is None or not self.layout.shards_params:
            return self.params
        return self.layout.gather_params(self.params)


class Accelerator:
    def __init__(
        self,
        device_placement: bool = True,
        split_batches: bool = False,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: Optional[int] = None,
        parallelism: Optional[ParallelismConfig] = None,
        fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None,
        compilation_config: Optional[CompilationConfig] = None,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        project_config: Optional[ProjectConfiguration] = None,
        project_dir: Optional[str] = None,
        even_batches: bool = True,
        dispatch_batches: Optional[bool] = None,
        step_scheduler_with_optimizer: bool = True,
        kwargs_handlers: Optional[list[KwargsHandler]] = None,
        device=None,
    ):
        """``device=None`` means CUDA (``cuda:LOCAL_RANK`` across processes;
        it raises without a card); ``device="cpu"`` runs every kernel's
        plain version. The loader options (``device_placement``,
        ``split_batches``, ``even_batches``, ``dispatch_batches``) are the
        defaults of ``prepare_data_loader``. An ``InitProcessGroupKwargs``
        among ``kwargs_handlers`` says how the processes meet."""
        if fsdp_plugin is not None and parallelism is None:
            parallelism = ParallelismConfig(fsdp=fsdp_plugin.fsdp_size or job_world_size())
        self.project_configuration = project_config or ProjectConfiguration(project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self.loss_scale_kwargs: Optional[LossScaleKwargs] = None
        init_kwargs = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, LossScaleKwargs):
                self.loss_scale_kwargs = handler
            elif isinstance(handler, InitProcessGroupKwargs):
                init_kwargs = handler
        self.state = AcceleratorState(mixed_precision=mixed_precision, parallelism=parallelism, device=device,
                                      init_kwargs=init_kwargs)
        self.fsdp_plugin = fsdp_plugin
        self._resolve_zero()
        self.compilation_config = compilation_config or CompilationConfig()
        if (fsdp_plugin is not None and fsdp_plugin.activation_checkpointing
                and self.compilation_config.remat_policy is None):
            # each layer recomputed in the backward but for the flash
            # forward's out and lse; a copy: the config may be shared
            self.compilation_config = dataclasses.replace(self.compilation_config, remat_policy="save_flash")
        if self.state.mixed_precision == "fp16" and self.loss_scale_kwargs is None:
            self.loss_scale_kwargs = LossScaleKwargs()
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=gradient_accumulation_steps or 1)
        elif gradient_accumulation_steps is not None:
            raise ValueError(
                "Pass either gradient_accumulation_steps or gradient_accumulation_plugin, not both."
            )
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.device_placement = device_placement
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.dispatch_batches = dispatch_batches
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self._models: list[PreparedModel] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list[BaseDataLoader] = []
        self._custom_objects: list = []
        self._save_model_hooks: list = []
        self._load_model_hooks: list = []
        self._accum_step = 0
        self.flag_tensor: Optional[torch.Tensor] = None

    def _resolve_zero(self) -> None:
        """The reference's ZeRO resolution: ``zero_stage=None`` shards the
        update wherever the mesh allows it, 0 keeps the replicated update, 1
        or more requires the sharded one (and raises where it cannot run)."""
        from .parallel.zero import zero_ineligible_reason

        sizes = self.state.mesh_shape
        requested = self.state.parallelism.zero_stage
        reason = zero_ineligible_reason(sizes, self.fsdp_plugin)
        if requested is not None and requested >= 1 and reason is not None:
            raise ValueError(
                f"zero_stage={requested} requested but the update cannot be sharded on this "
                f"configuration: {reason}. Drop zero_stage or fix the mesh."
            )
        self._zero_update_sharding = reason is None and requested != 0
        plugin = self.fsdp_plugin
        if (requested != 0 and reason is not None and plugin is not None and plugin.cpu_offload
                and plugin.stage >= 3 and zero_ineligible_reason(sizes, None) is None):
            logger.warning(
                f"ZeRO sharded update disabled: {reason}. Params and optimizer state keep the fsdp "
                "layout, not folded over the data axes; drop cpu_offload for the folded 1/N layout, "
                "or pass ParallelismConfig(zero_stage=0) to silence this."
            )

    # -- topology passthrough ------------------------------------------------

    @property
    def distributed_type(self):
        return self.state.distributed_type

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mesh(self):
        """The ``DeviceMesh`` over the processes (None at one process)."""
        return self.state.mesh

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int) -> None:
        self.gradient_state.plugin_kwargs.update({"num_steps": value})

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    def print(self, *args, **kwargs) -> None:
        self.state.print(*args, **kwargs)

    def wait_for_everyone(self) -> None:
        self.state.wait_for_everyone()

    @contextmanager
    def main_process_first(self):
        with self.state.main_process_first():
            yield

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        with self.state.split_between_processes(inputs, apply_padding=apply_padding) as piece:
            yield piece

    def on_main_process(self, fn):
        return self.state.on_main_process(fn)

    def on_last_process(self, fn):
        return self.state.on_last_process(fn)

    def on_process(self, fn=None, process_index: int = 0):
        return self.state.on_process(fn, process_index=process_index)

    # -- prepare ---------------------------------------------------------------

    def _partition_rules(self, module: Any):
        """The model's partition rules; FSDP stages 1 and 2 keep params whole."""
        from .parallel.sharding import PartitionRules

        rules = list(module.partition_rules()) if hasattr(module, "partition_rules") else []
        stage3 = self.fsdp_plugin is None or self.fsdp_plugin.stage >= 3
        return PartitionRules(rules, fsdp_plugin=self.fsdp_plugin, apply_fsdp_to_params=stage3)

    def prepare_model(self, model: Any, params: Optional[dict] = None) -> PreparedModel:
        """Bind a model to its fp32 master parameters: the module's own
        parameters (its ``param_tree()``), moved to the device if needed
        and marked ``requires_grad``, or ``params`` loaded into them. Wires
        the attention hook: the flash dispatch whenever
        ``flash_attention_min_seq`` is set (on any device; a CPU run takes
        the kernels' plain versions; non-causal for a model whose
        ``causal_attention`` is False, as BERT's), else the einsum path.
        A model with the ``remat_layers`` hook checkpoints each layer under
        the config's ``remat_policy``; the step wraps the whole loss
        function of any other model instead.

        Across processes process 0's weights are broadcast to every process
        (as DDP does), and each param is stored in the layout its partition
        rules give (folded over the data axes under ZeRO): where that
        splits it, the prepared model holds this process's shard and the
        module's weight is emptied."""
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
            # per layer, not the outer loss-fn wrap, which for the dot
            # policies would keep every layer's products alive at once;
            # always assigned: the model may be re-prepared under another config
            model.remat_layers = self.compilation_config.checkpoint_policy() or False
        tree = model.param_tree()
        layout = None
        if self.num_processes > 1:
            tree, layout = self._distribute(model, tree)
        prepared = PreparedModel(model, tree, layout)
        self._models.append(prepared)
        return prepared

    @torch.no_grad()
    def _distribute(self, model: Any, tree: dict):
        """Process 0's weights on every process, stored in the model's layout."""
        from .parallel.sharding import infer_shardings, zero_update_shardings
        from .parallel.zero import ShardedLayout

        for p in tree_leaves(tree):
            p.copy_(ops.broadcast(p.data))
        sizes = self.state.mesh_shape
        specs = infer_shardings(tree, sizes, self._partition_rules(model))
        if self._zero_update_sharding:
            specs = zero_update_shardings(tree, specs, sizes)
        layout = ShardedLayout(self.state, specs, specs)
        if layout.shards_params:
            stored = layout.store(tree)
            for p in tree_leaves(tree):  # the shards are the masters now
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            tree = stored
        return tree, layout

    def prepare_optimizer(self, tx: Any, model: Optional[PreparedModel] = None) -> AcceleratedOptimizer:
        """Bind a transform to a prepared model's masters. Across processes
        the update runs in the model's layout, or for FSDP stages 1 and 2
        sharded over ``fsdp`` while the params stay whole; under ZeRO a
        transform that reads across leaves (a global-norm clip inside it)
        is refused, since it would see only this process's shard."""
        if isinstance(tx, AcceleratedOptimizer):
            return tx
        if model is None:
            if not self._models:
                raise ValueError("Prepare (or pass) the model before its optimizer.")
            model = self._models[-1]
        plugin = self.fsdp_plugin
        if model.layout is not None and plugin is not None and plugin.stage < 3:
            from .parallel.sharding import infer_shardings
            from .parallel.zero import ShardedLayout

            rules = self._partition_rules(model.module).with_fsdp_applied()
            update_specs = infer_shardings(model.params, self.state.mesh_shape, rules)
            model.layout = ShardedLayout(self.state, model.layout.param_specs, update_specs)
        if self._zero_update_sharding:
            from .parallel.zero import tx_couples_across_leaves

            if tx_couples_across_leaves(tx, model.params):
                raise ValueError(
                    "This optimizer transform couples gradient leaves (a global-norm clip inside "
                    "it), which the ZeRO sharded update would compute over each process's 1/N "
                    "shard. Use accelerator.clip_grad_norm_() (an exact cross-shard norm inside "
                    "the step) or opt out with ParallelismConfig(zero_stage=0)."
                )
        optimizer = AcceleratedOptimizer(
            tx,
            model.params,
            scaler=self.loss_scale_kwargs if self.state.precision_policy.requires_loss_scaling else None,
            layout=model.layout,
            cpu_offload=plugin is not None and plugin.cpu_offload,
        )
        self._optimizers.append(optimizer)
        return optimizer

    def prepare_scheduler(self, schedule_fn: Callable[[int], float]) -> AcceleratedScheduler:
        """Wrap a schedule ``count -> lr``, bound to the optimizer prepared
        last."""
        if isinstance(schedule_fn, AcceleratedScheduler):
            return schedule_fn
        scheduler = AcceleratedScheduler(
            schedule_fn,
            optimizer=self._optimizers[-1] if self._optimizers else None,
            step_with_optimizer=self.step_scheduler_with_optimizer,
            split_batches=self.split_batches,
        )
        self._schedulers.append(scheduler)
        return scheduler

    def prepare_data_loader(self, loader: Any, device_placement: Optional[bool] = None,
                            **loader_kwargs) -> BaseDataLoader:
        """A loader over ``loader`` (a dataset, a torch ``DataLoader`` or a
        prepared loader) on this accelerator's device; ``loader_kwargs``
        (batch_size, shuffle, seed, collate_fn, drop_last, prefetch, ...)
        pass through to ``data_loader.prepare_data_loader``."""
        if isinstance(loader, BaseDataLoader) and loader_kwargs:
            raise ValueError(
                "This loader is already prepared; the extra options "
                f"{sorted(loader_kwargs)} would be silently ignored. Pass the "
                "raw dataset instead to reconfigure it."
            )
        merged = dict(
            split_batches=self.split_batches,
            even_batches=self.even_batches,
            dispatch_batches=self.dispatch_batches,
            device=self.device,
        )
        merged.update(loader_kwargs)
        prepared = prepare_data_loader(
            loader,
            device_placement=device_placement if device_placement is not None else self.device_placement,
            **merged,
        )
        if prepared not in self._dataloaders:  # prepare() of a loader prepared here
            self._dataloaders.append(prepared)
        return prepared

    @staticmethod
    def _is_model_like(obj: Any) -> bool:
        return isinstance(obj, PreparedModel) or (hasattr(obj, "apply") and hasattr(obj, "param_tree"))

    @staticmethod
    def _is_optimizer_like(obj: Any) -> bool:
        return hasattr(obj, "init") and hasattr(obj, "update") and not hasattr(obj, "apply")

    @staticmethod
    def _is_loader_like(obj: Any) -> bool:
        return (
            isinstance(obj, BaseDataLoader)
            or (hasattr(obj, "__getitem__") and hasattr(obj, "__len__"))
            or (hasattr(obj, "__iter__") and not callable(obj))
        )

    def prepare(self, *args: Any) -> Any:
        """Prepare each object by its duck type, models first (an optimizer
        binds to the model prepared before it): models (``apply`` and
        ``param_tree``), transforms (``init`` and ``update``), data loaders
        and datasets (indexable or iterable), then schedules (callables of
        one argument, the step count). Other objects pass through."""
        prepared: dict[int, Any] = {}
        for i, obj in enumerate(args):
            if self._is_model_like(obj):
                prepared[i] = self.prepare_model(obj)
        for i, obj in enumerate(args):
            if i in prepared:
                continue
            if self._is_optimizer_like(obj):
                prepared[i] = self.prepare_optimizer(obj)
            elif self._is_loader_like(obj):
                prepared[i] = self.prepare_data_loader(obj)
            elif callable(obj):
                _check_schedule_shaped(obj)
                prepared[i] = self.prepare_scheduler(obj)
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

    def _effective_remat(self, model: PreparedModel):
        """The outer activation-checkpointing wrap of the loss function: the
        config's policy for a model without the per-layer ``remat_layers``
        hook, None for one with it (its layers are checkpointed already)."""
        if hasattr(model.module, "remat_layers"):
            return None
        return self.compilation_config.checkpoint_policy()

    def _loss_and_grads(self, loss_fn, model: PreparedModel, batch, scale, has_aux: bool = False,
                        params: Optional[dict] = None, shards: int = 1):
        """``(loss fp32, aux, grads)`` of ``loss_fn`` over the compute-dtype
        cast of the model's params (or the whole ``params`` gathered from
        them) and ``batch``, times ``scale`` when given; the grads are fp32,
        like the masters. ``shards`` > 1 divides the loss by that many batch
        shards in the loss's own dtype (before the fp32 cast and the scale,
        as the reference's sharded step does), so summing every process's
        gradients gives the global mean."""
        policy = self.state.precision_policy
        params = model.params if params is None else params
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        remat = self._effective_remat(model)
        with torch.enable_grad():
            args = (cast_floating(params, policy.compute_dtype), cast_floating(batch, policy.compute_dtype))
            out = loss_fn(*args) if remat is None else remat(loss_fn, *args)
            loss, aux = out if has_aux else (out, None)
            if shards > 1:
                loss = loss / shards
            loss = loss.float()
            scaled = loss if scale is None else loss * scale
            grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), aux, tree_unflatten(params, grads)

    def backward(self, loss_fn: Callable, batch: Any = None, model: Optional[PreparedModel] = None,
                 has_aux: bool = False):
        """Compute gradients of ``loss_fn(params, batch)`` and accumulate
        them on the model's optimizer; returns the (unscaled) loss, with
        ``has_aux`` ``(loss, aux)``. Across processes ``batch`` is this
        process's share and the loss returned is the global one."""
        if model is None:
            if not self._models:
                raise ValueError("backward() needs a prepared model.")
            model = self._models[-1]
        optimizer = self._optimizer_for(model)
        layout = model.layout
        if layout is None:
            loss, aux, grads = self._loss_and_grads(loss_fn, model, batch, optimizer.scale, has_aux)
        else:
            # this process's share of the batch: the gradients carry the 1/N
            # that optimizer.step()'s reduction sums into the global mean
            loss, aux, grads = self._loss_and_grads(loss_fn, model, batch, optimizer.scale, has_aux,
                                                    params=layout.gather_params(model.params),
                                                    shards=layout.shards)
            loss = layout.psum(loss)
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
        """Whether this micro-step applies the gradients: every
        ``gradient_accumulation_steps``-th one, and the last batch of a
        loader's epoch (``sync_with_dataloader``), which also restarts the
        window."""
        if self.gradient_state.sync_with_dataloader and self.gradient_state.end_of_dataloader:
            self._accum_step = 0
            self.gradient_state._set_sync_gradients(True)
        else:
            self._accum_step += 1
            sync = (self._accum_step % self.gradient_state.num_steps == 0) or self.gradient_state.sync_each_batch
            self.gradient_state._set_sync_gradients(sync)

    @contextmanager
    def accumulate(self, *models):  # noqa: ARG002 - models accepted for parity
        """Gradient-accumulation window: ``optimizer.step()`` and
        ``zero_grad()`` act once every ``gradient_accumulation_steps``."""
        self._do_sync()
        yield

    @contextmanager
    def no_sync(self, model=None):  # noqa: ARG002 - parity
        """Accumulate without applying: ``optimizer.step()`` and
        ``zero_grad()`` do nothing inside."""
        previous = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(previous)

    @contextmanager
    def join_uneven_inputs(self, joinables, even_batches: Optional[bool] = None):  # noqa: ARG002 - parity
        """Nothing to join: the loaders' even batches give every process as
        many steps."""
        yield

    @contextmanager
    def autocast(self, autocast_handler=None):  # noqa: ARG002 - parity
        """Nothing to switch on: the dtype policy is a cast inside the step."""
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
        Run eagerly; the returned loss is a device scalar (no host sync).
        Across processes ``batch`` is this process's share and the step is
        the sharded one of ``parallel.zero.build_zero_step``."""
        if model is None:
            model = self._models[-1]
        optimizer = self._optimizer_for(model)
        if optimizer.layout is not None:
            from .parallel.zero import build_zero_step

            return build_zero_step(accelerator=self, loss_fn=loss_fn, model=model, optimizer=optimizer,
                                   clip_grad_norm=clip_grad_norm, clip_grad_value=clip_grad_value)
        num_micro = self.gradient_state.num_steps
        tx = optimizer.tx
        scaler_cfg = optimizer.scaler

        def loss_and_grads(batch, scale):
            """The (unscaled) loss and the scaled grads, averaged over the
            microbatches."""
            if num_micro == 1:
                loss, _, grads = self._loss_and_grads(loss_fn, model, batch, scale)
                return loss, grads
            total_loss, total = None, None
            for i in range(num_micro):
                mb = tree_map(lambda x: _microbatch(x, i, num_micro), batch)
                loss, _, grads = self._loss_and_grads(loss_fn, model, mb, scale)
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

    # -- gather / metrics -------------------------------------------------------

    def gather(self, tensor):
        return ops.gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """Gather, then drop the rows the even-batch padding added to the
        last batch of an epoch."""
        data = ops.gather_object(input_data) if use_gather_object else ops.gather(input_data)
        remainder = self.gradient_state.remainder
        if self.gradient_state.end_of_dataloader and remainder > 0:
            data = ops.recursively_apply(lambda t: t[:remainder], data, test_type=ops.is_array)
        return data

    def reduce(self, tensor, reduction: str = "mean", scale: float = 1.0):
        return ops.reduce(tensor, reduction=reduction, scale=scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
        return ops.pad_across_processes(tensor, dim=dim, pad_index=pad_index, pad_first=pad_first)

    def set_trigger(self) -> None:
        """Raise the flag that :meth:`check_trigger` reads on every process."""
        self.flag_tensor = torch.ones((), dtype=torch.int32, device=self.device)

    def check_trigger(self) -> bool:
        flag = self.flag_tensor if self.flag_tensor is not None else torch.zeros(
            (), dtype=torch.int32, device=self.device)
        if int(ops.reduce(flag, reduction="sum")) >= 1:
            self.flag_tensor = None
            return True
        return False

    # -- models and checkpoints ----------------------------------------------

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):  # noqa: ARG002 - parity
        """The module; where its params are stored split across processes,
        they are gathered into its weights first (a collective)."""
        if not isinstance(model, PreparedModel):
            return model
        if model.layout is not None and model.layout.shards_params:
            with torch.no_grad():
                for p, full in zip(tree_leaves(model.module.param_tree()), tree_leaves(model.full_params())):
                    p.data = full.detach()
        return model.module

    def get_state_dict(self, model: PreparedModel, unwrap: bool = True):  # noqa: ARG002 - parity
        """The whole params as a tree of host numpy arrays (gathered across
        processes: a collective)."""
        return ops.to_numpy(model.full_params())

    def save_model(self, model: PreparedModel, save_directory: str, max_shard_size: str = "10GB",
                   safe_serialization: bool = True):
        from .checkpointing import save_model_weights

        save_model_weights(model.full_params(), save_directory, max_shard_size=max_shard_size,
                           safe_serialization=safe_serialization)

    def register_for_checkpointing(self, *objects) -> None:
        invalid = [o for o in objects if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(f"All objects must have state_dict/load_state_dict methods; got invalid: {invalid}")
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook: Callable):
        """``hook(models, weights, output_dir)`` runs before a save writes."""
        self._save_model_hooks.append(hook)
        return _RemovableHandle(self._save_model_hooks, hook)

    def register_load_state_pre_hook(self, hook: Callable):
        """``hook(models, input_dir)`` runs before a load reads."""
        self._load_model_hooks.append(hook)
        return _RemovableHandle(self._load_model_hooks, hook)

    def save_state(self, output_dir: Optional[str] = None, **save_model_kwargs):
        """Save the model, optimizer, scheduler, RNG and registered state in
        the JAX package's format, atomically
        (``checkpointing.save_accelerator_state``); returns the directory."""
        from .checkpointing import save_accelerator_state

        return save_accelerator_state(self, output_dir, **save_model_kwargs)

    def load_state(self, input_dir: Optional[str] = None, **load_model_kwargs):
        """Restore a checkpoint of either package; ``"auto"`` takes the newest
        valid one under the project's checkpoints directory."""
        from .checkpointing import load_accelerator_state

        return load_accelerator_state(self, input_dir, **load_model_kwargs)

    def checkpoint_manager(self, checkpoint_dir: Optional[str] = None, **manager_kwargs):
        """A ``fault_tolerance.CheckpointManager`` for this accelerator."""
        from .fault_tolerance import CheckpointManager

        return CheckpointManager(self, checkpoint_dir=checkpoint_dir, **manager_kwargs)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches)

    def free_memory(self, *objects):
        """Drop the prepared objects and return the card's cached memory."""
        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self._accum_step = 0
        release_memory()
        return objects

    def clear(self, *objects):
        return self.free_memory(*objects)

    def __deepcopy__(self, memo):
        # an Accelerator wraps process-wide singletons: a copy must not fork them
        return self

    # -- later slices ---------------------------------------------------------

    def init_trackers(self, *args, **kwargs):
        raise NotImplementedError("trackers are not in the port yet (ROADMAP item 19)")

    log = end_training = get_tracker = init_trackers

    def profile(self, *args, **kwargs):
        raise NotImplementedError("Accelerator.profile (torch.profiler windows) is not in the port yet "
                                  "(ROADMAP item 19)")

    def analyze(self, *args, **kwargs):
        raise NotImplementedError("Accelerator.analyze is not in the port yet (ROADMAP item 21)")

    def elastic_coordinator(self, *args, **kwargs):
        raise NotImplementedError("elastic training is not in the port yet (ROADMAP item 18)")


def _check_schedule_shaped(obj: Callable) -> None:
    """A callable given to ``prepare`` is taken for a schedule, which takes
    one argument (the step count); a loss function would fail much later,
    so it is refused here with the fix spelled out."""
    try:
        required = [
            p for p in inspect.signature(obj).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) and p.default is p.empty
        ]
    except (TypeError, ValueError):  # builtins without signatures
        return
    if len(required) > 1:
        raise TypeError(
            f"prepare() got a callable ({getattr(obj, '__name__', obj)!r}) "
            f"taking {len(required)} required arguments: a learning-rate "
            "schedule takes one (the step count). If this is a loss "
            "function, pass it to backward()/compiled_step() instead; "
            "for a custom schedule call prepare_scheduler() explicitly."
        )


class _RemovableHandle:
    def __init__(self, hook_list: list, hook):
        self._list = hook_list
        self._hook = hook

    def remove(self) -> None:
        if self._hook in self._list:
            self._list.remove(self._hook)


def _microbatch(x, i: int, num_micro: int):
    """Microbatch ``i`` of ``num_micro`` split off a leaf's leading dim."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.shape[0] % num_micro:
        raise ValueError(f"batch dim {x.shape[0]} does not split into {num_micro} microbatches")
    size = x.shape[0] // num_micro
    return x[i * size:(i + 1) * size]
