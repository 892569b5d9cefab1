"""What each process of ``tests/test_torch_pipeline.py``'s launches runs.

Kept apart from the test module so that the processes the port's
``debug_launcher`` starts import torch and the port only, never JAX. Every
function returns plain Python and numpy, which the launcher carries back
through files. Training goes through ``torch_tensor_workers.train``.
"""

import logging

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, ModelParallelPlugin, fused_adamw
from accelerate_tpu_torch.models import get_config
from accelerate_tpu_torch.utils.dataclasses import CompilationConfig, ParallelismConfig
from accelerate_tpu_torch.utils.params import flatten_tree

import torch_tensor_workers as tensor_workers  # noqa: E402 - on the path the launcher hands on

LR = tensor_workers.LR


def config_of(name: str):
    """A registry name, or ``llama-tiny-4``: llama-tiny with 4 layers."""
    if name == "llama-tiny-4":
        return get_config("llama-tiny").replace(num_layers=4)
    return get_config(name)


def model_of(name: str, params: dict, dropout: float = 0.0):
    cfg = config_of(name)
    if dropout:
        cfg = cfg.replace(dropout_rate=dropout)
    family = cfg.arch
    model = tensor_workers.CLASSES[family](cfg, device="cpu")
    return tensor_workers.load_jax_params(model, params)


def accelerator(parallelism: dict, mixed_precision: str = "no", virtual: int = 1, microbatches: int = 0,
                flash: int = 0) -> Accelerator:
    plugin = None
    if virtual > 1 or microbatches:
        plugin = ModelParallelPlugin(pipeline_size=parallelism.get("pipeline", 1), virtual_pipeline_stages=virtual,
                                     num_microbatches=microbatches)
    config = CompilationConfig(flash_attention_min_seq=flash) if flash else None
    return Accelerator(device="cpu", parallelism=ParallelismConfig(**parallelism), model_parallel_plugin=plugin,
                       mixed_precision=mixed_precision, compilation_config=config)


def _arg(a):
    return torch.tensor(a) if isinstance(a, np.ndarray) else a


def forward(name: str, params: dict, parallelism: dict, args: tuple, kwargs: dict, options: dict) -> dict:
    """``prepared(*args, **kwargs)`` of a model under ``parallelism``
    (``options``: ``mixed_precision``, ``virtual``, ``microbatches``,
    ``flash``): the logits (with ``return_aux`` the aux too), this
    process's sequence span, and the shapes it stores."""
    tensor_workers._reset()
    acc = accelerator(parallelism, options.get("mixed_precision", "no"), options.get("virtual", 1),
                      options.get("microbatches", 0), options.get("flash", 0))
    prepared = acc.prepare_model(model_of(name, params))
    out = prepared(*map(_arg, args), **{k: _arg(v) for k, v in kwargs.items()})
    logits, aux = out if kwargs.get("return_aux") else (out, None)
    length = args[0].shape[1]
    return {"logits": logits.float().numpy().copy(), "aux": None if aux is None else float(aux),
            "span": prepared.sequence_span(length),
            "pipeline_fn": prepared.module.pipeline_fn is not None,
            "stored": {k: tuple(v.shape) for k, v in flatten_tree(prepared.params)}}


def dropout_forward(name: str, params: dict, parallelism: dict, ids, seed: int) -> dict:
    """The logits of a dropout-0.3 model under ``parallelism`` with a
    generator seeded ``seed`` (the first process's draw is the base seed)."""
    tensor_workers._reset()
    acc = accelerator(parallelism)
    model = model_of(name, params, dropout=0.3)
    prepared = acc.prepare_model(model)
    with torch.no_grad():
        logits = model.apply(prepared.compute_params(), torch.tensor(ids),
                             dropout_generator=torch.Generator().manual_seed(seed))
    return {"logits": logits.float().numpy().copy()}


def grads(name: str, params: dict, parallelism: dict, batch: dict) -> dict:
    """The first batch's gradients under ``parallelism`` (``backward``, no
    update): every leaf this process stores, and its stage."""
    tensor_workers._reset()
    torch.use_deterministic_algorithms(True)
    acc = accelerator(parallelism)
    model = model_of(name, params)
    acc.prepare_model(model)
    optimizer = acc.prepare_optimizer(fused_adamw(LR))
    loss = acc.backward(tensor_workers.loss_fn_of(name, model), tensor_workers._share(batch, acc.state))
    out = {"loss": float(loss), "grads": {k: v.detach().float().numpy().copy() for k, v in flatten_tree(optimizer.grads)},
           "stage": acc.state.mesh_coords["pipeline"]}
    torch.use_deterministic_algorithms(False)
    return out


def load(name: str, params: dict, parallelism: dict, directory: str) -> dict:
    """A checkpoint of either package loaded under ``parallelism``: the
    gathered params and the shapes this process stores."""
    tensor_workers._reset()
    acc = accelerator(parallelism)
    prepared = acc.prepare_model(model_of(name, params))
    acc.prepare_optimizer(fused_adamw(LR))
    acc.load_state(directory)
    return {"params": tensor_workers._numpy_tree(prepared.full_params()),
            "stored": {k: tuple(v.shape) for k, v in flatten_tree(prepared.params)}}


def save_interleaved(name: str, params: dict, directory: str) -> dict:
    """A model under ``pipeline=2, virtual_pipeline_stages=2`` (each stage
    two chunks, apart in the layer stack) saved sharded to ``directory``:
    the gathered params and the layer rows this process stores."""
    tensor_workers._reset()
    acc = accelerator(dict(pipeline=2), virtual=2)
    prepared = acc.prepare_model(model_of(name, params))
    acc.prepare_optimizer(fused_adamw(LR))
    acc.save_state(directory, sharded=True)
    mine = prepared.layout.chunks(prepared.params["layers"]["attn_norm"],
                                  prepared.layout.param_specs["layers"]["attn_norm"])
    return {"params": tensor_workers._numpy_tree(prepared.full_params()),
            "rows": [offset[0] for offset, _ in mine]}


def cut_warning(params: dict) -> dict:
    """llama-tiny under ``pipeline=2`` with 8 microbatches on a batch of 6:
    the schedule's warning, and the logits (4 and 2 rows run as 6 and 3
    microbatches)."""
    tensor_workers._reset()
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("accelerate_tpu_torch.parallel.pipeline")
    logger.addHandler(handler)
    try:
        acc = accelerator(dict(pipeline=2))
        prepared = acc.prepare_model(model_of("llama-tiny", params))
        ids = torch.tensor(np.random.default_rng(12).integers(0, 1024, (6, 16)))
        logits = prepared(ids)
    finally:
        logger.removeHandler(handler)
    return {"warnings": [r.getMessage() for r in records], "logits": logits.numpy().copy()}


def gpu_pipeline(batches: list) -> dict:
    """Two processes sharing cuda:0 over gloo (NCCL refuses two processes on
    one card): llama-tiny bf16 under ``pipeline=2``, flash from 128 tokens,
    fused adamw, 3 steps on every global batch; the losses and each
    kernel's launches."""
    from datetime import timedelta

    from accelerate_tpu_torch import InitProcessGroupKwargs
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops.fused_adamw import adamw_leaf

    wrappers = {"flash_fwd": fa.flash_forward, "flash_dq": fa.flash_backward_dq,
                "flash_dkv": fa.flash_backward_dkv, "fused_adamw": adamw_leaf}
    tensor_workers._reset()
    acc = Accelerator(mixed_precision="bf16", device="cuda:0", parallelism=ParallelismConfig(pipeline=2),
                      compilation_config=CompilationConfig(flash_attention_min_seq=128),
                      kwargs_handlers=[InitProcessGroupKwargs("gloo", timeout=timedelta(seconds=120))])
    model = tensor_workers.Llama("llama-tiny", seed=0)
    prepared = acc.prepare_model(model)
    acc.prepare_optimizer(fused_adamw(LR))
    step = acc.compiled_step(tensor_workers.Llama.loss_fn(model))
    for wrapper in wrappers.values():
        wrapper.launches = 0
    losses = [float(step({"input_ids": torch.tensor(b, device="cuda")})) for b in batches]
    out = {"losses": losses, "launches": {key: w.launches for key, w in wrappers.items()},
           "leaves": len(list(flatten_tree(prepared.params))), "microbatches": model.pipeline_fn.num_microbatches}
    tensor_workers._reset()
    return out


def suite(jobs: list) -> dict:
    """Every job ``(key, function name, args)`` in order: its result by key."""
    functions = {"forward": forward, "dropout": dropout_forward, "grads": grads, "load": load,
                 "train": tensor_workers.train, "cut_warning": cut_warning, "save_interleaved": save_interleaved}
    torch.manual_seed(0)
    return {key: functions[fn](*args) for key, fn, args in jobs}
