"""What each process of ``tests/test_torch_tensor_parallel.py``'s launches runs.

Kept apart from the test module so that the processes the port's
``debug_launcher`` starts import torch and the port only, never JAX. Every
function returns plain Python and numpy, which the launcher carries back
through files.
"""

import numpy as np
import torch

from accelerate_tpu_torch import (
    GPT2,
    T5,
    Accelerator,
    Bert,
    FP8RecipeKwargs,
    Llama,
    fused_adamw,
    load_jax_params,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig
from accelerate_tpu_torch.utils.params import flatten_tree

LR = 1e-3
CLASSES = {"llama": Llama, "gpt2": GPT2, "bert": Bert, "t5": T5}


def _reset() -> None:
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _numpy_tree(tree) -> dict:
    return {k: v.detach().cpu().float().numpy().copy() for k, v in flatten_tree(tree)}


def _model(name: str, params: dict):
    return load_jax_params(CLASSES[name.split("-")[0]](name, device="cpu"), params)


def _accelerator(parallelism: dict, mixed_precision: str = "no", margin=None) -> Accelerator:
    handlers = [FP8RecipeKwargs(margin=margin)] if margin is not None else None
    return Accelerator(device="cpu", parallelism=ParallelismConfig(**parallelism),
                       mixed_precision=mixed_precision, kwargs_handlers=handlers)


def _tensors(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def _share(batch: dict, state) -> dict:
    """This process's rows of a global batch: its batch shard (the processes
    of a tensor, expert or sequence group take the same rows)."""
    out = {}
    for key, value in batch.items():
        rows = value.shape[0] // state.batch_shards
        out[key] = torch.tensor(value[state.batch_shard_index * rows:(state.batch_shard_index + 1) * rows])
    return out


def forward(name: str, params: dict, parallelism: dict, args: tuple) -> dict:
    """``prepared(*args)`` of a model under ``parallelism``: the gathered
    logits, and the shapes this process stores."""
    _reset()
    acc = _accelerator(parallelism)
    prepared = acc.prepare_model(_model(name, params))
    logits = prepared(*[torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args])
    return {"logits": logits.float().numpy().copy(),
            "stored": {k: tuple(v.shape) for k, v in flatten_tree(prepared.params)}}


def loss_fn_of(name: str, model):
    return CLASSES[name.split("-")[0]].loss_fn(model)


def train(name: str, params: dict, parallelism: dict, batches: list, mixed_precision: str = "no",
          margin=None, checkpoint_dirs=None, clip_grad_norm=None) -> dict:
    """``len(batches)`` compiled steps of ``fused_adamw(LR)`` under
    ``parallelism`` (clipped to ``clip_grad_norm`` when given), each
    process on its share of every global batch: the losses and the
    gathered params. ``checkpoint_dirs`` (gathered, sharded): saved after
    the steps."""
    _reset()
    torch.use_deterministic_algorithms(True)
    acc = _accelerator(parallelism, mixed_precision, margin)
    model = _model(name, params)
    prepared = acc.prepare_model(model)
    optimizer = acc.prepare_optimizer(fused_adamw(LR))
    step = acc.compiled_step(loss_fn_of(name, model), clip_grad_norm=clip_grad_norm)
    losses = [float(step(_share(batch, acc.state))) for batch in batches]
    out = {"losses": losses, "params": _numpy_tree(prepared.full_params()),
           "stored": {k: tuple(v.shape) for k, v in flatten_tree(prepared.params)},
           "mesh": dict(acc.state.mesh_shape), "mesh_coords": dict(acc.state.mesh_coords), "distributed_type": str(acc.distributed_type),
           "dot_fn": None if model.dot_fn is None else getattr(model.dot_fn, "margin", "other")}
    if hasattr(model, "expert_parallel") and model.expert_parallel is not None:
        out["expert"] = (model.expert_parallel.rank, model.expert_parallel.size)
    if checkpoint_dirs is not None:
        acc.save_state(checkpoint_dirs[0])
        acc.save_state(checkpoint_dirs[1], sharded=True)
        # a fresh run of the same configuration resumes from the sharded save
        _reset()
        acc = _accelerator(parallelism, mixed_precision, margin)
        resumed = acc.prepare_model(_model(name, params))
        acc.prepare_optimizer(fused_adamw(LR))
        acc.load_state(checkpoint_dirs[1])
        out["resumed"] = _numpy_tree(resumed.full_params())
    torch.use_deterministic_algorithms(False)
    return out


def dropout_train(params: dict, parallelism: dict, batches: list) -> dict:
    """llama-tiny with residual dropout 0.1, 2 compiled steps under
    ``parallelism``, each process's dropout generator seeded apart (100 +
    its index): the losses. The processes of a tensor group take their
    first process's seeds, so they draw its masks."""
    from accelerate_tpu_torch.models import get_config

    _reset()
    torch.use_deterministic_algorithms(True)
    acc = _accelerator(parallelism)
    model = load_jax_params(Llama(get_config("llama-tiny").replace(dropout_rate=0.1), device="cpu"), params)
    acc.prepare_model(model)
    acc.prepare_optimizer(fused_adamw(LR))
    generator = torch.Generator().manual_seed(100 + acc.process_index)
    step = acc.compiled_step(Llama.loss_fn(model, dropout_generator=generator))
    losses = [float(step(_share(batch, acc.state))) for batch in batches]
    torch.use_deterministic_algorithms(False)
    _reset()
    return {"losses": losses}


def ring(q, k, v, mask, causal: bool) -> dict:
    """The ring at ``sequence=2, tensor=2``: this process's chunk of the
    sequence and its tensor rank's heads (its kv heads' share of GQA)."""
    from accelerate_tpu_torch.parallel.ring_attention import make_ring_attention

    _reset()
    state = PartialState(device="cpu", parallelism=ParallelismConfig(sequence=2, tensor=2))
    c = state.mesh_coords
    s, nh, kv = q.shape[1] // 2, q.shape[2] // 2, k.shape[2] // 2
    rows = slice(c["sequence"] * s, (c["sequence"] + 1) * s)
    heads, kv_heads = slice(c["tensor"] * nh, (c["tensor"] + 1) * nh), slice(c["tensor"] * kv, (c["tensor"] + 1) * kv)
    attn = make_ring_attention(state.mesh, causal=causal)
    local_mask = None if mask is None else torch.tensor(mask[:, rows])
    out = attn(torch.tensor(q[:, rows, heads]), torch.tensor(k[:, rows, kv_heads]), torch.tensor(v[:, rows, kv_heads]),
               local_mask)
    return {"rows": (rows.start, rows.stop), "heads": (heads.start, heads.stop), "out": out.numpy().copy()}


def fp8_products(case: dict) -> dict:
    """The e4m3 product at ``tensor=2`` in fp32, on this process's slices:
    column-parallel, row-parallel and GQA-shared (the whole weight, this
    process's columns read); the outputs and gradients."""
    from accelerate_tpu_torch.ops.fp8 import fp8_dot
    from accelerate_tpu_torch.parallel.tensor_parallel import column_products, model_parallel_groups, row_product

    _reset()
    state = PartialState(device="cpu", parallelism=ParallelismConfig(tensor=2))
    tp, _ = model_parallel_groups(state)
    x, w, ct = case["x"], case["w"], case["ct"]
    n, k = w.shape[1] // 2, w.shape[0] // 2
    cols, rows = slice(tp.rank * n, (tp.rank + 1) * n), slice(tp.rank * k, (tp.rank + 1) * k)
    out = {"cols": (cols.start, cols.stop), "rows": (rows.start, rows.stop)}

    def run(xv, wv, ctv, product):
        xt, wt = torch.tensor(xv, requires_grad=True), torch.tensor(wv, requires_grad=True)
        y = product(xt, wt)
        (y * torch.tensor(ctv)).sum().backward()
        return {"out": y.detach().numpy().copy(), "gx": xt.grad.numpy().copy(), "gw": wt.grad.numpy().copy()}

    out["column"] = run(x, w[:, cols], ct[:, cols], lambda a, b: column_products(a, fp8_dot, tp)(b))
    out["row"] = run(x[:, rows], w[rows], ct, lambda a, b: row_product(a, b, fp8_dot, tp))
    out["shared"] = run(x, w, ct[:, cols], lambda a, b: column_products(a, fp8_dot, tp)(b, cols))
    # data=2: this process's rows of x and of the cotangent, w whole; the
    # first process returns w's gradient, the other zeros (the update sums them)
    from accelerate_tpu_torch.ops.fp8 import Fp8Rows, make_fp8_dot

    _reset()
    state = PartialState(device="cpu", parallelism=ParallelismConfig(data=2))
    m = x.shape[0] // 2
    mine = slice(state.process_index * m, (state.process_index + 1) * m)
    dot = make_fp8_dot(0, Fp8Rows(state.group(("data",)), None, state.process_index == 0))
    out["data"] = run(x[mine], w, ct[mine], dot)
    out["data_rows"] = (mine.start, mine.stop)
    _reset()
    return out


def resolution() -> dict:
    """The ZeRO resolution and the scheduler's tick at ``data=2, tensor=2``
    (``tests/test_zero.py``'s and ``tests/test_accelerator.py``'s cases)."""
    from accelerate_tpu_torch.scheduler import AcceleratedScheduler

    _reset()
    acc = _accelerator(dict(data=2, tensor=2))
    out = {"zero_auto": acc._zero_update_sharding}
    _reset()
    try:  # the demanded sharded update raises: the refusal's text is the result
        _accelerator(dict(data=2, tensor=2, zero_stage=1))
        out["zero_demanded"] = None
    except ValueError as exc:
        out["zero_demanded"] = str(exc)
    _reset()
    acc = _accelerator(dict(data=2, tensor=2))
    sched = AcceleratedScheduler(lambda c: 0.1, optimizer=None)
    acc.gradient_state._set_sync_gradients(True)
    sched.step()
    out["scheduler_tick"] = sched.step_count
    out["batch_shards"] = acc.state.batch_shards
    out["gathered"] = acc.gather(torch.tensor([acc.state.batch_shard_index, 10])).tolist()
    _reset()
    return out


def suite(jobs: list) -> dict:
    """Every job ``(key, function name, args)`` in order: its result by key."""
    functions = {"forward": forward, "train": train, "ring": ring, "resolution": resolution,
                 "fp8_products": fp8_products, "dropout": dropout_train}
    torch.manual_seed(0)
    return {key: functions[fn](*args) for key, fn, args in jobs}
