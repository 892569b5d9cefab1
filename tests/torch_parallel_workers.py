"""What each process of ``tests/test_torch_parallel.py``'s launches runs.

Kept apart from the test module so that the processes the port's
``debug_launcher`` starts import torch and the port only, never JAX: each
imports this module to unpickle its function. Every function returns plain
Python and numpy, which the launcher carries back through files.
"""

import os

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, CompilationConfig, Llama, fused_adamw, load_jax_params
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin, ParallelismConfig
from accelerate_tpu_torch.utils.params import flatten_tree, state_leaves, tree_leaves, tree_unflatten

MODEL = "llama-tiny"
LR = 1e-3
FLASH_MIN_SEQ = 128  # the port's flash path (its plain version on the CPU)

# name -> (Accelerator options, compiled_step options, eager window or 0)
TRAINING = {
    "zero": (dict(), dict(clip_grad_norm=0.5), 0),
    "replicated": (dict(parallelism=ParallelismConfig(zero_stage=0)), dict(), 0),
    "fsdp2": (dict(fsdp_plugin=FullyShardedDataParallelPlugin(stage=2, min_weight_size=16)), dict(), 0),
    "fsdp3": (dict(fsdp_plugin=FullyShardedDataParallelPlugin(stage=3, min_weight_size=16)), dict(), 0),
    "fsdp3_offload": (dict(fsdp_plugin=FullyShardedDataParallelPlugin(stage=3, min_weight_size=16,
                                                                      cpu_offload=True)), dict(), 0),
    "zero_eager": (dict(gradient_accumulation_steps=2), dict(), 2),
    "zero_data_fsdp": (dict(parallelism=ParallelismConfig(data=2, fsdp=2)), dict(), 0),
}


def _reset() -> None:
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _numpy_tree(tree) -> dict:
    return {k: v.detach().cpu().float().numpy().copy() for k, v in flatten_tree(tree)}


def _share(batch: np.ndarray, state) -> dict:
    rows = batch.shape[0] // state.num_processes
    mine = batch[state.process_index * rows:(state.process_index + 1) * rows]
    return {"input_ids": torch.tensor(mine)}


def train(name: str, params: dict, batches: list) -> dict:
    """3 steps (the eager configurations: one optimizer step per window)
    of llama-tiny from ``params``, each process on its share of every global
    batch; the losses, the gathered params and what each process stores."""
    _reset()
    # the CPU embedding backward adds its rows in no fixed order otherwise;
    # the offload test compares two configurations bit for bit
    torch.use_deterministic_algorithms(True)
    options, step_options, window = TRAINING[name]
    acc = Accelerator(device="cpu", compilation_config=CompilationConfig(flash_attention_min_seq=FLASH_MIN_SEQ),
                      **options)
    model = load_jax_params(Llama(MODEL, device="cpu"), params)
    prepared = acc.prepare_model(model)
    optimizer = acc.prepare_optimizer(fused_adamw(LR))
    losses = []
    if window:
        loss_fn = Llama.loss_fn(model)
        for batch in batches:
            with acc.accumulate():
                losses.append(float(acc.backward(loss_fn, _share(batch, acc.state))))
                optimizer.step()
                optimizer.zero_grad()
    else:
        step = acc.compiled_step(Llama.loss_fn(model), **step_options)
        losses = [float(step(_share(batch, acc.state))) for batch in batches]
    state = optimizer.opt_state
    return {
        "losses": losses,
        "params": _numpy_tree(prepared.full_params()),
        "stored_shapes": {k: tuple(v.shape) for k, v in flatten_tree(prepared.params)},
        "state_bytes": sum(x.numel() * x.element_size() for x in state_leaves(state)),
        "state_devices": sorted({x.device.type for x in state_leaves(state) if x.ndim}),
        "module_emptied": all(p.numel() == 0 for p in model.parameters()),
        "steps": optimizer.step_count,
        "mesh": dict(acc.state.mesh_shape),
        "distributed_type": str(acc.distributed_type),
    }


def update_gate(zero_stage, params: dict, steps: int = 10) -> dict:
    """The update-equivalence gate's one side: ``steps`` eager updates of
    seeded gradients (each process its own draw) under ``zero_stage``
    (None: the ZeRO sharded update, 0: the replicated one); the gathered
    params and optimizer state."""
    _reset()
    acc = Accelerator(device="cpu", parallelism=ParallelismConfig(zero_stage=zero_stage))
    prepared = acc.prepare_model(load_jax_params(Llama(MODEL, device="cpu"), params))
    optimizer = acc.prepare_optimizer(fused_adamw(3e-4))
    rng = np.random.default_rng(1000 + acc.process_index)
    shapes = [np.shape(p) for p in tree_leaves(params)]
    for _ in range(steps):
        grads = [torch.tensor(rng.standard_normal(shape), dtype=torch.float32) for shape in shapes]
        optimizer.accumulate_grads(tree_unflatten(params, grads))
        optimizer.step()
    state = optimizer.state_dict()["opt_state"]
    return {
        "params": _numpy_tree(prepared.full_params()),
        "state": [x.detach().cpu().numpy().copy() for x in state_leaves(state)],
        "state_bytes": sum(x.numel() * x.element_size() for x in state_leaves(optimizer.opt_state)),
    }


def collectives() -> dict:
    """Every collective of ``ops.operations`` and the process helpers, on
    values that differ by process."""
    from accelerate_tpu_torch.ops import operations as ops
    from accelerate_tpu_torch.utils import random as port_random

    _reset()
    state = PartialState(device="cpu")
    r, n = state.process_index, state.num_processes
    out = {"rank": r, "world": n, "distributed_type": str(state.distributed_type)}
    out["gather"] = ops.gather({"t": torch.arange(3) + 10 * r, "s": torch.tensor(float(r))})
    out["gather"] = {k: v.numpy() for k, v in out["gather"].items()}
    out["gather_numpy"] = ops.gather(np.full((2, 2), r, np.int64))
    out["gather_object"] = ops.gather_object([f"p{r}", r])
    out["broadcast"] = ops.broadcast(torch.full((2,), float(r)), from_process=n - 1).numpy()
    out["broadcast_object_list"] = ops.broadcast_object_list([r, {"from": r}], from_process=1)
    out["reduce_sum"] = ops.reduce(torch.tensor([1.0, float(r)]), reduction="sum").numpy()
    out["reduce_mean"] = ops.reduce(torch.tensor([float(r)]), reduction="mean", scale=2.0).numpy()
    out["pad"] = ops.pad_across_processes(torch.ones(r + 1, 2), dim=0, pad_index=-1).numpy()
    out["pad_first"] = ops.pad_across_processes(np.ones((2, r + 1)), dim=1, pad_first=True).tolist()
    with state.split_between_processes(list(range(7)), apply_padding=True) as piece:
        out["split"] = piece
    with state.split_between_processes({"a": np.arange(5)}) as piece:
        out["split_dict"] = piece["a"].tolist()
    out["any_false"] = state.any_process(False)
    out["any_one"] = state.any_process(r == n - 1)
    out["metrics"] = state.aggregate_metrics({"step_ms": 10.0 + r, "flag": True})
    port_random.set_seed(123 + r)
    port_random.synchronize_rng_states()
    out["rng"] = [float(torch.rand(1)), float(np.random.rand()),
                  float(torch.rand(1, generator=port_random.generator("cpu")))]
    os.environ["ACCELERATE_DEBUG_MODE"] = "1"
    _reset()
    PartialState(device="cpu")
    try:
        ops.gather(torch.zeros(r + 1))
        out["debug_mismatch"] = None
    except ops.DistributedOperationException as e:
        out["debug_mismatch"] = str(e)
    finally:
        del os.environ["ACCELERATE_DEBUG_MODE"]
    _reset()
    return out


class _Rows:
    """A map-style dataset of ``n`` rows: row i is ``[i, 2i]``."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.array([i, 2 * i], np.int64)}


class _Stream:
    """An iterable dataset of ``n`` rows; with ``main_only`` only the main
    process may read it."""

    def __init__(self, n: int, main_only: bool = False):
        self.n = n
        self.main_only = main_only

    def __iter__(self):
        if self.main_only and PartialState().process_index != 0:
            raise AssertionError("the stream was read off the main process")
        for i in range(self.n):
            yield {"x": np.array([i, 2 * i], np.int64)}


def loaders(n_rows: int = 21, batch_size: int = 2) -> dict:
    """The rows each process's loaders yield: a shuffled map-style loader
    (round-robin shards, even batches), ``split_batches``, an iterable
    dataset every process reads (its shard), the dispatcher (only the main
    process reads), and ``gather_for_metrics`` over an epoch of the first."""
    from accelerate_tpu_torch.ops.operations import gather

    _reset()
    acc = Accelerator(device="cpu")
    out = {}
    loader = acc.prepare_data_loader(_Rows(n_rows), batch_size=batch_size, shuffle=True, seed=7, prefetch=0)
    loader.set_epoch(1)
    rows, gathered = [], []
    for batch in loader:
        rows.append(batch["x"][:, 0].tolist())
        gathered.append(acc.gather_for_metrics(batch["x"][:, 0]).tolist())
    out["shuffled"] = rows
    out["metrics"] = gathered
    out["gather_plain"] = gather(torch.tensor([len(rows)])).tolist()
    split = acc.prepare_data_loader(_Rows(n_rows), batch_size=4 * PartialState().num_processes, split_batches=True,
                                    prefetch=0)
    out["split"] = [b["x"][:, 0].tolist() for b in split]
    iterable = acc.prepare_data_loader(_Stream(n_rows), batch_size=batch_size, prefetch=0)
    out["iterable"] = [b["x"][:, 0].tolist() for b in iterable]
    dispatched = acc.prepare_data_loader(_Stream(n_rows, main_only=True), batch_size=batch_size,
                                         dispatch_batches=True)
    out["dispatched"] = [b["x"][:, 0].tolist() for b in dispatched]
    _reset()
    return out


def checkpoints(params: dict, batches: list, jax_dir: str, out_dir: str) -> dict:
    """One ZeRO step, then ``save_state(sharded=True)`` into ``out_dir``;
    then a fresh Accelerator loads the JAX package's sharded checkpoint in
    ``jax_dir``: the gathered params and optimizer state of both."""
    _reset()
    acc = Accelerator(device="cpu", compilation_config=CompilationConfig(flash_attention_min_seq=FLASH_MIN_SEQ))
    model = load_jax_params(Llama(MODEL, device="cpu"), params)
    prepared = acc.prepare_model(model)
    optimizer = acc.prepare_optimizer(fused_adamw(LR))
    step = acc.compiled_step(Llama.loss_fn(model))
    step(_share(batches[0], acc.state))
    acc.save_state(out_dir, sharded=True)
    saved = {
        "params": _numpy_tree(prepared.full_params()),
        "state": [x.detach().cpu().numpy().copy() for x in state_leaves(optimizer.state_dict()["opt_state"])],
        "files": sorted(os.listdir(out_dir)),
    }
    _reset()
    acc = Accelerator(device="cpu", compilation_config=CompilationConfig(flash_attention_min_seq=FLASH_MIN_SEQ))
    model = Llama(MODEL, device="cpu", seed=5)
    prepared = acc.prepare_model(model)
    optimizer = acc.prepare_optimizer(fused_adamw(LR))
    acc.load_state(jax_dir)
    loaded = {
        "params": _numpy_tree(prepared.full_params()),
        "state": [x.detach().cpu().numpy().copy() for x in state_leaves(optimizer.state_dict()["opt_state"])],
        "steps": optimizer.step_count,
    }
    _reset()
    return {"saved": saved, "loaded": loaded}


def suite(world_names: list, params: dict, batches: list, jax_dir=None, out_dir=None) -> dict:
    """Everything one launch checks, in one process per rank (a launch
    costs more than its work): the training configurations, the two sides
    of the update gate, the collectives, the loaders and, given
    directories, the checkpoints."""
    out = {f"train/{name}": train(name, params, batches) for name in world_names}
    out["gate/sharded"] = update_gate(None, params)
    out["gate/replicated"] = update_gate(0, params)
    out["collectives"] = collectives()
    out["loaders"] = loaders()
    if jax_dir is not None:
        out["checkpoints"] = checkpoints(params, batches, jax_dir, out_dir)
    return out


def fail_on_rank_one() -> None:
    """Process 1 raises; process 0 waits for it in a barrier that never ends."""
    state = PartialState(device="cpu")
    if state.process_index == 1:
        raise RuntimeError("rank 1 gives up")
    state.wait_for_everyone()



def gpu_pair(batches: list) -> dict:
    """Two processes sharing cuda:0 over gloo (NCCL refuses two processes on
    one card): llama-tiny bf16 through the flash kernels and fused adamw,
    3 steps under ZeRO over fsdp=2, then under FSDP stage 3 with
    ``cpu_offload``; the losses, each kernel's launches and where the
    offloaded state lives."""
    from datetime import timedelta

    from accelerate_tpu_torch import InitProcessGroupKwargs
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops.fused_adamw import adamw_leaf

    wrappers = {"flash_fwd": fa.flash_forward, "flash_dq": fa.flash_backward_dq,
                "flash_dkv": fa.flash_backward_dkv, "fused_adamw": adamw_leaf}
    out = {}
    for name, options in (("zero", dict(parallelism=ParallelismConfig(fsdp=2))),
                          ("offload", dict(fsdp_plugin=FullyShardedDataParallelPlugin(cpu_offload=True)))):
        _reset()
        acc = Accelerator(mixed_precision="bf16", device="cuda:0",
                          compilation_config=CompilationConfig(flash_attention_min_seq=FLASH_MIN_SEQ),
                          kwargs_handlers=[InitProcessGroupKwargs("gloo", timeout=timedelta(seconds=120))],
                          **options)
        model = Llama(MODEL, seed=0)
        prepared = acc.prepare_model(model)
        optimizer = acc.prepare_optimizer(fused_adamw(LR))
        step = acc.compiled_step(Llama.loss_fn(model))
        for wrapper in wrappers.values():
            wrapper.launches = 0
        rows = batches[0].shape[0] // 2
        r = acc.process_index
        losses = [float(step({"input_ids": torch.tensor(b[r * rows:(r + 1) * rows], device="cuda")}))
                  for b in batches]
        state = [x for x in state_leaves(optimizer.opt_state) if x.ndim]
        out[name] = {
            "losses": losses,
            "launches": {key: w.launches for key, w in wrappers.items()},
            "shard_leaves": len(tree_leaves(prepared.params)),
            "state_pinned_on_host": all(x.device.type == "cpu" and x.is_pinned() for x in state),
        }
    _reset()
    return out
