"""The distributed correctness checks ``accelerate-tpu-torch test`` runs.

Counterpart of ``accelerate_tpu/test_utils/scripts/test_script.py``, with its
checks: the collectives, RNG determinism and synchronisation, loader shard
exactness, training parity against a plain loop, gradient accumulation,
``gather_for_metrics``, the uneven end of an epoch, checkpoint resume,
``skip_first_batches``, ``sync_gradients``, triggers and process execution.
The model is a linear ``torch.nn.Module`` (``test_utils.training``), run on
``torch.distributed`` in every process ``launch`` started:

    accelerate-tpu-torch launch -m accelerate_tpu_torch.test_utils.scripts.test_script [--device cpu]

``--device`` (default ``cuda``: this process's card) is where the script
runs; ``--device cpu`` runs it on the CPU (gloo between processes), and a
named card (``cuda:0``) holds every process.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, GradientAccumulationPlugin, PartialState, ops, set_seed
from accelerate_tpu_torch.data_loader import BatchSampler, BatchSamplerShard, SequentialSampler
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.test_utils.training import SGD, RegressionDataset, RegressionModel
from accelerate_tpu_torch.utils.random import generator, synchronize_rng_states

_linear_loss = RegressionModel.loss_fn


class _Rows:
    """A dataset of ``{"x": i}`` rows, ``n`` of them."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return {"x": np.float32(i)}


def check_topology_and_ops(state):
    state.print(f"Topology: {state!r}")
    rows = 8
    full = np.arange(rows * state.num_processes, dtype=np.float32).reshape(-1, 1)
    local = full[state.process_index * rows:(state.process_index + 1) * rows]
    gathered = ops.gather(ops.send_to_device({"x": local}))
    assert np.array_equal(gathered["x"].cpu().numpy(), full), "gather roundtrip failed"

    total = ops.reduce({"v": np.ones(3, np.float32)}, "sum")
    assert np.allclose(total["v"], state.num_processes * np.ones(3)), "reduce sum failed"


def check_ops_coverage(state):
    """broadcast, broadcast_object_list, pad_across_processes, gather_object
    and reduce mean."""
    src = {"t": np.full((4,), float(state.process_index), np.float32)}
    b = ops.broadcast(ops.send_to_device(src))
    assert np.allclose(b["t"].cpu().numpy(), 0.0), "broadcast did not take rank 0's value"

    synced = ops.broadcast_object_list([f"rank-{state.process_index}", state.process_index])
    assert synced == ["rank-0", 0], f"broadcast_object_list: {synced}"

    ragged = torch.arange(3 + state.process_index, dtype=torch.float32, device=state.device)
    padded = ops.pad_across_processes(ragged, pad_index=-1.0)
    assert padded.shape[0] == 3 + state.num_processes - 1, padded.shape

    gathered = ops.gather_object([state.process_index])
    assert gathered == list(range(state.num_processes)), gathered

    mean = ops.reduce({"v": np.full(3, float(state.process_index + 1), np.float32)}, "mean")
    expected = np.mean([p + 1 for p in range(state.num_processes)])
    assert np.allclose(mean["v"], expected), "reduce mean failed"


def check_rng_determinism(state):
    """A seed gives the same draws again, on every process; after
    ``synchronize_rng_states`` processes seeded apart draw alike."""
    set_seed(123)
    k1 = torch.rand(4, generator=generator(state.device), device=state.device)
    set_seed(123)
    k2 = torch.rand(4, generator=generator(state.device), device=state.device)
    assert torch.equal(k1, k2), "seeded RNG not deterministic"
    draws = ops.gather_object([k1.cpu().tolist()])
    assert all(d == draws[0] for d in draws), f"the same seed drew differently across processes: {draws}"

    set_seed(7, device_specific=True)
    synchronize_rng_states()
    draws = ops.gather_object([(float(np.random.rand()), torch.rand(2).tolist())])
    assert all(d == draws[0] for d in draws), f"synchronize_rng_states left the processes apart: {draws}"


def check_dataloader_shard_exactness(state):
    """The union of every process's batches covers the dataset, and every
    process yields as many batches."""
    n, bs = 37, 4
    for even_batches in (True, False):
        shards = [
            list(
                BatchSamplerShard(
                    BatchSampler(SequentialSampler(n), batch_size=bs, drop_last=False),
                    num_processes=state.num_processes,
                    process_index=p,
                    even_batches=even_batches,
                )
            )
            for p in range(state.num_processes)
        ]
        if even_batches:
            assert len({len(s) for s in shards}) == 1, "uneven shard batch counts (desync/hang risk)"
        seen = {i for shard in shards for batch in shard for i in batch}
        assert seen == set(range(n)), f"shards dropped samples: {set(range(n)) - seen}"


def check_training_parity(accelerator):
    """The loop across processes equals a plain loop over the global
    batches, to float tolerance."""
    ds = RegressionDataset(length=64, seed=7)
    prepared, opt, loader = accelerator.prepare(RegressionModel(), SGD(0.1), ds)
    for epoch in range(2):
        loader.set_epoch(epoch)
        for batch in loader:
            accelerator.backward(_linear_loss, batch)
            opt.step()
            opt.zero_grad()
    dist_params = {k: float(v.detach()) for k, v in prepared.full_params().items()}

    params = {"a": torch.zeros((), requires_grad=True), "b": torch.zeros((), requires_grad=True)}
    bs = loader.total_batch_size
    for _ in range(2):
        for start in range(0, 64, bs):
            b = {"x": torch.from_numpy(ds.x[start:start + bs]), "y": torch.from_numpy(ds.y[start:start + bs])}
            grads = torch.autograd.grad(_linear_loss(params, b), list(params.values()))
            with torch.no_grad():
                for p, g in zip(params.values(), grads):
                    p -= 0.1 * g
    for key, value in dist_params.items():
        np.testing.assert_allclose(value, float(params[key].detach()), rtol=1e-4, atol=1e-5,
                                   err_msg=f"training parity diverged on {key}")


def check_gradient_accumulation(accelerator_factory):
    """accum=N over N microbatches equals one step on the concatenated batch."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32,)).astype(np.float32)
    y = (2 * x + 1).astype(np.float32)

    acc = accelerator_factory(4)
    model, opt = acc.prepare(RegressionModel(), SGD(0.1))
    for i in range(4):
        with acc.accumulate(model):
            acc.backward(_linear_loss, ops.send_to_device(
                {"x": x[i * 8:(i + 1) * 8], "y": y[i * 8:(i + 1) * 8]}, acc.device))
            opt.step()
            opt.zero_grad()
    accumulated = {k: float(v.detach()) for k, v in model.full_params().items()}

    acc2 = accelerator_factory(1)
    model2, opt2 = acc2.prepare(RegressionModel(), SGD(0.1))
    acc2.backward(_linear_loss, ops.send_to_device({"x": x, "y": y}, acc2.device))
    opt2.step()
    full = {k: float(v.detach()) for k, v in model2.full_params().items()}
    np.testing.assert_allclose(accumulated["a"], full["a"], rtol=1e-5)
    np.testing.assert_allclose(accumulated["b"], full["b"], rtol=1e-5)


def check_gather_for_metrics(accelerator):
    """The padded duplicates of the last batch are dropped."""
    n = accelerator.num_processes * 8 + 3  # an uneven tail
    loader = accelerator.prepare_data_loader(_Rows(n), batch_size=8)
    seen = [accelerator.gather_for_metrics(batch["x"]).cpu().numpy() for batch in loader]
    flat = np.concatenate(seen)
    assert len(flat) == n, f"gather_for_metrics kept {len(flat)} of {n} samples"
    assert set(flat.astype(int).tolist()) == set(range(n))


def check_uneven_end_of_epoch(accelerator):
    """``even_batches`` pads the end of an epoch by cycling from the start;
    the loader still reports the true dataset length."""
    n = accelerator.num_processes * 8 + 5
    loader = accelerator.prepare_data_loader(_Rows(n), batch_size=4)
    flat = np.concatenate([accelerator.gather(batch["x"]).cpu().numpy() for batch in loader])
    assert loader.total_dataset_length == n
    assert len(flat) % accelerator.num_processes == 0
    assert set(range(n)) <= set(flat.astype(int).tolist())


def check_checkpoint_resume(accelerator_factory):
    """save_state mid-training, load_state, and the same continuation."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(64,)).astype(np.float32)
    y = (3 * x - 1).astype(np.float32)

    from accelerate_tpu_torch.ops.fused_adamw import adamw

    acc = accelerator_factory(1)

    def batches():
        return [ops.send_to_device({"x": x[s:s + 8], "y": y[s:s + 8]}, acc.device) for s in range(0, 64, 8)]

    model, opt = acc.prepare(RegressionModel(), adamw(0.05, weight_decay=0.0))
    for batch in batches()[:4]:
        acc.backward(_linear_loss, batch)
        opt.step()
        opt.zero_grad()
    # every process reads process 0's directory (one host's filesystem)
    d = ops.broadcast_object_list([tempfile.mkdtemp() if acc.is_main_process else None])[0]
    try:
        ckpt = os.path.join(d, "ckpt")
        acc.save_state(ckpt)
        for batch in batches()[4:]:
            acc.backward(_linear_loss, batch)
            opt.step()
            opt.zero_grad()
        final_direct = {k: float(v.detach()) for k, v in model.full_params().items()}

        acc2 = accelerator_factory(1)
        model2, opt2 = acc2.prepare(RegressionModel(), adamw(0.05, weight_decay=0.0))
        acc2.load_state(ckpt)
        for batch in batches()[4:]:
            acc2.backward(_linear_loss, batch)
            opt2.step()
            opt2.zero_grad()
        final_resumed = {k: float(v.detach()) for k, v in model2.full_params().items()}
    finally:
        PartialState().wait_for_everyone()
        if PartialState().is_main_process:
            shutil.rmtree(d, ignore_errors=True)
    for key, value in final_direct.items():
        np.testing.assert_allclose(value, final_resumed[key], rtol=1e-5,
                                   err_msg=f"checkpoint resume diverged on {key}")


def check_skip_first_batches(accelerator):
    """skip_first_batches(k) yields exactly the loader's batches k..end."""
    loader = accelerator.prepare_data_loader(_Rows(accelerator.num_processes * 16), batch_size=4)
    all_batches = [b["x"].cpu().numpy() for b in loader]
    rest = [b["x"].cpu().numpy() for b in accelerator.skip_first_batches(loader, 2)]
    assert len(rest) == len(all_batches) - 2
    for a, b in zip(all_batches[2:], rest):
        np.testing.assert_array_equal(a, b)


def check_sync_gradients_flag(accelerator_factory):
    """sync_gradients turns at the accumulation boundary, and the optimizer
    steps only there."""
    acc = accelerator_factory(2)
    model, opt, sched = acc.prepare(RegressionModel(), SGD(0.01), lambda count: 0.01)
    flags = []
    for i in range(4):
        with acc.accumulate(model):
            acc.backward(_linear_loss, ops.send_to_device(
                {"x": np.asarray([1.0 * i], np.float32), "y": np.asarray([2.0 * i], np.float32)}, acc.device))
            flags.append(bool(acc.sync_gradients))
            opt.step()
            sched.step()
            opt.zero_grad()
    assert flags == [False, True, False, True], flags
    assert opt.step_count == 2, opt.step_count


def check_trigger(accelerator):
    """set_trigger/check_trigger: the breakpoint flag, reduced over processes."""
    assert not accelerator.check_trigger()
    if accelerator.is_main_process:
        accelerator.set_trigger()
    assert accelerator.check_trigger()  # every process sees the main one's flag
    assert not accelerator.check_trigger()  # reading resets it


def check_process_execution(state):
    """main_process_first ordering, the on_main_process decorator, splitting."""
    d = ops.broadcast_object_list([tempfile.mkdtemp() if state.is_main_process else None])[0]
    marker = os.path.join(d, "marker.txt")
    with state.main_process_first():
        if state.is_main_process:
            with open(marker, "w") as f:
                f.write("main was here")
        else:
            assert os.path.exists(marker), "a process ran before the main one"
    state.wait_for_everyone()
    if state.is_main_process:
        shutil.rmtree(d, ignore_errors=True)

    calls = []

    @state.on_main_process
    def only_main():
        calls.append("main")

    only_main()
    assert (len(calls) == 1) == state.is_main_process

    with state.split_between_processes(list(range(state.num_processes * 2))) as piece:
        assert len(piece) == 2


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Distributed correctness checks of the port.")
    parser.add_argument("--device", default="cuda",
                        help="Where every process runs: cuda (its own card, the default), a card "
                             "(cuda:0: every process on it) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    state = PartialState(device=None if args.device == "cuda" else args.device)
    check_topology_and_ops(state)
    check_ops_coverage(state)
    check_rng_determinism(state)
    check_dataloader_shard_exactness(state)
    check_process_execution(state)

    def fresh_accelerator(accum_steps: int = 1) -> Accelerator:
        AcceleratorState._reset_state()
        GradientState._reset_state()
        PartialState._reset_state()
        set_seed(0)
        return Accelerator(
            device=None if args.device == "cuda" else args.device,
            gradient_accumulation_plugin=GradientAccumulationPlugin(num_steps=accum_steps,
                                                                    sync_with_dataloader=False),
        )

    check_training_parity(fresh_accelerator())
    check_gradient_accumulation(fresh_accelerator)
    check_gather_for_metrics(fresh_accelerator())
    check_uneven_end_of_epoch(fresh_accelerator())
    check_checkpoint_resume(fresh_accelerator)
    check_skip_first_batches(fresh_accelerator())
    check_sync_gradients_flag(fresh_accelerator)
    check_trigger(fresh_accelerator())

    PartialState().print("All distributed correctness checks passed.")


if __name__ == "__main__":
    main()
