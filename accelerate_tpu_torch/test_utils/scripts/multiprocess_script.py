"""The checks that need several real processes, run by ``launch``.

Counterpart of ``accelerate_tpu/test_utils/scripts/multiprocess_script.py``:
the world size the launcher gave, object broadcast, gather across
processes, training that leaves every process with the params of the plain
loop of one process over the same global batches, the dispatcher's stream
order, ``gather_for_metrics``, a checkpoint round trip across processes,
the sharded checkpoint format, and the telemetry hub's aggregation and
flush:

    accelerate-tpu-torch launch --num_processes 2 \\
        -m accelerate_tpu_torch.test_utils.scripts.multiprocess_script [--device cpu] [--backend gloo]

``--device`` (default ``cuda``: each process's own card) is where each
process runs (``cuda:0``: every process on that card; ``cpu``);
``--backend`` picks the process group's (default: NCCL on the cards, gloo
on the CPU). Two processes share one card only over gloo
(``--device cuda:0 --backend gloo``): NCCL refuses it. The main process
prints one JSON line: the world size, every rank and its device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, InitProcessGroupKwargs, PartialState, ops, set_seed
from accelerate_tpu_torch.checkpointing import load_model_weights_sharded, save_model_weights_sharded
from accelerate_tpu_torch.test_utils.training import SGD, RegressionModel


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Checks of the port across real processes.")
    parser.add_argument("--device", default="cuda",
                        help="Where every process runs: cuda (its own card, the default), a card "
                             "(cuda:0: every process on it) or cpu")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="The process group's backend (default: nccl on the cards, gloo on the CPU)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = None if args.device == "cuda" else args.device
    init = [InitProcessGroupKwargs(backend=args.backend)] if args.backend else []
    accelerator = Accelerator(device=device, kwargs_handlers=init)
    state = PartialState()
    expected = int(os.environ["ACCELERATE_NUM_PROCESSES"])
    assert state.num_processes == expected > 1, (state.num_processes, expected)
    assert torch.distributed.get_world_size() == expected

    # object broadcast: every process sees rank 0's payload
    payload = [{"token": "rank0-secret", "pid": state.process_index}] if state.is_main_process else [None]
    received = ops.broadcast_object_list(payload)
    assert received[0]["token"] == "rank0-secret", received

    # every process's rows, gathered in process order
    local = np.full((4, 2), state.process_index, np.float32)
    gathered = ops.gather(ops.send_to_device({"x": local}))["x"].cpu().numpy()
    assert gathered.shape[0] == 4 * state.num_processes
    assert sorted(set(gathered[:, 0].astype(int).tolist())) == list(range(state.num_processes))

    # training: every process runs the same loop, and the replicated params
    # come out identical on every process
    set_seed(0)
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(64,)).astype(np.float32)

    class DS:
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return {"x": xs[i], "y": np.float32(2 * xs[i] + 1)}

    model, opt, loader = accelerator.prepare(RegressionModel(), SGD(0.1), DS())
    for epoch in range(3):
        loader.set_epoch(epoch)
        for batch in loader:
            accelerator.backward(RegressionModel.loss_fn, batch)
            opt.step()
            opt.zero_grad()
    params = {k: float(v.detach()) for k, v in model.full_params().items()}
    assert all(np.isfinite(v) for v in params.values())
    views = ops.gather_object([params])
    assert all(v == views[0] for v in views), views
    assert abs(params["a"] - 2.0) < 0.5 and abs(params["b"] - 1.0) < 0.5, params
    # ... and equal the plain loop of one process over the same global
    # batches: a gradient summed over the processes, not averaged, fails here
    plain = {"a": torch.zeros((), requires_grad=True), "b": torch.zeros((), requires_grad=True)}
    size = loader.total_batch_size
    assert len(xs) % size == 0, (len(xs), size)
    for _ in range(3):
        for start in range(0, len(xs), size):
            x = torch.from_numpy(xs[start:start + size])
            grads = torch.autograd.grad(RegressionModel.loss_fn(plain, {"x": x, "y": 2 * x + 1}), list(plain.values()))
            with torch.no_grad():
                for p, g in zip(plain.values(), grads):
                    p -= 0.1 * g
    for key, value in params.items():
        np.testing.assert_allclose(value, float(plain[key].detach()), rtol=1e-5,
                                   err_msg=f"{state.num_processes} processes' training left the plain loop on {key}")

    # the dispatcher: process 0 reads the stream, and each process gets its
    # slice of every batch in stream order
    def stream():
        for i in range(22):  # not a multiple of the global batch
            yield {"x": np.float32(i)}

    dispatcher = accelerator.prepare_data_loader(stream(), batch_size=4, dispatch_batches=True)
    flat = np.concatenate([ops.gather(batch["x"]).cpu().numpy().ravel() for batch in dispatcher])
    assert flat[:20].astype(int).tolist() == list(range(20)), flat[:20]
    assert set(range(22)) <= set(flat.astype(int).tolist()), sorted(set(flat.astype(int)))

    # gather_for_metrics drops the duplicated tail exactly
    n = state.num_processes * 8 + 3

    class Rows:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"x": np.float32(i)}

    seen = [accelerator.gather_for_metrics(batch["x"]).cpu().numpy()
            for batch in accelerator.prepare_data_loader(Rows(), batch_size=8)]
    flat2 = np.concatenate(seen)
    assert len(flat2) == n and set(flat2.astype(int).tolist()) == set(range(n)), (len(flat2), n)

    # a checkpoint round trip: saved by the main process, read by every one
    d = ops.broadcast_object_list([tempfile.mkdtemp() if state.is_main_process else None])[0]
    try:
        ckpt = os.path.join(d, "ckpt")
        accelerator.save_state(ckpt)
        saved = {k: float(v.detach()) for k, v in model.full_params().items()}
        with torch.no_grad():
            for leaf in model.params.values():
                leaf.add_(1.0)
        accelerator.load_state(ckpt)
        restored = {k: float(v.detach()) for k, v in model.full_params().items()}
        assert restored == saved, (saved, restored)
        views = ops.gather_object([restored])
        assert all(v == views[0] for v in views), views
    finally:
        state.wait_for_everyone()
        if state.is_main_process:
            shutil.rmtree(d, ignore_errors=True)

    # the sharded checkpoint format across processes: whole params (no
    # layout) are written once, by the main process, behind a barrier, and
    # every process reads the tensor back from its chunks
    full = {"w": np.arange(16 * 8, dtype=np.float32).reshape(16, 8)}
    d2 = ops.broadcast_object_list([tempfile.mkdtemp() if state.is_main_process else None])[0]
    try:
        save_model_weights_sharded({"w": torch.from_numpy(full["w"]).to(state.device)}, d2)
        state.wait_for_everyone()
        loaded = load_model_weights_sharded(d2)
        np.testing.assert_array_equal(loaded["w"], full["w"])
    finally:
        state.wait_for_everyone()
        if state.is_main_process:
            shutil.rmtree(d2, ignore_errors=True)

    # telemetry across processes: each process's value comes back as the
    # job's min/max/mean on every process, and the flush writes one record,
    # from the main process
    agg = state.aggregate_metrics({"per_host": float(state.process_index), "same": 7.0})
    count = state.num_processes
    assert agg["per_host"] == {"min": 0.0, "max": float(count - 1), "mean": (count - 1) / 2}, agg
    assert agg["same"]["min"] == agg["same"]["max"] == 7.0, agg
    d3 = ops.broadcast_object_list([tempfile.mkdtemp() if state.is_main_process else None])[0]
    try:
        from accelerate_tpu_torch.telemetry import Telemetry, TelemetryConfig

        telemetry = Telemetry(accelerator=accelerator, config=TelemetryConfig(sample_every=2, dir=d3))
        batch = ops.send_to_device({"x": np.ones(4, np.float32), "y": np.ones(4, np.float32)}, accelerator.device)
        for _ in range(4):
            telemetry.step(accelerator.backward(RegressionModel.loss_fn, batch))
        record = telemetry.flush()  # a collective: every process calls it
        assert record["aggregate"]["steps"]["min"] == 4.0, record["aggregate"]["steps"]
        telemetry.finish()
        state.wait_for_everyone()
        if state.is_main_process:
            with open(os.path.join(d3, "telemetry.jsonl")) as f:
                lines = [json.loads(line) for line in f]
            assert lines and lines[0]["metrics"]["steps"] == 4, lines
    finally:
        state.wait_for_everyone()
        if state.is_main_process:
            shutil.rmtree(d3, ignore_errors=True)

    # one line, from the main process: lines the processes print at once may interleave
    views = ops.gather_object([(state.process_index, str(state.device))])
    state.print(json.dumps({"multiprocess_ok": True, "processes": state.num_processes,
                            "ranks": [rank for rank, _ in views], "devices": [device for _, device in views],
                            "backend": state.backend}), flush=True)


if __name__ == "__main__":
    main()
