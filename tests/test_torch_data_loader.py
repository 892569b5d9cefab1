"""The port's data loader (``accelerate_tpu_torch/data_loader.py``) against
the JAX package's (``accelerate_tpu/data_loader.py``, oracle
``tests/test_data_loader.py``) on the CPU.

Each dataset row holds its own index, so a batch names the rows it holds:
the two loaders must yield the same indices in the same order, batch for
batch, over shuffles of every (seed, epoch) tried, ``drop_last``,
``even_batches``, ``split_batches``, iterable datasets, ``dispatch_batches``,
a torch ``DataLoader`` and ``skip_first_batches``, with the same
``end_of_dataloader`` and ``remainder`` flags. Comparisons are exact: the
loaders move integers. The JAX package runs one process over its 8-device
virtual CPU mesh, the port one process on the CPU."""

import os
import threading

import numpy as np
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import data_loader as jax_dl
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch import data_loader as dl
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState


@pytest.fixture(autouse=True)
def cpu_state():
    """Fresh singletons of both packages, the port's on the CPU."""
    for cls in (JaxAcceleratorState, JaxGradientState, JaxPartialState, AcceleratorState, GradientState,
                PartialState):
        cls._reset_state()
    PartialState(device="cpu")
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


class Rows:
    """A map-style dataset whose row ``i`` is ``{"i": i, "x": [i, 2i, 3i]}``."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.array([i, 2 * i, 3 * i], np.float32)}


class Stream:
    """An iterable dataset (no ``__len__``) of ``n`` such rows."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return (Rows(self.n)[i] for i in range(self.n))


def _indices(batch):
    return np.asarray(batch["i"]).tolist()


def _epochs(loader, epochs):
    """Per epoch, per batch: (indices, end_of_dataloader, remainder)."""
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.append([(_indices(b), loader.end_of_dataloader, loader.remainder) for b in loader])
    return out


LOADER_CASES = {
    "sequential": dict(n=37, batch_size=4),
    "shuffle_seed42": dict(n=37, batch_size=4, shuffle=True, seed=42),
    "shuffle_seed7": dict(n=64, batch_size=8, shuffle=True, seed=7),
    "drop_last": dict(n=37, batch_size=4, shuffle=True, seed=3, drop_last=True),
    "uneven_batches": dict(n=37, batch_size=4, shuffle=True, seed=42, even_batches=False),
    "split_batches": dict(n=37, batch_size=4, shuffle=True, seed=1, split_batches=True),
    "split_uneven": dict(n=37, batch_size=4, split_batches=True, even_batches=False),
    "exact": dict(n=32, batch_size=8, shuffle=True, seed=0),
}


@pytest.mark.parametrize("case", list(LOADER_CASES.values()), ids=list(LOADER_CASES))
def test_map_loader_matches_jax_index_for_index(case):
    """Epochs 0, 1 and 5: the same indices batch for batch, the same flags."""
    case = dict(case)
    n = case.pop("n")
    want = _epochs(jax_dl.prepare_data_loader(Rows(n), prefetch=0, **case), (0, 1, 5))
    got = _epochs(dl.prepare_data_loader(Rows(n), prefetch=0, **case), (0, 1, 5))
    assert got == want
    assert all(epoch[-1][1] for epoch in got)  # the last batch of an epoch carries the flag


@pytest.mark.parametrize("kind", ["iterable", "iterable_drop_last", "dispatch", "dispatch_drop_last",
                                  "dispatch_short", "torch_dataloader"])
def test_other_sources_match_jax(kind):
    """An iterable dataset (its last partial batch padded from the first,
    or dropped), ``dispatch_batches`` at one process (the same padding or
    dropping; a stream shorter than one batch padded from itself), and a
    torch ``DataLoader`` whose batch size and shuffle the loader takes over."""
    if kind.startswith("iterable"):
        make = lambda prep: prep(Stream(23), batch_size=4, drop_last=kind.endswith("drop_last"), prefetch=0)  # noqa: E731
    elif kind.startswith("dispatch"):
        rows = 3 if kind == "dispatch_short" else 23
        make = lambda prep: prep(Stream(rows), batch_size=4, dispatch_batches=True,  # noqa: E731
                                 drop_last=kind.endswith("drop_last"))
    else:
        data = [Rows(30)[i] for i in range(30)]
        make = lambda prep: prep(torch.utils.data.DataLoader(data, batch_size=4, shuffle=True), seed=9,  # noqa: E731
                                 prefetch=0)
    want = _epochs(make(jax_dl.prepare_data_loader), (0, 2))
    got = _epochs(make(dl.prepare_data_loader), (0, 2))
    assert got == want


@pytest.mark.parametrize("skip", [0, 3, 9])
def test_skip_first_batches_matches_jax(skip):
    """Mid-epoch resume: the same batches after ``skip``, and ``position``
    counts the skipped ones."""
    jax_loader = jax_dl.prepare_data_loader(Rows(37), batch_size=4, shuffle=True, seed=42, prefetch=0)
    loader = dl.prepare_data_loader(Rows(37), batch_size=4, shuffle=True, seed=42, prefetch=0)
    jax_loader.set_epoch(2)
    loader.set_epoch(2)
    want = [_indices(b) for b in jax_dl.skip_first_batches(jax_loader, skip)]
    skipped = dl.skip_first_batches(loader, skip)
    got = [_indices(b) for b in skipped]
    assert got == want and len(got) == 10 - skip
    assert skipped.position == 10


def test_skip_data_loader_over_an_iterable_matches_jax_and_reports_the_rewind(monkeypatch):
    calls = []
    monkeypatch.setattr(dl, "rewind_seconds_hook", lambda seconds, batches: calls.append(batches))
    want = [_indices(b) for b in jax_dl.skip_first_batches(
        jax_dl.prepare_data_loader(Stream(23), batch_size=4, prefetch=0), 2)]
    skipped = dl.skip_first_batches(dl.prepare_data_loader(Stream(23), batch_size=4, prefetch=0), 2)
    assert [_indices(b) for b in skipped] == want and skipped.position == 6
    assert calls == [2]


def test_batches_are_tensors_on_the_loaders_device():
    loader = dl.prepare_data_loader(Rows(10), batch_size=4, device="cpu")
    batch = next(iter(loader))
    assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"
    assert batch["x"].dtype == torch.float32 and batch["i"].dtype == torch.int64
    np.testing.assert_array_equal(batch["x"].numpy()[:, 1], 2 * np.arange(4))


@pytest.mark.parametrize("prefetch", [1, 3])
def test_prefetch_equals_no_prefetch(prefetch):
    """The same batches, bit for bit, and the end-of-epoch flag flips only
    as the last batch is handed out."""
    base = dl.prepare_data_loader(Rows(37), batch_size=4, shuffle=True, seed=42, prefetch=0)
    ahead = dl.prepare_data_loader(Rows(37), batch_size=4, shuffle=True, seed=42, prefetch=prefetch)
    for loader in (base, ahead):
        loader.set_epoch(1)
    want = [(b["x"].clone(), base.end_of_dataloader) for b in base]
    got = [(b["x"].clone(), ahead.end_of_dataloader) for b in ahead]
    assert len(got) == len(want) == 10
    for (x, flag), (y, want_flag) in zip(got, want):
        assert torch.equal(x, y) and flag == want_flag


def test_prefetch_raises_dataset_errors_and_stops_its_thread():
    class Broken(Rows):
        def __getitem__(self, i):
            if i >= 4:
                raise RuntimeError("boom at row 4")
            return super().__getitem__(i)

    with pytest.raises(RuntimeError, match="boom"):
        list(dl.prepare_data_loader(Broken(8), batch_size=4, prefetch=2))
    it = iter(dl.prepare_data_loader(Rows(64), batch_size=4, prefetch=2))
    next(it)
    it.close()
    alive = [t for t in threading.enumerate() if t.name == "accelerate-tpu-torch-prefetch" and t.is_alive()]
    assert not alive


def _accumulation_trace(acc, make_loader):
    loader = make_loader(acc)
    syncs, gathered = [], []
    for batch in loader:
        with acc.accumulate():
            syncs.append(acc.sync_gradients)
        gathered.append(np.asarray(acc.gather_for_metrics(batch["i"])).tolist())
    return syncs, gathered


def test_end_of_dataloader_closes_the_window_and_trims_metrics_like_jax():
    """Accumulation 4 over 7 micro-batches (26 rows, batch 4): the windows
    close at micro-batch 4 and, through the end of the loader, at 7, as the
    JAX ``Accelerator`` closes them; ``gather_for_metrics`` drops the rows
    the even-batch padding repeated in the last batch."""
    make = lambda acc: acc.prepare_data_loader(Rows(26), batch_size=4, shuffle=True, seed=42)  # noqa: E731
    want = _accumulation_trace(JaxAccelerator(gradient_accumulation_steps=4), make)
    got = _accumulation_trace(Accelerator(gradient_accumulation_steps=4, device="cpu"), make)
    assert got == want
    assert got[0] == [False, False, False, True, False, False, True]
    assert len(got[1][-1]) == 26 % 4


def test_prepare_registers_each_loader_once_and_keeps_positions():
    acc = Accelerator(device="cpu")
    loader = acc.prepare_data_loader(Rows(12), batch_size=4)
    assert acc.prepare(loader) is loader and acc._dataloaders == [loader]
    batches = iter(loader)
    next(batches)
    assert loader.position == 1
    batches.close()


OPS_CASES = {
    "find_batch_size": lambda ops, t: ops.find_batch_size(t),
    "concatenate": lambda ops, t: ops.concatenate([t, t]),
    "pad_input_tensors": lambda ops, t: ops.pad_input_tensors(t, batch_size=5, num_processes=4),
    "convert_to_fp32": lambda ops, t: ops.convert_to_fp32(t),
    "slice_tensors": lambda ops, t: ops.slice_tensors(t, slice(1, 3)),
    "reduce_sum": lambda ops, t: ops.reduce(t, reduction="sum", scale=2.0),
}


def _values(tree):
    """Leaves as float64 numpy (bf16 values are exact there), containers
    as dicts and lists."""
    if isinstance(tree, dict):
        return {k: _values(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_values(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        tree = tree.double().numpy()
    return np.asarray(tree, np.float64)


@pytest.mark.parametrize("op", list(OPS_CASES), ids=list(OPS_CASES))
def test_operations_match_jax_at_one_process(op):
    """The tree operations on a batch of 5 rows, the port on torch tensors
    (bf16 leaf included) and JAX's on numpy: the same values and types."""
    import ml_dtypes

    from accelerate_tpu.ops import operations as jax_ops
    from accelerate_tpu_torch.ops import operations as ops

    x = np.arange(20, dtype=np.float32).reshape(5, 4)
    jax_tree = {"x": x, "y": (x[:, 0].astype(ml_dtypes.bfloat16), np.arange(5, dtype=np.int32))}
    port_tree = {"x": torch.tensor(x), "y": (torch.tensor(x[:, 0]).bfloat16(), torch.arange(5, dtype=torch.int32))}
    want, got = OPS_CASES[op](jax_ops, jax_tree), OPS_CASES[op](ops, port_tree)
    np.testing.assert_equal(_values(got), _values(want))


def test_send_to_device_and_to_numpy():
    from accelerate_tpu_torch.ops import operations as ops

    tree = {"a": np.arange(3, dtype=np.int32), "b": [torch.ones(2, dtype=torch.bfloat16)], "s": np.array(["t"])}
    placed = ops.send_to_device(tree, "cpu", skip_keys="s")
    assert isinstance(placed["a"], torch.Tensor) and placed["s"] is tree["s"]
    back = ops.to_numpy(placed)
    assert back["b"][0].dtype == np.float32 and back["a"].tolist() == [0, 1, 2]


def test_logger_stamps_the_process_and_logs_on_the_main_one(caplog):
    from accelerate_tpu_torch.logging import get_logger

    logger = get_logger("accelerate_tpu_torch.test")
    with caplog.at_level("INFO", logger="accelerate_tpu_torch.test"):
        logger.info("hello", main_process_only=True)
        logger.info("in turn", in_order=True)
    assert [r.getMessage() for r in caplog.records] == ["hello", "in turn"]
    assert all(r.process_index == 0 and r.local_process_index == 0 for r in caplog.records)


@pytest.mark.parametrize("method, item", [("init_trackers", "item 19"), ("log", "item 19"),
                                          ("profile", "item 19"), ("analyze", "item 21"),
                                          ("elastic_coordinator", "item 18")])
def test_accelerator_methods_of_later_slices_name_their_item(method, item, tmp_path):
    """A method of a slice still to come raises NotImplementedError naming
    its ROADMAP item; item 19's (trackers, profile) and item 18's elastic
    coordinator are in the port now and run on the CPU (the coordinator
    needs a prepared model and optimizer; one process builds it, with
    nothing to shrink onto)."""
    acc = Accelerator(device="cpu", project_dir=str(tmp_path))
    if method == "elastic_coordinator":
        from accelerate_tpu_torch import Llama, fused_adamw

        with pytest.raises(ValueError, match="prepared model"):
            acc.elastic_coordinator(lambda params, batch: 0.0)
        model = Llama("llama-tiny", device="cpu")
        acc.prepare_model(model)
        acc.prepare_optimizer(fused_adamw(1e-3))
        coordinator = acc.elastic_coordinator(Llama.loss_fn(model))
        assert coordinator.members == [0] and coordinator._buddy is None  # one host: the mirror stands down
    elif item != "item 19":
        with pytest.raises(NotImplementedError, match=item):
            getattr(acc, method)()
    elif method == "profile":
        with acc.profile(str(tmp_path / "trace")):
            torch.ones(4) @ torch.ones(4)
        assert os.path.exists(tmp_path / "trace" / "trace.json")
    else:
        acc.init_trackers("proj")
        if method == "log":
            acc.log({"loss": 1.0}, step=0)
        assert acc.trackers == []  # no log_with: nothing to log to


def test_prepare_refuses_a_loss_function_for_a_schedule():
    acc = Accelerator(device="cpu")
    with pytest.raises(TypeError, match="schedule takes one"):
        acc.prepare(lambda params, batch: 0.0)
    assert acc.prepare(lambda count: 1e-3).get_last_lr() == [1e-3]
