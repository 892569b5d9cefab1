"""The port's examples against the reference's: ``accelerate_tpu_torch/
examples/nlp_example.py`` (BERT on the bundled MRPC-like data) beside
``examples/nlp_example.py``, on the CPU in fp32.

The JAX example runs as it is, its ``Accelerator`` swapped for a subclass
that records the params ``prepare`` draws and each step's loss; the port's
example starts from those params and its loader yields the same batches in
the same order (seed 42). Tolerances, and why:
- per-step losses over one epoch (3 steps of 16, 16 and 4 rows): rtol 1e-5,
  the same products summed in other orders, then one or two Adam updates;
- the warmup-cosine schedule: rtol 1e-6 at every step, since ATen's and
  XLA's fp32 cosines differ by an ulp at some arguments (about 1 in 20 in a
  sweep of 2e5 values), and the formula is otherwise optax's, op for op."""

import importlib.util
import os

import numpy as np
import pytest

import jax
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch import warmup_cosine_decay_schedule
from accelerate_tpu_torch.examples import example_utils, nlp_example
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _reset():
    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "reference_nlp_example", os.path.join(REPO_ROOT, "examples", "nlp_example.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_data_is_the_reference_file():
    assert os.path.samefile(example_utils.DATA_PATH, os.path.join(REPO_ROOT, "examples", "data", "mrpc_tiny.csv"))
    dataset = example_utils.PairClassificationDataset(vocab_size=1024, max_len=64)
    train, evaluate = example_utils.train_eval_split(dataset)
    assert (len(dataset), len(train), len(evaluate)) == (48, 36, 12)


def test_nlp_example_prints_its_metric_line(capsys):
    _reset()
    metric = nlp_example.main(["--device", "cpu", "--num_epochs", "1"])
    out = capsys.readouterr().out
    assert f"epoch 0: {metric}" in out
    assert set(metric) == {"accuracy", "f1"} and 0.0 <= metric["accuracy"] <= 1.0


def test_nlp_example_losses_match_the_reference(monkeypatch):
    """One epoch of both examples from the JAX example's initial params."""
    reference = _jax_example()
    record = {"params": None, "losses": []}

    class RecordingAccelerator(JaxAccelerator):
        def prepare_model(self, model, params=None, device_placement=None):
            prepared = super().prepare_model(model, params, device_placement)
            record["params"] = jax.tree.map(np.asarray, prepared.params)
            return prepared

        def backward(self, loss_fn, batch=None, **kwargs):
            loss = super().backward(loss_fn, batch, **kwargs)
            record["losses"].append(float(loss))
            return loss

    monkeypatch.setattr(reference, "Accelerator", RecordingAccelerator)
    _reset()
    args = reference.parse_args(["--num_epochs", "1"])
    config = {"lr": args.lr, "num_epochs": 1, "seed": 42, "batch_size": args.batch_size}
    want_metric = reference.training_function(config, args)
    _reset()
    losses = []
    got_metric = nlp_example.training_function(
        config, nlp_example.parse_args(["--device", "cpu", "--num_epochs", "1"]),
        params=record["params"], losses=losses)
    assert len(losses) == len(record["losses"]) == 3
    np.testing.assert_allclose(losses, record["losses"], rtol=1e-5)
    assert got_metric == want_metric


@pytest.mark.parametrize("args", [(0.0, 1e-3, 1, 3), (0.0, 1e-3, 3, 9), (0.1, 2e-5, 10, 100, 1e-6),
                                  (0.0, 1e-3, 0, 5)], ids=["example", "warm3", "end-value", "no-warmup"])
def test_warmup_cosine_schedule_equals_optax(args):
    want = optax.warmup_cosine_decay_schedule(*args)
    got = warmup_cosine_decay_schedule(*args)
    steps = range(args[3] + 3)
    w = np.array([float(want(np.int32(c))) for c in steps], np.float32)
    for count in (lambda c: c, lambda c: torch.tensor(c, dtype=torch.int32)):
        g = np.array([float(got(count(c))) for c in steps], np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        warmup_cosine_decay_schedule(0.0, 1e-3, 5, 5)
