"""The port's trackers against the JAX package's, on the CPU: the JSONL
round trip (the same lines as the JAX tracker's for the same calls, but for
the wall-clock ``_time``), TensorBoard event files, name resolution,
``Accelerator.log`` fan-out, and the telemetry hub's flush into the
trackers. wandb, mlflow, comet_ml, aim, clearml and dvclive are not
installed here: requested, they are skipped with a warning, as in the JAX
package."""

import glob
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accelerate_tpu.tracking import JSONLTracker as JaxJSONLTracker
from accelerate_tpu.tracking import _available_trackers as jax_available_trackers
from accelerate_tpu.tracking import dumps_robust as jax_dumps_robust
from accelerate_tpu_torch import Accelerator, TelemetryConfig
from accelerate_tpu_torch.tracking import (
    GeneralTracker,
    JSONLTracker,
    TensorBoardTracker,
    _available_trackers,
    dumps_robust,
    filter_trackers,
)
from accelerate_tpu_torch.utils import ProjectConfiguration, is_tensorboard_available, is_wandb_available


class MockTracker(GeneralTracker):
    name = "mock"
    requires_logging_directory = False

    def __init__(self):
        self.config = None
        self.logged = []
        self.finished = False

    def store_init_configuration(self, values):
        self.config = values

    def log(self, values, step=None, **kwargs):
        self.logged.append((values, step))

    def finish(self):
        self.finished = True


def _lines(path):
    return [json.loads(line) for line in open(path)]


def _untimed(lines):
    return [{k: v for k, v in line.items() if k != "_time"} for line in lines]


def test_jsonl_tracker_roundtrip_equals_the_jax_trackers(tmp_path):
    for cls, name in ((JSONLTracker, "port"), (JaxJSONLTracker, "jax")):
        tracker = cls("run1", logging_dir=str(tmp_path / name))
        tracker.store_init_configuration({"lr": 0.1})
        tracker.log({"loss": 1.5}, step=0)
        tracker.log({"loss": 0.5, "acc": 0.9}, step=1)
        tracker.finish()
    got = _lines(tmp_path / "port" / "run1" / "metrics.jsonl")
    want = _lines(tmp_path / "jax" / "run1" / "metrics.jsonl")
    assert _untimed(got) == _untimed(want)
    assert got[0]["_config"] == {"lr": 0.1}
    assert got[1] == {"loss": 1.5, "_step": 0, "_time": got[1]["_time"]}


def test_jsonl_tracker_coerces_tensors_and_scalars_and_fsyncs(tmp_path):
    tracker = JSONLTracker("run", logging_dir=str(tmp_path))
    tracker.log(
        {
            "torch_scalar": torch.tensor(1.5),
            "np_scalar": np.float64(2.5),
            "np_int": np.int64(7),
            "arr": np.arange(3),
            "tensor": torch.arange(3),
            "weird": {("a", "b"): 1},  # tuple key: unserializable structure
        },
        step=0,
    )
    tracker.finish()
    tracker.finish()  # a second finish does not raise
    [line] = _lines(tmp_path / "run" / "metrics.jsonl")
    assert line["torch_scalar"] == 1.5  # a NUMBER, not the string "1.5"
    assert line["np_scalar"] == 2.5 and line["np_int"] == 7
    assert line["arr"] == [0, 1, 2] and line["tensor"] == [0, 1, 2]
    assert line["weird"] == {"('a', 'b')": 1}
    record = {"a": np.float32(0.25), "b": [np.int32(3)], "c": {("x", 1): "y"}}
    assert dumps_robust(record) == jax_dumps_robust(record)
    assert json.loads(dumps_robust({"s": torch.tensor(2.0)})) == json.loads(jax_dumps_robust({"s": jnp.float32(2.0)}))


def test_tensorboard_tracker_writes_event_files(tmp_path):
    assert is_tensorboard_available()
    tracker = TensorBoardTracker("run1", logging_dir=str(tmp_path))
    tracker.store_init_configuration({"lr": 0.1, "epochs": 2})
    tracker.log({"loss": 1.0, "note": "hello", "grouped": {"a": 1.0, "b": 2.0}}, step=0)
    tracker.finish()
    assert glob.glob(str(tmp_path / "run1" / "events.out.tfevents.*"))
    assert json.load(open(tmp_path / "run1" / "hparams.json")) == {"lr": 0.1, "epochs": 2}


def test_filter_trackers_resolution(tmp_path):
    trackers = filter_trackers("all", str(tmp_path), "proj", config={"x": 1})
    names = {t.name for t in trackers}
    assert "jsonl" in names and "tensorboard" in names
    assert "comet_ml" not in names and "aim" not in names  # not installed: skipped
    assert json.loads(open(tmp_path / "proj" / "metrics.jsonl").readline())["_config"] == {"x": 1}
    for tracker in trackers:
        tracker.finish()


def test_filter_trackers_unknown_raises():
    with pytest.raises(ValueError, match="Unknown tracker"):
        filter_trackers("not-a-tracker", None, "proj")


def test_filter_trackers_instance_passthrough():
    mock = MockTracker()
    assert filter_trackers([mock], None, "proj", config={"seed": 1}) == [mock]
    assert mock.config == {"seed": 1}


def test_filter_trackers_requested_but_missing_skips(tmp_path):
    assert not is_wandb_available()
    trackers = filter_trackers(["comet_ml", "wandb", "jsonl"], str(tmp_path), "proj")
    assert [t.name for t in trackers] == ["jsonl"]


def test_accelerator_log_fans_out(tmp_path):
    mock = MockTracker()
    acc = Accelerator(
        device="cpu", log_with=[mock],
        project_config=ProjectConfiguration(project_dir=str(tmp_path), logging_dir=str(tmp_path)),
    )
    acc.init_trackers("proj", {"lr": 3e-4})
    assert mock.config == {"lr": 3e-4}
    acc.log({"loss": 0.1}, step=5)
    acc.log({"loss": 0.05}, step=6)
    assert mock.logged == [({"loss": 0.1}, 5), ({"loss": 0.05}, 6)]
    assert acc.get_tracker("mock") is mock
    with pytest.raises(ValueError, match="not an active tracker"):
        acc.get_tracker("jsonl")
    acc.end_training()
    assert mock.finished


def test_telemetry_flush_fans_out_to_the_jsonl_tracker(tmp_path):
    """The hub's flush logs its scalar metrics as ``telemetry/<name>`` through
    ``Accelerator.log``; ``end_training`` flushes once and closes the
    tracker."""
    acc = Accelerator(device="cpu", log_with="jsonl", project_dir=str(tmp_path),
                      telemetry_config=TelemetryConfig(sample_every=2, dir=str(tmp_path)))
    acc.init_trackers("proj", {"lr": 1e-3})
    for _ in range(4):
        acc.telemetry.step(torch.ones(()))
    acc.log({"loss": 0.5}, step=4)
    acc.end_training()
    lines = _lines(tmp_path / "proj" / "metrics.jsonl")
    assert lines[0]["_config"] == {"lr": 1e-3} and lines[1]["loss"] == 0.5
    assert lines[2]["_step"] == 4 and lines[2]["telemetry/steps"] == 4
    assert "telemetry/step_time_p50_ms" in lines[2]
    assert acc.get_tracker("jsonl", unwrap=True)._file.closed


def test_log_images_fallback_warns_not_crashes():
    MockTracker().log_images({"img": None})  # the base class's fallback: a warning, no error


def test_trackers_registered_as_in_the_jax_package():
    for name in ("tensorboard", "wandb", "mlflow", "comet_ml", "aim", "clearml", "dvclive", "jsonl"):
        assert name in _available_trackers
    assert set(_available_trackers) == set(jax_available_trackers)
