"""Experiment trackers.

Counterpart of ``accelerate_tpu/tracking.py``: ``GeneralTracker`` with
``requires_logging_directory`` / ``main_process_only`` / the lifecycle
(``store_init_configuration``, ``log``, ``finish``), the concrete trackers,
and ``filter_trackers``. wandb, mlflow, comet_ml, aim, clearml and dvclive
run only where their package is installed (``utils/imports.py``); nothing
is installed for them. ``JSONLTracker`` needs nothing and is the tracker
that runs where none of them, nor tensorboard, is present.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from .logging import get_logger
from .state import job_process_index
from .utils.imports import (
    is_aim_available,
    is_clearml_available,
    is_comet_ml_available,
    is_dvclive_available,
    is_mlflow_available,
    is_tensorboard_available,
    is_wandb_available,
)

logger = get_logger(__name__)


def json_default(obj: Any):
    """``json.dumps(default=...)`` coercion for the values telemetry and
    training loops actually log: torch/numpy scalars become numbers (not the
    strings ``default=str`` produced), small arrays and tensors become lists,
    everything else degrades to ``str`` so a sink never crashes a run. A
    tensor on the card is read to the host here: log host values in a hot
    loop."""
    import numpy as np

    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        try:
            return obj.item()  # 0-d tensors and friends
        except Exception:
            pass
    if hasattr(obj, "tolist"):
        try:
            return obj.tolist()  # small tensors
        except Exception:
            pass
    if isinstance(obj, (set, frozenset)):
        return sorted(str(v) for v in obj)
    return str(obj)


def coerce_jsonable(obj: Any) -> Any:
    """Deep-coerce a tree into plain JSON types (keys stringified) — the
    fallback for payloads ``json.dumps(default=json_default)`` still rejects,
    e.g. tuple-keyed dicts or NaN-free encoders."""
    if isinstance(obj, dict):
        return {str(k): coerce_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [coerce_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj
    coerced = json_default(obj)
    return coerce_jsonable(coerced) if isinstance(coerced, (dict, list, tuple)) else coerced


def dumps_robust(record: Any) -> str:
    """Serialize ``record`` without ever raising: numeric coercion first,
    deep sanitization if the structure itself is unserializable."""
    try:
        return json.dumps(record, default=json_default)
    except (TypeError, ValueError):
        return json.dumps(coerce_jsonable(record), default=str)


_available_trackers: dict[str, type] = {}


def register_tracker(cls):
    _available_trackers[cls.name] = cls
    return cls


def on_main_process(method):
    def wrapper(self, *args, **kwargs):
        if not getattr(self, "main_process_only", True) or job_process_index() == 0:
            return method(self, *args, **kwargs)

    return wrapper


class GeneralTracker:
    """Base tracker API (reference tracking.py:91-163)."""

    name: str = "general"
    requires_logging_directory: bool = False
    main_process_only: bool = True

    def store_init_configuration(self, values: dict) -> None:
        raise NotImplementedError

    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        raise NotImplementedError

    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """{name: HWC/NHWC array} (reference WandBTracker.log_images, :339).
        Optional — trackers without image support log a warning once."""
        logger.warning_once(f"Tracker {self.name} does not support log_images; skipping.")

    def log_table(
        self,
        table_name: str,
        columns: Optional[list] = None,
        data: Optional[list] = None,
        step: Optional[int] = None,
        **kwargs,
    ) -> None:
        """Tabular logging (reference WandBTracker.log_table, :360)."""
        logger.warning_once(f"Tracker {self.name} does not support log_table; skipping.")

    def finish(self) -> None:
        pass

    @property
    def tracker(self):
        return getattr(self, "writer", self)


@register_tracker
class TensorBoardTracker(GeneralTracker):
    name = "tensorboard"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard

        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        self.writer = tensorboard.SummaryWriter(self.logging_dir, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.writer.add_hparams(values, metric_dict={})
        self.writer.flush()
        with open(os.path.join(self.logging_dir, "hparams.json"), "w") as f:
            json.dump(values, f, default=str)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        for k, v in values.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, global_step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.add_text(k, v, global_step=step, **kwargs)
            elif isinstance(v, dict):
                self.writer.add_scalars(k, v, global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def finish(self) -> None:
        self.writer.close()


@register_tracker
class WandBTracker(GeneralTracker):
    name = "wandb"
    main_process_only = True

    def __init__(self, run_name: str, **kwargs):
        import wandb

        self.run = wandb.init(project=run_name, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        import wandb

        self.run.log({k: [wandb.Image(img) for img in v] if isinstance(v, (list, tuple)) else wandb.Image(v) for k, v in values.items()}, step=step, **kwargs)

    @on_main_process
    def log_table(self, table_name: str, columns=None, data=None, step: Optional[int] = None, **kwargs) -> None:
        import wandb

        self.run.log({table_name: wandb.Table(columns=columns, data=data)}, step=step, **kwargs)

    @on_main_process
    def finish(self) -> None:
        self.run.finish()

    @property
    def tracker(self):
        return self.run


@register_tracker
class MLflowTracker(GeneralTracker):
    name = "mlflow"

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        import mlflow

        self.run = mlflow.start_run(run_name=run_name, **kwargs)
        self.writer = mlflow

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        import mlflow

        for k, v in values.items():
            mlflow.log_param(k, v)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        import mlflow

        metrics = {k: v for k, v in values.items() if isinstance(v, (int, float))}
        mlflow.log_metrics(metrics, step=step)

    @on_main_process
    def finish(self) -> None:
        import mlflow

        mlflow.end_run()


@register_tracker
class JSONLTracker(GeneralTracker):
    """Dependency-free tracker writing metrics as JSON lines — the default
    when no external tracker is installed (useful where hosts have no
    network egress)."""

    name = "jsonl"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        self.run_name = run_name
        os.makedirs(os.path.join(logging_dir, run_name), exist_ok=True)
        self.path = os.path.join(logging_dir, run_name, "metrics.jsonl")
        self._file = open(self.path, "a")

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self._file.write(dumps_robust({"_config": values, "_time": time.time()}) + "\n")
        self._file.flush()

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        # dumps_robust: torch/numpy scalars land as numbers, and a weird value
        # degrades to a string instead of crashing the run (telemetry sinks
        # here every flush — a logging failure must never kill training)
        record = {**values, "_step": step, "_time": time.time()}
        self._file.write(dumps_robust(record) + "\n")
        self._file.flush()

    @on_main_process
    def finish(self) -> None:
        if self._file.closed:
            return
        # durability on preemption: the last flush must survive the VM dying
        # right after the run exits (GCS-fuse/NFS lose unfsynced pages)
        self._file.flush()
        try:
            os.fsync(self._file.fileno())
        except OSError:
            pass  # non-fsyncable sinks (pipes) still got the flush
        self._file.close()


@register_tracker
class CometMLTracker(GeneralTracker):
    """Comet (reference tracking.py:399-477)."""

    name = "comet_ml"

    def __init__(self, run_name: str, **kwargs):
        from comet_ml import Experiment

        self.run_name = run_name
        self.writer = Experiment(project_name=run_name, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.writer.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        if step is not None:
            self.writer.set_step(step)
        for k, v in values.items():
            if isinstance(v, (int, float)):
                self.writer.log_metric(k, v, step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.log_other(k, v, **kwargs)
            elif isinstance(v, dict):
                self.writer.log_metrics(v, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        for k, v in values.items():
            self.writer.log_image(v, name=k, step=step, **kwargs)

    @on_main_process
    def finish(self) -> None:
        self.writer.end()


@register_tracker
class AimTracker(GeneralTracker):
    """Aim (reference tracking.py:480-576)."""

    name = "aim"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        from aim import Run

        self.writer = Run(repo=logging_dir, **kwargs)
        self.writer.name = run_name

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.writer["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        for k, v in values.items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        import aim

        for k, v in values.items():
            self.writer.track(aim.Image(v, **kwargs.get("aim_image_kw", {})), name=k, step=step)

    @on_main_process
    def finish(self) -> None:
        self.writer.close()


@register_tracker
class ClearMLTracker(GeneralTracker):
    """ClearML (reference tracking.py:724-873)."""

    name = "clearml"

    def __init__(self, run_name: str, **kwargs):
        from clearml import Task

        self.run_name = run_name
        existing = Task.current_task()
        if existing is not None:
            self.task = existing
        else:
            init_kwargs = dict(kwargs)
            init_kwargs.setdefault("project_name", run_name)
            init_kwargs.setdefault("task_name", run_name)
            self.task = Task.init(**init_kwargs)
        # only close tasks we created; an adopted external task stays open
        self._created = existing is None

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.task.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        logger_obj = self.task.get_logger()
        for k, v in values.items():
            if isinstance(v, (int, float)):
                if step is None:
                    logger_obj.report_single_value(name=k, value=v, **kwargs)
                else:
                    title, _, series = k.partition("/")
                    logger_obj.report_scalar(
                        title=title, series=series or title, value=v, iteration=step, **kwargs
                    )

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        logger_obj = self.task.get_logger()
        for k, v in values.items():
            logger_obj.report_image(title=k, series=k, iteration=step, image=v, **kwargs)

    @on_main_process
    def log_table(self, table_name: str, columns=None, data=None, step: Optional[int] = None, **kwargs) -> None:
        to_report = [columns] + list(data) if columns is not None else data
        self.task.get_logger().report_table(
            title=table_name, series=table_name, table_plot=to_report, iteration=step, **kwargs
        )

    @on_main_process
    def finish(self) -> None:
        if self._created:
            self.task.close()

    @property
    def tracker(self):
        return self.task


@register_tracker
class DVCLiveTracker(GeneralTracker):
    """DVCLive (reference tracking.py:876-968)."""

    name = "dvclive"

    def __init__(self, run_name: str, live=None, **kwargs):  # noqa: ARG002 - run_name unused upstream too
        from dvclive import Live

        self.live = live if live is not None else Live(**kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.live.log_params(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            if isinstance(v, (int, float, str)):
                self.live.log_metric(k, v, **kwargs)
        self.live.next_step()

    @on_main_process
    def finish(self) -> None:
        self.live.end()

    @property
    def tracker(self):
        return self.live


_AVAILABILITY = {
    "tensorboard": is_tensorboard_available,
    "wandb": is_wandb_available,
    "mlflow": is_mlflow_available,
    "comet_ml": is_comet_ml_available,
    "aim": is_aim_available,
    "clearml": is_clearml_available,
    "dvclive": is_dvclive_available,
    "jsonl": lambda: True,
}


def filter_trackers(
    log_with,
    logging_dir: Optional[str],
    project_name: str,
    config: Optional[dict] = None,
    init_kwargs: Optional[dict] = None,
) -> list[GeneralTracker]:
    """Resolve tracker names ("all" included) to live instances (tracking.py:971)."""
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    init_kwargs = init_kwargs or {}

    names: list[str] = []
    instances: list[GeneralTracker] = []
    for item in log_with:
        if isinstance(item, GeneralTracker):
            instances.append(item)
        elif str(item) == "all":
            names.extend(name for name, avail in _AVAILABILITY.items() if avail())
        else:
            names.append(str(item))

    for name in dict.fromkeys(names):
        if name not in _available_trackers:
            raise ValueError(f"Unknown tracker {name!r}; available: {sorted(_available_trackers)}")
        avail = _AVAILABILITY.get(name, lambda: True)
        if not avail():
            logger.warning(f"Tracker {name} requested but its package is not installed; skipping.")
            continue
        cls = _available_trackers[name]
        kwargs = dict(init_kwargs.get(name, {}))
        if cls.requires_logging_directory:
            if logging_dir is None:
                raise ValueError(f"Tracker {name} requires a logging_dir (set project_dir).")
            instances.append(cls(project_name, logging_dir=logging_dir, **kwargs))
        else:
            instances.append(cls(project_name, **kwargs))
    for tracker in instances:
        if config:
            tracker.store_init_configuration(config)
    return instances
