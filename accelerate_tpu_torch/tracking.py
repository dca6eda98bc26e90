"""Experiment tracking.

Port of ``accelerate_tpu/tracking.py``: ``GeneralTracker`` (:91), the
JSONL (:126), TensorBoard (:165), WandB, MLflow, CometML, Aim, ClearML and
DVCLive trackers, ``LOGGER_TYPE_TO_CLASS`` (:487), ``filter_trackers``
(:499) and ``get_available_trackers`` (:59). Logging is host-side and on
the main process only. Metric values may be tensors on the card: a logged
value is read back when it is logged, not before. :class:`JSONLTracker`
needs no package; every other tracker imports its package when it is
made, and :func:`filter_trackers` skips one whose package is missing, with
a warning.

TensorBoard counts as available when the ``tensorboard`` or
``tensorboardX`` package is installed. (The reference also accepts the
``torch.utils.tensorboard`` module alone, which every PyTorch has but
which cannot be imported without ``tensorboard``.)

``telemetry_bridge`` returns the reference's ``TrackerBridgeSink``, which
is not ported yet: it raises naming its queue item (ROADMAP.md, A10).
"""

from __future__ import annotations

import functools
import importlib.metadata
import importlib.util
import json
import os
import time
from typing import Any, Optional, Union

import numpy as np
import torch

from .logging import get_logger
from .state import PartialState
from .utils.dataclasses import LoggerType

logger = get_logger(__name__)


@functools.lru_cache
def _is_package_available(name: str) -> bool:
    if importlib.util.find_spec(name) is None:
        return False
    try:
        importlib.metadata.version(name)
        return True
    except importlib.metadata.PackageNotFoundError:
        return False


def is_tensorboard_available() -> bool:
    return _is_package_available("tensorboard") or _is_package_available("tensorboardX")


_PACKAGES = {
    LoggerType.WANDB: "wandb",
    LoggerType.COMETML: "comet_ml",
    LoggerType.AIM: "aim",
    LoggerType.MLFLOW: "mlflow",
    LoggerType.CLEARML: "clearml",
    LoggerType.DVCLIVE: "dvclive",
}


def get_available_trackers() -> list[LoggerType]:
    """JSONL, and each tracker whose package is installed."""
    out = [LoggerType.JSONL]
    if is_tensorboard_available():
        out.append(LoggerType.TENSORBOARD)
    out += [t for t, package in _PACKAGES.items() if _is_package_available(package)]
    return out


def on_main_process(function):
    """Run the decorated tracker method on the main process only."""

    @functools.wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if getattr(self, "main_process_only", True):
            state = PartialState._shared_state
            if state and state.get("process_index", 0) != 0:
                return None
        return function(self, *args, **kwargs)

    return execute_on_main_process


def _scalarize(values: dict) -> dict:
    """Tensors and numpy values as Python numbers (or lists); strings and
    the rest as they are."""
    out = {}
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            out[k] = v.item() if v.ndim == 0 else v.tolist()
        elif isinstance(v, (np.integer, np.floating)):
            out[k] = v.item()
        else:
            out[k] = v
    return out


class GeneralTracker:
    """The tracker base class. A subclass sets ``name`` and
    ``requires_logging_directory`` and implements
    ``store_init_configuration`` and ``log``; ``tracker`` returns the
    underlying run object."""

    main_process_only = True
    name: str = "general"
    requires_logging_directory: bool = False

    def __init__(self, _blank: bool = False):
        if not _blank:
            for attr in ("name", "requires_logging_directory"):
                if getattr(self.__class__, attr, None) is None:
                    raise NotImplementedError(f"Tracker {self.__class__.__name__} must set "
                                              f"`{attr}`")

    @property
    def tracker(self):
        raise NotImplementedError

    def store_init_configuration(self, values: dict):
        raise NotImplementedError

    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        raise NotImplementedError

    def finish(self):
        pass


class JSONLTracker(GeneralTracker):
    """One JSON object a ``log`` call in ``<logging_dir>/<run>/metrics.jsonl``,
    the configuration in ``config.json`` beside it."""

    name = "jsonl"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Union[str, os.PathLike] = "."):
        super().__init__()
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir or ".", run_name)
        os.makedirs(self.logging_dir, exist_ok=True)
        self._path = os.path.join(self.logging_dir, "metrics.jsonl")
        self._file = open(self._path, "a", buffering=1)
        logger.debug(f"Initialized JSONL tracker at {self._path}")

    @property
    def tracker(self):
        return self._file

    @on_main_process
    def store_init_configuration(self, values: dict):
        with open(os.path.join(self.logging_dir, "config.json"), "w") as f:
            json.dump(_scalarize(values), f, indent=2, default=str)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        record = {"_time": time.time()}
        if step is not None:
            record["_step"] = int(step)
        record.update(_scalarize(values))
        self._file.write(json.dumps(record, default=str) + "\n")

    @on_main_process
    def finish(self):
        if not self._file.closed:
            self._file.close()


class TensorBoardTracker(GeneralTracker):
    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Union[str, os.PathLike] = ".", **kwargs):
        super().__init__()
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir or ".", run_name)
        self.writer = tensorboard.SummaryWriter(self.logging_dir, **kwargs)
        logger.debug(f"Initialized TensorBoard project {run_name} at {self.logging_dir}")

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.add_hparams(_flatten_config(_scalarize(values)), metric_dict={})
        self.writer.flush()
        try:
            with open(os.path.join(self.logging_dir, "hparams.yml"), "w") as out:
                try:
                    import yaml

                    yaml.dump(_scalarize(values), out)
                except ImportError:
                    json.dump(_scalarize(values), out, default=str)
        except Exception:  # noqa: BLE001 - the reference logs and goes on
            logger.error("Serialization to store hyperparameters failed")

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in _scalarize(values).items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, global_step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.add_text(k, v, global_step=step, **kwargs)
            elif isinstance(v, dict):
                self.writer.add_scalars(k, v, global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def finish(self):
        self.writer.close()


class WandBTracker(GeneralTracker):
    name = "wandb"
    requires_logging_directory = False
    main_process_only = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import wandb

        self.run_name = run_name
        self.run = wandb.init(project=self.run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb

        wandb.config.update(_scalarize(values), allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(_scalarize(values), step=step, **kwargs)

    @on_main_process
    def log_table(self, table_name: str, columns: Optional[list] = None,
                  data: Optional[list] = None, dataframe: Any = None,
                  step: Optional[int] = None, **kwargs):
        import wandb

        values = {table_name: wandb.Table(columns=columns, data=data, dataframe=dataframe)}
        self.log(values, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.run.finish()


class MLflowTracker(GeneralTracker):
    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, experiment_name: Optional[str] = None, logging_dir: Optional[str] = None,
                 run_id: Optional[str] = None, tags: Optional[dict] = None,
                 nested_run: bool = False, run_name: Optional[str] = None,
                 description: Optional[str] = None):
        super().__init__()
        import mlflow

        experiment_name = os.environ.get("MLFLOW_EXPERIMENT_NAME", experiment_name)
        run_id = os.environ.get("MLFLOW_RUN_ID", run_id)
        exps = mlflow.search_experiments(filter_string=f"name = '{experiment_name}'")
        if exps:
            experiment_id = exps[0].experiment_id
        else:
            experiment_id = mlflow.create_experiment(name=experiment_name,
                                                     artifact_location=logging_dir, tags=tags)
        self.active_run = mlflow.start_run(run_id=run_id, experiment_id=experiment_id,
                                           run_name=run_name, nested=nested_run, tags=tags,
                                           description=description)

    @property
    def tracker(self):
        return self.active_run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        for chunk in _chunk_dict(_scalarize(values),
                                 mlflow.utils.validation.MAX_PARAMS_TAGS_PER_BATCH):
            mlflow.log_params(chunk)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import mlflow

        metrics = {k: v for k, v in _scalarize(values).items() if isinstance(v, (int, float))}
        mlflow.log_metrics(metrics, step=step)

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


class CometMLTracker(GeneralTracker):
    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        from comet_ml import Experiment

        self.run_name = run_name
        self.writer = Experiment(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.log_parameters(_scalarize(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.writer.set_step(step)
        self.writer.log_others(_scalarize(values))

    @on_main_process
    def finish(self):
        self.writer.end()


class AimTracker(GeneralTracker):
    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__()
        from aim import Run

        self.run_name = run_name
        self.writer = Run(repo=logging_dir, **kwargs)
        self.writer.name = self.run_name

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer["hparams"] = _scalarize(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in _scalarize(values).items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.close()


class ClearMLTracker(GeneralTracker):
    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: Optional[str] = None, **kwargs):
        super().__init__()
        from clearml import Task

        current = Task.current_task()
        self._initialized_externally = current is not None
        self.task = current or Task.init(project_name=kwargs.pop("project_name", run_name),
                                         task_name=kwargs.pop("task_name", run_name), **kwargs)

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.task.connect_configuration(_scalarize(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in _scalarize(values).items():
            if isinstance(v, (int, float)) and step is None:
                self.task.get_logger().report_single_value(name=k, value=v, **kwargs)
            elif isinstance(v, (int, float)):
                title, _, series = k.partition("/")
                self.task.get_logger().report_scalar(title=title, series=series or title,
                                                     value=v, iteration=step, **kwargs)

    @on_main_process
    def finish(self):
        if not self._initialized_externally:
            self.task.close()


class DVCLiveTracker(GeneralTracker):
    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: Optional[str] = None, live: Any = None, **kwargs):
        super().__init__()
        from dvclive import Live

        self.live = live if live is not None else Live(**kwargs)

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(_scalarize(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in _scalarize(values).items():
            if isinstance(v, (int, float)):
                self.live.log_metric(k, v, **kwargs)
        self.live.next_step()

    @on_main_process
    def finish(self):
        self.live.end()


LOGGER_TYPE_TO_CLASS = {
    "aim": AimTracker,
    "comet_ml": CometMLTracker,
    "mlflow": MLflowTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "clearml": ClearMLTracker,
    "dvclive": DVCLiveTracker,
    "jsonl": JSONLTracker,
}


def filter_trackers(log_with: list, logging_dir: Optional[str] = None,
                    project_name: str = "accelerate_tpu", config: Optional[dict] = None,
                    init_kwargs: Optional[dict] = None) -> list[GeneralTracker]:
    """The requested trackers that are available, made and configured: a
    tracker instance passes through; a name whose package is missing, or
    that needs a logging dir when there is none, is skipped with a
    warning."""
    loggers: list[GeneralTracker] = []
    init_kwargs = init_kwargs or {}
    requested: list[Any] = []
    for item in log_with or []:
        if issubclass(type(item), GeneralTracker):
            loggers.append(item)
            continue
        item = LoggerType(str(item).lower())
        if item == LoggerType.ALL:
            requested = get_available_trackers()
            break
        requested.append(item)
    available = get_available_trackers()
    for ltype in requested:
        if ltype not in available:
            logger.warning(f"Tried adding logger {ltype} but package is not installed")
            continue
        cls = LOGGER_TYPE_TO_CLASS[str(ltype)]
        kwargs = dict(init_kwargs.get(str(ltype), {}))
        if cls.requires_logging_directory:
            if logging_dir is None:
                logger.warning(f"Logging with {ltype} requires a logging_dir; skipping")
                continue
            kwargs.setdefault("logging_dir", logging_dir)
        tracker = cls(project_name, **kwargs)
        if config:
            tracker.store_init_configuration(config)
        loggers.append(tracker)
    return loggers


def telemetry_bridge(trackers: Any, prefix: str = "telemetry/"):
    """The reference's ``TrackerBridgeSink`` forwards step records to the
    trackers; the port has no such sink yet."""
    raise NotImplementedError("telemetry_bridge: the TrackerBridgeSink is not ported yet "
                              "(ROADMAP.md, queue A10)")


def _flatten_config(values: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in values.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_config(v, prefix=f"{key}/"))
        elif isinstance(v, (int, float, str, bool)):
            out[key] = v
        else:
            out[key] = str(v)
    return out


def _chunk_dict(d: dict, size: int):
    items = list(d.items())
    for i in range(0, len(items), size):
        yield dict(items[i:i + size])
