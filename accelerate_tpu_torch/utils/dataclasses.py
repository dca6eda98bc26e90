"""Config dataclasses and enums of the training slice.

Port of ``accelerate_tpu/utils/dataclasses.py:41-238``: the precision,
distributed-type and tracker enums, the mixed-precision policy with torch dtypes (fp8
included, :163-167), gradient accumulation in both modes (:189-220, with its
environment variables), the data-loader configuration's one-process fields
(:225) and the project configuration that names checkpoints. One process
on one device: sharding plugins, process groups and the launcher's other
environment variables come with a later slice (ROADMAP.md, queue A4).
"""

from __future__ import annotations

import copy
import enum
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

from .constants import ENV_PREFIX
from .environment import parse_flag_from_env


class KwargsHandler:
    """``to_kwargs``: the fields that differ from the dataclass defaults
    (reference :41)."""

    def to_dict(self) -> dict[str, Any]:
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self) -> dict[str, Any]:
        default = self.__class__()
        return {k: v for k, v in self.to_dict().items() if getattr(default, k) != v}


class DistributedType(str, enum.Enum):
    """Process/topology type. This slice runs one process on one device;
    the multi-process types arrive with ``torch.distributed``."""

    NO = "NO"  # single device, single process


class LoggerType(str, enum.Enum):
    """The experiment trackers (reference :116); ``str()`` is the value."""

    ALL = "all"
    TENSORBOARD = "tensorboard"
    WANDB = "wandb"
    MLFLOW = "mlflow"
    COMETML = "comet_ml"
    AIM = "aim"
    CLEARML = "clearml"
    DVCLIVE = "dvclive"
    JSONL = "jsonl"  # the zero-dependency tracker

    def __str__(self) -> str:
        return self.value


class PrecisionType(str, enum.Enum):
    NO = "no"
    FP8 = "fp8"
    FP16 = "fp16"
    BF16 = "bf16"


@dataclass
class MixedPrecisionPolicy:
    """What dtype each tensor class uses inside the train step: params and
    gradients stay fp32, compute runs in ``compute_dtype``. ``fp8``: the
    models' projections run as fp8 products (``ops/fp8.py``; ``prepare``
    converts a model), everything else in bf16."""

    compute_dtype: Any = torch.float32
    fp8: bool = False
    # fp16 only: dynamic loss scaling (GradScaler semantics)
    loss_scale_init: float = 2.0**15
    loss_scale_growth_interval: int = 2000
    loss_scale_factor: float = 2.0

    @classmethod
    def from_precision(cls, precision: str | PrecisionType) -> "MixedPrecisionPolicy":
        precision = PrecisionType(precision)
        if precision == PrecisionType.NO:
            return cls()
        if precision == PrecisionType.BF16:
            return cls(compute_dtype=torch.bfloat16)
        if precision == PrecisionType.FP16:
            return cls(compute_dtype=torch.float16)
        return cls(compute_dtype=torch.bfloat16, fp8=True)

    @property
    def uses_loss_scaling(self) -> bool:
        return self.compute_dtype == torch.float16


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    """K-step gradient accumulation. Unfused (the default), the step runs
    once per microbatch and every K-th call applies the optimizer; with
    ``fused=True`` (env ``ACCELERATE_TPU_FUSED_ACCUM``) the step runs once
    per optimizer step over a stacked ``[K, micro, ...]`` batch.
    ``ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS`` fills ``num_steps`` when
    it is left at 1. ``adjust_scheduler``, ``sync_with_dataloader`` and
    ``sync_each_batch`` steer the raw loop's ``accumulate``."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False
    fused: bool = False

    def __post_init__(self):
        env = os.environ.get(ENV_PREFIX + "GRADIENT_ACCUMULATION_STEPS")
        if env is not None and self.num_steps == 1:
            self.num_steps = int(env)
        if self.num_steps < 1:
            raise ValueError("num_steps must be >= 1")
        if not self.fused:
            self.fused = parse_flag_from_env(ENV_PREFIX + "FUSED_ACCUM")
        if self.fused and self.sync_each_batch:
            raise ValueError(
                "fused accumulation folds every microbatch into one optimizer "
                "step; sync_each_batch=True contradicts that — use the "
                "unfused path for per-microbatch sync"
            )


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """The loader setting of one process (reference :225):
    ``split_batches``, the incoming batch is already the global one (the
    schedulers then count one step a step, which is also what one process
    counts). ``dispatch_batches``, ``even_batches`` and the sampler switches
    belong to several processes (ROADMAP.md, queue A4)."""

    split_batches: bool = False


@dataclass
class ProjectConfiguration:
    """Where ``save_state`` puts checkpoints: with
    ``automatic_checkpoint_naming`` they go to
    ``<project_dir>/checkpoints/checkpoint_<iteration>``, keeping at most
    ``total_limit`` of them."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0

    def set_directories(self, project_dir: Optional[str] = None) -> None:
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        self.set_directories(self.project_dir)
