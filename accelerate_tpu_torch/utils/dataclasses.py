"""Config dataclasses and enums of the training slice.

Port of ``accelerate_tpu/utils/dataclasses.py:65-225`` and ``:238``: the
precision and distributed-type enums, the mixed-precision policy with torch
dtypes (fp8 included, :163-167), gradient accumulation in its unfused mode, and the project
configuration that names checkpoints. One process on one device:
sharding plugins, process groups and the launcher's environment variables
come with a later slice (ROADMAP.md).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional

import torch


class DistributedType(str, enum.Enum):
    """Process/topology type. This slice runs one process on one device;
    the multi-process types arrive with ``torch.distributed``."""

    NO = "NO"  # single device, single process


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
class GradientAccumulationPlugin:
    """K-step gradient accumulation in the unfused mode: the step runs once
    per microbatch and every K-th call applies the optimizer. The fused
    (scanned) mode is not ported yet (ROADMAP.md, queue A3)."""

    num_steps: int = 1

    def __post_init__(self):
        if self.num_steps < 1:
            raise ValueError("num_steps must be >= 1")


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
