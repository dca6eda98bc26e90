"""Config dataclasses and enums of the training slice.

Port of ``accelerate_tpu/utils/dataclasses.py:41-238`` and :396: the
precision, distributed-type, tracker and RNG enums, the mixed-precision
policy with torch dtypes (fp8 included, :163-167), gradient accumulation in
both modes (:189-220, with its environment variables), the process-group
bring-up knobs (``DistributedInitKwargs`` :176), the data-loader
configuration (:225), the project configuration that names checkpoints,
``TensorInformation``, and the sharding configuration: ``ShardingStrategy``
(:257-266) and ``ParallelismPlugin`` (:270-360, with its environment
transport, its checks, ``mesh_shape`` and ``pure_dp``).
"""

from __future__ import annotations

import copy
import enum
import os
from dataclasses import dataclass, fields
from datetime import timedelta
from typing import Any, Optional

import torch

from .constants import (
    ENV_PREFIX,
    MESH_AXIS_DATA,
    MESH_AXIS_EXPERT,
    MESH_AXIS_FSDP,
    MESH_AXIS_PIPELINE,
    MESH_AXIS_SEQUENCE,
    MESH_AXIS_TENSOR,
)
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
    """Process/topology type (reference :74). A process drives one device;
    with a ``torch.distributed`` group up, the type is the group's, at any
    world size (a group of one still runs its collectives)."""

    NO = "NO"  # one process, no process group
    MULTI_GPU = "MULTI_GPU"  # a process group over NCCL, one CUDA device a process
    MULTI_CPU = "MULTI_CPU"  # a process group over gloo on the CPU (tests, debug launcher)


class RNGType(str, enum.Enum):
    """The generators ``synchronize_rng_states`` can align (reference :106;
    the port's explicit generator stands where the reference's JAX key
    does)."""

    TORCH = "torch"
    NUMPY = "numpy"
    PYTHON = "python"
    GENERATOR = "generator"


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
    """What dtype each tensor class uses inside the train step: the fp32
    masters, compute in ``compute_dtype``, gradients accumulated in
    ``grad_dtype`` (None: fp32; bf16 halves the carried buffer at some
    precision). ``param_dtype`` and ``output_dtype`` are the reference's
    fields, which its step does not read either. ``fp8``: the models'
    projections run as fp8 products (``ops/fp8.py``; ``prepare`` converts a
    model), everything else in bf16."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32
    grad_dtype: Any = None  # the accumulation buffer's dtype; None -> float32
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
class DistributedInitKwargs(KwargsHandler):
    """Process-group bring-up knobs (reference :176). Unset fields fall back
    to the launcher's ``ACCELERATE_TPU_NUM_PROCESSES``, ``_PROCESS_ID`` and
    ``_COORDINATOR_ADDRESS``. ``initialization_timeout`` bounds the
    rendezvous and every collective of the group."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    initialization_timeout: timedelta = timedelta(minutes=5)


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """The loaders' settings (reference :225). ``split_batches``: the
    incoming batch is already the global one and is split across the
    processes; ``dispatch_batches``: process 0 reads every batch and sends
    each process its rows; ``even_batches``: a short last batch wraps around
    the dataset (else it is padded with its last sample, the padding
    recorded in ``remainder``); ``use_seedable_sampler``: a shuffle drawn
    from ``seed + epoch`` (else from numpy's global generator);
    ``drop_last``: drop a short last batch."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    drop_last: bool = False


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


@dataclass
class TensorInformation:
    """A tensor's shape and dtype (reference :396), for
    ``operations.get_data_structure`` and ``initialize_tensors``."""

    shape: tuple[int, ...]
    dtype: Any


class ShardingStrategy(str, enum.Enum):
    """How far the parameter, optimizer-state and gradient sharding goes
    (reference :257): the union of FSDP's strategies and DeepSpeed's ZeRO
    stages, named by what is sharded."""

    NO_SHARD = "no_shard"  # data parallel (DDP / ZeRO-0)
    SHARD_OPT = "shard_opt"  # the optimizer state (ZeRO-1)
    SHARD_GRAD_OP = "shard_grad_op"  # and the gradient buffer (ZeRO-2)
    FULL_SHARD = "full_shard"  # and the parameters (ZeRO-3 / FSDP)
    HYBRID_SHARD = "hybrid_shard"  # FULL_SHARD inside a slice, data parallel across


@dataclass
class ParallelismPlugin(KwargsHandler):
    """The parallelism configuration (reference :270): the degree of each
    mesh axis and how far the state is sharded. ``dp * pp * fsdp * ep * sp
    * tp`` must equal the world size; ``-1`` on exactly one axis takes the
    rest. The launcher's environment (``ACCELERATE_TPU_DP_SIZE``, ...,
    ``ACCELERATE_TPU_SHARDING_STRATEGY``) fills a field left at its default.
    ``min_weight_size``: a leaf with fewer elements stays whole on the fsdp
    axis (FSDP's ``min_num_params``). ``sharding_rules``: (logical axis,
    mesh axis or None) pairs that override ``parallel.sharding``'s
    defaults."""

    dp_size: int = -1
    fsdp_size: int = 1
    tp_size: int = 1
    sp_size: int = 1
    ep_size: int = 1
    pp_size: int = 1

    sharding_strategy: ShardingStrategy = ShardingStrategy.FULL_SHARD
    min_weight_size: int = 2**12
    sharding_rules: Optional[list[tuple[str, Optional[str]]]] = None
    num_micro_batches: int = 1

    def __post_init__(self):
        # the environment fills defaults only: a value passed wins
        defaults = {f.name: f.default for f in fields(self.__class__)}
        for name in ("dp_size", "fsdp_size", "tp_size", "sp_size", "ep_size",
                     "pp_size", "num_micro_batches"):
            env = os.environ.get(ENV_PREFIX + name.upper())
            if env is not None and getattr(self, name) == defaults[name]:
                setattr(self, name, int(env))
        env = os.environ.get(ENV_PREFIX + "SHARDING_STRATEGY")
        if env is not None and self.sharding_strategy == defaults["sharding_strategy"]:
            self.sharding_strategy = ShardingStrategy(env)
        self.sharding_strategy = ShardingStrategy(self.sharding_strategy)
        sizes = [self.dp_size, self.pp_size, self.fsdp_size, self.tp_size,
                 self.sp_size, self.ep_size]
        if sizes.count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1 (auto)")
        for s in sizes:
            if s == 0 or s < -1:
                raise ValueError(f"invalid mesh degree {s}")

    @property
    def mesh_shape(self) -> dict[str, int]:
        """Axis name -> degree (an auto axis still -1; ``parallel.mesh.
        resolve_mesh_shape`` resolves it against the world size)."""
        return {
            MESH_AXIS_DATA: self.dp_size,
            MESH_AXIS_PIPELINE: self.pp_size,
            MESH_AXIS_FSDP: self.fsdp_size,
            MESH_AXIS_EXPERT: self.ep_size,
            MESH_AXIS_SEQUENCE: self.sp_size,
            MESH_AXIS_TENSOR: self.tp_size,
        }

    @property
    def shards_parameters(self) -> bool:
        return (self.sharding_strategy in (ShardingStrategy.FULL_SHARD,
                                           ShardingStrategy.HYBRID_SHARD)
                and self.fsdp_size != 1) or self.tp_size != 1

    @classmethod
    def pure_dp(cls) -> "ParallelismPlugin":
        return cls(dp_size=-1, fsdp_size=1, sharding_strategy=ShardingStrategy.NO_SHARD)
