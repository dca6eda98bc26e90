"""accelerate_tpu_torch: the PyTorch/CUDA port of accelerate_tpu.

The training slice on one NVIDIA H100: ``Accelerator`` (prepare ->
``unified_step``, unfused or fused gradient accumulation, with telemetry
step records -> ``save_state``/``load_state``, sync or in the background,
``CheckpointManager``'s cadence, preemption and resume, ``skip_first_batches``,
``gather_for_metrics``; the raw loop's ``accumulate``, ``backward``,
``clip_grad_norm_``, triggers and ``free_memory``;
``find_executable_batch_size``; diagnostics: goodput, anomalies, triggered
``torch.profiler`` captures, the flight recorder, the heartbeat watchdog and
``Accelerator.profile``, read back by
``python -m accelerate_tpu_torch.commands.accelerate_cli diagnose <dir>``), the Llama-family ``CausalLM`` (with the fused
RMSNorm -> QKV -> rope prologue under ``fused_kernels=True``) and the
BERT-shaped encoder ``SequenceClassifier``, LoRA/QLoRA adapters over an
int8 base (``adapters``, ``utils.quantization``) with multi-tenant serving,
big-model loading (``big_modeling``: empty init, device maps over the card,
pinned host memory and disk, streamed native and HF checkpoints through
``utils.hf_interop``, ``load_and_quantize_model``), several processes
(a ``torch.distributed`` group brought up from the launcher's environment:
NCCL on the card, gloo on the CPU; the collectives, each process's rows of
every global batch, the cross-process gradient mean, checkpoints saved by
every process and restored onto another world size, ``LocalSGD``, and
``debug_launcher``/``notebook_launcher``), sharded training on a device mesh
(``ParallelismPlugin``: dp, fsdp, tp, pp, sp and ep; ZeRO-1/2/3 and tensor
parallelism with parameters as DTensors placed by ``parallel.sharding``'s
rules, the compat plugins in ``utils.compat``, sharded checkpoints and loads
onto a mesh, decoding, LoRA and MoE over a sharded model, the raw loop on
DTensor params),
experiment trackers (``tracking``), the optax-faithful ``adamw``,
its fused-epilogue form ``fused_adamw``, ``sgd``, ``optax.contrib``'s
``schedule_free_adamw`` with ``schedule_free_eval_params``, and
``warmup_cosine_decay_schedule``, and hand-written kernels for Hopper:
flash attention (``ops/csrc/flash_attention.cu``) and the fused prologue
and AdamW epilogue (``ops/csrc/fused.cu``). Imports no JAX; runs on CUDA
unless the caller asks for the CPU (``Accelerator(cpu=True)``).
"""

from .accelerator import Accelerator
from .adapters import (
    AdapterRegistry,
    LoraConfig,
    init_adapter,
    load_adapter,
    lora_loss_fn,
    save_adapter,
)
from .big_modeling import (
    OffloadedLeaf,
    cpu_offload,
    disk_offload,
    dispatch_params,
    infer_auto_device_map,
    init_empty_weights,
    init_on_device,
    load_checkpoint_and_dispatch,
    materialize_offloaded,
    streamed_apply,
)
from .checkpoint_async import AsyncCheckpointer, save_accelerator_state_async
from .data_loader import DataLoader, prepare_data_loader, skip_first_batches
from .diagnostics import (
    AnomalyDetector,
    DiagnosticsConfig,
    DiagnosticsManager,
    FlightRecorder,
    GoodputAccounting,
    TraceCapture,
    build_report,
    format_report,
    list_dumps,
)
from .fault_tolerance import CheckpointManager
from .launchers import debug_launcher, notebook_launcher
from .local_sgd import LocalSGD
from .logging import get_logger
from .models.config import TransformerConfig
from .models.transformer import CausalLM, SequenceClassifier
from .ops.fused import fused_adamw
from .optimizer import (
    AcceleratedOptimizer,
    adamw,
    schedule_free_adamw,
    schedule_free_eval_params,
    sgd,
)
from .profiling import BufferCensus
from .scheduler import AcceleratedScheduler, warmup_cosine_decay_schedule
from .serving import SLOConfig, ServingEngine, TokenEvent
from .state import AcceleratorState, GradientState, PartialState
from .telemetry import (
    HeartbeatMonitor,
    JSONLSink,
    PrometheusTextSink,
    RecompileDetector,
    StepTelemetry,
    TelemetryConfig,
    scan_heartbeats,
)
from .utils.dataclasses import (
    DataLoaderConfiguration,
    DistributedInitKwargs,
    DistributedType,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ParallelismPlugin,
    ProjectConfiguration,
    ShardingStrategy,
)
from .utils.memory import find_executable_batch_size
from .utils.profiling import ProfileKwargs
from .utils.random import set_seed
from .utils.weights import carry_from_jax, carry_to_jax, params_from_jax

__all__ = [
    "AcceleratedOptimizer",
    "AcceleratedScheduler",
    "Accelerator",
    "AcceleratorState",
    "AdapterRegistry",
    "AnomalyDetector",
    "AsyncCheckpointer",
    "BufferCensus",
    "CausalLM",
    "CheckpointManager",
    "DataLoader",
    "DataLoaderConfiguration",
    "DiagnosticsConfig",
    "DiagnosticsManager",
    "DistributedInitKwargs",
    "DistributedType",
    "FlightRecorder",
    "GoodputAccounting",
    "GradientAccumulationPlugin",
    "GradientState",
    "HeartbeatMonitor",
    "JSONLSink",
    "LocalSGD",
    "LoraConfig",
    "MixedPrecisionPolicy",
    "OffloadedLeaf",
    "ParallelismPlugin",
    "PartialState",
    "ProfileKwargs",
    "ProjectConfiguration",
    "PrometheusTextSink",
    "RecompileDetector",
    "SLOConfig",
    "SequenceClassifier",
    "ServingEngine",
    "ShardingStrategy",
    "StepTelemetry",
    "TelemetryConfig",
    "TokenEvent",
    "TraceCapture",
    "TransformerConfig",
    "adamw",
    "build_report",
    "carry_from_jax",
    "carry_to_jax",
    "cpu_offload",
    "debug_launcher",
    "disk_offload",
    "dispatch_params",
    "find_executable_batch_size",
    "format_report",
    "fused_adamw",
    "get_logger",
    "infer_auto_device_map",
    "init_adapter",
    "init_empty_weights",
    "init_on_device",
    "list_dumps",
    "load_adapter",
    "load_checkpoint_and_dispatch",
    "lora_loss_fn",
    "materialize_offloaded",
    "notebook_launcher",
    "params_from_jax",
    "prepare_data_loader",
    "save_accelerator_state_async",
    "save_adapter",
    "scan_heartbeats",
    "set_seed",
    "schedule_free_adamw",
    "schedule_free_eval_params",
    "sgd",
    "skip_first_batches",
    "streamed_apply",
    "warmup_cosine_decay_schedule",
]
