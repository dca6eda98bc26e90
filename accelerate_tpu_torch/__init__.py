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
experiment trackers (``tracking``), the optax-faithful ``adamw``,
its fused-epilogue form ``fused_adamw``, ``sgd`` and
``warmup_cosine_decay_schedule``, and hand-written kernels for Hopper:
flash attention (``ops/csrc/flash_attention.cu``) and the fused prologue
and AdamW epilogue (``ops/csrc/fused.cu``). Imports no JAX; runs on CUDA
unless the caller asks for the CPU (``Accelerator(cpu=True)``).
"""

from .accelerator import Accelerator
from .data_loader import DataLoader
from .diagnostics import DiagnosticsConfig, DiagnosticsManager
from .fault_tolerance import CheckpointManager
from .models.config import TransformerConfig
from .models.transformer import CausalLM, SequenceClassifier
from .ops.fused import fused_adamw
from .optimizer import AcceleratedOptimizer, adamw, sgd
from .scheduler import AcceleratedScheduler, warmup_cosine_decay_schedule
from .state import AcceleratorState, GradientState
from .telemetry import HeartbeatMonitor, StepTelemetry, TelemetryConfig, scan_heartbeats
from .utils.dataclasses import (
    DataLoaderConfiguration,
    GradientAccumulationPlugin,
    ProjectConfiguration,
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
    "CausalLM",
    "CheckpointManager",
    "DataLoader",
    "DataLoaderConfiguration",
    "DiagnosticsConfig",
    "DiagnosticsManager",
    "GradientAccumulationPlugin",
    "GradientState",
    "HeartbeatMonitor",
    "ProfileKwargs",
    "ProjectConfiguration",
    "SequenceClassifier",
    "StepTelemetry",
    "TelemetryConfig",
    "TransformerConfig",
    "adamw",
    "carry_from_jax",
    "carry_to_jax",
    "find_executable_batch_size",
    "fused_adamw",
    "params_from_jax",
    "scan_heartbeats",
    "set_seed",
    "sgd",
    "warmup_cosine_decay_schedule",
]
