"""accelerate_tpu_torch: the PyTorch/CUDA port of accelerate_tpu.

The training slice on one NVIDIA H100: ``Accelerator`` (prepare ->
``unified_step`` -> ``save_state``/``load_state``, ``skip_first_batches``,
``gather_for_metrics``), the Llama-family ``CausalLM`` (with the fused
RMSNorm -> QKV -> rope prologue under ``fused_kernels=True``) and the
BERT-shaped encoder ``SequenceClassifier``, the optax-faithful ``adamw``,
its fused-epilogue form ``fused_adamw`` and
``warmup_cosine_decay_schedule``, and hand-written kernels for Hopper:
flash attention (``ops/csrc/flash_attention.cu``) and the fused prologue
and AdamW epilogue (``ops/csrc/fused.cu``). Imports no JAX; runs on CUDA
unless the caller asks for the CPU (``Accelerator(cpu=True)``).
"""

from .accelerator import Accelerator
from .data_loader import DataLoader
from .models.config import TransformerConfig
from .models.transformer import CausalLM, SequenceClassifier
from .ops.fused import fused_adamw
from .optimizer import adamw
from .scheduler import AcceleratedScheduler, warmup_cosine_decay_schedule
from .state import AcceleratorState, GradientState
from .utils.dataclasses import ProjectConfiguration
from .utils.random import set_seed
from .utils.weights import carry_from_jax, params_from_jax

__all__ = [
    "AcceleratedScheduler",
    "Accelerator",
    "AcceleratorState",
    "CausalLM",
    "DataLoader",
    "GradientState",
    "ProjectConfiguration",
    "SequenceClassifier",
    "TransformerConfig",
    "adamw",
    "carry_from_jax",
    "fused_adamw",
    "params_from_jax",
    "set_seed",
    "warmup_cosine_decay_schedule",
]
