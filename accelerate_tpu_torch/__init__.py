"""accelerate_tpu_torch: the PyTorch/CUDA port of accelerate_tpu.

The training slice on one NVIDIA H100: ``Accelerator`` (prepare ->
``unified_step``), the Llama-family ``CausalLM`` (with the fused
RMSNorm -> QKV -> rope prologue under ``fused_kernels=True``), the
optax-faithful ``adamw`` and its fused-epilogue form ``fused_adamw``, and
hand-written kernels for Hopper: flash attention
(``ops/csrc/flash_attention.cu``) and the fused prologue and AdamW epilogue
(``ops/csrc/fused.cu``). Imports no JAX; runs on CUDA unless the caller
asks for the CPU (``Accelerator(cpu=True)``).
"""

from .accelerator import Accelerator
from .data_loader import DataLoader
from .models.config import TransformerConfig
from .models.transformer import CausalLM
from .ops.fused import fused_adamw
from .optimizer import adamw
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.weights import params_from_jax

__all__ = [
    "AcceleratedScheduler",
    "Accelerator",
    "AcceleratorState",
    "CausalLM",
    "DataLoader",
    "GradientState",
    "TransformerConfig",
    "adamw",
    "fused_adamw",
    "params_from_jax",
]
