"""accelerate_tpu_torch: the PyTorch/CUDA port of accelerate_tpu.

The training slice on one NVIDIA H100: ``Accelerator`` (prepare ->
``unified_step``), the Llama-family ``CausalLM``, the optax-faithful
``adamw``, and hand-written flash-attention kernels for Hopper
(``ops/csrc/flash_attention.cu``). Imports no JAX; runs on CUDA unless the
caller asks for the CPU (``Accelerator(cpu=True)``).
"""

from .accelerator import Accelerator
from .data_loader import DataLoader
from .models.config import TransformerConfig
from .models.transformer import CausalLM
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
    "params_from_jax",
]
