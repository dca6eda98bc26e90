"""Multi-tenant adapters: LoRA/QLoRA training and batched multi-adapter
serving over one base model.

Port of ``accelerate_tpu/adapters/``; ``adapter_to_peft`` and
``peft_to_adapter`` (``utils/hf_interop``) are exported here too. Training: :func:`lora_loss_fn` differentiates only the adapter
tree against a frozen (optionally quantized) base, and the adapter tree is
the carry that threads through ``Accelerator.unified_step``. Serving:
:class:`AdapterRegistry` keeps tenants resident in fixed-shape stacks
indexed per slot as data, so one decode program (a CUDA graph on the card)
serves every tenant and is never rebuilt. Checkpoints: small
``adapter_<name>`` artifacts through the atomic commit protocol.
"""

from .checkpoint import adapter_dir, list_adapters, load_adapter, save_adapter
from .lora import (
    ALL_TARGETS,
    LoraConfig,
    adapter_num_bytes,
    adapter_num_params,
    assert_adapter_only,
    build_lora_state,
    init_adapter,
    lora_loss_fn,
    target_shapes,
)
from ..utils.hf_interop import adapter_to_peft, peft_to_adapter
from .registry import AdapterRegistry
from .runtime import LoraState, lora_delta

__all__ = [
    "ALL_TARGETS",
    "AdapterRegistry",
    "LoraConfig",
    "LoraState",
    "adapter_dir",
    "adapter_num_bytes",
    "adapter_num_params",
    "adapter_to_peft",
    "assert_adapter_only",
    "build_lora_state",
    "init_adapter",
    "list_adapters",
    "load_adapter",
    "lora_delta",
    "lora_loss_fn",
    "peft_to_adapter",
    "save_adapter",
    "target_shapes",
]
