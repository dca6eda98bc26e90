"""Migration shims: the reference's plugin names as ``ParallelismPlugin``s.

Port of ``accelerate_tpu/utils/compat.py``: ``DeepSpeedPlugin`` (:42, ZeRO
stages 0-3 to the sharding strategies), ``FullyShardedDataParallelPlugin``
(:83, torch's strategy names and integer codes) and ``MegatronLMPlugin``
(:130, the tp and pp degrees and the microbatches, through the pipeline
validator). A script ported from DeepSpeed, FSDP or Megatron keeps its
constructor call and gets a plain :class:`ParallelismPlugin`; engine
options with no meaning here (offload devices, bucket sizes, ...) are
ignored with the reference's log line.
"""

from __future__ import annotations

from typing import Any, Optional

from ..logging import get_logger
from .dataclasses import ParallelismPlugin, ShardingStrategy

logger = get_logger(__name__)

_ZERO_TO_STRATEGY = {
    0: ShardingStrategy.NO_SHARD,
    1: ShardingStrategy.SHARD_OPT,
    2: ShardingStrategy.SHARD_GRAD_OP,
    3: ShardingStrategy.FULL_SHARD,
}


def _warn_ignored(name: str, kwargs: dict) -> None:
    dropped = {k: v for k, v in kwargs.items() if v is not None}
    if dropped:
        logger.info(f"{name}: ignoring engine-specific options with no equivalent here: "
                    f"{sorted(dropped)}")


def DeepSpeedPlugin(zero_stage: int = 2, gradient_accumulation_steps: Optional[int] = None,
                    offload_optimizer_device: Optional[str] = None,
                    offload_param_device: Optional[str] = None,
                    **ignored: Any) -> ParallelismPlugin:
    """ZeRO stages as sharding strategies: 0 data parallel, 1 the optimizer
    state, 2 and the gradients, 3 and the parameters, every process in the
    sharding group (fsdp takes the world, dp 1)."""
    if zero_stage not in _ZERO_TO_STRATEGY:
        raise ValueError(f"zero_stage must be 0-3, got {zero_stage}")
    if gradient_accumulation_steps is not None:
        logger.info("DeepSpeedPlugin: pass gradient_accumulation_steps="
                    f"{gradient_accumulation_steps} to Accelerator(...); the parallelism "
                    "plugin only describes sharding")
    _warn_ignored("DeepSpeedPlugin", {"offload_optimizer_device": offload_optimizer_device,
                                      "offload_param_device": offload_param_device, **ignored})
    strategy = _ZERO_TO_STRATEGY[zero_stage]
    if zero_stage > 0:
        return ParallelismPlugin(dp_size=1, fsdp_size=-1, sharding_strategy=strategy)
    return ParallelismPlugin(sharding_strategy=strategy)


def FullyShardedDataParallelPlugin(sharding_strategy: Any = "FULL_SHARD",
                                   min_num_params: int = 2**12, cpu_offload: bool = False,
                                   **ignored: Any) -> ParallelismPlugin:
    """torch FSDP's strategy names (or their integer codes 1-4) as
    strategies; ``min_num_params`` is ``min_weight_size``."""
    names = {
        "FULL_SHARD": ShardingStrategy.FULL_SHARD,
        "SHARD_GRAD_OP": ShardingStrategy.SHARD_GRAD_OP,
        "NO_SHARD": ShardingStrategy.NO_SHARD,
        "HYBRID_SHARD": ShardingStrategy.HYBRID_SHARD,
        1: ShardingStrategy.FULL_SHARD,
        2: ShardingStrategy.SHARD_GRAD_OP,
        3: ShardingStrategy.NO_SHARD,
        4: ShardingStrategy.HYBRID_SHARD,
    }
    if isinstance(sharding_strategy, ShardingStrategy):
        key = sharding_strategy
    elif isinstance(sharding_strategy, str):
        key = sharding_strategy.upper().replace("SHARDINGSTRATEGY.", "")
    else:
        key = sharding_strategy
    if isinstance(key, ShardingStrategy):
        strategy = key
    elif key in names:
        strategy = names[key]
    else:
        raise ValueError(f"unknown sharding_strategy {sharding_strategy!r}")
    if cpu_offload:
        logger.info("FullyShardedDataParallelPlugin: cpu_offload maps to the big-model host "
                    "tier (big_modeling.cpu_offload), not the train-step plugin")
    _warn_ignored("FullyShardedDataParallelPlugin", ignored)
    if strategy is ShardingStrategy.NO_SHARD:
        return ParallelismPlugin(sharding_strategy=strategy, min_weight_size=min_num_params)
    return ParallelismPlugin(dp_size=1, fsdp_size=-1, sharding_strategy=strategy,
                             min_weight_size=min_num_params)


def MegatronLMPlugin(tp_degree: int = 1, pp_degree: int = 1, num_micro_batches: int = 1,
                     sequence_parallelism: bool = False, num_experts: Optional[int] = None,
                     **ignored: Any) -> ParallelismPlugin:
    """Megatron's degrees (reference :130-170): tensor and pipeline degrees
    and the microbatches (clamped up to ``pp_degree``) carry over;
    model-definition options (num_layers, hidden_size, ...) belong to
    ``TransformerConfig`` and are ignored. The plugin goes through the
    pipeline validator here, where the migration's context is visible."""
    if sequence_parallelism:
        logger.info("MegatronLMPlugin: sequence_parallelism maps to the sp mesh axis (ring "
                    "attention); set ParallelismPlugin.sp_size explicitly")
    if num_experts and num_experts > 1:
        logger.info("MegatronLMPlugin: expert parallelism is the ep mesh axis; set "
                    "ParallelismPlugin.ep_size to shard experts")
    _warn_ignored("MegatronLMPlugin", ignored)
    plugin = ParallelismPlugin(tp_size=tp_degree, pp_size=pp_degree,
                               num_micro_batches=max(num_micro_batches, pp_degree))
    from ..parallel.pipeline import validate_pipeline_plugin

    try:
        validate_pipeline_plugin(plugin)
    except NotImplementedError as e:
        raise NotImplementedError(
            f"MegatronLMPlugin(tp_degree={tp_degree}, pp_degree={pp_degree}): {e}") from None
    return plugin
