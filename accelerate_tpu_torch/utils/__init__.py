"""Utilities: the plugins and dataclasses, the mesh constants, the
collectives, profiling, quantization, RNG and HF-checkpoint interop.

Port of ``accelerate_tpu/utils/__init__.py``: the same names, each read
from its module on first use (PEP 562), so that importing one utils
module never imports the rest, and no module of the package meets a
half-initialised ``utils`` through an import cycle. Not ported yet
(ROADMAP.md): ``CompilePlugin`` and ``ComputeEnvironment`` and, of
``environment.py``, ``get_tpu_info``, ``get_hbm_bytes_per_device``,
``patch_environment``, ``clear_environment``, ``get_int_from_env`` and
``parse_choice_from_env`` (queue A10).
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "compat": ("DeepSpeedPlugin", "FullyShardedDataParallelPlugin", "MegatronLMPlugin"),
    "constants": ("MESH_AXES", "MESH_AXIS_DATA", "MESH_AXIS_EXPERT", "MESH_AXIS_FSDP",
                  "MESH_AXIS_PIPELINE", "MESH_AXIS_SEQUENCE", "MESH_AXIS_TENSOR"),
    "dataclasses": ("DataLoaderConfiguration", "DistributedInitKwargs", "DistributedType",
                    "GradientAccumulationPlugin", "KwargsHandler", "LoggerType",
                    "MixedPrecisionPolicy", "ParallelismPlugin", "PrecisionType",
                    "ProjectConfiguration", "RNGType", "ShardingStrategy",
                    "TensorInformation"),
    "hf_interop": ("hf_native_reader", "infer_config_from_hf", "is_hf_checkpoint",
                   "native_to_hf", "save_hf_checkpoint"),
    "environment": ("parse_flag_from_env", "str_to_bool"),
    "operations": ("DistributedOperationException", "broadcast", "broadcast_object_list",
                   "concatenate", "convert_to_fp32", "find_batch_size", "find_device", "gather",
                   "gather_object", "get_data_structure", "initialize_tensors", "is_tensor",
                   "pad_across_processes", "pad_input_tensors", "recursively_apply", "reduce",
                   "send_to_device", "slice_tensors"),
    "profiling": ("ProfileKwargs", "StepTimer", "annotate", "end_measure", "profile",
                  "start_measure"),
    "quantization": ("QuantizationConfig", "QuantizedTensor", "dequantize_tree",
                     "load_and_quantize_model", "quantize_params", "quantized_apply"),
    "random": ("KeyChain", "set_seed", "synchronize_rng_state", "synchronize_rng_states"),
}
_WHERE = {name: module for module, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    module = _WHERE.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
