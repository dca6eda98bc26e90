"""Checkpoint file names.

Port of ``accelerate_tpu/utils/constants.py:10-20``: the names that
``checkpointing.py`` gives the files of a saved state, kept so that a
directory the port writes is laid out as the reference's.
"""

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
RNG_STATE_NAME = "random_states"
CUSTOM_STATE_NAME = "custom_checkpoint"
METADATA_NAME = "accelerate_state.json"

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
