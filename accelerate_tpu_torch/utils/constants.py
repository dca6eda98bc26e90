"""Checkpoint file names and the environment prefix.

Port of ``accelerate_tpu/utils/constants.py:10-20``, ``:31-43`` and ``:48``:
the names that ``checkpointing.py`` gives the files of a saved state, kept
so that a directory the port writes is laid out as the reference's, the
mesh's axis names in their outer-to-inner order, and the prefix of the
environment variables the port reads.
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

# The mesh's axes, outermost first (reference :31-43): dp varies slowest and
# tp fastest, so a rank is dp-major and its tp peers are neighbours.
MESH_AXIS_DATA = "dp"
MESH_AXIS_PIPELINE = "pp"
MESH_AXIS_FSDP = "fsdp"
MESH_AXIS_EXPERT = "ep"
MESH_AXIS_SEQUENCE = "sp"
MESH_AXIS_TENSOR = "tp"
MESH_AXES = (
    MESH_AXIS_DATA,
    MESH_AXIS_PIPELINE,
    MESH_AXIS_FSDP,
    MESH_AXIS_EXPERT,
    MESH_AXIS_SEQUENCE,
    MESH_AXIS_TENSOR,
)

ENV_PREFIX = "ACCELERATE_TPU_"
