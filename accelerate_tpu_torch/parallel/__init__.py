from .mesh import (
    build_mesh,
    data_axes,
    mesh_axis_size,
    mesh_coordinate,
    resolve_mesh_shape,
    single_device_mesh,
)
from .sharding import (
    DEFAULT_LOGICAL_RULES,
    batch_sharding,
    get_logical_specs,
    grad_buffer_shardings,
    infer_opt_state_shardings,
    infer_param_shardings,
    mesh_axes_of_params,
    replicated,
    shard_params,
    shardings_of,
)
