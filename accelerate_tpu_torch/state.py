"""Process, accelerator and gradient state of one training process.

Port of ``accelerate_tpu/state.py`` (``_maybe_init_distributed`` :38-91,
``PartialState`` :94 with its process predicates and helpers :172-276,
``AcceleratorState`` :282, ``GradientState`` :377). The three are
shared-state singletons, as in the reference: every instance reads and
writes one dict, reset with ``_reset_state``.

A process drives one device: CUDA device ``cuda:<local_process_index>``
unless the caller asks for the CPU (``cpu=True``); with no CUDA device the
default raises instead of falling back to the CPU. Where the reference
brings up ``jax.distributed``, the port brings up a ``torch.distributed``
process group, when the launcher's environment (``ACCELERATE_TPU_NUM_PROCESSES``,
``_PROCESS_ID``, ``_COORDINATOR_ADDRESS``, ``_LOCAL_PROCESS_INDEX``) or a
``DistributedInitKwargs`` names a coordinator or more than one process: the
coordinator's ``host:port`` is the TCP rendezvous, the backend NCCL on the
card and gloo under ``cpu=True`` (picked once, from the device), and
``num_processes``, ``process_index`` and ``distributed_type`` come from the
group. A group that fails to come up raises: unlike the reference's
single-process fallback (:87-91), a run asked for N processes never trains
as one. A group of one is still a group, so its collectives run. Under a
``ParallelismPlugin`` ``AcceleratorState`` builds the device mesh over the
group (``parallel/mesh.py``); a single process given a plugin and no
launcher environment brings up a group of one on a free localhost port, and
an axis the port does not run yet raises before any group comes up.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from functools import wraps
from typing import Any, Callable, Optional

import torch

from .utils.constants import ENV_PREFIX, MESH_AXIS_DATA
from .utils.dataclasses import (
    DataLoaderConfiguration,
    DistributedInitKwargs,
    DistributedType,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
)
from .utils.environment import parse_flag_from_env


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(ENV_PREFIX + name, "").strip()
    return int(value) if value else None


def resolve_device(cpu: bool, local_index: Optional[int] = None) -> torch.device:
    """``cuda:<local_index>`` (the current CUDA device when no index is
    given) unless ``cpu``; raises when CUDA is asked for and absent."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: accelerate_tpu_torch runs on the GPU unless asked "
            "for the CPU (Accelerator(cpu=True))"
        )
    index = torch.cuda.current_device() if local_index is None else local_index
    return torch.device("cuda", index)


def group_is_up() -> bool:
    """Whether a ``torch.distributed`` process group is initialized."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def current_process_index() -> int:
    """This process's rank in the process group (0 without one), read
    without making a ``PartialState``."""
    if group_is_up():
        import torch.distributed as dist

        return dist.get_rank()
    return 0


def maybe_init_process_group(kwargs: Optional[DistributedInitKwargs],
                             device: torch.device) -> bool:
    """Bring up the process group the launcher asked for; returns whether
    one is up. Nothing is asked for when no coordinator is named and at
    most one process: then nothing is started. A group someone else
    started is taken as it is. The rendezvous is ``tcp://<coordinator>``;
    a failure raises (no single-process fallback)."""
    import torch.distributed as dist

    if group_is_up():
        return True
    num = kwargs.num_processes if kwargs is not None and kwargs.num_processes else None
    if num is None:
        num = _env_int("NUM_PROCESSES")
    coord = (kwargs.coordinator_address if kwargs is not None else None) or os.environ.get(
        ENV_PREFIX + "COORDINATOR_ADDRESS", "").strip()
    if not coord and (num is None or num <= 1):
        return False
    if not coord:
        raise ValueError(f"{num} processes asked for without a coordinator address "
                         f"({ENV_PREFIX}COORDINATOR_ADDRESS or DistributedInitKwargs)")
    num = num or 1
    pid = kwargs.process_id if kwargs is not None and kwargs.process_id is not None else None
    if pid is None:
        pid = _env_int("PROCESS_ID")
    if pid is None:
        if num != 1:
            raise ValueError(f"{num} processes asked for without this process's index "
                             f"({ENV_PREFIX}PROCESS_ID or DistributedInitKwargs.process_id)")
        pid = 0
    timeout = (kwargs or DistributedInitKwargs()).initialization_timeout
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{coord}", world_size=num, rank=pid,
                            timeout=timeout)
    return True


class PartialState:
    """Process topology: this process's device and, when a process group is
    up, its rank and the world's size. ``PartialState(cpu, init_kwargs=)``
    takes a ``DistributedInitKwargs``."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        init_kwargs = kwargs.get("init_kwargs")
        local = _env_int("LOCAL_PROCESS_INDEX")  # this process's device on its host
        device = resolve_device(cpu, local)
        # the group first: a bring-up that raises leaves no state behind
        if maybe_init_process_group(init_kwargs, device):
            import torch.distributed as dist

            backend, world, rank = dist.get_backend(), dist.get_world_size(), dist.get_rank()
            kind = DistributedType.MULTI_GPU if backend == "nccl" else DistributedType.MULTI_CPU
        else:
            backend, world, rank, kind = None, 1, 0, DistributedType.NO
        self.debug = parse_flag_from_env(ENV_PREFIX + "DEBUG_MODE")
        self.local_process_index = local or 0
        self.device = device
        self.backend = backend
        self.num_processes = world
        self.process_index = rank
        self.num_devices = world
        self.distributed_type = kind

    @property
    def initialized(self) -> bool:
        return "distributed_type" in self.__dict__

    @staticmethod
    def _reset_state():
        """Forget the topology; a process group stays up (the next state
        reads it back), ``destroy_process_group`` ends it."""
        PartialState._shared_state.clear()

    def __repr__(self) -> str:
        return (
            f"Distributed environment: {self.distributed_type.value}\n"
            f"Num processes: {self.num_processes}\n"
            f"Process index: {self.process_index}\n"
            f"Device: {self.device}\n"
        )

    # ------------------------------------------------------------------ #
    # process predicates
    # ------------------------------------------------------------------ #
    @property
    def use_distributed(self) -> bool:
        return self.num_processes > 1 or self.num_devices > 1

    @property
    def group_up(self) -> bool:
        """Whether this state runs over a process group (any world size)."""
        return self.distributed_type != DistributedType.NO

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    # ------------------------------------------------------------------ #
    # process control
    # ------------------------------------------------------------------ #
    def wait_for_everyone(self) -> None:
        """The cross-process barrier (reference :182); without a group, a
        no-op."""
        if self.group_up:
            import torch.distributed as dist

            if self.device.type == "cuda":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    @contextmanager
    def main_process_first(self):
        """The main process runs the body before the others (reference
        :190)."""
        if not self.is_main_process:
            self.wait_for_everyone()
        yield
        if self.is_main_process:
            self.wait_for_everyone()

    @contextmanager
    def local_main_process_first(self):
        if not self.is_local_main_process:
            self.wait_for_everyone()
        yield
        if self.is_local_main_process:
            self.wait_for_everyone()

    def on_main_process(self, function: Callable) -> Callable:
        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.is_main_process:
                return function(*args, **kwargs)

        return wrapper

    def on_local_main_process(self, function: Callable) -> Callable:
        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.is_local_main_process:
                return function(*args, **kwargs)

        return wrapper

    def on_process(self, function: Callable, process_index: int = 0) -> Callable:
        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.process_index == process_index:
                return function(*args, **kwargs)

        return wrapper

    @contextmanager
    def split_between_processes(self, inputs: Any, apply_padding: bool = False):
        """This process's share of a list, tuple or dict (reference :235):
        the first ``len % num_processes`` processes take one item more. With
        ``apply_padding`` the short shares repeat the last item, so every
        process holds the same count."""
        if self.num_processes == 1:
            yield inputs
            return
        if isinstance(inputs, dict):
            split = {}
            with self.split_between_processes(list(zip(*inputs.values())),
                                              apply_padding) as rows:
                for i, key in enumerate(inputs.keys()):
                    split[key] = [row[i] for row in rows]
            yield split
            return
        length = len(inputs)
        base, extra = divmod(length, self.num_processes)
        start = self.process_index * base + min(self.process_index, extra)
        end = start + base + (1 if self.process_index < extra else 0)
        chunk = inputs[start:end]
        if apply_padding and extra != 0:
            target = base + 1
            if len(chunk) < target and length:
                chunk = list(chunk) + inputs[-1:] * (target - len(chunk))
        yield chunk

    def print(self, *args, **kwargs) -> None:
        """Print on the main process only."""
        if self.is_main_process:
            print(*args, **kwargs)

    def destroy_process_group(self) -> None:
        """End the process group, if one is up (reference :271)."""
        if group_is_up():
            import torch.distributed as dist

            dist.destroy_process_group()


def _group_of_one() -> DistributedInitKwargs:
    """A process group of one on a free localhost port (a mesh needs a
    group; a single process given a plugin brings up its own)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return DistributedInitKwargs(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                                 process_id=0)


class AcceleratorState:
    """PartialState plus the precision policy, the loader configuration
    and, under a ``ParallelismPlugin``, the device mesh (reference
    :292-346): ``mesh``, ``data_axis_names`` and ``data_parallel_size``
    (dp x fsdp), and this process's ``data_parallel_rank``. The mesh is a
    ``DeviceMesh`` over the process group; a single process given a plugin
    and no launcher environment brings up a group of one. Without a plugin
    there is no mesh and the data-parallel ranks are the processes."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False,
                 dataloader_config: Optional[DataLoaderConfiguration] = None,
                 parallelism_plugin: Any = None, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        if parallelism_plugin is not None:
            from .parallel.mesh import check_ported

            check_ported(parallelism_plugin.mesh_shape)  # before any group comes up
        own_group = False
        if (parallelism_plugin is not None and kwargs.get("init_kwargs") is None
                and not group_is_up() and not PartialState._shared_state
                and not os.environ.get(ENV_PREFIX + "COORDINATOR_ADDRESS", "").strip()
                and (_env_int("NUM_PROCESSES") or 1) == 1):
            kwargs["init_kwargs"] = _group_of_one()
            own_group = True
        partial = PartialState(cpu, **kwargs)
        if parallelism_plugin is not None and not partial.group_up:
            raise RuntimeError(
                "a ParallelismPlugin needs a process group, and this process's state was made "
                "without one: make the Accelerator (or AcceleratorState) with the plugin before "
                "any PartialState, or launch the processes with a coordinator")
        self.partial_state = partial
        self.dataloader_config = dataloader_config or DataLoaderConfiguration()
        if mixed_precision is None:  # the launcher's setting, as the reference reads it
            mixed_precision = os.environ.get(ENV_PREFIX + "MIXED_PRECISION", "no")
        self.mixed_precision = PrecisionType(mixed_precision)
        self.mixed_precision_policy = MixedPrecisionPolicy.from_precision(
            self.mixed_precision
        )
        self.parallelism_plugin = parallelism_plugin
        if parallelism_plugin is None:
            self.mesh = None
            self.data_axis_names = (MESH_AXIS_DATA,)
            self.data_parallel_size = partial.num_processes
            self.data_parallel_rank = partial.process_index
        else:
            from .parallel.mesh import (
                build_mesh,
                data_axes,
                mesh_axis_size,
                mesh_coordinate,
                mesh_shape_of,
            )

            try:
                self.mesh = build_mesh(parallelism_plugin)
            except BaseException:
                # leave nothing half set up: the state, and a group of one
                # brought up for this plugin
                self._shared_state.clear()
                if own_group:
                    partial.destroy_process_group()
                    PartialState._reset_state()
                raise
            self.data_axis_names = data_axes(self.mesh)
            self.data_parallel_size = mesh_axis_size(self.mesh, *self.data_axis_names)
            shape = mesh_shape_of(self.mesh)
            coord = mesh_coordinate(partial.process_index, shape)
            rank = 0
            for axis in self.data_axis_names:
                rank = rank * shape[axis] + coord[axis]
            self.data_parallel_rank = rank

    @property
    def initialized(self) -> bool:
        return "partial_state" in self.__dict__

    @staticmethod
    def _reset_state(reset_partial_state: bool = False):
        AcceleratorState._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()

    def __getattr__(self, name: str):
        # process topology is delegated to PartialState
        if name in ("partial_state", "initialized") or name.startswith("__"):
            raise AttributeError(name)
        ps = self.__dict__.get("partial_state")
        if ps is not None and hasattr(ps, name):
            return getattr(ps, name)
        raise AttributeError(f"'AcceleratorState' object has no attribute '{name}'")

    def __repr__(self) -> str:
        out = repr(self.partial_state) + f"Mixed precision: {self.mixed_precision.value}\n"
        if self.mesh is not None:
            from .parallel.mesh import mesh_shape_of

            out += f"Mesh: {mesh_shape_of(self.mesh)}\n"
        return out


class GradientState:
    """Gradient-accumulation bookkeeping shared by the Accelerator, the
    optimizer, the scheduler and the loaders: the plugin's settings (the
    accumulation length, ``fused``, ``sync_with_dataloader``,
    ``sync_each_batch``, ``adjust_scheduler``), whether the last step was an
    optimizer boundary, and the loader being iterated, whose
    ``end_of_dataloader`` and ``remainder`` ``accumulate`` and
    ``gather_for_metrics`` read (reference ``state.py:377-475``)."""

    _shared_state: dict[str, Any] = {}

    def __init__(
        self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None
    ):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references: list[Any] = [None]
            self.plugin_kwargs: dict[str, Any] = {}
            self.num_steps = 1
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_kwargs()
            self.num_steps = gradient_accumulation_plugin.num_steps

    @property
    def initialized(self) -> bool:
        return "sync_gradients" in self.__dict__

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin_kwargs.get("adjust_scheduler", True)

    @property
    def sync_each_batch(self) -> bool:
        return self.plugin_kwargs.get("sync_each_batch", False)

    @property
    def fused(self) -> bool:
        """Whether accumulation runs fused: one step call per optimizer step
        over a stacked ``[num_steps, micro, ...]`` batch. Falls back to the
        ``ACCELERATE_TPU_FUSED_ACCUM`` flag, since ``plugin_kwargs`` keeps
        only the fields that differ from the defaults."""
        if "fused" in self.plugin_kwargs:
            return self.plugin_kwargs["fused"]
        return parse_flag_from_env(ENV_PREFIX + "FUSED_ACCUM")

    @property
    def end_of_dataloader(self) -> bool:
        return self.active_dataloader is not None and getattr(
            self.active_dataloader, "end_of_dataloader", False)

    @property
    def remainder(self) -> int:
        if self.active_dataloader is None:
            return -1
        return getattr(self.active_dataloader, "remainder", -1)

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    def _add_dataloader(self, dataloader) -> None:
        self.dataloader_references.append(dataloader)
        self.active_dataloader = dataloader

    def _remove_dataloader(self, dataloader) -> None:
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]

    @staticmethod
    def _reset_state():
        GradientState._shared_state.clear()
