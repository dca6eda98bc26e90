"""Tree helpers and the cross-process collectives.

Port of ``accelerate_tpu/utils/operations.py``: ``recursively_apply`` :64,
``send_to_device`` :87, ``get_data_structure`` / ``initialize_tensors`` /
``find_batch_size`` / ``find_device`` / ``slice_tensors`` /
``concatenate`` / ``convert_to_fp32`` (:113-174), and the collectives
``gather`` :192, ``gather_object`` :221, ``broadcast`` :241,
``broadcast_object_list`` :257, ``reduce`` :278, ``pad_across_processes``
:301, ``pad_input_tensors`` :333, with the debug-mode checker
``verify_operation`` :352.

Where the reference talks to other processes through
``jax.experimental.multihost_utils``, the port uses the ``torch.distributed``
process group that ``state.PartialState`` brought up (NCCL for tensors on
the card, gloo on the CPU). Without a group, a collective over the one
process returns its input (as a tensor), as the reference's does on one
process, so call sites keep their shape. Every tensor a collective returns
lies on the device of its input.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import numpy as np
import torch


class DistributedOperationException(Exception):
    """Raised by the debug-mode checker when the processes' inputs to a
    collective disagree (reference :35)."""


def is_tensor(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def recursively_apply(func: Callable, data: Any, *args,
                      test_type: Callable[[Any], bool] = is_tensor,
                      error_on_other_type: bool = False, **kwargs) -> Any:
    """``func`` applied to every leaf of a dict/list/tuple tree that passes
    ``test_type``; other leaves are kept (or refused)."""
    if isinstance(data, dict):
        return type(data)({k: recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type,
                                                **kwargs) for k, v in data.items()})
    if isinstance(data, (tuple, list)):
        items = [recursively_apply(func, v, *args, test_type=test_type,
                                   error_on_other_type=error_on_other_type, **kwargs)
                 for v in data]
        return type(data)(*items) if hasattr(data, "_fields") else type(data)(items)
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data)} passed to "
                        f"{getattr(func, '__name__', func)}.")
    return data


def _as_tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _leaves(data: Any) -> list:
    out: list = []
    recursively_apply(out.append, data)
    return out


def send_to_device(data: Any, device: Any, non_blocking: bool = True,
                   skip_keys: Optional[list[str]] = None) -> Any:
    """Every array leaf of a dict/list/tuple tree as a tensor on ``device``."""
    if isinstance(data, dict) and skip_keys:
        return {k: v if k in skip_keys else send_to_device(v, device, non_blocking)
                for k, v in data.items()}
    return recursively_apply(lambda x: _as_tensor(x).to(device, non_blocking=non_blocking),
                             data)


# ---------------------------------------------------------------------- #
# one-process helpers
# ---------------------------------------------------------------------- #
def get_data_structure(data: Any) -> Any:
    """The tree with each tensor replaced by its ``TensorInformation``."""
    from .dataclasses import TensorInformation

    return recursively_apply(lambda x: TensorInformation(shape=tuple(x.shape), dtype=x.dtype),
                             data)


def initialize_tensors(data_structure: Any) -> Any:
    """Zero tensors from ``get_data_structure``'s skeleton (a numpy dtype
    becomes its torch twin)."""
    from .dataclasses import TensorInformation

    def _init(info):
        dtype = info.dtype
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros((), dtype=dtype)).dtype
        return torch.zeros(info.shape, dtype=dtype)

    return recursively_apply(_init, data_structure,
                             test_type=lambda x: isinstance(x, TensorInformation))


def find_batch_size(data: Any) -> Optional[int]:
    """Leading dimension of the first array leaf with one."""
    for leaf in _leaves(data):
        if leaf.ndim > 0:
            return int(leaf.shape[0])
    return None


def find_device(data: Any) -> Optional[torch.device]:
    """The device of the first tensor leaf (None without one)."""
    for leaf in _leaves(data):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def slice_tensors(data: Any, tensor_slice: slice) -> Any:
    """Every array leaf sliced along its first dimension."""
    return recursively_apply(lambda t: t[tensor_slice], data)


def concatenate(data: list[Any], dim: int = 0) -> Any:
    """Trees of one structure concatenated leaf by leaf."""
    first = data[0]
    if isinstance(first, dict):
        return type(first)({k: concatenate([d[k] for d in data], dim) for k in first})
    if isinstance(first, (tuple, list)):
        return type(first)(concatenate([d[i] for d in data], dim) for i in range(len(first)))
    return torch.cat([_as_tensor(d) for d in data], dim=dim)


def convert_to_fp32(data: Any) -> Any:
    """Every floating leaf narrower or other than fp32 cast to fp32."""

    def _upcast(x):
        x = _as_tensor(x)
        return x.float() if x.is_floating_point() and x.dtype != torch.float32 else x

    return recursively_apply(_upcast, data)


# ---------------------------------------------------------------------- #
# collectives
# ---------------------------------------------------------------------- #
def _group():
    """The process state when a process group is up, else None."""
    from ..state import PartialState, group_is_up

    if not group_is_up():
        return None
    return PartialState()


def _on_group_device(x: Any, state) -> torch.Tensor:
    """``x`` as a contiguous tensor the group's backend takes: on the card
    for NCCL, on the CPU for gloo."""
    t = _as_tensor(x)
    want = state.device if state.backend == "nccl" else torch.device("cpu")
    return t.to(want).contiguous()


def _is_sharded(x: Any) -> bool:
    from ..parallel.sharding import is_dtensor

    return is_dtensor(x)


def _whole(x: Any) -> torch.Tensor:
    from ..parallel.runtime import gather_full

    return gather_full(x)


def gather(tensor: Any, group: Any = None) -> Any:
    """Every process's tensors concatenated along dim 0, in rank order, on
    every process (a 0-d tensor gives one value a process). The shapes must
    agree across processes (``pad_across_processes`` first otherwise).
    ``group``: a sub-group of the processes (a mesh's data-parallel ranks)
    instead of all of them. A sharded (DTensor) leaf is one global array
    already: every process gets the whole of it (reference :205-209)."""
    import torch.distributed as dist

    state = _group()

    def _gather_one(x):
        if _is_sharded(x):  # already one global array: every process gets all of it
            return _whole(x)
        t = _as_tensor(x)
        if state is None:
            return t
        src = _on_group_device(t, state)
        n = state.num_processes if group is None else dist.get_world_size(group)
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=group)
        joined = torch.stack(out) if src.dim() == 0 else torch.cat(out, dim=0)
        return joined.to(t.device)

    return recursively_apply(_gather_one, tensor)


def gather_object(object: Any, group: Any = None) -> list[Any]:
    """Every process's picklable object, in rank order (sizes may differ);
    one process: ``[object]``. ``group``: as in :func:`gather`."""
    import torch.distributed as dist

    state = _group()
    if state is None:
        return [object]
    out = [None] * (state.num_processes if group is None else dist.get_world_size(group))
    dist.all_gather_object(out, object, group=group)
    return out


def broadcast(tensor: Any, from_process: int = 0) -> Any:
    """Process ``from_process``'s tensors on every process."""
    import torch.distributed as dist

    state = _group()

    def _one(x):
        t = _as_tensor(x)
        if state is None:
            return t
        buf = _on_group_device(t, state).clone()
        dist.broadcast(buf, src=from_process)
        return buf.to(t.device)

    return recursively_apply(_one, tensor)


def broadcast_object_list(object_list: list[Any], from_process: int = 0) -> list[Any]:
    """``object_list`` filled in place with process ``from_process``'s
    objects, and returned."""
    import torch.distributed as dist

    state = _group()
    if state is None:
        return object_list
    kw = {"device": state.device} if state.backend == "nccl" else {}
    dist.broadcast_object_list(object_list, src=from_process, **kw)
    return object_list


def reduce(tensor: Any, reduction: str = "mean", scale: float = 1.0) -> Any:
    """The elementwise sum over processes times ``scale``; ``"mean"``
    divides that by the number of processes (reference :278). One process:
    its tensor times ``scale``. A sharded (DTensor) leaf is one global array,
    not per-process copies: the whole of it times ``scale``, as the
    reference returns a globally sharded array (:283-287)."""
    import torch.distributed as dist

    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    state = _group()

    def _one(x):
        if _is_sharded(x):  # one global array, not per-process copies: nothing to reduce
            return _whole(x) * scale
        t = _as_tensor(x)
        if state is None:
            return t * scale
        buf = _on_group_device(t, state).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        out = buf * scale
        if reduction == "mean":
            out = out / state.num_processes
        return out.to(t.device)

    return recursively_apply(_one, tensor)


def pad_across_processes(tensor: Any, dim: int = 0, pad_index: int = 0,
                         pad_first: bool = False) -> Any:
    """Each tensor padded with ``pad_index`` along ``dim`` to the largest
    size any process holds there (at the front with ``pad_first``), so a
    fixed-shape ``gather`` can follow. One process: nothing to pad to."""
    state = _group()
    if state is None:
        return tensor

    def _pad_one(x):
        t = _as_tensor(x)
        if dim >= t.dim():
            return t
        sizes = gather(torch.tensor([t.shape[dim]], device=t.device))
        max_size = int(sizes.max())
        if max_size == t.shape[dim]:
            return t
        shape = list(t.shape)
        shape[dim] = max_size
        out = t.new_full(shape, pad_index)
        idx = [slice(None)] * t.dim()
        idx[dim] = (slice(max_size - t.shape[dim], max_size) if pad_first
                    else slice(0, t.shape[dim]))
        out[tuple(idx)] = t
        return out

    return recursively_apply(_pad_one, tensor)


def pad_input_tensors(tensor: Any, batch_size: int, num_processes: int, dim: int = 0) -> Any:
    """The batch padded to a multiple of ``num_processes`` along ``dim`` by
    repeating its last row (leaves whose ``dim`` is not the batch stay)."""
    remainder = batch_size % num_processes
    if remainder == 0:
        return tensor
    pad = num_processes - remainder

    def _pad_one(x):
        t = _as_tensor(x)
        if dim >= t.dim() or t.shape[dim] != batch_size:
            return t
        last = t.narrow(dim, batch_size - 1, 1)
        return torch.cat([t] + [last] * pad, dim=dim)

    return recursively_apply(_pad_one, tensor)


def verify_operation(function: Callable) -> Callable:
    """In debug mode (``ACCELERATE_TPU_DEBUG_MODE``), gather every process's
    input shapes and raise ``DistributedOperationException`` on a mismatch
    before the collective runs, instead of hanging or failing inside it."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        state = _group()
        if state is None or not state.debug or state.num_processes == 1:
            return function(*args, **kwargs)
        tensor = kwargs.get("tensor", args[0] if args else None)
        shapes = recursively_apply(lambda x: tuple(x.shape), tensor)
        all_shapes = gather_object(shapes, group=kwargs.get("group"))
        if not all(s == all_shapes[0] for s in all_shapes):
            raise DistributedOperationException(
                "Cannot apply desired operation due to shape mismatches. All shapes across "
                f"devices must be valid.\n\nOperation: `{function.__name__}`\nInput shapes:\n  - "
                + "\n  - ".join(f"Process {i}: {s}" for i, s in enumerate(all_shapes)))
        return function(*args, **kwargs)

    return wrapper


# the shape-sensitive collectives carry the checker, as in the reference;
# pad_across_processes does not: differing shapes are its job
gather = verify_operation(gather)
broadcast = verify_operation(broadcast)
reduce = verify_operation(reduce)
