"""Big-model loading and dispatch: a model built without memory, a
checkpoint streamed tensor by tensor onto the card, host memory or disk.

Port of ``accelerate_tpu/big_modeling.py`` (``init_empty_weights`` :48,
``init_on_device`` :56, ``get_max_memory`` :65, ``compute_module_sizes``
:98, ``get_balanced_memory`` :117, ``infer_auto_device_map`` :144,
``_top_level_groups`` :186, ``check_device_map`` :213, ``OffloadedLeaf``
:232, ``materialize_offloaded`` :271, ``streamed_apply`` :308,
``dispatch_params`` :408, ``load_checkpoint_and_dispatch`` :494,
``_lazy_checkpoint_reader`` :583, ``cpu_offload`` :613, ``disk_offload``
:618).

* **Empty init.** ``init_empty_weights`` runs a constructor on the meta
  device: the port's models are then shapes only (``jax.eval_shape`` in the
  reference).
* **Names.** The sizes, groups and device maps work over ``//``-joined
  names of a nested dict, as in the reference. A module stands for its state
  dict, and every dict key is split at its dots, so the port's
  ``layers.3.attn.q_proj.weight`` is ``layers//3//attn//q_proj//weight``.
  The port's layers are one module each where the reference stacks them
  (``nn.scan``), so the depth-2 packing gives one group a layer
  (``layers//<i>``) where the reference's gives one a sub-module stack.
* **Three tiers.** A device index puts a tensor on ``cuda:<i>``; ``"cpu"``
  in pinned host memory when CUDA is present (the reference's
  ``pinned_host``), else in an ordinary CPU tensor; ``"disk"`` writes a
  memmap (``utils/offload.py``) and leaves an :class:`OffloadedLeaf`.
  Compute takes neither of the last two directly: a tree runs through
  :func:`materialize_offloaded` plus ``torch.func.functional_call``, or
  through :func:`streamed_apply`, one layer group at a time.
* **Streaming.** ``load_checkpoint_and_dispatch`` infers the device map
  from the template's shapes at the dtype each tensor will have (read from
  the checkpoint's headers), then reads, casts and places one tensor at a
  time, each shard opened once: the host holds one tensor, where the
  reference first builds the whole host tree (``:574-580``). Placements
  and values are the reference's.

Entry points run on the card unless the caller asks for the CPU: a device
index needs CUDA, and ``get_max_memory`` without CUDA raises unless given
``cpu=True`` (the reference's 4 GiB stand-in for a backend that reports no
memory). The mesh path (``mesh=`` a ``DeviceMesh``, ``plugin=``,
``logical_specs=``; the reference's GSPMD mode) reads each tensor and
keeps this rank's chunk under ``parallel.sharding``'s rules as a DTensor:
a port model's own logical axes apply when none are given. A module so
loaded runs through ``parallel.runtime.apply_sharded``.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Any, Callable, Optional, Union

import torch
from torch import nn

from .checkpointing import _SEP, _rebuild, flatten_tree, parse_size
from .state import resolve_device
from .utils import safetensors_io
from .utils.constants import SAFE_WEIGHTS_INDEX_NAME, SAFE_WEIGHTS_NAME
from .utils.offload import DTYPES, OffloadedWeightsLoader, offload_weight, save_offload_index


# ---------------------------------------------------------------------- #
# empty init — reference :48
# ---------------------------------------------------------------------- #
def init_empty_weights(model_init: Callable, *args, **kwargs) -> Any:
    """``model_init(*args, **kwargs)`` on the meta device: the port's models
    come back as shapes only, no byte allocated and nothing drawn."""
    with torch.device("meta"):
        return model_init(*args, **kwargs)


@contextlib.contextmanager
def init_on_device(device):
    """Build modules with ``device`` as the default device (reference :56)."""
    with torch.device(device):
        yield


# ---------------------------------------------------------------------- #
# trees: a module is its state dict; a name splits every key at its dots
# ---------------------------------------------------------------------- #
def _tree(params: Any) -> Any:
    if isinstance(params, nn.Module):
        return params.state_dict(keep_vars=True)
    return params


def _split(path: str) -> str:
    """A leaf's ``//`` name from its ``flatten_tree`` path (the name the
    checkpoint holds it under): each key split at its dots."""
    return path.replace(".", _SEP)


def _map(fn: Callable, tree: Any) -> Any:
    return _rebuild(_tree(tree), lambda path, leaf: fn(leaf))


def _nested(params: Any) -> dict:
    """The nested dict of ``//`` name parts -> leaf."""
    root: dict = {}
    for path, leaf in flatten_tree(_tree(params)).items():
        *parents, last = _split(path).split(_SEP)
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return root


# ---------------------------------------------------------------------- #
# memory probing — reference :65
# ---------------------------------------------------------------------- #
def _host_bytes() -> int:
    try:
        import psutil

        return psutil.virtual_memory().available
    except ImportError:
        return int(0.8 * os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def get_max_memory(max_memory: Optional[dict] = None, cpu: bool = False
                   ) -> dict[Union[int, str], int]:
    """Usable bytes, ``{device index: bytes, "cpu": bytes}``: 90 % of each
    card's free memory (``torch.cuda.mem_get_info``) and the host's
    available memory. ``max_memory`` overrides (values may be "10GB");
    ``cpu=True`` takes the reference's stand-in of 4 GiB for device 0
    (``:84-86``); else, without CUDA, it raises."""
    if max_memory is not None:
        return {k: parse_size(v) for k, v in max_memory.items()}
    if cpu:
        out: dict[Union[int, str], int] = {0: int(0.9 * (4 << 30))}
    else:
        resolve_device(cpu=False)
        out = {i: int(0.9 * torch.cuda.mem_get_info(i)[0])
               for i in range(torch.cuda.device_count())}
    out["cpu"] = _host_bytes()
    return out


def _nbytes(leaf: Any, dtype_bytes: Optional[int]) -> int:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return 8
    return math.prod(shape) * (dtype_bytes or leaf.dtype.itemsize)


def compute_module_sizes(params: Any, dtype_bytes: Optional[int] = None) -> dict[str, int]:
    """Bytes under every ``//`` name prefix, "" the total (reference :98)."""
    sizes: dict[str, int] = {}
    for path, leaf in flatten_tree(_tree(params)).items():
        nbytes = _nbytes(leaf, dtype_bytes)
        parts = _split(path).split(_SEP)
        for i in range(len(parts) + 1):
            key = _SEP.join(parts[:i])
            sizes[key] = sizes.get(key, 0) + nbytes
    return sizes


def get_balanced_memory(params: Any, max_memory: Optional[dict] = None,
                        no_split_module_classes: Any = None, dtype_bytes: Optional[int] = None,
                        low_zero: bool = False, cpu: bool = False) -> dict:
    """An even split of the model over the devices, so that layers spread
    instead of filling device 0 first (reference :117)."""
    max_memory = get_max_memory(max_memory, cpu=cpu)
    devices = [k for k in max_memory if k != "cpu"]
    total = compute_module_sizes(params, dtype_bytes)[""]
    per_device = total // max(len(devices), 1) + (1 << 20)
    balanced = {}
    for k in max_memory:
        if k == "cpu":
            balanced[k] = max_memory[k]
        elif low_zero and k == devices[0]:
            balanced[k] = min(max_memory[k], per_device // 2)
        else:
            balanced[k] = min(max_memory[k], per_device)
    return balanced


# ---------------------------------------------------------------------- #
# device maps — reference :144
# ---------------------------------------------------------------------- #
def infer_auto_device_map(params: Any, max_memory: Optional[dict] = None,
                          no_split: Optional[list[str]] = None, dtype_bytes: Optional[int] = None,
                          offload_to_disk: bool = True, cpu: bool = False
                          ) -> dict[str, Union[int, str]]:
    """A greedy pack of the groups (``_top_level_groups``) onto the devices
    in order, then "cpu", then "disk" (reference :144)."""
    max_memory = get_max_memory(max_memory, cpu=cpu)
    sizes = compute_module_sizes(params, dtype_bytes)
    groups = _top_level_groups(_nested(params), sizes, no_split or [])
    device_order: list[Union[int, str]] = sorted(k for k in max_memory if k != "cpu")
    device_order.append("cpu")
    if offload_to_disk:
        device_order.append("disk")
    budgets = {k: max_memory.get(k, 0) for k in device_order if k != "disk"}

    device_map: dict[str, Union[int, str]] = {}
    idx = 0
    for name, size in groups:
        while idx < len(device_order):
            dev = device_order[idx]
            if dev == "disk":
                break
            if budgets[dev] >= size:
                budgets[dev] -= size
                break
            idx += 1
        if idx >= len(device_order):
            raise ValueError(f"group {name!r} ({size} B) does not fit anywhere")
        device_map[name] = device_order[idx]
    return device_map


def _top_level_groups(params: Any, sizes: dict[str, int], no_split: list[str]
                      ) -> list[tuple[str, int]]:
    """The groups of the nested ``params``, in order: each child of a
    top-level dict (a leaf or a name in ``no_split`` stays whole), the
    reference's depth-2 packing."""
    if not isinstance(params, dict):
        return [("", sizes[""])]
    groups = []
    for k, sub in params.items():
        if isinstance(sub, dict) and k not in no_split:
            groups += [(k + _SEP + k2, sizes[k + _SEP + k2]) for k2 in sub]
        else:
            groups.append((k, sizes[k]))
    return groups


def _covers(prefix: str, name: str) -> bool:
    return prefix == "" or name == prefix or name.startswith(prefix + _SEP)


def check_device_map(params: Any, device_map: dict) -> None:
    """Every leaf must be under some prefix of ``device_map`` (reference :213)."""
    uncovered = [_split(path) for path in flatten_tree(_tree(params))
                 if not any(_covers(p, _split(path)) for p in device_map)]
    if uncovered:
        raise ValueError(f"device_map does not cover: {uncovered[:5]}"
                         + ("..." if len(uncovered) > 5 else ""))


def _lookup(device_map: dict, name: str):
    """The target of the longest prefix of ``device_map`` covering ``name``."""
    best = None
    for prefix, target in device_map.items():
        if _covers(prefix, name) and (best is None or len(prefix) > len(best[0])):
            best = (prefix, target)
    if best is None:
        raise KeyError(f"no device_map entry covers {name}")
    return best[1]


# ---------------------------------------------------------------------- #
# the disk tier's leaves — reference :232
# ---------------------------------------------------------------------- #
class OffloadedLeaf:
    """A lazy stand-in for one disk-offloaded tensor in a tree. ``load()``
    reads the whole tensor into a CPU tensor; ``memmap()`` gives a CPU
    tensor over the file whose slices read only the bytes they touch, what
    :func:`streamed_apply` uses to hold one layer group at a time."""

    __slots__ = ("name", "loader", "shape", "dtype")

    def __init__(self, name: str, loader, shape, dtype):
        self.name = name
        self.loader = loader
        self.shape = tuple(shape)
        self.dtype = DTYPES[dtype] if isinstance(dtype, str) else dtype

    def load(self) -> torch.Tensor:
        # the .dat file keeps a 0-d tensor as shape (1,)
        return self.loader[self.name].reshape(self.shape)

    def memmap(self) -> torch.Tensor:
        t = self.loader.get_memmap(self.name)
        return t.reshape(self.shape) if tuple(t.shape) != self.shape else t

    def __repr__(self):
        return f"OffloadedLeaf({self.name!r}, {self.shape}, {self.dtype})"


def _device(device) -> torch.device:
    return resolve_device(cpu=False) if device is None else torch.device(device)


def materialize_offloaded(tree: Any, device=None) -> Any:
    """``tree`` with every :class:`OffloadedLeaf` and every host (cpu tier)
    tensor made a live tensor on ``device`` (CUDA unless asked). The peak is
    the whole tree on the device: :func:`streamed_apply` holds one layer
    group. Tensors already on a device pass through."""
    device = _device(device)

    def one(leaf):
        if isinstance(leaf, OffloadedLeaf):
            return leaf.load().to(device)
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu":
            return leaf.to(device)
        return leaf

    return _map(one, tree)


def streamed_apply(block_fn: Callable[[Any, torch.Tensor], torch.Tensor], stacked_params: Any,
                   x: torch.Tensor, group_size: int = 1, device=None) -> torch.Tensor:
    """Run a stack of layers whose weights lie (partly) on the disk or host
    tier, ``group_size`` layers on the device at a time (reference :308).
    Every leaf carries a leading layer dim; ``block_fn(group, x) -> x``
    applies a group whose leaves carry ``<= group_size`` layers. A disk
    leaf's group is sliced from its memmap (only those bytes are read), a
    host leaf's from its tensor, and both are copied to ``device`` (``x``'s
    device when None); the group's tensors are dropped before the next group
    is loaded. Peak device memory: the activations and one group."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    leaves = list(flatten_tree(_tree(stacked_params)).values())
    if not leaves:
        raise ValueError("empty parameter tree")
    for leaf in leaves:
        if len(getattr(leaf, "shape", ())) < 1:
            raise ValueError(
                "streamed_apply requires every leaf to carry a leading stacked-layer dim; got a "
                f"0-dim leaf {leaf!r}: stack scalars to shape (num_layers,) or exclude them")
    num_layers = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != num_layers:
            raise ValueError("streamed_apply requires every leaf to carry the stacked layer dim; "
                             f"got leading dims {num_layers} vs {leaf.shape[0]}")
    device = x.device if device is None else torch.device(device)

    def slice_group(leaf, lo, hi):
        piece = leaf.memmap()[lo:hi] if isinstance(leaf, OffloadedLeaf) else leaf[lo:hi]
        return piece.to(device)

    for lo in range(0, num_layers, group_size):
        hi = min(lo + group_size, num_layers)
        group = _map(lambda leaf: slice_group(leaf, lo, hi), stacked_params)
        x = block_fn(group, x)
        del group  # the group's device tensors go before the next load
    return x


# ---------------------------------------------------------------------- #
# dispatch — reference :408
# ---------------------------------------------------------------------- #
def _place(leaf: Any, target, name: str, offload_dir: Optional[str], index: dict):
    """``leaf`` on ``target``'s tier; None for the disk tier, whose entry
    goes into ``index``."""
    t = torch.as_tensor(leaf).detach()
    if target == "disk":
        if offload_dir is None:
            raise ValueError("offload_dir required for disk offload")
        offload_weight(t, name, offload_dir, index)
        return None
    if target == "cpu":
        if not torch.cuda.is_available():
            return t.to("cpu")
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    resolve_device(cpu=False)
    return t.to(torch.device("cuda", int(target)))


def _with_offloaded(tree: Any, placed: dict, index: dict, offload_dir: Optional[str]) -> Any:
    """``tree``'s structure with each leaf from ``placed`` (by its path), an
    :class:`OffloadedLeaf` for every disk entry of ``index``."""
    if index:
        save_offload_index(index, offload_dir)
        loader = OffloadedWeightsLoader(save_folder=offload_dir)
        for path in placed:
            name = _split(path)
            if name in index:
                placed[path] = OffloadedLeaf(name, loader, index[name]["shape"],
                                             index[name]["dtype"])
    return _rebuild(tree, lambda path, leaf: placed[path])


def dispatch_params(params: Any, device_map: dict[str, Union[int, str]],
                    offload_dir: Optional[str] = None) -> Any:
    """Place each group of ``params`` (a nested dict of tensors, or a
    module's state dict) by ``device_map``: a device index on that card,
    "cpu" in pinned host memory, "disk" a memmap behind an
    :class:`OffloadedLeaf` (reference :408). Returns the same structure."""
    tree = _tree(params)
    check_device_map(tree, device_map)
    placed, index = {}, {}
    for path, leaf in flatten_tree(tree).items():
        name = _split(path)
        placed[path] = _place(leaf, _lookup(device_map, name), name, offload_dir, index)
    return _with_offloaded(tree, placed, index, offload_dir)


# ---------------------------------------------------------------------- #
# load + dispatch — reference :494
# ---------------------------------------------------------------------- #
def load_checkpoint_and_dispatch(model: Any, checkpoint: str, mesh=None, plugin=None,
                                 logical_specs: Any = None,
                                 device_map: Union[str, dict, None] = "auto",
                                 max_memory: Optional[dict] = None,
                                 offload_dir: Optional[str] = None, dtype: Any = None,
                                 config: Any = None, hf_format: Optional[bool] = None) -> Any:
    """Stream a safetensors checkpoint (one file or shards with an index)
    into the tiers of ``device_map`` ("auto" or None: inferred with
    ``max_memory``), one tensor at a time.

    ``model``: a module built by :func:`init_empty_weights` (or any module),
    or a nested dict of (meta) tensors, whose names the checkpoint holds.
    ``dtype`` casts every floating tensor. An HF transformers checkpoint
    (detected, or ``hf_format=True``) is read through
    ``utils/hf_interop.hf_native_reader`` with ``config`` (else the sibling
    ``config.json``), and every tensor of it must be used.

    Returns the module with its parameters assigned when ``model`` is a
    module and every tensor went to a card; else the named tree (a module's
    state dict, or ``model``'s structure), as the reference does.

    ``mesh`` (a ``DeviceMesh``, e.g. ``Accelerator.mesh``): each tensor is
    read and cut to this rank's chunk of its spec (``infer_param_shardings``
    with ``plugin`` and ``logical_specs``, by default the module's own
    logical axes), a DTensor on the mesh; ``device_map`` is not read. A
    module gets the DTensors as its parameters and is returned; a tree comes
    back with DTensor leaves. ``plugin``/``logical_specs`` without a mesh
    raise."""
    from .utils.hf_interop import hf_native_reader, infer_config_from_hf, is_hf_checkpoint

    if mesh is None and (plugin is not None or logical_specs is not None):
        raise ValueError("plugin= and logical_specs= place tensors on a mesh: pass mesh= too")
    if mesh is not None and not hasattr(mesh, "get_group"):
        raise TypeError(f"mesh must be a torch DeviceMesh (Accelerator.mesh), got "
                        f"{type(mesh).__name__}")

    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if hf_format is None:
        hf_format = is_hf_checkpoint(checkpoint)
    if hf_format:
        reader = hf_native_reader(checkpoint, config or infer_config_from_hf(checkpoint))
    else:
        reader = _lazy_checkpoint_reader(checkpoint)
    tree = _tree(model)
    leaves = flatten_tree(tree)

    def load_dtype(stored: torch.dtype) -> torch.dtype:
        return dtype if dtype is not None and stored.is_floating_point else stored

    if mesh is not None:
        return _load_onto_mesh(model, tree, leaves, reader, mesh, plugin, logical_specs,
                               load_dtype)
    placed, index = {}, {}
    with reader:
        if device_map == "auto" or device_map is None:
            # the sizes each tensor will have, from the headers: nothing read
            device_map = infer_auto_device_map(_rebuild(tree, lambda path, leaf: torch.empty(
                leaf.shape, device="meta", dtype=load_dtype(reader.dtype(path)))), max_memory)
        check_device_map(tree, device_map)
        for path, leaf in leaves.items():
            t = reader(path)
            t = t.to(load_dtype(t.dtype))
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint tensor {path!r} has shape {tuple(t.shape)}, the "
                                 f"model {tuple(leaf.shape)}")
            name = _split(path)
            placed[path] = _place(t, _lookup(device_map, name), name, offload_dir, index)
            del t
        leftover = getattr(reader, "unconsumed", lambda: [])()
    if leftover:
        # a tensor the mapping never asked for: the checkpoint holds
        # parameters this architecture cannot represent
        raise ValueError(
            f"HF checkpoint tensors not consumed by the parameter mapping (first 8): "
            f"{leftover[:8]}: the checkpoint's architecture does not match any supported "
            "mapping (Llama/Mixtral)")
    if isinstance(model, nn.Module) and not index and all(
            isinstance(t, torch.Tensor) and t.device.type == "cuda" for t in placed.values()):
        model.load_state_dict(placed, assign=True)
        return model
    return _with_offloaded(tree, placed, index, offload_dir)


def _load_onto_mesh(model, tree, leaves, reader, mesh, plugin, logical_specs, load_dtype):
    """The mesh branch of :func:`load_checkpoint_and_dispatch`: one tensor
    read at a time, this rank's chunk kept (reference :539-549)."""
    from .parallel.sharding import get_logical_specs, infer_param_shardings, shard_params

    if logical_specs is None and isinstance(model, nn.Module):
        logical_specs = get_logical_specs(model)
    specs = infer_param_shardings({k: tuple(v.shape) for k, v in leaves.items()}, mesh, plugin,
                                  logical_specs)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    placed = {}
    with reader:
        for path, leaf in leaves.items():
            t = reader(path)
            t = t.to(load_dtype(t.dtype))
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint tensor {path!r} has shape {tuple(t.shape)}, the "
                                 f"model {tuple(leaf.shape)}")
            placed[path] = shard_params({path: t}, specs, mesh, device=device)[path]
            del t
        leftover = getattr(reader, "unconsumed", lambda: [])()
    if leftover:
        raise ValueError(
            f"HF checkpoint tensors not consumed by the parameter mapping (first 8): "
            f"{leftover[:8]}: the checkpoint's architecture does not match any supported "
            "mapping (Llama/Mixtral)")
    if isinstance(model, nn.Module):
        for name, dt in placed.items():
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            module.register_parameter(leaf, nn.Parameter(dt, requires_grad=False))
        return model
    return _rebuild(tree, lambda path, leaf: placed[path])


def _lazy_checkpoint_reader(checkpoint: str) -> safetensors_io.ShardedReader:
    """name -> tensor over a native checkpoint, each shard opened once and
    read one tensor at a time (reference :583)."""
    return safetensors_io.ShardedReader(safetensors_io.checkpoint_files(
        checkpoint, SAFE_WEIGHTS_INDEX_NAME, SAFE_WEIGHTS_NAME))


def cpu_offload(params: Any) -> Any:
    """The whole tree on the host tier (reference :613)."""
    return dispatch_params(params, {"": "cpu"})


def disk_offload(params: Any, offload_dir: str) -> Any:
    """The whole tree on the disk tier (reference :618)."""
    return dispatch_params(params, {"": "disk"}, offload_dir=offload_dir)
