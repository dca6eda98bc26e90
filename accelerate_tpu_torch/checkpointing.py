"""Whole-training-state checkpointing, one process.

Port of ``accelerate_tpu/checkpointing.py:57-743`` for one process. The
training state is one tree, the step carry (params, optimizer state,
counters, the loss scale under fp16), so a checkpoint is "flatten the tree
-> named tensors -> safetensors" (``flatten_tree`` :70; the default format
is ``dist_checkpoint.py``'s), and a restore fills a template of the same
structure (``unflatten_into`` :75). Host state (schedulers, loader
positions, registered objects, metadata, RNG) keeps the reference's
file-per-object names (``utils/constants.py``). Every file is written into
``<dir>.tmp`` and published by the commit protocol
(``checkpoint_async/commit.py``).

A restore writes the checkpoint's values into the template's tensors in
place (the carry's params are the model's parameters), and returns the
template's structure with its Python counters replaced.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import random as _py_random
import re
import shutil
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from . import dist_checkpoint
from .checkpoint_async import commit
from .logging import get_logger
from .utils import safetensors_io
from .utils.constants import (
    CUSTOM_STATE_NAME,
    METADATA_NAME,
    MODEL_NAME,
    OPTIMIZER_NAME,
    RNG_STATE_NAME,
    SAFE_WEIGHTS_INDEX_NAME,
    SAFE_WEIGHTS_NAME,
    SAMPLER_NAME,
    SCHEDULER_NAME,
)

logger = get_logger(__name__)

_SEP = "//"  # path separator in flattened names
# leaves a checkpoint holds (strings and other objects are skipped)
_STORABLE = (torch.Tensor, np.ndarray, np.generic, int, float, bool)


# ---------------------------------------------------------------------- #
# tree <-> named leaves
# ---------------------------------------------------------------------- #
def _children(tree: Any) -> Optional[list[tuple[str, Any]]]:
    """(name, child) pairs of a container node, or None for a leaf: dicts by
    key, lists and tuples by index, dataclasses by field name."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _rebuild(tree: Any, fn: Callable[[str, Any], Any], prefix: str = "") -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``; None stays."""
    children = _children(tree)
    if children is None:
        return None if tree is None else fn(prefix or "__root__", tree)
    new = {name: _rebuild(child, fn, f"{prefix}{_SEP}{name}" if prefix else name)
           for name, child in children}
    if isinstance(tree, dict):
        return type(tree)((k, new[str(k)]) for k in tree)
    if isinstance(tree, (list, tuple)):
        items = [new[str(i)] for i in range(len(tree))]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return dataclasses.replace(tree, **new)


def flatten_tree(tree: Any) -> dict[str, Any]:
    """Tree -> {path: leaf} with deterministic, invertible names
    (``layers.0.attn.q_proj.weight`` under ``params`` is
    ``params//layers.0.attn.q_proj.weight``); None leaves are dropped."""
    named: dict[str, Any] = {}
    _rebuild(tree, lambda path, leaf: named.__setitem__(path, leaf))
    return named


def _restore_leaf(key: str, tleaf: Any, value: Any) -> Any:
    """``value`` in the form of the template leaf ``tleaf``: a tensor is
    written into ``tleaf`` in place; a Python number is returned as one."""
    value = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    if isinstance(tleaf, torch.Tensor):
        if tuple(value.shape) != tuple(tleaf.shape):
            # only 1-element leaves may be reshaped; anything else is corruption
            if value.numel() == tleaf.numel() == 1:
                value = value.reshape(tleaf.shape)
            else:
                raise ValueError(f"checkpoint tensor {key!r} has shape {tuple(value.shape)}, "
                                 f"template expects {tuple(tleaf.shape)}")
        with torch.no_grad():
            tleaf.copy_(value)
        return tleaf
    if isinstance(tleaf, (bool, int, float, np.generic)):
        return type(tleaf)(value.item())
    if isinstance(tleaf, np.ndarray):
        return value.numpy().astype(tleaf.dtype).reshape(tleaf.shape)
    return tleaf


def unflatten_into(template: Any, named: dict[str, Any], strict: bool = True) -> Any:
    """Fill ``template``'s structure from ``named``. Tensor leaves receive
    their values in place; ``strict=False`` keeps the template's value for
    a leaf ``named`` lacks (a carry that grew a leaf since the save)."""

    def fill(key, tleaf):
        if key not in named:
            if strict and isinstance(tleaf, _STORABLE):
                raise KeyError(f"checkpoint missing tensor {key!r}")
            return tleaf
        return _restore_leaf(key, tleaf, named[key])

    return _rebuild(template, fill)


def _tree_of(obj: Any) -> Any:
    """A module stands for its state dict."""
    return obj.state_dict() if isinstance(obj, nn.Module) else obj


def _to_named_tensors(tree: Any) -> dict[str, torch.Tensor]:
    """Every storable leaf of ``tree`` as a named host tensor."""
    out = {}
    for key, leaf in flatten_tree(_tree_of(tree)).items():
        t = dist_checkpoint.as_tensor_leaf(leaf)
        if t is not None:
            out[key] = t
    return out


# ---------------------------------------------------------------------- #
# atomic small-file io
# ---------------------------------------------------------------------- #
def _atomic_write(path: str, write_fn, mode: str = "w") -> None:
    """Write through a same-dir tmp file + ``os.replace``: a crash never
    leaves a truncated file under the real name."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _atomic_json_dump(obj: Any, path: str, **kwargs) -> None:
    _atomic_write(path, lambda f: json.dump(obj, f, **kwargs))


def _atomic_pickle_dump(obj: Any, path: str) -> None:
    _atomic_write(path, lambda f: pickle.dump(obj, f), mode="wb")


def _save_named(named: dict[str, torch.Tensor], path: str, safe: bool = True) -> None:
    if safe:
        safetensors_io.save_file(named, path)
    else:
        _atomic_pickle_dump(named, path)


def _load_named(path: str) -> dict[str, torch.Tensor]:
    """Tensors of a file this module wrote (safetensors, or its own pickle)."""
    if path.endswith(".safetensors"):
        return safetensors_io.load_file(path)
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------- #
# model weights, sharded by size
# ---------------------------------------------------------------------- #
def parse_size(size: str | int) -> int:
    if isinstance(size, int):
        return size
    m = re.fullmatch(r"(\d+\.?\d*)\s*([KMGT]?B)", size.strip(), re.IGNORECASE)
    if not m:
        raise ValueError(f"unparseable size {size!r}")
    mult = {"B": 1, "KB": 2**10, "MB": 2**20, "GB": 2**30, "TB": 2**40}
    return int(float(m.group(1)) * mult[m.group(2).upper()])


def shard_checkpoint(named: dict[str, torch.Tensor], max_shard_size: str | int = "10GB",
                     weights_name: str = SAFE_WEIGHTS_NAME
                     ) -> tuple[list[dict[str, torch.Tensor]], Optional[dict]]:
    """Greedy split of named tensors into shards of at most
    ``max_shard_size`` (a larger tensor gets a shard of its own), and the
    index naming each tensor's file (None for one shard)."""
    limit = parse_size(max_shard_size)
    shards: list[dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for key, t in named.items():
        nbytes = t.numel() * t.element_size()
        if sizes[-1] + nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][key] = t
        sizes[-1] += nbytes
    if len(shards) == 1:
        return shards, None
    index = {"metadata": {"total_size": int(sum(sizes))}, "weight_map": {}}
    stem, ext = os.path.splitext(weights_name)
    for i, shard in enumerate(shards):
        for key in shard:
            index["weight_map"][key] = f"{stem}-{i + 1:05d}-of-{len(shards):05d}{ext}"
    return shards, index


def save_model_weights(params: Any, save_directory: str, max_shard_size: str | int = "10GB",
                       safe_serialization: bool = True) -> None:
    """Weight files (sharded by size, with an index) of a module or tree."""
    os.makedirs(save_directory, exist_ok=True)
    named = _to_named_tensors(params)
    weights_name = SAFE_WEIGHTS_NAME if safe_serialization else MODEL_NAME + ".bin"
    shards, index = shard_checkpoint(named, max_shard_size, weights_name)
    if index is None:
        _save_named(shards[0], os.path.join(save_directory, weights_name), safe_serialization)
        return
    stem, ext = os.path.splitext(weights_name)
    for i, shard in enumerate(shards):
        name = f"{stem}-{i + 1:05d}-of-{len(shards):05d}{ext}"
        _save_named(shard, os.path.join(save_directory, name), safe_serialization)
    _atomic_json_dump(index, os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME), indent=2,
                      sort_keys=True)


def load_model_weights(load_directory: str) -> dict[str, torch.Tensor]:
    """The named tensors that ``save_model_weights`` wrote."""
    index_path = os.path.join(load_directory, SAFE_WEIGHTS_INDEX_NAME)
    if os.path.isfile(index_path):
        with open(index_path) as f:
            index = json.load(f)
        named: dict[str, torch.Tensor] = {}
        for fname in sorted(set(index["weight_map"].values())):
            named.update(_load_named(os.path.join(load_directory, fname)))
        return named
    for candidate in (SAFE_WEIGHTS_NAME, MODEL_NAME + ".bin"):
        path = os.path.join(load_directory, candidate)
        if os.path.isfile(path):
            return _load_named(path)
    raise FileNotFoundError(f"no model weights found under {load_directory}")


# ---------------------------------------------------------------------- #
# whole-state save/load
# ---------------------------------------------------------------------- #
def _list_checkpoints(base: str) -> list[str]:
    """Committed ``checkpoint_<n>`` dirs under ``base``, oldest first: a
    ``.tmp`` work dir never matches, and a dir without ``COMMITTED`` is
    not counted."""
    entries = []
    for name in os.listdir(base):
        m = re.fullmatch(r"checkpoint_(\d+)", name)
        path = os.path.join(base, name)
        if m and commit.is_committed(path):
            entries.append((int(m.group(1)), path))
    return [p for _, p in sorted(entries)]


def _checkpoint_dir(accelerator, output_dir: Optional[str]) -> str:
    """The directory a save goes to: ``<project_dir>/checkpoints/
    checkpoint_<iteration>`` with automatic naming (the oldest beyond
    ``total_limit`` removed first), else ``output_dir``."""
    pc = accelerator.project_configuration
    if not pc.automatic_checkpoint_naming:
        if output_dir is None:
            raise ValueError("output_dir required without automatic_checkpoint_naming")
        return output_dir
    base = os.path.join(pc.project_dir or output_dir or ".", "checkpoints")
    out = os.path.join(base, f"checkpoint_{pc.iteration}")
    os.makedirs(base, exist_ok=True)
    existing = _list_checkpoints(base)
    if pc.total_limit is not None and len(existing) + 1 > pc.total_limit:
        for stale in existing[: len(existing) + 1 - pc.total_limit]:
            logger.info(f"Deleting {stale} to respect total_limit={pc.total_limit}")
            shutil.rmtree(stale, ignore_errors=True)
    if os.path.exists(out):
        raise ValueError(f"Checkpoint directory {out} already exists: either load it first "
                         "or set a fresh ProjectConfiguration.iteration.")
    return out


def topology_metadata(accelerator) -> dict[str, Any]:
    """The save-time topology record: one process on one device."""
    return {
        "format_version": 2, "world_size": 1, "num_devices": 1, "devices_per_process": 1,
        "num_slices": 1, "mesh_shape": {},
        "process_shard_files": {"0": {
            "shard": dist_checkpoint.SHARD_FILE_PATTERN.format(0),
            "index": dist_checkpoint.INDEX_FILE_PATTERN.format(0), "fault_domain": 0}},
        "step": accelerator.step,
    }


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj.tolist()
    return obj


def _rng_state(accelerator) -> dict:
    state = {"python": _py_random.getstate(), "numpy": np.random.get_state(),
             "torch": torch.get_rng_state(), "keychain": accelerator.keys.state_dict()}
    if accelerator.device.type == "cuda":
        state["torch_cuda"] = torch.cuda.get_rng_state_all()
    return state


def _set_rng_state(accelerator, state: dict) -> None:
    _py_random.setstate(state["python"])
    np.random.set_state(state["numpy"])
    torch.set_rng_state(state["torch"])
    if "torch_cuda" in state and accelerator.device.type == "cuda":
        torch.cuda.set_rng_state_all(state["torch_cuda"])
    accelerator.keys.load_state_dict(state["keychain"])


def _write_host_state(accelerator, carry: Any, output_dir: str) -> None:
    """Schedulers, loader positions, registered objects, metadata and RNG,
    one file each, every file atomic."""
    for i, sched in enumerate(accelerator._schedulers):
        _atomic_json_dump(_jsonable(sched.state_dict()),
                          os.path.join(output_dir, f"{SCHEDULER_NAME}_{i}.json"))
    for i, dl in enumerate(accelerator._dataloaders):
        _atomic_json_dump(_jsonable(dl.state_dict()),
                          os.path.join(output_dir, f"{SAMPLER_NAME}_{i}.json"))
    for i, obj in enumerate(accelerator._custom_objects):
        _atomic_pickle_dump(obj.state_dict(),
                            os.path.join(output_dir, f"{CUSTOM_STATE_NAME}_{i}.pkl"))
    if carry is not None and "opt_step" in carry:
        accelerator.sync_from_carry(carry)  # the carry's counters are the source of truth
    meta = {
        "step": accelerator.step, "iteration": accelerator.project_configuration.iteration,
        "version": 1, "has_carry": carry is not None,
        "num_optimizers": len(accelerator._optimizers),
        "num_schedulers": len(accelerator._schedulers),
        "num_dataloaders": len(accelerator._dataloaders),
        "num_custom": len(accelerator._custom_objects),
    }
    _atomic_json_dump(meta, os.path.join(output_dir, METADATA_NAME), indent=2)
    _atomic_pickle_dump(_rng_state(accelerator),
                        os.path.join(output_dir, f"{RNG_STATE_NAME}_0.pkl"))


def save_accelerator_state(accelerator, output_dir: Optional[str] = None, carry: Any = None,
                           params: Any = None, safe_serialization: bool = True,
                           sharded: bool = True) -> str:
    """Save the whole training state; returns the committed directory.

    ``carry`` is the train step's carry (``Accelerator.init_carry``), or
    pass bare ``params`` (a module or a tree). ``sharded=True`` (the
    default) writes ``dist_checkpoint.py``'s format; ``sharded=False`` one
    ``model.safetensors``. Without a carry, each prepared optimizer's state
    goes to ``optimizer_<i>.safetensors``."""
    final_dir = _checkpoint_dir(accelerator, output_dir)
    work_dir = commit.work_dir_for(final_dir)
    commit.discard_work_dir(work_dir)  # a stale one from a crashed save
    os.makedirs(work_dir)
    logger.info(f"Saving current state to {final_dir}")
    tree = carry if carry is not None else _tree_of(params)
    if tree is not None:
        if sharded:
            dist_checkpoint.save_sharded_tree(tree, work_dir)
        else:
            _save_named(_to_named_tensors(tree),
                        os.path.join(work_dir, SAFE_WEIGHTS_NAME if safe_serialization
                                     else MODEL_NAME + ".bin"), safe_serialization)
    if carry is None:
        for i, opt in enumerate(accelerator._optimizers):
            if opt.opt_state is not None:
                _save_named(_to_named_tensors(opt.opt_state),
                            os.path.join(work_dir, f"{OPTIMIZER_NAME}_{i}.safetensors"))
    _write_host_state(accelerator, carry, work_dir)
    accelerator.project_configuration.iteration += 1
    return commit.commit(work_dir, final_dir, topology=topology_metadata(accelerator))


def load_accelerator_state(accelerator, input_dir: Optional[str] = None, carry: Any = None,
                           params: Any = None) -> Any:
    """Restore what ``save_accelerator_state`` saved. ``carry`` (or
    ``params``) is the template; its tensors receive the saved values in
    place and the filled structure is returned. Only a committed directory
    loads (the latest under the project's ``checkpoints`` when
    ``input_dir`` is None); one saved by several processes is refused."""
    if input_dir is None:
        base = os.path.join(accelerator.project_configuration.project_dir or ".", "checkpoints")
        found = _list_checkpoints(base) if os.path.isdir(base) else []
        if not found:
            raise FileNotFoundError(f"no committed checkpoints under {base}")
        input_dir = found[-1]
    if not commit.is_committed(input_dir):
        raise FileNotFoundError(f"{input_dir} is not a committed checkpoint (no "
                                f"{commit.COMMITTED_MARKER} marker)")
    topology = commit.read_topology(input_dir)
    if topology is not None and int(topology.get("world_size", 1)) != 1:
        raise NotImplementedError(
            f"{input_dir} was saved by {topology['world_size']} processes; restoring onto "
            "another topology is not ported yet (ROADMAP.md, queue A4)")
    logger.info(f"Loading states from {input_dir}")
    meta = {}
    meta_path = os.path.join(input_dir, METADATA_NAME)
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)

    template = carry if carry is not None else _tree_of(params)
    result = None
    if template is not None:
        if dist_checkpoint.is_sharded_checkpoint(input_dir):
            result = dist_checkpoint.load_sharded_tree(template, input_dir, strict=False)
        else:
            result = unflatten_into(template, load_model_weights(input_dir), strict=False)

    for i, opt in enumerate(accelerator._optimizers):
        if carry is not None and opt.opt_state is carry.get("opt_state"):
            opt.opt_state = result["opt_state"]  # the restored counter with the moments
        path = os.path.join(input_dir, f"{OPTIMIZER_NAME}_{i}.safetensors")
        if carry is None and opt.opt_state is not None and os.path.isfile(path):
            opt.opt_state = unflatten_into(opt.opt_state, _load_named(path))
    for i, sched in enumerate(accelerator._schedulers):
        path = os.path.join(input_dir, f"{SCHEDULER_NAME}_{i}.json")
        if os.path.isfile(path):
            with open(path) as f:
                sched.load_state_dict(json.load(f))
    for i, dl in enumerate(accelerator._dataloaders):
        path = os.path.join(input_dir, f"{SAMPLER_NAME}_{i}.json")
        if os.path.isfile(path):
            with open(path) as f:
                dl.load_state_dict(json.load(f))
    for i, obj in enumerate(accelerator._custom_objects):
        path = os.path.join(input_dir, f"{CUSTOM_STATE_NAME}_{i}.pkl")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                obj.load_state_dict(pickle.load(f))  # a file this module wrote
    rng_path = os.path.join(input_dir, f"{RNG_STATE_NAME}_0.pkl")
    if os.path.isfile(rng_path):
        with open(rng_path, "rb") as f:
            _set_rng_state(accelerator, pickle.load(f))

    if "step" in meta:
        accelerator.step = int(meta["step"])
    if carry is not None and isinstance(result, dict) and "opt_step" in result:
        accelerator.sync_from_carry(result)
    if "iteration" in meta:
        accelerator.project_configuration.iteration = int(meta["iteration"]) + 1
    return result
