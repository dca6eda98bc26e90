"""Whole-training-state checkpointing, by one process or several.

Port of ``accelerate_tpu/checkpointing.py:57-743``. The training state is
one tree, the step carry (params, optimizer state,
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
template's structure with its Python counters replaced. It reads and checks
every file before it writes into anything, so a load that fails leaves the
carry, the optimizers and the accelerator as they were.

Host state is captured as ``(filename, kind, payload)`` triples when the
save is made (``_capture_host_state``) and written from them
(``_write_host_state``), so the background writer
(``checkpoint_async/writer.py``) records the RNG, step and loader cursor of
the step it was given, not of a later one.

Across processes every process calls the save. In a data-parallel run
(every process holding the same state) process 0 writes the tree and the
other processes write empty shard files; under a mesh each process writes
its own chunks of the sharded leaves (``dist_checkpoint.snapshot_tree``),
and a restore into a sharded carry reads each rank's region. Process 0
writes the raw loop's optimizer states and the shared host state, every
process writes its own ``random_states_<rank>.pkl``, and the save ends in
the done-marker
barrier and process 0's commit (``checkpoint_async/commit.py``). A load at
the saved world size restores each process's own RNG file. A checkpoint
saved at another world size loads only with ``allow_reshape=True`` (the
reference's error otherwise), under the reference's rules: every chunk's
coverage is checked first, every process restores process 0's RNG and folds
its own index into the accelerator's ``KeyChain``, a carry saved in the
middle of an accumulation resumes at its last optimizer step, and the
loaders' cursors are re-derived by samples seen.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import random as _py_random
import re
import shutil
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from . import dist_checkpoint
from .checkpoint_async import commit
from .logging import get_logger
from .parallel.mesh import mesh_shape_of
from .parallel.sharding import is_dtensor, local_chunk, spec_of_placements
from .utils import safetensors_io
from .utils.environment import parse_flag_from_env
from .utils.quantization import QuantizedTensor
from .utils.constants import (
    ENV_PREFIX,
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
    key, lists and tuples by index, dataclasses by field name, a quantized
    weight by its codes and scales."""
    if isinstance(tree, QuantizedTensor):
        return [("codes", tree.codes), ("scales", tree.scales)]
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
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(new["codes"], new["scales"], tree.bits, tree.shape,
                               tree.block_size, tree.transposed)
    return dataclasses.replace(tree, **new)


def flatten_tree(tree: Any) -> dict[str, Any]:
    """Tree -> {path: leaf} with deterministic, invertible names
    (``layers.0.attn.q_proj.weight`` under ``params`` is
    ``params//layers.0.attn.q_proj.weight``); None leaves are dropped."""
    named: dict[str, Any] = {}
    _rebuild(tree, lambda path, leaf: named.__setitem__(path, leaf))
    return named


def _checked_value(key: str, tleaf: Any, value: Any) -> Any:
    """``value`` in the form of the template leaf ``tleaf``, checked but not
    written: a tensor of the template's shape, or a Python number."""
    value = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    if is_dtensor(tleaf):
        # a sharded leaf takes its local chunk: read as such, or cut from a
        # whole value
        local = tleaf._local_tensor
        if tuple(value.shape) == tuple(tleaf.shape) and tuple(local.shape) != tuple(value.shape):
            spec = spec_of_placements(tleaf.placements, tleaf.ndim)
            value = local_chunk(value, spec, tleaf.device_mesh.get_rank(), tleaf.device_mesh)
        if tuple(value.shape) != tuple(local.shape):
            raise ValueError(f"checkpoint tensor {key!r} has shape {tuple(value.shape)}, "
                             f"template's local chunk {tuple(local.shape)} of "
                             f"{tuple(tleaf.shape)}")
        return value
    if isinstance(tleaf, torch.Tensor):
        if tuple(value.shape) != tuple(tleaf.shape):
            # only 1-element leaves may be reshaped; anything else is corruption
            if value.numel() == tleaf.numel() == 1:
                value = value.reshape(tleaf.shape)
            else:
                raise ValueError(f"checkpoint tensor {key!r} has shape {tuple(value.shape)}, "
                                 f"template expects {tuple(tleaf.shape)}")
        return value
    if isinstance(tleaf, (bool, int, float, np.generic)):
        return type(tleaf)(value.item())
    if isinstance(tleaf, np.ndarray):
        return value.numpy().astype(tleaf.dtype).reshape(tleaf.shape)
    return tleaf


def restore_plan(template: Any, named: dict[str, Any], strict: bool = True) -> dict[str, Any]:
    """Every value ``unflatten_into`` would put into ``template``, checked
    (names, shapes) before anything is written; raises on the first leaf
    that does not fit. ``strict=False`` lets ``named`` lack a leaf."""
    plan: dict[str, Any] = {}

    def check(key, tleaf):
        if key in named:
            plan[key] = _checked_value(key, tleaf, named[key])
        elif strict and isinstance(tleaf, _STORABLE):
            raise KeyError(f"checkpoint missing tensor {key!r}")
        return tleaf

    _rebuild(template, check)
    return plan


def apply_plan(template: Any, plan: dict[str, Any]) -> Any:
    """``template`` filled from ``restore_plan``'s values: tensor leaves
    receive theirs in place, other leaves are replaced."""

    def fill(key, tleaf):
        if key not in plan:
            return tleaf
        if isinstance(tleaf, torch.Tensor):
            with torch.no_grad():
                (tleaf._local_tensor if is_dtensor(tleaf) else tleaf).copy_(plan[key])
            return tleaf
        return plan[key]

    return _rebuild(template, fill)


def unflatten_into(template: Any, named: dict[str, Any], strict: bool = True) -> Any:
    """Fill ``template``'s structure from ``named``. Tensor leaves receive
    their values in place, once every leaf has been checked; ``strict=False``
    keeps the template's value for a leaf ``named`` lacks (a carry that grew
    a leaf since the save)."""
    return apply_plan(template, restore_plan(template, named, strict))


def _tree_of(obj: Any) -> Any:
    """A module stands for its state dict."""
    return obj.state_dict() if isinstance(obj, nn.Module) else obj


def _to_named_tensors(tree: Any) -> dict[str, torch.Tensor]:
    """Every storable leaf of ``tree`` as a named host tensor; a sharded
    (DTensor) leaf is gathered whole, so every process must call it."""
    from .parallel.runtime import gather_full

    out = {}
    for key, leaf in flatten_tree(_tree_of(tree)).items():
        if is_dtensor(leaf):
            leaf = gather_full(leaf)
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
    ``total_limit`` removed first, by the main process), else
    ``output_dir``. The already-exists check runs on every process between
    two barriers, so a refusal fails everywhere instead of leaving the
    other processes at the next collective."""
    pc = accelerator.project_configuration
    if not pc.automatic_checkpoint_naming:
        if output_dir is None:
            raise ValueError("output_dir required without automatic_checkpoint_naming")
        return output_dir
    base = os.path.join(pc.project_dir or output_dir or ".", "checkpoints")
    out = os.path.join(base, f"checkpoint_{pc.iteration}")
    if accelerator.is_main_process:
        os.makedirs(base, exist_ok=True)
        existing = _list_checkpoints(base)
        if pc.total_limit is not None and len(existing) + 1 > pc.total_limit:
            for stale in existing[: len(existing) + 1 - pc.total_limit]:
                logger.info(f"Deleting {stale} to respect total_limit={pc.total_limit}")
                shutil.rmtree(stale, ignore_errors=True)
    accelerator.wait_for_everyone()
    exists = os.path.exists(out)
    accelerator.wait_for_everyone()
    if exists:
        raise ValueError(f"Checkpoint directory {out} already exists: either load it first "
                         "or set a fresh ProjectConfiguration.iteration.")
    return out


def topology_metadata(accelerator) -> dict[str, Any]:
    """The save-time topology record: the world size (one device a
    process) and each process's pair of shard files."""
    world = accelerator.num_processes
    mesh = getattr(accelerator.state, "mesh", None)
    return {
        "format_version": 2, "world_size": world, "num_devices": world,
        "devices_per_process": 1, "num_slices": 1,
        "mesh_shape": {} if mesh is None else mesh_shape_of(mesh),
        "process_shard_files": {str(p): {
            "shard": dist_checkpoint.SHARD_FILE_PATTERN.format(p),
            "index": dist_checkpoint.INDEX_FILE_PATTERN.format(p), "fault_domain": 0}
            for p in range(world)},
        "step": accelerator.step,
    }


def _topology_mismatch(saved: dict, accelerator) -> Optional[str]:
    """How the live world differs from the save-time topology, or None."""
    world = accelerator.num_processes
    diffs = []
    if int(saved.get("world_size", world)) != world:
        diffs.append(f"world size {saved['world_size']} -> {world}")
    if int(saved.get("num_devices", world)) != world:
        diffs.append(f"device count {saved['num_devices']} -> {world}")
    return ", ".join(diffs) if diffs else None


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


def _capture_host_state(accelerator, carry: Any = None) -> list[tuple[str, str, Any]]:
    """Schedulers, loader positions, registered objects, metadata and RNG as
    ``(filename, kind, payload)`` triples (``kind`` "json" or "pickle"),
    taken now: a background writer then writes the state at save time, not
    what the objects have moved on to. The carry's counters set the
    accelerator's ``step`` first (they are the source of truth). The shared
    files are the main process's; every process captures its own RNG."""
    files: list[tuple[str, str, Any]] = []
    if carry is not None and "opt_step" in carry:
        accelerator.sync_from_carry(carry)
    if accelerator.is_main_process:
        for i, sched in enumerate(accelerator._schedulers):
            files.append((f"{SCHEDULER_NAME}_{i}.json", "json", _jsonable(sched.state_dict())))
        for i, dl in enumerate(accelerator._dataloaders):
            files.append((f"{SAMPLER_NAME}_{i}.json", "json", _jsonable(dl.state_dict())))
        for i, obj in enumerate(accelerator._custom_objects):
            # pickled now: a later in-place change must not reach the file
            files.append((f"{CUSTOM_STATE_NAME}_{i}.pkl", "pickle",
                          pickle.dumps(obj.state_dict())))
        meta = {
            "step": accelerator.step, "iteration": accelerator.project_configuration.iteration,
            "version": 1, "has_carry": carry is not None,
            "num_optimizers": len(accelerator._optimizers),
            "num_schedulers": len(accelerator._schedulers),
            "num_dataloaders": len(accelerator._dataloaders),
            "num_custom": len(accelerator._custom_objects),
        }
        files.append((METADATA_NAME, "json", meta))
    files.append((f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl", "pickle",
                  pickle.dumps(_rng_state(accelerator))))
    return files


def _write_host_state(files: list[tuple[str, str, Any]], output_dir: str) -> None:
    """Write captured host state, every file atomic (a pickle payload is
    already its bytes)."""
    for name, kind, payload in files:
        path = os.path.join(output_dir, name)
        if kind == "json":
            _atomic_json_dump(payload, path, indent=2 if name == METADATA_NAME else None)
        else:
            _atomic_write(path, lambda f, b=payload: f.write(b), mode="wb")


def save_accelerator_state(accelerator, output_dir: Optional[str] = None, carry: Any = None,
                           params: Any = None, safe_serialization: bool = True,
                           sharded: bool = True) -> str:
    """Save the whole training state; returns the committed directory.

    ``carry`` is the train step's carry (``Accelerator.init_carry``), or
    pass bare ``params`` (a module or a tree). ``sharded=True`` (the
    default) writes ``dist_checkpoint.py``'s format; ``sharded=False`` one
    ``model.safetensors``. Without a carry, each prepared optimizer's state
    goes to ``optimizer_<i>.safetensors``. Emits a ``kind="checkpoint"``
    record (``mode="sync"``: the whole save is blocked time)."""
    t0 = time.perf_counter()
    final_dir = _checkpoint_dir(accelerator, output_dir)
    work_dir = commit.work_dir_for(final_dir)
    is_main = accelerator.is_main_process
    if is_main:
        commit.discard_work_dir(work_dir)  # a stale one from a crashed save
    accelerator.wait_for_everyone()
    os.makedirs(work_dir, exist_ok=True)
    logger.info(f"Saving current state to {final_dir}")
    nbytes = 0
    tree = carry if carry is not None else _tree_of(params)
    if tree is not None:
        if sharded:
            nbytes += dist_checkpoint.save_sharded_tree(tree, work_dir,
                                                        accelerator.process_index)
        elif is_main or any(is_dtensor(v) for v in flatten_tree(tree).values()):
            named = _to_named_tensors(tree)  # a sharded leaf gathers on every process
            if is_main:
                _save_named(named, os.path.join(work_dir, SAFE_WEIGHTS_NAME if safe_serialization
                                                else MODEL_NAME + ".bin"), safe_serialization)
                nbytes += _nbytes(named)
    if carry is None and is_main:
        for i, opt in enumerate(accelerator._optimizers):
            if opt.opt_state is not None:
                named = _to_named_tensors(opt.opt_state)
                _save_named(named, os.path.join(work_dir, f"{OPTIMIZER_NAME}_{i}.safetensors"))
                nbytes += _nbytes(named)
    _write_host_state(_capture_host_state(accelerator, carry), work_dir)
    accelerator.project_configuration.iteration += 1
    commit.commit(work_dir, final_dir, accelerator.process_index, accelerator.num_processes,
                  topology=topology_metadata(accelerator))
    accelerator.wait_for_everyone()
    accelerator.telemetry.record_checkpoint(
        step=accelerator.step, directory=final_dir, mode="sync",
        blocked_s=time.perf_counter() - t0, background_s=0.0, bytes_written=nbytes)
    return final_dir


def _nbytes(named: dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in named.values())


def _read_json(path: str) -> Optional[Any]:
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_pickle(path: str) -> Optional[Any]:
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)  # a file this module wrote


def load_accelerator_state(accelerator, input_dir: Optional[str] = None, carry: Any = None,
                           params: Any = None, allow_reshape: Optional[bool] = None) -> Any:
    """Restore what ``save_accelerator_state`` saved. ``carry`` (or
    ``params``) is the template; its tensors receive the saved values in
    place and the filled structure is returned. Only a committed directory
    loads (the latest under the project's ``checkpoints`` when
    ``input_dir`` is None). Every file is read and checked before anything
    is written, so a load that raises changes nothing.

    A checkpoint saved at another world size (its ``topology.json``)
    refuses to load unless ``allow_reshape`` is True (None: the
    ``ACCELERATE_TPU_ELASTIC`` flag); then the chunks' coverage is checked,
    every process restores process 0's RNG with its own index folded into
    the ``KeyChain``, and a carry saved in the middle of an accumulation
    resumes at its last optimizer step (the module docstring)."""
    if input_dir is None:
        base = os.path.join(accelerator.project_configuration.project_dir or ".", "checkpoints")
        found = _list_checkpoints(base) if os.path.isdir(base) else []
        if not found:
            raise FileNotFoundError(f"no committed checkpoints under {base}")
        input_dir = found[-1]
    if not commit.is_committed(input_dir):
        raise FileNotFoundError(f"{input_dir} is not a committed checkpoint (no "
                                f"{commit.COMMITTED_MARKER} marker)")
    if allow_reshape is None:
        allow_reshape = parse_flag_from_env(ENV_PREFIX + "ELASTIC")
    saved_topology = commit.read_topology(input_dir)
    mismatch = None if saved_topology is None else _topology_mismatch(saved_topology,
                                                                        accelerator)
    reshaped = mismatch is not None
    if reshaped and not allow_reshape:
        cur = topology_metadata(accelerator)
        raise ValueError(
            f"checkpoint {input_dir} was saved on a different topology ({mismatch}): saved "
            f"world_size={saved_topology['world_size']} "
            f"num_devices={saved_topology.get('num_devices')} "
            f"mesh={saved_topology.get('mesh_shape')}, live world_size={cur['world_size']} "
            f"num_devices={cur['num_devices']} mesh={cur['mesh_shape']}. Pass "
            "allow_reshape=True to load_state (or launch under --elastic) to re-slice the "
            "shards onto the live topology.")
    if reshaped and dist_checkpoint.is_sharded_checkpoint(input_dir):
        stats = dist_checkpoint.validate_coverage(input_dir)
        logger.warning(f"reshaping checkpoint {input_dir} ({mismatch}): {stats['chunks']} "
                       f"chunks across {stats['files']} per-process files fully cover all "
                       f"{stats['leaves']} leaves")
    logger.info(f"Loading states from {input_dir}")

    # read and check everything first
    meta = _read_json(os.path.join(input_dir, METADATA_NAME)) or {}
    template = carry if carry is not None else _tree_of(params)
    plan = None
    if template is not None:
        if dist_checkpoint.is_sharded_checkpoint(input_dir):
            named = dist_checkpoint.read_sharded_named(template, input_dir)
        else:
            named = load_model_weights(input_dir)
        plan = restore_plan(template, named, strict=False)
    opt_plans = {}
    if carry is None:
        for i, opt in enumerate(accelerator._optimizers):
            path = os.path.join(input_dir, f"{OPTIMIZER_NAME}_{i}.safetensors")
            if opt.opt_state is not None and os.path.isfile(path):
                opt_plans[i] = restore_plan(opt.opt_state, _load_named(path))
    scheds = [_read_json(os.path.join(input_dir, f"{SCHEDULER_NAME}_{i}.json"))
              for i in range(len(accelerator._schedulers))]
    loaders = [_read_json(os.path.join(input_dir, f"{SAMPLER_NAME}_{i}.json"))
               for i in range(len(accelerator._dataloaders))]
    customs = [_read_pickle(os.path.join(input_dir, f"{CUSTOM_STATE_NAME}_{i}.pkl"))
               for i in range(len(accelerator._custom_objects))]
    rng_path = os.path.join(input_dir, f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl")
    if reshaped or not os.path.isfile(rng_path):
        # a rank's own file may not exist (more processes than saved it) or
        # belong to a rank that read other data: every process takes
        # process 0's streams, then folds its own index into the KeyChain
        rng_path = os.path.join(input_dir, f"{RNG_STATE_NAME}_0.pkl")
    rng = _read_pickle(rng_path)

    # then write
    result = None if plan is None else apply_plan(template, plan)
    for i, opt in enumerate(accelerator._optimizers):
        if carry is not None and opt.opt_state is carry.get("opt_state"):
            opt.opt_state = result["opt_state"]  # the restored counter with the moments
        if i in opt_plans:
            opt.opt_state = apply_plan(opt.opt_state, opt_plans[i])
    for objs, states in ((accelerator._schedulers, scheds), (accelerator._dataloaders, loaders),
                         (accelerator._custom_objects, customs)):
        for obj, state in zip(objs, states):
            if state is not None:
                obj.load_state_dict(state)
    if rng is not None:
        _set_rng_state(accelerator, rng)
        if reshaped:
            accelerator.keys = accelerator.keys.fold_in(accelerator.process_index)
    if reshaped and isinstance(result, dict) and int(result.get("micro_step", 0)) != 0:
        logger.warning(f"checkpoint was saved mid-accumulation (micro_step="
                       f"{int(result['micro_step'])}); microbatch boundaries do not map "
                       "across world sizes, so the partial gradient sum is dropped and the "
                       "run resumes at the last optimizer-step boundary")
        result = dict(result, micro_step=0)
        for a in result.get("accum_grads", {}).values():
            a.zero_()

    if "step" in meta:
        accelerator.step = int(meta["step"])
    if carry is not None and isinstance(result, dict) and "opt_step" in result:
        accelerator.sync_from_carry(result)
    if "iteration" in meta:
        accelerator.project_configuration.iteration = int(meta["iteration"]) + 1
    return result
