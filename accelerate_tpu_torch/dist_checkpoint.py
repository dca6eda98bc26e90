"""The per-process checkpoint format, one process.

Port of ``accelerate_tpu/dist_checkpoint.py`` (the format :1-30,
``snapshot_tree`` :80, ``write_snapshot`` :181, ``_merged_manifest``
:224, ``validate_coverage`` :239, ``load_full_named`` :407,
``load_sharded_tree`` :421), the default format of ``save_state``. A
process ``p`` writes

* ``state_shard_{p:05d}.safetensors``: one chunk per leaf it owns, stored
  under ``<key>@<i>``;
* ``state_index_{p:05d}.json``: its manifest, ``key -> {shape, dtype,
  chunks: [{file, stored, offset, shape}]}``.

With one process every leaf is one chunk at offset 0 and every file is
process 0's; the reader still assembles any tiling of chunks, so it reads
the reference's checkpoints, which may hold several chunks a leaf. The
files go through the port's own codec (``utils/safetensors_io.py``).
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from .logging import get_logger
from .utils import safetensors_io

logger = get_logger(__name__)

SHARD_FILE_PATTERN = "state_shard_{:05d}.safetensors"
INDEX_FILE_PATTERN = "state_index_{:05d}.json"

# manifest dtype names (numpy's, as the reference writes them), one per codec dtype
_DTYPE_NAMES = {
    torch.float32: "float32", torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
}


@dataclasses.dataclass
class ShardSnapshot:
    """A host copy of this process's chunks: all the writer needs."""

    tensors: dict[str, torch.Tensor]
    manifest: dict[str, dict]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors.values())


def as_tensor_leaf(leaf: Any) -> Optional[torch.Tensor]:
    """A leaf as a host tensor the format can store, or None for a leaf it
    skips (strings, objects, and dtypes the codec does not write, such as a
    Python float's or bool's)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
    elif isinstance(leaf, (np.ndarray, np.generic, int, float, bool)):
        arr = np.asarray(leaf)
        if arr.dtype.kind in "USO":
            return None
        t = torch.from_numpy(np.ascontiguousarray(arr))
    else:
        return None
    return t if t.dtype in _DTYPE_NAMES else None


def snapshot_tree(tree: Any) -> ShardSnapshot:
    """Every storable leaf of ``tree`` as one chunk on the host."""
    from .checkpointing import flatten_tree

    fname = SHARD_FILE_PATTERN.format(0)
    tensors, manifest = {}, {}
    for key, leaf in flatten_tree(tree).items():
        t = as_tensor_leaf(leaf)
        if t is None:
            continue  # a non-tensor leaf: restore keeps the template's value
        stored = f"{key}@0"
        tensors[stored] = t
        manifest[key] = {
            "shape": list(t.shape), "dtype": _DTYPE_NAMES[t.dtype],
            "chunks": [{"file": fname, "stored": stored, "offset": [0] * t.dim(),
                        "shape": list(t.shape)}],
        }
    return ShardSnapshot(tensors=tensors, manifest=manifest)


def write_snapshot(snap: ShardSnapshot, output_dir: str) -> int:
    """The ``state_shard``/``state_index`` pair of a snapshot; the index is
    written through a temporary file and ``os.replace``. Returns bytes."""
    os.makedirs(output_dir, exist_ok=True)
    safetensors_io.save_file(snap.tensors,
                             os.path.join(output_dir, SHARD_FILE_PATTERN.format(0)))
    index_path = os.path.join(output_dir, INDEX_FILE_PATTERN.format(0))
    tmp = f"{index_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snap.manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, index_path)
    return snap.nbytes


def save_sharded_tree(tree: Any, output_dir: str) -> int:
    return write_snapshot(snapshot_tree(tree), output_dir)


def is_sharded_checkpoint(input_dir: str) -> bool:
    return bool(glob.glob(os.path.join(input_dir, "state_index_*.json")))


def _merged_manifest(input_dir: str) -> dict[str, dict]:
    merged: dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(input_dir, "state_index_*.json"))):
        with open(path) as f:
            frag = json.load(f)
        for key, entry in frag.items():
            if key in merged:
                merged[key]["chunks"].extend(entry["chunks"])
            else:
                merged[key] = entry
    if not merged:
        raise FileNotFoundError(f"no state_index_*.json under {input_dir}")
    return merged


def validate_coverage(input_dir: str, manifest: Optional[dict[str, dict]] = None
                      ) -> dict[str, int]:
    """Prove that the merged manifests tile every leaf's shape exactly once
    and that every shard file they name exists: per leaf, every cell of the
    grid cut by the chunks' bounds must lie in exactly one chunk. Raises
    ValueError naming the leaf and region, or FileNotFoundError naming the
    missing files; returns ``{"leaves", "chunks", "files"}``."""
    manifest = _merged_manifest(input_dir) if manifest is None else manifest
    files: set[str] = set()
    missing: set[str] = set()
    n_chunks = 0
    for key, entry in manifest.items():
        shape = tuple(entry["shape"])
        chunks = entry["chunks"]
        n_chunks += len(chunks)
        for chunk in chunks:
            if chunk["file"] not in files:
                files.add(chunk["file"])
                if not os.path.isfile(os.path.join(input_dir, chunk["file"])):
                    missing.add(chunk["file"])
        if not shape:
            if not chunks:
                raise ValueError(f"checkpoint leaf {key!r} has no chunks: incomplete "
                                 f"manifest under {input_dir}")
            continue
        cuts = [{0, d} for d in shape]
        for chunk in chunks:
            for i, (off, size) in enumerate(zip(chunk["offset"], chunk["shape"])):
                cuts[i].update(c for c in (off, off + size) if 0 <= c <= shape[i])
        cuts = [sorted(c) for c in cuts]
        for cell in itertools.product(*(zip(c[:-1], c[1:]) for c in cuts)):
            covering = sum(
                all(off <= lo and hi <= off + size
                    for (lo, hi), off, size in zip(cell, chunk["offset"], chunk["shape"]))
                for chunk in chunks)
            if covering != 1:
                region = ", ".join(f"{lo}:{hi}" for lo, hi in cell)
                problem = ("is not covered by any chunk" if covering == 0
                           else f"is covered by {covering} overlapping chunks")
                raise ValueError(f"checkpoint leaf {key!r} (shape {shape}): region [{region}] "
                                 f"{problem}: the files under {input_dir} do not assemble "
                                 "into a complete checkpoint")
    if missing:
        raise FileNotFoundError(f"checkpoint under {input_dir} references shard files that do "
                                f"not exist: {sorted(missing)}")
    return {"leaves": len(manifest), "chunks": n_chunks, "files": len(files)}


class _FileCache:
    """Opens each shard file once per restore, not once per chunk."""

    def __init__(self, input_dir: str):
        self.input_dir = input_dir
        self._open: dict[str, safetensors_io.SafeFile] = {}

    def read(self, fname: str, stored: str) -> torch.Tensor:
        if fname not in self._open:
            self._open[fname] = safetensors_io.SafeFile(os.path.join(self.input_dir, fname))
        return self._open[fname].get(stored)

    def close(self) -> None:
        for f in self._open.values():
            f.close()
        self._open.clear()

    def __enter__(self) -> "_FileCache":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _read_leaf(reader: _FileCache, entry: dict) -> torch.Tensor:
    """One leaf assembled whole from its chunks; fails if they do not
    cover it."""
    shape = tuple(entry["shape"])
    out, filled = None, 0
    for chunk in entry["chunks"]:
        piece = reader.read(chunk["file"], chunk["stored"]).reshape(chunk["shape"])
        if out is None:
            out = torch.empty(shape, dtype=piece.dtype)
        dst = tuple(slice(o, o + s) for o, s in zip(chunk["offset"], chunk["shape"]))
        out[dst] = piece
        filled += piece.numel()
    size = int(np.prod(shape))
    if out is None or filled != size:
        raise ValueError(f"checkpoint chunks cover {filled} of {size} elements for a leaf of "
                         f"shape {shape}: incomplete checkpoint?")
    return out


def load_full_named(input_dir: str) -> dict[str, torch.Tensor]:
    """Every leaf of a checkpoint in this format as a whole host tensor."""
    manifest = _merged_manifest(input_dir)
    with _FileCache(input_dir) as reader:
        return {key: _read_leaf(reader, entry) for key, entry in manifest.items()}


def load_sharded_tree(template: Any, input_dir: str, strict: bool = True) -> Any:
    """``template`` filled from a checkpoint in this format (tensor leaves
    are written in place, see ``checkpointing.unflatten_into``).
    ``strict=False`` keeps the template's value for a leaf the checkpoint
    does not hold."""
    from .checkpointing import flatten_tree, unflatten_into

    manifest = _merged_manifest(input_dir)
    with _FileCache(input_dir) as reader:
        named = {key: _read_leaf(reader, manifest[key])
                 for key in flatten_tree(template) if key in manifest}
    return unflatten_into(template, named, strict=strict)
