"""The per-process checkpoint format.

Port of ``accelerate_tpu/dist_checkpoint.py`` (the format :1-30,
``snapshot_tree`` :78-95, ``write_snapshot`` :181, ``_merged_manifest``
:224, ``validate_coverage`` :239, ``load_full_named`` :407,
``load_sharded_tree`` :421), the default format of ``save_state``. A
process ``p`` writes

* ``state_shard_{p:05d}.safetensors``: one chunk per leaf it owns, stored
  under ``<key>@<i>``;
* ``state_index_{p:05d}.json``: its manifest, ``key -> {shape, dtype,
  chunks: [{file, stored, offset, shape}]}``.

A leaf that is a DTensor on a mesh (a sharded carry under a
``ParallelismPlugin``) is written by chunks: each process writes only its
own chunk, at its offset (``parallel.sharding.local_bounds``), and of the
processes that hold the same chunk only the first writes it (its
coordinate 0 on every axis that does not split the leaf, the reference's
``replica_id == 0``). Every other leaf is whole on every process, the same
on each after the step's gradient mean; as in the reference for leaves
that are not globally sharded, process 0 owns it (one chunk at offset 0).
So the chunks never overlap, and a process that owns nothing writes an
empty pair of files. A restore into a DTensor template reads, for each
rank's chunk, only the chunks that overlap it (``_read_region``), so a
checkpoint re-slices onto any other mesh, or whole onto a plain template
(world 1, ``allow_reshape=True``). The reader assembles any tiling of
chunks, so it reads the reference's checkpoints, which may hold several
chunks a leaf. The files go through the port's own codec
(``utils/safetensors_io.py``).

A snapshot owns its memory: the train step updates params and moments in
place, so a snapshot that shared storage with them would be written with
a later step's values. A CPU leaf is cloned. A CUDA leaf is copied either
synchronously into fresh host memory (``buffers=None``: the sync save) or
into one of the background writer's sets of page-locked buffers
(:class:`HostBuffers`) with ``non_blocking`` copies on the current stream,
which stream order puts after the step that produced the values and before
the next step's in-place updates; one event after the last copy tells the
writer when the bytes have landed.
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import json
import os
import queue
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
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.int8: "int8",
}


@dataclasses.dataclass
class ShardSnapshot:
    """A host copy of this process's chunks: all the writer needs."""

    tensors: dict[str, torch.Tensor]
    manifest: dict[str, dict]
    process_index: int = 0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors.values())


def as_tensor_leaf(leaf: Any) -> Optional[torch.Tensor]:
    """A leaf as a host tensor the format can store, or None for a leaf it
    skips (strings, objects, and dtypes the codec does not write, such as a
    Python float's or bool's). A CPU tensor comes back as itself."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
    elif isinstance(leaf, (np.ndarray, np.generic, int, float, bool)):
        arr = np.asarray(leaf)
        if arr.dtype.kind in "USO":
            return None
        t = torch.from_numpy(np.asarray(arr, order="C"))  # a scalar stays 0-d
    else:
        return None
    return t if t.dtype in _DTYPE_NAMES else None


def _owned_host_copy(leaf: Any) -> Optional[torch.Tensor]:
    """``as_tensor_leaf`` in memory of its own: a CUDA tensor's copy is
    fresh, a CPU tensor or numpy array is copied."""
    t = as_tensor_leaf(leaf)
    on_host = isinstance(leaf, np.ndarray) or (
        isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu")
    return t.clone() if t is not None and on_host else t


_ALIGN = 64  # bytes: every view of a buffer set starts on a 64-byte boundary


def _local(leaf: Any) -> Any:
    """A DTensor's local chunk (sharing its storage); anything else as it is."""
    from .parallel.runtime import to_local

    return to_local(leaf)


def device_layout(named: dict[str, Any], prefix: str = "") -> list[tuple[str, tuple, torch.dtype]]:
    """``(prefix + key, shape, dtype)`` of every storable leaf of ``named``
    that lives on an accelerator (a DTensor's local chunk): what a set of
    host buffers must hold."""
    named = {key: _local(leaf) for key, leaf in named.items()}
    return [(prefix + key, tuple(leaf.shape), leaf.dtype) for key, leaf in named.items()
            if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu"
            and leaf.dtype in _DTYPE_NAMES]


def _pinned_empty(nbytes: int) -> torch.Tensor:
    """Page-locked host bytes; raises when the allocation fails (a pageable
    buffer would make the non_blocking copies synchronous)."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class HostBuffers:
    """One set of page-locked host buffers for one snapshot in flight: one
    allocation, cut into a 64-byte-aligned view a leaf. It is allocated on
    first use and kept while the layout stays the same."""

    def __init__(self):
        self.layout: Optional[list] = None
        self.views: dict[str, torch.Tensor] = {}
        self.nbytes = 0
        self.event = None  # recorded after the last copy into the set
        self._from_cuda = False

    def bind(self, layout: list) -> None:
        """Hold ``layout``'s leaves, allocating only when it changed."""
        if layout == self.layout:
            return
        offsets, total = [], 0
        for _, shape, dtype in layout:
            total += -total % _ALIGN
            offsets.append(total)
            total += int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        self.views, self.layout, self.nbytes = {}, None, 0
        flat = _pinned_empty(total) if total else None
        for (key, shape, dtype), off in zip(layout, offsets):
            size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self.views[key] = flat[off:off + size].view(dtype).view(shape)
        self.layout, self.nbytes = layout, total

    def copy_in(self, key: str, leaf: torch.Tensor) -> torch.Tensor:
        """Queue the copy of ``leaf`` into its view on the current stream;
        the view's bytes are valid once :meth:`wait` returns."""
        view = self.views[key]
        view.copy_(leaf.detach(), non_blocking=True)
        self._from_cuda = self._from_cuda or leaf.is_cuda
        return view

    def seal(self) -> None:
        """Record the event after the last copy (none without a CUDA copy)."""
        self.event = None
        if self._from_cuda:
            self.event = torch.cuda.Event()
            self.event.record()
        self._from_cuda = False

    def wait(self) -> None:
        """Block until every copy into the set has landed: the writer
        thread's only CUDA call."""
        if self.event is not None:
            self.event.synchronize()


class HostBufferPool:
    """``n_sets`` :class:`HostBuffers`, one a snapshot in flight, all
    allocated at the first save (none is in flight yet) and reused after.
    A set goes back to the pool only once its job has finished writing, and
    :meth:`acquire` waits while every set is out."""

    def __init__(self, n_sets: int):
        self.sets = [HostBuffers() for _ in range(n_sets)]
        self._free: queue.Queue = queue.Queue()
        for buffers in self.sets:
            self._free.put(buffers)

    def acquire(self, layout: list) -> HostBuffers:
        buffers = self._free.get()
        try:
            for other in self.sets:  # a set never bound is in the pool, not in flight
                if other is buffers or other.layout is None:
                    other.bind(layout)
        except BaseException:
            self._free.put(buffers)
            raise
        return buffers

    def release(self, buffers: HostBuffers) -> None:
        self._free.put(buffers)

    @property
    def pinned_bytes(self) -> int:
        return sum(b.nbytes for b in self.sets)


def host_copies(named: dict[str, Any], buffers: Optional[HostBuffers] = None,
                prefix: str = "") -> dict[str, torch.Tensor]:
    """Every storable leaf of ``named`` on the host, in memory of its own.
    A leaf that ``buffers`` holds a view for (under ``prefix + key``) is
    copied into it without waiting: call ``buffers.seal()`` after the last
    copy and ``buffers.wait()`` before reading. Without ``buffers`` a CUDA
    leaf is copied synchronously into fresh memory."""
    out = {}
    for key, leaf in named.items():
        if buffers is not None and prefix + key in buffers.views:
            t = buffers.copy_in(prefix + key, leaf)
        else:
            t = _owned_host_copy(leaf)
        if t is not None:  # a non-tensor leaf: restore keeps the template's value
            out[key] = t
    return out


def snapshot_tree(tree: Any, buffers: Optional[HostBuffers] = None,
                  process_index: Optional[int] = None) -> ShardSnapshot:
    """This process's chunks of ``tree`` on the host, in memory the
    snapshot owns (``host_copies``; with ``buffers`` bound to
    ``device_layout`` of the tree's leaves). A DTensor leaf: the chunk of
    this process (``process_index``, by default the group's rank), when it
    is the first holder of it, at its offset. Any other storable leaf:
    process 0's, whole."""
    from .checkpointing import flatten_tree
    from .parallel.sharding import is_dtensor, is_replica_zero, local_bounds, spec_of_placements
    from .state import current_process_index

    proc = current_process_index() if process_index is None else process_index
    fname = SHARD_FILE_PATTERN.format(proc)
    owned, where = {}, {}
    for key, leaf in flatten_tree(tree).items():
        if is_dtensor(leaf):
            spec = spec_of_placements(leaf.placements, leaf.ndim)
            if not is_replica_zero(spec, proc, leaf.device_mesh):
                continue
            bounds = local_bounds(spec, leaf.shape, proc, leaf.device_mesh)
            owned[key] = leaf._local_tensor
            where[key] = (list(leaf.shape), [lo for lo, _ in bounds])
        elif proc == 0:
            owned[key] = leaf
    tensors, manifest = {}, {}
    for key, t in host_copies(owned, buffers).items():
        stored = f"{key}@0"
        tensors[stored] = t
        shape, offset = where.get(key, (list(t.shape), [0] * t.dim()))
        manifest[key] = {
            "shape": shape, "dtype": _DTYPE_NAMES[t.dtype],
            "chunks": [{"file": fname, "stored": stored, "offset": offset,
                        "shape": list(t.shape)}],
        }
    return ShardSnapshot(tensors=tensors, manifest=manifest, process_index=proc)


def write_snapshot(snap: ShardSnapshot, output_dir: str, fsync: bool = False) -> int:
    """The ``state_shard``/``state_index`` pair of a snapshot, named for its
    process; the index is written through a temporary file and
    ``os.replace``. The codec fsyncs the shard; with ``fsync`` the index
    reaches the disk too before this returns. Returns bytes."""
    os.makedirs(output_dir, exist_ok=True)
    proc = snap.process_index
    safetensors_io.save_file(snap.tensors,
                             os.path.join(output_dir, SHARD_FILE_PATTERN.format(proc)))
    index_path = os.path.join(output_dir, INDEX_FILE_PATTERN.format(proc))
    tmp = f"{index_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snap.manifest, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, index_path)
    return snap.nbytes


def save_sharded_tree(tree: Any, output_dir: str, process_index: Optional[int] = None) -> int:
    """This process's snapshot of a tree written, both files on the disk;
    returns bytes. Every process calls it, each writing its own pair."""
    return write_snapshot(snapshot_tree(tree, process_index=process_index), output_dir,
                          fsync=True)


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
    return _read_region(reader, entry, tuple((0, d) for d in entry["shape"]))


def _read_region(reader: _FileCache, entry: dict, bounds: tuple) -> torch.Tensor:
    """The half-open region ``bounds`` (``(start, stop)`` a dim) of one leaf,
    assembled from the chunks that overlap it (reference :361); only those
    are read. Fails if they do not cover it."""
    region = tuple(hi - lo for lo, hi in bounds)
    out, filled = None, 0
    for chunk in entry["chunks"]:
        c_off, c_shape = chunk["offset"], chunk["shape"]
        lo = [max(b[0], o) for b, o in zip(bounds, c_off)]
        hi = [min(b[1], o + n) for b, o, n in zip(bounds, c_off, c_shape)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        piece = reader.read(chunk["file"], chunk["stored"]).reshape(c_shape)
        if out is None:
            out = torch.empty(region, dtype=piece.dtype)
        src = tuple(slice(a - o, b - o) for a, b, o in zip(lo, hi, c_off))
        dst = tuple(slice(a - r[0], b - r[0]) for a, b, r in zip(lo, hi, bounds))
        out[dst] = piece[src]
        filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
    size = int(np.prod(region))
    if out is None or filled != size:
        raise ValueError(f"checkpoint chunks cover {filled} of {size} elements for a region "
                         f"{list(bounds)} of a leaf of shape {tuple(entry['shape'])}: "
                         "incomplete checkpoint?")
    return out


def load_full_named(input_dir: str) -> dict[str, torch.Tensor]:
    """Every leaf of a checkpoint in this format as a whole host tensor."""
    manifest = _merged_manifest(input_dir)
    with _FileCache(input_dir) as reader:
        return {key: _read_leaf(reader, entry) for key, entry in manifest.items()}


def read_sharded_named(template: Any, input_dir: str) -> dict[str, torch.Tensor]:
    """The checkpoint's leaves that ``template`` names: a DTensor leaf's
    region of this process's chunk (its local shape), any other whole."""
    from .checkpointing import flatten_tree
    from .parallel.sharding import is_dtensor, local_bounds, spec_of_placements

    manifest = _merged_manifest(input_dir)
    out = {}
    with _FileCache(input_dir) as reader:
        for key, leaf in flatten_tree(template).items():
            if key not in manifest:
                continue
            entry = manifest[key]
            if is_dtensor(leaf) and tuple(entry["shape"]) == tuple(leaf.shape):
                spec = spec_of_placements(leaf.placements, leaf.ndim)
                bounds = local_bounds(spec, leaf.shape, leaf.device_mesh.get_rank(),
                                      leaf.device_mesh)
                out[key] = _read_region(reader, entry, bounds)
            else:
                out[key] = _read_leaf(reader, entry)
    return out


def load_sharded_tree(template: Any, input_dir: str, strict: bool = True) -> Any:
    """``template`` filled from a checkpoint in this format (tensor leaves
    are written in place once every leaf has been read and checked, see
    ``checkpointing.unflatten_into``). ``strict=False`` keeps the template's
    value for a leaf the checkpoint does not hold."""
    from .checkpointing import unflatten_into

    return unflatten_into(template, read_sharded_named(template, input_dir), strict=strict)
