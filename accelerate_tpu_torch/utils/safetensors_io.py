"""A small reader and writer of the safetensors format.

The reference writes its checkpoints with the ``safetensors`` package
(``accelerate_tpu/checkpointing.py:169``, ``dist_checkpoint.py``). The
port reads and writes the same files with this codec instead, so that a
machine without that package can save, resume, and read the reference's
checkpoints. The format: an 8-byte little-endian header length N, N bytes
of JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]},
"__metadata__": {str: str}}``, padded with spaces to a multiple of 8), then
the tensors' raw little-endian bytes, back to back from offset 0.
"""

from __future__ import annotations

import json
import math
import os
import struct
import sys
from typing import Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
CODES = {dtype: code for code, dtype in DTYPES.items()}

if sys.byteorder != "little":  # the format is little-endian, and so is every tensor here
    raise ImportError("the safetensors codec assumes a little-endian host")


def _raw(t: torch.Tensor) -> memoryview:
    """The tensor's bytes, in row-major order, as a flat view."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy())


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: Optional[dict[str, str]] = None) -> int:
    """Write ``tensors`` to ``path``; returns the bytes of tensor data."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in CODES:
            raise TypeError(f"{name}: dtype {t.dtype} is not one of {list(DTYPES.values())}")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            if tensors[name].numel():
                f.write(_raw(tensors[name]))
        f.flush()
        os.fsync(f.fileno())
    return offset


class SafeFile:
    """An open safetensors file: its header read once, tensors read by name.
    Close it, or use it in a ``with`` statement."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            head = self._f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            self.header = json.loads(self._f.read(n))
        except BaseException:
            self._f.close()
            raise
        self.metadata = self.header.pop("__metadata__", None)
        self._start = 8 + n

    def keys(self) -> list[str]:
        return list(self.header)

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` as a CPU tensor."""
        entry = self.header[name]
        dtype = DTYPES.get(entry["dtype"])
        if dtype is None:
            raise TypeError(f"{self.path}: {name} has dtype {entry['dtype']}, "
                            f"not one of {list(DTYPES)}")
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        if end - begin != math.prod(shape) * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{self.path}: {name} has {end - begin} bytes for shape {shape}")
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        buf = bytearray(end - begin)
        self._f.seek(self._start + begin)
        if self._f.readinto(buf) != len(buf):
            raise ValueError(f"{self.path}: truncated at {name}")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "SafeFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of ``path`` as a CPU tensor."""
    with SafeFile(path) as f:
        return {name: f.get(name) for name in f.keys()}


def checkpoint_files(checkpoint: str, index_name: str, weights_name: str) -> dict[str, str]:
    """name -> file of a checkpoint: a safetensors file, or a directory
    holding ``index_name`` (the shards' ``weight_map``) or ``weights_name``.
    Only the index or the headers are read."""
    if os.path.isdir(checkpoint):
        index_path = os.path.join(checkpoint, index_name)
        if os.path.isfile(index_path):
            with open(index_path) as f:
                weight_map = json.load(f)["weight_map"]
            return {k: os.path.join(checkpoint, v) for k, v in weight_map.items()}
        path = os.path.join(checkpoint, weights_name)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no safetensors files under {checkpoint}")
    else:
        path = checkpoint
    with SafeFile(path) as f:
        return dict.fromkeys(f.keys(), path)


class ShardedReader:
    """Tensors of a checkpoint read one at a time by name (``reader(name)``),
    from a name -> file map (``checkpoint_files``): each file is opened once,
    on its first read, and closed by ``close`` (or the ``with`` statement's
    end)."""

    def __init__(self, files: dict[str, str]):
        self.files = files
        self._open: dict[str, SafeFile] = {}

    def _safe(self, name: str) -> SafeFile:
        if name not in self.files:
            raise KeyError(f"the checkpoint has no tensor {name!r} (it has e.g. "
                           f"{sorted(self.files)[:4]})")
        path = self.files[name]
        if path not in self._open:
            self._open[path] = SafeFile(path)
        return self._open[path]

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` as a CPU tensor."""
        return self._safe(name).get(name)

    __call__ = get

    def dtype(self, name: str) -> torch.dtype:
        """The stored dtype of ``name``, from its file's header."""
        code = self._safe(name).header[name]["dtype"]
        if code not in DTYPES:
            raise TypeError(f"{name} has dtype {code}, not one of {list(DTYPES)}")
        return DTYPES[code]

    def close(self) -> None:
        for f in self._open.values():
            f.close()
        self._open.clear()

    def __enter__(self) -> "ShardedReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
