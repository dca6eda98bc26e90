"""The disk offload tier: one numpy memmap a tensor and a lazy index.

Port of ``accelerate_tpu/utils/offload.py`` (``offload_weight`` :25,
``open_offloaded_weight`` :45, ``load_offloaded_weight`` :60,
``save_offload_index`` :65, ``offload_state_dict`` :77,
``OffloadedWeightsLoader`` :85, ``PrefixedDataset`` :132,
``extract_submodules_state_dict`` :151), on torch tensors. The on-disk
format is the reference's, so a folder written by either package reads
back bit for bit in the other: ``<name with / as _>.dat`` (a 0-d tensor as
shape (1,)) and ``index.json`` mapping each name to ``{"dtype", "shape"}``
with numpy's dtype names. numpy has no bfloat16, so a bf16 tensor is stored
as its int16 bits under the dtype string ``"bfloat16"`` and read back
through ``Tensor.view(torch.bfloat16)``.

Memmaps open copy-on-write (``mode="c"``): the tensor over one is writable
in memory, so ``torch.from_numpy`` takes it, and a write never reaches the
file.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

# torch dtype -> the name numpy (and so the reference's index) gives it
_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
          torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
          torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
DTYPES = {name: dtype for dtype, name in _NAMES.items()}


def _safe_filename(weight_name: str) -> str:
    """Flattened names hold ``//``; the files stay in one folder."""
    return weight_name.replace("/", "_")


def offload_weight(weight: Any, weight_name: str, offload_folder: str,
                   index: Optional[dict] = None) -> dict:
    """Write one tensor (or numpy array) to a memmap; returns its index
    entry, also put in ``index`` when given (reference :25)."""
    os.makedirs(offload_folder, exist_ok=True)
    t = torch.as_tensor(weight).detach().to("cpu").contiguous()
    dtype = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.numpy()
    file_path = os.path.join(offload_folder, f"{_safe_filename(weight_name)}.dat")
    mm = np.memmap(file_path, dtype=arr.dtype, mode="w+", shape=arr.shape or (1,))
    mm[:] = arr.reshape(arr.shape or (1,))[:]
    mm.flush()
    del mm
    entry = {"dtype": dtype, "shape": list(arr.shape)}
    if index is not None:
        index[weight_name] = entry
    return entry


def open_offloaded_weight(weight_file: str, weight_info: dict) -> torch.Tensor:
    """One tensor as a CPU tensor over its memmap, nothing copied: a slice
    of it reads only the bytes it touches (what ``big_modeling.
    streamed_apply`` builds on). A 0-d tensor comes back as shape (1,)."""
    shape = tuple(weight_info["shape"]) or (1,)
    dtype = weight_info["dtype"]
    np_dtype = np.int16 if dtype == "bfloat16" else np.dtype(dtype)
    t = torch.from_numpy(np.memmap(weight_file, dtype=np_dtype, mode="c", shape=shape))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def load_offloaded_weight(weight_file: str, weight_info: dict) -> torch.Tensor:
    """One tensor read whole into memory (reference :60)."""
    return open_offloaded_weight(weight_file, weight_info).clone()


def save_offload_index(index: dict, offload_folder: str) -> None:
    """Merge ``index`` into the folder's ``index.json``."""
    os.makedirs(offload_folder, exist_ok=True)
    path = os.path.join(offload_folder, "index.json")
    current = {}
    if os.path.isfile(path):
        with open(path) as f:
            current = json.load(f)
    current.update(index)
    with open(path, "w") as f:
        json.dump(current, f, indent=2)


def offload_state_dict(save_dir: str, state_dict: Mapping[str, Any]) -> None:
    """Offload a whole dict of named tensors (reference :77)."""
    index: dict = {}
    for name, tensor in state_dict.items():
        offload_weight(tensor, name, save_dir, index)
    save_offload_index(index, save_dir)


class OffloadedWeightsLoader(Mapping):
    """A lazy mapping over tensors in memory and an offload folder
    (reference :85): reading a key reads only that tensor."""

    def __init__(self, state_dict: Optional[Mapping[str, Any]] = None,
                 save_folder: Optional[str] = None, index: Optional[Mapping[str, dict]] = None):
        if state_dict is None and save_folder is None and index is None:
            raise ValueError("need state_dict and/or save_folder")
        self.state_dict = dict(state_dict or {})
        self.save_folder = save_folder
        if index is None and save_folder is not None:
            with open(os.path.join(save_folder, "index.json")) as f:
                index = json.load(f)
        self.index = dict(index or {})
        self.all_keys = list(self.state_dict)
        self.all_keys.extend(k for k in self.index if k not in self.all_keys)

    def _file(self, key: str) -> str:
        return os.path.join(self.save_folder, f"{_safe_filename(key)}.dat")

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        return load_offloaded_weight(self._file(key), self.index[key])

    def get_memmap(self, key: str) -> torch.Tensor:
        """One tensor over its memmap, nothing copied; slices read lazily."""
        if key in self.state_dict:
            return torch.as_tensor(self.state_dict[key])
        return open_offloaded_weight(self._file(key), self.index[key])

    def __iter__(self):
        return iter(self.all_keys)

    def __len__(self):
        return len(self.all_keys)


class PrefixedDataset(Mapping):
    """A mapping seen under a key prefix (reference :132)."""

    def __init__(self, dataset: Mapping, prefix: str):
        self.dataset = dataset
        self.prefix = prefix

    def __getitem__(self, key):
        return self.dataset[f"{self.prefix}{key}"]

    def __iter__(self):
        return iter(k[len(self.prefix):] for k in self.dataset if k.startswith(self.prefix))

    def __len__(self):
        return sum(1 for k in self.dataset if k.startswith(self.prefix))


def extract_submodules_state_dict(state_dict: Mapping, submodule_names: list[str]) -> dict:
    """The entries of ``state_dict`` under the given prefixes (reference
    :151), dotted or ``//``-joined."""
    result = {}
    for name in submodule_names:
        result.update({k: v for k, v in state_dict.items()
                       if k == name or k.startswith(name + ".") or k.startswith(name + "//")})
    return result
