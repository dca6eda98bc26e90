"""Adapter checkpoints through the atomic commit protocol.

Port of ``accelerate_tpu/adapters/checkpoint.py`` (``adapter_dir`` :40,
``save_adapter`` :44, ``load_adapter`` :71, ``list_adapters`` :90). An
adapter artifact is a directory ``adapter_<name>/`` holding
``adapter_model.safetensors`` (the flattened A/B tree, through the port's
own safetensors codec) and ``adapter_config.json`` (the LoraConfig),
written into a ``.tmp`` work dir and renamed into place by
:mod:`..checkpoint_async.commit`. Readers see committed directories only;
a crash in the middle of a save leaves a ``.tmp`` dir that is never listed.
Base weights are never written: the adapter dir is the whole artifact.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from ..checkpoint_async.commit import commit, is_committed, work_dir_for
from ..checkpointing import _SEP, _atomic_json_dump, _load_named, _save_named, flatten_tree
from .lora import LoraConfig

ADAPTER_PREFIX = "adapter_"
WEIGHTS_FILE = "adapter_model.safetensors"
CONFIG_FILE = "adapter_config.json"


def adapter_dir(base_dir: str, name: str) -> str:
    return os.path.join(base_dir, f"{ADAPTER_PREFIX}{name}")


def save_adapter(base_dir: str, name: str, adapter_params: Any, lora_config: LoraConfig,
                 process_index: int = 0, world: int = 1) -> str:
    """Commit ``adapter_<name>/`` under ``base_dir``; returns the final path.
    The final dir either does not exist or is complete and committed. One
    process writes it (a save by several processes is queue A4)."""
    if world != 1 or process_index != 0:
        raise NotImplementedError("an adapter save by several processes is not ported yet "
                                  "(ROADMAP.md, queue A4)")
    if not name or "/" in name:
        raise ValueError(f"invalid adapter name {name!r}")
    final = adapter_dir(base_dir, name)
    work = work_dir_for(final)
    os.makedirs(work, exist_ok=True)
    named = {k: torch.as_tensor(v).detach().cpu().contiguous()
             for k, v in flatten_tree(adapter_params).items()}
    _save_named(named, os.path.join(work, WEIGHTS_FILE))
    _atomic_json_dump(lora_config.to_dict(), os.path.join(work, CONFIG_FILE), indent=2)
    commit(work, final)
    return final


def load_adapter(path: str) -> tuple[dict, LoraConfig]:
    """A committed adapter dir -> (adapter tree of CPU tensors, LoraConfig).
    An uncommitted or partial directory raises FileNotFoundError."""
    if not is_committed(path):
        raise FileNotFoundError(f"{path} is not a committed adapter checkpoint (missing "
                                "COMMITTED marker: crashed save or wrong path?)")
    params: dict = {}
    for key, leaf in _load_named(os.path.join(path, WEIGHTS_FILE)).items():
        node = params
        parts = key.split(_SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    with open(os.path.join(path, CONFIG_FILE)) as f:
        config = LoraConfig.from_dict(json.load(f))
    return params, config


def list_adapters(base_dir: str) -> dict[str, str]:
    """``{name: committed path}`` of every committed adapter under
    ``base_dir``; work dirs and uncommitted dirs are not listed."""
    out: dict[str, str] = {}
    if not os.path.isdir(base_dir):
        return out
    for entry in sorted(os.listdir(base_dir)):
        path = os.path.join(base_dir, entry)
        if entry.startswith(ADAPTER_PREFIX) and os.path.isdir(path) and is_committed(path):
            out[entry[len(ADAPTER_PREFIX):]] = path
    return out
