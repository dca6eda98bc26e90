"""The port's disk offload tier against the JAX reference's, on the CPU.

``accelerate_tpu_torch/utils/offload.py`` keeps the reference's on-disk
format (``<name>.dat`` memmaps and ``index.json``, bf16 as int16 bits under
``"bfloat16"``), so a folder written by either package reads back bit for
bit in the other, in fp32 and bf16 and for 0-d tensors; the loader, the
prefixed view and the sub-dict helper behave as the reference's; a memmap
view reads the file lazily and a write to it never reaches the file.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu.utils import offload as ref  # noqa: E402
from accelerate_tpu_torch.utils import offload  # noqa: E402


def _named(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "embed//w": rng.standard_normal((64, 32)).astype(np.float32),
        "layers.0.attn.q_proj.weight": rng.standard_normal((32, 32)).astype(np.float32),
        "bias": rng.standard_normal((32,)).astype(np.float32),
        "scale": np.array(1.5, dtype=np.float32),  # 0-d: stored as shape (1,)
        "step": np.array([3, 1, 4], dtype=np.int32),
    }


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or a numpy array, bf16 as int16."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_folder_reads_in_the_reference_bit_for_bit(tmp_path, dtype):
    named = _named(0)
    tensors = {k: torch.from_numpy(v) for k, v in named.items()}
    if dtype == "bfloat16":
        tensors = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                   for k, v in tensors.items()}
    offload.offload_state_dict(str(tmp_path), tensors)
    index = json.load(open(tmp_path / "index.json"))
    assert index["embed//w"] == {"dtype": dtype, "shape": [64, 32]}
    assert index["scale"]["shape"] == [] and os.path.isfile(tmp_path / "embed__w.dat")
    loader = ref.OffloadedWeightsLoader(save_folder=str(tmp_path))
    assert set(loader) == set(named)
    for name, t in tensors.items():
        got = np.asarray(loader[name]).reshape(t.shape)
        assert got.dtype == (ml_dtypes.bfloat16 if t.dtype == torch.bfloat16
                             else t.numpy().dtype)
        np.testing.assert_array_equal(_bits(got), _bits(t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_folder_reads_in_the_port_bit_for_bit(tmp_path, dtype):
    named = _named(1)
    arrays = {k: np.asarray(jnp.asarray(v, dtype) if v.dtype == np.float32 else v)
              for k, v in named.items()}
    ref.offload_state_dict(str(tmp_path), arrays)
    loader = offload.OffloadedWeightsLoader(save_folder=str(tmp_path))
    assert set(loader) == set(named)
    for name, arr in arrays.items():
        got = loader[name].reshape(arr.shape)
        assert got.dtype == offload.DTYPES[str(arr.dtype)]
        np.testing.assert_array_equal(_bits(got), _bits(arr))
        # the memmap view gives the same bits without reading the file whole
        np.testing.assert_array_equal(_bits(loader.get_memmap(name).reshape(arr.shape)),
                                      _bits(arr))


def test_offload_weight_entries_equal_the_reference(tmp_path):
    named = _named(2)
    ours, theirs = {}, {}
    for name, v in named.items():
        offload.offload_weight(torch.from_numpy(v), name, str(tmp_path / "port"), ours)
        ref.offload_weight(v, name, str(tmp_path / "ref"), theirs)
    assert ours == theirs
    for name in named:
        fname = f"{offload._safe_filename(name)}.dat"
        assert (tmp_path / "port" / fname).read_bytes() == (tmp_path / "ref" / fname).read_bytes()


def test_memmap_view_is_lazy_and_copy_on_write(tmp_path):
    w = torch.arange(4 * 1024, dtype=torch.float32).reshape(4, 1024)
    entry = offload.offload_weight(w, "w", str(tmp_path))
    path = str(tmp_path / "w.dat")
    view = offload.open_offloaded_weight(path, entry)
    assert torch.equal(view[2:3], w[2:3])
    view[0] = -1.0  # in memory only
    assert torch.equal(offload.load_offloaded_weight(path, entry), w)
    loaded = offload.load_offloaded_weight(path, entry)
    loaded += 1  # an owned copy
    assert torch.equal(offload.load_offloaded_weight(path, entry), w)


def test_loader_prefixed_view_and_submodules_match_the_reference(tmp_path):
    sd = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones((4,), np.float32)}
    offload.offload_state_dict(str(tmp_path), {k: torch.from_numpy(v) for k, v in sd.items()})
    ours = offload.OffloadedWeightsLoader(state_dict={"c": torch.zeros(2)},
                                          save_folder=str(tmp_path))
    theirs = ref.OffloadedWeightsLoader(state_dict={"c": np.zeros(2)},
                                        save_folder=str(tmp_path))
    assert list(ours) == list(theirs) == ["c", "a", "b"] and len(ours) == 3
    np.testing.assert_array_equal(ours["a"].numpy(), theirs["a"])
    pre, rpre = offload.PrefixedDataset(ours, "a"), ref.PrefixedDataset(theirs, "a")
    assert len(pre) == len(rpre) == 1 and list(pre) == list(rpre) == [""]
    np.testing.assert_array_equal(pre[""].numpy(), rpre[""])
    with pytest.raises(ValueError):
        offload.OffloadedWeightsLoader()
    state = {"layers.0.w": 1, "layers.0//b": 2, "layers.01.w": 3, "layers.0": 4, "head": 5}
    assert (offload.extract_submodules_state_dict(state, ["layers.0"])
            == ref.extract_submodules_state_dict(state, ["layers.0"])
            == {"layers.0.w": 1, "layers.0//b": 2, "layers.0": 4})
