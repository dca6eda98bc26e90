"""The port's big-model loading against the JAX reference's, on the CPU.

Mirrors ``tests/test_big_modeling.py`` but for the memory-helper tests that
``tests/test_torch_raw_loop.py`` mirrors (the GSPMD test loads at world 4
over gloo, at the end):
on the same seeded nested dict, ``compute_module_sizes``,
``get_balanced_memory``, ``infer_auto_device_map`` and
``check_device_map`` give the reference's results; the tiers hold the
reference's values bit for bit, each package reads the other's offload
folder and checkpoint, and offloaded, streamed and whole-tree forwards
agree within ``FP32_TOL`` (bit for bit inside the port). Then the port's
own: the meta-device model (nothing allocated, nothing drawn, the weights
on the CPU as before), a model loaded over the host and disk tiers and its
layers streamed from disk, the refusals (a mesh that is not a DeviceMesh, a
device index without CUDA), and the example ``big_model_inference.py`` at a
tiny size on the CPU, in its tiered and its mesh modes.
"""

import hashlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu import big_modeling as ref  # noqa: E402
from accelerate_tpu.checkpointing import save_model_weights as ref_save  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.utils import offload as ref_offload  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch import big_modeling as bm  # noqa: E402
from accelerate_tpu_torch.checkpointing import save_model_weights  # noqa: E402
from accelerate_tpu_torch.utils.offload import (  # noqa: E402
    OffloadedWeightsLoader,
    PrefixedDataset,
    offload_state_dict,
)

REPO = Path(__file__).resolve().parent.parent
FP32_TOL = 3e-6  # relative to the largest magnitude: about 3x the largest reading, 1.07e-6


def _arrays(seed: int = 0) -> dict:
    """The reference test's tree (``_params``), seeded."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed": {"w": normal(64, 32)},
            "layer1": {"kernel": normal(32, 32) / 6, "bias": normal(32) * 0.01},
            "layer2": {"kernel": normal(32, 32) / 6, "bias": normal(32) * 0.01},
            "head": {"w": normal(32, 64)}}


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _ours(tree):
    return _tree_map(torch.from_numpy, tree)


def _theirs(tree):
    return _tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}//") if isinstance(v, dict) else {prefix + k: v})
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, (bm.OffloadedLeaf, ref.OffloadedLeaf)):
        x = x.load()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_values(ours, theirs):
    a, b = _flat(ours), _flat(theirs)
    assert list(a) == sorted(b) or set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(_np(a[name]), _np(b[name]), err_msg=name)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= FP32_TOL * np.abs(b).max(), np.abs(a - b).max()


def _forward_torch(p, x):
    h = x @ p["embed"]["w"]
    h = torch.tanh(h @ p["layer1"]["kernel"] + p["layer1"]["bias"])
    h = torch.tanh(h @ p["layer2"]["kernel"] + p["layer2"]["bias"])
    return h @ p["head"]["w"]


def _forward_jax(p, x):
    h = x @ p["embed"]["w"]
    h = jnp.tanh(h @ p["layer1"]["kernel"] + p["layer1"]["bias"])
    h = jnp.tanh(h @ p["layer2"]["kernel"] + p["layer2"]["bias"])
    return h @ p["head"]["w"]


# ---------------------------------------------------------------------- #
# the reference's tests, on both packages
# ---------------------------------------------------------------------- #
def _digest(module) -> str:
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


# sha256 of the names and bytes of each model's state dict, built on the CPU
# from the default generator (seeded 0) or the one given, as the constructor
# made them before it learnt the meta device
CPU_DIGESTS = [
    (port.CausalLM, dict(), None,
     "d077da4a9220be09d8f31a2e8e9de29a2a6e7a2f90aabed77ca8e35915112aa4"),
    (port.CausalLM, dict(num_experts=4, qkv_bias=True, tie_embeddings=True), None,
     "193b4bcccd3b70131869d746a3944f71f9471431f5bdf955ab42427b4b6eda26"),
    (port.SequenceClassifier, dict(causal=False), None,
     "4e7cbd04832104e368ceb0106225b58fe0d0c736d1cad15705efe2a5486fd885"),
    (port.CausalLM, dict(), 7,
     "a95451492003e96e61189e45dbaa52d50eb48e594b38432a95c9bacfe23bc1df"),
]


def test_init_empty_weights_allocates_nothing(monkeypatch):
    """A meta model: every parameter on the meta device, the reference's
    parameter count, and no generator made and nothing drawn (each raises
    here). Llama-3-8B at full size would take 32 GB in fp32 if anything
    were allocated. On the CPU the weights are what they were."""
    cfg = JaxConfig.tiny()
    abstract = ref.init_empty_weights(JaxCausalLM(cfg).init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32))
    assert all(isinstance(leaf, jax.ShapeDtypeStruct) for leaf in jax.tree.leaves(abstract))
    for cls, kw, seed, digest in CPU_DIGESTS:
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        assert _digest(cls(port.TransformerConfig.tiny(**kw), device="cpu",
                           generator=gen)) == digest, (cls.__name__, kw)

    def refuse(*args, **kwargs):
        raise AssertionError("a meta model makes no generator and draws nothing")

    class NoGenerator(torch.Generator):  # still a type, for torch's own annotations
        __init__ = refuse

    monkeypatch.setattr(torch, "Generator", NoGenerator)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", refuse)
    rng = torch.get_rng_state()
    tiny = bm.init_empty_weights(port.CausalLM, port.TransformerConfig.tiny())
    assert {p.device.type for p in tiny.parameters()} == {"meta"}
    assert sum(p.numel() for p in tiny.parameters()) == sum(
        leaf.size for leaf in jax.tree.leaves(abstract))
    big = port.CausalLM(port.TransformerConfig.llama3_8b(), device="meta")
    assert all(p.is_meta for p in big.parameters())
    assert sum(p.numel() for p in big.parameters()) == 8_030_261_248
    moe = bm.init_empty_weights(port.CausalLM, port.TransformerConfig.tiny(num_experts=4))
    assert moe.layers[0].moe.gate_proj.is_meta
    clf = bm.init_empty_weights(port.SequenceClassifier, port.TransformerConfig.tiny(
        causal=False))
    assert all(p.is_meta for p in clf.parameters())
    assert torch.equal(torch.get_rng_state(), rng)  # torch's own inits on meta draw nothing


def test_compute_module_sizes():
    arrays = _arrays()
    ours, theirs = bm.compute_module_sizes(_ours(arrays)), ref.compute_module_sizes(
        _theirs(arrays))
    assert ours == theirs
    assert ours[""] == sum(a.size * 4 for a in jax.tree.leaves(arrays))
    assert ours["layer1"] == (32 * 32 + 32) * 4
    assert ours["layer1//kernel"] == 32 * 32 * 4
    assert bm.compute_module_sizes(_ours(arrays), dtype_bytes=2) == ref.compute_module_sizes(
        _theirs(arrays), dtype_bytes=2)
    # a module: its dotted names split into parts, one group a layer
    model = port.CausalLM(port.TransformerConfig.tiny(), device="meta")
    sizes = bm.compute_module_sizes(model)
    assert sizes["layers//1//attn//q_proj//weight"] == 128 * 128 * 4
    assert sizes[""] == sum(p.numel() * 4 for p in model.parameters())
    assert sizes["layers"] == sizes["layers//0"] + sizes["layers//1"]


def test_get_max_memory_override_and_probe():
    mm = {0: "1GB", "cpu": 2 * 2**30}
    assert bm.get_max_memory(mm) == ref.get_max_memory(mm) == {0: 2**30, "cpu": 2 * 2**30}
    probed = bm.get_max_memory(cpu=True)
    assert "cpu" in probed and 0 in probed and probed[0] > 0
    assert probed[0] == ref.get_max_memory()[0]  # the reference's 4 GiB stand-in
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bm.get_max_memory()


def test_infer_auto_device_map_spills_tiers():
    arrays = _arrays()
    sizes = bm.compute_module_sizes(_ours(arrays))
    # the budget fits embed only on device 0; the rest spills to cpu, then disk
    mm = {0: sizes["embed"] + 64, "cpu": sizes["layer1"] + 64}
    dm = bm.infer_auto_device_map(_ours(arrays), mm)
    assert dm == ref.infer_auto_device_map(_theirs(arrays), mm)
    assert dm["embed//w"] == 0 and dm["layer1//kernel"] == "cpu" and dm["head//w"] == "disk"
    bm.check_device_map(_ours(arrays), dm)
    for no_split, disk in (([], True), (["layer1"], True), ([], False)):
        kw = dict(no_split=no_split, offload_to_disk=disk)
        try:
            want = ref.infer_auto_device_map(_theirs(arrays), mm, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                bm.infer_auto_device_map(_ours(arrays), mm, **kw)
        else:
            assert bm.infer_auto_device_map(_ours(arrays), mm, **kw) == want
    with pytest.raises(ValueError, match="does not cover"):
        bm.check_device_map(_ours(arrays), {"embed": 0})
    mm2 = {0: 10_000, 1: 10_000_000, "cpu": 1 << 30}
    for low_zero in (False, True):
        assert bm.get_balanced_memory(_ours(arrays), mm2, low_zero=low_zero) == \
            ref.get_balanced_memory(_theirs(arrays), mm2, low_zero=low_zero)


def test_dispatch_and_reload_disk(tmp_path):
    """The reference's map with the host tier where it puts device 0 (this
    machine has no card): values bit for bit, the disk leaves lazy and
    loadable, each package's loader reading the other's folder."""
    arrays = _arrays()
    dm = {"embed": "cpu", "layer1": "cpu", "layer2": "disk", "head": "cpu"}
    placed = bm.dispatch_params(_ours(arrays), dm, offload_dir=str(tmp_path / "port"))
    theirs = ref.dispatch_params(_theirs(arrays), dm, offload_dir=str(tmp_path / "ref"))
    assert isinstance(placed["embed"]["w"], torch.Tensor)
    handle = placed["layer2"]["kernel"]
    assert isinstance(handle, bm.OffloadedLeaf)
    assert handle.shape == (32, 32) and handle.dtype == torch.float32
    _assert_same_values(placed, theirs)
    for folder, loader_cls in (("port", ref_offload.OffloadedWeightsLoader),
                               ("ref", OffloadedWeightsLoader)):
        loader = loader_cls(save_folder=str(tmp_path / folder))
        np.testing.assert_array_equal(_np(loader["layer2//kernel"]), arrays["layer2"]["kernel"])
    # a device index needs the card: no fallback to the host
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bm.dispatch_params(_ours(arrays), {"embed": 0, "": "cpu"})


def test_disk_offloaded_model_forward(tmp_path):
    """A model with disk-offloaded weights still computes its logits."""
    arrays = _arrays(3)
    x = np.random.default_rng(4).standard_normal((4, 64)).astype(np.float32)
    dm = {"embed": "cpu", "layer1": "disk", "layer2": "disk", "head": "cpu"}
    placed = bm.dispatch_params(_ours(arrays), dm, offload_dir=str(tmp_path / "port"))
    live = bm.materialize_offloaded(placed, device="cpu")
    assert not any(isinstance(v, bm.OffloadedLeaf) for v in _flat(live).values())
    ours = _forward_torch(live, torch.from_numpy(x))
    assert torch.equal(ours, _forward_torch(_ours(arrays), torch.from_numpy(x)))
    theirs = ref.materialize_offloaded(
        ref.dispatch_params(_theirs(arrays), dm, offload_dir=str(tmp_path / "ref")))
    _close(ours.numpy(), _forward_jax(theirs, jnp.asarray(x)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bm.materialize_offloaded(placed)


def test_streamed_apply_matches_dense(tmp_path):
    """Layer groups streamed from disk (and from the host tier): the dense
    stacked forward bit for bit, and the reference's streamed output."""
    L, D = 6, 16
    rng = np.random.default_rng(0)
    stacked = {"w": (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32),
               "b": (rng.standard_normal((L, D)) * 0.01).astype(np.float32)}
    x = rng.standard_normal((4, D)).astype(np.float32)

    def block_torch(group, h):
        for i in range(group["w"].shape[0]):
            h = torch.tanh(h @ group["w"][i] + group["b"][i])
        return h

    def block_jax(group, h):
        for i in range(group["w"].shape[0]):
            h = jnp.tanh(h @ group["w"][i] + group["b"][i])
        return h

    dense = block_torch(_ours(stacked), torch.from_numpy(x))
    disk = bm.disk_offload(_ours(stacked), str(tmp_path / "port"))
    assert all(isinstance(leaf, bm.OffloadedLeaf) for leaf in disk.values())
    seen = []
    out = bm.streamed_apply(lambda g, h: seen.append(g["w"].shape[0]) or block_torch(g, h),
                            disk, torch.from_numpy(x), group_size=4)
    assert seen == [4, 2] and torch.equal(out, dense)
    host = bm.cpu_offload(_ours(stacked))
    assert torch.equal(bm.streamed_apply(block_torch, host, torch.from_numpy(x), 2), dense)
    theirs = ref.streamed_apply(block_jax, ref.disk_offload(_theirs(stacked),
                                                            str(tmp_path / "ref")),
                                jnp.asarray(x), group_size=2)
    _close(out.numpy(), theirs)
    with pytest.raises(ValueError, match="group_size"):
        bm.streamed_apply(block_torch, disk, torch.from_numpy(x), group_size=0)
    with pytest.raises(ValueError, match="0-dim leaf"):
        bm.streamed_apply(block_torch, {"s": torch.ones(())}, torch.from_numpy(x))


def test_cpu_and_disk_offload_whole_tree(tmp_path):
    arrays = _arrays()
    host = bm.cpu_offload(_ours(arrays))
    assert all(isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
               for leaf in _flat(host).values())
    _assert_same_values(host, ref.cpu_offload(_theirs(arrays)))
    disk = bm.disk_offload(_ours(arrays), str(tmp_path))
    assert os.path.isfile(tmp_path / "index.json")
    assert all(isinstance(leaf, bm.OffloadedLeaf) for leaf in _flat(disk).values())
    _assert_same_values(disk, _theirs(arrays))


def test_load_checkpoint_and_dispatch_device_map(tmp_path):
    """Each package loads the checkpoint the other wrote, bit for bit."""
    arrays = _arrays(5)
    save_model_weights(_ours(arrays), str(tmp_path / "port"), max_shard_size="8KB")
    ref_save(_theirs(arrays), str(tmp_path / "ref"), max_shard_size="8KB")
    template = _tree_map(lambda a: torch.empty(a.shape, device="meta"), arrays)
    abstract = _tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), arrays)
    for folder in ("port", "ref"):
        ours = bm.load_checkpoint_and_dispatch(template, str(tmp_path / folder),
                                               device_map={"": "cpu"})
        theirs = ref.load_checkpoint_and_dispatch(abstract, str(tmp_path / folder),
                                                  device_map={"": 0})
        _assert_same_values(ours, theirs)
        _assert_same_values(ours, arrays)
    half = bm.load_checkpoint_and_dispatch(template, str(tmp_path / "port"),
                                           device_map={"": "cpu"}, dtype=torch.bfloat16)
    want = ref.load_checkpoint_and_dispatch(abstract, str(tmp_path / "port"),
                                            device_map={"": 0}, dtype=jnp.bfloat16)
    assert half["head"]["w"].dtype == torch.bfloat16
    for name, leaf in _flat(half).items():
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                      np.asarray(_flat(want)[name]).view(np.int16))


def test_offload_state_dict_roundtrip(tmp_path):
    sd = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones((4,))}
    offload_state_dict(str(tmp_path), {k: torch.from_numpy(v) for k, v in sd.items()})
    loader = OffloadedWeightsLoader(save_folder=str(tmp_path))
    assert set(loader) == {"a", "b"}
    np.testing.assert_array_equal(loader["a"].numpy(), sd["a"])
    assert loader["b"].dtype == torch.float64
    assert len(PrefixedDataset(loader, "a")) == 1
    theirs = ref_offload.OffloadedWeightsLoader(save_folder=str(tmp_path))
    for k in sd:
        np.testing.assert_array_equal(loader[k].numpy(), theirs[k])


# ---------------------------------------------------------------------- #
# the port's model over the tiers
# ---------------------------------------------------------------------- #
def test_model_loads_over_the_host_and_disk_tiers_and_streams_its_layers(tmp_path):
    """A tiny CausalLM saved sharded, loaded from its meta model by an
    inferred map over the host and disk tiers (one group a layer), gives
    the saved model's logits bit for bit; its layers stacked on the disk
    tier and streamed two at a time give the dense layers' hidden states
    bit for bit, and the reference's logits within FP32_TOL when the
    reference's model holds the same weights."""
    cfg = port.TransformerConfig.tiny(num_layers=4, max_seq_len=64)
    model = port.CausalLM(cfg, device="cpu")
    save_model_weights(model, str(tmp_path / "ckpt"), max_shard_size="300KB")
    meta = bm.init_empty_weights(port.CausalLM, cfg)
    sizes = bm.compute_module_sizes(meta)
    dm = bm.infer_auto_device_map(meta, {"cpu": sizes["embed"] + sizes["layers//0"]})
    assert dm["embed//weight"] == dm["layers//0"] == "cpu"
    assert dm["layers//1"] == dm["lm_head//weight"] == "disk"
    tree = bm.load_checkpoint_and_dispatch(meta, str(tmp_path / "ckpt"), device_map="auto",
                                           max_memory={"cpu": sizes["embed"] + sizes["layers//0"]},
                                           offload_dir=str(tmp_path / "off"))
    assert isinstance(tree["layers.3.mlp.down_proj.weight"], bm.OffloadedLeaf)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    live = bm.materialize_offloaded(tree, "cpu")
    with torch.no_grad():
        logits = torch.func.functional_call(meta, live, (ids,))
        assert torch.equal(logits, model(ids))
    jcfg = JaxConfig.tiny(num_layers=4, max_seq_len=64)
    jparams = nn.unbox(JaxCausalLM(jcfg).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 8), jnp.int32)))
    for name, value in port.params_from_jax(jparams["params"], cfg).items():
        live[name] = value
    with torch.no_grad():
        ours = torch.func.functional_call(meta, live, (ids,))
    _close(ours.numpy(), JaxCausalLM(jcfg).apply(jparams, jnp.asarray(ids.numpy())))

    # the layers stacked on the disk tier, streamed two at a time
    block_names = [n for n, _ in model.layers[0].named_parameters()]
    stacked = {n: torch.stack([dict(layer.named_parameters())[n].detach()
                               for layer in model.layers]) for n in block_names}
    disk = bm.disk_offload(stacked, str(tmp_path / "stack"))
    x = model.embed(ids).detach()
    positions = torch.arange(12)[None].expand(2, 12)

    def block_fn(group, h):
        for i in range(next(iter(group.values())).shape[0]):
            h = torch.func.functional_call(model.layers[0], {n: t[i] for n, t in group.items()},
                                           (h, positions))
        return h

    with torch.no_grad():
        dense = x
        for layer in model.layers:
            dense = layer(dense, positions)
        assert torch.equal(bm.streamed_apply(block_fn, disk, x, group_size=2), dense)


def test_load_checkpoint_and_dispatch_refuses_a_mesh(tmp_path):
    """A load onto a mesh is ported (the world-4 tests below); what it
    refuses is a mesh that is not a torch ``DeviceMesh``, and a plugin or
    logical axes with no mesh to place on."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        bm.load_checkpoint_and_dispatch({}, str(tmp_path), mesh=object())
    with pytest.raises(ValueError, match="pass mesh="):
        bm.load_checkpoint_and_dispatch({}, str(tmp_path), logical_specs={})


@pytest.mark.parametrize("extra", [[], ["--hf_format", "--quantize", "int8"]])
def test_big_model_inference_example_on_the_cpu(tmp_path, extra):
    """The example at its tiny size with the CPU asked for: a 1 MiB budget
    spills to the disk tier, and the tiered load's greedy tokens equal those
    of the same weights loaded without offload."""
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=str(REPO))
    result = subprocess.run(
        [sys.executable, str(REPO / "accelerate_tpu_torch" / "examples" /
                             "big_model_inference.py"),
         "--cpu", "--max_memory_mb", "1", "--workdir", str(tmp_path), *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    lines = dict(line.split(": ", 1) for line in result.stdout.splitlines() if ": " in line)
    assert lines["device_map tiers in use"] == "['cpu', 'disk']"
    assert lines["resident generate"] == lines["tiered generate"]
    assert len(eval(lines["tiered generate"])) == 8
    assert os.listdir(tmp_path / "offload")
    if extra:
        assert "int8 load" in lines


def test_reference_checkpoints_of_every_dtype_load(tmp_path):
    """A checkpoint the reference wrote holding float64, int8, int16 and
    bool tensors (its ``safetensors`` writes them all) reads in the port bit
    for bit, through ``load_model_weights`` and the streamed reader. The
    port's codec knew six dtypes before this slice and refused these."""
    from accelerate_tpu_torch.checkpointing import load_model_weights

    rng = np.random.default_rng(0)
    arrays = {"f64": rng.standard_normal((3, 4)), "i8": rng.integers(-128, 127, (5,), np.int8),
              "i16": rng.integers(-999, 999, (2, 2), np.int16), "mask": rng.random(7) > 0.5,
              "f32": rng.standard_normal(4).astype(np.float32)}
    ref_save(arrays, str(tmp_path))
    named = load_model_weights(str(tmp_path))
    with bm._lazy_checkpoint_reader(str(tmp_path)) as read:
        for name, arr in arrays.items():
            for got in (named[name], read(name)):
                assert got.numpy().dtype == arr.dtype, name
                np.testing.assert_array_equal(got.numpy(), arr, err_msg=name)
            assert read.dtype(name) == named[name].dtype


# ---------------------------------------------------------------------- #
# a load onto a mesh (queue A7 part 2), at world 4 over gloo
# ---------------------------------------------------------------------- #
def test_load_checkpoint_and_dispatch_gspmd(tmp_path):
    """Mirror of ``test_big_modeling.py::test_load_checkpoint_and_dispatch_gspmd``:
    the reference test's tree, saved, streams onto a world-4 fsdp mesh
    (``min_weight_size`` 16): every leaf whole again equals what was saved,
    each leaf placed as the reference places it on its own fsdp mesh, the
    layer kernel split over fsdp."""
    import json

    from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from accelerate_tpu.parallel.sharding import infer_param_shardings as jax_infer
    from accelerate_tpu.utils.dataclasses import ParallelismPlugin as JaxPlugin

    from accelerate_tpu_torch.checkpointing import flatten_tree
    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.test_utils.scripts import sharding_workers

    arrays = _arrays()
    ckpt = tmp_path / "ckpt"
    save_model_weights(_ours(arrays), str(ckpt))
    named = flatten_tree(_ours(arrays))
    with open(ckpt / "shapes.json", "w") as f:
        json.dump({k: list(v.shape) for k, v in named.items()}, f)
    case = dict(name="gspmd", plugin=dict(dp_size=1, fsdp_size=4, min_weight_size=16),
                checkpoint=str(ckpt), kind="tree")
    debug_launcher(sharding_workers.mesh_load_worker, (str(tmp_path), [case]), num_processes=4)
    rec = torch.load(tmp_path / "gspmd.pt")
    for k, v in named.items():
        assert torch.equal(rec["whole"][k], v), k
    assert rec["specs"]["layer1//kernel"] == (None, "fsdp")
    mesh = jax_build_mesh(JaxPlugin(dp_size=1, fsdp_size=4, min_weight_size=16),
                          devices=jax.devices()[:4])
    ref = jax_infer(_theirs(arrays), mesh, JaxPlugin(dp_size=1, fsdp_size=4,
                                                     min_weight_size=16))
    for k, spec in rec["specs"].items():
        outer, inner = k.split("//")
        want = tuple(ref[outer][inner].spec) + (None,) * (len(spec) - len(ref[outer][inner].spec))
        assert spec == want, k


def test_big_model_inference_example_mesh_mode(tmp_path):
    """The example's GSPMD mode on the CPU: 4 processes (tp 2 x fsdp 2) each
    load their chunks onto the mesh and decode through the sharded forward;
    the tokens equal the resident load's."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    result = subprocess.run(
        [sys.executable, str(REPO / "accelerate_tpu_torch" / "examples" /
                             "big_model_inference.py"),
         "--cpu", "--tp", "2", "--fsdp", "2", "--workdir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    lines = dict(line.split(": ", 1) for line in result.stdout.splitlines() if ": " in line)
    assert lines["mesh generate"] == lines["resident generate"]
    assert len(eval(lines["mesh generate"])) == 8
