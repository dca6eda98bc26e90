"""Sharded checkpoints of the port, across world sizes and across packages.

Mirrors the sharded cases of ``tests/test_dist_checkpoint.py`` over three
gloo launches (world 4, then 2, then 4 again), the world-1 cases in this
process:

* ``test_sharded_roundtrip_fsdp``, ``_restore_onto_different_sharding``,
  ``_save_state_uses_sharded_format``, ``_incomplete_checkpoint_fails_loudly``,
  ``_nonstrict_load_keeps_template_extras``, ``test_restore_across_world_sizes``
  (m 1, 2, 4), ``test_round_trip_n_m_n_is_bitwise`` (4 -> 2 -> 4) and the
  ``load_full_named`` half of ``test_load_full_named_and_merge_cli`` (the
  merge command is queue A10's);
* every chunk of a world-4 checkpoint is written once, by the process that
  holds it;
* across packages: the port's world-4 FULL_SHARD checkpoint (fsdp 2 x tp 2,
  each process writing its own chunks) loads in the reference through
  ``carry_to_jax`` bit for bit, and the reference's 4-way sharded checkpoint
  loads into the port at world 2 bit for bit.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu import dist_checkpoint as jax_dc  # noqa: E402
from accelerate_tpu.checkpointing import flatten_tree as jax_flatten  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch import dist_checkpoint  # noqa: E402
from accelerate_tpu_torch.checkpoint_async import commit as commit_mod  # noqa: E402
from accelerate_tpu_torch.checkpointing import flatten_tree  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import sharding_workers  # noqa: E402
from accelerate_tpu_torch.test_utils.training import TINY_LM, TINY_SEQ  # noqa: E402


def _reference_4way(out):
    """The reference's train-like tree saved 4-way by its own writer."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax_build_mesh(jax_pkg.ParallelismPlugin(dp_size=1, fsdp_size=4, min_weight_size=1),
                          devices=jax.devices()[:4])
    source = {k: v.numpy() for k, v in flatten_tree(sharding_workers._train_like_tree()).items()}
    tree = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("fsdp") if v.ndim else P()))
            for k, v in source.items()}
    jax_dc.save_sharded_tree(tree, os.path.join(out, "ref4"))
    with open(os.path.join(out, "ref_names.json"), "w") as f:
        json.dump({k: [list(v.shape), str(v.dtype)] for k, v in source.items()}, f)
    return source


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt_worlds")
    init = jax.tree.map(np.asarray, nn.unbox(JaxCausalLM(JaxConfig(**TINY_LM)).init_params(
        jax.random.PRNGKey(0), seq_len=TINY_SEQ)))
    torch.save(dict(port.params_from_jax(init, port.TransformerConfig(**TINY_LM))),
               os.path.join(out, "init.pt"))
    ref_source = _reference_4way(out)
    debug_launcher(sharding_workers.checkpoint_world_four, (str(out),), num_processes=4)
    debug_launcher(sharding_workers.checkpoint_world_two, (str(out),), num_processes=2)
    debug_launcher(sharding_workers.checkpoint_world_four, (str(out), True), num_processes=4)

    def load(name, n):
        return [torch.load(os.path.join(out, f"{name}_{r}.pt")) for r in range(n)]

    return {"out": str(out), "init": init, "ref_source": ref_source,
            "four": load("ck4", 4), "two": load("ck2", 2), "back": load("ck4b", 4)}


def _train_like():
    return flatten_tree(sharding_workers._train_like_tree())


def _equal_named(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(v)), k


def test_sharded_roundtrip_fsdp(worlds):
    rec = worlds["four"][0]
    assert all(r["small_roundtrip"] for r in worlds["four"])
    # fsdp 4 splits the (16, 16) kernel on its later dim: 4 distinct chunks,
    # each written once, by its own process
    small = os.path.join(worlds["out"], "small")
    assert dist_checkpoint.is_sharded_checkpoint(small)
    manifest = dist_checkpoint._merged_manifest(small)
    assert len(manifest["kernel"]["chunks"]) == 4 and manifest["kernel"]["shape"] == [16, 16]
    assert manifest["bias"]["dtype"] == "bfloat16"
    assert rec["small_specs"]["kernel"] == (None, "fsdp")
    assert rec["small_specs"]["counter"] == ()


def test_sharded_restore_onto_different_sharding(worlds):
    assert all(r["small_onto_replicated"] for r in worlds["four"])


def test_load_full_named(worlds):
    """The ``load_full_named`` half of ``test_load_full_named_and_merge_cli``."""
    named = dist_checkpoint.load_full_named(os.path.join(worlds["out"], "small"))
    _equal_named(named, sharding_workers._small_tree())


def test_save_state_uses_sharded_format(worlds):
    for rec in worlds["four"]:
        assert rec["state_roundtrip"]
        files = rec["state_files"]
        assert "model.safetensors" not in files
        assert {f"state_index_{p:05d}.json" for p in range(4)} <= set(files)


def test_incomplete_checkpoint_fails_loudly(worlds, tmp_path):
    ck = str(tmp_path / "ck")
    shutil.copytree(os.path.join(worlds["out"], "small"), ck)
    # a lost host: process 3's chunk of the kernel gone from its manifest
    idx = os.path.join(ck, "state_index_00003.json")
    with open(idx) as f:
        manifest = json.load(f)
    manifest.pop("kernel")
    with open(idx, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="incomplete|cover"):
        dist_checkpoint.load_full_named(ck)
    with pytest.raises(ValueError, match="not covered"):
        dist_checkpoint.validate_coverage(ck)


def test_nonstrict_load_keeps_template_extras(worlds):
    for rec in worlds["four"]:
        assert rec["strict_raised"] and rec["nonstrict"]


@pytest.mark.parametrize("m", [2, 1, 4])
def test_restore_across_world_sizes(worlds, m):
    """Saved 4-way; restored bit for bit at world 2 (fsdp 2), at world 1
    into a plain template, and at world 4."""
    want = _train_like()
    if m == 1:
        template = sharding_workers._zeros_like_tree(sharding_workers._train_like_tree())
        got = flatten_tree(dist_checkpoint.load_sharded_tree(
            template, os.path.join(worlds["out"], "ck4")))
        _equal_named(got, want)
    else:
        recs = worlds["two"] if m == 2 else worlds["four"]
        for rec in recs:
            _equal_named(rec[f"restore_{m}"], want)
    _equal_named(dist_checkpoint.load_full_named(os.path.join(worlds["out"], "ck4")), want)


def test_round_trip_n_m_n_is_bitwise(worlds):
    for rec in worlds["back"]:
        _equal_named(rec["n_m_n"], _train_like())


def _chunks_by_writer(path):
    """``{process: [(leaf, offset)]}`` from each process's own manifest; each
    chunk names its process's shard file."""
    out = {}
    for idx in sorted(glob.glob(os.path.join(path, "state_index_*.json"))):
        proc = int(idx[-10:-5])
        with open(idx) as f:
            frag = json.load(f)
        for key, entry in frag.items():
            for chunk in entry["chunks"]:
                assert chunk["file"] == f"state_shard_{proc:05d}.safetensors", (key, proc)
                out.setdefault(proc, []).append((key, tuple(chunk["offset"])))
    return out


def test_each_chunk_is_written_once_by_its_process(worlds):
    for name in ("ck4", "small"):
        path = os.path.join(worlds["out"], name)
        writers = _chunks_by_writer(path)
        assert sorted(writers) == [0, 1, 2, 3]  # every process wrote its own chunks
        stats = dist_checkpoint.validate_coverage(path)
        assert stats["files"] == 4
    # the FULL_SHARD model (fsdp 2 x tp 2): a leaf split over both axes has
    # four writers, a tp-split one two (fsdp coordinate 0), a whole one one
    path = worlds["four"][0]["lm_path"]
    writers = _chunks_by_writer(path)
    specs = worlds["four"][0]["lm_specs"]
    count = {}
    for proc, chunks in writers.items():
        for key, _ in chunks:
            count.setdefault(key, set()).add(proc)
    for name, spec in specs.items():
        axes = {a for e in spec if e for a in ((e,) if isinstance(e, str) else e)}
        want = {frozenset(): {0}, frozenset({"tp"}): {0, 1}, frozenset({"fsdp"}): {0, 2},
                frozenset({"fsdp", "tp"}): {0, 1, 2, 3}}[frozenset(axes)]
        assert count[f"params//{name}"] == want, (name, spec)
    assert dist_checkpoint.validate_coverage(path)["files"] == 4


def test_port_full_shard_checkpoint_loads_in_the_reference(worlds, tmp_path):
    path = worlds["four"][0]["lm_path"]
    saved = dist_checkpoint.load_full_named(path)
    carry = {k: v for k, v in worlds["four"][0]["lm_carry"].items()
             if isinstance(v, torch.Tensor)}
    _equal_named({k: v for k, v in saved.items() if k in carry}, carry)
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    jacc = jax_pkg.Accelerator()
    params, opt = jacc.prepare(jax.tree.map(jnp.asarray, worlds["init"]), optax.adamw(1e-2))
    jcarry = jacc.init_carry(params, opt)
    like = {k: np.asarray(v) for k, v in jax_flatten(jcarry).items()}
    named = port.carry_to_jax(saved, like)
    ref_dir = str(tmp_path / "as_ref")
    work = commit_mod.work_dir_for(ref_dir)
    dist_checkpoint.save_sharded_tree(named, work, process_index=0)
    commit_mod.commit(work, ref_dir, 0, 1, topology={"world_size": 1, "num_devices": 8})
    loaded = jacc.load_state(ref_dir, carry=jcarry, allow_reshape=True)
    flat = jax_flatten(loaded)
    for k, v in named.items():
        assert np.array_equal(np.asarray(flat[k]), v), k
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


def test_reference_4way_checkpoint_loads_into_the_port_at_world_two(worlds):
    for rec in worlds["two"]:
        assert rec["ref4_specs"]["params//kernel"] == ("fsdp", None)
        got = rec["ref4"]
        for k, v in worlds["ref_source"].items():
            assert np.array_equal(got[k].numpy(), v), k
