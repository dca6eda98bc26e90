"""The port's mesh and its state against the reference's.

Mirrors the mesh tests of ``tests/test_state.py``: the resolution errors,
the plugin's environment transport and the strategy enum run here on both
packages, with no process group; the meshes themselves are built in one
world-4 launch over gloo (the reference builds them on 4 of its 8 virtual
devices): the default (every rank on dp), the hybrid dp x fsdp x tp mesh
(``data_parallel_size`` dp x fsdp), each rank's data-parallel rank, the
state's repr naming the mesh, the tp groups, the compat plugins' meshes,
and degrees that do not cover the world, which raise naming them.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from accelerate_tpu.parallel.mesh import data_axes as jax_data_axes  # noqa: E402
from accelerate_tpu.parallel.mesh import resolve_mesh_shape as jax_resolve  # noqa: E402
from accelerate_tpu.utils.dataclasses import ParallelismPlugin as JaxPlugin  # noqa: E402
from accelerate_tpu.utils.dataclasses import ShardingStrategy as JaxStrategy  # noqa: E402

from accelerate_tpu_torch import ParallelismPlugin, ShardingStrategy  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.parallel.mesh import (  # noqa: E402
    data_axes,
    fault_domain_of_rank,
    mesh_coordinate,
    resolve_mesh_shape,
)
from accelerate_tpu_torch.test_utils.scripts import sharding_workers  # noqa: E402

WORLD = 4


@pytest.fixture(scope="module")
def world_four(tmp_path_factory):
    out = tmp_path_factory.mktemp("state4")
    debug_launcher(sharding_workers.state_worker, (str(out),), num_processes=WORLD)
    return [torch.load(os.path.join(out, f"state_{r}.pt")) for r in range(WORLD)]


def _reference_mesh(**kwargs):
    return jax_build_mesh(JaxPlugin(**kwargs), devices=jax.devices()[:WORLD])


def test_accelerator_state_mesh_default_dp(world_four):
    ref = _reference_mesh()
    for rec in world_four:
        assert rec["default"]["shape"] == dict(ref.shape)
        assert rec["default"]["shape"]["dp"] == WORLD
        assert rec["default"]["dps"] == WORLD
    assert [r["default"]["dp_rank"] for r in world_four] == list(range(WORLD))


def test_accelerator_state_mesh_hybrid(world_four):
    ref = _reference_mesh(dp_size=-1, fsdp_size=2, tp_size=2)
    for rec in world_four:
        hybrid = rec["hybrid"]
        assert hybrid["shape"] == dict(ref.shape) == {
            "dp": 1, "pp": 1, "fsdp": 2, "ep": 1, "sp": 1, "tp": 2}
        assert hybrid["dps"] == 2  # dp x fsdp
        assert tuple(hybrid["axes"]) == tuple(jax_data_axes(ref))
    # tp peers share a data rank; rank = fsdp-major, tp-minor
    assert [r["hybrid"]["dp_rank"] for r in world_four] == [0, 0, 1, 1]
    assert [r["hybrid"]["tp_ranks"] for r in world_four] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    dp_fsdp = world_four[0]["dp_fsdp"]
    assert dp_fsdp["shape"] == dict(_reference_mesh(dp_size=-1, fsdp_size=2).shape)
    assert dp_fsdp["dps"] == 4
    assert [r["dp_fsdp"]["dp_rank"] for r in world_four] == [0, 1, 2, 3]
    assert [r["tp"]["dp_rank"] for r in world_four] == [0, 0, 1, 1]


def test_state_repr_names_the_mesh(world_four):
    text = world_four[0]["hybrid"]["repr"]
    assert "Mesh: {'dp': 1, 'pp': 1, 'fsdp': 2, 'ep': 1, 'sp': 1, 'tp': 2}" in text
    assert "Num processes: 4" in text


def test_compat_plugins_build_meshes(world_four):
    """Mirror of ``test_compat.py::test_shim_plugins_build_meshes`` at world 4."""
    rec = world_four[0]
    assert rec["deepspeed3"]["shape"]["fsdp"] == WORLD
    assert rec["fsdp_plugin"]["shape"]["fsdp"] == WORLD
    assert rec["megatron_tp2"]["shape"]["tp"] == 2 and rec["megatron_tp2"]["shape"]["dp"] == 2


def test_collectives_take_a_sharded_leaf_whole(world_four):
    """``operations.gather`` and ``reduce`` given a DTensor (one global
    array, as the reference's globally sharded ``jax.Array``): the whole
    array on every process, and for ``reduce`` that array times the scale
    (reference ``utils/operations.py:205-209``, :283-287). Before the
    sharding slice they ran the per-process collective on the DTensor."""
    for rec in world_four:
        assert rec["sharded_gather"] and rec["sharded_reduce"]


def test_mesh_mismatch_raises_naming_the_degrees(world_four):
    for rec in world_four:
        assert rec["mismatch"] is not None
        assert "do not divide device count 4" in rec["mismatch"], rec["mismatch"]


def test_resolve_mesh_shape_errors():
    for ours, theirs in ((ParallelismPlugin, JaxPlugin),):
        with pytest.raises(ValueError):
            resolve_mesh_shape(ours(dp_size=3, fsdp_size=1), 8)
        with pytest.raises(ValueError):
            jax_resolve(theirs(dp_size=3, fsdp_size=1), 8)
        with pytest.raises(ValueError, match="use 4 devices but 8"):
            resolve_mesh_shape(ours(dp_size=2, fsdp_size=2), 8)
        with pytest.raises(ValueError):
            jax_resolve(theirs(dp_size=2, fsdp_size=2), 8)
        shape = resolve_mesh_shape(ours(dp_size=-1, tp_size=4), 8)
        assert shape["dp"] == 2 and shape["tp"] == 4
        assert shape == dict(jax_resolve(theirs(dp_size=-1, tp_size=4), 8))


def test_plugin_env_roundtrip(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_TP_SIZE", "4")
    monkeypatch.setenv("ACCELERATE_TPU_SHARDING_STRATEGY", "shard_opt")
    plugin = ParallelismPlugin()
    assert plugin.tp_size == 4 == JaxPlugin().tp_size
    assert plugin.sharding_strategy is ShardingStrategy.SHARD_OPT
    # a value passed wins over the environment
    assert ParallelismPlugin(tp_size=2).tp_size == 2
    with pytest.raises(ValueError, match="at most one"):
        ParallelismPlugin(dp_size=-1, fsdp_size=-1)


def test_sharding_strategy_enum():
    assert "full_shard" in ShardingStrategy
    assert ShardingStrategy("no_shard") == ShardingStrategy.NO_SHARD
    assert [s.value for s in ShardingStrategy] == [s.value for s in JaxStrategy]
    assert ParallelismPlugin.pure_dp().sharding_strategy is ShardingStrategy.NO_SHARD


def test_mesh_coordinates_and_data_axes_are_the_reference_layout():
    """Rank r sits where the reference's ``devices.reshape(dims)`` puts
    device r; the data axes are the reference's."""
    ref = _reference_mesh(dp_size=1, fsdp_size=2, tp_size=2)
    shape = dict(ref.shape)
    for idx, device in enumerate(ref.devices.flat):
        coord = mesh_coordinate(device.id, shape)
        assert list(coord.values()) == list(
            int(i) for i in np.unravel_index(idx, ref.devices.shape))
    assert data_axes(shape) == jax_data_axes(ref)
    assert fault_domain_of_rank(3, 4, 2) == 1
