"""The port's migration shims against the reference's (``utils/compat.py``).

Mirrors ``tests/test_compat.py``: DeepSpeed's ZeRO stages, FSDP's names and
torch's integer codes, and Megatron's tp degree give the same
``ParallelismPlugin`` fields in both packages, and the plugins resolve to
the same meshes. Where the reference maps ``pp_degree`` and runs its
pipeline validator, the port raises naming queue A7 part 3
(``test_megatron_plugin_rejects_unsupported_combo_early`` becomes that
refusal). ``test_estimate_includes_activations`` is the ``estimate``
command's (queue A10) and is not mirrored here.
"""

import pytest

jax = pytest.importorskip("jax")
from accelerate_tpu.parallel.mesh import resolve_mesh_shape as jax_resolve  # noqa: E402
from accelerate_tpu.utils import compat as jax_compat  # noqa: E402

from accelerate_tpu_torch import ParallelismPlugin, ShardingStrategy  # noqa: E402
from accelerate_tpu_torch.parallel.mesh import resolve_mesh_shape  # noqa: E402
from accelerate_tpu_torch.utils import compat  # noqa: E402

FIELDS = ("dp_size", "fsdp_size", "tp_size", "sp_size", "ep_size", "pp_size",
          "min_weight_size", "num_micro_batches")


def _same(ours, theirs):
    for f in FIELDS:
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.sharding_strategy.value == theirs.sharding_strategy.value


@pytest.mark.parametrize(
    "stage,strategy",
    [(0, ShardingStrategy.NO_SHARD), (1, ShardingStrategy.SHARD_OPT),
     (2, ShardingStrategy.SHARD_GRAD_OP), (3, ShardingStrategy.FULL_SHARD)],
)
def test_deepspeed_zero_stage_mapping(stage, strategy):
    plugin = compat.DeepSpeedPlugin(zero_stage=stage, offload_param_device="cpu")
    assert isinstance(plugin, ParallelismPlugin)
    assert plugin.sharding_strategy is strategy
    if stage > 0:
        assert plugin.fsdp_size == -1 and plugin.dp_size == 1
    _same(plugin, jax_compat.DeepSpeedPlugin(zero_stage=stage, offload_param_device="cpu"))


def test_deepspeed_rejects_bad_stage():
    with pytest.raises(ValueError):
        compat.DeepSpeedPlugin(zero_stage=5)
    with pytest.raises(ValueError):
        jax_compat.DeepSpeedPlugin(zero_stage=5)


def test_fsdp_plugin_names_and_codes():
    p = compat.FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD",
                                              min_num_params=100)
    assert p.sharding_strategy is ShardingStrategy.FULL_SHARD
    assert p.min_weight_size == 100
    p2 = compat.FullyShardedDataParallelPlugin(sharding_strategy=2)  # torch's integer code
    assert p2.sharding_strategy is ShardingStrategy.SHARD_GRAD_OP
    p3 = compat.FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD")
    assert p3.fsdp_size == 1
    with pytest.raises(ValueError):
        compat.FullyShardedDataParallelPlugin(sharding_strategy="WHAT")
    for strategy in ("FULL_SHARD", "ShardingStrategy.HYBRID_SHARD", 1, 2, 3, 4):
        _same(compat.FullyShardedDataParallelPlugin(sharding_strategy=strategy),
              jax_compat.FullyShardedDataParallelPlugin(sharding_strategy=strategy))


def test_megatron_plugin_mapping():
    p = compat.MegatronLMPlugin(tp_degree=4, sequence_parallelism=True, num_layers=32)
    assert p.tp_size == 4 and p.pp_size == 1
    _same(p, jax_compat.MegatronLMPlugin(tp_degree=4, sequence_parallelism=True,
                                         num_layers=32))
    # the reference maps pipeline stages, clamping the microbatches up
    ref = jax_compat.MegatronLMPlugin(pp_degree=2, num_micro_batches=1)
    assert ref.pp_size == 2 and ref.num_micro_batches == 2


def test_megatron_plugin_rejects_pipeline_stages_naming_part_3():
    """The port has no pipeline stages: ``pp_degree > 1`` raises at the
    shim, naming queue A7 part 3, alone or with tp."""
    for kwargs in (dict(pp_degree=2, num_micro_batches=1),
                   dict(tp_degree=2, pp_degree=2, num_micro_batches=2)):
        with pytest.raises(NotImplementedError, match="MegatronLMPlugin.*queue A7 part 3"):
            compat.MegatronLMPlugin(**kwargs)


@pytest.mark.parametrize("devices", [4, 8])
def test_shim_plugins_resolve_to_the_reference_meshes(devices):
    """The shims' plugins resolve to the reference's mesh degrees (the
    meshes themselves are built at world 4 in
    ``test_torch_parallel_state.py``)."""
    for make in ("DeepSpeedPlugin", "FullyShardedDataParallelPlugin"):
        ours = resolve_mesh_shape(getattr(compat, make)(), devices)
        theirs = jax_resolve(getattr(jax_compat, make)(), devices)
        assert ours == dict(theirs) and ours["fsdp"] == devices
    ours = resolve_mesh_shape(compat.MegatronLMPlugin(tp_degree=2), devices)
    assert ours == dict(jax_resolve(jax_compat.MegatronLMPlugin(tp_degree=2), devices))
