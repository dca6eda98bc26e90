"""The port's sharding rules against the reference's, leaf by leaf, with no
process group.

For the tiny ``CausalLM`` (the reference's ``tiny()``: 4 heads, width 128,
MLP 352, vocab 1024) and the tiny classifier, under each plugin, every
parameter's spec from ``parallel.sharding.infer_param_shardings`` equals
the reference's ``infer_param_shardings`` spec on a JAX mesh of the same
shape (``build_mesh(plugin, devices=jax.devices()[:4])``), read through the
port's layout (a layer's leaf unstacked, a Dense kernel's two dims
swapped); so do the moments' (``infer_opt_state_shardings``) and the
logical axes against ``get_logical_specs``; under sp 2 and ep 2 (the tiny
MoE LM's expert stacks over ep) as well, and the pipeline's stacked layers
over pp against ``stacked_layer_shardings``. Then the mirrors of
``test_models.py::test_tp_sharding_placement`` and
``::test_fsdp_sharding_placement`` and
``test_zero.py::test_zero1_keeps_embedding_replicated``, the specs as
DTensor placements and back, and the chunk bounds.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import SequenceClassifier as JaxClassifier  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from accelerate_tpu.parallel import sharding as jax_sharding  # noqa: E402
from accelerate_tpu.utils.dataclasses import ParallelismPlugin as JaxPlugin  # noqa: E402
from accelerate_tpu.utils.dataclasses import ShardingStrategy as JaxStrategy  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.parallel import sharding  # noqa: E402

CASES = {
    "pure_dp": dict(dp_size=4, fsdp_size=1, sharding_strategy="no_shard"),
    "fsdp4_min1024": dict(dp_size=1, fsdp_size=4, min_weight_size=1024),
    "fsdp4_min8": dict(dp_size=1, fsdp_size=4, min_weight_size=8),
    "dp2_tp2": dict(dp_size=2, tp_size=2),
    "fsdp2_tp2": dict(dp_size=1, fsdp_size=2, tp_size=2),
    "shard_opt_fsdp4": dict(dp_size=1, fsdp_size=4, sharding_strategy="shard_opt",
                            min_weight_size=8),
    "shard_grad_op_fsdp4": dict(dp_size=1, fsdp_size=4, sharding_strategy="shard_grad_op",
                                min_weight_size=8),
}


MOE = dict(num_experts=4, num_experts_per_tok=2)
# the axes of queue A7 part 4: the sequence over sp, the experts over ep
PART4_CASES = {"dp2_sp2": dict(dp_size=2, sp_size=2),
               "dp2_ep2": dict(dp_size=2, ep_size=2),
               "fsdp2_ep2": dict(dp_size=1, fsdp_size=2, ep_size=2, min_weight_size=1024)}


def _plugins(kwargs):
    jkw, pkw = dict(kwargs), dict(kwargs)
    if "sharding_strategy" in kwargs:
        jkw["sharding_strategy"] = JaxStrategy(kwargs["sharding_strategy"])
        pkw["sharding_strategy"] = port.ShardingStrategy(kwargs["sharding_strategy"])
    return JaxPlugin(**jkw), port.ParallelismPlugin(**pkw)


def _reference_tree(model_cls, cfg, **kw):
    variables = model_cls(cfg, **kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return variables


def _ref_path(name: str):
    """The reference's path of a port parameter, and whether the leaf is a
    stacked layer's (its dim 0 the layers) and a Dense kernel (dims
    swapped)."""
    parts = name.split(".")
    stacked = parts[0] == "layers"
    mods, leaf = (parts[2:-1] if stacked else parts[:-1]), parts[-1]
    if leaf == "weight":
        leaf = ("scale" if mods[-1].endswith("norm") else "embedding" if mods == ["embed"]
                else "kernel")
    return (["layers"] if stacked else []) + mods + [leaf], stacked, leaf == "kernel"


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _norm(entry):
    if isinstance(entry, (list, tuple)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def _to_port(spec, ndim, stacked, kernel):
    """A reference spec in the port's layout: the stacked dim (which must be
    whole) dropped, a kernel's two dims swapped."""
    entries = [_norm(e) for e in spec] + [None] * (ndim + 1)
    if stacked:
        assert entries[0] is None, spec
        entries = entries[1:]
    entries = entries[:ndim]
    return tuple(entries[::-1]) if kernel else tuple(entries)


def _both(model_name, kwargs, opt=False):
    """(port specs, reference specs in the port's layout) for each param."""
    jplugin, pplugin = _plugins(kwargs)
    mesh = jax_build_mesh(jplugin, devices=jax.devices()[:4])
    if model_name == "lm":
        variables = _reference_tree(JaxCausalLM, JaxConfig.tiny())
        model = port.CausalLM(port.TransformerConfig.tiny(), device="meta")
    elif model_name == "moe":
        variables = _reference_tree(JaxCausalLM, JaxConfig.tiny(**MOE))
        model = port.CausalLM(port.TransformerConfig.tiny(**MOE), device="meta")
    else:
        jcfg = JaxConfig.tiny(causal=False, attention_impl="xla")
        variables = _reference_tree(JaxClassifier, jcfg, num_labels=3)
        model = port.SequenceClassifier(port.TransformerConfig.tiny(causal=False), num_labels=3,
                                        device="meta")
    raw = jax_sharding.unbox_params(variables)["params"]
    logical = jax_sharding.get_logical_specs(variables)["params"]
    if opt:
        ref = jax_sharding.infer_opt_state_shardings(jax.eval_shape(lambda: raw), mesh, jplugin)
    else:
        ref = jax_sharding.infer_param_shardings(raw, mesh, jplugin, logical_specs=logical)
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    fn = sharding.infer_opt_state_shardings if opt else sharding.infer_param_shardings
    ours = fn(shapes, dict(mesh.shape), pplugin, sharding.get_logical_specs(model))
    want = {}
    for name, shape in shapes.items():
        path, stacked, kernel = _ref_path(name)
        want[name] = _to_port(tuple(_get(ref, path).spec), len(shape), stacked, kernel)
    got = {k: tuple(_norm(e) for e in v) for k, v in ours.items()}
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_param_placements_match_the_reference(case):
    got, want = _both("lm", CASES[case])
    assert got == want


@pytest.mark.parametrize("case", ["fsdp4_min8", "shard_opt_fsdp4", "shard_grad_op_fsdp4"])
def test_moment_placements_match_the_reference(case):
    got, want = _both("lm", CASES[case], opt=True)
    assert got == want
    # ZeRO-1/2 moments split over fsdp while their params stay whole
    if "shard" in case:
        params, _ = _both("lm", CASES[case])
        assert all("fsdp" not in str(s) for s in params.values())
        assert any("fsdp" in str(s) for s in got.values())


@pytest.mark.parametrize("model", ["lm", "moe"])
@pytest.mark.parametrize("case", sorted(PART4_CASES))
def test_sp_and_ep_placements_match_the_reference(case, model):
    """Every leaf of the tiny LM and the tiny MoE LM under sp 2 and ep 2
    (with dp, and with fsdp) takes the reference's spec; the expert stacks
    split over ep."""
    got, want = _both(model, PART4_CASES[case])
    assert got == want
    if model == "moe" and "ep" in case:
        assert all("ep" in str(v) for k, v in got.items()
                   if k.endswith(("moe.gate_proj", "moe.up_proj", "moe.down_proj")))


def test_pp_stacked_placements_match_the_reference():
    """The stacked layers of a pipeline: each leaf's layer dim over pp where
    pp divides it, else whole, as the reference's
    ``stacked_layer_shardings``."""
    from accelerate_tpu.parallel.pipeline import stacked_layer_shardings as jax_stacked

    import torch

    from accelerate_tpu_torch.parallel.pipeline import stacked_layer_shardings

    mesh = jax_build_mesh(JaxPlugin(dp_size=2, pp_size=2, num_micro_batches=2),
                          devices=jax.devices()[:4])
    tree = {"w": np.zeros((4, 16, 32), np.float32), "v": np.zeros((4, 32, 16), np.float32),
            "b": np.zeros((4, 16), np.float32), "odd": np.zeros((3, 8), np.float32),
            "scalar": np.zeros((), np.float32)}
    ref = jax_stacked(tree, mesh)
    ours = stacked_layer_shardings({k: torch.from_numpy(v) for k, v in tree.items()},
                                   {"dp": 2, "pp": 2})
    for name, sharding_ in ref.items():
        want = tuple(_norm(e) for e in sharding_.spec) + (None,) * tree[name].ndim
        assert ours[name] == want[:tree[name].ndim], name
    assert ours["w"] == ("pp", None, None) and ours["odd"] == (None, None)


@pytest.mark.parametrize("case", ["fsdp4_min1024", "dp2_tp2", "fsdp2_tp2"])
def test_classifier_placements_match_the_reference(case):
    got, want = _both("classifier", CASES[case])
    assert got == want


def test_logical_axes_match_get_logical_specs():
    variables = _reference_tree(JaxCausalLM, JaxConfig.tiny())
    logical = jax_sharding.get_logical_specs(variables)["params"]
    raw = jax_sharding.unbox_params(variables)["params"]
    model = port.CausalLM(port.TransformerConfig.tiny(), device="meta")
    for name, axes in sharding.get_logical_specs(model).items():
        path, _, _ = _ref_path(name)
        assert tuple(axes.logical) == tuple(_get(logical, path)), name
        assert tuple(axes.ref_shape) == tuple(_get(raw, path).shape), name


def test_tp_sharding_placement():
    """Mirror of ``test_models.py::test_tp_sharding_placement`` at dp 2 x
    tp 2: the up projection splits its mlp dim over tp, the final norm does
    not."""
    model = port.CausalLM(port.TransformerConfig.tiny(), device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    specs = sharding.infer_param_shardings(
        shapes, {"dp": 2, "tp": 2}, port.ParallelismPlugin(dp_size=2, tp_size=2),
        sharding.get_logical_specs(model))
    assert specs["layers.0.mlp.up_proj.weight"] == ("tp", None)  # (mlp, embed)
    assert "tp" not in str(specs["final_norm.weight"])


def test_fsdp_sharding_placement():
    """Mirror of ``test_models.py::test_fsdp_sharding_placement`` at fsdp
    4: down_proj splits over fsdp, leaves under ``min_weight_size`` stay
    whole."""
    model = port.CausalLM(port.TransformerConfig.tiny(), device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    specs = sharding.infer_param_shardings(
        shapes, {"fsdp": 4}, port.ParallelismPlugin(dp_size=1, fsdp_size=4,
                                                     min_weight_size=1024),
        sharding.get_logical_specs(model))
    assert "fsdp" in str(specs["layers.0.mlp.down_proj.weight"])
    assert specs["final_norm.weight"] == (None,)


def test_zero1_keeps_embedding_replicated():
    """Mirror of ``test_zero.py::test_zero1_keeps_embedding_replicated``:
    the embedding's ("vocab", "zero") seat shards weights only under
    ZeRO-3 strategies; under SHARD_OPT the params stay whole."""
    model = port.CausalLM(port.TransformerConfig.tiny(), device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    specs = sharding.infer_param_shardings(
        shapes, {"fsdp": 4}, port.ParallelismPlugin(
            dp_size=1, fsdp_size=4, sharding_strategy=port.ShardingStrategy.SHARD_OPT,
            min_weight_size=16),
        sharding.get_logical_specs(model))
    assert "fsdp" not in str(specs["embed.weight"]), specs["embed.weight"]


@pytest.mark.parametrize("spec", [(None, None), ("fsdp", None), (None, "tp"),
                                  (("tp", "fsdp"), None), (("dp", "fsdp"), "tp")])
def test_placements_round_trip(spec):
    """A spec as DTensor placements and back; a dim split over tp then fsdp
    (against the mesh's order) takes _StridedShard on fsdp."""
    mesh = {"dp": 2, "fsdp": 2, "tp": 2}
    placements = sharding.placements_for(spec, mesh)
    assert len(placements) == 6
    assert sharding.spec_of_placements(placements, 2) == spec
    if spec[0] == ("tp", "fsdp"):
        assert type(placements[2]).__name__ == "_StridedShard"
        assert placements[2].split_factor == 2


def test_local_bounds_tile_in_the_reference_order():
    """Each rank's chunk under ("tp", "fsdp") on dim 0: tp major, so a
    gather over fsdp gives each tp rank a contiguous block; the chunks of
    all ranks tile the leaf once; replica 0 of each chunk is unique."""
    mesh = {"fsdp": 2, "tp": 2}
    spec = (("tp", "fsdp"), None)
    seen = {}
    for rank in range(4):
        coord = sharding.mesh_coordinate(rank, mesh)
        bounds = sharding.local_bounds(spec, (8, 3), rank, mesh)
        assert bounds[0][0] == 2 * (2 * coord["tp"] + coord["fsdp"])
        seen[bounds] = rank
    assert len(seen) == 4
    owners = [r for r in range(4) if sharding.is_replica_zero((None, "tp"), r, mesh)]
    assert owners == [0, 1]  # fsdp coordinate 0 writes each tp chunk
    with pytest.raises(ValueError, match="evenly"):
        sharding.local_bounds(("fsdp",), (3,), 0, {"fsdp": 2})


def test_stacked_dim_choice_refuses():
    """A leaf whose fsdp dim would be the reference's stacked layers dim
    cannot be split a layer at a time: refused by name, not placed
    elsewhere."""
    model = port.CausalLM(port.TransformerConfig.tiny(num_layers=4, hidden_size=6,
                                                      num_heads=1, intermediate_size=6,
                                                      vocab_size=6), device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    with pytest.raises(NotImplementedError, match="stacked dim"):
        sharding.infer_param_shardings(shapes, {"fsdp": 4},
                                       port.ParallelismPlugin(dp_size=1, fsdp_size=4,
                                                              min_weight_size=1),
                                       sharding.get_logical_specs(model))
    assert np.prod(shapes["embed.weight"]) == 36


@pytest.mark.parametrize("kwargs", [dict(dp_size=2, sp_size=2), dict(dp_size=2, ep_size=2),
                                    dict(dp_size=4)])
def test_batch_sharding_puts_the_sequence_on_sp(kwargs):
    """``batch_sharding(mesh, seq_dim=1)``: the rows over the data axes and
    the sequence over sp, the reference's spec (the port's took no
    ``seq_dim`` before the sp axis was ported)."""
    jplugin, _ = _plugins(kwargs)
    mesh = jax_build_mesh(jplugin, devices=jax.devices()[:4])
    ref = tuple(_norm(e) for e in jax_sharding.batch_sharding(mesh, seq_dim=1).spec)
    ref = (ref + (None, None))[:2]
    ours = sharding.spec_of_placements(sharding.batch_sharding(dict(mesh.shape), seq_dim=1), 2)
    assert ours == ref
    assert sharding.spec_of_placements(sharding.batch_sharding(dict(mesh.shape)), 1) == ref[:1]
