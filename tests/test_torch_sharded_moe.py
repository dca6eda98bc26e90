"""MoE experts under tensor parallelism, and the capacity dispatch under
ep x sp, on the port at world 4 over gloo, against the reference under the
same plugin and the port's own world 1.

One world-4 launch of ``tp_workers.adapters_experts_worker`` runs the tiny
MoE model (4 experts, top 2) with its stacks' ``mlp`` dim split over tp:
the ragged, capacity and dense dispatches at dp 2 x tp 2, the
shard-capacity schedule at ep 2 x tp 2, and the capacity dispatch at
ep 2 x sp 2 with ring attention (each rank a sequence chunk; the capacity
is the global batch's, over the chunks put back in row order, at a
capacity factor that drops): the logits and one sgd step (its loss, and the
params after it: every gradient, the router's and each stack's, times 0.5)
match world 1 and the reference's under that plugin (its logits as in
``tests/test_models.py:88``, its step through ``unified_step``).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import linen as nn  # noqa: E402

import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import tp_workers  # noqa: E402

TOL = 2e-5
MOE = dict(num_experts=4, num_experts_per_tok=2, max_seq_len=64)
# name: (the mesh, the config's overrides, the reference's plugin)
MOE_CASES = {
    "tp2_ragged": (dict(dp_size=2, tp_size=2), dict(moe_dispatch="ragged"),
                   dict(dp_size=-1, tp_size=2)),
    "tp2_capacity": (dict(dp_size=2, tp_size=2), dict(moe_dispatch="capacity"),
                     dict(dp_size=-1, tp_size=2)),
    "tp2_dense": (dict(dp_size=2, tp_size=2), dict(moe_dispatch="dense"),
                  dict(dp_size=-1, tp_size=2)),
    "ep2_tp2": (dict(dp_size=1, ep_size=2, tp_size=2, sharding_strategy="no_shard"),
                dict(moe_dispatch="auto", moe_capacity_factor=2.0),
                dict(dp_size=-1, ep_size=2, tp_size=2, sharding_strategy="no_shard")),
    "ep2_sp2_capacity": (dict(dp_size=1, ep_size=2, sp_size=2, sharding_strategy="no_shard"),
                         dict(moe_dispatch="capacity", moe_capacity_factor=1.0,
                              attention_impl="ring"),
                         dict(dp_size=-1, ep_size=2, sp_size=2,
                              sharding_strategy="no_shard")),
}


def _moe_case(name, plugin):
    config = {**MOE, **MOE_CASES[name][1]}
    return dict(name=name, plugin=plugin, config=config, init="init_moe.pt")


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


def _reference(config: dict):
    model = JaxCausalLM(JaxConfig.tiny(**config))
    return model, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_moe")
    _reset()
    rng = np.random.default_rng(9)
    np.savez(os.path.join(out, "inputs.npz"), moe_ids=rng.integers(0, 1024, (4, 32)))
    _, params = _reference(MOE)
    torch.save(dict(port.params_from_jax(jax.tree.map(np.asarray, nn.unbox(params)),
                                         port.TransformerConfig.tiny(**MOE))),
               os.path.join(out, "init_moe.pt"))
    moe = [_moe_case(n, mesh) for n, (mesh, _, _) in MOE_CASES.items()]
    debug_launcher(tp_workers.adapters_experts_worker, (str(out), [], moe), num_processes=4)
    for name in MOE_CASES:
        tp_workers.moe_case(str(out), {**_moe_case(name, None), "name": f"{name}_w1"})
    _reset()
    names = list(MOE_CASES) + [f"{n}_w1" for n in MOE_CASES]
    return out, {n: torch.load(os.path.join(out, f"{n}.pt")) for n in names}


def _logits(rec):
    """The global batch's logits from every rank's record: rows in data-rank
    order, a sequence split over sp joined in sp order, tp peers once."""
    seen = {}
    for r in rec["ranks"]:
        seen[(r["data_rank"], r["sp_rank"])] = r["logits"]
    rows = sorted({d for d, _ in seen})
    return torch.cat([torch.cat([seen[(d, s)] for s in sorted(s for dd, s in seen if dd == d)],
                                dim=1) for d in rows]).numpy()


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_under_tp_and_capacity_under_sp_match_world_one(records, name):
    _, recs = records
    rec, one = recs[name], recs[f"{name}_w1"]
    _close(_logits(rec), _logits(one), "logits vs world 1")
    _close(rec["loss"], one["loss"], "sgd step loss")
    for k, v in one["params"].items():
        _close(rec["params"][k], v, f"{k} after the step")


_REFERENCE_RUNS: dict = {}


def _reference_run(out, name):
    """The reference under ``name``'s plugin on its eight devices: the
    logits of the global batch, and one ``unified_step`` of sgd 0.5 on it
    (its loss and the params after it, by the port's names). Made once a
    case."""
    if name not in _REFERENCE_RUNS:
        _, over, plugin = MOE_CASES[name]
        config = {**MOE, **over}
        model, params = _reference(config)
        ids = jnp.asarray(np.load(os.path.join(out, "inputs.npz"))["moe_ids"], jnp.int32)
        _reset()
        acc = jax_pkg.Accelerator(parallelism_plugin=jax_pkg.ParallelismPlugin(**plugin))
        sharded, opt = acc.prepare(params, optax.sgd(0.5))
        logits = np.asarray(jax.jit(lambda p, i: model.apply({"params": p}, i))(sharded, ids))
        step = acc.unified_step(JaxCausalLM.loss_fn(model), opt)
        carry, metrics = step(acc.init_carry(sharded, opt), {"input_ids": ids})
        after = port.params_from_jax(jax.tree.map(np.asarray, nn.unbox(carry["params"])),
                                     port.TransformerConfig.tiny(**config))
        _REFERENCE_RUNS[name] = (logits, float(metrics["loss"]), after)
        _reset()
    return _REFERENCE_RUNS[name]


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_logits_match_the_reference_under_the_same_plugin(records, name):
    out, recs = records
    want, _, _ = _reference_run(out, name)
    assert np.isfinite(want).all()
    _close(_logits(recs[name]), want, "logits vs the reference")


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_step_matches_the_reference_under_the_same_plugin(records, name):
    """The sgd step of ``test_moe_under_tp_and_capacity_under_sp_match_world_one``
    against the reference's ``unified_step`` under the same plugin: its loss,
    and every param after it (the router's and each expert stack's gradient
    times 0.5)."""
    out, recs = records
    _, loss, after = _reference_run(out, name)
    rec = recs[name]
    _close(rec["loss"], loss, "sgd step loss vs the reference")
    for k, v in after.items():
        _close(rec["params"][k], v, f"{k} after the step vs the reference")
