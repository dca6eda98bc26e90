"""The port's expert-parallel MoE against the reference's, at dp 2 x ep 2.

Mirrors ``tests/test_moe.py:197-352`` in one world-4 gloo launch
(``pipeline_workers.moe_worker``): the shard-capacity schedule
(``moe_ragged_ep``) on the tiny MoE ``CausalLM`` against the reference's
dense oracle, forward and gradients, and the port's dense run under the
same mesh; ``moe_dispatch="auto"`` resolving to it under ep at a tight
capacity factor, equal to the reference's ep run of ``"ragged"`` (whose
windows span the global batch, as the port's gather over the token ranks
does), while ``"capacity"`` equals the reference's capacity run; and a
window that drops what overflows shard 0, exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402


@pytest.fixture(autouse=True)
def reset_singletons():
    def reset():
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
        jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
        jax_pkg.state.GradientState._reset_state()

    reset()
    yield
    reset()


def _close(got, want, tol, name=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=tol, err_msg=name)


EP_CFG = dict(num_experts=4, num_experts_per_tok=2)


@pytest.fixture(scope="module")
def ep_records(tmp_path_factory):
    import os

    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.test_utils.scripts import pipeline_workers

    out = tmp_path_factory.mktemp("moe_ep")
    params = JaxCausalLM(JaxConfig.tiny(**EP_CFG)).init_params(jax.random.PRNGKey(0), 2, 32)
    params = jax.tree.map(np.asarray, nn.unbox(params))
    torch.save(dict(port.params_from_jax(params, port.TransformerConfig.tiny(**EP_CFG))),
               os.path.join(out, "init_moe.pt"))
    T, h, f, E = 64, 16, 32, 4
    np.savez(os.path.join(out, "inputs.npz"),
             ids=np.random.default_rng(0).integers(0, 1024, (4, 32)).astype(np.int64),
             drop_x=np.asarray(jax.random.normal(jax.random.PRNGKey(1), (T, h))),
             drop_wg=np.asarray(jax.random.normal(jax.random.PRNGKey(2), (E, h, f)) / np.sqrt(h)),
             drop_wu=np.asarray(jax.random.normal(jax.random.PRNGKey(3), (E, h, f)) / np.sqrt(h)),
             drop_wd=np.asarray(jax.random.normal(jax.random.PRNGKey(4), (E, f, h)) / np.sqrt(f)))
    debug_launcher(pipeline_workers.moe_worker, (str(out),), num_processes=4)

    def load(name):
        recs = [torch.load(os.path.join(out, f"moe_{name}_{r}.pt")) for r in range(4)]
        return sorted(recs, key=lambda r: r["data_rank"])

    ids = np.load(os.path.join(out, "inputs.npz"))["ids"]
    return load, params, ids


def _ep_logits(recs):
    return np.concatenate([r["logits"].numpy() for r in recs])


def _reference_ep_logits(params, ids, **over):
    """The reference's tiny MoE model under its dp 4 x ep 2 mesh."""
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.Accelerator(parallelism_plugin=jax_pkg.ParallelismPlugin(
        dp_size=4, ep_size=2, sharding_strategy=jax_pkg.ShardingStrategy.NO_SHARD))
    model = JaxCausalLM(JaxConfig.tiny(**EP_CFG, **over))
    out = jax.jit(lambda p, i: model.apply({"params": p}, i))(params, jnp.asarray(ids, jnp.int32))
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    return np.asarray(out)


def test_ragged_ep_matches_dense_oracle(ep_records):
    """The shard-capacity schedule at dp 2 x ep 2 with capacity_factor 2
    (== ep: no drops) equals the reference's dense oracle, forward and
    gradients (each expert shard's gathered), and the port's own dense run
    under the same mesh."""
    load, params, ids = ep_records
    model = JaxCausalLM(JaxConfig.tiny(**EP_CFG, moe_dispatch="dense"))
    jids = jnp.asarray(ids, jnp.int32)
    want = np.asarray(model.apply({"params": params}, jids))
    ragged, dense = load("ragged"), load("dense")
    np.testing.assert_allclose(_ep_logits(ragged), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_ep_logits(dense), want, rtol=2e-5, atol=2e-5)

    def loss(p):
        return jnp.mean(model.apply({"params": p}, jids).astype(jnp.float32) ** 2)

    g = port.params_from_jax(jax.tree.map(np.asarray, jax.grad(loss)(params)),
                             port.TransformerConfig.tiny(**EP_CFG))
    for rec in ragged:
        for k, want_g in g.items():
            _close(rec["grads"][k], want_g.numpy(), 5e-5, k)
    assert any("ep" in str(s) for s in ragged[0]["specs"].values())


def test_auto_dispatch_resolves_to_ragged_under_ep(ep_records):
    """"auto" under ep > 1 is the shard-capacity schedule: at a tight
    capacity_factor (1.0, where it and the per-expert capacity schedule
    drop different choices) it equals "ragged" in the port, the
    reference's ep run of "ragged", and the port's "capacity" equals the
    reference's "capacity" instead."""
    load, params, ids = ep_records
    auto, ragged, cap = _ep_logits(load("auto_cf1")), _ep_logits(load("ragged_cf1")), \
        _ep_logits(load("capacity_cf1"))
    np.testing.assert_allclose(auto, ragged, rtol=1e-6, atol=1e-6)
    ref = _reference_ep_logits(params, ids, moe_dispatch="ragged", moe_capacity_factor=1.0)
    np.testing.assert_allclose(auto, ref, rtol=2e-5, atol=2e-5)
    ref_cap = _reference_ep_logits(params, ids, moe_dispatch="capacity", moe_capacity_factor=1.0)
    np.testing.assert_allclose(cap, ref_cap, rtol=2e-5, atol=2e-5)
    assert np.abs(auto - cap).max() > 1e-3  # the two schedules drop differently here


def test_ragged_ep_shard_capacity_drops_overflow(ep_records):
    """Every token picks experts 0 and 1 (both shard 0's): shard 0's window
    covers only each token's expert-0 row, so the output is exactly
    0.5 * expert0(x), not corruption."""
    load, _, _ = ep_records
    recs = load("drop")
    out = np.concatenate([r["out"].numpy() for r in recs])
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 16))
    wg = jax.random.normal(jax.random.PRNGKey(2), (4, 16, 32)) / np.sqrt(16)
    wu = jax.random.normal(jax.random.PRNGKey(3), (4, 16, 32)) / np.sqrt(16)
    wd = jax.random.normal(jax.random.PRNGKey(4), (4, 32, 16)) / np.sqrt(32)
    exp0 = (jax.nn.silu(x @ wg[0]) * (x @ wu[0])) @ wd[0]
    np.testing.assert_allclose(out, 0.5 * np.asarray(exp0), rtol=1e-5, atol=1e-5)
