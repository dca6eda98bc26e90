"""ZeRO-1/2/3 on the port at world 4 over gloo, against the reference.

Mirrors ``tests/test_zero.py`` on its toy (a tanh MLP of two weights, Adam
at 1e-2, global batches of 8 rows from one seed) in one world-4 launch:
ZeRO-1 (SHARD_OPT) shards the moments over fsdp and keeps the params whole;
ZeRO-2 (SHARD_GRAD_OP, K 2) shards the accumulation buffer too; both train
as data parallelism does (2e-5, the reference's bound); a step built
before ``init_carry`` still shards the moments. FULL_SHARD and HYBRID_SHARD
(one slice) are added against NO_SHARD, and every run's final params are
within 2e-5 of the reference's run of the same plugin and data (the
reference at fsdp 8 on its 8 virtual devices: the same global batch is the
same math). ``test_zero1_keeps_embedding_replicated`` is in
``test_torch_sharding.py``.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu.utils.dataclasses import ParallelismPlugin as JaxPlugin  # noqa: E402
from accelerate_tpu.utils.dataclasses import ShardingStrategy as JaxStrategy  # noqa: E402

from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import sharding_workers  # noqa: E402

TOL = 2e-5
CALLS = 6  # the reference's _train: six step calls
STRATEGIES = ("no_shard", "shard_opt", "shard_grad_op", "full_shard", "hybrid_shard")


def _params(key=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    return {"w1": jax.random.normal(k1, (16, 32)), "w2": jax.random.normal(k2, (32, 8))}


def _loss(p, b):
    h = jnp.tanh(b["x"] @ p["w1"])
    return jnp.mean((h @ p["w2"] - b["y"]) ** 2)


def _reference(strategy, num_accum, seed=0):
    """The reference's ``_train``: fsdp 8 over its 8 devices, 6 calls."""
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    plugin = JaxPlugin(fsdp_size=8, sharding_strategy=JaxStrategy(strategy), min_weight_size=8)
    acc = JaxAccelerator(parallelism_plugin=plugin, gradient_accumulation_steps=num_accum)
    params = acc.prepare(_params())
    opt = acc.prepare(optax.adam(1e-2))
    carry = acc.init_carry(params, opt)
    step = acc.unified_step(_loss)
    rng = np.random.default_rng(seed)
    from accelerate_tpu.parallel.sharding import batch_sharding

    for _ in range(CALLS):
        batch = {"x": jnp.asarray(rng.normal(size=(8, 16)), jnp.float32),
                 "y": jnp.asarray(rng.normal(size=(8, 8)), jnp.float32)}
        carry, _ = step(carry, jax.device_put(batch, batch_sharding(acc.mesh)))
    out = {k: np.asarray(v) for k, v in carry["params"].items()}
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return out


def _run(name, strategy, accum, **kw):
    return dict(name=name, model="mlp", optimizer="adamw", lr=1e-2, weight_decay=0.0,
                calls=CALLS, accum=accum, rows=8,
                plugin=dict(fsdp_size=4, sharding_strategy=strategy, min_weight_size=8), **kw)


@pytest.fixture(scope="module")
def world_four(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero4")
    np.savez(os.path.join(out, "mlp_init.npz"),
             **{k: np.asarray(v) for k, v in _params().items()})
    runs = [_run(f"{s}_k2", s, 2) for s in STRATEGIES]
    runs += [_run("shard_opt_k1", "shard_opt", 1),
             _run("shard_opt_built_first", "shard_opt", 1, step_before_carry=True)]
    debug_launcher(sharding_workers.train_runs_worker, (str(out), runs), num_processes=4)
    return {r["name"]: torch.load(os.path.join(out, f"{r['name']}.pt")) for r in runs}


def _all_whole(specs):
    return all(all(e is None for e in spec) for spec in specs.values())


def test_zero1_shards_opt_state_replicates_params(world_four):
    rec = world_four["shard_opt_k1"]
    assert _all_whole(rec["specs"]), rec["specs"]
    assert rec["moments"] and all("fsdp" in str(s) for s in rec["moments"].values())


def test_zero2_additionally_shards_grad_buffer(world_four):
    rec = world_four["shard_grad_op_k2"]
    assert _all_whole(rec["specs"]), rec["specs"]
    assert rec["buffer"] and all("fsdp" in str(s) for s in rec["buffer"].values())
    assert all("fsdp" in str(s) for s in rec["moments"].values())


@pytest.mark.parametrize("strategy", ["shard_opt", "shard_grad_op"])
def test_zero_trains_equivalently_to_dp(world_four, strategy):
    dp, zero = world_four["no_shard_k2"], world_four[f"{strategy}_k2"]
    for k, v in dp["params"].items():
        np.testing.assert_allclose(zero["params"][k].numpy(), v.numpy(), atol=TOL, err_msg=k)


def test_zero1_step_built_before_init_carry(world_four):
    rec = world_four["shard_opt_built_first"]
    assert all("fsdp" in str(s) for s in rec["moments"].values())
    for k, v in world_four["shard_opt_k1"]["params"].items():
        assert torch.equal(rec["params"][k], v), k


@pytest.mark.parametrize("strategy", ["full_shard", "hybrid_shard"])
def test_full_and_hybrid_shard_train_as_no_shard(world_four, strategy):
    rec = world_four[f"{strategy}_k2"]
    # the params themselves split over fsdp (both leaves exceed min_weight_size)
    assert all("fsdp" in str(s) for s in rec["specs"].values()), rec["specs"]
    assert rec["moments"] == rec["specs"] and rec["buffer"] == rec["specs"]
    for k, v in world_four["no_shard_k2"]["params"].items():
        np.testing.assert_allclose(rec["params"][k].numpy(), v.numpy(), atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", [f"{s}_k2" for s in STRATEGIES] + ["shard_opt_k1"])
def test_each_run_matches_the_reference_run(world_four, name):
    strategy, accum = name.rsplit("_k", 1)
    want = _reference(strategy, int(accum))
    for k, v in want.items():
        np.testing.assert_allclose(world_four[name]["params"][k].numpy(), v, atol=TOL,
                                   err_msg=f"{name} {k}")
