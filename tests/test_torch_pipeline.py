"""Pipelines on the port at world 4 over gloo, against the reference.

Mirrors all 13 tests of ``tests/test_pipeline.py``. One world-4 launch
(``pipeline_workers.pipeline_worker``) runs every configuration in one
process group and writes each rank's record; each test compares the
records with the reference's own run of the same stacked weights and data
(drawn here with the reference's keys), at the reference test's tolerance.
The reference runs 8 virtual devices; the port's meshes are the same
configurations at world 4 (dp 2 x pp 2 where the reference has dp 4 x pp
2): the same global batch gives the same numbers.

* GPipe (``pipeline_apply``): the forward at M 2 and 4, the gradients,
  four ``unified_step`` calls through it;
* the validator, and ``pp_size=-1`` resolved and validated;
* 1F1B (``pipeline_train_step``) at (pp, tp) = (2, 1), (4, 1), (2, 2),
  composed with ring attention (pp 2 x sp 2) and with the ragged MoE
  (pp 2 x ep 2), and at pp 1;
* memory: the bytes autograd keeps (``saved_tensors_hooks``) plus 1F1B's
  input ring stay at least 4x below GPipe + autograd at M 32, S 2; with
  the boundary feed a middle stage at pp 4 holds no data, with the numbers
  of a replicated feed;
* ``Accelerator.unified_pipeline_step``: it trains as the microbatched
  ``unified_step``; fp16 loss scaling and the overflow hold; plain AdamW
  and ``fused_adamw`` with a clip, each step's loss and grad norm and the
  final params within 2e-5 of the reference's; an inf planted in one
  stage's gradients holds the step on every rank and halves the scale.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu import MixedPrecisionPolicy  # noqa: E402
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from accelerate_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply  # noqa: E402
from accelerate_tpu.parallel.pipeline import pipeline_train_step as jax_1f1b  # noqa: E402
from accelerate_tpu.parallel.pipeline import stacked_layer_shardings as jax_stacked  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JaxState  # noqa: E402
from accelerate_tpu.state import GradientState as JaxGradientState  # noqa: E402
from accelerate_tpu.state import PartialState as JaxPartialState  # noqa: E402
from accelerate_tpu.utils.dataclasses import ParallelismPlugin as JaxPlugin  # noqa: E402
from accelerate_tpu.utils.dataclasses import ShardingStrategy as JaxStrategy  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.parallel import pipeline  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import pipeline_workers  # noqa: E402

L, H, F = 4, 16, 32
NH, HD, S_SEQ = 2, 8, 8
E, K = 4, 2
TOL = 2e-5


def _stacked_params(key=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    return {"w": jax.random.normal(k1, (L, H, F)) / np.sqrt(H),
            "v": jax.random.normal(k2, (L, F, H)) / np.sqrt(F)}


def _moe_params(key=0):
    ks = jax.random.split(jax.random.PRNGKey(key), 4)
    return {"router": jax.random.normal(ks[0], (L, H, E)) / np.sqrt(H),
            "wg": jax.random.normal(ks[1], (L, E, H, F)) / np.sqrt(H),
            "wu": jax.random.normal(ks[2], (L, E, H, F)) / np.sqrt(H),
            "wd": jax.random.normal(ks[3], (L, E, F, H)) / np.sqrt(F)}


def _block_fn(local_params, x):
    def body(h, layer):
        return h + jnp.tanh(h @ layer["w"]) @ layer["v"], None

    h, _ = jax.lax.scan(body, x, local_params)
    return h


def _mse(y, tgt):
    return jnp.mean((y - tgt) ** 2)


def _inputs():
    out = {k: np.asarray(v) for k, v in _stacked_params().items()}
    out["x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (16, H)))
    out["tgt"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (16, H)))
    out["sp_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (16, S_SEQ, H)))
    out["sp_tgt"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (16, S_SEQ, H)))
    out.update({f"moe_{k}": np.asarray(v) for k, v in _moe_params().items()})
    out["mem_w"] = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 256, 256)) / 16)
    out["mem_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64 * 32, 256)))
    out["mem_t"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (64 * 32, 256)))
    out["feed_w"] = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 64, 64)) / 8)
    out["feed_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8 * 32, 64)))
    out["feed_t"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (8 * 32, 64)))
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    np.savez(os.path.join(out, "inputs.npz"), **_inputs())
    debug_launcher(pipeline_workers.pipeline_worker, (str(out),), num_processes=4)

    def load(name, rank=None):
        if rank is not None:
            return torch.load(os.path.join(out, f"{name}_{rank}.pt"))
        return [torch.load(os.path.join(out, f"{name}_{r}.pt")) for r in range(4)]

    return load


def _reset_reference():
    JaxState._reset_state()
    JaxGradientState._reset_state()
    JaxPartialState._reset_state()


def _mesh(**kw):
    return jax_build_mesh(JaxPlugin(sharding_strategy=JaxStrategy.NO_SHARD, **kw))


def _whole_grads(recs):
    """Every stage's local gradients put back into the whole stack (the
    first rank of each stage)."""
    by_stage = {}
    for r in recs:
        by_stage.setdefault(r["stage"], r["grads"])
    names = by_stage[0].keys()
    return {k: torch.cat([by_stage[s][k] for s in sorted(by_stage)]).numpy() for k in names}


def _close(got, want, atol, rtol=0.0):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=atol,
                                   rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------- #
# GPipe
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("num_micro", [2, 4])
def test_pipeline_forward_matches_sequential(records, num_micro):
    mesh = _mesh(dp_size=4, pp_size=2, num_micro_batches=num_micro)
    params = _stacked_params()
    x = jax.random.normal(jax.random.PRNGKey(1), (16, H))
    ps = jax.device_put(params, jax_stacked(params, mesh))
    ref = jax.jit(lambda p, xx: jax_pipeline_apply(_block_fn, p, xx, mesh=mesh,
                                                   num_micro_batches=num_micro))(ps, x)
    seq = _block_fn(params, x)
    for rec in records(f"gpipe_fwd_M{num_micro}"):  # every stage returns the output
        np.testing.assert_allclose(rec["y"].numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(rec["y"].numpy(), np.asarray(seq), atol=1e-5)


def test_pipeline_grads_match_sequential(records):
    mesh = _mesh(dp_size=4, pp_size=2, num_micro_batches=4)
    params = _stacked_params()
    x = jax.random.normal(jax.random.PRNGKey(1), (16, H))
    ps = jax.device_put(params, jax_stacked(params, mesh))

    def pp_loss(p):
        return jnp.mean(jax_pipeline_apply(_block_fn, p, x, mesh=mesh, num_micro_batches=4) ** 2)

    g_pp = jax.jit(jax.grad(pp_loss))(ps)
    g_seq = jax.grad(lambda p: jnp.mean(_block_fn(p, x) ** 2))(params)
    got = _whole_grads(records("gpipe_grads"))
    _close(got, g_pp, 1e-5)
    _close(got, g_seq, 1e-5)


def test_pipeline_training_via_unified_step(records):
    """Four unified_step calls through the GPipe pipeline (pp 2 x dp 2)
    give the reference's pipelined params and the port's own dp-4 run's."""
    _reset_reference()
    plugin = JaxPlugin(dp_size=4, pp_size=2, sharding_strategy=JaxStrategy.NO_SHARD,
                       num_micro_batches=4)
    acc = JaxAccelerator(parallelism_plugin=plugin)
    params = _stacked_params()
    params = jax.device_put(params, jax_stacked(params, acc.mesh))
    acc._models.append(params)
    acc._param_shardings = jax_stacked(params, acc.mesh)
    opt = acc.prepare(optax.sgd(1e-2))

    def loss_fn(p, batch):
        y = jax_pipeline_apply(_block_fn, p, batch["x"], mesh=acc.mesh, num_micro_batches=4)
        return jnp.mean((y - batch["y"]) ** 2)

    carry = acc.init_carry(params, opt)
    step = acc.unified_step(loss_fn)
    rng = np.random.default_rng(0)
    for _ in range(4):
        batch = {"x": jnp.asarray(rng.normal(size=(16, H)), jnp.float32),
                 "y": jnp.asarray(rng.normal(size=(16, H)), jnp.float32)}
        carry, _ = step(carry, batch)
    _reset_reference()
    got = records("unified_pp", 0)["params"]
    _close(got, carry["params"], 1e-5)
    _close(got, records("unified_seq", 0)["params"], 1e-5)


# ---------------------------------------------------------------------- #
# validation
# ---------------------------------------------------------------------- #
def test_pipeline_plugin_validation():
    """pp composes with tp, sp and ep (the reference's validator on a jax
    with partial-manual shard_map, which the port's stages always are);
    fewer microbatches than stages raises."""
    assert pipeline.partial_manual_supported()
    for kw in (dict(tp_size=2), dict(sp_size=2), dict(ep_size=2)):
        pipeline.validate_pipeline_plugin(port.ParallelismPlugin(pp_size=2,
                                                                 num_micro_batches=4, **kw))
    with pytest.raises(ValueError, match="num_micro_batches"):
        pipeline.validate_pipeline_plugin(port.ParallelismPlugin(pp_size=4, num_micro_batches=2))
    with pytest.raises(ValueError, match="num_micro_batches"):
        pipeline.validate_pipeline_plugin(
            port.ParallelismPlugin(dp_size=1, pp_size=-1, num_micro_batches=2),
            resolved_shape={"pp": 4, "tp": 1, "sp": 1, "ep": 1})


def test_auto_pp_size_still_validated(records):
    """pp_size=-1 resolving to 4 at world 4 (dp 1) hits the microbatch
    bound (2 < 4), on every rank, before the mesh comes up."""
    for rec in records("auto_pp"):
        assert rec["error"] is not None and "num_micro_batches" in rec["error"]


# ---------------------------------------------------------------------- #
# 1F1B
# ---------------------------------------------------------------------- #
def _ref_1f1b(block, params, x, tgt, mesh):
    ps = jax.device_put(params, jax_stacked(params, mesh))
    return jax.jit(lambda p, xx, tt: jax_1f1b(block, _mse, p, xx, tt, mesh=mesh,
                                              num_micro_batches=4))(ps, x, tgt)


@pytest.mark.parametrize("pp,tp", [(2, 1), (4, 1), (2, 2)])
def test_1f1b_matches_sequential(records, pp, tp):
    mesh = _mesh(dp_size=8 // (pp * tp), pp_size=pp, tp_size=tp, num_micro_batches=4)
    params = _stacked_params()
    x = jax.random.normal(jax.random.PRNGKey(1), (16, H))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (16, H))
    l_pp, g_pp = _ref_1f1b(_block_fn, params, x, tgt, mesh)

    def seq(p):
        xm, tm = x.reshape(4, 4, H), tgt.reshape(4, 4, H)
        return jnp.mean(jax.vmap(lambda a, b: _mse(_block_fn(p, a), b))(xm, tm))

    l_ref, g_ref = jax.value_and_grad(seq)(params)
    recs = records(f"f1b_pp{pp}_tp{tp}")
    for rec in recs:  # every rank reports the loss
        np.testing.assert_allclose(rec["loss"], float(l_ref), rtol=1e-5)
        np.testing.assert_allclose(rec["loss"], float(l_pp), rtol=1e-5)
        assert set(rec["types"].values()) == {"DTensor"}
    got = _whole_grads(recs)
    _close(got, g_ref, 1e-5)
    _close(got, g_pp, 1e-5)


def test_1f1b_composes_with_sp_ring_attention(records):
    """pp 2 x sp 2: a stage body with ring attention under 1F1B matches the
    sequential dense oracle (and the reference's pp x sp run) at the
    reference's tolerance."""
    from accelerate_tpu.ops.ring_attention import ring_attention

    def attn_block(mesh):
        def fn(local_params, x):
            def body(h, layer):
                b, s, hh = h.shape
                qkv = h.reshape(b, s, NH, HD)
                h = h + ring_attention(qkv, qkv, qkv, causal=True, mesh=mesh).reshape(b, s, hh)
                return h + jnp.tanh(h @ layer["w"]) @ layer["v"], None

            h, _ = jax.lax.scan(body, x, local_params)
            return h

        return fn

    params = _stacked_params()
    x = jax.random.normal(jax.random.PRNGKey(1), (16, S_SEQ, H))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (16, S_SEQ, H))
    ref_mesh = _mesh(dp_size=8, num_micro_batches=4)

    def seq(p):
        xm, tm = x.reshape(4, 4, S_SEQ, H), tgt.reshape(4, 4, S_SEQ, H)
        return jnp.mean(jax.vmap(lambda a, b: _mse(attn_block(ref_mesh)(p, a), b))(xm, tm))

    l_ref, g_ref = jax.value_and_grad(seq)(params)
    mesh = _mesh(dp_size=2, pp_size=2, sp_size=2, num_micro_batches=4)
    l_pp, g_pp = _ref_1f1b(attn_block(mesh), params, x, tgt, mesh)
    recs = records("f1b_sp")
    for rec in recs:
        np.testing.assert_allclose(rec["loss"], float(l_ref), rtol=1e-5)
        np.testing.assert_allclose(rec["loss"], float(l_pp), rtol=1e-5)
    got = _whole_grads(recs)
    _close(got, g_ref, 1e-3, 1e-3)
    _close(got, g_pp, 1e-3, 1e-3)


def test_1f1b_composes_with_ep_ragged_moe(records):
    """pp 2 x ep 2: the shard-capacity ragged MoE in a stage body under 1F1B
    (capacity_factor == ep: exact) matches the dense-dispatch oracle and
    the reference's pp x ep run."""
    from accelerate_tpu.ops.moe import moe_ragged_ep

    def _route(layer, h):
        w, sel = jax.lax.top_k(jax.nn.softmax(h @ layer["router"], -1), K)
        return sel, w / jnp.sum(w, -1, keepdims=True)

    def moe_block(mesh):
        def fn(local_params, x):
            def body(h, layer):
                sel, w = _route(layer, h)
                return h + moe_ragged_ep(h, sel, w, layer["wg"], layer["wu"], layer["wd"],
                                         mesh=mesh, capacity_factor=2.0), None

            h, _ = jax.lax.scan(body, x, local_params)
            return h

        return fn

    def dense_block(local_params, x):
        def body(h, layer):
            sel, w = _route(layer, h)
            hid = jax.nn.silu(jnp.einsum("th,ehf->tef", h, layer["wg"])) * jnp.einsum(
                "th,ehf->tef", h, layer["wu"])
            out = jnp.einsum("tef,efh->teh", hid, layer["wd"])
            combine = jnp.zeros((h.shape[0], E)).at[jnp.arange(h.shape[0])[:, None], sel].set(w)
            return h + jnp.sum(out * combine[..., None], axis=1), None

        h, _ = jax.lax.scan(body, x, local_params)
        return h

    params = _moe_params()
    x = jax.random.normal(jax.random.PRNGKey(1), (16, H))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (16, H))

    def seq(p):
        xm, tm = x.reshape(4, 4, H), tgt.reshape(4, 4, H)
        return jnp.mean(jax.vmap(lambda a, b: _mse(dense_block(p, a), b))(xm, tm))

    l_ref, g_ref = jax.value_and_grad(seq)(params)
    mesh = _mesh(dp_size=2, pp_size=2, ep_size=2, num_micro_batches=4)
    l_pp, g_pp = _ref_1f1b(moe_block(mesh), params, x, tgt, mesh)
    recs = records("f1b_ep")
    for rec in recs:
        np.testing.assert_allclose(rec["loss"], float(l_ref), rtol=1e-5)
        np.testing.assert_allclose(rec["loss"], float(l_pp), rtol=1e-5)
    got = _whole_grads(recs)
    _close(got, g_ref, 1e-4, 1e-4)
    _close(got, g_pp, 1e-4, 1e-4)


def test_1f1b_single_stage_fallback(records):
    """pp 1 takes the plain path: the microbatched loss and its gradients,
    averaged over the dp ranks, the reference's numbers."""
    mesh = _mesh(dp_size=8, num_micro_batches=2)
    params = _stacked_params()
    x = jax.random.normal(jax.random.PRNGKey(1), (8, H))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (8, H))
    loss, grads = jax_1f1b(_block_fn, _mse, params, x, tgt, mesh=mesh, num_micro_batches=2)
    for rec in records("f1b_single"):
        assert np.isfinite(rec["loss"])
        assert set(rec["grads"]) == set(params)
        np.testing.assert_allclose(rec["loss"], float(loss), rtol=1e-5)
        _close(rec["grads"], grads, 1e-5)


# ---------------------------------------------------------------------- #
# memory and the feed
# ---------------------------------------------------------------------- #
def test_1f1b_peak_memory_beats_gpipe_autodiff(records):
    """At M 32, S 2 each stage's 1F1B state (the autograd bytes of one
    recompute at a time, plus the input ring of at most 2S - 1 inputs)
    stays at least 4x below GPipe + autograd's saved residuals."""
    for rec in records("memory"):
        f1b = rec["f1b_saved"] + rec["f1b_ring"]
        assert rec["peak_inputs"] <= 3
        assert f1b * 4 < rec["gpipe"], rec


def test_1f1b_feed_sharding_cuts_input_memory(records):
    """pp 4, M 32: with the boundary feed the middle stages hold no input
    or target bytes (a replicated feed holds all of them there), and the
    numbers are the replicated feed's."""
    data_bytes = (8 * 32 * 64) * 4 * 2
    boundary, replicated = records("feed_boundary"), records("feed_replicated")
    for b, r in zip(boundary, replicated):
        if b["stage"] in (1, 2):
            assert b["held"] == 0 and r["held"] == data_bytes
        np.testing.assert_allclose(b["loss"], r["loss"], rtol=1e-6)
        _close(b["grads"], r["grads"], 1e-5)
    assert boundary[0]["held"] == data_bytes // 2  # stage 0: the inputs only


# ---------------------------------------------------------------------- #
# unified_pipeline_step
# ---------------------------------------------------------------------- #
def _ref_upp(optimizer, steps=3, mixed_precision=None, loss_scale=None, max_grad_norm=10.0):
    """The reference's unified_pipeline_step over the reference tests'
    batches: per-step losses and grad norms, the final params, the loss
    scale and the finite flags."""
    _reset_reference()
    kw = {}
    if mixed_precision == "fp16":
        policy = MixedPrecisionPolicy.from_precision("fp16")
        policy.loss_scale_init = loss_scale
        kw = dict(mixed_precision="fp16", mixed_precision_policy=policy)
    plugin = JaxPlugin(dp_size=4, pp_size=2, sharding_strategy=JaxStrategy.NO_SHARD,
                       num_micro_batches=4)
    acc = JaxAccelerator(parallelism_plugin=plugin, **kw)
    params = _stacked_params()
    params = jax.device_put(params, jax_stacked(params, acc.mesh))
    acc._models.append(params)
    opt = acc.prepare(optimizer)
    carry = acc.init_carry(params, opt)
    step = acc.unified_pipeline_step(_block_fn, _mse, max_grad_norm=max_grad_norm)
    rng = np.random.default_rng(0)
    losses, norms, finite = [], [], []
    for _ in range(steps):
        x = jnp.asarray(rng.normal(size=(16, H)), jnp.float32)
        y = jnp.asarray(rng.normal(size=(16, H)), jnp.float32)
        carry, m = step(carry, x, y)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        finite.append(bool(m["grads_finite"]))
    scale = float(carry["loss_scale"].scale) if "loss_scale" in carry else None
    _reset_reference()
    return {"losses": losses, "norms": norms, "finite": finite, "scale": scale,
            "params": jax.tree.map(np.asarray, carry["params"])}


def test_unified_pipeline_step_fp16_gradscaler(records):
    """fp16 loss scaling under 1F1B: a sane scale trains to the fp32
    trajectory within fp16 tolerance, reporting the unscaled loss, with
    fp32 masters; a forced overflow holds the params on every rank, halves
    the scale and reports grads_finite False — as the reference does."""
    for r16, r32 in zip(records("upp_fp16"), records("upp_fp32")):
        assert r16["finite"][-1]
        assert r16["losses"][-1] < 20.0
        _close(r16["params"], r32["params"], 5e-3)
        assert r16["dtype"] == "torch.float32"
    ref16 = _ref_upp(optax.sgd(1e-2), mixed_precision="fp16", loss_scale=2.0 ** 8)
    _close(records("upp_fp16", 0)["params"], ref16["params"], 5e-3)
    ref32 = _ref_upp(optax.sgd(1e-2))
    r32 = records("upp_fp32", 0)
    np.testing.assert_allclose(r32["losses"], ref32["losses"], rtol=TOL)
    _close(r32["params"], ref32["params"], TOL)
    before = {k: v for k, v in _inputs().items() if k in ("w", "v")}
    ref_of = _ref_upp(optax.sgd(1e-2), steps=1, mixed_precision="fp16", loss_scale=2.0 ** 20)
    assert not ref_of["finite"][0] and ref_of["scale"] == 2.0 ** 19
    for rec in records("upp_fp16_overflow"):
        assert not rec["finite"][0] and rec["held"][0]
        _close(rec["params"], before, 0.0)
        assert rec["scales"][0] == 2.0 ** 19


def test_unified_pipeline_step_trains(records):
    """unified_pipeline_step (1F1B, clip, update through the Accelerator)
    reaches the microbatched unified_step's loss and params, and the
    reference's."""
    pp, seq = records("upp_trains", 0), records("upp_seq", 0)
    assert pp["acc_step"] == 4 and pp["opt_step"] == 4
    np.testing.assert_allclose(pp["losses"][-1], seq["losses"][-1], rtol=1e-5)
    _close(pp["params"], seq["params"], 1e-5)
    ref = _ref_upp(optax.sgd(1e-2), steps=4)
    np.testing.assert_allclose(pp["losses"], ref["losses"], rtol=1e-5)
    _close(pp["params"], ref["params"], 1e-5)


@pytest.mark.parametrize("name", ["upp_adamw", "upp_fused_adamw"])
def test_unified_pipeline_step_adamw_clip_matches_the_reference(records, name):
    """Three steps at pp 2 x dp 2 with a clip that bites (0.5), plain AdamW
    and the fused epilogue: each step's loss and grad norm (every stage's
    layers counted once in the norm) and the final params within 2e-5 of
    the reference's plain adamw run, on every rank."""
    ref = _ref_upp(optax.adamw(1e-2), max_grad_norm=0.5)
    assert min(ref["norms"]) > 0.5  # the clip is active
    for rec in records(name):
        np.testing.assert_allclose(rec["losses"], ref["losses"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(rec["norms"], ref["norms"], rtol=TOL, atol=TOL)
        _close(rec["params"], ref["params"], TOL)


def test_unified_pipeline_step_holds_an_inf_planted_in_one_stage(records):
    """fp16 with an inf put into one rank's stage-1 gradients at the second
    step: every rank holds that step (params unchanged), reports it
    non-finite and halves the scale; the steps around it apply."""
    for rec in records("upp_fp16_planted"):
        assert rec["finite"] == [True, False, True]
        assert rec["held"] == [False, True, False]
        assert rec["scales"][1] == rec["scales"][0] / 2
