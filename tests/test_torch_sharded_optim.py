"""ZeRO-1/2 at fsdp x tp and the raw loop on DTensor params, on the port at
world 4 over gloo, against the port's world 1 and the reference.

One world-4 launch of ``tp_workers.optim_worker`` runs:

* SHARD_OPT and SHARD_GRAD_OP at fsdp 2 x tp 2: three adamw steps (1e-2,
  eps 1e-3, clip 1.0, ``min_weight_size=1``) of the tiny LM, whose moments split each
  rank's tp-local slice over fsdp (AdamW is elementwise, so the update is
  world 1's); losses, grad norms and params within 2e-5 of world 1, and the
  carry saved with ``save_state`` restores at world 1
  (``load_state(allow_reshape=True)``) bit for bit;
* the raw loop at fsdp 2 x tp 2 (FULL_SHARD): ``accumulate`` over K 2,
  ``backward`` returning gradients with their params' placements, their
  sum, ``clip_grad_norm_`` over every shard and the optimizer's ``step``:
  sgd 0.5 against world 1 and the reference's raw loop under the same
  plugin (``accelerate_tpu/accelerator.py:1272-1295``), and adamw under
  SHARD_OPT against world 1.
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
from accelerate_tpu_torch.test_utils.scripts import sharding_workers, tp_workers  # noqa: E402
from accelerate_tpu_torch.test_utils.training import TINY_LM, TINY_SEQ, MaskedTokens  # noqa: E402

TOL = 2e-5
# adamw's eps: at optax's 1e-8 the reduction order's rounding of a near-zero
# gradient turns into a visible step (one element of 10240 read 5.1e-5 in
# test_torch_sharded_training.py); at 1e-3 the update is smooth in the
# gradient and the params are held at TOL like the rest
ADAM_EPS = 1e-3
ZERO = {"shard_opt": dict(dp_size=1, fsdp_size=2, tp_size=2, min_weight_size=1,
                          sharding_strategy="shard_opt"),
        "shard_grad_op": dict(dp_size=1, fsdp_size=2, tp_size=2, min_weight_size=1,
                              sharding_strategy="shard_grad_op")}


def _zero_run(name, plugin, accum=1):
    return dict(name=name, plugin=plugin, optimizer="adamw", lr=1e-2, eps=ADAM_EPS, steps=3,
                rows=8, max_grad_norm=1.0, accum=accum,
                save=None if plugin is None else f"ckpt_{name}")


RUNS = ([_zero_run(n, p) for n, p in ZERO.items()]
        + [_zero_run("shard_grad_op_accum2", ZERO["shard_grad_op"], accum=2)])
RAW = [dict(name="raw_full_shard", plugin=dict(dp_size=1, fsdp_size=2, tp_size=2,
                                               min_weight_size=1),
            init="init.pt"),
       dict(name="raw_shard_opt", plugin=ZERO["shard_opt"], init="init.pt", optimizer="adamw",
            eps=ADAM_EPS)]


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


def _reference_init():
    model = JaxCausalLM(JaxConfig(**TINY_LM))
    return model, model.init_params(jax.random.PRNGKey(0), seq_len=TINY_SEQ)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_optim")
    _reset()
    _, init = _reference_init()
    torch.save(dict(port.params_from_jax(jax.tree.map(np.asarray, nn.unbox(init)),
                                         port.TransformerConfig(**TINY_LM))),
               os.path.join(out, "init.pt"))
    debug_launcher(tp_workers.optim_worker, (str(out), RUNS, RAW), num_processes=4)
    for run in ([_zero_run("adamw_w1", None), _zero_run("adamw_accum2_w1", None, accum=2)]):
        sharding_workers._train_run(str(out), run)
        _reset()
    for case in RAW:
        tp_workers.raw_loop_case(str(out), {**case, "name": f"{case['name']}_w1",
                                            "plugin": None})
        _reset()
    names = ([r["name"] for r in RUNS] + ["adamw_w1", "adamw_accum2_w1"]
             + [c["name"] for c in RAW] + [f"{c['name']}_w1" for c in RAW])
    return out, {n: torch.load(os.path.join(out, f"{n}.pt")) for n in names}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def _reference_zero(strategy: str, accum: int):
    """The reference's ``unified_step`` under dp 2 x fsdp 2 x tp 2 with
    ``strategy`` on its eight devices: the port's ZeRO run (adamw 1e-2, eps
    ``ADAM_EPS``, weight decay 1e-4, clip 1.0, K ``accum``) on the same
    init and global batches."""
    model, init = _reference_init()
    _reset()
    acc = jax_pkg.Accelerator(gradient_accumulation_steps=accum,
                              parallelism_plugin=jax_pkg.ParallelismPlugin(
                                  **{**ZERO[strategy], "dp_size": -1}))
    params, opt, loader = acc.prepare(
        init, optax.adamw(1e-2, eps=ADAM_EPS, weight_decay=1e-4),
        jax_pkg.DataLoader(MaskedTokens(3 * accum * 8, 2), batch_size=8))
    step = acc.unified_step(JaxCausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(params, opt)
    losses, norms = [], []
    for batch in loader:
        carry, metrics = step(carry, batch)
        if bool(metrics["is_sync_step"]):
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    final = port.params_from_jax(jax.tree.map(np.asarray, nn.unbox(carry["params"])),
                                 port.TransformerConfig(**TINY_LM))
    _reset()
    return {"losses": losses, "norms": norms, "params": final}


@pytest.mark.parametrize("name,one", [("shard_opt", "adamw_w1"),
                                      ("shard_grad_op", "adamw_w1"),
                                      ("shard_grad_op_accum2", "adamw_accum2_w1")])
def test_zero12_at_fsdp_x_tp_matches_world_one(records, name, one):
    """Against world 1 and the reference's step under the same strategy."""
    _, recs = records
    rec = recs[name]
    run = next(r for r in RUNS if r["name"] == name)
    reference = _reference_zero(run["plugin"]["sharding_strategy"], run["accum"])
    for want, what in ((recs[one], "world 1"), (reference, "the reference")):
        assert len(want["losses"]) == len(rec["losses"]) == 3, what
        _close(rec["losses"], want["losses"], f"losses vs {what}")
        _close(rec["norms"], want["norms"], f"grad norms vs {what}")
        for k, v in want["params"].items():
            _close(rec["params"][k], v, f"{k} vs {what}")
    # the moments split each tp-local slice over fsdp: a tp-split leaf's
    # moment is split over both, and every moment over fsdp somewhere
    specs = rec["moments"]
    q = specs["layers.0.attn.q_proj.weight"]
    assert "tp" in str(q) and "fsdp" in str(q), q
    assert all("fsdp" in str(s) for k, s in specs.items() if "norm" not in k), specs


@pytest.mark.parametrize("name", ["shard_opt", "shard_grad_op"])
def test_zero12_checkpoint_restores_at_world_one_bitwise(records, name):
    out, recs = records
    rec = recs[name]
    _reset()
    acc = port.Accelerator(cpu=True)
    model = port.CausalLM(port.TransformerConfig(**TINY_LM), device="cpu")
    opt = acc.prepare(port.adamw(1e-2))
    template = {k: torch.zeros_like(v) for k, v in model.named_parameters()}
    carry = acc.init_carry(template, opt)
    back = acc.load_state(os.path.join(out, f"ckpt_{name}"), carry=carry, allow_reshape=True)
    for k, v in rec["params"].items():
        assert torch.equal(back["params"][k], v), k
    for key in ("mu", "nu"):
        for k, v in rec["whole_moments"][key].items():
            assert torch.equal(back["opt_state"][key][k], v), (key, k)
    assert int(back["opt_state"]["count"]) == 3
    _reset()


def _reference_raw_loop(case: dict):
    """The reference's raw loop under dp 2 x fsdp 2 x tp 2 and ``case``'s
    strategy on its eight devices: K 2, ``backward``, the sum,
    ``clip_grad_norm_`` (1.0) and the optimizer's ``step`` (sgd 0.5, or
    adamw 1e-2 with ``case``'s eps)."""
    model, init = _reference_init()
    _reset()
    acc = jax_pkg.Accelerator(gradient_accumulation_steps=2,
                              parallelism_plugin=jax_pkg.ParallelismPlugin(
                                  **{**case["plugin"], "dp_size": -1}))
    optimizer = (optax.sgd(0.5) if case.get("optimizer", "sgd") == "sgd"
                 else optax.adamw(1e-2, eps=case["eps"]))
    params, opt, loader = acc.prepare(init, optimizer,
                                      jax_pkg.DataLoader(MaskedTokens(32, 4), batch_size=8))
    loss_fn = JaxCausalLM.loss_fn(model)
    # each call jitted, as a JAX user's loop is: the same functions on the
    # same sharded arrays, compiled once instead of dispatched op by op
    backward = jax.jit(lambda p, b: acc.backward(loss_fn, p, b))
    add = jax.jit(lambda a, b: jax.tree.map(jnp.add, a, b))
    clip = jax.jit(lambda g: acc.clip_grad_norm_(g, 1.0))
    total, losses, norms = None, [], []
    for batch in loader:
        with acc.accumulate():
            loss, grads = backward(params, batch)
            losses.append(float(loss))
            total = grads if total is None else add(total, grads)
            if acc.sync_gradients:
                total, norm = clip(total)
                norms.append(float(norm))
                params = opt.step(params, total)
                total = None
    final = port.params_from_jax(jax.tree.map(np.asarray, nn.unbox(params)),
                                 port.TransformerConfig(**TINY_LM))
    _reset()
    return losses, norms, final


def test_raw_loop_on_dtensor_params_matches_world_one_and_the_reference(records):
    _, recs = records
    rec, one = recs["raw_full_shard"], recs["raw_full_shard_w1"]
    losses, norms, final = _reference_raw_loop(RAW[0])
    assert len(rec["losses"]) == 4 and len(rec["norms"]) == 2
    for got, what in ((one, "world 1"), ({"losses": losses, "norms": norms, "params": final},
                                        "the reference")):
        _close(rec["losses"], got["losses"], f"losses vs {what}")
        _close(rec["norms"], got["norms"], f"norms vs {what}")
        for k, v in got["params"].items():
            _close(rec["params"][k], v, f"{k} vs {what}")
    # the gradients came back split as their params are
    assert rec["placed"] == [True, True]


def test_raw_loop_gradients_mix_with_params_only_as_local_tensors(records):
    """The gradients live on the sub-mesh of the mesh's axes above 1, not on
    the params' mesh (``Accelerator.backward``'s docstring): a DTensor
    update ``p - lr * g`` raises torch's mesh error, and the same update on
    the local tensors runs (the worker makes it)."""
    _, recs = records
    for name in ("raw_full_shard", "raw_shard_opt"):
        assert "different meshes" in (recs[name]["mixed"] or ""), recs[name]["mixed"]
    assert recs["raw_full_shard_w1"]["mixed"] is None


def test_raw_loop_steps_zero1_moments(records):
    """The raw loop's adamw under SHARD_OPT against world 1 and the
    reference's raw loop under the same plugin."""
    _, recs = records
    rec = recs["raw_shard_opt"]
    losses, norms, final = _reference_raw_loop(RAW[1])
    for want, what in ((recs["raw_shard_opt_w1"], "world 1"),
                       ({"losses": losses, "norms": norms, "params": final}, "the reference")):
        _close(rec["losses"], want["losses"], f"losses vs {what}")
        _close(rec["norms"], want["norms"], f"norms vs {what}")
        for k, v in want["params"].items():
            _close(rec["params"][k], v, f"{k} vs {what}")
