"""Sharded training on the port at world 4 over gloo, against the reference
and the port's own unsharded run.

One world-4 launch runs every configuration in turn on one process group:

* mirrors of ``test_models.py::test_sharded_training_decreases_loss`` (dp 4,
  fsdp 4, fsdp 2 x tp 2 on the reference's ``tiny()`` in bf16: the loss
  falls and stays finite) and ``test_accelerator.py::
  test_fsdp_sharding_matches_dp``;
* the fp32 parity cases: five steps of the tiny ``CausalLM`` (weights from
  the reference's init through ``params_from_jax``, sgd 0.5, clip 1.0) on
  global batches whose data ranks hold different mask counts, under fsdp 4,
  dp 2 x tp 2 and fsdp 2 x tp 2: each step's loss and grad norm and the
  final params within 2e-5 of the reference's single-process run and of the
  port's own unsharded world-1 run; tp peers read the same rows, so each
  row of the global batch is counted once;
* the fused path (``fused_kernels=True``, ``fused_adamw``) under FULL_SHARD
  at fsdp 2 x tp 2: losses and grad norms within 2e-5 of the reference's
  plain adamw run and of the port's unsharded fused run, and the params
  against the latter as chip_smoke.py holds the fused path's (the norm of
  the difference over the norm of the update, ``SMALL_UPDATE_TOL``);
* fp16 under FULL_SHARD with an inf planted in one rank's gradient shard:
  every rank holds the step;
* ``get_state_dict`` under FULL_SHARD equals the unsharded state bit for
  bit;
* ``grad_dtype=bfloat16`` at fsdp 2 x tp 2 with clip 1.0 against the
  port's world-1 run under the same policy: the layout's and the raw
  loop's norms add the leaves as ``optimizer.global_norm`` does;
* a DTensor handed to each kernel wrapper raises;
* each layer under ``remat="full"`` at fsdp 2 x tp 2 (the recompute gathers
  again), and the reference's plugin names (DeepSpeed's ZeRO stages 0-3,
  FSDP's plugin, Megatron's tp 2) training as the reference does.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import sharding_workers  # noqa: E402
from accelerate_tpu_torch.test_utils.training import TINY_LM, TINY_SEQ, MaskedTokens  # noqa: E402

TOL = 2e-5
SMALL_UPDATE_TOL = 3e-4  # chip_smoke.py's bound for the fused path's params
# bf16 gradients at fsdp 2 x tp 2 against world 1's: 3x the reading, 2.44e-4
# after five steps (a bf16 gradient rounded from a differently summed fp32)
BF16_GRAD_PARAMS_TOL = 7.5e-4
STEPS, ROWS = 5, 8
PARITY = {"fsdp4": dict(dp_size=1, fsdp_size=4),
          "dp2_tp2": dict(dp_size=2, tp_size=2),
          "fsdp2_tp2": dict(dp_size=1, fsdp_size=2, tp_size=2)}
DECREASE = {"dp4": dict(dp_size=4, fsdp_size=1, sharding_strategy="no_shard"),
            "fsdp4_min1024": dict(dp_size=1, fsdp_size=4, min_weight_size=1024),
            "fsdp2_tp2_min1024": dict(dp_size=1, fsdp_size=2, tp_size=2,
                                      min_weight_size=1024)}
FUSED = dict(optimizer="fused_adamw", lr=1e-2, config=dict(fused_kernels=True))
# the reference's plugin names (utils/compat.py) at world 4
COMPAT = {"deepspeed_zero0": ("DeepSpeedPlugin", dict(zero_stage=0)),
          "deepspeed_zero1": ("DeepSpeedPlugin", dict(zero_stage=1)),
          "deepspeed_zero2": ("DeepSpeedPlugin", dict(zero_stage=2)),
          "deepspeed_zero3": ("DeepSpeedPlugin", dict(zero_stage=3)),
          "fsdp_plugin": ("FullyShardedDataParallelPlugin", dict(min_num_params=1024)),
          "megatron_tp2": ("MegatronLMPlugin", dict(tp_degree=2))}


def _parity_run(name, plugin, **kw):
    return dict(name=name, plugin=plugin, steps=STEPS, rows=ROWS, max_grad_norm=1.0, **kw)


RUNS = (
    [_parity_run(f"parity_{n}", p) for n, p in PARITY.items()]
    + [_parity_run(f"parity_{n}_remat", p, config=dict(remat="full"))
       for n, p in PARITY.items() if n == "fsdp2_tp2"]
    + [_parity_run(f"compat_{n}", {"compat": cls, "args": args})
       for n, (cls, args) in COMPAT.items()]
    + [dict(name=f"decrease_{n}", plugin=p, base="tiny", init="seed", data="fixed_ids",
            mixed_precision="bf16", optimizer="adamw", lr=1e-3, weight_decay=0.0, calls=10,
            max_grad_norm=1.0) for n, p in DECREASE.items()]
    + [dict(name=f"vec_{n}", model="vec", plugin=p, optimizer="sgd", lr=0.05, rows=16, calls=2)
       for n, p in (("dp", dict(dp_size=-1, sharding_strategy="no_shard")),
                    ("fsdp", dict(dp_size=1, fsdp_size=4, min_weight_size=1)))]
    + [_parity_run("fused_fsdp2_tp2", PARITY["fsdp2_tp2"], **FUSED),
       dict(name="fp16_inf", plugin=dict(dp_size=1, fsdp_size=4, min_weight_size=1),
            mixed_precision="fp16", steps=4, rows=ROWS, plant_inf=(2, 2)),
       dict(name="fp16_clean", plugin=dict(dp_size=1, fsdp_size=4, min_weight_size=1),
            mixed_precision="fp16", steps=4, rows=ROWS),
       dict(name="state_dict_lr0", plugin=PARITY["fsdp2_tp2"], lr=0.0, steps=1, rows=ROWS),
       _parity_run("grad_bf16_fsdp2_tp2", PARITY["fsdp2_tp2"], grad_dtype="bfloat16")]
)


def _reference_init():
    jmodel = JaxCausalLM(JaxConfig(**TINY_LM))
    return jax.tree.map(np.asarray, nn.unbox(jmodel.init_params(jax.random.PRNGKey(0),
                                                                seq_len=TINY_SEQ)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded4")
    init = _reference_init()
    torch.save(dict(port.params_from_jax(init, port.TransformerConfig(**TINY_LM))),
               os.path.join(out, "init.pt"))
    debug_launcher(sharding_workers.train_runs_worker, (str(out), RUNS, True), num_processes=4)
    records = {r["name"]: torch.load(os.path.join(out, f"{r['name']}.pt")) for r in RUNS}
    # the port's unsharded world-1 runs, in this process (no group)
    for name, kw in (("world1", {}), ("world1_fused", FUSED),
                     ("world1_grad_bf16", dict(grad_dtype="bfloat16"))):
        sharding_workers._train_run(str(out), _parity_run(name, None, **kw))
        records[name] = torch.load(os.path.join(out, f"{name}.pt"))
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    import json

    with open(os.path.join(out, "kernel_refusals.json")) as f:
        records["kernel_refusals"] = json.load(f)
    return out, init, records


_REFERENCE_RUNS: dict = {}


def _reference(init, name):
    """The reference's run with ``optax.sgd(0.5)`` or ``optax.adamw(1e-2)``,
    made once for the file."""
    if name not in _REFERENCE_RUNS:
        optimizer = optax.sgd(0.5) if name == "sgd" else optax.adamw(1e-2, weight_decay=1e-4)
        _REFERENCE_RUNS[name] = _reference_run(init, optimizer)
    return _REFERENCE_RUNS[name]


def _reference_run(init, optimizer):
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    acc = jax_pkg.Accelerator()
    jmodel = JaxCausalLM(JaxConfig(**TINY_LM))
    params, opt, loader = acc.prepare(
        jax.tree.map(jnp.asarray, init), optimizer,
        jax_pkg.DataLoader(MaskedTokens(STEPS * ROWS, 2), batch_size=ROWS))
    step = acc.unified_step(JaxCausalLM.loss_fn(jmodel), opt, max_grad_norm=1.0)
    carry = acc.init_carry(params, opt)
    losses, norms = [], []
    for batch in loader:
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out = (losses, norms, port.params_from_jax(jax.tree.map(np.asarray, carry["params"]),
                                               port.TransformerConfig(**TINY_LM)))
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    return out


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_sharded_fp32_training_matches_the_reference_and_world_one(runs, name):
    _, init, records = runs
    rec, one = records[f"parity_{name}"], records["world1"]
    losses, norms, params = _reference(init, "sgd")
    _close(rec["losses"], losses, "losses vs the reference")
    _close(rec["norms"], norms, "grad norms vs the reference")
    _close(rec["losses"], one["losses"], "losses vs world 1")
    _close(rec["norms"], one["norms"], "grad norms vs world 1")
    for k, v in params.items():
        _close(rec["params"][k], v, f"{k} vs the reference")
        _close(rec["params"][k], one["params"][k], f"{k} vs world 1")


def test_remat_recompute_gathers_again_under_fsdp_and_tp(runs):
    """Each layer under ``remat="full"`` at fsdp 2 x tp 2: the recompute in
    the backward gathers the layer's weights again (and runs its tp
    collectives again); the run is the plain run's within 2e-5."""
    _, _, records = runs
    rec, plain = records["parity_fsdp2_tp2_remat"], records["parity_fsdp2_tp2"]
    _close(rec["losses"], plain["losses"], "remat losses")
    _close(rec["norms"], plain["norms"], "remat grad norms")
    for k, v in plain["params"].items():
        _close(rec["params"][k], v, f"remat {k}")


@pytest.mark.parametrize("name", sorted(COMPAT))
def test_compat_plugins_train_as_the_reference(runs, name):
    """The reference's plugin names train on the port at world 4: DeepSpeed's
    ZeRO stages 0-3, FSDP's plugin and Megatron's tp 2, each within 2e-5 of
    the reference's single-process run on the same global batches."""
    _, init, records = runs
    rec = records[f"compat_{name}"]
    losses, norms, params = _reference(init, "sgd")
    _close(rec["losses"], losses, "losses vs the reference")
    _close(rec["norms"], norms, "grad norms vs the reference")
    for k, v in params.items():
        _close(rec["params"][k], v, f"{k} vs the reference")
    specs = " ".join(str(s) for s in rec["specs"].values())
    want = {"deepspeed_zero3": "fsdp", "fsdp_plugin": "fsdp", "megatron_tp2": "tp"}.get(name)
    if want:
        assert want in specs, rec["specs"]
    else:  # ZeRO 0-2 keep the params whole
        assert "fsdp" not in specs and "tp" not in specs, rec["specs"]


@pytest.mark.parametrize("name", sorted(PARITY))
def test_tp_peers_read_the_same_rows_and_data_ranks_differ(runs, name):
    """Each row of the global batch is read by one data rank: the tp peers
    of a data rank hold the same rows, distinct data ranks distinct ones, and
    together they cover the global batch once."""
    rec = runs[2][f"parity_{name}"]
    tp = PARITY[name].get("tp_size", 1)
    seen = [r["seen"] for r in rec["ranks"]]
    assert rec["data_size"] == 4 // tp
    for rank in range(4):  # rank = data rank * tp + tp index
        assert seen[rank] == seen[rank - rank % tp]
    per_call = list(zip(*[seen[d * tp] for d in range(rec["data_size"])]))
    assert all(sum(len(rows) for rows in call) == ROWS for call in per_call)
    # the data ranks held different mask counts (the pattern changes every 2 rows)
    assert rec["losses"] == runs[2][f"parity_{name}"]["ranks"][3]["losses"]


@pytest.mark.parametrize("name", sorted(PARITY))
def test_parity_placements_follow_the_rules(runs, name):
    from accelerate_tpu_torch.parallel import sharding

    rec = runs[2][f"parity_{name}"]
    model = port.CausalLM(port.TransformerConfig(**TINY_LM), device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    shape = {"dp": 1, "fsdp": 1, "tp": 1}
    shape.update({a[:-5]: v for a, v in PARITY[name].items() if a.endswith("_size")})
    specs = sharding.infer_param_shardings(shapes, shape, port.ParallelismPlugin(**PARITY[name]),
                                           sharding.get_logical_specs(model))
    assert rec["specs"] == {k: sharding.live_axes(v, shape) for k, v in specs.items()}


@pytest.mark.parametrize("name", sorted(DECREASE))
def test_sharded_training_decreases_loss(runs, name):
    losses = runs[2][f"decrease_{name}"]["losses"]
    assert len(losses) == 10
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(x) for x in losses)


def test_fsdp_sharding_matches_dp(runs):
    dp, fsdp = runs[2]["vec_dp"], runs[2]["vec_fsdp"]
    assert fsdp["specs"]["w"] == ("fsdp",)
    np.testing.assert_allclose(fsdp["params"]["w"].numpy(), dp["params"]["w"].numpy(),
                               rtol=1e-5)


def test_fused_path_under_full_shard(runs):
    _, init, records = runs
    rec, one = records["fused_fsdp2_tp2"], records["world1_fused"]
    losses, norms, _ = _reference(init, "adamw")
    _close(rec["losses"], losses, "fused losses vs the reference's adamw")
    _close(rec["norms"], norms, "fused grad norms vs the reference's adamw")
    _close(rec["losses"], one["losses"], "fused losses vs world 1")
    # Adam turns a near-zero gradient's summation-order difference into a
    # whole step (one element of 10240 read 5.1e-5 here), so the params are
    # held as the fused path's are on the card: |sharded - world 1| over
    # |world 1's update| across the tree, within chip_smoke.py's
    # SMALL_UPDATE_TOL
    init = torch.load(os.path.join(runs[0], "init.pt"))
    diff = torch.sqrt(sum(((rec["params"][k] - v) ** 2).sum() for k, v in one["params"].items()))
    update = torch.sqrt(sum(((v - init[k]) ** 2).sum() for k, v in one["params"].items()))
    assert float(diff / update) <= SMALL_UPDATE_TOL, float(diff / update)
    # the attention norm, applied after the tp split by the fused prologue,
    # is one of the leaves summed over tp
    assert rec["specs"]["layers.0.attn_norm.weight"] == (None,)


def test_fp16_inf_in_one_shard_holds_every_rank(runs):
    """An inf put into rank 2's gradient shard at the third step: that step
    is non-finite on every rank (the first step's own fp16 overflow at the
    initial scale is held in both runs) and every rank's params stay as
    they were; the clean run's third step applies."""
    rec, clean = runs[2]["fp16_inf"], runs[2]["fp16_clean"]
    flags = clean["finite"]
    assert flags[2] is True
    planted = flags[:2] + [False] + flags[3:]
    assert [r["finite"] for r in rec["ranks"]] == [planted] * 4
    assert [r["held"] for r in rec["ranks"]] == [True] * 4
    assert rec["loss_scale"] == clean["loss_scale"] / 2  # one more halving


def test_get_state_dict_under_full_shard_is_the_unsharded_state(runs):
    out, _, records = runs
    init = torch.load(os.path.join(out, "init.pt"))
    state = records["state_dict_lr0"]["params"]
    assert set(state) == set(init)
    for k, v in init.items():
        assert torch.equal(state[k], v), k
    assert any("fsdp" in str(s) for s in records["state_dict_lr0"]["specs"].values())


def test_a_dtensor_handed_to_a_kernel_wrapper_raises(runs):
    refused = runs[2]["kernel_refusals"]
    assert set(refused) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused",
                            "qkv_prologue", "prologue_launch", "adamw_epilogue"}
    for name, err in refused.items():
        assert err is not None and err.startswith("TypeError") and "DTensor" in err, (name, err)


def test_bf16_gradients_clip_under_a_plugin_as_at_world_one(runs):
    """``grad_dtype=bfloat16`` at fsdp 2 x tp 2, clip 1.0 scaling every step:
    each step's loss and grad norm within TOL of the port's world-1 run
    under the same policy, the params within BF16_GRAD_PARAMS_TOL, and a
    bf16 tree's norm from the layout (the step's) and from its DTensors
    (the raw loop's) within TOL of ``optimizer.global_norm`` of the whole
    leaves; the fp32 run's norms are not those (the dtype reaches the
    step)."""
    _, _, records = runs
    rec, one = records["grad_bf16_fsdp2_tp2"], records["world1_grad_bf16"]
    low = rec["low_norms"]
    _close([low["step"], low["raw"]], [low["whole"]] * 2, "bf16 tree norms vs the whole leaves'")
    assert min(one["norms"]) > 1.0, one["norms"]  # the clip scales every step
    _close(rec["losses"], one["losses"], "losses vs world 1")
    _close(rec["norms"], one["norms"], "grad norms vs world 1")
    f32 = records["parity_fsdp2_tp2"]["norms"]
    assert all(abs(a - b) > 10 * TOL * b for a, b in zip(f32, one["norms"])), (f32, one["norms"])
    for k, v in one["params"].items():
        np.testing.assert_allclose(np.asarray(rec["params"][k]), np.asarray(v), rtol=0,
                                   atol=BF16_GRAD_PARAMS_TOL, err_msg=k)
