"""Fused gradient accumulation in the port, against its unfused step and
against the JAX reference's fused step, on the CPU.

The port's counterparts of ``tests/test_fused_accum.py``: the fused step
(one call per optimizer step over a stacked ``[K, micro, ...]`` batch) and
the unfused one (one call per microbatch) share the epilogue and add the
same fp32 gradients into zeros in the same order, so their params and
optimizer state must be equal bit for bit, in fp32 and in bf16, with
clipping and through an fp16 overflow; and each is held against the
reference's.

Tolerances: the port against the reference 2e-5 relative on params,
moments and losses in fp32 (summation order only), the reference's own
2e-2 in bf16; everything inside the port bitwise. The tiny CausalLM (fp32,
K 4, 3 optimizer steps) holds ``loss_per_microbatch`` and the params
within 2e-5 of the reference's fused step.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.utils.dataclasses import GradientAccumulationPlugin as JaxPlugin  # noqa: E402
from accelerate_tpu_torch.utils.dataclasses import GradientAccumulationPlugin  # noqa: E402

BATCH = 8  # divisible by the 8 virtual CPU devices of tests/conftest.py


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_singletons():
    _reset()
    yield
    _reset()


class RegressionDataset:
    def __init__(self, n=96, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(n, 1)).astype(np.float32)
        self.y = (2.0 * self.x[:, 0] + 3.0 + 0.05 * rng.normal(size=n)).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def port_loss(params, batch):
    pred = batch["x"][:, 0] * params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def jax_loss(params, batch):
    pred = batch["x"][:, 0] * params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _run_port(fused, *, K=4, n=96, mixed_precision=None, max_grad_norm=None, w0=0.0,
              remat_policy=None, optimizer=None, telemetry=False):
    _reset()
    acc = port.Accelerator(
        cpu=True, mixed_precision=mixed_precision, telemetry=telemetry,
        gradient_accumulation_plugin=GradientAccumulationPlugin(num_steps=K, fused=fused))
    params = {"w": torch.tensor(w0), "b": torch.tensor(0.0)}
    opt, loader = acc.prepare(optimizer or port.adamw(0.1),
                              port.DataLoader(RegressionDataset(n), batch_size=BATCH))
    step = acc.unified_step(port_loss, opt, max_grad_norm=max_grad_norm,
                            remat_policy=remat_policy)
    carry = acc.init_carry(params, opt)
    history = []
    for batch in loader:
        carry, metrics = step(carry, batch)
        history.append(metrics)
    return carry, acc, history


def _run_jax(fused, *, K=4, n=96, mixed_precision=None, max_grad_norm=None, w0=0.0,
             optimizer=None):
    _reset()
    acc = jax_pkg.Accelerator(mixed_precision=mixed_precision,
                              gradient_accumulation_plugin=JaxPlugin(num_steps=K, fused=fused))
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(0.0)}
    params, opt, loader = acc.prepare(params, optimizer or optax.adamw(0.1),
                                      jax_pkg.DataLoader(RegressionDataset(n), batch_size=BATCH))
    step = acc.unified_step(jax_loss, opt, max_grad_norm=max_grad_norm)
    carry = acc.init_carry(params, opt)
    history = []
    for batch in loader:
        carry, metrics = step(carry, batch)
        history.append(metrics)
    return carry, history


def _assert_bitwise(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_bitwise(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), (a, b)
    else:
        assert a == b


def _assert_close_to_jax(port_carry, jax_carry, rtol):
    for k in ("w", "b"):
        np.testing.assert_allclose(float(port_carry["params"][k].detach()),
                                   float(jax_carry["params"][k]), rtol=rtol, err_msg=k)


def test_fused_parity_fp32_bitwise():
    unfused, acc_u, _ = _run_port(False)
    fused, acc_f, history = _run_port(True)
    assert unfused["opt_step"] == fused["opt_step"] == 3
    _assert_bitwise(unfused["params"], fused["params"])
    _assert_bitwise(unfused["opt_state"], fused["opt_state"])
    # the fused carry drops the per-call bookkeeping
    assert "micro_step" in unfused and "accum_grads" in unfused
    assert "micro_step" not in fused and "accum_grads" not in fused
    acc_f.sync_from_carry(fused)
    assert acc_f.step == 3 and acc_f.gradient_state.sync_gradients
    acc_u.sync_from_carry(unfused)
    assert acc_u.step == 12
    jax_fused, jax_history = _run_jax(True)
    _assert_close_to_jax(fused, jax_fused, 2e-5)
    for got, want in zip(history, jax_history):
        np.testing.assert_allclose(got["loss_per_microbatch"].numpy(),
                                   np.asarray(want["loss_per_microbatch"]), rtol=2e-5)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-5)
    for key in ("mu", "nu"):
        for k in ("w", "b"):
            np.testing.assert_allclose(float(fused["opt_state"][key][k]),
                                       float(getattr(jax_fused["opt_state"][0], key)[k]), rtol=2e-5)


def test_fused_parity_with_clipping():
    unfused, _, hu = _run_port(False, max_grad_norm=0.5, w0=50.0)
    fused, _, hf = _run_port(True, max_grad_norm=0.5, w0=50.0)
    _assert_bitwise(unfused["params"], fused["params"])
    # the sync step's norm is the same real (pre-clip) norm
    assert float(hu[-1]["grad_norm"]) == float(hf[-1]["grad_norm"]) > 0.5
    jax_fused, jh = _run_jax(True, max_grad_norm=0.5, w0=50.0)
    _assert_close_to_jax(fused, jax_fused, 2e-5)
    np.testing.assert_allclose(float(hf[-1]["grad_norm"]), float(jh[-1]["grad_norm"]), rtol=2e-5)


def test_fused_parity_bf16_compute():
    unfused, _, _ = _run_port(False, mixed_precision="bf16")
    fused, _, _ = _run_port(True, mixed_precision="bf16")
    _assert_bitwise(unfused["params"], fused["params"])
    assert fused["params"]["w"].dtype == torch.float32  # the masters stay fp32
    jax_fused, _ = _run_jax(True, mixed_precision="bf16")
    _assert_close_to_jax(fused, jax_fused, 2e-2)


def test_fused_fp16_overflow_skip_parity():
    """A huge w overflows the fp16 forward, so both modes skip every update
    (params held), halve the scale each time and still count the optimizer
    steps, identically, as the reference's do."""
    results = {}
    for fused in (False, True):
        carry, _, history = _run_port(fused, mixed_precision="fp16", w0=1e4,
                                      optimizer=port.sgd(1e-4))
        assert not bool(history[-1]["grads_finite"])  # the overflow was real
        results[fused] = carry
    unfused, fused = results[False], results[True]
    assert unfused["opt_step"] == fused["opt_step"] == 3
    _assert_bitwise(unfused["params"], fused["params"])
    assert float(fused["params"]["w"].detach()) == 1e4
    assert float(unfused["loss_scale"].scale) == float(fused["loss_scale"].scale) == 2.0**15 / 2**3
    jax_fused, jh = _run_jax(True, mixed_precision="fp16", w0=1e4, optimizer=optax.sgd(1e-4))
    assert not bool(jh[-1]["grads_finite"])
    assert float(jax_fused["loss_scale"].scale) == float(fused["loss_scale"].scale)


def test_fused_remat_policy_parity():
    """``remat_policy=True`` recomputes each microbatch's loss in the
    backward: the same ops on the same inputs, so the same bits (the
    reference holds its own at 1e-6)."""
    plain, _, _ = _run_port(True)
    remat, _, _ = _run_port(True, remat_policy=True)
    _assert_bitwise(plain["params"], remat["params"])
    with pytest.raises(ValueError, match="unknown remat_policy"):
        port.Accelerator(cpu=True).unified_step(port_loss, port.AcceleratedOptimizer(
            port.sgd(0.1)), remat_policy="nothing")


def test_fused_one_record_per_optimizer_step():
    """With telemetry the fused step emits one record per optimizer step:
    ``microbatches`` K, ``dispatches_per_opt_step`` 1, a real grad norm;
    the signature is new on the first call only."""
    K = 4
    carry, acc, _ = _run_port(True, K=K, n=64, telemetry=True)
    assert carry["opt_step"] == 2  # 8 microbatches / K: every call is an optimizer step
    recs = [r for r in acc.telemetry.records if r.get("kind") == "step"]
    assert len(recs) == 2
    assert [r["retraced"] for r in recs] == [True, False]
    assert acc.telemetry.detector(recs[0]["label"]).retraces == 0
    for rec in recs:
        assert rec["microbatches"] == K and rec["dispatches_per_opt_step"] == 1
        assert rec["is_sync_step"] == 1.0 and np.isfinite(rec["grad_norm"])
        assert rec["fused_kernels"] is False
    unfused, acc_u, _ = _run_port(False, K=K, n=64, telemetry=True)
    urecs = [r for r in acc_u.telemetry.records if r.get("kind") == "step"]
    assert len(urecs) == 8
    assert all(r["microbatches"] == 1 and r["dispatches_per_opt_step"] == K for r in urecs)


def test_records_never_carry_a_fake_grad_norm(tmp_path):
    """Steps that only accumulate have no gradient norm: the step reports
    NaN, never 0.0, and the record leaves the field off, so the JSONL sink
    (and anything reading it) only sees sync-step norms, as the
    reference's records do."""
    import json

    path = tmp_path / "t.jsonl"
    _, acc, history = _run_port(False, K=2, n=64,
                                telemetry=port.telemetry.TelemetryConfig(jsonl_path=str(path)))
    acc.telemetry.close()
    assert all(np.isnan(float(m["grad_norm"])) for m in history[::2])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    recs = [r for r in recs if r["kind"] == "step"]
    sync = [r for r in recs if r["is_sync_step"] == 1.0]
    nonsync = [r for r in recs if r["is_sync_step"] != 1.0]
    assert len(sync) == len(nonsync) == 4
    for rec in nonsync:
        assert "grad_norm" not in rec and "loss" in rec
    for rec in sync:
        assert np.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0.0


def test_fused_step_rejects_unfused_carry():
    acc = port.Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
        num_steps=2, fused=True))
    opt = acc.prepare(port.sgd(0.1))
    step = acc.unified_step(lambda p, b: torch.mean((b["x"][:, 0] * p["w"]) ** 2), opt)
    stale = acc.init_carry({"w": torch.tensor(0.0)}, opt, fused_accumulation=False)
    with pytest.raises(ValueError, match="fused accumulation carries no"):
        step(stale, {"x": torch.ones(2, 8, 1)})


def test_fused_env_knob(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_FUSED_ACCUM", "1")
    assert GradientAccumulationPlugin(num_steps=4).fused and JaxPlugin(num_steps=4).fused
    acc = port.Accelerator(cpu=True, gradient_accumulation_steps=4)
    assert acc.gradient_state.fused
    carry = acc.init_carry({"w": torch.tensor(0.0)}, acc.prepare(port.sgd(0.1)))
    assert "micro_step" not in carry and "accum_grads" not in carry
    monkeypatch.setenv("ACCELERATE_TPU_FUSED_ACCUM", "maybe")
    with pytest.raises(ValueError, match="FUSED_ACCUM"):
        GradientAccumulationPlugin(num_steps=4)
    monkeypatch.delenv("ACCELERATE_TPU_FUSED_ACCUM")
    monkeypatch.setenv("ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS", "3")
    assert GradientAccumulationPlugin().num_steps == JaxPlugin().num_steps == 3
    assert GradientAccumulationPlugin(num_steps=5).num_steps == 5  # an explicit value wins


def test_fused_rejects_sync_each_batch():
    for plugin in (GradientAccumulationPlugin, JaxPlugin):
        with pytest.raises(ValueError, match="sync_each_batch"):
            plugin(num_steps=2, fused=True, sync_each_batch=True)


def test_has_aux_and_keywords_reach_the_loss():
    """``has_aux`` returns the loss closure's aux (stacked by microbatch
    when fused) and ``**kw`` reaches the loss, as in the reference."""

    def ploss(params, batch, scale=1.0):
        err = batch["x"][:, 0] * params["w"] + params["b"] - batch["y"]
        return scale * torch.mean(err ** 2), {"abs_err": torch.mean(err.abs())}

    def jloss(params, batch, scale=1.0):
        err = batch["x"][:, 0] * params["w"] + params["b"] - batch["y"]
        return scale * jnp.mean(err ** 2), {"abs_err": jnp.mean(jnp.abs(err))}

    ds = RegressionDataset(32)
    for fused in (False, True):
        _reset()
        pacc = port.Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
            num_steps=4, fused=fused))
        popt, ploader = pacc.prepare(port.adamw(0.1), port.DataLoader(ds, batch_size=BATCH))
        pstep = pacc.unified_step(ploss, popt, has_aux=True, donate=False)
        pcarry = pacc.init_carry({"w": torch.tensor(0.0), "b": torch.tensor(0.0)}, popt)
        jacc = jax_pkg.Accelerator(gradient_accumulation_plugin=JaxPlugin(num_steps=4,
                                                                          fused=fused))
        jparams, jopt, jloader = jacc.prepare({"w": jnp.asarray(0.0), "b": jnp.asarray(0.0)},
                                              optax.adamw(0.1),
                                              jax_pkg.DataLoader(ds, batch_size=BATCH))
        jstep = jacc.unified_step(jloss, jopt, has_aux=True)
        jcarry = jacc.init_carry(jparams, jopt)
        for pb, jb in zip(ploader, jloader):
            pcarry, pm = pstep(pcarry, pb, scale=2.0)
            jcarry, jm = jstep(jcarry, jb, scale=2.0)
            got, want = pm["aux"]["abs_err"], np.asarray(jm["aux"]["abs_err"])
            assert tuple(got.shape) == want.shape == ((4,) if fused else ())
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=2e-5)
        _assert_close_to_jax(pcarry, jcarry, 2e-5)


MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64)
SEQ = 16


class Tokens:
    def __init__(self, n, seed=0):
        self.ids = np.random.default_rng(seed).integers(
            0, MODEL["vocab_size"], size=(n, SEQ)).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i]}


@pytest.mark.parametrize("optimizer,remat_policy", [("sgd", None), ("sgd", "save_mlp"),
                                                    ("adamw", None)])
def test_causal_lm_fused_matches_reference(optimizer, remat_policy):
    """A tiny fp32 CausalLM, K 4, 3 optimizer steps from carried weights:
    the port's fused step against the reference's fused step
    (``loss_per_microbatch`` within 2e-5; the params within 2e-5 under sgd
    at lr 0.5, which moves a weight ~1e-3 a step), and against the port's
    unfused step bit for bit, with and without a remat policy. Under adamw
    the params are held inside the port only: Adam divides each gradient by
    its root mean square plus eps 1e-8, so the smallest gradient element
    (|g| 5e-8 of a median 3.5e-3) turns the packages' summation-order
    difference (4e-9) into 3e-5 after 3 steps."""
    K, steps = 4, 3
    model = JaxCausalLM(JaxConfig(**MODEL))
    init = jax.tree.map(np.asarray, nn.unbox(model.init_params(jax.random.PRNGKey(0),
                                                               seq_len=SEQ)))
    dataset = Tokens(K * steps * BATCH)
    lr = 0.5 if optimizer == "sgd" else 1e-3
    _reset()
    jacc = jax_pkg.Accelerator(gradient_accumulation_plugin=JaxPlugin(num_steps=K, fused=True))
    jparams, jopt, jloader = jacc.prepare(jax.tree.map(jnp.asarray, init),
                                          getattr(optax, optimizer)(lr),
                                          jax_pkg.DataLoader(dataset, batch_size=BATCH))
    jstep = jacc.unified_step(JaxCausalLM.loss_fn(model), jopt, max_grad_norm=1.0)
    jcarry = jacc.init_carry(jparams, jopt)
    jlosses = []
    for batch in jloader:
        jcarry, m = jstep(jcarry, batch)
        jlosses.append(np.asarray(m["loss_per_microbatch"]))
    want = port.params_from_jax(jax.tree.map(np.asarray, jcarry["params"]),
                                port.TransformerConfig(**MODEL))

    runs = {}
    for fused in (True, False):
        _reset()
        acc = port.Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
            num_steps=K, fused=fused))
        pmodel = port.CausalLM(port.TransformerConfig(**MODEL), device="cpu")
        pmodel.load_state_dict(port.params_from_jax(init, pmodel.config), strict=True)
        pmodel, opt, loader = acc.prepare(pmodel, getattr(port, optimizer)(lr),
                                          port.DataLoader(dataset, batch_size=BATCH))
        step = acc.unified_step(port.CausalLM.loss_fn(pmodel), opt, max_grad_norm=1.0,
                                remat_policy=remat_policy)
        carry = acc.init_carry(pmodel, opt)
        losses = []
        for batch in loader:
            carry, m = step(carry, batch)
            losses.append(m["loss_per_microbatch"].numpy() if fused else float(m["loss"]))
        runs[fused] = (losses, {k: p.detach().clone() for k, p in carry["params"].items()})
    flosses, fparams = runs[True]
    assert len(flosses) == len(jlosses) == steps
    np.testing.assert_allclose(np.stack(flosses), np.stack(jlosses), rtol=2e-5)
    np.testing.assert_array_equal(np.concatenate(flosses), np.asarray(runs[False][0]))
    _assert_bitwise(fparams, runs[False][1])
    assert set(fparams) == set(want)
    start = port.params_from_jax(init, port.TransformerConfig(**MODEL))
    moved = max(float((fparams[k] - v).abs().max()) for k, v in start.items())
    assert moved > 1e-3  # the steps moved the weights well past the tolerance
    if optimizer == "sgd":
        for name, value in want.items():
            np.testing.assert_allclose(fparams[name].numpy(), value.numpy(), atol=2e-5,
                                       rtol=2e-5, err_msg=name)
