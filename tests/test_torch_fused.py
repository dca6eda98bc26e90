"""The port's fused step kernels (their plain versions, on the CPU) against
the JAX reference's ``ops/fused.py`` run in interpret mode.

* B5, the prologue: ``fused_qkv_prologue`` of both packages on the same
  numpy inputs: q, k, v and the grads of x, the norm scale and every
  weight (and bias) for the loss of ``tests/test_fused_kernels.py:84``.
* B6, the epilogue: ``maybe_fused_epilogue`` of both packages on the same
  tree, state and clip, with the step finite and not, and over several
  steps.
* The slice as a whole: a ``fused_kernels=True`` ``CausalLM`` against the
  reference's (logits, loss, every grad), then five ``unified_step``s with
  ``fused_adamw`` against the reference's fused step.

Tolerances: fp32 on both sides. The prologue: 2e-5 absolute + 2e-5
relative on q, k, v; grads divided by their largest reference magnitude,
then 2e-5 absolute (sum order in the matmuls and the norm's mean). The
epilogue: bitwise from fresh moments; over several steps params within 2
ulp and moments within 2 ulp of their largest magnitude, because XLA:CPU
contracts two of the reference's products into fmas where optax's order
(and the port) rounds each (shown exactly in the test). The whole model
and step: the tolerances of ``test_torch_models.py`` and
``test_torch_accelerator.py``.
"""

import dataclasses

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
from accelerate_tpu.ops import fused as jfused  # noqa: E402
from accelerate_tpu_torch.ops import fused as tfused  # noqa: E402

TOL = 2e-5
LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 16,
}


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


# --------------------------------------------------------------------- #
# B5: the prologue
# --------------------------------------------------------------------- #
PROLOGUE_CASES = {
    "gqa": dict(),
    "bias": dict(bias=True),
    "mha": dict(kv_heads=4),
    "llama3_rope": dict(scaling=LLAMA3_SCALING),
    "norm_offset": dict(norm_offset=True, bias=True),
}


def _prologue_inputs(b=2, s=32, hidden=64, heads=4, kv_heads=2, d=16, bias=False, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd=1.0: (rng.normal(size=shape) * sd).astype(np.float32)  # noqa: E731
    arrays = dict(x=f(b, s, hidden), scale=f(hidden, sd=0.1) + 1.0,
                  wq=f(hidden, heads * d, sd=0.05), wk=f(hidden, kv_heads * d, sd=0.05),
                  wv=f(hidden, kv_heads * d, sd=0.05))
    arrays.update(bq=f(heads * d) if bias else None, bk=f(kv_heads * d) if bias else None,
                  bv=f(kv_heads * d) if bias else None)
    positions = np.broadcast_to(np.arange(s)[None, :], (b, s)).astype(np.int32)
    return arrays, positions


def _prologue_pair(case):
    kw = dict(PROLOGUE_CASES[case])
    scaling = kw.pop("scaling", None)
    norm_offset = kw.pop("norm_offset", False)
    heads, kv_heads = 4, kw.get("kv_heads", 2)
    arrays, positions = _prologue_inputs(**kw)
    statics = dict(eps=1e-6, norm_offset=norm_offset, num_heads=heads, num_kv_heads=kv_heads,
                   head_dim=16, theta=10000.0, scaling=scaling)
    names = [n for n in ("x", "scale", "wq", "wk", "wv", "bq", "bk", "bv")
             if arrays[n] is not None]

    def loss(q, k, v, xp):
        return xp.sum(q * q) + xp.sum(k) + xp.sum(v * 2.0)

    def jax_fn(*diff):
        a = dict(arrays, **dict(zip(names, diff)))
        q, k, v = jfused.fused_qkv_prologue(
            a["x"], a["scale"], a["wq"], a["wk"], a["wv"], a["bq"], a["bk"], a["bv"],
            jnp.asarray(positions), dtype=jnp.float32, **statics)
        return loss(q, k, v, jnp), (q, k, v)

    jgrads, jout = jax.grad(jax_fn, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(arrays[n]) for n in names))

    # the port's weights are PyTorch's (out, in)
    tens = {n: torch.tensor(arrays[n].T.copy() if n.startswith("w") else arrays[n],
                            requires_grad=True) for n in names}
    get = lambda n: tens.get(n)  # noqa: E731
    tout = tfused.fused_qkv_prologue(
        get("x"), get("scale"), get("wq"), get("wk"), get("wv"), get("bq"), get("bk"),
        get("bv"), torch.from_numpy(positions).long(), dtype=torch.float32, **statics)
    tgrads = torch.autograd.grad(loss(*tout, torch), [tens[n] for n in names])
    tgrads = [g.T if n.startswith("w") else g for n, g in zip(names, tgrads)]
    return names, (jout, [np.asarray(g) for g in jgrads]), (tout, tgrads)


@pytest.mark.parametrize("case", sorted(PROLOGUE_CASES))
def test_prologue_plain_matches_jax_kernel(case):
    _, (jout, _), (tout, _) = _prologue_pair(case)
    for name, got, want in zip("qkv", tout, jout):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(PROLOGUE_CASES))
def test_prologue_grads_match_jax(case):
    names, (_, jgrads), (_, tgrads) = _prologue_pair(case)
    for name, got, want in zip(names, tgrads, jgrads):
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=TOL, err_msg=name)


def test_prologue_supported_keeps_the_reference_answer_on_cpu():
    for args in ((4, 2, 15, 2, 32, 64), (4, 2, 16, 2, 32, 64), (4, 2, 16, 1, 7, 64),
                 (32, 8, 128, 2, 2048, 4096)):
        assert tfused.prologue_supported(*args, device="cpu") == \
            jfused.prologue_supported(*args, interpret=True), args
    for heads in ((4, 2, 16), (32, 8, 128), (14, 2, 128), (12, 6, 64)):
        assert tfused._col_block(*heads) == jfused._col_block(*heads)


# --------------------------------------------------------------------- #
# B6: the epilogue
# --------------------------------------------------------------------- #
def _epilogue_tree(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (37, 19), "b": (19,), "s": ()}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 3.0).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    return params, grads


def _run_epilogues(params, grad_steps, finite):
    """Each package's maybe_fused_epilogue over ``grad_steps`` with the clip
    scale from the global norm (max norm 0.5, so it binds). The same clip
    scale goes to both: the global norm sums in another order in each
    framework and is not the epilogue's work."""
    jopt = jfused.fused_adamw(3e-4)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    topt = port.fused_adamw(3e-4)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = topt.init(tparams)
    for grads in grad_steps:
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        jscale = jnp.minimum(1.0, 0.5 / (optax.global_norm(jg) + 1e-6))
        jparams, jstate = jfused.maybe_fused_epilogue(
            jopt, jg, jstate, jparams, clip_scale=jscale, finite=jnp.asarray(finite))
        tg = {k: torch.tensor(v) for k, v in grads.items()}
        assert tfused.maybe_fused_epilogue(topt, tg, tstate, tparams,
                                           clip_scale=torch.tensor(np.asarray(jscale)),
                                           finite=finite) is not None
    return (jparams, jstate), (tparams, tstate)


@pytest.mark.parametrize("finite", [True, False], ids=["finite", "held"])
def test_epilogue_bitwise_vs_jax_from_fresh_moments(finite):
    """One step from freshly made moments (mu = nu = 0): params, mu, nu
    and the count bit for bit, so the bias corrections (pow of the count)
    and the operation order agree exactly; a held step changes nothing."""
    params, grad_steps = _epilogue_tree()
    (jparams, jstate), (tparams, tstate) = _run_epilogues(params, grad_steps[:1], finite)
    for name in params:
        for got, want in ((tparams[name], jparams[name]), (tstate["mu"][name], jstate[0].mu[name]),
                          (tstate["nu"][name], jstate[0].nu[name])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        if not finite:
            np.testing.assert_array_equal(tparams[name].numpy(), params[name])
    assert tstate["count"] == int(jstate[0].count) == (1 if finite else 0)


def test_epilogue_vs_jax_over_steps_within_the_fma_gap():
    """Four steps. Once mu and nu are non-zero, XLA:CPU contracts the
    reference's interpreted kernel: mu' = fma(1-b1, g, b1*mu) and nu' =
    fma(1-b2, g*g, b2*nu), where optax's order (and the port, on the CPU
    and in its CUDA kernel) rounds each product. Measured gap: params
    within 2 ulp, mu and nu within 2 ulp of their largest magnitude. The
    cause is checked exactly: one step of the reference from a state with
    moments is the fma chain, bit for bit."""
    params, grad_steps = _epilogue_tree()
    (jparams, jstate), (tparams, tstate) = _run_epilogues(params, grad_steps, True)
    assert tstate["count"] == int(jstate[0].count) == 4
    for name in params:
        np.testing.assert_array_almost_equal_nulp(tparams[name].numpy(),
                                                  np.asarray(jparams[name]), nulp=2)
        for got, want in ((tstate["mu"][name], jstate[0].mu[name]),
                          (tstate["nu"][name], jstate[0].nu[name])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=2.0**-22 * np.abs(want).max(), err_msg=name)

    # the cause: the reference's step from moments is the contracted chain
    g = grad_steps[0]["w"]
    mu, nu = np.asarray(jstate[0].mu["w"]), np.asarray(jstate[0].nu["w"])
    jopt = jfused.fused_adamw(3e-4)
    state = jopt.init({"w": jnp.asarray(params["w"])})
    state = (state[0]._replace(count=jnp.int32(4), mu={"w": jnp.asarray(mu)},
                               nu={"w": jnp.asarray(nu)}),) + state[1:]
    _, out = jfused.maybe_fused_epilogue(jopt, {"w": jnp.asarray(g)}, state,
                                         {"w": jnp.asarray(params["w"])}, clip_scale=None,
                                         finite=jnp.asarray(True))
    f32, f64 = np.float32, np.float64
    b1, b2, omb1, omb2 = f32(0.9), f32(0.999), f32(1 - 0.9), f32(1 - 0.999)
    gg = (g * g).astype(f32)
    fma = lambda a, x, c: (f64(a) * x.astype(f64) + c.astype(f64)).astype(f32)  # noqa: E731
    np.testing.assert_array_equal(np.asarray(out[0].mu["w"]), fma(omb1, g, b1 * mu))
    np.testing.assert_array_equal(np.asarray(out[0].nu["w"]), fma(omb2, gg, b2 * nu))


def test_epilogue_matches_the_plain_optimizer_bitwise():
    """The fused epilogue is the port's own AdamW step, bit for bit."""
    params, grad_steps = _epilogue_tree(seed=1)
    fused, plain = port.fused_adamw(1e-2), port.adamw(1e-2)
    fp = {k: torch.tensor(v) for k, v in params.items()}
    pp = {k: torch.tensor(v) for k, v in params.items()}
    fs, ps = fused.init(fp), plain.init(pp)
    for grads in grad_steps:
        tfused.maybe_fused_epilogue(fused, {k: torch.tensor(v) for k, v in grads.items()}, fs,
                                    fp, clip_scale=None, finite=True)
        plain.apply_({k: torch.tensor(v) for k, v in grads.items()}, ps, pp)
    for name in params:
        assert torch.equal(fp[name], pp[name]) and torch.equal(fs["mu"][name], ps["mu"][name])
    assert fs["count"] == ps["count"] == 4


def test_epilogue_declines_non_fp32_trees():
    params, grad_steps = _epilogue_tree()
    opt = port.fused_adamw(3e-4)
    bf16 = {k: torch.tensor(v).to(torch.bfloat16) for k, v in params.items()}
    grads = {k: torch.tensor(v) for k, v in grad_steps[0].items()}
    assert tfused.maybe_fused_epilogue(opt, grads, opt.init(bf16), bf16, clip_scale=None,
                                       finite=True) is None
    # a plain adamw and an unknown state layout decline too
    fp32 = {k: torch.tensor(v) for k, v in params.items()}
    assert tfused.maybe_fused_epilogue(port.adamw(3e-4), grads, opt.init(fp32), fp32,
                                       clip_scale=None, finite=True) is None
    assert tfused.maybe_fused_epilogue(opt, grads, {"count": 0}, fp32, clip_scale=None,
                                       finite=True) is None


def test_fused_adamw_env_knob(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_FUSED_EPILOGUE", "0")
    opt = port.fused_adamw(1e-3)
    assert opt.fused is False and jfused.fused_adamw(1e-3).fused is False
    params, grad_steps = _epilogue_tree()
    fp32 = {k: torch.tensor(v) for k, v in params.items()}
    grads = {k: torch.tensor(v) for k, v in grad_steps[0].items()}
    assert tfused.maybe_fused_epilogue(opt, grads, opt.init(fp32), fp32, clip_scale=None,
                                       finite=True) is None
    monkeypatch.delenv("ACCELERATE_TPU_FUSED_EPILOGUE")
    assert port.fused_adamw(1e-3).fused is True
    assert port.fused_adamw(1e-3, fused=False).fused is False
    assert port.fused_adamw(1e-3).hyperparams == jfused.fused_adamw(1e-3).hyperparams


# --------------------------------------------------------------------- #
# the slice as a whole
# --------------------------------------------------------------------- #
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2,
             num_heads=4, max_seq_len=64, fused_kernels=True)
MODEL_VARIANTS = {
    "gqa": dict(num_kv_heads=2),
    "qkv_bias_llama3_rope": dict(num_kv_heads=2, qkv_bias=True, rope_scaling=LLAMA3_SCALING,
                                 rope_theta=10000.0),
    "mha": dict(),
}


@pytest.mark.parametrize("variant", sorted(MODEL_VARIANTS))
def test_fused_model_logits_loss_and_grads_match_jax(variant):
    kw = dict(MODEL, **MODEL_VARIANTS[variant])
    jcfg = JaxConfig(**kw)
    jmodel = JaxCausalLM(jcfg)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    params = nn.unbox(jmodel.init_params(jax.random.PRNGKey(0), seq_len=32))
    jlogits = jmodel.apply({"params": params}, jnp.asarray(ids))
    jloss, jgrads = jax.value_and_grad(JaxCausalLM.loss_fn(jmodel))(
        params, {"input_ids": jnp.asarray(ids)})

    model = port.CausalLM(port.TransformerConfig(**kw), device="cpu")
    model.load_state_dict(port.params_from_jax(params, model.config), strict=True)
    tids = torch.from_numpy(ids).long()
    np.testing.assert_allclose(model(tids).detach().numpy(), np.asarray(jlogits), atol=TOL,
                               rtol=TOL)
    tparams = dict(model.named_parameters())
    loss = port.CausalLM.loss_fn(model)(tparams, {"input_ids": tids})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=TOL, rtol=TOL)
    grads = torch.autograd.grad(loss, list(tparams.values()))
    want = port.params_from_jax(jax.tree.map(np.asarray, jgrads), model.config)
    for name, got in zip(tparams, grads):
        scale = float(want[name].abs().max()) + 1e-12
        np.testing.assert_allclose(got.numpy() / scale, want[name].numpy() / scale, atol=TOL,
                                   err_msg=name)


STEPS, BATCH, SEQ, LR = 5, 8, 16, 1e-3
STEP_MODEL = dict(MODEL, num_kv_heads=2)


class TokenDataset:
    def __init__(self, n, vocab, nan_rows=(), seed=0):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(0, vocab, size=(n, SEQ)).astype(np.int32)
        self.mask = np.ones((n, SEQ), np.float32)
        self.mask[list(nan_rows), 3] = np.nan

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "loss_mask": self.mask[i]}


def _run_jax(dataset, params, mixed_precision, clip):
    acc = jax_pkg.Accelerator(mixed_precision=mixed_precision)
    model = JaxCausalLM(JaxConfig(**STEP_MODEL))
    params, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, params),
                                      jfused.fused_adamw(LR),
                                      jax_pkg.DataLoader(dataset, batch_size=BATCH))
    step = acc.unified_step(JaxCausalLM.loss_fn(model), opt, max_grad_norm=clip)
    carry = acc.init_carry(params, opt)
    curve = []
    for batch in loader:
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"]), bool(m["grads_finite"])))
    final = jax.tree.map(np.asarray, carry["params"])
    return curve, port.params_from_jax(final, port.TransformerConfig(**STEP_MODEL))


def _run_port(dataset, params, mixed_precision, clip, snapshots):
    acc = port.Accelerator(mixed_precision=mixed_precision, cpu=True)
    model = port.CausalLM(port.TransformerConfig(**STEP_MODEL), device="cpu")
    model.load_state_dict(port.params_from_jax(params, model.config), strict=True)
    model, opt, loader = acc.prepare(model, port.fused_adamw(LR),
                                     port.DataLoader(dataset, batch_size=BATCH))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=clip)
    carry = acc.init_carry(model, opt)
    curve = []
    for batch in loader:
        snapshots.append({k: p.detach().clone() for k, p in carry["params"].items()})
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"]), bool(m["grads_finite"])))
    return curve, {k: p.detach() for k, p in carry["params"].items()}, carry


def _initial_params():
    model = JaxCausalLM(JaxConfig(**STEP_MODEL))
    return jax.tree.map(np.asarray, nn.unbox(model.init_params(jax.random.PRNGKey(0),
                                                               seq_len=SEQ)))


def _compare(jax_run, port_run, loss_rtol, norm_rtol, param_atol):
    (jcurve, jparams), (pcurve, pparams) = jax_run, port_run[:2]
    assert len(jcurve) == len(pcurve) == STEPS
    for (jl, jn, jf), (pl, pn, pf) in zip(jcurve, pcurve):
        assert jf == pf
        np.testing.assert_allclose(pl, jl, rtol=loss_rtol)
        np.testing.assert_allclose(pn, jn, rtol=norm_rtol)
    assert set(jparams) == set(pparams)
    for name in jparams:
        np.testing.assert_allclose(pparams[name].numpy(), jparams[name].numpy(),
                                   atol=param_atol, err_msg=name)


@pytest.mark.parametrize("clip", [None, 0.5], ids=["no_clip", "clip"])
def test_fused_step_matches_jax_fused_step(clip):
    dataset = TokenDataset(STEPS * BATCH, STEP_MODEL["vocab_size"])
    params = _initial_params()
    port_run = _run_port(dataset, params, "no", clip, [])
    _compare(_run_jax(dataset, params, "no", clip), port_run, 2e-5, 2e-5, 2e-5)
    assert port_run[2]["opt_state"]["count"] == STEPS
    if clip is not None:  # the clip really bound
        assert all(n > clip for _, n, _ in port_run[0])


def test_fused_step_holds_a_non_finite_batch_fp16():
    """fp16 with dynamic loss scaling; batch 2 has a NaN loss mask: both
    packages' fused epilogues hold that step and halve the scale."""
    bad = 2
    dataset = TokenDataset(STEPS * BATCH, STEP_MODEL["vocab_size"], nan_rows=[bad * BATCH])
    params = _initial_params()
    snapshots = []
    port_run = _run_port(dataset, params, "fp16", None, snapshots)
    assert [f for _, _, f in port_run[0]] == [True, True, False, True, True]
    for name, before in snapshots[bad].items():  # the held step changed nothing
        assert torch.equal(before, snapshots[bad + 1][name]), name
    carry = port_run[2]
    assert carry["opt_step"] == STEPS and carry["opt_state"]["count"] == STEPS - 1
    _compare(_run_jax(dataset, params, "fp16", None), port_run, 2e-3, 1e-2, 2e-4)


def test_fused_config_builds_and_prepare_takes_fused_adamw():
    cfg = port.TransformerConfig.tiny(num_layers=1, fused_kernels=True)
    model = port.CausalLM(cfg, device="cpu")
    acc = port.Accelerator(cpu=True)
    model, opt = acc.prepare(model, port.fused_adamw(1e-3))
    assert isinstance(opt.optimizer, tfused.FusedAdamW) and opt.optimizer.fused
    assert opt.opt_state["count"] == 0
    assert set(opt.opt_state["mu"]) == set(dict(model.named_parameters()))
    # the same parameter names as the unfused model: checkpoints interchange
    plain = port.CausalLM(dataclasses.replace(cfg, fused_kernels=False), device="cpu")
    assert set(model.state_dict()) == set(plain.state_dict())
