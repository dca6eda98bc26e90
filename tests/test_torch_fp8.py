"""The port's fp8 ops against the JAX reference's, on the CPU.

Mirrors ``tests/test_fp8.py`` (:20-196; the int4 case at :128 belongs to
``utils/quantization.py``, queue A8): ``quantize_fp8`` to e4m3 and e5m2
bit for bit (saturation and an all-zero tensor included); ``fp8_matmul``'s
forward, dx and dw against the reference's ``custom_vjp``; the delayed
state's roll, max and zero history bit for bit, and ``fp8_matmul_delayed``
against current scaling once warm; ``Fp8Dense`` trains; ``convert_model``
keeps the state dict; ``prepare`` converts under ``mixed_precision="fp8"``;
the tiny ``CausalLM(fp8=True)`` against the reference.

Tolerances, from readings over seeds (PERF.md's parity table):
* the ops on the same inputs quantise to the same codes (0 differ), so
  they differ only in the fp32 sum order: 1e-6 of the largest reference
  magnitude (read at most 5.2e-8 over seeds 0-4); dx and dw in bf16, one
  bf16 spacing of the largest, 4e-3 (read 0.0 over seeds 0-7);
* the model, fp32 apart from its fp8 products: logits and loss 1.5e-6
  (read 3.8e-7 on seeds 0-3). Gradients differ where a last-bit
  difference upstream rounds a code of x or of the e5m2 gradient the other
  way (a jump of up to 1/8 of the value at e4m3, 1/4 at e5m2), or moves a
  tensor's amax and with it every code, and the backward spreads it.
  ||port - reference|| / ||reference|| over the gradient tree read 1e-7 to
  8e-6 on 22 of seeds 0-23, 2.8e-3 on seed 1 (387 of 119,104 elements
  beyond 1e-3 of their leaf's largest; worst leaf 4.1e-3) and 0.145 on
  seed 16 (its logits already differ by 3.7 %). The reference against
  itself with every parameter one ulp up reads 0.144 on seed 1: per-tensor
  current scaling amplifies a last bit this far in either package. The
  test holds seeds 0-3, seed 1 among them, to 0.01 for the tree and 0.015
  for the worst leaf, about 3x seed 1's readings.
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
from accelerate_tpu.ops import fp8 as jfp8  # noqa: E402
from accelerate_tpu_torch.models.transformer import Fp8Dense, convert_model  # noqa: E402
from accelerate_tpu_torch.ops import fp8  # noqa: E402
from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy  # noqa: E402

OPS_TOL = 1e-6
BF16_GRAD_TOL = 4e-3
LOGITS_TOL = 1.5e-6
TREE_GRAD_TOL = 0.01
LEAF_GRAD_TOL = 0.015
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64, fp8=True)
FORMATS = {"e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn, fp8.E4M3_MAX),
           "e5m2": (torch.float8_e5m2, jnp.float8_e5m2, fp8.E5M2_MAX)}


@pytest.fixture(autouse=True)
def reset_singletons():
    def reset():
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()

    reset()
    yield
    reset()


def _bits(t):
    return t.view(torch.uint8).numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t).view(np.uint8))


def _close(got, want, tol=OPS_TOL, name=""):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) + 1e-30
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale, want / scale, atol=tol,
                               err_msg=name)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_quantize_fp8_bit_for_bit(fmt):
    tdt, jdt, fmax = FORMATS[fmt]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(10_000) * np.exp(rng.uniform(-12, 6, 10_000))).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    ts, js = fp8._scale_for(tx, fmax), jfp8._scale_for(jx, fmax)
    assert np.float32(ts).tobytes() == np.float32(js).tobytes()
    for scale in (ts, ts * 4):  # x4: a quarter of the range saturates at +-fmax
        codes = fp8.quantize_fp8(tx, tdt, scale)
        jcodes = jfp8.quantize_fp8(jx, jdt, jnp.asarray(np.float32(scale)))
        assert codes.dtype == tdt
        assert np.array_equal(_bits(codes), _bits(jcodes))
    assert float(codes.float().abs().max()) == fmax
    zeros = torch.zeros(64)
    zs = fp8._scale_for(zeros, fmax)
    assert np.float32(zs).tobytes() == np.float32(jfp8._scale_for(jnp.zeros(64), fmax)).tobytes()
    assert np.array_equal(_bits(fp8.quantize_fp8(zeros, tdt, zs)),
                          _bits(jfp8.quantize_fp8(jnp.zeros(64), jdt, jnp.asarray(float(zs)))))
    assert not torch.equal(tx, torch.zeros_like(tx))  # the input was not scaled in place


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fp8_matmul_matches_jax_forward_dx_dw(dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((48, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    g = rng.standard_normal((48, 32)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tw = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, w))
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    jout, vjp = jax.vjp(lambda a, b: jfp8.fp8_matmul(a.astype(jnp.float32),
                                                     b.astype(jnp.float32)), jx, jw)
    jdx, jdw = vjp(jnp.asarray(g))
    out = fp8.fp8_matmul(tx, tw)
    assert out.dtype == torch.float32 and tuple(out.shape) == (48, 32)
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(g))
    assert dx.dtype == dw.dtype == tdt
    _close(out.detach(), jout, name="out")
    tol = OPS_TOL if dtype == "float32" else BF16_GRAD_TOL
    _close(dx.float(), np.asarray(jdx, np.float32), tol=tol, name="dx")
    _close(dw.float(), np.asarray(jdw, np.float32), tol=tol, name="dw")


def test_fp8_matmul_saves_codes_and_scales_only():
    x = torch.randn(16, 32, requires_grad=True)
    w = torch.randn(32, 16, requires_grad=True)
    out = fp8.fp8_matmul(x, w)
    saved = [t for t in out.grad_fn.saved_tensors]
    assert [t.dtype for t in saved] == [torch.float8_e4m3fn, torch.float8_e4m3fn,
                                        torch.float32, torch.float32]
    assert [t.dim() for t in saved] == [2, 2, 0, 0]


def test_delayed_state_bit_for_bit():
    state, jstate = fp8.init_delayed_state(history_len=4), jfp8.init_delayed_state(4)
    assert float(state.scale) == 1.0
    for amax in (0.1, 3.0, 0.5, 2.0, 0.2, 0.0, 7.25):
        state = fp8.update_delayed_state(state, torch.tensor(amax))
        jstate = jfp8.update_delayed_state(jstate, jnp.asarray(amax))
        assert np.array_equal(state.amax_history.numpy(), np.asarray(jstate.amax_history))
        assert state.scale.numpy().tobytes() == np.asarray(jstate.scale).tobytes()
    assert state.amax_history.tolist() == [7.25, 0.0, np.float32(0.2), 2.0]
    zero = fp8.DelayedScaleState(torch.zeros(4), torch.tensor(7.5))
    assert float(fp8.update_delayed_state(zero, torch.tensor(0.0)).scale) == 7.5


def test_fp8_matmul_delayed_matches_current_scaling_when_warm():
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy((rng.standard_normal((64, 32)) / 8).astype(np.float32)).requires_grad_()
    xs, ws = fp8.init_delayed_state(), fp8.init_delayed_state()
    _, xs, ws = fp8.fp8_matmul_delayed(x, w, xs, ws)  # warm-up records the amaxes
    out, xs2, ws2 = fp8.fp8_matmul_delayed(x, w, xs, ws)
    ref = fp8.fp8_matmul(x, w)
    assert torch.equal(out, ref)
    assert torch.equal(xs2.scale, xs.scale) and torch.equal(ws2.scale, ws.scale)
    g = torch.randn(16, 32)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(out, (x, w), g),
                                                 torch.autograd.grad(ref, (x, w), g)))
    jout, _, _ = jfp8.fp8_matmul_delayed(jnp.asarray(x.detach().numpy()),
                                         jnp.asarray(w.detach().numpy()),
                                         *(jfp8.DelayedScaleState(
                                             jnp.asarray(s.amax_history.numpy()),
                                             jnp.asarray(s.scale.numpy())) for s in (xs, ws)))
    _close(out.detach(), jout)


def test_fp8_dense_trains():
    torch.manual_seed(5)
    layer = Fp8Dense(8, 4, False, torch.float32, "cpu", torch.Generator().manual_seed(7))
    x = torch.randn(32, 8)
    y = x @ torch.randn(8, 4)
    opt = torch.optim.Adam(layer.parameters(), lr=3e-2)
    l0 = float(((layer(x) - y) ** 2).mean())
    for _ in range(60):
        opt.zero_grad()
        ((layer(x) - y) ** 2).mean().backward()
        opt.step()
    assert float(((layer(x) - y) ** 2).mean()) < 0.1 * l0


def test_convert_model_keeps_the_state_dict():
    model = port.CausalLM(port.TransformerConfig.tiny(num_layers=2), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert convert_model(model) is model
    after = model.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert model.config.fp8 and model.layers[1].attn.config.fp8
    assert type(model.layers[0].attn.q_proj) is Fp8Dense
    assert type(model.layers[1].mlp.down_proj) is Fp8Dense
    assert type(model.lm_head) is not Fp8Dense
    built = port.CausalLM(port.TransformerConfig.tiny(num_layers=2, fp8=True), device="cpu")
    built.load_state_dict(after, strict=True)  # checkpoints interchange
    ids = torch.randint(0, 1024, (2, 16), generator=torch.Generator().manual_seed(0))
    assert torch.equal(built(ids), model(ids))


def test_prepare_converts_under_fp8_and_policy_flag():
    policy = MixedPrecisionPolicy.from_precision("fp8")
    assert policy.fp8 is True and policy.compute_dtype == torch.bfloat16
    assert MixedPrecisionPolicy.from_precision("bf16").fp8 is False
    jpolicy = jax_pkg.MixedPrecisionPolicy.from_precision("fp8")
    assert jpolicy.fp8 and jpolicy.compute_dtype == jnp.bfloat16
    acc = port.Accelerator(mixed_precision="fp8", cpu=True)
    model = acc.prepare(port.CausalLM(port.TransformerConfig.tiny(num_layers=1), device="cpu"))
    assert model.config.fp8 and type(model.layers[0].mlp.up_proj) is Fp8Dense
    port.AcceleratorState._reset_state(reset_partial_state=True)
    acc = port.Accelerator(mixed_precision="bf16", cpu=True)
    model = acc.prepare(port.CausalLM(port.TransformerConfig.tiny(num_layers=1), device="cpu"))
    assert not model.config.fp8 and type(model.layers[0].mlp.up_proj) is not Fp8Dense


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fp8_causal_lm_matches_jax(seed):
    kw = dict(MODEL, dtype="float32")
    jmodel = JaxCausalLM(JaxConfig(**kw))
    params = jax.tree.map(np.asarray, nn.unbox(jmodel.init_params(jax.random.PRNGKey(seed),
                                                                   seq_len=32)))
    ids = np.random.default_rng(seed).integers(0, kw["vocab_size"], (2, 32)).astype(np.int32)
    jlogits = jmodel.apply({"params": params}, jnp.asarray(ids))
    jloss, jgrads = jax.value_and_grad(JaxCausalLM.loss_fn(jmodel))(
        params, {"input_ids": jnp.asarray(ids)})
    model = port.CausalLM(port.TransformerConfig(**kw), device="cpu")
    model.load_state_dict(port.params_from_jax(params, model.config), strict=True)
    tids = torch.from_numpy(ids).long()
    _close(model(tids).detach(), jlogits, tol=LOGITS_TOL, name="logits")
    tparams = dict(model.named_parameters())
    loss = port.CausalLM.loss_fn(model)(tparams, {"input_ids": tids})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOGITS_TOL)
    grads = dict(zip(tparams, torch.autograd.grad(loss, list(tparams.values()))))
    want = port.params_from_jax(jax.tree.map(np.asarray, jgrads), model.config)
    diff = sum(float((grads[k].double() - want[k].double()).square().sum()) for k in want)
    norm = sum(float(want[k].double().square().sum()) for k in want)
    assert (diff / norm) ** 0.5 <= TREE_GRAD_TOL
    for k in want:
        assert float((grads[k] - want[k]).norm() / want[k].norm()) <= LEAF_GRAD_TOL, k
