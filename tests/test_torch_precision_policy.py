"""The precision policy's other dtypes and the Accelerator's constructor,
against the JAX reference's, on the CPU.

* ``MixedPrecisionPolicy``: the reference's fields in its order, with its
  defaults (``param_dtype``/``output_dtype`` fp32, ``grad_dtype`` None),
  ``from_precision``'s answers, ``repr`` and equality.
* ``Accelerator.__init__`` takes every argument of the reference's but
  ``compile_plugin`` (queue A10), and an explicit ``mixed_precision_policy``
  replaces the state's.
* The reference's ``test_fp16_loss_scaling_step`` through
  ``mixed_precision_policy=``.
* ``grad_dtype=bfloat16`` (compute bf16) at K 1, K 4 unfused and K 4 fused,
  on the regression toy (adamw) here and on a tiny ``CausalLM`` (sgd at lr
  0.3, 3 optimizer steps) in ``test_torch_precision_policy_lm.py``, against
  the reference's ``unified_step`` under the same policy: each
  microbatch's loss within ``GRAD_BF16_LOSS_TOL`` (relative) and the params
  within ``GRAD_BF16_UPDATE_TOL`` of the update the steps made (||port -
  reference|| / ||reference - start|| over the tree); both about 3x the
  largest reading (``PERF.md``'s parity table: bf16 compute reads the same
  between the packages with an fp32 buffer). The carried buffer is bf16
  (none fused or at K 1), and the run differs from the port's fp32-buffer
  run. The reference's unfused step at K > 1 raises TypeError under a bf16
  ``grad_dtype`` (its ``lax.cond`` branches disagree: the grad norm comes
  out bf16 against the hold branch's fp32 NaN), so the port's unfused run is
  held against the reference's fused one, which the reference computes
  with the same epilogue, and against the port's own fused run bit for bit.
* The same at fp32 compute (``compute_dtype=float32, grad_dtype=bfloat16``),
  where the gradients' rounding is the only bf16 in the step, within the
  tighter ``F32_*`` limits, which the port's run with fp32 gradients fails
  against the same reference run (the toy here, the tiny ``CausalLM`` in
  ``test_torch_precision_policy_lm.py``).
"""

import dataclasses
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.utils.dataclasses import GradientAccumulationPlugin as JaxPlugin  # noqa: E402
from accelerate_tpu.utils.dataclasses import MixedPrecisionPolicy as JaxPolicy  # noqa: E402
from accelerate_tpu_torch.utils.dataclasses import (  # noqa: E402
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
)

BATCH = 8  # divisible by the 8 virtual CPU devices of tests/conftest.py
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64)
SEQ = 16
# port against reference under grad_dtype bf16 (compute bf16): a loss's
# relative difference and the params' over the update, about 3x the largest
# readings (toy loss 3.8e-3; tiny CausalLM update 3.4e-2; PERF.md)
GRAD_BF16_LOSS_TOL = 1.2e-2
GRAD_BF16_UPDATE_TOL = 0.1
# the same at fp32 compute, where bf16 gradient rounding is the only bf16 in
# the step: about 3x the largest reading, each below the control's reading
# (the port's fp32-gradient run against the reference's bf16 one), which
# must fail it (PERF.md's parity table)
F32_TOY_UPDATE_TOL = 6e-4  # reading 2.0e-4; control 8.7e-4 to 1.33e-3
F32_LM_UPDATE_TOL = 2.4e-3  # reading 1.3e-4 (K 1), 8.0e-4 (K 4); control 4.2e-3 to 5.6e-3
F32_LM_LOSS_TOL = 1.2e-5  # reading 3.8e-7 (K 1), 3.7e-6 (K 4); control 3.9e-5 to 2.2e-4


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


def _name(dtype):
    return None if dtype is None else str(jnp.dtype(dtype)) if not isinstance(
        dtype, torch.dtype) else str(dtype).replace("torch.", "")


def test_policy_fields_and_defaults_are_the_reference_s():
    ref = [f.name for f in dataclasses.fields(JaxPolicy)]
    got = [f.name for f in dataclasses.fields(MixedPrecisionPolicy)]
    assert got == ref
    default = MixedPrecisionPolicy()
    for field in ("param_dtype", "compute_dtype", "output_dtype", "grad_dtype"):
        assert _name(getattr(default, field)) == _name(getattr(JaxPolicy(), field)), field
    assert default.param_dtype is torch.float32 and default.output_dtype is torch.float32
    assert default.grad_dtype is None
    for precision in ("no", "bf16", "fp16", "fp8"):
        p, r = MixedPrecisionPolicy.from_precision(precision), JaxPolicy.from_precision(precision)
        for field in ("param_dtype", "compute_dtype", "output_dtype", "grad_dtype", "fp8"):
            want = getattr(r, field)
            assert (_name(getattr(p, field)) == _name(want) if field != "fp8"
                    else p.fp8 == want), (precision, field)
        assert p.uses_loss_scaling == r.uses_loss_scaling


def test_policy_repr_and_equality():
    a = MixedPrecisionPolicy(compute_dtype=torch.bfloat16, grad_dtype=torch.bfloat16)
    assert a == MixedPrecisionPolicy(compute_dtype=torch.bfloat16, grad_dtype=torch.bfloat16)
    assert a != MixedPrecisionPolicy(compute_dtype=torch.bfloat16)
    assert MixedPrecisionPolicy(param_dtype=torch.bfloat16) != MixedPrecisionPolicy()
    assert MixedPrecisionPolicy(output_dtype=torch.bfloat16) != MixedPrecisionPolicy()
    text = repr(a)
    assert text.startswith("MixedPrecisionPolicy(param_dtype=torch.float32, "
                           "compute_dtype=torch.bfloat16, output_dtype=torch.float32, "
                           "grad_dtype=torch.bfloat16, fp8=False")


def test_accelerator_takes_every_reference_argument_but_compile_plugin():
    ref = set(inspect.signature(jax_pkg.Accelerator.__init__).parameters) - {"self"}
    got = set(inspect.signature(port.Accelerator.__init__).parameters) - {"self"}
    assert ref - got == {"compile_plugin"}
    policy = MixedPrecisionPolicy(compute_dtype=torch.bfloat16, grad_dtype=torch.bfloat16)
    acc = port.Accelerator(cpu=True, mixed_precision_policy=policy, device_placement=False,
                           rng_types=["torch"])
    assert acc.state.mixed_precision_policy is policy
    assert acc.device_placement is False and acc.rng_types == ["torch"]
    _reset()
    acc = port.Accelerator(cpu=True)
    assert acc.device_placement is True and acc.rng_types == ["generator"]
    assert acc.state.mixed_precision_policy == MixedPrecisionPolicy()


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


def test_fp16_loss_scaling_step():
    """The reference's test (``tests/test_accelerator.py:142``) on the port:
    an explicit policy with a smaller initial scale through
    ``mixed_precision_policy=``."""
    policy = MixedPrecisionPolicy.from_precision("fp16")
    policy.loss_scale_init = 2.0**8  # keep fp16 backward finite for the toy
    accelerator = port.Accelerator(cpu=True, mixed_precision="fp16",
                                   mixed_precision_policy=policy)
    loader = port.DataLoader(RegressionDataset(16), batch_size=16, shuffle=False)
    params = {"w": torch.tensor(0.0), "b": torch.tensor(0.0)}
    params, opt, prepared = accelerator.prepare(params, port.sgd(0.01), loader)
    step = accelerator.unified_step(port_loss, opt)
    carry = accelerator.init_carry(params, opt)
    assert "loss_scale" in carry
    assert float(carry["loss_scale"].scale) == 2.0**8  # the explicit policy's
    for batch in prepared:
        carry, metrics = step(carry, batch)
    assert bool(metrics["grads_finite"])
    assert float(carry["params"]["w"]) != 0.0


def _policies(grad_dtype, compute=torch.bfloat16):
    """The port's and the reference's policy: ``compute`` (a torch dtype)
    and ``grad_dtype`` (None or bf16)."""
    jcompute = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[compute]
    return (MixedPrecisionPolicy(compute_dtype=compute, grad_dtype=grad_dtype),
            JaxPolicy(compute_dtype=jcompute,
                      grad_dtype=None if grad_dtype is None else jnp.bfloat16))


def _microbatch_losses(metrics) -> list:
    """Each microbatch's loss: the fused step's ``loss_per_microbatch``, an
    unfused call's ``loss``."""
    if "loss_per_microbatch" in metrics:
        return [float(v) for v in np.asarray(metrics["loss_per_microbatch"], np.float64)]
    return [float(metrics["loss"])]


MODES = [(1, False), (4, False), (4, True)]
MODE_IDS = ["k1", "k4_unfused", "k4_fused"]


def _run_toy(K, fused, grad_dtype, ref_fused=None, compute=torch.bfloat16,
             ref_grad_dtype="same"):
    """The port's and the reference's runs under ``compute`` and
    ``grad_dtype`` (the reference's under ``ref_grad_dtype`` when given)."""
    policy, jpolicy = _policies(grad_dtype, compute)
    if ref_grad_dtype != "same":
        jpolicy = _policies(ref_grad_dtype, compute)[1]
    ref_fused = fused if ref_fused is None else ref_fused
    _reset()
    acc = port.Accelerator(cpu=True, mixed_precision_policy=policy,
                           gradient_accumulation_plugin=GradientAccumulationPlugin(
                               num_steps=K, fused=fused))
    params = {"w": torch.tensor(0.0), "b": torch.tensor(0.0)}
    opt, loader = acc.prepare(port.adamw(0.1), port.DataLoader(RegressionDataset(), BATCH))
    step = acc.unified_step(port_loss, opt)
    carry = acc.init_carry(params, opt)
    buffer = carry.get("accum_grads")
    losses = []
    for batch in loader:
        carry, m = step(carry, batch)
        losses += _microbatch_losses(m)
    got = {k: float(v.detach()) for k, v in carry["params"].items()}

    _reset()
    jacc = jax_pkg.Accelerator(mixed_precision_policy=jpolicy,
                               gradient_accumulation_plugin=JaxPlugin(num_steps=K,
                                                                      fused=ref_fused))
    # strongly typed fp32 scalars: weakly typed ones would take the moments
    # to bf16 beside bf16 gradients (JAX's weak-type promotion)
    jparams = {"w": jnp.zeros((), jnp.float32), "b": jnp.zeros((), jnp.float32)}
    jparams, jopt, jloader = jacc.prepare(jparams, optax.adamw(0.1),
                                          jax_pkg.DataLoader(RegressionDataset(), BATCH))
    jstep = jacc.unified_step(jax_loss, jopt)
    jcarry = jacc.init_carry(jparams, jopt)
    jbuffer = jcarry.get("accum_grads")
    jlosses = []
    for batch in jloader:
        jcarry, m = jstep(jcarry, batch)
        jlosses += _microbatch_losses(m)
    want = {k: float(v) for k, v in jcarry["params"].items()}
    return (losses, got, buffer), (jlosses, want, jbuffer)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _update_rel(got, want, start):
    """||got - want|| over ||want - start|| across the whole tree: the
    difference against the update the steps made."""
    diff = sum(float(((got[k].float() - want[k].float()) ** 2).sum()) for k in want)
    step = sum(float(((want[k].float() - start[k].float()) ** 2).sum()) for k in want)
    return (diff / step) ** 0.5


def _check_buffer(buffer, jbuffer, K, fused):
    """The port's carried buffer: none fused or at K 1 (the reference's
    neither), else bf16."""
    if K == 1 or fused:
        assert buffer is None and jbuffer is None
        return
    assert {t.dtype for t in buffer.values()} == {torch.bfloat16}


@pytest.mark.parametrize("K,fused", MODES, ids=MODE_IDS)
def test_grad_dtype_bf16_matches_the_reference_on_the_toy(K, fused):
    (losses, got, buffer), (jlosses, want, jbuffer) = _run_toy(K, fused, torch.bfloat16,
                                                               ref_fused=K > 1)
    _check_buffer(buffer, jbuffer, K, fused)
    assert _rel(losses, jlosses) <= GRAD_BF16_LOSS_TOL
    start = {k: torch.tensor(0.0) for k in got}
    assert _update_rel({k: torch.tensor(v) for k, v in got.items()},
                       {k: torch.tensor(v) for k, v in want.items()}, start) <= GRAD_BF16_UPDATE_TOL


def _toy_update_rel(got, want):
    start = {k: torch.tensor(0.0) for k in want}
    return _update_rel({k: torch.tensor(v) for k, v in got.items()},
                       {k: torch.tensor(v) for k, v in want.items()}, start)


@pytest.mark.parametrize("K,fused", MODES, ids=MODE_IDS)
def test_grad_dtype_bf16_at_fp32_compute_matches_the_reference_on_the_toy(K, fused):
    f32 = torch.float32
    (_, got, buffer), (_, want, jbuffer) = _run_toy(K, fused, torch.bfloat16, ref_fused=K > 1,
                                                    compute=f32)
    _check_buffer(buffer, jbuffer, K, fused)
    assert _toy_update_rel(got, want) <= F32_TOY_UPDATE_TOL
    # the control: fp32 gradients against the same reference run fail it
    (_, full, _), _ = _run_toy(K, fused, None, ref_fused=K > 1, compute=f32,
                               ref_grad_dtype=torch.bfloat16)
    assert _toy_update_rel(full, want) > F32_TOY_UPDATE_TOL


def test_the_reference_s_unfused_bf16_buffer_raises():
    """Why the unfused runs are held against the reference's fused step."""
    with pytest.raises(TypeError, match="cond branches"):
        _run_toy(4, False, torch.bfloat16)
