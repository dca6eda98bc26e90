"""``grad_dtype=bfloat16`` on a tiny ``CausalLM`` (sgd at lr 0.3, 3 optimizer
steps) at K 1, K 4 unfused and K 4 fused, at bf16 and at fp32 compute,
against the reference's ``unified_step`` under the same policy (the limits,
the helpers and why the unfused run is held against the reference's fused
one: ``test_torch_precision_policy.py``). At fp32 compute the gradients'
rounding to bf16 is the only bf16 in the step, so the limits (``F32_LM_*``)
sit below what the port's run with fp32 gradients reads against the same
reference run, and that control must fail them.
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
from test_torch_precision_policy import (  # noqa: E402
    BATCH,
    F32_LM_LOSS_TOL,
    F32_LM_UPDATE_TOL,
    GRAD_BF16_LOSS_TOL,
    GRAD_BF16_UPDATE_TOL,
    MODE_IDS,
    MODEL,
    MODES,
    SEQ,
    _check_buffer,
    _microbatch_losses,
    _policies,
    _rel,
    _reset,
    _update_rel,
)


@pytest.fixture(autouse=True)
def reset_singletons():
    _reset()
    yield
    _reset()


class Tokens:
    def __init__(self, n, seed=0):
        self.ids = np.random.default_rng(seed).integers(
            0, MODEL["vocab_size"], size=(n, SEQ)).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i]}


# the reference's runs by (K, fused, compute, grad_dtype, init, rows): the
# K 4 cases share theirs (both take the reference's fused step)
_REFERENCE_RUNS: dict = {}


def _run_lm(K, fused, grad_dtype, init, dataset, ref_fused=None, reference=True,
            compute=torch.bfloat16):
    """The port's and (``reference``) the reference's runs under ``compute``
    and ``grad_dtype``: each microbatch's loss, the params, the carried
    buffer."""
    policy, jpolicy = _policies(grad_dtype, compute)
    ref_fused = fused if ref_fused is None else ref_fused
    dtype = "bfloat16" if compute == torch.bfloat16 else "float32"
    _reset()
    acc = port.Accelerator(cpu=True, mixed_precision_policy=policy,
                           gradient_accumulation_plugin=GradientAccumulationPlugin(
                               num_steps=K, fused=fused))
    model = port.CausalLM(port.TransformerConfig(**MODEL, dtype=dtype), device="cpu")
    model.load_state_dict(port.params_from_jax(init, model.config), strict=True)
    model, opt, loader = acc.prepare(model, port.sgd(0.3),
                                     port.DataLoader(dataset, batch_size=BATCH))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt)
    carry = acc.init_carry(model, opt)
    buffer = carry.get("accum_grads")
    losses = []
    for batch in loader:
        carry, m = step(carry, batch)
        losses += _microbatch_losses(m)
    params = {k: p.detach().clone() for k, p in carry["params"].items()}
    if not reference:
        return (losses, params, buffer), None
    key = (K, ref_fused, compute, grad_dtype, id(init), len(dataset))
    if key not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[key] = _reference_lm(K, ref_fused, jpolicy, init, dataset, dtype,
                                             model.config)
    return (losses, params, buffer), _REFERENCE_RUNS[key]


def _reference_lm(K, fused, jpolicy, init, dataset, dtype, config):
    _reset()
    jmodel = JaxCausalLM(JaxConfig(**MODEL, dtype=dtype))
    jacc = jax_pkg.Accelerator(mixed_precision_policy=jpolicy,
                               gradient_accumulation_plugin=JaxPlugin(num_steps=K,
                                                                      fused=fused))
    jparams, jopt, jloader = jacc.prepare(jax.tree.map(jnp.asarray, init), optax.sgd(0.3),
                                          jax_pkg.DataLoader(dataset, batch_size=BATCH))
    jstep = jacc.unified_step(JaxCausalLM.loss_fn(jmodel), jopt)
    jcarry = jacc.init_carry(jparams, jopt)
    jbuffer = jcarry.get("accum_grads")
    jlosses = []
    for batch in jloader:
        jcarry, m = jstep(jcarry, batch)
        jlosses += _microbatch_losses(m)
    want = port.params_from_jax(jax.tree.map(np.asarray, jcarry["params"]), config)
    return jlosses, want, jbuffer


def make_init(dtype: str):
    model = JaxCausalLM(JaxConfig(**MODEL, dtype=dtype))
    init = jax.tree.map(np.asarray, nn.unbox(model.init_params(jax.random.PRNGKey(0),
                                                               seq_len=SEQ)))
    return init


@pytest.fixture(scope="module")
def lm_init():
    return make_init("bfloat16")


@pytest.mark.parametrize("K,fused", MODES, ids=MODE_IDS)
def test_grad_dtype_bf16_matches_the_reference_on_a_tiny_causal_lm(K, fused, lm_init):
    dataset = Tokens(K * 3 * BATCH)  # 3 optimizer steps
    (losses, params, buffer), (jlosses, want, jbuffer) = _run_lm(
        K, fused, torch.bfloat16, lm_init, dataset, ref_fused=K > 1)
    _check_buffer(buffer, jbuffer, K, fused)
    start = port.params_from_jax(lm_init, port.TransformerConfig(**MODEL))
    assert _rel(losses, jlosses) <= GRAD_BF16_LOSS_TOL
    assert _update_rel(params, want, start) <= GRAD_BF16_UPDATE_TOL
    if not fused:  # the bf16 buffer reaches the arithmetic: the fp32 buffer's run differs
        (_, full, _), _ = _run_lm(K, fused, None, lm_init, dataset, reference=False)
        assert any(not torch.equal(params[k], full[k]) for k in params)
    if K > 1 and not fused:  # the unfused run is the fused one, bit for bit
        (_, fused_params, _), _ = _run_lm(K, True, torch.bfloat16, lm_init, dataset,
                                          reference=False)
        for k in params:
            assert torch.equal(params[k], fused_params[k]), k


_F32_CONTROLS: dict = {}  # the port's fp32-gradient run at fp32 compute, by K


@pytest.fixture(scope="module")
def f32_init():
    return make_init("float32")


@pytest.mark.parametrize("K,fused", MODES, ids=MODE_IDS)
def test_grad_dtype_bf16_at_fp32_compute_matches_the_reference_on_a_tiny_causal_lm(
        K, fused, f32_init):
    f32 = torch.float32
    dataset = Tokens(K * 3 * BATCH)  # 3 optimizer steps
    (losses, params, buffer), (jlosses, want, jbuffer) = _run_lm(
        K, fused, torch.bfloat16, f32_init, dataset, ref_fused=K > 1, compute=f32)
    _check_buffer(buffer, jbuffer, K, fused)
    start = port.params_from_jax(f32_init, port.TransformerConfig(**MODEL))
    assert _rel(losses, jlosses) <= F32_LM_LOSS_TOL
    assert _update_rel(params, want, start) <= F32_LM_UPDATE_TOL
    # the control: the port's fp32 gradients against the same reference run
    # (fused at K 4: the unfused run is that run bit for bit)
    if K not in _F32_CONTROLS:
        _F32_CONTROLS[K] = _run_lm(K, K > 1, None, f32_init, dataset, reference=False,
                                   compute=f32)[0]
    full_losses, full, _ = _F32_CONTROLS[K]
    assert _rel(full_losses, jlosses) > F32_LM_LOSS_TOL
    assert _update_rel(full, want, start) > F32_LM_UPDATE_TOL
