"""The port's LoRA/QLoRA training against the JAX reference, on the CPU.

Mirrors the training tests of ``tests/test_adapters.py``
(``test_frozen_base_gradients_identically_zero``,
``test_qlora_int8_loss_close_to_fp32``, ``test_unified_step_adapter_only_carry``
with plain and fused AdamW) on the reference's tiny model and adapters
carried over with ``params_from_jax`` (``tests/test_torch_adapters.py``
holds the rest of that file and the serving side): the adapter gradients
over an int8 base within ``FP32_TOL`` of the reference's, the int8 and fp32
losses, and a bf16 ``unified_step`` over an int8 base whose losses track
the reference's within ``BF16_LOSS_TOL``, the carry holding the adapter
only; the base's gradient does not exist (no base tensor enters
autograd). Then the port's own: under remat each layer's adapter tensors
enter the checkpointed call as inputs (gradients and dropout masks the
same as without remat, bit for bit), and the fused prologue's gate.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu.adapters as jax_adapters  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.utils import quantization as jax_quant  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch import adapters  # noqa: E402
from accelerate_tpu_torch.adapters.runtime import A_KEY, stack_adapter  # noqa: E402
from accelerate_tpu_torch.utils import quantization  # noqa: E402
from test_torch_adapters import (  # noqa: E402
    _CFG,
    _LCFG,
    _PCFG,
    _PLCFG,
    _close,
    _ids,
    _port_lcfg,
    _rand_adapter,
    _to_port,
    reset_port_singletons,
    tiny,
)

BF16_LOSS_TOL = 1e-6  # bf16 unified_step losses against the reference's (read 2.1e-7)

__all__ = ["reset_port_singletons", "tiny"]  # the fixtures this file takes from its sibling


# --------------------------------------------------------------------- #
# training: the frozen base, the adapter-only carry
# --------------------------------------------------------------------- #
def _port_grads(pmodel, base, ad, batch, compute_dtype=None):
    leaves = {(t, k): v.clone().requires_grad_(True) for t, p in ad.items() for k, v in p.items()}
    tree = {t: {k: leaves[(t, k)] for k in p} for t, p in ad.items()}
    loss = adapters.lora_loss_fn(pmodel, base, _PLCFG, compute_dtype=compute_dtype)(tree, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, dict(zip(leaves, grads))


def test_frozen_base_gradients_identically_zero(tiny):
    """The base's gradient does not exist: no base tensor takes part in
    autograd (the reference's stop_gradient makes it zero; here asking for
    it is an error), plain or int8; the adapter's gradients are the
    reference's, nonzero and finite."""
    model, params, pmodel = tiny
    base = {k: v.clone().requires_grad_(True) for k, v in pmodel.state_dict().items()}
    qbase = quantization.quantize_params(
        base, quantization.QuantizationConfig(load_in_8bit=True, min_weight_size=256))
    ad = _rand_adapter(3)
    pad = _to_port(ad)
    batch = {"input_ids": torch.from_numpy(_ids()).long()}
    loss = adapters.lora_loss_fn(pmodel, base, _PLCFG)(pad, batch)
    assert not loss.requires_grad  # nothing in the graph: base detached, adapter frozen
    tree = {t: {k: v.clone().requires_grad_(True) for k, v in p.items()} for t, p in pad.items()}
    loss = adapters.lora_loss_fn(pmodel, base, _PLCFG)(tree, batch)
    assert torch.autograd.grad(loss, list(base.values()), allow_unused=True) == (
        (None,) * len(base))
    assert all(p.grad is None for p in base.values())
    jbatch = {"input_ids": jnp.asarray(_ids())}
    jq = jax_quant.quantize_params(params, jax_quant.QuantizationConfig(load_in_8bit=True,
                                                                        min_weight_size=256))
    _, qgrads = _port_grads(pmodel, qbase, pad, batch, compute_dtype=torch.float32)
    want = jax.grad(jax_adapters.lora_loss_fn(model, jq, _LCFG, compute_dtype=jnp.float32))(
        ad, jbatch)
    for (t, k), g in qgrads.items():
        assert torch.isfinite(g).all() and g.any()
        _close(g, want[t][k])


def test_qlora_int8_loss_close_to_fp32(tiny):
    model, params, pmodel = tiny
    ad = _rand_adapter(4)
    pad = _to_port(ad)
    batch = {"input_ids": torch.from_numpy(_ids()).long()}
    fp = float(adapters.lora_loss_fn(pmodel, pmodel, _PLCFG)(pad, batch))
    qbase = quantization.quantize_params(
        pmodel, quantization.QuantizationConfig(load_in_8bit=True, min_weight_size=256))
    q = float(adapters.lora_loss_fn(pmodel, qbase, _PLCFG, compute_dtype=torch.float32)(pad,
                                                                                        batch))
    assert abs(q - fp) / fp < 0.05, (q, fp)
    jbatch = {"input_ids": jnp.asarray(_ids())}
    jq = jax_quant.quantize_params(params, jax_quant.QuantizationConfig(load_in_8bit=True,
                                                                        min_weight_size=256))
    ref_fp = float(jax_adapters.lora_loss_fn(model, params, _LCFG)(ad, jbatch))
    ref_q = float(jax_adapters.lora_loss_fn(model, jq, _LCFG, compute_dtype=jnp.float32)(
        ad, jbatch))
    _close(np.float32(fp), ref_fp)
    _close(np.float32(q), ref_q)


@pytest.fixture(scope="module")
def reference_qlora_losses():
    """The reference's bf16 unified_step over its int8 base, 5 steps of
    adamw (1e-3, clip 1.0) from its adapter seed 1."""
    import optax

    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    model = JaxCausalLM(_CFG)
    acc = jax_pkg.Accelerator(mixed_precision="bf16")
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    base = acc.prepare(params)
    qbase = jax_quant.quantize_params(base, jax_quant.QuantizationConfig(load_in_8bit=True))
    adapter = jax_adapters.init_adapter(jax.random.PRNGKey(1), _CFG, _LCFG)
    start = jax.tree.map(np.asarray, adapter)
    adapter = acc.prepare(adapter)
    opt = acc.prepare(optax.adamw(1e-3))
    carry = acc.init_carry(adapter, opt)
    step = acc.unified_step(jax_adapters.lora_loss_fn(model, qbase, _LCFG,
                                                      compute_dtype=jnp.bfloat16),
                            max_grad_norm=1.0)
    batch = {"input_ids": jnp.asarray(_ids(seed=2))}
    losses = []
    for _ in range(5):
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    return params, start, losses


@pytest.mark.parametrize("optimizer", ["adamw", "fused_adamw"])
def test_unified_step_adapter_only_carry(optimizer, reference_qlora_losses):
    """Only adapter leaves in the carry through ``unified_step`` (plain and
    fused AdamW), the loss falling over an int8 frozen base, and the
    reference's losses within BF16_LOSS_TOL from the same start."""
    params, start, want = reference_qlora_losses
    acc = port.Accelerator(mixed_precision="bf16", cpu=True)
    model = port.CausalLM(_PCFG, device="cpu")
    model.load_state_dict(port.params_from_jax(params, _PCFG), strict=True)
    model.requires_grad_(False)
    qbase = quantization.quantize_params(model,
                                         quantization.QuantizationConfig(load_in_8bit=True))
    adapter = acc.prepare(_to_port(start))
    adapters.assert_adapter_only(adapter, _PLCFG)
    opt = acc.prepare(port.fused_adamw(1e-3) if optimizer == "fused_adamw" else port.adamw(1e-3))
    carry = acc.init_carry(adapter, opt)
    adapters.assert_adapter_only(carry["params"], _PLCFG)
    step = acc.unified_step(adapters.lora_loss_fn(model, qbase, _PLCFG,
                                                  compute_dtype=torch.bfloat16),
                            max_grad_norm=1.0)
    batch = {"input_ids": torch.from_numpy(_ids(seed=2)).long()}
    losses = []
    for _ in range(5):
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    adapters.assert_adapter_only(carry["params"], _PLCFG)
    assert carry["params"]["q_proj"][A_KEY] is adapter["q_proj"][A_KEY]  # updated in place
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(losses, want, rtol=BF16_LOSS_TOL)
    with pytest.raises(AssertionError):
        adapters.assert_adapter_only({"q_proj": {}, "extra": {}}, _PLCFG)


# --------------------------------------------------------------------- #
# the port's own: remat, dropout, the fused prologue gate
# --------------------------------------------------------------------- #
def test_remat_and_fused_gate_keep_the_adapter_gradients(tiny, monkeypatch):
    """Under remat each layer's adapter tensors enter the checkpointed call
    as inputs: the adapter gradients equal those without remat bit for bit;
    with dropout the recompute draws the same masks. A q/v adapter runs the
    unfused chain under ``fused_kernels`` (same loss as without)."""
    import dataclasses

    _, _, pmodel = tiny
    pad = _to_port(_rand_adapter(8))
    batch = {"input_ids": torch.from_numpy(_ids()).long()}
    base = dict(pmodel.named_parameters())
    want_loss, want = _port_grads(pmodel, base, pad, batch)
    drop = adapters.LoraConfig(rank=4, alpha=8.0, target_modules=("q_proj", "v_proj"),
                               dropout=0.25)
    for remat in ("dots",):  # a selective policy: its context keeps the delta's bmms too
        model = port.CausalLM(dataclasses.replace(_PCFG, remat=remat), device="cpu")
        model.load_state_dict(pmodel.state_dict())
        loss, got = _port_grads(model, base, pad, batch)
        assert torch.equal(loss, want_loss)
        assert all(torch.equal(got[k], want[k]) for k in want), remat
        tree = {t: {k: v.clone().requires_grad_(True) for k, v in p.items()}
                for t, p in pad.items()}
        dbatch = dict(batch, dropout_seed=3)
        losses = [adapters.lora_loss_fn(m, base, drop)(tree, dbatch) for m in (pmodel, model)]
        assert torch.equal(losses[0], losses[1]) and not torch.equal(losses[0], want_loss)
        g0, g1 = (torch.autograd.grad(lo, [tree["q_proj"][A_KEY]])[0] for lo in losses)
        assert torch.equal(g0, g1)
    # the fused prologue's gate, with its shape gate forced open on the CPU
    # (where the kernel's plain version runs): a q/v adapter takes the
    # unfused chain, an o_proj-only adapter keeps the prologue
    from accelerate_tpu_torch.models import transformer

    calls = []
    prologue = transformer.fused_ops.fused_qkv_prologue
    monkeypatch.setattr(transformer.fused_ops, "prologue_supported", lambda *a, **k: True)
    monkeypatch.setattr(transformer.fused_ops, "fused_qkv_prologue",
                        lambda *a, **k: calls.append(1) or prologue(*a, **k))
    fused = port.CausalLM(dataclasses.replace(_PCFG, fused_kernels=True), device="cpu")
    fused.load_state_dict(pmodel.state_dict())
    loss, _ = _port_grads(fused, base, pad, batch)
    assert calls == [] and torch.equal(loss, want_loss)
    o_cfg = jax_adapters.LoraConfig(rank=4, alpha=8.0, target_modules=("o_proj",))
    o_pad = _to_port(_rand_adapter(9, o_cfg))
    state = adapters.build_lora_state(o_pad, _port_lcfg(o_cfg), 2)
    with torch.no_grad():
        got, want_o = fused(batch["input_ids"], lora=state), pmodel(batch["input_ids"], lora=state)
    assert len(calls) == _PCFG.num_layers
    _close(got, want_o.numpy())
    assert stack_adapter(pad)["q_proj"][A_KEY].shape == (_PCFG.num_layers, 1, 128, 4)
