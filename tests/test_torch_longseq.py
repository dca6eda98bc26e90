"""The long-sequence pair on the CPU: flash against plain attention.

The reference benchmark's ``longseq4k`` and ``longseq_xla4k``
(``accelerate_tpu/benchmarks/registry.py:357-379``) train the ``longseq``
config once with the flash kernels and once with the plain (``xla``)
attention, both under ``remat="full"`` and ``optax.sgd``; the card runs them
at S 4096 (``chip_smoke.py``). Here a tiny config at S 256, from one set
of weights:

* the loss and gradients of one batch through four paths: the port's
  plain attention, the port's flash route (on the CPU its kernels' plain
  versions), the reference's ``xla`` path and the reference's Pallas
  kernels in interpret mode, each gradient within 2e-5 of its tensor's
  largest value;
* two ``unified_step``s with sgd through the port's two paths and the
  reference's ``xla`` path: losses and params within 2e-5 (fp32; sgd at lr
  0.5 moves a weight ~1e-3 a step, so a wrong gradient would show).

The interpreter's io callbacks run neither under ``jax.checkpoint`` (JAX
refuses effects in remat's partial eval) nor in a step sharded over the
test mesh (a side-effecting op cannot be replicated), so the reference's
Pallas path is differentiated by ``jax.value_and_grad`` without remat: a
recompute changes no value, which ``tests/test_torch_remat.py`` holds bit
for bit on the port's side.
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
from accelerate_tpu.ops.flash_attention import kernel_interpret_mode  # noqa: E402

S = 256
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=S, remat="full")
STEPS, LR = 2, 0.5


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


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, MODEL["vocab_size"], size=(2, S)).astype(np.int32)
            for _ in range(STEPS)]


def _jax_model(impl, remat="full"):
    return JaxCausalLM(JaxConfig(**dict(MODEL, attention_impl=impl, remat=remat)))


def _port_model(impl, init):
    model = port.CausalLM(port.TransformerConfig(**dict(MODEL, attention_impl=impl)),
                          device="cpu")
    model.load_state_dict(port.params_from_jax(init, model.config), strict=True)
    return model


def _init():
    return jax.tree.map(np.asarray, nn.unbox(
        JaxCausalLM(JaxConfig(**MODEL)).init_params(jax.random.PRNGKey(0), seq_len=S)))


def test_flash_and_plain_paths_give_the_same_gradients():
    init = _init()
    ids = _batches()[0]
    cfg = port.TransformerConfig(**MODEL)
    runs = {}
    for impl in ("xla", "flash"):
        model = _port_model(impl, init)
        params = dict(model.named_parameters())
        loss = port.CausalLM.loss_fn(model)(params, {"input_ids": torch.from_numpy(ids)})
        grads = torch.autograd.grad(loss, list(params.values()))
        runs[f"port {impl}"] = (float(loss.detach()), dict(zip(params, grads)))
        jmodel = _jax_model(impl, remat="full" if impl == "xla" else None)
        with kernel_interpret_mode():
            jloss, jgrads = jax.value_and_grad(JaxCausalLM.loss_fn(jmodel))(
                jax.tree.map(jnp.asarray, init), {"input_ids": jnp.asarray(ids)})
        runs[f"jax {impl}"] = (float(jloss), port.params_from_jax(
            jax.tree.map(np.asarray, jgrads), cfg))
    want_loss, want = runs["jax xla"]
    for name, (loss, grads) in runs.items():
        np.testing.assert_allclose(loss, want_loss, rtol=2e-5, err_msg=name)
        assert set(grads) == set(want)
        for k, ref in want.items():
            scale = float(ref.abs().max()) + 1e-12
            np.testing.assert_allclose(grads[k].detach().numpy() / scale, ref.numpy() / scale,
                                       atol=2e-5, err_msg=f"{name} {k}")


def _jax_steps(init):
    acc = jax_pkg.Accelerator()
    params, opt = acc.prepare(jax.tree.map(jnp.asarray, init), optax.sgd(LR))
    step = acc.unified_step(JaxCausalLM.loss_fn(_jax_model("xla")), opt, max_grad_norm=1.0)
    carry = acc.init_carry(params, opt)
    losses = []
    for ids in _batches():
        carry, m = step(carry, {"input_ids": jnp.asarray(ids)})
        losses.append(float(m["loss"]))
    return losses, port.params_from_jax(jax.tree.map(np.asarray, carry["params"]),
                                        port.TransformerConfig(**MODEL))


def _port_steps(impl, init):
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(cpu=True)
    model, opt = acc.prepare(_port_model(impl, init), port.sgd(LR))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    losses = []
    for ids in _batches():
        carry, m = step(carry, {"input_ids": torch.from_numpy(ids)})
        losses.append(float(m["loss"]))
    return losses, {k: p.detach().clone() for k, p in carry["params"].items()}


def test_flash_and_plain_paths_train_alike():
    init = _init()
    want_losses, want_params = _jax_steps(init)
    start = port.params_from_jax(init, port.TransformerConfig(**MODEL))
    assert max(float((want_params[k] - v).abs().max()) for k, v in start.items()) > 1e-3
    for impl in ("xla", "flash"):
        losses, params = _port_steps(impl, init)
        np.testing.assert_allclose(losses, want_losses, rtol=2e-5, err_msg=impl)
        for k, v in want_params.items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), atol=2e-5,
                                       err_msg=f"{impl} {k}")
