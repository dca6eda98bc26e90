"""``SequenceClassifier(fused_kernels=True)`` against the JAX reference's
fused classifier, on the CPU.

The port hands each layer's raw residual stream and its norm scale to the
fused prologue (B5's plain version on the CPU); the reference runs its
Pallas prologue in interpret mode (and its flash kernels under
``kernel_interpret_mode``), as its own tests run them. A tiny config (2
layers, 64 wide, 4 heads; ``H == Hkv`` and GQA, with and without
``qkv_bias``) on right-padded masks:

logits, loss and every gradient within 2e-5 (B5's limit in
``tests/test_torch_fused.py``), each variant once, two on the flash route
(the mask lowered to ``kv_lengths``) and two on the xla route (the dense
key mask). The steps, the
masks' routes, the step record and tp are in
``test_torch_fused_classifier_steps.py``.
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
from accelerate_tpu.models.transformer import SequenceClassifier as JaxClassifier  # noqa: E402
from accelerate_tpu.ops.flash_attention import kernel_interpret_mode  # noqa: E402
from accelerate_tpu_torch import SequenceClassifier, TransformerConfig, params_from_jax  # noqa: E402

TOL = 2e-5
SEQ = 32  # a multiple of the reference's 16-row interpret-mode blocks
LENS = np.array([SEQ, 19])  # one whole row, one right-padded
BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2, num_heads=4,
            max_seq_len=64, causal=False, fused_kernels=True)
VARIANTS = {"mha": dict(num_kv_heads=4), "gqa": dict(num_kv_heads=2),
            "mha_bias": dict(num_kv_heads=4, qkv_bias=True),
            "gqa_bias": dict(num_kv_heads=2, qkv_bias=True)}


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


def _kw(variant, **over):
    return dict(BASE, **VARIANTS[variant], **over)


def _ids(vocab, batch=2, seed=0):
    return np.random.default_rng(seed).integers(4, vocab, size=(batch, SEQ)).astype(np.int32)


def _mask(lens):
    return (np.arange(SEQ)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)


def _reference_params(kw, ids, mask, seed=0):
    model = JaxClassifier(JaxConfig(**dict(kw, attention_impl="xla")))
    with kernel_interpret_mode():
        params = nn.unbox(model.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                                     jnp.asarray(mask))["params"])
    return jax.tree.map(np.asarray, params)  # host copies: the reference's step donates


def _port_classifier(kw, params):
    model = SequenceClassifier(TransformerConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(params, model.config), strict=True)
    return model


def _close(got, want, what):
    scale = float(np.abs(want).max()) + 1e-12
    assert float(np.abs(got - want).max()) / scale <= TOL, what


# each variant once, each route twice (the interpreted flash kernels make a
# case cost 5-20 s)
CASES = [("mha", "flash"), ("gqa_bias", "flash"), ("gqa", "xla"), ("mha_bias", "xla")]


@pytest.mark.parametrize("variant,impl", CASES)
def test_fused_classifier_matches_the_reference(variant, impl):
    kw = _kw(variant, attention_impl=impl)
    ids, mask = _ids(kw["vocab_size"]), _mask(LENS)
    params = _reference_params(kw, ids, mask)
    labels = np.array([1, 0], np.int32)
    jmodel = JaxClassifier(JaxConfig(**kw))
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask),
              "labels": jnp.asarray(labels)}
    with kernel_interpret_mode():
        jlogits = jmodel.apply({"params": params}, jbatch["input_ids"], jbatch["attention_mask"])
        jloss, jgrads = jax.value_and_grad(JaxClassifier.loss_fn(jmodel))(params, jbatch)

    model = _port_classifier(kw, params)
    batch = {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask),
             "labels": torch.from_numpy(labels)}
    logits = model(batch["input_ids"], batch["attention_mask"])
    _close(logits.detach().numpy(), np.asarray(jlogits), "logits")
    tparams = dict(model.named_parameters())
    loss = SequenceClassifier.loss_fn(model)(tparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL, atol=TOL)
    grads = torch.autograd.grad(loss, list(tparams.values()))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model.config)
    assert set(want) == set(tparams)
    for name, got in zip(tparams, grads):
        _close(got.numpy(), want[name].numpy(), name)
