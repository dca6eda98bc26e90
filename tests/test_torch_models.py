"""The port's CausalLM against the JAX reference, on the CPU in fp32.

The same flax parameters (carried over by ``params_from_jax``) and the
same token ids go through ``accelerate_tpu.models.CausalLM`` and
``accelerate_tpu_torch.CausalLM``; logits, the loss and every parameter
gradient must agree.

Tolerance: fp32 on both sides; the two frameworks sum the same products
in a different order, which moves results by a few fp32 ulps per
reduction. Logits and the loss: 2e-5 absolute + 2e-5 relative. Gradients:
each gradient tensor divided by its largest reference magnitude, then 2e-5
absolute.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.ops.flash_attention import kernel_interpret_mode  # noqa: E402
from accelerate_tpu_torch import CausalLM, TransformerConfig, params_from_jax  # noqa: E402

ATOL = RTOL = 2e-5
LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 16,
}
VARIANTS = {
    "gqa": dict(num_kv_heads=2),
    "mha_llama3_rope": dict(rope_scaling=LLAMA3_SCALING, rope_theta=10000.0),
    "qkv_bias": dict(num_kv_heads=2, qkv_bias=True),
    "sliding_window": dict(num_kv_heads=2, sliding_window=8),
    "tie_embeddings": dict(tie_embeddings=True),
    "unrolled_layers": dict(num_kv_heads=2, scan_layers=False),
    "flash": dict(num_kv_heads=2, attention_impl="flash"),
    "remat_full": dict(num_kv_heads=2, remat="full"),
}


def _tiny(**kw):
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
                num_layers=2, num_heads=4, max_seq_len=64)
    base.update(kw)
    return base


def _jax_setup(kw, seq):
    cfg = JaxConfig(**_tiny(**kw))
    model = JaxCausalLM(cfg)
    with kernel_interpret_mode():
        params = nn.unbox(model.init_params(jax.random.PRNGKey(0), seq_len=seq))
    return cfg, model, params


def _ids(vocab, batch=2, seq=32, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, seq)).astype(np.int32)


def _torch_model(kw, params):
    model = CausalLM(TransformerConfig(**_tiny(**kw)), device="cpu")
    model.load_state_dict(params_from_jax(params, model.config), strict=True)
    return model


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, ref in want.items():
        scale = float(ref.abs().max()) + 1e-12
        np.testing.assert_allclose(
            got[name].numpy() / scale, ref.numpy() / scale, atol=ATOL, err_msg=name
        )


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_loss_and_grads_match_jax(variant):
    kw = VARIANTS[variant]
    seq = 32  # a multiple of 16 for the forced-flash case
    cfg, jmodel, params = _jax_setup(kw, seq)
    ids = _ids(cfg.vocab_size, seq=seq)
    jloss_fn = JaxCausalLM.loss_fn(jmodel)
    with kernel_interpret_mode():
        jlogits = jmodel.apply({"params": params}, jnp.asarray(ids))
        jloss, jgrads = jax.value_and_grad(jloss_fn)(params, {"input_ids": jnp.asarray(ids)})

    model = _torch_model(kw, params)
    tids = torch.from_numpy(ids).long()
    logits = model(tids)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=RTOL)

    tparams = dict(model.named_parameters())
    loss = CausalLM.loss_fn(model)(tparams, {"input_ids": tids})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL, rtol=RTOL)
    names = list(tparams)
    grads = torch.autograd.grad(loss, [tparams[n] for n in names])
    _assert_grads_close(dict(zip(names, grads)),
                        params_from_jax(jax.tree.map(np.asarray, jgrads), model.config))


def test_loss_mask_matches_jax():
    cfg, jmodel, params = _jax_setup(dict(num_kv_heads=2), 16)
    ids = _ids(cfg.vocab_size, seq=16)
    mask = (np.arange(16)[None, :] < np.array([[10], [16]])).astype(np.float32)
    jloss = JaxCausalLM.loss_fn(jmodel)(
        params, {"input_ids": jnp.asarray(ids), "loss_mask": jnp.asarray(mask)}
    )
    model = _torch_model(dict(num_kv_heads=2), params)
    loss = CausalLM.loss_fn(model)(
        dict(model.named_parameters()),
        {"input_ids": torch.from_numpy(ids).long(), "loss_mask": torch.from_numpy(mask)},
    )
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL, rtol=RTOL)


def test_bridge_covers_every_parameter():
    """Both layouts of the flax tree fill the port's state dict exactly."""
    for scan in (True, False):
        kw = dict(num_kv_heads=2, qkv_bias=True, scan_layers=scan)
        _, _, params = _jax_setup(kw, 16)
        model = CausalLM(TransformerConfig(**_tiny(**kw)), device="cpu")
        state = params_from_jax(params, model.config)
        assert set(state) == set(model.state_dict())
        for name, t in model.state_dict().items():
            assert state[name].shape == t.shape, name


def test_bf16_compute_matches_jax_within_bf16_rounding():
    """``dtype="bfloat16"`` with bf16-cast params, as the bf16 train step
    runs them. The two frameworks round at different points (XLA keeps
    fused elementwise chains in fp32, eager torch rounds after each op), so
    the bound is bf16's, not fp32's: bf16 keeps 8 significant bits (one
    unit in the last place is 2**-8 relative), and two layers accumulate a
    few units. Logits and grads: max error over max reference magnitude
    under 2.5e-2 and 5e-2; the fp32 loss: 1e-3 relative."""
    kw = dict(num_kv_heads=2, dtype="bfloat16")
    cfg, jmodel, params = _jax_setup(kw, 32)
    ids = _ids(cfg.vocab_size, seq=32)
    bf16 = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
    jlogits = np.asarray(jmodel.apply({"params": bf16}, jnp.asarray(ids)).astype(jnp.float32))
    jloss, jgrads = jax.value_and_grad(JaxCausalLM.loss_fn(jmodel))(
        bf16, {"input_ids": jnp.asarray(ids)})

    model = _torch_model(kw, params)
    tparams = {k: p.detach().to(torch.bfloat16).requires_grad_(True)
               for k, p in model.named_parameters()}
    tids = torch.from_numpy(ids).long()
    logits = torch.func.functional_call(model, tparams, (tids,)).float().detach().numpy()
    assert np.abs(logits - jlogits).max() <= 2.5e-2 * np.abs(jlogits).max()
    loss = CausalLM.loss_fn(model)(tparams, {"input_ids": tids})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-3)
    grads = torch.autograd.grad(loss, list(tparams.values()))
    want = params_from_jax(
        jax.tree.map(lambda g: np.asarray(g.astype(jnp.float32)), jgrads), model.config)
    for name, got in zip(tparams, grads):
        scale = float(want[name].abs().max()) + 1e-12
        err = float((got.float() - want[name]).abs().max()) / scale
        assert err <= 5e-2, (name, err)


# ---------------------------------------------------------------------- #
# SequenceClassifier (the BERT encoder path)
# ---------------------------------------------------------------------- #
from accelerate_tpu.models.transformer import SequenceClassifier as JaxClassifier  # noqa: E402
from accelerate_tpu_torch import SequenceClassifier  # noqa: E402

CLS_SEQ = 32  # a multiple of the reference's 16-row interpret-mode blocks
CLS_LENS = np.array([CLS_SEQ, 19])  # one full row, one right-padded


def _cls_kw(**kw):
    return _tiny(causal=False, num_kv_heads=4, **kw)


def _cls_setup(kw, seed=0):
    cfg = JaxConfig(**_cls_kw(**kw))
    ids = _ids(cfg.vocab_size, seq=CLS_SEQ, seed=seed)
    mask = (np.arange(CLS_SEQ)[None, :] < CLS_LENS[:, None]).astype(np.int32)
    xla = JaxClassifier(JaxConfig(**_cls_kw(**dict(kw, attention_impl="xla"))))
    params = nn.unbox(xla.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                               jnp.asarray(mask))["params"])
    return cfg, JaxClassifier(cfg), params, ids, mask


def _torch_classifier(kw, params):
    model = SequenceClassifier(TransformerConfig(**_cls_kw(**kw)), device="cpu")
    model.load_state_dict(params_from_jax(params, model.config), strict=True)
    return model


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_classifier_logits_loss_and_grads_match_jax(impl, padded):
    """The port's classifier on weights carried by params_from_jax: on the
    flash route the mask becomes kv_lengths into the plain flash version
    (JAX: its Pallas kernels in interpret mode), on the xla route the dense
    key mask. Logits, loss and every grad at 2e-5."""
    kw = dict(attention_impl=impl)
    cfg, jmodel, params, ids, mask = _cls_setup(kw)
    labels = np.array([1, 0], np.int32)
    batch = {"input_ids": ids, "labels": labels}
    if padded:
        batch["attention_mask"] = mask
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with kernel_interpret_mode():
        jlogits = jmodel.apply({"params": params}, jbatch["input_ids"],
                               jbatch.get("attention_mask"))
        jloss, jgrads = jax.value_and_grad(JaxClassifier.loss_fn(jmodel))(params, jbatch)

    model = _torch_classifier(kw, params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(tbatch["input_ids"], tbatch.get("attention_mask"))
    assert logits.dtype == torch.float32 and logits.shape == (2, 2)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=RTOL)
    tparams = dict(model.named_parameters())
    loss = SequenceClassifier.loss_fn(model)(tparams, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL, rtol=RTOL)
    names = list(tparams)
    grads = torch.autograd.grad(loss, [tparams[n] for n in names])
    _assert_grads_close(dict(zip(names, grads)),
                        params_from_jax(jax.tree.map(np.asarray, jgrads), model.config))


def test_classifier_flash_padding_matches_xla():
    """Mirror of tests/test_models.py::test_classifier_flash_padding_matches_xla:
    a right-padded mask lowered to kv_lengths on the flash route gives the
    dense-mask xla route's logits (2e-5 here, fp32 plain versions on both)."""
    cfg, _, params, ids, _ = _cls_setup(dict(attention_impl="xla"))
    lens = np.array([CLS_SEQ, 21])
    mask = torch.from_numpy((np.arange(CLS_SEQ)[None, :] < lens[:, None]).astype(np.int32))
    tids = torch.from_numpy(ids)
    xla = _torch_classifier(dict(attention_impl="xla"), params)(tids, mask)
    flash = _torch_classifier(dict(attention_impl="flash"), params)(tids, mask)
    np.testing.assert_allclose(flash.detach().numpy(), xla.detach().numpy(),
                               atol=ATOL, rtol=RTOL)


def test_classifier_left_padding_poisons_flash_rows():
    """Mirror of tests/test_models.py::test_classifier_left_padding_poisons_flash_rows:
    a left-padded (non-prefix) row is NaN on the flash route and finite on
    the xla route; the right-padded row is finite on both."""
    _, _, params, ids, _ = _cls_setup(dict(attention_impl="xla"))
    mask = np.ones((2, CLS_SEQ), np.int32)
    mask[1, :5] = 0
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    flash = _torch_classifier(dict(attention_impl="flash"), params)(tids, tmask).detach()
    xla = _torch_classifier(dict(attention_impl="xla"), params)(tids, tmask).detach()
    assert torch.isfinite(flash[0]).all() and torch.isnan(flash[1]).all()
    assert torch.isfinite(xla).all()


def test_classifier_remat_passes_the_mask_through_checkpoint():
    """remat="full" runs each layer under torch.utils.checkpoint with the
    mask and the lengths as arguments: same logits and grads, bit for bit."""
    _, _, params, ids, mask = _cls_setup(dict(attention_impl="xla"))
    batch = {"input_ids": torch.from_numpy(ids), "labels": torch.tensor([0, 1]),
             "attention_mask": torch.from_numpy(mask)}
    for impl in ("xla", "flash"):
        out = []
        for remat in (None, "full"):
            model = _torch_classifier(dict(attention_impl=impl, remat=remat), params)
            tparams = dict(model.named_parameters())
            loss = SequenceClassifier.loss_fn(model)(tparams, batch)
            out.append((loss.detach(), torch.autograd.grad(loss, list(tparams.values()))))
        assert torch.equal(out[0][0], out[1][0])
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_bridge_covers_every_classifier_parameter(scan):
    _, _, params, _, _ = _cls_setup(dict(scan_layers=scan))
    model = SequenceClassifier(TransformerConfig(**_cls_kw(scan_layers=scan)), device="cpu")
    state = params_from_jax(params, model.config)
    assert {"pooler.weight", "pooler.bias", "classifier.weight", "classifier.bias"} <= set(state)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)
