"""``SequenceClassifier(fused_kernels=True)`` trained, against the JAX
reference's fused classifier, on the CPU (the helpers and the tiny configs
of ``test_torch_fused_classifier.py``):

* the fused layers run the prologue (B5's plain version here), one call a
  layer, and give the unfused classifier's logits within 2e-5;
* a row whose mask is not a prefix is NaN on the flash route, finite on
  the xla route;
* a 5-step ``unified_step`` run (adamw at eps 1e-3, the port's convention
  for step tests, clip 1.0; the dense key mask, since the reference's flash
  kernels in interpret mode do not partition inside its sharded step)
  against the reference's: each step's loss and grad norm within 2e-5
  relative, the params within 2e-5;
* the step record says ``fused_kernels: false``, as the reference's does
  (its classifier ``loss_fn`` sets no such attribute);
* under tp 2 at world 2 over gloo (``debug_launcher``) the fused
  classifier trains as at world 1: losses and grad norms within 2e-5
  relative, params within 2e-5, and ``attn_norm.weight`` of every layer
  is among the leaves whose gradients are partial sums over tp.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import SequenceClassifier as JaxClassifier  # noqa: E402
from accelerate_tpu_torch import SequenceClassifier, TransformerConfig, params_from_jax  # noqa: E402
from accelerate_tpu_torch.models.transformer import tp_partial_names  # noqa: E402
from test_torch_fused_classifier import (  # noqa: E402
    BASE,
    LENS,
    SEQ,
    TOL,
    _close,
    _ids,
    _kw,
    _mask,
    _port_classifier,
    _reference_params,
    _reset,
)

STEPS, BATCH = 5, 8  # BATCH divides the 8 virtual CPU devices of tests/conftest.py


@pytest.fixture(autouse=True)
def reset_singletons():
    _reset()
    yield
    _reset()


def test_the_fused_classifier_runs_the_prologue():
    """The fused layers take the prologue (its plain version here), with
    the same weights as the unfused classifier and the same logits within
    TOL: the fused branch is the path, not a copy of the unfused one."""
    from accelerate_tpu_torch.ops import fused as fused_ops

    kw = _kw("mha", attention_impl="flash")
    ids, mask = _ids(kw["vocab_size"]), _mask(LENS)
    params = _reference_params(kw, ids, mask)
    model = _port_classifier(kw, params)
    plain = _port_classifier(dict(kw, fused_kernels=False), params)
    calls = []
    real = fused_ops.fused_qkv_prologue

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    fused_ops.fused_qkv_prologue = counted
    try:
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).detach()
    finally:
        fused_ops.fused_qkv_prologue = real
    assert len(calls) == BASE["num_layers"]
    want = plain(torch.from_numpy(ids), torch.from_numpy(mask)).detach()
    _close(got.numpy(), want.numpy(), "fused against unfused logits")


def test_a_non_prefix_mask_row_is_nan_on_the_flash_route():
    kw = _kw("gqa")
    ids = _ids(kw["vocab_size"])
    mask = np.ones((2, SEQ), np.int32)
    mask[1, :5] = 0  # left padding: not a prefix
    params = _reference_params(kw, ids, mask)
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    flash = _port_classifier(dict(kw, attention_impl="flash"), params)(tids, tmask).detach()
    xla = _port_classifier(dict(kw, attention_impl="xla"), params)(tids, tmask).detach()
    assert torch.isfinite(flash[0]).all() and torch.isnan(flash[1]).all()
    assert torch.isfinite(xla).all()


class Rows:
    """Right-padded classifier rows from a seed."""

    def __init__(self, n, vocab, seed=0):
        rng = np.random.default_rng(seed)
        lens = rng.integers(5, SEQ + 1, n)
        lens[0] = SEQ
        self.mask = _mask(lens)
        self.ids = rng.integers(4, vocab, (n, SEQ)).astype(np.int32) * self.mask
        self.labels = rng.integers(0, 2, n).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "attention_mask": self.mask[i],
                "labels": self.labels[i]}


def _train_port(kw, params, data, telemetry=False):
    _reset()
    acc = port.Accelerator(cpu=True, telemetry=telemetry)
    model = _port_classifier(kw, params)
    model, opt, loader = acc.prepare(model, port.adamw(1e-3, eps=1e-3),
                                     port.DataLoader(data, batch_size=BATCH))
    step = acc.unified_step(SequenceClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    curve = []
    for batch in loader:
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"])))
    return curve, {k: p.detach().clone() for k, p in carry["params"].items()}, acc


def _train_reference(kw, params, data, telemetry=False):
    _reset()
    acc = jax_pkg.Accelerator(telemetry=telemetry)
    model = JaxClassifier(JaxConfig(**kw))
    jparams, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, params),
                                       optax.adamw(1e-3, eps=1e-3),
                                       jax_pkg.DataLoader(data, batch_size=BATCH))
    step = acc.unified_step(JaxClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(jparams, opt)
    curve = []
    for batch in loader:  # its prologue in Pallas interpret mode, the CPU's default
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"])))
    return curve, jax.tree.map(np.asarray, carry["params"]), acc


@pytest.mark.parametrize("variant", ["mha", "gqa_bias"])
def test_fused_classifier_steps_match_the_reference(variant):
    # the dense key mask: the reference's flash kernels take kernel_interpret_mode,
    # whose callbacks its sharded step cannot partition (the flash route is
    # held by test_fused_classifier_matches_the_reference)
    kw = _kw(variant, attention_impl="xla")
    data = Rows(STEPS * BATCH, kw["vocab_size"])
    params = _reference_params(kw, data.ids[:2], data.mask[:2])
    jcurve, jparams, _ = _train_reference(kw, params, data)
    curve, got, _ = _train_port(kw, params, data)
    assert len(curve) == len(jcurve) == STEPS
    np.testing.assert_allclose(np.array(curve), np.array(jcurve), rtol=TOL)
    want = params_from_jax(jparams, TransformerConfig(**kw))
    start = params_from_jax(params, TransformerConfig(**kw))
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-4  # it moved
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=TOL, err_msg=name)


def test_the_step_record_says_fused_kernels_false_as_the_reference_s():
    kw = _kw("mha", attention_impl="xla")
    data = Rows(BATCH, kw["vocab_size"])
    params = _reference_params(kw, data.ids[:2], data.mask[:2])
    _, _, acc = _train_port(kw, params, data, telemetry=True)
    records = [r for r in acc.telemetry.records if r.get("kind") == "step"]
    assert records and all(r["fused_kernels"] is False for r in records)
    _, _, jacc = _train_reference(kw, params, data, telemetry=True)
    jrecords = [r for r in jacc.telemetry.records if r.get("kind") == "step"]
    assert jrecords and all(r["fused_kernels"] is False for r in jrecords)


def test_the_fused_classifier_under_tp_trains_as_at_world_one(tmp_path):
    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.test_utils.scripts import sharding_workers

    config = dict(causal=False, fused_kernels=True, attention_impl="flash")
    run = dict(model="classifier", config=config, optimizer="adamw", lr=1e-3, eps=1e-3,
               weight_decay=1e-4, steps=3, rows=8, max_grad_norm=1.0)
    runs = [dict(run, name="cls_tp2", plugin=dict(dp_size=1, tp_size=2))]
    debug_launcher(sharding_workers.train_runs_worker, (str(tmp_path), runs),
                   num_processes=2, timeout=60.0)
    sharded = torch.load(os.path.join(tmp_path, "cls_tp2.pt"))
    _reset()
    sharding_workers._train_run(str(tmp_path), dict(run, name="cls_world1", plugin=None))
    whole = torch.load(os.path.join(tmp_path, "cls_world1.pt"))
    np.testing.assert_allclose(sharded["losses"], whole["losses"], rtol=TOL)
    np.testing.assert_allclose(sharded["norms"], whole["norms"], rtol=TOL)
    for name, value in whole["params"].items():
        np.testing.assert_allclose(sharded["params"][name].numpy(), value.numpy(), atol=TOL,
                                   err_msg=name)
    from accelerate_tpu_torch.test_utils.training import TINY_LM

    model = SequenceClassifier(TransformerConfig(**{**TINY_LM, **config}), device="meta")
    partial = tp_partial_names(model)
    layers = TINY_LM["num_layers"]
    assert {f"layers.{i}.attn_norm.weight" for i in range(layers)} <= partial
