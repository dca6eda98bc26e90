"""The port's train step against the JAX reference's, on the CPU.

Five calls of ``Accelerator.unified_step`` on a tiny ``CausalLM`` with the
port's ``adamw`` against the reference's ``unified_step`` with
``optax.adamw``: the same initial weights (carried by ``params_from_jax``),
the same token batches through each package's prepared ``DataLoader``.
The loss curve, the gradient norms and the final parameters must agree.

Tolerances: fp32 runs, 2e-5 relative on losses and grad norms and 2e-5
absolute on parameters (lr 1e-3, so five steps move a weight by at most
~5e-3 and the two packages differ only by summation order). The fp16 run
holds both packages to fp16 compute: 2e-3 relative on losses, 1e-2 on
grad norms and 2e-4 absolute on parameters; the held step itself must
leave the port's parameters bitwise unchanged.
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

STEPS = 5
BATCH = 8  # divisible by the 8 virtual CPU devices of tests/conftest.py
SEQ = 16
LR = 1e-3
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64)


@pytest.fixture(autouse=True)
def reset_port_singletons():
    def reset():
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()

    reset()
    yield
    reset()


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


def _run_jax(dataset, params, mixed_precision, accum, clip):
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    acc = jax_pkg.Accelerator(mixed_precision=mixed_precision,
                              gradient_accumulation_steps=accum)
    model = JaxCausalLM(JaxConfig(**MODEL))
    loader = jax_pkg.DataLoader(dataset, batch_size=BATCH)
    params, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, params),
                                      optax.adamw(LR), loader)
    step = acc.unified_step(JaxCausalLM.loss_fn(model), opt, max_grad_norm=clip)
    carry = acc.init_carry(params, opt)
    curve = []
    for batch in loader:
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"]), bool(m["grads_finite"])))
    final = jax.tree.map(np.asarray, carry["params"])
    return curve, port.params_from_jax(final, port.TransformerConfig(**MODEL))


def _run_port(dataset, params, mixed_precision, accum, clip, snapshots=None):
    acc = port.Accelerator(mixed_precision=mixed_precision,
                           gradient_accumulation_steps=accum, cpu=True)
    model = port.CausalLM(port.TransformerConfig(**MODEL), device="cpu")
    model.load_state_dict(port.params_from_jax(params, model.config), strict=True)
    loader = port.DataLoader(dataset, batch_size=BATCH)
    model, opt, loader = acc.prepare(model, port.adamw(LR), loader)
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=clip)
    carry = acc.init_carry(model, opt)
    curve = []
    for batch in loader:
        if snapshots is not None:
            snapshots.append({k: p.detach().clone() for k, p in carry["params"].items()})
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"]), bool(m["grads_finite"])))
    return curve, {k: p.detach() for k, p in carry["params"].items()}, carry


def _initial_params():
    model = JaxCausalLM(JaxConfig(**MODEL))
    params = nn.unbox(model.init_params(jax.random.PRNGKey(0), seq_len=SEQ))
    return jax.tree.map(np.asarray, params)


def _compare(jax_run, port_run, loss_rtol, norm_rtol, param_atol):
    (jcurve, jparams), (pcurve, pparams) = jax_run, port_run[:2]
    assert len(jcurve) == len(pcurve) == STEPS
    for (jl, jn, jf), (pl, pn, pf) in zip(jcurve, pcurve):
        assert jf == pf
        np.testing.assert_allclose(pl, jl, rtol=loss_rtol)
        np.testing.assert_allclose(pn, jn, rtol=norm_rtol, equal_nan=True)
    assert set(jparams) == set(pparams)
    for name in jparams:
        np.testing.assert_allclose(pparams[name].numpy(), jparams[name].numpy(),
                                   atol=param_atol, err_msg=name)


@pytest.mark.parametrize("accum,clip", [(1, None), (1, 0.5), (2, None)],
                         ids=["no_clip", "clip", "accum2"])
def test_five_steps_match_jax(accum, clip):
    dataset = TokenDataset(STEPS * BATCH, MODEL["vocab_size"])
    params = _initial_params()
    jax_run = _run_jax(dataset, params, "no", accum, clip)
    port_run = _run_port(dataset, params, "no", accum, clip)
    _compare(jax_run, port_run, 2e-5, 2e-5, 2e-5)
    if clip is not None:  # the clip really bound
        assert all(n > clip for _, n, _ in jax_run[0])
    if accum == 2:
        assert port_run[2]["opt_step"] == STEPS // 2
        assert np.isnan(port_run[0][0][1])  # no norm on an accumulating call


def test_non_finite_batch_holds_params_fp16():
    """fp16 with dynamic loss scaling; batch 2 carries a NaN loss mask, so
    its gradients are non-finite: both packages skip that update and halve
    the loss scale, then train on."""
    bad = 2
    dataset = TokenDataset(STEPS * BATCH, MODEL["vocab_size"], nan_rows=[bad * BATCH])
    params = _initial_params()
    jax_run = _run_jax(dataset, params, "fp16", 1, None)
    snapshots = []
    port_run = _run_port(dataset, params, "fp16", 1, None, snapshots)
    assert [f for _, _, f in port_run[0]] == [True, True, False, True, True]
    for name, before in snapshots[bad].items():  # the held step changed nothing
        assert torch.equal(before, snapshots[bad + 1][name]), name
    carry = port_run[2]
    assert float(carry["loss_scale"].scale) == 2.0**15 / 2
    assert carry["opt_step"] == STEPS and carry["opt_state"]["count"] == STEPS - 1
    _compare(jax_run, port_run, 2e-3, 1e-2, 2e-4)


def test_prepared_loader_matches_jax_batches():
    """Shuffled, with a short tail wrapped to a full batch: the port's
    prepared loader yields the reference's batches, epoch by epoch."""
    dataset = TokenDataset(20, MODEL["vocab_size"])
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jloader = jax_pkg.Accelerator().prepare(
        jax_pkg.DataLoader(dataset, batch_size=BATCH, shuffle=True))
    ploader = port.Accelerator(cpu=True).prepare(
        port.DataLoader(dataset, batch_size=BATCH, shuffle=True))
    assert len(jloader) == len(ploader) == 3
    for epoch in range(2):
        jloader.set_epoch(epoch)
        ploader.set_epoch(epoch)
        jbatches = [np.asarray(b["input_ids"]) for b in jloader]
        pbatches = [b["input_ids"].numpy() for b in ploader]
        assert len(jbatches) == len(pbatches) == 3
        for jb, pb in zip(jbatches, pbatches):
            np.testing.assert_array_equal(pb, jb)


class PairDataset:
    """Right-padded rows of a BERT-shaped task: ids, attention_mask, label."""

    def __init__(self, n, vocab, seq=SEQ, seed=0):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(1, vocab, size=(n, seq)).astype(np.int32)
        lens = rng.integers(4, seq + 1, size=n)
        self.mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
        self.ids *= self.mask
        self.labels = rng.integers(0, 2, size=n).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "attention_mask": self.mask[i],
                "labels": self.labels[i]}


def _collate(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


@pytest.mark.parametrize("drop_last", [False, True], ids=["tail_wraps", "drop_last"])
def test_prepared_torch_loader_matches_jax_batches(drop_last):
    """A shuffled ``torch.utils.data.DataLoader`` (no ``shuffle`` attribute:
    its sampler is a RandomSampler) prepared by the port yields the
    reference's batches, epoch by epoch, and the same ``remainder`` for the
    short tail the reference wraps around."""
    from torch.utils.data import DataLoader as TorchLoader

    dataset = TokenDataset(21, MODEL["vocab_size"])
    make = lambda: TorchLoader(dataset, batch_size=BATCH, shuffle=True,  # noqa: E731
                               drop_last=drop_last, collate_fn=_collate)
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jloader = jax_pkg.Accelerator().prepare(make())
    ploader = port.Accelerator(cpu=True).prepare(make())
    n = 2 if drop_last else 3
    assert len(jloader) == len(ploader) == n
    for epoch in range(2):
        jloader.set_epoch(epoch)
        ploader.set_epoch(epoch)
        jbatches = [np.asarray(b["input_ids"]) for b in jloader]
        pbatches = [b["input_ids"].numpy() for b in ploader]
        assert len(jbatches) == len(pbatches) == n
        for jb, pb in zip(jbatches, pbatches):
            np.testing.assert_array_equal(pb, jb)
        assert ploader.remainder == jloader.remainder == (0 if drop_last else 21 - 2 * BATCH)
    assert not np.array_equal(pbatches[0], dataset.ids[:BATCH])  # shuffled


CLS_MODEL = dict(MODEL, causal=False, num_kv_heads=4)


def _run_classifier_jax(dataset, params, schedule_args):
    from accelerate_tpu.models.transformer import SequenceClassifier as JaxClassifier

    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    acc = jax_pkg.Accelerator()
    model = JaxClassifier(JaxConfig(**CLS_MODEL))
    schedule = optax.warmup_cosine_decay_schedule(*schedule_args)
    params, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, params),
                                      optax.adamw(schedule, weight_decay=0.01),
                                      jax_pkg.DataLoader(dataset, batch_size=BATCH))
    step = acc.unified_step(JaxClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(params, opt)
    curve = []
    for batch in loader:
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"]), bool(m["grads_finite"])))
    final = jax.tree.map(np.asarray, carry["params"])
    return curve, port.params_from_jax(final, port.TransformerConfig(**CLS_MODEL))


def test_classifier_five_steps_match_jax():
    """Five unified_steps of SequenceClassifier.loss_fn on right-padded
    rows with adamw(warmup_cosine_decay_schedule(...), weight_decay=0.01)
    and clip 1.0 (the examples' optimizer): losses, grad norms and final
    params at 2e-5."""
    from accelerate_tpu.models.transformer import SequenceClassifier as JaxClassifier

    dataset = PairDataset(STEPS * BATCH, MODEL["vocab_size"])
    jmodel = JaxClassifier(JaxConfig(**CLS_MODEL))
    sample = {k: jnp.asarray(v[:1]) for k, v in _collate([dataset[0]]).items()}
    params = jax.tree.map(np.asarray, nn.unbox(jmodel.init(
        jax.random.PRNGKey(0), sample["input_ids"], sample["attention_mask"])["params"]))
    schedule_args = (0.0, LR, 2, STEPS)
    jax_run = _run_classifier_jax(dataset, params, schedule_args)

    acc = port.Accelerator(cpu=True)
    model = port.SequenceClassifier(port.TransformerConfig(**CLS_MODEL), device="cpu")
    model.load_state_dict(port.params_from_jax(params, model.config), strict=True)
    model, opt, loader = acc.prepare(
        model, port.adamw(port.warmup_cosine_decay_schedule(*schedule_args), weight_decay=0.01),
        port.DataLoader(dataset, batch_size=BATCH))
    step = acc.unified_step(port.SequenceClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    curve = []
    for batch in loader:
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"]), bool(m["grads_finite"])))
    _compare(jax_run, (curve, {k: p.detach() for k, p in carry["params"].items()}),
             2e-5, 2e-5, 2e-5)
    assert acc.step == STEPS and carry["opt_state"]["count"] == STEPS


@pytest.mark.parametrize("args", [
    (0.0, 2e-4, 256, 1024),  # the examples' schedule: 16384 rows, batch 16, one epoch
    (0.0, 1e-3, 2, 12),
    (1e-5, 3e-4, 7, 33, 1e-6, 2.0),
], ids=["examples", "short", "end_value_exponent"])
def test_warmup_cosine_decay_schedule_matches_optax(args):
    """The port's schedule equals optax's at every step of a run and past
    its end, to one float32 ulp of the peak (optax's float32 cosine is not
    correctly rounded, the port's is)."""
    want = optax.warmup_cosine_decay_schedule(*args)
    got = port.warmup_cosine_decay_schedule(*args)
    ulp = np.spacing(np.float32(args[1]))
    for count in range(args[3] + 5):
        assert abs(got(count) - float(want(count))) <= ulp, count
