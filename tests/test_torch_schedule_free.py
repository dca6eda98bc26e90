"""``schedule_free_adamw`` and ``schedule_free_eval_params`` against optax's
(``optax.contrib``, which the reference's schedule-free example takes them
from), on the CPU.

* 10 steps on random fp32 leaves, with and without warmup and weight decay:
  the params, ``z`` and the eval params each within 1e-6 of optax's,
  relative to the leaf's largest value (XLA:CPU's fp32 ``sqrt`` is not
  correctly rounded: 1 ulp apart from PyTorch's in ~0.6 % of elements); the
  scalar fields exact, ``step_count`` from 1 as optax's.
* One tiny-classifier ``unified_step`` run (clip 1.0, eps 1e-3 as the
  port's step tests take it) against the reference's with
  ``optax.contrib.schedule_free_adamw``: losses and grad norms within 2e-5
  relative, the params and the eval params within 2e-5.
* ``save_state``/``load_state`` (the chunked checkpoint) into a fresh
  accelerator and model: every tensor and count of the state bit for bit,
  and the next step equal bit for bit to the uninterrupted run's; the state
  through ``dist_checkpoint.save_sharded_tree``/``load_sharded_tree``
  bit for bit.
* ``prepare`` takes it as a plain optimizer (the fused AdamW epilogue does
  not apply), and the package's top level exports both names (the
  examples import them from there).
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
from accelerate_tpu.models.transformer import SequenceClassifier as JaxClassifier  # noqa: E402
from accelerate_tpu_torch import SequenceClassifier, TransformerConfig, params_from_jax  # noqa: E402
from accelerate_tpu_torch.optimizer import ScheduleFreeAdamW  # noqa: E402

REL = 1e-6
TOL = 2e-5
SHAPES = {"w": (7, 13), "b": (13,), "s": ()}
CLS = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=64, causal=False, attention_impl="xla")
SEQ, BATCH, STEPS = 16, 8, 5


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


def _rel_close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale
    assert err <= REL, (what, err)


@pytest.mark.parametrize("warmup,wd", [(None, 0.0), (3, 0.0), (None, 0.05), (4, 0.01)],
                         ids=["plain", "warmup", "decay", "warmup_decay"])
def test_schedule_free_matches_optax(warmup, wd):
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jopt = optax.contrib.schedule_free_adamw(2e-2, warmup_steps=warmup, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    opt = port.schedule_free_adamw(2e-2, warmup_steps=warmup, weight_decay=wd)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = opt.init(tp)
    assert ts["step_count"] == int(js.step_count) == 1
    for step in range(10):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        updates, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply_({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        for k in SHAPES:
            _rel_close(tp[k].numpy(), jp[k], f"params {k} step {step}")
            _rel_close(ts["z"][k].numpy(), js.z[k], f"z {k} step {step}")
    assert ts["step_count"] == int(js.step_count) == 11
    assert ts["base_optimizer_state"]["count"] == 10
    for field in ("b1", "weight_sum", "max_lr"):
        _rel_close(float(ts[field]), float(getattr(js, field)), field)
    jeval = optax.contrib.schedule_free_eval_params(js, jp)
    teval = port.schedule_free_eval_params(ts, tp)
    for k in SHAPES:
        _rel_close(teval[k].numpy(), jeval[k], f"eval {k}")
    with pytest.raises(ValueError):
        port.schedule_free_eval_params({"count": 0}, tp)


def test_prepare_takes_it_as_a_plain_optimizer():
    acc = port.Accelerator(cpu=True)
    opt = acc.prepare(port.schedule_free_adamw(1e-3))
    assert isinstance(opt, port.AcceleratedOptimizer)
    assert isinstance(opt.optimizer, ScheduleFreeAdamW)
    assert not getattr(opt.optimizer, "fused", False)  # no fused epilogue
    assert "schedule_free_adamw" in port.__all__ and "schedule_free_eval_params" in port.__all__


class Rows:
    def __init__(self, n, vocab, seed=0):
        rng = np.random.default_rng(seed)
        lens = rng.integers(4, SEQ + 1, n)
        self.mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.int32)
        self.ids = rng.integers(4, vocab, (n, SEQ)).astype(np.int32) * self.mask
        self.labels = rng.integers(0, 2, n).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "attention_mask": self.mask[i],
                "labels": self.labels[i]}


def _init():
    model = JaxClassifier(JaxConfig(**CLS))
    data = Rows(STEPS * BATCH, CLS["vocab_size"])
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.asarray(data.ids[:2]),
                                 jnp.asarray(data.mask[:2]))["params"])
    return jax.tree.map(np.asarray, params), data


def _port_run(params, data, steps=None, save_at=None, out=None):
    acc = port.Accelerator(cpu=True)
    model = SequenceClassifier(TransformerConfig(**CLS), device="cpu")
    model.load_state_dict(params_from_jax(params, model.config), strict=True)
    model, opt, loader = acc.prepare(
        model, port.schedule_free_adamw(1e-2, warmup_steps=2, weight_decay=0.01, eps=1e-3),
        port.DataLoader(data, batch_size=BATCH))
    step = acc.unified_step(SequenceClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    curve = []
    for i, batch in enumerate(loader):
        if steps is not None and i == steps:
            break
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"])))
        if save_at is not None and i + 1 == save_at:
            acc.save_state(out, carry=carry)
    return acc, model, opt, carry, curve


def test_a_classifier_run_matches_the_reference():
    params, data = _init()
    acc = jax_pkg.Accelerator()
    jmodel = JaxClassifier(JaxConfig(**CLS))
    jparams, jopt, jloader = acc.prepare(
        jax.tree.map(jnp.asarray, params),
        optax.contrib.schedule_free_adamw(1e-2, warmup_steps=2, weight_decay=0.01, eps=1e-3),
        jax_pkg.DataLoader(data, batch_size=BATCH))
    jstep = acc.unified_step(JaxClassifier.loss_fn(jmodel), jopt, max_grad_norm=1.0)
    jcarry = acc.init_carry(jparams, jopt)
    jcurve = []
    for batch in jloader:
        jcarry, m = jstep(jcarry, batch)
        jcurve.append((float(m["loss"]), float(m["grad_norm"])))
    jeval = optax.contrib.schedule_free_eval_params(jcarry["opt_state"], jcarry["params"])
    cfg = TransformerConfig(**CLS)
    want = params_from_jax(jax.tree.map(np.asarray, jcarry["params"]), cfg)
    want_eval = params_from_jax(jax.tree.map(np.asarray, jeval), cfg)

    _reset()
    _, model, _, carry, curve = _port_run(params, data)
    assert len(curve) == len(jcurve) == STEPS
    np.testing.assert_allclose(np.array(curve), np.array(jcurve), rtol=TOL)
    got_eval = port.schedule_free_eval_params(carry["opt_state"], carry["params"])
    start = params_from_jax(params, cfg)
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-3  # it moved
    for name in want:
        np.testing.assert_allclose(carry["params"][name].detach().numpy(), want[name].numpy(),
                                   atol=TOL, err_msg=name)
        np.testing.assert_allclose(got_eval[name].numpy(), want_eval[name].numpy(), atol=TOL,
                                   err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), k
        else:
            assert x == y, k


def test_the_state_round_trips_through_a_checkpoint_bit_for_bit(tmp_path):
    params, data = _init()
    out = str(tmp_path / "ckpt")
    _, _, _, straight, _ = _port_run(params, data, steps=4)
    _reset()
    _, _, _, carry, _ = _port_run(params, data, steps=3, save_at=3, out=out)
    saved = {k: v for k, v in _flat(carry["opt_state"]).items()}
    _reset()
    # a fresh accelerator and a model from other weights, the state loaded
    acc = port.Accelerator(cpu=True)
    model = SequenceClassifier(TransformerConfig(**CLS), device="cpu",
                               generator=torch.Generator().manual_seed(7))
    model, opt, loader = acc.prepare(
        model, port.schedule_free_adamw(1e-2, warmup_steps=2, weight_decay=0.01, eps=1e-3),
        port.DataLoader(data, batch_size=BATCH))
    step = acc.unified_step(SequenceClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    fresh = acc.init_carry(model, opt)
    fresh = acc.load_state(out, carry=fresh)
    loaded = _flat(fresh["opt_state"])
    assert set(loaded) == set(saved)
    for k, v in saved.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(loaded[k], v), k
        else:
            assert int(loaded[k]) == v, k
    batch = list(acc.skip_first_batches(loader, 3))[0]
    fresh, _ = step(fresh, batch)
    for k, v in straight["params"].items():
        assert torch.equal(fresh["params"][k].detach(), v.detach()), k
    _same(fresh["opt_state"], straight["opt_state"])

    from accelerate_tpu_torch import dist_checkpoint

    path = str(tmp_path / "tree")
    dist_checkpoint.save_sharded_tree(straight["opt_state"], path)
    template = port.schedule_free_adamw(1e-2).init(
        {k: torch.zeros_like(v) for k, v in straight["params"].items()})
    back = dist_checkpoint.load_sharded_tree(template, path)
    for k, v in _flat(straight["opt_state"]).items():
        got = _flat(back)[k]
        assert (torch.equal(torch.as_tensor(got), torch.as_tensor(v))
                if isinstance(v, torch.Tensor) else int(got) == v), k
