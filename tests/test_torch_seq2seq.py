"""The port's ``Seq2SeqLM`` against the JAX reference's, on the CPU: the
mirrors of ``tests/test_seq2seq.py``, each on both packages.

The tiny model of that file (vocab 64, width 64, MLP 128, 2 + 2 layers of
4 heads, 32 positions, tied) with the reference's weights carried by
``params_from_jax``: the forward's logits within ``TOL`` of the
reference's (relative to the largest logit), masked source positions that
change nothing, the copy task through ``unified_step`` (the reference's
Adam at 3e-3, the port's ``adamw`` without decay, ``remat="dots"``, 40 of
its 60 steps; the loss curve held step by step against the reference's
within ``COPY_TOL`` and collapsing as there), the
``t5_base`` preset, the forced-causal decoder, cached greedy ``generate``
against the full-recompute loop and the reference's tokens, and
``generate``'s bounds. The sharded mirror (``test_sharded_training_
compiles``) is in ``test_torch_zoo_sharded.py``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu.models import Seq2SeqLM as JaxSeq2Seq  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.models import Seq2SeqLM, count_params  # noqa: E402

TOL = 2e-5
# the copy task's loss a step against the reference's, relative to the
# largest: 40 adam steps of two summation orders (read 8.3e-6). 40 of the
# reference's 60 steps: the loss has fallen to 0.05 of its start by then
COPY_TOL = 3e-5
COPY_STEPS = 40
TINY = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
            num_decoder_layers=2, num_heads=4, max_seq_len=32, tie_embeddings=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: beside the suite's other workers,
    torch's threads oversubscribe the cores (the copy task read 75.7 s at
    8 threads beside five busy workers, 13.2 s alone at 1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pair(seed=0, src_len=8, tgt_len=7, **kw):
    """The reference model and its params (init on ``seed``), and the
    port's model carrying them."""
    cfg = dict(TINY, **kw)
    jm = JaxSeq2Seq(JaxConfig(**cfg))
    params = nn.unbox(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, src_len), jnp.int32),
                              jnp.zeros((1, tgt_len), jnp.int32))["params"])
    pm = Seq2SeqLM(port.TransformerConfig(**cfg), device="cpu")
    pm.load_state_dict(port.params_from_jax(params, pm.config), strict=True)
    return jm, params, pm.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def test_forward_shapes_and_finite(tiny):
    jm, params, pm = tiny
    rng = np.random.default_rng(0)
    src, tgt = rng.integers(1, 64, (2, 12)), rng.integers(1, 64, (2, 7))
    with torch.no_grad():
        logits = pm(_t(src), _t(tgt))
    assert logits.shape == (2, 7, 64) and torch.isfinite(logits).all()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(src), jnp.asarray(tgt)))
    assert _rel(logits.numpy(), want) <= TOL
    assert {n.split(".")[0] for n, _ in pm.named_parameters()} >= {"encoder", "decoder"}


def test_source_padding_mask_blocks_attention(tiny):
    jm, params, pm = tiny
    rng = np.random.default_rng(0)
    src, tgt = rng.integers(1, 64, (1, 8)), rng.integers(1, 64, (1, 5))
    mask = np.asarray([[1, 1, 1, 1, 0, 0, 0, 0]])
    src2 = src.copy()
    src2[:, 4:] = rng.integers(1, 64, (1, 4))
    with torch.no_grad():
        out1, out2 = (pm(_t(s), _t(tgt), _t(mask)) for s in (src, src2))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(src), jnp.asarray(tgt),
                               jnp.asarray(mask)))
    assert _rel(out1.numpy(), want) <= TOL


def test_trains_copy_task_via_unified_step():
    """The copy task on both packages from the same weights: the port's
    loss curve is the reference's step by step, the loss collapses, and the
    port's greedy decode copies the source."""
    jm, params, pm = _pair(src_len=8, tgt_len=8, remat="dots")
    rng = np.random.default_rng(1)
    src = rng.integers(2, 64, (16, 8)).astype(np.int32)
    dec_in = np.concatenate([np.zeros((16, 1), np.int32), src[:, :-1]], axis=1)
    batch = {"input_ids": src, "decoder_input_ids": dec_in, "labels": src}

    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    acc = jax_pkg.Accelerator()
    jparams = acc.prepare(jax.tree.map(lambda x: jnp.asarray(np.array(x)), params))
    opt = acc.prepare(optax.adam(3e-3))
    carry = acc.init_carry(jparams, opt)
    step = acc.unified_step(JaxSeq2Seq.loss_fn(jm))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(COPY_STEPS):
        carry, m = step(carry, jbatch)
        want.append(float(m["loss"]))

    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    pacc = port.Accelerator(cpu=True)
    model, popt = pacc.prepare(pm, port.adamw(3e-3, weight_decay=0.0))
    pstep = pacc.unified_step(Seq2SeqLM.loss_fn(model), popt)
    pcarry = pacc.init_carry(model, popt)
    pbatch = {k: _t(v) for k, v in batch.items()}
    got = []
    for _ in range(COPY_STEPS):
        pcarry, m = pstep(pcarry, pbatch)
        got.append(float(m["loss"]))
    port.AcceleratorState._reset_state(reset_partial_state=True)
    assert _rel(got, want) <= COPY_TOL, (got, want)
    assert got[-1] < 0.15 * got[0], (got[0], got[-1])
    out = model.generate(_t(src[:2]), max_new_tokens=8, bos_token_id=0)
    np.testing.assert_array_equal(out[:, 1:].numpy(), src[:2])


def test_t5_base_preset():
    cfg = port.TransformerConfig.t5_base()
    assert cfg.num_decoder_layers == 12 and cfg.tie_embeddings
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxConfig.t5_base())
    ref = jax.eval_shape(lambda: JaxSeq2Seq(JaxConfig.t5_base()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32)))
    from accelerate_tpu.models import count_params as jax_count_params

    assert count_params(Seq2SeqLM(cfg, device="meta")) == jax_count_params(
        nn.unbox(ref["params"]))


def test_decoder_forced_causal_even_with_noncausal_config():
    jm, params, pm = _pair(src_len=6, tgt_len=6, causal=False)
    rng = np.random.default_rng(2)
    src, tgt = rng.integers(1, 64, (1, 6)), rng.integers(1, 64, (1, 6))
    tgt2 = tgt.copy()
    tgt2[:, -1] = (tgt[:, -1] + 1) % 64
    with torch.no_grad():
        out1, out2 = pm(_t(src), _t(tgt)), pm(_t(src), _t(tgt2))
    np.testing.assert_allclose(out1[:, :-1].numpy(), out2[:, :-1].numpy(), atol=1e-5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(src), jnp.asarray(tgt)))
    assert _rel(out1.numpy(), want) <= TOL


def test_cached_generate_matches_full_recompute():
    jm, params, pm = _pair(seed=1, tgt_len=1)
    rng = np.random.default_rng(3)
    src = rng.integers(1, 64, (2, 8))
    mask = np.ones((2, 8), np.int64)
    mask[1, 6:] = 0
    for m in (None, mask):
        out = pm.generate(_t(src), max_new_tokens=6, bos_token_id=0,
                          attention_mask=None if m is None else _t(m))
        with torch.no_grad():
            memory = pm.encode(_t(src), None if m is None else _t(m))
            dec = torch.zeros((2, 1), dtype=torch.long)
            for _ in range(6):
                logits = pm.decode_logits(dec, memory, None if m is None else _t(m))
                dec = torch.cat([dec, logits[:, -1].argmax(-1)[:, None]], dim=1)
        np.testing.assert_array_equal(out.numpy(), dec.numpy())
        want = jm.generate(params, jnp.asarray(src), max_new_tokens=6, bos_token_id=0,
                           attention_mask=None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_generate_bounds_and_zero_tokens():
    jm, params, pm = _pair(tgt_len=1, src_len=4, max_seq_len=8)
    src = np.ones((1, 4), np.int64)
    with pytest.raises(ValueError, match="max_seq_len"):
        pm.generate(_t(src), max_new_tokens=8)
    with pytest.raises(ValueError, match="max_seq_len"):
        jm.generate(params, jnp.asarray(src), max_new_tokens=8)
    np.testing.assert_array_equal(pm.generate(_t(src), max_new_tokens=0).numpy(), [[0]])
    np.testing.assert_array_equal(np.asarray(jm.generate(params, jnp.asarray(src),
                                                         max_new_tokens=0)), [[0]])
