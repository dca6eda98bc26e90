"""The port's MoE against the JAX reference's, on the CPU in fp32.

Mirrors ``tests/test_moe.py``: ``moe_ragged`` and ``moe_dispatch_combine``
(with and without drops) against ``accelerate_tpu.ops.moe`` on the same
inputs, forward and gradients; ``expert_capacity`` and
``load_balancing_loss`` equal; a tiny MoE ``CausalLM`` (4 experts, top-2)
in every dispatch mode on parameters carried over from the reference's
tree (the expert stacks untransposed); three ``unified_step``s against the
reference's. The expert-parallel cases (:197-352) are
``test_torch_moe_ep.py``'s.

Tolerance: fp32 on both sides, the products summed in another order:
1e-5 for the ops (outputs and gradients over their largest reference
magnitude), 2e-5 for the model and the step, as ``test_torch_models.py``.
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
from accelerate_tpu.ops import moe as jmoe  # noqa: E402
from accelerate_tpu_torch.ops import moe  # noqa: E402

OPS_TOL = 1e-5
MODEL_TOL = 2e-5
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64, num_experts=4, num_experts_per_tok=2)


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


def _routing(T, E, K, seed):
    """Seeded router logits and their renormalised top-K, as numpy."""
    logits = np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)
    weights, sel = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), K)
    weights = weights / jnp.sum(weights, -1, keepdims=True)
    return logits, np.asarray(sel), np.asarray(weights)


def _close(got, want, tol=OPS_TOL, name=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=tol, err_msg=name)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_moe_ragged_matches_jax_forward_and_grads():
    T, h, f, E, K = 48, 16, 24, 4, 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, h)).astype(np.float32)
    wg, wu = (rng.standard_normal((E, h, f)).astype(np.float32) / 4 for _ in range(2))
    wd = rng.standard_normal((E, f, h)).astype(np.float32) / 5
    _, sel, weights = _routing(T, E, K, seed=1)
    g = rng.standard_normal((T, h)).astype(np.float32)

    def jloss(x, w, wg, wu, wd):
        return jnp.sum(jmoe.moe_ragged(x, jnp.asarray(sel), w, wg, wu, wd) * g)

    jout = jmoe.moe_ragged(*(jnp.asarray(a) for a in (x, sel, weights, wg, wu, wd)))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, weights, wg, wu, wd)))
    args = [_t(a, grad=True) for a in (x, weights, wg, wu, wd)]
    out = moe.moe_ragged(args[0], torch.from_numpy(sel).long(), *args[1:])
    _close(out.detach(), jout)
    grads = torch.autograd.grad((out * _t(g)).sum(), args)
    for name, got, want in zip(("x", "weights", "gate", "up", "down"), grads, jgrads):
        _close(got, want, name=name)


def _experts(w, lib):
    if lib is jnp:
        return lambda buf: jnp.tanh(jnp.einsum("ech,ehf->ecf", buf, w))
    return lambda buf: torch.tanh(torch.einsum("ech,ehf->ecf", buf, w))


@pytest.mark.parametrize("case", ["no_drop", "drops"])
def test_moe_dispatch_combine_matches_jax(case):
    T, h, E, K = 64, 16, 4, 2
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, h)).astype(np.float32)
    w = (rng.standard_normal((E, h, h)) / 4).astype(np.float32)
    _, sel, weights = _routing(T, E, K, seed=3)
    kw = (dict(capacity_factor=moe.no_drop_capacity_factor(E, K)) if case == "no_drop"
          else dict(capacity=8))  # 8 of the 32 claims an expert has on average

    def jfn(x, w_):
        return jmoe.moe_dispatch_combine(x, jnp.asarray(sel), jnp.asarray(weights),
                                         _experts(w_, jnp), E, **kw)

    jout = jfn(jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jfn(a, b) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    out = moe.moe_dispatch_combine(tx, torch.from_numpy(sel).long(), _t(weights),
                                   _experts(tw, torch), E, **kw)
    _close(out.detach(), jout)
    gx, gw = torch.autograd.grad((out ** 2).sum(), (tx, tw))
    _close(gx, jgx, name="x")
    _close(gw, jgw, name="w")
    slot, keep = moe.capacity_slots(torch.from_numpy(sel).long(), E,
                                    kw.get("capacity") or moe.expert_capacity(T, E, K, 2.0))
    if case == "drops":  # a dropped (token, choice) reads zeros: rows with both dropped are 0
        assert 0 < int((~keep).sum()) < T * K
        both = (~keep).reshape(T, K).all(dim=1)
        assert torch.equal(out[both].detach(), torch.zeros_like(out[both]))
    else:
        assert bool(keep.all())


def test_capacity_drops_route_to_the_spare_row():
    """Every token on expert 0 at capacity 8: the first 8 get the expert,
    the rest read zeros (the reference's test_capacity_factor_bounds...)."""
    x = torch.ones(32, 8)
    sel = torch.zeros(32, 1, dtype=torch.long)
    out = moe.moe_dispatch_combine(x, sel, torch.ones(32, 1), lambda buf: buf + 1.0, 2,
                                   capacity=8)
    assert torch.equal(out[:8], torch.full((8, 8), 2.0))
    assert torch.equal(out[8:], torch.zeros(24, 8))
    slot, keep = moe.capacity_slots(sel, 2, 8)
    assert slot[:8].tolist() == list(range(8)) and set(slot[8:].tolist()) == {16}


@pytest.mark.parametrize("args", [(1024, 8, 2, 1.0), (4, 64, 1, 1.0), (100, 8, 2, 1.25),
                                  (16384, 8, 2, 1.25), (33, 3, 2, 2.0)])
def test_expert_capacity_and_no_drop_factor_equal_jax(args):
    assert moe.expert_capacity(*args) == jmoe.expert_capacity(*args)
    assert moe.expert_capacity(*args) % 8 == 0
    assert moe.no_drop_capacity_factor(*args[1:3]) == jmoe.no_drop_capacity_factor(*args[1:3])


def test_load_balancing_loss_equals_jax():
    T, E, K = 512, 4, 2
    rng = np.random.default_rng(4)
    sel = rng.integers(0, E, (T, K))
    zeros = np.zeros((T, E), np.float32)
    uniform = moe.load_balancing_loss(torch.from_numpy(zeros), torch.from_numpy(sel[:, :1]), E)
    assert float(uniform) == pytest.approx(1.0, abs=0.05)  # K = 1, as the reference's test
    for logits in (zeros, rng.standard_normal((2, T // 2, E)).astype(np.float32)):
        s = sel.reshape(logits.shape[:-1] + (K,))
        got = moe.load_balancing_loss(torch.from_numpy(logits), torch.from_numpy(s), E)
        want = jmoe.load_balancing_loss(jnp.asarray(logits), jnp.asarray(s), E)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_params(cfg_kw, seq):
    model = JaxCausalLM(JaxConfig(**cfg_kw))
    params = nn.unbox(model.init_params(jax.random.PRNGKey(0), seq_len=seq))
    return jax.tree.map(np.asarray, params)


def _ids(vocab, batch=2, seq=32, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, seq)).astype(np.int32)


@pytest.mark.parametrize("dispatch,factor", [("auto", 2.0), ("ragged", 2.0), ("capacity", 2.0),
                                             ("capacity", 1.0), ("dense", 2.0)])
def test_moe_causal_lm_matches_jax(dispatch, factor):
    kw = dict(MODEL, moe_dispatch=dispatch, moe_capacity_factor=factor)
    params = _jax_params(kw, 32)
    jmodel = JaxCausalLM(JaxConfig(**kw))
    ids = _ids(kw["vocab_size"])
    jlogits, state = jmodel.apply({"params": params}, jnp.asarray(ids),
                                  mutable=["intermediates"])
    jloss, jgrads = jax.value_and_grad(JaxCausalLM.loss_fn(jmodel))(
        params, {"input_ids": jnp.asarray(ids)})

    model = port.CausalLM(port.TransformerConfig(**kw), device="cpu")
    state_dict = port.params_from_jax(params, model.config)
    # the expert stacks come over untransposed, the router transposed
    stack = params["layers"]["moe"]["gate_proj"][1]
    assert np.array_equal(state_dict["layers.1.moe.gate_proj"].numpy(), stack)
    assert np.array_equal(state_dict["layers.0.moe.router.weight"].numpy(),
                          params["layers"]["moe"]["router"]["kernel"][0].T)
    model.load_state_dict(state_dict, strict=True)
    tids = torch.from_numpy(ids).long()
    logits = model(tids)
    _close(logits.detach(), jlogits, tol=MODEL_TOL)
    aux = np.asarray(state["intermediates"]["layers"]["moe"]["moe_aux_loss"][0])
    np.testing.assert_allclose(float(model.layers[1].moe.aux_loss), aux[1], rtol=1e-5)
    tparams = dict(model.named_parameters())
    loss = port.CausalLM.loss_fn(model)(tparams, {"input_ids": tids})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=MODEL_TOL)
    names = list(tparams)
    grads = torch.autograd.grad(loss, [tparams[n] for n in names])
    want = port.params_from_jax(jax.tree.map(np.asarray, jgrads), model.config)
    assert set(names) == set(want)
    for name, got in zip(names, grads):
        _close(got, want[name].numpy(), tol=MODEL_TOL, name=name)


def test_unrolled_reference_tree_carries_over():
    kw = dict(MODEL, scan_layers=False)
    params = _jax_params(kw, 16)
    state = port.params_from_jax(params, port.TransformerConfig(**kw))
    assert np.array_equal(state["layers.1.moe.down_proj"].numpy(),
                          params["layer_1"]["moe"]["down_proj"])
    port.CausalLM(port.TransformerConfig(**kw), device="cpu").load_state_dict(state, strict=True)


def test_three_unified_steps_match_jax():
    kw = dict(MODEL, moe_dispatch="ragged")
    params = _jax_params(kw, 16)
    ids = np.random.default_rng(5).integers(0, kw["vocab_size"], (24, 16)).astype(np.int32)
    dataset = [{"input_ids": row} for row in ids]

    acc = jax_pkg.Accelerator()
    jmodel = JaxCausalLM(JaxConfig(**kw))
    jp, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, params), optax.adamw(1e-3),
                                  jax_pkg.DataLoader(dataset, batch_size=8))
    step = acc.unified_step(JaxCausalLM.loss_fn(jmodel), opt, max_grad_norm=1.0)
    carry = acc.init_carry(jp, opt)
    jcurve = []
    for batch in loader:
        carry, m = step(carry, batch)
        jcurve.append((float(m["loss"]), float(m["grad_norm"])))
    jfinal = port.params_from_jax(jax.tree.map(np.asarray, carry["params"]),
                                  port.TransformerConfig(**kw))

    acc = port.Accelerator(cpu=True)
    model = port.CausalLM(port.TransformerConfig(**kw), device="cpu")
    model.load_state_dict(port.params_from_jax(params, model.config), strict=True)
    model, opt, loader = acc.prepare(model, port.adamw(1e-3),
                                     port.DataLoader(dataset, batch_size=8))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    curve = []
    for batch in loader:
        carry, m = step(carry, batch)
        curve.append((float(m["loss"]), float(m["grad_norm"])))
    assert len(curve) == len(jcurve) == 3
    np.testing.assert_allclose(np.array(curve), np.array(jcurve), rtol=MODEL_TOL)
    for name, p in carry["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), jfinal[name].numpy(), atol=MODEL_TOL,
                                   err_msg=name)


def test_expert_parallel_raises_naming_a7():
    """Expert parallelism is ported (queue A7 part 4); MoE experts under
    tensor parallelism are what part 4 leaves, and raise naming it."""
    from accelerate_tpu_torch.parallel import runtime

    model = port.CausalLM(port.TransformerConfig(**MODEL), device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    with runtime.sharded_forward(tp=runtime.TensorParallel(None, 2, 0)):
        with pytest.raises(NotImplementedError, match="queue A7 part 4"):
            model.layers[0].moe(torch.zeros(1, 8, MODEL["hidden_size"]))
    assert model(ids).shape == (1, 8, MODEL["vocab_size"])


def test_top_k_takes_the_lower_index_on_ties():
    """``lax.top_k``'s order on equal values, which ``torch.topk`` does not
    promise: all-equal router probabilities pick experts 0 and 1."""
    kw = dict(MODEL, num_layers=1)
    model = port.CausalLM(port.TransformerConfig(**kw), device="cpu")
    with torch.no_grad():
        model.layers[0].moe.router.weight.zero_()
    from accelerate_tpu_torch.models.transformer import _top_k

    probs = torch.softmax(torch.zeros(3, 4), dim=-1)
    _, idx = _top_k(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[0, 1]] * 3
    assert torch.isfinite(model(torch.zeros(1, 8, dtype=torch.long))).all()
