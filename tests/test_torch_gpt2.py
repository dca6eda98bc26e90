"""The port's ``GPT2LM`` against the JAX reference's, on the CPU.

The tiny GPT-2 (the reference's ``gpt2`` preset at vocab 128, width 64, MLP
256, 2 layers of 4 heads, 64 positions) with the reference's weights,
every leaf nudged off its init so the biases and LayerNorm offsets are
live, carried by ``params_from_jax``: logits, the next-token loss and every
gradient within ``TOL`` of the reference's (relative to the largest value
of each tensor); greedy ``generate`` and ``make_generate_fn`` tokens equal
to the reference's, with its trace counts; three ``unified_step``s of
AdamW (eps ``ADAM_EPS``) against the reference's (losses, grad norms and params within
``TOL``). The sharded mirror of ``test_models.py::
test_gpt2_sharded_training_decreases_loss`` is in
``test_torch_zoo_sharded.py`` (one gloo launch with the seq2seq one).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu.models import GPT2LM as JaxGPT2  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models import causal_model_for as jax_causal_model_for  # noqa: E402
from accelerate_tpu.models.generation import generate as jax_generate  # noqa: E402
from accelerate_tpu.models.generation import make_generate_fn as jax_make_generate_fn  # noqa

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.models import GPT2LM, causal_model_for, count_params  # noqa: E402
from accelerate_tpu_torch.models.generation import generate, make_generate_fn  # noqa: E402

TOL = 2e-5
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=256, num_layers=2, num_heads=4,
            max_seq_len=64)
SEQ = 16
# AdamW's eps in the step test: at 1e-8 the summation order's rounding of a
# near-zero gradient turns into a visible step (one embedding element read
# 3e-4 apart); at 1e-3 the update is smooth in the gradient
ADAM_EPS = 1e-3


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


@pytest.fixture(scope="module")
def setup():
    """The reference's model, nudged params, tokens, and its logits, loss
    and gradients on them."""
    cfg = JaxConfig.gpt2(**TINY)
    model = JaxGPT2(cfg)
    params = nn.unbox(model.init_params(jax.random.PRNGKey(0), seq_len=SEQ))
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree.unflatten(tree, [x + 0.05 * jax.random.normal(k, x.shape)
                                       for x, k in zip(leaves, keys)])
    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"], (2, SEQ)).astype(np.int32)
    logits = np.asarray(model.apply({"params": params}, jnp.asarray(ids)))
    loss, grads = jax.value_and_grad(JaxGPT2.loss_fn(model))(params,
                                                            {"input_ids": jnp.asarray(ids)})
    return dict(model=model, params=params, ids=ids, logits=logits, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads))


def _port(setup):
    cfg = port.TransformerConfig.gpt2(**TINY)
    model = causal_model_for(cfg, device="cpu")
    model.load_state_dict(port.params_from_jax(setup["params"], cfg), strict=True)
    return model


def test_model_zoo_dispatch_and_count(setup):
    cfg = port.TransformerConfig.gpt2(**TINY)
    model = causal_model_for(cfg, device="cpu")
    assert isinstance(model, GPT2LM) and isinstance(
        causal_model_for(port.TransformerConfig.tiny(), device="cpu"), port.CausalLM)
    assert isinstance(jax_causal_model_for(JaxConfig.gpt2(**TINY)), JaxGPT2)
    from accelerate_tpu.models import count_params as jax_count_params

    assert count_params(model) == jax_count_params(setup["params"])
    if not torch.cuda.is_available():  # an entry point runs on the card unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GPT2LM(cfg)
    assert count_params(dict(model.named_parameters())) == count_params(model)
    # the gpt2 preset is 124M parameters, counted on the meta device
    big = GPT2LM(port.TransformerConfig.gpt2(), device="meta")
    assert count_params(big) == 124_439_808


def test_logits_loss_and_grads_match_the_reference(setup):
    model = _port(setup)
    ids = torch.from_numpy(setup["ids"]).long()
    params = dict(model.named_parameters())
    logits = torch.func.functional_call(model, params, (ids,))
    assert _rel(logits.detach().numpy(), setup["logits"]) <= TOL
    loss = GPT2LM.loss_fn(model)(params, {"input_ids": ids})
    assert abs(loss.item() - setup["loss"]) <= TOL * abs(setup["loss"])
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = port.params_from_jax(setup["grads"], model.config)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert _rel(g.numpy(), want[name].numpy()) <= TOL, name


def test_greedy_generate_matches_the_reference(setup):
    model = _port(setup)
    prompt = setup["ids"][:, :6]
    want = np.asarray(jax_generate(setup["model"], setup["params"], jnp.asarray(prompt),
                                   max_new_tokens=8))
    got = generate(model, torch.from_numpy(prompt), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the built-once closure: the same tokens and the reference's trace counts
    fn, ref_fn = make_generate_fn(model, max_new_tokens=8), jax_make_generate_fn(
        setup["model"], max_new_tokens=8)
    for length in (6, 5):
        p = setup["ids"][:, :length]
        ref_out = ref_fn(setup["params"], jnp.asarray(p), jax.random.PRNGKey(0))
        np.testing.assert_array_equal(fn(torch.from_numpy(p)).numpy(), np.asarray(ref_out))
    assert fn.trace_counts() == ref_fn.trace_counts()


class _Tokens:
    def __init__(self, ids):
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i]}


def test_three_unified_steps_match_the_reference(setup):
    ids = np.random.default_rng(3).integers(0, TINY["vocab_size"], (24, SEQ)).astype(np.int32)
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    acc = jax_pkg.Accelerator()
    # a copy: the step donates its params
    params, opt, loader = acc.prepare(jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                                                   setup["params"]),
                                      optax.adamw(1e-3, eps=ADAM_EPS),
                                      jax_pkg.DataLoader(_Tokens(ids), 8))
    step = acc.unified_step(JaxGPT2.loss_fn(setup["model"]), opt, max_grad_norm=1.0)
    carry = acc.init_carry(params, opt)
    want = []
    for batch in loader:
        carry, m = step(carry, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    want_params = port.params_from_jax(jax.tree.map(np.asarray, carry["params"]),
                                       port.TransformerConfig.gpt2(**TINY))

    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    pacc = port.Accelerator(cpu=True)
    model, popt, ploader = pacc.prepare(_port(setup), port.adamw(1e-3, eps=ADAM_EPS),
                                        port.DataLoader(_Tokens(ids), batch_size=8))
    pstep = pacc.unified_step(GPT2LM.loss_fn(model), popt, max_grad_norm=1.0)
    pcarry = pacc.init_carry(model, popt)
    got = []
    for batch in ploader:
        pcarry, m = pstep(pcarry, batch)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    port.AcceleratorState._reset_state(reset_partial_state=True)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=TOL)
    for name, p in pcarry["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(), atol=TOL,
                                   err_msg=name)
