"""Tensor-parallel sizes that do not fall on whole heads or on even kv
groups, on the port at world 4 over gloo, against the reference and the
port's own world 1.

The reference's rules split the query projection's columns and the vocab
evenly over tp and check divisibility for fsdp only
(``accelerate_tpu/parallel/sharding.py:146-181``); GSPMD runs whatever the
columns' split gives. So the reference runs ``tiny(num_heads=2)`` at tp 4
(each rank half a head) and 10 heads over 5 kv heads at tp 4 (a rank's
heads straddle two kv groups unevenly), and this file first runs its
forward under those plugins. The port runs them too: a rank gathers q over
tp, attends over the heads its columns touch (its kv heads expanded to
one a query head where they group unevenly) and keeps its columns. One
world-4 launch of ``tp_workers.decode_worker`` decodes each (prefill and
every step's logits within 2e-5 of world 1, and the prefill's of the
reference's forward under the plugin) and takes one sgd step (loss and
params within 2e-5 of world 1). A vocab that tp does not divide is refused
by both.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import tp_workers  # noqa: E402

TOL = 2e-5
TP4 = dict(dp_size=1, tp_size=4)
# name: the config (``tiny``'s overrides)
CASES = {"uneven_heads": dict(num_heads=2, max_seq_len=64),
         "uneven_kv": dict(num_heads=10, num_kv_heads=5, hidden_size=160, max_seq_len=64)}


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


_PARAMS: dict = {}


def _reference(name: str):
    """The reference's ``tiny(**CASES[name])`` and its boxed init from key 0
    (the logical axes its ``prepare`` maps to tp)."""
    if name not in _PARAMS:
        model = JaxCausalLM(JaxConfig.tiny(**CASES[name]))
        _PARAMS[name] = model, model.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 8), jnp.int32))["params"]
    return _PARAMS[name]


def _case(name, plugin):
    return dict(name=name if plugin else f"{name}_w1", plugin=plugin, config=CASES[name],
                init=f"init_{name}.pt", logits=True, train="train_ids")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("uneven_tp")
    _reset()
    np.savez(os.path.join(out, "inputs.npz"),
             prompt=np.random.default_rng(5).integers(0, 1024, (2, 8)),
             train_ids=np.random.default_rng(7).integers(0, 1024, (8, 16)))
    for name, cfg in CASES.items():
        _, params = _reference(name)
        torch.save(dict(port.params_from_jax(jax.tree.map(np.asarray, nn.unbox(params)),
                                             port.TransformerConfig.tiny(**cfg))),
                   os.path.join(out, f"init_{name}.pt"))
    refusal = dict(name="refusal", refuse=True, plugin=dict(dp_size=2, tp_size=2),
                   config=dict(vocab_size=1001))
    debug_launcher(tp_workers.decode_worker,
                   (str(out), [_case(n, TP4) for n in CASES] + [refusal]), num_processes=4)
    for name in CASES:
        tp_workers.decode_case(str(out), _case(name, None))
    _reset()
    names = list(CASES) + [f"{n}_w1" for n in CASES] + ["refusal"]
    return out, {n: torch.load(os.path.join(out, f"{n}.pt")) for n in names}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_uneven_tp_runs_as_the_reference(records, name):
    out, recs = records
    rec, base = recs[name], recs[f"{name}_w1"]
    model, params = _reference(name)
    _reset()
    acc = jax_pkg.Accelerator(parallelism_plugin=jax_pkg.ParallelismPlugin(dp_size=-1,
                                                                           tp_size=4))
    sharded = acc.prepare(params)
    assert any("tp" in str(leaf.sharding.spec) for leaf in jax.tree.leaves(sharded))
    prompt = np.load(os.path.join(out, "inputs.npz"))["prompt"]
    want = np.asarray(jax.jit(lambda p, i: model.apply({"params": p}, i))(
        sharded, jnp.asarray(prompt, jnp.int32)))
    _reset()
    _close(rec["logits"][0], want, "prefill vs the reference under tp 4")
    for i, (got, one) in enumerate(zip(rec["logits"], base["logits"])):
        _close(got, one, f"step {i} vs world 1")
    assert torch.equal(rec["tokens"], base["tokens"])
    _close(rec["loss"], base["loss"], "sgd step loss")
    for k, v in base["params"].items():
        _close(rec["params"][k], v, k)


def test_a_vocab_tp_does_not_divide_is_refused_by_both(records):
    """vocab 1001 at tp 2: the reference's ``device_put`` refuses the split,
    and the port's placement refuses it too."""
    _, recs = records
    assert "do not divide dim 0 of size 1001" in recs["refusal"]["error"]
    _reset()
    model = JaxCausalLM(JaxConfig.tiny(vocab_size=1001))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    acc = jax_pkg.Accelerator(parallelism_plugin=jax_pkg.ParallelismPlugin(dp_size=-1,
                                                                           tp_size=2))
    with pytest.raises(ValueError, match="divisible"):
        acc.prepare(params)
    _reset()
