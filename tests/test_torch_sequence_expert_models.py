"""Sequence- and expert-parallel training of the port's models at world 4
over gloo, against the reference.

One world-4 launch (``pipeline_workers.models_worker``) runs:

* the mirror of ``test_models.py::test_sequence_parallel_training_matches_dp``:
  one sgd step of the tiny LM with ring attention at dp 2 x sp 2 (each sp
  rank takes its half of the sequence, the ring runs over sp) against the
  port's plain dp-4 run and the reference's dp-8 run, within the
  reference's 1e-4;
* the mirror of ``::test_moe_forward_and_ep_sharding`` at dp 2 x ep 2: the
  expert stacks split over ep, the logits of the global batch finite;
* fp32 parity: three steps of the tiny ``CausalLM`` (weights from the
  reference's init through ``params_from_jax``, sgd 0.5, clip 1.0) on
  global batches whose rows hold different ``loss_mask`` counts, under
  dp 2 x sp 2 with ring attention and under dp 2 x ep 2 with 4 experts
  (capacity_factor 2 == ep, so nothing drops): each step's loss and grad
  norm and the final params within 2e-5 of the reference's
  single-process run. Under sp the targets and the mask come from the
  whole row before each rank takes its chunk, so every token counts once
  across the chunk boundary; under ep the expert stacks' gradients are
  averaged over dp only and the rest over dp x ep.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import pipeline_workers  # noqa: E402
from accelerate_tpu_torch.test_utils.training import TINY_LM, TINY_SEQ, MaskedTokens  # noqa: E402

TOL = 2e-5
STEPS, ROWS = 3, 8
MOE = dict(num_experts=4, num_experts_per_tok=2, moe_capacity_factor=2.0)
PARITY = {"sp2": (dict(dp_size=2, sp_size=2), dict(attention_impl="ring"), "init.pt"),
          "ep2": (dict(dp_size=2, ep_size=2), MOE, "init_moe_lm.pt")}
RUNS = [dict(name=f"parity_{n}", plugin=p, config=c, init_file=f, steps=STEPS, rows=ROWS,
             max_grad_norm=1.0) for n, (p, c, f) in PARITY.items()]


def _init(cfg):
    return jax.tree.map(np.asarray, nn.unbox(JaxCausalLM(cfg).init_params(
        jax.random.PRNGKey(0), seq_len=TINY_SEQ)))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp_ep_models")
    sp_vars = JaxCausalLM(JaxConfig.tiny(num_layers=2, max_seq_len=64)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    sp_params = jax.tree.map(np.asarray, nn.unbox(sp_vars)["params"])
    moe_params = jax.tree.map(np.asarray, nn.unbox(
        JaxCausalLM(JaxConfig.tiny(num_experts=4, num_experts_per_tok=2)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"])
    inits = {"init_sp.pt": (sp_params, port.TransformerConfig.tiny(num_layers=2, max_seq_len=64)),
             "init_moe.pt": (moe_params, port.TransformerConfig.tiny(num_experts=4,
                                                                     num_experts_per_tok=2)),
             "init.pt": (_init(JaxConfig(**TINY_LM)), port.TransformerConfig(**TINY_LM)),
             "init_moe_lm.pt": (_init(JaxConfig(**TINY_LM, **MOE)),
                                port.TransformerConfig(**TINY_LM, **MOE))}
    for name, (tree, cfg) in inits.items():
        torch.save(dict(port.params_from_jax(tree, cfg)), os.path.join(out, name))
    rng = np.random.default_rng(0)
    np.savez(os.path.join(out, "inputs.npz"),
             sp_ids=rng.integers(0, 1024, size=(4, 64)).astype(np.int64),
             ep_ids=np.random.default_rng(0).integers(0, 1024, size=(4, 16)).astype(np.int64))
    debug_launcher(pipeline_workers.models_worker, (str(out), RUNS), num_processes=4)

    def load(name, rank=None):
        if rank is None:
            return torch.load(os.path.join(out, f"{name}.pt"))
        return torch.load(os.path.join(out, f"{name}_{rank}.pt"))

    return load, sp_params


def test_sequence_parallel_training_matches_dp(records):
    """Ring attention at dp 2 x sp 2 gives the loss and params of the plain
    path on the same global batch: the port's dp-4 run and the reference's
    dp-8 run, within the reference test's 1e-4."""
    load, sp_params = records
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    cfg = JaxConfig.tiny(num_layers=2, max_seq_len=64)
    acc = jax_pkg.Accelerator(parallelism_plugin=jax_pkg.ParallelismPlugin(dp_size=8))
    opt = acc.prepare(optax.sgd(0.1))
    params = acc.prepare(jax.tree.map(jnp.asarray, sp_params))
    carry = acc.init_carry(params, opt)
    step = acc.unified_step(JaxCausalLM.loss_fn(JaxCausalLM(cfg)))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(4, 64))
    carry, m = step(carry, {"input_ids": jnp.asarray(ids, jnp.int32)})
    ref_params = port.params_from_jax(jax.tree.map(np.asarray, carry["params"]),
                                      port.TransformerConfig.tiny(num_layers=2, max_seq_len=64))
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    ring, dp4 = load("sp_ring", 0), load("sp_dp4", 0)
    assert abs(ring["loss"] - float(m["loss"])) < 1e-4
    assert abs(ring["loss"] - dp4["loss"]) < 1e-4
    for k, want in ref_params.items():
        np.testing.assert_allclose(ring["params"][k].numpy(), want.numpy(), atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(ring["params"][k].numpy(), dp4["params"][k].numpy(),
                                   atol=1e-4, err_msg=k)


def test_moe_forward_and_ep_sharding(records):
    load, _ = records
    recs = sorted((load("moe_model", r) for r in range(4)), key=lambda r: r["data_rank"])
    spec = recs[0]["specs"]["layers.0.moe.gate_proj"]
    assert "ep" in str(spec)
    logits = torch.cat([r["logits"] for r in recs])
    assert logits.shape == (4, 16, 1024)
    assert torch.isfinite(logits).all()


_REFERENCE: dict = {}


def _reference_run(name):
    """The reference's single-process run of ``PARITY[name]``'s model:
    sgd 0.5, clip 1.0, ``MaskedTokens`` global batches."""
    if name in _REFERENCE:
        return _REFERENCE[name]
    over = {"attention_impl": "ring"} if name == "sp2" else MOE
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    cfg = JaxConfig(**TINY_LM, **over)
    acc = jax_pkg.Accelerator()
    init = _init(JaxConfig(**TINY_LM, **({} if name == "sp2" else MOE)))
    params, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, init), optax.sgd(0.5),
                                      jax_pkg.DataLoader(MaskedTokens(STEPS * ROWS, 2),
                                                         batch_size=ROWS))
    step = acc.unified_step(JaxCausalLM.loss_fn(JaxCausalLM(cfg)), opt, max_grad_norm=1.0)
    carry = acc.init_carry(params, opt)
    losses, norms = [], []
    for batch in loader:
        carry, m = step(carry, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = port.params_from_jax(jax.tree.map(np.asarray, carry["params"]),
                                 port.TransformerConfig(**TINY_LM, **over))
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    _REFERENCE[name] = (losses, norms, final)
    return _REFERENCE[name]


@pytest.mark.parametrize("name", sorted(PARITY))
def test_sp_and_ep_fp32_training_matches_the_reference(records, name):
    load, _ = records
    rec = load(f"parity_{name}")
    losses, norms, params = _reference_run(name)
    assert rec["data_size"] == (2 if name == "sp2" else 4)
    np.testing.assert_allclose(rec["losses"], losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rec["norms"], norms, rtol=TOL, atol=TOL)
    for k, want in params.items():
        np.testing.assert_allclose(rec["params"][k].numpy(), want.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)
    # sp peers read the same rows; the data ranks read their own
    seen = [r["seen"] for r in rec["ranks"]]
    if name == "sp2":
        assert seen[0] == seen[1] and seen[2] == seen[3] and seen[0] != seen[2]
    else:
        assert len({str(s) for s in seen}) == 4
