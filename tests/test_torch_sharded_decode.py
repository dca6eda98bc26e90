"""Decoding a sharded model on the port over gloo, against the reference
and the port's own world 1.

One world-8 launch and one world-4 launch of ``tp_workers.decode_worker``
run every configuration in turn, each on one process group:

* the reference's own sharded-generate contract
  (``tests/test_generation.py:107``): ``TransformerConfig.tiny(max_seq_len=64)``
  with the reference's init, prepared under dp 2 x fsdp 2 x tp 2 (FULL_SHARD,
  ``min_weight_size=1``), greedy ``generate`` of 6 tokens from the prompt
  ``default_rng(5)`` (2, 8): exactly the reference's single-device tokens
  and the port's world 1;
* its ``test_sharded_generate_no_involuntary_reshard`` (:155) as the port
  can see it: every collective of one decode step, of which the tp group's
  are the activations' sums (the embedding's and two a layer) and one
  gather of the logits, and none moves a tp-split weight;
* at world 4, GQA (``num_kv_heads=2``) under fsdp 2 x tp 2, tp 4 (one kv
  head a rank) and dp 2 x tp 2: the prefill's and every decode step's logits
  within 2e-5 of world 1, and ``make_generate_fn``'s tokens and
  ``trace_counts`` as the reference's (``tests/test_generation.py:85-103``);
* the serving engine and a paged cache over a sharded model run (the
  engine's own tests are ``test_torch_sharded_engine.py``).

Tp sizes that cut heads or kv groups are ``test_torch_uneven_tp.py``'s.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu.models.generation import generate as jax_generate  # noqa: E402
from accelerate_tpu.models.generation import make_generate_fn as jax_make_generate_fn  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import tp_workers  # noqa: E402

TOL = 2e-5
NEW = 6
LENGTHS = (3, 5, 8, 13)
CONTRACT = dict(dp_size=2, fsdp_size=2, tp_size=2, min_weight_size=1,
                sharding_strategy="full_shard")
GQA = dict(num_kv_heads=2, max_seq_len=64)
WORLD8 = [
    dict(name="contract", plugin=CONTRACT, config=dict(max_seq_len=64), init="init_ref.pt",
         count=True),
]
WORLD4 = [
    dict(name="gqa_fsdp2_tp2", plugin=dict(dp_size=1, fsdp_size=2, tp_size=2,
                                           min_weight_size=1),
         config=GQA, init="init_gqa.pt", logits=True, lengths=LENGTHS, count=True),
    dict(name="gqa_tp4", plugin=dict(dp_size=1, tp_size=4), config=GQA, init="init_gqa.pt",
         logits=True),
    dict(name="gqa_dp2_tp2", plugin=dict(dp_size=2, tp_size=2), config=GQA, init="init_gqa.pt",
         logits=True),
]
WORLD1 = [
    dict(name="contract_w1", config=dict(max_seq_len=64), init="init_ref.pt"),
    dict(name="gqa_w1", config=GQA, init="init_gqa.pt", logits=True, lengths=LENGTHS),
]


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


_PARAMS: dict = {}


def _reference_params(config: dict, boxed: bool = False):
    """The reference's ``tiny(**config)`` model and its init from key 0,
    made once a config; ``boxed``: with the logical axes its ``prepare``
    maps to tp."""
    key = tuple(sorted(config.items()))
    if key not in _PARAMS:
        model = JaxCausalLM(JaxConfig.tiny(**config))
        _PARAMS[key] = model, model.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8), jnp.int32))["params"]
    model, params = _PARAMS[key]
    return model, params if boxed else nn.unbox(params)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_decode")
    _reset()
    inputs = {"prompt": np.random.default_rng(5).integers(0, 1024, (2, 8))}
    rng = np.random.default_rng(11)
    for n in LENGTHS:
        inputs[f"len{n}"] = rng.integers(0, 1024, (2, n))
    np.savez(os.path.join(out, "inputs.npz"), **inputs)
    for name, cfg in (("init_ref.pt", dict(max_seq_len=64)), ("init_gqa.pt", GQA)):
        _, params = _reference_params(cfg)
        torch.save(dict(port.params_from_jax(jax.tree.map(np.asarray, params),
                                             port.TransformerConfig.tiny(**cfg))),
                   os.path.join(out, name))
    debug_launcher(tp_workers.decode_worker, (str(out), WORLD8), num_processes=8)
    debug_launcher(tp_workers.decode_worker, (str(out), WORLD4), num_processes=4)
    for case in WORLD1:
        tp_workers.decode_case(str(out), case)
    _reset()
    names = [c["name"] for c in WORLD8 + WORLD4 + WORLD1]
    return out, inputs, {n: torch.load(os.path.join(out, f"{n}.pt")) for n in names}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def test_sharded_generate_matches_single_device(records):
    """The reference's contract at its own plugin (dp 2 x fsdp 2 x tp 2,
    FULL_SHARD, world 8): the port's tokens are exactly the reference's
    single-device tokens, and the port's unsharded run's."""
    _, inputs, recs = records
    model, params = _reference_params(dict(max_seq_len=64))
    want = np.asarray(jax_generate(model, params, jnp.asarray(inputs["prompt"], jnp.int32),
                                   max_new_tokens=NEW))
    np.testing.assert_array_equal(recs["contract"]["tokens"].numpy(), want)
    np.testing.assert_array_equal(recs["contract_w1"]["tokens"].numpy(), want)


@pytest.mark.parametrize("name", ["contract", "gqa_fsdp2_tp2"])
def test_decode_step_gathers_no_tp_split_weight(records, name):
    """One decode step's collectives on the tp group: the embedding's sum,
    two sums a layer (attention and MLP), each (B, 1, hidden), and one
    gather of the (B, 1, vocab / tp) logits; no tp collective carries a
    tensor the size of a tp-split weight's shard. The fsdp gathers of the
    layers run on the fsdp group."""
    _, _, recs = records
    rec = recs[name]
    cfg = port.TransformerConfig.tiny(**[c for c in WORLD8 + WORLD4
                                         if c["name"] == name][0]["config"])
    tp = len(rec["tp_ranks"])
    on_tp = [(op, shape) for op, ranks, shape in rec["collectives"]
             if ranks == rec["tp_ranks"]]
    sums = [shape for op, shape in on_tp if op == "all_reduce"]
    gathers = [int(np.prod(shape)) for op, shape in on_tp if op != "all_reduce"]
    assert sums == [(2, 1, cfg.hidden_size)] * (1 + 2 * cfg.num_layers), on_tp
    assert gathers == [2 * cfg.vocab_size // tp], on_tp
    split = {shape for k, shape in rec["local_shapes"].items()
             if any(p in k for p in ("q_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
                                     "lm_head", "embed"))}
    assert not any(shape in split or int(np.prod(shape)) in {int(np.prod(s)) for s in split}
                   for _, shape in on_tp)
    fsdp = [ranks for op, ranks, shape in rec["collectives"] if ranks != rec["tp_ranks"]]
    assert fsdp and all(len(r) == 2 for r in fsdp)  # the fsdp pairs gather the layers


@pytest.mark.parametrize("name", ["gqa_fsdp2_tp2", "gqa_tp4", "gqa_dp2_tp2"])
def test_tp_decode_logits_match_world_one(records, name):
    """GQA under fsdp 2 x tp 2, tp 4 (one kv head a rank) and dp 2 x tp 2:
    the prefill's logits and every decode step's within 2e-5 of the
    unsharded run, and the same tokens."""
    _, _, recs = records
    rec, one = recs[name], recs["gqa_w1"]
    assert len(rec["logits"]) == NEW
    for i, (got, want) in enumerate(zip(rec["logits"], one["logits"])):
        _close(got, want, f"{name} step {i}")
    assert torch.equal(rec["tokens"], one["tokens"])


def test_make_generate_fn_trace_counts_match_the_reference(records):
    """``make_generate_fn`` on the sharded model: its tokens for prompts of
    several lengths equal ``generate``'s at world 1, and its trace counts
    equal the reference's over the same lengths."""
    _, inputs, recs = records
    rec, one = recs["gqa_fsdp2_tp2"], recs["gqa_w1"]
    for got, want in zip(rec["fn_tokens"], one["fn_tokens"]):
        assert torch.equal(got, want)
    model, params = _reference_params(GQA)
    fn = jax_make_generate_fn(model, max_new_tokens=4)
    for n in LENGTHS:
        fn(params, jnp.asarray(inputs[f"len{n}"], jnp.int32))
    assert rec["trace_counts"] == one["trace_counts"] == fn.trace_counts()


def test_the_engine_over_a_sharded_model_names_its_queue_item(records):
    """The serving engine over a sharded model is ported (it raised naming
    its queue item before): over a prepared model it decodes the unsharded
    model's greedy tokens, and ``init_cache`` gives it paged pools of every
    kv head (one rank) with whole int8 scale arrays."""
    from accelerate_tpu_torch.models import generation

    _reset()
    cfg = port.TransformerConfig.tiny(num_layers=1, **GQA)
    prompt = torch.tensor([[5, 6, 7, 8]])
    plain = port.CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    want = generation.generate(plain, prompt, max_new_tokens=3)
    acc = port.Accelerator(cpu=True, parallelism_plugin=port.ParallelismPlugin(dp_size=1))
    model = acc.prepare(port.CausalLM(cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(0)))
    try:
        got = port.ServingEngine(model, max_slots=1, block_size=16).generate(
            prompt, max_new_tokens=3)
        assert torch.equal(got, want)
        cache = generation.init_cache(model, 1, num_blocks=4, block_size=16, kv_dtype="int8")
        assert cache.key.shape == (1, 4, 16, cfg.num_kv_heads, cfg.head_dim)
        assert cache.key.dtype == torch.int8 and cache.key_scale.shape == (1, 4, 16)
    finally:
        acc.state.partial_state.destroy_process_group()
        _reset()
