"""The serving engine over a model split over tp where the heads do not
split evenly, and sampling over a sharded model, on the port over gloo.

One world-4 launch of ``engine_workers.engine_worker`` at tp 4 over the
reference's ``tiny(num_heads=10, num_kv_heads=5, hidden_size=160)`` (the
configuration ``test_torch_uneven_tp.py`` decodes): each rank's query
columns cut a head (it gathers q) and its query heads read kv heads that
a neighbour holds too (``kv_map``), so the paged pools of two ranks share
kv heads:

* int8 KV: every prefill's and decode step's logits within 2e-5 of world 1,
  the scale arrays after the first prefill and at the end within 1e-6 of
  world 1's (the amax over the tp group counts a shared head once: a
  maximum), tokens the reference's int8 engine's;
* a hand-off from that engine to a world-1 engine (each kv head of the
  manifest written by its first holder): tokens the colocated run's, the
  manifests' bytes the reference's;
* sampling at temperature 0.8 under tp 2 (GQA): every rank draws the same
  tokens (logits gathered whole, one seed), equal to world 1's.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu.serving as jax_serving  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import engine_workers  # noqa: E402

TOL = 2e-5
SCALE_TOL = 1e-6
UNEVEN = dict(num_heads=10, num_kv_heads=5, hidden_size=160, max_seq_len=64)
GQA = dict(num_kv_heads=2, max_seq_len=64)
ENGINE = dict(max_slots=4, block_size=8)


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1024, size=n).tolist() for n in lens]


REQ = [(f"u{i}", p, {"max_new_tokens": 6}) for i, p in enumerate(_prompts((5, 11, 17), 3))]
SAMPLED = [(f"s{i}", p, {"max_new_tokens": 8, "temperature": 0.8})
           for i, p in enumerate(_prompts((6, 13), 4))]
WORLD4 = [
    dict(name="uneven_int8_tp4", plugin=dict(dp_size=1, tp_size=4), config=UNEVEN,
         init="init_uneven.pt", engine=dict(ENGINE, kv_dtype="int8"), requests=REQ,
         logits=True, scales=True),
    dict(name="uneven_handoff_tp4", kind="handoff", sharded="prefill",
         plugin=dict(dp_size=1, tp_size=4), config=UNEVEN, init="init_uneven.pt",
         engine=dict(max_slots=2, block_size=8), requests=REQ),
    dict(name="sampled_tp2", plugin=dict(dp_size=2, tp_size=2), config=GQA, init="init_gqa.pt",
         engine=ENGINE, requests=SAMPLED),
]
WORLD1 = [dict(WORLD4[0], name="uneven_int8_w1", plugin=None),
          dict(WORLD4[2], name="sampled_w1", plugin=None)]


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


_PARAMS: dict = {}


def _reference(config: dict):
    key = tuple(sorted(config.items()))
    if key not in _PARAMS:
        model = JaxCausalLM(JaxConfig.tiny(**config))
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        _PARAMS[key] = model, nn.unbox(params)
    return _PARAMS[key]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_engine_uneven")
    _reset()
    for name, cfg in (("init_uneven.pt", UNEVEN), ("init_gqa.pt", GQA)):
        _, params = _reference(cfg)
        torch.save(dict(port.params_from_jax(jax.tree.map(np.asarray, params),
                                             port.TransformerConfig.tiny(**cfg))),
                   os.path.join(out, name))
    debug_launcher(engine_workers.engine_worker, (str(out), WORLD4), num_processes=4)
    threads = torch.get_num_threads()
    try:  # one thread, as each rank runs
        engine_workers.engine_worker(str(out), WORLD1)
    finally:
        torch.set_num_threads(threads)
    _reset()
    names = [c["name"] for c in WORLD4 + WORLD1]
    return {n: torch.load(os.path.join(out, f"{n}.pt"), weights_only=False) for n in names}


def _ref_run(engine, requests) -> dict:
    for rid, prompt, kw in requests:
        engine.add_request(list(prompt), request_id=rid, **kw)
    for _ in engine.stream():
        pass
    return {rid: engine.result(rid) for rid, _, _ in requests}


def _ranks_agree(rec):
    first = rec["ranks"][0]
    assert len(rec["ranks"]) == 4
    for other in rec["ranks"][1:]:
        assert other["events"] == first["events"]
        for a, b in zip(other["tables"], first["tables"]):
            np.testing.assert_array_equal(a, b)


def test_uneven_tp_int8_engine_matches_world_one_and_the_reference(records):
    rec, one = records["uneven_int8_tp4"], records["uneven_int8_w1"]
    for kind in ("prefill", "decode"):
        assert len(rec["logits"][kind]) == len(one["logits"][kind]) > 0
        for i, (got, want) in enumerate(zip(rec["logits"][kind], one["logits"][kind])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{kind} {i}")
    assert len(rec["scales"]) == 2
    for got, want in zip(rec["scales"], one["scales"]):
        for g, w in zip(got, want):
            assert (w > 0).any()
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=SCALE_TOL, atol=0)
    model, params = _reference(UNEVEN)
    want = _ref_run(jax_serving.ServingEngine(model, params, seed=0, kv_dtype="int8", **ENGINE),
                    REQ)
    assert rec["tokens"] == one["tokens"] == want
    _ranks_agree(rec)


def test_uneven_tp_handoff_carries_every_kv_head(records):
    rec = records["uneven_handoff_tp4"]
    model, params = _reference(UNEVEN)
    kw = dict(max_slots=2, block_size=8)
    pre = jax_serving.ServingEngine(model, params, role="prefill", **kw)
    dec = jax_serving.ServingEngine(model, params, role="decode", **kw)
    for rid, prompt, rkw in REQ:
        pre.add_request(list(prompt), request_id=rid, **rkw)
    manifests = []
    for _ in range(300):
        if not (pre.has_work or dec.has_work):
            break
        pre.step()
        for m in pre.pop_manifests():
            manifests.append((m.request_id, m.nbytes, m.n_blocks, m.bytes_per_block()))
            dec.acquire(m)
        dec.step()
    colocated = _ref_run(jax_serving.ServingEngine(model, params, **kw), REQ)
    assert rec["tokens"] == colocated
    assert rec["manifests"] == manifests
    assert rec["prefill_gauges"] == pre.transfer_gauges()


def test_sampling_over_a_sharded_model_draws_alike_on_every_rank(records):
    """At temperature 0.8 every rank samples the same tokens from the
    logits gathered whole with one seed, and those are world 1's draws."""
    rec, one = records["sampled_tp2"], records["sampled_w1"]
    _ranks_agree(rec)
    assert rec["tokens"] == one["tokens"]
    assert all(len(t) == 8 for t in rec["tokens"].values())
