"""The serving engine over a sharded model on the port over gloo, against
the reference's engine and the port's own world 1.

One world-4 launch of ``engine_workers.engine_worker`` runs every
configuration in turn on one process group; the parent runs the same case
functions unsharded and the reference's ``ServingEngine`` on the same flax
params (``params_from_jax``):

* the reference's audited-engine traffic (``tests/test_hlo_audit.py:271-318``:
  ``TransformerConfig.tiny(max_seq_len=64)`` from key 0, ``max_slots=2``,
  ``block_size=8``, ``seed=0``, n-gram speculation at k 2, ``[7, 8] * 3``
  and ``[1, 2, 3] * 5`` for 6 tokens each), with the prefix cache on and a
  third request that hits the second's first block whole (a copy on write),
  under fsdp 4, tp 4 and fsdp 2 x tp 2: exactly the reference engine's
  tokens and counts, and every rank's events and block tables equal;
* GQA (``num_kv_heads=2``) under tp 2 and tp 4 (two ranks share each kv
  head): every prefill's and decode step's logits within 2e-5 of world 1,
  tokens exactly the reference's; a draft model prepared under tp 2 beside
  the target;
* int8 KV under tp 2 (one kv head a rank): the scale arrays after the first
  prefill and at the end within 1e-6 of world 1's, tokens the reference's
  int8 engine's;
* chunked prefill and one preemption with its swap-in under fsdp 2 x tp 2:
  tokens, swap bytes and ``kv_bytes_per_token`` the reference's;
* hand-offs between a tp engine (2, or 4 with shared kv heads) and a
  world-1 engine, both ways: tokens the colocated run's, manifests' bytes
  and the transfer gauges the reference's;
* two adapters and the base under tp 2: tokens the reference's, and the
  registry's stacks, each rank's share put together, world 1's bitwise.
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
from accelerate_tpu.adapters import AdapterRegistry as JaxRegistry  # noqa: E402
from accelerate_tpu.adapters import LoraConfig as JaxLoraConfig  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.serving.speculation import SpecConfig as JaxSpecConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.adapters import target_shapes  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import engine_workers  # noqa: E402

TOL = 2e-5
SCALE_TOL = 1e-6
REF = dict(max_seq_len=64)
GQA = dict(num_kv_heads=2, max_seq_len=64)
FULL_SHARD = dict(min_weight_size=1, sharding_strategy="full_shard")
AUDITED = dict(max_slots=2, block_size=8, spec_k=2, prefix_cache=True)
AUDITED_REQ = [("a", [7, 8] * 3, {"max_new_tokens": 6}),
               ("b", [1, 2, 3] * 5, {"max_new_tokens": 6})]
# the second request's first block, whole: a full-prompt prefix hit
AGAIN = [("c", [1, 2, 3, 1, 2, 3, 1, 2], {"max_new_tokens": 6})]
RANK = 4
TARGETS = ("q_proj", "v_proj", "o_proj", "gate_proj", "down_proj")


def _prompts(lens, seed=0, lo=1, hi=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, size=n).tolist() for n in lens]


GQA_REQ = [(f"g{i}", p, {"max_new_tokens": 6}) for i, p in enumerate(_prompts((5, 11, 17)))]
INT8_REQ = [(f"q{i}", p, {"max_new_tokens": 7}) for i, p in enumerate(_prompts((5, 11, 17)))]
CAP_ENGINE = dict(max_slots=3, block_size=4, num_blocks=13, prefill_chunk_tokens=8,
                  preemption=True)
CAP_REQ = [(f"c{i}", p, {"max_new_tokens": 4}) for i, p in enumerate(_prompts((40, 39, 38)))]
HANDOFF_REQ = [(f"h{i}", p, {"max_new_tokens": 5}) for i, p in enumerate(_prompts((9, 20, 3), 1))]
TENANT_REQ = [(f"t{i}", p, {"max_new_tokens": 6, "adapter": a})
              for i, (p, a) in enumerate(zip(_prompts((4, 5, 6, 7), 2, 1, 50),
                                             (None, "a", "b", "a")))]


def _contract(name, plugin):
    return dict(name=name, plugin=plugin, config=REF, init="init_ref.pt", engine=AUDITED,
                requests=AUDITED_REQ, again=AGAIN)


WORLD4 = [
    _contract("contract_fsdp4", dict(dp_size=1, fsdp_size=4, **FULL_SHARD)),
    _contract("contract_tp4", dict(dp_size=1, tp_size=4)),
    _contract("contract_fsdp2_tp2", dict(dp_size=1, fsdp_size=2, tp_size=2, **FULL_SHARD)),
    dict(name="gqa_tp2", plugin=dict(dp_size=2, tp_size=2), config=GQA, init="init_gqa.pt",
         engine=dict(max_slots=4, block_size=8), requests=GQA_REQ, logits=True),
    dict(name="gqa_tp4", plugin=dict(dp_size=1, tp_size=4), config=GQA, init="init_gqa.pt",
         engine=dict(max_slots=4, block_size=8), requests=GQA_REQ, logits=True),
    dict(name="draft_tp2", plugin=dict(dp_size=2, tp_size=2), config=GQA, init="init_gqa.pt",
         engine=dict(max_slots=4, block_size=8, spec_k=2, draft=True), requests=GQA_REQ),
    dict(name="int8_tp2", plugin=dict(dp_size=2, tp_size=2), config=GQA, init="init_gqa.pt",
         engine=dict(max_slots=4, block_size=8, kv_dtype="int8"), requests=INT8_REQ,
         scales=True),
    dict(name="capacity_fsdp2_tp2", plugin=dict(dp_size=1, fsdp_size=2, tp_size=2, **FULL_SHARD),
         config=REF, init="init_ref.pt", engine=CAP_ENGINE, requests=CAP_REQ),
    dict(name="handoff_tp2_to_w1", kind="handoff", sharded="prefill",
         plugin=dict(dp_size=2, tp_size=2), config=GQA, init="init_gqa.pt",
         engine=dict(max_slots=2, block_size=8), requests=HANDOFF_REQ),
    dict(name="handoff_tp4_to_w1", kind="handoff", sharded="prefill",
         plugin=dict(dp_size=1, tp_size=4), config=GQA, init="init_gqa.pt",
         engine=dict(max_slots=2, block_size=8), requests=HANDOFF_REQ),
    dict(name="handoff_w1_to_tp2", kind="handoff", sharded="decode",
         plugin=dict(dp_size=2, tp_size=2), config=GQA, init="init_gqa.pt",
         engine=dict(max_slots=2, block_size=8), requests=HANDOFF_REQ),
    dict(name="tenants_tp2", kind="tenants", plugin=dict(dp_size=2, tp_size=2), config=GQA,
         init="init_gqa.pt", engine=dict(max_slots=4, block_size=8), requests=TENANT_REQ,
         adapters=["a", "b"], rank=RANK, targets=TARGETS),
]
WORLD1 = [
    dict(_contract("contract_w1", None)),
    dict(WORLD4[3], name="gqa_w1", plugin=None),
    dict(WORLD4[6], name="int8_w1", plugin=None),
    dict(WORLD4[-1], name="tenants_w1", plugin=None),
]


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


def _adapter(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cfg = port.TransformerConfig.tiny(**GQA)
    out = {}
    for t in TARGETS:
        i, o = target_shapes(cfg)[t]
        out[f"{t}/lora_a"] = (rng.normal(size=(cfg.num_layers, i, RANK)) * 0.05).astype(np.float32)
        out[f"{t}/lora_b"] = (rng.normal(size=(cfg.num_layers, RANK, o)) * 0.05).astype(np.float32)
    return out


def _tree(flat: dict, module) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        target, leaf = key.split("/")
        tree.setdefault(target, {})[leaf] = module.asarray(value)
    return tree


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_engine")
    _reset()
    for name, cfg in (("init_ref.pt", REF), ("init_gqa.pt", GQA)):
        _, params = _reference(cfg)
        torch.save(dict(port.params_from_jax(jax.tree.map(np.asarray, params),
                                             port.TransformerConfig.tiny(**cfg))),
                   os.path.join(out, name))
    for i, name in enumerate(("a", "b")):
        np.savez(os.path.join(out, f"{name}.npz"), **_adapter(20 + i))
    debug_launcher(engine_workers.engine_worker, (str(out), WORLD4), num_processes=4)
    threads = torch.get_num_threads()
    try:  # one thread, as each rank runs
        engine_workers.engine_worker(str(out), WORLD1)
    finally:
        torch.set_num_threads(threads)
    _reset()
    names = [c["name"] for c in WORLD4 + WORLD1]
    return out, {n: torch.load(os.path.join(out, f"{n}.pt"), weights_only=False) for n in names}


def _ref_engine(config, **kw):
    model, params = _reference(config)
    spec_k = kw.pop("spec_k", None)
    return jax_serving.ServingEngine(
        model, params, seed=0, spec_decode=JaxSpecConfig(k=spec_k) if spec_k else None, **kw)


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
        assert len(other["tables"]) == len(first["tables"])
        for a, b in zip(other["tables"], first["tables"]):
            np.testing.assert_array_equal(a, b)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def audited():
    engine = _ref_engine(REF, **AUDITED)
    tokens = _ref_run(engine, AUDITED_REQ)
    tokens.update(_ref_run(engine, AGAIN))
    return tokens, engine.trace_counts(), engine.prefix_cache.cow_copies_total


@pytest.mark.parametrize("name", ["contract_fsdp4", "contract_tp4", "contract_fsdp2_tp2",
                                  "contract_w1"])
def test_audited_engine_traffic_matches_the_reference(records, audited, name):
    """The reference's audited-engine traffic: exactly its tokens, its
    prefill buckets (at least 2), verify widths (at least 1) and one decode
    build, the copy-on-write taken as often; every rank's events and block
    tables equal."""
    _, recs = records
    rec = recs[name]
    tokens, traces, cow = audited
    assert rec["tokens"] == tokens
    counts = rec["trace_counts"]
    assert counts["prefill"] == traces["prefill"] >= 2
    assert counts["verify"] == traces["verify"] >= 1
    assert counts["decode"] == traces["decode"] == 1
    assert rec["cow"] == cow >= 1
    if name != "contract_w1":
        _ranks_agree(rec)


@pytest.fixture(scope="module")
def gqa_reference():
    """The reference engine's greedy tokens for GQA_REQ."""
    return _ref_run(_ref_engine(GQA, max_slots=4, block_size=8), GQA_REQ)


@pytest.mark.parametrize("name", ["gqa_tp2", "gqa_tp4"])
def test_gqa_logits_match_world_one_and_tokens_the_reference(records, gqa_reference, name):
    _, recs = records
    rec, one = recs[name], recs["gqa_w1"]
    for kind in ("prefill", "decode"):
        assert len(rec["logits"][kind]) == len(one["logits"][kind]) > 0
        for i, (got, want) in enumerate(zip(rec["logits"][kind], one["logits"][kind])):
            _close(got, want, f"{name} {kind} {i}")
    assert rec["tokens"] == one["tokens"] == gqa_reference
    _ranks_agree(rec)


def test_sharded_draft_model_proposes_in_its_own_context(records, gqa_reference):
    """A draft model of the target's weights, prepared under the same tp 2
    plugin, proposes through its own sharded context and pools (the kv heads
    of its rank): every draft is accepted, and the tokens are greedy
    decoding's, the reference engine's without speculation."""
    _, recs = records
    rec = recs["draft_tp2"]
    assert rec["trace_counts"]["draft_step"] == 1 and rec["trace_counts"]["verify"] >= 1
    assert rec["accepted"] > 0
    assert rec["tokens"] == gqa_reference
    _ranks_agree(rec)


def test_int8_scales_under_tp_match_world_one(records):
    """Each rank holds one kv head; the scale arrays are the amax over both
    (the tp group's maximum), equal to world 1's after the first prefill and
    at the end, and the tokens are the reference's int8 engine's."""
    _, recs = records
    rec, one = recs["int8_tp2"], recs["int8_w1"]
    assert len(rec["scales"]) == 2
    for when, (got, want) in enumerate(zip(rec["scales"], one["scales"])):
        for g, w in zip(got, want):
            assert g.shape == w.shape and (w > 0).any()
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=SCALE_TOL, atol=0,
                                       err_msg=f"scales at {when}")
    want = _ref_run(_ref_engine(GQA, max_slots=4, block_size=8, kv_dtype="int8"), INT8_REQ)
    assert rec["tokens"] == one["tokens"] == want
    _ranks_agree(rec)


def test_capacity_levers_under_fsdp_tp_match_the_reference(records):
    """Chunked prefill and a preemption with its swap-in under fsdp 2 x tp 2:
    tokens, swap bytes (the whole model's KV, as the reference counts a
    global array), ``kv_bytes_per_token`` and the census's KV and parameter
    bytes the reference engine's."""
    _, recs = records
    rec = recs["capacity_fsdp2_tp2"]

    class Preempts:
        swap_bytes: list = []

        def record_preempt(self, **fields):
            self.swap_bytes.append(int(fields["swap_bytes"]))

    tele = Preempts()
    tele.swap_bytes = []
    engine = _ref_engine(REF, telemetry=tele, **CAP_ENGINE)
    tokens = _ref_run(engine, CAP_REQ)
    assert rec["tokens"] == tokens
    assert rec["swap_bytes"] == tele.swap_bytes and len(tele.swap_bytes) >= 1
    assert rec["kv_bytes_per_token"] == engine.kv_bytes_per_token
    # the census counts the whole model too: every kv head, every parameter
    cfg = port.TransformerConfig.tiny(**REF)
    whole = sum(p.numel() * 4 for p in port.CausalLM(cfg, device="meta").parameters())
    assert rec["census"]["kv_cache"] == (engine.kv_bytes_per_token
                                         * CAP_ENGINE["num_blocks"] * CAP_ENGINE["block_size"])
    assert rec["census"]["params"] == whole
    assert rec["resumes"] == engine._resumes_total == sum(rec["preempts"].values())
    assert rec["chunks"] > 0 and rec["pool"]["allocated"] == 0 and rec["pool"]["swapped"] == 0
    assert rec["trace_counts"]["decode"] == 1
    _ranks_agree(rec)


@pytest.fixture(scope="module")
def reference_handoff():
    pre = _ref_engine(GQA, role="prefill", max_slots=2, block_size=8)
    dec = _ref_engine(GQA, role="decode", max_slots=2, block_size=8)
    for rid, prompt, kw in HANDOFF_REQ:
        pre.add_request(list(prompt), request_id=rid, **kw)
    manifests = []
    for _ in range(300):
        if not (pre.has_work or dec.has_work):
            break
        pre.step()
        for m in pre.pop_manifests():
            manifests.append((m.request_id, m.nbytes, m.n_blocks, m.bytes_per_block()))
            dec.acquire(m)
        dec.step()
    colocated = _ref_run(_ref_engine(GQA, max_slots=2, block_size=8), HANDOFF_REQ)
    return ({rid: dec.result(rid) for rid, _, _ in HANDOFF_REQ}, manifests,
            pre.transfer_gauges(), dec.transfer_gauges(), colocated)


@pytest.mark.parametrize("name", ["handoff_tp2_to_w1", "handoff_tp4_to_w1", "handoff_w1_to_tp2"])
def test_handoffs_between_tp_and_world_one(records, reference_handoff, name):
    """A manifest carries the whole model's KV: a tp prefill engine's seats
    in an unsharded decode engine and the other way round, with the
    colocated run's tokens, the reference's manifest bytes and gauges, and
    no prefill on the decode side."""
    _, recs = records
    rec = recs[name]
    tokens, manifests, pre_gauges, dec_gauges, colocated = reference_handoff
    assert tokens == colocated
    assert rec["tokens"] == colocated
    assert rec["manifests"] == manifests
    assert rec["prefill_gauges"] == pre_gauges
    assert rec["decode_gauges"] == dec_gauges
    assert rec["decode_prefills"] == 0


def test_mixed_tenants_under_tp_match_the_reference(records):
    """Two adapters and the base (``tests/test_adapters.py:412-455``) under
    tp 2: tokens the reference engine's; the registry's stacks hold each
    rank's share (B's columns, A's rows), which put together are world 1's
    bit for bit."""
    out, recs = records
    rec, one = recs["tenants_tp2"], recs["tenants_w1"]
    assert rec["split"] and not one["split"]
    assert rec["stacks"].keys() == one["stacks"].keys()
    for k, t in one["stacks"].items():
        assert torch.equal(rec["stacks"][k], t), k
    model, params = _reference(GQA)
    lcfg = JaxLoraConfig(rank=RANK, alpha=2.0 * RANK, target_modules=TARGETS)
    reg = JaxRegistry(JaxConfig.tiny(**GQA), capacity=4, max_rank=RANK, target_modules=TARGETS)
    for i, name in enumerate(("a", "b")):
        reg.load(name, _tree(_adapter(20 + i), jnp), lcfg)
    engine = jax_serving.ServingEngine(model, params, adapters=reg, max_slots=4, block_size=8)
    want = _ref_run(engine, TENANT_REQ)
    assert rec["tokens"] == one["tokens"] == want
    assert len(set(map(tuple, want.values()))) > 1
