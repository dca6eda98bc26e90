"""Speculative decoding in the port against the JAX reference, on the CPU.

Mirrors ``tests/test_speculation.py``: ``SpecConfig``'s checks, the
n-gram lookup (on both packages, and on seeded random contexts), the
engine's propose / verify / commit loop and the draft model's cache
discipline, and the serving contracts (the k-token reservation and its
clamp, one verify build a width, rebuild-free toggles, copy-on-write
before a speculative write into a shared block).

Greedy tokens of the port equal the reference's and the plain engine's
for the n-gram arm and the draft-model arm, and so do the accept counts
(proposed, accepted, rounds). Under sampling the port's random stream is
its own (``torch.Generator`` Gumbel noise, not ``jax.random``), so the
sampled identities are held within the port: ``k = 0`` against the plain
engine, and single-slot sampled speculation against the plain engine.
Tokens are compared exactly.
"""

from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu.serving as jax_serving  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu_torch import CausalLM, TransformerConfig, params_from_jax  # noqa: E402
from accelerate_tpu_torch import serving  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402

PACKAGES = {"port": serving, "reference": jax_serving}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _carry(params, jax_cfg):
    """A port CausalLM on the CPU holding the reference's ``params``."""
    cfg = TransformerConfig.tiny(**{f: getattr(jax_cfg, f) for f in (
        "vocab_size", "num_layers", "max_seq_len")})
    model = CausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = JaxConfig.tiny(max_seq_len=64)
    model = JaxCausalLM(cfg)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return cfg, model, params, _carry(params, cfg)


@pytest.fixture(scope="module")
def draft_pair():
    """The reference's self-consistent pair: the target's layers >= 1 add
    exact zeros (o_proj and down_proj zeroed) and the 1-layer draft holds
    its layer 0, embedding and head, so the draft predicts the target."""
    cfg = JaxConfig.tiny(max_seq_len=64, num_layers=3)
    target = JaxCausalLM(cfg)
    params = nn.unbox(target.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    for block, proj in (("attn", "o_proj"), ("mlp", "down_proj")):
        params["layers"][block][proj] = jax.tree_util.tree_map(
            lambda x: x.at[1:].set(0.0), params["layers"][block][proj])
    dcfg = replace(cfg, num_layers=1)
    draft = JaxCausalLM(dcfg)
    draft_params = dict(params)
    draft_params["layers"] = jax.tree_util.tree_map(lambda x: x[:1], params["layers"])
    return dict(ref=(target, params, draft, draft_params),
                port=(_carry(params, cfg), _carry(draft_params, dcfg)))


def _drain(engine, prompts, max_new=8, temperature=0.0):
    rids = [engine.add_request(list(p), max_new_tokens=max_new, temperature=temperature)
            for p in prompts]
    for _ in engine.stream():
        pass
    return [engine.result(r) for r in rids]


def _spec_counts(engine) -> dict:
    spec = engine.summary()["speculation"]
    return {k: spec[k] for k in ("rounds", "proposed", "accepted", "accept_rate")}


# ---------------------------------------------------------------------- #
# config and n-gram lookup
# ---------------------------------------------------------------------- #
def test_spec_config_validates():
    with pytest.raises(ValueError, match="k must be >= 0"):
        serving.SpecConfig(k=-1)
    with pytest.raises(ValueError, match="method"):
        serving.SpecConfig(method="medusa")
    with pytest.raises(ValueError, match="draft_model"):
        serving.SpecConfig(method="draft_model")
    with pytest.raises(ValueError, match="min_ngram"):
        serving.SpecConfig(min_ngram=3, max_ngram=2)
    assert serving.SpecConfig(k=0).k == 0
    assert serving.SpecConfig(k=0, method="draft_model").method == "draft_model"
    a, b = serving.SpecConfig(), serving.SpecConfig()
    assert a != b and len({a, b}) == 2  # eq=False: configs hash by identity


def test_draft_proposer_rejects_mismatched_configs(tiny_pair):
    cfg, _, _, port = tiny_pair
    for kw, match in ((dict(vocab_size=cfg.vocab_size * 2), "vocab"),
                      (dict(max_seq_len=cfg.max_seq_len // 2), "max_seq_len")):
        draft = CausalLM(replace(port.config, **kw), device="cpu")
        with pytest.raises(ValueError, match=match):
            serving.ServingEngine(port, max_slots=2, block_size=4, spec_decode=serving.SpecConfig(
                k=2, method="draft_model", draft_model=draft))


def test_ngram_lookup_proposes_continuation_of_trailing_ngram(pkg):
    p = pkg.NGramProposer(pkg.SpecConfig(k=3))
    assert p.lookup([1, 2, 3, 4, 9, 8, 3, 4], 3) == [9, 8, 3]


def test_ngram_lookup_prefers_longest_then_most_recent(pkg):
    p = pkg.NGramProposer(pkg.SpecConfig(k=2, max_ngram=2))
    assert p.lookup([5, 6, 9, 5, 6, 7, 5, 6], 2) == [7, 5]
    q = pkg.NGramProposer(pkg.SpecConfig(k=1, max_ngram=2))
    assert q.lookup([6, 1, 5, 6, 2, 5, 6], 1) == [2]


def test_ngram_lookup_miss_and_degenerate_inputs(pkg):
    p = pkg.NGramProposer(pkg.SpecConfig(k=4))
    assert p.lookup([1, 2, 3, 4, 5], 4) == [] and p.misses == 1
    assert p.lookup([7], 4) == [] and p.lookup([1, 2, 1, 2], 0) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_lookup_matches_the_reference_on_random_contexts(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 40))
        context = rng.integers(0, 6, n).tolist()  # a small alphabet repeats
        k = int(rng.integers(0, 6))
        cfg = dict(k=k, max_ngram=int(rng.integers(1, 5)), min_ngram=1)
        assert (serving.NGramProposer(serving.SpecConfig(**cfg)).lookup(context, k)
                == jax_serving.NGramProposer(jax_serving.SpecConfig(**cfg)).lookup(context, k))


# ---------------------------------------------------------------------- #
# parity: speculation never changes the stream
# ---------------------------------------------------------------------- #
def test_k0_and_spec_none_match_plain_engine_generate_and_reference(tiny_pair):
    cfg, model, params, port = tiny_pair
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, cfg.vocab_size, 5)) for _ in range(3)]
    want = _drain(jax_serving.ServingEngine(model, params, max_slots=2, block_size=4, seed=2),
                  prompts)
    plain = serving.ServingEngine(port, max_slots=2, block_size=4, seed=2)
    k0 = serving.ServingEngine(port, max_slots=2, block_size=4, seed=2,
                               spec_decode=serving.SpecConfig(k=0))
    assert _drain(plain, prompts) == want and _drain(k0, prompts) == want
    dense = generate(port, torch.as_tensor([prompts[0]]), max_new_tokens=8)
    assert dense[0, len(prompts[0]):].tolist() == want[0]
    assert k0.trace_counts()["verify"] == 0


def test_k0_parity_holds_under_sampling(tiny_pair):
    _, _, _, port = tiny_pair
    prompts = [[1, 2, 3, 4, 5]]
    plain = serving.ServingEngine(port, max_slots=2, block_size=4, seed=5)
    k0 = serving.ServingEngine(port, max_slots=2, block_size=4, seed=5,
                               spec_decode=serving.SpecConfig(k=0))
    assert _drain(k0, prompts, temperature=0.9) == _drain(plain, prompts, temperature=0.9)


def test_greedy_ngram_speculation_matches_plain_engine_and_reference(tiny_pair):
    """Repetitive prompts with multi-slot churn: tokens equal the plain
    engine's and the reference's, and so do rounds, proposed and accepted
    drafts."""
    _, model, params, port = tiny_pair
    prompts = [[7, 8, 9] * 4, [3, 4] * 5, [5, 6, 5, 6, 5, 6]]
    ref = jax_serving.ServingEngine(model, params, max_slots=2, block_size=4, seed=0,
                                    spec_decode=jax_serving.SpecConfig(k=3))
    on = serving.ServingEngine(port, max_slots=2, block_size=4, seed=0,
                               spec_decode=serving.SpecConfig(k=3))
    want = _drain(serving.ServingEngine(port, max_slots=2, block_size=4, seed=0), prompts,
                  max_new=12)
    assert _drain(ref, prompts, max_new=12) == want
    assert _drain(on, prompts, max_new=12) == want
    assert _spec_counts(on) == _spec_counts(ref)
    assert _spec_counts(on)["proposed"] > 0 and _spec_counts(on)["accepted"] > 0
    recs = [(r["spec_proposed"], r["spec_accepted"]) for r in on.stats.requests]
    assert recs == [(r["spec_proposed"], r["spec_accepted"]) for r in ref.stats.requests]


@pytest.mark.parametrize("method", ["ngram", "draft_model"])
def test_single_slot_sampled_speculation_matches_plain_engine(tiny_pair, draft_pair, method):
    """temperature 0.8, one slot: the verify pass's column j samples with
    the noise plain decode's j-th step would draw, and the generator ends
    where the emitted tokens leave it, so sampled streams agree exactly."""
    _, _, _, port = tiny_pair
    if method == "draft_model":
        port, draft = draft_pair["port"]
        spec = serving.SpecConfig(k=3, method="draft_model", draft_model=draft)
    else:
        spec = serving.SpecConfig(k=3)
    prompts = [[2, 3] * 6]
    off = serving.ServingEngine(port, max_slots=1, block_size=4, seed=11)
    on = serving.ServingEngine(port, max_slots=1, block_size=4, seed=11, spec_decode=spec)
    want = _drain(off, prompts, max_new=16, temperature=0.8)
    assert _drain(on, prompts, max_new=16, temperature=0.8) == want
    if method == "draft_model":
        # verify rounds ran and emitted more than one token (a sampled
        # n-gram tail rarely repeats, so the n-gram arm mostly decodes
        # plainly, as in the reference's test)
        assert _spec_counts(on)["accepted"] > 0
    assert _drain(on, prompts, max_new=16, temperature=0.8) == _drain(
        off, prompts, max_new=16, temperature=0.8)


def test_bad_draft_model_only_lowers_accept_rate(tiny_pair):
    """A draft of the right shapes and other weights: tokens still equal
    the plain engine's and the reference's; accept counts equal the
    reference's."""
    cfg, model, params, port = tiny_pair
    bad = nn.unbox(model.init(jax.random.PRNGKey(99), jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(4)
    prompts = [list(rng.integers(1, cfg.vocab_size, 6)) for _ in range(2)]
    ref = jax_serving.ServingEngine(model, params, max_slots=2, block_size=4, seed=0,
                                    spec_decode=jax_serving.SpecConfig(
                                        k=3, method="draft_model", draft_model=model,
                                        draft_params=bad))
    on = serving.ServingEngine(port, max_slots=2, block_size=4, seed=0,
                               spec_decode=serving.SpecConfig(
                                   k=3, method="draft_model", draft_model=_carry(bad, cfg)))
    want = _drain(serving.ServingEngine(port, max_slots=2, block_size=4, seed=0), prompts,
                  max_new=10)
    assert _drain(ref, prompts, max_new=10) == want
    assert _drain(on, prompts, max_new=10) == want
    assert _spec_counts(on) == _spec_counts(ref)
    assert _spec_counts(on)["accept_rate"] < 1.0


def test_perfect_draft_accepts_everything(draft_pair):
    target, params, draft, draft_params = draft_pair["ref"]
    port_target, port_draft = draft_pair["port"]
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    ref = jax_serving.ServingEngine(target, params, max_slots=2, block_size=4, seed=0,
                                    spec_decode=jax_serving.SpecConfig(
                                        k=4, method="draft_model", draft_model=draft,
                                        draft_params=draft_params))
    on = serving.ServingEngine(port_target, max_slots=2, block_size=4, seed=0,
                               spec_decode=serving.SpecConfig(k=4, method="draft_model",
                                                              draft_model=port_draft))
    want = _drain(serving.ServingEngine(port_target, max_slots=2, block_size=4, seed=0),
                  prompts, max_new=20)
    assert _drain(ref, prompts, max_new=20) == want
    assert _drain(on, prompts, max_new=20) == want
    spec = _spec_counts(on)
    assert spec == _spec_counts(ref)
    assert spec["accept_rate"] == 1.0 and 0 < spec["rounds"] <= 8
    counts = on.trace_counts()
    assert counts["verify"] == 1 and counts["draft_step"] == 1 and counts["decode"] == 0


def test_draft_cache_follows_engine_block_tables(draft_pair):
    """Slot churn onto recycled blocks with the draft attached: stale draft
    KV of a block's earlier tenant never leaks into proposals, so tokens
    and accept counts equal the reference's."""
    target, params, draft, draft_params = draft_pair["ref"]
    port_target, port_draft = draft_pair["port"]
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, 1024, 5)) for _ in range(5)]
    ref = jax_serving.ServingEngine(target, params, max_slots=2, block_size=4, seed=0,
                                    spec_decode=jax_serving.SpecConfig(
                                        k=3, method="draft_model", draft_model=draft,
                                        draft_params=draft_params))
    on = serving.ServingEngine(port_target, max_slots=2, block_size=4, seed=0,
                               spec_decode=serving.SpecConfig(k=3, method="draft_model",
                                                              draft_model=port_draft))
    want = _drain(serving.ServingEngine(port_target, max_slots=2, block_size=4, seed=0),
                  prompts, max_new=10)
    assert _drain(ref, prompts, max_new=10) == want
    assert _drain(on, prompts, max_new=10) == want
    assert _spec_counts(on) == _spec_counts(ref)


# ---------------------------------------------------------------------- #
# serving contracts
# ---------------------------------------------------------------------- #
def test_admit_reserves_k_lookahead_blocks(pkg):
    sched = pkg.ContinuousScheduler(max_slots=2, pool=pkg.BlockPool(num_blocks=9, block_size=4))
    sched.lookahead_tokens = 4
    sched.submit(pkg.Request(prompt=[1] * 4, max_new_tokens=4))
    slot = sched.admit()[0]
    assert len(slot.blocks) == 3 and slot.lookahead == 4  # 12 tokens, not 8


def test_lookahead_clamps_at_table_capacity(pkg):
    sched = pkg.ContinuousScheduler(max_slots=1, pool=pkg.BlockPool(num_blocks=17, block_size=4),
                                    max_table_blocks=4)
    sched.lookahead_tokens = 8
    sched.submit(pkg.Request(prompt=[1] * 8, max_new_tokens=8))
    slot = sched.admit()[0]
    assert len(slot.blocks) == 4 and slot.lookahead == 0


def test_verify_built_once_and_toggles_rebuild_nothing(tiny_pair, draft_pair):
    """One verify build for its width, one draft step; an off-on-off-on
    sequence over both proposers replays built programs only, and the
    decode step is built once across it all."""
    _, _, _, port = tiny_pair
    ngram = serving.SpecConfig(k=3)
    engine = serving.ServingEngine(port, max_slots=2, block_size=4, seed=0, spec_decode=ngram)
    prompts = [[7, 8] * 5, [1, 2, 3] * 3]
    want = _drain(engine, prompts, max_new=10)
    assert engine.trace_counts()["verify"] == 1
    engine.set_speculation(None)
    assert _drain(engine, prompts, max_new=10) == want
    warm = engine.trace_counts()
    engine.set_speculation(ngram)
    assert _drain(engine, prompts, max_new=10) == want
    engine.set_speculation(None)
    assert _drain(engine, prompts, max_new=10) == want
    assert engine.trace_counts() == warm and warm["decode"] == 1

    target, draft = draft_pair["port"]
    spec = serving.SpecConfig(k=3, method="draft_model", draft_model=draft)
    engine = serving.ServingEngine(target, max_slots=2, block_size=4, seed=0)
    want = _drain(engine, prompts, max_new=10)
    for toggle in (spec, None, spec):
        engine.set_speculation(toggle)
        assert _drain(engine, prompts, max_new=10) == want
    counts = engine.trace_counts()
    assert counts["verify"] == 1 and counts["draft_step"] == 1 and counts["decode"] == 1
    engine.set_speculation(None)
    engine.set_speculation(spec)
    assert _drain(engine, prompts, max_new=10) == want and engine.trace_counts() == counts


def test_speculative_write_into_shared_block_cows_first(tiny_pair):
    _, model, params, port = tiny_pair
    kw = dict(max_slots=1, block_size=4, seed=0, prefix_cache=True, model_fingerprint="fp")
    ref = jax_serving.ServingEngine(model, params, spec_decode=jax_serving.SpecConfig(k=3), **kw)
    engine = serving.ServingEngine(port, spec_decode=serving.SpecConfig(k=3), **kw)
    template = list(range(1, 13))
    for e in (ref, engine):
        _drain(e, [template], max_new=6)
    before = engine.prefix_cache.cow_copies_total
    out = _drain(engine, [template], max_new=6)
    assert engine.prefix_cache.cow_copies_total > before
    assert out == _drain(ref, [template], max_new=6)
    assert engine.prefix_cache.stats() == ref.prefix_cache.stats()
    cold = serving.ServingEngine(port, max_slots=1, block_size=4, seed=0)
    assert _drain(cold, [template], max_new=6) == out


def test_spec_observability_records_and_counters(draft_pair):
    from accelerate_tpu_torch.telemetry import PrometheusTextSink, StepTelemetry

    target, draft = draft_pair["port"]
    tele = StepTelemetry(True)
    prom = tele.add_sink(PrometheusTextSink(path=None))
    engine = serving.ServingEngine(target, max_slots=2, block_size=4, seed=0, telemetry=tele,
                                   spec_decode=serving.SpecConfig(k=4, method="draft_model",
                                                                  draft_model=draft))
    # 16 new tokens: the prefill token and three whole k=4 rounds
    _drain(engine, [[3, 1, 4, 1, 5]], max_new=16)
    rec = next(r for r in tele.records if r.get("kind") == "serve")
    assert rec["spec_proposed"] == 12 and rec["spec_accepted"] == 12 and rec["accept_rate"] == 1.0
    span = next(r for r in tele.records if r.get("kind") == "span")
    assert span["accept_rate"] == 1.0
    gauges = engine._gauge_fields()
    assert gauges["spec_accept_rate"] == 1.0
    assert gauges["spec_rounds"] == engine.summary()["speculation"]["rounds"] == 3
    text = prom.render()
    for metric in ("serve_spec_proposed_total", "serve_spec_accepted_total",
                   "serve_spec_accept_rate"):
        assert f"accelerate_tpu_{metric}" in text
    tele.close()
