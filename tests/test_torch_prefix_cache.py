"""Prefix caching in the port against the JAX reference, on the CPU.

Mirrors ``tests/test_prefix_cache.py`` for the parts ported:

* ``BlockPool``'s refcounts, content index and LRU, each contract a case
  run on both packages; the same seeded random op sequence on both pools
  leaves the same free list, refcounts, LRU order, index and stats after
  every op;
* ``prefix_keys``: the reference's bytes for the same fingerprint,
  adapter and tokens; ``PrefixCache`` isolating tenants;
* the engine on the reference's tiny model (its params carried over with
  ``params_from_jax``; both engines given one ``model_fingerprint``, since
  the default hashes the config's repr, which differs between the
  packages): greedy tokens equal to the reference's, cold and warm, with a
  full-prompt hit and its copy-on-write, and the same hit, saved-token and
  copy counts; the donor chain bit for bit after the copy; toggles on a
  warm engine rebuild nothing; a pool that cannot seat the rest releases
  the acquired chain; the gauges, spans and Prometheus lines.

Tokens are compared exactly: greedy argmax of fp32 logits.
"""

import random

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

PACKAGES = {"port": serving, "reference": jax_serving}
FINGERPRINT = "tiny-test-model"


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = JaxConfig.tiny(max_seq_len=64)
    model = JaxCausalLM(cfg)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port_cfg = TransformerConfig.tiny(max_seq_len=64)
    port = CausalLM(port_cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, port_cfg), strict=True)
    return model, params, port


def _engines(tiny_pair, **kw):
    """(reference engine, port engine) with the same options."""
    model, params, port = tiny_pair
    kw.setdefault("model_fingerprint", FINGERPRINT)
    return (jax_serving.ServingEngine(model, params, **kw), serving.ServingEngine(port, **kw))


def _drain(engine, prompt, max_new=6):
    rid = engine.add_request(list(prompt), max_new_tokens=max_new)
    for _ in engine.stream():
        pass
    return engine.result(rid)


def _invariant(pool) -> bool:
    return pool.num_free + pool.num_allocated + pool.num_cached == pool.num_blocks - 1


# ---------------------------------------------------------------------- #
# pool contracts, each on both packages
# ---------------------------------------------------------------------- #
def test_refcount_acquire_release_roundtrip(pkg):
    pool = pkg.BlockPool(num_blocks=8, block_size=4)
    blocks = pool.allocate(2)
    assert all(pool.refcount(b) == 1 for b in blocks)
    pool.acquire(blocks)
    assert all(pool.refcount(b) == 2 for b in blocks) and pool.num_shared == 2
    pool.free(blocks)
    assert all(pool.refcount(b) == 1 for b in blocks) and pool.num_free == 5
    pool.free(blocks)
    assert all(pool.refcount(b) == 0 for b in blocks) and pool.num_free == 7
    assert _invariant(pool)


def test_free_while_shared_keeps_block_live_and_double_free_raises(pkg):
    pool = pkg.BlockPool(num_blocks=8, block_size=4)
    (b,) = pool.allocate(1)
    pool.acquire([b])
    pool.free([b])
    assert pool.refcount(b) == 1 and b not in pool._free
    pool.free([b])
    with pytest.raises(ValueError, match="not allocated"):
        pool.free([b])
    assert _invariant(pool)


def test_acquire_unknown_block_raises_and_rolls_back(pkg):
    pool = pkg.BlockPool(num_blocks=8, block_size=4)
    blocks = pool.allocate(2)
    with pytest.raises(ValueError, match="neither allocated nor cached"):
        pool.acquire(blocks + [99])
    assert all(pool.refcount(b) == 1 for b in blocks) and _invariant(pool)


def test_published_block_retires_to_cache_and_is_reacquirable(pkg):
    pool = pkg.BlockPool(num_blocks=8, block_size=4)
    (b,) = pool.allocate(1)
    key = b"k" * 32
    assert pool.publish(b, key) == b
    pool.free([b])
    assert pool.num_cached == 1 and pool.num_free == 6 and pool.lookup([key]) == [b]
    pool.acquire([b])
    assert pool.refcount(b) == 1 and pool.num_cached == 0 and _invariant(pool)


def test_publish_first_writer_wins(pkg):
    pool = pkg.BlockPool(num_blocks=8, block_size=4)
    a, b = pool.allocate(2)
    key = b"same-key" * 4
    assert pool.publish(a, key) == a and pool.publish(b, key) == a
    assert pool.lookup([key]) == [a]


def test_lru_eviction_prefers_coldest_and_never_touches_refcounted(pkg):
    pool = pkg.BlockPool(num_blocks=6, block_size=4)
    blocks = pool.allocate(5)
    keys = [bytes([i]) * 32 for i in range(5)]
    for b, k in zip(blocks, keys):
        pool.publish(b, k)
    pool.free(blocks)
    assert pool.num_cached == 5 and pool.num_free == 0
    pool.acquire([blocks[0]])
    got = pool.allocate(2)
    assert blocks[0] not in got and pool.lookup([keys[0]]) == [blocks[0]]
    assert pool.lookup([keys[1]]) == [] and pool.evictions_total == 2 and _invariant(pool)


def test_can_allocate_counts_cached_as_capacity(pkg):
    pool = pkg.BlockPool(num_blocks=6, block_size=4)
    blocks = pool.allocate(5)
    for i, b in enumerate(blocks):
        pool.publish(b, bytes([i]) * 32)
    pool.free(blocks)
    assert pool.num_free == 0 and pool.can_allocate(5) and not pool.can_allocate(6)


def test_clear_cache_returns_lru_blocks_to_free_list(pkg):
    pool = pkg.BlockPool(num_blocks=6, block_size=4)
    blocks = pool.allocate(3)
    for i, b in enumerate(blocks):
        pool.publish(b, bytes([i]) * 32)
    pool.free(blocks[:2])
    pool.clear_cache()
    assert pool.num_cached == 0 and pool.num_free == 4
    assert pool.lookup([bytes([2]) * 32]) == [] and pool.refcount(blocks[2]) == 1
    assert _invariant(pool)


def _pool_state(pool) -> dict:
    stats = pool.stats()
    return {"free": list(pool._free), "ref": dict(pool._ref), "lru": list(pool._lru),
            "index": dict(pool._index), "hash_of": dict(pool._hash_of),
            "stats": {k: stats[k] for k in serving.BlockPool(2, 1).stats()}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_sequence_leaves_both_pools_identical(seed):
    """allocate / free / acquire / publish / warm hit / lookup / unpublish
    / clear, chosen by one seeded generator and applied to both pools: the
    free list, refcounts, LRU order, index and stats agree after every op,
    as does every op's result (allocated ids, canonical blocks, lookups).
    The reference's stats add only its swap ledger, which stays empty."""
    rng = random.Random(seed)
    ref, got = jax_serving.BlockPool(17, 4), serving.BlockPool(17, 4)
    assert set(ref.stats()) - set(got.stats()) == {"swapped", "swap_outs_total",
                                                   "swap_ins_total"}
    held: list[int] = []
    published = 0
    for _ in range(1500):
        op = rng.random()
        if op < 0.3 and got.can_allocate(n := rng.randint(1, 3)):
            out = [pool.allocate(n) for pool in (ref, got)]
            held.extend(out[1])
        elif op < 0.5 and held:
            b = held.pop(rng.randrange(len(held)))
            out = [pool.free([b]) for pool in (ref, got)]
        elif op < 0.62 and held:
            b = held[rng.randrange(len(held))]
            out = [pool.acquire([b]) for pool in (ref, got)]
            held.append(b)
        elif op < 0.77 and held:
            b = held[rng.randrange(len(held))]
            key = (published % 11).to_bytes(4, "big") * 8  # keys repeat: first writer wins
            out = [pool.publish(b, key) for pool in (ref, got)]
            published += 1
        elif op < 0.85 and got.num_cached:
            b = list(got._lru)[rng.randrange(got.num_cached)]
            out = [pool.acquire([b]) for pool in (ref, got)]
            held.append(b)
        elif op < 0.93:
            keys = [(i % 11).to_bytes(4, "big") * 8 for i in range(rng.randint(0, 4))]
            out = [pool.lookup(keys) for pool in (ref, got)]
        elif op < 0.99:
            b = rng.randrange(1, 17)
            out = [pool.unpublish(b) for pool in (ref, got)]
        else:
            out = [pool.clear_cache() for pool in (ref, got)]
        assert out[0] == out[1]
        assert _pool_state(ref) == _pool_state(got)
        assert _invariant(got)
    for b in held:
        ref.free([b])
        got.free([b])
    assert _pool_state(ref) == _pool_state(got) and got.num_allocated == 0


# ---------------------------------------------------------------------- #
# keys
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("fingerprint,adapter,n_tokens,block_size", [
    ("fp", None, 10, 4), ("fp", "tenant-a", 16, 4), ("0123abcd", None, 37, 16),
    ("", None, 3, 4), ("fp2", "tenant-b", 64, 8),
])
def test_prefix_keys_are_the_reference_bytes(fingerprint, adapter, n_tokens, block_size):
    tokens = np.random.default_rng(n_tokens).integers(0, 2**40, n_tokens).tolist()
    want = jax_serving.prefix_keys(fingerprint, adapter, tokens, block_size)
    assert serving.prefix_keys(fingerprint, adapter, tokens, block_size) == want
    assert len(want) == n_tokens // block_size


def test_prefix_keys_are_rolling_and_fold_in_adapter_and_fingerprint(pkg):
    toks = list(range(10))
    keys = pkg.prefix_keys("fp", None, toks, block_size=4)
    assert len(keys) == 2
    other = pkg.prefix_keys("fp", None, toks[:4] + [99] * 4, block_size=4)
    assert other[0] == keys[0] and other[1] != keys[1]
    shifted = pkg.prefix_keys("fp", None, [99] + toks[1:], block_size=4)
    assert shifted[0] != keys[0] and shifted[1] != keys[1]
    base = pkg.prefix_keys("fp", None, toks[:8], 4)
    assert set(pkg.prefix_keys("fp", "tenant-a", toks[:8], 4)).isdisjoint(base)
    assert set(pkg.prefix_keys("fp2", None, toks[:8], 4)).isdisjoint(base)


def test_prefix_cache_match_isolates_tenants(pkg):
    pool = pkg.BlockPool(num_blocks=8, block_size=4)
    cache = pkg.PrefixCache(pool, fingerprint="fp")
    toks = list(range(8))
    blocks = pool.allocate(2)
    cache.publish(toks, "tenant-a", blocks)
    assert cache.match(toks, "tenant-a") == blocks
    assert cache.match(toks, "tenant-b") == [] and cache.match(toks, None) == []
    assert cache.stats()["hits"] == 1 and cache.stats()["lookups"] == 3


# ---------------------------------------------------------------------- #
# the engine against the reference's
# ---------------------------------------------------------------------- #
def test_warm_hit_matches_cold_and_the_reference(tiny_pair):
    """A 4-block template: the first request publishes it, the second hits
    it and prefills its 3-token tail, the third is the template exactly
    (a full-prompt hit: its 1-token tail rewrites the last shared block,
    so that block is copied first). Tokens equal a cold engine's and the
    reference's; hits, saved tokens and copies equal the reference's."""
    template = list(range(1, 17))
    prompts = [template + [21, 22, 23], template + [31, 32], template]
    ref, got = _engines(tiny_pair, max_slots=2, block_size=4, seed=7, prefix_cache=True)
    cold = serving.ServingEngine(tiny_pair[2], max_slots=2, block_size=4, seed=7)
    want = [_drain(ref, p) for p in prompts]
    assert [_drain(got, p) for p in prompts] == want
    assert [_drain(cold, p) for p in prompts] == want
    stats = got.prefix_cache.stats()
    assert stats == ref.prefix_cache.stats()
    assert stats["hits"] == 2 and stats["prefill_tokens_saved_total"] == 16 + 15
    assert stats["cow_copies_total"] == 1
    assert got.trace_counts()["decode"] == 1 and _invariant(got.pool)
    assert got.pool.stats() == {k: v for k, v in ref.pool.stats().items() if k in got.pool.stats()}


def test_cow_leaves_donor_chain_intact_bitwise(tiny_pair):
    """After the full-prompt hit's copy the donor blocks hold the same bits
    in every layer's K and V pools, stay published, and a third identical
    request hits them again; tokens are the reference's."""
    template = list(range(1, 13))  # 3 full blocks of 4
    ref, got = _engines(tiny_pair, max_slots=2, block_size=4, seed=3, prefix_cache=True)
    first = _drain(got, template)
    chain = got.pool.lookup(got.prefix_cache.keys_for(template, None))
    assert len(chain) == 3
    before = [pool[:, chain].clone() for pool in (got.cache.key, got.cache.value)]
    second = _drain(got, template)
    assert got.prefix_cache.cow_copies_total == 1
    for pool, was in zip((got.cache.key, got.cache.value), before):
        assert torch.equal(pool[:, chain], was)
    third = _drain(got, template)
    assert got.prefix_cache.stats()["hits"] == 2 and got.prefix_cache.cow_copies_total == 2
    assert first == second == third == [_drain(ref, template) for _ in range(3)][0]
    assert got.prefix_cache.stats() == ref.prefix_cache.stats()


def test_set_prefix_cache_toggles_on_a_warm_engine_without_rebuild(tiny_pair):
    model, params, port = tiny_pair
    engine = serving.ServingEngine(port, max_slots=2, block_size=4, seed=1)
    ref = jax_serving.ServingEngine(model, params, max_slots=2, block_size=4, seed=1)
    template = list(range(1, 17))
    cold = _drain(engine, template + [5])
    assert cold == _drain(ref, template + [5])
    engine.set_prefix_cache(True, model_fingerprint=FINGERPRINT)
    assert _drain(engine, template + [5]) == cold  # publishes
    assert _drain(engine, template + [5]) == cold  # the first hit builds its tail bucket
    builds = engine.trace_counts()
    assert _drain(engine, template + [5]) == cold
    assert engine.prefix_cache.hits == 2 and engine.trace_counts() == builds
    assert builds["decode"] == 1
    engine.set_prefix_cache(False)
    assert engine.pool.num_cached == 0 and engine.prefix_cache is None
    assert _drain(engine, template + [5]) == cold
    assert engine.trace_counts() == builds


def test_speculation_on_a_warm_prefix_copies_before_verify(tiny_pair):
    """A full-prompt hit seated on the shared chain with n-gram speculation
    on: the speculative write span reaches the last shared block, which is
    copied before the verify pass writes; tokens are the reference's (and a
    cold plain engine's), and so are the copy counts."""
    template = list(range(1, 13))
    ref, got = _engines(tiny_pair, max_slots=2, block_size=4, seed=4, prefix_cache=True)
    ref.set_speculation(jax_serving.SpecConfig(k=3))
    got.set_speculation(serving.SpecConfig(k=3))
    cold = serving.ServingEngine(tiny_pair[2], max_slots=2, block_size=4, seed=4)
    want = _drain(cold, template, max_new=8)
    outs = [[_drain(engine, template, max_new=8) for _ in range(3)] for engine in (ref, got)]
    assert outs[1] == outs[0] == [want] * 3
    assert got.prefix_cache.stats() == ref.prefix_cache.stats()
    assert got.prefix_cache.cow_copies_total == 2 and got.prefix_cache.hits == 2
    assert got.summary()["speculation"]["rounds"] > 0


def test_pool_exhaustion_rolls_back_the_acquired_prefix(pkg, tiny_pair):
    model, params, port = tiny_pair
    kw = dict(max_slots=2, block_size=4, num_blocks=16, prefix_cache=True, seed=2)
    engine = (serving.ServingEngine(port, **kw) if pkg is serving
              else jax_serving.ServingEngine(model, params, **kw))
    template = list(range(1, 17))
    _drain(engine, template, max_new=4)
    assert engine.pool.num_cached == 4
    held = engine.pool.allocate(5)
    # needs 4 shared + 9 private blocks, 6 are free: blocked, chain released
    rid = engine.add_request(template + [7] * 15, max_new_tokens=20)
    engine.step()
    assert engine.result(rid) is None
    assert engine.scheduler.blocked_reasons["pool_exhausted"] >= 1
    pool = engine.pool
    assert pool.num_allocated == 5 and pool.num_cached == 4
    assert all(pool.refcount(b) == 0 for b in pool._lru)
    pool.free(held)
    assert _invariant(pool)


def test_gauges_spans_and_prometheus_export_match_the_reference(tiny_pair):
    from accelerate_tpu.telemetry import PrometheusTextSink as JaxSink
    from accelerate_tpu.telemetry import StepTelemetry as JaxTelemetry
    from accelerate_tpu_torch.telemetry import PrometheusTextSink, StepTelemetry

    model, params, port = tiny_pair
    runs = {}
    for name, tele, sink, make in (
            ("reference", JaxTelemetry(True), JaxSink(path=None),
             lambda t: jax_serving.ServingEngine(model, params, max_slots=2, block_size=4,
                                                 seed=9, prefix_cache=True, telemetry=t,
                                                 model_fingerprint=FINGERPRINT)),
            ("port", StepTelemetry(True), PrometheusTextSink(path=None),
             lambda t: serving.ServingEngine(port, max_slots=2, block_size=4, seed=9,
                                             prefix_cache=True, telemetry=t,
                                             model_fingerprint=FINGERPRINT))):
        tele.add_sink(sink)
        engine = make(tele)
        template = list(range(1, 17))
        outs = [_drain(engine, template + [3]), _drain(engine, template + [4])]
        runs[name] = (engine, outs, sink.render())
        tele.close()
    (ref, ref_outs, _), (got, outs, text) = runs["reference"], runs["port"]
    assert outs == ref_outs
    gauges, ref_gauges = got._gauge_fields(), ref._gauge_fields()
    assert set(gauges) == set(ref_gauges)
    assert gauges == ref_gauges
    assert gauges["prefix_cache_hit_rate"] == 0.5 and gauges["prefill_tokens_saved_total"] == 16
    assert sorted(s.cached_prefix_tokens for s in got.span_log.closed) == [0, 16]
    for metric in ("prefix_cache_hit_rate", "shared_blocks", "cow_copies_total",
                   "prefill_tokens_saved_total"):
        assert f"accelerate_tpu_serve_{metric}" in text
    assert got.summary()["prefix_cache"] == ref.summary()["prefix_cache"]
