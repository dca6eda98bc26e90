"""The port's serving path against the JAX reference, on the CPU.

* The paged ops (``PagedKVState``, ``paged_update``, ``paged_attention``)
  on the same fp32 inputs, made with numpy from a seed: outputs within
  1e-5, pools equal bit for bit, padding in block 0 in both.
* ``ServingEngine`` on the reference's tiny model (its params carried over
  with ``params_from_jax``) over one mixed trace with a fake clock: every
  request's tokens, the admission order, the serve records, the spans and
  ``ServeStats`` must be the reference's.
* The host-side contracts of ``BlockPool``, ``ContinuousScheduler``,
  ``SpanLog`` and ``ServeStats`` (``tests/test_serving.py:44-234``,
  ``tests/test_serving_obs.py``), each a case run on both packages.
* Per-slot sampling, the zero-rebuild contract on the port's counters,
  every option not ported yet raising NotImplementedError naming A9, and
  the four options the prefix, speculation and observability slice ports
  working (``tests/test_torch_prefix_cache.py``,
  ``test_torch_speculation.py`` and ``test_torch_serving_obs.py`` hold
  them against the reference).

The CPU runs the decode step eager; the CUDA graph is held against the
eager step by ``chip_smoke.py`` on the card.
"""

import json
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu.ops.attention as jax_attn  # noqa: E402
import accelerate_tpu.serving as jax_serving  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu_torch import CausalLM, TransformerConfig, params_from_jax  # noqa: E402
from accelerate_tpu_torch import serving  # noqa: E402
from accelerate_tpu_torch.ops import attention as attn  # noqa: E402

PACKAGES = {"port": serving, "reference": jax_serving}
PAGED_TOL = 1e-5


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def tick(self, dt: float = 1.0) -> None:
        self.t += dt

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = JaxConfig.tiny(max_seq_len=64)
    model = JaxCausalLM(cfg)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port_cfg = TransformerConfig.tiny(max_seq_len=64)
    port = CausalLM(port_cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, port_cfg), strict=True)
    return cfg, model, params, port


# ---------------------------------------------------------------------- #
# paged ops
# ---------------------------------------------------------------------- #
PAGED_CASES = {
    # two slots mid-prefill: slot 0 at cache_len 3 with 5 valid of 8 (its
    # padding lands at block 0, offsets 0-2), slot 1 a full 8 from 0
    "prefill": dict(s=8, table=[[5, 2, 9, 0], [3, 7, 1, 8]], cache_len=[3, 0], lengths=[5, 8]),
    "prefill_window": dict(s=8, table=[[5, 2, 9, 0], [3, 7, 1, 8]], cache_len=[3, 0],
                           lengths=[5, 8], window=4),
    # a decode batch at mixed depths with an empty slot in the middle
    "decode": dict(s=1, table=[[4, 6, 0, 0], [0, 0, 0, 0], [1, 3, 5, 2]],
                   cache_len=[6, 0, 13], lengths=[1, 0, 1]),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_update_and_attention_match_reference(case):
    c = PAGED_CASES[case]
    heads, kv_heads, d, bs, nb = 4, 2, 16, 4, 10
    b, s = len(c["table"]), c["s"]
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for h in (heads, kv_heads, kv_heads))
    pools = [rng.standard_normal((nb, bs, kv_heads, d)).astype(np.float32) for _ in range(2)]
    arrays = dict(block_table=np.asarray(c["table"], np.int32),
                  cache_len=np.asarray(c["cache_len"], np.int32),
                  lengths=np.asarray(c["lengths"], np.int32))
    jstate = jax_attn.PagedKVState(**{n: jnp.asarray(a) for n, a in arrays.items()},
                                   num_blocks=nb, block_size=bs)
    jk, jv = jax_attn.paged_update(jnp.asarray(pools[0]), jnp.asarray(pools[1]),
                                   jnp.asarray(k), jnp.asarray(v), jstate)
    want = jax_attn.paged_attention(jnp.asarray(q), jk, jv, jstate, window=c.get("window"))
    state = attn.PagedKVState(**{n: torch.as_tensor(a) for n, a in arrays.items()},
                              num_blocks=nb, block_size=bs)
    pk, pv = (torch.tensor(p) for p in pools)
    attn.paged_update(pk, pv, torch.as_tensor(k), torch.as_tensor(v), state)
    got = attn.paged_attention(torch.as_tensor(q), pk, pv, state, window=c.get("window"))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PAGED_TOL, rtol=PAGED_TOL)
    touched = {int(blk) for row in c["table"] for blk in row} | {0}
    for blk in set(range(nb)) - touched:  # no block outside the tables moved
        np.testing.assert_array_equal(pk[blk].numpy(), pools[0][blk])
    if min(c["lengths"]) < s:  # padding went to the garbage block
        assert not np.array_equal(pk[0].numpy(), pools[0][0])


def test_paged_attention_matches_dense_causal_attention():
    """Paging is an addressing scheme: a prompt written through a scattered
    table and read back equals plain causal attention."""
    rng = np.random.default_rng(0)
    seq, heads, d, bs = 21, 4, 16, 8
    q, k, v = (torch.as_tensor(rng.standard_normal((1, seq, heads, d)).astype(np.float32))
               for _ in range(3))
    cache = attn.PagedKVCache.zeros(1, 12, bs, heads, d, torch.float32, "cpu")
    state = attn.PagedKVState(torch.tensor([[5, 2, 9, 7]]), torch.zeros(1, dtype=torch.long),
                              torch.tensor([seq]), num_blocks=12, block_size=bs)
    attn.paged_update(cache.key[0], cache.value[0], k, v, state)
    got = attn.paged_attention(q, cache.key[0], cache.value[0], state)
    torch.testing.assert_close(got, attn.xla_attention(q, k, v, causal=True),
                               atol=PAGED_TOL, rtol=PAGED_TOL)


# ---------------------------------------------------------------------- #
# the engine against the reference's
# ---------------------------------------------------------------------- #
def _record_admissions(engine, order):
    admit = engine.scheduler.admit

    def recorded():
        slots = admit()
        order.extend(s.request.request_id for s in slots)
        return slots

    engine.scheduler.admit = recorded


def _run_trace(engine, clock, trace):
    order = []
    _record_admissions(engine, order)
    for i, (prompt, n, eos) in enumerate(trace):
        engine.add_request(prompt, max_new_tokens=n, eos_token_id=eos, request_id=f"r{i}")
    events = []
    while engine.has_work:
        events += [(e.request_id, int(e.token), e.done) for e in engine.step()]
        clock.tick(0.25)
    return order, events


def test_engine_matches_reference_on_a_mixed_trace(tiny_pair):
    """Seven requests through three slots and a pool that cannot seat all
    at once: mixed prompt lengths and budgets, one request ending on EOS
    (its slot refills early). Tokens, events, admission order, serve
    records, spans and the stats summary are the reference's."""
    cfg, model, params, port = tiny_pair
    rng = np.random.default_rng(5)
    probe = rng.integers(0, cfg.vocab_size, 6).tolist()
    eos = int(serving.ServingEngine(port, max_slots=1, block_size=8).generate(
        np.asarray([probe]), max_new_tokens=2)[0, -1])
    trace = []
    for i, length in enumerate((3, 17, 8, 1, 30, 5)):
        trace.append((rng.integers(0, cfg.vocab_size, length).tolist(), 9 if i % 2 else 4, None))
    trace.insert(2, (probe, 7, eos))  # finishes on its first decode step
    runs = {}
    for name, engine_of in (("reference", lambda clk: jax_serving.ServingEngine(
            model, params, max_slots=3, block_size=8, num_blocks=12, now=clk)),
            ("port", lambda clk: serving.ServingEngine(
                port, max_slots=3, block_size=8, num_blocks=12, now=clk))):
        clock = FakeClock()
        engine = engine_of(clock)
        order, events = _run_trace(engine, clock, trace)
        runs[name] = (engine, order, events)
    (ref, ref_order, ref_events), (got, order, events) = runs["reference"], runs["port"]
    assert order == ref_order and events == ref_events
    for i in range(len(trace)):
        assert got.result(f"r{i}") == ref.result(f"r{i}"), i
    assert got.result("r2")[-1] == eos and len(got.result("r2")) < 7  # EOS freed its slot
    fields = ("request_id", "prompt_tokens", "new_tokens", "queue_s", "ttft_s", "e2e_s",
              "decode_tokens_per_s")
    assert [{f: r[f] for f in fields} for r in got.stats.requests] == [
        {f: r[f] for f in fields} for r in ref.stats.requests]
    assert got.stats.summary() == ref.stats.summary()
    keys = got.span_log.closed[0].to_record().keys()
    assert [s.to_record() for s in got.span_log.closed] == [
        {k: v for k, v in s.to_record().items() if k in keys} for s in ref.span_log.closed]
    assert got.pool.stats()["allocated"] == 0 and not got.has_work
    # buckets 1, 4, 8, 32; no speculation, so no verify step
    assert got.trace_counts() == {"prefill": 4, "decode": 1, "verify": 0}
    assert got.trace_counts()["prefill"] == ref.trace_counts()["prefill"]


def test_engine_latency_accounting_with_fake_clock(tiny_pair):
    """With one slot the second request waits out the first's generation;
    the injected clock makes queue_s and e2e_s exact."""
    _, _, _, port = tiny_pair
    clock = FakeClock()
    engine = serving.ServingEngine(port, max_slots=1, block_size=8, now=clock)
    r1 = engine.add_request([1, 2, 3], max_new_tokens=3)
    r2 = engine.add_request([4, 5], max_new_tokens=2)
    while engine.has_work:
        engine.step()
        clock.tick()
    recs = {r["request_id"]: r for r in engine.stats.requests}
    # r1: prefill and a decode step at t=0, its last token at t=1; r2 is
    # seated at t=2 and makes both its tokens in that step
    assert recs[r1]["queue_s"] == 0.0 and recs[r1]["e2e_s"] == 1.0
    assert recs[r2]["queue_s"] == 2.0 and recs[r2]["e2e_s"] == 2.0
    assert recs[r1]["new_tokens"] == 3 and recs[r2]["new_tokens"] == 2


def test_engine_sheds_by_queue_bound_and_deadline(tiny_pair):
    _, _, _, port = tiny_pair
    clock = FakeClock()
    engine = serving.ServingEngine(port, max_slots=1, block_size=8, now=clock, max_queue=2,
                                   max_queue_delay_s=1.5)
    ids = [engine.add_request([1, 2], max_new_tokens=3) for _ in range(4)]
    assert [engine.shed_reason(r) for r in ids] == [None, None, "queue_full", "queue_full"]
    while engine.has_work:
        engine.step()
        clock.tick()
    assert engine.result(ids[0]) is not None
    assert engine.shed_reason(ids[1]) == "queue_deadline" and engine.result(ids[1]) is None
    summary = engine.summary()
    assert summary["shed_queue_full"] == 2 and summary["shed_queue_deadline"] == 1
    assert summary["spans"]["spans_shed"] == 3


def test_zero_decode_rebuild_after_warmup(tiny_pair):
    """The reference's contract (``tests/test_serving.py:301``) on the
    port's counters: admissions, evictions, mixed depths and temperatures
    are data in the decode step's buffers, so it is built once; prefill
    stays within the power-of-two bucket budget."""
    cfg, _, _, port = tiny_pair
    rng = np.random.default_rng(3)
    engine = serving.ServingEngine(port, max_slots=3, block_size=8)
    engine.add_request([1, 2, 3], max_new_tokens=2)
    for _ in engine.stream():
        pass
    assert engine.trace_counts()["decode"] == 1
    for i in range(8):
        prompt = rng.integers(0, cfg.vocab_size, (2 + 3 * i % 17,)).tolist()
        engine.add_request(prompt, max_new_tokens=1 + i % 5, temperature=0.5 * (i % 2))
    events = list(engine.stream())
    assert sum(e.done for e in events) == 8
    counts = engine.trace_counts()
    assert counts["decode"] == 1, "decode step rebuilt after warmup"
    assert counts["prefill"] <= int(math.log2(cfg.max_seq_len))


def test_engine_generate_equals_dense_generate(tiny_pair):
    """Paged greedy decoding through the engine == the dense-cache
    ``generate`` (reference ``tests/test_serving.py:145``)."""
    from accelerate_tpu_torch.models.generation import generate

    cfg, _, _, port = tiny_pair
    engine = serving.ServingEngine(port, max_slots=2, block_size=8)
    rng = np.random.default_rng(0)
    for p_len in (3, 8, 13):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, p_len)))
        torch.testing.assert_close(engine.generate(prompt, max_new_tokens=6),
                                   generate(port, prompt, max_new_tokens=6))


# ---------------------------------------------------------------------- #
# sampling
# ---------------------------------------------------------------------- #
def test_sample_tokens_greedy_rows_argmax_and_sampled_rows_in_support():
    logits = torch.as_tensor(np.random.default_rng(1).standard_normal((4, 50)),
                             dtype=torch.float32) * 4
    temps = torch.tensor([0.0, 0.7, 0.0, 1.3])
    top5 = torch.topk(logits, 5).indices
    for seed in range(20):
        out = serving.sample_tokens(logits, torch.Generator().manual_seed(seed), temps, top_k=5)
        assert out[0] == logits[0].argmax() and out[2] == logits[2].argmax()
        assert int(out[1]) in top5[1].tolist() and int(out[3]) in top5[3].tolist()


def test_slot_draw_does_not_depend_on_its_neighbours():
    rng = np.random.default_rng(2)
    logits = torch.as_tensor(rng.standard_normal((4, 50)), dtype=torch.float32)
    other = logits.clone()
    other[[0, 2, 3]] = torch.as_tensor(rng.standard_normal((3, 50)), dtype=torch.float32) * 9
    draws = []
    for lg, temps in ((logits, [0.0, 1.0, 0.0, 0.0]), (other, [2.0, 1.0, 0.5, 0.0])):
        draws.append([int(serving.sample_tokens(lg, torch.Generator().manual_seed(s),
                                                torch.tensor(temps), top_p=0.9)[1])
                      for s in range(16)])
    assert draws[0] == draws[1] and len(set(draws[0])) > 1


def test_sampling_never_draws_a_masked_token():
    logits = torch.full((2, 8), float("-inf"))
    logits[0, 3] = 0.0
    logits[1, 5] = -1e30
    out = serving.sample_tokens(logits, torch.Generator().manual_seed(0), torch.tensor([1.0, 1.0]))
    assert out.tolist() == [3, 5]


# ---------------------------------------------------------------------- #
# host-side contracts, on both packages
# ---------------------------------------------------------------------- #
@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_block_pool_never_hands_out_garbage_block(pkg):
    pool = pkg.BlockPool(num_blocks=8, block_size=4)
    blocks = pool.allocate(7)
    assert 0 not in blocks and sorted(blocks) == list(range(1, 8)) and pool.num_free == 0


def test_block_pool_alloc_free_roundtrip_and_reuse(pkg):
    pool = pkg.BlockPool(num_blocks=10, block_size=4)
    a, b = pool.allocate(3), pool.allocate(2)
    assert pool.num_allocated == 5 and pool.num_free == 4
    pool.free(a)
    c = pool.allocate(4)
    assert set(c) & set(a) and pool.num_allocated == 6
    pool.free(b)
    pool.free(c)
    assert pool.num_free == 9 and pool.num_allocated == 0
    assert pool.stats()["utilization"] == 0.0


def test_block_pool_fragmentation_is_free(pkg):
    pool = pkg.BlockPool(num_blocks=17, block_size=4)
    held = [pool.allocate(2) for _ in range(8)]
    for blocks in held[::2]:
        pool.free(blocks)
    assert pool.num_free == 8 and pool.can_allocate(8)
    assert len(set(pool.allocate(8))) == 8 and pool.num_free == 0


def test_block_pool_rejects_double_free_and_exhaustion(pkg):
    pool = pkg.BlockPool(num_blocks=4, block_size=2)
    blocks = pool.allocate(2)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.allocate(2)
    pool.free(blocks)
    with pytest.raises(ValueError, match="not allocated"):
        pool.free(blocks)
    with pytest.raises(ValueError, match="num_blocks"):
        pkg.BlockPool(num_blocks=1, block_size=2)


def test_blocks_for_tokens_sizing_formula(pkg):
    pool = pkg.BlockPool(num_blocks=8, block_size=16)
    assert [pool.blocks_for_tokens(n) for n in (0, 1, 16, 17, 33)] == [0, 1, 1, 2, 3]


def test_block_ids_come_out_in_the_reference_order():
    ref, got = jax_serving.BlockPool(12, 4), serving.BlockPool(12, 4)
    for pool_ops in ((3, None), (2, 0), (4, None), (1, 1), (2, None)):
        n, free_index = pool_ops
        held = [ref.allocate(n), got.allocate(n)]
        assert held[0] == held[1]
        if free_index is not None:
            ref.free(held[0][free_index:free_index + 1])
            got.free(held[1][free_index:free_index + 1])


def test_scheduler_admits_in_fifo_order_within_capacity(pkg):
    clock = FakeClock()
    sched = pkg.ContinuousScheduler(max_slots=2, pool=pkg.BlockPool(9, 4), now=clock)
    ids = [sched.submit(pkg.Request(prompt=[1] * 4, max_new_tokens=4)) for _ in range(3)]
    clock.tick()
    admitted = sched.admit()
    assert [s.request.request_id for s in admitted] == ids[:2]
    assert all(s.admit_time == 1.0 and s.request.submit_time == 0.0 for s in admitted)
    assert len(sched.queue) == 1 and sched.admit() == []
    clock.tick()
    sched.release(admitted[0])
    refill = sched.admit()
    assert [s.request.request_id for s in refill] == [ids[2]] and refill[0].admit_time == 2.0


def test_scheduler_head_of_queue_blocks_until_pool_can_fund_it(pkg):
    sched = pkg.ContinuousScheduler(max_slots=3, pool=pkg.BlockPool(7, 4), now=FakeClock())
    big = sched.submit(pkg.Request(prompt=[1] * 16, max_new_tokens=4))
    (slot,) = sched.admit()
    assert slot.request.request_id == big
    big2 = sched.submit(pkg.Request(prompt=[1] * 8, max_new_tokens=4))
    small = sched.submit(pkg.Request(prompt=[1] * 2, max_new_tokens=2))
    assert sched.admit() == []
    assert sched.blocked_reasons["pool_exhausted"] == 1
    sched.release(slot)
    assert [s.request.request_id for s in sched.admit()] == [big2, small]


def test_scheduler_rejects_request_larger_than_pool(pkg):
    sched = pkg.ContinuousScheduler(max_slots=1, pool=pkg.BlockPool(4, 4))
    with pytest.raises(ValueError, match="allocatable blocks"):
        sched.submit(pkg.Request(prompt=[1] * 16, max_new_tokens=8))


def test_scheduler_sheds_by_queue_bound_and_deadline(pkg):
    clock = FakeClock()
    sched = pkg.ContinuousScheduler(2, pkg.BlockPool(9, 8), now=clock, max_queue=2)
    reqs = [pkg.Request(prompt=[1, 2], max_new_tokens=4) for _ in range(4)]
    for r in reqs:
        sched.submit(r)
    assert [r.shed_reason for r in reqs] == [None, None, "queue_full", "queue_full"]
    assert list(sched.queue) == reqs[:2] and sched.shed_counts["queue_full"] == 2
    sched = pkg.ContinuousScheduler(2, pkg.BlockPool(9, 8), now=clock, max_queue_delay_s=5.0)
    old, fresh = pkg.Request(prompt=[1], max_new_tokens=2), pkg.Request(prompt=[2], max_new_tokens=2)
    sched.submit(old)
    clock.tick(4.0)
    sched.submit(fresh)
    assert sched.shed_expired() == []
    clock.tick(2.0)
    assert sched.shed_expired() == [old] and old.shed_reason == "queue_deadline"
    assert list(sched.queue) == [fresh] and sched.shed_counts["queue_deadline"] == 1


def test_spans_ordering_records_and_chrome_trace(pkg, tmp_path):
    log = pkg.SpanLog(maxlen=3)
    log.on_submit("good", 1.0, prompt_tokens=4)
    log.on_admit("good", 2.0)
    log.on_prefill("good", 2.5)
    log.on_first_token("good", 3.0)
    span = log.on_finish("good", 5.0, new_tokens=8)
    rec = span.to_record()
    assert (rec["queue_s"], rec["prefill_s"], rec["decode_s"], rec["e2e_s"]) == (1.0, 0.5, 2.0, 4.0)
    log.on_submit("bad", 1.5)
    shed = log.on_shed("bad", 4.0, "queue_deadline")
    assert shed.terminal and shed.to_record()["decode_s"] is None
    assert log.summary() == {"spans_open": 0, "spans_closed": 2, "spans_shed": 1}
    path = pkg.write_chrome_trace(str(tmp_path / "trace.json"), log.closed)
    slices = [e for e in json.load(open(path))["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in slices} == {"queue", "prefill", "decode", "shed:queue_deadline"}
    assert min(e["ts"] for e in slices) == 0.0 and all(e["dur"] >= 0 for e in slices)
    for i in range(4):
        log.on_submit(f"r{i}", float(i))
        log.on_finish(f"r{i}", float(i) + 1.0, 1)
    assert [s.request_id for s in log.closed] == ["r1", "r2", "r3"]


def test_serve_stats_window_and_percentile(pkg):
    stats = pkg.ServeStats(window=4)
    for i in range(10):
        stats.add({"prompt_tokens": 1, "new_tokens": 2, "ttft_s": float(i)})
    stats.add_shed("queue_full")
    s = stats.summary()
    assert len(stats.requests) == 4 and s["requests"] == 10 and s["new_tokens"] == 20
    assert len(stats) == 10  # the lifetime count, as the reference's __len__
    assert s["ttft_s_p50"] == 7.5 and s["shed_total"] == s["shed_queue_full"] == 1
    assert pkg.percentile([3.0, 1.0, 2.0, 10.0], 95) == pytest.approx(8.95)
    assert pkg.percentile([], 50) is None


# ---------------------------------------------------------------------- #
# what is not ported yet
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("option", [
    dict(prefill_chunk_tokens=16), dict(preemption=True), dict(kv_dtype="int8"),
    dict(role="prefill"), dict(role="decode"), dict(transfer_plane=object()),
    dict(adapters=object()),
])
def test_options_not_ported_raise_naming_a9(tiny_pair, option):
    _, _, _, port = tiny_pair
    with pytest.raises(NotImplementedError, match="queue A9"):
        serving.ServingEngine(port, **option)


@pytest.mark.parametrize("method", ["start_http", "health", "drain", "prefix_digest",
                                    "capture_programs", "audit_programs"])
def test_http_plane_and_program_capture_raise_naming_a9(tiny_pair, method):
    _, _, _, port = tiny_pair
    engine = serving.ServingEngine(port, max_slots=1, block_size=8)
    with pytest.raises(NotImplementedError, match="queue A9"):
        getattr(engine, method)()


@pytest.mark.parametrize("option", ["prefix_cache", "spec_decode", "slo", "telemetry"])
def test_options_ported_in_the_serve_slice_work(tiny_pair, option):
    """The four options this slice ports, each on alone: the engine serves
    the plain engine's greedy tokens and the option leaves its trace."""
    from accelerate_tpu_torch.telemetry import StepTelemetry

    _, _, _, port = tiny_pair
    tele = StepTelemetry(True)
    kw = {"prefix_cache": dict(prefix_cache=True), "spec_decode": dict(
        spec_decode=serving.SpecConfig(k=3)), "slo": dict(slo=serving.SLOConfig(
            interval_steps=1, min_requests=1)), "telemetry": dict(telemetry=tele)}[option]
    prompts = [[5, 6, 7] * 3, [5, 6, 7] * 3 + [9]]
    want = [serving.ServingEngine(port, max_slots=2, block_size=4).generate(
        np.asarray([p]), max_new_tokens=6)[0].tolist() for p in prompts]
    engine = serving.ServingEngine(port, max_slots=2, block_size=4, **kw)
    got = [engine.generate(np.asarray([p]), max_new_tokens=6)[0].tolist() for p in prompts]
    assert got == want
    summary = engine.summary()
    if option == "prefix_cache":
        assert summary["prefix_cache"]["hits"] == 1
    elif option == "spec_decode":
        assert summary["speculation"]["proposed"] > 0 and engine.trace_counts()["verify"] == 1
    elif option == "slo":
        assert summary["slo"]["requests_total"] == 2
    else:
        assert {r["kind"] for r in tele.records} >= {"serve", "span", "serve_gauge"}


def test_request_options_and_int8_kv_not_ported_raise_naming_a9(tiny_pair):
    _, _, _, port = tiny_pair
    engine = serving.ServingEngine(port, max_slots=1, block_size=8)
    with pytest.raises(NotImplementedError, match="queue A9"):
        engine.add_request([1, 2], adapter="tenant")
    with pytest.raises(NotImplementedError, match="queue A9"):
        engine.add_request([1, 2], priority=1)
    with pytest.raises(NotImplementedError, match="queue A9"):
        attn.PagedKVState(torch.zeros(1, 2), torch.zeros(1), torch.ones(1), num_blocks=4,
                          block_size=2, kv_dtype="int8")
    assert not engine.has_work
