"""The port's capacity levers against the JAX reference, on the CPU.

Mirrors ``tests/test_capacity.py`` (chunked prefill, preemption with KV
swap and priorities, int8 paged KV), run on both packages where the
reference has a result:

* ``quantize_kv`` codes and scales bit for bit (fp32 and bf16 inputs, an
  all-zero row and a saturating row), and the int8 ``paged_update`` /
  ``paged_attention`` (codes and scales bit for bit, outputs within
  ``PAGED_TOL``);
* the engines on the reference's tiny model (its params carried over with
  ``params_from_jax``): greedy tokens, chunk and preemption counts, swap
  builds and pool stats equal to the reference's;
* the pool's swap ledger under one seeded op sequence applied to both
  pools (state compared after every op), and its refusals;
* the scheduler's priority order, ``shed_expired`` and
  ``preempt_candidate`` against the reference's on one sequence;
* ``kv_bytes_per_token`` and the Prometheus preempt counter equal to the
  reference's; the census's ``kv_cache`` bytes.

The CPU runs the decode step eager; ``chip_smoke.py --soak-only`` holds
the same levers on the card.
"""

import math
import random

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

PAGED_TOL = 1e-5
#: the reference's prompts (tests/test_capacity.py:45): the 9-token draw has
#: a near tie at its first step, so the int8 parity cases use the first three
PROMPT_LENS = (23, 5, 17, 9)


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


def _engines(tiny_pair, fake_clock=False, **kw):
    """The reference's engine and the port's with the same options (each on
    its own ``FakeClock`` with ``fake_clock``, the engine's ``_now``)."""
    _, model, params, port = tiny_pair
    if fake_clock:
        return (jax_serving.ServingEngine(model, params, now=FakeClock(), **kw),
                serving.ServingEngine(port, now=FakeClock(), **kw))
    return (jax_serving.ServingEngine(model, params, **kw), serving.ServingEngine(port, **kw))


def _prompts(vocab, lens=PROMPT_LENS):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=n).tolist() for n in lens]


def _run_all(engine, prompts, max_new_tokens=6, **kw):
    ids = [engine.add_request(p, max_new_tokens=max_new_tokens, **kw) for p in prompts]
    while engine.has_work:
        engine.step()
    return [engine.result(rid) for rid in ids]


def _records(engine):
    return {r["request_id"]: r for r in engine.stats.requests}


# ---------------------------------------------------------------------- #
# int8 paged KV ops
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference_bit_for_bit(dtype):
    """Per-token symmetric codes and fp32 scales, half to even: the same
    bits as the reference, an all-zero row (scale at KV_SCALE_EPS, codes 0)
    and a row whose amax element maps to exactly 127 included."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 7, 2, 16)) * 3.0).astype(np.float32)
    x[0, 2] = 0.0
    x[1, 4, 1, 5] = 1e4  # saturates: every other element of the row rounds to 0
    x[2, 1] = np.linspace(-2.5, 2.5, 32, dtype=np.float32).reshape(2, 16)  # ties
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    want_q, want_s = jax_attn.quantize_kv(jx)
    got_q, got_s = attn.quantize_kv(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert float(got_s[0, 2]) == np.float32(attn.KV_SCALE_EPS) and not got_q[0, 2].any()
    assert int(got_q[1, 4, 1, 5]) == 127
    assert attn.KV_SCALE_EPS == jax_attn.KV_SCALE_EPS


INT8_CASES = {
    "prefill": dict(s=8, table=[[5, 2, 9, 0], [3, 7, 1, 8]], cache_len=[3, 0], lengths=[5, 8]),
    "decode": dict(s=1, table=[[4, 6, 0, 0], [0, 0, 0, 0], [1, 3, 5, 2]],
                   cache_len=[6, 0, 13], lengths=[1, 0, 1]),
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_paged_update_and_attention_match_reference(case):
    c = INT8_CASES[case]
    heads, kv_heads, d, bs, nb = 4, 2, 16, 4, 10
    b, s = len(c["table"]), c["s"]
    rng = np.random.default_rng(len(case) + 11)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for h in (heads, kv_heads, kv_heads))
    pools = [rng.integers(-127, 128, (nb, bs, kv_heads, d)).astype(np.int8) for _ in range(2)]
    scales = [rng.uniform(0.001, 0.03, (nb, bs)).astype(np.float32) for _ in range(2)]
    arrays = dict(block_table=np.asarray(c["table"], np.int32),
                  cache_len=np.asarray(c["cache_len"], np.int32),
                  lengths=np.asarray(c["lengths"], np.int32))
    jstate = jax_attn.PagedKVState(**{n: jnp.asarray(a) for n, a in arrays.items()},
                                   num_blocks=nb, block_size=bs, kv_dtype="int8")
    jk, jv, jks, jvs = jax_attn.paged_update(
        *(jnp.asarray(p) for p in pools), jnp.asarray(k), jnp.asarray(v), jstate,
        key_scale=jnp.asarray(scales[0]), value_scale=jnp.asarray(scales[1]))
    want = jax_attn.paged_attention(jnp.asarray(q), jk, jv, jstate, key_scale=jks,
                                    value_scale=jvs)
    state = attn.PagedKVState(**{n: torch.as_tensor(a) for n, a in arrays.items()},
                              num_blocks=nb, block_size=bs, kv_dtype="int8")
    tensors = [torch.tensor(a) for a in (*pools, *scales)]
    out = attn.paged_update(tensors[0], tensors[1], torch.as_tensor(k), torch.as_tensor(v),
                            state, tensors[2], tensors[3])
    assert all(o is t for o, t in zip(out, tensors))  # in place
    got = attn.paged_attention(torch.as_tensor(q), *tensors[:2], state, key_scale=tensors[2],
                               value_scale=tensors[3])
    for mine, ref in zip(tensors, (jk, jv, jks, jvs)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PAGED_TOL, rtol=PAGED_TOL)
    with pytest.raises(ValueError, match="key_scale"):
        attn.paged_attention(torch.as_tensor(q), *tensors[:2], state)


def test_int8_cache_layout_and_bytes():
    model = CausalLM(TransformerConfig.tiny(num_layers=2, max_seq_len=32), device="cpu")
    from accelerate_tpu_torch.models.generation import init_cache

    cache = init_cache(model, num_blocks=5, block_size=8, kv_dtype="int8")
    cfg = model.config
    assert cache.key.dtype == torch.int8 and cache.kv_dtype == "int8"
    assert cache.key_scale.shape == (2, 5, 8) and cache.key_scale.dtype == torch.float32
    per_token = 2 * (2 * cfg.num_kv_heads * cfg.head_dim + 2 * 4)
    assert cache.nbytes == 5 * 8 * per_token
    native = init_cache(model, num_blocks=5, block_size=8)
    assert native.key_scale is None and native.kv_dtype == "native"
    state = attn.PagedKVState(torch.zeros(1, 4, dtype=torch.long), torch.zeros(1),
                              torch.ones(1), num_blocks=5, block_size=8)
    with pytest.raises(ValueError, match="pools are 'int8'"):
        model(torch.zeros(1, 1, dtype=torch.long), decode=True, paged=state, cache=cache)


# ---------------------------------------------------------------------- #
# chunked prefill
# ---------------------------------------------------------------------- #
def test_chunked_prefill_greedy_parity_zero_retrace(tiny_pair):
    """The reference's tokens, chunked and not, the decode step built once
    and the same chunk counts."""
    cfg = tiny_pair[0]
    prompts = _prompts(cfg.vocab_size)
    expected = _run_all(serving.ServingEngine(tiny_pair[3], max_slots=4, block_size=8), prompts)
    ref, got = _engines(tiny_pair, max_slots=4, block_size=8, prefill_chunk_tokens=8)
    assert _run_all(got, prompts) == _run_all(ref, prompts) == expected
    counts = got.trace_counts()
    assert counts["decode"] == 1 and counts["prefill"] <= int(math.log2(cfg.max_seq_len))
    assert counts["prefill"] == ref.trace_counts()["prefill"]
    assert got._prefill_chunks_total == ref._prefill_chunks_total >= sum(
        math.ceil(len(p) / 8) for p in prompts) - len(prompts)
    assert got.prefill_bucket_tokens_total == ref.prefill_bucket_tokens_total
    assert [r["prefill_chunks"] for r in got.stats.requests] == [
        r["prefill_chunks"] for r in ref.stats.requests]


def test_chunked_prefill_decode_never_starves(tiny_pair):
    """A 33-token prompt ingests in 5 steps of 8 while its neighbour emits a
    token on every one of them; the reference's steps and records."""
    outs = {}
    for name, engine in zip(("reference", "port"), _engines(
            tiny_pair, fake_clock=True, max_slots=2, block_size=8, num_blocks=32,
            prefill_chunk_tokens=8)):
        clock = engine._now
        a = engine.add_request([1, 2, 3, 4], max_new_tokens=20)
        for _ in range(2):
            engine.step()
            clock.tick()
        long_prompt = np.random.default_rng(7).integers(1, 1024, size=33).tolist()
        b = engine.add_request(long_prompt, max_new_tokens=2)
        steps = during = 0
        while True:
            events = engine.step()
            clock.tick()
            steps += 1
            during += sum(1 for e in events if e.request_id == a)
            if any(e.request_id == b for e in events):
                break
            assert steps < 20
        while engine.has_work:
            engine.step()
            clock.tick()
        outs[name] = (steps, during, _records(engine)[b]["prefill_chunks"],
                      engine.result(a), engine.result(b), engine.trace_counts()["decode"])
    assert outs["port"] == outs["reference"]
    assert outs["port"][:3] == (5, 5, 5) and outs["port"][-1] == 1


def test_chunked_prefill_srpt_orders_short_prompt_first(tiny_pair):
    cfg = tiny_pair[0]
    prompts = _prompts(cfg.vocab_size, lens=(17, 5))
    ttfts = []
    for engine in _engines(tiny_pair, fake_clock=True, max_slots=2, block_size=8, num_blocks=32,
                           prefill_chunk_tokens=8):
        long_id = engine.add_request(prompts[0], max_new_tokens=2)
        short_id = engine.add_request(prompts[1], max_new_tokens=2)
        while engine.has_work:
            engine.step()
            engine._now.tick()
        recs = _records(engine)
        ttfts.append((recs[short_id]["ttft_s"], recs[long_id]["ttft_s"]))
    assert ttfts[0] == ttfts[1] and ttfts[1][0] < ttfts[1][1]


def test_chunked_stall_preempts_instead_of_wedging(tiny_pair):
    """Three long prompts chunk-admitted into a pool too small for all:
    growth preempts and resumes instead of wedging, the greedy tokens are
    the uncontended engine's, and the counts and drained pool are the
    reference's."""
    cfg = tiny_pair[0]
    prompts = _prompts(cfg.vocab_size, lens=(40, 39, 38))
    expected = _run_all(serving.ServingEngine(tiny_pair[3], max_slots=3, block_size=4,
                                              num_blocks=40), prompts, max_new_tokens=4)
    outs = []
    for engine in _engines(tiny_pair, max_slots=3, block_size=4, num_blocks=13,
                           prefill_chunk_tokens=8, preemption=True):
        ids = [engine.add_request(p, max_new_tokens=4) for p in prompts]
        steps = 0
        while engine.has_work:
            engine.step()
            steps += 1
            assert steps < 300, "engine wedged: mid-prefill seats starved"
        counts = engine.trace_counts()
        outs.append(([engine.result(r) for r in ids], steps, dict(engine._preempt_counts),
                     engine._resumes_total, engine.pool.stats(),
                     {k: counts[k] for k in ("decode", "prefill", "swap_out", "swap_in")}))
    assert outs[1] == outs[0]
    results, _, preempts, resumes, stats, counts = outs[1]
    assert results == expected and preempts["growth"] >= 1
    assert resumes == sum(preempts.values()) >= 1
    assert stats["allocated"] == 0 and stats["swapped"] == 0 and counts["decode"] == 1


# ---------------------------------------------------------------------- #
# preemption with KV swap
# ---------------------------------------------------------------------- #
def _priority_run(engine, prompts, temperature=0.0):
    victim = engine.add_request(prompts[0], max_new_tokens=6, temperature=temperature,
                                request_id="victim")
    for _ in range(2):
        engine.step()
    urgent = engine.add_request(prompts[1], max_new_tokens=6, priority=5,
                                temperature=temperature, request_id="urgent")
    filler = engine.add_request(prompts[2], max_new_tokens=6, temperature=temperature,
                                request_id="filler")
    while engine.has_work:
        engine.step()
    return victim, urgent, filler


def test_preempt_swap_resume_bitwise_parity(tiny_pair):
    """A priority-5 arrival swaps the seated low-priority request out; its
    KV goes through host memory and back, and every request finishes with
    the uncontended engine's tokens. One swap build each way, the pool
    drained, the records' preempt counts: all the reference's."""
    cfg = tiny_pair[0]
    prompts = _prompts(cfg.vocab_size, lens=(23, 17, 5))
    expected = _run_all(serving.ServingEngine(tiny_pair[3], max_slots=2, block_size=4,
                                              num_blocks=33), prompts)
    outs = []
    for engine in _engines(tiny_pair, max_slots=2, block_size=4, num_blocks=13,
                           preemption=True):
        ids = _priority_run(engine, prompts)
        counts = engine.trace_counts()
        recs = _records(engine)
        outs.append(([engine.result(r) for r in ids], dict(engine._preempt_counts),
                     engine._resumes_total, engine.pool.stats(),
                     {k: counts[k] for k in ("decode", "prefill", "swap_out", "swap_in")},
                     [recs[r]["preempted_count"] for r in ids]))
    assert outs[1] == outs[0]
    results, preempts, resumes, stats, counts, preempted = outs[1]
    assert results == expected
    assert preempts["priority"] == 1 and resumes == 1 and preempted == [1, 0, 0]
    assert counts["swap_out"] == counts["swap_in"] == 1 and counts["decode"] == 1
    assert stats["swap_outs_total"] == stats["swap_ins_total"] == 1
    assert stats["swapped"] == 0 and stats["allocated"] == 0


def test_preempt_and_resume_draw_nothing_from_the_generator(tiny_pair):
    """Sampling on: a swap-out and the resume leave the engine's generator
    where it was (the reference consumes no key for them), and a
    preempted request's draws are those of its decode steps only: the same
    run on an engine that swaps twice in a row per preemption gives the
    same tokens."""
    cfg = tiny_pair[0]
    port = tiny_pair[3]
    prompts = _prompts(cfg.vocab_size, lens=(23, 17, 5))
    engine = serving.ServingEngine(port, max_slots=2, block_size=4, num_blocks=13,
                                   preemption=True, seed=3)
    engine.add_request(prompts[0], max_new_tokens=6, temperature=0.9)
    engine.step()
    engine.step()
    state = engine._generator.get_state()
    slot = next(s for s in engine.scheduler.slots if s.busy)
    engine._preempt(slot, "priority")
    assert torch.equal(engine._generator.get_state(), state)
    engine._try_resume()
    assert torch.equal(engine._generator.get_state(), state) and engine._resumes_total == 1
    runs = []
    for twice in (False, True):
        engine = serving.ServingEngine(port, max_slots=2, block_size=4, num_blocks=13,
                                       preemption=True, seed=3)
        if twice:
            once = engine._preempt

            def preempt_and_bounce(slot, reason, once=once, engine=engine):
                index = slot.index
                once(slot, reason)
                entry = engine._swapped_reqs.pop()
                engine._resume(engine.scheduler.slots[index], entry, 0)
                once(engine.scheduler.slots[index], reason)
            engine._preempt = preempt_and_bounce
        ids = _priority_run(engine, prompts, temperature=0.9)
        runs.append([engine.result(r) for r in ids])
    assert runs[0] == runs[1] and all(len(r) == 6 for r in runs[0])
    assert engine.pool.stats()["allocated"] == 0 and engine.pool.num_swapped == 0


def test_preemption_off_never_swaps(tiny_pair):
    cfg = tiny_pair[0]
    prompts = _prompts(cfg.vocab_size, lens=(23, 17, 5))
    ref, got = _engines(tiny_pair, max_slots=2, block_size=4, num_blocks=13)
    results = _run_all(got, prompts)
    assert results == _run_all(ref, prompts) and all(r is not None for r in results)
    assert got._preempt_counts == {"priority": 0, "pool": 0, "growth": 0}
    assert got.pool.stats()["swap_outs_total"] == 0
    assert got.trace_counts()["swap_out"] == 0 == ref.trace_counts()["swap_out"]


# ---------------------------------------------------------------------- #
# the pool's swap ledger
# ---------------------------------------------------------------------- #
def _pool_state(pool) -> dict:
    return {"free": list(pool._free), "ref": dict(pool._ref), "lru": list(pool._lru),
            "index": dict(pool._index), "stats": pool.stats(), "swapped": pool.num_swapped}


@pytest.mark.parametrize("seed", [1, 2])
def test_block_pool_fuzz_with_swap_ops_against_reference(seed):
    """allocate / free / acquire / publish / swap_out / swap_in / swap_drop
    from one seeded generator on both pools: every op's result and the
    whole state (free list, refcounts, LRU, index, stats with the swap
    ledger) agree after every op, and the extended conservation law holds."""
    rng = random.Random(seed)
    ref, got = jax_serving.BlockPool(17, 4), serving.BlockPool(17, 4)
    held: list[int] = []
    swapped = published = 0
    for _ in range(2000):
        op = rng.random()
        out = None
        if op < 0.30 and got.can_allocate(n := rng.randint(1, 3)):
            out = [pool.allocate(n) for pool in (ref, got)]
            held.extend(out[1])
        elif op < 0.45 and held:
            b = held.pop(rng.randrange(len(held)))
            out = [pool.free([b]) for pool in (ref, got)]
        elif op < 0.55 and held:
            b = held[rng.randrange(len(held))]
            out = [pool.acquire([b]) for pool in (ref, got)]
            held.append(b)
        elif op < 0.65 and held:
            b = held[rng.randrange(len(held))]
            key = published.to_bytes(4, "big") * 8
            out = [pool.publish(b, key) for pool in (ref, got)]
            published += 1
        elif op < 0.80 and held:
            b = held.pop(rng.randrange(len(held)))
            out = [pool.swap_out([b]) for pool in (ref, got)]
            swapped += 1
        elif op < 0.90 and swapped:
            n = rng.randint(1, swapped)
            if got.can_allocate(n):
                out = [pool.swap_in(n) for pool in (ref, got)]
                held.extend(out[1])
                swapped -= n
        elif swapped:
            n = rng.randint(1, swapped)
            out = [pool.swap_drop(n) for pool in (ref, got)]
            swapped -= n
        if out is not None:
            assert out[0] == out[1]
        assert _pool_state(got) == _pool_state(ref)
        assert (got.num_free + got.num_allocated + got.num_cached == got.num_blocks - 1
                and got.num_swapped == swapped)
    for pool in (ref, got):
        pool.free(held)
        pool.swap_drop(swapped)
    assert _pool_state(got) == _pool_state(ref) and got.num_allocated == 0


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_swap_ledger_rejects_bad_ops(pkg):
    pool = (serving if pkg == "port" else jax_serving).BlockPool(num_blocks=8, block_size=4)
    with pytest.raises(ValueError, match="not allocated"):
        pool.swap_out([3])
    with pytest.raises(ValueError, match="swap_in"):
        pool.swap_in(1)
    with pytest.raises(ValueError, match="swap_drop"):
        pool.swap_drop(1)
    blocks = pool.allocate(2)
    pool.swap_out(blocks)
    assert pool.num_swapped == 2 and pool.num_free == 7
    assert len(pool.swap_in(2)) == 2 and pool.num_swapped == 0


# ---------------------------------------------------------------------- #
# priorities in the scheduler
# ---------------------------------------------------------------------- #
def test_priority_submit_shed_and_preempt_candidate_against_reference():
    """One sequence of submits (mixed priorities), admissions, progress and
    a deadline on both schedulers: the queue order, the sheds and every
    ``preempt_candidate`` answer are the reference's."""
    outs = {}
    for name, pkg in (("reference", jax_serving), ("port", serving)):
        clock = FakeClock()
        pool = pkg.BlockPool(40, 4)
        sched = pkg.ContinuousScheduler(3, pool, now=clock, max_queue_delay_s=5.0)
        log = []
        for i, prio in enumerate([0, 0, 2, 1, 0, 2, 0]):
            sched.submit(pkg.Request(prompt=[1] * (3 + i), max_new_tokens=4,
                                     request_id=f"r{i}", priority=prio))
            clock.tick(1.0)
        log.append([r.request_id for r in sched.queue])
        for slot in sched.admit():
            slot.cache_len = len(slot.request.prompt)
        log.append([s.request.request_id for s in sched.slots])
        log.append(sched.preempt_candidate().index)
        log.append(sched.preempt_candidate(max_priority=1).index)
        log.append(sched.preempt_candidate(max_priority=-1))
        log.append(sched.preempt_candidate(exclude={0, 1}).index)
        sched.slots[2].resumed = True
        log.append(sched.preempt_candidate(max_priority=2).index)
        clock.tick(1.5)
        log.append([r.request_id for r in sched.shed_expired()])
        log.append([r.request_id for r in sched.queue])
        sched.submit(pkg.Request(prompt=[1, 2], request_id="late", priority=1))
        log.append([r.request_id for r in sched.queue])
        outs[name] = log
    assert outs["port"] == outs["reference"]
    assert outs["port"][0] == ["r2", "r5", "r3", "r0", "r1", "r4", "r6"]


def test_chunked_reserve_admits_on_one_chunk():
    """With ``chunked_reserve`` a 40-token prompt is seated on its first
    chunk's blocks; without it on the whole footprint (both packages)."""
    for pkg in (jax_serving, serving):
        got = []
        for reserve in (False, True):
            sched = pkg.ContinuousScheduler(2, pkg.BlockPool(40, 4))
            sched.chunk_tokens, sched.chunked_reserve = 8, reserve
            sched.submit(pkg.Request(prompt=list(range(1, 41)), max_new_tokens=8))
            got.append(len(sched.admit()[0].blocks))
        assert got == [12, 2]


# ---------------------------------------------------------------------- #
# int8 KV in the engine
# ---------------------------------------------------------------------- #
def test_int8_kv_greedy_parity(tiny_pair):
    """int8 KV gives the bf16 engine's greedy tokens on prompts with a clear
    logit gap, in both packages, and builds its decode step once."""
    cfg = tiny_pair[0]
    prompts = _prompts(cfg.vocab_size, lens=(23, 5, 17))
    expected = _run_all(serving.ServingEngine(tiny_pair[3], max_slots=4, block_size=8,
                                              num_blocks=16), prompts)
    ref, got = _engines(tiny_pair, max_slots=4, block_size=8, num_blocks=16, kv_dtype="int8")
    assert _run_all(got, prompts) == _run_all(ref, prompts) == expected
    assert got.trace_counts()["decode"] == 1 and got.cache.key.dtype == torch.int8


def test_int8_kv_capacity_arithmetic(tiny_pair):
    """bytes a cached token: 2 kvH hd x itemsize a layer native, 2 kvH hd +
    2 x 4 (the fp32 scales) int8; the reference's numbers, >= 1.8x the seats
    in one budget."""
    cfg = tiny_pair[0]
    kw = dict(max_slots=2, block_size=8, num_blocks=16)
    ref_fp, fp = _engines(tiny_pair, **kw)
    ref_i8, i8 = _engines(tiny_pair, kv_dtype="int8", **kw)
    assert fp.kv_bytes_per_token == ref_fp.kv_bytes_per_token
    assert i8.kv_bytes_per_token == ref_i8.kv_bytes_per_token
    per_layer_i8 = 2 * cfg.num_kv_heads * cfg.head_dim + 2 * 4
    assert i8.kv_bytes_per_token == cfg.num_layers * per_layer_i8
    assert fp.kv_bytes_per_token / i8.kv_bytes_per_token >= 1.8
    budget, tokens = 64 << 20, 512
    assert (budget // int(i8.kv_bytes_per_token * tokens)
            >= 1.8 * (budget // int(fp.kv_bytes_per_token * tokens)))


def test_census_counts_the_kv_cache_and_params(tiny_pair):
    """The engine registers ``params`` and ``kv_cache`` with the collector's
    census; ``kv_cache`` is the pools' bytes (and the scale arrays' for
    int8) and its ratio is the capacity ratio."""
    from accelerate_tpu_torch.telemetry import StepTelemetry

    port = tiny_pair[3]
    seen = {}
    for kv_dtype in ("bf16", "int8"):
        tele = StepTelemetry(True)
        engine = serving.ServingEngine(port, max_slots=2, block_size=8, num_blocks=16,
                                       telemetry=tele, kv_dtype=kv_dtype)
        owners = tele.sample_memory(force=True)["census_owner_bytes"]
        assert owners["kv_cache"] == engine.cache.nbytes
        assert owners["params"] == sum(p.nbytes for p in port.parameters())
        seen[kv_dtype] = owners["kv_cache"]
    assert seen["bf16"] / seen["int8"] >= 1.8


def test_kv_dtype_validation(tiny_pair):
    port = tiny_pair[3]
    with pytest.raises(ValueError, match="kv_dtype"):
        serving.ServingEngine(port, max_slots=2, kv_dtype="fp8")
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        serving.ServingEngine(port, max_slots=2, prefill_chunk_tokens=0)
    with pytest.raises(ValueError, match="kv_dtype"):
        attn.PagedKVState(torch.zeros(1, 2), torch.zeros(1), torch.ones(1), num_blocks=4,
                          block_size=2, kv_dtype="fp8")


# ---------------------------------------------------------------------- #
# composition
# ---------------------------------------------------------------------- #
def test_all_three_features_compose(tiny_pair):
    """Chunked prefill, preemption and int8 together give int8 alone's
    greedy tokens, and the reference's."""
    cfg = tiny_pair[0]
    prompts = _prompts(cfg.vocab_size)
    expected = _run_all(serving.ServingEngine(tiny_pair[3], max_slots=4, block_size=8,
                                              num_blocks=24, kv_dtype="int8"), prompts)
    ref, got = _engines(tiny_pair, max_slots=4, block_size=8, num_blocks=24,
                        prefill_chunk_tokens=8, preemption=True, kv_dtype="int8")
    assert _run_all(got, prompts) == _run_all(ref, prompts) == expected
    assert got.trace_counts()["decode"] == 1


def test_prefix_cache_with_chunks_and_int8_copies_scale_rows(tiny_pair):
    """A full-prompt hit copies its last block, the int8 scale rows with the
    codes: a warm int8 engine gives the cold one's tokens, and the chunked
    warm run publishes only single-chunk prompts, as the reference does."""
    port = tiny_pair[3]
    template = list(range(3, 27))
    prompts = [template + [7, 8, 9], template + [5], template]
    kw = dict(max_slots=2, block_size=8, kv_dtype="int8")
    cold = [serving.ServingEngine(port, **kw).generate([p], max_new_tokens=6)[0].tolist()
            for p in prompts]
    for extra in (dict(), dict(prefill_chunk_tokens=32)):
        engine = serving.ServingEngine(port, prefix_cache=True, **kw, **extra)
        warm = [engine.generate([p], max_new_tokens=6)[0].tolist() for p in prompts]
        assert warm == cold
        assert engine.prefix_cache.cow_copies_total == 1
    _, model, params, _ = tiny_pair
    ref = jax_serving.ServingEngine(model, params, prefix_cache=True, prefill_chunk_tokens=32,
                                    **kw)
    want = [np.asarray(ref.generate(np.asarray([p]), max_new_tokens=6))[0].tolist()
            for p in prompts]
    assert want == cold and ref.prefix_cache.stats() == engine.prefix_cache.stats()


# ---------------------------------------------------------------------- #
# telemetry
# ---------------------------------------------------------------------- #
def test_preempt_counter_reaches_prometheus_sink():
    """The preempt counter's text is the reference's."""
    from accelerate_tpu.telemetry import PrometheusTextSink as JaxSink
    from accelerate_tpu.telemetry import StepTelemetry as JaxTelemetry
    from accelerate_tpu_torch.telemetry import PrometheusTextSink, StepTelemetry

    texts = []
    for tel_cls, sink_cls in ((JaxTelemetry, JaxSink), (StepTelemetry, PrometheusTextSink)):
        tel = tel_cls(True)
        sink = tel.add_sink(sink_cls(path=None))
        tel.record_preempt(request_id="r1", reason="priority", blocks=8, swap_bytes=4096,
                           cache_len=25, priority=0)
        tel.record_preempt(request_id="r2", reason="growth")
        tel.record_preempt(request_id="r3", reason="priority")
        texts.append(sink.render())
        tel.close()
    assert texts[1] == texts[0]
    assert 'accelerate_tpu_serve_preempt_total{reason="priority"} 2.0' in texts[1]


def test_preempt_records_spans_and_gauges_equal_the_reference(tiny_pair):
    """The priority preemption with telemetry on: the preempt, serve and
    span records and the capacity gauges are the reference's."""
    from accelerate_tpu.telemetry import StepTelemetry as JaxTelemetry
    from accelerate_tpu_torch.telemetry import StepTelemetry

    cfg = tiny_pair[0]
    prompts = _prompts(cfg.vocab_size, lens=(23, 17, 5))
    tels = (JaxTelemetry(True), StepTelemetry(True))
    engines = []
    for tel, engine in zip(tels, _engines(tiny_pair, fake_clock=True, max_slots=2, block_size=4,
                                          num_blocks=13, preemption=True)):
        engine.set_observability(telemetry=tel)
        _priority_run(engine, prompts)
        engines.append(engine)

    def records(tel, kind):
        return [{k: v for k, v in r.items() if k != "time_unix"} for r in tel.records
                if r.get("kind") == kind]

    for kind in ("preempt", "serve", "span"):
        want, mine = records(tels[0], kind), records(tels[1], kind)
        assert len(mine) == len(want) > 0, kind
        assert mine == [{k: v for k, v in r.items() if k in m} for r, m in zip(want, mine)]
    preempt = records(tels[1], "preempt")[0]
    assert preempt["reason"] == "priority" and preempt["swap_bytes"] > 0
    gauges = [records(t, "serve_gauge") for t in tels]
    assert gauges[1] == gauges[0]
    assert gauges[1][-1]["resumes_total"] == 1 and gauges[1][-1]["preempts_priority_total"] == 1
