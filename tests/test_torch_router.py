"""The port's fleet router against the JAX reference's, on the CPU.

Mirrors ``tests/test_router.py`` but for its three scrape-endpoint tests,
which start the reference's ``MetricsHTTPExporter`` (the port's HTTP plane
is ROADMAP.md queue A10):

* the fake-engine cases drive both packages' routers on the same fakes and
  clock (``_both``): every placement, snapshot, digest, ledger and chaos
  event the reference's router decides, the port's must decide too, and
  the reference's own expectations hold on both;
* the chain digest of both ``BlockPool``s on one op sequence;
* the real-engine cases run the reference's tiny model and the port's
  (its params carried over with ``params_from_jax``) side by side: drain,
  the prefix digest, and a three-replica fleet under round robin and
  prefix affinity, whose tokens, per-request placement,
  ``router_summary`` and merged ``export_trace`` (times aside) equal the
  reference's;
* chip_smoke.py's ``fleet_soak`` arms (``fleet_plan``/``fleet_arms``, the
  reference benchmark's ``measure.py:1648-1916``) at a tiny config, a
  quarter of their length, through both packages.

Everything compared is exact: host arithmetic and greedy argmax over fp32
logits.
"""

import json
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu.loadgen.chaos as jax_chaos  # noqa: E402
import accelerate_tpu.router as jax_router  # noqa: E402
import accelerate_tpu.serving as jax_serving  # noqa: E402
import accelerate_tpu.serving.block_pool as jax_block_pool  # noqa: E402
import accelerate_tpu.serving.spans as jax_spans  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.test_utils import fault_injection as jax_faults  # noqa: E402
from accelerate_tpu_torch import CausalLM, TransformerConfig, params_from_jax  # noqa: E402
from accelerate_tpu_torch import router, serving  # noqa: E402
from accelerate_tpu_torch.loadgen import chaos  # noqa: E402
from accelerate_tpu_torch.serving import block_pool, spans  # noqa: E402
from accelerate_tpu_torch.test_utils import fault_injection  # noqa: E402

REF = SimpleNamespace(name="reference", router=jax_router, block_pool=jax_block_pool,
                      chaos=jax_chaos, spans=jax_spans, faults=jax_faults)
PORT = SimpleNamespace(name="port", router=router, block_pool=block_pool, chaos=chaos,
                       spans=spans, faults=fault_injection)


def _both(scenario):
    """Run ``scenario(pkg)`` on the reference's router and the port's; the
    observations must be equal. Returns the port's."""
    want = scenario(REF)
    got = scenario(PORT)
    assert got == want
    return got


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def tick(self, dt: float = 1.0) -> None:
        self.t += dt

    def advance(self, dt: float) -> None:
        self.t += dt

    def __call__(self) -> float:
        return self.t


class FakeReq:
    """Shaped like ``scheduler.Request`` where the router's re-queue reads
    it."""

    def __init__(self, prompt, rid, adapter=None, max_new_tokens=4):
        self.prompt = list(prompt)
        self.request_id = rid
        self.adapter = adapter
        self.max_new_tokens = max_new_tokens
        self.temperature = 0.0
        self.eos_token_id = None
        self.priority = 0


class FakeEngine:
    """The duck surface the replica handle reads, with no model: one queued
    request completes a step, and completion publishes its chain keys
    (``pkg``'s ``prefix_keys``) into what ``prefix_digest`` reports."""

    block_size = 4

    def __init__(self, pkg, fingerprint="fake-fp", gauges=None):
        self._keys_fn = pkg.block_pool.prefix_keys
        self.scheduler = SimpleNamespace(queue=deque(), slots=[])
        self._swapped_reqs = []
        self.gauges = dict(gauges or {})
        self.fingerprint = fingerprint
        self.keys = set()
        self.warm_hits = 0
        self.finished = {}
        self._draining = False
        self._n = 0

    def add_request(self, prompt, max_new_tokens=32, temperature=0.0, eos_token_id=None,
                    request_id="", adapter=None, priority=0):
        rid = request_id or f"fake-{self._n}"
        self._n += 1
        keys = self._keys_fn(self.fingerprint, adapter, prompt, self.block_size)
        if keys and keys[0].hex() in self.keys:
            self.warm_hits += 1
        self.scheduler.queue.append(FakeReq(prompt, rid, adapter, max_new_tokens))
        return rid

    def step(self):
        if self.scheduler.queue:
            req = self.scheduler.queue.popleft()
            for k in self._keys_fn(self.fingerprint, req.adapter, req.prompt, self.block_size):
                self.keys.add(k.hex())
            self.finished[req.request_id] = [1]
        return []

    @property
    def has_work(self):
        return bool(self.scheduler.queue)

    def _gauge_fields(self):
        g = {"queue_depth": len(self.scheduler.queue), "slots_active": 0,
             "slot_occupancy": 0.0, "pool_utilization": 0.0, "tokens_in_flight": 0}
        g.update(self.gauges)
        return g

    def prefix_digest(self, max_entries=512):
        entries = sorted(self.keys)[:max_entries]
        return {"block_size": self.block_size, "entries": entries,
                "fingerprint": self.fingerprint, "total": len(self.keys),
                "truncated": len(self.keys) > len(entries)}

    def drain(self):
        self._draining = True
        out = list(self.scheduler.queue)
        self.scheduler.queue.clear()
        return out

    @property
    def draining(self):
        return self._draining

    def health(self):
        return {"ok": True, "state": "draining" if self._draining else "serving"}

    def result(self, rid):
        return self.finished.get(rid)

    def shed_reason(self, rid):
        return None


def _fleet(pkg, n=3, policy="least_loaded", clock=None, gauges=None, **kw):
    clock = clock or FakeClock()
    engines = [FakeEngine(pkg, gauges=(gauges or {}).get(i)) for i in range(n)]
    reps = [pkg.router.InProcessReplica(f"r{i}", e) for i, e in enumerate(engines)]
    fleet = pkg.router.FleetRouter(reps, policy=policy, now=clock, **kw)
    return fleet, engines, clock


def _drain_fleet(fleet, clock, budget=200, dt=0.1):
    for _ in range(budget):
        if not fleet.has_work:
            return
        fleet.step()
        clock.tick(dt)
    raise AssertionError("fleet did not drain")


def _snaps(fleet):
    return {name: (s.queue_depth, s.slots_active, s.pool_utilization, s.taken_at, s.stale)
            for name, s in fleet._snaps.items()}


# ---------------------------------------------------------------------- #
# placement policies
# ---------------------------------------------------------------------- #
def test_least_loaded_picks_idle_replica_under_skew():
    def scenario(pkg):
        fleet, _, _ = _fleet(pkg, 3, gauges={0: {"queue_depth": 5}, 2: {"queue_depth": 3}})
        for _ in range(4):
            fleet.add_request([1, 2, 3])
        first = dict(fleet.routed_by_replica)
        fleet.add_request([1, 2, 3])
        return first, dict(fleet.routed_by_replica), _snaps(fleet)

    first, after, _ = _both(scenario)
    # the idle replica takes all four, then its own queue makes r2 (depth 3)
    # the lighter one
    assert first["r1"] == 4 and after["r2"] == 1


def test_make_policy_resolution_and_load_score():
    def scenario(pkg):
        r = pkg.router
        with pytest.raises(ValueError):
            r.make_policy("power_of_two")
        snap = r.ReplicaSnapshot(queue_depth=3, slots_active=2, pool_utilization=0.5)
        return (r.make_policy("round_robin").name,
                r.make_policy("prefix_affinity", load_penalty=2.0).load_penalty,
                r.load_score(snap))

    assert _both(scenario) == ("round_robin", 2.0, 5.5)


def test_round_robin_cycles_registration_order():
    def scenario(pkg):
        fleet, _, _ = _fleet(pkg, 3, policy="round_robin")
        return [fleet.select([1, 2, 3]) for _ in range(6)]

    assert _both(scenario) == ["r0", "r1", "r2", "r0", "r1", "r2"]


def test_round_robin_skips_dead_and_draining():
    def scenario(pkg):
        fleet, _, _ = _fleet(pkg, 3, policy="round_robin")
        fleet.drain("r1")
        return [fleet.select([1]) for _ in range(4)]

    assert _both(scenario) == ["r0", "r2", "r0", "r2"]


def _templated_trace(n_cohorts=4, per_cohort=6, prefix_blocks=2, bs=4):
    # four cohorts over three replicas: the two cycles are coprime, so round
    # robin scatters every cohort
    trace = []
    for i in range(n_cohorts * per_cohort):
        c = i % n_cohorts
        trace.append([100 + c] * (prefix_blocks * bs) + [200 + i, 201 + i, 1 + c])
    return trace


def test_prefix_affinity_beats_round_robin_on_warm_hits():
    def scenario(pkg):
        out = {}
        for policy in ("round_robin", "prefix_affinity"):
            fleet, engines, clock = _fleet(pkg, 3, policy=policy)
            placed = []
            for prompt in _templated_trace():
                placed.append(fleet._placements[fleet.add_request(prompt)])
                _drain_fleet(fleet, clock)
            out[policy] = (sum(e.warm_hits for e in engines), placed)
        return out

    out = _both(scenario)
    # under affinity each cohort's chain lives on one replica: every request
    # after a cohort's first is warm
    assert out["prefix_affinity"][0] == 4 * 6 - 4
    assert out["prefix_affinity"][0] > out["round_robin"][0]


def test_prefix_affinity_degrades_to_least_loaded_when_cold():
    def scenario(pkg):
        fleet, _, _ = _fleet(pkg, 3, policy="prefix_affinity", gauges={0: {"queue_depth": 9}})
        return fleet.select([7, 7, 7, 7])

    assert _both(scenario) == "r1"  # no overlap anywhere


def test_affinity_load_penalty_overrides_overlap():
    """A warm replica buried under queue loses to an idle cold one once the
    penalty outweighs the overlap."""
    def scenario(pkg):
        fleet, engines, clock = _fleet(pkg, 2, policy="prefix_affinity", load_penalty=8.0)
        prompt = [5] * 12
        fleet.add_request(prompt)
        _drain_fleet(fleet, clock)
        warm = fleet.select(prompt)
        engines[0].gauges["queue_depth"] = 50  # 50 x 8 >> 11 tokens of overlap
        clock.tick(1.0)  # ages out the cached snapshot and digest
        return warm, fleet.select(prompt), sorted(fleet._digests["r0"]["keys"])

    warm, buried, _ = _both(scenario)
    assert (warm, buried) == ("r0", "r1")


# ---------------------------------------------------------------------- #
# session affinity
# ---------------------------------------------------------------------- #
def test_session_affinity_pins_and_spills_on_drain():
    def scenario(pkg):
        fleet, _, _ = _fleet(pkg, 3, session_affinity=True)
        first = fleet.select([1, 2], session_id="alice")
        pinned = [fleet.select([i], session_id="alice") for i in range(5)]
        fleet.drain(first)
        second = fleet.select([9], session_id="alice")
        spills = fleet.session_spills_total
        again = fleet.select([10], session_id="alice")
        return first, pinned, second, spills, again, fleet.session_spills_total

    first, pinned, second, spills, again, spills_after = _both(scenario)
    assert all(p == first for p in pinned) and second != first
    assert spills == 1 and again == second and spills_after == 1  # the spill re-pins


def test_session_map_is_bounded():
    def scenario(pkg):
        fleet, _, _ = _fleet(pkg, 2, session_affinity=True, max_sessions=8)
        for i in range(50):
            fleet.select([1], session_id=f"s{i}")
        return list(fleet._sessions.items()), fleet.router_summary()["sessions_tracked"]

    sessions, tracked = _both(scenario)
    assert len(sessions) == 8 and tracked == 8


# ---------------------------------------------------------------------- #
# staleness tolerance
# ---------------------------------------------------------------------- #
def _boom(*_):
    raise ConnectionError("scrape died")


def test_stale_gauge_snapshots_never_wedge_admission():
    def scenario(pkg):
        fleet, engines, clock = _fleet(pkg, 2)
        fleet.add_request([1, 2, 3])  # a healthy snapshot cached for both
        for e in engines:
            e._gauge_fields = _boom
        clock.tick(1.0)  # ages the cache out
        for _ in range(3):
            fleet.add_request([4, 5, 6])  # must not raise
        return fleet.stale_snapshot_routes_total, fleet.routed_total, _snaps(fleet)

    stale, routed, _ = _both(scenario)
    assert stale >= 2 and routed == 4


def test_snapshotless_replica_routes_optimistically():
    """A replica that never produced a snapshot still takes traffic (a zero
    load) instead of blocking the fleet."""
    def scenario(pkg):
        fleet, engines, _ = _fleet(pkg, 1)
        engines[0]._gauge_fields = _boom
        return fleet.select([1, 2]), fleet.stale_snapshot_routes_total

    assert _both(scenario) == ("r0", 1)


def test_digest_fetch_failure_degrades_to_load_routing():
    def scenario(pkg):
        fleet, engines, _ = _fleet(pkg, 2, policy="prefix_affinity")
        for e in engines:
            e.prefix_digest = _boom
        return fleet.select([1, 2, 3, 4])

    assert _both(scenario) in ("r0", "r1")  # no raise


# ---------------------------------------------------------------------- #
# lifecycle: drain / kill / health ejection / slow
# ---------------------------------------------------------------------- #
def test_drain_requeues_unadmitted_onto_survivors():
    def scenario(pkg):
        fleet, engines, _ = _fleet(pkg, 2)
        for _ in range(3):
            fleet.add_request([1, 2])
        routed = dict(fleet.routed_by_replica)
        out = fleet.drain("r0")
        return (routed, out, len(engines[0].scheduler.queue), len(engines[1].scheduler.queue),
                fleet.requests_requeued, fleet.router_summary())

    routed, out, q0, q1, requeued, summary = _both(scenario)
    assert routed == {"r0": 2, "r1": 1}  # least loaded: r0, r1, then the tie to r0
    assert out == {"replica": "r0", "requeued": 2, "lost": 0}
    assert (q0, q1, requeued) == (0, 3, 2)
    assert summary["replicas_alive"] == 2  # draining is not dead


def test_kill_requeues_queue_and_counts_seated_as_lost():
    def scenario(pkg):
        fleet, engines, _ = _fleet(pkg, 2)
        victim = engines[0]
        victim.scheduler.queue.extend(FakeReq([1, 2, 3], f"q{i}") for i in range(3))
        victim.scheduler.slots = [SimpleNamespace(busy=True), SimpleNamespace(busy=True),
                                  SimpleNamespace(busy=False)]
        out = fleet.kill("r0")
        state = (len(engines[1].scheduler.queue), fleet.requests_lost, fleet.rerouted_total,
                 fleet.router_summary())
        return out, state, fleet.kill("r0")

    out, (q1, lost, rerouted, summary), again = _both(scenario)
    assert out == {"replica": "r0", "requeued": 3, "lost": 2}
    assert (q1, lost, rerouted) == (3, 2, 3)
    assert summary["replicas_alive"] == 1 and summary["ejections_total"] == 1
    assert again == {"replica": "r0", "requeued": 0, "lost": 0}  # no double count


def test_kill_with_no_survivor_counts_queue_as_lost():
    def scenario(pkg):
        fleet, engines, _ = _fleet(pkg, 1)
        engines[0].scheduler.queue.append(FakeReq([1], "q0"))
        out = fleet.kill("r0")
        with pytest.raises(RuntimeError):
            fleet.add_request([1, 2])
        return out

    out = _both(scenario)
    assert out["requeued"] == 0 and out["lost"] == 1


def test_healthz_ejection_on_step():
    def scenario(pkg):
        fleet, engines, _ = _fleet(pkg, 2)
        engines[0].scheduler.queue.append(FakeReq([1, 2], "q0"))
        engines[0].health = lambda: {"ok": False, "state": "dead"}
        fleet.step()
        state = (fleet.router_summary()["replicas_alive"], fleet.replica("r0").alive,
                 fleet.requests_requeued)
        while fleet.has_work:  # the rescued request finishes on r1
            fleet.step()
        return state, fleet.result("q0")

    state, result = _both(scenario)
    assert state == (1, False, 1) and result == [1]


def test_replica_slow_skips_steps_until_deadline():
    def scenario(pkg):
        fleet, engines, clock = _fleet(pkg, 2)
        fleet.add_request([1, 2])  # r0 by the tie-break
        fleet.slow("r0", 5.0)
        fleet.step()
        frozen = len(engines[0].scheduler.queue)
        clock.tick(6.0)
        fleet.step()
        return frozen, len(engines[0].scheduler.queue)

    assert _both(scenario) == (1, 0)


def test_trace_counts_merge_keeps_dead_replicas():
    def scenario(pkg):
        fleet, engines, _ = _fleet(pkg, 2)
        for e in engines:
            e.trace_counts = lambda: {"decode": 1, "prefill": 2}
        before = fleet.trace_counts()
        fleet.kill("r0")
        return before, fleet.trace_counts()

    assert _both(scenario) == ({"decode": 2, "prefill": 4},) * 2


def test_result_resolves_through_placement_map():
    def scenario(pkg):
        fleet, _, clock = _fleet(pkg, 2)
        rid = fleet.add_request([1, 2, 3], request_id="want-this")
        _drain_fleet(fleet, clock)
        return rid, fleet.result(rid), fleet.result("never-submitted")

    assert _both(scenario) == ("want-this", [1], None)


# ---------------------------------------------------------------------- #
# fault grammar + chaos handlers
# ---------------------------------------------------------------------- #
def test_fault_spec_replica_field_round_trips():
    def scenario(pkg):
        spec = pkg.faults.FaultSpec.parse("replica_kill@0:replica=1")
        slow = pkg.faults.FaultSpec.parse("replica_slow@2:replica=0:secs=3")
        assert pkg.faults.FaultSpec.parse(spec.render()) == spec
        assert pkg.faults.FaultSpec.parse(slow.render()) == slow
        return (spec.action, spec.replica, spec.render(), slow.stall_secs, slow.replica,
                slow.render())

    got = _both(scenario)
    assert got[:2] == ("replica_kill", 1) and got[3:5] == (3.0, 0)


def test_fault_spec_replica_field_rejected_elsewhere():
    def scenario(pkg):
        msgs = []
        for text in ("stall_decode@0:replica=1", "replica_kill@0:secs=2"):  # kill is not timed
            with pytest.raises(ValueError) as err:
                pkg.faults.FaultSpec.parse(text)
            msgs.append(str(err.value))
        return msgs

    _both(scenario)


def _chaos(pkg, engine, clock, specs):
    injector = pkg.faults.FaultInjector([], rank=0, generation=0)
    adapter = pkg.chaos.ChaosAdapter(engine, injector, clock)
    injector.specs = [pkg.faults.FaultSpec.parse(s) for s in specs]
    injector.maybe_fire(0)
    return adapter


def test_chaos_replica_kill_fires_against_fleet():
    def scenario(pkg):
        fleet, engines, clock = _fleet(pkg, 2)
        engines[1].scheduler.queue.append(FakeReq([1, 2], "q0"))
        adapter = _chaos(pkg, fleet, clock, ["replica_kill@0:replica=1"])
        return adapter.events, fleet.router_summary()

    events, summary = _both(scenario)
    assert summary["replicas_alive"] == 1
    (event,) = [e for e in events if e["action"] == "replica_kill"]
    assert (event["replica"], event["requeued"], event["lost"]) == ("r1", 1, 0)


def test_chaos_replica_slow_fires_against_fleet():
    def scenario(pkg):
        fleet, engines, clock = _fleet(pkg, 2)
        adapter = _chaos(pkg, fleet, clock, ["replica_slow@0:replica=0:secs=4"])
        fleet.add_request([1, 2])  # ties still place on r0, which is frozen
        fleet.step()
        frozen = len(engines[0].scheduler.queue)
        clock.tick(5.0)
        fleet.step()
        return adapter.events, frozen, len(engines[0].scheduler.queue)

    (event,), frozen, after = _both(scenario)
    assert (event["action"], event["replica"], event["secs"]) == ("replica_slow", "r0", 4.0)
    assert (frozen, after) == (1, 0)


def test_chaos_replica_actions_skip_single_engine():
    def scenario(pkg):
        engine = FakeEngine(pkg)
        adapter = _chaos(pkg, engine, FakeClock(), ["replica_kill@0:replica=0"])
        return adapter.events, engine.has_work

    events, has_work = _both(scenario)
    assert events[0]["skipped"] == "not_a_fleet" and has_work is False  # untouched


def test_chaos_replica_out_of_range_skips():
    def scenario(pkg):
        fleet, _, clock = _fleet(pkg, 2)
        adapter = _chaos(pkg, fleet, clock, ["replica_kill@0:replica=7"])
        return adapter.events, fleet.router_summary()["replicas_alive"]

    events, alive = _both(scenario)
    assert events[0]["skipped"] == "replica_out_of_range" and alive == 2


# ---------------------------------------------------------------------- #
# the chain-key digest (BlockPool, host-only)
# ---------------------------------------------------------------------- #
def test_cached_chain_digest_is_bounded_and_token_free():
    def scenario(pkg):
        pool = pkg.block_pool.BlockPool(num_blocks=32, block_size=4)
        keys = pkg.block_pool.prefix_keys("fp", None, list(range(1, 41)), 4)  # 10 blocks
        for b, k in zip(pool.allocate(len(keys)), keys):
            pool.publish(b, k)
        return ([k.hex() for k in keys], pool.cached_chain_digest(max_entries=4),
                pool.cached_chain_digest(max_entries=100))

    keys, digest, full = _both(scenario)
    assert len(digest["entries"]) == 4 and digest["total"] == 10 and digest["truncated"]
    assert all(isinstance(e, str) and len(e) == 64 and int(e, 16) >= 0
               for e in digest["entries"])
    assert len(full["entries"]) == 10 and not full["truncated"]
    assert set(full["entries"]) == set(keys)


def test_cached_chain_digest_prefers_live_then_mru():
    def scenario(pkg):
        pool = pkg.block_pool.BlockPool(num_blocks=32, block_size=4)
        keys = pkg.block_pool.prefix_keys("fp", None, list(range(1, 25)), 4)  # 6 blocks
        blocks = pool.allocate(len(keys))
        for b, k in zip(blocks, keys):
            pool.publish(b, k)
        pool.free(blocks[3:])  # three chains retire into the cached LRU
        return ([k.hex() for k in keys], pool.cached_chain_digest(max_entries=3),
                pool.cached_chain_digest(max_entries=6))

    keys, digest, full = _both(scenario)
    assert digest["entries"] == keys[:3]  # live first
    assert full["entries"] == keys[:3] + keys[:2:-1]  # then the MRU end of the LRU


# ---------------------------------------------------------------------- #
# real engines: drain semantics + an end-to-end fleet
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tiny_pair():
    cfg = JaxConfig.tiny(max_seq_len=64)
    model = JaxCausalLM(cfg)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port_cfg = TransformerConfig.tiny(max_seq_len=64)
    port = CausalLM(port_cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, port_cfg), strict=True)
    return cfg, model, params, port


def _engine(tiny_pair, pkg, **kw):
    _, model, params, port = tiny_pair
    if pkg is REF:
        return jax_serving.ServingEngine(model, params, **kw)
    return serving.ServingEngine(port, **kw)


def test_engine_drain_stops_admission_and_finishes_seats(tiny_pair):
    def scenario(pkg):
        engine = _engine(tiny_pair, pkg, max_slots=1, block_size=4, seed=0)
        rids = [engine.add_request(list(range(1, 6)), max_new_tokens=3, request_id=f"d{i}")
                for i in range(3)]
        engine.step()  # seats the first request
        harvested = [r.request_id for r in engine.drain()]
        health = engine.health()
        late = engine.add_request([1, 2, 3], max_new_tokens=2, request_id="late")
        shed = (engine.shed_reason(late), dict(engine.scheduler.shed_counts))
        while engine.has_work:  # the seated request still finishes
            engine.step()
        first = engine.result(rids[0])
        engine.undrain()
        after = engine.health()
        ok = engine.add_request([1, 2, 3], max_new_tokens=2, request_id="ok")
        while engine.has_work:
            engine.step()
        return rids, harvested, health, shed, first, after, engine.result(ok)

    rids, harvested, health, shed, first, after, ok = _both(scenario)
    assert harvested == rids[1:] and health == {"ok": True, "state": "draining"}
    assert shed[0] == "draining" and shed[1]["draining"] == 1
    assert first is not None and after["state"] == "serving" and ok is not None


def test_engine_prefix_digest_scoped_and_bounded(tiny_pair):
    def scenario(pkg):
        engine = _engine(tiny_pair, pkg, max_slots=2, block_size=4, seed=0, prefix_cache=True,
                         model_fingerprint="digest-test")
        engine.add_request(list(range(1, 14)), max_new_tokens=2)
        while engine.has_work:
            engine.step()
        return engine.prefix_digest(), engine.prefix_digest(2)

    digest, cut = _both(scenario)
    assert digest["enabled"] and digest["fingerprint"] == "digest-test"
    expected = block_pool.prefix_keys("digest-test", None, list(range(1, 14)), 4)
    assert set(digest["entries"]) >= {k.hex() for k in expected}
    assert len(cut["entries"]) == 2 and cut["truncated"]


def _trace_without_times(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


def test_fleet_e2e_affinity_beats_round_robin(tiny_pair, tmp_path):
    """Three real engines on one fake clock, each package: prefix affinity
    gathers each cohort's chain on one replica (more cache hits than round
    robin), outputs are the same under both policies, every replica builds
    one decode step; and the port's tokens, placements, router summary and
    merged trace (times aside) equal the reference's."""
    cohorts = [[10 + c] * 8 for c in range(2)]
    prompts = [cohorts[i % 2] + [30 + i, 31 + i] for i in range(8)]

    def scenario(pkg):
        out = {}
        for policy in ("round_robin", "prefix_affinity"):
            clock = FakeClock()
            engines = [_engine(tiny_pair, pkg, max_slots=2, block_size=4, seed=0,
                               prefix_cache=True, model_fingerprint="fleet-e2e", now=clock)
                       for _ in range(3)]
            fleet = pkg.router.FleetRouter(
                [pkg.router.InProcessReplica(f"r{i}", e) for i, e in enumerate(engines)],
                policy=policy, now=clock)
            rids = []
            for i, p in enumerate(prompts):
                rids.append(fleet.add_request(list(p), max_new_tokens=3, request_id=f"q{i}"))
                _drain_fleet(fleet, clock, budget=500)
            trace = fleet.export_trace(str(tmp_path / f"{pkg.name}-{policy}.json"))
            out[policy] = {
                "outs": [fleet.result(r) for r in rids],
                "placed": [fleet._placements[r] for r in rids],
                "hits": sum(e.prefix_cache.stats()["hits"] for e in engines),
                "decodes": [e.trace_counts().get("decode", 0) for e in engines],
                "summary": fleet.router_summary(),
                "transfer": fleet.transfer_summary(),
                "trace": _trace_without_times(trace),
            }
        return out

    out = _both(scenario)
    rr, af = out["round_robin"], out["prefix_affinity"]
    assert af["outs"] == rr["outs"] and all(o is not None for o in af["outs"])
    assert af["hits"] > rr["hits"]
    assert af["hits"] == len(prompts) - 2  # all but each cohort's opener
    # one decode build a replica (0 for one that never decoded)
    assert all(d <= 1 for d in af["decodes"] + rr["decodes"])
    assert af["transfer"] == {} and len(af["trace"]) > 3


# ---------------------------------------------------------------------- #
# export_trace: one merged Perfetto timeline for the whole fleet
# ---------------------------------------------------------------------- #
def test_export_trace_merges_replica_rows_and_transfer_ledger(tmp_path):
    """Per-replica span logs and the hand-off ledger land in one Chrome-trace
    JSON: a named process row per replica, a kv-transfer row, every slice on
    the fleet's shared time origin."""
    def scenario(pkg):
        fleet, engines, _ = _fleet(pkg, n=2)
        # real span logs with one finished request each, offset so the
        # shared origin is r0's submit (t = 2.0)
        for i, eng in enumerate(engines):
            log = pkg.spans.SpanLog()
            t0 = 2.0 + i
            log.on_submit(f"req-{i}", t0, prompt_tokens=8)
            log.on_admit(f"req-{i}", t0 + 0.1)
            log.on_prefill(f"req-{i}", t0 + 0.1)
            log.on_first_token(f"req-{i}", t0 + 0.3)
            log.on_finish(f"req-{i}", t0 + 0.5, new_tokens=4)
            eng.span_log = log
        # the ledger entries _deliver() and _drop_record() keep
        fleet._transfer_trace.append({
            "request_id": "req-0", "src": "r0", "dst": "r1", "state": "delivered",
            "started_at": 2.4, "done_at": 2.6, "bytes": 4096, "blocks": 2})
        fleet._transfer_trace.append({
            "request_id": "req-x", "src": "r0", "dst": None, "state": "dropped",
            "reason": "dst_dead", "started_at": 3.0, "done_at": 3.0, "bytes": 0,
            "blocks": 0})
        with open(fleet.export_trace(str(tmp_path / f"{pkg.name}.json"))) as f:
            return json.load(f)

    events = _both(scenario)["traceEvents"]
    rows = {e["args"]["name"]: e["pid"] for e in events
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert set(rows) == {"r0", "r1", "kv-transfer"} and len(set(rows.values())) == 3
    slices = [e for e in events if e["ph"] == "X"]
    by_name = {e["name"]: e for e in slices}
    xfer = by_name["transfer:r0->r1"]
    assert xfer["pid"] == rows["kv-transfer"]
    assert xfer["args"]["bytes"] == 4096 and xfer["args"]["blocks"] == 2
    assert by_name["transfer-drop:dst_dead"]["dur"] == 0.0
    # the earliest submit (2.0) is ts 0; the transfer 0.4 s later is 400000 us
    assert min(e["ts"] for e in slices) == 0.0
    assert xfer["ts"] == pytest.approx(0.4e6)
    assert {"queue", "prefill", "decode"} <= {
        e["name"] for e in slices if e["pid"] in (rows["r0"], rows["r1"])}


def test_export_trace_empty_fleet_writes_valid_json(tmp_path):
    def scenario(pkg):
        fleet, _, _ = _fleet(pkg, n=2)  # the fakes have no span log
        with open(fleet.export_trace(str(tmp_path / f"empty-{pkg.name}.json"))) as f:
            return json.load(f)

    assert _both(scenario)["traceEvents"] == []


# ---------------------------------------------------------------------- #
# chip_smoke.py's fleet_soak arms through both packages
# ---------------------------------------------------------------------- #
def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _quarter(phases):
    import dataclasses

    return tuple(dataclasses.replace(p, duration_s=p.duration_s / 4) for p in phases)


def _comparable(arm: dict) -> dict:
    """An arm's report without its wall time stamp and with the decode
    build count both engines keep, and its counts and build deltas."""
    report = arm["report"]
    out = {k: v for k, v in report.items() if k not in ("time_unix", "trace_counts")}
    out["decode_builds"] = report["trace_counts"]["decode"]
    out.update(counts=arm["counts"], decode_retraces=arm["decode_retraces"],
               prefill_retraces=arm["prefill_retraces"], kill=arm.get("kill"))
    return json.loads(json.dumps(out, default=str))


@pytest.fixture()
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fleet_arms_match_the_reference(one_torch_thread):
    """chip_smoke.py's ``fleet_soak`` arms (the reference benchmark's
    ``measure.py:1774-1839``) at a tiny config (max_seq_len 128, 2 slots,
    blocks of 8), every phase a quarter of its length, through both
    packages: the reports agree field for field (placement per replica,
    warm hits, the kill's ledger) and no replica rebuilds its decode step.
    (Affinity's margin over round robin needs the full length's traffic:
    phase 16's check (c) and ``test_fleet_e2e_affinity_beats_round_robin``
    hold it.)"""
    import accelerate_tpu.loadgen as jax_loadgen
    from accelerate_tpu_torch import loadgen

    cfg = JaxConfig.tiny(max_seq_len=128)
    model = JaxCausalLM(cfg)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port_cfg = TransformerConfig.tiny(max_seq_len=128)
    port = CausalLM(port_cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, port_cfg), strict=True)
    cs = _chip_smoke()
    runs = {}
    for name, pkg, rpkg, make in (
            ("reference", jax_loadgen, jax_router, lambda clock: jax_serving.ServingEngine(
                model, params, max_slots=2, block_size=8, now=clock, prefix_cache=True,
                model_fingerprint="fleet-bench")),
            ("port", loadgen, router, lambda clock: serving.ServingEngine(
                port, max_slots=2, block_size=8, now=clock, prefix_cache=True,
                model_fingerprint="fleet-bench"))):
        plan = cs.fleet_plan(pkg, cfg, max_slots=2, block_size=8, target_requests=48, seed=0)
        plan.update(policy_phases=_quarter(plan["policy_phases"]),
                    kill_phases=_quarter(plan["kill_phases"]))
        runs[name] = cs.fleet_arms(pkg, rpkg, make, plan)
    assert plan["prime_lens"] == [2, 4, 8, 16, 32, 40]
    for arm in ("round_robin", "least_loaded", "prefix_affinity", "replica_kill"):
        got, want = runs["port"][arm], runs["reference"][arm]
        assert _comparable(got) == _comparable(want), arm
        assert not any(got["decode_retraces"]) and got["report"]["requests_finished"] > 0
    kill = runs["port"]["replica_kill"]
    assert kill["counts"]["requests_lost"] == kill["kill"]["seats"]
    assert kill["kill"]["requeued_finished_or_shed"]
