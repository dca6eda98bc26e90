"""The port's prefill/decode disaggregation against the JAX reference's.

Mirrors ``tests/test_disagg.py`` (16 cases), each run on both packages on
the reference's tiny model (its params carried over with
``params_from_jax``) where the reference has a result: engine roles, the
hand-off's tokens against the colocated engine's, the dedup against the
decode side's content index, the inbox, the int8 swap round trip and the
int8 hand-off, the router's ``placement="disagg"`` with its stall, drop and
kill damage, the transfer faults, and ``HTTPReplica``'s degraded digest.
Then the parity cases: a one-prefill, one-decode router-pumped fleet whose
tokens, placements, manifests (keys and bytes), ``router_summary``,
``transfer_summary`` and merged ``export_trace`` (times aside) equal the
reference's; and chip_smoke.py's ``disagg_soak`` arms and probe
(``disagg_plan``/``disagg_arms``/``disagg_probe``, the reference
benchmark's ``measure.py:1919-2203``) at a tiny config, a quarter of their
length, through both packages.

A manifest's ``data`` differs in layout only: the reference holds one
numpy array a cache leaf with the block position first, the port one
tensor a cache tensor (``PagedKVCache.tensors()``) with it on axis 1; the
bytes are the same. Everything compared is exact.
"""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu.loadgen as jax_loadgen  # noqa: E402
import accelerate_tpu.loadgen.chaos as jax_chaos  # noqa: E402
import accelerate_tpu.router as jax_router  # noqa: E402
import accelerate_tpu.serving as jax_serving  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.test_utils import fault_injection as jax_faults  # noqa: E402
from accelerate_tpu_torch import CausalLM, TransformerConfig, loadgen, params_from_jax  # noqa: E402
from accelerate_tpu_torch import router, serving  # noqa: E402
from accelerate_tpu_torch.loadgen import chaos  # noqa: E402
from accelerate_tpu_torch.test_utils import fault_injection  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("reference", "port")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def tick(self, dt: float = 0.01) -> None:
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
    return model, params, port


PROMPTS = [
    list(range(3, 15)),  # 12 tokens: a full block and a tail at block_size 8
    list(range(5, 21)),  # 16 tokens: block-aligned
    list(range(3, 15)),  # the first again: the dedup donor
    list(range(7, 30)),  # 23 tokens
]


def _pkg(name):
    if name == "reference":
        return dict(serving=jax_serving, router=jax_router, chaos=jax_chaos, faults=jax_faults,
                    loadgen=jax_loadgen)
    return dict(serving=serving, router=router, chaos=chaos, faults=fault_injection,
                loadgen=loadgen)


def _engine(tiny_pair, name, role="colocated", plane=None, **kw):
    model, params, port = tiny_pair
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefix_cache", True)
    if name == "reference":
        return jax_serving.ServingEngine(model, params, role=role, transfer_plane=plane, **kw)
    return serving.ServingEngine(port, role=role, transfer_plane=plane, **kw)


def _run_colocated(tiny_pair, name, prompts, **kw):
    eng = _engine(tiny_pair, name, **kw)
    rids = [eng.add_request(p, max_new_tokens=6, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    while eng.has_work:
        eng.step()
    return {rid: eng.result(rid) for rid in rids}


def _pump_pair(pre, dec, budget=300):
    """Drive a prefill/decode engine pair by hand (no router)."""
    for _ in range(budget):
        if not (pre.has_work or dec.has_work):
            return
        pre.step()
        for m in pre.pop_manifests():
            dec.acquire(m)
        dec.step()
    raise AssertionError("disagg pair did not drain")


def _both(scenario):
    """``scenario(name)`` for the reference and the port: equal
    observations; returns the port's."""
    want, got = (scenario(name) for name in PACKAGES)
    assert got == want
    return got


# ---------------------------------------------------------------------- #
# engine roles
# ---------------------------------------------------------------------- #
def test_role_validation(tiny_pair):
    def scenario(name):
        with pytest.raises(ValueError, match="role"):
            _engine(tiny_pair, name, role="verifier")
        eng = _engine(tiny_pair, name)
        roles = [eng.role]
        eng.set_role("prefill")
        roles.append(eng.role)
        with pytest.raises(ValueError, match="role"):
            eng.set_role("nope")
        return roles

    assert _both(scenario) == ["colocated", "prefill"]


def test_colocated_gauge_schema_is_unchanged(tiny_pair):
    """A colocated engine's gauges carry no transfer field; a prefill
    engine's carry its role and the hand-off counts, with the reference's
    keys."""
    def scenario(name):
        colo = _engine(tiny_pair, name)._gauge_fields()
        pre = _engine(tiny_pair, name, role="prefill")._gauge_fields()
        extra = {k: v for k, v in pre.items() if k not in colo}
        return ("role" in colo or any(k.startswith("transfer_") for k in colo)
                or "manifests_out" in colo), extra

    leaked, extra = _both(scenario)
    assert not leaked and extra["role"] == "prefill" and extra["manifests_out"] == 0


def test_handoff_outputs_bitwise_vs_colocated(tiny_pair):
    def scenario(name):
        base = _run_colocated(tiny_pair, name, PROMPTS)
        plane = _pkg(name)["serving"].TransferPlane("inprocess")
        pre = _engine(tiny_pair, name, role="prefill", plane=plane)
        dec = _engine(tiny_pair, name, role="decode", plane=plane)
        for i, p in enumerate(PROMPTS):
            pre.add_request(p, max_new_tokens=6, request_id=f"r{i}")
        _pump_pair(pre, dec)
        got = {rid: dec.result(rid) for rid in base}
        return (base, got, [pre.result(r) for r in base], dec.trace_counts()["prefill"],
                dec.trace_counts()["decode"])

    base, got, pre_results, prefills, decodes = _both(scenario)
    assert got == base
    # prompt ingestion only: the prefill engine keeps no result, and the
    # decode engine builds no prefill and one decode step
    assert pre_results == [None] * 4 and (prefills, decodes) == (0, 1)


def test_manifest_acquire_dedups_cached_blocks(tiny_pair):
    """An identical prompt's second hand-off moves only the tail block: the
    full prompt block is found in the decode side's content index."""
    def scenario(name):
        plane = _pkg(name)["serving"].TransferPlane("inprocess")
        pre = _engine(tiny_pair, name, role="prefill", plane=plane)
        dec = _engine(tiny_pair, name, role="decode", plane=plane)
        out = []
        for rid in ("a", "b"):
            pre.add_request(PROMPTS[0], max_new_tokens=4, request_id=rid)
            while pre.has_work:
                pre.step()
            (m,) = pre.pop_manifests()
            out.append((dec.acquire(m), m.bytes_per_block(), m.nbytes, m.n_blocks,
                        [k.hex() for k in m.keys]))
            while dec.has_work:
                dec.step()
        return out, dec.result("a"), dec.result("b"), dec.transfer_gauges()

    (first, second), a, b, gauges = _both(scenario)
    assert first[0] == {"seated": True, "reused_blocks": 0, "moved_blocks": 2,
                        "moved_bytes": 2 * first[1]}
    assert second[0]["seated"] and second[0]["reused_blocks"] == 1
    assert second[0]["moved_blocks"] == 1 and second[0]["moved_bytes"] == second[1]
    assert a == b and gauges["blocks_deduped"] == 1 and gauges["manifests_in"] == 2


def test_acquire_defers_to_inbox_when_full(tiny_pair):
    def scenario(name):
        plane = _pkg(name)["serving"].TransferPlane("inprocess")
        pre = _engine(tiny_pair, name, role="prefill", plane=plane)
        dec = _engine(tiny_pair, name, role="decode", plane=plane, max_slots=1)
        for i in (0, 3):
            pre.add_request(PROMPTS[i], max_new_tokens=4, request_id=f"r{i}")
        while pre.has_work:
            pre.step()
        manifests = pre.pop_manifests()
        seats = [dec.acquire(m) for m in manifests]
        depth, has_work = dec.transfer_gauges()["transfer_inbox_depth"], dec.has_work
        while dec.has_work:
            dec.step()  # the seat frees, the inbox drains, both finish
        return len(manifests), seats, depth, has_work, dec.result("r0"), dec.result("r3")

    n, seats, depth, has_work, r0, r3 = _both(scenario)
    assert n == 2 and seats[0]["seated"] and seats[1] == {"seated": False}
    assert depth == 1 and has_work and r0 is not None and r3 is not None


# ---------------------------------------------------------------------- #
# int8 swap round trip
# ---------------------------------------------------------------------- #
def test_int8_swap_roundtrip_is_bitwise_including_scales(tiny_pair):
    """A swap-out and swap-in of int8 blocks is bit for bit, codes and the
    per-token fp32 scale rows alike, so a restored block dequantizes as it
    did; the images hold the reference's bytes."""
    nbytes = {}
    for name in PACKAGES:
        eng = _engine(tiny_pair, name, kv_dtype="int8", prefix_cache=False)
        eng.add_request(PROMPTS[3], max_new_tokens=4, request_id="q")
        eng.step()  # admit and prefill: the blocks hold real codes
        (slot,) = [s for s in eng.scheduler.slots if s.busy]
        blocks = list(slot.blocks)
        data, nbytes[name] = eng._swap_out_blocks(blocks)
        fresh = eng.pool.allocate(len(blocks))
        eng._restore_blocks(fresh, data)
        again, nbytes2 = eng._swap_out_blocks(fresh)
        assert nbytes2 == nbytes[name]
        for a, b in zip(data, again):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port's images: int8 pools, fp32 scale rows (layers, blocks,
    # block_size), the block position on axis 1
    assert [d.dtype for d in data] == [torch.int8] * 2 + [torch.float32] * 2
    assert all(d.shape[1] == len(blocks) for d in data)
    assert data[2].shape[-1] == eng.block_size and nbytes["port"] == nbytes["reference"] > 0


def test_int8_handoff_outputs_match_int8_colocated(tiny_pair):
    def scenario(name):
        base = _run_colocated(tiny_pair, name, PROMPTS[:2], kv_dtype="int8")
        pre = _engine(tiny_pair, name, role="prefill", kv_dtype="int8")
        dec = _engine(tiny_pair, name, role="decode", kv_dtype="int8")
        for i, p in enumerate(PROMPTS[:2]):
            pre.add_request(p, max_new_tokens=6, request_id=f"r{i}")
        _pump_pair(pre, dec)
        return base, {rid: dec.result(rid) for rid in base}

    base, got = _both(scenario)
    assert got == base


# ---------------------------------------------------------------------- #
# disagg routing
# ---------------------------------------------------------------------- #
def _disagg_fleet(tiny_pair, name, clock, n_prefill=2, n_decode=2, manifests=None):
    """A prefix-affinity disagg fleet over one ``inprocess`` plane; with
    ``manifests`` (a list), every manifest the prefill replicas give the
    router is recorded there (id, keys, blocks, bytes, first token)."""
    pkg = _pkg(name)
    plane = pkg["serving"].TransferPlane("inprocess", now=clock)
    engines = [_engine(tiny_pair, name, role="prefill", plane=plane, now=clock)
               for _ in range(n_prefill)]
    engines += [_engine(tiny_pair, name, role="decode", plane=plane, now=clock)
                for _ in range(n_decode)]
    if manifests is not None:
        for eng in engines[:n_prefill]:
            pop = eng.pop_manifests

            def recording(pop=pop):
                out = pop()
                manifests.extend((m.request_id, [k.hex() for k in m.keys], m.n_blocks,
                                  m.cache_len, m.nbytes, m.first_token) for m in out)
                return out

            eng.pop_manifests = recording
    names = [f"p{i}" for i in range(n_prefill)] + [f"d{i}" for i in range(n_decode)]
    reps = [pkg["router"].InProcessReplica(n, e) for n, e in zip(names, engines)]
    fleet = pkg["router"].FleetRouter(reps, policy="prefix_affinity", placement="disagg",
                                      transfer_plane=plane, now=clock)
    return fleet, plane


def _drain(fleet, clock, budget=500):
    for _ in range(budget):
        if not fleet.has_work:
            return
        fleet.step()
        clock.tick(0.01)
    raise AssertionError("disagg fleet did not drain")


def test_router_disagg_end_to_end_bitwise(tiny_pair):
    def scenario(name):
        base = _run_colocated(tiny_pair, name, PROMPTS)
        clock = FakeClock()
        fleet, _ = _disagg_fleet(tiny_pair, name, clock)
        for i, p in enumerate(PROMPTS):
            fleet.add_request(p, max_new_tokens=6, request_id=f"r{i}")
        _drain(fleet, clock)
        return (base, {rid: fleet.result(rid) for rid in base}, fleet.transfer_summary(),
                fleet.transfer_record("r0"), dict(fleet.routed_by_replica))

    base, got, summary, rec, routed = _both(scenario)
    assert got == base
    assert summary["placement"] == "disagg" and summary["delivered_total"] == 4
    assert summary["in_flight"] == 0 and summary["plane"]["transfers_total"] == 4
    assert 0.0 <= summary["plane"]["dedup_ratio"] <= 1.0
    assert rec["src"].startswith("p") and rec["dst"].startswith("d") and rec["bytes"] > 0
    assert routed["d0"] == routed["d1"] == 0  # no prompt lands on a decode replica


def test_transfer_stall_damage_bounded_to_waiting(tiny_pair):
    """A stall wedges deliveries and loses nothing: every affected request
    finishes after the window, and the recovery time is reported."""
    def scenario(name):
        clock = FakeClock()
        fleet, _ = _disagg_fleet(tiny_pair, name, clock)
        for i, p in enumerate(PROMPTS):
            fleet.add_request(p, max_new_tokens=6, request_id=f"r{i}")
        fleet.stall_transfers(2.0)
        for _ in range(50):
            fleet.step()
            clock.tick(0.01)
        wedged = fleet.transfer_summary()["in_flight"], fleet.requests_lost
        clock.tick(5.0)  # the stall ends
        _drain(fleet, clock)
        return (wedged, {rid: fleet.result(rid) for rid in ("r0", "r1", "r2", "r3")},
                fleet.requests_lost, fleet.transfer_summary())

    wedged, got, lost, summary = _both(scenario)
    assert wedged[0] > 0 and wedged[1] == 0  # wedged, not lost
    assert got == _run_colocated(tiny_pair, "port", PROMPTS)
    assert lost == 0 and summary["stalls_total"] == 1 and summary["stall_recovery_s"] > 0.0


def test_transfer_drop_requeues_under_original_id(tiny_pair):
    def scenario(name):
        clock = FakeClock()
        fleet, _ = _disagg_fleet(tiny_pair, name, clock, n_prefill=1, n_decode=1)
        fleet.add_request(PROMPTS[0], max_new_tokens=6, request_id="r0")
        fleet.stall_transfers(60.0)  # holds the manifest on the wire
        for _ in range(50):
            fleet.step()
            clock.tick(0.01)
            if fleet.transfer_summary()["in_flight"]:
                break
        in_flight = fleet.transfer_summary()["in_flight"]
        out = fleet.drop_transfers()
        ledger = fleet.requests_lost, fleet.requests_requeued
        clock.tick(120.0)
        _drain(fleet, clock)
        return in_flight, out, ledger, fleet.result("r0"), fleet.transfer_summary()

    in_flight, out, ledger, result, summary = _both(scenario)
    assert in_flight == 1 and out["dropped"] == 1 and ledger == (0, 1)
    assert result == _run_colocated(tiny_pair, "port", PROMPTS[:1])["r0"]
    assert summary["dropped_total"] == 1


def test_kill_mid_transfer_requeues_parked_manifests(tiny_pair):
    """A decode replica that dies with manifests parked in its inbox gives
    those prompts back to the fleet instead of losing them."""
    def scenario(name):
        clock = FakeClock()
        fleet, _ = _disagg_fleet(tiny_pair, name, clock, n_prefill=1, n_decode=2)
        for i, p in enumerate(PROMPTS):
            fleet.add_request(p, max_new_tokens=6, request_id=f"r{i}")
        for _ in range(30):
            fleet.step()
            clock.tick(0.01)
            if fleet.transfers_delivered_total:
                break
        victim = fleet.transfer_record(next(
            rid for rid in ("r0", "r1", "r2", "r3") if fleet.transfer_record(rid)))["dst"]
        killed = fleet.kill(victim)
        _drain(fleet, clock)
        return (victim, killed, {rid: fleet.result(rid) for rid in ("r0", "r1", "r2", "r3")},
                fleet.transfer_summary()["in_flight"], fleet.router_summary())

    victim, killed, got, in_flight, summary = _both(scenario)
    base = _run_colocated(tiny_pair, "port", PROMPTS)
    # seated decodes died with the victim (counted as lost); whatever ran
    # again is still the colocated engine's tokens
    assert all(v is None or v == base[rid] for rid, v in got.items())
    assert in_flight == 0 and summary["requests_lost"] == killed["lost"]


# ---------------------------------------------------------------------- #
# fault grammar + chaos
# ---------------------------------------------------------------------- #
def test_fault_grammar_accepts_transfer_actions():
    def scenario(name):
        parse = _pkg(name)["faults"].FaultSpec.parse
        stall, drop = parse("transfer_stall@3:secs=2:replica=1"), parse("transfer_drop@5")
        with pytest.raises(ValueError, match="secs"):
            parse("transfer_drop@5:secs=2")
        return (stall.action, stall.stall_secs, stall.replica, drop.action, drop.replica)

    assert _both(scenario) == ("transfer_stall", 2.0, 1, "transfer_drop", None)


def _fire(name, engine, clock, specs, step):
    pkg = _pkg(name)
    injector = pkg["faults"].FaultInjector([], rank=0, generation=0)
    adapter = pkg["chaos"].ChaosAdapter(engine, injector, clock)
    injector.specs = [pkg["faults"].FaultSpec.parse(s) for s in specs]
    injector.maybe_fire(step)
    return adapter, injector


def test_chaos_transfer_actions_fire_against_disagg_fleet(tiny_pair):
    def scenario(name):
        clock = FakeClock()
        fleet, _ = _disagg_fleet(tiny_pair, name, clock, n_prefill=1, n_decode=1)
        adapter, injector = _fire(name, fleet, clock, ["transfer_stall@0:secs=3:replica=0"], 0)
        stalls = fleet.transfer_summary()["stalls_total"]
        injector.specs = [_pkg(name)["faults"].FaultSpec.parse("transfer_drop@1")]
        injector.maybe_fire(1)
        return adapter.events, stalls

    events, stalls = _both(scenario)
    (stall,) = [e for e in events if e["action"] == "transfer_stall"]
    (drop,) = [e for e in events if e["action"] == "transfer_drop"]
    assert (stall["secs"], stall["replica"], stalls) == (3.0, "p0", 1)
    assert drop["dropped"] == 0  # nothing in flight yet


def test_chaos_transfer_actions_skip_plain_engine(tiny_pair):
    """The transfer faults install against any engine and skip, with an
    event, where the engine is not a disagg router."""
    def scenario(name):
        adapter, _ = _fire(name, _engine(tiny_pair, name), FakeClock(),
                           ["transfer_stall@0:secs=1", "transfer_drop@0"], 0)
        return [e.get("skipped") for e in adapter.events]

    assert _both(scenario) == ["not_a_disagg_fleet"] * 2


# ---------------------------------------------------------------------- #
# HTTPReplica's degraded digest
# ---------------------------------------------------------------------- #
def test_http_digest_degrades_to_empty_instead_of_raising():
    def scenario(name):
        rep = _pkg(name)["router"].HTTPReplica("r0", "http://127.0.0.1:1", timeout_s=0.05)
        digest = rep.fetch_digest(16)  # connection refused: no raise
        first = rep.digest_failures_total
        rep.fetch_digest(16)
        return digest, first, rep.digest_failures_total

    digest, first, second = _both(scenario)
    assert digest == {"entries": [], "block_size": 0, "fingerprint": "", "stale": True}
    assert (first, second) == (1, 2)


def test_router_prefers_last_known_digest_over_degraded():
    class Rep:
        name = "r0"
        alive = True
        draining = False

        def __init__(self):
            self.good = True

        def fetch_digest(self, max_entries):
            if self.good:
                return {"entries": ["aa"], "block_size": 4, "fingerprint": "fp"}
            return {"entries": [], "block_size": 0, "fingerprint": "", "stale": True}

    def scenario(name):
        clock = FakeClock()
        fleet = _pkg(name)["router"].FleetRouter(now=clock, digest_max_age_s=0.0)
        rep = Rep()
        fleet.register(rep)
        fresh = fleet._digest(rep)["keys"]
        rep.good = False
        clock.tick(1.0)
        return fresh, fleet._digest(rep)["keys"]  # the degraded digest keeps the warm view

    assert _both(scenario) == ({"aa"}, {"aa"})


# ---------------------------------------------------------------------- #
# parity: a router-pumped 1P + 1D fleet, decision for decision
# ---------------------------------------------------------------------- #
def _trace_without_times(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


def test_one_prefill_one_decode_fleet_matches_the_reference(tiny_pair, tmp_path):
    """Four prompts through a prefix-affinity 1P + 1D fleet on one fake
    clock: the port's tokens, per-request placement, every manifest (id,
    chain keys, blocks, cache length, bytes, first token), per-request
    transfer records, ``router_summary``, ``transfer_summary`` and merged
    trace (times aside) are the reference's."""
    def scenario(name):
        clock = FakeClock()
        manifests = []
        fleet, _ = _disagg_fleet(tiny_pair, name, clock, n_prefill=1, n_decode=1,
                                 manifests=manifests)
        rids = [fleet.add_request(p, max_new_tokens=6, request_id=f"r{i}")
                for i, p in enumerate(PROMPTS)]
        _drain(fleet, clock)
        trace = fleet.export_trace(str(tmp_path / f"{name}.json"))
        return {"tokens": [fleet.result(r) for r in rids],
                "placed": [fleet._placements[r] for r in rids], "manifests": manifests,
                "records": [fleet.transfer_record(r) for r in rids],
                "router": fleet.router_summary(), "transfer": fleet.transfer_summary(),
                "trace": _trace_without_times(trace)}

    got = _both(scenario)
    assert got["tokens"] == list(_run_colocated(tiny_pair, "port", PROMPTS).values())
    assert got["placed"] == ["d0"] * 4 and len(got["manifests"]) == 4
    assert got["transfer"]["plane"]["transfers_total"] == got["transfer"]["delivered_total"] == 4
    assert any(e["name"].startswith("transfer:p0->d0") for e in got["trace"] if e["ph"] == "X")


# ---------------------------------------------------------------------- #
# chip_smoke.py's disagg_soak arms and probe through both packages
# ---------------------------------------------------------------------- #
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _quarter(phases):
    return tuple(dataclasses.replace(p, duration_s=p.duration_s / 4) for p in phases)


def _comparable(arm: dict) -> dict:
    report = arm["report"]
    out = {k: v for k, v in report.items() if k not in ("time_unix", "trace_counts")}
    out["decode_builds"] = report["trace_counts"]["decode"]
    out.update(counts=arm["counts"], decode_retraces=arm["decode_retraces"],
               prefill_retraces=arm["prefill_retraces"], stalled=arm["stalled"])
    return json.loads(json.dumps(out, default=str))


@pytest.fixture()
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_disagg_arms_and_probe_match_the_reference(one_torch_thread):
    """chip_smoke.py's ``disagg_soak`` arms at a tiny config (max_seq_len
    128, 2 slots, blocks of 8), every phase a quarter of its length, and its
    probe, through both packages: the reports (the transfer ledger and
    per-role gauges included) agree field for field, the decode pool builds
    neither a prefill nor a second decode step, the stall loses nothing,
    and the probe's tokens across the hand-off are the colocated engine's."""
    cfg = JaxConfig.tiny(max_seq_len=128)
    model = JaxCausalLM(cfg)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port_cfg = TransformerConfig.tiny(max_seq_len=128)
    port = CausalLM(port_cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, port_cfg), strict=True)
    cs = _chip_smoke()
    makers = {
        "reference": lambda clock, plane, role="colocated": jax_serving.ServingEngine(
            model, params, max_slots=2, block_size=8, now=clock, prefix_cache=True,
            model_fingerprint="disagg-bench", transfer_plane=plane, role=role),
        "port": lambda clock, plane, role="colocated": serving.ServingEngine(
            port, max_slots=2, block_size=8, now=clock, prefix_cache=True,
            model_fingerprint="disagg-bench", transfer_plane=plane, role=role),
    }
    runs, probes = {}, {}
    for name in PACKAGES:
        pkg = _pkg(name)
        plan = cs.disagg_plan(pkg["loadgen"], cfg, max_slots=2, block_size=8,
                              target_requests=32, seed=0)
        plan.update(ab_phases=_quarter(plan["ab_phases"]),
                    stall_phases=_quarter(plan["stall_phases"]),
                    stall_fault="transfer_stall@0:secs=0.25")
        runs[name] = cs.disagg_arms(pkg["loadgen"], pkg["router"], pkg["serving"].TransferPlane,
                                    makers[name], plan)
        probes[name] = cs.disagg_probe(pkg["serving"].TransferPlane, lambda role, plane, m=makers[
            name]: m(FakeClock(), plane, role), cfg.vocab_size, plan)
    assert plan["prime_lens"] == [2, 4, 8, 16, 32, 64]
    for arm in ("colocated", "disagg", "transfer_stall"):
        got, want = runs["port"][arm], runs["reference"][arm]
        assert _comparable(got) == _comparable(want), arm
        assert not any(got["decode_retraces"]) and got["report"]["requests_finished"] > 0
        assert all(n == 0 for n, role in zip(got["prefill_retraces"], got["roles"])
                   if role == "decode")
    stall = runs["port"]["transfer_stall"]
    assert stall["counts"]["requests_lost"] == 0 and stall["transfer"]["in_flight"] == 0
    assert runs["port"]["disagg"]["counts"]["transfers_delivered"] > 0
    (base, got), want = probes["port"], probes["reference"]
    assert got == base and (base, got) == want and all(v is not None for v in got.values())
