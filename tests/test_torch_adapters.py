"""The port's multi-tenant adapters against the JAX reference, on the CPU.

Mirrors the tests of ``tests/test_adapters.py`` that need neither
``hf_interop`` nor the slow mark (its training tests are in
``tests/test_torch_adapter_training.py``), each held against the reference
where it computes something: the same adapters (made by the reference's
``init_adapter`` and carried over with ``params_from_jax``, untransposed)
on the reference's tiny model give the reference's logits within
``FP32_TOL``, its registry stacks bit for bit, its greedy tokens, trace
counts and serve records exactly. The port's own contracts ride along: a
fresh adapter is invisible bit for bit, a mixed batch equals each tenant
alone bit for bit, the registry writes rows in place (the CUDA-graph
contract), and adapter checkpoints cross between the two packages
(``tests/test_torch_adapter_soak.py`` holds the soak's tenants and the
adapter-churn fault).

Rank padding is held at a tolerance: ``test_adapters.py::
test_rank_padding_is_exact`` (bitwise) is red in the reference.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu.adapters as jax_adapters  # noqa: E402
import accelerate_tpu.serving as jax_serving  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch import adapters, serving  # noqa: E402
from accelerate_tpu_torch.adapters.runtime import (  # noqa: E402
    A_KEY,
    B_KEY,
    lora_delta,
    pad_rank,
)

# relative to the largest magnitude; readings on the CPU
FP32_TOL = 1e-5  # logits, losses and adapter gradients of the tiny fp32 model (read 2.6e-6)
RANK_PAD_TOL = 1e-6  # padded against unpadded rank (read 0.0; the reference's bitwise test is red)
_CFG = JaxConfig.tiny()
_PCFG = port.TransformerConfig.tiny()
_LCFG = jax_adapters.LoraConfig(rank=4, alpha=8.0, target_modules=("q_proj", "v_proj"))
_PLCFG = adapters.LoraConfig(rank=4, alpha=8.0, target_modules=("q_proj", "v_proj"))


@pytest.fixture(autouse=True)
def reset_port_singletons():
    def reset():
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()

    reset()
    yield
    reset()


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny model and params, and the port's model carrying
    them."""
    model = JaxCausalLM(_CFG)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    pmodel = port.CausalLM(_PCFG, device="cpu")
    pmodel.load_state_dict(port.params_from_jax(params, _PCFG), strict=True)
    pmodel.requires_grad_(False)
    return model, params, pmodel


def _ids(batch=2, seq=16, seed=0):
    return np.random.default_rng(seed).integers(0, _CFG.vocab_size, (batch, seq)).astype(np.int32)


def _rand_adapter(seed, lcfg=_LCFG, cfg=_CFG):
    """The reference test's adapter with a nonzero B (a fresh one is
    invisible)."""
    ad = jax_adapters.init_adapter(jax.random.PRNGKey(seed), cfg, lcfg)
    return {t: {A_KEY: pair[A_KEY],
                B_KEY: 0.05 * jax.random.normal(jax.random.PRNGKey(seed * 977 + i),
                                                pair[B_KEY].shape)}
            for i, (t, pair) in enumerate(sorted(ad.items()))}


def _to_port(tree):
    return port.params_from_jax(jax.tree.map(np.asarray, tree), _PCFG)


def _port_lcfg(lcfg):
    return adapters.LoraConfig.from_dict(lcfg.to_dict())


def _close(got, want, tol=FP32_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# --------------------------------------------------------------------- #
# config and layout
# --------------------------------------------------------------------- #
def test_lora_config_validation_and_round_trip():
    for bad in (dict(rank=0), dict(dropout=1.0), dict(target_modules=("qproj",)),
                dict(target_modules=())):
        with pytest.raises(ValueError):
            adapters.LoraConfig(**bad)
        with pytest.raises(ValueError):
            jax_adapters.LoraConfig(**bad)
    cfg = adapters.LoraConfig(rank=16, alpha=32.0, target_modules=["q_proj"])
    assert cfg.scaling == 2.0
    assert adapters.LoraConfig.from_dict(cfg.to_dict()) == cfg
    ref = jax_adapters.LoraConfig(rank=16, alpha=32.0, target_modules=["q_proj"])
    assert cfg.to_dict() == ref.to_dict()
    assert adapters.ALL_TARGETS == jax_adapters.ALL_TARGETS


def test_init_adapter_injection_layout():
    lcfg = adapters.LoraConfig(rank=4, target_modules=("q_proj", "k_proj", "o_proj",
                                                       "gate_proj", "down_proj"))
    ad = adapters.init_adapter(torch.Generator().manual_seed(0), _PCFG, lcfg)
    ref = jax_adapters.init_adapter(jax.random.PRNGKey(0), _CFG,
                                    jax_adapters.LoraConfig(**lcfg.to_dict()))
    assert adapters.target_shapes(_PCFG) == jax_adapters.target_shapes(_CFG)
    assert set(ad) == set(ref) == set(lcfg.target_modules)
    for t in lcfg.target_modules:
        for k in (A_KEY, B_KEY):
            assert tuple(ad[t][k].shape) == ref[t][k].shape
        assert not ad[t][B_KEY].any()  # B = 0: the delta is exactly zero at birth
        assert abs(float(ad[t][A_KEY].std()) - 0.02) < 0.002
    assert adapters.adapter_num_params(_PCFG, lcfg) == jax_adapters.adapter_num_params(
        _CFG, jax_adapters.LoraConfig(**lcfg.to_dict())) == sum(
        leaf.numel() for pair in ad.values() for leaf in pair.values())
    assert adapters.adapter_num_bytes(ad) == jax_adapters.adapter_num_bytes(ref)


def test_fresh_adapter_is_bitwise_invisible(tiny):
    model, params, pmodel = tiny
    ids = torch.from_numpy(_ids()).long()
    with torch.no_grad():
        base = pmodel(ids)
        fresh = adapters.init_adapter(torch.Generator().manual_seed(1), _PCFG, _PLCFG)
        out = pmodel(ids, lora=adapters.build_lora_state(fresh, _PLCFG, 2))
        assert torch.equal(base, out)
        ad = _rand_adapter(7)
        out2 = pmodel(ids, lora=adapters.build_lora_state(_to_port(ad), _PLCFG, 2))
    assert not torch.equal(base, out2)
    want = model.apply({"params": params}, jnp.asarray(_ids()),
                       lora=jax_adapters.build_lora_state(ad, _LCFG, 2))
    _close(out2, want)


def test_per_slot_indexing_parity():
    """Each batch row reads only its own stack row: a mixed batch equals
    the row-by-row computations bit for bit, and the reference's delta
    within FP32_TOL."""
    rng = np.random.default_rng(0)
    in_dim, out_dim, r = 8, 6, 4
    a = np.concatenate([np.zeros((1, in_dim, r)), rng.normal(size=(3, in_dim, r))])
    b = np.concatenate([np.zeros((1, r, out_dim)), rng.normal(size=(3, r, out_dim))])
    stacked = {A_KEY: torch.tensor(a, dtype=torch.float32),
               B_KEY: torch.tensor(b, dtype=torch.float32)}
    x = rng.normal(size=(4, 5, in_dim)).astype(np.float32)
    slot_ids = torch.tensor([2, 0, 3, 1])
    scales = torch.tensor([2.0, 1.5, 0.5, 1.0])
    mixed = lora_delta(torch.from_numpy(x), stacked, slot_ids, scales)
    for row in range(4):
        single = lora_delta(torch.from_numpy(x[row:row + 1]), stacked, slot_ids[row:row + 1],
                            scales)
        assert torch.equal(mixed[row], single[0])
    assert not mixed[1].any()  # row 0 is the identity
    want = jax_adapters.lora_delta(
        jnp.asarray(x), {k: jnp.asarray(v.numpy()) for k, v in stacked.items()},
        jnp.asarray(slot_ids.numpy(), jnp.int32), jnp.asarray(scales.numpy()))
    _close(mixed, want)


def test_rank_padding_is_exact():
    """Zero-padding a rank-2 adapter to r_max 8 gives the unpadded delta
    within RANK_PAD_TOL (the products' summation lengths differ, so this is
    not held bitwise)."""
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.normal(size=(1, 8, 2)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(1, 2, 6)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(1, 3, 8)), dtype=torch.float32)
    slot, scale = torch.zeros(1, dtype=torch.long), torch.ones(1)
    small = lora_delta(x, {A_KEY: a, B_KEY: b}, slot, scale)
    padded = lora_delta(x, {A_KEY: pad_rank(a, axis=2, r_max=8),
                            B_KEY: pad_rank(b, axis=1, r_max=8)}, slot, scale)
    _close(padded, small.numpy(), RANK_PAD_TOL)
    assert not pad_rank(a, axis=2, r_max=8)[..., 2:].any()
    with pytest.raises(ValueError):
        pad_rank(a, axis=2, r_max=1)


# --------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------- #
def test_adapter_save_restore_round_trip(tmp_path):
    ad = _to_port(_rand_adapter(5))
    base_dir = str(tmp_path)
    path = adapters.save_adapter(base_dir, "tenant-a", ad, _PLCFG)
    assert os.path.basename(path) == "adapter_tenant-a"
    assert not os.path.exists(path + ".tmp")
    loaded, lcfg = adapters.load_adapter(path)
    assert lcfg == _PLCFG
    for t in _PLCFG.target_modules:
        for k in (A_KEY, B_KEY):
            assert torch.equal(ad[t][k], loaded[t][k]), (t, k)
    assert adapters.list_adapters(base_dir) == {"tenant-a": path}
    with pytest.raises(ValueError):
        adapters.save_adapter(base_dir, "a/b", ad, _PLCFG)
    # the two packages read each other's adapter dirs
    ref_loaded, ref_cfg = jax_adapters.load_adapter(path)
    assert ref_cfg == _LCFG
    for t in _PLCFG.target_modules:
        for k in (A_KEY, B_KEY):
            np.testing.assert_array_equal(np.asarray(ref_loaded[t][k]), ad[t][k].numpy())
    ref_path = jax_adapters.save_adapter(str(tmp_path / "ref"), "t", _rand_adapter(6), _LCFG)
    got, _ = adapters.load_adapter(ref_path)
    for t, pair in _rand_adapter(6).items():
        for k, v in pair.items():
            np.testing.assert_array_equal(got[t][k].numpy(), np.asarray(v))
    # committed adapter bytes <= 2% of the base checkpoint at rank 16, at a
    # width where the ratio is representative (the reference's check)
    cfg = port.TransformerConfig.tiny(hidden_size=512)
    base_ckpt = str(tmp_path / "base")
    port.checkpointing.save_model_weights(port.CausalLM(cfg, device="cpu"), base_ckpt)

    def du(d):
        return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)

    lcfg16 = adapters.LoraConfig(rank=16, target_modules=("q_proj", "v_proj"))
    path16 = adapters.save_adapter(
        base_dir, "rank16", adapters.init_adapter(torch.Generator().manual_seed(2), cfg, lcfg16),
        lcfg16)
    assert du(path16) <= 0.02 * du(base_ckpt), (du(path16), du(base_ckpt))


def test_load_adapter_requires_commit(tmp_path):
    from accelerate_tpu_torch.checkpoint_async.commit import work_dir_for

    final = adapters.adapter_dir(str(tmp_path), "ghost")
    os.makedirs(work_dir_for(final))  # a save in flight, never committed
    with pytest.raises(FileNotFoundError):
        adapters.load_adapter(final)
    assert adapters.list_adapters(str(tmp_path)) == {}


# --------------------------------------------------------------------- #
# the registry: residency, refcounts, LRU
# --------------------------------------------------------------------- #
def _registries(capacity=2, rank=4, targets=_LCFG.target_modules):
    return (adapters.AdapterRegistry(_PCFG, capacity=capacity, max_rank=rank,
                                     target_modules=targets, device="cpu"),
            jax_adapters.AdapterRegistry(_CFG, capacity=capacity, max_rank=rank,
                                         target_modules=targets))


def _same_stacks(reg, ref):
    for t, pair in ref.stacks().items():
        for k, v in pair.items():
            np.testing.assert_array_equal(reg.stacks()[t][k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(reg.scales().numpy(), np.asarray(ref.scales()))


def test_registry_load_evict_refcount_lru():
    """One sequence of loads, pins and evictions on both registries:
    slots, residency, counters and the stacks themselves agree after each;
    the stacks are written in place."""
    reg, ref = _registries()
    ptrs = [leaf.data_ptr() for pair in reg.stacks().values() for leaf in pair.values()]
    a, b, c = (_rand_adapter(s) for s in (10, 11, 12))
    for r, conv in ((reg, _to_port), (ref, lambda x: x)):
        r.load("a", conv(a), _LCFG if r is ref else _PLCFG)
        r.load("b", conv(b), _LCFG if r is ref else _PLCFG)
    _same_stacks(reg, ref)
    assert reg.resident("a") and reg.resident("b") and reg.resident(None)
    assert reg.slot_of(None) == 0 and reg.resident_names() == ["a", "b"]
    assert reg.slot_of("a") == ref.slot_of("a") != reg.slot_of("b") == ref.slot_of("b")
    for r in (reg, ref):
        r.acquire("a")
        with pytest.raises(RuntimeError):
            r.evict("a")  # a request in flight pins it
    reg.load("c", _to_port(c), _PLCFG)
    ref.load("c", c, _LCFG)  # full and "a" pinned: the LRU evicts "b"
    _same_stacks(reg, ref)
    assert not reg.resident("b") and reg.resident("c") and reg.evict_total == 1
    for r, lc in ((reg, _PLCFG), (ref, _LCFG)):
        r.acquire("c")
        with pytest.raises(RuntimeError):
            r.load("d", _to_port(_rand_adapter(13)) if r is reg else _rand_adapter(13), lc)
        r.release("a")
        r.release("c")
        r.evict("c")
    _same_stacks(reg, ref)
    assert not reg.resident("c") and reg.hbm_bytes() == ref.hbm_bytes() > 0
    assert ptrs == [leaf.data_ptr() for pair in reg.stacks().values() for leaf in pair.values()]


def test_registry_validates_rank_targets_shapes():
    reg, ref = _registries()
    wide = adapters.LoraConfig(rank=4, target_modules=("q_proj", "o_proj"))
    jwide = jax_adapters.LoraConfig(rank=4, target_modules=("q_proj", "o_proj"))
    bad = _rand_adapter(1)
    bad["q_proj"][A_KEY] = bad["q_proj"][A_KEY][:, :8, :]
    cases = [
        (_rand_adapter(1, jax_adapters.LoraConfig(rank=8)), adapters.LoraConfig(rank=8),
         jax_adapters.LoraConfig(rank=8)),  # rank > max_rank
        (_rand_adapter(1, jwide), wide, jwide),  # o_proj not in the registry
        (bad, _PLCFG, _LCFG),  # a leaf against the model's layout
    ]
    for ad, lc, jlc in cases:
        with pytest.raises(ValueError):
            reg.load("x", _to_port(ad), lc)
        with pytest.raises(ValueError):
            ref.load("x", ad, jlc)
    l2 = jax_adapters.LoraConfig(rank=2, target_modules=_LCFG.target_modules)
    small = _rand_adapter(2, l2)
    reg.load("small", _to_port(small), _port_lcfg(l2))  # rank 2 pads into rank 4
    ref.load("small", small, l2)
    _same_stacks(reg, ref)


# --------------------------------------------------------------------- #
# serving: admission, tenants in one batch, no rebuild
# --------------------------------------------------------------------- #
def _engines(tiny, capacity=4, **kw):
    """The port's engine and the reference's over the same weights, each
    with an empty registry."""
    model, params, pmodel = tiny
    reg, ref_reg = _registries(capacity=capacity, rank=_LCFG.rank)
    kw.setdefault("max_slots", 4)
    kw.setdefault("block_size", 8)
    return (serving.ServingEngine(pmodel, adapters=reg, **kw), reg,
            jax_serving.ServingEngine(model, params, adapters=ref_reg, **kw), ref_reg)


def _load(regs, name, ad, lcfg=_LCFG):
    reg, ref_reg = regs
    reg.load(name, _to_port(ad), _port_lcfg(lcfg))
    ref_reg.load(name, ad, lcfg)


def _serve(engine, reqs, seed=0):
    """reqs: adapter names (None: the base); returns the tokens by request."""
    rng = np.random.default_rng(seed)
    rids = [engine.add_request(rng.integers(1, 50, size=4 + i).tolist(), max_new_tokens=6,
                               adapter=name, request_id=f"r{seed}-{i}")
            for i, name in enumerate(reqs)]
    for _ in engine.stream():
        pass
    return [engine.result(rid) for rid in rids]


def test_scheduler_gates_admission_on_residency(tiny):
    engine, reg, ref, ref_reg = _engines(tiny)
    for e in (engine, ref):
        rid = e.add_request([1, 2, 3], max_new_tokens=4, adapter="t0", request_id="gated")
        e.step()
        assert e.result(rid) is None  # not resident: queued, and counted
    assert engine.scheduler.blocked_reasons == ref.scheduler.blocked_reasons
    assert (engine._gauge_fields()["admission_blocked_adapter_not_resident_total"]
            == ref._gauge_fields()["admission_blocked_adapter_not_resident_total"] >= 1)
    _load((reg, ref_reg), "t0", _rand_adapter(20))
    for e in (engine, ref):
        for _ in e.stream():
            pass
    assert engine.result("gated") == ref.result("gated") is not None
    with pytest.raises(ValueError):
        serving.ServingEngine(tiny[2], max_slots=2, block_size=8).add_request([1, 2],
                                                                            adapter="t0")


def test_multi_adapter_batch_bitwise_matches_single_tenant(tiny):
    """Three adapters and the base in one batch: each tenant's tokens equal
    a single-tenant engine's of the same width, and the reference's."""
    ads = {f"t{i}": _rand_adapter(30 + i) for i in range(3)}
    names = ["t0", "t1", "t2", None]
    engine, reg, ref, ref_reg = _engines(tiny)
    for name, ad in ads.items():
        _load((reg, ref_reg), name, ad)
    mixed = _serve(engine, names, seed=7)
    assert mixed == _serve(ref, names, seed=7)
    assert engine.trace_counts()["decode"] == ref.trace_counts()["decode"] == 1
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 50, size=4 + j).tolist() for j in range(4)]
    for i, name in enumerate(names):
        single = serving.ServingEngine(tiny[2], adapters=adapters.AdapterRegistry(
            _PCFG, capacity=4, max_rank=_LCFG.rank, target_modules=_LCFG.target_modules,
            device="cpu"), max_slots=4, block_size=8)
        if name is not None:
            single.adapters.load(name, _to_port(ads[name]), _PLCFG)
        rid = single.add_request(prompts[i], max_new_tokens=6, adapter=name)
        for _ in single.stream():
            pass
        assert single.result(rid) == mixed[i], name
    assert len({tuple(o) for o in mixed}) > 1


def test_zero_decode_retraces_across_adapter_churn(tiny):
    engine, reg, ref, ref_reg = _engines(tiny)
    regs = (reg, ref_reg)
    _load(regs, "t0", _rand_adapter(40))
    out = [_serve(e, ["t0", None]) for e in (engine, ref)]
    warm = dict(engine.trace_counts())
    for i in (1, 2, 3):
        _load(regs, f"t{i}", _rand_adapter(40 + i))
    out += [_serve(e, ["t1", "t2", "t3", None], seed=1) for e in (engine, ref)]
    _load(regs, "t4", _rand_adapter(44))  # the LRU evicts a cold tenant
    out += [_serve(e, ["t4", "t1"], seed=2) for e in (engine, ref)]
    assert out[0::2] == out[1::2]
    assert engine.trace_counts()["decode"] == warm["decode"] == 1
    for kind in ("decode", "prefill"):
        assert engine.trace_counts()[kind] == ref.trace_counts()[kind]
    assert reg.load_total == ref_reg.load_total == 5
    assert reg.evict_total == ref_reg.evict_total >= 1


def test_serve_telemetry_carries_adapter_id(tiny):
    """Serve records, spans and the Prometheus text carry the adapter, as
    the reference's do: under one fake clock the serve records equal the
    reference's (``time_unix`` aside), and the spans' ids and adapters."""
    import accelerate_tpu.telemetry as jax_telemetry

    from accelerate_tpu_torch import telemetry

    class Clock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    model, params, pmodel = tiny
    out = {}
    for name, pkg in (("port", telemetry), ("reference", jax_telemetry)):
        tel = pkg.StepTelemetry(True)
        sink = tel.add_sink(pkg.PrometheusTextSink(path=None))
        clock = Clock()
        kw = dict(max_slots=4, block_size=8, telemetry=tel, gauge_interval=1, now=clock)
        if name == "port":
            reg = _registries()[0]
            engine = serving.ServingEngine(pmodel, adapters=reg, **kw)
            reg.load("t0", _to_port(_rand_adapter(50)), _PLCFG)
        else:
            reg = _registries()[1]
            engine = jax_serving.ServingEngine(model, params, adapters=reg, **kw)
            reg.load("t0", _rand_adapter(50), _LCFG)
        for i, adapter in enumerate(["t0", None]):
            engine.add_request([3 + i, 9, 4, 1], max_new_tokens=4, adapter=adapter,
                               request_id=f"q{i}")
        while engine.has_work:
            engine.step()
            clock.t += 0.25
        out[name] = (tel, sink, engine)
    tel, sink, engine = out["port"]
    records = [r for r in tel.records if r.get("kind") == "serve"]
    assert {r["adapter_id"] for r in records} == {"t0", None}
    assert sorted((s.adapter_id for s in engine.span_log.closed),
                  key=lambda a: a or "") == [None, "t0"]
    text = sink.render()
    assert 'accelerate_tpu_serve_requests_total{adapter="t0"} 1' in text, text
    assert 'accelerate_tpu_serve_requests_total{adapter="none"} 1' in text, text
    assert 'accelerate_tpu_serve_adapters_resident{label="serve"} 1.0' in text, text
    ref_records = [r for r in out["reference"][0].records if r.get("kind") == "serve"]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "time_unix"} for r in rs]  # noqa: E731
    assert strip(records) == strip(ref_records)
    spans = [r for r in tel.records if r.get("kind") == "span"]
    ref_spans = [r for r in out["reference"][0].records if r.get("kind") == "span"]
    assert [(r["request_id"], r["adapter_id"]) for r in spans] == [
        (r["request_id"], r["adapter_id"]) for r in ref_spans]
    for t, _, _ in out.values():
        t.close()
