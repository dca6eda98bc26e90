"""The soak harness's tenants and the adapter-churn fault in the port,
against the JAX reference, on the CPU.

``tests/test_loadgen.py::test_adapter_churn_evicts_and_restores`` on both
packages (the events and the registries' ends equal), and a short soak
whose requests name two tenants, with an ``adapter_churn`` fault in its
fault phase, through both packages' harnesses and engines on the virtual
clock: the reports equal (wall stamps and build counts aside), the tenants
reloaded after the churn, one decode build.
"""

import pytest

jax = pytest.importorskip("jax")

import accelerate_tpu.serving as jax_serving  # noqa: E402

from accelerate_tpu_torch import serving  # noqa: E402
from test_torch_adapters import (  # noqa: E402
    _CFG,
    _LCFG,
    _PLCFG,
    _rand_adapter,
    _registries,
    _to_port,
    reset_port_singletons,
    tiny,
)

__all__ = ["reset_port_singletons", "tiny"]  # the fixtures this file takes from its sibling


# --------------------------------------------------------------------- #
# the soak's tenants and the adapter-churn fault
# --------------------------------------------------------------------- #
def test_adapter_churn_evicts_and_restores():
    """``tests/test_loadgen.py::test_adapter_churn_evicts_and_restores`` on
    both packages: a capacity-full wave evicts every unpinned tenant, none
    of the wave stays, ``release`` calls the restore callback; the two
    registries end alike and the events are the reference's."""
    import accelerate_tpu.loadgen as jax_loadgen
    from accelerate_tpu.test_utils import fault_injection as jax_faults

    from accelerate_tpu_torch import loadgen
    from accelerate_tpu_torch.test_utils import fault_injection

    class Engine:  # the registry is all the fault reads
        pass

    events = {}
    for name, (lg, faults, reg) in {
            "port": (loadgen, fault_injection, _registries(capacity=3)[0]),
            "reference": (jax_loadgen, jax_faults, _registries(capacity=3)[1])}.items():
        engine = Engine()
        engine.adapters = reg
        reg.load("tenant", _to_port(_rand_adapter(1)) if name == "port" else _rand_adapter(1),
                 _PLCFG if name == "port" else _LCFG)
        restored = []
        chaos = lg.ChaosAdapter(engine, faults.FaultInjector([], rank=0, generation=0),
                                lambda: 0.0, restore=lambda: restored.append(1))
        chaos._on_adapter_churn(faults.FaultSpec.parse("adapter_churn@0"))
        assert reg.evict_total > 0 and reg.resident_names() == []
        chaos.release()
        assert restored == [1]
        events[name] = [{k: v for k, v in e.items() if k != "t"} for e in chaos.events]
    assert events["port"] == events["reference"]


def test_soak_tenants_and_churn_match_the_reference(tiny):
    """A short soak whose requests name two tenants, with an adapter-churn
    fault in its fault phase, on the virtual clock through both packages'
    harnesses and engines: the tenants load, the churn evicts and the
    restore reloads them, and the reports agree (wall stamps and the build
    counts aside, whose decode entry is 1 in both)."""
    import accelerate_tpu.loadgen as jax_loadgen

    from accelerate_tpu_torch import loadgen

    model, params, pmodel = tiny
    reports, regs = {}, {}
    for name, lg in (("port", loadgen), ("reference", jax_loadgen)):
        clock = lg.SoakClock()
        reg = _registries(capacity=2)[0 if name == "port" else 1]
        kw = dict(max_slots=2, block_size=8, now=clock, adapters=reg)
        engine = (serving.ServingEngine(pmodel, **kw) if name == "port"
                  else jax_serving.ServingEngine(model, params, **kw))
        wl = lg.WorkloadConfig(vocab_size=_CFG.vocab_size, prompt_tokens_min=2,
                               prompt_tokens_median=4, prompt_tokens_max=12,
                               output_tokens_min=2, output_tokens_median=3,
                               output_tokens_max=6, max_total_tokens=24,
                               adapters=("a", "b"), adapter_fraction=0.5)
        phases = lg.standard_program(warmup_s=0.25, warmup_rps=4.0, ramp_rates=(8.0, 16.0),
                                     ramp_step_s=0.25, soak_s=0.25, soak_rps=8.0, fault_s=0.25,
                                     recovery_s=0.25)
        cfg = lg.SoakConfig(workload=wl, phases=phases, seed=3, step_dt_s=0.01,
                            fault_specs="adapter_churn@0", drain_grace_s=10.0)
        reports[name] = lg.SoakHarness(engine, cfg, clock=clock).run()
        regs[name] = reg
    got, want = ({k: v for k, v in r.items() if k not in ("time_unix", "trace_counts")}
                 for r in (reports["port"], reports["reference"]))
    assert got == want
    assert reports["port"]["trace_counts"]["decode"] == 1
    assert got["fault"]["events"][0]["action"] == "adapter_churn"
    assert got["requests_finished"] + got["requests_shed"] == got["requests_submitted"] > 0
    reg, ref_reg = regs["port"], regs["reference"]
    assert reg.resident_names() == ref_reg.resident_names() == ["a", "b"]
    assert (reg.load_total, reg.evict_total) == (ref_reg.load_total, ref_reg.evict_total)
