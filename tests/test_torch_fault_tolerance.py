"""The port's ``CheckpointManager``: the reference's
``tests/test_fault_tolerance.py`` mirrored (cadence and rotation, SIGTERM
and opt-in SIGINT preemption, the drain before the final save, resume with
fallback, construction checks, an idempotent ``close`` that leaves a newer
handler alone), the heartbeat hook, and both packages' managers run side
by side on one tiny model.

Tolerances: within the port, bit for bit. Across the packages (fp32,
adamw lr 1e-3, the same weights by ``params_from_jax`` and the same
batches): 2e-5, the fp32 parity of ``tests/test_torch_accelerator.py``.
"""

import glob
import os
import signal
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.fault_tolerance import CheckpointManager as JaxCheckpointManager  # noqa: E402
from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu_torch import dist_checkpoint  # noqa: E402
from accelerate_tpu_torch.checkpoint_async import commit as commit_mod  # noqa: E402


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_port_singletons():
    _reset()
    yield
    _reset()


def _setup(tmp_path, total_limit=3):
    _reset()
    pc = port.ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True,
                                   total_limit=total_limit)
    acc = port.Accelerator(cpu=True, project_config=pc)
    opt = acc.prepare(port.sgd(0.1))
    carry = acc.init_carry({"w": torch.zeros(4, 4)}, opt)
    step = acc.unified_step(lambda p, b: ((p["w"] - b["t"]) ** 2).mean())
    return acc, carry, step, {"t": torch.ones(4, 4)}


def test_cadence_checkpoints_and_rotation(tmp_path):
    acc, carry, step, batch = _setup(tmp_path, total_limit=2)
    with port.CheckpointManager(acc, every_n_steps=2, handle_signals=False) as mgr:
        saved = []
        for _ in range(6):
            carry, _ = step(carry, batch)
            out = mgr.step(carry)
            if out:
                saved.append(out)
    assert len(saved) == 3  # steps 2, 4, 6
    # total_limit 2: the third save rotated the first out
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_1", "checkpoint_2"]


def test_preemption_signal_forces_checkpoint_and_stop(tmp_path):
    acc, carry, step, batch = _setup(tmp_path)
    with port.CheckpointManager(acc, every_n_steps=1000) as mgr:
        carry, _ = step(carry, batch)
        assert mgr.step(carry) is None  # far from the cadence
        os.kill(os.getpid(), signal.SIGTERM)  # the eviction notice
        assert mgr.preempted and not mgr.should_stop
        carry, _ = step(carry, batch)
        out = mgr.step(carry)
        assert out is not None and mgr.should_stop
        assert commit_mod.is_committed(out)


def test_auto_resume_continues_from_checkpoint(tmp_path):
    acc, carry, step, batch = _setup(tmp_path)
    with port.CheckpointManager(acc, every_n_steps=2, handle_signals=False) as mgr:
        for _ in range(4):
            carry, _ = step(carry, batch)
            mgr.step(carry)
    w_at_4 = carry["params"]["w"].detach().clone()
    acc2, carry2, _, _ = _setup(tmp_path)
    with port.CheckpointManager(acc2, every_n_steps=2, handle_signals=False) as mgr2:
        carry2, resumed = mgr2.restore_or_init(carry2)
    assert resumed and acc2.step == 4
    assert torch.equal(carry2["params"]["w"], w_at_4)
    assert carry2["opt_step"] == 4


def test_preemption_drains_inflight_async_save_then_writes_final(tmp_path, monkeypatch):
    """SIGTERM while a background save is still writing: the manager drains
    it, then writes the final checkpoint synchronously, and a restart
    resumes from the final one."""
    acc, carry, step, batch = _setup(tmp_path)
    real_write = dist_checkpoint.write_snapshot

    def slow_write(snap, out_dir, fsync=False):
        time.sleep(0.3)
        return real_write(snap, out_dir, fsync=fsync)

    monkeypatch.setattr(dist_checkpoint, "write_snapshot", slow_write)
    with port.CheckpointManager(acc, every_n_steps=2, async_saves=True) as mgr:
        for _ in range(2):
            carry, _ = step(carry, batch)
            mgr.step(carry)  # step 2: an async save in flight (a 0.3 s write)
        assert mgr.in_flight
        os.kill(os.getpid(), signal.SIGTERM)
        assert mgr.preempted
        carry, _ = step(carry, batch)
        out = mgr.step(carry)  # drain, then the final sync checkpoint
        assert out is not None and mgr.should_stop
        assert not mgr.in_flight
    base = tmp_path / "checkpoints"
    assert sorted(os.listdir(base)) == ["checkpoint_0", "checkpoint_1"]
    for name in os.listdir(base):
        assert commit_mod.is_committed(str(base / name))
    acc2, carry2, _, _ = _setup(tmp_path)
    with port.CheckpointManager(acc2, handle_signals=False) as mgr2:
        carry2, resumed = mgr2.restore_or_init(carry2)
    assert resumed and acc2.step == 3
    assert torch.equal(carry2["params"]["w"], carry["params"]["w"])


def test_restore_or_init_without_checkpoints(tmp_path):
    acc, carry, _, _ = _setup(tmp_path)
    with port.CheckpointManager(acc, handle_signals=False) as mgr:
        out, resumed = mgr.restore_or_init(carry)
    assert not resumed and out is carry


def test_rejects_bad_cadence(tmp_path):
    acc, *_ = _setup(tmp_path)
    with pytest.raises(ValueError):
        port.CheckpointManager(acc, every_n_steps=0)


def test_requires_automatic_naming():
    with pytest.raises(ValueError, match="automatic checkpoint naming"):
        port.CheckpointManager(port.Accelerator(cpu=True))


def test_restore_falls_back_when_newest_checkpoint_corrupt(tmp_path):
    acc, carry, step, batch = _setup(tmp_path)
    with port.CheckpointManager(acc, every_n_steps=2, handle_signals=False) as mgr:
        for i in range(4):
            carry, _ = step(carry, batch)
            mgr.step(carry)
            if i == 1:
                w_at_2 = carry["params"]["w"].detach().clone()
    for shard in glob.glob(str(tmp_path / "checkpoints" / "checkpoint_1" / "state_shard_*")):
        os.remove(shard)  # the newest (step 4) loses its shard file
    acc2, carry2, _, _ = _setup(tmp_path)
    with port.CheckpointManager(acc2, handle_signals=False) as mgr2:
        carry2, resumed = mgr2.restore_or_init(carry2)
    assert resumed and acc2.step == 2
    assert torch.equal(carry2["params"]["w"], w_at_2)


def test_restore_raises_when_every_checkpoint_corrupt(tmp_path):
    acc, carry, step, batch = _setup(tmp_path)
    with port.CheckpointManager(acc, every_n_steps=2, handle_signals=False) as mgr:
        for _ in range(4):
            carry, _ = step(carry, batch)
            mgr.step(carry)
    for shard in glob.glob(str(tmp_path / "checkpoints" / "*" / "state_shard_*")):
        os.remove(shard)
    acc2, carry2, _, _ = _setup(tmp_path)
    with port.CheckpointManager(acc2, handle_signals=False) as mgr2:
        with pytest.raises(RuntimeError, match="every checkpoint"):
            mgr2.restore_or_init(carry2)


def test_sigint_opt_in_gets_preemption_semantics(tmp_path):
    """signals=(SIGTERM, SIGINT) gives Ctrl-C the final-checkpoint contract;
    without it SIGINT keeps its KeyboardInterrupt handler."""
    acc, carry, step, batch = _setup(tmp_path)
    default_int = signal.getsignal(signal.SIGINT)
    with port.CheckpointManager(acc, every_n_steps=1000) as mgr:
        assert signal.getsignal(signal.SIGINT) is default_int
        assert signal.getsignal(signal.SIGTERM) == mgr._on_preemption
    with port.CheckpointManager(acc, every_n_steps=1000,
                                signals=(signal.SIGTERM, signal.SIGINT)) as mgr:
        assert signal.getsignal(signal.SIGINT) == mgr._on_preemption
        carry, _ = step(carry, batch)
        os.kill(os.getpid(), signal.SIGINT)  # no KeyboardInterrupt
        assert mgr.preempted
        carry, _ = step(carry, batch)
        out = mgr.step(carry)
        assert out is not None and mgr.should_stop
    assert signal.getsignal(signal.SIGINT) is default_int


def test_close_is_idempotent_and_restores_handlers(tmp_path):
    acc, *_ = _setup(tmp_path)
    prev = signal.getsignal(signal.SIGTERM)
    mgr = port.CheckpointManager(acc, every_n_steps=1000)
    assert signal.getsignal(signal.SIGTERM) == mgr._on_preemption
    mgr.close()
    assert signal.getsignal(signal.SIGTERM) is prev
    mgr.close()  # the atexit hook after __exit__: a no-op
    assert signal.getsignal(signal.SIGTERM) is prev


def test_close_does_not_clobber_newer_handler(tmp_path):
    acc, *_ = _setup(tmp_path)
    prev = signal.getsignal(signal.SIGTERM)
    m1 = port.CheckpointManager(acc, every_n_steps=1000)
    m2 = port.CheckpointManager(acc, every_n_steps=1000)
    assert signal.getsignal(signal.SIGTERM) == m2._on_preemption
    m1.close()
    assert signal.getsignal(signal.SIGTERM) == m2._on_preemption
    m2.close()
    signal.signal(signal.SIGTERM, prev)  # unwind the nested install


def test_heartbeat_is_any_object_with_beat(tmp_path):
    """``heartbeat=`` takes any object with ``beat(count)``; without one the
    manager looks for the telemetry's (the port's has none yet: None)."""
    acc, carry, step, batch = _setup(tmp_path)

    class Beats:
        def __init__(self):
            self.counts = []

        def beat(self, count):
            self.counts.append(count)

    beats = Beats()
    with port.CheckpointManager(acc, every_n_steps=2, handle_signals=False,
                                heartbeat=beats) as mgr:
        for _ in range(3):
            carry, _ = step(carry, batch)
            mgr.step(carry)
    assert beats.counts == [1, 2, 3]
    with port.CheckpointManager(acc, handle_signals=False) as mgr:
        assert mgr.heartbeat is None


# ---------------------------------------------------------------------- #
# both packages' managers on one tiny model
# ---------------------------------------------------------------------- #
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64)
SEQ, BATCH, LR, STEPS = 16, 8, 1e-3, 6


def _batch(i):
    return np.random.default_rng(i).integers(0, MODEL["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def _relative(records, base):
    return [(r["mode"], r["step"], os.path.relpath(r["dir"], base)) for r in records
            if r.get("kind") == "checkpoint"]


def _jax_side(base, params):
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()

    def accelerator():
        pc = jax_pkg.ProjectConfiguration(project_dir=base, automatic_checkpoint_naming=True,
                                          total_limit=2)
        acc = jax_pkg.Accelerator(project_config=pc, telemetry=True)
        p, opt = acc.prepare(jax.tree.map(jnp.asarray, params), optax.adamw(LR))
        return acc, opt, acc.init_carry(p, opt)

    acc, opt, carry = accelerator()
    step = acc.unified_step(JaxCausalLM.loss_fn(JaxCausalLM(JaxConfig(**MODEL))), opt)
    with JaxCheckpointManager(acc, every_n_steps=2, handle_signals=False,
                              async_saves=True) as mgr:
        for i in range(STEPS):
            carry, _ = step(carry, {"input_ids": jnp.asarray(_batch(i))})
            mgr.step(carry)
        mgr.wait()
    records = _relative(acc.telemetry.records, base)
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    acc2, _, fresh = accelerator()
    with JaxCheckpointManager(acc2, handle_signals=False) as mgr:
        restored, resumed = mgr.restore_or_init(fresh)
    return records, restored, resumed, acc2.step


def _port_side(base, params):
    def accelerator():
        _reset()
        pc = port.ProjectConfiguration(project_dir=base, automatic_checkpoint_naming=True,
                                       total_limit=2)
        acc = port.Accelerator(cpu=True, project_config=pc, telemetry=True)
        model = port.CausalLM(port.TransformerConfig(**MODEL), device="cpu")
        model.load_state_dict(port.params_from_jax(params, model.config), strict=True)
        model, opt = acc.prepare(model, port.adamw(LR))
        return acc, model, opt, acc.init_carry(model, opt)

    acc, model, opt, carry = accelerator()
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt)
    with port.CheckpointManager(acc, every_n_steps=2, handle_signals=False,
                                async_saves=True) as mgr:
        for i in range(STEPS):
            carry, _ = step(carry, {"input_ids": torch.from_numpy(_batch(i))})
            mgr.step(carry)
        mgr.wait()
    records = _relative(acc.telemetry.records, base)
    acc2, _, _, fresh = accelerator()
    with port.CheckpointManager(acc2, handle_signals=False) as mgr:
        restored, resumed = mgr.restore_or_init(fresh)
    return records, restored, resumed, acc2.step


def test_async_managers_match_the_reference(tmp_path):
    """Six steps with an async save every 2 in each package: the same
    directory names, saved steps, committed set and record fields (mode,
    step, dir), and restore_or_init gives the same params and moments."""
    params = jax.tree.map(np.asarray, nn.unbox(
        JaxCausalLM(JaxConfig(**MODEL)).init_params(jax.random.PRNGKey(0), seq_len=SEQ)))
    jbase, pbase = str(tmp_path / "ref"), str(tmp_path / "port")
    jrec, jcarry, jresumed, jstep = _jax_side(jbase, params)
    prec, pcarry, presumed, pstep = _port_side(pbase, params)
    assert prec == jrec == [("async", s, f"checkpoints/checkpoint_{i}")
                            for i, s in enumerate((2, 4, 6))]
    names = sorted(os.listdir(os.path.join(pbase, "checkpoints")))
    assert names == sorted(os.listdir(os.path.join(jbase, "checkpoints")))
    assert names == ["checkpoint_1", "checkpoint_2"]  # total_limit 2
    for name in names:
        assert commit_mod.is_committed(os.path.join(pbase, "checkpoints", name))
    assert jresumed and presumed and jstep == pstep == STEPS
    assert pcarry["opt_step"] == int(jcarry["opt_step"]) == STEPS
    cfg = port.TransformerConfig(**MODEL)
    (adam,) = [s for s in jcarry["opt_state"] if hasattr(s, "mu")]
    for port_tree, jax_tree in ((pcarry["params"], jcarry["params"]),
                                (pcarry["opt_state"]["mu"], adam.mu),
                                (pcarry["opt_state"]["nu"], adam.nu)):
        want = port.params_from_jax(jax.tree.map(np.asarray, jax_tree), cfg)
        assert set(want) == set(port_tree)
        for name, w in want.items():
            np.testing.assert_allclose(port_tree[name].detach().numpy(), w.numpy(), atol=2e-5,
                                       rtol=0, err_msg=name)
    assert pcarry["opt_state"]["count"] == int(adam.count) == STEPS
