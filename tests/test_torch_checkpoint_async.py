"""The port's async checkpoints: the one-process cases of the reference's
``tests/test_checkpoint_async.py`` mirrored, the snapshot's ownership of
its memory under the port's in-place updates, a load that fails changing
nothing, the two repairs (``load_state(allow_reshape=False)`` and the sync
save's ``kind="checkpoint"`` record), and the reference's checkpoints
carried over in both directions.

Mirrors all of the reference file, the done-marker barrier included (both
packages' ``wait_for_done_markers`` time out naming the missing process, and
two processes' commits, here two threads, rename once). The
reference's ``test_to_host_batches_device_transfers_into_one_call`` becomes
the pinned buffer set's: one allocation a set, reused, every copy into it
queued before one wait. Its ``test_snapshot_tree_holds_no_device_arrays``
holds the port's snapshot to host tensors of its own.

Tolerances: within the port, bit for bit. Across the packages, the
carried values themselves are equal bit for bit; the fp16 runs continued
for two calls hold losses at 2e-5 relative and params at 2e-5 absolute (the
fp32 tolerance; read 8e-8 and 6.6e-6 at most), counters and the loss scale exactly,
and the moments and the accumulation buffer, which hold fp16 gradients, at
``FP16_GRAD_TOL`` of each leaf's largest value.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import threading
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
from accelerate_tpu.checkpointing import flatten_tree as jax_flatten  # noqa: E402
from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu_torch import checkpointing as ckpt  # noqa: E402
from accelerate_tpu_torch import dist_checkpoint  # noqa: E402
from accelerate_tpu_torch.checkpoint_async import commit as commit_mod  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the blocked-time case's one slowed write. Its async save blocks for the
# snapshot of a 4x4 tensor, the host-state capture and the writer thread's
# start: a few ms, and under 0.2 s under the test command's 6 loaded workers
SLOW = 1.0


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_port_singletons():
    _reset()
    yield
    _reset()


def _setup(tmp_path, telemetry=False, total_limit=3):
    _reset()
    pc = port.ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True,
                                   total_limit=total_limit)
    acc = port.Accelerator(cpu=True, project_config=pc, telemetry=telemetry)
    opt = acc.prepare(port.sgd(0.1))
    carry = acc.init_carry({"w": torch.zeros(4, 4)}, opt)
    step = acc.unified_step(lambda p, b: ((p["w"] - b["t"]) ** 2).mean())
    return acc, carry, step, {"t": torch.ones(4, 4)}


def _checkpoint_records(acc):
    return [r for r in acc.telemetry.records if r.get("kind") == "checkpoint"]


# ---------------------------------------------------------------------- #
# commit protocol unit
# ---------------------------------------------------------------------- #
def test_commit_renames_work_dir_and_marks_committed(tmp_path):
    final = str(tmp_path / "checkpoint_0")
    work = commit_mod.work_dir_for(final)
    assert work.endswith(commit_mod.TMP_SUFFIX)
    assert commit_mod.is_work_dir(work) and not commit_mod.is_work_dir(final)
    os.makedirs(work)
    with open(os.path.join(work, "shard.bin"), "wb") as f:
        f.write(b"data")
    assert commit_mod.commit(work, final) == final
    assert not os.path.exists(work)
    assert commit_mod.is_committed(final)
    with open(os.path.join(final, "shard.bin"), "rb") as f:
        assert f.read() == b"data"


def test_commit_replaces_existing_final_dir(tmp_path):
    final = str(tmp_path / "ckpt")
    for payload in (b"old", b"new"):
        work = commit_mod.work_dir_for(final)
        os.makedirs(work)
        with open(os.path.join(work, "shard.bin"), "wb") as f:
            f.write(payload)
        commit_mod.commit(work, final)
    with open(os.path.join(final, "shard.bin"), "rb") as f:
        assert f.read() == b"new"
    assert commit_mod.is_committed(final)
    assert [n for n in os.listdir(tmp_path) if ".old." in n] == []


def test_done_marker_barrier_times_out_listing_missing_procs(tmp_path):
    from accelerate_tpu.checkpoint_async import commit as jax_commit

    for mod in (jax_commit, commit_mod):
        work = str(tmp_path / f"{mod.__name__}" / "checkpoint_0.tmp")
        os.makedirs(work)
        mod.mark_done(work, 0)
        with pytest.raises(TimeoutError, match=r"\[1\]"):
            mod.wait_for_done_markers(work, world=2, timeout_s=0.2)
    # two processes' commits: process 1 waits for the rename, process 0
    # renames once both markers are there, and stamps the topology
    final = str(tmp_path / "two" / "checkpoint_0")
    work = commit_mod.work_dir_for(final)
    os.makedirs(work)
    got = []
    other = threading.Thread(target=lambda: got.append(commit_mod.commit(work, final, 1, 2)))
    other.start()
    assert commit_mod.commit(work, final, 0, 2, topology={"world_size": 2}) == final
    other.join()
    assert got == [final] and commit_mod.is_committed(final) and not os.path.exists(work)
    assert commit_mod.read_topology(final) == {"world_size": 2}
    assert sorted(n for n in os.listdir(final) if n.startswith("done_")) == [
        "done_00000", "done_00001"]


# ---------------------------------------------------------------------- #
# async end to end
# ---------------------------------------------------------------------- #
def test_async_cadence_saves_commit_and_restore(tmp_path):
    acc, carry, step, batch = _setup(tmp_path)
    with port.CheckpointManager(acc, every_n_steps=2, handle_signals=False,
                                async_saves=True) as mgr:
        started = []
        for _ in range(6):
            carry, _ = step(carry, batch)
            out = mgr.step(carry)
            if out:
                started.append(out)
        mgr.wait()
        assert not mgr.in_flight
    assert len(started) == 3  # steps 2, 4, 6
    base = tmp_path / "checkpoints"
    assert sorted(os.listdir(base)) == ["checkpoint_0", "checkpoint_1", "checkpoint_2"]
    for name in os.listdir(base):
        assert commit_mod.is_committed(str(base / name))
    w6 = carry["params"]["w"].detach().clone()

    acc2, carry2, _, _ = _setup(tmp_path)
    with port.CheckpointManager(acc2, handle_signals=False) as mgr2:
        carry2, resumed = mgr2.restore_or_init(carry2)
    assert resumed and acc2.step == 6
    assert torch.equal(carry2["params"]["w"], w6)
    assert carry2["opt_step"] == 6


def test_async_blocked_time_excludes_serialization_and_io(tmp_path, monkeypatch):
    """With the shard write slowed by SLOW seconds, the async save's
    blocked_s and the call's wall time stay under SLOW while background_s
    takes it; a sync save of the same state blocks for it."""
    acc, carry, step, batch = _setup(tmp_path, telemetry=True)
    carry, _ = step(carry, batch)
    real_write = dist_checkpoint.write_snapshot

    def slow_write(snap, out_dir, fsync=False):
        time.sleep(SLOW)
        return real_write(snap, out_dir, fsync=fsync)

    monkeypatch.setattr(dist_checkpoint, "write_snapshot", slow_write)
    t0 = time.perf_counter()
    acc.save_state(carry=carry, block=False)
    wall = time.perf_counter() - t0
    acc.wait_for_checkpoint()
    rec_async = _checkpoint_records(acc)[-1]
    assert rec_async["mode"] == "async"
    assert wall < SLOW
    assert rec_async["blocked_s"] < SLOW
    assert rec_async["background_s"] >= SLOW
    assert rec_async["bytes_written"] > 0

    carry, _ = step(carry, batch)
    acc.save_state(carry=carry)  # sync: pays the slow write in line
    rec_sync = _checkpoint_records(acc)[-1]
    assert rec_sync["mode"] == "sync"
    assert rec_sync["blocked_s"] >= SLOW
    assert rec_sync["background_s"] == 0.0
    assert rec_async["blocked_s"] < rec_sync["blocked_s"]
    base = tmp_path / "checkpoints"
    assert commit_mod.is_committed(str(base / "checkpoint_0"))
    assert commit_mod.is_committed(str(base / "checkpoint_1"))


def test_background_failure_discards_work_dir_and_restore_falls_back(tmp_path, monkeypatch):
    acc, carry, step, batch = _setup(tmp_path)
    carry, _ = step(carry, batch)
    acc.save_state(carry=carry)  # checkpoint_0, committed at step 1
    carry, _ = step(carry, batch)

    def boom(snap, out_dir, fsync=False):
        raise RuntimeError("disk died")

    monkeypatch.setattr(dist_checkpoint, "write_snapshot", boom)
    acc.save_state(carry=carry, block=False)
    with pytest.raises(RuntimeError, match="NOT committed"):
        acc.wait_for_checkpoint()
    base = tmp_path / "checkpoints"
    assert sorted(os.listdir(base)) == ["checkpoint_0"]
    # the failed job handed its buffer set back
    assert acc._async_checkpointer.buffers._free.qsize() == 2

    acc2, carry2, _, _ = _setup(tmp_path)
    with port.CheckpointManager(acc2, handle_signals=False) as mgr:
        carry2, resumed = mgr.restore_or_init(carry2)
    assert resumed and acc2.step == 1


def test_uncommitted_tmp_invisible_to_restore_and_rotation(tmp_path):
    acc, carry, step, batch = _setup(tmp_path, total_limit=2)
    base = tmp_path / "checkpoints"
    os.makedirs(base)
    stale = base / "checkpoint_7.tmp"  # a crashed save: data, no COMMITTED
    os.makedirs(stale)
    (stale / "state_shard_00000.safetensors").write_bytes(b"junk")
    for _ in range(3):  # total_limit=2: the third save rotates the first out
        carry, _ = step(carry, batch)
        acc.save_state(carry=carry)
    names = [os.path.basename(p) for p in ckpt._list_checkpoints(str(base))]
    assert names == ["checkpoint_1", "checkpoint_2"]
    assert stale.is_dir()
    assert not (base / "checkpoint_0").exists()

    acc2, carry2, _, _ = _setup(tmp_path)
    with port.CheckpointManager(acc2, handle_signals=False) as mgr:
        carry2, resumed = mgr.restore_or_init(carry2)
    assert resumed and acc2.step == 3


# ---------------------------------------------------------------------- #
# the snapshot: one pinned allocation a set, memory of its own
# ---------------------------------------------------------------------- #
def test_buffer_set_is_one_allocation_reused_after_release(monkeypatch):
    """The port's counterpart of the reference's one batched device_get: a
    set of host buffers is ONE page-locked allocation (the CPU stands in
    for it here), cut into aligned views that do not overlap; every set is
    allocated at the first save and reused while the layout stays; a set
    goes back to the pool only when released, and acquire waits while every
    set is out."""
    allocs = []

    def fake_pinned(nbytes):
        allocs.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)

    monkeypatch.setattr(dist_checkpoint, "_pinned_empty", fake_pinned)
    layout = [("a", (3,), torch.float32), ("b", (5, 7), torch.bfloat16), ("c", (), torch.int64)]
    pool = dist_checkpoint.HostBufferPool(2)
    first = pool.acquire(layout)
    assert len(allocs) == 2 and first.nbytes == allocs[0] == allocs[1]  # both sets
    spans = sorted((v.data_ptr(), v.data_ptr() + v.numel() * v.element_size())
                   for v in first.views.values())
    assert all(lo % 64 == spans[0][0] % 64 for lo, _ in spans)
    assert all(hi <= lo for (_, hi), (lo, _) in zip(spans, spans[1:]))
    leaves = {"a": torch.arange(3.0), "b": torch.randn(5, 7).to(torch.bfloat16),
              "c": torch.tensor(9)}
    got = {k: first.copy_in(k, v) for k, v in leaves.items()}
    first.seal()  # no CUDA copy: nothing to wait for
    first.wait()
    assert all(torch.equal(got[k], v) for k, v in leaves.items())
    second = pool.acquire(layout)
    assert second is not first and len(allocs) == 2  # no allocation at the second save
    took = []
    waiter = threading.Thread(target=lambda: took.append(pool.acquire(layout)))
    waiter.start()
    waiter.join(timeout=0.2)
    assert waiter.is_alive()  # both sets are out
    pool.release(first)
    waiter.join(timeout=10)
    assert not waiter.is_alive() and took == [first]
    assert len(allocs) == 2  # reused, not allocated again
    assert pool.pinned_bytes == 2 * first.nbytes


def test_snapshot_tree_holds_host_tensors_of_its_own(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "scale": np.float32(2.0), "n": np.arange(3),
            "step": 3, "name": "skipped"}
    snap = dist_checkpoint.snapshot_tree(tree)
    assert all(type(t) is torch.Tensor and t.device.type == "cpu"
               for t in snap.tensors.values())
    assert "name@0" not in snap.tensors and snap.nbytes > 0
    ptr = tree["w"].untyped_storage().data_ptr()
    assert snap.tensors["w@0"].untyped_storage().data_ptr() != ptr
    tree["n"] += 5  # a numpy leaf changed in place after the snapshot
    assert snap.tensors["n@0"].tolist() == [0, 1, 2]
    dist_checkpoint.write_snapshot(snap, str(tmp_path))
    restored = dist_checkpoint.load_sharded_tree(
        {"w": torch.zeros(3, 4), "scale": np.float32(0.0), "step": 0}, str(tmp_path),
        strict=False)
    assert torch.equal(restored["w"], torch.arange(12.0).reshape(3, 4))
    assert restored["step"] == 3


def test_async_snapshot_shares_no_storage_and_keeps_the_submit_state(tmp_path):
    """The port's step updates params, moments and counters in place. The
    snapshot an async save takes shares no storage with a live leaf, and
    the checkpoint holds the state at the call although three more steps
    change the same tensors while the writer runs (its write is held until
    they are done)."""
    acc, carry, step, batch = _setup(tmp_path)
    carry, _ = step(carry, batch)
    snap = dist_checkpoint.snapshot_tree(carry)
    live = {t.untyped_storage().data_ptr() for t in ckpt.flatten_tree(carry).values()
            if isinstance(t, torch.Tensor)}
    assert live and not live & {t.untyped_storage().data_ptr() for t in snap.tensors.values()}

    gate = threading.Event()
    real_write = dist_checkpoint.write_snapshot

    def held_write(snap, out_dir, fsync=False):
        gate.wait(timeout=30)
        return real_write(snap, out_dir, fsync=fsync)

    dist_checkpoint.write_snapshot = held_write
    try:
        out = acc.save_state(carry=carry, block=False)
        want = {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in ckpt.flatten_tree(carry).items()}
        for _ in range(3):
            carry, _ = step(carry, batch)
        gate.set()
        acc.wait_for_checkpoint()
    finally:
        dist_checkpoint.write_snapshot = real_write
    assert not torch.equal(carry["params"]["w"], want["params//w"])
    _, fresh, _, _ = _setup(tmp_path / "other")
    got = ckpt.flatten_tree(acc.load_state(out, carry=fresh))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v, k


def test_async_save_without_a_carry_keeps_the_optimizer_state(tmp_path):
    """The raw loop's save: bare params and each prepared optimizer's state
    in a file of its own, snapshotted at the call although the optimizer
    steps in place while the writer runs."""
    acc = port.Accelerator(cpu=True)
    params = {"w": torch.ones(4, 4)}
    opt = acc.prepare(port.adamw(0.1))
    opt.init(params)
    opt.step(params, {"w": torch.full((4, 4), 0.5)})
    gate = threading.Event()
    real_write = dist_checkpoint.write_snapshot

    def held_write(snap, out_dir, fsync=False):
        gate.wait(timeout=30)
        return real_write(snap, out_dir, fsync=fsync)

    dist_checkpoint.write_snapshot = held_write
    try:
        out = acc.save_state(str(tmp_path / "raw"), params=params, block=False)
        want_mu, want_w = opt.opt_state["mu"]["w"].clone(), params["w"].clone()
        opt.step(params, {"w": torch.full((4, 4), -2.0)})
        gate.set()
        acc.wait_for_checkpoint()
    finally:
        dist_checkpoint.write_snapshot = real_write
    assert os.path.isfile(os.path.join(out, "optimizer_0.safetensors"))
    acc2 = port.Accelerator(cpu=True)
    opt2 = acc2.prepare(port.adamw(0.1))
    fresh = {"w": torch.zeros(4, 4)}
    opt2.init(fresh)
    got = acc2.load_state(out, params=fresh)
    assert torch.equal(got["w"], want_w)
    assert torch.equal(opt2.opt_state["mu"]["w"], want_mu) and opt2.opt_state["count"] == 1


# ---------------------------------------------------------------------- #
# loads that fail, and the two repairs
# ---------------------------------------------------------------------- #
def _rewrite(path, fn):
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f)


def _adam_setup(data):
    _reset()
    acc = port.Accelerator(cpu=True)
    loader = acc.prepare(port.DataLoader(data, batch_size=1))
    opt = acc.prepare(port.adamw(0.1))
    carry = acc.init_carry({"w": torch.zeros(4, 4)}, opt)
    step = acc.unified_step(lambda p, b: ((p["w"] - b["t"]) ** 2).mean())
    return acc, loader, carry, step


@pytest.mark.parametrize("fault", ["tensor_shape", "host_file"])
def test_failed_load_leaves_the_carry_as_it_was(tmp_path, fault):
    """A checkpoint whose last moment reads with the wrong shape (after the
    params and the first moment in the restore's order), or whose loader
    cursor file is torn: load_state raises, and the carry, the loader's
    cursor, the RNG and the step are bit for bit as before."""
    data = [{"t": torch.full((4, 4), float(i))} for i in range(8)]
    acc, loader, carry, step = _adam_setup(data)
    for batch in list(loader)[:2]:
        carry, _ = step(carry, batch)
    out = acc.save_state(str(tmp_path / "ck"), carry=carry)
    if fault == "tensor_shape":
        def reshape(index):
            entry = index["opt_state//nu//w"]
            entry["shape"] = entry["chunks"][0]["shape"] = [2, 8]
        _rewrite(os.path.join(out, "state_index_00000.json"), reshape)
    else:
        with open(os.path.join(out, "sampler_0.json"), "w") as f:
            f.write('{"epoch": ')
    acc, loader, fresh, _ = _adam_setup(data)
    next(iter(loader))
    fresh["params"]["w"].data.fill_(-3.0)
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in ckpt.flatten_tree(fresh).items()}
    state = (acc.step, loader.state_dict())
    keys = acc.keys.state_dict()["generator"].clone()
    with pytest.raises(ValueError):
        acc.load_state(out, carry=fresh)
    after = ckpt.flatten_tree(fresh)
    for k, v in before.items():
        assert torch.equal(after[k], v) if isinstance(v, torch.Tensor) else after[k] == v, k
    assert (acc.step, loader.state_dict()) == state
    assert torch.equal(acc.keys.state_dict()["generator"], keys)


def test_load_state_takes_allow_reshape_false(tmp_path):
    """The reference's load_state takes allow_reshape, and its
    CheckpointManager.restore_or_init always passes it; the port's took no
    such argument (TypeError). None, False and True load a checkpoint of
    the live topology alike (True only matters for another world size)."""
    acc, carry, step, batch = _setup(tmp_path)
    carry, _ = step(carry, batch)
    out = acc.save_state(carry=carry)
    for flag in (None, False, True):
        _, fresh, _, _ = _setup(tmp_path / f"f{flag}")
        got = acc.load_state(out, carry=fresh, allow_reshape=flag)
        assert torch.equal(got["params"]["w"], carry["params"]["w"])


def test_sync_save_emits_a_checkpoint_record(tmp_path):
    """The reference's sync save emits kind="checkpoint" with mode "sync",
    background_s 0.0 and bytes_written (the ckpt variant's sync arm reads
    them); the port's emitted none."""
    acc, carry, step, batch = _setup(tmp_path, telemetry=True)
    carry, _ = step(carry, batch)
    out = acc.save_state(carry=carry)
    (rec,) = _checkpoint_records(acc)
    assert rec["mode"] == "sync" and rec["background_s"] == 0.0 and rec["dir"] == out
    assert rec["step"] == 1 and rec["blocked_s"] > 0
    # w (16 fp32) and the counters opt_step, micro_step, count (int64)
    assert rec["bytes_written"] == 16 * 4 + 3 * 8
    assert rec["write_bandwidth_bytes_per_s"] == rec["bytes_written"] / rec["blocked_s"]


# ---------------------------------------------------------------------- #
# satellites: atomic small-file writes
# ---------------------------------------------------------------------- #
def test_atomic_json_dump_preserves_original_on_failure(tmp_path):
    path = str(tmp_path / "accelerate_state.json")
    ckpt._atomic_json_dump({"step": 7}, path)
    with pytest.raises(TypeError):
        ckpt._atomic_json_dump({"step": object()}, path)  # not JSON-able
    with open(path) as f:
        assert json.load(f) == {"step": 7}
    assert [n for n in os.listdir(tmp_path) if ".tmp" in n] == []


def test_atomic_pickle_dump_preserves_original_on_failure(tmp_path):
    class Unpicklable:
        def __reduce__(self):
            raise ValueError("nope")

    path = str(tmp_path / "custom_checkpoint_0.pkl")
    ckpt._atomic_pickle_dump({"state": 1}, path)
    with pytest.raises(ValueError):
        ckpt._atomic_pickle_dump(Unpicklable(), path)
    with open(path, "rb") as f:
        assert pickle.load(f) == {"state": 1}
    assert [n for n in os.listdir(tmp_path) if ".tmp" in n] == []


# ---------------------------------------------------------------------- #
# kill between snapshot and commit
# ---------------------------------------------------------------------- #
_CHILD = r"""
import os, signal, sys, time
import torch
import accelerate_tpu_torch.dist_checkpoint as dist_checkpoint
import accelerate_tpu_torch as port

# the THIRD save's shard lands in its .tmp work dir, then the writer sleeps
# before the commit: the SIGKILL below arrives in that window
real_write = dist_checkpoint.write_snapshot
CALLS = {"n": 0}
def gated(snap, out_dir, fsync=False):
    CALLS["n"] += 1
    r = real_write(snap, out_dir, fsync=fsync)
    if CALLS["n"] >= 3:
        time.sleep(60)
    return r
dist_checkpoint.write_snapshot = gated

acc = port.Accelerator(cpu=True, project_config=port.ProjectConfiguration(
    project_dir=sys.argv[1], automatic_checkpoint_naming=True))
opt = acc.prepare(port.sgd(0.1))
carry = acc.init_carry({"w": torch.zeros(4, 4)}, opt)
step = acc.unified_step(lambda p, b: ((p["w"] - b["t"]) ** 2).mean())
batch = {"t": torch.ones(4, 4)}
mgr = port.CheckpointManager(acc, every_n_steps=2, handle_signals=False, async_saves=True)
for i in range(6):
    carry, _ = step(carry, batch)
    mgr.step(carry)
work = os.path.join(sys.argv[1], "checkpoints", "checkpoint_2.tmp")
deadline = time.time() + 30
while not os.path.isdir(work) and time.time() < deadline:
    time.sleep(0.01)
time.sleep(0.3)  # let the tiny shard write finish: die in the sleep(60)
print("KILLING", flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_kill_between_snapshot_and_commit_falls_back(tmp_path):
    """The child imports torch and the port only (no JAX)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env={**env, "PYTHONPATH": REPO})
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "KILLING" in proc.stdout
    base = tmp_path / "checkpoints"
    names = sorted(os.listdir(base))
    assert "checkpoint_2.tmp" in names and "checkpoint_2" not in names
    assert not commit_mod.is_committed(str(base / "checkpoint_2.tmp"))
    for committed in ("checkpoint_0", "checkpoint_1"):
        assert commit_mod.is_committed(str(base / committed))

    acc, carry, step, batch = _setup(tmp_path)
    with port.CheckpointManager(acc, handle_signals=False) as mgr:
        carry, resumed = mgr.restore_or_init(carry)
    assert resumed and acc.step == 4
    carry, _ = step(carry, batch)
    out = acc.save_state(carry=carry)  # clears the killed run's tmp and commits
    assert os.path.basename(out) == "checkpoint_2"
    assert commit_mod.is_committed(out)
    assert not (base / "checkpoint_2.tmp").exists()


# ---------------------------------------------------------------------- #
# the reference's checkpoints, both directions
# ---------------------------------------------------------------------- #
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64)
SEQ, BATCH, LR, K = 16, 8, 1e-3, 2
# fp16 gradients in the two packages round apart: the moments and the
# accumulated (loss-scaled) gradients after the two calls read 3.9e-4 of
# their leaf's largest value at most (accum_grads, both directions); about 3x
FP16_GRAD_TOL = 1.2e-3


def _batch(i):
    """Call ``i``'s tokens, the same in both packages."""
    return np.random.default_rng(i).integers(0, MODEL["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def _jax_trainer():
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    acc = jax_pkg.Accelerator(mixed_precision="fp16", gradient_accumulation_steps=K)
    model = JaxCausalLM(JaxConfig(**MODEL))
    params = nn.unbox(model.init_params(jax.random.PRNGKey(0), seq_len=SEQ))
    params, opt = acc.prepare(params, optax.adamw(LR))
    return acc, acc.unified_step(JaxCausalLM.loss_fn(model), opt), acc.init_carry(params, opt)


def _jax_calls(step, carry, calls):
    start = int(np.asarray(carry["opt_step"])) * K + int(np.asarray(carry["micro_step"]))
    losses = []
    for i in range(start, start + calls):
        carry, m = step(carry, {"input_ids": jnp.asarray(_batch(i))})
        losses.append(float(m["loss"]))
    return losses, carry


def _port_trainer():
    acc = port.Accelerator(cpu=True, mixed_precision="fp16", gradient_accumulation_steps=K)
    model = port.CausalLM(port.TransformerConfig(**MODEL), device="cpu",
                          generator=torch.Generator().manual_seed(7))
    model, opt = acc.prepare(model, port.adamw(LR))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt)
    return acc, model, opt, step


def _port_calls(step, carry, calls):
    start = carry["opt_step"] * K + carry["micro_step"]
    losses = []
    for i in range(start, start + calls):
        carry, m = step(carry, {"input_ids": torch.from_numpy(_batch(i))})
        losses.append(float(m["loss"]))
    return losses, carry


def _jax_named(carry):
    return {k: np.asarray(v) for k, v in jax_flatten(carry).items()}


def _hold(port_carry, jax_carry):
    """The port's carry against the reference's under the reference's
    names: params at 2e-5 absolute (the fp32 tolerance); counters and the
    loss scale exactly; the moments and the accumulation buffer, which
    carry fp16 gradients, at FP16_GRAD_TOL of each leaf's largest value."""
    want = _jax_named(jax_carry)
    got = port.carry_to_jax(ckpt.flatten_tree(port_carry), want)
    for k, v in want.items():
        if k.startswith("params"):
            atol = 2e-5
        elif k.startswith("accum_grads") or "//mu//" in k or "//nu//" in k:
            atol = FP16_GRAD_TOL * np.abs(v).max()
        else:
            atol = 0.0
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=0, err_msg=k)


def test_reference_fp16_accumulation_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains 3 calls in fp16 with K 2 (one optimizer step and
    one accumulated microbatch) and saves: the port's carry_from_jax takes
    the params, moments, loss scale, accumulation buffer and counters bit
    for bit, and both packages continue 2 calls to the same state."""
    jacc, jstep, jcarry = _jax_trainer()
    _, jcarry = _jax_calls(jstep, jcarry, 3)
    out = jacc.save_state(str(tmp_path / "ref"), carry=jcarry)
    named = {k: v.numpy() for k, v in dist_checkpoint.load_full_named(out).items()}
    assert named["micro_step"] == 1 and "loss_scale//scale" in named
    _, model, opt, step = _port_trainer()
    carry = port.carry_from_jax(named, model, opt)
    back = port.carry_to_jax(ckpt.flatten_tree(carry), named)
    for k, v in named.items():  # the carry-over is a copy
        assert np.array_equal(back[k], v), k
    plosses, carry = _port_calls(step, carry, 2)
    jlosses, jcarry = _jax_calls(jstep, jcarry, 2)
    np.testing.assert_allclose(plosses, jlosses, rtol=2e-5)
    assert carry["opt_step"] == 2 and carry["micro_step"] == 1
    _hold(carry, jcarry)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    """The port trains 3 calls in fp16 with K 2 from its own init and saves;
    carry_to_jax puts the checkpoint under the reference's names, written
    in the format both packages read and committed; accelerate_tpu's
    load_state restores it into the reference's carry bit for bit, and both
    continue 2 calls to the same state."""
    acc, model, opt, step = _port_trainer()
    _, carry = _port_calls(step, acc.init_carry(model, opt), 3)
    out = acc.save_state(str(tmp_path / "port"), carry=carry)
    jacc, jstep, jcarry = _jax_trainer()
    named = port.carry_to_jax(dist_checkpoint.load_full_named(out), _jax_named(jcarry))
    ref_dir = str(tmp_path / "as_ref")
    work = commit_mod.work_dir_for(ref_dir)
    dist_checkpoint.save_sharded_tree(named, work)
    commit_mod.commit(work, ref_dir)
    jcarry = jacc.load_state(ref_dir, carry=jcarry)
    for k, v in _jax_named(jcarry).items():
        assert np.array_equal(v, named[k]), k
    plosses, carry = _port_calls(step, carry, 2)
    jlosses, jcarry = _jax_calls(jstep, jcarry, 2)
    np.testing.assert_allclose(plosses, jlosses, rtol=2e-5)
    _hold(carry, jcarry)
