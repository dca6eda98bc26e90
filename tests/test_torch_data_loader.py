"""The port's data loading against the JAX reference's, on the CPU.

* ``DataLoader`` iterated unprepared yields the reference's host batches,
  in order and shuffled from ``seed + epoch`` over two epochs (ROADMAP
  queue C: the port's could not be iterated and took no ``seed``).
* ``prepare_data_loader`` takes an iterable of batches, as the reference
  does (queue C: the port's refused one), and yields the same batches.
* The superbatch mode of fused accumulation: the stacked ``[K, micro,
  ...]`` batches, the padded last stack, ``remainder``, ``len`` and the
  cursor's batch size; and ``GradientState.end_of_dataloader`` over an
  epoch.

Every comparison is exact: the loaders move integers and fp32 rows.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.data_loader import prepare_data_loader as jax_prepare  # noqa: E402
from accelerate_tpu_torch.data_loader import prepare_data_loader as port_prepare  # noqa: E402

BATCH = 8  # divisible by the 8 virtual CPU devices of tests/conftest.py


@pytest.fixture(autouse=True)
def reset_singletons():
    def reset():
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
        jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
        jax_pkg.state.GradientState._reset_state()

    reset()
    yield
    reset()


class Rows:
    """Map-style rows: an id and an fp32 feature vector."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(n, 3)).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"id": np.int64(i), "x": self.x[i]}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_trees_equal(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
        np.testing.assert_array_equal(got, want)


def test_unprepared_dataloader_yields_the_reference_batches():
    got = list(port.DataLoader(range(5), batch_size=2))
    want = list(jax_pkg.DataLoader(range(5), batch_size=2))
    assert [b.tolist() for b in got] == [b.tolist() for b in want] == [[0, 1], [2, 3], [4]]


@pytest.mark.parametrize("drop_last", [False, True])
def test_unprepared_shuffle_follows_seed_and_epoch(drop_last):
    rows = Rows(21)
    pl = port.DataLoader(rows, batch_size=4, shuffle=True, drop_last=drop_last, seed=3)
    jl = jax_pkg.DataLoader(rows, batch_size=4, shuffle=True, drop_last=drop_last, seed=3)
    assert len(pl) == len(jl) == (5 if drop_last else 6)
    epochs = []
    for epoch in range(2):
        pl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(pl)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
        epochs.append(np.concatenate([b["id"] for b in got]))
    assert not np.array_equal(epochs[0], epochs[1])  # each epoch draws its own order
    assert not np.array_equal(epochs[0], np.arange(len(epochs[0])))  # shuffled


def test_prepare_takes_an_iterable_of_batches():
    """Three pre-batched dicts, the last one short: the same batches on the
    device in both packages, and the short one's size as ``remainder``."""
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(n, 3)).astype(np.float32),
                "y": np.arange(n, dtype=np.int32)} for n in (BATCH, BATCH, 5)]
    ploader = port.Accelerator(cpu=True).prepare_data_loader(batches)
    jloader = jax_pkg.Accelerator().prepare_data_loader(batches)
    assert len(ploader) == len(jloader) == 3
    got, want = [], []
    for b in ploader:
        got.append(b)
        assert b["x"].device == torch.device("cpu")
    assert ploader.end_of_dataloader and ploader.remainder == 5
    for b in jloader:
        want.append(b)
    assert jloader.remainder == ploader.remainder
    assert len(got) == len(want) == 3
    for g, w, host in zip(got, want, batches):
        _assert_trees_equal(g, w)
        _assert_trees_equal(g, host)


@pytest.mark.parametrize("n,k", [(88, 4), (84, 4), (64, 4), (40, 3)])
def test_superbatch_stacks_like_the_reference(n, k):
    """``superbatch=k`` over ``n`` rows in microbatches of 8: the stacked
    batches, the last stack padded with its last microbatch, ``remainder``
    (the true rows of a short last stack, a wrapped tail included), ``len``
    and the cursor's batch size equal the reference's."""
    rows = Rows(n)
    jstate = jax_pkg.state.AcceleratorState()
    pstate = port.AcceleratorState(cpu=True)
    jl = jax_prepare(jax_pkg.DataLoader(rows, batch_size=BATCH), jstate, superbatch=k)
    pl = port_prepare(port.DataLoader(rows, batch_size=BATCH), pstate, superbatch=k)
    micro = math.ceil(n / BATCH)
    assert len(pl) == len(jl) == math.ceil(micro / k)
    want = [(b, jl.remainder) for b in jl]
    got = [(b, pl.remainder) for b in pl]
    assert len(got) == len(want) == len(pl)
    for (g, g_rem), (w, w_rem) in zip(got, want):
        assert tuple(g["x"].shape) == tuple(np.asarray(w["x"]).shape) == (k, BATCH, 3)
        _assert_trees_equal(g, w)
        assert g_rem == w_rem
    assert pl.remainder == jl.remainder
    full = BATCH * k
    if micro % k:  # padded: the last slot repeats the one before it
        last = _np(got[-1][0])
        np.testing.assert_array_equal(last["id"][-1], last["id"][micro % k - 1])
    assert pl.remainder == (0 if n % full == 0 else n % full)
    assert pl.state_dict()["global_batch_size"] == jl.state_dict()["global_batch_size"] == full


def test_accelerator_stacks_for_fused_accumulation():
    """``prepare`` under ``GradientAccumulationPlugin(fused=True)`` makes the
    loader stack ``num_steps`` microbatches, in both packages; unfused it
    does not."""
    from accelerate_tpu.utils.dataclasses import GradientAccumulationPlugin as JaxPlugin
    from accelerate_tpu_torch.utils.dataclasses import GradientAccumulationPlugin

    rows = Rows(64)
    for fused in (True, False):
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
        jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
        jax_pkg.state.GradientState._reset_state()
        pacc = port.Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
            num_steps=4, fused=fused))
        jacc = jax_pkg.Accelerator(gradient_accumulation_plugin=JaxPlugin(num_steps=4,
                                                                          fused=fused))
        pl = pacc.prepare(port.DataLoader(rows, batch_size=BATCH))
        jl = jacc.prepare(jax_pkg.DataLoader(rows, batch_size=BATCH))
        assert pl.superbatch == jl.superbatch == (4 if fused else 1)
        assert len(pl) == len(jl) == (2 if fused else 8)


def test_end_of_dataloader_marks_the_last_batch():
    """While the loop body runs on a batch, ``GradientState.end_of_dataloader``
    is True on the last batch only, in both packages; after the loop no
    loader is active."""
    rows = Rows(40)
    pl = port.Accelerator(cpu=True).prepare(port.DataLoader(rows, batch_size=BATCH))
    jl = jax_pkg.Accelerator().prepare(jax_pkg.DataLoader(rows, batch_size=BATCH))
    pgs, jgs = port.GradientState(), jax_pkg.state.GradientState()
    got = [pgs.end_of_dataloader for _ in pl]
    want = [jgs.end_of_dataloader for _ in jl]
    assert got == want == [False] * 4 + [True]
    assert not pgs.in_dataloader and not pgs.end_of_dataloader
