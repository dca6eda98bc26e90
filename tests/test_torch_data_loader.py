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
* The 15 tests of ``tests/test_data_loader.py`` on both packages (the
  reference's sharded device batch is the port's process's rows; the
  reference's AOT ``batch_spec`` is held against the port's batch shapes).
* Data sharding: ``BatchSamplerShard`` and ``IterableDatasetShard`` give
  exactly the reference's index lists and ``valid`` counts for every
  process over a grid (lengths 0-33, world 1-4, ``even_batches``,
  ``split_batches``, ``drop_last``), in this process; and a prepared loader
  at world 2 and 3 (``num_processes``/``process_index`` set on a state, no
  group) yields each process its rows of the reference's global batch, with
  the reference's global counts (``remainder``, ``len``, the cursor).

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


# ---------------------------------------------------------------------- #
# the reference's tests/test_data_loader.py, on both packages
# ---------------------------------------------------------------------- #
from accelerate_tpu import data_loader as jdl  # noqa: E402
from accelerate_tpu_torch import data_loader as pdl  # noqa: E402


class RangeDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, dtype=np.float32), "y": np.int32(i)}


def _both(name, *args, **kwargs):
    return getattr(jdl, name)(*args, **kwargs), getattr(pdl, name)(*args, **kwargs)


def test_seedable_sampler_deterministic():
    for mod in (jdl, pdl):
        s1 = mod.SeedableRandomSampler(10, seed=3, epoch=0)
        s2 = mod.SeedableRandomSampler(10, seed=3, epoch=0)
        assert list(s1) == list(s2)
        s2.set_epoch(1)
        assert list(s1) != list(s2)
        assert sorted(list(s2)) == list(range(10))
    assert list(pdl.SeedableRandomSampler(10, 3, 1)) == list(jdl.SeedableRandomSampler(10, 3, 1))


@pytest.mark.parametrize("num_processes", [1, 2, 4])
def test_batch_sampler_shard_even(num_processes):
    for mod in (jdl, pdl):
        sampler = mod.SequentialSampler(16)
        shards = [mod.BatchSamplerShard(sampler, 2, num_processes=num_processes, process_index=i)
                  for i in range(num_processes)]
        batches = [list(s) for s in shards]
        for b in batches:
            assert len(b) == len(shards[0])
        seen = [i for step in zip(*batches) for local, _ in step for i in local]
        assert sorted(seen) == list(range(16))


def test_batch_sampler_shard_uneven_wraparound():
    for mod in (jdl, pdl):
        shards = [mod.BatchSamplerShard(mod.SequentialSampler(10), 2, num_processes=4,
                                        process_index=i) for i in range(4)]
        lasts = [list(s)[-1] for s in shards]
        assert len([i for local, _ in lasts for i in local]) == 8
        assert lasts[0][1] == 2  # only 2 real samples in the tail batch


def test_batch_sampler_drop_last():
    for mod in (jdl, pdl):
        shard = mod.BatchSamplerShard(mod.SequentialSampler(10), 2, num_processes=4,
                                      drop_last=True)
        assert len(list(shard)) == len(shard) == 1


def test_iterable_dataset_shard():
    for mod in (jdl, pdl):
        shards = [mod.IterableDatasetShard(range(10), batch_size=2, num_processes=2,
                                           process_index=i) for i in range(2)]
        out = [list(s) for s in shards]
        assert len(out[0]) == 3
        assert out[0][0][0] + out[1][0][0] == [0, 1, 2, 3]


def test_prepare_data_loader_shards_batches():
    """The reference's global batch of 8 sharded over 8 devices; the port's
    one process holds its 8 rows on its device."""
    jb = list(jdl.prepare_data_loader(jax_pkg.DataLoader(RangeDataset(16), batch_size=8),
                                      jax_pkg.AcceleratorState()))
    pb = list(pdl.prepare_data_loader(port.DataLoader(RangeDataset(16), batch_size=8),
                                      port.AcceleratorState(cpu=True)))
    assert len(jb) == len(pb) == 2
    assert jb[0]["x"].sharding.spec[0] in ("dp", ("dp",))
    assert pb[0]["x"].shape == (8, 2) and pb[0]["x"].device == torch.device("cpu")
    for g, w in zip(pb, jb):
        _assert_trees_equal(g, w)


def test_dataloader_gradient_state_bookkeeping():
    rows = {}
    for name, pkg, state in (("jax", jax_pkg, jax_pkg.AcceleratorState()),
                             ("port", port, port.AcceleratorState(cpu=True))):
        gs = pkg.GradientState()
        prepared = (jdl if name == "jax" else pdl).prepare_data_loader(
            pkg.DataLoader(RangeDataset(10), batch_size=8), state)
        rows[name] = [(gs.in_dataloader, gs.end_of_dataloader, gs.remainder) for _ in prepared]
        assert not gs.in_dataloader
    assert rows["port"] == rows["jax"] == [(True, False, -1), (True, True, 2)]


def test_dataloader_length_and_epoch():
    epochs = {}
    for name, pkg, mod, state in (("jax", jax_pkg, jdl, jax_pkg.AcceleratorState()),
                                  ("port", port, pdl, port.AcceleratorState(cpu=True))):
        prepared = mod.prepare_data_loader(
            pkg.DataLoader(RangeDataset(16), batch_size=8, shuffle=True, seed=0), state)
        assert len(prepared) == 2
        first = [np.asarray(b["y"]).tolist() for b in prepared]
        prepared.set_epoch(1)
        second = [np.asarray(b["y"]).tolist() for b in prepared]
        assert first != second
        prepared.set_epoch(0)
        assert [np.asarray(b["y"]).tolist() for b in prepared] == first
        epochs[name] = (first, second)
    assert epochs["port"] == epochs["jax"]


def test_skip_first_batches():
    for pkg, mod, state in ((jax_pkg, jdl, jax_pkg.AcceleratorState()),
                            (port, pdl, port.AcceleratorState(cpu=True))):
        prepared = mod.prepare_data_loader(pkg.DataLoader(RangeDataset(16), batch_size=8), state)
        batches = [np.asarray(b["y"]).tolist() for b in mod.skip_first_batches(prepared, 1)]
        assert batches == [list(range(8, 16))]
        assert len(list(prepared)) == 2  # one-shot


def test_prepare_iterable_of_batches():
    raw = [{"x": np.ones((8, 2), dtype=np.float32) * i} for i in range(3)]
    jb = list(jdl.prepare_data_loader(raw, jax_pkg.AcceleratorState()))
    pb = list(pdl.prepare_data_loader(raw, port.AcceleratorState(cpu=True)))
    assert len(jb) == len(pb) == 3
    assert isinstance(pb[0]["x"], torch.Tensor)
    for g, w in zip(pb, jb):
        _assert_trees_equal(g, w)


def test_prepare_torch_dataloader():
    from torch.utils.data import DataLoader as TorchDataLoader, TensorDataset

    tl = TorchDataLoader(TensorDataset(torch.arange(16).float().reshape(16, 1)), batch_size=8)
    jb = list(jdl.prepare_data_loader(tl, jax_pkg.AcceleratorState()))
    pb = list(pdl.prepare_data_loader(tl, port.AcceleratorState(cpu=True)))
    assert len(jb) == len(pb) == 2
    assert pb[0][0].shape == (8, 1)
    for g, w in zip(pb, jb):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))


def test_prepare_rejects_indivisible_batch():
    """The reference refuses a global batch its 8 data-parallel devices
    cannot split; the port's process drives one device, so its batch of 4
    is taken whole."""
    with pytest.raises(ValueError, match="divisible by the data-parallel"):
        jdl.prepare_data_loader(jax_pkg.DataLoader(RangeDataset(16), batch_size=4),
                                jax_pkg.AcceleratorState())
    pb = list(pdl.prepare_data_loader(port.DataLoader(RangeDataset(16), batch_size=4),
                                      port.AcceleratorState(cpu=True)))
    assert [b["y"].tolist() for b in pb] == [list(range(i, i + 4)) for i in range(0, 16, 4)]


def test_superbatch_loader_stacks_microbatches():
    jp = jdl.prepare_data_loader(jax_pkg.DataLoader(RangeDataset(32), batch_size=8),
                                 jax_pkg.AcceleratorState(), superbatch=2)
    pp = pdl.prepare_data_loader(port.DataLoader(RangeDataset(32), batch_size=8),
                                 port.AcceleratorState(cpu=True), superbatch=2)
    assert jp.superbatch == pp.superbatch == 2 and len(jp) == len(pp) == 2
    jb, pb = list(jp), list(pp)
    assert pb[0]["x"].shape == (2, 8, 2) and pb[0]["y"].shape == (2, 8)
    np.testing.assert_array_equal(pb[0]["y"].numpy(), np.arange(16).reshape(2, 8))
    for g, w in zip(pb, jb):
        _assert_trees_equal(g, w)
    assert jp.remainder == pp.remainder == 0


def test_superbatch_batch_spec_matches_batches():
    """The reference's AOT spec of a stacked batch is the shape and dtype
    of every batch the port's loader yields."""
    jp = jdl.prepare_data_loader(jax_pkg.DataLoader(RangeDataset(32), batch_size=8),
                                 jax_pkg.AcceleratorState(), superbatch=2)
    pp = pdl.prepare_data_loader(port.DataLoader(RangeDataset(32), batch_size=8),
                                 port.AcceleratorState(cpu=True), superbatch=2)
    spec = jp.batch_spec()
    for batch in pp:
        for k, v in batch.items():
            assert tuple(v.shape) == spec[k].shape
            assert str(v.dtype).split(".")[-1] == str(spec[k].dtype), k


def test_superbatch_partial_final_batch_padded():
    seen = {}
    for name, pkg, mod, state in (("jax", jax_pkg, jdl, jax_pkg.AcceleratorState()),
                                  ("port", port, pdl, port.AcceleratorState(cpu=True))):
        gs = pkg.GradientState()
        prepared = mod.prepare_data_loader(pkg.DataLoader(RangeDataset(24), batch_size=8), state,
                                           superbatch=2)
        assert len(prepared) == 2
        seen[name] = [(np.asarray(b["y"]).tolist(), gs.end_of_dataloader, gs.remainder)
                      for b in prepared]
    assert seen["port"] == seen["jax"]
    last = seen["port"][-1]
    assert last[0] == [list(range(16, 24))] * 2 and last[1] is True and last[2] == 8


# ---------------------------------------------------------------------- #
# data sharding: the shards' index lists, exactly the reference's
# ---------------------------------------------------------------------- #
def _shard_lists(mod, n, world, bs, **kw):
    """Every process's (indices, valid) list, or the exception's type."""
    out = []
    for rank in range(world):
        try:
            shard = mod.BatchSamplerShard(mod.SequentialSampler(n), bs, num_processes=world,
                                          process_index=rank, **kw)
            out.append((list(shard), len(shard)))
        except ValueError as e:
            out.append(type(e))
    return out


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("even_batches", [True, False])
@pytest.mark.parametrize("split_batches", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_shard_grid_equals_the_reference(world, even_batches, split_batches,
                                                       drop_last):
    kw = dict(even_batches=even_batches, split_batches=split_batches, drop_last=drop_last)
    for n in range(34):
        for bs in (1, 2, 3, 4):
            assert _shard_lists(pdl, n, world, bs, **kw) == _shard_lists(jdl, n, world, bs, **kw), \
                (n, bs)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("even_batches", [True, False])
@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_shard_grid_equals_the_reference(world, even_batches, drop_last):
    for n in range(34):
        for bs in (1, 2, 3):
            for rank in range(world):
                kw = dict(batch_size=bs, num_processes=world, process_index=rank,
                          drop_last=drop_last, even_batches=even_batches)
                assert list(pdl.IterableDatasetShard(range(n), **kw)) == list(
                    jdl.IterableDatasetShard(range(n), **kw)), (n, bs, rank)


class _Ranked:
    """A state of ``world`` processes seen from ``rank``, without a group:
    what ``prepare_data_loader`` reads of a state."""

    def __init__(self, world, rank, config=None):
        self.num_processes, self.process_index = world, rank
        self.device = torch.device("cpu")
        self.dataloader_config = config or port.DataLoaderConfiguration()


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("even_batches", [True, False])
def test_each_process_holds_its_rows_of_the_global_batch(world, even_batches):
    """Rows 0-20 by 2 a process: process ``p`` yields rows ``[p*2, p*2+2)``
    of each global batch of the reference's sampler; ``remainder``, ``len``
    and the cursor count global samples."""
    n, bs = 21, 2
    cfg = port.DataLoaderConfiguration(even_batches=even_batches)
    gbs = bs * world
    ref = jdl.BatchSamplerShard(jdl.SequentialSampler(n), gbs, even_batches=even_batches)
    global_rows = [idx for idx, _ in ref]
    tail = list(ref)[-1][1]
    for rank in range(world):
        loader = pdl.prepare_data_loader(port.DataLoader(RangeDataset(n), batch_size=bs),
                                         _Ranked(world, rank, cfg))
        got = [b["y"].tolist() for b in loader]
        assert got == [rows[rank * bs:(rank + 1) * bs] for rows in global_rows]
        assert len(loader) == len(global_rows)
        assert loader.remainder == (tail if tail != gbs else 0)
        assert loader.global_batch_size == gbs and loader.state_dict()["global_batch_size"] == gbs


@pytest.mark.parametrize("field,value", [("drop_last", True), ("even_batches", False),
                                         ("use_seedable_sampler", False),
                                         ("dispatch_batches", True)])
def test_loader_configuration_fields_act_as_the_reference(field, value):
    """Each ``DataLoaderConfiguration`` field the reference's loader reads,
    through both packages' ``Accelerator(dataloader_config=)``: the same
    batches, ``remainder`` and ``len`` (ROADMAP queue C: the port's
    configuration had ``split_batches`` only, and a script setting any other
    field failed with a TypeError)."""
    out = {}
    for name, pkg in (("jax", jax_pkg), ("port", port)):
        _reset_both()
        kw = {"cpu": True} if name == "port" else {}
        acc = pkg.Accelerator(dataloader_config=pkg.DataLoaderConfiguration(**{field: value}),
                              **kw)
        loader = acc.prepare_data_loader(pkg.DataLoader(RangeDataset(20), batch_size=8,
                                                        shuffle=field == "use_seedable_sampler"))
        np.random.seed(0)  # the non-seedable sampler draws from numpy's global generator
        out[name] = ([np.asarray(b["y"]).tolist() for b in loader], loader.remainder, len(loader))
    assert out["port"] == out["jax"]


def _reset_both():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
