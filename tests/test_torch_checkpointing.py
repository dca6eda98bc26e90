"""The port's checkpoints: the reference's one-process checkpoint tests
mirrored, the safetensors codec against the ``safetensors`` package, resume
bit for bit in the port, and resume in the port from a checkpoint the JAX
reference wrote.

Mirrors: ``tests/test_checkpointing.py`` (flatten, sizes, sharded weights,
carry round trip, counters, naming and rotation, custom objects, RNG) and
the one-process cases of ``tests/test_dist_checkpoint.py`` (the sharded
format, an incomplete checkpoint, non-strict loads, non-tensor leaves,
coverage), plus the commit protocol of ``checkpoint_async/commit.py``.

Tolerances: a round trip and a resume in the port are bit for bit (the
same arithmetic on the same bits); the resume from the reference's
checkpoint is held at 2e-5, the fp32 parity of the two packages' steps
(``tests/test_torch_accelerator.py``).
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import optax  # noqa: E402
import safetensors.numpy as st_numpy  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import SequenceClassifier as JaxClassifier  # noqa: E402
from accelerate_tpu_torch import checkpointing as ckpt  # noqa: E402
from accelerate_tpu_torch import dist_checkpoint as dc  # noqa: E402
from accelerate_tpu_torch.checkpoint_async import commit  # noqa: E402
from accelerate_tpu_torch.utils import safetensors_io  # noqa: E402

MODEL = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
             num_heads=2, num_kv_heads=2, max_seq_len=32, causal=False)
SEQ, BATCH = 16, 8  # BATCH divisible by the 8 virtual CPU devices of tests/conftest.py


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_port_singletons():
    _reset()
    yield
    _reset()


class PairDataset:
    """Right-padded rows: ids, attention_mask, label."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        lens = rng.integers(3, SEQ + 1, size=n)
        self.mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.int32)
        self.ids = rng.integers(1, MODEL["vocab_size"], size=(n, SEQ)).astype(np.int32) * self.mask
        self.labels = rng.integers(0, 2, size=n).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "attention_mask": self.mask[i],
                "labels": self.labels[i]}


def _collate(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _toy_params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"dense": {"kernel": torch.randn(8, 16, generator=g), "bias": torch.zeros(16)},
            "out": {"kernel": torch.randn(16, 4, generator=g)}}


def _trainer(seed=0, schedule=(0.0, 1e-3, 2, 12), **acc_kw):
    """A prepared tiny classifier, adamw with the examples' schedule, clip
    1.0, and a shuffled torch loader of 6 batches."""
    from torch.utils.data import DataLoader as TorchLoader

    acc = port.Accelerator(cpu=True, **acc_kw)
    model = port.SequenceClassifier(port.TransformerConfig(**MODEL), device="cpu",
                                    generator=torch.Generator().manual_seed(seed))
    loader = TorchLoader(PairDataset(6 * BATCH), batch_size=BATCH, shuffle=True,
                         collate_fn=_collate)
    model, opt, loader = acc.prepare(
        model, port.adamw(port.warmup_cosine_decay_schedule(*schedule), weight_decay=0.01),
        loader)
    step = acc.unified_step(port.SequenceClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    return acc, model, opt, loader, step, acc.init_carry(model, opt)


def _train(step, carry, loader, n):
    losses = []
    for i, batch in enumerate(loader):
        if i == n:
            break
        carry, m = step(carry, batch)
        losses.append(m["loss"])
    return carry, losses


# ---------------------------------------------------------------------- #
# mirrors of tests/test_checkpointing.py
# ---------------------------------------------------------------------- #
def test_flatten_unflatten_roundtrip():
    params = _toy_params()
    named = ckpt.flatten_tree(params)
    assert "dense//kernel" in named
    template = {k: {n: torch.zeros_like(t) for n, t in v.items()} for k, v in params.items()}
    restored = ckpt.unflatten_into(template, named)
    for key, t in ckpt.flatten_tree(restored).items():
        assert torch.equal(t, named[key])
    assert restored["dense"]["kernel"] is template["dense"]["kernel"]  # filled in place


def test_parse_size():
    assert ckpt.parse_size("10GB") == 10 * 2**30
    assert ckpt.parse_size("512MB") == 512 * 2**20
    assert ckpt.parse_size(123) == 123


def test_shard_checkpoint_splits():
    named = {f"w{i}": torch.zeros(128, 128) for i in range(4)}  # 64 KiB each
    shards, index = ckpt.shard_checkpoint(named, max_shard_size=100 * 1024)
    assert len(shards) == 4
    assert set(index["weight_map"]) == set(named)


def test_save_load_model_weights(tmp_path):
    params = _toy_params()
    port.Accelerator(cpu=True).save_model(params, str(tmp_path), max_shard_size="600B")
    assert os.path.isfile(tmp_path / "model.safetensors.index.json")
    named = ckpt.load_model_weights(str(tmp_path))
    orig = ckpt.flatten_tree(params)
    assert set(named) == set(orig)
    for k in named:
        assert torch.equal(named[k], orig[k])


def test_save_load_state_carry_roundtrip(tmp_path):
    acc, model, opt, loader, step, carry = _trainer()
    carry, _ = _train(step, carry, loader, 2)
    saved = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in ckpt.flatten_tree(carry).items()}
    acc.save_state(str(tmp_path / "ck"), carry=carry)
    zero = ckpt._rebuild(carry, lambda _, x: torch.zeros_like(x)
                         if isinstance(x, torch.Tensor) else 0)
    restored = acc.load_state(str(tmp_path / "ck"), carry=zero)
    got = ckpt.flatten_tree(restored)
    assert set(got) == set(saved)
    for k, v in saved.items():
        assert torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v, k


def test_step_mirror_and_resume_counters(tmp_path):
    """The accelerator's ``step`` counts train-step calls, micro steps
    included; save_state records it and a fresh accelerator resumes the
    counters from the carry."""
    acc, model, opt, loader, step, carry = _trainer(gradient_accumulation_steps=2)
    assert acc.step == 0
    batches = iter(loader)
    carry, _ = step(carry, next(batches))
    assert acc.step == 1 and not acc.sync_gradients
    carry, _ = step(carry, next(batches))
    assert acc.step == 2 and acc.sync_gradients
    carry, _ = step(carry, next(batches))
    out = acc.save_state(str(tmp_path / "ck"), carry=carry)
    with open(os.path.join(out, "accelerate_state.json")) as f:
        assert json.load(f)["step"] == 3
    del batches
    _reset()
    acc2, _, _, _, _, carry2 = _trainer(seed=1, gradient_accumulation_steps=2)
    restored = acc2.load_state(out, carry=carry2)
    assert acc2.step == 3 and not acc2.sync_gradients
    assert restored["opt_step"] == 1 and restored["micro_step"] == 1
    assert torch.equal(restored["accum_grads"]["pooler.weight"],
                       carry["accum_grads"]["pooler.weight"])


def test_checkpoint_dir_exists_raises(tmp_path):
    pc = port.ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True)
    acc = port.Accelerator(cpu=True, project_config=pc)
    acc.save_state(params=_toy_params())
    pc.iteration = 0  # force a collision with checkpoint_0
    with pytest.raises(ValueError, match="already exists"):
        acc.save_state(params=_toy_params())


def test_automatic_naming_and_rotation(tmp_path):
    pc = port.ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True,
                                   total_limit=2)
    acc = port.Accelerator(cpu=True, project_config=pc)
    for _ in range(3):
        acc.save_state(params=_toy_params())
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_1", "checkpoint_2"]
    template = _toy_params(seed=5)
    acc.load_state(params=template)  # the latest committed one
    assert torch.equal(template["out"]["kernel"], _toy_params()["out"]["kernel"])


def test_custom_object_checkpointing(tmp_path):
    class Counter:
        def __init__(self):
            self.n = 0

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, state):
            self.n = state["n"]

    acc = port.Accelerator(cpu=True)
    c = Counter()
    c.n = 41
    acc.register_for_checkpointing(c)
    params = _toy_params()
    acc.save_state(str(tmp_path / "ck"), params=params)
    c.n = 0
    acc.load_state(str(tmp_path / "ck"), params=params)
    assert c.n == 41


def test_optimizer_and_scheduler_state_dicts_round_trip():
    """The prepared optimizer's and scheduler's state_dict/load_state_dict:
    a fresh pair takes the count, the moments (copied into its own
    tensors) and the scheduler's step."""
    acc, model, opt, loader, step, carry = _trainer()
    carry, _ = _train(step, carry, loader, 2)
    sched = acc.prepare(lambda count: 1e-3)
    sched.step()
    _reset()
    acc2, _, opt2, _, _, _ = _trainer(seed=1)
    sched2 = acc2.prepare(lambda count: 1e-3)
    mu = opt2.opt_state["mu"]["pooler.weight"]
    opt2.load_state_dict(opt.state_dict())
    sched2.load_state_dict(sched.state_dict())
    assert opt2.opt_state["count"] == 2 and sched2.step_count == 1
    assert opt2.opt_state["mu"]["pooler.weight"] is mu
    for key in ("mu", "nu"):
        for name, t in opt.opt_state[key].items():
            assert torch.equal(opt2.opt_state[key][name], t), (key, name)


def test_register_for_checkpointing_rejects_stateless():
    with pytest.raises(ValueError):
        port.Accelerator(cpu=True).register_for_checkpointing(object())


def test_rng_restore(tmp_path):
    """The accelerator's generator, torch's, numpy's and Python's streams
    resume where the save left them."""
    import random

    acc = port.Accelerator(cpu=True, seed=7)
    acc.set_seed(7)
    torch.rand(3, generator=acc.keys.generator)
    acc.save_state(str(tmp_path / "ck"), params=_toy_params())
    draws = (torch.rand(3, generator=acc.keys.generator), torch.rand(3),
             np.random.rand(3), random.random())
    acc.load_state(str(tmp_path / "ck"), params=_toy_params())
    again = (torch.rand(3, generator=acc.keys.generator), torch.rand(3),
             np.random.rand(3), random.random())
    assert torch.equal(draws[0], again[0]) and torch.equal(draws[1], again[1])
    assert np.array_equal(draws[2], again[2]) and draws[3] == again[3]


# ---------------------------------------------------------------------- #
# mirrors of tests/test_dist_checkpoint.py (one process)
# ---------------------------------------------------------------------- #
def test_save_state_uses_sharded_format(tmp_path):
    acc, model, opt, loader, step, carry = _trainer()
    carry, _ = _train(step, carry, loader, 1)
    out = acc.save_state(str(tmp_path / "ck"), carry=carry)
    assert dc.is_sharded_checkpoint(out)
    assert not os.path.exists(os.path.join(out, "model.safetensors"))
    assert sorted(os.listdir(out)) == [
        "COMMITTED", "accelerate_state.json", "done_00000", "random_states_0.pkl",
        "sampler_0.json", "state_index_00000.json", "state_shard_00000.safetensors",
        "topology.json"]
    with open(os.path.join(out, "state_index_00000.json")) as f:
        entry = json.load(f)["params//pooler.weight"]
    assert entry == {"shape": [32, 32], "dtype": "float32", "chunks": [
        {"file": "state_shard_00000.safetensors", "stored": "params//pooler.weight@0",
         "offset": [0, 0], "shape": [32, 32]}]}
    assert dc.validate_coverage(out)["files"] == 1


def _saved_tree(tmp_path, tree=None):
    out = str(tmp_path / "ck")
    dc.save_sharded_tree(tree or {"kernel": torch.arange(256.0).reshape(16, 16),
                                  "bias": torch.arange(16.0)}, out)
    return out


def _edit_index(out, fn):
    path = os.path.join(out, "state_index_00000.json")
    with open(path) as f:
        manifest = json.load(f)
    fn(manifest)
    with open(path, "w") as f:
        json.dump(manifest, f)


def test_incomplete_checkpoint_fails_loudly(tmp_path):
    out = _saved_tree(tmp_path)

    def halve(m):  # a chunk that claims only the first half of the kernel
        m["kernel"]["chunks"][0]["shape"] = [8, 16]
        m["kernel"]["chunks"][0]["stored"] = "bias@0"
    _edit_index(out, halve)
    with pytest.raises((ValueError, RuntimeError)):
        dc.load_full_named(out)


def test_nonstrict_load_keeps_template_extras(tmp_path):
    out = _saved_tree(tmp_path, {"kernel": torch.ones(16, 16)})
    template = {"kernel": torch.zeros(16, 16), "loss_scale": torch.tensor(2.0**15)}
    with pytest.raises(KeyError):
        dc.load_sharded_tree(template, out, strict=True)
    restored = dc.load_sharded_tree(template, out, strict=False)
    assert bool((restored["kernel"] == 1.0).all()) and float(restored["loss_scale"]) == 2.0**15


def test_save_skips_non_tensor_leaves(tmp_path):
    out = _saved_tree(tmp_path, {"kernel": torch.ones(4, 4), "note": "hello", "none": None})
    assert set(dc.load_full_named(out)) == {"kernel"}


@pytest.mark.parametrize("fault", ["missing_chunk", "overlapping_chunks", "missing_shard_file"])
def test_validate_coverage_rejects(tmp_path, fault):
    out = _saved_tree(tmp_path)
    if fault == "missing_chunk":
        _edit_index(out, lambda m: m["kernel"]["chunks"][0].update(shape=[8, 16]))
        with pytest.raises(ValueError, match="kernel.*not covered"):
            dc.validate_coverage(out)
    elif fault == "overlapping_chunks":
        _edit_index(out, lambda m: m["kernel"]["chunks"].append(dict(m["kernel"]["chunks"][0])))
        with pytest.raises(ValueError, match="overlapping"):
            dc.validate_coverage(out)
    else:
        shard = os.path.join(out, "state_shard_00000.safetensors")
        os.rename(shard, shard + ".lost")
        with pytest.raises(FileNotFoundError, match="state_shard_00000"):
            dc.validate_coverage(out)


# ---------------------------------------------------------------------- #
# the commit protocol
# ---------------------------------------------------------------------- #
def test_stale_work_dir_is_ignored_and_discarded(tmp_path):
    pc = port.ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True)
    acc = port.Accelerator(cpu=True, project_config=pc)
    acc.save_state(params=_toy_params())
    base = tmp_path / "checkpoints"
    stale = base / "checkpoint_1.tmp"  # a crashed save of the next checkpoint
    stale.mkdir()
    (stale / "state_index_00000.json").write_text("{truncated")
    assert ckpt._list_checkpoints(str(base)) == [str(base / "checkpoint_0")]
    acc.load_state(params=_toy_params(seed=3))  # loads checkpoint_0, not the .tmp
    acc.save_state(params=_toy_params())
    assert sorted(os.listdir(base)) == ["checkpoint_0", "checkpoint_1"]
    assert commit.is_committed(str(base / "checkpoint_1"))


def test_only_a_committed_dir_loads(tmp_path):
    acc = port.Accelerator(cpu=True)
    out = acc.save_state(str(tmp_path / "ck"), params=_toy_params())
    os.remove(os.path.join(out, commit.COMMITTED_MARKER))
    with pytest.raises(FileNotFoundError, match="not a committed checkpoint"):
        acc.load_state(out, params=_toy_params())
    base = tmp_path / "proj" / "checkpoints"
    (base / "checkpoint_0").mkdir(parents=True)  # complete-looking, never committed
    assert ckpt._list_checkpoints(str(base)) == []


def test_save_state_block_false_is_not_ported():
    with pytest.raises(NotImplementedError, match="A6"):
        port.Accelerator(cpu=True).save_state("x", params=_toy_params(), block=False)


# ---------------------------------------------------------------------- #
# the safetensors codec against the safetensors package
# ---------------------------------------------------------------------- #
CODEC_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                "I32": torch.int32, "I64": torch.int64}


def _codec_tensors(dtype):
    g = torch.Generator().manual_seed(0)
    make = (lambda *s: torch.randint(-1000, 1000, s, generator=g).to(dtype)) \
        if not dtype.is_floating_point else (lambda *s: torch.randn(s, generator=g).to(dtype))
    return {"matrix": make(5, 7), "vector": make(3), "scalar": make(), "empty": make(0, 4)}


def _as_numpy(t):
    """A torch tensor as the numpy array safetensors.numpy stores (bf16 as
    ml_dtypes.bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a):
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("code", sorted(CODEC_DTYPES))
def test_codec_writes_what_safetensors_reads(tmp_path, code):
    tensors = _codec_tensors(CODEC_DTYPES[code])
    path = str(tmp_path / "x.safetensors")
    safetensors_io.save_file(tensors, path, metadata={"format": "pt"})
    back = st_numpy.load_file(path)
    assert set(back) == set(tensors)
    for name, t in tensors.items():
        want = _as_numpy(t)
        assert back[name].dtype == want.dtype and back[name].shape == want.shape, name
        assert np.array_equal(_bits(back[name]), _bits(want)), name


@pytest.mark.parametrize("code", sorted(CODEC_DTYPES))
def test_codec_reads_what_safetensors_wrote(tmp_path, code):
    tensors = _codec_tensors(CODEC_DTYPES[code])
    path = str(tmp_path / "x.safetensors")
    st_numpy.save_file({k: _as_numpy(t) for k, t in tensors.items()}, path)
    back = safetensors_io.load_file(path)
    assert set(back) == set(tensors)
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name


# ---------------------------------------------------------------------- #
# resume
# ---------------------------------------------------------------------- #
def test_resume_in_the_port_is_bitwise(tmp_path):
    """Six steps straight, against three steps, save_state, a fresh
    accelerator and a model made from another seed, load_state,
    skip_first_batches(3) and three more: the losses of steps 4-6 and every
    final parameter and moment are equal bit for bit."""
    _, _, _, loader, step, carry = _trainer()
    carry, straight = _train(step, carry, loader, 6)
    want = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in ckpt.flatten_tree(carry).items()}

    _reset()
    acc, _, _, loader, step, carry = _trainer()
    carry, first = _train(step, carry, loader, 3)
    out = acc.save_state(str(tmp_path / "step_3"), carry=carry)
    _reset()
    acc, model, _, loader, step, carry = _trainer(seed=1)
    carry = acc.load_state(out, carry=carry)
    assert carry["params"]["pooler.weight"] is model.pooler.weight  # restored in place
    carry, rest = _train(step, carry, acc.skip_first_batches(loader, 3), 3)
    assert [float(x) for x in first + rest] == [float(x) for x in straight]
    got = ckpt.flatten_tree(carry)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v, k


def test_resume_from_a_reference_checkpoint(tmp_path):
    """The reference trains the tiny classifier 3 steps and save_state's
    (its default sharded format); the port reads the directory with its own
    reader and carry_from_jax, then both packages train 2 more steps on the
    same batches: losses and params at 2e-5."""
    dataset = PairDataset(5 * BATCH)
    schedule = (0.0, 1e-3, 2, 8)
    jmodel = JaxClassifier(JaxConfig(**MODEL))
    sample = _collate([dataset[0]])
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(sample["input_ids"]),
                                  jnp.asarray(sample["attention_mask"]))["params"])
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()
    jacc = jax_pkg.Accelerator()
    jparams, jopt, jloader = jacc.prepare(
        params, optax.adamw(optax.warmup_cosine_decay_schedule(*schedule), weight_decay=0.01),
        jax_pkg.DataLoader(dataset, batch_size=BATCH))
    jstep = jacc.unified_step(JaxClassifier.loss_fn(jmodel), jopt, max_grad_norm=1.0)
    jcarry = jacc.init_carry(jparams, jopt)
    jlosses = []
    for i, batch in enumerate(jloader):
        jcarry, m = jstep(jcarry, batch)
        jlosses.append(float(m["loss"]))
        if i == 2:
            out = jacc.save_state(str(tmp_path / "ref"), carry=jcarry)
    jfinal = port.params_from_jax(jax.tree.map(np.asarray, jcarry["params"]),
                                  port.TransformerConfig(**MODEL))

    acc = port.Accelerator(cpu=True)
    model = port.SequenceClassifier(port.TransformerConfig(**MODEL), device="cpu",
                                    generator=torch.Generator().manual_seed(9))
    model, opt, loader = acc.prepare(
        model, port.adamw(port.warmup_cosine_decay_schedule(*schedule), weight_decay=0.01),
        port.DataLoader(dataset, batch_size=BATCH))
    dc.validate_coverage(out)
    carry = port.carry_from_jax(dc.load_full_named(out), model, opt)
    assert carry["opt_step"] == 3 and carry["opt_state"]["count"] == 3
    step = acc.unified_step(port.SequenceClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    losses = []
    for batch in acc.skip_first_batches(loader, 3):
        carry, m = step(carry, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses[3:], rtol=2e-5)
    for name, want in jfinal.items():
        np.testing.assert_allclose(carry["params"][name].detach().numpy(), want.numpy(),
                                   atol=2e-5, err_msg=name)
