"""Worker functions for ``debug_launcher``-based multi-process tests.

Port of ``accelerate_tpu/test_utils/scripts/multiprocess_worker.py``
(``collective_worker`` :10, ``training_worker`` :30,
``sharded_checkpoint_worker`` :56, ``local_sgd_worker`` :93), plus the
port's own: every collective's multi-process form, a rank that never
reaches a collective, and the tiny ``CausalLM`` trained on global batches
whose processes hold different mask counts, saved and loaded back. A
spawned child resolves each by its qualified name; each runs on the CPU in
the gloo group that ``debug_launcher`` brought up, and fails by raising.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


def collective_worker():
    """Real cross-process collectives: a sum, a gather in rank order and
    process 0's broadcast."""
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils.operations import broadcast, gather, reduce

    state = PartialState()
    assert state.num_processes > 1, "expected multi-process"
    total = reduce(torch.ones(()), "sum")
    np.testing.assert_allclose(total.numpy(), state.num_processes)
    g = gather(torch.tensor([float(state.process_index)]))
    np.testing.assert_allclose(np.sort(g.numpy()), np.arange(state.num_processes))
    b = broadcast(torch.tensor([41.0 + state.process_index]))
    np.testing.assert_allclose(b.numpy(), [41.0])  # rank 0's value wins


def training_worker():
    """Regression trained on the sharded loader with the gradient mean
    reaches the generating parameters (reference test_script.py's
    training_check under the launcher)."""
    from accelerate_tpu_torch import Accelerator, DataLoader, sgd
    from accelerate_tpu_torch.test_utils.training import (
        RegressionDataset,
        regression_init,
        regression_loss,
    )

    acc = Accelerator(cpu=True)
    dl = acc.prepare_data_loader(DataLoader(RegressionDataset(length=64, seed=3), batch_size=8))
    opt = acc.prepare(sgd(0.1))
    params = acc.prepare(regression_init())
    carry = acc.init_carry(params, opt)
    step = acc.unified_step(regression_loss)
    for _ in range(15):
        for batch in dl:
            carry, _ = step(carry, batch)
    a = float(carry["params"]["a"].detach())
    assert abs(a - 2.0) < 0.3, a


def sequence_worker(names: tuple):
    """The workers of this module named ``names``, one after another in one
    launch, each on a fresh accelerator state (the process group kept): one
    spawn of the processes for several checks."""
    from accelerate_tpu_torch import AcceleratorState, GradientState

    for name in names:
        AcceleratorState._reset_state()
        GradientState._reset_state()
        globals()[name]()


def sharded_checkpoint_worker(tmpdir):
    """Each process writes only its own chunks; a restore reads each rank's
    chunk back onto the live sharding (reference :56)."""
    import glob

    from accelerate_tpu_torch import Accelerator, ParallelismPlugin
    from accelerate_tpu_torch.dist_checkpoint import load_sharded_tree, save_sharded_tree
    from accelerate_tpu_torch.parallel.sharding import local_bounds, spec_of_placements

    acc = Accelerator(cpu=True, parallelism_plugin=ParallelismPlugin(
        dp_size=1, fsdp_size=2, min_weight_size=1))
    assert acc.num_processes == 2
    full = torch.arange(64.0, dtype=torch.float32).reshape(8, 8)
    params = acc.prepare({"k": full.clone()})
    save_sharded_tree(params, tmpdir)
    acc.wait_for_everyone()
    # one manifest and one shard file a process, half the data each
    assert len(glob.glob(os.path.join(tmpdir, "state_index_*.json"))) == 2
    mine = json.load(open(os.path.join(
        tmpdir, f"state_index_{acc.process_index:05d}.json")))
    # the heuristic splits the later of two equal dims
    assert [(c["offset"], c["shape"]) for c in mine["k"]["chunks"]] == [
        ([0, 4 * acc.process_index], [8, 4])], mine
    template = {"k": torch.zeros_like(params["k"])}
    restored = load_sharded_tree(template, tmpdir)
    leaf = restored["k"]
    bounds = local_bounds(spec_of_placements(leaf.placements, leaf.ndim), leaf.shape,
                          acc.process_index, acc.mesh)
    want = full[tuple(slice(lo, hi) for lo, hi in bounds)]
    assert torch.equal(leaf.to_local(), want)


def local_sgd_worker():
    """Each process trains its own copy toward a different target with no
    gradient exchange; LocalSGD's periodic average lands every process on
    the mean."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.local_sgd import LocalSGD

    acc = Accelerator(cpu=True)
    assert acc.num_processes == 2
    target = float(acc.process_index)  # rank 0 -> 0, rank 1 -> 1
    params = {"w": torch.tensor(5.0)}
    with LocalSGD(acc, local_sgd_steps=4) as lsgd:
        for _ in range(8):
            params["w"].sub_(0.25 * 2.0 * (params["w"] - target))
            params = lsgd.step(params)
    w = float(params["w"])
    assert abs(w - 0.5) < 0.05, w


def operations_worker(out_dir):
    """Every collective's multi-process form, each process's inputs of
    different sizes where the collective allows it; the process helpers
    and the debug-mode checker. Writes nothing unless every check held."""
    from accelerate_tpu_torch.adapters import LoraConfig, load_adapter, save_adapter
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.random import KeyChain, synchronize_rng_states

    state = PartialState()
    rank, world = state.process_index, state.num_processes
    objs = ops.gather_object({"rank": rank, "payload": "x" * (10 ** rank)})
    assert [o["rank"] for o in objs] == list(range(world))
    assert [len(o["payload"]) for o in objs] == [10 ** r for r in range(world)]
    x = torch.full((rank + 2, 3), float(rank + 1))
    padded = ops.pad_across_processes(x, dim=0, pad_index=-1)
    assert padded.shape == (world + 1, 3), padded.shape
    assert torch.equal(padded[:rank + 2], x) and bool((padded[rank + 2:] == -1).all())
    first = ops.pad_across_processes(x, dim=0, pad_first=True)
    assert torch.equal(first[world + 1 - (rank + 2):], x)
    everyone = ops.gather(padded)
    assert everyone.shape == ((world + 1) * world, 3)
    v = torch.tensor([1.0, 2.0]) * (rank + 1)
    s = sum(range(1, world + 1))
    assert torch.equal(ops.reduce(v, "sum"), torch.tensor([1.0, 2.0]) * s)
    assert torch.allclose(ops.reduce(v, "mean", scale=2.0),
                          torch.tensor([1.0, 2.0]) * s * 2 / world)
    assert torch.equal(ops.broadcast({"t": torch.arange(4.0) + rank})["t"], torch.arange(4.0))
    assert torch.equal(ops.broadcast(torch.tensor([rank]), from_process=world - 1),
                       torch.tensor([world - 1]))
    payload = ["from-rank-0", {"n": 7}] if rank == 0 else [None, None]
    assert ops.broadcast_object_list(payload) == ["from-rank-0", {"n": 7}]
    assert payload[0] == "from-rank-0"  # filled in place
    with state.split_between_processes(list(range(2 * world + 1)), apply_padding=True) as mine:
        assert len(mine) == 3, mine
    shares = ops.gather_object(mine)
    assert sorted(set(i for share in shares for i in share)) == list(range(2 * world + 1))
    with state.main_process_first():
        pass
    state.wait_for_everyone()
    # rank 0's generator state on every process
    np.random.seed(rank)
    keys = KeyChain(rank)
    synchronize_rng_states(["numpy", "generator"], keys)
    draws = ops.gather_object((float(np.random.rand()),
                               float(torch.rand((), generator=keys.generator))))
    assert len(set(draws)) == 1, draws
    # the debug-mode checker turns a shape mismatch into an error, not a hang
    state.debug = True
    try:
        try:
            ops.gather(torch.zeros(rank + 1))
        except ops.DistributedOperationException:
            pass
        else:
            raise AssertionError("the debug checker let a shape mismatch through")
    finally:
        state.debug = False
    # an adapter saved by every process, committed once
    lcfg = LoraConfig(rank=2, target_modules=("q_proj",))
    tree = {"q_proj": {"lora_a": torch.arange(8.0).reshape(1, 4, 2),
                       "lora_b": torch.ones(1, 2, 4)}}
    path = save_adapter(out_dir, "shared", tree, lcfg, process_index=rank, world=world)
    state.wait_for_everyone()
    loaded, _ = load_adapter(path)
    assert torch.equal(loaded["q_proj"]["lora_a"], tree["q_proj"]["lora_a"])
    assert sorted(n for n in os.listdir(path) if n.startswith("done_")) == [
        f"done_{p:05d}" for p in range(world)]


def hang_worker(sleep_s: float):
    """Process 0 enters an all-reduce that the others never join; they
    sleep ``sleep_s`` seconds and return."""
    import torch.distributed as dist

    from accelerate_tpu_torch.state import PartialState

    if PartialState().process_index == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(sleep_s)


def barrier_worker():
    """``wait_for_everyone`` at world > 1: no process passes the barrier
    before every process reached it."""
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils.operations import gather_object

    state = PartialState()
    time.sleep(0.3 * state.process_index)
    reached = time.time()
    state.wait_for_everyone()
    passed = time.time()
    times = gather_object((reached, passed))
    assert min(p for _, p in times) >= max(r for r, _ in times), times


def tiny_lm_worker(out_dir: str, steps: int = 3, rows_per_process: int = 4, seed: int = 0):
    """The tiny CausalLM (fp32, weights from ``out_dir/init.pt``) trained
    ``steps`` steps with sgd (lr 0.5, clip 1.0) on ``MaskedTokens`` through
    the prepared loader, then saved (``out_dir/ckpt``) through the
    done-marker commit and loaded back into a fresh model at this world
    size, bit for bit. Writes ``out_dir/rank<p>.pt``: the losses, the grad
    norms and the final state dict."""
    from accelerate_tpu_torch import Accelerator, CausalLM, DataLoader, TransformerConfig, sgd
    from accelerate_tpu_torch.checkpointing import flatten_tree
    from accelerate_tpu_torch.test_utils.training import TINY_LM, MaskedTokens

    acc = Accelerator(cpu=True)
    world, rank = acc.num_processes, acc.process_index
    cfg = TransformerConfig(**TINY_LM)
    model = CausalLM(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(out_dir, "init.pt")))
    data = MaskedTokens(steps * rows_per_process * world, rows_per_process, seed=seed)
    model, opt, loader = acc.prepare(model, sgd(0.5),
                                     DataLoader(data, batch_size=rows_per_process))
    step = acc.unified_step(CausalLM.loss_fn(model), max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    losses, norms, counts = [], [], []
    for batch in loader:
        counts.append(float(batch["loss_mask"][:, 1:].sum()))
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    path = acc.save_state(os.path.join(out_dir, "ckpt"), carry=carry)
    # a fresh model at this world size loads every leaf bit for bit
    fresh = CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed + 1))
    fresh_carry = acc.init_carry(fresh, acc.prepare(sgd(0.5)))
    restored = acc.load_state(path, carry=fresh_carry)
    want, got = flatten_tree(carry), flatten_tree(restored)
    for k, v in want.items():
        assert (torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v), k
    torch.save({"losses": losses, "norms": norms, "mask_counts": counts,
                "params": {k: v.detach().clone() for k, v in model.state_dict().items()}},
               os.path.join(out_dir, f"rank{rank}.pt"))


def tiny_lora_worker(out_dir: str, steps: int = 3, rows_per_process: int = 4, seed: int = 0):
    """A rank 4 q/v adapter on the frozen tiny CausalLM (fp32, weights from
    ``out_dir/init.pt``, the adapter from ``out_dir/adapter.pt``) trained
    ``steps`` steps with sgd (lr 0.5, clip 1.0) on ``MaskedTokens`` through
    the prepared loader, once over the plain base ("lora") and once over
    its int8 quantization ("qlora", dequantized to fp32). Writes
    ``out_dir/lora_rank<p>.pt``: for each, the losses, the grad norms and
    the final adapter."""
    from accelerate_tpu_torch import Accelerator, CausalLM, DataLoader, TransformerConfig, sgd
    from accelerate_tpu_torch.adapters import LoraConfig, lora_loss_fn
    from accelerate_tpu_torch.checkpointing import flatten_tree
    from accelerate_tpu_torch.test_utils.training import TINY_LM, MaskedTokens
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize_params

    acc = Accelerator(cpu=True)
    world, rank = acc.num_processes, acc.process_index
    model = CausalLM(TransformerConfig(**TINY_LM), device="cpu")
    model.load_state_dict(torch.load(os.path.join(out_dir, "init.pt")))
    model.requires_grad_(False)
    lcfg = LoraConfig(rank=4, alpha=8.0, target_modules=("q_proj", "v_proj"))
    bases = {"lora": (model, None),
             "qlora": (quantize_params(model, QuantizationConfig(load_in_8bit=True,
                                                                 min_weight_size=256)),
                       torch.float32)}
    data = MaskedTokens(steps * rows_per_process * world, rows_per_process, seed=seed)
    loader = acc.prepare(DataLoader(data, batch_size=rows_per_process))
    out = {}
    for name, (base, dtype) in bases.items():
        adapter = acc.prepare(torch.load(os.path.join(out_dir, "adapter.pt")))
        carry = acc.init_carry(adapter, acc.prepare(sgd(0.5)))
        step = acc.unified_step(lora_loss_fn(model, base, lcfg, compute_dtype=dtype),
                                max_grad_norm=1.0)
        losses, norms, counts = [], [], []
        for batch in loader:
            counts.append(float(batch["loss_mask"][:, 1:].sum()))
            carry, metrics = step(carry, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        out[name] = {"losses": losses, "norms": norms, "mask_counts": counts,
                     "adapter": {k: v.detach().clone()
                                 for k, v in flatten_tree(carry["params"]).items()}}
    torch.save(out, os.path.join(out_dir, f"lora_rank{rank}.pt"))



def scheduler_worker(out_dir: str):
    """``AcceleratedScheduler``'s count after one synced step across the
    group, without and with ``split_batches``, and after a step while
    accumulating: written to ``out_dir/scheduler_<rank>.json``."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.scheduler import AcceleratedScheduler

    acc = Accelerator(cpu=True)
    counts = {}
    for split in (False, True):
        sched = AcceleratedScheduler(lambda count: 1.0, split_batches=split)
        acc.gradient_state.sync_gradients = True
        sched.step()
        acc.gradient_state.sync_gradients = False
        sched.step()  # frozen while accumulating
        counts["split" if split else "plain"] = sched.step_count
    with open(os.path.join(out_dir, f"scheduler_{acc.process_index}.json"), "w") as f:
        json.dump({"num_processes": acc.num_processes, **counts}, f)
