"""Worker functions of the mesh tests, run under ``launchers.debug_launcher``.

Each runs on the CPU in the gloo group that ``debug_launcher`` brought up
(world 2 or 4), builds its accelerators on that group (a fresh
``AcceleratorState`` for each plugin, the group kept), and writes what the
tests compare into a directory the parent reads: process 0's records, or
every process's where the test checks each one. They import torch and the
port only, so that a spawned child never imports jax; one torch thread a
process keeps four processes off each other's cores.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _plugin(kwargs):
    """A ``ParallelismPlugin`` from JSON-able kwargs (the strategy by its
    value), or None; ``{"compat": name, "args": {...}}`` makes it with that
    shim of ``utils/compat.py``."""
    from accelerate_tpu_torch.utils import compat
    from accelerate_tpu_torch.utils.dataclasses import ParallelismPlugin, ShardingStrategy

    if kwargs is None:
        return None
    if "compat" in kwargs:
        return getattr(compat, kwargs["compat"])(**kwargs.get("args", {}))
    kwargs = dict(kwargs)
    if "sharding_strategy" in kwargs:
        kwargs["sharding_strategy"] = ShardingStrategy(kwargs["sharding_strategy"])
    return ParallelismPlugin(**kwargs)


def _fresh_accelerator(**kw):
    from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState

    AcceleratorState._reset_state()  # the process group stays up
    GradientState._reset_state()
    return Accelerator(cpu=True, **kw)


def _save(out_dir: str, name: str, record) -> None:
    torch.save(record, os.path.join(out_dir, name))


# ---------------------------------------------------------------------- #
# the mesh and the state
# ---------------------------------------------------------------------- #
def state_worker(out_dir: str):
    """The mesh each plugin resolves to at this world size, the data
    ranks, the state's repr and the sub-groups; then a plugin whose degrees
    do not cover the world, which must raise naming them. Every process
    writes ``state_<rank>.pt``."""
    import torch.distributed as dist

    from accelerate_tpu_torch.parallel.mesh import mesh_shape_of
    from accelerate_tpu_torch.utils.compat import (
        DeepSpeedPlugin,
        FullyShardedDataParallelPlugin,
        MegatronLMPlugin,
    )

    torch.set_num_threads(1)
    out = {}
    cases = {"default": {}, "hybrid": dict(dp_size=-1, fsdp_size=2, tp_size=2),
             "dp_fsdp": dict(dp_size=-1, fsdp_size=2), "tp": dict(dp_size=-1, tp_size=2)}
    for name, kwargs in cases.items():
        acc = _fresh_accelerator(parallelism_plugin=_plugin(kwargs))
        state = acc.state
        tp_group = acc.mesh.get_group("tp")
        out[name] = {"shape": mesh_shape_of(acc.mesh), "dps": state.data_parallel_size,
                     "dp_rank": state.data_parallel_rank, "axes": state.data_axis_names,
                     "repr": repr(state), "tp_ranks": dist.get_process_group_ranks(tp_group)}
    for name, plugin in (("deepspeed3", DeepSpeedPlugin(zero_stage=3)),
                         ("fsdp_plugin", FullyShardedDataParallelPlugin()),
                         ("megatron_tp2", MegatronLMPlugin(tp_degree=2))):
        acc = _fresh_accelerator(parallelism_plugin=plugin)
        out[name] = {"shape": mesh_shape_of(acc.mesh)}
    # the collectives given a sharded leaf: one global array, whole everywhere
    from accelerate_tpu_torch.parallel.sharding import shard_params
    from accelerate_tpu_torch.utils import operations as ops

    acc = _fresh_accelerator(parallelism_plugin=_plugin(dict(dp_size=-1, fsdp_size=2)))
    full = torch.arange(32.0).reshape(8, 4)
    dt = shard_params({"x": full}, {"x": ("fsdp", None)}, acc.mesh)["x"]
    out["sharded_gather"] = torch.equal(ops.gather(dt), full)
    out["sharded_reduce"] = torch.equal(ops.reduce(dt, "sum", scale=2.0), full * 2)
    try:
        _fresh_accelerator(parallelism_plugin=_plugin(dict(dp_size=3)))
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    _save(out_dir, f"state_{dist.get_rank()}.pt", out)


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #
def _mlp_loss(p, b):
    """The reference ZeRO tests' toy: tanh MLP, mean squared error."""
    h = torch.tanh(b["x"] @ p["w1"])
    return ((h @ p["w2"] - b["y"]) ** 2).mean()


def _vec_loss(p, batch):
    """The reference's FSDP-matches-DP toy: a shardable (8,) weight of which
    the prediction reads the first element."""
    pred = batch["x"] * p["w"][0] + p["b"]
    return ((pred - batch["y"]) ** 2).mean()


class _Rows:
    """A dataset over dict-of-array rows."""

    def __init__(self, **columns):
        self.columns = columns

    def __len__(self):
        return len(next(iter(self.columns.values())))

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.columns.items()}


def _mlp_rows(calls: int, rows: int, seed: int) -> _Rows:
    """The reference ZeRO test's batches: per call x (rows, 16) then y
    (rows, 8), drawn in that order from one generator."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(calls):
        xs.append(rng.normal(size=(rows, 16)).astype(np.float32))
        ys.append(rng.normal(size=(rows, 8)).astype(np.float32))
    return _Rows(x=np.concatenate(xs), y=np.concatenate(ys))


def _lm_config(run):
    from accelerate_tpu_torch import TransformerConfig
    from accelerate_tpu_torch.test_utils.training import TINY_LM

    over = run.get("config", {})
    if run.get("base") == "tiny":
        return TransformerConfig.tiny(**over)
    return TransformerConfig(**{**TINY_LM, **over})


def _lm_rows(run, cfg, calls: int, rows: int):
    from accelerate_tpu_torch.test_utils.training import MaskedTokens

    if run.get("data") == "fixed_ids":  # one batch, every call (the reference's _batch)
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(rows, 32))
        return _Rows(input_ids=np.tile(ids, (calls, 1)).astype(np.int64))
    # global batches whose mask counts differ every 2 rows
    return MaskedTokens(calls * rows, 2, seed=run.get("seed", 0), vocab=cfg.vocab_size)


def _classifier_rows(cfg, calls: int, rows: int, seed: int) -> _Rows:
    """Right-padded classifier rows (lengths 5-32 of 32, the first row
    whole), ids past a row's length 0, seeded labels."""
    rng = np.random.default_rng(seed)
    n, seq = calls * rows, 32
    lens = rng.integers(5, seq + 1, n)
    lens[0] = seq
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(4, cfg.vocab_size, (n, seq)).astype(np.int64) * mask
    return _Rows(input_ids=ids, attention_mask=mask,
                 labels=rng.integers(0, 2, n).astype(np.int64))


def _train_run(out_dir: str, run: dict) -> None:
    """One run of :func:`train_runs_worker` (its docstring)."""
    import torch.distributed as dist

    from accelerate_tpu_torch import (
        CausalLM,
        DataLoader,
        SequenceClassifier,
        adamw,
        fused_adamw,
        sgd,
    )
    from accelerate_tpu_torch.parallel.runtime import gather_full, to_local
    from accelerate_tpu_torch.parallel.sharding import shardings_of
    from accelerate_tpu_torch.test_utils.training import RegressionDataset

    accum = run.get("accum", 1)
    policy = {}
    if run.get("grad_dtype"):
        from accelerate_tpu_torch import MixedPrecisionPolicy

        policy["mixed_precision_policy"] = MixedPrecisionPolicy(
            grad_dtype=getattr(torch, run["grad_dtype"]))
    acc = _fresh_accelerator(mixed_precision=run.get("mixed_precision", "no"),
                             parallelism_plugin=_plugin(run.get("plugin")),
                             gradient_accumulation_steps=accum, **policy)
    rank, data_size = acc.process_index, acc.state.data_parallel_size
    rows = run.get("rows", 8)
    calls = run.get("calls", run.get("steps", 3) * accum)
    lr = run.get("lr", 0.5)
    name = run.get("optimizer", "sgd")
    wd = {} if name == "sgd" else {"weight_decay": run.get("weight_decay", 1e-4),
                                    "eps": run.get("eps", 1e-8)}
    opt = {"sgd": sgd, "adamw": adamw, "fused_adamw": fused_adamw}[name](lr, **wd)
    kind = run.get("model", "tiny_lm")
    model = None
    if kind == "tiny_lm":
        cfg = _lm_config(run)
        model = CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        if run.get("init", "file") == "file":
            model.load_state_dict(torch.load(os.path.join(out_dir, run.get("init_file",
                                                                           "init.pt"))))
        data, tree = _lm_rows(run, cfg, calls, rows), model
    elif kind == "classifier":
        cfg = _lm_config(run)
        model = SequenceClassifier(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        data, tree = _classifier_rows(cfg, calls, rows, run.get("seed", 0)), model
    elif kind == "mlp":
        init = np.load(os.path.join(out_dir, "mlp_init.npz"))
        tree = {k: torch.from_numpy(init[k].copy()) for k in ("w1", "w2")}
        data = _mlp_rows(calls, rows, run.get("seed", 0))
    else:  # "vec"
        tree = {"w": torch.zeros(8), "b": torch.zeros(())}
        data = RegressionDataset(length=rows * calls)
    loader = DataLoader(data, batch_size=rows // data_size)
    if run.get("step_before_carry"):
        # the reference's build order: params, then the optimizer alone (no
        # state yet), the step, and only then the carry
        tree = acc.prepare(tree)
        opt = acc.prepare(opt)
        loader = acc.prepare(loader)
    else:
        tree, opt, loader = acc.prepare(tree, opt, loader)
    loss_fn = {"tiny_lm": lambda: CausalLM.loss_fn(tree), "mlp": lambda: _mlp_loss,
               "vec": lambda: _vec_loss,
               "classifier": lambda: SequenceClassifier.loss_fn(tree)}[kind]()
    step = acc.unified_step(loss_fn, max_grad_norm=run.get("max_grad_norm"),
                            remat_policy=run.get("remat"))
    carry = acc.init_carry(tree, opt)
    params = dict(tree.named_parameters()) if model is not None else carry["params"]
    losses, norms, finite, seen, held = [], [], [], [], None
    plant = run.get("plant_inf")
    for i, batch in enumerate(loader):
        first = next(iter(batch.values()))  # each row's first value names the row
        seen.append((first[:, 0] if first.dim() > 1 else first).tolist())
        before = None
        if plant is not None and i == plant[0]:
            before = {k: to_local(v).clone() for k, v in params.items()}
            _plant_inf(rank == plant[1])
        carry, metrics = step(carry, batch)
        if before is not None:
            held = all(torch.equal(to_local(v), before[k]) for k, v in params.items())
        if metrics["is_sync_step"]:
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            finite.append(bool(metrics["grads_finite"]))
    _unplant_inf()
    if run.get("save"):
        acc.save_state(os.path.join(out_dir, run["save"]), carry=carry)
    state = (acc.get_state_dict(tree) if model is not None
             else {k: gather_full(v).detach().clone() for k, v in params.items()})
    low_norms = _low_precision_norms(acc, params, run["grad_dtype"]) if run.get(
        "grad_dtype") else None
    opt_state = carry["opt_state"]
    moments = shardings_of(opt_state["mu"]) if isinstance(opt_state.get("mu"), dict) else {}
    buffer = shardings_of(carry["accum_grads"]) if "accum_grads" in carry else {}
    mine = {"seen": seen, "held": held, "finite": finite, "losses": losses}
    if dist.is_initialized():
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, mine)
    else:  # one process, no group: the unsharded run the tests compare with
        everyone = [mine]
    whole_moments = ({key: {k: gather_full(v).detach().clone() for k, v in opt_state[key].items()}
                      for key in ("mu", "nu")} if run.get("save") else None)
    if rank == 0:
        _save(out_dir, f"{run['name']}.pt", {
            "losses": losses, "norms": norms, "finite": finite, "params": state,
            "whole_moments": whole_moments,
            "specs": shardings_of(params), "moments": moments, "buffer": buffer,
            "ranks": everyone, "data_size": data_size, "low_norms": low_norms,
            "loss_scale": (float(carry["loss_scale"].scale) if "loss_scale" in carry
                           else None)})
    acc.wait_for_everyone()


def _low_precision_norms(acc, params: dict, dtype: str) -> dict:
    """The final params cast to ``dtype`` as a gradient tree, its norm three
    ways: the step's (the layout's over the local shards, or
    ``optimizer.global_norm`` with no plugin), the raw loop's over DTensors
    (``dtensor_global_norm``), and ``optimizer.global_norm`` of the whole
    leaves on one process."""
    from accelerate_tpu_torch.optimizer import global_norm
    from accelerate_tpu_torch.parallel.runtime import (
        dtensor_global_norm,
        gather_full,
        place_like,
        to_local,
    )

    low = getattr(torch, dtype)
    local = {k: to_local(v).detach().to(low) for k, v in params.items()}
    cast = place_like(local, params)  # no DTensor op: no sharding propagation
    lay = acc._layout
    step = lay.global_norm(local) if lay is not None else global_norm(local)
    raw = dtensor_global_norm(cast) if lay is not None else step
    whole = global_norm({k: gather_full(v) for k, v in cast.items()})
    return {"step": float(step), "raw": float(raw), "whole": float(whole)}


def train_runs_worker(out_dir: str, runs: list, kernel_checks: bool = False):
    """Each of ``runs`` trains in a fresh accelerator on this group. A run
    is a dict: ``name``; ``plugin`` (kwargs, or None for none);
    ``mixed_precision``; ``model``: ``"tiny_lm"`` (the tiny CausalLM, from
    ``out_dir/init.pt`` unless ``init="seed"``; ``base="tiny"`` for the
    reference's ``tiny()`` widths; ``config`` overrides; ``data``
    ``"fixed_ids"`` for one batch of 8 x 32 every call, else
    ``MaskedTokens``; ``init_file`` another file of ``out_dir`` than
    ``init.pt``), ``"mlp"`` (the reference ZeRO tests' toy, from
    ``out_dir/mlp_init.npz``), ``"vec"`` (a shardable vector weight on
    ``RegressionDataset``) or ``"classifier"`` (a ``SequenceClassifier`` of
    the tiny LM's widths and ``config``, its own init from seed 0, on
    right-padded rows of 32); ``rows`` of each global batch; ``calls`` (or
    ``steps`` x ``accum``); ``optimizer``, ``lr``, ``weight_decay`` and ``eps``;
    ``max_grad_norm``; ``grad_dtype`` (a torch dtype's name: the policy's
    ``grad_dtype``, and the record's ``low_norms`` from
    :func:`_low_precision_norms`);
    ``remat``; ``step_before_carry``; ``plant_inf``: ``(call, rank)``, an
    inf put into that rank's gradient shards; ``save``: a directory of
    ``out_dir`` the final carry is saved into (``save_state``), and the
    record then holds the whole moments too. Process 0 writes
    ``out_dir/<name>.pt``: losses, grad norms and finite flags of the
    optimizer steps, the whole final params, the specs of the params, the
    moments and the buffer, and every rank's rows, held flag and metrics.
    ``kernel_checks``: also hand each kernel wrapper a DTensor, and write
    which raised (``kernel_refusals.json``)."""
    torch.set_num_threads(1)
    for run in runs:
        _train_run(out_dir, run)
    if kernel_checks:
        refused = kernel_refusals()
        if _rank() == 0:
            with open(os.path.join(out_dir, "kernel_refusals.json"), "w") as f:
                json.dump(refused, f)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


_PLANTED: dict = {}


def _plant_inf(here: bool) -> None:
    """An inf into this rank's first gradient shard at the next optimizer
    epilogue (after the data-parallel mean), when ``here``."""
    from accelerate_tpu_torch.parallel import runtime

    original = runtime.ShardedLayout.reduce_grads_
    _PLANTED["reduce"] = original

    def planted(self, grads, scattered=False):
        out = original(self, grads, scattered)
        if here:
            next(iter(out.values())).view(-1)[0] = float("inf")
        runtime.ShardedLayout.reduce_grads_ = original
        return out

    runtime.ShardedLayout.reduce_grads_ = planted


def _unplant_inf() -> None:
    from accelerate_tpu_torch.parallel import runtime

    if "reduce" in _PLANTED:
        runtime.ShardedLayout.reduce_grads_ = _PLANTED.pop("reduce")


def kernel_refusals() -> dict:
    """Each kernel wrapper given a DTensor argument: the error it raised
    (its type and message), or None when it did not raise."""
    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused
    from accelerate_tpu_torch.parallel.sharding import replicated

    acc = _fresh_accelerator(parallelism_plugin=_plugin(dict(dp_size=-1)))
    mesh = acc.mesh

    def dt(*shape):
        return DTensor.from_local(torch.randn(*shape), mesh, replicated(mesh), run_check=False)

    q = dt(1, 16, 2, 16)
    k = v = torch.randn(1, 16, 2, 16)
    lse = delta = torch.zeros(1, 2, 16)
    x, w, b = dt(1, 16, 64), torch.randn(32, 64), None
    cos = sin = torch.zeros(16, 16)
    row = torch.zeros(1, 8)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, 0.25),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, q, lse, delta, 0.25),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, q, lse, delta, 0.25),
        "flash_bwd_fused": lambda: fa.flash_bwd_fused(q, k, v, q, lse, delta, 0.25),
        "qkv_prologue": lambda: fused.qkv_prologue(
            x, torch.ones(64), w, w, w, b, b, b, cos, sin, eps=1e-6, norm_offset=False,
            num_heads=2, num_kv_heads=2, head_dim=16, dtype=torch.float32),
        "prologue_launch": lambda: fused.prologue_launch(
            x, torch.ones(64), w, w, w, b, b, b, cos, sin, q, q, q, eps=1e-6,
            norm_offset=False, num_heads=2, num_kv_heads=2, head_dim=16,
            dtype=torch.float32),
        "adamw_epilogue": lambda: fused.adamw_epilogue(
            [dt(4)], [torch.zeros(4)], [torch.zeros(4)], [torch.zeros(4)], row, b1=0.9,
            b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=0.0),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the test reads which error it was
            out[name] = f"{type(e).__name__}: {e}"
    return out


# ---------------------------------------------------------------------- #
# sharded checkpoints
# ---------------------------------------------------------------------- #
def _small_tree():
    """The reference test's ``_sharded_params`` tree."""
    return {"kernel": torch.arange(256.0, dtype=torch.float32).reshape(16, 16),
            "bias": torch.arange(16.0).to(torch.bfloat16),
            "counter": torch.tensor(7, dtype=torch.int32)}


def _train_like_tree():
    """The reference's ``_train_like_tree``: params and moment-like leaves,
    dim 24 divisible by every world size tried."""
    kernel = torch.arange(24.0 * 8).reshape(24, 8)
    bias = torch.arange(24.0)
    return {"params": {"kernel": kernel, "bias": bias},
            "mu": {"kernel": kernel * 0.1, "bias": bias * 0.1},
            "nu": {"kernel": kernel ** 2, "bias": bias ** 2},
            "count": torch.tensor(3, dtype=torch.int32)}


def _place_fsdp(acc, tree):
    """Every leaf of at least one dim split over fsdp on dim 0 (the
    reference test's ``P("fsdp")``), as DTensors."""
    from accelerate_tpu_torch.checkpointing import _rebuild
    from accelerate_tpu_torch.parallel.sharding import shard_params

    def put(path, leaf):
        spec = ("fsdp",) + (None,) * (leaf.dim() - 1) if leaf.dim() else ()
        return shard_params({path: leaf}, {path: spec}, acc.mesh)[path]

    return _rebuild(tree, put)


def _zeros_like_tree(tree):
    from accelerate_tpu_torch.checkpointing import _rebuild

    return _rebuild(tree, lambda path, leaf: torch.zeros_like(leaf))


def _whole(tree) -> dict:
    """Every leaf of a tree whole (a DTensor gathered), by flat name."""
    from accelerate_tpu_torch.checkpointing import flatten_tree
    from accelerate_tpu_torch.parallel.runtime import gather_full

    return {k: gather_full(v).clone() if isinstance(v, torch.Tensor) else v
            for k, v in flatten_tree(tree).items()}


def checkpoint_world_four(out_dir: str, grow_back: bool = False):
    """The world-4 halves of the sharded-checkpoint tests. First: the
    reference's round trips (fsdp 4 over ``_small_tree``, restored onto the
    same sharding, onto a replicated one, non-strict), ``save_state`` of a
    sharded carry and its load, the train-like tree saved 4-way (for the
    world-2 and world-1 restores) and restored here, and the tiny CausalLM
    trained 2 steps under FULL_SHARD (fsdp 2 x tp 2) and saved through the
    commit; every process writes ``ck4_<rank>.pt``. ``grow_back``: the
    world-2 save (``ck2``) restored back at 4, into ``ck4b_<rank>.pt``."""
    import torch.distributed as dist

    from accelerate_tpu_torch import CausalLM, DataLoader, adamw
    from accelerate_tpu_torch.dist_checkpoint import load_sharded_tree, save_sharded_tree
    from accelerate_tpu_torch.parallel.sharding import replicated, shardings_of

    torch.set_num_threads(1)
    rank = dist.get_rank()
    rec = {}
    plugin = dict(dp_size=1, fsdp_size=4, min_weight_size=1)
    acc = _fresh_accelerator(parallelism_plugin=_plugin(plugin))
    if grow_back:
        back2 = load_sharded_tree(_zeros_like_tree(_place_fsdp(acc, _train_like_tree())),
                                  os.path.join(out_dir, "ck2"))
        _save(out_dir, f"ck4b_{rank}.pt", {"n_m_n": _whole(back2)})
        return
    params = acc.prepare(_small_tree())
    rec["small_specs"] = shardings_of(params)
    small = os.path.join(out_dir, "small")
    save_sharded_tree(params, small)
    acc.wait_for_everyone()
    restored = load_sharded_tree(_zeros_like_tree(params), small)
    rec["small_roundtrip"] = all(torch.equal(restored[k].to_local(), params[k].to_local())
                                 and restored[k].placements == params[k].placements
                                 and restored[k].dtype == params[k].dtype for k in params)
    # onto a replicated template
    from torch.distributed.tensor import DTensor

    repl = {k: DTensor.from_local(torch.zeros(v.shape, dtype=v.dtype), acc.mesh,
                                  replicated(acc.mesh), run_check=False)
            for k, v in params.items()}
    onto = load_sharded_tree(repl, small)
    rec["small_onto_replicated"] = all(torch.equal(onto[k].to_local(), v)
                                       for k, v in _small_tree().items())
    # non-strict keeps a template extra
    template = {"kernel": torch.zeros_like(params["kernel"]), "loss_scale": 2.0 ** 15}
    try:
        load_sharded_tree(template, small, strict=True)
        rec["strict_raised"] = False
    except KeyError:
        rec["strict_raised"] = True
    loose = load_sharded_tree(template, small, strict=False)
    rec["nonstrict"] = (torch.equal(loose["kernel"].to_local(), params["kernel"].to_local())
                        and loose["loss_scale"] == 2.0 ** 15)
    # save_state of a sharded carry: the per-process format, loaded back
    opt = acc.prepare(adamw(1e-2))
    tree = acc.prepare({"kernel": torch.arange(256.0).reshape(16, 16),
                        "bias": torch.arange(16.0)})
    carry = acc.init_carry(tree, opt)
    step = acc.unified_step(lambda p, b: (p["kernel"] ** 2).mean() + p["bias"].sum() * 0)
    carry, _ = step(carry, {"x": torch.ones(2, 1)})
    path = acc.save_state(os.path.join(out_dir, "state"), carry=carry)
    rec["state_files"] = sorted(os.listdir(path))
    back = acc.load_state(path, carry=_zeros_carry(carry))
    rec["state_roundtrip"] = _carry_equal(carry, back)
    # the train-like tree, 4-way
    rec["train_like"] = _whole(_place_fsdp(acc, _train_like_tree()))
    four = os.path.join(out_dir, "ck4")
    save_sharded_tree(_place_fsdp(acc, _train_like_tree()), four)
    acc.wait_for_everyone()
    back4 = load_sharded_tree(_zeros_like_tree(_place_fsdp(acc, _train_like_tree())), four)
    rec["restore_4"] = _whole(back4)
    # the tiny CausalLM under FULL_SHARD (fsdp 2 x tp 2), saved through the commit
    from accelerate_tpu_torch.test_utils.training import MaskedTokens

    lm = _fresh_accelerator(parallelism_plugin=_plugin(dict(dp_size=1, fsdp_size=2,
                                                            tp_size=2)))
    model = CausalLM(_lm_config({}), device="cpu")
    model.load_state_dict(torch.load(os.path.join(out_dir, "init.pt")))
    model, lm_opt, loader = lm.prepare(model, adamw(1e-2),
                                       DataLoader(MaskedTokens(16, 2), batch_size=4))
    lm_step = lm.unified_step(CausalLM.loss_fn(model), max_grad_norm=1.0)
    lm_carry = lm.init_carry(model, lm_opt)
    for batch in loader:
        lm_carry, _ = lm_step(lm_carry, batch)
    rec["lm_path"] = lm.save_state(os.path.join(out_dir, "lm_full_shard"), carry=lm_carry)
    rec["lm_carry"] = _whole(lm_carry)
    rec["lm_specs"] = shardings_of(dict(model.named_parameters()))
    _save(out_dir, f"ck4_{rank}.pt", rec)


def checkpoint_world_two(out_dir: str):
    """The world-2 half: the 4-way train-like checkpoint restored here (fsdp
    2) and saved again (``ck2``), and the reference's 4-way checkpoint
    (``out_dir/ref4``, its names under ``ref_names.json``) restored onto
    this mesh. Every process writes ``ck2_<rank>.pt``."""
    import torch.distributed as dist

    from accelerate_tpu_torch.dist_checkpoint import load_sharded_tree, save_sharded_tree
    from accelerate_tpu_torch.parallel.sharding import shardings_of

    torch.set_num_threads(1)
    rank = dist.get_rank()
    acc = _fresh_accelerator(parallelism_plugin=_plugin(dict(dp_size=1, fsdp_size=2,
                                                             min_weight_size=1)))
    on2 = load_sharded_tree(_zeros_like_tree(_place_fsdp(acc, _train_like_tree())),
                            os.path.join(out_dir, "ck4"))
    rec = {"restore_2": _whole(on2)}
    save_sharded_tree(on2, os.path.join(out_dir, "ck2"))
    acc.wait_for_everyone()
    ref = os.path.join(out_dir, "ref4")
    if os.path.isdir(ref):
        with open(os.path.join(out_dir, "ref_names.json")) as f:
            shapes = json.load(f)
        template = {k: torch.zeros(s, dtype=getattr(torch, dt)) for k, (s, dt) in shapes.items()}
        from accelerate_tpu_torch.parallel.sharding import infer_param_shardings, shard_params

        specs = infer_param_shardings(template, acc.mesh, acc.state.parallelism_plugin)
        placed = shard_params(template, specs, acc.mesh)
        loaded = load_sharded_tree(placed, ref)
        rec["ref4_specs"] = shardings_of(loaded)
        rec["ref4"] = _whole(loaded)
    _save(out_dir, f"ck2_{rank}.pt", rec)


def _zeros_carry(carry):
    from accelerate_tpu_torch.checkpointing import _rebuild

    return _rebuild(carry, lambda path, leaf: torch.zeros_like(leaf)
                    if isinstance(leaf, torch.Tensor) else type(leaf)(0))


def _carry_equal(a, b) -> bool:
    from accelerate_tpu_torch.checkpointing import flatten_tree
    from accelerate_tpu_torch.parallel.runtime import to_local

    fa, fb = flatten_tree(a), flatten_tree(b)
    for k, v in fa.items():
        w = fb[k]
        if isinstance(v, torch.Tensor):
            if not torch.equal(to_local(v), to_local(w)):
                return False
        elif v != w:
            return False
    return True


# ---------------------------------------------------------------------- #
# loads onto a mesh
# ---------------------------------------------------------------------- #
def mesh_load_worker(out_dir: str, cases: list):
    """Each of ``cases`` (``name``, ``plugin`` kwargs, ``checkpoint`` dir,
    ``kind``: ``"tree"`` for ``shapes.json``'s flat tree, ``"model"`` for a
    ``CausalLM`` of ``config.json``'s fields, ``hf`` for an HF checkpoint,
    ``logical`` to pass the model's logical axes explicitly) loaded with
    ``load_checkpoint_and_dispatch(mesh=...)``; process 0 writes
    ``<name>.pt``: each leaf whole, the specs, and for a model the logits
    of ``ids.pt`` through ``apply_sharded``."""
    import torch.distributed as dist

    from accelerate_tpu_torch import CausalLM, TransformerConfig, init_empty_weights
    from accelerate_tpu_torch.big_modeling import load_checkpoint_and_dispatch
    from accelerate_tpu_torch.parallel.runtime import apply_sharded, gather_full
    from accelerate_tpu_torch.parallel.sharding import get_logical_specs, shardings_of

    torch.set_num_threads(1)
    for case in cases:
        acc = _fresh_accelerator(parallelism_plugin=_plugin(case["plugin"]))
        ckpt = case["checkpoint"]
        rec = {}
        if case["kind"] == "tree":
            with open(os.path.join(ckpt, "shapes.json")) as f:
                shapes = json.load(f)
            template = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
            loaded = load_checkpoint_and_dispatch(template, ckpt, mesh=acc.mesh,
                                                  plugin=acc.state.parallelism_plugin)
            params = loaded
        else:
            with open(case["config"]) as f:
                cfg = TransformerConfig(**json.load(f))
            meta = init_empty_weights(CausalLM, cfg)
            kw = {"logical_specs": get_logical_specs(meta)} if case.get("logical") else {}
            if case.get("hf"):
                kw.update(config=cfg, hf_format=True)
            model = load_checkpoint_and_dispatch(meta, ckpt, mesh=acc.mesh,
                                                 plugin=acc.state.parallelism_plugin, **kw)
            params = dict(model.named_parameters())
            rec["logits"] = apply_sharded(model, torch.load(os.path.join(out_dir, "ids.pt")))
        rec["specs"] = shardings_of(params)
        rec["whole"] = {k: gather_full(v).detach().clone() for k, v in params.items()}
        if dist.get_rank() == 0:
            _save(out_dir, f"{case['name']}.pt", rec)
        acc.wait_for_everyone()


def sharded_lm_worker(out_dir: str, plugin: dict, steps: int, rows: int, lr: float,
                      clip: float, seed: int = 0):
    """The tiny CausalLM (fp32, weights from ``out_dir/init.pt``) trained
    ``steps`` steps with sgd under FULL_SHARD over ``plugin``'s mesh, on
    ``MaskedTokens`` global batches of ``rows`` a data-parallel rank (whose
    mask counts differ between data ranks), saved through the commit into
    ``out_dir/ckpt``; process 0 writes the whole final params,
    ``out_dir/full.pt``."""
    from accelerate_tpu_torch import CausalLM, DataLoader, sgd
    from accelerate_tpu_torch.test_utils.training import MaskedTokens

    torch.set_num_threads(1)
    acc = _fresh_accelerator(parallelism_plugin=_plugin(plugin))
    model = CausalLM(_lm_config({}), device="cpu")
    model.load_state_dict(torch.load(os.path.join(out_dir, "init.pt")))
    data_size = acc.state.data_parallel_size
    data = MaskedTokens(steps * rows * data_size, rows, seed=seed)
    model, opt, loader = acc.prepare(model, sgd(lr), DataLoader(data, batch_size=rows))
    step = acc.unified_step(CausalLM.loss_fn(model), max_grad_norm=clip)
    carry = acc.init_carry(model, opt)
    for batch in loader:
        carry, _ = step(carry, batch)
    acc.save_state(os.path.join(out_dir, "ckpt"), carry=carry)
    state = acc.get_state_dict(model)
    if acc.is_main_process:
        torch.save(state, os.path.join(out_dir, "full.pt"))
    acc.wait_for_everyone()
