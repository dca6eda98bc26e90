"""Worker functions of the pipeline, ring-attention and expert-parallel
tests, run under ``launchers.debug_launcher`` at world 4 (or 2) on the CPU
over gloo.

Each worker reads the inputs the test drew with the reference's keys
(``inputs.npz`` in the output directory), runs every configuration of its
file in one process group (a mesh, or a fresh ``AcceleratorState``, per
configuration, the group kept) and writes each rank's record,
``<name>_<rank>.pt``, which the tests assemble and compare with the
reference's numbers. They import torch and the port only, and set one
torch thread a process.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from .sharding_workers import _fresh_accelerator, _plugin, _save


def _inputs(out_dir: str) -> dict:
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    return {k: torch.from_numpy(data[k].copy()) for k in data.files}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def _mesh(kwargs: dict):
    from accelerate_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(_plugin(kwargs), device_type="cpu")


def _coord(mesh) -> dict:
    from accelerate_tpu_torch.parallel.mesh import mesh_coordinate, mesh_shape_of

    return mesh_coordinate(_rank(), mesh_shape_of(mesh))


def _rows(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    step = x.shape[0] // n
    return x[i * step:(i + 1) * step]


def _data_index(mesh) -> tuple[int, int]:
    """(number of row-holding ranks, this rank's index): dp x fsdp x ep."""
    from accelerate_tpu_torch.parallel.mesh import mesh_shape_of

    shape, c = mesh_shape_of(mesh), _coord(mesh)
    n, i = 1, 0
    for a in ("dp", "fsdp", "ep"):
        n, i = n * shape[a], i * shape[a] + c[a]
    return n, i


def _stage_params(stack: dict, mesh) -> dict:
    """This stage's layers of a whole stack, as DTensors split over pp."""
    from accelerate_tpu_torch.parallel.pipeline import stacked_layer_shardings
    from accelerate_tpu_torch.parallel.sharding import shard_params

    return shard_params(stack, stacked_layer_shardings(stack, mesh), mesh)


def _local(tree: dict) -> dict:
    from accelerate_tpu_torch.parallel.runtime import to_local

    return {k: to_local(v).detach().clone() for k, v in tree.items()}


# ---------------------------------------------------------------------- #
# the reference tests' toy stacks
# ---------------------------------------------------------------------- #
def toy_block(local: dict, x: torch.Tensor) -> torch.Tensor:
    """The residual MLP stack of ``tests/test_pipeline.py`` over a stage's
    layers (leading local-layer dim)."""
    for i in range(local["w"].shape[0]):
        x = x + torch.tanh(x @ local["w"][i]) @ local["v"][i]
    return x


def tanh_block(local: dict, x: torch.Tensor) -> torch.Tensor:
    """The memory tests' stack: h + tanh(h @ w)."""
    for i in range(local["w"].shape[0]):
        x = x + torch.tanh(x @ local["w"][i])
    return x


def mse(y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return ((y - t) ** 2).mean()


def attn_block(mesh, heads: int, head_dim: int):
    """The pp x sp test's stage: ring attention on q = k = v = h, then the
    residual MLP, each layer."""
    from accelerate_tpu_torch.ops.ring_attention import ring_attention

    def fn(local, x):
        for i in range(local["w"].shape[0]):
            b, s, hh = x.shape
            qkv = x.reshape(b, s, heads, head_dim)
            a = ring_attention(qkv, qkv, qkv, causal=True, mesh=mesh)
            x = x + a.reshape(b, s, hh)
            x = x + torch.tanh(x @ local["w"][i]) @ local["v"][i]
        return x

    return fn


def _route(router: torch.Tensor, h: torch.Tensor, k: int):
    from accelerate_tpu_torch.models.transformer import _top_k

    w, sel = _top_k(torch.softmax(h @ router, dim=-1), k)
    return sel, w / w.sum(dim=-1, keepdim=True)


def moe_block(mesh, k: int, capacity_factor: float):
    """The pp x ep test's stage: top-k routing and ``moe_ragged_ep`` on the
    whole stacks (each ep rank runs its experts), residual."""
    from accelerate_tpu_torch.ops.moe import moe_ragged_ep

    def fn(local, x):
        for i in range(local["router"].shape[0]):
            sel, w = _route(local["router"][i], x, k)
            x = x + moe_ragged_ep(x, sel, w, local["wg"][i], local["wu"][i], local["wd"][i],
                                  mesh=mesh, capacity_factor=capacity_factor)
        return x

    return fn


class SavedBytes:
    """The bytes autograd keeps for the backward, live and at their peak,
    counted through ``saved_tensors_hooks`` (a saved tensor is counted
    until the graph that holds it is freed)."""

    def __init__(self):
        self.live = self.peak = 0

    def _pack(self, t):
        return _Held(t, self)

    @staticmethod
    def _unpack(h):
        return h.t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)


class _Held:
    def __init__(self, t, counter: SavedBytes):
        self.t, self.counter = t, counter
        self.n = t.numel() * t.element_size()
        counter.live += self.n
        counter.peak = max(counter.peak, counter.live)

    def __del__(self):
        self.counter.live -= self.n


# ---------------------------------------------------------------------- #
# test_torch_pipeline.py
# ---------------------------------------------------------------------- #
def _gpipe(out_dir: str, inp: dict) -> None:
    from accelerate_tpu_torch.parallel.pipeline import pipeline_apply

    stack = {"w": inp["w"], "v": inp["v"]}
    for M in (2, 4):
        mesh = _mesh(dict(dp_size=2, pp_size=2, sharding_strategy="no_shard",
                          num_micro_batches=M))
        ps = _local(_stage_params(stack, mesh))
        y = pipeline_apply(toy_block, ps, inp["x"], mesh=mesh, num_micro_batches=M)
        _save(out_dir, f"gpipe_fwd_M{M}_{_rank()}.pt", {"y": y})
    leaves = {k: v.requires_grad_(True) for k, v in ps.items()}
    y = pipeline_apply(toy_block, leaves, inp["x"], mesh=mesh, num_micro_batches=4)
    loss = (y ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _save(out_dir, f"gpipe_grads_{_rank()}.pt",
          {"stage": _coord(mesh)["pp"], "grads": dict(zip(leaves, grads))})


def _unified_gpipe(out_dir: str, inp: dict) -> None:
    """4 unified_step calls through pipeline_apply (pp 2 x dp 2), and the
    port's own dp-4 run of the plain stack."""
    from accelerate_tpu_torch import sgd
    from accelerate_tpu_torch.parallel.pipeline import pipeline_apply
    from accelerate_tpu_torch.parallel.runtime import gather_full

    for pp in (True, False):
        plugin = dict(dp_size=2 if pp else 4, pp_size=2 if pp else 1,
                      sharding_strategy="no_shard", num_micro_batches=4)
        acc = _fresh_accelerator(parallelism_plugin=_plugin(plugin))
        stack = {"w": inp["w"].clone(), "v": inp["v"].clone()}
        n, i = acc.state.data_parallel_size, acc.state.data_parallel_rank
        if pp:
            params = _stage_params(stack, acc.mesh)
            mesh = acc.mesh

            def loss_fn(p, batch):
                y = pipeline_apply(toy_block, p, batch["x"], mesh=mesh, num_micro_batches=4)
                return ((y - batch["y"]) ** 2).mean()
        else:
            params = acc.prepare(stack)

            def loss_fn(p, batch):
                return ((toy_block(p, batch["x"]) - batch["y"]) ** 2).mean()
        opt = acc.prepare(sgd(1e-2))
        carry = acc.init_carry(params, opt)
        step = acc.unified_step(loss_fn)
        rng = np.random.default_rng(0)
        losses = []
        for _ in range(4):
            x = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
            y = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
            carry, m = step(carry, {"x": _rows(x, n, i), "y": _rows(y, n, i)})
            losses.append(float(m["loss"]))
        final = {k: gather_full(v).detach().clone() for k, v in carry["params"].items()}
        if _rank() == 0:
            _save(out_dir, f"unified_{'pp' if pp else 'seq'}_0.pt",
                  {"params": final, "losses": losses})


def _validation(out_dir: str) -> None:
    """pp_size=-1 resolving above 1 is validated on its resolved degree (4
    at world 4 with dp 1)."""
    try:
        _fresh_accelerator(parallelism_plugin=_plugin(dict(dp_size=1, pp_size=-1,
                                                          num_micro_batches=2)))
        err = None
    except ValueError as e:
        err = str(e)
    _save(out_dir, f"auto_pp_{_rank()}.pt", {"error": err})


def _f1b_case(out_dir: str, name: str, plugin: dict, make_block, stack: dict, x, tgt,
              seq_dim: int = None, feed: str = "boundary") -> None:
    """One ``pipeline_train_step`` on a mesh of ``plugin``: each rank's rows
    (and, with ``seq_dim``, its sp chunk) of ``x``/``tgt``, stage 0 and the
    last stage alone given them unless ``feed="replicated"``;
    ``make_block(mesh)`` gives the stage's block."""
    from accelerate_tpu_torch.parallel.pipeline import pipeline_train_step

    mesh = _mesh(plugin)
    c = _coord(mesh)
    n, i = _data_index(mesh)
    xs, ts = _rows(x, n, i), _rows(tgt, n, i)
    if seq_dim is not None:  # this sp rank's chunk of the sequence
        sp = mesh.get_group("sp").size()
        xs = torch.chunk(xs, sp, dim=seq_dim)[c["sp"]].contiguous()
        ts = torch.chunk(ts, sp, dim=seq_dim)[c["sp"]].contiguous()
    pp = plugin.get("pp_size", 1)
    if feed == "boundary":  # data only where it is read
        xs = xs if c["pp"] == 0 else None
        ts = ts if c["pp"] == pp - 1 else None
    held = sum(t.numel() * t.element_size() for t in (xs, ts) if t is not None)
    info: dict[str, Any] = {}
    params = _stage_params(stack, mesh)
    loss, grads = pipeline_train_step(make_block(mesh), mse, params, xs, ts, mesh=mesh,
                                      num_micro_batches=plugin["num_micro_batches"],
                                      _stats=info)
    _save(out_dir, f"{name}_{_rank()}.pt",
          {"loss": float(loss), "stage": c["pp"], "grads": _local(grads), "held": held,
           "coord": c, "stats": info, "types": {k: type(v).__name__ for k, v in grads.items()}})


def _memory(out_dir: str, inp: dict) -> None:
    """GPipe + autograd against 1F1B at M 32, S 2: the bytes autograd
    keeps at their peak (and, for 1F1B, the schedule's input ring)."""
    from accelerate_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_train_step

    M = 32
    mesh = _mesh(dict(dp_size=2, pp_size=2, sharding_strategy="no_shard",
                      num_micro_batches=M))
    n, i = _data_index(mesh)
    x, t = _rows(inp["mem_x"], n, i), _rows(inp["mem_t"], n, i)
    stack = {"w": inp["mem_w"]}
    ps = {k: v.requires_grad_(True) for k, v in _local(_stage_params(stack, mesh)).items()}
    gp = SavedBytes()
    with gp.hooks():
        y = pipeline_apply(tanh_block, ps, x, mesh=mesh, num_micro_batches=M)
        loss = ((y - t) ** 2).mean()
    torch.autograd.grad(loss, list(ps.values()))
    del y, loss
    f1 = SavedBytes()
    info: dict = {}
    c = _coord(mesh)
    with f1.hooks():
        pipeline_train_step(tanh_block, mse, _stage_params(stack, mesh),
                            x if c["pp"] == 0 else None, t if c["pp"] == 1 else None,
                            mesh=mesh, num_micro_batches=M, _stats=info)
    _save(out_dir, f"memory_{_rank()}.pt",
          {"gpipe": gp.peak, "f1b_saved": f1.peak, "f1b_ring": info["ring_bytes"],
           "peak_inputs": info["peak_inputs"], "stage": c["pp"]})


def _unified_pipeline(out_dir: str, inp: dict, run: dict) -> None:
    """``unified_pipeline_step`` (pp 2 x dp 2 unless ``plugin`` says) or the
    port's sequential ``unified_step`` (``seq``) over the reference tests'
    batches; see :func:`pipeline_worker`."""
    from accelerate_tpu_torch import adamw, fused_adamw, sgd
    from accelerate_tpu_torch.parallel import pipeline as pl
    from accelerate_tpu_torch.parallel.runtime import gather_full

    plugin = run.get("plugin", dict(dp_size=2, pp_size=2, sharding_strategy="no_shard",
                                    num_micro_batches=4))
    acc = _fresh_accelerator(mixed_precision=run.get("mixed_precision", "no"),
                             parallelism_plugin=_plugin(plugin))
    if run.get("loss_scale") is not None:
        acc.state.mixed_precision_policy.loss_scale_init = run["loss_scale"]
    stack = {"w": inp["w"].clone(), "v": inp["v"].clone()}
    opt = {"sgd": sgd, "adamw": adamw, "fused_adamw": fused_adamw}[run.get("optimizer", "sgd")](
        run.get("lr", 1e-2))
    n, i = acc.state.data_parallel_size, acc.state.data_parallel_rank
    seq = run.get("seq", False)
    if seq:
        params = acc.prepare(stack)
        opt = acc.prepare(opt)
        carry = acc.init_carry(params, opt)

        def loss_fn(p, batch):  # the microbatched mean of means
            xm, tm = batch["x"].reshape(4, -1, 16), batch["y"].reshape(4, -1, 16)
            return torch.stack([mse(toy_block(p, xm[j]), tm[j]) for j in range(4)]).mean()

        step = acc.unified_step(loss_fn, max_grad_norm=run.get("max_grad_norm"))
    else:
        params = _stage_params(stack, acc.mesh)
        opt = acc.prepare(opt)
        carry = acc.init_carry(params, opt)
        step = acc.unified_pipeline_step(toy_block, mse, max_grad_norm=run.get("max_grad_norm"))
    stage = _coord(acc.mesh)["pp"]
    plant = run.get("plant_inf")  # (call, rank): an inf in that rank's gradients
    original = pl.pipeline_train_step
    rng = np.random.default_rng(0)
    losses, norms, finite, held, scales = [], [], [], [], []
    for call in range(run.get("steps", 3)):
        x = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
        y = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
        before = {k: gather_full(v).detach().clone() for k, v in carry["params"].items()}
        if plant is not None and call == plant[0]:
            def planted(*a, **kw):
                loss, grads = original(*a, **kw)
                if _rank() == plant[1]:
                    next(iter(grads.values())).view(-1)[0] = float("inf")
                return loss, grads

            pl.pipeline_train_step = planted
        try:
            if seq:
                carry, m = step(carry, {"x": _rows(x, n, i), "y": _rows(y, n, i)})
            else:
                carry, m = step(carry, _rows(x, n, i) if stage == 0 else None,
                                _rows(y, n, i) if stage == 1 else None)
        finally:
            pl.pipeline_train_step = original
        after = {k: gather_full(v).detach().clone() for k, v in carry["params"].items()}
        held.append(all(torch.equal(before[k], after[k]) for k in before))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        finite.append(bool(m["grads_finite"]))
        scales.append(float(carry["loss_scale"].scale) if "loss_scale" in carry else None)
    final = {k: gather_full(v).detach().clone() for k, v in carry["params"].items()}
    _save(out_dir, f"{run['name']}_{_rank()}.pt",
          {"losses": losses, "norms": norms, "finite": finite, "held": held, "scales": scales,
           "params": final, "dtype": str(next(iter(carry["params"].values())).dtype),
           "opt_step": int(carry["opt_step"]), "acc_step": acc.step})


PIPELINE_RUNS = (
    dict(name="upp_trains", steps=4, max_grad_norm=10.0),
    dict(name="upp_seq", seq=True, steps=4, max_grad_norm=10.0,
         plugin=dict(dp_size=4, sharding_strategy="no_shard", num_micro_batches=4)),
    dict(name="upp_fp16", mixed_precision="fp16", loss_scale=2.0 ** 8, max_grad_norm=10.0),
    dict(name="upp_fp32", max_grad_norm=10.0),
    dict(name="upp_fp16_overflow", mixed_precision="fp16", loss_scale=2.0 ** 20, steps=1,
         max_grad_norm=10.0),
    dict(name="upp_adamw", optimizer="adamw", max_grad_norm=0.5),
    dict(name="upp_fused_adamw", optimizer="fused_adamw", max_grad_norm=0.5),
    dict(name="upp_fp16_planted", mixed_precision="fp16", loss_scale=2.0 ** 8,
         max_grad_norm=10.0, plant_inf=(1, 3)),
)


def pipeline_worker(out_dir: str):
    """Every configuration of ``tests/test_torch_pipeline.py`` at world 4:
    GPipe's forward (M 2 and 4) and gradients, four ``unified_step`` calls
    through GPipe and the plain dp-4 run, ``pp_size=-1``'s validation, 1F1B
    at (pp, tp) = (2, 1), (4, 1), (2, 2), composed with sp ring attention
    and with ep ragged MoE, at pp 1, the memory and feed cases, and the
    ``unified_pipeline_step`` runs of :data:`PIPELINE_RUNS`."""
    torch.set_num_threads(1)
    inp = _inputs(out_dir)
    _gpipe(out_dir, inp)
    _unified_gpipe(out_dir, inp)
    _validation(out_dir)
    toy = {"w": inp["w"], "v": inp["v"]}
    for pp, tp in ((2, 1), (4, 1), (2, 2)):
        _f1b_case(out_dir, f"f1b_pp{pp}_tp{tp}",
                  dict(dp_size=4 // (pp * tp), pp_size=pp, tp_size=tp,
                       sharding_strategy="no_shard", num_micro_batches=4),
                  lambda mesh: toy_block, toy, inp["x"], inp["tgt"])
    _f1b_case(out_dir, "f1b_sp", dict(dp_size=1, pp_size=2, sp_size=2,
                                      sharding_strategy="no_shard", num_micro_batches=4),
              lambda mesh: attn_block(mesh, 2, 8), toy, inp["sp_x"], inp["sp_tgt"], seq_dim=1)
    moe_stack = {k: inp[f"moe_{k}"] for k in ("router", "wg", "wu", "wd")}
    _f1b_case(out_dir, "f1b_ep", dict(dp_size=1, pp_size=2, ep_size=2,
                                      sharding_strategy="no_shard", num_micro_batches=4),
              lambda mesh: moe_block(mesh, 2, 2.0), moe_stack, inp["x"], inp["tgt"])
    _f1b_case(out_dir, "f1b_single", dict(dp_size=4, sharding_strategy="no_shard",
                                          num_micro_batches=2),
              lambda mesh: toy_block, toy, inp["x"][:8], inp["tgt"][:8])
    _memory(out_dir, inp)
    for feed in ("boundary", "replicated"):
        _f1b_case(out_dir, f"feed_{feed}", dict(dp_size=1, pp_size=4, sharding_strategy="no_shard",
                                                num_micro_batches=32),
                  lambda mesh: tanh_block, {"w": inp["feed_w"]}, inp["feed_x"], inp["feed_t"],
                  feed=feed)
    for run in PIPELINE_RUNS:
        _unified_pipeline(out_dir, inp, run)


# ---------------------------------------------------------------------- #
# test_torch_ring_attention.py
# ---------------------------------------------------------------------- #
def _qkv(S=64, B=4, H=4, Hkv=2, D=16, seed=0):
    """The reference test's q, k, v (numpy's generator)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def _seq_chunk(x: torch.Tensor, mesh) -> torch.Tensor:
    sp = mesh.get_group("sp").size()
    return torch.chunk(x, sp, dim=1)[_coord(mesh)["sp"]].contiguous()


def ring_worker(out_dir: str):
    """Ring attention at sp 4 (world 4): each rank's output chunk, causal
    and not, and its chunks' gradients of sum(out**2); then the sp-1
    fallback on a dp-4 mesh, and the refusals of masks and windows."""
    from accelerate_tpu_torch.ops.attention import dot_product_attention
    from accelerate_tpu_torch.ops.ring_attention import ring_attention

    torch.set_num_threads(1)
    rank = _rank()
    mesh = _mesh(dict(dp_size=1, sp_size=4))
    q, k, v = _qkv()
    rec = {"sp": _coord(mesh)["sp"]}
    for causal in (True, False):
        rec[f"out_{causal}"] = ring_attention(*(_seq_chunk(t, mesh) for t in (q, k, v)),
                                              causal=causal, mesh=mesh)
    q, k, v = _qkv(S=32, B=2)
    chunks = [_seq_chunk(t, mesh).requires_grad_(True) for t in (q, k, v)]
    loss = (ring_attention(*chunks, causal=True, mesh=mesh) ** 2).sum()
    rec["grads"] = torch.autograd.grad(loss, chunks)
    # an sp-1 mesh runs the plain attention of the whole sequence
    flat = _mesh(dict(dp_size=4))
    rec["fallback"] = ring_attention(q, k, v, causal=True, mesh=flat)
    refused = {}
    for name, kw in (("mask", dict(mask=torch.ones(2, 1, 1, 32, dtype=torch.bool))),
                     ("window", dict(window=8))):
        try:
            dot_product_attention(q, k, v, causal=True, implementation="ring", **kw)
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    rec["refused"] = refused
    _save(out_dir, f"ring_{rank}.pt", rec)


def ring_long_worker(out_dir: str, seq: int):
    """The long-sequence proof point: a causal ring of ``seq`` tokens over sp
    4 with the dense path made to raise; each rank writes its output
    chunk."""
    from accelerate_tpu_torch.ops import attention as attn_mod
    from accelerate_tpu_torch.ops.ring_attention import ring_attention

    torch.set_num_threads(1)
    mesh = _mesh(dict(dp_size=1, sp_size=4))
    data = np.load(os.path.join(out_dir, "long.npz"))
    q, k, v = (_seq_chunk(torch.from_numpy(data[n]), mesh) for n in ("q", "k", "v"))

    def no_dense(*a, **kw):
        raise AssertionError("ring_attention took the dense fallback")

    attn_mod.xla_attention = no_dense
    with torch.no_grad():
        out = ring_attention(q, k, v, causal=True, mesh=mesh)
    _save(out_dir, f"long_{_rank()}.pt", {"sp": _coord(mesh)["sp"], "out": out})


# ---------------------------------------------------------------------- #
# test_torch_moe.py and test_torch_sequence_expert_models.py
# ---------------------------------------------------------------------- #
def _full(grads: dict, params: dict) -> dict:
    """Gradients of this rank's shards as whole tensors (gathered over the
    mesh by the params' placements)."""
    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch.parallel.runtime import gather_full
    from accelerate_tpu_torch.parallel.sharding import is_dtensor

    out = {}
    for k, g in grads.items():
        p = params[k]
        if is_dtensor(p):
            g = gather_full(DTensor.from_local(g.contiguous(), p.device_mesh, p.placements,
                                               run_check=False, shape=p.shape,
                                               stride=p.stride()))
        out[k] = g.detach().clone()
    return out


def _sharded_model_pass(out_dir: str, plugin: dict, config: dict, init_file: str, ids,
                        grads: bool = True) -> dict:
    """A port CausalLM prepared under ``plugin``, this rank's rows of
    ``ids`` through it inside the layout's forward context: its logits, the
    whole gradients of mean(logits**2) over the global batch (the data
    ranks' mean), the experts' specs."""
    from accelerate_tpu_torch import CausalLM, TransformerConfig
    from accelerate_tpu_torch.parallel.sharding import shardings_of

    acc = _fresh_accelerator(parallelism_plugin=_plugin(plugin))
    model = CausalLM(TransformerConfig.tiny(**config), device="cpu")
    model.load_state_dict(torch.load(os.path.join(out_dir, init_file)))
    model = acc.prepare(model)
    lay = acc._layout
    params = dict(model.named_parameters())
    n, i = acc.state.data_parallel_size, acc.state.data_parallel_rank
    compute = {k: v.detach().requires_grad_(True) for k, v in lay.local(params).items()}
    with lay.forward_context():
        logits = torch.func.functional_call(model, lay.loss_params(compute), (_rows(ids, n, i),))
        loss = (logits.float() ** 2).mean()
        got = torch.autograd.grad(loss, list(compute.values())) if grads else None
    rec = {"data_rank": i, "logits": logits.detach(),
           "specs": {k: v for k, v in shardings_of(params).items() if "moe" in k}}
    if grads:
        reduced = lay.reduce_grads_({k: g.clone() for k, g in zip(compute, got)})
        rec["grads"] = _full(reduced, params)
    return rec


MOE_EP = dict(dp_size=2, ep_size=2, sharding_strategy="no_shard")


def moe_worker(out_dir: str):
    """The sharded MoE cases at dp 2 x ep 2 (world 4): the tiny MoE model
    under the dense oracle and the shard-capacity schedule at
    capacity_factor 2 (== ep), "auto", "ragged" and "capacity" at 1.0, and
    ``moe_ragged_ep`` called alone on routing that overflows shard 0."""
    from accelerate_tpu_torch.ops.moe import moe_ragged_ep

    torch.set_num_threads(1)
    inp = _inputs(out_dir)
    ids = inp["ids"].long()
    base = dict(num_experts=4, num_experts_per_tok=2)
    for name, over in (("dense", dict(moe_dispatch="dense")),
                       ("ragged", dict(moe_dispatch="ragged", moe_capacity_factor=2.0)),
                       ("auto_cf1", dict(moe_dispatch="auto", moe_capacity_factor=1.0)),
                       ("ragged_cf1", dict(moe_dispatch="ragged", moe_capacity_factor=1.0)),
                       ("capacity_cf1", dict(moe_dispatch="capacity", moe_capacity_factor=1.0))):
        rec = _sharded_model_pass(out_dir, MOE_EP, {**base, **over}, "init_moe.pt", ids,
                                  grads=name in ("dense", "ragged", "capacity_cf1"))
        _save(out_dir, f"moe_{name}_{_rank()}.pt", rec)
    mesh = _mesh(MOE_EP)
    n, i = _data_index(mesh)
    x = _rows(inp["drop_x"], n, i)
    sel = torch.zeros(x.shape[0], 2, dtype=torch.long)
    sel[:, 1] = 1  # every token picks experts 0 and 1, both shard 0's
    out = moe_ragged_ep(x, sel, torch.full((x.shape[0], 2), 0.5), inp["drop_wg"],
                        inp["drop_wu"], inp["drop_wd"], mesh=mesh, capacity_factor=1.0)
    _save(out_dir, f"moe_drop_{_rank()}.pt", {"data_rank": i, "out": out})


def models_worker(out_dir: str, runs: list):
    """The model cases of ``test_torch_sequence_expert_models.py`` at world
    4: one sgd step of the tiny LM with ring attention at dp 2 x sp 2 and
    of the plain model at dp 4 on the reference's batch; the MoE model's
    expert placement and logits at dp 2 x ep 2; then the fp32 parity
    ``runs`` of ``sharding_workers.train_runs_worker``."""
    from accelerate_tpu_torch import CausalLM, TransformerConfig, sgd
    from accelerate_tpu_torch.parallel.runtime import gather_full

    from .sharding_workers import _train_run

    torch.set_num_threads(1)
    inp = _inputs(out_dir)
    ids = inp["sp_ids"].long()
    for name, plugin, impl in (("sp_ring", dict(dp_size=2, sp_size=2), "ring"),
                               ("sp_dp4", dict(dp_size=4), None)):
        acc = _fresh_accelerator(parallelism_plugin=_plugin(plugin))
        model = CausalLM(TransformerConfig.tiny(num_layers=2, max_seq_len=64,
                                                attention_impl=impl), device="cpu")
        model.load_state_dict(torch.load(os.path.join(out_dir, "init_sp.pt")))
        model, opt = acc.prepare(model, sgd(0.1))
        carry = acc.init_carry(model, opt)
        step = acc.unified_step(CausalLM.loss_fn(model))
        n, i = acc.state.data_parallel_size, acc.state.data_parallel_rank
        carry, m = step(carry, {"input_ids": _rows(ids, n, i)})
        params = {k: gather_full(v).detach().clone() for k, v in carry["params"].items()}
        if _rank() == 0:
            _save(out_dir, f"{name}_0.pt", {"loss": float(m["loss"]), "params": params})
    rec = _sharded_model_pass(out_dir, dict(dp_size=2, ep_size=2, fsdp_size=1),
                              dict(num_experts=4, num_experts_per_tok=2), "init_moe.pt",
                              inp["ep_ids"].long(), grads=False)
    _save(out_dir, f"moe_model_{_rank()}.pt", rec)
    for run in runs:
        _train_run(out_dir, run)


# ---------------------------------------------------------------------- #
# test_torch_dist_checkpoint.py: a pp 2 x ep 2 checkpoint
# ---------------------------------------------------------------------- #
PP_EP_SPECS = {"stack.bias": ("pp", None), "moe.gate_proj": ("ep", None, None),
               "norm.weight": (None,)}


def pp_ep_tree() -> dict:
    """A stacked pipeline leaf (4 layers over pp), an expert stack (4
    experts over ep) and a whole leaf, in the port's names of the
    reference's ``stack/bias``, ``moe/gate_proj`` and ``norm/scale``."""
    gen = torch.Generator().manual_seed(3)
    return {"stack.bias": torch.randn(4, 16, generator=gen),
            "moe.gate_proj": torch.randn(4, 16, 8, generator=gen),
            "norm.weight": torch.randn(16, generator=gen)}


def pp_ep_checkpoint_worker(out_dir: str):
    """At pp 2 x ep 2 (world 4): the tree placed by :data:`PP_EP_SPECS`, one
    AdamW step, then ``save_state``; process 0 writes the whole carry and
    the path (``ppep.pt``)."""
    from accelerate_tpu_torch import adamw
    from accelerate_tpu_torch.parallel.runtime import gather_full
    from accelerate_tpu_torch.parallel.sharding import shard_params

    torch.set_num_threads(1)
    acc = _fresh_accelerator(parallelism_plugin=_plugin(dict(dp_size=1, pp_size=2, ep_size=2,
                                                             num_micro_batches=2)))
    params = shard_params(pp_ep_tree(), PP_EP_SPECS, acc.mesh)
    opt = acc.prepare(adamw(1e-2))
    carry = acc.init_carry(params, opt)
    step = acc.unified_step(lambda p, b: sum((v ** 2).mean() for v in p.values()))
    carry, _ = step(carry, {"x": torch.ones(2, 1)})
    path = acc.save_state(os.path.join(out_dir, "ppep"), carry=carry)
    whole = {"params": {k: gather_full(v).clone() for k, v in carry["params"].items()},
             "mu": {k: gather_full(v).clone() for k, v in carry["opt_state"]["mu"].items()},
             "nu": {k: gather_full(v).clone() for k, v in carry["opt_state"]["nu"].items()}}
    if _rank() == 0:
        _save(out_dir, "ppep.pt", {"path": path, "whole": whole})
    acc.wait_for_everyone()
