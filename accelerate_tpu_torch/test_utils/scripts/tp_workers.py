"""Worker functions of the tests of the sharded paths that run under tensor
parallelism and beside it: decoding a sharded model, LoRA adapters and MoE
experts under tp, the capacity dispatch under ep x sp, ZeRO-1/2 at
fsdp x tp, the raw loop on DTensor params, and tp sizes that cut heads or
kv groups. Run under ``launchers.debug_launcher`` on the CPU over gloo.

Each worker runs every case of its file in one process group (a fresh
``AcceleratorState`` a case, the group kept) and process 0 writes each
case's record, ``<name>.pt``, into the directory the parent reads; the
parent runs the same case function at world 1, in its own process, for
the unsharded record. Inputs come from ``inputs.npz`` and the weights from
the ``.pt`` files the parent wrote there. They import torch and the port
only, and set one torch thread a process.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .sharding_workers import _fresh_accelerator, _plugin, _save


def _inputs(out_dir: str) -> dict:
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    return {k: torch.from_numpy(data[k].copy()) for k in data.files}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _done(acc, out_dir: str, name: str, rec: dict) -> None:
    if _rank() == 0:
        _save(out_dir, f"{name}.pt", rec)
    if acc.state.num_processes > 1:
        acc.wait_for_everyone()


def _model(out_dir: str, case: dict):
    """The case's tiny ``CausalLM`` (``TransformerConfig.tiny`` with its
    ``config``) with the weights of ``out_dir/<init>`` (without one, its
    own init from seed 0)."""
    from accelerate_tpu_torch import CausalLM, TransformerConfig

    model = CausalLM(TransformerConfig.tiny(**case.get("config", {})), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    if "init" in case:
        model.load_state_dict(torch.load(os.path.join(out_dir, case["init"])))
    return model


def _rows(x: torch.Tensor, acc) -> torch.Tensor:
    """This process's rows of a global batch (the data-parallel ranks')."""
    n, i = acc.state.data_parallel_size, acc.state.data_parallel_rank
    step = x.shape[0] // n
    return x[i * step:(i + 1) * step]


def _whole(tree: dict) -> dict:
    from accelerate_tpu_torch.parallel.runtime import gather_full

    return {k: gather_full(v).detach().clone() for k, v in tree.items()}


# ---------------------------------------------------------------------- #
# decoding
# ---------------------------------------------------------------------- #
def _decode_logits(model, prompt: torch.Tensor, new: int) -> list:
    """The prefill's logits and each greedy decode step's, on the dense
    cache through ``generation``'s forward (inside the sharded context for
    a sharded model)."""
    from accelerate_tpu_torch.models import generation

    forward = generation._forward(model)
    cache = generation.init_cache(model, prompt.shape[0])
    with torch.no_grad():
        out = [forward(prompt, cache)]
        token = out[-1][:, -1].argmax(-1)
        for _ in range(new - 1):
            out.append(forward(token[:, None], cache))
            token = out[-1][:, -1].argmax(-1)
    return [t.detach().clone() for t in out]


_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather", "reduce_scatter_tensor",
                "broadcast", "all_to_all_single", "send", "recv")


def _decode_step_collectives(model, prompt: torch.Tensor) -> list:
    """Every collective one decode step issues after the prefill: its name,
    its group's ranks and the shape of the tensor it sends."""
    import torch.distributed as dist

    from accelerate_tpu_torch.models import generation

    forward = generation._forward(model)
    cache = generation.init_cache(model, prompt.shape[0])
    seen = []
    originals = {n: getattr(dist, n) for n in _COLLECTIVES}

    def recorded(name, fn):
        def call(*args, **kwargs):
            group = kwargs.get("group")
            ranks = tuple(dist.get_process_group_ranks(group if group is not None
                                                       else dist.group.WORLD))
            sent = args[1] if name in ("all_gather_into_tensor", "reduce_scatter_tensor",
                                       "all_gather") else args[0]
            seen.append((name, ranks, tuple(sent.shape)))
            return fn(*args, **kwargs)

        return call

    with torch.no_grad():
        token = forward(prompt, cache)[:, -1].argmax(-1)
        for name in _COLLECTIVES:
            setattr(dist, name, recorded(name, originals[name]))
        try:
            forward(token[:, None], cache)
        finally:
            for name, fn in originals.items():
                setattr(dist, name, fn)
    return seen


def decode_case(out_dir: str, case: dict) -> None:
    """One decode case: the tiny model prepared under ``case["plugin"]``
    (None: unsharded, at world 1), greedy ``generate`` of ``new`` tokens from
    ``inputs.npz[prompt]``; with ``logits`` the prefill's and each step's
    logits; with ``lengths`` ``make_generate_fn``'s tokens for the prompts
    ``len<n>`` and its ``trace_counts``; with ``count`` the collectives of
    one decode step, the tp group's ranks and every tp-split weight's local
    shape; with ``train`` one sgd step (0.5) of ``CausalLM.loss_fn`` on the
    global batch ``inputs.npz[train]``: its loss and the whole params."""
    from accelerate_tpu_torch import CausalLM, sgd
    from accelerate_tpu_torch.models import generation
    from accelerate_tpu_torch.parallel.runtime import to_local

    inp = _inputs(out_dir)
    acc = _fresh_accelerator(parallelism_plugin=_plugin(case.get("plugin")))
    model = acc.prepare(_model(out_dir, case))
    prompt = inp[case.get("prompt", "prompt")].long()
    new = case.get("new", 6)
    rec = {"tokens": generation.generate(model, prompt, max_new_tokens=new)}
    if case.get("logits"):
        rec["logits"] = _decode_logits(model, prompt, new)
    if case.get("lengths"):
        fn = generation.make_generate_fn(model, max_new_tokens=4)
        rec["fn_tokens"] = [fn(inp[f"len{n}"].long()) for n in case["lengths"]]
        rec["trace_counts"] = fn.trace_counts()
    if case.get("count"):
        rec["collectives"] = _decode_step_collectives(model, prompt)
        rec["tp_ranks"] = tuple(torch.distributed.get_process_group_ranks(
            acc.mesh.get_group("tp")))
        rec["local_shapes"] = {k: tuple(to_local(v).shape)
                               for k, v in model.named_parameters()}
    if case.get("train"):
        opt = acc.prepare(sgd(0.5))
        carry = acc.init_carry(model, opt)
        step = acc.unified_step(CausalLM.loss_fn(model))
        carry, metrics = step(carry, {"input_ids": _rows(inp[case["train"]].long(), acc)})
        rec["loss"] = float(metrics["loss"])
        rec["params"] = acc.get_state_dict(model)
    _done(acc, out_dir, case["name"], rec)


def refusal_case(out_dir: str, case: dict) -> None:
    """A configuration the port refuses: the error that preparing the
    model and decoding under ``case["plugin"]`` raised."""
    from accelerate_tpu_torch.models import generation

    acc = _fresh_accelerator(parallelism_plugin=_plugin(case["plugin"]))
    try:
        model = acc.prepare(_model(out_dir, case))
        generation.generate(model, torch.zeros(2, 4, dtype=torch.long), max_new_tokens=1)
        rec = {"error": None}
    except Exception as e:  # noqa: BLE001 - the test reads which error it was
        rec = {"error": f"{type(e).__name__}: {e}"}
    _done(acc, out_dir, case["name"], rec)


def decode_worker(out_dir: str, cases: list) -> None:
    torch.set_num_threads(1)
    for case in cases:
        (refusal_case if case.get("refuse") else decode_case)(out_dir, case)


# ---------------------------------------------------------------------- #
# LoRA and MoE under tp, capacity under ep x sp
# ---------------------------------------------------------------------- #
def _adapter_tree(out_dir: str, name: str) -> dict:
    data = np.load(os.path.join(out_dir, name))
    tree: dict = {}
    for key in data.files:
        target, leaf = key.split("/")
        tree.setdefault(target, {})[leaf] = torch.from_numpy(data[key].copy())
    return tree


def lora_case(out_dir: str, case: dict) -> None:
    """LoRA over the tiny model prepared under ``case["plugin"]``: the
    adapter ``out_dir/<adapter>`` (its targets ``targets``, rank ``rank``),
    prepared beside it; the adapter gradients of the first global batch
    (the mean over the token ranks, as the step takes them), then ``steps``
    adamw (1e-2, clip 1.0) steps of ``unified_step`` over
    ``inputs.npz[lora_ids]``: the losses, grad norms and the whole adapter."""
    from accelerate_tpu_torch import adamw
    from accelerate_tpu_torch.accelerator import _flat_params, _like_tree
    from accelerate_tpu_torch.adapters import LoraConfig, lora_loss_fn

    inp = _inputs(out_dir)
    acc = _fresh_accelerator(parallelism_plugin=_plugin(case.get("plugin")))
    model = _model(out_dir, case)
    model.requires_grad_(False)
    model = acc.prepare(model)
    lcfg = LoraConfig(rank=case["rank"], alpha=2.0 * case["rank"],
                      target_modules=tuple(case["targets"]))
    adapter, opt = acc.prepare(_adapter_tree(out_dir, case["adapter"]), adamw(1e-2))
    fn = lora_loss_fn(model, model, lcfg)
    ids = inp["lora_ids"].long()
    lay = acc._layout if acc.state.parallelism_plugin is not None else None
    flat = _flat_params(adapter)
    local = {k: (v if lay is None else lay.local({k: v})[k]).detach().requires_grad_(True)
             for k, v in flat.items()}
    context = lay.forward_context() if lay is not None else torch.enable_grad()
    with context:
        seen = local if lay is None else lay.loss_params(local)
        loss = fn(_like_tree(adapter, seen), {"input_ids": _rows(ids[0], acc)})
        grads = dict(zip(local, torch.autograd.grad(loss, list(local.values()))))
    if lay is not None:
        from accelerate_tpu_torch.parallel.runtime import place_like

        grads = _whole(place_like(lay.reduce_grads_(grads, placed=True), flat))
    step = acc.unified_step(fn, max_grad_norm=1.0)
    carry = acc.init_carry(adapter, opt)
    losses, norms = [], []
    for batch in ids:
        carry, metrics = step(carry, {"input_ids": _rows(batch, acc)})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    _done(acc, out_dir, case["name"], {"grads": grads, "losses": losses, "norms": norms,
                                       "adapter": _whole(_flat_params(adapter))})


def moe_case(out_dir: str, case: dict) -> None:
    """The tiny MoE model prepared under ``case["plugin"]``: the logits of
    this rank's rows of ``inputs.npz[moe_ids]`` (under sp with ring
    attention its sequence chunk, with the rank's place), and one sgd step
    (0.5) of ``CausalLM.loss_fn``: its loss and the whole params (so every
    gradient, the router's and each expert stack's, times 0.5)."""
    from accelerate_tpu_torch import CausalLM, sgd
    from accelerate_tpu_torch.parallel.mesh import mesh_coordinate, mesh_shape_of

    inp = _inputs(out_dir)
    acc = _fresh_accelerator(parallelism_plugin=_plugin(case.get("plugin")))
    model = acc.prepare(_model(out_dir, case))
    params = dict(model.named_parameters())
    lay = acc._layout if acc.state.parallelism_plugin is not None else None
    rows = _rows(inp["moe_ids"].long(), acc)
    with torch.no_grad():
        if lay is None:
            logits = model(rows)
            place = {"data_rank": 0, "sp_rank": 0}
        else:
            with lay.forward_context():
                logits = torch.func.functional_call(model, lay.loss_params(lay.local(params)),
                                                    (rows,))
            coord = mesh_coordinate(_rank(), mesh_shape_of(acc.mesh))
            place = {"data_rank": acc.state.data_parallel_rank, "sp_rank": coord["sp"]}
    everyone = [{**place, "logits": logits.clone()}]
    if acc.state.num_processes > 1:
        everyone = [None] * acc.state.num_processes
        torch.distributed.all_gather_object(everyone, {**place, "logits": logits})
    opt = acc.prepare(sgd(0.5))
    carry = acc.init_carry(model, opt)
    step = acc.unified_step(CausalLM.loss_fn(model))
    carry, metrics = step(carry, {"input_ids": rows})
    _done(acc, out_dir, case["name"], {"ranks": everyone, "loss": float(metrics["loss"]),
                                       "params": acc.get_state_dict(model)})


def adapters_experts_worker(out_dir: str, lora_cases: list, moe_cases: list) -> None:
    torch.set_num_threads(1)
    for case in lora_cases:
        lora_case(out_dir, case)
    for case in moe_cases:
        moe_case(out_dir, case)


# ---------------------------------------------------------------------- #
# ZeRO-1/2 at fsdp x tp, and the raw loop on DTensor params
# ---------------------------------------------------------------------- #
def raw_loop_case(out_dir: str, case: dict) -> None:
    """The raw loop over the tiny LM (``test_utils.training.TINY_LM``,
    weights ``out_dir/<init>``) prepared under ``case["plugin"]`` with
    accumulation ``accum``: ``accumulate``, ``backward``, the sum of the
    microbatches' gradients, ``clip_grad_norm_`` (1.0) and the optimizer's
    ``step`` on each boundary, over ``MaskedTokens`` global batches of
    ``rows``. Records each microbatch's loss, each boundary's norm, whether
    every clipped gradient was split as its param (on the mesh's axes above
    1) and the whole final params."""
    from accelerate_tpu_torch import CausalLM, DataLoader, TransformerConfig, adamw, sgd
    from accelerate_tpu_torch.parallel.runtime import live_submesh
    from accelerate_tpu_torch.parallel.sharding import is_dtensor
    from accelerate_tpu_torch.test_utils.training import TINY_LM, MaskedTokens

    def placed_as_params(grads) -> bool:
        for k, g in grads.items():
            p = params[k]
            if not is_dtensor(p):
                return not is_dtensor(g)
            _, dims = live_submesh(p.device_mesh)
            want = tuple(p.placements[d] for d in dims if p.device_mesh.size(d) > 1)
            if tuple(x for x in g.placements if not x.is_replicate()) != tuple(
                    x for x in want if not x.is_replicate()) or g.shape != p.shape:
                return False
        return True

    accum = case.get("accum", 2)
    acc = _fresh_accelerator(parallelism_plugin=_plugin(case.get("plugin")),
                             gradient_accumulation_steps=accum)
    model = CausalLM(TransformerConfig(**TINY_LM), device="cpu")
    model.load_state_dict(torch.load(os.path.join(out_dir, case["init"])))
    rows = case.get("rows", 8)
    data = MaskedTokens(rows * accum * case.get("steps", 2), rows // 2)
    optimizer = (sgd(0.5) if case.get("optimizer", "sgd") == "sgd"
                 else adamw(1e-2, eps=case.get("eps", 1e-8)))
    model, opt, loader = acc.prepare(model, optimizer,
                                     DataLoader(data, batch_size=rows // acc.state.data_parallel_size))
    params = dict(model.named_parameters())
    loss_fn = CausalLM.loss_fn(model)
    total, losses, norms, placed = None, [], [], []
    for batch in loader:
        with acc.accumulate(model):
            loss, grads = acc.backward(loss_fn, params, batch)
            losses.append(float(loss))
            total = grads if total is None else {k: total[k] + g for k, g in grads.items()}
            if acc.sync_gradients:
                total, norm = acc.clip_grad_norm_(total, 1.0)
                norms.append(float(norm))
                placed.append(placed_as_params(total))
                opt.step(params, total)
                total = None
    # the gradients' mesh is the live sub-mesh: a DTensor update that mixes
    # them with the params raises, one on the local tensors runs
    mixed = None
    k = "layers.0.attn.q_proj.weight"
    if is_dtensor(params[k]):
        try:
            params[k] - 0.5 * grads[k]
        except RuntimeError as e:
            mixed = str(e)
        torch.sub(params[k].to_local(), grads[k].to_local(), alpha=0.5)
    _done(acc, out_dir, case["name"], {"losses": losses, "norms": norms, "placed": placed,
                                       "mixed": mixed, "params": acc.get_state_dict(model)})


def optim_worker(out_dir: str, runs: list, raw_cases: list) -> None:
    """``runs`` through ``sharding_workers._train_run`` (a run with ``save``
    also saves its final carry with ``save_state``), then ``raw_cases``."""
    from .sharding_workers import _train_run

    torch.set_num_threads(1)
    for run in runs:
        _train_run(out_dir, run)
    for case in raw_cases:
        raw_loop_case(out_dir, case)


# ---------------------------------------------------------------------- #
# tp 2 at world 2: what computes under a size-2 TensorParallel
# ---------------------------------------------------------------------- #
def tp_compute_case(out_dir: str, tp_size: int) -> None:
    """At ``tp_size`` (2 over gloo, or 1 unsharded): the tiny MoE model's
    logits, greedy decoding of the dense one by ``generate`` and by the
    serving engine (int8 KV), and a LoRA loss over it on q/v/o/gate/down;
    ``out_dir/tp<tp_size>.pt``."""
    from accelerate_tpu_torch import CausalLM, TransformerConfig
    from accelerate_tpu_torch.adapters import LoraConfig, init_adapter, lora_loss_fn
    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.parallel.runtime import apply_sharded
    from accelerate_tpu_torch.serving import ServingEngine

    plugin = dict(dp_size=1, tp_size=tp_size) if tp_size > 1 else None
    ids = torch.randint(0, 1024, (2, 8), generator=torch.Generator().manual_seed(0))
    rec = {}
    acc = _fresh_accelerator(parallelism_plugin=_plugin(plugin))
    moe = acc.prepare(CausalLM(TransformerConfig.tiny(num_layers=1, num_experts=4,
                                                      num_experts_per_tok=2),
                               device="cpu", generator=torch.Generator().manual_seed(0)))
    rec["moe"] = apply_sharded(moe, ids)
    acc = _fresh_accelerator(parallelism_plugin=_plugin(plugin))
    cfg = TransformerConfig.tiny(num_layers=1, num_kv_heads=2)
    dense = acc.prepare(CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    rec["tokens"] = generate(dense, ids[:, :4], max_new_tokens=3)
    rec["engine_tokens"] = ServingEngine(dense, max_slots=2, block_size=8).generate(
        ids[:, :4], max_new_tokens=3)
    rec["int8_engine_tokens"] = ServingEngine(dense, max_slots=2, block_size=8,
                                              kv_dtype="int8").generate(ids[:, :4],
                                                                        max_new_tokens=3)
    lcfg = LoraConfig(rank=2, target_modules=("q_proj", "v_proj", "o_proj", "gate_proj",
                                              "down_proj"))
    adapter = init_adapter(torch.Generator().manual_seed(1), cfg, lcfg)
    for pair in adapter.values():  # a nonzero B, so every delta counts
        pair["lora_b"].normal_(0.0, 0.02, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        rec["lora_loss"] = float(lora_loss_fn(dense, dense, lcfg)(adapter, {"input_ids": ids}))
    _done(acc, out_dir, f"tp{tp_size}", rec)


def tp_compute_worker(out_dir: str) -> None:
    torch.set_num_threads(1)
    tp_compute_case(out_dir, 2)
