"""Worker functions of the tests of the serving engine over a sharded model
and of QLoRA over a sharded quantized base. Run under
``launchers.debug_launcher`` on the CPU over gloo.

Each worker runs every case of its file in one process group (a fresh
``AcceleratorState`` a case, the group kept). A case's record holds what
every rank saw where the test compares ranks (gathered to process 0, which
writes ``<name>.pt`` into the directory the parent reads); the parent runs
the same case function at world 1 for the unsharded record. Weights come
from the ``.pt`` files and adapters from the ``.npz`` files the parent
wrote there. They import torch and the port only, and set one torch thread
a process.
"""

from __future__ import annotations

import os

import torch

from .sharding_workers import _fresh_accelerator, _plugin
from .tp_workers import _adapter_tree, _done, _model, _whole


def _everyone(value) -> list:
    """``value`` of every rank, in rank order (this one's alone at world 1)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


class _Preempts:
    """A telemetry stand-in that keeps the preemption records' swap bytes,
    with a buffer census."""

    def __init__(self):
        from accelerate_tpu_torch.profiling.census import BufferCensus

        self.swap_bytes = []
        self.census = BufferCensus()

    def record_preempt(self, **fields):
        self.swap_bytes.append(int(fields["swap_bytes"]))


def _prepared(out_dir: str, case: dict):
    """The case's model prepared under ``case["plugin"]`` (None: a plain
    model), and its accelerator."""
    acc = _fresh_accelerator(parallelism_plugin=_plugin(case.get("plugin")))
    model = _model(out_dir, case)
    return acc, (acc.prepare(model) if case.get("plugin") is not None else model)


def _run(engine, requests: list, tables: bool = False) -> dict:
    """Submit ``requests`` ((request_id, prompt, kwargs)), step the engine
    until it drains and return the tokens by request, the events of every
    step and, with ``tables``, the host block tables after each step."""
    for rid, prompt, kw in requests:
        engine.add_request(prompt, request_id=rid, **kw)
    events, seen = [], []
    for _ in range(400):
        if not engine.has_work:
            break
        events.append([(e.request_id, e.token, e.done) for e in engine.step()])
        if tables:
            seen.append(engine._tables.copy())
    assert not engine.has_work, "the engine did not drain"
    return {"tokens": {rid: engine.result(rid) for rid, _, _ in requests},
            "events": events, "tables": seen}


def _recording(engine) -> dict:
    """Keep the logits of every prefill call and decode step the engine
    makes."""
    seen = {"prefill": [], "decode": []}
    prefill, decode = engine._prefill_call, engine._decode_logits

    def prefill_call(*args, **kwargs):
        table, last = prefill(*args, **kwargs)
        seen["prefill"].append(last.detach().clone())
        return table, last

    def decode_logits(*args, **kwargs):
        out = decode(*args, **kwargs)
        seen["decode"].append(out.detach().clone())
        return out

    engine._prefill_call, engine._decode_logits = prefill_call, decode_logits
    return seen


def _requests(spec: list) -> list:
    return [(rid, list(prompt), dict(kw)) for rid, prompt, kw in spec]


# ---------------------------------------------------------------------- #
# the engine
# ---------------------------------------------------------------------- #
def engine_case(out_dir: str, case: dict) -> None:
    """The serving engine over the tiny model prepared under
    ``case["plugin"]`` (None: unsharded): ``case["engine"]`` its arguments
    (``spec_k``: n-gram speculation at that k, or with ``draft`` a draft
    model of the same weights prepared alike), ``case["requests"]`` its
    traffic, then ``case["again"]`` after it drains (a full-prompt prefix
    hit copies a block on write). Records every rank's events and tables,
    the tokens, ``trace_counts``, the copy-on-write count, swap bytes,
    ``kv_bytes_per_token``; with ``logits`` every prefill's and decode
    step's logits; with ``scales`` the int8 scale arrays after the first
    prefill and at the end."""
    from accelerate_tpu_torch.serving import ServingEngine
    from accelerate_tpu_torch.serving.speculation import SpecConfig

    acc, model = _prepared(out_dir, case)
    kw = dict(case["engine"])
    spec_k = kw.pop("spec_k", None)
    spec = None
    if spec_k and kw.pop("draft", False):  # the same weights, prepared again: a perfect draft
        draft = acc.prepare(_model(out_dir, case)) if case.get("plugin") else _model(out_dir, case)
        spec = SpecConfig(k=spec_k, method="draft_model", draft_model=draft)
    elif spec_k:
        spec = SpecConfig(k=spec_k)
    tele = _Preempts()
    engine = ServingEngine(model, seed=0, telemetry=tele, spec_decode=spec, **kw)
    seen = _recording(engine) if case.get("logits") else None
    scales = []
    if case.get("scales"):
        prefill = engine._prefill_call

        def prefill_call(*args, **kwargs):
            out = prefill(*args, **kwargs)
            if not scales:
                scales.append([t.clone() for t in engine.cache.tensors()[2:]])
            return out

        engine._prefill_call = prefill_call
    run = _run(engine, _requests(case["requests"]), tables=True)
    if case.get("again"):
        again = _run(engine, _requests(case["again"]), tables=True)
        run["tokens"].update(again["tokens"])
        run["events"] += again["events"]
        run["tables"] += again["tables"]
    rec = {"tokens": run["tokens"], "trace_counts": engine.trace_counts(),
           "kv_bytes_per_token": engine.kv_bytes_per_token, "swap_bytes": tele.swap_bytes,
           "preempts": dict(engine._preempt_counts), "resumes": engine._resumes_total,
           "chunks": engine._prefill_chunks_total, "pool": engine.pool.stats(),
           "cow": (engine.prefix_cache.cow_copies_total
                   if engine.prefix_cache is not None else 0),
           "accepted": engine._spec_accepted_total,
           "census": tele.census.sample()["census_owner_bytes"],
           "ranks": _everyone({"events": run["events"], "tables": run["tables"]})}
    if seen is not None:
        rec["logits"] = seen
    if scales:
        rec["scales"] = scales + [[t.clone() for t in engine.cache.tensors()[2:]]]
    _done(acc, out_dir, case["name"], rec)


def handoff_case(out_dir: str, case: dict) -> None:
    """A prefill engine hands its prompts off to a decode engine, one of
    them over the tiny model prepared under ``case["plugin"]`` and the
    other over the plain model (``case["sharded"]``: ``"prefill"`` or
    ``"decode"``), pumped by hand: the decode side's tokens, every
    manifest's ``nbytes``, ``n_blocks`` and ``bytes_per_block`` and both
    engines' ``transfer_gauges``."""
    from accelerate_tpu_torch.serving import ServingEngine

    acc, sharded = _prepared(out_dir, case)
    plain = _model(out_dir, case)
    kw = dict(case["engine"])
    pre = ServingEngine(sharded if case["sharded"] == "prefill" else plain, role="prefill", **kw)
    dec = ServingEngine(sharded if case["sharded"] == "decode" else plain, role="decode", **kw)
    requests = _requests(case["requests"])
    for rid, prompt, rkw in requests:
        pre.add_request(prompt, request_id=rid, **rkw)
    manifests = []
    for _ in range(300):
        if not (pre.has_work or dec.has_work):
            break
        pre.step()
        for m in pre.pop_manifests():
            manifests.append((m.request_id, m.nbytes, m.n_blocks, m.bytes_per_block()))
            dec.acquire(m)
        dec.step()
    rec = {"tokens": {rid: dec.result(rid) for rid, _, _ in requests}, "manifests": manifests,
           "prefill_gauges": pre.transfer_gauges(), "decode_gauges": dec.transfer_gauges(),
           "decode_prefills": dec.trace_counts()["prefill"]}
    _done(acc, out_dir, case["name"], rec)


def tenants_case(out_dir: str, case: dict) -> None:
    """The engine with an adapter registry over the tiny model prepared
    under ``case["plugin"]``: the adapters ``out_dir/<adapters>`` loaded
    (rank ``rank``, targets ``targets``), the requests naming them or none.
    Records the tokens and the registry's stacks, each rank's share placed
    at its bounds and summed over the ranks (whole where each column or row
    has one owner, the tp shares)."""
    from accelerate_tpu_torch.adapters import AdapterRegistry, LoraConfig
    from accelerate_tpu_torch.serving import ServingEngine

    acc, model = _prepared(out_dir, case)
    lcfg = LoraConfig(rank=case["rank"], alpha=2.0 * case["rank"],
                      target_modules=tuple(case["targets"]))
    reg = AdapterRegistry(model.config, capacity=4, max_rank=case["rank"],
                          target_modules=lcfg.target_modules, device="cpu")
    # one tenant resident before the engine splits the stacks, one after
    first, *rest = case["adapters"]
    reg.load(first, _adapter_tree(out_dir, f"{first}.npz"), lcfg)
    engine = ServingEngine(model, adapters=reg, **case["engine"])
    for name in rest:
        reg.load(name, _adapter_tree(out_dir, f"{name}.npz"), lcfg)
    run = _run(engine, _requests(case["requests"]))
    stacks = {}
    for target, pair in reg.stacks().items():
        for leaf, t in pair.items():
            part = None if reg.tp_slices is None else reg.tp_slices[target]
            if part is None or part[0] != leaf:  # whole on every rank
                stacks[f"{target}.{leaf}"] = t.clone()
                continue
            shares = _everyone((part[1], t.clone()))
            dim = t.dim() - 2 if leaf == "lora_a" else t.dim() - 1
            shape = list(t.shape)
            shape[dim] = max(p.stop for p, _ in shares)
            out = torch.zeros(shape, dtype=t.dtype)
            for p, share in shares:
                out.narrow(dim, p.start, p.stop - p.start).copy_(share)
            stacks[f"{target}.{leaf}"] = out
    _done(acc, out_dir, case["name"], {"tokens": run["tokens"], "stacks": stacks,
                                       "split": reg.tp_slices is not None})


def engine_worker(out_dir: str, cases: list) -> None:
    torch.set_num_threads(1)
    runners = {"engine": engine_case, "handoff": handoff_case, "tenants": tenants_case}
    for case in cases:
        runners[case.get("kind", "engine")](out_dir, case)


# ---------------------------------------------------------------------- #
# QLoRA over a sharded quantized base
# ---------------------------------------------------------------------- #
def qlora_case(out_dir: str, case: dict) -> None:
    """LoRA over the tiny model's weights quantized (``bits``, int4 blocks of
    ``block``) whole and then placed by ``Accelerator.prepare`` under
    ``case["plugin"]``: the adapter ``out_dir/<adapter>`` prepared beside
    it; the adapter gradients of the first global batch, then adamw (1e-2,
    eps 1e-3, clip 1.0) steps over the batches of ``inputs.npz[lora_ids]``, their
    losses (the first: the first batch's before any update) and the whole
    adapter. The quantized tree is saved as a
    chunked checkpoint into ``<name>_ckpt`` and restored into a zeroed
    template placed alike: whether every local chunk came back bitwise."""
    from accelerate_tpu_torch import adamw
    from accelerate_tpu_torch import dist_checkpoint
    from accelerate_tpu_torch.accelerator import _flat_params, _like_tree
    from accelerate_tpu_torch.adapters import LoraConfig, lora_loss_fn
    from accelerate_tpu_torch.parallel.runtime import place_like, to_local
    from accelerate_tpu_torch.utils.quantization import (
        QuantizationConfig,
        QuantizedTensor,
        quantize_params,
    )

    from .tp_workers import _inputs, _rows

    inp = _inputs(out_dir)
    acc = _fresh_accelerator(parallelism_plugin=_plugin(case.get("plugin")))
    model = _model(out_dir, case)
    model.requires_grad_(False)
    qcfg = QuantizationConfig(load_in_8bit=case["bits"] == 8, load_in_4bit=case["bits"] == 4,
                              min_weight_size=256, int4_block_size=case.get("block", 64))
    whole = quantize_params(model, qcfg)
    base = acc.prepare(whole, logical_specs=model)
    lay_base = acc._layout if acc.state.parallelism_plugin is not None else None
    lcfg = LoraConfig(rank=case["rank"], alpha=2.0 * case["rank"],
                      target_modules=tuple(case["targets"]))
    # eps 1e-3: at 1e-8 Adam turns the reduction order of a near-zero
    # gradient into a visible step (the sharded optimizer tests' choice)
    adapter, opt = acc.prepare(_adapter_tree(out_dir, case["adapter"]), adamw(1e-2, eps=1e-3))
    fn = lora_loss_fn(model, base, lcfg, compute_dtype=torch.float32)
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
        grads = _whole(place_like(lay.reduce_grads_(grads, placed=True), flat))
    step = acc.unified_step(fn, max_grad_norm=1.0)
    carry = acc.init_carry(adapter, opt)
    losses = []
    for batch in ids:
        carry, metrics = step(carry, {"input_ids": _rows(batch, acc)})
        losses.append(float(metrics["loss"]))
    # the chunked checkpoint of the placed quantized tree, restored in place
    ckpt = os.path.join(out_dir, f"{case['name']}_ckpt")
    dist_checkpoint.save_sharded_tree(base, ckpt)
    if acc.state.num_processes > 1:
        acc.wait_for_everyone()
    template = {k: QuantizedTensor(torch.zeros_like(v.codes), torch.zeros_like(v.scales),
                                   v.bits, v.shape, v.block_size, v.transposed)
                if isinstance(v, QuantizedTensor) else torch.zeros_like(v)
                for k, v in whole.items()}
    template = acc.prepare(template, logical_specs=model)
    dist_checkpoint.load_sharded_tree(template, ckpt)

    def leaves(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, QuantizedTensor):
                out[f"{k}.codes"], out[f"{k}.scales"] = to_local(v.codes), to_local(v.scales)
            else:
                out[k] = to_local(v)
        return out

    got, want = leaves(template), leaves(base)
    restored = all(torch.equal(got[k], want[k]) for k in want)
    split = sorted({k for k, v in base.items() if isinstance(v, QuantizedTensor)
                    and tuple(to_local(v.codes).shape) != tuple(v.codes.shape)})
    _done(acc, out_dir, case["name"], {
        "grads": grads, "losses": losses,
        "adapter": _whole(_flat_params(adapter)), "restored": all(_everyone(restored)),
        "split": split, "tp": lay_base.tp.size if lay_base is not None else 1})


def qlora_worker(out_dir: str, cases: list) -> None:
    torch.set_num_threads(1)
    for case in cases:
        qlora_case(out_dir, case)
