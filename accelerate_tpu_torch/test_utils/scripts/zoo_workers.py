"""Worker functions of the model zoo's sharded tests: ``GPT2LM`` and
``Seq2SeqLM`` trained through ``prepare`` and ``unified_step`` under a
``ParallelismPlugin`` (fsdp x tp, dp x fsdp x tp). Run under
``launchers.debug_launcher`` on the CPU over gloo; the parent runs the same
case function at world 1, in its own process, for the unsharded record.

Each case loads the weights of ``out_dir/<init>`` and the rows of
``out_dir/inputs.npz`` (the arrays named ``<model>_<key>``), trains fp32
AdamW (weight decay 0, eps 1e-3: the update is smooth in the gradient, so
a sharded run's summation order moves no step) with clip 1.0, and process 0
writes ``<name>.pt``: the global batch's loss a step, the whole final
parameters and each parameter's spec. They import torch and the port only,
and set one torch thread a process.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .sharding_workers import _fresh_accelerator, _plugin, _save

# the batch keys of each model's loss
KEYS = {"gpt2": ("input_ids",),
        "seq2seq": ("input_ids", "decoder_input_ids", "labels", "attention_mask")}


def zoo_case(out_dir: str, case: dict) -> None:
    """One case: ``name``, ``model`` (``"gpt2"`` or ``"seq2seq"``),
    ``config`` (``TransformerConfig`` kwargs), ``init`` (a state dict file
    of ``out_dir``), ``plugin`` (kwargs, or None), ``rows`` of each global
    batch, ``lr``."""
    import torch.distributed as dist

    from accelerate_tpu_torch import DataLoader, adamw
    from accelerate_tpu_torch.models import GPT2LM, Seq2SeqLM, TransformerConfig
    from accelerate_tpu_torch.parallel.sharding import shardings_of

    acc = _fresh_accelerator(parallelism_plugin=_plugin(case.get("plugin")))
    cls = GPT2LM if case["model"] == "gpt2" else Seq2SeqLM
    model = cls(TransformerConfig(**case["config"]), device="cpu",
                generator=torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(os.path.join(out_dir, case["init"])))
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    arrays = {k: data[f"{case['model']}_{k}"] for k in KEYS[case["model"]]}
    n = len(next(iter(arrays.values())))
    rows = [{k: v[i] for k, v in arrays.items()} for i in range(n)]
    loader = DataLoader(rows, batch_size=case["rows"] // acc.state.data_parallel_size)
    model, opt, loader = acc.prepare(model, adamw(case["lr"], eps=1e-3, weight_decay=0.0),
                                     loader)
    step = acc.unified_step(cls.loss_fn(model), max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    losses = []
    for batch in loader:
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
    rec = {"losses": losses, "params": acc.get_state_dict(model),
           "specs": {k: None if v is None else tuple(v)
                     for k, v in shardings_of(dict(model.named_parameters())).items()}}
    if not dist.is_initialized() or dist.get_rank() == 0:
        _save(out_dir, f"{case['name']}.pt", rec)
    if acc.state.num_processes > 1:
        acc.wait_for_everyone()


def zoo_worker(out_dir: str, cases: list) -> None:
    """Every case of ``cases`` in one process group, a fresh accelerator
    each."""
    torch.set_num_threads(1)
    for case in cases:
        zoo_case(out_dir, case)
