"""Big-model inference: load a checkpoint that does not fit one device, the
PyTorch port of ``examples/big_model_inference.py``.

Build the model on the meta device (nothing allocated), stream the
checkpoint into the tiers of a device map (the card, pinned host memory,
disk memmaps), and generate: the tiered load's greedy tokens must equal
those of the same weights loaded whole onto the device.

    python accelerate_tpu_torch/examples/big_model_inference.py [--max_memory_mb 1] [--seq 16]

The example writes its own checkpoint first, in the port's native format or,
with ``--hf_format``, in HF transformers' (``utils/hf_interop.
save_hf_checkpoint``). ``--hf_checkpoint DIR`` reads a directory of HF
safetensors and its ``config.json`` (a Llama, Mistral, Qwen2 or Mixtral
snapshot) instead. ``--quantize int8|int4`` also loads it weight-only
quantized, tensor by tensor. ``--cpu`` runs on the CPU: the device budget
then applies to the host tier, and what is past it goes to disk.

``--tp``/``--fsdp`` above 1 add the reference's GSPMD mode: ``tp x fsdp``
processes (CPU processes over gloo, ``--cpu``; one process a card is the
launch command's, ROADMAP.md queue A10) each load their chunk of every
weight onto the mesh (``load_checkpoint_and_dispatch(mesh=...)``) and
decode greedily through ``parallel.runtime.apply_sharded``; the tokens must
equal the resident load's.

    python accelerate_tpu_torch/examples/big_model_inference.py --cpu --tp 2 --fsdp 2
"""

import argparse
import os
import sys
import tempfile

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu_torch import (  # noqa: E402
    CausalLM,
    debug_launcher,
    TransformerConfig,
    infer_auto_device_map,
    init_empty_weights,
    load_checkpoint_and_dispatch,
    materialize_offloaded,
)
from accelerate_tpu_torch.checkpointing import save_model_weights  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.state import resolve_device  # noqa: E402
from accelerate_tpu_torch.utils.hf_interop import (  # noqa: E402
    infer_config_from_hf,
    save_hf_checkpoint,
)


def as_model(cfg, placed):
    """A runnable model from what ``load_checkpoint_and_dispatch`` returned:
    the model itself, or a tree whose every tensor is live on one device."""
    if isinstance(placed, CausalLM):
        return placed
    model = init_empty_weights(CausalLM, cfg)
    model.load_state_dict(placed, assign=True)
    return model


def mesh_worker(ckpt_dir, cfg, load_kwargs, prompt, new_tokens, tp, fsdp, out_file):
    """One process of the mesh mode: its chunk of each weight loaded onto the
    mesh under the rules, then greedy decoding by whole forwards through
    ``apply_sharded`` (the decode cache holds one card's whole heads);
    process 0 writes the tokens."""
    from accelerate_tpu_torch import Accelerator, ParallelismPlugin
    from accelerate_tpu_torch.parallel.runtime import apply_sharded

    torch.set_num_threads(1)
    acc = Accelerator(cpu=True, parallelism_plugin=ParallelismPlugin(
        dp_size=-1, tp_size=tp, fsdp_size=fsdp, min_weight_size=1))
    model = load_checkpoint_and_dispatch(init_empty_weights(CausalLM, cfg), ckpt_dir,
                                         mesh=acc.mesh, plugin=acc.state.parallelism_plugin,
                                         **load_kwargs)
    ids = prompt
    for _ in range(new_tokens):
        logits = apply_sharded(model, ids)
        ids = torch.cat([ids, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    if acc.is_main_process:
        torch.save(ids, out_file)
    acc.wait_for_everyone()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seq", type=int, default=16)
    parser.add_argument("--new_tokens", type=int, default=8)
    parser.add_argument("--max_memory_mb", type=float, default=None,
                        help="Cap the device's memory to force the cpu and disk tiers")
    parser.add_argument("--hf_format", action="store_true",
                        help="Write the example's checkpoint in HF transformers' layout")
    parser.add_argument("--hf_checkpoint", type=str, default=None,
                        help="A directory of HF-layout safetensors and config.json; replaces the "
                        "example's own checkpoint")
    parser.add_argument("--quantize", choices=["int8", "int4"], default=None,
                        help="Also load weight-only quantized, tensor by tensor")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel degree of the mesh mode (with --cpu)")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="Weight-shard degree of the mesh mode (composes with --tp)")
    parser.add_argument("--workdir", type=str, default=None)
    parser.add_argument("--cpu", action="store_true", help="If passed, runs on the CPU.")
    args = parser.parse_args(argv)
    mesh_mode = args.tp > 1 or args.fsdp > 1
    if mesh_mode and not args.cpu:
        raise NotImplementedError(
            "the mesh mode (--tp, --fsdp above 1) needs one process a card, which is the launch "
            "command's (ROADMAP.md, queue A10): pass --cpu to run it over gloo")
    device = resolve_device(args.cpu)
    workdir = args.workdir or tempfile.mkdtemp(prefix="big_model_")
    offload_dir = os.path.join(workdir, "offload")

    load_kwargs = {}
    if args.hf_checkpoint is not None:
        ckpt_dir = args.hf_checkpoint
        cfg = infer_config_from_hf(ckpt_dir)
        load_kwargs = {"config": cfg, "hf_format": True}
        print(f"HF checkpoint: {ckpt_dir} ({cfg.num_layers}L/{cfg.hidden_size}H, "
              f"{'MoE' if cfg.num_experts else 'dense'})")
    else:
        # someone trained a model and saved its weights, sharded
        cfg = TransformerConfig.tiny(max_seq_len=128)
        ckpt_dir = os.path.join(workdir, "ckpt")
        trained = CausalLM(cfg, device=device, generator=torch.Generator(device).manual_seed(0))
        if args.hf_format:
            save_hf_checkpoint(trained, cfg, ckpt_dir, max_shard_size="2MB")
        else:
            save_model_weights(trained, ckpt_dir, max_shard_size="2MB")
        del trained
        print(f"checkpoint written to {ckpt_dir}")

    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, args.seq))).to(device)

    # mode 1: every weight on the device
    whole = {"": "cpu"} if device.type == "cpu" else {"": device.index}
    model = as_model(cfg, load_checkpoint_and_dispatch(
        init_empty_weights(CausalLM, cfg), ckpt_dir, device_map=whole, **load_kwargs))
    out = generate(model, prompt, max_new_tokens=args.new_tokens)
    print("resident generate:", out[0, -args.new_tokens:].tolist())

    # mode 2: device-map tiers (a capped device spills to the cpu, then disk;
    # on the CPU the host is the device, the reference's 4 GiB by default)
    budget = None if args.max_memory_mb is None else int(args.max_memory_mb * 2**20)
    if device.type == "cpu":
        max_memory = {"cpu": budget or 4 << 30}
    else:
        max_memory = None if budget is None else {device.index: budget, "cpu": 8 << 20}
    meta = init_empty_weights(CausalLM, cfg)
    device_map = infer_auto_device_map(meta, max_memory)
    print(f"device_map tiers in use: {sorted({str(v) for v in device_map.values()})}")
    placed = load_checkpoint_and_dispatch(meta, ckpt_dir, device_map=device_map,
                                          offload_dir=offload_dir, **load_kwargs)
    tiered = as_model(cfg, placed if isinstance(placed, CausalLM)
                      else materialize_offloaded(placed, device))
    out2 = generate(tiered, prompt, max_new_tokens=args.new_tokens)
    print("tiered generate:", out2[0, -args.new_tokens:].tolist())
    if not torch.equal(out, out2):
        raise SystemExit("the tiered load's tokens differ from the resident load's")
    print("outputs identical across placements: big-model inference OK")

    # mode 4 (--tp, --fsdp): each of tp x fsdp processes loads its chunks onto
    # the mesh and decodes through the sharded forward
    if mesh_mode:
        out_file = os.path.join(workdir, "mesh_tokens.pt")
        debug_launcher(mesh_worker, (ckpt_dir, cfg, load_kwargs, prompt.cpu(), args.new_tokens,
                                     args.tp, args.fsdp, out_file),
                       num_processes=args.tp * args.fsdp)
        out3 = torch.load(out_file)
        print("mesh generate:", out3[0, -args.new_tokens:].tolist())
        if not torch.equal(out.cpu(), out3):
            raise SystemExit("the mesh load's tokens differ from the resident load's")

    # mode 3 (--quantize): weight-only int8/int4, quantized as it loads
    if args.quantize is not None:
        from accelerate_tpu_torch.utils.quantization import (
            QuantizationConfig,
            load_and_quantize_model,
            quantized_apply,
        )

        qcfg = QuantizationConfig(load_in_8bit=args.quantize == "int8",
                                  load_in_4bit=args.quantize == "int4")
        qparams = load_and_quantize_model(init_empty_weights(CausalLM, cfg), ckpt_dir, qcfg,
                                          device=device, model_config=load_kwargs.get("config"),
                                          hf_format=load_kwargs.get("hf_format"))
        q_bytes = sum(getattr(v, "nbytes", 0) for v in qparams.values())
        fp_bytes = sum(p.nbytes for p in model.parameters())
        print(f"{args.quantize} load: {q_bytes / 2**20:.1f} MiB (fp: {fp_bytes / 2**20:.1f} MiB)")
        with torch.no_grad():
            logits = quantized_apply(model, qparams, prompt, dtype=torch.float32)
            agree = (logits.argmax(-1) == model(prompt).argmax(-1)).float().mean().item()
        print(f"quantized next-token agreement with the fp load: {agree:.2%}")
    return {"resident": out[0].tolist(), "tiered": out2[0].tolist(),
            "tiers": sorted({str(v) for v in device_map.values()})}


if __name__ == "__main__":
    main()
