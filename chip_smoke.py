#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build:  compile the port's CUDA sources with nvcc for sm_90a.
2. kernels: hold each flash-attention kernel (forward, dq, dk/dv) against
   its plain PyTorch version on the card, at the main path's shape in bf16
   and on small cases (non-causal, one kv head per query head, window,
   kv lengths with an empty row, kv longer than q, fp32 at a tight
   tolerance); time kernel, plain version and, where one PyTorch call
   computes the same function, that call.
3. small model: a tiny CausalLM through the kernels on the card against
   the same weights through the plain path on the CPU.
4. main path: a Llama-3-8B-width CausalLM (4 layers) trained for a few
   ``Accelerator.unified_step``s in bf16 with AdamW and clipping, with
   every kernel launch counter set to 0 just before and read just after.

Prints one JSON line describing the kernels, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Needs one
CUDA device; exits non-zero without one.

    python3 chip_smoke.py --check-only

runs phases 1 and 2 without the timings (for tools/flash_mutants.py).

Each kernel output is compared row by row: for every row of head_dim
values, max |kernel - plain| over that row's RMS plus 1e-2 of the whole
tensor's RMS (the floor keeps rows the plain version nearly cancels, such
as dq of a query that sees one key, from reading as large), then the
largest over all rows. A global max|err| / max|plain| would let a causal
output pass with most rows wrong: its largest values sit in the first
rows, which see few keys.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

MAIN = dict(B=2, S=2048, H=32, Hkv=8, D=128)  # llama3_8b attention at the main path's batch
STEPS = 5
NUM_LAYERS = 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# limits about 3x the largest reading of a correct kernel on an H100
# (PERF.md): worst row error, see above, and lse's max abs error
TOL = {"bfloat16": 0.1, "float16": 1e-2, "float32": 1e-5}
LSE_TOL = {"bfloat16": 5e-6, "float16": 5e-6, "float32": 2e-6}
SOURCE = "accelerate_tpu_torch/ops/csrc/flash_attention.cu"
KERNELS = {  # wrapper name -> (kernel name, the Pallas kernel it replaces)
    "flash_fwd": ("flash_fwd_kernel", "accelerate_tpu/ops/flash_attention.py:150"),
    "flash_bwd_dq": ("flash_bwd_dq_kernel", "accelerate_tpu/ops/flash_attention.py:269"),
    "flash_bwd_dkv": ("flash_bwd_dkv_kernel", "accelerate_tpu/ops/flash_attention.py:325"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


class Report:
    def __init__(self, card_line: str):
        self.card = card_line

    def line(self, text: str) -> None:
        print(f"[{self.card}] {text}", flush=True)


def time_ms(torch, fn, iters: int, flush) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, by CUDA events around the call alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-12))


def row_err(torch, got, want) -> float:
    """Worst row of ``got`` against ``want``: max |err| over the row's RMS
    plus 1e-2 of the tensor's RMS."""
    g, w = got.float(), want.float()
    rms_row = w.square().mean(dim=-1, keepdim=True).sqrt()
    floor = 1e-2 * float(w.square().mean().sqrt()) + 1e-30
    return float(((g - w).abs() / (rms_row + floor)).max())


def make_inputs(torch, B, S, H, Hkv, D, dtype, Skv=None, seed=0):
    Skv = S if Skv is None else Skv
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape_q, shape_kv = (B, S, H, D), (B, Skv, Hkv, D)
    q, k, v, dout = (
        torch.randn(shape, generator=g, device="cuda").to(dtype)
        for shape in (shape_q, shape_kv, shape_kv, shape_q)
    )
    return q, k, v, dout


def check_case(torch, fa, name, B, S, H, Hkv, D, dtype, Skv=None, causal=True,
               window=None, lens=None):
    """All three kernels against their plain versions on one case. Returns
    the case's readings (printed as one JSON line) and the max abs error of
    each kernel's outputs."""
    q, k, v, dout = make_inputs(torch, B, S, H, Hkv, D, dtype, Skv)
    kv_lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    args = (scale, causal, kv_lengths, window)
    out, lse = fa.flash_fwd(q, k, v, *args)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, *args)
    delta = fa.attention_delta(ref_out, dout)
    dq = fa.flash_bwd_dq(q, k, v, dout, ref_lse, delta, *args)
    ref_dq = fa.flash_bwd_dq_reference(q, k, v, dout, ref_lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, ref_lse, delta, *args)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, dout, ref_lse, delta, *args)
    torch.cuda.synchronize()
    tag = str(dtype).replace("torch.", "")
    pairs = {"o": (out, ref_out), "dq": (dq, ref_dq), "dk": (dk, ref_dk), "dv": (dv, ref_dv)}
    errs = {k: row_err(torch, *gw) for k, gw in pairs.items()}
    lse_err = float((lse - ref_lse).abs().max())
    bad = [k for k, e in errs.items() if not e <= TOL[tag]]
    if not lse_err <= LSE_TOL[tag]:
        bad.append("lse")
    reading = {
        "case": name, "dtype": tag, "row_err": errs, "row_limit": TOL[tag],
        "lse_abs_err": lse_err, "lse_limit": LSE_TOL[tag], "bad": bad,
        # the global max|err| / max|plain|, for comparison only
        "global_rel_err": {k: rel_err(torch, *gw) for k, gw in pairs.items()},
    }
    absmax = lambda a, b: float((a.float() - b.float()).abs().max())  # noqa: E731
    return reading, {
        "flash_fwd": absmax(out, ref_out),
        "flash_bwd_dq": absmax(dq, ref_dq),
        "flash_bwd_dkv": max(absmax(dk, ref_dk), absmax(dv, ref_dv)),
    }


def visible_pairs(torch, S, Skv, causal) -> int:
    rows = torch.arange(S)[:, None]
    cols = torch.arange(Skv)[None, :]
    keep = cols <= rows + (Skv - S) if causal else torch.ones(S, Skv, dtype=torch.bool)
    return int(keep.sum())


def kernel_phase(torch, fa, rep: Report, check_only: bool = False) -> list[dict]:
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    cases = [
        ("noncausal", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=bf16, causal=False)),
        ("mha_g1", dict(B=2, S=200, H=4, Hkv=4, D=128, dtype=bf16)),
        ("window", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=bf16, window=50)),
        ("kv_lengths_zero_row", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=bf16,
                                     causal=False, lens=[0, 130])),
        ("kv_longer_than_q", dict(B=2, S=64, Skv=200, H=4, Hkv=2, D=64, dtype=bf16)),
        ("q_longer_than_kv", dict(B=2, S=200, Skv=100, H=4, Hkv=2, D=64, dtype=bf16)),
        ("fp16", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=torch.float16)),
        ("fp32", dict(B=2, S=100, H=4, Hkv=2, D=64, dtype=torch.float32)),
        ("fp32_window_lengths", dict(B=2, S=100, H=4, Hkv=2, D=128, dtype=torch.float32,
                                     window=30, lens=[100, 7])),
    ]
    cases.append(("main_bf16_causal", dict(**MAIN, dtype=bf16)))
    failed = []
    for name, kw in cases:  # every case runs; the phase fails after the last
        reading, abs_errs = check_case(torch, fa, name, **kw)
        rep.line(json.dumps(reading))
        if reading["bad"]:
            failed.append(f"{name}: {reading['bad']}")
    main_abs_errs = abs_errs
    # no fallback: a CUDA tensor the kernel does not take is refused, never
    # routed to the plain version
    q, k, v, _ = make_inputs(torch, 1, 64, 2, 1, 64, bf16)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    d40 = tuple(x[..., :40].contiguous() for x in (q, k, v))  # head_dim not a multiple of 16
    for name, args in (("strided q", (strided, k, v)), ("head_dim 40", d40)):
        try:
            fa.flash_fwd(*args, 0.125, True)
        except ValueError:
            continue
        fail(f"the forward wrapper took an input its kernel does not: {name}")
    rep.line("kernel wrappers refuse a strided q and head_dim 40")
    if failed:
        fail(f"kernel outputs beyond tolerance: {'; '.join(failed)}")
    if check_only:
        return []

    # times at the main path's shape
    B, S, H, Hkv, D = (MAIN[k] for k in ("B", "S", "H", "Hkv", "D"))
    q, k, v, dout = make_inputs(torch, B, S, H, Hkv, D, bf16, seed=1)
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = fa.attention_delta(out, dout)
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB of L2
    flush = scratch.zero_
    kernel_fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, True),
                      lambda: fa.flash_fwd_reference(q, k, v, scale, True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, True),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale, True)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, True),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale,
                                                             True)),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)

    pairs = visible_pairs(torch, S, S, True) * B * H
    e = 2  # bytes per bf16 element
    qo = B * S * H * D * e  # q, o, do or dq
    kv = B * S * Hkv * D * e  # k, v, dk or dv
    stat = B * H * S * 4  # lse or delta
    work = {  # (FLOP, bytes): each input read once, each output written once
        "flash_fwd": (2 * 2 * D * pairs, qo + 2 * kv + qo + stat),
        "flash_bwd_dq": (3 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + qo),
        "flash_bwd_dkv": (4 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + 2 * kv),
    }
    rows = []
    for wrapper, (kernel_name, replaces) in KERNELS.items():
        kfn, pfn = kernel_fns[wrapper]
        ms = time_ms(torch, kfn, 20, flush)
        plain_ms = time_ms(torch, pfn, 5, flush)
        flops, nbytes = work[wrapper]
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        rows.append({
            "name": kernel_name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": None, "max_abs_err": main_abs_errs[wrapper], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_fwd if wrapper == "flash_fwd" else None,
        })
        rep.line(f"{kernel_name} at {MAIN} bf16 causal: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                 f"bound {max(t_ops, t_bytes):.4f} ms by {rows[-1]['bound_by']}, "
                 f"{flops / ms / 1e9:.1f} TFLOP/s)")

    # the backward as a whole against SDPA's (a yardstick: no single
    # PyTorch call computes dq alone or dk/dv alone)
    qg, kg, vg = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    dout_t = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        torch.autograd.grad(o, (qg, kg, vg), dout_t)

    def port_fwd_bwd():
        o, l = fa.flash_fwd(q, k, v, scale, True)
        d = fa.attention_delta(o, dout)
        fa.flash_bwd_dq(q, k, v, dout, l, d, scale, True)
        fa.flash_bwd_dkv(q, k, v, dout, l, d, scale, True)

    rep.line(f"fwd+bwd at {MAIN}: port kernels {time_ms(torch, port_fwd_bwd, 10, flush):.4f} ms, "
             f"F.scaled_dot_product_attention {time_ms(torch, sdpa_fwd_bwd, 10, flush):.4f} ms "
             "(yardstick only)")
    return rows


def small_model_phase(torch, port, rep: Report) -> None:
    """A tiny CausalLM forced through the flash kernels on the card in fp32
    against the same weights on the CPU's plain path."""
    cfg = port.TransformerConfig.tiny(vocab_size=512, hidden_size=128, num_heads=4,
                                      num_kv_heads=2, attention_impl="flash")
    cpu_model = port.CausalLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    gpu_model = port.CausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(1))
    results = []
    for model, device in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        params = dict(model.named_parameters())
        loss = port.CausalLM.loss_fn(model)(params, {"input_ids": ids.to(device)})
        grads = torch.autograd.grad(loss, list(params.values()))
        results.append((float(loss.detach()), [g.cpu() for g in grads]))
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results
    grad_err = max(rel_err(torch, g, c) for g, c in zip(gpu_grads, cpu_grads))
    rep.line(f"small model fp32 flash kernels vs CPU plain path: loss {gpu_loss:.6f} vs "
             f"{cpu_loss:.6f}, max grad rel err {grad_err:.3g}")
    if not (abs(gpu_loss - cpu_loss) <= 1e-4 * abs(cpu_loss) and grad_err <= 1e-4):
        fail("small model: the card's kernels disagree with the CPU plain path")


def main_path_phase(torch, port, fa, rep: Report) -> dict:
    cfg = port.TransformerConfig.llama3_8b(num_layers=NUM_LAYERS, dtype="bfloat16",
                                           max_seq_len=MAIN["S"])
    torch.cuda.empty_cache()  # hand back what the kernel phase's plain versions cached
    acc = port.Accelerator(mixed_precision="bf16")
    t0 = time.perf_counter()
    model = port.CausalLM(cfg, device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    # one batch of synthetic tokens, repeated every step: the loss must fall
    tokens = torch.randint(0, cfg.vocab_size, (MAIN["B"], MAIN["S"]),
                           generator=torch.Generator().manual_seed(0)).numpy()
    dataset = [{"input_ids": tokens[i % MAIN["B"]]} for i in range(STEPS * MAIN["B"])]
    model, opt, loader = acc.prepare(model, port.adamw(3e-4),
                                     port.DataLoader(dataset, batch_size=MAIN["B"]))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    torch.cuda.synchronize()
    rep.line(f"main path set-up: {n_params} params ({cfg.num_layers} layers at llama3_8b "
             f"width), {time.perf_counter() - t0:.2f} s")

    for wrapper in fa.KERNEL_WRAPPERS:
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    for batch in loader:
        t0 = time.perf_counter()
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {w.__name__: w.launches for w in fa.KERNEL_WRAPPERS}
    peak = torch.cuda.max_memory_allocated()

    steady = statistics.median(times[1:])  # the first step pays one-time set-up
    tokens_per_step = MAIN["B"] * MAIN["S"]
    rep.line(f"main path losses {losses}, grad norms {norms}")
    rep.line(f"main path step seconds {times}; median of steps 2-{STEPS} {steady} s, "
             f"{tokens_per_step / steady} tokens/s; peak memory {peak / 2**30} GiB")
    rep.line(f"main path kernel launches {json.dumps(launches)}")
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"main path losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"main path loss did not fall on a repeated batch: {losses}")
    if carry["opt_step"] != STEPS:
        fail(f"main path took {carry['opt_step']} optimizer steps, not {STEPS}")
    want = NUM_LAYERS * STEPS
    if any(n != want for n in launches.values()):
        fail(f"main path kernel launches {launches}, want {want} each")
    profile_step(torch, step, carry, batch, rep)
    return launches


def profile_step(torch, step, carry, batch, rep: Report) -> None:
    """One more step of the main path (after its counts were read) under
    torch.profiler: device time by kernel group, the optimizer epilogue's
    device range, and the device's busy share of the step's wall time (the
    profiler's own cost included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(carry, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, epilogue_ms = {}, None
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.key == "unified_step.sync_apply":  # the range on the device
            epilogue_ms = evt.device_time_total / 1e3
        else:
            kernels[evt.key] = evt.self_device_time_total / 1e3
    busy_ms = sum(kernels.values())
    if busy_ms == 0:
        rep.line("profiled step: the profiler saw no device time (not measured)")
        return
    groups = {"flash attention kernels": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        if "flash_" in name and "_kernel" in name:
            groups["flash attention kernels"] += ms
        elif any(t in name.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")):
            groups["matmul (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    rep.line(f"profiled step: wall {wall_ms} ms, device busy {busy_ms} ms "
             f"({100 * busy_ms / wall_ms} %), by kernel group ms {json.dumps(groups)}, "
             f"optimizer epilogue (unified_step.sync_apply) {epilogue_ms} ms on the device")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        rep.line(f"profiled step: {ms} ms {name[:110]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    try:
        import accelerate_tpu_torch as port
        from accelerate_tpu_torch.ops import _build
        from accelerate_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep = Report(card())
    rep.line(f"torch {torch.__version__} cuda {torch.version.cuda} device "
             f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    seconds = _build.build(["flash_attention"])
    rep.line(f"build: {json.dumps(seconds)} s per source, {time.perf_counter() - t0:.2f} s in all")
    for line in _build.BUILD_LOGS.get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            rep.line(f"ptxas: {line.strip()}")

    rows = kernel_phase(torch, fa, rep, check_only="--check-only" in sys.argv[1:])
    if not rows:
        rep.line("check-only: every kernel case within tolerance")
        return
    small_model_phase(torch, port, rep)
    launches = main_path_phase(torch, port, fa, rep)
    wrapper_of = {kernel: wrapper for wrapper, (kernel, _) in KERNELS.items()}
    for row in rows:
        row["launches"] = launches[wrapper_of[row["name"]]]

    print(json.dumps({"kernels": rows}))
    print(rep.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
