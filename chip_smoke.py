#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build:  compile the port's CUDA sources (flash_attention.cu, fused.cu)
   with nvcc for sm_90a, one nvcc per source, all started together.
2. kernels: hold each kernel against its plain PyTorch version on the
   card. The flash kernels (forward, dq, dk/dv and the single-pass
   backward, the latter also against dq + dk/dv) at the main path's shape
   in bf16 and on small cases that reach the edges of both designs (bf16
   and fp16 at head_dim 64 and 128, S = 129, 255 and 300, a window across a
   128-row tile and across dq's 64-row kv tiles, kv lengths with an empty
   row, one and four query heads a kv head, kv longer or shorter than q,
   non-causal, head_dim 96 on the wmma design, fp32 at a tight tolerance,
   and bert_base's shape: B 4, S 512, 12 heads of 64, non-causal, lengths
   512/300/129/0, bf16 and fp16), each case's launches of all four counted
   by design (``kernel_design``'s
   answer at the launch, first held against the C launcher's own rule);
   where dk/dv and the single pass both take the wgmma design, dk/dv's dk
   and dv must equal the single pass's bit for bit, and dq and dk/dv,
   launched again into outputs filled with NaN, must give the same bits; the fused prologue at
   the main shape and on cases that reach the edges of both designs (D 64
   in 64-, 128-, 192- and 256-column tiles, D 128 in 128- and 256-column
   tiles, with and without a bias, rows that fill no 128-row tile or end
   past a tile edge, E = 320 and 64, fp16; D 96 and fp32 on the wmma
   design), each counted by design (first held against the C launcher's
   rule), launched twice for the same bits and into outputs followed by
   guard rows that must stay as they were; the AdamW epilogue BIT
   FOR BIT on the main path's 39 leaf shapes plus an odd-sized and a 0-d
   leaf, finite and held. Time kernel, plain version and, where one
   PyTorch call computes the same function (SDPA's forward for B1,
   PyTorch's flash-attention backward op for B4, ``torch._fused_adamw_``
   for the epilogue), that call; else a named yardstick. B1-B3 also at the
   BERT phase's shape (B 32, S 512, seeded lengths), SDPA with the key
   mask as B1's library call.
3. small models: a tiny CausalLM through the kernels on the card against
   the same weights through the plain path on the CPU; then a tiny
   ``fused_kernels=True`` CausalLM with ``fused_adamw`` and the single-pass
   backward trained 3 steps on the card against the CPU, from three seeds.
4. main path: a Llama-3-8B-width CausalLM (4 layers) trained for a few
   ``Accelerator.unified_step``s in bf16 with AdamW and clipping, with
   every kernel launch counter set to 0 just before and read just after;
   then one profiled step, whose kernel names must be the path's kernels.
5. fused path: the same model with ``fused_kernels=True``, ``fused_adamw``
   and ``flash_attention.FUSED_BWD = True``, counters and profiled step
   read the same way; its loss curve must stay within PATH_LOSS_TOL of the
   main path's.
6. BERT phase: the bert_base ``SequenceClassifier`` (full width and depth)
   at B 32, S 512, where auto-dispatch itself takes B1-B3 non-causal with
   ``kv_lengths``: 6 ``unified_step``s and an eval pass with exact launch
   counts and one profiled step; then 3 steps, ``save_state``, a fresh
   accelerator and model, ``load_state``, ``skip_first_batches(3)`` and 3
   steps, which must equal the uninterrupted run bit for bit.
7. example: ``accelerate_tpu_torch/examples/checkpointing.py`` for one
   bert_base epoch (S 128: no kernel of the port), its ``epoch_0``
   re-evaluated in a fresh accelerator to the same accuracy, and one
   profiled step of its shape.
8. serving: ``generate``, ``make_generate_fn`` and the continuous-batching
   ``ServingEngine`` (``max_slots`` 4, ``block_size`` 16) on the reference's
   5.5 B ``decode`` config at full width and depth (24 layers), bf16
   weights made on the card from a seed. Checks: the engine's decode step
   replayed as a CUDA graph equals the eager step bit for bit (logits and
   pools, 8 steps of a 4-slot batch at mixed depths), and so does
   ``make_generate_fn``'s; a 2-layer fp32 model's greedy tokens are the
   same through the engine and ``generate`` on the card and on the CPU,
   and through the engine with the prefix cache cold and warm (a
   full-prompt hit and its copy included); paged and dense prefill give
   the same first-token logits within SERVE_PREFILL_TOL; blocks no table
   held keep the sentinel the pools were filled with, and the trace's
   tokens do not change between its warm and timed runs; the decode step
   is built once and prefill buckets stay within log2(max_seq_len); no
   kernel of the port launches. Prints s/token of ``make_generate_fn`` (B
   1, prompt 128, 64 new tokens) and of the eager ``generate`` beside the
   weights-read bound, the engine's useful tokens/s on the 8-request
   long-tailed trace of ``benchmarks/measure.py:_run_serve`` against fixed
   batches of ``make_generate_fn``, peak memory, KV bytes per token and the
   device's busy share of one profiled decode step and one engine step.
   Then the reference's three further parts of its ``serve`` variant
   (``measure.py:705-952``): the observability A/B on the same warm engine
   (the trace with telemetry, gauges, SLO and spans off, then on, in
   OBS_ROUNDS interleaved rounds; tokens unchanged, the decode step built
   once, ``serve_gauge`` and ``slo`` lines in the scrape text); the prefix
   A/B on it (a 24-block template, 12 prompts with 8-token suffixes drained
   one at a time, cold then warm: TTFT, exactly 12 x 384 prefill tokens
   saved, no new build, first-token logits warm against cold within
   PREFIX_LOGITS_TOL); and the speculation A/B with the target in fp32 at
   the decode config (o_proj and down_proj of layers >= 1 at zero) and a
   1-layer draft holding its layer 0: off, n-gram and draft model at k 4 on
   8 prompts of 180 new tokens, each a fresh engine, warm then timed
   (n-gram and draft outputs equal off's token for token, nothing rebuilt
   after warmup, one verify and one draft-step build, the draft's accept
   rate at least SPEC_ACCEPT_MIN).
9. moe: the reference benchmark's ``moe`` config (registry.py:214-258,
   656,453,632 params: 1 layer, 8 experts of Mixtral width, top-2, ragged
   dispatch) at B 16, S 1024: B1-B4 against their plain versions at its
   attention shape (``check_case``, gated), B1-B3 timed there; a
   2-layer fp32 tiny MoE model on the card against the CPU (1e-4); one
   full-width MoE layer's output and grads (x, router, the three stacks)
   by the grouped GEMM and by capacity at the no-drop factor against the
   dense oracle, row by row (MOE_ORACLE_TOL); capacity 1.25's drops equal
   to the plain version's on the CPU, and fully dropped tokens read zeros;
   5 unified_steps (AdamW, clip 1.0) with exact B1-B3 launches and none of
   B4-B6; a profiled step whose kernels include the grouped GEMM; a step
   and its gradients repeated from one copy of the state, bit for bit.
10. dense and fp8: the ``dense`` config (registry.py:205-213, 3 layers at
   Llama-8B width, ``remat="dots"``) at B 8, S 1024, 5 steps in bf16, then
   again under ``mixed_precision="fp8"`` (prepare converts the 21
   projections): ``fp8_matmul`` by ``torch._scaled_mm`` against its plain
   version at the config's projection shapes (forward, dx, dw row by row,
   FP8_PRODUCT_TOL); exact launches (the "dots" recompute replays the
   flash forward) and exact fp8 products (the wrapper's calls, and the
   fp8 GEMM kernels of a profiled step: 63); "dots" against no remat bit
   for bit; then bf16 and fp8 again from each further seed of FP8_SEEDS,
   and on every seed the fp8 losses within FP8_LOSS_TOL of the bf16 ones
   (the gap over the bf16 run's first loss).
11. longseq: the ``longseq`` config (registry.py:259-288, 2 layers, S 8192,
   B 1, flash): B1-B4 against their plain versions at its attention shape
   (gated), B1-B3 timed there, then 4 steps each under
   ``"save_mlp"``, ``"full"`` and no remat, whose gradients must be the same
   bit for bit, each with exact launches.

Prints one JSON line describing the kernels (each with the shape it was
timed at), then the card's name and power limit, then ``{"ok": true, "device": {...}}`` as the last line. Needs one
CUDA device; exits non-zero without one.

    python3 chip_smoke.py --check-only

runs phases 1 and 2 without the timings, and

    python3 chip_smoke.py --small-only

phases 1 and 3 (both for tools/flash_mutants.py), and

    python3 chip_smoke.py --bert-only

phase 1, the BERT-shape kernel cases and timings, and phases 6 and 7, and

    python3 chip_smoke.py --serve-only

phase 8 alone (the serving path runs no kernel of the port, so nothing is
built), ending with the card's line and the ``{"ok": true, ...}`` line, and

    python3 chip_smoke.py --variants-only

phases 1 and 9-11.

Each kernel output is compared row by row: for every row of head_dim
values, max |kernel - plain| over that row's RMS plus 1e-2 of the whole
tensor's RMS (the floor keeps rows the plain version nearly cancels, such
as dq of a query that sees one key, from reading as large), then the
largest over all rows. A global max|err| / max|plain| would let a causal
output pass with most rows wrong: its largest values sit in the first
rows, which see few keys.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

MAIN = dict(B=2, S=2048, H=32, Hkv=8, D=128)  # llama3_8b attention at the main path's batch
STEPS = 5
NUM_LAYERS = 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SPIN_CYCLES = 4_000_000  # about 2 ms of the SM clock: longer than a wrapper's host work
# limits about 3x the largest reading of a correct kernel on an H100
# (PERF.md): worst row error, see above, and lse's max abs error
TOL = {"bfloat16": 0.1, "float16": 1e-2, "float32": 1e-5}
LSE_TOL = {"bfloat16": 5e-6, "float16": 5e-6, "float32": 2e-6}
PROLOGUE_TOL = {"bfloat16": 0.05, "float16": 5e-3, "float32": 1e-5}  # the same row error
SMALL_UPDATE_TOL = 3e-4  # |card - CPU| / |CPU update| of the tiny fused model's params
SMALL_SEEDS = (0, 1, 2)  # weights and batches of the tiny fused model
# |fused path loss - main path loss| / main path loss, by step: about 3x the
# largest reading over seeds and repeats of tools/path_bisect.py (PERF.md)
PATH_LOSS_TOL = (5e-5, 3e-4, 2e-3, 3e-3, 1e-2)
FLASH_SRC = "accelerate_tpu_torch/ops/csrc/flash_attention.cu"
FUSED_SRC = "accelerate_tpu_torch/ops/csrc/fused.cu"
# wrapper name -> (kernel name, the Pallas kernel it replaces, source, its
# design; None: two designs, the row says which one the main shape's case
# launched, from the wrapper's per-design counter)
KERNELS = {
    # the wmma design of B1-B4 (fp32, other head dims) launches as
    # flash_fwd_wmma_kernel, flash_bwd_dq_wmma_kernel, ...
    "flash_fwd": ("flash_fwd_kernel", "accelerate_tpu/ops/flash_attention.py:150", FLASH_SRC,
                  None),
    "flash_bwd_dq": ("flash_bwd_dq_kernel", "accelerate_tpu/ops/flash_attention.py:269",
                     FLASH_SRC, None),
    "flash_bwd_dkv": ("flash_bwd_dkv_kernel", "accelerate_tpu/ops/flash_attention.py:325",
                      FLASH_SRC, None),
    "flash_bwd_fused": ("flash_bwd_fused_kernel", "accelerate_tpu/ops/flash_attention.py:422",
                        FLASH_SRC, None),
    # the wgmma design launches qkv_prologue_rstd_kernel, then
    # qkv_prologue_kernel; the wmma design (fp32, other head dims)
    # qkv_prologue_wmma_kernel
    "qkv_prologue": ("qkv_prologue_kernel", "accelerate_tpu/ops/fused.py:214", FUSED_SRC,
                     None),
    "adamw_epilogue": ("adamw_kernel", "accelerate_tpu/ops/fused.py:426", FUSED_SRC,
                       "elementwise"),
}
# the BERT phase: bert_base at its max_seq_len, the kernels' BERT shape
BERT = dict(B=32, S=512, H=12, D=64, steps=6, eval_rows=100, eval_batch=32)
BERT_CASES = [  # B1-B3 non-causal, right-padded, G = 1 at head_dim 64; a row of length 0
    ("bert_noncausal_lengths_d64_g1", dict(B=4, S=512, H=12, Hkv=12, D=64, causal=False,
                                           lens=[512, 300, 129, 0])),
    ("bert_noncausal_lengths_d64_g1_fp16", dict(B=4, S=512, H=12, Hkv=12, D=64, causal=False,
                                                lens=[512, 300, 129, 0])),
]
WRAPPER_OF = {spec[0]: wrapper for wrapper, spec in KERNELS.items()}  # kernel -> wrapper
# the reference's ``decode`` config (accelerate_tpu/benchmarks/registry.py:289-297):
# 5,496,836,096 params, 96 KiB of bf16 KV a token
DECODE_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=24,
                  num_heads=32, num_kv_heads=8, max_seq_len=512, dtype="bfloat16")
# the reference's serve and decode variants (registry.py:318-328)
SERVE = dict(max_slots=4, block_size=16, n_requests=8, seed=0, prompt=128, new_tokens=64,
             reps=3, graph_steps=8)
# paged against dense prefill, first-token logits in bf16: worst row's max
# error over its RMS. An H100 read 0.0 on all 8 prompts (the padded and
# unpadded products picked the same cuBLAS kernels), so the limit is not 3x
# the reading but a few bf16 spacings (2^-8) of a logit row (PERF.md)
SERVE_PREFILL_TOL = 0.02
OBS_ROUNDS = 2  # interleaved off/on rounds of the observability A/B (measure.py:733)
PREFIX_COHORT, PREFIX_NEW = 12, 8  # the templated cohort: 12 requests of 8 new tokens
# warm against cold first-token logits in bf16 (an M of 8 against a bucket
# of 512), worst row's max error over its RMS: about 3x the largest reading
# on an H100 (0.180 over 12 prompts; PERF.md). The same tail padded to the
# cold bucket is held within SERVE_PREFILL_TOL
PREFIX_LOGITS_TOL = 0.55
SPEC_K, SPEC_PROMPTS = 4, 8  # measure.py:896-897
# the draft arm's accept rate: an H100 read 1.0 (2,304 of 2,304); the margin
# is for argmax ties that the draft step (M 8) and the verify step (M 20)
# round apart in fp32
SPEC_ACCEPT_MIN = 0.97
SENTINEL = -768.0  # what the pools hold before the trace (exact in bf16)
CARD = "cuda"  # where the serving phase puts its models
# the reference benchmark's single-card training variants
# (accelerate_tpu/benchmarks/registry.py:203-406): full width and depth
MOE_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=3584, num_layers=1,
               num_heads=32, num_kv_heads=8, max_seq_len=1024, num_experts=8,
               num_experts_per_tok=2, moe_dispatch="ragged", moe_capacity_factor=1.25,
               dtype="bfloat16", remat=None)  # :214-258, 656,453,632 params
DENSE_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=3,
                 num_heads=32, num_kv_heads=8, max_seq_len=1024, dtype="bfloat16",
                 remat="dots")  # :205-213, 916,484,096 params; fp8 :389-391
LONGSEQ_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=2,
                   num_heads=32, num_kv_heads=8, max_seq_len=8192, dtype="bfloat16",
                   remat="save_mlp", attention_impl="flash")  # :259-288, 698,372,096 params
VARIANT_BATCH = {"moe": 16, "dense": 8}  # the variants' B (registry.py:343, :389); longseq B 1
VARIANT_STEPS = 5
LONGSEQ_STEPS = 4
# limits, worst row's max error over its RMS (bf16): about 3x the largest
# reading on an H100 (PERF.md's parity table)
MOE_ORACLE_TOL = 0.17  # ragged and capacity against the dense oracle (read 0.057)
FP8_PRODUCT_TOL = 0.05  # fp8_matmul by torch._scaled_mm against its plain version (read 0.017)
FP8_SEEDS = (0, 1, 2, 3, 4)  # weights and tokens of the fp8 against bf16 loss comparison
# |fp8 loss - bf16 loss| / the bf16 run's first loss, by step, on every seed
# of FP8_SEEDS. Over the first loss, not each step's own: the repeated batch
# takes the loss from 10.9 to 0.01 in 5 steps, and a gap over a loss that
# vanishes compares noise. About 3x the largest reading over the seeds on an
# H100 (2.5e-4, 4.6e-3, 0.0177, 0.0117, 2.0e-4); tools/fp8_mutants.py's
# planted faults in the fp8 backward read 0.137 or more from step 2 on
FP8_LOSS_TOL = (7.5e-4, 0.014, 0.055, 0.035, 6e-4)
LLAMA3_ROPE = dict(theta=500000.0, scaling={
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
})


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
    L2 flush, by CUDA events around the call alone. A spin kernel queued
    between the flush and the start event keeps the card busy while the
    host prepares the call, so the host's time before the first kernel of
    ``fn`` reaches the card is not counted as the card's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
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
    """All four flash kernels against their plain versions on one case, and
    the single-pass backward against dq + dk/dv. Each kernel must count its
    launches under ``fa.kernel_design``'s design alone (the rule's answer at
    the launch; ``check_design_rule`` holds it against the C launcher's).
    On the wgmma design dk/dv's dk and dv must equal the single pass's bit
    for bit (one body, the single pass's dq part compiled out of dk/dv), and
    dq and dk/dv, which use no atomics, must give the same bits when
    launched again on the same inputs. Returns the case's readings (printed
    as one JSON line) and the max abs error of each kernel's outputs."""
    q, k, v, dout = make_inputs(torch, B, S, H, Hkv, D, dtype, Skv)
    before = [dict(w.by_design) for w in fa.KERNEL_WRAPPERS]
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
    fdq, fdk, fdv = fa.flash_bwd_fused(q, k, v, dout, ref_lse, delta, *args)
    ref_fdq, ref_fdk, ref_fdv = fa.flash_bwd_fused_reference(q, k, v, dout, ref_lse, delta,
                                                             *args)
    # dq and dk/dv once more on the same inputs, into outputs filled with NaN
    # first (the wrappers' outputs start as whatever the memory held): an
    # element a kernel leaves unwritten reads NaN and fails the repeat check
    nan = float("nan")
    dq2, dk2, dv2 = torch.full_like(q, nan), torch.full_like(k, nan), torch.full_like(v, nan)
    fa._launch(fa.flash_bwd_dq, (q, k, v, dout, ref_lse, delta, kv_lengths, dq2), q, k, scale,
               causal, window)
    fa._launch(fa.flash_bwd_dkv, (q, k, v, dout, ref_lse, delta, kv_lengths, dk2, dv2), q, k,
               scale, causal, window)
    torch.cuda.synchronize()
    ran = {w.__name__: [d for d, n in w.by_design.items() if n != b[d]]
           for w, b in zip(fa.KERNEL_WRAPPERS, before)}
    design = fa.kernel_design(dtype, D)
    tag = str(dtype).replace("torch.", "")
    pairs = {"o": (out, ref_out), "dq": (dq, ref_dq), "dk": (dk, ref_dk), "dv": (dv, ref_dv),
             "fused_dq": (fdq, ref_fdq), "fused_dk": (fdk, ref_fdk), "fused_dv": (fdv, ref_fdv)}
    # the single-pass kernel against the two-pass kernels on the same inputs
    two_pass = {"fused_dq": (fdq, dq), "fused_dk": (fdk, dk), "fused_dv": (fdv, dv)}
    errs = {k: row_err(torch, *gw) for k, gw in pairs.items()}
    vs_two_pass = {k: row_err(torch, *gw) for k, gw in two_pass.items()}
    lse_err = float((lse - ref_lse).abs().max())
    bad = [k for k, e in errs.items() if not e <= TOL[tag]]
    bad += [f"{k}_vs_two_pass" for k, e in vs_two_pass.items() if not e <= TOL[tag]]
    if not lse_err <= LSE_TOL[tag]:
        bad.append("lse")
    bad += [f"{w}_design" for w, got in ran.items() if got != [design]]
    # bit for bit: dk/dv against the single pass on the wgmma design (None
    # on the wmma design, whose two kernels differ), dq and dk/dv against
    # their second launch
    bitwise = {"dk_equals_fused": torch.equal(dk, fdk) if design == "wgmma" else None,
               "dv_equals_fused": torch.equal(dv, fdv) if design == "wgmma" else None,
               "dq_repeats": torch.equal(dq, dq2),
               "dk_repeats": torch.equal(dk, dk2), "dv_repeats": torch.equal(dv, dv2)}
    bad += [k for k, same in bitwise.items() if same is False]
    reading = {
        "case": name, "dtype": tag, "design": design, "launched": ran, "row_err": errs,
        "row_err_vs_two_pass": vs_two_pass, "bitwise": bitwise,
        "row_limit": TOL[tag], "lse_abs_err": lse_err, "lse_limit": LSE_TOL[tag], "bad": bad,
        # the global max|err| / max|plain|, for comparison only
        "global_rel_err": {k: rel_err(torch, *gw) for k, gw in pairs.items()},
    }
    absmax = lambda a, b: float((a.float() - b.float()).abs().max())  # noqa: E731
    return reading, {
        "flash_fwd": absmax(out, ref_out),
        "flash_bwd_dq": absmax(dq, ref_dq),
        "flash_bwd_dkv": max(absmax(dk, ref_dk), absmax(dv, ref_dv)),
        "flash_bwd_fused": max(absmax(fdq, ref_fdq), absmax(fdk, ref_fdk),
                               absmax(fdv, ref_fdv)),
    }


def prologue_inputs(torch, fused, B, S, E, H, Hkv, D, dtype, bias=False, seed=0):
    """Raw residual stream, norm scale, (out, in) weights, biases and the
    rope tables (llama3 scaling, theta 500000) for the prologue on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *shape, sd=1.0: torch.randn(*shape, generator=g, device="cuda") * sd  # noqa
    x = randn(B, S, E).to(dtype)
    scale = 1.0 + randn(E, sd=0.1)
    ws = [randn(n * D, E, sd=E ** -0.5).to(dtype) for n in (H, Hkv, Hkv)]
    bs = [randn(n * D, sd=0.5).to(dtype) if bias else None for n in (H, Hkv, Hkv)]
    positions = torch.arange(S, device="cuda")[None].expand(B, S)
    inv = fused.rope_inv_freqs(D, LLAMA3_ROPE["theta"], LLAMA3_ROPE["scaling"], "cuda")
    cosd, sind = fused._rope_tables(positions, inv)
    statics = dict(eps=1e-5, norm_offset=False, num_heads=H, num_kv_heads=Hkv, head_dim=D,
                   dtype=dtype)
    return (x, scale, *ws, *bs, cosd.contiguous(), sind.contiguous()), statics


GUARD = -768.0  # what the prologue's guard rows hold (exact in bf16 and fp16)


def guarded_outputs(torch, B, S, widths, dtype):
    """q, k and v as (B, S, n, D) views into one buffer, each followed by 128
    rows of GUARD (a tile's rows past the end would land there); returns the
    views and the guards."""
    rows = B * S
    span = [(rows + 128) * n * d for n, d in widths]
    buf = torch.full((sum(span),), GUARD, dtype=dtype, device="cuda")
    views, guards, at = [], [], 0
    for (n, d), size in zip(widths, span):
        views.append(buf[at:at + rows * n * d].view(B, S, n, d))
        guards.append(buf[at + rows * n * d:at + size])
        at += size
    return views, guards


def check_prologue_case(torch, fused, name, **kw):
    """The prologue kernel against its plain version on the card, q, k and
    v row by row, counted under ``prologue_kernel_design``'s design alone.
    Launched again on the same inputs into outputs followed by guard rows,
    it must give the same bits (no atomics) and leave every guard as it
    was (no store past the last row). Returns the reading and the max abs
    error."""
    args, statics = prologue_inputs(torch, fused, **kw)
    before = dict(fused.qkv_prologue.by_design)
    got = fused.qkv_prologue(*args, **statics)
    want = fused._prologue_reference_tables(*args, **statics)
    ran = [d for d, n in fused.qkv_prologue.by_design.items() if n != before[d]]
    widths = [(n, kw["D"]) for n in (kw["H"], kw["Hkv"], kw["Hkv"])]
    again, guards = guarded_outputs(torch, kw["B"], kw["S"], widths, kw["dtype"])
    fused.prologue_launch(*args, *again, **statics)
    torch.cuda.synchronize()
    tag = str(kw["dtype"]).replace("torch.", "")
    design = fused.prologue_kernel_design(kw["dtype"], kw["H"], kw["Hkv"], kw["D"], kw["E"])
    errs = {n: row_err(torch, gt, w) for n, gt, w in zip("qkv", got, want)}
    bitwise = {"repeats": all(torch.equal(a, b) for a, b in zip(got, again)),
               "guards_intact": all(bool((g == GUARD).all()) for g in guards)}
    bad = [n for n, e in errs.items() if not e <= PROLOGUE_TOL[tag]]
    bad += [k for k, same in bitwise.items() if not same]
    if ran != [design]:
        bad.append("design")
    limit = 256 if design == "wgmma" else 512
    reading = {
        "case": f"prologue_{name}", "dtype": tag, "design": design, "launched": ran,
        "col_block": fused._col_block(kw["H"], kw["Hkv"], kw["D"], limit=limit),
        "row_err": errs, "row_limit": PROLOGUE_TOL[tag], "bitwise": bitwise, "bad": bad,
    }
    return reading, max(float((gt.float() - w.float()).abs().max()) for gt, w in zip(got, want))


def main_tree_shapes(cfg) -> list[tuple]:
    """The parameter shapes of the main path's CausalLM, in its order."""
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layer = [(E,), (q, E), (kv, E), (kv, E), (E, q), (E,), (F, E), (F, E), (E, F)]
    return [(V, E)] + layer * cfg.num_layers + [(E,), (V, E)]


def epilogue_leaf(torch, shape, seed):
    """g, p, mu, nu of one fp32 leaf, made anew from ``seed`` whenever asked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    make = lambda sd: torch.randn(shape, generator=g, device="cuda") * sd  # noqa: E731
    return make(3.0), make(1.0), make(0.1), make(0.01).abs()


def check_epilogue(torch, port, fused, rep: Report) -> None:
    """The epilogue kernel BIT FOR BIT against its plain version on the main
    path's 39 leaf shapes (1.92e9 values, one launch) plus an odd-sized and
    a 0-d leaf: first held (finite = 0: nothing may change), then finite.
    The plain version runs leaf by leaf on inputs made anew from the same
    seed, so only one copy of the tree is on the card."""
    cfg = port.TransformerConfig.llama3_8b(num_layers=NUM_LAYERS)
    shapes = main_tree_shapes(cfg) + [(1000003,), ()]
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4)
    leaves = [epilogue_leaf(torch, shape, i) for i, shape in enumerate(shapes)]
    cols = [list(c) for c in zip(*leaves)]
    for finite in (False, True):
        row = fused.epilogue_scalars(hp["b1"], hp["b2"], 3, -3e-4, finite, "cuda")
        fused.adamw_epilogue(*cols, row, **hp)
        torch.cuda.synchronize()
        worst, mismatched = 0.0, []
        for i, shape in enumerate(shapes):
            want = list(epilogue_leaf(torch, shape, i))
            fused.adamw_leaf_reference(*want, row, **hp)
            for name, got, w in zip(("p", "mu", "nu"), leaves[i][1:], want[1:]):
                if not torch.equal(got, w):
                    mismatched.append(f"{name} of leaf {i} {shape}")
                    worst = max(worst, float((got - w).abs().max()))
            del want
        rep.line(f"adamw_epilogue {'finite' if finite else 'held'} over {len(shapes)} leaves, "
                 f"{sum(math.prod(s) for s in shapes)} values: "
                 f"{'bitwise' if not mismatched else f'{len(mismatched)} leaves differ'}")
        if mismatched:
            fail(f"adamw_epilogue ({'finite' if finite else 'held'}) is not bitwise its plain "
                 f"version: {mismatched[:6]}, max abs diff {worst}")
    del leaves, cols
    torch.cuda.empty_cache()


def visible_pairs(torch, S, Skv, causal) -> int:
    rows = torch.arange(S)[:, None]
    cols = torch.arange(Skv)[None, :]
    keep = cols <= rows + (Skv - S) if causal else torch.ones(S, Skv, dtype=torch.bool)
    return int(keep.sum())


def check_design_rule(fa, build, rep: Report) -> None:
    """``fa.kernel_design``, by which the wrappers count launches, against
    ``flash_design``, the rule the C launcher takes its design by, for each
    of the four kernels at every dtype and head_dim they take."""
    lib = build.bind("flash_attention", fa._SIGNATURES, "flash_error_string")
    # the launcher's Kind codes
    kinds = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2, "flash_bwd_fused": 3}
    wrong = [(w, str(dtype), D) for w, kind in kinds.items()
             for dtype, code in build.DTYPE_CODES.items() for D in range(16, 129, 16)
             if lib.flash_design(kind, code, D) != (fa.kernel_design(dtype, D) == "wgmma")]
    if wrong:
        fail(f"kernel_design and the C launcher's flash_design disagree on {wrong}")
    rep.line("kernel_design agrees with the C launcher's flash_design for the forward, dq, "
             "dk/dv and the single pass at every dtype and head_dim")


def check_prologue_design_rule(fused, build, rep: Report) -> None:
    """``fused.prologue_kernel_design``, by which the prologue wrapper counts
    launches, against ``prologue_design``, the rule the C launcher takes its
    design by, at every dtype, even head_dim from 16 to 128 and a few head
    counts and hidden sizes."""
    lib = fused._kernels()
    shapes = [(32, 8, 4096), (8, 1, 320), (14, 2, 1024), (6, 3, 512), (4, 2, 96), (8, 8, 64)]
    wrong = [(str(dtype), H, Hkv, D, E) for dtype, code in build.DTYPE_CODES.items()
             for D in range(16, 129, 2) for H, Hkv, E in shapes
             if lib.prologue_design(code, H, Hkv, D, E)
             != (fused.prologue_kernel_design(dtype, H, Hkv, D, E) == "wgmma")]
    if wrong:
        fail(f"prologue_kernel_design and the C launcher's prologue_design disagree on "
             f"{wrong[:8]}")
    rep.line("prologue_kernel_design agrees with the C launcher's prologue_design at every "
             "dtype and even head_dim 16-128")


def kernel_phase(torch, port, fa, fused, build, rep: Report,
                 check_only: bool = False) -> list[dict]:
    import torch.nn.functional as F

    check_design_rule(fa, build, rep)
    check_prologue_design_rule(fused, build, rep)
    bf16, fp16 = torch.bfloat16, torch.float16
    cases = [
        ("noncausal", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=bf16, causal=False)),
        ("mha_g1", dict(B=2, S=200, H=4, Hkv=4, D=128, dtype=bf16)),
        ("gqa_g4", dict(B=2, S=200, H=8, Hkv=2, D=128, dtype=bf16)),
        ("window", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=bf16, window=50)),
        # dq's 64-row kv tiles: a partial last tile, window edges inside tiles, G = 4
        ("gqa_g4_window_d64_s300", dict(B=2, S=300, H=8, Hkv=2, D=64, dtype=bf16, window=100)),
        ("window_across_128_rows", dict(B=2, S=384, H=4, Hkv=2, D=128, dtype=bf16, window=160)),
        ("kv_lengths_zero_row", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=bf16,
                                     causal=False, lens=[0, 130])),
        ("kv_lengths_zero_row_d128", dict(B=2, S=200, H=4, Hkv=2, D=128, dtype=bf16,
                                          lens=[0, 130])),
        ("kv_longer_than_q", dict(B=2, S=64, Skv=200, H=4, Hkv=2, D=64, dtype=bf16)),
        ("q_longer_than_kv", dict(B=2, S=200, Skv=100, H=4, Hkv=2, D=64, dtype=bf16)),
        ("s129_d128", dict(B=2, S=129, H=4, Hkv=2, D=128, dtype=bf16)),
        ("s255_d64", dict(B=2, S=255, H=4, Hkv=2, D=64, dtype=bf16)),
        ("fp16", dict(B=2, S=200, H=4, Hkv=2, D=64, dtype=fp16)),
        ("fp16_d128_s255", dict(B=2, S=255, H=4, Hkv=1, D=128, dtype=fp16)),
        ("d96_wmma", dict(B=2, S=200, H=4, Hkv=2, D=96, dtype=bf16)),
        ("fp32", dict(B=2, S=100, H=4, Hkv=2, D=64, dtype=torch.float32)),
        ("fp32_window_lengths", dict(B=2, S=100, H=4, Hkv=2, D=128, dtype=torch.float32,
                                     window=30, lens=[100, 7])),
    ]
    cases += bert_cases(torch)
    cases.append(("main_bf16_causal", dict(**MAIN, dtype=bf16)))
    failed, reading, abs_errs = run_cases(torch, fa, cases, rep)
    main_abs_errs, main_launched = abs_errs, dict(reading["launched"])
    pro_main = dict(B=MAIN["B"], S=MAIN["S"], E=4096, H=MAIN["H"], Hkv=MAIN["Hkv"], D=MAIN["D"])
    # wgmma design: bf16/fp16 at D 64 and 128; wmma: fp32 and D 96
    prologue_cases = [
        ("bias", dict(B=1, S=256, E=512, H=8, Hkv=2, D=64, dtype=bf16, bias=True)),
        ("gqa_14_2_tile256", dict(B=1, S=128, E=1024, H=14, Hkv=2, D=128, dtype=bf16)),
        ("rows_not_filling_a_tile", dict(B=1, S=200, E=512, H=8, Hkv=4, D=64, dtype=bf16)),
        ("fp16", dict(B=1, S=256, E=512, H=8, Hkv=2, D=64, dtype=torch.float16, bias=True)),
        ("fp32", dict(B=1, S=200, E=256, H=4, Hkv=2, D=64, dtype=torch.float32, bias=True)),
        # rope's partner 32 columns away, in a 64-column tile and in a 192-column
        # tile (three 64-wide wgmmas)
        ("d64_tile64", dict(B=1, S=256, E=512, H=4, Hkv=1, D=64, dtype=bf16)),
        ("d64_tile192", dict(B=1, S=256, E=512, H=6, Hkv=3, D=64, dtype=bf16, bias=True)),
        ("tile128_h8_hkv1", dict(B=1, S=256, E=512, H=8, Hkv=1, D=128, dtype=bf16)),
        # rows that fill no 128-row tile, and rows past a tile edge
        ("rows_s200", dict(B=1, S=200, E=512, H=8, Hkv=2, D=128, dtype=bf16)),
        ("rows_s300", dict(B=1, S=300, E=1024, H=32, Hkv=8, D=128, dtype=bf16)),
        # E not a multiple of the ring's depth x 64; E of one k-step
        ("e320", dict(B=1, S=256, E=320, H=8, Hkv=2, D=64, dtype=bf16)),
        ("e64_s130", dict(B=1, S=130, E=64, H=4, Hkv=2, D=64, dtype=torch.float16)),
        ("bias_d128", dict(B=2, S=128, E=512, H=8, Hkv=2, D=128, dtype=bf16, bias=True)),
        ("d96_wmma", dict(B=1, S=200, E=512, H=8, Hkv=2, D=96, dtype=bf16, bias=True)),
        ("main_bf16", dict(**pro_main, dtype=bf16)),
    ]
    for name, kw in prologue_cases:
        reading, pro_abs_err = check_prologue_case(torch, fused, name, **kw)
        rep.line(json.dumps(reading))
        if reading["bad"]:
            failed.append(f"prologue {name}: {reading['bad']}")
    main_abs_errs["qkv_prologue"] = pro_abs_err
    main_launched["qkv_prologue"] = reading["launched"]
    # no fallback: a CUDA tensor a kernel does not take is refused, never
    # routed to the plain version
    q, k, v, _ = make_inputs(torch, 1, 64, 2, 1, 64, bf16)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    d40 = tuple(x[..., :40].contiguous() for x in (q, k, v))  # head_dim not a multiple of 16
    pargs, pstat = prologue_inputs(torch, fused, B=1, S=64, E=256, H=4, Hkv=2, D=40, dtype=bf16)
    leaf = [torch.ones(8, device="cuda") for _ in range(4)]
    refusals = (
        ("forward: strided q", lambda: fa.flash_fwd(strided, k, v, 0.125, True)),
        ("forward: head_dim 40", lambda: fa.flash_fwd(*d40, 0.125, True)),
        ("dq: strided q", lambda: fa.flash_bwd_dq(
            strided, k, v, q, *(torch.zeros(1, 2, 64, device="cuda"),) * 2, 0.125)),
        ("dk/dv: head_dim 40", lambda: fa.flash_bwd_dkv(
            *d40, d40[0], *(torch.zeros(1, 2, 64, device="cuda"),) * 2, 0.125)),
        ("single-pass backward: strided q", lambda: fa.flash_bwd_fused(
            strided, k, v, q, *(torch.zeros(1, 2, 64, device="cuda"),) * 2, 0.125)),
        ("prologue: head_dim 40 (an 80-column tile)", lambda: fused.qkv_prologue(*pargs,
                                                                                 **pstat)),
        ("epilogue: a bf16 leaf", lambda: fused.adamw_epilogue(
            [leaf[0].to(bf16)], [leaf[1]], [leaf[2]], [leaf[3]],
            fused.epilogue_scalars(0.9, 0.999, 1, -1e-3, True, "cuda"), b1=0.9, b2=0.999,
            eps=1e-8, eps_root=0.0, weight_decay=1e-4)),
    )
    for name, call in refusals:
        try:
            call()
        except ValueError:
            continue
        fail(f"a kernel wrapper took an input its kernel does not: {name}")
    rep.line(f"kernel wrappers refuse: {'; '.join(n for n, _ in refusals)}")
    if failed:
        fail(f"kernel outputs beyond tolerance: {'; '.join(failed)}")
    check_epilogue(torch, port, fused, rep)
    main_abs_errs["adamw_epilogue"] = 0.0  # bitwise, or the check failed
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
        "flash_bwd_fused": (lambda: fa.flash_bwd_fused(q, k, v, dout, lse, delta, scale, True),
                            lambda: fa.flash_bwd_fused_reference(q, k, v, dout, lse, delta,
                                                                 scale, True)),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
    library_bwd = time_library_bwd(torch, q, k, v, dout, scale, flush, rep)
    library = {"flash_fwd": library_fwd, "flash_bwd_fused": library_bwd}

    pairs = visible_pairs(torch, S, S, True) * B * H
    e = 2  # bytes per bf16 element
    qo = B * S * H * D * e  # q, o, do or dq
    kv = B * S * Hkv * D * e  # k, v, dk or dv
    stat = B * H * S * 4  # lse or delta
    work = {  # (FLOP, bytes, peak FLOP/s): each input read once, each output written once
        "flash_fwd": (2 * 2 * D * pairs, qo + 2 * kv + qo + stat, PEAK_BF16_FLOPS),
        "flash_bwd_dq": (3 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + qo, PEAK_BF16_FLOPS),
        "flash_bwd_dkv": (4 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + 2 * kv,
                          PEAK_BF16_FLOPS),
        "flash_bwd_fused": (5 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + qo + 2 * kv,
                            PEAK_BF16_FLOPS),
    }

    # the prologue at the main path's shape
    pargs, pstat = prologue_inputs(torch, fused, **pro_main, dtype=bf16, seed=2)
    kernel_fns["qkv_prologue"] = (lambda: fused.qkv_prologue(*pargs, **pstat),
                                  lambda: fused._prologue_reference_tables(*pargs, **pstat))
    rows_, E = B * S, pro_main["E"]
    W = (H + 2 * Hkv) * D
    work["qkv_prologue"] = (2 * rows_ * E * W,
                            rows_ * E * e + W * E * e + E * 4 + 2 * rows_ * D * 4 + rows_ * W * e,
                            PEAK_BF16_FLOPS)
    xn = fused.rms_norm_reference(pargs[0], pargs[1], eps=1e-5, norm_offset=False)
    wcat = torch.cat(pargs[2:5])
    linear_ms = time_ms(torch, lambda: F.linear(xn, wcat), 20, flush)
    del xn, wcat

    rows = []
    for wrapper, (kernel_name, _, _, design) in KERNELS.items():
        if wrapper == "adamw_epilogue":
            continue
        kfn, pfn = kernel_fns[wrapper]
        ms = time_ms(torch, kfn, 20, flush)
        plain_ms = time_ms(torch, pfn, 5, flush)
        design = design or "+".join(main_launched[wrapper])
        rows.append(kernel_row(wrapper, design, ms, plain_ms, *work[wrapper],
                               main_abs_errs[wrapper], library.get(wrapper)))
        rep.line(f"{kernel_name} at the main shape (bf16): {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                 f"bound {rows[-1]['bound_ms']:.4f} ms by {rows[-1]['bound_by']}, "
                 f"{work[wrapper][0] / ms / 1e9:.1f} TFLOP/s)")
    del pargs
    rep.line(f"yardstick for qkv_prologue_kernel: F.linear of the pre-normed bf16 x "
             f"({rows_}, {E}) against the concatenated ({W}, {E}) weight (cuBLAS alone, no "
             f"norm, bias or rope) {linear_ms:.4f} ms")

    # dq + dk/dv against the single pass and PyTorch's flash backward op (a
    # yardstick: no single PyTorch call computes dq alone or dk/dv alone)
    def two_pass_bwd():
        fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, True)
        fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, True)

    two_pass_ms = time_ms(torch, two_pass_bwd, 20, flush)
    rep.line(f"flash_bwd_dq_kernel + flash_bwd_dkv_kernel at the main shape (bf16): "
             f"{two_pass_ms:.4f} ms, {(3 + 4) * 2 * D * pairs / two_pass_ms / 1e9:.1f} TFLOP/s; "
             f"yardstick: PyTorch's flash backward op {library_bwd:.4f} ms (all of dq, dk, dv, "
             f"no GQA sum)")

    # the backward as a whole against SDPA's (a yardstick: no single
    # PyTorch call computes dq alone, dk/dv alone or the single pass)
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

    def port_fwd_fused_bwd():
        o, l = fa.flash_fwd(q, k, v, scale, True)
        fa.flash_bwd_fused(q, k, v, dout, l, fa.attention_delta(o, dout), scale, True)

    rep.line(f"fwd+bwd at {MAIN}: port kernels {time_ms(torch, port_fwd_bwd, 10, flush):.4f} ms, "
             f"with the single-pass backward {time_ms(torch, port_fwd_fused_bwd, 10, flush):.4f} "
             f"ms, F.scaled_dot_product_attention {time_ms(torch, sdpa_fwd_bwd, 10, flush):.4f} "
             "ms (yardstick only)")
    del q, k, v, dout, out, lse, delta, qg, kg, vg, dout_t
    rows.append(time_epilogue(torch, port, fused, rep, flush, main_abs_errs["adamw_epilogue"]))
    return rows


def time_library_bwd(torch, q, k, v, dout, scale, flush, rep: Report, shape="the main shape"):
    """One call of PyTorch's flash-attention backward op at the main shape:
    B4's library time. It is fed the output, logsumexp and philox values of
    its own forward op, with k and v expanded to the query heads (the op
    takes no GQA); it returns dq, dk and dv per query head, so the GQA sum
    that B4 also does is not in it."""
    G = q.shape[2] // k.shape[2]
    qt, dt = q.transpose(1, 2), dout.transpose(1, 2)
    ke, ve = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(qt, ke, ve, 0.0, True, False,
                                                             scale=scale)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    ms = time_ms(torch, lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dt, qt, ke, ve, out, lse, cum_q, cum_k, max_q, max_k, 0.0, True, seed, offset,
        scale=scale), 20, flush)
    rep.line(f"library for flash_bwd_fused_kernel: "
             f"torch.ops.aten._scaled_dot_product_flash_attention_backward at {shape} "
             f"(k, v expanded to {q.shape[2]} heads) {ms:.4f} ms")
    return ms


def kernel_row(wrapper, design, ms, plain_ms, flops, nbytes, peak, max_abs_err,
               library_ms) -> dict:
    kernel_name, replaces, source, _ = KERNELS[wrapper]
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {
        "name": kernel_name, "route": "cuda", "design": design, "source": source,
        "replaces": replaces,
        "launches": None, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def time_epilogue(torch, port, fused, rep: Report, flush, max_abs_err) -> dict:
    """The epilogue kernel, its plain version and the library call
    ``torch._fused_adamw_`` over the main path's 39 leaves. PyTorch's fused
    AdamW (with eps_root 0, as here) computes the same update, p (1 - lr wd)
    - (lr / bc1) mu' / (sqrt(nu') / sqrt(bc2) + eps), and its ``found_inf``
    holds a non-finite step; only the rounding order differs from optax's,
    so it is not bitwise the plain version and the port cannot call it."""
    cfg = port.TransformerConfig.llama3_8b(num_layers=NUM_LAYERS)
    shapes = main_tree_shapes(cfg)
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4)
    cols = [list(c) for c in zip(*(epilogue_leaf(torch, s, i) for i, s in enumerate(shapes)))]
    row = fused.epilogue_scalars(hp["b1"], hp["b2"], 3, -3e-4, True, "cuda")
    ms = time_ms(torch, lambda: fused.adamw_epilogue(*cols, row, **hp), 5, flush)

    def plain():
        for leaf in zip(*cols):
            fused.adamw_leaf_reference(*leaf, row, **hp)

    plain_ms = time_ms(torch, plain, 3, flush)
    g, p, mu, nu = cols
    steps = [torch.full((), 3.0, device="cuda") for _ in p]
    found_inf = torch.zeros((), device="cuda")
    library_ms = time_ms(torch, lambda: torch._fused_adamw_(
        p, g, mu, nu, [], steps, lr=3e-4, beta1=0.9, beta2=0.999, weight_decay=1e-4, eps=1e-8,
        amsgrad=False, maximize=False, found_inf=found_inf), 5, flush)
    n = sum(math.prod(s) for s in shapes)
    del cols, g, p, mu, nu
    torch.cuda.empty_cache()
    # 28 B per value: read g, p, mu, nu, write p, mu, nu; ~15 fp32 operations each
    out = kernel_row("adamw_epilogue", KERNELS["adamw_epilogue"][3], ms, plain_ms, 15 * n,
                     28 * n, PEAK_FP32_FLOPS, max_abs_err, library_ms)
    rep.line(f"adamw_kernel over the main path's {len(shapes)} leaves ({n} values, one launch): "
             f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms by "
             f"{out['bound_by']}, {28 * n / ms / 1e6:.1f} GB/s); library "
             f"torch._fused_adamw_ over the same tensors {library_ms:.4f} ms")
    return out


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


def small_fused_phase(torch, port, fa, fused, rep: Report, seed: int) -> None:
    """A tiny fused_kernels=True CausalLM with fused_adamw and the
    single-pass backward, 3 unified_steps in fp32 on the card (prologue,
    flash forward, single-pass backward and epilogue kernels) against the
    same weights and batches, made from ``seed``, on the CPU's plain path."""
    cfg = port.TransformerConfig.tiny(vocab_size=512, hidden_size=128, num_heads=4,
                                      num_kv_heads=2, attention_impl="flash",
                                      fused_kernels=True)
    init = port.CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    ids = torch.randint(0, cfg.vocab_size, (3, 2, 96),
                        generator=torch.Generator().manual_seed(seed + 1)).numpy()
    dataset = [{"input_ids": ids[i // 2][i % 2]} for i in range(6)]
    runs = {}
    wrappers = (*fa.KERNEL_WRAPPERS, *fused.KERNEL_WRAPPERS)
    fa.FUSED_BWD = True
    try:
        for device in ("cpu", "cuda"):
            port.AcceleratorState._reset_state(reset_partial_state=True)
            port.GradientState._reset_state()
            acc = port.Accelerator(cpu=device == "cpu")
            model = port.CausalLM(cfg, device=device)
            model.load_state_dict(init.state_dict())
            model, opt, loader = acc.prepare(model, port.fused_adamw(1e-3),
                                             port.DataLoader(dataset, batch_size=2))
            step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
            carry = acc.init_carry(model, opt)
            reset_counts(wrappers)
            curve = []
            for batch in loader:
                carry, m = step(carry, batch)
                curve.append((float(m["loss"]), float(m["grad_norm"])))
            launches = {w.__name__: w.launches for w in wrappers}
            runs[device] = (curve, {k: t.detach().cpu() for k, t in carry["params"].items()},
                            launches)
    finally:
        fa.FUSED_BWD = False
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
    (cpu_curve, cpu_params, _), (gpu_curve, gpu_params, launches) = runs["cpu"], runs["cuda"]
    curve_err = max(abs(a - b) / abs(b) for ga, gb in zip(gpu_curve, cpu_curve)
                    for a, b in zip(ga, gb))
    # AdamW divides each moment by its root: an element whose gradient is
    # near zero moves by up to lr on a last-bit difference in the gradient,
    # so neither the largest element error nor a small leaf's error says
    # much (final_norm's 128 values read 2.6e-3 of their update on a correct
    # card). A wrong kernel moves many elements; the error's norm over the
    # update's norm, over the whole tree, sees that.
    init_params = init.state_dict()
    diff = math.sqrt(sum(float((gpu_params[k] - cpu_params[k]).square().sum())
                         for k in cpu_params))
    update = math.sqrt(sum(float((cpu_params[k] - init_params[k]).square().sum())
                           for k in cpu_params))
    update_err = diff / (update + 1e-30)
    leaf_err = {k: float((gpu_params[k] - cpu_params[k]).norm()
                         / ((cpu_params[k] - init_params[k]).norm() + 1e-30)) for k in cpu_params}
    worst = max(leaf_err, key=leaf_err.get)
    param_err = max(rel_err(torch, gpu_params[k], cpu_params[k]) for k in cpu_params)
    rep.line(f"small fused model fp32, seed {seed}, 3 steps: losses/grad norms card "
             f"{gpu_curve} vs CPU {cpu_curve} (max rel err {curve_err:.3g}); final params: "
             f"|card - CPU| / |CPU update| {update_err:.3g} over the tree, at most "
             f"{leaf_err[worst]:.3g} in one leaf ({worst}), max element error over the "
             f"tensor's max {param_err:.3g}; card launches {json.dumps(launches)}")
    want = {"flash_fwd": 6, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_fused": 6,
            "qkv_prologue": 6, "adamw_epilogue": 3}  # 2 layers x 3 steps; one epilogue a step
    if launches != want:
        fail(f"small fused model launches {launches}, want {want}")
    if not (len(gpu_curve) == 3 and curve_err <= 1e-4 and update_err <= SMALL_UPDATE_TOL):
        fail(f"small fused model (seed {seed}): the card's kernels disagree with the CPU "
             f"plain path: losses/grad norms {curve_err:.3g} (limit 1e-4), params "
             f"{update_err:.3g} of the update (limit {SMALL_UPDATE_TOL})")


def reset_counts(wrappers) -> None:
    """Every launch counter to 0, the flash wrappers' per-design ones too."""
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "by_design"):
            w.by_design = dict.fromkeys(w.by_design, 0)


def build_path(torch, port, fused_kernels: bool, fused_optimizer: bool, seed: int = 0):
    """The 4-layer llama3_8b-width CausalLM in bf16 (``fused_kernels`` as
    given) with ``fused_adamw`` or ``adamw`` (lr 3e-4) and global-norm
    clipping at 1.0, its weights and one batch of synthetic tokens made
    from ``seed``; the batch repeats every step, so the loss must fall.
    Returns the step, its carry, the loader and the parameter count."""
    cfg = port.TransformerConfig.llama3_8b(num_layers=NUM_LAYERS, dtype="bfloat16",
                                           max_seq_len=MAIN["S"], fused_kernels=fused_kernels)
    gc.collect()
    torch.cuda.empty_cache()  # hand back what earlier phases cached
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(mixed_precision="bf16")
    model = port.CausalLM(cfg, device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (MAIN["B"], MAIN["S"]),
                           generator=torch.Generator().manual_seed(seed)).numpy()
    dataset = [{"input_ids": tokens[i % MAIN["B"]]} for i in range(STEPS * MAIN["B"])]
    if [tuple(p.shape) for p in model.parameters()] != main_tree_shapes(cfg):
        fail("the path's parameter shapes are not main_tree_shapes'")
    optimizer = (port.fused_adamw if fused_optimizer else port.adamw)(3e-4)
    model, opt, loader = acc.prepare(model, optimizer,
                                     port.DataLoader(dataset, batch_size=MAIN["B"]))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    torch.cuda.synchronize()
    return step, carry, loader, n_params


def run_steps(torch, step, carry, loader):
    """Every batch of ``loader`` through ``step``. Returns the carry, the
    last batch, the losses, the grad norms and each step's seconds (host
    clock around the step, ending in a synchronise)."""
    losses, norms, times = [], [], []
    for batch in loader:
        t0 = time.perf_counter()
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return carry, batch, losses, norms, times


def main_path_phase(torch, port, wrappers, rep: Report, fused_path: bool = False):
    """The main path (``fused_path`` False: unfused model, adamw, two-pass
    backward) or the fused path (``fused_kernels=True``, ``fused_adamw``,
    ``FUSED_BWD``), trained for STEPS steps with every launch counter in
    ``wrappers`` set to 0 just before and read just after. Returns the
    counts and the losses."""
    name = "fused path" if fused_path else "main path"
    t0 = time.perf_counter()
    step, carry, loader, n_params = build_path(torch, port, fused_path, fused_path)
    rep.line(f"{name} set-up: {n_params} params ({NUM_LAYERS} layers at llama3_8b "
             f"width), {time.perf_counter() - t0:.2f} s")

    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    carry, batch, losses, norms, times = run_steps(torch, step, carry, loader)
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    peak = torch.cuda.max_memory_allocated()

    steady = statistics.median(times[1:])  # the first step pays one-time set-up
    tokens_per_step = MAIN["B"] * MAIN["S"]
    rep.line(f"{name} losses {losses}, grad norms {norms}")
    rep.line(f"{name} step seconds {times}; median of steps 2-{STEPS} {steady} s, "
             f"{tokens_per_step / steady} tokens/s; peak memory {peak / 2**30} GiB")
    rep.line(f"{name} kernel launches {json.dumps(launches)}, by design {json.dumps(by_design)}")
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{name} losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name} loss did not fall on a repeated batch: {losses}")
    if carry["opt_step"] != STEPS:
        fail(f"{name} took {carry['opt_step']} optimizer steps, not {STEPS}")
    per_layer = NUM_LAYERS * STEPS
    if fused_path:  # one epilogue launch a step, over every leaf
        want = {"flash_fwd": per_layer, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "flash_bwd_fused": per_layer, "qkv_prologue": per_layer, "adamw_epilogue": STEPS}
    else:
        want = {"flash_fwd": per_layer, "flash_bwd_dq": per_layer, "flash_bwd_dkv": per_layer,
                "flash_bwd_fused": 0, "qkv_prologue": 0, "adamw_epilogue": 0}
    if launches != want:
        fail(f"{name} kernel launches {launches}, want {want}")
    # every flash kernel counted under the wgmma design only
    want_design = {w: {"wgmma": want[w], "wmma": 0} for w in by_design}
    if by_design != want_design:
        fail(f"{name} launches by design {by_design}, want {want_design}")
    ran = profile_step(torch, step, carry, batch, rep, name)
    # the profiler names the kernels that ran: the wgmma ones, no wmma twin
    want_ran = {KERNELS[w][0] for w, n in want.items() if n}
    if want["qkv_prologue"]:  # the wgmma design's pre-pass
        want_ran.add("qkv_prologue_rstd_kernel")
    if ran is None:
        rep.line(f"{name} profiled step: kernel names not checked (no device time seen)")
    elif ran != want_ran:
        fail(f"{name} profiled step ran the port's kernels {sorted(ran)}, want {sorted(want_ran)}")
    return launches, losses


def check_path_losses(losses, fused_losses, rep: Report) -> None:
    """The fused path computes the main path's step with other kernels and
    other summation orders: its loss curve stays within PATH_LOSS_TOL of
    the main path's, step by step."""
    rel = [abs(f - m) / abs(m) for f, m in zip(fused_losses, losses)]
    rep.line(f"fused path against main path: relative loss difference by step {rel}, "
             f"limits {list(PATH_LOSS_TOL)}")
    if len(rel) != len(PATH_LOSS_TOL) or any(not r <= lim for r, lim in zip(rel, PATH_LOSS_TOL)):
        fail(f"the fused path's losses {fused_losses} left the main path's {losses}: "
             f"relative differences {rel}, limits {list(PATH_LOSS_TOL)}")


def profile_step(torch, step, carry, batch, rep: Report, name: str):
    """One more step of the path (after its counts were read) under
    torch.profiler: device time by kernel group, the optimizer epilogue's
    device range, and the device's busy share of the step's wall time (the
    profiler's own cost included). Returns the names of the port's kernels
    that ran, or None when the profiler saw no device time."""
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
        rep.line(f"{name} profiled step: the profiler saw no device time (not measured)")
        return None
    groups = {"flash attention kernels": 0.0, "prologue kernel": 0.0, "epilogue kernel": 0.0,
              "matmul (cuBLAS)": 0.0, "other": 0.0}
    for key, ms in kernels.items():
        if "flash_" in key and "_kernel" in key:
            groups["flash attention kernels"] += ms
        elif "qkv_prologue" in key and "_kernel" in key:  # the pre-pass too
            groups["prologue kernel"] += ms
        elif "adamw_kernel" in key:
            groups["epilogue kernel"] += ms
        elif any(t in key.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")):
            groups["matmul (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    rep.line(f"{name} profiled step: wall {wall_ms} ms, device busy {busy_ms} ms "
             f"({100 * busy_ms / wall_ms} %), by kernel group ms {json.dumps(groups)}, "
             f"optimizer epilogue (unified_step.sync_apply) {epilogue_ms} ms on the device")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        rep.line(f"{name} profiled step: {ms} ms {key[:110]}")
    return {m.group(1) for key in kernels
            for m in [re.search(r"\b((?:flash|qkv|adamw)\w*_kernel)\b", key)] if m}


def bert_cases(torch) -> list:
    dtypes = (torch.bfloat16, torch.float16)
    return [(name, dict(kw, dtype=dt)) for (name, kw), dt in zip(BERT_CASES, dtypes)]


def run_cases(torch, fa, cases, rep: Report):
    """Every flash case through ``check_case``, each reading printed.
    Returns the failures and the last case's reading and max abs errors."""
    failed = []
    for name, kw in cases:  # every case runs; the caller fails after the last
        reading, abs_errs = check_case(torch, fa, name, **kw)
        rep.line(json.dumps(reading))
        if reading["bad"]:
            failed.append(f"{name}: {reading['bad']}")
    return failed, reading, abs_errs


def bert_lengths(B: int, S: int, seed: int):
    """Right-padding lengths drawn from [64, S], seeded; the first is S."""
    import numpy as np

    lens = np.random.default_rng(seed).integers(64, S + 1, size=B)
    lens[0] = S
    return lens


def time_bert_kernels(torch, fa, rep: Report) -> list[dict]:
    """B1-B3 at the BERT phase's shape (B 32, S 512, 12 heads, head_dim 64,
    bf16, non-causal, seeded right-padding lengths): each output's max abs
    error against the plain version on these inputs, and the times of
    kernel, plain version and, for B1, SDPA with the (B, 1, 1, S) key mask.
    Bounds count the visible pairs (every query row against its row's real
    keys) and read k and v up to each row's length."""
    import torch.nn.functional as F

    B, S, H, D = (BERT[k] for k in ("B", "S", "H", "D"))
    lens = bert_lengths(B, S, seed=3)
    q, k, v, dout = make_inputs(torch, B, S, H, H, D, torch.bfloat16, seed=3)
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    args = (scale, False, kvl)
    out, lse = fa.flash_fwd(q, k, v, *args)
    delta = fa.attention_delta(out, dout)
    absmax = lambda a, b: float((a.float() - b.float()).abs().max())  # noqa: E731
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, *args)
    abs_errs = {
        "flash_fwd": absmax(out, ref_out),
        "flash_bwd_dq": absmax(fa.flash_bwd_dq(q, k, v, dout, lse, delta, *args),
                               fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, *args)),
        "flash_bwd_dkv": max(absmax(a, b) for a, b in zip(
            fa.flash_bwd_dkv(q, k, v, dout, lse, delta, *args),
            fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, *args))),
    }
    del ref_out, ref_lse
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB of L2
    flush = scratch.zero_
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *args),
                      lambda: fa.flash_fwd_reference(q, k, v, *args)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, *args),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, *args)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, *args),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, *args)),
    }
    keep = (torch.arange(S, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep), 20, flush)
    pairs = int(lens.sum()) * S * H
    e = 2
    qo, kv_full = B * S * H * D * e, B * S * H * D * e
    kv_real, stat = int(lens.sum()) * H * D * e, B * H * S * 4
    work = {  # (FLOP, bytes): inputs read once (k, v up to each length), outputs written once
        "flash_fwd": (2 * 2 * D * pairs, qo + 2 * kv_real + qo + stat),
        "flash_bwd_dq": (3 * 2 * D * pairs, 2 * qo + 2 * kv_real + 2 * stat + qo),
        "flash_bwd_dkv": (4 * 2 * D * pairs, 2 * qo + 2 * kv_real + 2 * stat + 2 * kv_full),
    }
    rows = []
    for wrapper, (kfn, pfn) in fns.items():
        ms = time_ms(torch, kfn, 20, flush)
        plain_ms = time_ms(torch, pfn, 3, flush)
        row = kernel_row(wrapper, fa.kernel_design(torch.bfloat16, D), ms, plain_ms,
                         *work[wrapper], PEAK_BF16_FLOPS, abs_errs[wrapper],
                         library_fwd if wrapper == "flash_fwd" else None)
        row["shape"] = (f"bert_base B{B} S{S} H{H} Hkv{H} D{D} bf16 non-causal, kv_lengths "
                        f"{int(lens.min())}-{int(lens.max())} (mean {float(lens.mean())})")
        rows.append(row)
        rep.line(f"{KERNELS[wrapper][0]} at the BERT shape: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                 f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                 f"{work[wrapper][0] / ms / 1e9:.1f} TFLOP/s of visible pairs)")
    rep.line(f"library for flash_fwd_kernel at the BERT shape: F.scaled_dot_product_attention "
             f"with the (B, 1, 1, S) key mask {library_fwd:.4f} ms")

    qg, kg, vg = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    dout_t = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
        torch.autograd.grad(o, (qg, kg, vg), dout_t)

    def port_fwd_bwd():
        o, l = fa.flash_fwd(q, k, v, *args)
        d = fa.attention_delta(o, dout)
        fa.flash_bwd_dq(q, k, v, dout, l, d, *args)
        fa.flash_bwd_dkv(q, k, v, dout, l, d, *args)

    rep.line(f"fwd+bwd at the BERT shape: port kernels {time_ms(torch, port_fwd_bwd, 10, flush):.4f} "
             f"ms, F.scaled_dot_product_attention with the key mask "
             f"{time_ms(torch, sdpa_fwd_bwd, 10, flush):.4f} ms (yardstick only)")
    return rows


def bert_rows(n: int, vocab: int, seed: int) -> list[dict]:
    """Right-padded rows of the classifier's batch keys, seeded: lengths in
    [64, S] with the first row at S, ids past a row's length 0."""
    import numpy as np

    S = BERT["S"]
    lens = bert_lengths(n, S, seed)
    rng = np.random.default_rng(seed + 1)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(4, vocab, size=(n, S)).astype(np.int32) * mask
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    return [{"input_ids": ids[i], "attention_mask": mask[i], "labels": labels[i]}
            for i in range(n)]


def bert_trainer(torch, port, seed: int):
    """bert_base at full width and depth, bf16 compute with fp32 masters,
    adamw with the examples' warmup-cosine schedule and weight decay 0.01,
    clip 1.0; a shuffled torch loader of the training rows and an eval
    loader whose size is not a multiple of its batch."""
    from torch.utils.data import DataLoader as TorchLoader

    from accelerate_tpu_torch.examples.nlp_example import collate_fn

    gc.collect()
    torch.cuda.empty_cache()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(mixed_precision="bf16")
    cfg = port.TransformerConfig.bert_base(dtype="bfloat16")
    model = port.SequenceClassifier(cfg, num_labels=2, device=acc.device,
                                    generator=torch.Generator(acc.device).manual_seed(seed))
    B = BERT["B"]
    train = TorchLoader(bert_rows(BERT["steps"] * B, cfg.vocab_size, seed=11), batch_size=B,
                        shuffle=True, collate_fn=collate_fn)
    evals = TorchLoader(bert_rows(BERT["eval_rows"], cfg.vocab_size, seed=12),
                        batch_size=BERT["eval_batch"], shuffle=False, collate_fn=collate_fn)
    schedule = port.warmup_cosine_decay_schedule(0.0, 2e-4, 2, BERT["steps"])
    model, opt, train, evals = acc.prepare(model, port.adamw(schedule, weight_decay=0.01),
                                           train, evals)
    step = acc.unified_step(port.SequenceClassifier.loss_fn(model), opt, max_grad_norm=1.0)
    return acc, model, opt, train, evals, step, acc.init_carry(model, opt)


def train_bert(torch, step, carry, loader, n: int):
    """At most ``n`` batches of ``loader`` through ``step``: the carry, the
    losses, each step's seconds (host clock ending in a synchronise), the
    real tokens (the attention mask's sum) of each batch, and the last
    batch."""
    losses, times, real = [], [], []
    for i, batch in enumerate(loader):
        if i == n:
            break
        t0 = time.perf_counter()
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        real.append(int(batch["attention_mask"].sum()))
        last = batch
    return carry, losses, times, real, last


def bert_phase(torch, port, wrappers, rep: Report) -> dict:
    """The BERT path: bert_base (12 layers, 768 wide, 12 heads of 64) at
    B 32, S 512, where auto-dispatch itself takes B1-B3 (non-causal, the
    mask lowered to kv_lengths): 6 unified_steps and one eval pass, with
    every launch counter set to 0 just before and read just after; then the
    resume: 3 steps, save_state, a fresh accelerator and a model from
    another seed, load_state, skip_first_batches(3), 3 steps, which must
    equal the uninterrupted run bit for bit. Returns the launch counts."""
    import tempfile

    B, S, steps = BERT["B"], BERT["S"], BERT["steps"]
    t0 = time.perf_counter()
    acc, model, opt, train, evals, step, carry = bert_trainer(torch, port, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    rep.line(f"bert phase set-up: {n_params} params (bert_base: 12 layers, hidden 768, 12 heads "
             f"of 64), {time.perf_counter() - t0:.2f} s")
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    carry, losses, times, real, batch = train_bert(torch, step, carry, train, steps)
    peak = torch.cuda.max_memory_allocated()
    correct = total = 0
    with torch.no_grad():
        for batch in evals:
            pred = model(batch["input_ids"], batch["attention_mask"]).argmax(dim=-1)
            pred, ref = acc.gather_for_metrics((pred, batch["labels"]))
            correct += int((pred == ref).sum())
            total += int(ref.shape[0])
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}

    steady = statistics.median(times[1:])
    real_per_step = statistics.mean(real[1:])
    rep.line(f"bert phase losses {losses}")
    rep.line(f"bert phase step seconds {times}; median of steps 2-{steps} {steady} s, "
             f"{B * S / steady} tokens/s padded (B*S), {real_per_step / steady} tokens/s real "
             f"(mask sum, {real_per_step} a step); peak memory {peak / 2**30} GiB")
    rep.line(f"bert phase eval: {total} rows gathered of {BERT['eval_rows']} (batch "
             f"{BERT['eval_batch']}), accuracy {correct / max(total, 1)}")
    rep.line(f"bert phase kernel launches {json.dumps(launches)}, by design {json.dumps(by_design)}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"bert phase losses not finite: {losses}")
    if carry["opt_step"] != steps:
        fail(f"bert phase took {carry['opt_step']} optimizer steps, not {steps}")
    if total != BERT["eval_rows"]:
        fail(f"bert phase: gather_for_metrics returned {total} rows, not {BERT['eval_rows']}")
    n_eval = math.ceil(BERT["eval_rows"] / BERT["eval_batch"])
    layers = model.config.num_layers
    want = {"flash_fwd": layers * (steps + n_eval), "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps, "flash_bwd_fused": 0, "qkv_prologue": 0,
            "adamw_epilogue": 0}
    if launches != want:
        fail(f"bert phase kernel launches {launches}, want {want}")
    want_design = {w: {"wgmma": want[w], "wmma": 0} for w in by_design}
    if by_design != want_design:
        fail(f"bert phase launches by design {by_design}, want {want_design}")
    straight = {k: t.detach().clone() for k, t in carry["params"].items()}
    # one more step under the profiler (after the counts were read): the
    # port's kernels in it must be B1-B3's wgmma ones
    ran = profile_step(torch, step, carry, batch, rep, "bert phase")
    want_ran = {KERNELS[w][0] for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if ran is not None and ran != want_ran:
        fail(f"bert phase profiled step ran the port's kernels {sorted(ran)}, want "
             f"{sorted(want_ran)}")
    del acc, model, opt, train, evals, step, carry

    with tempfile.TemporaryDirectory() as tmp:
        acc, _, _, train, _, step, carry = bert_trainer(torch, port, seed=0)
        carry, first, *_ = train_bert(torch, step, carry, train, 3)
        t0 = time.perf_counter()
        out = acc.save_state(os.path.join(tmp, "step_3"), carry=carry)
        save_s = time.perf_counter() - t0
        del acc, train, step, carry
        acc, model, _, train, _, step, carry = bert_trainer(torch, port, seed=1)
        t0 = time.perf_counter()
        carry = acc.load_state(out, carry=carry)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        carry, rest, *_ = train_bert(torch, step, carry, acc.skip_first_batches(train, 3), 3)
    diffs = {k: float((carry["params"][k].detach() - t).abs().max()) for k, t in straight.items()}
    unequal = [k for k, t in straight.items() if not torch.equal(carry["params"][k].detach(), t)]
    rep.line(f"bert resume: save_state {save_s} s, load_state {load_s} s, {size} bytes; losses "
             f"of steps 4-6 resumed {rest} vs straight {losses[3:]}; params bitwise equal "
             f"{len(straight) - len(unequal)} of {len(straight)}, largest difference "
             f"{max(diffs.values())}")
    if first != losses[:3] or rest != losses[3:] or unequal:
        fail(f"bert resume is not bit for bit the uninterrupted run: losses {first + rest} vs "
             f"{losses}, {len(unequal)} params differ ({unequal[:4]}), largest "
             f"{max(diffs.values())}")
    del acc, model, train, step, carry, straight
    return launches


def example_phase(torch, port, wrappers, rep: Report) -> None:
    """``accelerate_tpu_torch/examples/checkpointing.py``'s training function
    at bert_base width, bf16, one epoch (its config's ``num_epochs``; the
    example reads ``TESTING_NUM_EPOCHS`` only with its tiny model),
    ``--checkpointing_steps epoch``: step time and tokens/s from the train
    step's calls, the epoch's accuracy; then ``epoch_0`` loaded into a fresh
    accelerator and a model from another seed must give the same accuracy.
    At S 128 both packages take plain attention: B1-B3 launch 0 times."""
    import argparse
    import tempfile

    from accelerate_tpu_torch.examples import checkpointing as example
    from accelerate_tpu_torch.examples import nlp_example

    stamps, real = [], []

    class TimedAccelerator(port.Accelerator):
        """Stamps the host clock as each train step is called (the queue of
        launches holds the host back to the card's pace)."""

        def unified_step(self, *a, **kw):
            step = super().unified_step(*a, **kw)

            def timed(carry, batch):
                stamps.append(time.perf_counter())
                real.append(batch["attention_mask"].sum())
                return step(carry, batch)

            return timed

    config = {"lr": 2e-4, "num_epochs": 1, "seed": 42, "batch_size": 16}
    with tempfile.TemporaryDirectory() as tmp:
        args = argparse.Namespace(cpu=False, mixed_precision="bf16", gradient_accumulation_steps=1,
                                  checkpointing_steps="epoch", output_dir=tmp,
                                  resume_from_checkpoint=None)
        gc.collect()
        torch.cuda.empty_cache()
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
        reset_counts(wrappers)
        example.Accelerator = TimedAccelerator
        try:
            t0 = time.perf_counter()
            metric = example.training_function(config, args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            example.Accelerator = port.Accelerator
        launches = {w.__name__: w.launches for w in wrappers}
        gaps = [b - a for a, b in zip(stamps[10:], stamps[11:])]
        step_s = statistics.median(gaps)
        real_per_step = float(torch.stack(real).float().mean())
        rep.line(f"example checkpointing.py (bert_base, bf16, B 16, S 128, 1 epoch): "
                 f"{len(stamps)} steps, {wall} s in all (data, set-up, the epoch, eval, "
                 f"save_state), train steps {stamps[-1] - stamps[0]} s from first to last call, "
                 f"step {step_s} s (median gap between calls after the 10th), "
                 f"{16 * 128 / step_s} tokens/s padded, {real_per_step / step_s} tokens/s real; "
                 f"accuracy {metric['accuracy']}; launches {json.dumps(launches)}")
        flash = {w: n for w, n in launches.items() if w.startswith("flash_")}
        if any(flash.values()):
            fail(f"example: the flash kernels launched at S 128: {flash}")

        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
        acc = port.Accelerator(mixed_precision="bf16")
        model, cfg = nlp_example.model_and_config(acc, seed=7)
        train, evals = nlp_example.get_dataloaders(acc, config["batch_size"], cfg)
        model, opt, train, evals = acc.prepare(model, port.adamw(2e-4, weight_decay=0.01),
                                               train, evals)
        carry = acc.load_state(os.path.join(tmp, "epoch_0"), carry=acc.init_carry(model, opt))
        again = nlp_example.evaluate(acc, model, evals)
        rep.line(f"example epoch_0 loaded into a fresh accelerator: accuracy {again['accuracy']} "
                 f"(trained {metric['accuracy']}), opt_step {carry['opt_step']}")
        if again != metric:
            fail(f"example: epoch_0 re-evaluates to {again}, the epoch gave {metric}")
        # one step of the example's shape under the profiler: device busy share
        step = acc.unified_step(port.SequenceClassifier.loss_fn(model), opt, max_grad_norm=1.0)
        ran = profile_step(torch, step, carry, next(iter(train)), rep, "example")
        if ran:
            fail(f"example profiled step ran the port's kernels {sorted(ran)}, want none")
        del acc, model, opt, train, evals, carry, step


def decode_model(torch, port, seed: int = 0):
    """The ``decode`` config at full width and depth, built on the meta
    device and given bf16 weights on the card from a seeded generator: std
    0.02 for matrices and 1 for vectors, as ``benchmarks/measure.py:430-437``
    makes them, with no fp32 copy."""
    cfg = port.TransformerConfig(**DECODE_CFG)
    model = port.CausalLM(cfg, device="meta", generator=torch.Generator())
    g = torch.Generator(CARD).manual_seed(seed)
    model.load_state_dict({
        name: torch.empty(p.shape, dtype=torch.bfloat16, device=CARD).normal_(
            0.0, 0.02 if p.ndim > 1 else 1.0, generator=g)
        for name, p in model.named_parameters()}, assign=True)
    return model.requires_grad_(False)


def serve_trace(vocab: int, max_seq_len: int):
    """The long-tailed request trace exactly as ``measure.py:_run_serve``
    (:626-638) draws it: prompts of 4-64 tokens, a quarter of the requests
    with 32-64 new tokens and the rest with 4-8."""
    import numpy as np

    rng = np.random.default_rng(SERVE["seed"])
    max_prompt = max(8, min(max_seq_len // 4, 64))
    long_new = min(64, max_seq_len - max_prompt)
    trace = []
    for _ in range(SERVE["n_requests"]):
        p = int(rng.integers(4, max_prompt + 1))
        if rng.random() < 0.25:
            n = int(rng.integers(long_new // 2, long_new + 1))
        else:
            n = int(rng.integers(4, 9))
        trace.append((rng.integers(0, vocab, p).astype(np.int64), n))
    return trace


def profile_call(torch, fn, rep: Report, name: str) -> None:
    """``fn()`` once under torch.profiler: wall time (host clock, ending in a
    synchronise), device busy time (every CUDA kernel's self time) and their
    share, and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {evt.key: evt.self_device_time_total / 1e3 for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA}
    busy_ms = sum(kernels.values())
    if busy_ms == 0:
        rep.line(f"{name} profiled: the profiler saw no device time (busy share not measured)")
        return
    matmul_ms = sum(ms for key, ms in kernels.items()
                    if any(t in key.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")))
    rep.line(f"{name} profiled: wall {wall_ms} ms, device busy {busy_ms} ms "
             f"({100 * busy_ms / wall_ms} %): matmul (cuBLAS) {matmul_ms} ms, the other "
             f"{len(kernels)} kernel names {busy_ms - matmul_ms} ms")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        rep.line(f"{name} profiled: {ms} ms {key[:110]}")


def replay_ms(torch, program, n: int = 20) -> float:
    """Device time of one replay of a built step: CUDA events around ``n``
    replays queued back to back, so no host time sits between them."""
    program()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        program()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def replay_against_eager(torch, run_step, state, steps: int):
    """``run_step(eager, prev_logits) -> logits`` ``steps`` times by graph
    replay and again by the eager step, from the same copy of the ``state``
    tensors (caches and input buffers, written in place). Returns whether the logits of every
    step and the final state are equal bit for bit, and the largest
    difference."""
    start = [t.clone() for t in state]
    runs = []
    for eager in (False, True):
        for t, s in zip(state, start):
            t.copy_(s)
        logits, prev = [], None
        for _ in range(steps):
            prev = run_step(eager, prev).clone()
            logits.append(prev)
        runs.append((logits, [t.clone() for t in state]))
    (graph_logits, graph_state), (eager_logits, eager_state) = runs
    pairs = list(zip(graph_logits, eager_logits)) + list(zip(graph_state, eager_state))
    equal = all(torch.equal(a, b) for a, b in pairs)
    worst = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    return equal, worst


def small_serving_check(torch, port, rep: Report) -> None:
    """A 2-layer fp32 model of the tiny widths: greedy tokens through the
    engine and ``generate`` on the card and through both on the CPU must be
    the same (paged against dense, card against CPU)."""
    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.serving import ServingEngine

    cfg = port.TransformerConfig.tiny(num_layers=2, max_seq_len=64, dtype="float32")
    cpu = port.CausalLM(cfg, device="cpu")
    card_model = port.CausalLM(cfg, device=CARD)
    card_model.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    outs = {}
    for length in (5, 13, 29):
        ids = torch.randint(0, cfg.vocab_size, (2, length), generator=g)
        for where, model in (("card", card_model), ("cpu", cpu)):
            engine = ServingEngine(model, max_slots=2, block_size=8)
            outs.setdefault(f"{where} engine", []).append(
                engine.generate(ids, max_new_tokens=12).cpu())
            outs.setdefault(f"{where} generate", []).append(
                generate(model, ids, max_new_tokens=12).cpu())
    want = outs["cpu generate"]
    same = {name: all(torch.equal(a, b) for a, b in zip(got, want)) for name, got in outs.items()}
    rep.line(f"serve small fp32 model (2 layers, tiny widths): greedy tokens equal to the CPU's "
             f"generate {json.dumps(same)}")
    if not all(same.values()):
        fail(f"serve small model: greedy tokens differ from the CPU's generate: {same}")
    # prefix caching: a 3-block template, its cohort cold and warm (the
    # last prompt is the template itself: a full-prompt hit and its copy)
    template = torch.randint(1, cfg.vocab_size, (24,), generator=g).tolist()
    prompts = [template + [7, 8, 9], template + [5], template]
    runs = {}
    for where, model in (("card", card_model), ("cpu", cpu)):
        for warm in (False, True):
            engine = ServingEngine(model, max_slots=2, block_size=8, prefix_cache=warm)
            runs[f"{where} {'warm' if warm else 'cold'}"] = [
                engine.generate([p], max_new_tokens=10)[0].tolist() for p in prompts]
            if warm and where == "card":
                stats = engine.prefix_cache.stats()
    same = {name: got == runs["cpu cold"] for name, got in runs.items()}
    rep.line(f"serve small fp32 model, prefix cache: greedy tokens of 3 templated prompts equal "
             f"to the CPU's cold engine {json.dumps(same)}; card warm hits {stats['hits']}, "
             f"saved {stats['prefill_tokens_saved_total']} tokens, copies "
             f"{stats['cow_copies_total']}")
    if not all(same.values()) or stats["hits"] != 2 or stats["cow_copies_total"] != 1:
        fail(f"serve small model: prefix caching changed tokens or missed: {same}, {stats}")


def paged_against_dense(torch, model, trace, rep: Report) -> None:
    """First-token logits of each trace prompt from a paged prefill (bucket
    padded, through a scattered block table) and from a dense prefill of
    the whole prompt, held by the worst row's max error over its RMS."""
    from accelerate_tpu_torch.models.generation import init_cache
    from accelerate_tpu_torch.ops.attention import PagedKVState

    bs = SERVE["block_size"]
    width = -(-model.config.max_seq_len // bs)
    pools = init_cache(model, num_blocks=9, block_size=bs)
    errs = []
    with torch.no_grad():
        for prompt, _ in trace:
            p = len(prompt)
            bucket = 1 << (p - 1).bit_length()
            ids = torch.zeros((1, bucket), dtype=torch.long, device=CARD)
            ids[0, :p] = torch.from_numpy(prompt)
            table = torch.zeros((1, width), dtype=torch.long, device=CARD)
            table[0, :4] = torch.tensor([7, 2, 5, 3])  # 64 tokens at most
            state = PagedKVState(table, torch.zeros(1, dtype=torch.long, device=CARD),
                                 torch.tensor([p], device=CARD), num_blocks=9, block_size=bs)
            paged = model(ids, decode=True, paged=state, cache=pools)[0, p - 1].float()
            dense = model(ids[:, :p], decode=True, cache=init_cache(model, 1))[0, -1].float()
            rms = dense.square().mean().sqrt()
            errs.append(float((paged - dense).abs().max() / rms))
    rep.line(f"serve paged against dense prefill (bf16, {len(trace)} prompts of "
             f"{[len(p) for p, _ in trace]} tokens): first-token logits max error over RMS "
             f"{errs}, largest {max(errs)}, limit {SERVE_PREFILL_TOL}")
    if not max(errs) <= SERVE_PREFILL_TOL:
        fail(f"serve: paged prefill left dense prefill: {max(errs)} > {SERVE_PREFILL_TOL}")


def serve_phase(torch, port, wrappers, rep: Report) -> None:
    """The serving path on the ``decode`` config: see phase 8 in the module
    docstring. Every launch counter is set to 0 before and read after."""
    import numpy as np

    from accelerate_tpu_torch.models.generation import generate, make_generate_fn
    from accelerate_tpu_torch.serving import ServingEngine

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts(wrappers)
    small_serving_check(torch, port, rep)
    t0 = time.perf_counter()
    model = decode_model(torch, port)
    torch.cuda.synchronize()
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.nbytes for p in model.parameters())
    bound_ms = weights / PEAK_BYTES * 1e3
    rep.line(f"serve set-up: decode config (registry.py:289-297), {n_params} params, "
             f"{weights} bytes of bf16 weights, {time.perf_counter() - t0:.2f} s")
    trace = serve_trace(cfg.vocab_size, cfg.max_seq_len)
    paged_against_dense(torch, model, trace, rep)

    # generate: B 1, prompt 128, 64 new tokens (registry.py:318)
    B, P, N, reps = 1, SERVE["prompt"], SERVE["new_tokens"], SERVE["reps"]
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P)))
    gen = make_generate_fn(model, max_new_tokens=N)
    timings = {}
    for name, call in (("make_generate_fn (decode as one CUDA graph)", lambda: gen(ids)),
                       ("generate (eager)", lambda: generate(model, ids, max_new_tokens=N))):
        call()[:, -1].cpu()  # warm: builds and captures
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = call()
            out[:, -1].cpu()
        s_tok = (time.perf_counter() - t0) / (reps * N)
        timings[name] = s_tok
        rep.line(f"serve {name}: B {B}, prompt {P}, {N} new tokens, {reps} reps: {s_tok} s/token "
                 f"({1e3 * s_tok / bound_ms} x the weights-read bound {bound_ms} ms); peak memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30} GiB")
    if gen.trace_counts()["decode"] != 1:
        fail(f"serve: make_generate_fn built its decode step {gen.trace_counts()} times")
    cache, token, program = gen.decode_programs[B]
    token.copy_(out[:, -1:].to(token.device))
    profile_call(torch, lambda: program().argmax(-1), rep, "serve make_generate_fn decode step")
    cache.index.fill_(P)
    rep.line(f"serve make_generate_fn decode step, replays back to back (B {B}, cache index "
             f"{P}): {replay_ms(torch, program)} ms each on the device")

    def dense_step(eager, prev):
        if prev is not None:
            token.copy_(prev.argmax(-1)[:, None])
        return program.fn() if eager else program()

    equal, worst = replay_against_eager(torch, dense_step,
                                        [cache.key, cache.value, cache.index, token],
                                        SERVE["graph_steps"])
    rep.line(f"serve make_generate_fn: {SERVE['graph_steps']} decode steps by graph replay "
             f"against the eager step: bit for bit {equal} (largest difference {worst})")
    if not equal:
        fail("serve: make_generate_fn's graph replay is not its eager step bit for bit")
    del gen, cache, token, program

    # the engine over the trace: warm run, timed run
    engine = ServingEngine(model, max_slots=SERVE["max_slots"], block_size=SERVE["block_size"])
    engine.cache.key.fill_(SENTINEL)
    engine.cache.value.fill_(SENTINEL)
    held = set()
    allocate = engine.pool.allocate

    def recorded(n):
        blocks = allocate(n)
        held.update(blocks)
        return blocks

    engine.pool.allocate = recorded
    useful = sum(n for _, n in trace)

    def run_engine():
        rids = [engine.add_request(p, max_new_tokens=n) for p, n in trace]
        for _ in engine.stream():
            pass
        torch.cuda.synchronize()
        return [engine.result(r) for r in rids]

    warm = run_engine()
    warm_counts = engine.trace_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timed = run_engine()
    engine_s = time.perf_counter() - t0
    engine_peak = torch.cuda.max_memory_allocated()
    counts = engine.trace_counts()
    headline = engine.summary()  # the SLO objectives come from its p95s
    engine_tps = useful / engine_s
    rep.line(f"serve engine: {len(trace)} requests (prompts {[len(p) for p, _ in trace]}, new "
             f"tokens {[n for _, n in trace]}), {useful} useful new tokens in {engine_s} s: "
             f"{engine_tps} tokens/s; peak memory {engine_peak / 2**30} GiB; kv_bytes_per_token "
             f"{engine.kv_bytes_per_token}; pool {engine.num_blocks} blocks of "
             f"{engine.block_size}; builds after warm {warm_counts}, after timed {counts}")
    if warm_counts["decode"] != 1 or warm_counts["prefill"] > math.log2(cfg.max_seq_len):
        fail(f"serve: after the warm run the engine's builds are {warm_counts}")
    if counts != warm_counts:
        fail(f"serve: the timed run rebuilt programs: {warm_counts} -> {counts}")
    if timed != warm or [len(t) for t in timed] != [n for _, n in trace]:
        fail("serve: the trace's tokens changed between its warm and timed runs")
    unused = sorted(set(range(1, engine.num_blocks)) - held)
    kept = all(bool((pool[:, unused] == SENTINEL).all())
               for pool in (engine.cache.key, engine.cache.value))
    rep.line(f"serve garbage routing: {len(held)} blocks held by a table, the other "
             f"{len(unused)} (block 0 aside) still all sentinel: {kept}")
    if not unused or not kept:
        fail("serve: a block no table held was written")
    engine.pool.allocate = allocate

    # one profiled step() in steady decode: 4 seated slots, no admission
    long = [engine.add_request(p, max_new_tokens=48) for p, _ in trace[:SERVE["max_slots"]]]
    engine.step()
    engine.step()
    profile_call(torch, engine.step, rep, "serve engine step (4 slots decoding)")
    for _ in engine.stream():
        pass
    if any(len(engine.result(r)) != 48 for r in long):
        fail("serve: the profiled requests did not finish")

    # graph replay against the eager step: 4 slots at mixed depths
    prompts = [np.arange(n) % cfg.vocab_size for n in (5, 23, 40, 64)]
    for p in prompts:
        engine.add_request(p, max_new_tokens=64)
    engine.step()  # seats all four: prefill and one decode step
    slots = engine.scheduler.slots
    pending = np.asarray([[s.pending] for s in slots], np.int64)
    start_lens = np.asarray([s.cache_len for s in slots], np.int64)
    ones = np.ones(len(slots), np.int64)
    step_no = [0]

    def engine_step(eager, prev):
        step_no[0] = 0 if prev is None else step_no[0] + 1
        tokens = pending if prev is None else prev.argmax(-1)[:, None].cpu().numpy()
        return engine._decode_logits(tokens, start_lens + step_no[0], ones, eager=eager)

    equal, worst = replay_against_eager(torch, engine_step, [engine.cache.key, engine.cache.value],
                                        SERVE["graph_steps"])
    rep.line(f"serve engine: {SERVE['graph_steps']} decode steps of 4 slots at cache lengths "
             f"{start_lens.tolist()} by graph replay against the eager step: bit for bit {equal} "
             f"(largest difference {worst}); decode builds {engine.trace_counts()['decode']}")
    if not equal:
        fail("serve: the engine's graph replay is not its eager step bit for bit")
    if engine.trace_counts()["decode"] != 1:
        fail(f"serve: the engine's decode step was built {engine.trace_counts()} times")
    rep.line(f"serve engine decode step, replays back to back (4 slots): "
             f"{replay_ms(torch, engine._decode_program)} ms each on the device")
    for _ in engine.stream():  # the four requests of the replay check finish
        pass

    # the reference's baseline: run-to-completion fixed batches of max_slots,
    # each padded to its longest prompt and decoded to its largest budget
    slots_n = SERVE["max_slots"]
    chunks = [trace[i:i + slots_n] for i in range(0, len(trace), slots_n)]
    fns = {}

    def run_baseline():
        for chunk in chunks:
            rows = list(chunk) + [chunk[0]] * (slots_n - len(chunk))
            p_max = max(len(p) for p, _ in rows)
            n_max = max(n for _, n in rows)
            fn = fns.setdefault(n_max, make_generate_fn(model, max_new_tokens=n_max))
            batch = np.zeros((slots_n, p_max), np.int64)
            for j, (p, _) in enumerate(rows):
                batch[j, :len(p)] = p
            fn(torch.from_numpy(batch))[:, -1].cpu()

    run_baseline()
    t0 = time.perf_counter()
    run_baseline()
    baseline_s = time.perf_counter() - t0
    baseline_tps = useful / baseline_s
    rep.line(f"serve baseline (fixed batches of {slots_n} through make_generate_fn): {useful} "
             f"useful new tokens in {baseline_s} s: {baseline_tps} tokens/s; engine against "
             f"baseline {engine_tps / baseline_tps}")
    del fns
    observability_ab(torch, engine, run_engine, headline, timed, rep)
    prefix_ab(torch, engine, model, rep)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    speculation_ab(torch, port, rep)
    launches = {w.__name__: w.launches for w in wrappers}
    rep.line(f"serve kernel launches of the port {json.dumps(launches)}")
    if any(launches.values()):
        fail(f"serve: kernels of the port launched on the serving path: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    rep.line(f"serve phase: {time.perf_counter() - phase_t0} s")


def observability_ab(torch, engine, run_engine, headline: dict, want, rep: Report) -> None:
    """``measure.py:705-756`` on the warm engine: the trace with the
    observability plane off and on, OBS_ROUNDS interleaved rounds; the SLO
    objectives are the headline pass's p95s x 1.5."""
    from accelerate_tpu_torch.serving import SLOConfig, SloTracker
    from accelerate_tpu_torch.telemetry import PrometheusTextSink, StepTelemetry

    tracker = SloTracker(SLOConfig(
        ttft_objective_s=(headline.get("ttft_s_p95") or 0.5) * 1.5,
        e2e_objective_s=(headline.get("e2e_s_p95") or 5.0) * 1.5, target=0.99,
        interval_steps=16))
    tele = StepTelemetry(True)
    prom = tele.add_sink(PrometheusTextSink(path=None))
    walls = {"off": [], "on": []}
    for _ in range(OBS_ROUNDS):
        for arm in ("off", "on"):
            if arm == "off":
                engine.set_observability(telemetry=None, gauge_interval=0, slo=None, spans=False)
            else:
                engine.set_observability(telemetry=tele, gauge_interval=1, slo=tracker, spans=True)
            t0 = time.perf_counter()
            outs = run_engine()
            walls[arm].append(time.perf_counter() - t0)
            if outs != want:
                fail(f"serve observability {arm}: the trace's tokens changed")
    deltas = [on - off for on, off in zip(walls["on"], walls["off"])]
    overhead = statistics.median(deltas) / statistics.median(walls["off"]) * 100.0
    snap = tracker.snapshot()
    text = prom.render()
    kinds = sorted({r["kind"] for r in tele.records})
    tele.close()
    engine.set_observability(telemetry=None, gauge_interval=0, slo=None, spans=False)
    rep.line(f"serve observability A/B ({OBS_ROUNDS} interleaved rounds of the trace): walls off "
             f"{walls['off']} s, on {walls['on']} s; overhead (median on - off over median off) "
             f"{overhead} %; record kinds {kinds}; scrape text {len(text)} bytes")
    rep.line(f"serve SLO snapshot: {json.dumps(snap)}")
    builds = engine.trace_counts()
    if builds["decode"] != 1:
        fail(f"serve observability: the decode step was built {builds} times")
    if "accelerate_tpu_serve_queue_depth" not in text or "accelerate_tpu_slo_" not in text:
        fail("serve observability: the scrape text lacks the serve_gauge or slo lines")


def templated_cohort(vocab: int, block_size: int, max_seq_len: int):
    """``measure.py:771-793``: a template of whole blocks, capped at 24, and
    PREFIX_COHORT prompts of the template and an 8-token unique suffix; the
    seed prompt is the template and its first token again."""
    import numpy as np

    suffix_len = max(2, block_size // 2)
    blocks = max(4, min(24, (max_seq_len - suffix_len - PREFIX_NEW - 4) // block_size))
    rng = np.random.default_rng(SERVE["seed"] + 1)
    template = rng.integers(0, vocab, blocks * block_size)
    prompts = [np.concatenate([template, rng.integers(0, vocab, suffix_len)])
               for _ in range(PREFIX_COHORT)]
    return template, prompts, np.concatenate([template, template[:1]])


def prefix_first_logits(torch, model, template, prompts, seed_prompt, rep: Report):
    """First-token logits of each cohort prompt in bf16, cold (the whole
    prompt prefilled at its bucket) against warm (the seed prompt prefilled
    at its bucket, then the prompt's tail at cache position len(template)
    over the template's blocks): the worst row's max error over its RMS, a
    prompt each, for the tail at its own bucket (the engine's call) and for
    the tail padded to the cold call's bucket (the same GEMM shapes as cold,
    so any difference would be the path's, not rounding's). The engine's
    prefills, on pools of their own; one cold and one warm call profiled."""
    from accelerate_tpu_torch.models.generation import init_cache
    from accelerate_tpu_torch.ops.attention import PagedKVState

    bs = SERVE["block_size"]
    width = -(-model.config.max_seq_len // bs)
    n_tmpl = len(template) // bs
    need = -(-len(prompts[0]) // bs)
    pools = init_cache(model, num_blocks=1 + 2 * need + 1, block_size=bs)
    warm_blocks = list(range(1, need + 1))  # template blocks, then the tail's
    cold_blocks = list(range(need + 1, 2 * need + 1))
    spare = 2 * need + 1  # the seed prompt's partial block
    cold_bucket = 1 << (len(prompts[0]) - 1).bit_length()

    def prefill(tokens, blocks, cache_len, bucket=None):
        n = len(tokens)
        bucket = bucket or 1 << (n - 1).bit_length()
        ids = torch.zeros((1, bucket), dtype=torch.long, device=CARD)
        ids[0, :n] = torch.as_tensor(tokens)
        table = torch.zeros((1, width), dtype=torch.long, device=CARD)
        table[0, :len(blocks)] = torch.as_tensor(blocks)
        state = PagedKVState(table, torch.full((1,), cache_len, device=CARD),
                             torch.full((1,), n, device=CARD), num_blocks=pools.key.shape[1],
                             block_size=bs)
        return model(ids, decode=True, paged=state, cache=pools)[0, n - 1].float()

    def err(got, want):
        return float((got - want).abs().max() / want.square().mean().sqrt())

    errs, same_bucket = [], []
    with torch.no_grad():
        prefill(seed_prompt, warm_blocks[:n_tmpl] + [spare], 0)
        for prompt in prompts:
            cold = prefill(prompt, cold_blocks, 0)
            tail = prompt[len(template):]
            same_bucket.append(err(prefill(tail, warm_blocks, len(template), cold_bucket), cold))
            errs.append(err(prefill(tail, warm_blocks, len(template)), cold))
        prompt = prompts[0]
        profile_call(torch, lambda: prefill(prompt, cold_blocks, 0).argmax(), rep,
                     f"serve prefix cold prefill ({len(prompt)} tokens, bucket {cold_bucket})")
        tail = prompt[len(template):]
        profile_call(torch, lambda: prefill(tail, warm_blocks, len(template)).argmax(), rep,
                     f"serve prefix warm prefill ({len(tail)} tokens at cache position "
                     f"{len(template)})")
    return errs, same_bucket


def prefix_ab(torch, engine, model, rep: Report) -> None:
    """``measure.py:758-856`` on the warm engine: the templated cohort, one
    request at a time, cold (caching off) and warm (the template published
    by one seed request); both arms' prefill buckets built before the timed
    passes."""
    from accelerate_tpu_torch.serving.telemetry import ServeStats

    cfg = model.config
    template, prompts, seed_prompt = templated_cohort(cfg.vocab_size, engine.block_size,
                                                      cfg.max_seq_len)

    def run_cohort():
        outs = []
        for prompt in prompts:
            rid = engine.add_request(prompt, max_new_tokens=PREFIX_NEW)
            for _ in engine.stream():
                pass
            outs.append(engine.result(rid))
        torch.cuda.synchronize()
        return outs

    def seed_cache():
        engine.add_request(seed_prompt, max_new_tokens=1)
        for _ in engine.stream():
            pass

    engine.set_prefix_cache(False)
    run_cohort()
    engine.set_prefix_cache(True)
    seed_cache()
    run_cohort()
    warm_builds = engine.trace_counts()
    arms = {}
    for arm in ("cold", "warm"):
        engine.set_prefix_cache(arm == "warm")
        if arm == "warm":
            seed_cache()
            saved_before = engine.prefix_cache.tokens_saved_total
        engine.stats = ServeStats()
        t0 = time.perf_counter()
        outs = run_cohort()
        wall = time.perf_counter() - t0
        arms[arm] = (outs, wall, engine.stats.summary())
    saved = engine.prefix_cache.tokens_saved_total - saved_before
    stats = engine.prefix_cache.stats()
    engine.set_prefix_cache(False)
    builds = engine.trace_counts()
    errs, same_bucket = prefix_first_logits(torch, model, template, prompts, seed_prompt, rep)
    (cold_out, cold_s, cold_sum), (warm_out, warm_s, warm_sum) = arms["cold"], arms["warm"]
    matched = sum(a == b for a, b in zip(cold_out, warm_out))
    rep.line(f"serve prefix A/B: template {len(template)} tokens ({len(template) // 16} blocks), "
             f"{len(prompts)} prompts of {len(prompts[0])} tokens, {PREFIX_NEW} new tokens each, "
             f"one at a time: cold wall {cold_s} s, TTFT p50 {cold_sum['ttft_s_p50']} s, p95 "
             f"{cold_sum['ttft_s_p95']} s; warm wall {warm_s} s, TTFT p50 "
             f"{warm_sum['ttft_s_p50']} s, p95 {warm_sum['ttft_s_p95']} s; cold over warm TTFT "
             f"p50 {cold_sum['ttft_s_p50'] / warm_sum['ttft_s_p50']}")
    rep.line(f"serve prefix A/B: tokens saved {saved} (want {len(prompts) * len(template)}), "
             f"hit rate {stats['hit_rate']}, hits {stats['hits']} of {stats['lookups']} lookups, "
             f"copies {stats['cow_copies_total']}; builds after the warm-up {warm_builds}, after "
             f"the arms {builds}; greedy outputs equal warm and cold {matched} of {len(prompts)}")
    rep.line(f"serve prefix first-token logits, warm against cold (bf16): max error over RMS "
             f"{errs}, largest {max(errs)}, limit {PREFIX_LOGITS_TOL}; the tail padded to the "
             f"cold bucket {same_bucket}, largest {max(same_bucket)}, limit {SERVE_PREFILL_TOL}")
    if saved != len(prompts) * len(template):
        fail(f"serve prefix: {saved} prefill tokens saved, want {len(prompts) * len(template)}")
    if builds != warm_builds:
        fail(f"serve prefix: the timed arms built programs: {warm_builds} -> {builds}")
    if not max(errs) <= PREFIX_LOGITS_TOL:
        fail(f"serve prefix: warm logits left cold: {max(errs)} > {PREFIX_LOGITS_TOL}")
    if not max(same_bucket) <= SERVE_PREFILL_TOL:
        fail(f"serve prefix: warm logits at the cold bucket left cold: {max(same_bucket)} > "
             f"{SERVE_PREFILL_TOL}")


def spec_models(torch, port):
    """The reference's self-consistent pair at the ``decode`` config in fp32
    (``measure.py:867-892``): the target's layers >= 1 have o_proj and
    down_proj at zero, so they add exact zeros, and the 1-layer draft holds
    the target's layer 0, embedding, final norm and head (the same
    tensors)."""
    cfg = port.TransformerConfig(**{**DECODE_CFG, "dtype": "float32"})
    target = port.CausalLM(cfg, device="meta", generator=torch.Generator())
    g = torch.Generator(CARD).manual_seed(SERVE["seed"])
    weights = {}
    for name, p in target.named_parameters():
        w = torch.empty(p.shape, dtype=torch.float32, device=CARD)
        layer = int(name.split(".")[1]) if name.startswith("layers.") else 0
        if layer >= 1 and name.endswith(("o_proj.weight", "down_proj.weight")):
            w.zero_()
        else:
            w.normal_(0.0, 0.02 if p.ndim > 1 else 1.0, generator=g)
        weights[name] = w
    target.load_state_dict(weights, assign=True)
    draft = port.CausalLM(port.TransformerConfig(**{**DECODE_CFG, "dtype": "float32",
                                                    "num_layers": 1}),
                          device="meta", generator=torch.Generator())
    draft.load_state_dict({name: weights[name] for name, _ in draft.named_parameters()},
                          assign=True)
    return target.requires_grad_(False), draft.requires_grad_(False)


def speculation_ab(torch, port, rep: Report) -> None:
    """``measure.py:858-952`` at the ``decode`` config's widths and depth:
    off, n-gram and draft model, each a fresh engine with a warm pass and a
    timed pass over SPEC_PROMPTS decode-heavy requests."""
    import numpy as np

    from accelerate_tpu_torch.serving import ServingEngine, SpecConfig

    t0 = time.perf_counter()
    target, draft = spec_models(torch, port)
    torch.cuda.synchronize()
    rep.line(f"serve speculation set-up: fp32 target (decode config, o_proj and down_proj of "
             f"layers >= 1 at zero), {sum(p.nbytes for p in target.parameters())} bytes; "
             f"1-layer draft sharing its tensors; {time.perf_counter() - t0} s")
    cfg = target.config
    rng = np.random.default_rng(SERVE["seed"] + 2)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(4, 12)))
               for _ in range(SPEC_PROMPTS)]
    new = min(180, cfg.max_seq_len - 16 - SPEC_K)
    arms = {}
    for name, spec in (("off", None), ("ngram", SpecConfig(k=SPEC_K)),
                       ("draft", SpecConfig(k=SPEC_K, method="draft_model", draft_model=draft))):
        engine = ServingEngine(target, max_slots=SERVE["max_slots"], block_size=SERVE["block_size"])
        engine.set_speculation(spec)
        for p in prompts:
            engine.add_request(p, max_new_tokens=new)
        for _ in engine.stream():
            pass
        warm = engine.trace_counts()
        rids = [engine.add_request(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in engine.stream():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        outs = [engine.result(r) for r in rids]
        after = engine.trace_counts()
        spec_sum = engine.summary().get("speculation", {})
        arms[name] = dict(outs=outs, tps=sum(len(o) for o in outs) / wall, wall=wall,
                          spec=spec_sum, warm=warm, after=after)
        rep.line(f"serve speculation {name}: {len(prompts)} prompts of "
                 f"{[len(p) for p in prompts]} tokens, {new} new each, k {SPEC_K}: "
                 f"{arms[name]['tps']} tokens/s ({wall} s); rounds {spec_sum.get('rounds')}, "
                 f"proposed {spec_sum.get('proposed')}, accepted {spec_sum.get('accepted')}, "
                 f"accept rate {spec_sum.get('accept_rate')}; builds after the warm pass {warm}, "
                 f"after the timed pass {after}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    off = arms["off"]
    rep.line(f"serve speculation: n-gram over off {arms['ngram']['tps'] / off['tps']}, draft "
             f"over off {arms['draft']['tps'] / off['tps']}; accept-rate limit for the draft "
             f"{SPEC_ACCEPT_MIN}")
    for name in ("ngram", "draft"):
        arm = arms[name]
        if arm["outs"] != off["outs"]:
            diff = sum(a != b for a, b in zip(arm["outs"], off["outs"]))
            fail(f"serve speculation {name}: {diff} outputs differ from speculation off")
        if arm["after"] != arm["warm"]:
            fail(f"serve speculation {name}: rebuilt after warmup: {arm['warm']} -> {arm['after']}")
        want_verify = 1 if name == "draft" or arm["spec"]["proposed"] else 0
        if arm["after"]["verify"] != want_verify or arm["after"]["decode"] > 1:
            fail(f"serve speculation {name}: builds {arm['after']}")
    if arms["draft"]["after"].get("draft_step") != 1:
        fail(f"serve speculation draft: draft step builds {arms['draft']['after']}")
    if not arms["draft"]["spec"]["accept_rate"] >= SPEC_ACCEPT_MIN:
        fail(f"serve speculation draft: accept rate {arms['draft']['spec']['accept_rate']} < "
             f"{SPEC_ACCEPT_MIN}")
    del target, draft


# ---------------------------------------------------------------------- #
# phases 9-11: the reference benchmark's single-card training variants
# ---------------------------------------------------------------------- #
def variant_trainer(torch, port, cfg_kw: dict, batch: int, steps: int, seed: int = 0,
                    mixed_precision: str = "bf16"):
    """A CausalLM of the reference's config ``cfg_kw`` built on the card from
    a seeded generator, ``prepare``d (under ``mixed_precision="fp8"`` that
    converts its projections) with adamw (lr 3e-4) and clip 1.0, and one
    batch of seeded tokens that repeats every step (also returned, on the
    card, as the last item)."""
    gc.collect()
    torch.cuda.empty_cache()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    acc = port.Accelerator(mixed_precision=mixed_precision)
    cfg = port.TransformerConfig(**cfg_kw)
    model = port.CausalLM(cfg, device=acc.device,
                          generator=torch.Generator(device=acc.device).manual_seed(seed))
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                           generator=torch.Generator().manual_seed(seed)).numpy()
    dataset = [{"input_ids": tokens[i % batch]} for i in range(steps * batch)]
    model, opt, loader = acc.prepare(model, port.adamw(3e-4),
                                     port.DataLoader(dataset, batch_size=batch))
    step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
    carry = acc.init_carry(model, opt)
    first = {"input_ids": torch.from_numpy(tokens[:batch]).to(acc.device)}
    torch.cuda.synchronize()
    return acc, model, opt, loader, step, carry, first


def set_remat(model, remat) -> None:
    """``model``'s config, and every submodule's that shares it, with
    ``remat`` in place."""
    import dataclasses

    old = model.config
    new = dataclasses.replace(old, remat=remat)
    for module in model.modules():
        if getattr(module, "config", None) is old:
            module.config = new


def grads_of(torch, model, batch, dtype) -> dict:
    """The step's gradients: the loss on the params cast to ``dtype``, its
    gradients on the fp32 masters (``Accelerator.unified_step``'s own
    arithmetic), returned as fp32 tensors by name."""
    params = dict(model.named_parameters())
    compute = {k: p.to(dtype) for k, p in params.items()}
    batch = {k: v.to("cuda") for k, v in batch.items()}
    loss = model.loss_fn(model)(compute, batch)
    grads = torch.autograd.grad(loss.float(), list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def unequal(a: dict, b: dict) -> list:
    return [k for k in a if not a[k].equal(b[k])]


def run_counted(torch, wrappers, step, carry, loader):
    """``run_steps`` with every launch counter set to 0 just before and read
    just after; the peak memory of the steps."""
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    carry, batch, losses, norms, times = run_steps(torch, step, carry, loader)
    launches = {w.__name__: w.launches for w in wrappers}
    by_design = {w.__name__: dict(w.by_design) for w in wrappers if hasattr(w, "by_design")}
    return carry, batch, losses, times, launches, by_design, torch.cuda.max_memory_allocated()


def check_launches(name, launches, by_design, want) -> None:
    full = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_fused": 0,
            "qkv_prologue": 0, "adamw_epilogue": 0, **want}
    if launches != full:
        fail(f"{name} kernel launches {launches}, want {full}")
    want_design = {w: {"wgmma": full[w], "wmma": 0} for w in by_design}
    if by_design != want_design:
        fail(f"{name} launches by design {by_design}, want {want_design}")


# kernel groups of the variants' profiled steps, first match wins
VARIANT_GROUPS = (
    ("grouped GEMMs", lambda k: "GroupProblemShape" in k or "grouped_gemm" in k),
    ("fp8 GEMMs", lambda k: re.match(r"nvjet_[qr][qr]", k) is not None),
    ("flash kernels", lambda k: "flash_" in k and "_kernel" in k),
    ("other matmuls", lambda k: any(t in k.lower() for t in ("gemm", "nvjet", "xmma",
                                                             "cutlass"))),
    ("quantisation (amax, scale, clamp, fp8 casts)",
     lambda k: any(t in k for t in ("Float8", "float8", "AbsMax", "clamp", "NormOps"))),
    ("dispatch (sort, gathers, bincount, cumsum, combine)",
     lambda k: any(t in k.lower() for t in ("sort", "index", "gather", "scatter", "bincount",
                                            "scan", "histogram", "cumsum", "one_hot",
                                            "embedding"))),
)


def profile_groups(torch, fn, rep: Report, name: str):
    """``fn()`` once under torch.profiler: wall (host clock ending in a
    synchronise), device busy (every kernel's self time) and its share, the
    busy time by VARIANT_GROUPS (the rest: elementwise and the rest), the
    optimizer's ``unified_step.sync_apply`` range on the device, and the
    launches of each kernel name. Returns {kernel name: launches}, or None
    when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, counts, sync_ms = {}, {}, None
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.key == "unified_step.sync_apply":
            sync_ms = evt.device_time_total / 1e3
        else:
            kernels[evt.key] = evt.self_device_time_total / 1e3
            counts[evt.key] = evt.count
    busy = sum(kernels.values())
    if busy == 0:
        rep.line(f"{name} profiled step: the profiler saw no device time (not measured)")
        return None
    groups = dict.fromkeys([g for g, _ in VARIANT_GROUPS] + ["the rest (elementwise, norms, "
                                                              "loss, optimizer)"], 0.0)
    for key, ms in kernels.items():
        group = next((g for g, match in VARIANT_GROUPS if match(key)), None)
        groups[group or list(groups)[-1]] += ms
    rep.line(f"{name} profiled step: wall {wall_ms} ms, device busy {busy} ms "
             f"({100 * busy / wall_ms} %), by group ms {json.dumps(groups)}; optimizer "
             f"(unified_step.sync_apply) {sync_ms} ms on the device")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        rep.line(f"{name} profiled step: {ms} ms x{counts[key]} {key[:100]}")
    return counts


def time_flash_shape(torch, fa, rep: Report, label: str, B, S, H, Hkv, D) -> list[dict]:
    """B1-B3 at a variant's attention shape (bf16, causal): first the gated
    ``check_case`` at this shape (every flash kernel against its plain
    version row by row, launches by design, the repeat bits; a failure
    ends the script), whose max abs errors go into the rows; then the
    times of kernel, plain version and, for B1, SDPA's forward; B2 + B3
    beside PyTorch's flash backward op as a yardstick."""
    import torch.nn.functional as F

    gc.collect()
    torch.cuda.empty_cache()
    reading, abs_errs = check_case(torch, fa, f"{label}_bf16_causal", B, S, H, Hkv, D,
                                   torch.bfloat16)
    rep.line(json.dumps(reading))
    if reading["bad"]:
        fail(f"flash kernels at {label}'s shape beyond tolerance or design: {reading['bad']}")
    torch.cuda.empty_cache()
    q, k, v, dout = make_inputs(torch, B, S, H, Hkv, D, torch.bfloat16, seed=5)
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = fa.attention_delta(out, dout)
    torch.cuda.empty_cache()
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, True),
                      lambda: fa.flash_fwd_reference(q, k, v, scale, True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, True),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale,
                                                           True)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, True),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale,
                                                             True)),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
    pairs = visible_pairs(torch, S, S, True) * B * H
    e = 2
    qo, kv, stat = B * S * H * D * e, B * S * Hkv * D * e, B * H * S * 4
    work = {
        "flash_fwd": (2 * 2 * D * pairs, qo + 2 * kv + qo + stat),
        "flash_bwd_dq": (3 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + qo),
        "flash_bwd_dkv": (4 * 2 * D * pairs, 2 * qo + 2 * kv + 2 * stat + 2 * kv),
    }
    rows = []
    for wrapper, (kfn, pfn) in fns.items():
        ms = time_ms(torch, kfn, 20, flush)
        plain_ms = time_ms(torch, pfn, 2, flush)
        torch.cuda.empty_cache()
        row = kernel_row(wrapper, fa.kernel_design(torch.bfloat16, D), ms, plain_ms,
                         *work[wrapper], PEAK_BF16_FLOPS, abs_errs[wrapper],
                         library_fwd if wrapper == "flash_fwd" else None)
        row["shape"] = f"{label} B{B} S{S} H{H} Hkv{Hkv} D{D} bf16 causal"
        rows.append(row)
        rep.line(f"{KERNELS[wrapper][0]} at {label}'s shape: {ms:.4f} ms (plain {plain_ms:.4f} "
                 f"ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                 f"{work[wrapper][0] / ms / 1e9:.1f} TFLOP/s), max abs err {abs_errs[wrapper]}")

    def two_pass():
        fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, True)
        fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, True)

    library_bwd = time_library_bwd(torch, q, k, v, dout, scale, flush, rep, f"{label}'s shape")
    rep.line(f"at {label}'s shape: SDPA forward {library_fwd:.4f} ms; B2 + B3 "
             f"{time_ms(torch, two_pass, 10, flush):.4f} ms against PyTorch's flash backward op "
             f"{library_bwd:.4f} ms (yardstick: all of dq, dk, dv, no GQA sum)")
    del q, k, v, dout, out, lse, delta, scratch
    torch.cuda.empty_cache()
    return rows


def moe_layer_outputs(torch, moe_module, x, g, dispatch, factor=None):
    """One MoE layer's output and the gradients of <output, g> with respect
    to x, the router and the three stacks, under ``dispatch``."""
    import dataclasses

    cfg = moe_module.config
    moe_module.config = dataclasses.replace(
        cfg, moe_dispatch=dispatch, moe_capacity_factor=factor or cfg.moe_capacity_factor)
    try:
        xg = x.detach().requires_grad_(True)
        out = moe_module(xg)
        params = [xg, moe_module.router.weight, moe_module.gate_proj, moe_module.up_proj,
                  moe_module.down_proj]
        grads = torch.autograd.grad(out, params, g)
    finally:
        moe_module.config = cfg
    return [out.detach()] + [t.detach() for t in grads]


def moe_phase(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 9: see the module docstring. Returns B1-B3's rows at the
    config's attention shape, with this phase's launches."""
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import moe as moe_ops

    cfg_kw, B, steps = MOE_CFG, VARIANT_BATCH["moe"], VARIANT_STEPS
    S, E, K = cfg_kw["max_seq_len"], cfg_kw["num_experts"], cfg_kw["num_experts_per_tok"]
    rows = time_flash_shape(torch, fa, rep, "moe", B, S, cfg_kw["num_heads"],
                            cfg_kw["num_kv_heads"], 128)
    moe_small_check(torch, port, rep)
    t0 = time.perf_counter()
    acc, model, opt, loader, step, carry, _ = variant_trainer(torch, port, cfg_kw, B, steps)
    n_params = sum(p.numel() for p in model.parameters())
    rep.line(f"moe set-up: {n_params} params (registry.py:214-258), "
             f"{time.perf_counter() - t0:.2f} s")

    # 1-3: one MoE layer at full width on B*S tokens: ragged and capacity
    # against the dense oracle, row by row; capacity 1.25's drops
    layer = model.layers[0].moe
    T, h = B * S, cfg_kw["hidden_size"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(T, 1, h, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(T, 1, h, generator=gen, device="cuda").to(torch.bfloat16)
    names = ("out", "dx", "router", "gate_proj", "up_proj", "down_proj")
    dense = moe_layer_outputs(torch, layer, x, g, "dense")
    readings = {}
    for label, dispatch, factor in (
            ("ragged", "ragged", None),
            ("capacity_no_drop", "capacity", moe_ops.no_drop_capacity_factor(E, K))):
        got = moe_layer_outputs(torch, layer, x, g, dispatch, factor)
        readings[label] = {n: row_err(torch, a, b) for n, a, b in zip(names, got, dense)}
        del got
    del dense
    torch.cuda.empty_cache()
    rep.line(f"moe layer against the dense oracle (T {T}, bf16), worst row's max error over its "
             f"RMS: {json.dumps(readings)}; limit {MOE_ORACLE_TOL}")
    worst = max(v for r in readings.values() for v in r.values())
    if not worst <= MOE_ORACLE_TOL:
        fail(f"moe: ragged or capacity against the dense oracle {worst} > {MOE_ORACLE_TOL}")
    # a shared direction in every token skews the routing, so capacity 1.25
    # must drop (seeded tokens alone route evenly enough that nothing drops)
    x = x + torch.randn(h, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        logits = layer.router(x.float())
        sel = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                         stable=True).indices[..., :K].reshape(T, K)
    C = moe_ops.expert_capacity(T, E, K, cfg_kw["moe_capacity_factor"])
    slot, keep = moe_ops.capacity_slots(sel, E, C)
    cpu_slot, cpu_keep = moe_ops.capacity_slots(sel.cpu(), E, C)
    out = moe_layer_outputs(torch, layer, x, g, "capacity")[0].reshape(T, h)
    both = (~keep).reshape(T, K).all(dim=1)
    rep.line(f"moe capacity {cfg_kw['moe_capacity_factor']} (C {C}): {int((~keep).sum())} of "
             f"{T * K} (token, choice) pairs dropped on the card, {int((~cpu_keep).sum())} by "
             f"the plain version on the CPU; {int(both.sum())} tokens lost both choices")
    if not (torch.equal(keep.cpu(), cpu_keep) and torch.equal(slot.cpu(), cpu_slot)):
        fail("moe: the card's capacity slots differ from the plain version's on the CPU")
    if not torch.equal(out[both], torch.zeros_like(out[both])):
        fail("moe: a token whose choices were all dropped did not read zeros")
    if not 0 < int((~cpu_keep).sum()) < T * K:
        fail("moe: the skewed routing dropped no pair at capacity 1.25: the check saw nothing")
    del x, g, out, logits, sel, slot, keep

    # 5 steps with exact launch counts, then one profiled step
    carry, batch, losses, times, launches, by_design, peak = run_counted(
        torch, wrappers, step, carry, loader)
    steady = statistics.median(times[1:])
    rep.line(f"moe losses {losses}")
    rep.line(f"moe step seconds {times}; median of steps 2-{steps} {steady} s, {B * S / steady} "
             f"tokens/s; peak memory {peak / 2**30} GiB")
    rep.line(f"moe kernel launches {json.dumps(launches)}")
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        fail(f"moe losses {losses}: not finite or not falling on a repeated batch")
    L = cfg_kw["num_layers"]
    check_launches("moe", launches, by_design, {"flash_fwd": L * steps, "flash_bwd_dq": L * steps,
                                                 "flash_bwd_dkv": L * steps})
    counts = profile_groups(torch, lambda: step(carry, batch), rep, "moe")
    if counts is None or not any("GroupProblemShape" in k for k in counts):
        fail("moe profiled step: no grouped GEMM kernel seen")

    # 4: repeat from one copy of the state, bit for bit
    loss_a, grads_a = grads_of(torch, model, batch, torch.bfloat16)
    loss_b, grads_b = grads_of(torch, model, batch, torch.bfloat16)
    bad = unequal(grads_a, grads_b)
    del grads_a, grads_b
    state = opt.opt_state
    snap = {k: t.detach().clone() for k, t in carry["params"].items()}
    moments = {k: (state["mu"][k].clone(), state["nu"][k].clone()) for k in snap}
    count = state["count"]
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for k, t in carry["params"].items():
                t.copy_(snap[k])
                state["mu"][k].copy_(moments[k][0])
                state["nu"][k].copy_(moments[k][1])
        state["count"] = count
        _, m = step(carry, batch)
        runs.append((float(m["loss"]), {k: t.detach().clone() for k, t in carry["params"].items()}))
    bad += unequal(runs[0][1], runs[1][1])
    rep.line(f"moe repeat: grads of one state twice {'equal' if loss_a == loss_b else 'differ'} "
             f"(loss {loss_a} vs {loss_b}); a step from one copy twice: loss {runs[0][0]} vs "
             f"{runs[1][0]}; tensors that differ {bad[:4]} ({len(bad)})")
    if loss_a != loss_b or runs[0][0] != runs[1][0] or bad:
        fail(f"moe: a repeated step is not bit for bit the same: {bad[:4]}")
    del acc, model, opt, loader, step, carry, snap, moments, runs
    for row in rows:
        row["launches"] = launches[WRAPPER_OF[row["name"]]]
    return rows


def moe_small_check(torch, port, rep: Report) -> None:
    """A 2-layer fp32 tiny-width MoE CausalLM (ragged: the grouped GEMM on
    the card, the per-expert loop on the CPU) on both devices from one set
    of weights: loss and grads within 1e-4 relative."""
    cfg = port.TransformerConfig.tiny(vocab_size=512, hidden_size=128, intermediate_size=256,
                                      num_heads=4, num_kv_heads=2, num_experts=4,
                                      moe_dispatch="ragged", attention_impl="flash")
    cpu_model = port.CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu_model = port.CausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(1))
    results = []
    for model, device in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        params = dict(model.named_parameters())
        loss = port.CausalLM.loss_fn(model)(params, {"input_ids": ids.to(device)})
        grads = torch.autograd.grad(loss, list(params.values()))
        results.append((float(loss.detach()), [t.cpu() for t in grads]))
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results
    grad_err = max(rel_err(torch, a, b) for a, b in zip(gpu_grads, cpu_grads))
    rep.line(f"small MoE model fp32 (grouped GEMM, flash) vs CPU plain path: loss {gpu_loss} vs "
             f"{cpu_loss}, max grad rel err {grad_err:.3g}")
    if not (abs(gpu_loss - cpu_loss) <= 1e-4 * abs(cpu_loss) and grad_err <= 1e-4):
        fail("small MoE model: the card disagrees with the CPU plain path")


def check_fp8_products(torch, rep: Report) -> dict:
    """``fp8_matmul`` on the card (``torch._scaled_mm``) against its plain
    version on the card (the codes multiplied in fp32), at the dense
    config's projection shapes (M = B*S rows): the forward, dx and dw row
    by row. Both sides quantise the same bf16 inputs to the same codes."""
    from accelerate_tpu_torch.ops import fp8

    e4m3, e5m2 = torch.float8_e4m3fn, torch.float8_e5m2
    M, h, f = VARIANT_BATCH["dense"] * DENSE_CFG["max_seq_len"], DENSE_CFG["hidden_size"], \
        DENSE_CFG["intermediate_size"]
    kv = DENSE_CFG["num_kv_heads"] * 128
    gen = torch.Generator(device="cuda").manual_seed(11)
    readings = {}
    for label, k, n in (("q/o", h, h), ("k/v", h, kv), ("gate/up", h, f), ("down", f, h)):
        x = torch.randn(M, k, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        w.requires_grad_()
        g = torch.randn(M, n, generator=gen, device="cuda").to(torch.bfloat16)
        out = fp8.fp8_matmul(x, w, out_dtype=torch.bfloat16)
        dx, dw = torch.autograd.grad(out, (x, w), g)
        xs, ws = fp8._scale_for(x, fp8.E4M3_MAX), fp8._scale_for(w, fp8.E4M3_MAX)
        gs = fp8._scale_for(g, fp8.E5M2_MAX)
        xq, wq = fp8.quantize_fp8(x.detach(), e4m3, xs), fp8.quantize_fp8(w.detach(), e4m3, ws)
        gq = fp8.quantize_fp8(g, e5m2, gs)
        plain = fp8.scaled_mm_reference(xq, wq, xs, ws, torch.float32)
        pdx = fp8.scaled_mm_reference(gq, wq.t(), gs, ws, torch.float32)
        pdw = fp8.scaled_mm_reference(xq.t(), gq, xs, gs, torch.float32)
        readings[label] = {"out": row_err(torch, out, plain), "dx": row_err(torch, dx, pdx),
                           "dw": row_err(torch, dw, pdw)}
        del x, w, g, out, dx, dw, xq, wq, gq, plain, pdx, pdw
    torch.cuda.empty_cache()
    rep.line(f"fp8_matmul (torch._scaled_mm, e4m3 / e5m2) against its plain version on the card at "
             f"M {M}, worst row's max error over its RMS: {json.dumps(readings)}; limit "
             f"{FP8_PRODUCT_TOL}")
    worst = max(v for r in readings.values() for v in r.values())
    if not worst <= FP8_PRODUCT_TOL:
        fail(f"fp8_matmul on the card against its plain version: {worst} > {FP8_PRODUCT_TOL}")
    return readings


def dense_fp8_phase(torch, port, wrappers, rep: Report) -> None:
    """Phase 10: see the module docstring."""
    from accelerate_tpu_torch.models.transformer import Fp8Dense
    from accelerate_tpu_torch.ops import fp8

    cfg_kw, B, steps = DENSE_CFG, VARIANT_BATCH["dense"], VARIANT_STEPS
    S, L = cfg_kw["max_seq_len"], cfg_kw["num_layers"]
    check_fp8_products(torch, rep)
    results = {}
    for precision in ("bf16", "fp8"):
        name = f"dense {precision}"
        t0 = time.perf_counter()
        acc, model, opt, loader, step, carry, _ = variant_trainer(
            torch, port, cfg_kw, B, steps, mixed_precision=precision)
        n_fp8 = sum(isinstance(m, Fp8Dense) for m in model.modules())
        rep.line(f"{name} set-up: {sum(p.numel() for p in model.parameters())} params "
                 f"(registry.py:205-213, remat {model.config.remat!r}), {n_fp8} Fp8Dense "
                 f"projections, {time.perf_counter() - t0:.2f} s")
        if n_fp8 != (7 * L if precision == "fp8" else 0):
            fail(f"{name}: {n_fp8} projections converted to fp8")
        fp8.scaled_mm.calls = 0
        carry, batch, losses, times, launches, by_design, peak = run_counted(
            torch, wrappers, step, carry, loader)
        calls = fp8.scaled_mm.calls
        steady = statistics.median(times[1:])
        rep.line(f"{name} losses {losses}")
        rep.line(f"{name} step seconds {times}; median of steps 2-{steps} {steady} s, "
                 f"{B * S / steady} tokens/s; peak memory {peak / 2**30} GiB")
        rep.line(f"{name} kernel launches {json.dumps(launches)}; fp8 product wrapper "
                 f"(scaled_mm) called {calls} times")
        if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            fail(f"{name} losses {losses}: not finite or not falling on a repeated batch")
        # "dots": the recompute replays the flash forward, once more a layer
        check_launches(name, launches, by_design, {"flash_fwd": 2 * L * steps,
                                                   "flash_bwd_dq": L * steps,
                                                   "flash_bwd_dkv": L * steps})
        # 7 projections x L layers x (forward, dx, dw) fp8 GEMMs a step; the
        # recompute's forward products come from the "dots" cache, though
        # the wrapper is called again for them
        want_calls = (7 * L * 4 * steps) if precision == "fp8" else 0
        if calls != want_calls:
            fail(f"{name}: the fp8 product wrapper called {calls} times, want {want_calls}")
        counts = profile_groups(torch, lambda: step(carry, batch), rep, name)
        if counts is None:
            fail(f"{name}: the profiler saw no kernel, so the fp8 GEMMs cannot be counted")
        fp8_gemms = sum(n for k, n in counts.items() if re.match(r"nvjet_[qr][qr]", k))
        rep.line(f"{name} profiled step: {fp8_gemms} fp8 GEMM kernels (nvjet_[qr][qr]*)")
        if fp8_gemms != (7 * L * 3 if precision == "fp8" else 0):
            fail(f"{name}: {fp8_gemms} fp8 GEMM kernels in one step, want "
                 f"{7 * L * 3 if precision == 'fp8' else 0}")
        if precision == "bf16":  # "dots" against no remat, bit for bit
            _, dots = grads_of(torch, model, batch, torch.bfloat16)
            set_remat(model, None)
            _, plain = grads_of(torch, model, batch, torch.bfloat16)
            set_remat(model, cfg_kw["remat"])
            bad = unequal(dots, plain)
            rep.line(f"dense bf16: one step's grads under 'dots' and without remat: "
                     f"{len(dots) - len(bad)} of {len(dots)} tensors bitwise equal")
            if bad:
                fail(f"dense: 'dots' changes the step's gradients: {bad[:4]}")
            del dots, plain
        results[precision] = (losses, steady, peak)
        del acc, model, opt, loader, step, carry
    (bl, bs, bp), (fl, fs, fp) = results["bf16"], results["fp8"]
    rep.line(f"dense fp8 against bf16: step time ratio fp8/bf16 {fs / bs}, tokens/s ratio "
             f"{bs / fs}, peak memory {fp / 2**30} vs {bp / 2**30} GiB")
    fp8_loss_gaps(torch, port, rep, {"bf16": bl, "fp8": fl})


def fp8_loss_gaps(torch, port, rep: Report, curves=None) -> None:
    """fp8 against bf16 on the dense config from every seed of FP8_SEEDS,
    5 steps each (``curves``, {precision: losses}, gives the first seed's
    runs where the caller has made them): |fp8 - bf16| by step over the
    bf16 run's first loss, each within FP8_LOSS_TOL."""
    B, steps = VARIANT_BATCH["dense"], VARIANT_STEPS
    runs = {} if curves is None else {FP8_SEEDS[0]: curves}
    for seed in FP8_SEEDS:
        for precision in ("bf16", "fp8"):
            if precision in runs.setdefault(seed, {}):
                continue
            acc, model, opt, loader, step, carry, _ = variant_trainer(
                torch, port, DENSE_CFG, B, steps, seed=seed, mixed_precision=precision)
            runs[seed][precision] = run_steps(torch, step, carry, loader)[2]
            del acc, model, opt, loader, step, carry
    gaps = {seed: [abs(f - b) / r["bf16"][0] for f, b in zip(r["fp8"], r["bf16"])]
            for seed, r in runs.items()}
    worst = [max(g[i] for g in gaps.values()) for i in range(min(map(len, gaps.values())))]
    rep.line(f"dense fp8 against bf16, losses by seed {json.dumps(runs)}")
    rep.line(f"dense fp8 against bf16, |fp8 - bf16| over the bf16 run's first loss by seed "
             f"{json.dumps(gaps)}; largest by step {worst}, limits {list(FP8_LOSS_TOL)}")
    bad = [(seed, "steps") for seed, g in gaps.items() if len(g) != len(FP8_LOSS_TOL)]
    bad += [(seed, i + 1) for seed, g in gaps.items()
            for i, (x, t) in enumerate(zip(g, FP8_LOSS_TOL)) if not x <= t]
    if bad:
        fail(f"dense: the fp8 runs' losses left the bf16 runs' at (seed, step) {bad[:6]}: "
             f"largest by step {worst}, limits {list(FP8_LOSS_TOL)}")


def longseq_phase(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phase 11: see the module docstring. Returns B1-B3's rows at the
    config's attention shape, with the "save_mlp" run's launches."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    cfg_kw, steps = LONGSEQ_CFG, LONGSEQ_STEPS
    S, L = cfg_kw["max_seq_len"], cfg_kw["num_layers"]
    rows = time_flash_shape(torch, fa, rep, "longseq", 1, S, cfg_kw["num_heads"],
                            cfg_kw["num_kv_heads"], 128)
    grads, by_policy = {}, {}
    for remat in ("save_mlp", "full", None):
        t0 = time.perf_counter()
        acc, model, opt, loader, step, carry, first = variant_trainer(
            torch, port, dict(cfg_kw, remat=remat), 1, steps)
        name = f"longseq remat={remat!r}"
        rep.line(f"{name} set-up: {sum(p.numel() for p in model.parameters())} params "
                 f"(registry.py:259-288), {time.perf_counter() - t0:.2f} s")
        _, grads[remat] = grads_of(torch, model, first, torch.bfloat16)
        if remat != "save_mlp":  # held against the first policy's, then dropped
            bad = unequal(grads[remat], grads["save_mlp"])
            rep.line(f"{name}: one step's grads against 'save_mlp': {len(bad)} tensors differ")
            if bad:
                fail(f"longseq: remat={remat!r} changes the step's gradients: {bad[:4]}")
            del grads[remat]
        carry, batch, losses, times, launches, by_design, peak = run_counted(
            torch, wrappers, step, carry, loader)
        steady = statistics.median(times[1:])
        rep.line(f"{name} losses {losses}; step seconds {times}; median of steps 2-{steps} "
                 f"{steady} s, {S / steady} tokens/s; peak memory {peak / 2**30} GiB")
        rep.line(f"{name} kernel launches {json.dumps(launches)}")
        if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            fail(f"{name} losses {losses}: not finite or not falling on a repeated batch")
        fwd = (1 if remat is None else 2) * L * steps
        check_launches(name, launches, by_design, {"flash_fwd": fwd, "flash_bwd_dq": L * steps,
                                                   "flash_bwd_dkv": L * steps})
        by_policy[remat] = launches
        if remat == "save_mlp":
            profile_groups(torch, lambda: step(carry, batch), rep, name)
        del acc, model, opt, loader, step, carry
    del grads
    for row in rows:
        row["launches"] = by_policy["save_mlp"][WRAPPER_OF[row["name"]]]
    return rows


def variant_phases(torch, port, wrappers, rep: Report) -> list[dict]:
    """Phases 9-11; returns the B1-B3 rows at the moe and longseq shapes."""
    t0 = time.perf_counter()
    rows = moe_phase(torch, port, wrappers, rep)
    t1 = time.perf_counter()
    dense_fp8_phase(torch, port, wrappers, rep)
    t2 = time.perf_counter()
    rows += longseq_phase(torch, port, wrappers, rep)
    rep.line(f"variant phases: moe {t1 - t0:.1f} s, dense/fp8 {t2 - t1:.1f} s, longseq "
             f"{time.perf_counter() - t2:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def main() -> None:
    script_t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    try:
        import accelerate_tpu_torch as port
        from accelerate_tpu_torch.ops import _build
        from accelerate_tpu_torch.ops import flash_attention as fa
        from accelerate_tpu_torch.ops import fused
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep = Report(card())
    rep.line(f"torch {torch.__version__} cuda {torch.version.cuda} device "
             f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    wrappers = (*fa.KERNEL_WRAPPERS, *fused.KERNEL_WRAPPERS)
    if "--serve-only" in sys.argv[1:]:
        serve_phase(torch, port, wrappers, rep)
        rep.line("serve-only: the serving phase passed")
        print(rep.card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return

    t0 = time.perf_counter()
    sources = ["flash_attention", "fused"]
    seconds = _build.build(sources)
    rep.line(f"build: {json.dumps(seconds)} s per source, {time.perf_counter() - t0:.2f} s in all")
    for source in sources:
        for line in _build.BUILD_LOGS.get(source, "").splitlines():
            if any(t in line for t in ("registers", "spill", "Compiling entry", "Performance")):
                rep.line(f"ptxas {source}: {line.strip()}")

    def small_models():
        small_model_phase(torch, port, rep)
        for seed in SMALL_SEEDS:
            small_fused_phase(torch, port, fa, fused, rep, seed)

    if "--small-only" in sys.argv[1:]:
        small_models()
        rep.line("small-only: the small models on the card agree with the CPU")
        return
    if "--variants-only" in sys.argv[1:]:
        rows = variant_phases(torch, port, wrappers, rep)
        print(json.dumps({"kernels": rows}))
        rep.line("variants-only: the moe, dense/fp8 and longseq phases passed")
        return
    if "--bert-only" in sys.argv[1:]:
        failed = run_cases(torch, fa, bert_cases(torch), rep)[0]
        if failed:
            fail(f"kernel outputs beyond tolerance: {'; '.join(failed)}")
        rows = time_bert_kernels(torch, fa, rep)
        bert_launches = bert_phase(torch, port, wrappers, rep)
        example_phase(torch, port, wrappers, rep)
        for row in rows:
            row["launches"] = bert_launches[WRAPPER_OF[row["name"]]]
        print(json.dumps({"kernels": rows}))
        rep.line("bert-only: the BERT kernel cases, the BERT phase and the example passed")
        return
    rows = kernel_phase(torch, port, fa, fused, _build, rep,
                        check_only="--check-only" in sys.argv[1:])
    if not rows:
        rep.line("check-only: every kernel case within tolerance")
        return
    bert_rows_ = time_bert_kernels(torch, fa, rep)
    small_models()
    launches, losses = main_path_phase(torch, port, wrappers, rep)
    fa.FUSED_BWD = True  # the reference's switch, on for the fused path
    try:
        fused_launches, fused_losses = main_path_phase(torch, port, wrappers, rep,
                                                       fused_path=True)
    finally:
        fa.FUSED_BWD = False
    check_path_losses(losses, fused_losses, rep)
    bert_launches = bert_phase(torch, port, wrappers, rep)
    example_phase(torch, port, wrappers, rep)
    serve_phase(torch, port, wrappers, rep)
    variant_rows = variant_phases(torch, port, wrappers, rep)
    runs_on_fused_path = ("flash_bwd_fused", "qkv_prologue", "adamw_epilogue")
    for row in rows:
        wrapper = WRAPPER_OF[row["name"]]
        row["shape"] = "llama3_8b main shape" if wrapper != "adamw_epilogue" else "main path leaves"
        row["launches"] = (fused_launches if wrapper in runs_on_fused_path else launches)[wrapper]
    for row in bert_rows_:
        row["launches"] = bert_launches[WRAPPER_OF[row["name"]]]

    rep.line(f"whole script: {time.perf_counter() - script_t0} s")
    print(json.dumps({"kernels": rows + bert_rows_ + variant_rows}))
    print(rep.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
