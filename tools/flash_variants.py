#!/usr/bin/env python3
"""Time build-time variants of the wgmma flash kernels (the forward, dq,
dk/dv and the single-pass backward) and of the fused prologue at the main
path's shapes, to split a kernel's time among its parts.

    python3 tools/flash_variants.py [--only NAME ...]

Needs one CUDA device. Each variant is a copy of the port under the
gitignored ``accelerate_tpu_torch/ops/build/variants/<name>/`` with text
edits to ``flash_attention.cu`` or ``fused.cu`` (tools/port_copies.py: each
must match the source exactly once, so a kernel rewrite must update them).
Most variants take one part of a kernel out, so their outputs are wrong by
design and only their time is read; ``wmma_design`` and
``prologue_wmma_design`` keep the function and time the first port's
kernels beside the wgmma ones in the same call. The committed source never
carries such a switch. All copies build together (one ``nvcc`` a source);
each library is loaded with ctypes and its ``flash_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkv`` and ``flash_bwd_fused`` are timed at B=2, S=2048, H=32,
Hkv=8, D=128, bf16, causal, and its ``fused_qkv_prologue`` (the rstd
pre-pass included) at 4096 rows, E 4096 -> 6144 columns, bf16, as
chip_smoke.py times them (median of 20 launches, each after an L2 flush),
in two rounds with the variants interleaved. Prints one JSON line a variant
(its times, and the row errors of O, dq, dk and the prologue's q against
the plain versions: base-sized for a variant that keeps the function, large
for one that takes a part out; ptxas's spills and wgmma serialisation),
then the card's name and power limit. The copies are removed at the end.
``--only`` builds and times only the variants named (``base`` among them to
compare with).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import sys

from port_copies import BUILD, REPO, build_copies, library, make_copy

WORK = BUILD / "variants"
FLASH = "accelerate_tpu_torch/ops/csrc/flash_attention.cu"
FUSED = "accelerate_tpu_torch/ops/csrc/fused.cu"

NTILES = "  const int ntiles = t_end - t_begin;"
NKV = "  const int nkv = t_end - t_begin;"
NPAIRS = "  const int nt = t_end - t_begin, total = G * nt;"
# the forward's copies and waits of K and V; the single pass's of Q and dO
COPY_K = "    if (leader && n < ntiles) {\n      hk::mbar_expect_tx(bar_k"
COPY_V = "    if (leader && n < ntiles) {\n      hk::mbar_expect_tx(bar_v"
WAIT_K = "  auto wait_k = [&](int n) { hk::mbar_wait("
WAIT_V = "  auto wait_v = [&](int n) { hk::mbar_wait("
WAIT_QD = "    hk::mbar_wait(bar_qd + 8 * (n & 1), (n >> 1) & 1);"
BWD_NEXT = "    if (n + 1 < total) {  // pair n + 1"
DQ_ADD = "if (qrow < p.S)\n          atomicAdd("
DESIGN = "bool wgmma_design(int dtype, int D) {\n  return "
DQ_STAGES = "  static constexpr int STAGES = 2;"
DQ_END = "    hk::wgmma_commit();\n  }\n  hk::wgmma_wait<0>();\n  dq.fence();\n"
PRO_DESIGN = "bool pro_wgmma_design(int dtype, int H, int Hkv, int D, int E) {\n  return "
NAN_MAX = '  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));'
PRO_STAGES = "constexpr int PRO_STAGES = 4;"
PRO_WAIT = "hk::wgmma_wait<1>();  // k-step i - 1 retired"
PRO_WN = "return N == 192 ? 64 : N;"
PRO_MULT = ("const float2 mq[2] = {*reinterpret_cast<const float2*>(m + 16 * kk),\n"
            "                            *reinterpret_cast<const float2*>(m + 16 * kk + 8)};")
PRO_NORM = ("a[kk][q] = hk::pack2<T>((v.x * rs[q % 2]) * mq[q / 2].x, "
            "(v.y * rs[q % 2]) * mq[q / 2].y);")

# name -> (what it changes, [(source, old, new)] edits)
VARIANTS = {
    "base": ("the committed source", []),
    "fmaxf_row_max": ("the softmax's row max by fmaxf, which drops NaN (the forward before "
                      "its NaN rows were repaired)", [(FLASH, NAN_MAX, "  r = fmaxf(a, b);")]),
    "select_nan_max": ("the softmax's row max keeping NaN by compares and selects around "
                       "fmaxf instead of one max.NaN",
                       [(FLASH, NAN_MAX, "  r = a != a ? a : (b != b ? b : fmaxf(a, b));")]),
    "wmma_design": ("every launch takes the wmma design (flash_fwd_wmma_kernel, "
                    "flash_bwd_dq_wmma_kernel, flash_bwd_dkv_wmma_kernel, "
                    "flash_bwd_fused_wmma_kernel), the kernels before the wgmma ones",
                    [(FLASH, DESIGN, DESIGN + "false && ")]),
    "no_tiles": ("every CTA skips its loop: launch, Q/K/V loads, epilogue stores",
                 [(FLASH, NTILES, "  const int ntiles = 0;"), (FLASH, NKV, "  const int nkv = 0;"),
                  (FLASH, NPAIRS, "  const int nt = t_end - t_begin, total = 0 * G * nt;")]),
    "dq_three_stages": ("dq: a three-stage K/V ring (a tile's copy has two tiles' "
                        "work to land, not one)", [(FLASH, DQ_STAGES, DQ_STAGES.replace("2", "3"))]),
    "dq_no_overlap": ("dq: each tile's dS K retires before the next tile's S and dP "
                      "are issued", [(FLASH, DQ_END, DQ_END.replace("commit();\n", "commit();\n"
                                                             "    hk::wgmma_wait<0>();\n", 1))]),
    "fwd_no_stream": ("forward: only kv tiles 0 and 1 are copied; later tiles reuse "
                      "their stage's stale data",
                      [(FLASH, COPY_K, COPY_K.replace("n < ntiles", "n < min(ntiles, 2)")),
                       (FLASH, COPY_V, COPY_V.replace("n < ntiles", "n < min(ntiles, 2)")),
                       (FLASH, WAIT_K, WAIT_K.replace("{ hk", "{ if (n < 2) hk")),
                       (FLASH, WAIT_V, WAIT_V.replace("{ hk", "{ if (n < 2) hk"))]),
    "fwd_no_s": ("forward: S = Q K^T of tiles 1.. is not issued",
                 [(FLASH, "    issue_s(n + 1);\n", "")]),
    "fwd_no_pv": ("forward: O += P V of tiles 0..n-2 is not issued",
                  [(FLASH, "    issue_pv(n);\n", "")]),
    "fwd_no_softmax": ("forward: the softmax of tiles 1.. is skipped (P = raw S)",
                       [(FLASH, "    softmax(n + 1);\n", "")]),
    "bwd_no_stream": ("single pass: only pairs 0 and 1 are copied; later pairs reuse "
                      "their stage's stale data",
                      [(FLASH, BWD_NEXT, BWD_NEXT.replace("n + 1 < total", "n + 1 < min(total, 2)")),
                       (FLASH, WAIT_QD, "    if (n < 2)\n  " + WAIT_QD)]),
    "bwd_no_dq_add": ("single pass: dq_pair is formed but never added to the buffer",
                      [(FLASH, DQ_ADD, "if (qrow < 0) atomicAdd(")]),
    "prologue_wmma_design": ("the prologue takes the wmma design (qkv_prologue_wmma_kernel, "
                             "the kernel before the wgmma one)",
                             [(FUSED, PRO_DESIGN, PRO_DESIGN + "false && ")]),
    "prologue_no_overlap": ("prologue: each k-step's products retire before the next "
                            "k-step's fragments are formed",
                            [(FUSED, PRO_WAIT, PRO_WAIT.replace("<1>", "<0>"))]),
    "prologue_two_stages": ("prologue: a two-stage ring", [(FUSED, PRO_STAGES,
                                                           PRO_STAGES.replace("4", "2"))]),
    "prologue_three_stages": ("prologue: a three-stage ring", [(FUSED, PRO_STAGES,
                                                               PRO_STAGES.replace("4", "3"))]),
    "prologue_n128": ("prologue: two m64n128 wgmmas a k16 step instead of one m64n256",
                      [(FUSED, PRO_WN, "return N == 192 ? 64 : (N == 256 ? 128 : N);")]),
    "prologue_no_norm": ("prologue: the raw x fragments go to the products (no rstd, "
                         "mult or rounding)", [(FUSED, PRO_NORM, "a[kk][q] = raw[q];")]),
    "prologue_no_mult_loads": ("prologue: the norm multiplier is 1, not loaded",
                               [(FUSED, PRO_MULT, "const float2 mq[2] = {make_float2(1.f, 1.f), "
                                 "make_float2(1.f, 1.f)};")]),
    "prologue_mult_from_global": ("prologue: the norm multiplier read from global memory "
                                  "(__ldg) instead of the stage's copy in shared memory",
                                  [(FUSED, PRO_MULT, "const float* mg = p.mult + 2 * (lane % 4) + "
                                    "i * PRO_BK + 16 * kk;\n      const float2 mq[2] = {__ldg("
                                    "reinterpret_cast<const float2*>(mg)), __ldg(reinterpret_cast"
                                    "<const float2*>(mg + 8))};")]),
    "prologue_no_rope": ("prologue: the epilogue skips rope (round, bias and store stay)",
                         [(FUSED, "  if (part < 2) {\n", "  if (false) {\n")]),
}


def main() -> None:
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fused

    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA device")

    parser = argparse.ArgumentParser()
    parser.add_argument("--only", nargs="+", choices=sorted(VARIANTS), default=list(VARIANTS))
    only = parser.parse_args().only
    roots = {name: make_copy(WORK / name, edits) for name, (_, edits) in VARIANTS.items()
             if name in only}
    logs = build_copies(roots, ["flash_attention", "fused"])

    def load(root, source, signatures, error_string):
        lib = ctypes.CDLL(str(library(root, source)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
        getattr(lib, error_string).argtypes = [ctypes.c_int]
        getattr(lib, error_string).restype = ctypes.c_char_p
        return lib

    libs, pro_libs, notes = {}, {}, {}
    for name, log in logs.items():
        # spills, and wgmma serialised by ptxas (warning C7514)
        notes[name] = sorted({line.strip()[-160:] for line in log.splitlines()
                              if re.search(r"[1-9][0-9]* bytes spill", line)
                              or "C7514" in line})
        libs[name] = load(roots[name], "flash_attention", fa._SIGNATURES, "flash_error_string")
        pro_libs[name] = load(roots[name], "fused", fused._SIGNATURES, "fused_error_string")

    B, S, H, Hkv, D = (cs.MAIN[k] for k in ("B", "S", "H", "Hkv", "D"))
    q, k, v, dout = cs.make_inputs(torch, B, S, H, Hkv, D, torch.bfloat16)
    scale = D ** -0.5
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, scale, True)
    delta = fa.attention_delta(ref_out, dout)
    o, lse = torch.empty_like(q), torch.empty_like(ref_lse)
    dq = torch.zeros(q.shape, dtype=torch.float32, device="cuda")  # the single pass's
    dq16 = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    flush_buf = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    shape = (B, S, S, H, Hkv, D, scale, 1, 0, _build.DTYPE_CODES[torch.bfloat16])

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(lib):
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(),
                            lse.data_ptr(), *shape, stream())
        assert err == 0, lib.flash_error_string(err)

    def bwd(lib):
        err = lib.flash_bwd_fused(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                  ref_lse.data_ptr(), delta.data_ptr(), None, dq.data_ptr(),
                                  dk.data_ptr(), dv.data_ptr(), *shape, stream())
        assert err == 0, lib.flash_error_string(err)

    def dq_kernel(lib):
        err = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                               ref_lse.data_ptr(), delta.data_ptr(), None, dq16.data_ptr(),
                               *shape, stream())
        assert err == 0, lib.flash_error_string(err)

    def dkv_kernel(lib):
        err = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                ref_lse.data_ptr(), delta.data_ptr(), None, dk.data_ptr(),
                                dv.data_ptr(), *shape, stream())
        assert err == 0, lib.flash_error_string(err)

    # the prologue at the main path's shape, called as its wrapper calls it
    pro = dict(B=B, S=S, E=4096, H=H, Hkv=Hkv, D=D, dtype=torch.bfloat16)
    pargs, pstat = cs.prologue_inputs(torch, fused, **pro, seed=2)
    px, pscale, *pws, pcos, psin = (pargs[0], pargs[1], *pargs[2:5], pargs[8], pargs[9])
    mult = pscale.float().contiguous()
    rows = B * S
    rstd = torch.empty(rows, dtype=torch.float32, device="cuda")
    pq = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="cuda")
    pk, pv = (torch.empty(B, S, Hkv, D, dtype=torch.bfloat16, device="cuda") for _ in range(2))
    ref_pq = fused._prologue_reference_tables(*pargs, **pstat)[0]

    def prologue(lib):
        err = lib.fused_qkv_prologue(
            px.data_ptr(), mult.data_ptr(), *(w.data_ptr() for w in pws), None, None, None,
            pcos.data_ptr(), psin.data_ptr(), pq.data_ptr(), pk.data_ptr(), pv.data_ptr(),
            rstd.data_ptr(), rows, pro["E"], H, Hkv, D, fused._col_block(H, Hkv, D), 1e-5,
            _build.DTYPE_CODES[torch.bfloat16], stream())
        assert err == 0, lib.fused_error_string(err)

    ref_dq = fa.flash_bwd_dq_reference(q, k, v, dout, ref_lse, delta, scale, True)
    ref_dk, _ = fa.flash_bwd_dkv_reference(q, k, v, dout, ref_lse, delta, scale, True)
    errs = {}
    for name, lib in libs.items():
        fwd(lib)
        dq_kernel(lib)
        dkv_kernel(lib)
        prologue(pro_libs[name])
        torch.cuda.synchronize()
        errs[name] = {"o": cs.row_err(torch, o, ref_out), "dq": cs.row_err(torch, dq16, ref_dq),
                      "dk": cs.row_err(torch, dk, ref_dk),
                      "prologue_q": cs.row_err(torch, pq, ref_pq)}
    del ref_pq
    kernels = {"fwd_ms": fwd, "dq_ms": dq_kernel, "dkv_ms": dkv_kernel, "bwd_ms": bwd}
    times = {name: {key: [] for key in (*kernels, "prologue_ms")} for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            for key, fn in kernels.items():
                times[name][key].append(cs.time_ms(torch, lambda: fn(lib), 20, flush_buf.zero_))
            times[name]["prologue_ms"].append(
                cs.time_ms(torch, lambda: prologue(pro_libs[name]), 20, flush_buf.zero_))
    for name, (what, _) in VARIANTS.items():
        if name not in libs:
            continue
        print(json.dumps({"variant": name, "what": what, **times[name],
                          "row_err": errs[name], "ptxas": notes[name]}), flush=True)
    print(cs.card())
    shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
