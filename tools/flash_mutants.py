#!/usr/bin/env python3
"""Plant faults in the port's kernels and check that chip_smoke.py's kernel
checks reject each one.

    python3 tools/flash_mutants.py

Needs one CUDA device. For each mutant it copies the port and
chip_smoke.py into ``accelerate_tpu_torch/ops/build/mutants/<name>/`` (the
gitignored build directory) and applies one text edit to one CUDA source of
the copy. All copies build together; then each copy's checks run one at a
time (the epilogue's bitwise check holds about 50 GB of the card):
``chip_smoke.py --check-only`` (the kernel cases) and, for some copies,
``chip_smoke.py --small-only`` (the tiny models trained on the card against
the CPU). The unedited copy ("control") must pass both. Every mutant must
fail each of its checks: the kernel check at the main path's shape on the
outputs it spoils (the wgmma flash and the prologue faults by the case at
that shape, ``main_bf16_causal`` or ``prologue_main_bf16``; the faults of
the first port's wmma kernels, which only other head dims and fp32 reach,
by ``d96_wmma`` and ``fp32`` (the prologue's: ``prologue_d96_wmma`` and
``prologue_fp32``); a dk/dv tile past a padded row's length left unwritten
by the BERT-shape case ``bert_noncausal_lengths_d64_g1``, the only case
with a kv tile wholly past a non-zero length; a prologue store past the last row by the guard rows of
the cases whose rows end inside a tile, ``prologue_rows_s200`` and
``prologue_rows_s300``; the epilogue faults by the bitwise check on the
main path's 39 leaves), the small-model check by the tiny fused model's
comparison. Prints one JSON line per check with its
readings (for a case, the per-row error that is checked and the global
max|err| / max|plain| where the case reports one; otherwise the failure),
and exits 1 when a mutant was not caught or the control failed. The copies
are removed at the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

from port_copies import BUILD, build_copies, make_copy

WORK = BUILD / "mutants"
FLASH = Path("accelerate_tpu_torch/ops/csrc/flash_attention.cu")
FUSED = Path("accelerate_tpu_torch/ops/csrc/fused.cu")
FLASH_CASE, PROLOGUE_CASE = "main_bf16_causal", "prologue_main_bf16"
WMMA_CASES = ("d96_wmma", "fp32")  # bf16 at head_dim 96, and fp32: the wmma kernels
PROLOGUE_WMMA_CASES = ("prologue_d96_wmma", "prologue_fp32")
PARTIAL_ROW_CASES = ("prologue_rows_s200", "prologue_rows_s300")  # a partial 128-row tile
BERT_CASE = "bert_noncausal_lengths_d64_g1"  # lengths 512, 300, 129, 0 in 128-row kv tiles

FWD_STAGE = "    const int stage = n & 1;  // the ring stage that holds tile n"
FWD_RESCALE = "      corr[hh] = exp2f((m[hh] - m_new) * LOG2E);"
FWD_FIRST_P = "    for (int kk = 0; kk < BK / 16; ++kk) hk::pack_a<T>(s, kk, pa[kk]);  // tile 0's p"
DQ_LOOP = """  for (int it = t_begin; it < t_end; ++it) {
    const int k0 = it * BK;
    load_tile(sm.k, LT, static_cast<const T*>(p.k) + kbase, kstride, k0, BK, p.Skv, D);"""
DKV_LOOP = """      const int q0 = it * BQ, qmax = min(q0 + BQ, p.S) - 1;"""
FUSED_DQ_ADD = "      float* DQ = p.dq_acc + ((size_t)b * p.S * p.H + h) * D + wg * (D / 2);"
FUSED_DS = "      dpt.d[i] = st.d[i] * (dpt.d[i] - dl) * p.scale;"
KV_PAIR = "    // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 64 kv rows\n"
KV_STORE = "  uint16_t* dK = static_cast<uint16_t*>(p.o) + kbase;"
SKIP = "    if ({}) {{\n      __syncthreads();\n      continue;\n    }}\n"
DQ_PACK = "    for (int kk = 0; kk < BK / 16; ++kk) hk::pack_a<T>(dp, kk, da[kk]);"
DQ_STAGE = "hk::desc_mnmajor<BK>(kt, 0, kk), 1);  // dQ += dS K"
DQ_DS = "dp.d[i] = s.d[i] * (dp.d[i] - dl[frag_half(i)]) * p.scale;"
ROPE_PARTNER = "proj_at<T>(accs, LA, bias, r, j < half ? n + half : n - half, lc0)"
PRO_W_STAGE = "const uint32_t wt = base + (i % S) * L::STAGE + L::X;"
PRO_NORM = ("a[kk][q] = hk::pack2<T>((v.x * rs[q % 2]) * mq[q / 2].x, "
            "(v.y * rs[q % 2]) * mq[q / 2].y);")
PRO_RSTD = "rs[h] = row < p.rows ? p.rstd[row] : 0.f;"
PRO_PAIR = "const float x1 = at(j1, h, e), x2 = at(j2, h, e);"
PRO_STORE = "if (row >= p.rows) continue;  // a partial row tile stores its rows only"
EPI_HOLD = "  if (row[4] == 0.f) return;  // not finite: p, mu and nu stay as they are"
EPI_MU = "  const float mu2 = __fadd_rn(__fmul_rn(c.omb1, g), __fmul_rn(c.b1, mu));"
EPI_ROOT = "float u = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(__fadd_rn(nhat, c.eps_root)), c.eps));"
CHECK, SMALL = "--check-only", "--small-only"
SMALL_FAILS = (SMALL, None, "small fused model")

# name -> (source, text in it, its replacement, checks), a check being
# (chip_smoke.py's flag, the case or cases that must flag it (all of them)
# or None, what must be flagged: outputs or checks of each case, or a text
# of the failure)
MUTANTS = {
    "control": (None, None, None, [(CHECK, FLASH_CASE, []), (SMALL, None, None)]),
    # B1 (wgmma): the online softmax never rescales what earlier kv tiles
    # accumulated
    "fwd_no_rescale": (FLASH, FWD_RESCALE, "      corr[hh] = 1.f;", [(CHECK, FLASH_CASE, ["o"])]),
    # B1: the last q tile of every head drops its first kv tile's p V
    "fwd_drop_tile": (FLASH, FWD_FIRST_P, FWD_FIRST_P + "\n    if (iq == nq - 1)\n"
                      "#pragma unroll\n      for (int kk = 0; kk < BK / 16; ++kk) pa[kk][0] = pa[kk][1] = "
                      "pa[kk][2] = pa[kk][3] = 0u;", [(CHECK, FLASH_CASE, ["o"])]),
    # B1: the products read the other ring stage, the one being filled with
    # the next tile (or, on the last tile, the previous one)
    "fwd_stale_stage": (FLASH, FWD_STAGE, FWD_STAGE.replace("n & 1", "(n + 1) & 1"),
                        [(CHECK, FLASH_CASE, ["o"])]),
    # B2 (wgmma): the last q tile of every head drops its first kv tile's dS K
    "dq_wgmma_drop_tile": (FLASH, DQ_PACK, DQ_PACK + "\n    if (iq == nq - 1 && n == 0)\n"
                           "#pragma unroll\n      for (int kk = 0; kk < BK / 16; ++kk) da[kk][0] = "
                           "da[kk][1] = da[kk][2] = da[kk][3] = 0u;",
                           [(CHECK, FLASH_CASE, ["dq"])]),
    # B2: dS K reads K from the other ring stage, the one being filled with
    # a later tile (or holding an earlier one)
    "dq_stale_stage": (FLASH, DQ_STAGE, DQ_STAGE.replace(
        "(kt, 0, kk)", "(base + L::K + ((n + 1) % STAGES) * L::STAGE, 0, kk)"),
        [(CHECK, FLASH_CASE, ["dq"])]),
    # B2: dS = p (dp - delta) scale loses its delta
    "dq_no_delta": (FLASH, DQ_DS, DQ_DS.replace("(dp.d[i] - dl[frag_half(i)])", "dp.d[i]"),
                    [(CHECK, FLASH_CASE, ["dq"])]),
    # B3 (wgmma; not B4, whose body it shares): the first kv tile skips its
    # last pair, the last q tile of the last query head of its group. One
    # pair of 128 moves dk and dv by about the row limit, so the case must
    # flag the bitwise check against B4.
    "dkv_wgmma_drop_pair": (FLASH, KV_PAIR, SKIP.format("!kDq && ik == 0 && n == total - 1")
                            + KV_PAIR, [(CHECK, FLASH_CASE, ["dk_equals_fused",
                                                            "dv_equals_fused"])]),
    # B3 (wgmma, not B4): a kv tile wholly past its row's length, in a row
    # with some real keys, returns without storing its dk and dv (zeros): they
    # keep what the memory held. Only the BERT case has such a tile; its
    # repeat launch into NaN-filled outputs reads NaN there.
    "dkv_padded_tile_unwritten": (FLASH, KV_STORE, "  if (!kDq && total == 0 && kv_valid > 0) "
                                  "return;\n" + KV_STORE,
                                  [(CHECK, BERT_CASE, ["dk_repeats", "dv_repeats"])]),
    # B2 and B3 (wmma, the first port's): the last q tile of each head skips
    # its first kv tile
    "dq_drop_tile": (FLASH, DQ_LOOP, DQ_LOOP.replace(
        "const int k0 = it * BK;",
        "if (iq == (int)gridDim.x - 1 && it == t_begin) continue;\n    const int k0 = it * BK;"),
        [(CHECK, WMMA_CASES, ["dq"])]),
    # the first kv tile skips the last q tile of every query head
    "dkv_drop_tile": (FLASH, DKV_LOOP, "      if (ik == 0 && it == t_end - 1) continue;\n"
                      + DKV_LOOP, [(CHECK, WMMA_CASES, ["dk", "dv"])]),
    # B4 (wgmma): the first kv tile's dq contribution to the last q tile of
    # the last query head of each group is dropped
    "fused_drop_dq_tile": (FLASH, FUSED_DQ_ADD, SKIP.format("ik == 0 && n == total - 1")
                           + FUSED_DQ_ADD, [(CHECK, FLASH_CASE, ["fused_dq"])]),
    # B4 and B3 (one body): dS = p (dp - delta) scale loses its delta on
    # each CTA's last pair (the last q tile of the last query head of its
    # group)
    "fused_no_delta_last_tile": (FLASH, FUSED_DS, FUSED_DS.replace(
        "- dl)", "- (n == total - 1 ? 0.f : dl))"), [(CHECK, FLASH_CASE, ["fused_dq", "fused_dk"])]),
    # prologue (wmma design: D 96 and fp32): rope takes its partner column
    # from the next head
    "prologue_partner_off_by_a_head": (
        FUSED, ROPE_PARTNER,
        "proj_at<T>(accs, LA, bias, r, ((j < half ? n + half : n - half) + D) % c, lc0)",
        [(CHECK, PROLOGUE_WMMA_CASES, ["q", "k"]), SMALL_FAILS]),
    # prologue (wgmma design): the products read the W tile of the other ring
    # stage, one being filled with a later k-step (or holding an earlier one)
    "prologue_w_other_stage": (FUSED, PRO_W_STAGE, PRO_W_STAGE.replace("(i % S)", "((i + 1) % S)"),
                               [(CHECK, PROLOGUE_CASE, ["q", "k", "v"])]),
    # the last k-step's fragments are zeros: its products add nothing
    "prologue_drop_last_k": (FUSED, PRO_NORM, PRO_NORM + "\n        if (i == nk - 1) a[kk][q] = 0u;",
                             [(CHECK, PROLOGUE_CASE, ["q", "k", "v"])]),
    # each row normalised by its neighbour's rstd
    "prologue_rstd_neighbour_row": (FUSED, PRO_RSTD, PRO_RSTD.replace("p.rstd[row]",
                                                                      "p.rstd[row ^ 1]"),
                                    [(CHECK, PROLOGUE_CASE, ["q", "k", "v"])]),
    # rope's partner read from the thread's register of the other row (8 rows
    # away) instead of the same row's
    "prologue_partner_wrong_register": (FUSED, PRO_PAIR, PRO_PAIR.replace(
        "x2 = at(j2, h, e)", "x2 = at(j2, 1 - h, e)"), [(CHECK, PROLOGUE_CASE, ["q", "k"])]),
    # a partial row tile stores one row past its last; the main shape has no
    # partial tile, so the cases that end inside a tile must flag their guards
    "prologue_stores_past_last_row": (FUSED, PRO_STORE, PRO_STORE.replace(
        "row >= p.rows", "row >= p.rows + 1"), [(CHECK, PARTIAL_ROW_CASES, ["guards_intact"])]),
    # epilogue: a step that is not finite is applied anyway
    "epilogue_ignores_hold": (FUSED, EPI_HOLD, "  // (the hold is gone)",
                              [(CHECK, None, "adamw_epilogue (held) is not bitwise")]),
    # epilogue: the first moment's product contracted into an fma
    "epilogue_fma_mu": (FUSED, EPI_MU, "  const float mu2 = fmaf(c.omb1, g, __fmul_rn(c.b1, mu));",
                        [(CHECK, None, "adamw_epilogue (finite) is not bitwise")]),
    # epilogue: eps inside the root, sqrt(nu_hat + eps) (another AdamW)
    "epilogue_eps_in_root": (FUSED, EPI_ROOT,
                             "float u = __fdiv_rn(mhat, __fsqrt_rn(__fadd_rn(nhat, c.eps)));",
                             [SMALL_FAILS]),
}


def reading_of(stdout: str, case: str):
    for line in stdout.splitlines():
        at = line.find(f'{{"case": "{case}"')
        if at >= 0:
            return json.loads(line[at:])
    return None


def main() -> None:
    roots = {name: make_copy(WORK / name, [] if source is None else [(source, old, new)])
             for name, (source, old, new, _) in MUTANTS.items()}
    build_copies(roots, ["flash_attention", "fused"])
    missed = []
    for name, (_, _, _, checks) in MUTANTS.items():
        for flag, case, want in checks:
            proc = subprocess.run([sys.executable, "chip_smoke.py", flag], cwd=roots[name],
                                  capture_output=True, text=True, timeout=900)
            if case is None:  # a failure's text, or a clean pass for the control
                reading = next((line for line in proc.stderr.splitlines() if "FAIL" in line),
                               None)
                if name == "control":
                    ok = proc.returncode == 0 and reading is None
                else:
                    ok = proc.returncode != 0 and reading is not None and want in reading
            else:
                cases = (case,) if isinstance(case, str) else case
                readings = [reading_of(proc.stdout, c) for c in cases]
                if name == "control":
                    ok = proc.returncode == 0 and all(r is not None and not r["bad"]
                                                      for r in readings)
                else:
                    ok = proc.returncode != 0 and all(
                        r is not None and all(k in r["bad"] for k in want) for r in readings)
                reading = readings[0] if len(readings) == 1 else readings
            if flag == SMALL:  # the tiny fused models' readings, pass or fail
                reading = [line[line.find("small fused"):] for line in proc.stdout.splitlines()
                           if "small fused model fp32" in line] + [reading]
            print(json.dumps({
                "mutant": name, "check": flag, "caught" if name != "control" else "passes": ok,
                "rc": proc.returncode, "reading": reading,
            }), flush=True)
            if not ok:
                missed.append(f"{name} {flag}")
                print(proc.stderr[-3000:], file=sys.stderr)
    shutil.rmtree(WORK, ignore_errors=True)
    if missed:
        print(f"flash_mutants: FAIL: {missed}", file=sys.stderr)
        sys.exit(1)
    print("flash_mutants: the control passes and every planted fault is caught")


if __name__ == "__main__":
    main()
