#!/usr/bin/env python3
"""Plant faults in the flash-attention kernels and check that
chip_smoke.py's kernel comparison rejects each one.

    python3 tools/flash_mutants.py

Needs one CUDA device. For each mutant it copies the port and
chip_smoke.py into ``accelerate_tpu_torch/ops/build/mutants/<name>/`` (the
gitignored build directory), applies one text edit to the copy's
``csrc/flash_attention.cu`` and runs the copy's ``chip_smoke.py
--check-only``; all copies build and run together. The unedited copy
("control") must pass. Every mutant must fail, and must fail at the main
path's shape (case ``main_bf16_causal``) on the outputs it spoils, so the
check at that shape is shown to catch it on its own. Prints one JSON line
per copy with its main-shape readings (the per-row error that is checked
and, for comparison, the global max|err| / max|plain|), and exits 1 when a
mutant was not caught or the control failed. The copies are removed at
the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORK = REPO / "accelerate_tpu_torch" / "ops" / "build" / "mutants"
SOURCE = Path("accelerate_tpu_torch/ops/csrc/flash_attention.cu")

FWD_LOOP = """  for (int it = t_begin; it < t_end; ++it) {
    const int k0 = it * BK;
    load_tile(sm.k, LT, K, kstride, k0, BK, p.Skv, D);"""
DQ_LOOP = """  for (int it = t_begin; it < t_end; ++it) {
    const int k0 = it * BK;
    load_tile(sm.k, LT, static_cast<const T*>(p.k) + kbase, kstride, k0, BK, p.Skv, D);"""
DKV_LOOP = """      const int q0 = it * BQ, qmax = min(q0 + BQ, p.S) - 1;"""

# name -> (text in the source, its replacement, outputs the main case must flag)
MUTANTS = {
    "control": (None, None, []),
    # the online softmax never rescales what earlier kv tiles accumulated
    "fwd_no_rescale": ("const float corr = expf(m_prev - m_new);", "const float corr = 1.f;",
                       ["o"]),
    # the last q tile of every head skips its first kv tile
    "fwd_drop_tile": (FWD_LOOP, FWD_LOOP.replace(
        "const int k0 = it * BK;",
        "if (iq == (int)gridDim.x - 1 && it == t_begin) continue;\n    const int k0 = it * BK;"),
        ["o"]),
    "dq_drop_tile": (DQ_LOOP, DQ_LOOP.replace(
        "const int k0 = it * BK;",
        "if (iq == (int)gridDim.x - 1 && it == t_begin) continue;\n    const int k0 = it * BK;"),
        ["dq"]),
    # the first kv tile skips the last q tile of every query head
    "dkv_drop_tile": (DKV_LOOP, "      if (ik == 0 && it == t_end - 1) continue;\n" + DKV_LOOP,
                      ["dk", "dv"]),
}


def make_copy(name: str, old, new) -> Path:
    root = WORK / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "accelerate_tpu_torch", root / "accelerate_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(REPO / "chip_smoke.py", root / "chip_smoke.py")
    if old is not None:
        src = root / SOURCE
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to replace is not in {SOURCE} exactly once")
        src.write_text(text.replace(old, new))
    return root


def main_reading(stdout: str):
    for line in stdout.splitlines():
        at = line.find('{"case": "main_bf16_causal"')
        if at >= 0:
            return json.loads(line[at:])
    return None


def main() -> None:
    procs = {}
    for name, (old, new, _) in MUTANTS.items():
        root = make_copy(name, old, new)
        procs[name] = subprocess.Popen(
            [sys.executable, "chip_smoke.py", "--check-only"], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    missed = []
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=900)
        reading = main_reading(out)
        want = MUTANTS[name][2]
        if name == "control":
            ok = proc.returncode == 0 and reading is not None and not reading["bad"]
        else:
            ok = (proc.returncode != 0 and reading is not None
                  and all(k in reading["bad"] for k in want))
        print(json.dumps({
            "mutant": name, "caught_at_main_shape" if name != "control" else "passes": ok,
            "rc": proc.returncode, "main": reading,
        }), flush=True)
        if not ok:
            missed.append(name)
            print(err[-3000:], file=sys.stderr)
    shutil.rmtree(WORK, ignore_errors=True)
    if missed:
        print(f"flash_mutants: FAIL: {missed}", file=sys.stderr)
        sys.exit(1)
    print("flash_mutants: the control passes and every planted fault is caught")


if __name__ == "__main__":
    main()
