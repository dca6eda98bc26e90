#!/usr/bin/env python3
"""Plant faults in the port's fp8 backward and check which of chip_smoke.py's
fp8 checks reject each one.

    python3 tools/fp8_mutants.py

Needs one CUDA device. For each mutant it copies the port and
chip_smoke.py into ``accelerate_tpu_torch/ops/build/fp8_mutants/<name>/``
(the gitignored build directory) and applies one text edit to the copy's
``ops/fp8.py``; the control copy has none. The edits touch no CUDA source,
so the flash library is built once, in the control copy, and copied into
the others. Then each copy runs, in a process of its own, chip_smoke.py's
two fp8 checks, each on its own: ``check_fp8_products`` (the products
against their plain version at the dense config's projection shapes,
FP8_PRODUCT_TOL) and ``fp8_loss_gaps`` (the dense config trained 5 steps
in bf16 and in fp8 from every seed of FP8_SEEDS, FP8_LOSS_TOL). The
control must pass both, and each mutant must fail the checks listed for
it; the other check's verdict is printed too. Prints one JSON line per
(copy, check) with its verdict, its reading and the failure's text, and
exits 1 when a listed check passed a mutant or the control failed. The
copies are removed at the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from port_copies import BUILD, build_copies, library, make_copy

WORK = BUILD / "fp8_mutants"
FP8 = "accelerate_tpu_torch/ops/fp8.py"
GS = "gs = _scale_for(g, E5M2_MAX)"
DX = "dx = scaled_mm(gq, wq.t(), gs, ws, ctx.x_dtype)"
DW = "dw = scaled_mm(gq.t(), xq, gs, xs, ctx.w_dtype).t()"
RET = "return dx.reshape(ctx.x_shape), dw, None, None, None"
PRODUCTS, LOSSES = "products", "losses"

# name -> (text in ops/fp8.py, its replacement, the checks that must fail it)
MUTANTS = {
    "control": (None, None, ()),
    # dw with the wrong sign: the fp8 projections climb the loss
    "dw_sign": (RET, "return dx.reshape(ctx.x_shape), -dw, None, None, None",
                (PRODUCTS, LOSSES)),
    # dw pairs each gradient row with the previous row's x (an off-by-one)
    "dw_rows_shifted": (DW, "dw = scaled_mm(gq.t(), xq.view(torch.uint8).roll(1, 0)"
                            ".view(xq.dtype), gs, xs, ctx.w_dtype).t()", (PRODUCTS, LOSSES)),
    # the gradient quantised without its scale: values under e5m2's
    # smallest subnormal (2^-16) flush to zero
    "g_unscaled": (GS, "gs = torch.ones((), device=g.device)", (PRODUCTS, LOSSES)),
    # dx divided by x's scale instead of w's: each product's dx off by one
    # factor (AdamW divides a gradient's scale out again)
    "dx_scale_pair": (DX, "dx = scaled_mm(gq, wq.t(), gs, xs, ctx.x_dtype)", (PRODUCTS,)),
}

# runs in a copy: each check on its own, a failure raised instead of exiting
RUNNER = """
import json, torch
import chip_smoke as cs
import accelerate_tpu_torch as port

class Failed(Exception):
    pass

def fail(msg):
    raise Failed(msg)

cs.fail = fail
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rep = cs.Report(cs.card())
for name, check in (("products", lambda: cs.check_fp8_products(torch, rep)),
                    ("losses", lambda: cs.fp8_loss_gaps(torch, port, rep))):
    try:
        check()
        failure = None
    except Failed as e:
        failure = str(e)
    print("RESULT " + json.dumps({"check": name, "failure": failure}), flush=True)
"""
READING = {PRODUCTS: "worst row's max error over its RMS", LOSSES: "largest by step"}


def main() -> None:
    roots = {name: make_copy(WORK / name, [] if old is None else [(FP8, old, new)])
             for name, (old, new, _) in MUTANTS.items()}
    build_copies({"control": roots["control"]}, ["flash_attention"])
    lib = library(roots["control"], "flash_attention")
    for name, root in roots.items():
        if name != "control":
            target = root / "accelerate_tpu_torch" / "ops" / "build"
            target.mkdir(parents=True, exist_ok=True)
            shutil.copy2(lib, target / lib.name)
    missed = []
    for name, (_, _, must) in MUTANTS.items():
        proc = subprocess.run([sys.executable, "-c", RUNNER], cwd=roots[name],
                              capture_output=True, text=True, timeout=900)
        results = {r["check"]: r["failure"] for r in (
            json.loads(line[len("RESULT "):]) for line in proc.stdout.splitlines()
            if line.startswith("RESULT "))}
        if proc.returncode != 0 or set(results) != {PRODUCTS, LOSSES}:
            missed.append(f"{name}: the checks did not run to their end")
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            continue
        for check, failure in results.items():
            reading = next((line[line.find("]") + 2:] for line in proc.stdout.splitlines()
                            if READING[check] in line), None)
            if name == "control":
                ok = failure is None
            else:
                ok = failure is not None or check not in must
            print(json.dumps({"mutant": name, "check": check, "must_fail": check in must,
                              "failed": failure is not None, "ok": ok, "reading": reading,
                              "failure": failure}), flush=True)
            if not ok:
                missed.append(f"{name} {check}")
    shutil.rmtree(WORK, ignore_errors=True)
    if missed:
        print(f"fp8_mutants: FAIL: {missed}", file=sys.stderr)
        sys.exit(1)
    print("fp8_mutants: the control passes and every listed check fails its mutant")


if __name__ == "__main__":
    main()
