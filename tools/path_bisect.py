#!/usr/bin/env python3
"""Split the difference between the main path's and the fused path's loss
curves among the kernels that the fused path swaps in.

    python3 tools/path_bisect.py [--seeds 0 1 2] [--repeats 2]

Needs one CUDA device. First holds the two backward designs against the
plain single-pass version at the main path's attention shape (bf16, causal,
B=2 S=2048 H=32 Hkv=8 D=128): dq, dk and dv of dq + dk/dv (B2 + B3) and of
the single pass (B4) against the plain version's, whose sums are fp32 and
rounded once. For each output: the share of elements equal to the plain
version's and chip_smoke.py's row error against it; and the share of
elements where the two designs agree.

Then trains chip_smoke.py's 4-layer llama3_8b-width model for its 5 steps,
from weights and tokens made from each seed, in configurations that each
change the main path (unfused model, adamw, dq + dk/dv backward) in one
part or in several:

    main         the main path
    b4           the single-pass backward (FUSED_BWD)
    b5           the fused prologue (fused_kernels=True)
    b6           the fused AdamW epilogue (fused_adamw)
    fused_no_b4  B5 and B6, two-pass backward
    fused        the fused path: B5, B6 and B4
    plain_bwd    dq, dk and dv from the plain single-pass version on the card
                 (fp32 sums, each gradient rounded once): no kernel in the
                 backward, so what it moves is rounding alone

each ``--repeats`` times. Prints one JSON line a run (losses, grad norms),
then one a configuration: by step, the largest relative loss difference
from the main path over seeds and repeats, and the largest between two
repeats of the configuration itself. Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import sys

from port_copies import REPO

CONFIGS = {  # name -> (fused_kernels, fused_adamw, backward)
    "main": (False, False, "two_pass"),
    "b4": (False, False, "single_pass"),
    "b5": (True, False, "two_pass"),
    "b6": (False, True, "two_pass"),
    "fused_no_b4": (True, True, "two_pass"),
    "fused": (True, True, "single_pass"),
    "plain_bwd": (False, False, "plain"),
}


def backward_vs_plain(torch, cs, fa) -> dict:
    B, S, H, Hkv, D = (cs.MAIN[k] for k in ("B", "S", "H", "Hkv", "D"))
    q, k, v, dout = cs.make_inputs(torch, B, S, H, Hkv, D, torch.bfloat16, seed=1)
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = fa.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, scale, True)
    plain = fa.flash_bwd_fused_reference(*args)
    two_pass = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    single_pass = fa.flash_bwd_fused(*args)
    torch.cuda.synchronize()
    reading = {}
    for design, grads in (("b2_b3", two_pass), ("b4", single_pass)):
        for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
            reading[f"{design}_{name}"] = {"equal_share": float((got == want).float().mean()),
                                           "row_err": cs.row_err(torch, got, want)}
    b3_b4 = {name: float((a == b).float().mean())
             for name, a, b in zip(("dq", "dk", "dv"), two_pass, single_pass)}
    reading["b2_b3_equal_b4_share"] = b3_b4
    return reading


def train(torch, cs, port, fa, config: str, seed: int) -> dict:
    fused_kernels, fused_optimizer, backward = CONFIGS[config]
    single_pass = fa.flash_bwd_fused
    fa.FUSED_BWD = backward != "two_pass"
    if backward == "plain":
        fa.flash_bwd_fused = fa.flash_bwd_fused_reference
    try:
        step, carry, loader, _ = cs.build_path(torch, port, fused_kernels, fused_optimizer, seed)
        carry, _, losses, norms, _ = cs.run_steps(torch, step, carry, loader)
    finally:
        fa.FUSED_BWD = False
        fa.flash_bwd_fused = single_pass
    del step, carry, loader
    gc.collect()
    return {"losses": losses, "grad_norms": norms}


def main() -> None:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("path_bisect: no CUDA device")
    sys.path.insert(0, str(REPO))
    import accelerate_tpu_torch as port
    import chip_smoke as cs
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["flash_attention", "fused"])
    print(json.dumps({"backward_vs_plain": backward_vs_plain(torch, cs, fa)}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}  # (config, seed) -> [losses of each repeat]
    for seed, repeat, config in itertools.product(args.seeds, range(args.repeats), CONFIGS):
        run = train(torch, cs, port, fa, config, seed)
        runs.setdefault((config, seed), []).append(run["losses"])
        print(json.dumps({"config": config, "seed": seed, "repeat": repeat, **run}), flush=True)

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    for config in CONFIGS:
        vs_main = [rel(c, m) for seed in args.seeds for c in runs[(config, seed)]
                   for m in runs[("main", seed)]]
        self_spread = [rel(a, b) for seed in args.seeds
                       for a, b in itertools.combinations(runs[(config, seed)], 2)]
        print(json.dumps({
            "config": config, "by_step_max_rel_vs_main": [max(s) for s in zip(*vs_main)],
            "by_step_max_rel_between_repeats": [max(s) for s in zip(*self_spread)]
            if self_spread else None,
        }), flush=True)
    print(cs.card())


if __name__ == "__main__":
    main()
