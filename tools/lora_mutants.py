#!/usr/bin/env python3
"""Plant faults in the port's adapter serving path and check which of
chip_smoke.py's phase 17 serving checks reject each one.

    python3 tools/lora_mutants.py

Needs one CUDA device. For each mutant it copies the port and
chip_smoke.py into ``accelerate_tpu_torch/ops/build/lora_mutants/<name>/``
(the gitignored build directory) and applies its text edits to the copy;
the control copy has none. The serving path runs no kernel of the port, so
nothing is built. Each copy runs phase 17's serving part and its checks
(``chip_smoke.lora_serving`` on the small config's bf16 model: (a) no
decode rebuild across adapter churn, (b) the mixed batch against
single-tenant engines, (c) a tenant loaded after the decode graph's capture
against one loaded before it, (d) a tiny fp32 engine with three tenants on
the card against the CPU) in a process of its own. The mutants are the two
ways a CUDA graph reads stale adapter data, which the CPU tests cannot see
(on the CPU the decode step runs eagerly and reads whatever is current):

* ``rebound_stacks``: the registry writes a load into new tensors and
  rebinds them (the reference's functional ``write_adapter_row``), so the
  captured graph keeps reading the stacks it was captured with;
* ``rebound_slot_ids``: the engine puts each step's slot ids into a new
  tensor instead of copying them into the static buffer the graph reads.

The control must pass every check and each mutant must fail at least one.
Prints one JSON line per copy and exits 1 when a mutant passed them all or
the control failed one. The copies are removed at the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from port_copies import BUILD, make_copy

WORK = BUILD / "lora_mutants"
REGISTRY = "accelerate_tpu_torch/adapters/registry.py"
ENGINE = "accelerate_tpu_torch/serving/engine.py"

MUTANTS = {
    "control": [],
    "rebound_stacks": [
        (REGISTRY, "        write_adapter_row(self._stacks, slot, adapter_params, r_max=self.max_rank)\n",
         "        self._stacks = {t: {k: v.clone() for k, v in p.items()}  # planted: new tensors\n"
         "                        for t, p in self._stacks.items()}\n"
         "        write_adapter_row(self._stacks, slot, adapter_params, r_max=self.max_rank)\n"),
    ],
    "rebound_slot_ids": [
        (ENGINE, '            buf["slot_ids"].copy_(torch.from_numpy(self._slot_adapter))\n',
         '            buf["slot_ids"] = torch.from_numpy(self._slot_adapter).to(self.device)'
         '  # planted\n'),
    ],
}

# runs in a copy: phase 17's serving part and its checks on a fresh model
RUNNER = """
import json, torch
import chip_smoke as cs
import accelerate_tpu_torch as port
from accelerate_tpu_torch import adapters

class Failed(Exception):
    pass

def fail(msg):
    raise Failed(msg)

cs.fail = fail
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rep = cs.Report(cs.card())
_, cfg, model, _ = cs.lora_setup(torch, port)
model.requires_grad_(False)
lcfg = adapters.LoraConfig(rank=cs.LORA["rank"], alpha=cs.LORA["alpha"],
                           target_modules=cs.LORA["targets"])
checks = {}
try:
    cs.lora_serving(torch, port, rep, model, cfg, lcfg, checks)
    failure = None
except Failed as e:
    failure = str(e)
print("RESULT " + json.dumps({"failure": failure, "checks": checks}), flush=True)
"""


def main() -> None:
    roots = {name: make_copy(WORK / name, edits) for name, edits in MUTANTS.items()}
    missed = []
    for name in MUTANTS:
        proc = subprocess.run([sys.executable, "-c", RUNNER], cwd=roots[name],
                              capture_output=True, text=True, timeout=900)
        result = next((json.loads(line[len("RESULT "):]) for line in proc.stdout.splitlines()
                       if line.startswith("RESULT ")), None)
        if result is None:
            print(json.dumps({"copy": name, "ran": False, "error": proc.stderr[-1500:]}),
                  flush=True)
            missed.append(name)
            continue
        failed = sorted(k for k, ok in result["checks"].items() if not ok)
        ok = not failed if name == "control" else bool(failed)
        readings = [line[line.index("]") + 2:][:600] for line in proc.stdout.splitlines()
                    if "lora check" in line]
        print(json.dumps({"copy": name, "failed": failed, "ok": ok,
                          "failure": result["failure"], "readings": readings}), flush=True)
        if not ok:
            missed.append(name)
    shutil.rmtree(WORK, ignore_errors=True)
    if missed:
        print(f"lora_mutants: FAIL: {missed}", file=sys.stderr)
        sys.exit(1)
    print("lora_mutants: the control passes and every mutant fails a check")


if __name__ == "__main__":
    main()
