#!/usr/bin/env python3
"""Plant faults in the port's async checkpoint path and check which of
chip_smoke.py's phase 14 checks reject each one.

    python3 tools/ckpt_mutants.py

Needs one CUDA device. For each mutant it copies the port and
chip_smoke.py into ``accelerate_tpu_torch/ops/build/ckpt_mutants/<name>/``
(the gitignored build directory) and applies its text edits to the copy;
the control copy has none. No edit touches a CUDA source, so the flash
library is built once, in the control copy, and copied into the others.
Then each copy runs phase 14's two arms and their hard checks
(``chip_smoke.ckpt_checks``) in a process of its own: (a) the step-12
async save against a clone taken right after its submit, while steps 13-16
update the same tensors in place; (a2) the same for a save made with no
synchronise after its step; (b) the committed set; (c) the newest
checkpoint against the live carry, and across the arms; (d) resume and
step 17; (e) SIGTERM with a save in flight. The mutants:

* ``no_event_wait``: the writer thread reads the pinned buffers without
  waiting on the event recorded after the copies into them;
* ``aliases``: the snapshot keeps the live CUDA tensors instead of copies
  (the writer then reads them when it writes, on its own thread);
* ``host_state_on_writer``: the host state (RNG, step, iteration, loader
  cursor) is captured on the writer thread, when it writes, not at submit.

The control must pass every check, and each mutant must fail at least one
of (a), (a2) and (d). Prints one JSON line per copy with the checks that
failed and the lines that read them, and exits 1 when a mutant passed them
all or the control failed one. The copies are removed at the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from port_copies import BUILD, build_copies, library, make_copy

WORK = BUILD / "ckpt_mutants"
WRITER = "accelerate_tpu_torch/checkpoint_async/writer.py"
DIST = "accelerate_tpu_torch/dist_checkpoint.py"
MUST = {"a", "a2", "d_sync", "d_async"}  # at least one of these fails each mutant

MUTANTS = {
    "control": [],
    "no_event_wait": [
        (WRITER, "            job.buffers.wait()  # the copies into the pinned set have landed",
         "            pass  # planted: no wait on the copies' event"),
    ],
    "aliases": [
        (DIST, "            t = buffers.copy_in(prefix + key, leaf)",
         "            t = leaf.detach()  # planted: the live tensor, not a copy"),
    ],
    "host_state_on_writer": [
        (WRITER, "        host_files = _capture_host_state(accelerator, carry)\n",
         "        host_files = (accelerator, carry)  # planted: captured when written\n"),
        (WRITER, "        _write_host_state(job.host_files, job.work_dir)\n",
         "        from ..checkpointing import _capture_host_state\n"
         "        _write_host_state(_capture_host_state(*job.host_files), job.work_dir)\n"),
    ],
}

# runs in a copy: the arms and their checks, a failure raised instead of exiting
RUNNER = """
import json, torch
import chip_smoke as cs
import accelerate_tpu_torch as port
from accelerate_tpu_torch.ops import flash_attention as fa, fused

class Failed(Exception):
    pass

def fail(msg):
    raise Failed(msg)

cs.fail = fail
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rep = cs.Report(cs.card())
try:
    cs.ckpt_checks(torch, port, (*fa.KERNEL_WRAPPERS, *fused.KERNEL_WRAPPERS), rep)
    failure = None
except Failed as e:
    failure = str(e)
print("RESULT " + json.dumps({"failure": failure}), flush=True)
"""


def main() -> None:
    roots = {name: make_copy(WORK / name, edits) for name, edits in MUTANTS.items()}
    build_copies({"control": roots["control"]}, ["flash_attention"])
    lib = library(roots["control"], "flash_attention")
    for name, root in roots.items():
        if name != "control":
            target = root / "accelerate_tpu_torch" / "ops" / "build"
            target.mkdir(parents=True, exist_ok=True)
            shutil.copy2(lib, target / lib.name)
    missed = []
    for name in MUTANTS:
        proc = subprocess.run([sys.executable, "-c", RUNNER], cwd=roots[name],
                              capture_output=True, text=True, timeout=900)
        lines = proc.stdout.splitlines()
        result = next((json.loads(line[len("RESULT "):]) for line in lines
                       if line.startswith("RESULT ")), None)
        checks = next((json.loads(line[line.index("{"):]) for line in lines
                       if "] ckpt checks {" in line), None)
        if result is None or checks is None:
            # a mutant that crashes the arms before their checks: report its error
            print(json.dumps({"copy": name, "ran": False, "error": proc.stderr[-1500:]}),
                  flush=True)
            if name == "control":
                missed.append("control did not run")
            continue
        failed = sorted(k for k, ok in checks.items() if not ok)
        readings = [line[line.index("]") + 2:][:400] for line in lines
                    if any(f"ckpt{tag}" in line for tag in (" (a)", " (a2)", " async (d)",
                                                            " sync (d)"))]
        ok = not failed if name == "control" else bool(set(failed) & MUST)
        print(json.dumps({"copy": name, "ran": True, "failed": failed, "ok": ok,
                          "failure": result["failure"], "readings": readings}), flush=True)
        if not ok:
            missed.append(name)
    shutil.rmtree(WORK, ignore_errors=True)
    if missed:
        print(f"ckpt_mutants: FAIL: {missed}", file=sys.stderr)
        sys.exit(1)
    print("ckpt_mutants: the control passes and every mutant fails (a), (a2) or (d)")


if __name__ == "__main__":
    main()
