"""The in-package distributed assertion script.

Port of ``accelerate_tpu/test_utils/scripts/test_script.py`` (the process
execution check :37, the collectives :47, the loader's preparation :78, the
training check :95, ``split_between_processes`` :117, the RNG sync :124,
the object collectives :137, the dispatcher :166, the checkpoint round
trip :184, ``run_all_checks`` :291). Run it under the launcher
(``debug_launcher(run_all_checks, num_processes=N)``) or as a script on one
process (``python -m accelerate_tpu_torch.test_utils.scripts.test_script``,
on the CPU). The reference's ``pipeline_check`` (:214) waits for pipelines
(ROADMAP.md, queue A7) and raises naming it; ``run_all_checks`` leaves it
out.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

# run by path without a pip install: the package root goes on sys.path
_PKG_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
if _PKG_ROOT not in sys.path:
    sys.path.insert(0, _PKG_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu_torch import Accelerator, DataLoader, sgd  # noqa: E402
from accelerate_tpu_torch.test_utils.training import (  # noqa: E402
    RegressionDataset,
    regression_init,
    regression_loss,
)
from accelerate_tpu_torch.utils.operations import (  # noqa: E402
    broadcast,
    broadcast_object_list,
    gather,
    gather_object,
    pad_across_processes,
    reduce,
)


def process_execution_check(accelerator: Accelerator):
    """``main_process_first``, the barrier and ``on_main_process``."""
    order = []
    with accelerator.main_process_first():
        order.append(accelerator.process_index)
    accelerator.wait_for_everyone()
    printed = accelerator.on_main_process(lambda: "printed")()
    assert (printed == "printed") == accelerator.is_main_process
    accelerator.print("process execution check: main process prints")


def collective_check(accelerator: Accelerator):
    """gather, broadcast and reduce."""
    n = accelerator.num_processes
    x = torch.ones(2) * (accelerator.process_index + 1)
    g = gather(x)
    assert g.shape == (2 * n,), g.shape
    assert torch.equal(g, torch.arange(1.0, n + 1).repeat_interleave(2))
    assert float(reduce(torch.ones(()), "sum")) == n
    assert torch.equal(broadcast(torch.arange(4.0) * (accelerator.process_index + 1)),
                       torch.arange(4.0))
    accelerator.print("collective check passed")


def dl_preparation_check(accelerator: Accelerator):
    """Every sample appears exactly once across the processes."""
    ds = RegressionDataset(length=64)
    dl = accelerator.prepare_data_loader(DataLoader(ds, batch_size=8, shuffle=False))
    local = []
    for batch in dl:
        local.extend(batch["x"].tolist())
    everyone = [x for part in gather_object(local) for x in part]
    assert len(everyone) == 64 and sorted(everyone) == sorted(ds.x.tolist()), len(everyone)
    accelerator.print("dataloader preparation check passed")


def training_check(accelerator: Accelerator):
    """Regression reaches the generating parameters, and every process ends
    on the same parameters."""
    ds = RegressionDataset(length=96, seed=1)
    dl = accelerator.prepare_data_loader(DataLoader(ds, batch_size=16))
    opt = accelerator.prepare(sgd(0.1))
    params = accelerator.prepare(regression_init())
    carry = accelerator.init_carry(params, opt)
    step = accelerator.unified_step(regression_loss)
    for _ in range(20):
        for batch in dl:
            carry, _ = step(carry, batch)
    a, b = float(carry["params"]["a"].detach()), float(carry["params"]["b"].detach())
    assert abs(a - 2.0) < 0.2, f"a={a}"
    assert abs(b - 3.0) < 0.2, f"b={b}"
    assert len(set(gather_object((a, b)))) == 1
    accelerator.print(f"training check passed (a={a:.3f}, b={b:.3f})")


def split_between_processes_check(accelerator: Accelerator):
    items = list(range(10))
    with accelerator.split_between_processes(items) as mine:
        assert len(mine) >= 10 // max(accelerator.num_processes, 1)
    assert sorted(i for part in gather_object(mine) for i in part) == items
    accelerator.print("split_between_processes check passed")


def rng_sync_check(accelerator: Accelerator):
    """After set_seed every process draws the same numbers."""
    from accelerate_tpu_torch.utils.random import set_seed

    gen = set_seed(42)
    draws = gather_object(float(torch.randn((), generator=gen)))
    assert all(d == draws[0] for d in draws), draws
    accelerator.print("rng sync check passed")


def object_ops_check(accelerator: Accelerator):
    """gather_object, broadcast_object_list, pad_across_processes."""
    idx, world = accelerator.process_index, accelerator.num_processes
    objs = gather_object({"rank": idx, "tag": f"p{idx}"})
    assert [o["rank"] for o in objs] == list(range(world))
    payload = ["from-rank-0", {"n": 7}] if accelerator.is_main_process else [None, None]
    payload = broadcast_object_list(payload)
    assert payload[0] == "from-rank-0" and payload[1] == {"n": 7}
    x = torch.ones(idx + 2, 3) * (idx + 1)
    padded = pad_across_processes(x, dim=0)
    assert padded.shape[0] == world + 1, padded.shape
    assert bool((padded[: idx + 2] == idx + 1).all()) and bool((padded[idx + 2:] == 0).all())
    accelerator.print("object ops check passed")


def dispatcher_check(accelerator: Accelerator):
    """Process 0 reads, every process receives its rows."""
    ds = RegressionDataset(length=32)
    dl = accelerator.prepare_data_loader(DataLoader(ds, batch_size=8, shuffle=False),
                                         dispatch_batches=True)
    local = []
    for batch in dl:
        local.extend(batch["x"].tolist())
    everyone = [x for part in gather_object(local) for x in part]
    assert sorted(everyone) == sorted(ds.x.tolist()), len(everyone)
    accelerator.print("dispatcher check passed")


def checkpoint_check(accelerator: Accelerator):
    """A save by every process and a load back, bit for bit."""
    where = [tempfile.mkdtemp() if accelerator.is_main_process else None]
    where = broadcast_object_list(where)[0]
    try:
        params = accelerator.prepare({"w": torch.arange(32.0).reshape(8, 4), "b": torch.zeros(4)})
        opt = accelerator.prepare(sgd(0.1))
        carry = accelerator.init_carry(params, opt)
        step = accelerator.unified_step(lambda p, b: ((p["w"] @ p["b"] + b["x"]) ** 2).mean())
        carry, _ = step(carry, {"x": torch.ones(1)})
        out = accelerator.save_state(os.path.join(where, "ckpt"), carry=carry)
        zero = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}
        restored = accelerator.load_state(out, carry=accelerator.init_carry(
            zero, accelerator.prepare(sgd(0.1))))
        for k in ("w", "b"):
            assert torch.equal(restored["params"][k], carry["params"][k]), k
        accelerator.wait_for_everyone()
    finally:
        if accelerator.is_main_process:
            shutil.rmtree(where, ignore_errors=True)
    accelerator.print("checkpoint check passed")


def pipeline_check(accelerator: Accelerator):
    """1F1B pipeline training across the process group waits for
    pipelines."""
    raise NotImplementedError("pipeline training across processes is not ported yet: "
                              "ROADMAP.md, queue A7")


def run_all_checks():
    """Every ported check in one process group, importable so
    ``debug_launcher`` can spawn it at any world size."""
    main()


def main():
    accelerator = Accelerator(cpu=True)
    accelerator.print(f"state: {accelerator.state!r}")
    process_execution_check(accelerator)
    collective_check(accelerator)
    rng_sync_check(accelerator)
    object_ops_check(accelerator)
    dl_preparation_check(accelerator)
    dispatcher_check(accelerator)
    split_between_processes_check(accelerator)
    checkpoint_check(accelerator)
    training_check(accelerator)
    accelerator.print("All checks passed!")


if __name__ == "__main__":
    main()
