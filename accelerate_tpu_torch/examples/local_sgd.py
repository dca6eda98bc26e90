"""Feature example: Local SGD, the PyTorch port of
``examples/by_feature/local_sgd.py``.

Every process trains its own replica of a linear regression on its own
shard of the data, with no gradient exchange between syncs (inside
``LocalSGD`` the accelerator's step keeps each process's gradients its
own), and every ``--local_sgd_steps`` steps the replicas' parameters and
optimizer state are replaced by their mean over the processes. The
reference's single-host form stacks the replicas on a device-sharded axis;
here each replica is a process, launched by ``notebook_launcher`` (CPU
processes over gloo, so ``--cpu`` is required for more than one).

    python accelerate_tpu_torch/examples/local_sgd.py --cpu --num_processes 2

The main process prints the largest spread between replicas seen before an
average and the final weights' error against the generating ones.
"""

import argparse
import os
import sys

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu_torch import Accelerator, sgd  # noqa: E402
from accelerate_tpu_torch.launchers import notebook_launcher  # noqa: E402
from accelerate_tpu_torch.local_sgd import LocalSGD  # noqa: E402
from accelerate_tpu_torch.utils.operations import gather_object  # noqa: E402
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402

TRUE_W = np.asarray([2.0, -1.0, 0.5, 3.0], np.float32)


def training_function(config, args):
    accelerator = Accelerator(cpu=args.cpu, mixed_precision=args.mixed_precision)
    set_seed(config["seed"])
    rank, n_replicas = accelerator.process_index, accelerator.num_processes
    accelerator.print(f"{n_replicas} independent replicas, one a process")

    # every replica sees a DIFFERENT data shard: real divergence between syncs
    rng = np.random.default_rng(config["seed"] + rank)
    xs = rng.normal(size=(512, 4)).astype(np.float32)
    ys = xs @ TRUE_W + 0.05 * rng.normal(size=(512,)).astype(np.float32)

    params = accelerator.prepare({"w": torch.zeros(4), "b": torch.zeros(())})
    opt = accelerator.prepare(sgd(config["lr"]))
    carry = accelerator.init_carry(params, opt)
    step = accelerator.unified_step(
        lambda p, batch: ((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2).mean())

    bs, max_spread = config["batch_size"], 0.0
    # New code: the loop runs inside LocalSGD, which averages every K steps
    with LocalSGD(accelerator, local_sgd_steps=args.local_sgd_steps) as local_sgd:
        for i in range(config["num_steps"]):
            lo = (i * bs) % 512
            batch = {"x": torch.from_numpy(xs[lo:lo + bs]), "y": torch.from_numpy(ys[lo:lo + bs])}
            carry, _ = step(carry, batch)
            if (i + 1) % args.local_sgd_steps == 0:
                ws = np.stack(gather_object(carry["params"]["w"].detach().numpy().copy()))
                before = float(np.abs(ws - ws.mean(0)).max())
                max_spread = max(max_spread, before)
            carry = local_sgd.step(carry)
            if (i + 1) % args.local_sgd_steps == 0:
                ws = np.stack(gather_object(carry["params"]["w"].detach().numpy().copy()))
                accelerator.print(f"step {i + 1}: replica spread {before:.4f} -> "
                                  f"{float(np.abs(ws - ws.mean(0)).max()):.6f} after averaging")
    err = float(np.abs(carry["params"]["w"].detach().numpy() - TRUE_W).max())
    result = {"weight_error": err, "max_spread": max_spread}
    accelerator.print(f"|w - w*|_inf after local SGD: {result}")
    return result


def main():
    parser = argparse.ArgumentParser(description="Local SGD example.")
    parser.add_argument("--mixed_precision", type=str, default=None,
                        choices=["no", "fp16", "bf16", "fp8"])
    parser.add_argument("--cpu", action="store_true", help="Train on the CPU.")
    parser.add_argument("--num_processes", type=int, default=2,
                        help="Replicas, one a process (CPU processes over gloo).")
    parser.add_argument("--local_sgd_steps", type=int, default=8,
                        help="Average the replicas every this many steps.")
    args = parser.parse_args()
    config = {"lr": 0.05, "num_steps": 48, "seed": 42, "batch_size": 32}
    notebook_launcher(training_function, (config, args), num_processes=args.num_processes,
                      cpu=args.cpu)


if __name__ == "__main__":
    main()
