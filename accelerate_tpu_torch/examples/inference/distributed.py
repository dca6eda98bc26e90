"""Distributed batch inference through ``split_between_processes``, the
PyTorch port of ``examples/inference/distributed.py``.

A prompt list is split evenly across processes: each process generates its
share with its own copy of the model, and the results are gathered back to
every process. The embarrassingly parallel inference idiom: no sharding,
only the ``PartialState`` splitter and ``gather_object``.

A tiny ``CausalLM`` with random weights from a seed generates token ids
from synthetic prompts (no network). On one process the split is the
identity, so the script runs anywhere:

    python accelerate_tpu_torch/examples/inference/distributed.py [--new_tokens 8] [--cpu]

and on several processes through ``debug_launcher`` (CPU processes over
gloo): ``debug_launcher(distributed.main, (["--cpu"],), num_processes=2)``.
"""

import argparse
import os
import sys

import numpy as np
import torch

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))

from accelerate_tpu_torch import PartialState  # noqa: E402
from accelerate_tpu_torch.models import CausalLM, TransformerConfig  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.utils.operations import gather_object  # noqa: E402
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402

PROMPT_LEN = 16


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--new_tokens", type=int, default=8)
    parser.add_argument("--num_prompts", type=int, default=6)
    parser.add_argument("--cpu", action="store_true", help="Generate on the CPU")
    args = parser.parse_args(argv)

    # PartialState: the process's identity without any training machinery,
    # all that batch inference needs
    state = PartialState(cpu=args.cpu)
    set_seed(42)

    cfg = TransformerConfig.tiny(max_seq_len=64)
    model = CausalLM(cfg, device=state.device,
                     generator=torch.Generator(state.device).manual_seed(0))

    # every process sees the same prompt list...
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN).tolist()
               for _ in range(args.num_prompts)]

    # ...and generates only its own share (padding keeps the shares' sizes
    # equal)
    with state.split_between_processes(prompts, apply_padding=True) as shard:
        ids = torch.as_tensor(np.asarray(shard, np.int64), device=state.device)
        out = generate(model, ids, max_new_tokens=args.new_tokens)
        completions = out[:, PROMPT_LEN:].tolist()

    # gather every process's completions; drop each share's padding (rank r
    # owns base + 1 prompts when r < extra)
    base, extra = divmod(args.num_prompts, state.num_processes)
    chunks = gather_object(completions)
    gathered = [c for rank, chunk in enumerate(chunks)
                for c in chunk[: base + (1 if rank < extra else 0)]]
    state.print(f"{len(gathered)} completions from {state.num_processes} process(es)")
    for i, completion in enumerate(gathered):
        state.print(f"prompt {i}: {completion}")
    assert len(gathered) == args.num_prompts
    return gathered


if __name__ == "__main__":
    main()
