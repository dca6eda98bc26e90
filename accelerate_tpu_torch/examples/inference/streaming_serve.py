"""Streaming serving with continuous batching over a paged KV cache, the
PyTorch port of ``examples/inference/streaming_serve.py``.

Requests of very different prompt lengths and token budgets go into a
:class:`~accelerate_tpu_torch.serving.ServingEngine`, which packs them into
a fixed batch of slots, refills a finished slot at every decode step, and
streams each token as it is produced, so no request waits out a longer
neighbour's budget. The whole workload runs on one decode step program
(on CUDA one captured graph) and one prefill per power-of-two bucket
(``engine.trace_counts()`` shows it).

A tiny ``CausalLM`` with random weights from a seed serves synthetic
token-id prompts (no network):

    python accelerate_tpu_torch/examples/inference/streaming_serve.py [--requests 6] [--cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))

from accelerate_tpu_torch.models import CausalLM, TransformerConfig  # noqa: E402
from accelerate_tpu_torch.serving import ServingEngine  # noqa: E402
from accelerate_tpu_torch.state import resolve_device  # noqa: E402
from accelerate_tpu_torch.telemetry import StepTelemetry, TelemetryConfig  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--requests", type=int, default=6)
    parser.add_argument("--max_slots", type=int, default=2)
    parser.add_argument("--block_size", type=int, default=8)
    parser.add_argument("--cpu", action="store_true", help="Serve on the CPU")
    args = parser.parse_args(argv)

    device = resolve_device(args.cpu)
    cfg = TransformerConfig.tiny(max_seq_len=64)
    model = CausalLM(cfg, device=device, generator=torch.Generator(device).manual_seed(0))

    # every completed request emits a kind="serve" telemetry record (TTFT,
    # queue time, decode tokens/s) through the normal sink stack
    telemetry = StepTelemetry(TelemetryConfig(enabled=True))
    engine = ServingEngine(model, max_slots=args.max_slots, block_size=args.block_size,
                           telemetry=telemetry)

    # a mixed-length trace: more requests than slots, uneven budgets; the
    # continuous scheduler seats each as a slot frees up
    rng = np.random.default_rng(0)
    req_ids = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, (3 + 5 * i % 23,)).tolist()
        rid = engine.add_request(prompt, max_new_tokens=3 + i % 5, temperature=0.7 * (i % 2))
        req_ids.append(rid)

    # stream(): tokens arrive a decode step at a time, interleaved across the
    # requests holding slots; this is the serving loop
    streamed: dict[str, list[int]] = {rid: [] for rid in req_ids}
    for event in engine.stream():
        streamed[event.request_id].append(event.token)
        tag = " <done>" if event.done else ""
        print(f"  {event.request_id}: token {event.token}{tag}")

    # every request completed, and the streamed tokens are exactly the
    # results the engine recorded
    for rid in req_ids:
        result = engine.result(rid)
        assert result is not None, f"{rid} never completed"
        assert streamed[rid] == result, "streamed tokens != stored result"

    summary = engine.summary()
    assert summary["requests"] == args.requests
    assert summary["pool"]["allocated"] == 0, "blocks leaked after drain"
    # one decode program, bucketed prefills
    assert summary["traces"]["decode"] == 1
    serve_records = [r for r in telemetry.records if r.get("kind") == "serve"]
    assert len(serve_records) == args.requests
    telemetry.close()

    print(f"served {summary['requests']} requests ({summary['new_tokens']} tokens): "
          f"ttft_p50={summary['ttft_s_p50']:.4f}s "
          f"decode_p50={summary['decode_tokens_per_s_p50']:.1f} tok/s, "
          f"traces={summary['traces']}")
    print("streaming serve example passed")


if __name__ == "__main__":
    main()
