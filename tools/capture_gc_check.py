"""Why ``utils/cuda_graph.StepProgram`` turns Python's garbage collector off
while it captures: on a CUDA device, build serving engines one after
another and drop each (an engine holds its decode program, whose function
holds the engine: a reference cycle, so only the collector frees it and
its CUDA graph). Each capture after the first runs one collection inside
itself, as an automatic collection that falls there would. Prints how many
engines decoded; a graph destroyed inside a capture invalidates it
("operation not permitted when stream is capturing", then
cudaErrorStreamCaptureInvalidated), so fewer than 4 do.

    PYTHONPATH=. python3 tools/capture_gc_check.py
"""
import gc

from accelerate_tpu_torch.utils import cuda_graph

import accelerate_tpu_torch as port

build = cuda_graph.StepProgram.__init__


def collecting_build(self, fn, device):
    calls = []

    def step():
        calls.append(1)
        if len(calls) == 2:  # the capture (the first call is the warm-up)
            gc.collect()
        return fn()

    build(self, step, device)


def main() -> None:
    cuda_graph.StepProgram.__init__ = collecting_build
    model = port.CausalLM(port.TransformerConfig.tiny(max_seq_len=64), device="cuda")
    decoded = 0
    for _ in range(4):
        try:
            engine = port.ServingEngine(model, max_slots=2, block_size=8)
            rid = engine.add_request([1, 2, 3, 4], max_new_tokens=3)
            for _ in engine.stream():
                pass
            decoded += engine.result(rid) is not None
        except RuntimeError as e:
            print(f"capture failed: {str(e).splitlines()[0]}")
        engine = None  # dropped: its cycle waits for the collector
    print(f"{decoded} of 4 engines decoded with a collection inside each capture")


if __name__ == "__main__":
    main()
