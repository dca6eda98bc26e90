"""A step built once: one CUDA graph on the card, the eager call on the CPU.

The reference compiles its decode step once with ``jax.jit`` and counts the
traces (``accelerate_tpu/serving/engine.py:377-392``,
``models/generation.py:176``). The port's counterpart is a function of
static buffers captured as one CUDA graph and replayed every step: the
caller copies each step's inputs into the buffers the function reads, and
reads the output the capture allocated, which each replay overwrites.
A capture or a replay that fails raises; nothing goes back to eager on the
card. Several programs may read the same buffers and caches (a serving
engine's decode step, its verify step of each width and a draft model's
step share the block-table buffer and the KV pools): each keeps its own
graph and memory pool, and whatever one writes in place the next reads.

Python's garbage collector is off while a step is captured: an object that
holds a built step and is part of a reference cycle (an engine holds its
programs, whose functions hold the engine) is freed only by the collector,
and a collection that ran inside another step's capture would destroy that
step's graph there, which invalidates the capture.
"""

from __future__ import annotations

import gc
from typing import Callable

import torch


class StepProgram:
    """``fn()`` reads only tensors that stay where they are (static input
    buffers, caches written in place, parameters) and returns a tensor.
    On a CUDA ``device`` it runs once on a side stream (the lazy set-up of
    cuBLAS and the allocator must not be captured), so it must be harmless
    to run with the buffers as they are, then is captured; ``program()``
    replays it. On the CPU ``program()`` is ``fn()``."""

    def __init__(self, fn: Callable[[], torch.Tensor], device):
        self.fn = fn
        self.graph = None
        self.out = None
        device = torch.device(device)
        if device.type != "cuda":
            return
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn()
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        return self.out
