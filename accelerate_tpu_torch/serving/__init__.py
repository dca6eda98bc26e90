"""Serving: continuous batching over a paged KV cache.

Port of the core of ``accelerate_tpu/serving/``: a fixed slot batch
refilled at every decode step, a block-table paged KV cache, and
:class:`ServingEngine` (``add_request`` / ``step`` / ``stream``), whose
decode step is one CUDA graph on the card. The modules of the reference's
other planes (speculation, transfer, SLO) are not ported yet (ROADMAP.md,
queue A9).
"""

from ..ops.attention import PagedKVCache, PagedKVState, paged_attention, paged_update
from .block_pool import BlockPool
from .engine import ServingEngine, TokenEvent
from .sampling import SlotSampling, sample_tokens
from .scheduler import ContinuousScheduler, Request, Slot
from .spans import RequestSpan, SpanLog, spans_to_chrome_trace, write_chrome_trace
from .telemetry import ServeStats, percentile

__all__ = [
    "BlockPool",
    "ContinuousScheduler",
    "PagedKVCache",
    "PagedKVState",
    "Request",
    "RequestSpan",
    "ServeStats",
    "ServingEngine",
    "Slot",
    "SlotSampling",
    "SpanLog",
    "TokenEvent",
    "paged_attention",
    "paged_update",
    "percentile",
    "sample_tokens",
    "spans_to_chrome_trace",
    "write_chrome_trace",
]
