"""Serving: continuous batching over a paged KV cache.

Port of ``accelerate_tpu/serving/``: a fixed slot batch refilled at every
decode step, a block-table paged KV cache with prefix caching and
copy-on-write, speculative decoding (n-gram and draft model), the SLO
tracker, request spans, and :class:`ServingEngine` (``add_request`` /
``step`` / ``stream``), whose decode and verify steps are CUDA graphs on
the card. The reference's transfer plane, preemption, chunked prefill,
adapters and HTTP plane are not ported yet (ROADMAP.md, queue A9).
"""

from ..ops.attention import PagedKVCache, PagedKVState, paged_attention, paged_update
from .block_pool import BlockPool, PrefixCache, prefix_keys
from .engine import ServingEngine, TokenEvent
from .sampling import SlotSampling, sample_tokens
from .scheduler import ContinuousScheduler, Request, Slot
from .slo import SLOConfig, SloTracker
from .spans import RequestSpan, SpanLog, spans_to_chrome_trace, write_chrome_trace
from .speculation import DraftModelProposer, NGramProposer, SpecConfig
from .telemetry import ServeStats, percentile

__all__ = [
    "BlockPool",
    "ContinuousScheduler",
    "DraftModelProposer",
    "NGramProposer",
    "PagedKVCache",
    "PagedKVState",
    "PrefixCache",
    "Request",
    "RequestSpan",
    "SLOConfig",
    "ServeStats",
    "ServingEngine",
    "SloTracker",
    "Slot",
    "SlotSampling",
    "SpanLog",
    "SpecConfig",
    "TokenEvent",
    "paged_attention",
    "paged_update",
    "percentile",
    "prefix_keys",
    "sample_tokens",
    "spans_to_chrome_trace",
    "write_chrome_trace",
]
