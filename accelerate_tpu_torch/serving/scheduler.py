"""Continuous (iteration-level) batching: admission and eviction on the host.

Port of ``accelerate_tpu/serving/scheduler.py`` (``Request`` :42, ``Slot``
:79, ``ContinuousScheduler`` :156) with prefix matching at admission and
speculation's lookahead reservation, without the parts of paths not ported
yet (priorities and preemption, adapters, chunked prefill, drain;
ROADMAP.md, queue A9).

A fixed array of decode slots is the device-side batch (the decode step is
built once for it); requests flow through it. At every step boundary the
engine retires finished slots, whose blocks return to the pool at once,
and :meth:`ContinuousScheduler.admit` refills them from the FIFO queue.
Admission reserves a request's whole worst-case footprint,
``ceil((prompt_len + max_new_tokens) / block_size)`` blocks, so an
admitted request never runs out of blocks in flight. With a prefix cache
attached, the longest cached chain of the head's prompt is acquired
(refcounted) instead of allocated, and the engine prefills only the tail;
with speculation on, ``lookahead_tokens`` more tokens' blocks are reserved
for the verify pass's writes past the cursor. The queue is bounded
when asked: ``max_queue`` tail-drops submissions (``shed_reason=
"queue_full"``) and ``max_queue_delay_s`` sheds heads that waited too long
(``"queue_deadline"``); ``blocked_reasons`` says why admission stalled.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from .block_pool import BlockPool

_request_counter = itertools.count()


@dataclass
class Request:
    """One generation request: ``prompt`` is a list of token ids; the
    timing fields are stamped by the scheduler's clock."""

    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    request_id: str = ""
    submit_time: float = 0.0
    # set when the scheduler refuses or evicts the request instead of
    # queueing it: "queue_full" | "queue_deadline"
    shed_reason: Optional[str] = None
    # prefix caching: the prompt's rolling content keys, computed once at
    # the first admission attempt and reused at publish
    prefix_keys: Optional[list] = None

    def __post_init__(self):
        if not self.request_id:
            self.request_id = f"req-{next(_request_counter)}"
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclass
class Slot:
    """One seat in the fixed decode batch and its request's state."""

    index: int
    request: Optional[Request] = None
    blocks: list[int] = field(default_factory=list)
    cache_len: int = 0          # tokens written into the paged cache
    generated: list[int] = field(default_factory=list)
    pending: int = 0            # last sampled token, fed to the next step
    done: bool = False
    admit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    # prefix caching: table positions pointing at shared (read-only)
    # blocks, which any write copies first
    shared: set[int] = field(default_factory=set)
    # prompt tokens whose KV is in the cache already: prefill skips them
    cached_tokens: int = 0
    # the block reserved at admission for a full-prompt hit's copy (the
    # tail keeps >= 1 token, so it rewrites the last shared block)
    cow_spare: Optional[int] = None
    # positions whose block was copied: private, but kept out of the index
    cow_indices: set[int] = field(default_factory=set)
    # speculation: extra tokens of reservation granted at admission (0: the
    # slot decodes plainly), and the request's draft accounting
    lookahead: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def busy(self) -> bool:
        return self.request is not None

    def clear(self) -> None:
        self.request = None
        self.blocks = []
        self.cache_len = 0
        self.generated = []
        self.pending = 0
        self.done = False
        self.admit_time = 0.0
        self.first_token_time = 0.0
        self.finish_time = 0.0
        self.shared = set()
        self.cached_tokens = 0
        self.cow_spare = None
        self.cow_indices = set()
        self.lookahead = 0
        self.spec_proposed = 0
        self.spec_accepted = 0


class ContinuousScheduler:
    """Slot admission and eviction. ``now`` is injectable, so fake-clock
    tests drive the queueing-time accounting exactly."""

    def __init__(self, max_slots: int, pool: BlockPool,
                 now: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None,
                 max_queue_delay_s: Optional[float] = None, prefix_cache=None,
                 max_table_blocks: Optional[int] = None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if max_queue_delay_s is not None and max_queue_delay_s <= 0:
            raise ValueError("max_queue_delay_s must be > 0 (or None)")
        self.slots = [Slot(i) for i in range(max_slots)]
        self.pool = pool
        self.queue: deque[Request] = deque()
        self._now = now
        self.max_queue = max_queue
        self.max_queue_delay_s = max_queue_delay_s
        # an optional block_pool.PrefixCache: admission points new tables at
        # cached chains instead of allocating them
        self.prefix_cache = prefix_cache
        # speculation's extra reservation per request (set by the engine),
        # clamped per request at the table's width and the pool's size
        self.lookahead_tokens = 0
        self.max_table_blocks = max_table_blocks
        self.shed_counts = {"queue_full": 0, "queue_deadline": 0}
        self.blocked_reasons = {"no_free_slot": 0, "pool_exhausted": 0}

    def submit(self, request: Request) -> str:
        need = self.pool.blocks_for_tokens(len(request.prompt) + request.max_new_tokens)
        if need > self.pool.num_blocks - 1:
            raise ValueError(
                f"request needs {need} blocks "
                f"({len(request.prompt)} prompt + {request.max_new_tokens} "
                f"new tokens) but the pool only has "
                f"{self.pool.num_blocks - 1} allocatable blocks total"
            )
        request.submit_time = self._now()
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # tail-drop: the newest request is refused, those waiting keep
            # their place
            request.shed_reason = "queue_full"
            self.shed_counts["queue_full"] += 1
            return request.request_id
        self.queue.append(request)
        return request.request_id

    def shed_expired(self) -> list[Request]:
        """Shed queue heads whose wait exceeds ``max_queue_delay_s``. The
        queue is FIFO, so the scan stops at the first fresh request. The
        engine calls this once a step, before admission."""
        if self.max_queue_delay_s is None:
            return []
        now = self._now()
        shed: list[Request] = []
        while self.queue:
            req = self.queue[0]
            if now - req.submit_time <= self.max_queue_delay_s:
                break
            self.queue.popleft()
            req.shed_reason = "queue_deadline"
            self.shed_counts["queue_deadline"] += 1
            shed.append(req)
        return shed

    def release(self, slot: Slot) -> None:
        """Return a finished slot's references and empty the seat: the next
        :meth:`admit` can refill it. A shared block only drops a reference,
        and a published block at refcount 0 retires into the pool's LRU."""
        if slot.blocks:
            self.pool.free(slot.blocks)
        if slot.cow_spare is not None:  # reserved but never written
            self.pool.free([slot.cow_spare])
        slot.clear()

    def admit(self) -> list[Slot]:
        """Fill free slots from the queue head while the pool can fund each
        request's full reservation. Strict FIFO: a head that does not fit
        blocks the ones behind it (no starvation of big requests).

        With a prefix cache, the head's longest cached chain is acquired
        and only the rest of the footprint is allocated. A hit covering the
        whole prompt still leaves its last token to the tail (the first
        sample needs that position's logits), so one more private block is
        reserved for the engine's copy of the last shared block. If the
        pool cannot fund the rest, the acquired chain is released."""
        admitted = []
        free_slots = (s for s in self.slots if not s.busy)
        while self.queue:
            slot = next(free_slots, None)
            if slot is None:
                self.blocked_reasons["no_free_slot"] += 1
                break
            req = self.queue[0]
            base_tokens = len(req.prompt) + req.max_new_tokens
            lookahead = 0
            if self.lookahead_tokens:
                # a request that fits without speculation must still be
                # seated with it: the grant shrinks at the hard ceilings
                cap = (self.pool.num_blocks - 1) * self.pool.block_size
                if self.max_table_blocks is not None:
                    cap = min(cap, self.max_table_blocks * self.pool.block_size)
                lookahead = max(0, min(self.lookahead_tokens, cap - base_tokens))
            shared: list[int] = []
            if self.prefix_cache is not None:
                if req.prefix_keys is None:
                    req.prefix_keys = self.prefix_cache.keys_for(req.prompt, None)
                shared = self.prefix_cache.match(req.prompt, keys=req.prefix_keys)
            hit_tokens = len(shared) * self.pool.block_size
            cached_tokens = min(hit_tokens, len(req.prompt) - 1)
            cow_reserve = 1 if hit_tokens > cached_tokens else 0
            need = self.pool.blocks_for_tokens(base_tokens + lookahead)
            if shared:
                # pin the chain before any allocation can evict it
                self.pool.acquire(shared)
            if not self.pool.can_allocate(need - len(shared) + cow_reserve):
                if shared:
                    self.pool.free(shared)
                self.blocked_reasons["pool_exhausted"] += 1
                break
            self.queue.popleft()
            slot.clear()
            slot.request = req
            slot.blocks = shared + self.pool.allocate(need - len(shared))
            slot.shared = set(range(len(shared)))
            slot.cached_tokens = cached_tokens
            slot.lookahead = lookahead
            if cow_reserve:
                slot.cow_spare = self.pool.allocate(1)[0]
            slot.admit_time = self._now()
            admitted.append(slot)
        return admitted

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s.busy for s in self.slots)
