"""Continuous (iteration-level) batching: admission and eviction on the host.

Port of ``accelerate_tpu/serving/scheduler.py`` (``Request`` :42, ``Slot``
:79, ``ContinuousScheduler`` :156) with prefix matching at admission,
speculation's lookahead reservation, priorities (``Request.priority``
:52-56, the ordered ``submit`` and ``shed_expired`` :228-301),
chunk-aware admission (:386-400) and the preemption victim
(``preempt_candidate`` :423-457) and drain mode (``draining``, the
``"draining"`` shed and ``harvest_queue`` :216-246, :303, :338) and the
adapter gate (``Request.adapter`` :57-60, ``adapter_ready`` :167-186,
:350-358): a request that names an adapter is seated only once the
adapter is resident, and a head that waits blocks the queue (strict FIFO).

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
for the verify pass's writes past the cursor. With ``chunked_reserve``
(chunked prefill with preemption) admission reserves the cached prefix and
one chunk instead, and the engine grows the table on demand, preempting
when it cannot. The queue is ordered by priority (higher first, FIFO
within a priority) and bounded
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
    # higher admits first (FIFO within a priority; 0 is the default tier);
    # with preemption a seated request of lower priority can be swapped out
    # to fund it
    priority: int = 0
    # the adapter the request decodes under (None: the base model); the
    # request is seated only once it is resident in the engine's registry
    adapter: Optional[str] = None
    submit_time: float = 0.0
    # set when the scheduler refuses or evicts the request instead of
    # queueing it: "queue_full" | "queue_deadline" | "draining"
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
    # chunked prefill: the chunks the prompt took (0: unchunked)
    chunks: int = 0
    # preemption: times the request was swapped out, and whether this
    # seating is a resume (a resumed slot is not preempted again)
    preempted_count: int = 0
    resumed: bool = False

    @property
    def busy(self) -> bool:
        return self.request is not None

    @property
    def mid_prefill(self) -> bool:
        """Chunked prefill still ingesting the prompt: the slot holds a seat
        but is not in the decode batch yet."""
        return self.request is not None and self.cache_len < len(self.request.prompt)

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
        self.chunks = 0
        self.preempted_count = 0
        self.resumed = False


class ContinuousScheduler:
    """Slot admission and eviction. ``now`` is injectable, so fake-clock
    tests drive the queueing-time accounting exactly."""

    def __init__(self, max_slots: int, pool: BlockPool,
                 now: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None,
                 max_queue_delay_s: Optional[float] = None,
                 adapter_ready: Optional[Callable[[Optional[str]], bool]] = None,
                 prefix_cache=None, max_table_blocks: Optional[int] = None):
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
        # the adapter gate: whether a request's adapter is resident (None:
        # no gate); a request seated before its adapter loads would decode
        # under the identity row
        self.adapter_ready = adapter_ready
        # an optional block_pool.PrefixCache: admission points new tables at
        # cached chains instead of allocating them
        self.prefix_cache = prefix_cache
        # speculation's extra reservation per request (set by the engine),
        # clamped per request at the table's width and the pool's size
        self.lookahead_tokens = 0
        self.max_table_blocks = max_table_blocks
        # chunked prefill (set by the engine): with chunked_reserve, which
        # the engine sets only with preemption on, admission funds one chunk
        # instead of the whole footprint
        self.chunk_tokens: Optional[int] = None
        self.chunked_reserve = False
        # sticky: once a nonzero priority was submitted the queue is no
        # longer in submit order and shed_expired scans all of it
        self._saw_priority = False
        # drain mode (ServingEngine.drain): admission stops, new submits are
        # shed with reason "draining", seated work finishes
        self.draining = False
        self.shed_counts = {"queue_full": 0, "queue_deadline": 0}
        self.blocked_reasons = {"no_free_slot": 0, "pool_exhausted": 0,
                                "adapter_not_resident": 0}

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
        if self.draining:
            # a refusal is a shed, so a caller without a router still sees
            # a definite outcome
            request.shed_reason = "draining"
            self.shed_counts["draining"] = self.shed_counts.get("draining", 0) + 1
            return request.request_id
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # tail-drop: the newest request is refused, those waiting keep
            # their place
            request.shed_reason = "queue_full"
            self.shed_counts["queue_full"] += 1
            return request.request_id
        if request.priority != 0:
            self._saw_priority = True
            # keep (priority desc, submit order asc): walk in from the tail
            # past lower priorities; priority 0 appends
            i = len(self.queue)
            while i > 0 and self.queue[i - 1].priority < request.priority:
                i -= 1
            self.queue.insert(i, request)
        else:
            self.queue.append(request)
        return request.request_id

    def shed_expired(self) -> list[Request]:
        """Shed queued requests whose wait exceeds ``max_queue_delay_s``. A
        FIFO queue stops at the first fresh head; once priorities have
        reordered it, the whole queue is scanned. The engine calls this once
        a step, before admission."""
        if self.max_queue_delay_s is None:
            return []
        now = self._now()
        shed: list[Request] = []
        if self._saw_priority:
            keep: deque[Request] = deque()
            for req in self.queue:
                if now - req.submit_time > self.max_queue_delay_s:
                    req.shed_reason = "queue_deadline"
                    self.shed_counts["queue_deadline"] += 1
                    shed.append(req)
                else:
                    keep.append(req)
            self.queue = keep
            return shed
        while self.queue:
            req = self.queue[0]
            if now - req.submit_time <= self.max_queue_delay_s:
                break
            self.queue.popleft()
            req.shed_reason = "queue_deadline"
            self.shed_counts["queue_deadline"] += 1
            shed.append(req)
        return shed

    def harvest_queue(self) -> list[Request]:
        """Pop and return every queued (unadmitted) request, for a drain or
        a kill whose caller routes them elsewhere: no shed is counted, since
        none is lost."""
        out = list(self.queue)
        self.queue.clear()
        return out

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
        if self.draining:
            return []  # seated work decodes on; the queue waits for a harvest
        admitted = []
        free_slots = (s for s in self.slots if not s.busy)
        while self.queue:
            slot = next(free_slots, None)
            if slot is None:
                self.blocked_reasons["no_free_slot"] += 1
                break
            req = self.queue[0]
            if self.adapter_ready is not None and not self.adapter_ready(req.adapter):
                # strict FIFO: the requests behind it wait too (loading the
                # adapter unblocks them)
                self.blocked_reasons["adapter_not_resident"] += 1
                break
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
                    req.prefix_keys = self.prefix_cache.keys_for(req.prompt, req.adapter)
                shared = self.prefix_cache.match(req.prompt, req.adapter, keys=req.prefix_keys)
            hit_tokens = len(shared) * self.pool.block_size
            cached_tokens = min(hit_tokens, len(req.prompt) - 1)
            cow_reserve = 1 if hit_tokens > cached_tokens else 0
            total_tokens = base_tokens + lookahead
            if self.chunked_reserve and self.chunk_tokens is not None:
                # the cached prefix and one chunk; the engine grows the
                # table a chunk at a time and preempts when it cannot
                reserve_tokens = min(total_tokens, cached_tokens + self.chunk_tokens)
            else:
                reserve_tokens = total_tokens
            need = self.pool.blocks_for_tokens(reserve_tokens)
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

    def preempt_candidate(self, max_priority: Optional[int] = None,
                          exclude=()) -> Optional[Slot]:
        """The slot preemption should swap out, or None: the lowest
        priority first, then the least progress (fewest KV tokens: the
        cheapest swap), then the highest index. Resumed slots are exempt, so
        a request is preempted at most once a seating. ``max_priority``
        caps the victims' priority; ``exclude`` skips slot indices (seats
        admitted this step)."""
        cands = [s for s in self.slots
                 if s.busy and not s.done and not s.resumed and s.index not in exclude]
        if max_priority is not None:
            cands = [s for s in cands if s.request.priority <= max_priority]
        if not cands:
            return None
        return min(cands, key=lambda s: (s.request.priority, s.cache_len, -s.index))

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s.busy for s in self.slots)
