"""Continuous (iteration-level) batching: admission and eviction on the host.

Port of ``accelerate_tpu/serving/scheduler.py`` (``Request`` :42, ``Slot``
:79, ``ContinuousScheduler`` :156) without the parts of paths not ported
yet (priorities and preemption, adapters, prefix caching, speculation's
lookahead, chunked prefill, drain; ROADMAP.md, queue A9).

A fixed array of decode slots is the device-side batch (the decode step is
built once for it); requests flow through it. At every step boundary the
engine retires finished slots, whose blocks return to the pool at once,
and :meth:`ContinuousScheduler.admit` refills them from the FIFO queue.
Admission reserves a request's whole worst-case footprint,
``ceil((prompt_len + max_new_tokens) / block_size)`` blocks, so an
admitted request never runs out of blocks in flight. The queue is bounded
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


class ContinuousScheduler:
    """Slot admission and eviction. ``now`` is injectable, so fake-clock
    tests drive the queueing-time accounting exactly."""

    def __init__(self, max_slots: int, pool: BlockPool,
                 now: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None,
                 max_queue_delay_s: Optional[float] = None):
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
        """Return a finished slot's blocks and empty the seat: the next
        :meth:`admit` can refill it."""
        if slot.blocks:
            self.pool.free(slot.blocks)
        slot.clear()

    def admit(self) -> list[Slot]:
        """Fill free slots from the queue head while the pool can fund each
        request's full reservation. Strict FIFO: a head that does not fit
        blocks the ones behind it (no starvation of big requests)."""
        admitted = []
        free_slots = (s for s in self.slots if not s.busy)
        while self.queue:
            slot = next(free_slots, None)
            if slot is None:
                self.blocked_reasons["no_free_slot"] += 1
                break
            req = self.queue[0]
            need = self.pool.blocks_for_tokens(len(req.prompt) + req.max_new_tokens)
            if not self.pool.can_allocate(need):
                self.blocked_reasons["pool_exhausted"] += 1
                break
            self.queue.popleft()
            slot.clear()
            slot.request = req
            slot.blocks = self.pool.allocate(need)
            slot.admit_time = self._now()
            admitted.append(slot)
        return admitted

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s.busy for s in self.slots)
