"""Request-lifecycle spans: where each request's time went.

Host-only copy of ``accelerate_tpu/serving/spans.py`` (``RequestSpan``
:36, ``SpanLog`` :119, ``spans_to_chrome_trace`` :239,
``write_chrome_trace`` :297) for the edges the ported engine stamps:
submit -> admit -> prefill -> first token -> finish, or shed, with the
prompt tokens served from the prefix cache and the request's draft accept
rate. The span fields of the paths not ported yet (adapters, preemption,
chunked prefill; ROADMAP.md, queue A9) are left out. ``SpanLog.enabled =
False`` turns every hook into a no-op (the observability toggle's off
arm).

Ordering invariant: ``submit_t <= admit_t <= prefill_start_t <=
first_token_t <= finish_t`` for finished spans; shed spans stop at the edge
they reached.
"""

from __future__ import annotations

import collections
import json
from dataclasses import dataclass
from typing import Iterable, Optional

#: terminal span states; everything else ("queued", "running") is live
TERMINAL_STATES = ("finished", "shed")


@dataclass
class RequestSpan:
    """Lifecycle timestamps of one request, on the engine's clock."""

    request_id: str
    submit_t: float
    prompt_tokens: int = 0
    admit_t: Optional[float] = None
    prefill_start_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    state: str = "queued"  # queued | running | finished | shed
    shed_reason: Optional[str] = None  # "queue_full" | "queue_deadline"
    new_tokens: int = 0
    # prompt tokens whose KV came from the prefix cache (0: cold or off)
    cached_prefix_tokens: int = 0
    # accepted over proposed draft tokens (None: nothing was proposed)
    accept_rate: Optional[float] = None

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def to_record(self) -> dict:
        """The flat record, with the phase durations (None where the span
        never reached that edge)."""
        def gap(a, b):
            return b - a if a is not None and b is not None else None

        return {
            "request_id": self.request_id,
            "state": self.state,
            "shed_reason": self.shed_reason,
            "prompt_tokens": self.prompt_tokens,
            "cached_prefix_tokens": self.cached_prefix_tokens,
            "new_tokens": self.new_tokens,
            "accept_rate": self.accept_rate,
            "submit_t": self.submit_t,
            "admit_t": self.admit_t,
            "prefill_start_t": self.prefill_start_t,
            "first_token_t": self.first_token_t,
            "finish_t": self.finish_t,
            "queue_s": gap(self.submit_t, self.admit_t),
            "prefill_s": gap(self.prefill_start_t, self.first_token_t),
            "decode_s": gap(self.first_token_t, self.finish_t),
            "e2e_s": gap(self.submit_t, self.finish_t),
        }


class SpanLog:
    """Open spans by request id plus a bounded ring of closed ones."""

    def __init__(self, maxlen: int = 512):
        if maxlen < 1:
            raise ValueError("maxlen must be >= 1")
        self._open: dict[str, RequestSpan] = {}
        self.closed: collections.deque = collections.deque(maxlen=maxlen)
        self.enabled = True

    def on_submit(self, request_id: str, submit_t: float,
                  prompt_tokens: int = 0) -> Optional[RequestSpan]:
        if not self.enabled:
            return None
        span = RequestSpan(request_id=request_id, submit_t=submit_t,
                           prompt_tokens=prompt_tokens)
        self._open[request_id] = span
        return span

    def on_admit(self, request_id: str, t: float) -> Optional[RequestSpan]:
        span = self._open.get(request_id)
        if span is not None:
            span.admit_t = t
            span.state = "running"
        return span

    def on_prefill(self, request_id: str, t: float,
                   cached_prefix_tokens: int = 0) -> Optional[RequestSpan]:
        span = self._open.get(request_id)
        if span is not None:
            span.prefill_start_t = t
            span.cached_prefix_tokens = cached_prefix_tokens
        return span

    def on_first_token(self, request_id: str, t: float) -> Optional[RequestSpan]:
        span = self._open.get(request_id)
        if span is not None:
            span.first_token_t = t
        return span

    def on_finish(self, request_id: str, t: float, new_tokens: int,
                  accept_rate: Optional[float] = None) -> Optional[RequestSpan]:
        span = self._open.get(request_id)
        if span is not None:
            span.accept_rate = accept_rate
        return self._close(request_id, t, "finished", None, new_tokens)

    def on_shed(self, request_id: str, t: float, reason: str) -> Optional[RequestSpan]:
        return self._close(request_id, t, "shed", reason, 0)

    def _close(self, request_id: str, t: float, state: str, shed_reason: Optional[str],
               new_tokens: int) -> Optional[RequestSpan]:
        span = self._open.pop(request_id, None)
        if span is None:
            return None
        span.finish_t = t
        span.state = state
        span.shed_reason = shed_reason
        span.new_tokens = new_tokens
        self.closed.append(span)
        return span

    @property
    def open_spans(self) -> list[RequestSpan]:
        return list(self._open.values())

    def summary(self) -> dict:
        closed = list(self.closed)
        return {
            "spans_open": len(self._open),
            "spans_closed": len(closed),
            "spans_shed": sum(1 for s in closed if s.state == "shed"),
        }


def spans_to_chrome_trace(spans: Iterable[RequestSpan], process_index: int = 0,
                          time_origin: Optional[float] = None) -> dict:
    """Chrome-trace JSON (Perfetto, ``chrome://tracing``): one row per
    request, complete (``ph="X"``) slices for its queue, prefill and decode
    phases; a shed request is one ``shed:<reason>`` slice over its life.
    Microseconds from ``time_origin`` (default: the earliest submit)."""
    spans = list(spans)
    if time_origin is None:
        time_origin = min((s.submit_t for s in spans), default=0.0)

    def us(t: float) -> float:
        return (t - time_origin) * 1e6

    events: list[dict] = []
    for tid, span in enumerate(spans):
        events.append({"ph": "M", "name": "thread_name", "pid": process_index, "tid": tid,
                       "args": {"name": span.request_id}})
        args = {"request_id": span.request_id, "prompt_tokens": span.prompt_tokens,
                "new_tokens": span.new_tokens, "state": span.state}
        if span.state == "shed":
            end = span.finish_t if span.finish_t is not None else span.submit_t
            events.append({"ph": "X", "name": f"shed:{span.shed_reason}", "cat": "serve",
                           "pid": process_index, "tid": tid, "ts": us(span.submit_t),
                           "dur": us(end) - us(span.submit_t),
                           "args": {**args, "shed_reason": span.shed_reason}})
            continue
        phases = []
        if span.admit_t is not None:
            phases.append(("queue", span.submit_t, span.admit_t))
        if span.prefill_start_t is not None and span.first_token_t is not None:
            phases.append(("prefill", span.prefill_start_t, span.first_token_t))
        if span.first_token_t is not None and span.finish_t is not None:
            phases.append(("decode", span.first_token_t, span.finish_t))
        if not phases:  # still queued: the wait so far as a slice
            phases.append(("queue", span.submit_t, span.submit_t))
        for name, start, end in phases:
            events.append({"ph": "X", "name": name, "cat": "serve", "pid": process_index,
                           "tid": tid, "ts": us(start), "dur": max(us(end) - us(start), 0.0),
                           "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[RequestSpan], process_index: int = 0) -> str:
    """:func:`spans_to_chrome_trace` written to ``path``; returns it."""
    payload = spans_to_chrome_trace(spans, process_index=process_index)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path
