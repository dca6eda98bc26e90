"""SLO tracking with multi-window burn-rate alerting for the serving path.

Host-only copy of ``accelerate_tpu/serving/slo.py`` (``SLOConfig`` :34,
``SloTracker`` :83). An SLO here is "fraction ``target`` of requests meet
the latency objective", one objective for TTFT (submit to first token)
and one for end-to-end latency. The error budget is ``1 - target``, the
burn rate is ``window_error_rate / error_budget`` (1.0 = consuming the
budget exactly as fast as the SLO allows), and a breach fires only when
both a fast window (quick detection) and a slow window (sustained, not a
blip) burn at or above the threshold, over enough requests.

:class:`SloTracker` is host arithmetic over an injectable clock. The
engine feeds it each finished request and emits its snapshot as
``kind="slo"`` records on a step cadence.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Optional

#: the two latency objectives tracked per request
OBJECTIVES = ("ttft", "e2e")


@dataclass
class SLOConfig:
    """Objectives + burn windows for :class:`SloTracker`.

    ``ttft_objective_s`` / ``e2e_objective_s``: a request "meets" the
    objective when its latency is <= the bound. ``target``: the fraction
    of requests that must meet it (0.99 → a 1% error budget).

    ``fast_window_s`` / ``slow_window_s``: the two burn windows. The
    fast window makes detection quick; requiring the slow window too
    makes it robust — a single slow request cannot breach on its own.

    ``burn_threshold``: breach when BOTH windows burn at or above this
    rate (1.0 = budget consumed exactly at the sustainable rate; SRE
    practice pages at much higher, e.g. 14.4 for a 1h/30d pair — pick
    per deployment).

    ``interval_steps``: engine steps between ``kind="slo"`` records
    (0 keeps the tracker summary-only).

    ``min_requests``: windows with fewer finished requests than this
    never breach — burn arithmetic over 2 requests is noise.
    """

    ttft_objective_s: float = 1.0
    e2e_objective_s: float = 30.0
    target: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    burn_threshold: float = 1.0
    interval_steps: int = 16
    min_requests: int = 5

    def __post_init__(self):
        if not (0.0 < self.target < 1.0):
            raise ValueError("target must be in (0, 1)")
        if self.ttft_objective_s <= 0 or self.e2e_objective_s <= 0:
            raise ValueError("latency objectives must be > 0")
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError("burn windows must be > 0")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast_window_s must be <= slow_window_s")
        if self.burn_threshold <= 0:
            raise ValueError("burn_threshold must be > 0")
        if self.interval_steps < 0:
            raise ValueError("interval_steps must be >= 0")
        if self.min_requests < 1:
            raise ValueError("min_requests must be >= 1")


class SloTracker:
    """Fold finished-request latencies into attainment + burn rates.

    ``observe(now, ttft_s, e2e_s)`` per finished request;
    ``snapshot(now)`` → the ``kind="slo"`` record payload. Events older
    than ``slow_window_s`` age out of the deque (bounded memory on a
    long-lived server); lifetime attainment rides separate counters.
    """

    def __init__(self, config: Optional[SLOConfig] = None):
        self.config = config or SLOConfig()
        # (t, ttft_met, e2e_met) for the slow window (superset of fast)
        self._events: collections.deque = collections.deque()
        # running miss counts over exactly the events in the deque — the
        # slow window's stats in O(1) at snapshot time (a 10k-request
        # soak snapshots on a step cadence; a full-deque scan per
        # snapshot made that O(n) twice per emit)
        self._window_errors = {obj: 0 for obj in OBJECTIVES}
        self.total_requests = 0
        self.met_total = {obj: 0 for obj in OBJECTIVES}
        self.breaches = 0  # snapshots that reported breach=True

    # ------------------------------------------------------------------ #
    def observe(
        self,
        now: float,
        ttft_s: Optional[float],
        e2e_s: Optional[float],
    ) -> None:
        """Fold one finished request. ``None`` latencies count as misses
        (a request that never produced a first token did not meet TTFT)."""
        cfg = self.config
        ttft_met = ttft_s is not None and ttft_s <= cfg.ttft_objective_s
        e2e_met = e2e_s is not None and e2e_s <= cfg.e2e_objective_s
        self._events.append((now, ttft_met, e2e_met))
        self._window_errors["ttft"] += int(not ttft_met)
        self._window_errors["e2e"] += int(not e2e_met)
        self.total_requests += 1
        self.met_total["ttft"] += int(ttft_met)
        self.met_total["e2e"] += int(e2e_met)
        self._prune(now)

    def _prune(self, now: float) -> None:
        cutoff = now - self.config.slow_window_s
        while self._events and self._events[0][0] < cutoff:
            _, ttft_met, e2e_met = self._events.popleft()
            self._window_errors["ttft"] -= int(not ttft_met)
            self._window_errors["e2e"] -= int(not e2e_met)

    def _window_stats(self, now: float, span_s: float) -> dict:
        """(requests, error-rate per objective) over the trailing span.

        Events arrive in nondecreasing time order (one monotonic clock),
        so the scan walks backwards from the newest event and stops at
        the first one older than the span — O(window), not O(deque).
        The pruned deque IS the slow window, whose stats come from the
        running counters instead (see :meth:`snapshot`)."""
        cutoff = now - span_s
        n = 0
        errors = {obj: 0 for obj in OBJECTIVES}
        for t, ttft_met, e2e_met in reversed(self._events):
            if t < cutoff:
                break
            n += 1
            errors["ttft"] += int(not ttft_met)
            errors["e2e"] += int(not e2e_met)
        return {
            "requests": n,
            "error_rate": {
                obj: (errors[obj] / n if n else 0.0) for obj in OBJECTIVES
            },
        }

    def _slow_window_stats(self) -> dict:
        """O(1) slow-window stats: after :meth:`_prune`, the deque holds
        exactly the slow window and the running counters its misses."""
        n = len(self._events)
        return {
            "requests": n,
            "error_rate": {
                obj: (self._window_errors[obj] / n if n else 0.0)
                for obj in OBJECTIVES
            },
        }

    # ------------------------------------------------------------------ #
    def snapshot(self, now: Optional[float] = None) -> dict:
        """The flat ``kind="slo"`` record payload: per-objective
        attainment (lifetime + slow window), fast/slow burn rates, and
        the multi-window breach verdict."""
        now = time.monotonic() if now is None else now
        self._prune(now)
        cfg = self.config
        budget = 1.0 - cfg.target
        fast = self._window_stats(now, cfg.fast_window_s)
        slow = self._slow_window_stats()
        out: dict = {
            "target": cfg.target,
            "ttft_objective_s": cfg.ttft_objective_s,
            "e2e_objective_s": cfg.e2e_objective_s,
            "requests_total": self.total_requests,
            "requests_fast_window": fast["requests"],
            "requests_slow_window": slow["requests"],
        }
        breached: list[str] = []
        max_burn = 0.0
        for obj in OBJECTIVES:
            attain = (
                self.met_total[obj] / self.total_requests
                if self.total_requests
                else None
            )
            win_attain = (
                1.0 - slow["error_rate"][obj] if slow["requests"] else None
            )
            burn_fast = fast["error_rate"][obj] / budget
            burn_slow = slow["error_rate"][obj] / budget
            out[f"{obj}_attainment"] = attain
            out[f"{obj}_attainment_window"] = win_attain
            out[f"{obj}_burn_fast"] = burn_fast
            out[f"{obj}_burn_slow"] = burn_slow
            max_burn = max(max_burn, burn_fast, burn_slow)
            # multi-window AND: fast for speed, slow for sustainment —
            # and enough requests that the rates mean something
            if (
                fast["requests"] >= cfg.min_requests
                and slow["requests"] >= cfg.min_requests
                and burn_fast >= cfg.burn_threshold
                and burn_slow >= cfg.burn_threshold
            ):
                breached.append(obj)
        out["max_burn_rate"] = max_burn
        out["breach"] = bool(breached)
        out["breached_objectives"] = breached
        if breached:
            self.breaches += 1
        return out
