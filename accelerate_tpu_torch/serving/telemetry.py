"""Per-request serving metrics: percentile summaries over serve records.

Host-only copy of ``accelerate_tpu/serving/telemetry.py`` (``percentile``
:20, ``ServeStats`` :38). The rolling window holds the last ``window``
records for the p50/p95 keys; request and token totals and shed counts
accumulate for the engine's whole life. Each record is the engine's
``kind="serve"`` record, with the request's cached prefix tokens, its
draft counts (``spec_proposed``, ``spec_accepted``, ``accept_rate``), its
preemptions (``preempted_count``) and its prefill chunks; the
engine-wide prefix hit and speculation totals are sections of
``ServingEngine.summary()``.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile (numpy's default); None on empty
    input."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


PERCENTILE_FIELDS = ("ttft_s", "e2e_s", "queue_s", "decode_tokens_per_s")


class ServeStats:
    """Accumulates per-request serve records; :meth:`summary` folds them
    into the p50/p95 block."""

    def __init__(self, window: int = 1024):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self.requests: collections.deque = collections.deque(maxlen=window)
        self.total_requests = 0
        self.total_prompt_tokens = 0
        self.total_new_tokens = 0
        self.shed_counts: dict[str, int] = {}

    def __len__(self) -> int:
        return self.total_requests

    def add(self, record: dict) -> None:
        self.requests.append(dict(record))
        self.total_requests += 1
        self.total_prompt_tokens += int(record.get("prompt_tokens") or 0)
        self.total_new_tokens += int(record.get("new_tokens") or 0)

    def add_shed(self, reason: str) -> None:
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1

    def summary(self) -> dict:
        out: dict = {
            "requests": self.total_requests,
            "prompt_tokens": self.total_prompt_tokens,
            "new_tokens": self.total_new_tokens,
        }
        for field in PERCENTILE_FIELDS:
            vals = [r[field] for r in self.requests if r.get(field) is not None]
            out[f"{field}_p50"] = percentile(vals, 50)
            out[f"{field}_p95"] = percentile(vals, 95)
        out["shed_total"] = sum(self.shed_counts.values())
        for reason, count in sorted(self.shed_counts.items()):
            out[f"shed_{reason}"] = count
        return out
