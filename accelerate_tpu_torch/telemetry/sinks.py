"""Telemetry export sinks.

Port of ``accelerate_tpu/telemetry/sinks.py``: ``TelemetrySink`` (:305),
``JSONLSink`` (:315) and ``PrometheusTextSink`` (:391) for the record
kinds the serving engine emits. A sink receives every record (a flat,
JSON-able dict whose ``kind`` says what it is) and ships it somewhere;
the collector catches and rate-limits a sink's errors.

Serving record kinds (the schema is the reference's, :75-140):

* ``serve``: one completed request (``request_id``, ``prompt_tokens``,
  ``cached_prefix_tokens``, ``new_tokens``, ``queue_s``, ``ttft_s``,
  ``e2e_s``, ``decode_tokens_per_s``, ``spec_proposed``,
  ``spec_accepted``, ``accept_rate``);
* ``span``: one request reaching a terminal state, with its lifecycle
  stamps and phase durations (``serving/spans.py``);
* ``serve_gauge``: a sample of the live engine (queue, slots, pool,
  prefix cache, speculation, shed and blocked counters);
* ``shed``: one refused or expired request and its ``reason``;
* ``slo``: attainment and burn rates (``serving/slo.py``);
* ``memory``: device and host memory in use.

The Prometheus sink renders them as the reference does: latency fields
and ``accept_rate`` of ``serve`` records as summaries (rolling-window
quantiles with cumulative ``_count``/``_sum``), the draft tallies as
per-adapter counters, gauges for ``serve_gauge``, ``slo`` and ``memory``
fields, a counter per shed reason; span records are not gauges. The
training kinds (``step``, ``goodput``, ``audit``, ``soak``, ``preempt``)
and ``TrackerBridgeSink`` wait for the step records (ROADMAP.md, queue
A10); a sink ignores a kind it does not render.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Optional, Union

SCHEMA_VERSION = 1


class TelemetrySink:
    """Base class: implement ``emit``; ``close`` if you hold resources."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONLSink(TelemetrySink):
    """Append-only JSONL file, flushed every record so that a killed
    process keeps every record it emitted, and fsynced at close."""

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = os.fspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._file = open(self.path, "a", buffering=1)

    def emit(self, record: dict) -> None:
        self._file.write(json.dumps(record, default=str) + "\n")
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            try:
                os.fsync(self._file.fileno())
            except OSError:
                pass  # not every target supports fsync (pipes, some FUSE)
            self._file.close()


# fields that are not metrics: redundant with the scrape timestamp
_PROM_SKIP = ("time_unix", "schema")

# serve-record fields exported as summaries rather than last-value gauges:
# a per-request latency gauge means nothing once the next request lands
_SERVE_SUMMARY_FIELDS = {
    "ttft_s": "serve_ttft_seconds",
    "e2e_s": "serve_e2e_seconds",
    "queue_s": "serve_queue_seconds",
    "decode_tokens_per_s": "serve_decode_tokens_per_second",
    "accept_rate": "serve_spec_accept_rate",
}

# serve-record draft tallies exported as per-adapter counters
_SERVE_SPEC_COUNTER_FIELDS = {
    "spec_proposed": "serve_spec_proposed_total",
    "spec_accepted": "serve_spec_accepted_total",
}

_SERVE_QUANTILES = (0.5, 0.95, 0.99)


def _quantile(values: list, q: float) -> float:
    """Linear-interpolation quantile (q in [0, 1]) of a non-empty list."""
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def _numeric(value) -> bool:
    return not isinstance(value, bool) and isinstance(value, (int, float))


class PrometheusTextSink(TelemetrySink):
    """Metrics in the Prometheus text exposition format, written atomically
    to ``path`` on every record (point node_exporter's textfile collector
    at it). ``path=None`` keeps the sink in memory: :meth:`render` returns
    the current text and nothing touches the disk."""

    def __init__(self, path: Optional[Union[str, os.PathLike]] = None,
                 prefix: str = "accelerate_tpu", summary_window: int = 1024):
        self.path = os.fspath(path) if path is not None else None
        self.prefix = prefix
        if self.path:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self._gauges: dict[tuple[str, str], float] = {}  # (metric, label) -> value
        # (metric, label name, label value) -> monotonic count
        self._counters: dict[tuple[str, str, str], float] = {}
        # (metric, label) -> rolling window for the quantiles; _count and
        # _sum stay cumulative (Prometheus summary semantics)
        self._summary_window = int(summary_window)
        self._summaries: dict[tuple[str, str], deque] = {}
        self._summary_counts: dict[tuple[str, str], int] = {}
        self._summary_sums: dict[tuple[str, str], float] = {}

    def emit(self, record: dict) -> None:
        kind = record.get("kind")
        if kind == "serve":
            self._emit_serve(record)
        elif kind == "serve_gauge":
            self._emit_gauges(record, "serve")
        elif kind == "memory":
            self._emit_gauges(record, "memory")
        elif kind == "slo":
            # the breach flag is the one bool worth a gauge (a 0/1 alert line)
            self._emit_gauges({**record, "breach": 1.0 if record.get("breach") else 0.0}, "slo")
        elif kind == "shed":
            self._count("serve_shed_total", "reason", str(record.get("reason", "unknown")), 1.0)
            self._write()
        # span records are per-request traces for JSONL/Perfetto, not gauges

    def _count(self, name: str, lname: str, lvalue: str, n: float) -> None:
        key = (f"{self.prefix}_{name}", lname, lvalue)
        self._counters[key] = self._counters.get(key, 0.0) + n

    def _emit_gauges(self, record: dict, section: str) -> None:
        label = str(record.get("label", "serve"))
        for key, value in record.items():
            if _numeric(value) and key not in _PROM_SKIP:
                self._gauges[(f"{self.prefix}_{section}_{key}", label)] = float(value)
        self._write()

    def _emit_serve(self, record: dict) -> None:
        label = str(record.get("label", "serve"))
        # per-tenant request counter ("none" = the base model)
        adapter = str(record.get("adapter_id") or "none")
        self._count("serve_requests_total", "adapter", adapter, 1.0)
        for key, value in record.items():
            if not _numeric(value) or key in _PROM_SKIP:
                continue
            counter = _SERVE_SPEC_COUNTER_FIELDS.get(key)
            if counter is not None:
                if value:
                    self._count(counter, "adapter", adapter, float(value))
                continue
            name = _SERVE_SUMMARY_FIELDS.get(key)
            if name is None:
                self._gauges[(f"{self.prefix}_serve_{key}", label)] = float(value)
                continue
            slot = (f"{self.prefix}_{name}", label)
            window = self._summaries.setdefault(slot, deque(maxlen=self._summary_window))
            window.append(float(value))
            self._summary_counts[slot] = self._summary_counts.get(slot, 0) + 1
            self._summary_sums[slot] = self._summary_sums.get(slot, 0.0) + float(value)
        self._write()

    @staticmethod
    def _escape_label(value: str) -> str:
        # \, " and newline must be escaped inside quoted label values
        return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    def render(self) -> str:
        """The whole exposition text (what ``_write`` puts on disk)."""
        lines = []
        for metric in sorted({m for m, _ in self._gauges}):
            lines.append(f"# TYPE {metric} gauge")
            for (m, label), value in sorted(self._gauges.items()):
                if m == metric:
                    lines.append(f'{metric}{{label="{self._escape_label(label)}"}} {value}')
        for metric in sorted({m for m, _, _ in self._counters}):
            lines.append(f"# TYPE {metric} counter")
            for (m, lname, lvalue), value in sorted(self._counters.items()):
                if m == metric:
                    lines.append(f'{metric}{{{lname}="{self._escape_label(lvalue)}"}} {value}')
        for metric in sorted({m for m, _ in self._summaries}):
            lines.append(f"# TYPE {metric} summary")
            for (m, label), window in sorted(self._summaries.items()):
                if m != metric or not window:
                    continue
                escaped = self._escape_label(label)
                values = list(window)
                for q in _SERVE_QUANTILES:
                    lines.append(f'{metric}{{label="{escaped}",quantile="{q}"}} '
                                 f"{_quantile(values, q)}")
                lines.append(f'{metric}_count{{label="{escaped}"}} '
                             f"{self._summary_counts[(m, label)]}")
                lines.append(f'{metric}_sum{{label="{escaped}"}} '
                             f"{self._summary_sums[(m, label)]}")
        return "\n".join(lines) + "\n"

    def _write(self) -> None:
        if self.path is None:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.render())
        os.replace(tmp, self.path)  # scrapers never see a torn file

    def close(self) -> None:
        if self._gauges or self._counters or self._summaries:
            self._write()
