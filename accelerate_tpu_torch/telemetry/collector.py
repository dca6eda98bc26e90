"""The telemetry collector, for the serving records.

Port of ``accelerate_tpu/telemetry/collector.py:StepTelemetry`` (:47) for
the records the serving engine emits: ``add_sink``, the emit path (the
in-memory ring, then every sink, with a ``kind="meta"`` record first and
sink errors caught and rate-limited), ``record_serve`` (:398),
``record_span``, ``record_serve_gauge``, ``record_shed``,
``record_memory``, ``sample_memory`` (:512), ``record_slo``, ``summary``
and ``close``.

``sample_memory`` reads ``torch.cuda.memory_stats`` of the current CUDA
device where there is one, and the process's resident set size always; on
a machine without CUDA the device fields are 0, as the reference reports a
device that gives no numbers. The reference's owner-attributed buffer
census (``profiling/census.py``) is not ported.

The training-side hooks (``begin_step``, ``end_step``,
``record_checkpoint``, ``record_compile``, ``record_dataloader_wait``) and
what they feed (retrace detection, the heartbeat watchdog, diagnostics)
wait for the step records: they raise NotImplementedError naming
ROADMAP.md's queue A10.
"""

from __future__ import annotations

import collections
import resource
import threading
import time
from typing import Any, Optional, Union

import torch

from ..logging import get_logger
from .config import TelemetryConfig
from .sinks import SCHEMA_VERSION, JSONLSink, TelemetrySink

logger = get_logger(__name__)


def _training_hook(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"StepTelemetry.{name} records training steps, which are not ported yet "
        "(ROADMAP.md, queue A10)")


def _rank_and_world() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_memory_rss() -> int:
    """The process's resident set size in bytes (Linux)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


def device_memory_stats() -> dict:
    """Bytes in use, peak bytes in use and the capacity of the current CUDA
    device; zeros where there is no CUDA device."""
    if not torch.cuda.is_available():
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats()
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory),
    }


class StepTelemetry:
    """Serving telemetry: records go to the in-memory ring (``records``)
    and to every attached sink; a sink that raises is logged (three times
    at most) and never stops the caller. Every hook is a no-op while
    ``enabled`` is False."""

    def __init__(self, config: Optional[Union[TelemetryConfig, bool]] = None):
        if config is None or config is False:
            config = TelemetryConfig(enabled=False)
        elif config is True:
            config = TelemetryConfig()
        self.config = config
        self.enabled = config.enabled
        self.sinks: list[TelemetrySink] = []
        self.records: collections.deque = collections.deque(maxlen=config.history)
        self._meta_written = False
        self._sink_errors = 0
        self._last_memory_t: Optional[float] = None
        # records may come from several threads: serialize sink writes
        self._emit_lock = threading.Lock()
        if config.enabled and config.jsonl_path is not None:
            self.add_sink(JSONLSink(config.jsonl_path))

    # ------------------------------------------------------------------ #
    # sinks
    # ------------------------------------------------------------------ #
    def add_sink(self, sink: TelemetrySink) -> TelemetrySink:
        self.sinks.append(sink)
        return sink

    def _emit(self, record: dict) -> None:
        self.records.append(record)
        if self.sinks and _rank_and_world()[0] == 0:
            with self._emit_lock:
                if not self._meta_written:
                    self._meta_written = True
                    self._emit_raw(self._meta_record())
                self._emit_raw(record)

    def _emit_raw(self, record: dict) -> None:
        for sink in self.sinks:
            try:
                sink.emit(record)
            except Exception as exc:  # a sink never takes the engine down
                self._sink_errors += 1
                if self._sink_errors <= 3:
                    logger.warning(f"telemetry sink {type(sink).__name__} failed: {exc}")

    def _meta_record(self) -> dict:
        rank, world = _rank_and_world()
        return {
            "kind": "meta",
            "schema": SCHEMA_VERSION,
            "time_unix": time.time(),
            "backend": "cuda" if torch.cuda.is_available() else "cpu",
            "process_index": rank,
            "process_count": world,
            "local_device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        }

    # ------------------------------------------------------------------ #
    # serving records
    # ------------------------------------------------------------------ #
    def record_serve(self, *, request_id: str, prompt_tokens: int, new_tokens: int,
                     queue_s: Optional[float] = None, ttft_s: Optional[float] = None,
                     e2e_s: Optional[float] = None,
                     decode_tokens_per_s: Optional[float] = None, label: str = "serve",
                     **extra: Any) -> Optional[dict]:
        """Emit a ``kind="serve"`` record: one completed request (the engine
        calls this when it retires the slot). None while disabled."""
        if not self.enabled:
            return None
        record: dict[str, Any] = {
            "kind": "serve",
            "label": label,
            "time_unix": time.time(),
            "request_id": request_id,
            "prompt_tokens": int(prompt_tokens),
            "new_tokens": int(new_tokens),
            "queue_s": queue_s,
            "ttft_s": ttft_s,
            "e2e_s": e2e_s,
            "decode_tokens_per_s": decode_tokens_per_s,
        }
        for key, value in extra.items():
            record.setdefault(key, value)
        self._emit(record)
        return record

    def _record_event(self, kind: str, label: str, fields: dict) -> Optional[dict]:
        """The flat record every serving kind shares: ``kind``, ``label``,
        ``time_unix`` and the fields. None while disabled."""
        if not self.enabled:
            return None
        record: dict[str, Any] = {"kind": kind, "label": label, "time_unix": time.time()}
        for key, value in fields.items():
            record.setdefault(key, value)
        self._emit(record)
        return record

    def record_span(self, *, label: str = "serve", **fields) -> Optional[dict]:
        """Emit a ``kind="span"`` record: one request's lifecycle stamps and
        phase durations, at its terminal transition (finished or shed)."""
        return self._record_event("span", label, fields)

    def record_serve_gauge(self, *, label: str = "serve", **fields) -> Optional[dict]:
        """Emit a ``kind="serve_gauge"`` record: a sample of the live
        engine (queue, slots, pool, prefix cache, speculation, counters)."""
        return self._record_event("serve_gauge", label, fields)

    def record_shed(self, *, request_id: str, reason: str, label: str = "serve",
                    **fields) -> Optional[dict]:
        """Emit a ``kind="shed"`` record: one request refused or expired
        (``reason``: ``queue_full`` | ``queue_deadline``)."""
        return self._record_event("shed", label,
                                  {"request_id": request_id, "reason": reason, **fields})

    def record_slo(self, *, label: str = "serve", **fields) -> Optional[dict]:
        """Emit a ``kind="slo"`` record: attainment and burn rates of the
        serving latency objectives."""
        return self._record_event("slo", label, fields)

    def record_memory(self, *, label: str = "memory", **fields) -> Optional[dict]:
        """Emit a ``kind="memory"`` record: one device and host memory
        sample."""
        return self._record_event("memory", label, fields)

    def sample_memory(self, *, force: bool = False) -> Optional[dict]:
        """Take one memory sample and emit it as a ``kind="memory"`` record:
        ``hbm_bytes_in_use``, ``peak_hbm_bytes`` and ``hbm_bytes_limit`` of
        the CUDA device, ``host_rss_bytes``. Samples are at least
        ``config.census_min_interval_s`` apart (``force`` skips the wait);
        None while disabled or waiting."""
        if not self.enabled:
            return None
        now = time.monotonic()
        if (not force and self._last_memory_t is not None
                and now - self._last_memory_t < self.config.census_min_interval_s):
            return None
        self._last_memory_t = now
        stats = device_memory_stats()
        return self.record_memory(hbm_bytes_in_use=stats["bytes_in_use"],
                                  peak_hbm_bytes=stats["peak_bytes_in_use"],
                                  hbm_bytes_limit=stats["bytes_limit"],
                                  host_rss_bytes=host_memory_rss())

    # ------------------------------------------------------------------ #
    # training hooks (queue A10)
    # ------------------------------------------------------------------ #
    def begin_step(self, *args, **kwargs):
        raise _training_hook("begin_step")

    def end_step(self, *args, **kwargs):
        raise _training_hook("end_step")

    def record_checkpoint(self, *args, **kwargs):
        raise _training_hook("record_checkpoint")

    def record_compile(self, *args, **kwargs):
        raise _training_hook("record_compile")

    def record_dataloader_wait(self, *args, **kwargs):
        raise _training_hook("record_dataloader_wait")

    # ------------------------------------------------------------------ #
    # reporting and lifecycle
    # ------------------------------------------------------------------ #
    def summary(self) -> dict[str, Any]:
        """Counts over the in-memory ring: records by kind, and the sink
        errors seen. The reference's step-time block waits for the step
        records (queue A10)."""
        by_kind: dict[str, int] = {}
        for record in self.records:
            kind = str(record.get("kind"))
            by_kind[kind] = by_kind.get(kind, 0) + 1
        return {"records": len(self.records), "by_kind": by_kind,
                "sink_errors": self._sink_errors}

    def close(self) -> None:
        """Close every sink (idempotent)."""
        for sink in self.sinks:
            try:
                sink.close()
            except Exception as exc:  # closing one sink must not skip the rest
                logger.warning(f"telemetry sink {type(sink).__name__} close failed: {exc}")
