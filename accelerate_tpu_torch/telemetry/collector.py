"""The telemetry collector: training step records and the serving records.

Port of ``accelerate_tpu/telemetry/collector.py:StepTelemetry`` (:47):
``add_sink``, the emit path (the in-memory ring, then every sink, with a
``kind="meta"`` record first and sink errors caught and rate-limited), the
training hooks the Accelerator's step wrapper and the prepared loaders call
(``detector``, ``record_dataloader_wait``, ``begin_step``, ``end_step``,
``record_compile``, :193-360), ``record_serve`` (:398),
``record_span``, ``record_serve_gauge``, ``record_shed``,
``record_preempt`` (:515-540), ``record_memory``, ``sample_memory``
(:542-575), ``record_slo``, ``record_soak`` (:577-), ``summary`` and
``close``.

An enabled collector holds a buffer census (``census``, a
``profiling.census.BufferCensus``, :85-90) that a serving engine points at
its parameters and KV cache. ``sample_memory`` takes one census (owner
bytes, unowned bytes, host RSS and its peak) and adds
``torch.cuda.memory_stats`` of the current CUDA device where there is one;
on a machine without CUDA the device fields are 0, as the reference
reports a device that gives no numbers.

A step's time is the reference's async-aware bracket: ``begin_step``
before the call, ``end_step(result)`` after it, which synchronises the
CUDA device when the result holds a CUDA tensor (the only synchronise
telemetry adds, and only while enabled): ``step_time_s`` runs to that
synchronise, ``dispatch_s`` to the call's return.

``record_checkpoint`` emits one record for each committed save, from the
train loop (sync) or from the checkpoint writer's thread (async); records
are serialised by one lock.

With ``TelemetryConfig(heartbeat=...)`` the collector starts a
:class:`~.heartbeat.HeartbeatMonitor` and beats it at every step record;
with ``diagnostics=...`` it owns a
``diagnostics.manager.DiagnosticsManager`` (the reference's :104-118):
every emitted record goes through its ``observe``, and the ``goodput`` and
``anomaly`` records it derives re-enter the emit path, so they reach the
ring and every sink; dataloader waits go to its ``record_wait``, fields of
a finished capture land on the next step record, a heartbeat stall goes to
its ``on_stall``, and ``close`` writes its final ``"shutdown"`` dump. With
``census_interval`` a buffer census rides every N-th step record.
"""

from __future__ import annotations

import collections
import math
import statistics
import threading
import time
from typing import Any, Optional, Union

import torch

from ..logging import get_logger
from ..profiling.census import BufferCensus
from ..utils.profiling import device_memory_stats, host_memory_rss
from .config import TelemetryConfig
from .heartbeat import HeartbeatMonitor
from .recompile import RecompileDetector, _flatten_with_path
from .sinks import SCHEMA_VERSION, JSONLSink, TelemetrySink

logger = get_logger(__name__)


def _infer_tokens(batch: Any) -> Optional[int]:
    """Default token counter: the first tensor with a sequence dim gives
    batch x seq; else the leading dim of the first with one."""
    leaves: list = []
    _flatten_with_path(batch, "", leaves)
    fallback = None
    for _, leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if not shape:
            continue
        if len(shape) >= 2:
            return int(shape[0]) * int(shape[1])
        if fallback is None:
            fallback = int(shape[0])
    return fallback


def _scalar_items(metrics: Any):
    """(key, float) for the 0-d numeric values of a metrics dict. The
    port's step reports ``is_sync_step`` and ``grads_finite`` as host bools
    where the reference's reports 0-d arrays, so bools count as 0 or 1."""
    if not isinstance(metrics, dict):
        return
    for key, value in metrics.items():
        if isinstance(value, str):
            continue
        if isinstance(value, (bool, int, float)):
            yield key, float(value)
        elif getattr(value, "shape", None) == ():
            yield key, float(value)


def _synchronize(result: Any) -> None:
    """Wait for the CUDA device if ``result`` holds a CUDA tensor."""
    leaves: list = []
    _flatten_with_path(result, "", leaves)
    devices = {leaf.device for _, leaf in leaves
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def _rank_and_world() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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
        self.census = (BufferCensus(min_interval_s=config.census_min_interval_s)
                       if config.enabled else None)
        self._detectors: dict[str, RecompileDetector] = {}
        self._t0: Optional[float] = None
        self._dl_wait = 0.0
        self._emitted = 0
        # records may come from several threads: serialize sink writes
        self._emit_lock = threading.Lock()
        # asked here, not in the meta record: that may be built on the
        # checkpoint writer's thread, which makes no CUDA call but its wait
        cuda = torch.cuda.is_available()
        self._backend = ("cuda" if cuda else "cpu", torch.cuda.device_count() if cuda else 0)
        if config.enabled and config.jsonl_path is not None:
            self.add_sink(JSONLSink(config.jsonl_path))
        self.heartbeat: Optional[HeartbeatMonitor] = None
        self.diagnostics = None
        if config.enabled and config.diagnostics is not None:
            from ..diagnostics.manager import DiagnosticsManager

            self.diagnostics = DiagnosticsManager(config.diagnostics)
        if config.enabled and config.heartbeat:
            self.heartbeat = HeartbeatMonitor(
                dir=config.heartbeat_dir,
                interval_s=config.heartbeat_interval_s,
                stall_timeout_s=config.heartbeat_stall_timeout_s,
                on_stall=self.diagnostics.on_stall if self.diagnostics is not None else None,
            ).start()

    # ------------------------------------------------------------------ #
    # sinks
    # ------------------------------------------------------------------ #
    def add_sink(self, sink: TelemetrySink) -> TelemetrySink:
        self.sinks.append(sink)
        return sink

    def _emit(self, record: dict, scalars: Optional[dict] = None) -> None:
        """Emit one record: ring, sinks, then diagnostics. ``scalars`` is a
        step's 0-d metrics before the non-finite ``grad_norm`` is taken off
        the record: the NaN rule needs the values the record cannot carry.
        The records diagnostics derives (``anomaly``, ``goodput``) re-enter
        here once; the manager files them without deriving more."""
        with self._emit_lock:  # the checkpoint writer's thread emits too
            self.records.append(record)
            if self.sinks and _rank_and_world()[0] == 0:
                if not self._meta_written:
                    self._meta_written = True
                    self._emit_raw(self._meta_record())
                self._emit_raw(record)
        if self.diagnostics is not None:
            try:
                derived = self.diagnostics.observe(record, scalars)
            except Exception as exc:  # diagnostics never take the loop down
                self._sink_errors += 1
                if self._sink_errors <= 3:
                    logger.warning(f"telemetry diagnostics failed: {exc}")
                derived = []
            for extra_record in derived:
                self._emit(extra_record)

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
            "backend": self._backend[0],
            "process_index": rank,
            "process_count": world,
            "local_device_count": self._backend[1],
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

    def record_preempt(self, *, request_id: str, reason: str, label: str = "serve",
                       **fields) -> Optional[dict]:
        """Emit a ``kind="preempt"`` record: one running request swapped out
        to host memory (``reason``: ``priority`` | ``pool`` | ``growth``).
        Unlike a shed the request resumes later with the same tokens."""
        return self._record_event("preempt", label,
                                  {"request_id": request_id, "reason": reason, **fields})

    def record_soak(self, *, label: str = "soak", **fields) -> Optional[dict]:
        """Emit a ``kind="soak"`` record: the loadgen harness's posture at a
        phase end (offered and achieved rate, goodput under the SLO,
        arrival lag, sheds, breach) or its ``phase="final"`` summary."""
        return self._record_event("soak", label, fields)

    def record_memory(self, *, label: str = "memory", **fields) -> Optional[dict]:
        """Emit a ``kind="memory"`` record: one device and host memory
        sample."""
        return self._record_event("memory", label, fields)

    def sample_memory(self, *, step: Optional[int] = None, force: bool = False,
                      label: str = "memory") -> Optional[dict]:
        """Take one census and emit it as a ``kind="memory"`` record: the
        census fields (``census_owner_bytes``, ``census_unowned_bytes``,
        ``census_total_bytes``, ``census_arrays``, ``host_rss_bytes``,
        ``host_rss_peak_bytes``) and ``hbm_bytes_in_use``,
        ``peak_hbm_bytes`` and ``hbm_bytes_limit`` of the CUDA device.
        Samples are at least ``config.census_min_interval_s`` apart
        (``force`` skips the wait); None while disabled or waiting."""
        if not self.enabled or self.census is None:
            return None
        fields = self.census.maybe_sample(force=force)
        if fields is None:
            return None
        fields = dict(fields)
        stats = device_memory_stats()
        fields["hbm_bytes_in_use"] = stats["bytes_in_use"]
        fields["peak_hbm_bytes"] = stats["peak_bytes_in_use"]
        fields["hbm_bytes_limit"] = stats["bytes_limit"]
        if step is not None:
            fields["step"] = step
        return self.record_memory(label=label, **fields)

    # ------------------------------------------------------------------ #
    # training hooks (the Accelerator's step wrapper, the prepared loaders)
    # ------------------------------------------------------------------ #
    def detector(self, name: str) -> RecompileDetector:
        """Get or create the rebuild detector of one step function."""
        det = self._detectors.get(name)
        if det is None:
            det = self._detectors[name] = RecompileDetector(name)
        return det

    @property
    def recompiles(self) -> int:
        """Rebuilds seen by every detector (new signatures after the first)."""
        return sum(d.retraces for d in self._detectors.values())

    def record_dataloader_wait(self, seconds: float, source: str = "dataloader") -> None:
        """Add host time spent waiting for a batch; the next step record
        carries the total as ``dataloader_wait_s``. With diagnostics the
        wait also goes to its goodput at once (a starved loop with no step
        after it still counts), and a long one (``source`` names the
        loader) becomes a flight-recorder event."""
        if not self.enabled:
            return
        self._dl_wait += seconds
        if self.diagnostics is not None:
            self.diagnostics.record_wait(seconds, source=source)

    def begin_step(self) -> None:
        """Mark the host-side start of a step call."""
        if self.enabled:
            self._t0 = time.perf_counter()

    def end_step(self, result: Any = None, *, batch: Any = None, step: Optional[int] = None,
                 metrics: Any = None, retraced: bool = False, label: str = "step",
                 compile_stats: Optional[dict] = None,
                 extra: Optional[dict] = None) -> Optional[dict]:
        """Complete one step: wait for ``result`` on the device, build the
        ``kind="step"`` record (times, dataloader wait, rebuilds, tokens and
        throughput, model FLOP/s and MFU, memory every ``memory_interval``
        records, the step's 0-d metrics, ``extra``), emit it and return it
        (None while disabled). A ``grad_norm`` that is not finite or comes
        from a step that only accumulated is left off the record."""
        if not self.enabled:
            return None
        if self._t0 is None:
            total_s = dispatch_s = 0.0
        else:
            dispatch_s = time.perf_counter() - self._t0
            if result is not None:
                _synchronize(result)
            total_s = time.perf_counter() - self._t0
            self._t0 = None
        record: dict[str, Any] = {
            "kind": "step",
            "label": label,
            "step": step,
            "time_unix": time.time(),
            "step_time_s": total_s,
            "dispatch_s": dispatch_s,
            "dataloader_wait_s": self._dl_wait,
            "retraced": bool(retraced),
            "recompiles": self.recompiles,
        }
        self._dl_wait = 0.0
        if compile_stats:
            record["compile_time_s"] = float(compile_stats.get("compile_time_s", 0.0))
            record["persistent_cache_hits"] = int(compile_stats.get("persistent_cache_hits", 0))
            record["persistent_cache_misses"] = int(
                compile_stats.get("persistent_cache_misses", 0))
        for key, value in (extra or {}).items():
            record.setdefault(key, value)
        if self.diagnostics is not None:
            # a finished capture's fields (top_ops, overlap_pct) land on the
            # first step record after its trace is on disk
            for key, value in self.diagnostics.pop_step_fields().items():
                record.setdefault(key, value)

        tokens = None
        if batch is not None:
            try:
                tokens = (self.config.tokens_fn or _infer_tokens)(batch)
            except Exception:  # a user's counter never stops the step
                tokens = None
        record["tokens"] = tokens
        record["tokens_per_s"] = tokens / total_s if tokens and total_s > 0 else None
        if self.config.flops_per_token is not None:
            flops_per_s = (self.config.flops_per_token * record["tokens_per_s"]
                           if record["tokens_per_s"] else None)
            record["model_flops_per_s"] = flops_per_s
            if flops_per_s and self.config.device_peak_flops:
                record["mfu"] = flops_per_s / self.config.device_peak_flops  # one device

        interval = self.config.memory_interval
        if interval and self._emitted % interval == 0:
            stats = device_memory_stats()
            record["peak_hbm_bytes"] = stats["peak_bytes_in_use"]
            record["hbm_bytes_in_use"] = stats["bytes_in_use"]
            record["hbm_bytes_limit"] = stats["bytes_limit"]
            record["host_rss_bytes"] = host_memory_rss()

        raw_scalars = None
        if metrics is not None:
            raw_scalars = dict(_scalar_items(metrics))
            scalars = dict(raw_scalars)
            gnorm = scalars.get("grad_norm")
            if gnorm is not None and (not math.isfinite(gnorm)
                                      or not scalars.get("is_sync_step", 1.0)):
                del scalars["grad_norm"]  # no norm on an accumulating step; NaN is no JSON
            for key, value in scalars.items():
                record.setdefault(key, value)

        self._emitted += 1
        self._emit(record, raw_scalars)
        cadence = self.config.census_interval
        if cadence and self._emitted % cadence == 0:
            # its own record kind, at most one a census_min_interval_s
            self.sample_memory(step=step)
        if self.heartbeat is not None:
            self.heartbeat.beat(step)
        return record

    def record_compile(self, *, label: str = "step", source: str = "warmup",
                       compile_time_s: Optional[float] = None, persistent_cache_hits: int = 0,
                       persistent_cache_misses: int = 0, **extra: Any) -> Optional[dict]:
        """Emit a ``kind="compile"`` record: one build outside a step worth
        attributing. None while disabled."""
        if not self.enabled:
            return None
        record: dict[str, Any] = {
            "kind": "compile",
            "label": label,
            "source": source,
            "time_unix": time.time(),
            "compile_time_s": compile_time_s,
            "persistent_cache_hits": int(persistent_cache_hits),
            "persistent_cache_misses": int(persistent_cache_misses),
        }
        for key, value in extra.items():
            record.setdefault(key, value)
        self._emit(record)
        return record

    def record_checkpoint(self, *, step: Optional[int] = None, directory: Optional[str] = None,
                          mode: str = "sync", blocked_s: Optional[float] = None,
                          background_s: Optional[float] = None,
                          bytes_written: Optional[int] = None, **extra: Any) -> Optional[dict]:
        """Emit a ``kind="checkpoint"`` record: one committed save.
        ``blocked_s`` is what the train loop waited (sync: the whole save;
        async: the snapshot, the host-state capture and any backpressure),
        ``background_s`` the writer thread's serialisation, IO and commit
        (0 for sync). Thread-safe: async saves report from the writer
        thread. None while disabled."""
        if not self.enabled:
            return None
        record: dict[str, Any] = {
            "kind": "checkpoint",
            "label": "checkpoint",
            "step": step,
            "time_unix": time.time(),
            "dir": directory,
            "mode": mode,
            "blocked_s": blocked_s,
            "background_s": background_s,
            "bytes_written": bytes_written,
        }
        io_s = background_s if mode == "async" else blocked_s
        record["write_bandwidth_bytes_per_s"] = (
            bytes_written / io_s if bytes_written and io_s else None)
        for key, value in extra.items():
            record.setdefault(key, value)
        self._emit(record)
        return record

    # ------------------------------------------------------------------ #
    # reporting and lifecycle
    # ------------------------------------------------------------------ #
    def summary(self) -> dict[str, Any]:
        """Counts over the in-memory ring: records by kind and the sink
        errors seen; step counts, rebuilds and dataloader wait; the
        step-time mean, median and p90 and mean tokens/s over the steps that
        did not rebuild; the checkpoints and their blocked and background
        seconds; the heartbeat's stalls; and diagnostics' summary with
        ``goodput_pct`` and ``rolling_goodput_pct`` lifted to the top (the
        reference's :602-648)."""
        by_kind: dict[str, int] = {}
        for record in self.records:
            kind = str(record.get("kind"))
            by_kind[kind] = by_kind.get(kind, 0) + 1
        steps = [r for r in self.records if r.get("kind") == "step"]
        out: dict[str, Any] = {
            "records": len(self.records), "by_kind": by_kind, "sink_errors": self._sink_errors,
            "steps": len(steps), "recompiles": self.recompiles,
            "dataloader_wait_total_s": float(sum(r.get("dataloader_wait_s") or 0.0
                                                 for r in steps)),
        }
        timed = [r["step_time_s"] for r in steps if not r.get("retraced")]
        if timed:
            ordered = sorted(timed)
            pos = 0.9 * (len(ordered) - 1)  # numpy's linear percentile
            lo = int(pos)
            hi = min(lo + 1, len(ordered) - 1)
            out.update(step_time_mean_s=statistics.fmean(timed),
                       step_time_median_s=statistics.median(timed),
                       step_time_p90_s=ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo))
            tps = [r["tokens_per_s"] for r in steps
                   if not r.get("retraced") and r.get("tokens_per_s")]
            if tps:
                out["tokens_per_s_mean"] = statistics.fmean(tps)
        ckpts = [r for r in self.records if r.get("kind") == "checkpoint"]
        if ckpts:
            out["checkpoints"] = len(ckpts)
            out["checkpoint_blocked_total_s"] = float(
                sum(r.get("blocked_s") or 0.0 for r in ckpts))
            out["checkpoint_background_total_s"] = float(
                sum(r.get("background_s") or 0.0 for r in ckpts))
        if self.heartbeat is not None:
            out["stalls"] = self.heartbeat.stalls
        if self.diagnostics is not None:
            diag = self.diagnostics.summary()
            goodput = diag.get("goodput")
            if goodput is not None:
                out["goodput_pct"] = goodput["goodput_pct"]
                out["rolling_goodput_pct"] = goodput["rolling_goodput_pct"]
            out.update(diag)
        return out

    def close(self) -> None:
        """Stop the watchdog, write diagnostics' final dump and close every
        sink (idempotent)."""
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.diagnostics is not None:
            try:
                self.diagnostics.close()
            except Exception as exc:  # closing must reach the sinks
                logger.warning(f"telemetry diagnostics close failed: {exc}")
        for sink in self.sinks:
            try:
                sink.close()
            except Exception as exc:  # closing one sink must not skip the rest
                logger.warning(f"telemetry sink {type(sink).__name__} close failed: {exc}")
