"""Per-process flight recorder: the evidence survives the process.

Port of ``accelerate_tpu/diagnostics/flight_recorder.py``; the process
index is the port's (``state.PartialState``).

When a multi-host job dies or hangs, the telemetry stream dies with it —
unless each process has been continuously publishing its last-known
state. The recorder keeps a ring of the last ``ring_size`` telemetry
records and ``max_events`` notable events (anomalies, stalls, dataloader
stalls, capture starts, exceptions) and dumps them atomically
(tmp + ``os.replace``, the heartbeat-file discipline) to
``dir/flightrec-rank{i}.json``:

* every ``dump_interval_s`` seconds while the run is healthy — so even a
  SIGKILL/OOM-kill (which no handler can catch) leaves a committed dump
  at most one interval old;
* immediately on notable events: unhandled exception (``sys.excepthook``
  chain), heartbeat stall, preemption, anomaly.

``diagnose <dir>`` aggregates these per-host files (plus
the heartbeat files) into the post-mortem report.

Thread-safe: records arrive from the train loop AND the async-checkpoint
writer thread; stall events arrive from the heartbeat watchdog.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Optional

from ..logging import get_logger
from .config import DiagnosticsConfig

logger = get_logger(__name__)

DUMP_PREFIX = "flightrec-rank"
DUMP_SCHEMA = 1


def _default_process_index() -> int:
    """This process's index in the port's state (0 before any state is
    made: building one here would pick a device)."""
    from ..state import PartialState

    return int(PartialState._shared_state.get("process_index", 0))


class FlightRecorder:
    def __init__(
        self,
        config: Optional[DiagnosticsConfig] = None,
        process_index: Optional[int] = None,
    ):
        self.config = config or DiagnosticsConfig()
        self.process_index = (
            _default_process_index() if process_index is None else process_index
        )
        self.records: collections.deque = collections.deque(
            maxlen=self.config.ring_size
        )
        self.events: collections.deque = collections.deque(
            maxlen=self.config.max_events
        )
        self.last_step: Optional[int] = None
        self.last_checkpoint: Optional[dict] = None
        self.dumps = 0
        self._last_dump = 0.0
        self._lock = threading.Lock()
        self._prev_excepthook = None
        self._dump_errors = 0
        if self.config.dir is not None:
            os.makedirs(self.config.dir, exist_ok=True)

    # ------------------------------------------------------------------ #
    @property
    def path(self) -> Optional[str]:
        if self.config.dir is None:
            return None
        return os.path.join(
            self.config.dir, f"{DUMP_PREFIX}{self.process_index}.json"
        )

    def observe(self, record: dict) -> None:
        """Append one telemetry record to the ring; periodic dump."""
        with self._lock:
            self.records.append(record)
            kind = record.get("kind")
            if kind == "step" and isinstance(record.get("step"), int):
                self.last_step = record["step"]
            elif kind == "checkpoint":
                self.last_checkpoint = {
                    "dir": record.get("dir"),
                    "step": record.get("step"),
                    "time_unix": record.get("time_unix"),
                }
        now = time.monotonic()
        if now - self._last_dump >= self.config.dump_interval_s:
            self.dump("periodic")

    def event(self, event_type: str, dump: bool = True, **fields: Any) -> dict:
        """Record a notable event; by default also dumps immediately (the
        event is exactly the evidence a post-mortem needs on disk)."""
        entry = {"event": event_type, "time_unix": time.time(), **fields}
        with self._lock:
            self.events.append(entry)
        if dump:
            self.dump(event_type)
        return entry

    # ------------------------------------------------------------------ #
    def dump(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Atomically write this process's dump file; returns its path
        (None when no dir is configured). Never raises — the recorder
        must stay harmless inside excepthooks and signal-adjacent paths."""
        path = self.path
        if path is None:
            return None
        self._last_dump = time.monotonic()
        with self._lock:
            payload = {
                "kind": "flight_recorder",
                "schema": DUMP_SCHEMA,
                "process_index": self.process_index,
                "pid": os.getpid(),
                "reason": reason,
                "time_unix": time.time(),
                "last_step": self.last_step,
                "last_checkpoint": self.last_checkpoint,
                "dumps": self.dumps + 1,
                "events": list(self.events),
                "records": list(self.records),
            }
        if extra:
            payload.update(extra)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # readers never see a torn dump
        except OSError as exc:
            self._dump_errors += 1
            if self._dump_errors <= 3:
                logger.warning(f"flight-recorder dump failed: {exc}")
            return None
        self.dumps += 1
        return path

    # ------------------------------------------------------------------ #
    def install_excepthook(self) -> None:
        """Chain onto ``sys.excepthook``: an unhandled exception dumps
        (with the traceback as an event) before the interpreter dies."""
        if self._prev_excepthook is not None:
            return
        self._prev_excepthook = sys.excepthook

        def _hook(exc_type, exc, tb):
            try:
                self.event(
                    "exception",
                    dump=False,
                    exception=f"{exc_type.__name__}: {exc}",
                    traceback="".join(
                        traceback.format_exception(exc_type, exc, tb)
                    )[-4000:],
                )
                self.dump(f"exception:{exc_type.__name__}")
            except Exception:
                pass  # the original exception must still surface
            (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = _hook

    def uninstall_excepthook(self) -> None:
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None

    def summary(self) -> dict:
        with self._lock:
            return {
                "flight_recorder_dumps": self.dumps,
                "flight_recorder_path": self.path,
                "last_checkpoint": self.last_checkpoint,
                "events": len(self.events),
            }


def list_dumps(dir: str) -> dict[int, dict]:
    """Read every ``flightrec-rank*.json`` under ``dir`` ->
    ``{rank: payload}``. Torn/foreign files are skipped, never fatal —
    the scanner runs during post-mortems, when anything may be broken."""
    out: dict[int, dict] = {}
    if not os.path.isdir(dir):
        return out
    for name in sorted(os.listdir(dir)):
        if not (name.startswith(DUMP_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dir, name)) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        out[int(payload.get("process_index", -1))] = payload
    return out
