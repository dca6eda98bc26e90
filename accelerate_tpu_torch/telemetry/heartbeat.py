"""Multi-host heartbeat / hang monitor.

Port of ``accelerate_tpu/telemetry/heartbeat.py``: the process index is the
port's (``state.PartialState``), and the elastic generation and fault domain
come from ``ACCELERATE_TPU_*`` variables (``utils/constants.ENV_PREFIX``).

In a job of many processes a single wedged rank (stuck host input pipeline, a deadlocked
collective, a crashed data worker) stalls *every* rank at the next
collective — and the job dies only when the scheduler's wall clock
expires, hours later, with no record of who stopped first.

:class:`HeartbeatMonitor` is the cheap answer: the train loop ``beat()``\\ s
once per completed step; a daemon thread flags the process as *stalled*
when no beat arrives within ``stall_timeout_s`` and logs a loud warning
with the last completed step. With a ``dir`` on shared storage each rank
also writes a tiny ``heartbeat-rank{i}.json`` on a rate-limited cadence,
so any rank (or a human with ``cat``) can run :func:`scan_heartbeats` and
name the stalled rank while the job is still alive.

The monitor thread holds only a weak reference (the
``utils.profiling.PeakHostMemory`` pattern): an abandoned monitor exits
with its last owner instead of polling forever.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import Any, Callable, Optional

from ..logging import get_logger

logger = get_logger(__name__)


def _default_process_index() -> int:
    """This process's index in the port's state (0 before any state is
    made: building one here would pick a device)."""
    from ..state import PartialState

    return int(PartialState._shared_state.get("process_index", 0))


def _default_generation() -> Optional[int]:
    """The elastic generation this process belongs to (the supervisor
    exports it on every relaunch) — stamped into heartbeat records so a
    scanner can ignore stale files left by a previous, smaller/larger
    world without racing file deletion."""
    from ..utils.constants import ENV_PREFIX

    val = os.environ.get(ENV_PREFIX + "ELASTIC_GENERATION")
    try:
        return int(val) if val is not None else None
    except ValueError:
        return None


def _default_fault_domain() -> Optional[int]:
    """The slice id (fault domain) this process lives on — the elastic
    supervisor exports it per rank on multi-slice runs. Stamped into
    heartbeat records so a scanner (or ``diagnose``) can tell a single
    wedged rank from a whole lost slice."""
    from ..utils.constants import ENV_PREFIX

    val = os.environ.get(ENV_PREFIX + "FAULT_DOMAIN")
    try:
        return int(val) if val is not None else None
    except ValueError:
        return None


class HeartbeatMonitor:
    """Watchdog for the step loop of one process.

    ``interval_s``: cadence for heartbeat-file writes (and the floor of
    the watchdog poll). ``stall_timeout_s``: silence longer than this
    flags the process as stalled. ``on_stall``: optional callback invoked
    once per stall (e.g. dump stacks, trigger a checkpoint).

    Thread-safe: ``beat()`` may be called from any thread.
    """

    def __init__(
        self,
        dir: Optional[str] = None,
        interval_s: float = 10.0,
        stall_timeout_s: float = 300.0,
        process_index: Optional[int] = None,
        on_stall: Optional[Callable[["HeartbeatMonitor"], None]] = None,
        generation: Optional[int] = None,
        fault_domain: Optional[int] = None,
    ):
        if stall_timeout_s <= 0:
            raise ValueError("stall_timeout_s must be > 0")
        self.dir = dir
        self.interval_s = interval_s
        self.stall_timeout_s = stall_timeout_s
        self.process_index = (
            _default_process_index() if process_index is None else process_index
        )
        self.generation = (
            _default_generation() if generation is None else generation
        )
        self.fault_domain = (
            _default_fault_domain() if fault_domain is None else fault_domain
        )
        self.on_stall = on_stall
        self.stalls = 0  # completed stall episodes observed
        self._stalled = False
        self._last_beat = time.monotonic()
        self._last_step: Optional[int] = None
        self._last_write = 0.0
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------------------------ #
    @property
    def path(self) -> Optional[str]:
        if self.dir is None:
            return None
        return os.path.join(self.dir, f"heartbeat-rank{self.process_index}.json")

    @property
    def stalled(self) -> bool:
        return self._stalled

    @property
    def last_step(self) -> Optional[int]:
        return self._last_step

    def start(self) -> "HeartbeatMonitor":
        if self._running:
            return self
        self._running = True
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=HeartbeatMonitor._watch,
            args=(weakref.ref(self),),
            daemon=True,
            name=f"telemetry-heartbeat-{self.process_index}",
        )
        self._thread.start()
        return self

    def beat(self, step: Optional[int] = None) -> None:
        """Record a completed step. Cheap (a timestamp + a rate-limited
        tiny file write); call once per step from the train loop."""
        now = time.monotonic()
        recovered = False
        with self._lock:
            self._last_beat = now
            if step is not None:
                self._last_step = step
            if self._stalled:
                self._stalled = False
                recovered = True
        if recovered:
            logger.warning(
                "heartbeat: rank %d recovered at step %s",
                self.process_index,
                self._last_step,
            )
        if self.path is not None and (
            now - self._last_write >= self.interval_s or recovered
        ):
            self._write_file()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------------ #
    def _write_file(self) -> None:
        path = self.path
        if path is None:
            return
        self._last_write = time.monotonic()
        record = {
            "process_index": self.process_index,
            "pid": os.getpid(),
            "step": self._last_step,
            "time_unix": time.time(),
            "stalled": self._stalled,
        }
        if self.generation is not None:
            record["generation"] = self.generation
        if self.fault_domain is not None:
            record["fault_domain"] = self.fault_domain
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, path)  # atomic: scanners never see a torn file
        except OSError as exc:  # shared storage hiccups must not kill training
            logger.warning_once(f"heartbeat file write failed: {exc}")

    @staticmethod
    def _watch(ref: "weakref.ref[HeartbeatMonitor]") -> None:
        while True:
            self = ref()
            if self is None or not self._running:
                return
            quantum = min(self.interval_s, self.stall_timeout_s / 4, 1.0)
            with self._lock:
                silent = time.monotonic() - self._last_beat
                newly_stalled = silent > self.stall_timeout_s and not self._stalled
                if newly_stalled:
                    self._stalled = True
                    self.stalls += 1
            if newly_stalled:
                # file before log: scanners watching the dir must not see a
                # fresh stalled=False file after the attribute reads stalled
                self._write_file()
                logger.warning(
                    "heartbeat: rank %d STALLED — no step completed for "
                    "%.1fs (stall_timeout %.1fs, last step %s). A wedged "
                    "rank stalls every rank at its next collective; "
                    "check this host's input pipeline / stacks before the "
                    "job wall clock expires.",
                    self.process_index,
                    silent,
                    self.stall_timeout_s,
                    self._last_step,
                    main_process_only=False,
                )
                if self.on_stall is not None:
                    try:
                        self.on_stall(self)
                    except Exception:
                        logger.exception("heartbeat on_stall callback failed")
            del self  # don't pin the monitor between polls
            time.sleep(quantum)


def scan_heartbeats(
    dir: str, stall_timeout_s: float = 300.0
) -> dict[int, dict[str, Any]]:
    """Read every ``heartbeat-rank*.json`` under ``dir`` and mark staleness.

    Returns ``{rank: record}`` where each record additionally carries
    ``age_s`` (seconds since that rank's last write) and ``stale`` (the
    file is older than ``stall_timeout_s`` OR the rank flagged itself
    stalled). Run from rank 0 — or by hand — to name the wedged rank on a
    job that has stopped making progress.
    """
    out: dict[int, dict[str, Any]] = {}
    if not os.path.isdir(dir):
        return out
    now = time.time()
    for name in sorted(os.listdir(dir)):
        if not (name.startswith("heartbeat-rank") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dir, name)) as f:
                record = json.load(f)
        except (OSError, ValueError):
            continue  # torn/foreign file: skip, never crash the scanner
        age = now - float(record.get("time_unix", 0.0))
        record["age_s"] = age
        record["stale"] = bool(record.get("stalled")) or age > stall_timeout_s
        out[int(record.get("process_index", -1))] = record
    return out


def partition_liveness(
    dir: str,
    stall_timeout_s: float = 300.0,
    generation: Optional[int] = None,
    world: Optional[int] = None,
) -> tuple[set[int], set[int]]:
    """``(alive, dead)`` rank sets from the heartbeat files — the elastic
    supervisor's declare-a-rank-dead primitive.

    ``generation`` filters out files written by a previous elastic
    generation (a relaunched, renumbered world must not count its
    predecessor's ranks). ``world`` caps the rank range and counts ranks
    that have never written a heartbeat as dead — a process wedged before
    its first beat is as gone as one that stopped beating.
    """
    records = scan_heartbeats(dir, stall_timeout_s=stall_timeout_s)
    if generation is not None:
        records = {
            r: rec
            for r, rec in records.items()
            if rec.get("generation") == generation
        }
    if world is not None:
        records = {r: rec for r, rec in records.items() if 0 <= r < world}
    alive = {r for r, rec in records.items() if not rec["stale"]}
    dead = {r for r, rec in records.items() if rec["stale"]}
    if world is not None:
        dead |= set(range(world)) - alive - dead
    return alive, dead
