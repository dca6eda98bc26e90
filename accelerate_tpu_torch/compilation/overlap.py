"""Evidence from a profile capture: the top kernels by self time and the
overlap of collectives with compute.

Port of the two functions of ``accelerate_tpu/compilation/overlap.py`` that
the diagnostics manager calls (``manager.py:177-199``):
:func:`top_self_time_ops` (:408) and :func:`collective_compute_overlap`
(:465), with the pure interval math they share (:func:`overlap_from_spans`,
:142). Where the reference parses ``*.xplane.pb`` device planes, these read
the Chrome JSON traces that ``torch.profiler`` exports
(``*.pt.trace.json``): the events of categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` are the work on the CUDA device, every
other complete event is host work. The XLA scheduler options of the
reference's module wait for the rest of ``compilation/`` (ROADMAP.md,
queue A10).

Everything here is best-effort: a missing or garbled trace yields None,
never an exception on the train loop.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Iterable, Optional

from ..logging import get_logger

logger = get_logger(__name__)

TRACE_SUFFIX = ".pt.trace.json"
#: Kineto's categories of work on the CUDA device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# NCCL's kernels (ncclDevKernel_AllReduce_Sum_f32_RING_LL, ...) and the
# reference's HLO names, with or without a separator
_COLLECTIVE_RE = re.compile(
    r"nccl|all[-_]?gather|all[-_]?reduce|reduce[-_]?scatter|all[-_]?to[-_]?all"
    r"|collective[-_]?permute|send[-_]?recv",
    re.IGNORECASE,
)


def is_collective_event(name: str) -> bool:
    """Does this kernel or trace event name denote a cross-device collective?"""
    return bool(_COLLECTIVE_RE.search(name or ""))


def _merge_intervals(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def overlap_from_spans(spans: Iterable[dict]) -> Optional[dict[str, Any]]:
    """Collective/compute overlap from a flat span list (the reference's
    :142, as it stands).

    ``spans``: dicts with ``name``, ``start``, ``end`` (any consistent time
    unit; ``end > start``) and optionally an explicit ``kind``
    (``"collective"`` / ``"compute"``) overriding the name classifier.
    Async collectives traced as ``<op>-start`` / ``<op>-done`` pairs are
    folded into one interval spanning issue to completion.

    Returns ``{"overlap_pct", "collective_time", "compute_time",
    "overlapped_time"}`` with ``overlap_pct`` the share of total collective
    time covered by the union of compute spans, or None when no collective
    spans exist (nothing to measure).
    """
    collectives: list[tuple[float, float]] = []
    compute: list[tuple[float, float]] = []
    pending_start: dict[str, tuple[float, float]] = {}
    for span in spans:
        name = str(span.get("name", ""))
        start, end = span["start"], span["end"]
        if end <= start:
            continue
        kind = span.get("kind")
        if kind is None:
            kind = "collective" if is_collective_event(name) else "compute"
        if kind != "collective":
            compute.append((start, end))
            continue
        if name.endswith("-start"):
            pending_start[name[: -len("-start")]] = (start, end)
            continue
        if name.endswith("-done"):
            issued = pending_start.pop(name[: -len("-done")], None)
            if issued is not None:
                collectives.append((issued[0], end))
                continue
        collectives.append((start, end))
    # unmatched -start events still count for their own duration
    collectives.extend(pending_start.values())
    if not collectives:
        return None
    collectives = _merge_intervals(collectives)
    compute = _merge_intervals(compute)
    total = sum(e - s for s, e in collectives)
    covered = 0.0
    ci = 0
    for s, e in collectives:
        while ci < len(compute) and compute[ci][1] <= s:
            ci += 1
        cj = ci
        while cj < len(compute) and compute[cj][0] < e:
            covered += min(e, compute[cj][1]) - max(s, compute[cj][0])
            cj += 1
    return {
        "overlap_pct": 100.0 * covered / total,
        "collective_time": total,
        "compute_time": sum(e - s for s, e in compute),
        "overlapped_time": covered,
    }


# --------------------------------------------------------------------- #
# reading torch.profiler traces
# --------------------------------------------------------------------- #
def trace_paths(trace_dir: str) -> list[str]:
    """Every ``*.pt.trace.json`` under ``trace_dir``, sorted."""
    paths = []
    for root, _, files in os.walk(trace_dir):
        paths.extend(os.path.join(root, f) for f in files if f.endswith(TRACE_SUFFIX))
    return sorted(paths)


def trace_events(path: str) -> list[dict]:
    """The complete events (``"ph": "X"``) of one Chrome JSON trace.
    Raises OSError or ValueError on an unreadable file."""
    with open(path) as fh:
        data = json.load(fh)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    return [e for e in events
            if isinstance(e, dict) and e.get("ph") == "X" and isinstance(e.get("dur"), (int, float))
            and isinstance(e.get("ts"), (int, float))]


def is_device_event(event: dict) -> bool:
    return event.get("cat") in DEVICE_CATEGORIES


def self_times(events: Iterable[dict]) -> dict[str, tuple[float, int]]:
    """Self time (microseconds, nested children subtracted) and count by
    event name: ``{name: (self_us, count)}``. Events nest within one
    ``(pid, tid)`` lane (an operator holds the operators it called; a CUDA
    stream's kernels do not nest); within each lane the events are walked
    in ``(start, -end)`` order with a stack of open intervals, and a
    parent's self time is its duration minus its direct children's (the
    reference's ``self_times_from_plane``, :349)."""
    lanes: dict[tuple, list[tuple[float, float, str]]] = {}
    for e in events:
        dur = float(e["dur"])
        if dur <= 0:
            continue
        start = float(e["ts"])
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(
            (start, start + dur, str(e.get("name", ""))))
    totals: dict[str, list] = {}
    for lane in lanes.values():
        lane.sort(key=lambda ev: (ev[0], -ev[1]))
        stack: list[list] = []  # [end, duration, child duration, name]

        def _pop():
            end, dur, child, name = stack.pop()
            slot = totals.setdefault(name, [0.0, 0])
            slot[0] += max(dur - child, 0.0)
            slot[1] += 1
            if stack:
                stack[-1][2] += dur

        for start, end, name in lane:
            while stack and stack[-1][0] <= start:
                _pop()
            stack.append([end, end - start, 0.0, name])
        while stack:
            _pop()
    return {name: (us, n) for name, (us, n) in totals.items()}


def top_self_time_ops(trace_dir: str, k: int = 5) -> Optional[list[dict]]:
    """Best-effort top-``k`` breakdown for one capture directory:
    ``[{"op", "self_time_ms", "count"}]`` by self time, descending, over the
    device events of every trace under ``trace_dir`` (the CUDA kernels,
    copies and fills), falling back to the host events when no trace holds
    device work (a CPU-only run still gives a breakdown). None when nothing
    parses. Never raises."""
    try:
        device_totals: dict[str, list] = {}
        host_totals: dict[str, list] = {}
        for path in trace_paths(trace_dir):
            try:
                events = trace_events(path)
            except (OSError, ValueError) as exc:
                logger.debug(f"skipping unparseable trace {path}: {exc}")
                continue
            for totals, subset in ((device_totals, [e for e in events if is_device_event(e)]),
                                   (host_totals, [e for e in events if not is_device_event(e)])):
                for name, (us, count) in self_times(subset).items():
                    slot = totals.setdefault(name, [0.0, 0])
                    slot[0] += us
                    slot[1] += count
        totals = device_totals or host_totals
        if not totals:
            return None
        ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])
        out = [{"op": name, "self_time_ms": round(us / 1e3, 6), "count": count}
               for name, (us, count) in ranked[: max(k, 0)] if us > 0]
        return out or None
    except Exception as exc:  # diagnostics never take down training
        logger.debug(f"top_self_time_ops({trace_dir}) failed: {exc}")
        return None


def collective_compute_overlap(trace_dir: str) -> Optional[dict[str, Any]]:
    """Best-effort overlap report for one capture directory: for the first
    trace whose device events hold a collective (an NCCL kernel), the
    :func:`overlap_from_spans` report over its device events (times in
    microseconds) plus ``{"source": path, "devices": n}``. None when no
    trace holds a collective, which is always so on one GPU and on the CPU.
    Never raises."""
    try:
        for path in trace_paths(trace_dir):
            try:
                events = trace_events(path)
            except (OSError, ValueError) as exc:
                logger.debug(f"skipping unparseable trace {path}: {exc}")
                continue
            device = [e for e in events if is_device_event(e)]
            spans = [{"name": str(e.get("name", "")), "start": float(e["ts"]),
                      "end": float(e["ts"]) + float(e["dur"])} for e in device]
            report = overlap_from_spans(spans) if spans else None
            if report is not None:
                report["source"] = path
                report["devices"] = len({e.get("pid") for e in device})
                return report
        return None
    except Exception as exc:  # diagnostics never take down training
        logger.debug(f"collective_compute_overlap({trace_dir}) failed: {exc}")
        return None
