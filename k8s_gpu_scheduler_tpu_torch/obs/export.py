"""Exporters of the port (copy of the JAX package's ``obs/export.py``):
Chrome-trace/Perfetto JSON.

``to_perfetto`` renders a span list as the Chrome Trace Event format
(the JSON flavor Perfetto's UI and ``chrome://tracing`` both load): one
process group for the serving engine with a thread row per slot lane,
one process group for the control plane with a row per component lane,
complete "X" events with microsecond timestamps rebased to the earliest
span, span attrs (and the rid correlation key) in ``args``. The format
is plain JSON — no SDK, no protobuf dependency.

``validate_perfetto`` is the structural schema check: a trace that
silently drops required keys loads as an empty timeline in the UI,
which is exactly the kind of bitrot a loader-side check catches the day
it happens.

The Prometheus side lives in ``metrics/exporter.py`` (the
``tpu_serve_phase_duration_seconds{phase=...}`` histogram fed from
``ContinuousBatcher.pool_metrics()``'s atomic phase drain); this module
only owns the span-shaped exports.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence, Tuple

from .trace import Span

# The request-lifecycle phase taxonomy (the JAX package's, name for name).
# The engine adds shed, absorb, page_shortage and, tiered, demote and
# promote; "handoff" is the one router-lane member (the fleet tier).
PHASES = ("queue", "admit", "prefill", "prefill_chunk", "decode_chunk",
          "verify", "rewind", "reap", "drain", "restore", "handoff")

_ENGINE_PID = 1
_CONTROL_PID = 2


def _lane_ids(lanes: Iterable[str]) -> Dict[str, Tuple[int, int]]:
    """lane name -> (pid, tid): engine lanes (``engine``, ``slot*``)
    group under one process so slot rows sit together; everything else
    (sched, queue, registry, ...) is a control-plane row."""
    ids: Dict[str, Tuple[int, int]] = {}
    next_tid = {_ENGINE_PID: 1, _CONTROL_PID: 1}
    for lane in sorted(set(lanes)):
        pid = _ENGINE_PID if (lane == "engine" or lane.startswith("slot")) \
            else _CONTROL_PID
        ids[lane] = (pid, next_tid[pid])
        next_tid[pid] += 1
    return ids


def to_perfetto(spans: Sequence[Span]) -> Dict[str, object]:
    """Chrome Trace Event JSON document for ``spans`` (any order).
    Timestamps rebase to the earliest t0 so the trace starts at 0 µs
    regardless of the monotonic clock's epoch."""
    spans = list(spans)
    base = min((s.t0 for s in spans), default=0.0)
    ids = _lane_ids(s.lane for s in spans)
    events: List[Dict[str, object]] = [
        {"name": "process_name", "ph": "M", "pid": _ENGINE_PID, "tid": 0,
         "args": {"name": "serving-engine"}},
        {"name": "process_name", "ph": "M", "pid": _CONTROL_PID, "tid": 0,
         "args": {"name": "control-plane"}},
    ]
    for lane, (pid, tid) in sorted(ids.items()):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": lane}})
    for s in sorted(spans, key=lambda s: (s.t0, s.t1)):
        pid, tid = ids[s.lane]
        args: Dict[str, object] = dict(s.attrs)
        if s.rid is not None:
            args["rid"] = s.rid
        events.append({
            "name": s.name,
            "cat": "phase",
            "ph": "X",
            "ts": round((s.t0 - base) * 1e6, 3),
            "dur": round(max(0.0, s.t1 - s.t0) * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_perfetto(doc: object) -> List[str]:
    """Structural schema check; returns the list of problems (empty =
    loads cleanly). Checked: top-level shape, per-event required keys
    and types, non-negative rebased timestamps/durations, and that
    every complete event's (pid, tid) has a thread_name row — a lane
    without one renders as an anonymous track, which usually means the
    exporter and the recorder disagree about lanes."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents must be a non-empty list"]
    named_lanes = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "I"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"event {i}: {key} must be an int")
        if ph == "M":
            if ev.get("name") == "thread_name":
                named_lanes.add((ev.get("pid"), ev.get("tid")))
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: ts must be a number >= 0")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: dur must be a number >= 0")
    for i, ev in enumerate(events):
        if isinstance(ev, dict) and ev.get("ph") == "X" \
                and (ev.get("pid"), ev.get("tid")) not in named_lanes:
            problems.append(
                f"event {i}: lane (pid={ev.get('pid')}, "
                f"tid={ev.get('tid')}) has no thread_name metadata")
    return problems


def write_perfetto(spans: Sequence[Span], path: str) -> Dict[str, object]:
    """Export + write; returns the document (callers usually also
    ``validate_perfetto`` it)."""
    doc = to_perfetto(spans)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return doc
