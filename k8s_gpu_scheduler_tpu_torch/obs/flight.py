"""Engine flight recorder of the port (copy of the JAX package's
``obs/flight.py``) — a fixed ring of per-step records.

A span buffer answers "what did request R wait on"; the flight recorder
answers "what was the ENGINE doing" — one compact record per batcher
step (kind, host wall ms, active slots, tokens emitted, accept rate,
pool watermark, admissions/evictions/retires, fault injections), kept in
a fixed-size drop-oldest ring. It is on by default (one dict append per
step) and, unlike the tracer, its contents SURVIVE preemption:
``ContinuousBatcher.drain()`` folds the ring into the ``ServingSnapshot``
and ``restore()`` seeds the fresh engine's ring from it, so a restored
engine — in this package or the JAX one, the wire format is shared —
can explain its pre-preemption behavior.

Records are plain JSON-safe dicts (the snapshot's meta doc carries them
verbatim); ``seq`` is a monotonically increasing step counter that keeps
numbering continuous across drain/restore, and ``t_mono`` is the
recording engine's monotonic clock — meaningful for intra-ring deltas,
not across process boundaries (the restore record marks the seam).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from .trace import Clock, SYSTEM_CLOCK

DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Thread-safe fixed ring of per-step records (drop-oldest)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Clock] = None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.clock = clock or SYSTEM_CLOCK
        self._mu = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._seq = 0
        self._dropped = 0

    def record(self, kind: str, **fields) -> Dict[str, object]:
        """Append one step record; returns it (callers may keep a
        reference for tests). ``fields`` must be JSON-safe — they ride
        the snapshot's meta document unchanged."""
        with self._mu:
            rec = {"seq": self._seq, "kind": kind,
                   "t_mono": self.clock.monotonic(), **fields}
            self._seq += 1
            if len(self._buf) == self.capacity:
                self._dropped += 1
            self._buf.append(rec)
            return rec

    @property
    def dropped(self) -> int:
        with self._mu:
            return self._dropped

    def __len__(self) -> int:
        with self._mu:
            return len(self._buf)

    def records(self, kind: Optional[str] = None) -> List[Dict[str, object]]:
        """Snapshot (oldest first), optionally filtered by step kind."""
        with self._mu:
            out = list(self._buf)
        if kind is not None:
            out = [r for r in out if r["kind"] == kind]
        return out

    # -- snapshot codec ----------------------------------------------------
    def to_payload(self) -> List[Dict[str, object]]:
        """JSON-safe dump for ``ServingSnapshot`` (oldest first)."""
        with self._mu:
            return [dict(r) for r in self._buf]

    def seed(self, payload: List[Dict[str, object]]) -> None:
        """Refill from a snapshot payload (restore path): the restored
        ring keeps the drained engine's records — trimmed to this ring's
        capacity, newest kept — and continues ``seq`` past them so the
        combined timeline stays ordered."""
        with self._mu:
            self._buf.clear()
            for rec in payload[-self.capacity:]:
                self._buf.append(dict(rec))
            if self._buf:
                self._seq = max(self._seq,
                                int(self._buf[-1]["seq"]) + 1)
