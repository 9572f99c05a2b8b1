"""Span API of the port (copy of the JAX package's ``obs/trace.py``):
injected clocks, bounded buffers, never block the hot path.

Design constraints, in order:

1. **Cheap when off.** Everything that instruments a hot path guards
   with ``tracer is None`` (or ``tracer.enabled``); a disabled tracer's
   ``span()`` returns one shared no-op context manager — no allocation,
   no clock read.
2. **Never block, never grow.** The buffer is a fixed-capacity ring
   with drop-oldest semantics: an append under load evicts the oldest
   span and counts it in ``dropped`` instead of stalling the step loop
   or leaking memory. The lock is held for one deque append.
3. **Monotonic time only.** Spans are measured on ``Clock.monotonic()``
   — wall clocks jump (NTP, suspend) and a duration measured on one is
   a latent bug. ``Clock.wall()`` exists for *timestamps that leave the
   process* (snapshot downtime accounting), never for durations.
4. **Injectable time.** Production uses :data:`SYSTEM_CLOCK`; chaos and
   trace tests inject :class:`VirtualClock` and advance it by hand, so
   timing-dependent assertions are exact instead of sleep-and-hope.

Spans are flat records (name, t0, t1, lane, rid, thread id, attrs) —
nesting is positional: two spans on the same lane whose intervals nest
render nested in Perfetto, which is all the structure the timeline
views need. ``rid`` is the cross-plane correlation key: the serving
engine tags its spans with the request's trace id, and a caller that
uses one string across planes gets a single correlated timeline.

On the port's engine a span brackets host work: a dispatch span ends
when its kernels are enqueued, not when the card has run them (nothing
in a step synchronises with the card but the token read-backs).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional


class Clock:
    """Injectable time source. ``monotonic()`` is for durations and
    ordering; ``wall()`` is for timestamps that cross process/host
    boundaries. Subclasses override both."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def wall(self) -> float:
        raise NotImplementedError


class SystemClock(Clock):
    """The real clocks: ``time.monotonic`` / ``time.time``."""

    def monotonic(self) -> float:
        return time.monotonic()

    def wall(self) -> float:
        return time.time()


class VirtualClock(Clock):
    """Hand-advanced time for tests: ``advance(dt)`` moves both clocks
    forward together (a virtual wall clock can additionally ``jump`` —
    the NTP-step scenario duration code must be immune to)."""

    def __init__(self, mono: float = 1000.0, wall: float = 1.7e9) -> None:
        self._mono = float(mono)
        self._wall = float(wall)
        self._mu = threading.Lock()

    def monotonic(self) -> float:
        with self._mu:
            return self._mono

    def wall(self) -> float:
        with self._mu:
            return self._wall

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("monotonic time cannot go backward")
        with self._mu:
            self._mono += dt
            self._wall += dt

    def jump_wall(self, dt: float) -> None:
        """Step ONLY the wall clock (either direction) — the clock-jump
        scenario that distinguishes duration code on the right clock
        from duration code that merely worked so far."""
        with self._mu:
            self._wall += dt


SYSTEM_CLOCK = SystemClock()


@dataclass(frozen=True)
class Span:
    """One closed interval on one lane. ``t0``/``t1`` are
    ``Clock.monotonic()`` readings from the owning tracer's clock."""

    name: str                        # phase: queue|admit|prefill|...
    #                                  (tiered engines add demote|promote)
    t0: float
    t1: float
    lane: str = "host"               # Perfetto row: slot3, sched, ...
    rid: Optional[str] = None        # cross-plane correlation key
    tid: int = 0                     # host thread ident
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe bounded span collector.

    ``record()`` / ``event()`` append; ``span()`` is the context-manager
    form for synchronous blocks. The buffer drops OLDEST on overflow
    (``dropped`` counts evictions) — a tracer left on forever costs a
    fixed amount of memory and the most recent window of spans, which is
    the window an incident investigation wants anyway.
    """

    def __init__(self, capacity: int = 16384,
                 clock: Optional[Clock] = None,
                 enabled: bool = True) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock or SYSTEM_CLOCK
        self.capacity = capacity
        self.enabled = bool(enabled)
        self._mu = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._dropped = 0

    # -- write side --------------------------------------------------------
    def record(self, name: str, t0: float, t1: float, lane: str = "host",
               rid: Optional[str] = None, **attrs) -> None:
        """Append a closed span with explicit endpoints (for phases whose
        start and end live on different code paths — queue wait is
        recorded at admission with t0 = the submit-time clock reading)."""
        if not self.enabled:
            return
        span = Span(name, t0, t1, lane, rid, threading.get_ident(), attrs)
        with self._mu:
            if len(self._buf) == self.capacity:
                self._dropped += 1
            self._buf.append(span)

    def event(self, name: str, lane: str = "host",
              rid: Optional[str] = None, **attrs) -> None:
        """Zero-duration marker (rewinds, page-shortage stalls, fault
        injections)."""
        now = self.clock.monotonic()
        self.record(name, now, now, lane, rid, **attrs)

    @contextlib.contextmanager
    def _span_cm(self, name: str, lane: str, rid: Optional[str],
                 attrs: Dict[str, object]) -> Iterator[Dict[str, object]]:
        t0 = self.clock.monotonic()
        try:
            # The yielded dict lets the body attach result attrs
            # (tokens emitted, accept rate) before the span closes.
            yield attrs
        finally:
            self.record(name, t0, self.clock.monotonic(), lane, rid,
                        **attrs)

    def span(self, name: str, lane: str = "host",
             rid: Optional[str] = None, **attrs):
        """``with tracer.span("decode_chunk", lane="engine") as a: ...`` —
        times the block on the tracer's monotonic clock. Disabled tracers
        return a shared no-op (no clock read, no allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return self._span_cm(name, lane, rid, dict(attrs))

    # -- read side ---------------------------------------------------------
    @property
    def dropped(self) -> int:
        with self._mu:
            return self._dropped

    def __len__(self) -> int:
        with self._mu:
            return len(self._buf)

    def spans(self, rid: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        """Snapshot of the buffer (oldest first), optionally filtered by
        correlation id and/or phase name."""
        with self._mu:
            out = list(self._buf)
        if rid is not None:
            out = [s for s in out if s.rid == rid]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        with self._mu:
            self._buf.clear()
            self._dropped = 0
