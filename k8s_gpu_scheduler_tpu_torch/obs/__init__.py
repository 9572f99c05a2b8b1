"""obs — request-lifecycle tracing and the engine flight recorder of the
port (copies of the JAX package's ``obs/`` modules; the wire format of
the flight ring and the Perfetto documents are the same).

- :mod:`~.trace` — the span API: an injectable :class:`Clock` (so chaos
  and trace tests run on virtual time), :class:`Tracer` with a
  thread-safe bounded drop-oldest buffer, ``span()`` context managers and
  explicit ``record()``/``event()`` for phases whose endpoints live on
  different host paths (queue wait: submit → admission).
- :mod:`~.flight` — the engine flight recorder: a fixed-size ring of
  per-step records that rides into ``ServingSnapshot``.
- :mod:`~.export` — Chrome-trace/Perfetto JSON export (one lane per
  engine slot) and its schema check; the phase durations fold into the
  ``tpu_serve_phase_duration_seconds`` histogram in
  ``metrics/exporter.py``.

Tracing is off by default: engines take ``tracer=None`` (one ``is None``
check per phase). Span calls are host-side and read no device value.
"""
from .trace import (
    Clock, Span, SystemClock, Tracer, VirtualClock, SYSTEM_CLOCK,
)
from .flight import FlightRecorder
from .export import (
    PHASES, to_perfetto, validate_perfetto, write_perfetto,
)

__all__ = [
    "Clock",
    "SystemClock",
    "VirtualClock",
    "SYSTEM_CLOCK",
    "Span",
    "Tracer",
    "FlightRecorder",
    "PHASES",
    "to_perfetto",
    "validate_perfetto",
    "write_perfetto",
]
