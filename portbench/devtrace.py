"""Device activity of a traced stretch of a run, from ``torch.profiler``
(CUDA activity only, so the trace stays small): every kernel's, copy's
and memset's name and
interval on the host's monotonic clock, the union of the intervals (the
seconds in which the card ran something), and the idle gaps between them,
each labelled with the innermost host span open at its midpoint."""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Kernel:
    name: str
    t0: float
    t1: float


@dataclass
class DeviceTrace:
    t0: float = 0.0                  # host monotonic seconds
    t1: float = 0.0
    kernels: List[Kernel] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the kernel intervals, clipped to the window."""
        iv = sorted((max(k.t0, self.t0), min(k.t1, self.t1))
                    for k in self.kernels if k.t1 > self.t0
                    and k.t0 < self.t1)
        out: List[Tuple[float, float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def seconds(self, match) -> float:
        """Summed device seconds of the kernels whose name ``match``
        accepts."""
        return sum(k.t1 - k.t0 for k in self.kernels if match(k.name))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            by[k.name[:120]] += k.t1 - k.t0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, spans: List[Tuple[str, float, float]],
                  n: int = 10) -> List[list]:
        """Idle seconds summed by the innermost host span (name, t0, t1)
        open at each gap's midpoint, largest first."""
        gaps, prev = [], self.t0
        for a, b in self.busy_intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        by: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            best: Optional[Tuple[float, str]] = None
            for name, s0, s1 in spans:
                if s0 <= mid <= s1 and (best is None or s1 - s0 < best[0]):
                    best = (s1 - s0, name)
            by[best[1] if best else "outside every span"] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


class Profiler:
    """``start()`` / ``stop()`` around whole steps, each at a point where
    the card has drained (after a synchronise)."""

    def __init__(self) -> None:
        self._prof = None
        self.trace = DeviceTrace()

    @staticmethod
    def warm() -> None:
        """Trace one small operation, so that the profiler's first start
        (seconds, for CUPTI) falls in set-up and not in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(8, device="cuda").sum()
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.trace.t0 = time.monotonic()

    def stop(self) -> DeviceTrace:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.trace.t1 = time.monotonic()
        self._prof.__exit__(None, None, None)
        # Kineto stamps events on the wall clock (ns since the epoch):
        # map them onto the monotonic clock the host spans use.
        offset = time.monotonic() - time.time_ns() / 1e9
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            s = e.start_ns() / 1e9 + offset
            self.trace.kernels.append(Kernel(name, s,
                                             s + e.duration_ns() / 1e9))
        self._prof = None
        return self.trace
