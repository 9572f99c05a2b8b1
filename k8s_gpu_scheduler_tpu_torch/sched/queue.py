"""Scheduling queue: active heap + unschedulable backoff (copy of the JAX
package's ``sched/queue.py``).

- active: heap ordered by (−priority, creation time) — FIFO within equal
  priority (priority from the ``tpu.sched/priority`` annotation).
- backoff: unschedulable pods re-enter active after exponential backoff.
- cluster events (node add/update, pod delete) flush backoff early via
  ``move_all_to_active`` so capacity freed now is used now."""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Dict, List, Optional, Tuple

from ..api.objects import Pod
from ..obs import SYSTEM_CLOCK

ANN_PRIORITY = "tpu.sched/priority"


def pod_priority(pod: Pod) -> int:
    try:
        return int(pod.metadata.annotations.get(ANN_PRIORITY, "0"))
    except ValueError:
        return 0


class SchedulingQueue:
    def __init__(self, backoff_initial_s: float = 1.0, backoff_max_s: float = 10.0,
                 clock=None) -> None:
        # Injected time source (obs.Clock): backoff readiness and queue-wait
        # timestamps are DURATION math and ride the monotonic clock; tests
        # can pass a VirtualClock and step backoff deterministically.
        self._clock = clock or SYSTEM_CLOCK
        self._mu = threading.Condition()
        self._heap: List[Tuple[int, float, int, Pod]] = []
        self._queued_uids: Dict[str, int] = {}  # uid -> attempt count
        self._backoff: Dict[str, Tuple[float, Pod]] = {}  # uid -> (ready_at, pod)
        # uid -> first-enqueue monotonic timestamp: the scheduler's
        # sched_queue span measures pod-arrival -> pop from it (survives
        # backoff round-trips — queue wait is e2e, not per-attempt).
        self._enqueued: Dict[str, float] = {}
        self._seq = itertools.count()
        self._backoff_initial = backoff_initial_s
        self._backoff_max = backoff_max_s
        self._closed = False

    # -- producers ---------------------------------------------------------
    def add(self, pod: Pod) -> None:
        """New pending pod (informer on_add)."""
        with self._mu:
            if pod.metadata.uid in self._queued_uids or pod.metadata.uid in self._backoff:
                return
            self._queued_uids[pod.metadata.uid] = 0
            self._enqueued.setdefault(pod.metadata.uid,
                                      self._clock.monotonic())
            self._push_locked(pod)
            self._mu.notify()

    def add_unschedulable(self, pod: Pod) -> None:
        """Failed cycle → backoff pool with exponential delay."""
        with self._mu:
            attempts = self._queued_uids.get(pod.metadata.uid, 0) + 1
            self._queued_uids[pod.metadata.uid] = attempts
            delay = min(self._backoff_initial * (2 ** (attempts - 1)), self._backoff_max)
            self._backoff[pod.metadata.uid] = (
                self._clock.monotonic() + delay, pod)
            self._enqueued.setdefault(pod.metadata.uid,
                                      self._clock.monotonic())
            self._mu.notify()

    def remove(self, pod: Pod) -> None:
        """Pod deleted while queued."""
        with self._mu:
            self._queued_uids.pop(pod.metadata.uid, None)
            self._backoff.pop(pod.metadata.uid, None)
            self._enqueued.pop(pod.metadata.uid, None)
            # lazily dropped from the heap at pop time

    def move_all_to_active(self, _reason: str = "") -> None:
        """Cluster changed — give every backed-off pod another chance now
        (kube-scheduler's MoveAllToActiveOrBackoffQueue)."""
        with self._mu:
            for uid, (_ready, pod) in list(self._backoff.items()):
                del self._backoff[uid]
                self._push_locked(pod)
            self._mu.notify_all()

    def done(self, pod: Pod) -> None:
        """Pod left the scheduling pipeline (bound or abandoned)."""
        with self._mu:
            self._queued_uids.pop(pod.metadata.uid, None)
            self._backoff.pop(pod.metadata.uid, None)
            self._enqueued.pop(pod.metadata.uid, None)

    def enqueued_at(self, uid: str) -> Optional[float]:
        """First-enqueue monotonic timestamp of a still-pipelined pod
        (None once done/removed) — the t0 of the scheduler's queue-wait
        span."""
        with self._mu:
            return self._enqueued.get(uid)

    def close(self) -> None:
        with self._mu:
            self._closed = True
            self._mu.notify_all()

    # -- consumer ----------------------------------------------------------
    def pop(self, timeout: Optional[float] = None) -> Optional[Pod]:
        """Next pod to schedule, honoring backoff readiness; None on timeout
        or close."""
        deadline = None if timeout is None \
            else self._clock.monotonic() + timeout
        with self._mu:
            while True:
                if self._closed:
                    return None
                self._promote_ready_locked()
                while self._heap:
                    _, _, _, pod = heapq.heappop(self._heap)
                    if pod.metadata.uid in self._queued_uids and pod.metadata.uid not in self._backoff:
                        return pod
                    # stale entry (removed or re-backed-off) — skip
                now = self._clock.monotonic()
                if deadline is not None and now >= deadline:
                    return None  # None strictly means timeout or close
                waits = []
                if deadline is not None:
                    waits.append(deadline - now)
                if self._backoff:
                    waits.append(min(r for r, _ in self._backoff.values()) - now)
                wait = min(waits) if waits else None
                if wait is not None and wait <= 0:
                    continue  # a backoff entry became ready — re-promote
                self._mu.wait(timeout=wait)

    def pending_count(self) -> int:
        with self._mu:
            return len(self._queued_uids)

    # -- internals (lock held) --------------------------------------------
    def _push_locked(self, pod: Pod) -> None:
        heapq.heappush(
            self._heap,
            (-pod_priority(pod), pod.metadata.creation_timestamp, next(self._seq), pod),
        )

    def _promote_ready_locked(self) -> None:
        now = self._clock.monotonic()
        for uid, (ready_at, pod) in list(self._backoff.items()):
            if ready_at <= now:
                del self._backoff[uid]
                self._push_locked(pod)

