"""Leader election over a coordination Lease — scheduler HA (copy of the
JAX package's ``sched/leaderelection.py``, client-go's algorithm on the
APIServer interface):

- one Lease object names the scheduler; the holder renews every
  ``renew_period_s`` (default duration/3);
- challengers retry every ``retry_period_s``; they steal the lease only
  when ``renew_time + lease_duration_s`` has passed (the previous holder
  crashed or lost connectivity);
- acquisition and steal are compare-and-swap through
  ``APIServer.update(expect_rv=...)`` — two challengers race, one gets
  Conflict and backs off;
- the holder drops leadership locally when it has failed to renew for
  ``renew_deadline_s`` (its clock, no quorum needed), strictly before a
  challenger can steal.

The Scheduler gates its cycle loop on ``is_leader()`` (standby replicas
keep informers warm, like kube-scheduler), so two replicas fail over in
about ``lease_duration_s``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..api.objects import Lease, ObjectMeta
from ..cluster.apiserver import AlreadyExists, Conflict, NotFound

log = logging.getLogger(__name__)


class LeaderElector:
    def __init__(
        self,
        server,
        identity: str,
        name: str = "tpu-scheduler",
        namespace: str = "default",
        lease_duration_s: float = 15.0,
        renew_period_s: Optional[float] = None,
        retry_period_s: Optional[float] = None,
        renew_deadline_s: Optional[float] = None,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.server = server
        self.identity = identity
        self.name = name
        self.namespace = namespace
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s or lease_duration_s / 3.0
        self.retry_period_s = retry_period_s or lease_duration_s / 5.0
        # client-go's renewDeadline: the holder considers itself demoted
        # STRICTLY BEFORE a challenger can steal (which needs the full
        # lease_duration past the last server renew). The margin is what
        # lets an in-flight scheduling cycle on the old leader finish
        # before the new leader's term starts — with a single threshold,
        # demotion and steal are simultaneous and the terms can overlap
        # (found by the chaos failover test).
        self.renew_deadline_s = renew_deadline_s or 0.8 * lease_duration_s
        if self.renew_deadline_s >= lease_duration_s:
            # client-go errors on this exact misconfiguration: a deadline
            # at or past the lease duration voids the margin and reopens
            # the double-leadership window the margin exists to close.
            raise ValueError(
                f"renew_deadline_s ({self.renew_deadline_s}) must be < "
                f"lease_duration_s ({lease_duration_s})")
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.clock = clock
        self._leading = threading.Event()
        self._last_renew = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- public ------------------------------------------------------------
    def is_leader(self) -> bool:
        """Leading AND the last successful renew is inside the renew
        deadline — a partitioned leader demotes itself strictly before
        anyone can steal the lease (steal needs the FULL duration)."""
        return (self._leading.is_set()
                and self.clock() - self._last_renew < self.renew_deadline_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"leader-elector-{self.identity}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop electing; release the lease if held so a standby can take
        over immediately instead of waiting out the duration."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._leading.is_set():
            self._demote()
            try:
                lease = self.server.get("Lease", self.name, self.namespace)
                if lease.holder_identity == self.identity:
                    lease.holder_identity = ""
                    self.server.update(
                        lease, expect_rv=lease.metadata.resource_version)
            except Exception:  # noqa: BLE001 — best-effort release
                pass

    def wait_until_leader(self, timeout: float) -> bool:
        deadline = self.clock() + timeout
        while self.clock() < deadline:
            if self.is_leader():
                return True
            time.sleep(0.02)
        return False

    # -- loop --------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            if self._try_acquire_or_renew():
                if not self._leading.is_set():
                    log.info("%s became leader of %s/%s", self.identity,
                             self.namespace, self.name)
                    self._leading.set()
                    if self.on_started_leading:
                        self.on_started_leading()
                self._stop.wait(self.renew_period_s)
            else:
                was = self._leading.is_set()
                if was and self.clock() - self._last_renew >= self.renew_deadline_s:
                    self._demote()
                self._stop.wait(self.retry_period_s)

    def _demote(self) -> None:
        if self._leading.is_set():
            log.warning("%s lost leadership of %s/%s", self.identity,
                        self.namespace, self.name)
            self._leading.clear()
            if self.on_stopped_leading:
                self.on_stopped_leading()

    def _try_acquire_or_renew(self) -> bool:
        now = self.clock()
        try:
            lease = self.server.get("Lease", self.name, self.namespace)
        except NotFound:
            return self._create_fresh(now)
        except Exception as e:  # noqa: BLE001 — transport flap, not fatal
            # A dropped connection to the lease store must NOT kill the
            # elector thread (found by the chaos harness: an injected
            # registry flap permanently disabled election for the
            # replica). Treat it like any failed renew: the retry loop
            # keeps trying, and a holder that stays partitioned demotes
            # itself via the staleness check in _run/is_leader.
            log.warning("lease read failed: %s", e)
            return False
        return self._renew_or_steal(lease, now)

    def _create_fresh(self, now: float) -> bool:
        try:
            self.server.create(Lease(
                metadata=ObjectMeta(name=self.name,
                                    namespace=self.namespace),
                holder_identity=self.identity,
                lease_duration_s=self.lease_duration_s,
                acquire_time=now, renew_time=now, lease_transitions=0,
            ))
            self._last_renew = now
            return True
        except AlreadyExists:
            return False
        except Exception as e:  # noqa: BLE001
            log.warning("lease create failed: %s", e)
            return False

    def _renew_or_steal(self, lease, now: float) -> bool:
        if lease.holder_identity == self.identity:
            lease.renew_time = now
            lease.lease_duration_s = self.lease_duration_s
        elif lease.expired(now):
            lease.holder_identity = self.identity
            lease.acquire_time = now
            lease.renew_time = now
            lease.lease_duration_s = self.lease_duration_s
            lease.lease_transitions += 1
        else:
            return False
        try:
            self.server.update(
                lease, expect_rv=lease.metadata.resource_version)
            self._last_renew = now
            return True
        except (Conflict, NotFound):
            return False
        except Exception as e:  # noqa: BLE001
            log.warning("lease update failed: %s", e)
            return False
