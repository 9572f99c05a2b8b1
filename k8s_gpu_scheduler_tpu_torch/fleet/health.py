"""Replica health states — the crash-tolerance substrate of the fleet
(copy of the JAX package's ``fleet/health.py``).

Drain and shed assume a replica that cooperates; this module is the
non-cooperative half, a per-replica state machine

    live → suspect → dead → quarantined → rejoining → live

driven by three independent signals:

- **step exceptions**: ``Router.step()`` isolates each replica's raise and
  reports it here; consecutive-failure thresholds decide suspect (no new
  requests) and dead (failover of its in-flight requests by journal
  replay). A hard ``ReplicaCrashed`` goes straight to dead.
- **summary-heartbeat staleness**: a replica whose summary has not landed
  in the store for ``stale_s`` is suspect, for ``dead_s`` dead. The router
  applies this only while the summary plane itself is alive (some replica
  published fresh): a dead store degrades routing, it kills no replica.
- **engine watchdog**: ``pool_metrics()``'s ``last_step_age_seconds`` (0
  when idle) crossing ``watchdog_s`` with work pending means a wedged
  engine.

Dead replicas enter a circuit-breaker quarantine: the k-th death costs a
jittered exponential hold (``utils/retry.RetryPolicy``, jitter from a
seeded RNG so chaos runs replay), and the policy's ``attempts`` bound
latches a flapping replica in quarantine. After the hold the replica is
rejoining: the router rebuilds its engine (``models/lifecycle.py``
``resume_or_fresh``) and a successful probe returns it to live.

The monitor is host-side bookkeeping driven by an injected clock, never
touches an engine, and records every transition.
"""
from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Tuple

from ..utils.retry import RetryPolicy

LIVE = "live"
SUSPECT = "suspect"
DEAD = "dead"
QUARANTINED = "quarantined"
REJOINING = "rejoining"
STATES = (LIVE, SUSPECT, DEAD, QUARANTINED, REJOINING)

# Default quarantine ladder: 0.2 s, 0.4 s, 0.8 s ... capped at 5 s,
# ±50% jitter, at most 8 rejoin attempts before the breaker latches
# open (the replica stays quarantined until an operator intervenes).
DEFAULT_QUARANTINE = RetryPolicy(attempts=8, base_s=0.2, multiplier=2.0,
                                 max_s=5.0, jitter=0.5)


@dataclass(frozen=True)
class HealthPolicy:
    """Thresholds for the state machine. ``dead_s`` must exceed
    ``stale_s``: staleness that merely degrades routing (the
    round-robin fallback) must trip long before staleness that declares
    a replica dead and replays its requests elsewhere — a replay races
    the original replica only if the two thresholds invert."""

    suspect_after: int = 1       # consecutive step errors → suspect
    dead_after: int = 3          # consecutive step errors → dead
    stale_s: float = 5.0         # heartbeat age → suspect
    dead_s: float = 15.0         # heartbeat age → dead (> stale_s)
    watchdog_s: float = 30.0     # engine last_step_age → dead (wedged)
    quarantine: RetryPolicy = field(default_factory=lambda: DEFAULT_QUARANTINE)

    def __post_init__(self) -> None:
        if self.dead_s <= self.stale_s:
            raise ValueError(
                f"dead_s ({self.dead_s}) must exceed stale_s "
                f"({self.stale_s}): a replica must degrade to stale "
                f"routing before it is declared dead")
        if self.dead_after < self.suspect_after:
            raise ValueError(
                f"dead_after ({self.dead_after}) must be >= "
                f"suspect_after ({self.suspect_after})")
        if self.suspect_after < 1:
            raise ValueError("suspect_after must be >= 1")


@dataclass
class ReplicaHealth:
    """One replica's mutable health record."""

    state: str = LIVE
    consecutive_errors: int = 0
    deaths: int = 0                      # quarantine backoff exponent
    quarantined_until: float = 0.0       # monotonic; inf = breaker open
    last_error: str = ""
    since: float = 0.0                   # monotonic time of last transition


class HealthMonitor:
    """Tracks N replicas' states; every mutation returns the transition
    it caused (``(old, new)`` or ``None``) so the caller can act —
    failover on ``* → dead``, re-enter rotation on ``rejoining → live``.
    Deterministic given the clock and the seed (jittered quarantine
    draws come from one seeded RNG consumed in event order)."""

    def __init__(self, policy: Optional[HealthPolicy] = None,
                 seed: int = 0) -> None:
        self.policy = policy or HealthPolicy()
        self._rng = random.Random(seed)
        self._replicas: Dict[str, ReplicaHealth] = {}
        self._transitions = 0
        # Transition log: (monotonic, replica, old, new, reason) — what
        # the chaos determinism gate compares (minus the clock column).
        # Bounded drop-oldest: a long-lived router's health history must
        # not be a slow leak; the counter above stays exact.
        self.events: Deque[Tuple[float, str, str, str, str]] = \
            deque(maxlen=512)

    # -- registration / reads ---------------------------------------------
    def add(self, replica_id: str, now: float = 0.0) -> None:
        self._replicas[replica_id] = ReplicaHealth(since=now)

    def get(self, replica_id: str) -> ReplicaHealth:
        return self._replicas[replica_id]

    def state(self, replica_id: str) -> str:
        return self._replicas[replica_id].state

    def routable(self, replica_id: str) -> bool:
        """May receive NEW requests (suspect replicas keep serving what
        they hold but stop accruing blast radius)."""
        return self._replicas[replica_id].state == LIVE

    def serving(self, replica_id: str) -> bool:
        """Should still be stepped (holds live work)."""
        return self._replicas[replica_id].state in (LIVE, SUSPECT)

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in STATES}
        for h in self._replicas.values():
            out[h.state] += 1
        return out

    @property
    def transition_count(self) -> int:
        return self._transitions

    # -- transitions -------------------------------------------------------
    def _move(self, rid: str, new: str, reason: str,
              now: float) -> Optional[Tuple[str, str]]:
        h = self._replicas[rid]
        old = h.state
        if old == new:
            return None
        h.state = new
        h.since = now
        self._transitions += 1
        self.events.append((now, rid, old, new, reason))
        return (old, new)

    def note_ok(self, rid: str, now: float) -> Optional[Tuple[str, str]]:
        """A successful step: clears the error run; a replica suspected
        FOR step errors redeems itself (live again). A heartbeat-stale
        suspect stays suspect — stepping fine says nothing about its
        summary reaching the store, and redeeming it here would flap
        suspect↔live every step while the staleness persists
        (``observe`` redeems it when the heartbeat is fresh again)."""
        h = self._replicas[rid]
        error_driven = h.consecutive_errors > 0
        h.consecutive_errors = 0
        if h.state == SUSPECT and error_driven:
            return self._move(rid, LIVE, "step ok", now)
        return None

    def note_error(self, rid: str, exc: BaseException,
                   now: float) -> Optional[Tuple[str, str]]:
        """A step exception (isolated by the router): escalate along the
        consecutive-failure ladder."""
        h = self._replicas[rid]
        h.consecutive_errors += 1
        h.last_error = f"{type(exc).__name__}: {exc}"
        if h.consecutive_errors >= self.policy.dead_after:
            return self._move(
                rid, DEAD,
                f"{h.consecutive_errors} consecutive step errors "
                f"({h.last_error})", now)
        if h.consecutive_errors >= self.policy.suspect_after:
            return self._move(rid, SUSPECT, h.last_error, now)
        return None

    def declare_dead(self, rid: str, reason: str,
                     now: float) -> Optional[Tuple[str, str]]:
        """Conclusive death (hard crash, watchdog, heartbeat dead_s):
        no ladder — the evidence is terminal."""
        h = self._replicas[rid]
        h.last_error = reason
        return self._move(rid, DEAD, reason, now)

    def observe(self, rid: str, now: float,
                heartbeat_age_s: Optional[float] = None,
                last_step_age_s: Optional[float] = None,
                ) -> Optional[Tuple[str, str]]:
        """Passive-signal check for a live/suspect replica: heartbeat
        staleness and the engine watchdog. Caller is responsible for the
        summary-plane liveness guard (don't indict replicas for a dead
        store)."""
        h = self._replicas[rid]
        if h.state not in (LIVE, SUSPECT):
            return None
        if last_step_age_s is not None \
                and last_step_age_s > self.policy.watchdog_s:
            return self._move(
                rid, DEAD,
                f"engine wedged: last step {last_step_age_s:.1f}s ago "
                f"(watchdog {self.policy.watchdog_s:.1f}s)", now)
        if heartbeat_age_s is not None:
            if heartbeat_age_s > self.policy.dead_s:
                return self._move(
                    rid, DEAD,
                    f"heartbeat {heartbeat_age_s:.1f}s stale "
                    f"(dead_s {self.policy.dead_s:.1f}s)", now)
            if heartbeat_age_s > self.policy.stale_s and h.state == LIVE:
                return self._move(
                    rid, SUSPECT,
                    f"heartbeat {heartbeat_age_s:.1f}s stale", now)
            if heartbeat_age_s <= self.policy.stale_s \
                    and h.state == SUSPECT \
                    and h.consecutive_errors == 0:
                # Heartbeat-driven suspicion lifts when the heartbeat is
                # fresh again (error-driven suspicion lifts in note_ok).
                return self._move(rid, LIVE, "heartbeat fresh", now)
        return None

    # -- circuit breaker ---------------------------------------------------
    def quarantine(self, rid: str, now: float) -> Optional[Tuple[str, str]]:
        """Dead → quarantined for the next jittered-backoff hold; past
        the policy's attempt bound the breaker latches open (hold =
        inf): a replica that keeps dying right after rejoining must stop
        costing the fleet failovers."""
        h = self._replicas[rid]
        h.deaths += 1
        h.consecutive_errors = 0
        if h.deaths >= self.policy.quarantine.attempts:
            h.quarantined_until = float("inf")
            return self._move(
                rid, QUARANTINED,
                f"breaker open after {h.deaths} deaths", now)
        hold = self.policy.quarantine.backoff_s(h.deaths, rng=self._rng)
        h.quarantined_until = now + hold
        return self._move(rid, QUARANTINED, f"hold {hold:.3f}s", now)

    def due_for_rejoin(self, rid: str, now: float) -> bool:
        h = self._replicas[rid]
        return h.state == QUARANTINED and now >= h.quarantined_until

    def start_rejoin(self, rid: str, now: float) -> Optional[Tuple[str, str]]:
        return self._move(rid, REJOINING, "quarantine expired", now)

    def rejoined(self, rid: str, now: float) -> Optional[Tuple[str, str]]:
        """Fresh engine built and probed: back in rotation. ``deaths``
        is deliberately NOT reset — a flapper's next quarantine is
        longer, which is the whole point of the breaker."""
        h = self._replicas[rid]
        h.consecutive_errors = 0
        return self._move(rid, LIVE, "rejoined", now)

    def rejoin_failed(self, rid: str, exc: BaseException,
                      now: float) -> Optional[Tuple[str, str]]:
        """Engine rebuild failed: back to quarantine on the next rung."""
        h = self._replicas[rid]
        h.last_error = f"{type(exc).__name__}: {exc}"
        self._move(rid, DEAD, f"rejoin failed: {h.last_error}", now)
        return self.quarantine(rid, now)
