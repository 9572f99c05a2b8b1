"""Cache-aware fleet router — N serving replicas behind one admission
point, crash-tolerant (copy of the JAX package's ``fleet/router.py``).

The ``Router`` fronts N in-process paged engine replicas and places each
request by cache-aware load balancing: every replica publishes a
:class:`~.summary.ReplicaSummary` (radix digest, pool watermarks,
per-phase p50s) to the store, and admission scores

    score(replica) = (1 + resident_match
                          + DEMOTED_MATCH_DISCOUNT × demoted_match)
                     × (eps + free_page_frac)
                     × (eps + free_slot_frac)
                     × 1 / (1 + decode_p50 / p50_ref)
                     × 1 / (1 + prefill_backlog / backlog_ref)

taking the argmax with a deterministic tiebreak (the lowest replica id:
same summaries, same placement). The match term sends shared system
prompts to the replica that already holds their KV; demoted-match tokens
(pages in the host tier) count at ``DEMOTED_MATCH_DISCOUNT``; the load
terms keep a cold cache from losing every request to a hot one; the
latency and backlog terms weigh decode and prefill pressure apart. With
stale summaries routing degrades to deterministic round-robin.

Load shedding: ``shed()`` takes a partial ``ServingSnapshot`` off a hot
replica (``drain(slots=...)``) and ``absorb()``s it into a cold one,
token-identically, re-pointing the fleet request ids through the
returned rid mapping.

Crash tolerance rests on three pieces:

- a **health monitor** (``fleet/health.py``): live → suspect → dead →
  quarantined → rejoining, driven by isolated step exceptions, heartbeat
  staleness and the engine watchdog, with a jittered-backoff quarantine
  and rejoin through ``models/lifecycle.resume_or_fresh`` and an
  ``engine_factory``;
- a **request journal** (``fleet/journal.py``): ``submit()`` records the
  request and every ``step()`` appends each in-flight request's delivered
  tokens (``ContinuousBatcher.emitted``); ``checkpoint_journal()``
  persists it and a restarted router recovers it;
- **failover by deterministic replay**: a dead replica's engine is
  discarded and every journaled in-flight request is re-submitted to a
  survivor with ``prompt + delivered`` (less a ``replay_verify_tokens``
  window) as its prompt. Greedy decode is deterministic, so the
  regenerated window must equal the journal (a divergence fails the
  request loudly) and only the undelivered suffix streams: the stream is
  identical to a no-fault run. Re-decoded tokens per failover are at
  most the journaled delivered tokens.

Per-request deadlines (``submit(deadline_s=)``) are enforced between
steps: an expired request is cancelled on its engine
(``ContinuousBatcher.cancel``), recorded in ``Router.errors`` and closed
in the journal. ``run()`` is bounded by a no-progress watchdog.

Disaggregated pools (``pools=``): new requests land on role="prefill"
replicas, and ``step()`` hands each completed prefill to the decode pool
by partial drain and absorb (``handoff``).

Threading: the router is a single-threaded driver of all N engines; the
concurrent surface is the store, whose client is thread-safe and
retry-bounded on its own. Nothing synchronises the card inside ``step``
beyond each engine's own reads (``emitted`` after its step).

``publish`` exports the process's serving downgrades as
``tpu_serve_decode_fallback_total`` as the JAX router does; in the port
the one reason is ``weights_replicated``.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..metrics.exporter import (
    FLEET_AFFINITY_HITS_TOTAL, FLEET_COUNTERS, FLEET_EXPIRED_TOTAL,
    FLEET_FAILOVERS_TOTAL, FLEET_GAUGES, FLEET_HANDOFF_DURATION,
    FLEET_HANDOFFS_TOTAL, FLEET_HISTOGRAMS, FLEET_JOURNAL_SIZE,
    FLEET_LOST_TOTAL, FLEET_MIGRATED_TOTAL, FLEET_REPLAYED_TOKENS_TOTAL,
    FLEET_REPLICA_ROLE, FLEET_REPLICA_STATE, FLEET_ROUTED_TOTAL,
    FLEET_SHED_TOTAL, export_decode_fallbacks, export_serving_pool,
)
from ..models.lifecycle import (
    load_journal, persist_journal, resume_or_fresh,
)
from ..models.snapshot import SnapshotError, check_fingerprint
from ..obs import SYSTEM_CLOCK
from ..testing.faults import InjectedFault, ReplicaCrashed
from .health import (
    DEAD, HealthMonitor, HealthPolicy, LIVE, QUARANTINED, REJOINING,
    STATES, SUSPECT,
)
from .journal import DONE, ERROR, EXPIRED, JournalError, RequestJournal
from .pools import PoolPlan, PoolPolicy, plan_pools
from .summary import (
    MemoryStore, ReplicaSummary, list_summaries, prefix_match_parts,
    publish_summary, summarize,
)

# Phases feeding the routing p50s (the names _obs_span records).
_DECODE_PHASES = ("decode_chunk", "verify")
_PREFILL_PHASES = ("prefill", "prefill_chunk")

# A demoted-path match is worth this fraction of a resident one: the
# pages exist (no prefill compute) but pay a DRAM→HBM promotion upload
# at admission. Strictly in (0, 1), so for the same digest path a
# resident replica always outscores a demoted one, and a demoted one
# always outscores a cold miss.
DEMOTED_MATCH_DISCOUNT = 0.5


class FleetError(RuntimeError):
    """Fleet-level misuse or impossible operation (unknown replica,
    shed without capacity, heterogeneous fleet, no-progress watchdog)."""


def _p50(window) -> float:
    if not window:
        return 0.0
    xs = sorted(window)
    return xs[len(xs) // 2]


class _Replica:
    """Router-side state for one engine: identity, publish seq, the
    rolling phase-duration windows the summary p50s are computed from
    (fed by the same ``pool_metrics()`` phase batch the Prometheus
    export consumes — drained once, used twice), and the health inputs
    captured at publish time (heartbeat wall, watchdog age). ``engine``
    is None while the replica is dead/quarantined — a hard crash
    DISCARDS the object (no drain); rejoin installs a fresh one."""

    def __init__(self, replica_id: str, engine) -> None:
        self.id = replica_id
        self.engine = engine
        self.seq = 0
        self.decode_window: deque = deque(maxlen=256)
        self.prefill_window: deque = deque(maxlen=64)
        self.last_publish_wall = float("-inf")   # heartbeat (store ack'd)
        self.last_step_age = 0.0                 # watchdog (from publish)


class Router:
    """Admission front for N in-process paged engine replicas.

    ``replicas`` is a sequence of ``(id, ContinuousBatcher)`` pairs (ids
    unique; engines paged with one shared page_size — scoring compares
    page-aligned match lengths across them). ``store`` is the summary
    plane: any object with the registry client's get/set/get_keys
    (+mget) subset — defaults to an in-process :class:`MemoryStore`;
    pass the real registry ``Client`` to share summaries across
    processes. ``policy`` is ``"affinity"`` (cache-aware scoring, the
    point of this module) or ``"round_robin"`` (the baseline affinity is
    measured against). ``metrics`` is an optional metrics.exporter ``Registry``
    — when present every replica's ``pool_metrics()`` exports under a
    ``{replica=}`` label and the ``tpu_fleet_*`` counters/gauges are
    kept.

    Crash-tolerance knobs: ``health`` (a :class:`HealthPolicy`;
    thresholds + quarantine backoff), ``engine_factory`` (``rid -> new
    engine`` — without it a dead replica can never rejoin and stays
    quarantined), ``faults`` (a ``FaultInjector`` firing ``fleet.step``
    once per router step and ``replica.crash`` once per serving replica
    per step — kind="crash" hard-kills that replica), ``journal_dir``
    (the ``.npz`` step directory of ``checkpoint_journal()``; when it already holds a
    journal the constructor recovers it and replays every open entry),
    ``replay_verify_tokens`` (re-decoded overlap per failover — the
    determinism check; 0 trusts the journal blindly),
    ``run_no_progress_s`` (the ``run()`` watchdog horizon)."""

    def __init__(self, replicas: Sequence[Tuple[str, object]],
                 store=None, fleet: str = "fleet",
                 pools: Optional[Dict[str, Sequence[str]]] = None,
                 policy: str = "affinity", stale_s: float = 5.0,
                 clock=None, tracer=None, metrics=None,
                 digest_top_k: int = 8, digest_max_tokens: int = 512,
                 p50_ref_s: float = 0.05, load_eps: float = 0.1,
                 backlog_ref_tokens: float = 2048.0,
                 auto_shed: bool = False,
                 shed_free_frac: float = 0.125,
                 shed_target_free_frac: float = 0.5,
                 health: Optional[HealthPolicy] = None,
                 health_seed: int = 0,
                 engine_factory: Optional[Callable[[str], object]] = None,
                 faults=None,
                 journal_dir: Optional[str] = None,
                 replay_verify_tokens: int = 4,
                 run_no_progress_s: float = 30.0) -> None:
        if not replicas:
            raise FleetError("a fleet needs at least one replica")
        if policy not in ("affinity", "round_robin"):
            raise FleetError(
                f"policy must be 'affinity' or 'round_robin', got "
                f"{policy!r}")
        if replay_verify_tokens < 0:
            raise FleetError(
                f"replay_verify_tokens must be >= 0, got "
                f"{replay_verify_tokens}")
        self._replicas: "OrderedDict[str, _Replica]" = OrderedDict()
        first_id: Optional[str] = None
        for rid, eng in replicas:
            rid = str(rid)
            if rid in self._replicas:
                raise FleetError(f"duplicate replica id {rid!r}")
            eng.replica_stats()          # paged-layout gate, fails early
            if first_id is None:
                first_id = rid
            else:
                # Fingerprint compatibility is validated HERE, not at
                # shed time: a partial drain removes the shed slots
                # from the source BEFORE absorb() runs its own
                # fingerprint check, so a mismatched pair discovered
                # mid-shed would strand the drained requests. With a
                # homogeneous fleet (everything but n_pages must
                # match — snapshot.check_fingerprint), absorb can only
                # refuse for capacity, which shed() prechecks. The same
                # reference vets every rejoining engine.
                try:
                    check_fingerprint(
                        self._replicas[first_id].engine.fingerprint(),
                        eng.fingerprint())
                except SnapshotError as e:
                    raise FleetError(
                        f"replica {rid!r} is not shed-compatible with "
                        f"{first_id!r}: {e}") from e
            self._replicas[rid] = _Replica(rid, eng)
        self._fingerprint_ref = \
            self._replicas[first_id].engine.fingerprint()
        self.page_size = int(
            self._replicas[first_id].engine.replica_stats()["page_size"])
        # Disaggregated pools (DistServe): ``pools`` PARTITIONS the
        # replica ids into a prefill pool (role='prefill' engines —
        # admission + chunked prefill, decode never dispatched) and a
        # decode pool (everything else). submit() then routes new
        # requests to the prefill pool only, and step() hands each
        # completed prefill off to the best decode replica via the
        # partial drain→absorb path. ``pools=None`` is the colocated
        # fallback — today's behavior, byte-identical — under which a
        # role='prefill' engine is REJECTED (its requests would park
        # at the phase boundary forever with nobody to hand off to).
        self._pools: Optional[Dict[str, List[str]]] = None
        self._pool_of: Dict[str, str] = {}
        if pools is not None:
            if set(pools) != {"prefill", "decode"}:
                raise FleetError(
                    f"pools needs exactly the keys 'prefill' and "
                    f"'decode', got {sorted(pools)}")
            pre = [str(r) for r in pools["prefill"]]
            dec = [str(r) for r in pools["decode"]]
            if not pre or not dec:
                raise FleetError(
                    "each pool needs at least one replica (a 1-replica "
                    "fleet runs colocated: pools=None)")
            both = pre + dec
            if (len(set(both)) != len(both)
                    or set(both) != set(self._replicas)):
                raise FleetError(
                    f"pools must partition the replica ids: pools name "
                    f"{sorted(both)}, fleet has "
                    f"{sorted(self._replicas)}")
            for r in pre:
                if getattr(self._replicas[r].engine, "role",
                           "mixed") != "prefill":
                    raise FleetError(
                        f"prefill-pool replica {r!r} must be built "
                        f"with role='prefill' (its engine would "
                        f"dispatch decode and race the handoff)")
            for r in dec:
                if getattr(self._replicas[r].engine, "role",
                           "mixed") == "prefill":
                    raise FleetError(
                        f"decode-pool replica {r!r} has role="
                        f"'prefill': it would never decode")
            self._pools = {"prefill": pre, "decode": dec}
            self._pool_of = {r: "prefill" for r in pre}
            self._pool_of.update({r: "decode" for r in dec})
        else:
            for rid, rep in self._replicas.items():
                if getattr(rep.engine, "role", "mixed") == "prefill":
                    raise FleetError(
                        f"replica {rid!r} has role='prefill' but the "
                        f"router has no pools= — its requests would "
                        f"never decode; pass pools= or build the "
                        f"engine role='mixed'")
        self.fleet = str(fleet)
        self.policy = policy
        self.stale_s = float(stale_s)
        self._store = store if store is not None else MemoryStore()
        self._clock = clock or SYSTEM_CLOCK
        self._tracer = tracer
        self._metrics = metrics
        self.digest_top_k = int(digest_top_k)
        self.digest_max_tokens = int(digest_max_tokens)
        self.p50_ref_s = float(p50_ref_s)
        self.load_eps = float(load_eps)
        self.backlog_ref_tokens = float(backlog_ref_tokens)
        self.auto_shed = bool(auto_shed)
        self.shed_free_frac = float(shed_free_frac)
        self.shed_target_free_frac = float(shed_target_free_frac)
        self.replay_verify_tokens = int(replay_verify_tokens)
        self.run_no_progress_s = float(run_no_progress_s)
        self._engine_factory = engine_factory
        self._faults = faults
        self._journal_dir = journal_dir
        if metrics is not None:
            self._c_routed = metrics.counter(
                FLEET_ROUTED_TOTAL, FLEET_COUNTERS[FLEET_ROUTED_TOTAL])
            self._c_shed = metrics.counter(
                FLEET_SHED_TOTAL, FLEET_COUNTERS[FLEET_SHED_TOTAL])
            self._c_migrated = metrics.counter(
                FLEET_MIGRATED_TOTAL, FLEET_COUNTERS[FLEET_MIGRATED_TOTAL])
            self._c_affinity = metrics.counter(
                FLEET_AFFINITY_HITS_TOTAL,
                FLEET_COUNTERS[FLEET_AFFINITY_HITS_TOTAL])
            self._c_failovers = metrics.counter(
                FLEET_FAILOVERS_TOTAL, FLEET_COUNTERS[FLEET_FAILOVERS_TOTAL])
            self._c_replayed = metrics.counter(
                FLEET_REPLAYED_TOKENS_TOTAL,
                FLEET_COUNTERS[FLEET_REPLAYED_TOKENS_TOTAL])
            self._c_lost = metrics.counter(
                FLEET_LOST_TOTAL, FLEET_COUNTERS[FLEET_LOST_TOTAL])
            self._c_expired = metrics.counter(
                FLEET_EXPIRED_TOTAL, FLEET_COUNTERS[FLEET_EXPIRED_TOTAL])
            # Counter registration is exposition-safe eager (a Counter
            # with no observations exports HELP/TYPE headers only); the
            # handoff-duration Histogram is NOT (it eagerly exposes a
            # zeroed unlabeled series), so it registers lazily at the
            # first handoff — a colocated fleet's exposition stays
            # byte-identical to pre-disagg output.
            self._c_handoffs = metrics.counter(
                FLEET_HANDOFFS_TOTAL, FLEET_COUNTERS[FLEET_HANDOFFS_TOTAL])
        # Health: every replica starts live; transitions drive failover.
        self._health = HealthMonitor(health, seed=health_seed)
        for rid in self._replicas:
            self._health.add(rid, now=self._clock.monotonic())
        # Fleet-level request ids: one namespace over all replicas —
        # local engine ids are replica-private and CHANGE on migration
        # (absorb assigns fresh ones), so callers hold fleet ids and the
        # router re-points the mapping at each shed/failover. The
        # JOURNAL owns the namespace (ids must stay unique across a
        # router restart).
        self._journal = RequestJournal()
        self._where: Dict[int, Tuple[str, int]] = {}   # frid -> (rid, lrid)
        self._local: Dict[Tuple[str, int], int] = {}   # (rid, lrid) -> frid
        # Engine tokens already consumed by the journal, per placement —
        # the progress cursor (a replayed placement restarts at 0 and
        # burns its verify window before delivering).
        self._consumed: Dict[Tuple[str, int], int] = {}
        # frid -> expected-but-not-yet-verified replay overlap.
        self._verify: Dict[int, List[int]] = {}
        self._req_metrics: Dict[int, Dict[str, float]] = {}
        # Surfaced request failures (deadline expiry, poison requests,
        # replay divergence) — the fleet mirror of
        # ``ContinuousBatcher.errors``: a request is never silently
        # stuck or silently dropped; it finishes or it lands here.
        self.errors: Dict[int, str] = {}
        self._rr = 0                                   # round-robin cursor
        self._handoff_rr = 0         # decode-target round-robin cursor
        self._handoffs = 0           # completed prefill→decode handoffs
        self._degraded = 0                             # degraded routes
        self._store_errors = 0
        self._failovers = 0
        self._replayed_tokens = 0
        self._lost = 0
        self._expired = 0
        # Parsed-summary cache, valid for one publish cycle: routing a
        # burst of submits between steps re-reads/re-parses nothing —
        # publish() (the only writer this router knows about)
        # invalidates it, so a shared-registry peer's update is picked
        # up at the next publish boundary at the latest.
        self._summaries_cache: Optional[Dict[str, ReplicaSummary]] = None
        if journal_dir:
            recovered = load_journal(journal_dir)
            if recovered is not None:
                # Router restart: every open entry's engine state died
                # with the old process — orphan them all and replay
                # (same machinery as a replica death).
                self._journal = recovered
                for frid in self._journal.open_frids():
                    self._journal.reassign(frid, None, failover=True)
        self.publish()                                 # summaries exist
        self._place_orphans()                          # recovered entries
        self._export_fleet_health()

    # -- summary plane -----------------------------------------------------
    def publish(self, replica_id: Optional[str] = None) -> None:
        """Publish summaries (one replica, or the whole fleet): drain
        each live engine's ``pool_metrics()`` once — feeding the rolling
        phase windows, the watchdog age, AND, when a metrics registry is
        attached, the ``{replica=}``-labeled Prometheus export — then
        write the summary to the store. A successful write is the
        replica's HEARTBEAT (health staleness reads the ack wall clock).
        Store failures are counted and swallowed: the registry client is
        retry-bounded, and an unreachable summary plane must degrade
        routing, never kill serving."""
        if self._metrics is not None:
            # Process-level, not per replica: serving downgrades by reason.
            from ..models.serving import decode_fallback_counts

            export_decode_fallbacks(self._metrics, decode_fallback_counts())
        reps = ([self._replica(replica_id)] if replica_id is not None
                else list(self._replicas.values()))
        for rep in reps:
            if rep.engine is None or not self._health.serving(rep.id):
                continue
            pm = rep.engine.pool_metrics()
            rep.last_step_age = float(
                pm.get("last_step_age_seconds", 0.0) or 0.0)
            for phase, seconds in pm.get("phase_durations") or ():
                if phase in _DECODE_PHASES:
                    rep.decode_window.append(float(seconds))
                elif phase in _PREFILL_PHASES:
                    rep.prefill_window.append(float(seconds))
            if self._metrics is not None:
                export_serving_pool(self._metrics, pm,
                                    labels={"replica": rep.id})
            rep.seq += 1
            s = summarize(
                rep.engine, rep.id, fleet=self.fleet, seq=rep.seq,
                now_wall=self._clock.wall(),
                decode_p50_s=_p50(rep.decode_window),
                prefill_p50_s=_p50(rep.prefill_window),
                top_k=self.digest_top_k,
                max_tokens=self.digest_max_tokens)
            try:
                publish_summary(self._store, s)
            except Exception:  # noqa: BLE001 — summary plane down ≠ serving down
                self._store_errors += 1
            else:
                rep.last_publish_wall = s.published_wall
        self._summaries_cache = None       # next route() re-reads once

    def summaries(self) -> Dict[str, ReplicaSummary]:
        """Summaries for THIS fleet's known replicas, from the store
        (an empty dict when the store is unreachable — the caller's
        staleness check then degrades routing). Cached per publish
        cycle: the store is read/parsed once per step, not once per
        submit."""
        if self._summaries_cache is not None:
            return dict(self._summaries_cache)
        try:
            listed = list_summaries(self._store, self.fleet)
        except Exception:  # noqa: BLE001 — summary plane down ≠ serving down
            self._store_errors += 1
            return {}
        out = {r: s for r, s in listed.items() if r in self._replicas}
        self._summaries_cache = out
        return dict(out)

    # -- scoring -----------------------------------------------------------
    def score(self, summary: ReplicaSummary,
              prompt: Sequence[int]) -> Tuple[float, int]:
        """(score, prefix match tokens) for placing ``prompt`` on the
        summarized replica — a pure function of its arguments, which is
        what makes placement deterministic and testable."""
        match, resident = prefix_match_parts(
            prompt, summary.digest, self.page_size)
        effective = resident + DEMOTED_MATCH_DISCOUNT * (match - resident)
        eps = self.load_eps
        load = ((eps + summary.free_frac)
                * (eps + summary.free_slot_frac)
                / (1.0 + summary.decode_p50_s / self.p50_ref_s)
                / (1.0 + max(0, summary.prefill_backlog_tokens)
                   / self.backlog_ref_tokens))
        return (1.0 + effective) * load, match

    def _routable_ids(self) -> List[str]:
        return [rid for rid in self._replicas
                if self._health.routable(rid)
                and self._replicas[rid].engine is not None]

    def route(self, prompt: Sequence[int]) -> Tuple[str, str, int]:
        """Choose a replica for ``prompt``: returns
        ``(replica id, policy used, prefix match tokens)``. Only LIVE
        replicas are candidates (suspect ones keep serving what they
        hold but take no new blast radius). Affinity scoring needs FRESH
        summaries (published within ``stale_s`` of now); with none
        fresh — or under ``policy="round_robin"`` — the deterministic
        round-robin fallback places the request instead (bounded
        staleness can degrade placement quality, never correctness)."""
        ids = self._routable_ids()
        if not ids:
            raise FleetError(
                f"no live replicas to route to "
                f"(states: {self._health.counts()})")
        if self._pools is not None:
            # Per-phase routing: NEW admissions go to the prefill pool
            # (chunked engines sized for TTFT), and reach the decode
            # pool only through the phase-boundary handoff. With the
            # whole prefill pool down, fall back to the decode pool —
            # its engines behave like mixed replicas (role='decode' is
            # advisory), so requests complete colocated-style instead
            # of stranding; requests_lost stays 0 either way.
            pool_ids = [r for r in ids
                        if self._pool_of[r] == "prefill"]
            ids = pool_ids or ids
        if self.policy == "affinity":
            now = self._clock.wall()
            fresh = {r: s for r, s in self.summaries().items()
                     if r in ids and now - s.published_wall <= self.stale_s}
            if fresh:
                best_rid, best_score, best_match = None, 0.0, 0
                for rid in sorted(fresh):
                    sc, match = self.score(fresh[rid], prompt)
                    if best_rid is None or sc > best_score:
                        best_rid, best_score, best_match = rid, sc, match
                return best_rid, "affinity", best_match
            self._degraded += 1
        rid = ids[self._rr % len(ids)]
        self._rr += 1
        return rid, ("round_robin" if self.policy == "round_robin"
                     else "degraded"), 0

    # -- serving API -------------------------------------------------------
    def submit(self, prompt, max_new: int,
               trace_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> int:
        """Route and admit one request; returns its FLEET id (stable
        across migrations and failovers — local engine ids are not).
        The submission is journaled BEFORE it reaches an engine: from
        here on a crash anywhere in the fleet can delay the stream but
        not lose it. ``deadline_s`` (relative seconds) arms per-request
        deadline enforcement: past it the request fails with a surfaced
        ``Router.errors`` record instead of sitting stuck."""
        prompt = [int(t) for t in prompt]
        if deadline_s is not None and deadline_s <= 0:
            raise FleetError(
                f"deadline_s must be positive, got {deadline_s}")
        rid, policy, match = self.route(prompt)
        now_wall = self._clock.wall()
        frid = self._journal.open(
            prompt, max_new, trace_id=trace_id, replica=rid,
            deadline_wall=(None if deadline_s is None
                           else now_wall + float(deadline_s)),
            submitted_wall=now_wall)
        eng = self._replica(rid).engine
        try:
            lrid = eng.submit(prompt, max_new=max_new, trace_id=trace_id)
        except Exception:
            # Admission refused (infeasible request) — the journal must
            # not carry an entry no engine holds, or the failover path
            # would replay a request that was never accepted.
            self._journal.close(frid, ERROR)
            raise
        self._where[frid] = (rid, lrid)
        self._local[(rid, lrid)] = frid
        self._consumed[(rid, lrid)] = 0
        if self._metrics is not None:
            self._c_routed.inc(replica=rid, policy=policy)
            if match:
                self._c_affinity.inc(replica=rid)
        if self._tracer is not None:
            self._tracer.event(
                "route", lane="router",
                rid=trace_id if trace_id is not None else f"fleet-{frid}",
                replica=rid, policy=policy, match_tokens=match)
        return frid

    def locate(self, frid: int) -> Tuple[str, int]:
        """(replica id, local request id) a fleet request currently
        lives on — moves when a shed or a failover migrates it."""
        if frid not in self._where:
            raise FleetError(f"unknown or finished fleet request {frid}")
        return self._where[frid]

    @property
    def pending(self) -> int:
        """In-flight work: live engines' queues/slots plus journaled
        orphans awaiting a live target (their dead replica's engine no
        longer counts them — the journal does)."""
        live = sum(r.engine.pending for r in self._replicas.values()
                   if r.engine is not None
                   and self._health.serving(r.id))
        return live + len(self._journal.inflight_on(None))

    # -- journal bookkeeping -----------------------------------------------
    def _ingest(self, frid: int, tokens,
                consumed: int) -> Optional[str]:
        """Feed one placement's engine-token progress into the journal:
        ``tokens[consumed:]`` first burns the replay verify window
        (byte-compare against the journaled delivery — greedy decode is
        deterministic, so a mismatch means the replay is NOT the same
        stream and must fail loudly), the rest is newly delivered.
        Returns a failure reason (caller fails THAT request — one bad
        stream must not unwind the fleet step) or None on success."""
        new = [int(t) for t in tokens[consumed:]]
        if not new:
            return None
        expect = self._verify.get(frid)
        if expect:
            k = min(len(new), len(expect))
            if new[:k] != expect[:k]:
                return ("replay divergence: regenerated tokens != "
                        "journaled delivery")
            del expect[:k]
            if not expect:
                self._verify.pop(frid, None)
            self._replayed_tokens += k
            if self._metrics is not None:
                self._c_replayed.inc(k)
            new = new[k:]
        if new:
            try:
                self._journal.deliver(frid, new)
            except JournalError as e:
                return f"journal refused delivery: {e}"
        return None

    def _drop_placement(self, frid: int) -> Optional[Tuple[str, int]]:
        loc = self._where.pop(frid, None)
        if loc is not None:
            self._local.pop(loc, None)
            self._consumed.pop(loc, None)
        self._verify.pop(frid, None)
        return loc

    def _fail_fleet_request(self, frid: int, reason: str,
                            outcome: str = ERROR,
                            cancel: bool = True) -> None:
        """Surface one fleet request's failure: engine-side cancel
        (pages retired), ``Router.errors`` record, journal entry
        closed."""
        loc = self._drop_placement(frid)
        if cancel and loc is not None:
            rep = self._replicas.get(loc[0])
            if rep is not None and rep.engine is not None:
                try:
                    rep.engine.cancel(loc[1], reason=reason)
                except Exception:  # noqa: BLE001 — engine may be dying too
                    pass
        self.errors[frid] = reason
        if frid in self._journal:
            self._journal.close(frid, outcome)

    def _collect_engine_errors(self, rep: _Replica) -> None:
        """Mirror per-request engine failures (poison isolation,
        ``ContinuousBatcher.errors``) into fleet errors + journal
        closure — the request already lost its slot and pages."""
        errs = rep.engine.errors
        if not errs:
            return
        for (rid_, lrid), frid in list(self._local.items()):
            if rid_ == rep.id and lrid in errs:
                reason = errs[lrid]
                self._drop_placement(frid)
                self.errors[frid] = reason
                if frid in self._journal:
                    self._journal.close(frid, ERROR)

    # -- health / failover -------------------------------------------------
    def _note_transition(self, rid: str,
                         transition: Optional[Tuple[str, str]],
                         reason: str = "") -> None:
        if transition is None:
            return
        old, new = transition
        if self._tracer is not None:
            name = "replica_dead" if new == DEAD else f"replica_{new}"
            self._tracer.event(name, lane="router", replica=rid,
                               prev=old, reason=reason)

    def _crash(self, rid: str, exc: BaseException) -> None:
        """Hard kill: the engine object is discarded — no drain, no
        snapshot, exactly what an OOM/wedged-device/killed-pod leaves
        behind. Recovery is journal replay only."""
        rep = self._replica(rid)
        rep.engine = None
        now = self._clock.monotonic()
        tr = self._health.declare_dead(rid, f"crash: {exc}", now)
        self._note_transition(rid, tr, f"crash: {exc}")
        self._on_dead(rid)

    def _on_dead(self, rid: str) -> None:
        """A replica was declared dead: discard its engine, orphan its
        journaled in-flight requests (replayed onto survivors by
        ``_place_orphans``), quarantine it (circuit breaker), and
        account the failover. Requests a dead replica held WITHOUT a
        journal entry would be lost — that counter must stay 0 (every
        router submission is journaled at admission)."""
        now = self._clock.monotonic()
        rep = self._replica(rid)
        rep.engine = None                  # dead = discarded, uniformly
        orphaned = 0
        for (rid_, _lrid), frid in list(self._local.items()):
            if rid_ != rid:
                continue
            self._drop_placement(frid)
            if frid in self._journal:
                self._journal.reassign(frid, None, failover=True)
                orphaned += 1
            else:
                self._lost += 1
                if self._metrics is not None:
                    self._c_lost.inc(replica=rid)
        self._failovers += 1
        if self._metrics is not None:
            self._c_failovers.inc(replica=rid)
        if self._tracer is not None:
            self._tracer.event("failover", lane="router", replica=rid,
                               orphaned=orphaned,
                               reason=self._health.get(rid).last_error)
        tr = self._health.quarantine(rid, now)
        self._note_transition(rid, tr)
        self._place_orphans()

    def _replay_entry(self, entry) -> bool:
        """Re-place one journaled in-flight request by deterministic
        replay: the new prompt is ``prompt + delivered`` minus the
        verify window, the new budget is the undelivered remainder plus
        that window. The replayed stream's first ``overlap`` tokens must
        byte-equal the journal (checked incrementally in ``_ingest``);
        only tokens past the window are delivered — the caller's stream
        is byte-identical to a no-fault run, and the re-decoded rework
        is bounded by the journaled delivery."""
        overlap = min(self.replay_verify_tokens, len(entry.delivered))
        ctx = list(entry.prompt) + list(entry.delivered)
        replay_prompt = ctx[:len(ctx) - overlap] if overlap else ctx
        budget = entry.remaining + overlap
        # Prefer the scored route (prefix affinity makes the replay
        # prefill cheap where siblings share the prompt), then fall
        # back to every other live replica — capacity refusals must not
        # strand a request that some replica could hold.
        try:
            first, _policy, _match = self.route(replay_prompt)
        except FleetError:
            return False                   # no live replicas right now
        candidates = [first] + [r for r in self._routable_ids()
                                if r != first]
        for rid in candidates:
            eng = self._replicas[rid].engine
            try:
                lrid = eng.submit(replay_prompt, max_new=budget,
                                  trace_id=entry.trace_id)
            except (ValueError, RuntimeError):
                continue                   # can't fit here; try the next
            frid = entry.frid
            self._where[frid] = (rid, lrid)
            self._local[(rid, lrid)] = frid
            self._consumed[(rid, lrid)] = 0
            if overlap:
                self._verify[frid] = list(entry.delivered[-overlap:])
            self._journal.reassign(frid, rid)
            if self._tracer is not None:
                self._tracer.event(
                    "replay", lane="router",
                    rid=(entry.trace_id if entry.trace_id is not None
                         else f"fleet-{frid}"),
                    replica=rid, resumed_at=len(entry.delivered),
                    verify_tokens=overlap)
            flight = getattr(eng, "_flight", None)
            if flight is not None:
                flight.record("replay", frid=frid, lrid=lrid,
                              resumed_at=len(entry.delivered),
                              verify_tokens=overlap)
            return True
        return False

    def _place_orphans(self) -> int:
        """Replay every journaled request with no live placement (dead
        replica, router restart). Unplaceable entries stay orphaned and
        are retried each step — ``run()``'s no-progress watchdog bounds
        the wait."""
        placed = 0
        for entry in self._journal.inflight_on(None):
            if self._replay_entry(entry):
                placed += 1
        return placed

    def _tick_health(self) -> None:
        """Passive health pass, once per step: quarantine expiry →
        rejoin (fresh engine via ``engine_factory`` +
        ``resume_or_fresh``, fingerprint-vetted, failure re-quarantines
        on the next backoff rung), then heartbeat-staleness and watchdog
        checks over the publish-time captures. Staleness only indicts a
        replica when the summary PLANE is alive (some other replica
        published fresh): a dead store degrades routing, it does
        not kill the fleet."""
        now = self._clock.monotonic()
        now_wall = self._clock.wall()
        for rep in self._replicas.values():
            st = self._health.state(rep.id)
            if st == QUARANTINED \
                    and self._health.due_for_rejoin(rep.id, now) \
                    and self._engine_factory is not None:
                tr = self._health.start_rejoin(rep.id, now)
                self._note_transition(rep.id, tr)
                try:
                    eng, _resumed = resume_or_fresh(
                        lambda: self._engine_factory(rep.id),
                        self._rejoin_dir(rep.id))
                    eng.replica_stats()          # paged + alive probe
                    check_fingerprint(self._fingerprint_ref,
                                      eng.fingerprint())
                except Exception as e:  # noqa: BLE001 — rejoin must not kill the fleet
                    rep.engine = None
                    tr = self._health.rejoin_failed(rep.id, e, now)
                    self._note_transition(rep.id, tr, str(e))
                    continue
                rep.engine = eng
                rep.last_step_age = 0.0
                # Fresh heartbeat baseline BEFORE the publish attempt: a
                # replica that died by staleness still carries its
                # pre-death publish wall, and one dropped store write at
                # rejoin time must not let the next observe() pass
                # re-declare the healthy rebuild dead in the same tick.
                rep.last_publish_wall = now_wall
                tr = self._health.rejoined(rep.id, now)
                self._note_transition(rep.id, tr)
                self.publish(rep.id)             # heartbeat + summary
                self._place_orphans()            # capacity came back
        serving = [rep for rep in self._replicas.values()
                   if self._health.serving(rep.id)]
        ages = {rep.id: now_wall - rep.last_publish_wall
                for rep in serving}
        plane_ok = any(a <= self._health.policy.stale_s
                       for a in ages.values())
        for rep in serving:
            tr = self._health.observe(
                rep.id, now,
                heartbeat_age_s=(ages[rep.id] if plane_ok else None),
                last_step_age_s=rep.last_step_age)
            self._note_transition(rep.id, tr)
            if self._health.state(rep.id) == DEAD:
                self._on_dead(rep.id)

    def _rejoin_dir(self, rid: str) -> Optional[str]:
        """Snapshot directory a rejoining replica may resume from —
        None in-process (a hard crash never drained; resume_or_fresh
        then builds fresh). A cross-process deployment points this at
        the replica's pod volume."""
        return None

    def _enforce_deadlines(self) -> None:
        now_wall = self._clock.wall()
        for frid in self._journal.open_frids():
            e = self._journal.entry(frid)
            if e.deadline_wall is None or now_wall < e.deadline_wall:
                continue
            self._expired += 1
            if self._metrics is not None:
                self._c_expired.inc()
            if self._tracer is not None:
                self._tracer.event(
                    "deadline_expired", lane="router",
                    rid=(e.trace_id if e.trace_id is not None
                         else f"fleet-{frid}"),
                    delivered=len(e.delivered), budget=e.max_new)
            self._fail_fleet_request(
                frid,
                f"deadline exceeded after "
                f"{now_wall - e.submitted_wall:.3f}s "
                f"({len(e.delivered)}/{e.max_new} tokens delivered)",
                outcome=EXPIRED)

    def _export_fleet_health(self) -> None:
        if self._metrics is None:
            return
        g_state = self._metrics.gauge(FLEET_REPLICA_STATE,
                                      FLEET_GAUGES[FLEET_REPLICA_STATE])
        for rid in self._replicas:
            st = self._health.state(rid)
            for s in STATES:
                g_state.set(1.0 if s == st else 0.0,
                            replica=rid, state=s)
        # Pool topology, one-hot like replica_state: pools= mode labels
        # by pool membership (the router's routing truth even for a
        # mixed-role engine placed in the decode pool); colocated
        # fleets label every replica "mixed".
        g_role = self._metrics.gauge(FLEET_REPLICA_ROLE,
                                     FLEET_GAUGES[FLEET_REPLICA_ROLE])
        for rid in self._replicas:
            role = (self._pool_of[rid] if self._pools is not None
                    else "mixed")
            for r in ("mixed", "prefill", "decode"):
                g_role.set(1.0 if r == role else 0.0,
                           replica=rid, role=r)
        self._metrics.gauge(
            FLEET_JOURNAL_SIZE,
            FLEET_GAUGES[FLEET_JOURNAL_SIZE]).set(float(len(self._journal)))

    # -- stepping ----------------------------------------------------------
    def step(self) -> Dict[int, list]:
        """Step every serving replica once (admission + one
        decode/verify chunk each) WITH per-replica fault isolation: one
        replica's raise marks it suspect/dead and the step continues —
        the bugfix for the old all-or-nothing unwind — then journal the
        progress, enforce deadlines, replay orphans, refresh the
        published summaries, and return the newly finished streams keyed
        by FLEET id (each the full journaled delivery — for a
        failed-over request that is pre-crash tokens + replayed suffix,
        byte-identical to the no-fault stream). With ``auto_shed`` on, a
        replica past the pressure watermark sheds toward the coldest
        peer after the step."""
        done: Dict[int, list] = {}
        if self._faults is not None:
            try:
                self._faults.fire("fleet.step")
            except ReplicaCrashed:
                raise                      # a router crash is the caller's
            except InjectedFault:
                return done                # router step dropped: no work
        self._tick_health()
        now = self._clock.monotonic()
        for rep in list(self._replicas.values()):
            if rep.engine is None or not self._health.serving(rep.id):
                continue
            if self._faults is not None:
                try:
                    self._faults.fire("replica.crash",
                                      drop_exc=ReplicaCrashed)
                except InjectedFault as e:
                    self._crash(rep.id, e)
                    continue
            if not rep.engine.pending:
                # An idle engine cannot be wedged; a suspect one
                # redeems itself by having nothing to fail at.
                self._health.note_ok(rep.id, now)
                continue
            try:
                finished = rep.engine.step()
            except Exception as e:  # noqa: BLE001 — per-replica isolation (the point)
                tr = self._health.note_error(rep.id, e, now)
                self._note_transition(rep.id, tr, str(e))
                if self._health.state(rep.id) == DEAD:
                    self._on_dead(rep.id)
                continue
            self._health.note_ok(rep.id, now)
            metrics = rep.engine.pop_request_metrics()
            self._collect_engine_errors(rep)
            for lrid, toks in finished.items():
                frid = self._local.pop((rep.id, lrid), None)
                if frid is None:
                    continue                 # not router-owned (warmup)
                self._where.pop(frid, None)
                consumed = self._consumed.pop((rep.id, lrid), 0)
                reason = self._ingest(frid, toks, consumed)
                if reason is not None:
                    self._fail_fleet_request(frid, reason, cancel=False)
                    continue
                if self._verify.get(frid):
                    # Finished with verify window left unregenerated: a
                    # correct replay's budget (remaining + window) always
                    # regenerates the full window plus at least one new
                    # token, so stopping short IS divergence (e.g. an
                    # eos the journaled stream never contained) — fail
                    # loudly, never close DONE with a truncated stream.
                    self._fail_fleet_request(
                        frid, "replay divergence: replayed stream ended "
                        "inside the verify window", cancel=False)
                    continue
                done[frid] = self._journal.stream(frid)
                self._journal.close(frid, DONE)
                if lrid in metrics:
                    self._req_metrics[frid] = metrics[lrid]
            for (rid_, lrid), frid in list(self._local.items()):
                if rid_ != rep.id:
                    continue
                toks = rep.engine.emitted(lrid)
                consumed = self._consumed.get((rid_, lrid), 0)
                if len(toks) <= consumed:
                    continue
                reason = self._ingest(frid, toks, consumed)
                if reason is not None:
                    self._fail_fleet_request(frid, reason)
                    continue
                self._consumed[(rid_, lrid)] = len(toks)
        if self._pools is not None:
            # Phase boundary: every prefill-pool slot whose prompt is
            # fully resident (first token emitted, journaled by the
            # progress pass above) hands off to the decode pool now.
            self._auto_handoff()
        self._enforce_deadlines()
        self._place_orphans()
        self.publish()
        self._export_fleet_health()
        if self.auto_shed:
            self.maybe_shed()
        return done

    def _progress_marker(self) -> Tuple:
        # Deliberately NOT health.transition_count: a replica flapping
        # suspect↔live would register as perpetual "progress" and defeat
        # the watchdog. Recovery that matters shows up here anyway — a
        # rejoin that re-places orphans moves journal/pending.
        return (self._journal.delivered_tokens_total,
                sum(self._journal.closed.values()),
                len(self._journal), self.pending)

    def run(self, no_progress_s: Optional[float] = None) -> Dict[int, list]:
        """Drain everything submitted across the fleet, bounded by a
        no-progress watchdog: ``while pending`` alone would spin forever
        on a wedged or permanently-quarantined fleet — if no token is
        delivered, no request closes, and the journaled/pending work
        doesn't move for ``no_progress_s`` (monotonic), raise instead.
        A rejoin that matters re-places orphans (journal/pending move),
        so a recovering fleet is never killed mid-backoff as long as
        the horizon exceeds the quarantine ladder."""
        horizon = (self.run_no_progress_s if no_progress_s is None
                   else float(no_progress_s))
        done: Dict[int, list] = {}
        last_progress = self._clock.monotonic()
        marker = self._progress_marker()
        while self.pending:
            done.update(self.step())
            now = self._clock.monotonic()
            m = self._progress_marker()
            if m != marker:
                marker, last_progress = m, now
            elif now - last_progress >= horizon:
                raise FleetError(
                    f"fleet made no progress for {now - last_progress:.1f}s: "
                    f"{self.pending} pending, "
                    f"{len(self._journal)} journaled in flight, "
                    f"states {self._health.counts()}")
        return done

    def pop_request_metrics(self) -> Dict[int, Dict[str, float]]:
        """Per-request latency records (ttft_s/latency_s/tokens) keyed
        by fleet id, drained since the last call — migration-safe: a
        shed request's record closes on the replica that finished it,
        with the handoff gap charged (absorb rebases the clocks)."""
        out, self._req_metrics = self._req_metrics, {}
        return out

    # -- durability --------------------------------------------------------
    @property
    def journal(self) -> RequestJournal:
        return self._journal

    def checkpoint_journal(self) -> None:
        """Persist the journal under ``journal_dir`` as an ``.npz`` step
        directory (models/lifecycle.py): a restarted router recovers it and
        replays every open entry — the request-level analogue of the
        serve loop's snapshot persistence, for the crash that never
        drained."""
        if not self._journal_dir:
            raise FleetError("router built without journal_dir")
        persist_journal(self._journal, self._journal_dir)

    @property
    def health(self) -> HealthMonitor:
        return self._health

    # -- load shedding -----------------------------------------------------
    def _replica(self, rid: str) -> _Replica:
        try:
            return self._replicas[str(rid)]
        except KeyError:
            raise FleetError(f"unknown replica {rid!r}") from None

    def _repoint(self, src: str, dst: str,
                 mapping: Dict[int, int]) -> int:
        """Re-point the fleet-id bookkeeping after an absorb moved
        requests ``src → dst`` with the returned ``{old local rid: new
        local rid}`` mapping — shared by shed() and the disagg handoff.
        The delivered-progress cursor rides along: absorb carries the
        emitted stream, so the target's ``emitted()`` continues at the
        same offset."""
        src, dst = str(src), str(dst)
        moved = 0
        for (rid, lrid), frid in list(self._local.items()):
            if rid == src and lrid in mapping:
                del self._local[(rid, lrid)]
                new_key = (dst, mapping[lrid])
                self._local[new_key] = frid
                self._where[frid] = new_key
                self._consumed[new_key] = self._consumed.pop(
                    (rid, lrid), 0)
                if frid in self._journal:
                    # reassign() only moves the placement: trace_id,
                    # submitted_wall and — critically — deadline_wall
                    # are untouched, so a handed-off request keeps its
                    # ORIGINAL deadline (and a decode-pool crash later
                    # replays with it too).
                    self._journal.reassign(frid, dst)
                moved += 1
        return moved

    # -- disaggregated handoff ---------------------------------------------
    def _pick_decode_target(self, need_pages: int,
                            ctx: Sequence[int]) -> Optional[str]:
        """Best decode-pool replica for one completed prefill: hard
        capacity precheck on LIVE stats (≥1 free slot and room for the
        migrating pages — an absorb refusal after the drain would
        orphan the request), then conversation affinity + free-capacity
        scoring over fresh summaries (``ctx`` is prompt + delivered, so
        a multi-turn conversation lands where its earlier turns left
        cached pages). With any candidate's summary stale, degrade to a
        deterministic round-robin cursor over the candidates — same
        bounded-staleness posture as route()."""
        pool = self._pools["decode"]
        cands = []
        for rid in pool:
            rep = self._replicas[rid]
            if rep.engine is None or not self._health.routable(rid):
                continue
            st = rep.engine.replica_stats()
            if (st["n_slots"] - st["active_slots"] < 1
                    or st["pages_free"] < need_pages):
                continue
            cands.append(rid)
        if not cands:
            return None
        now = self._clock.wall()
        fresh = {r: s for r, s in self.summaries().items()
                 if now - s.published_wall <= self.stale_s}
        if all(r in fresh for r in cands):
            scored = sorted(
                ((self.score(fresh[r], ctx)[0], r) for r in cands),
                key=lambda t: (-t[0], t[1]))
            return scored[0][1]
        rid = cands[self._handoff_rr % len(cands)]
        self._handoff_rr += 1
        return rid

    def _handoff_slot(self, src: str, slot: int, lrid: int,
                      frid: int, dst: Optional[str] = None) -> bool:
        """Hand ONE completed-prefill slot to the decode pool: partial
        ``drain(slots=[slot])`` off the prefill replica → ``absorb()``
        on the chosen target, pages LUT-remapped, fleet id re-pointed,
        trace label re-attached (labels are engine-local, not wire
        state). Returns False when no target has capacity (the slot
        parks on the prefill replica and retries next step — admission
        backpressure, not loss). An absorb failure AFTER the drain is
        the handoff-in-flight crash: the request left the source with
        the snapshot, so it is orphaned through the journal and
        replayed like any dead-replica failover — replay routes back
        through the prefill pool and re-reaches this boundary with the
        ORIGINAL deadline."""
        se = self._replicas[src].engine
        need = se.pages_referenced([slot])
        entry = (self._journal.entry(frid)
                 if frid in self._journal else None)
        ctx = (list(entry.prompt) + list(entry.delivered)
               if entry is not None else [])
        if dst is None:
            dst = self._pick_decode_target(need, ctx)
            if dst is None:
                return False
        t0 = self._clock.monotonic()
        snap = se.drain(slots=[slot])
        try:
            mapping = self._replicas[dst].engine.absorb(snap)
        except Exception as e:  # noqa: BLE001 — orphan, never strand
            self._drop_placement(frid)
            if frid in self._journal:
                self._journal.reassign(frid, None, failover=True)
                self._place_orphans()
            else:
                self._lost += 1
                if self._metrics is not None:
                    self._c_lost.inc(replica=src)
            if self._tracer is not None:
                self._tracer.event(
                    "handoff_failed", lane="router",
                    rid=(entry.trace_id if entry is not None
                         and entry.trace_id is not None
                         else f"fleet-{frid}"),
                    src=src, dst=dst, reason=str(e))
            return False
        self._repoint(src, dst, mapping)
        t1 = self._clock.monotonic()
        self._handoffs += 1
        new_lrid = mapping.get(lrid)
        de = self._replicas[dst].engine
        if (entry is not None and entry.trace_id is not None
                and new_lrid is not None):
            de.label_request(new_lrid, entry.trace_id)
        if self._metrics is not None:
            self._c_handoffs.inc(src=src, dst=dst)
            self._metrics.histogram(
                FLEET_HANDOFF_DURATION,
                FLEET_HISTOGRAMS[FLEET_HANDOFF_DURATION]).observe(t1 - t0)
        rid_label = (entry.trace_id if entry is not None
                     and entry.trace_id is not None else f"fleet-{frid}")
        if self._tracer is not None:
            self._tracer.record(
                "handoff", t0, t1, lane="router", rid=rid_label,
                src=src, dst=dst, pages=need,
                delivered=(len(entry.delivered)
                           if entry is not None else 0))
        # Flight records on BOTH engines: the per-engine rings each
        # show their half of the migration, and the shared frid keys
        # them to the router span — one correlated timeline per
        # request across the pool boundary.
        for eng, kind, lr in ((se, "handoff_out", lrid),
                              (de, "handoff_in", new_lrid)):
            flight = getattr(eng, "_flight", None)
            if flight is not None:
                flight.record(kind, frid=frid, lrid=lr,
                              peer=(dst if kind == "handoff_out"
                                    else src), pages=need)
        return True

    def _auto_handoff(self) -> int:
        """Migrate every handoff-ready prefill-pool slot (prompt fully
        resident, first token emitted) to the decode pool; runs once
        per router step at the phase boundary. Capacity-refused slots
        stay parked and retry next step."""
        moved = 0
        for src in self._pools["prefill"]:
            rep = self._replicas[src]
            if rep.engine is None or not self._health.serving(src):
                continue
            for slot, lrid in rep.engine.handoff_ready_slots():
                frid = self._local.get((src, lrid))
                if frid is None:
                    continue             # not router-owned (warmup)
                if self._handoff_slot(src, slot, lrid, frid):
                    moved += 1
        return moved

    def handoff(self, frid: int, dst: Optional[str] = None) -> str:
        """Manually hand one fleet request prefill→decode (the
        auto-handoff in step() normally does this): returns the decode
        replica it landed on. Refuses requests that are mid-prefill
        (handoff is defined at the phase boundary only), already on the
        decode pool, or without a live placement."""
        if self._pools is None:
            raise FleetError("handoff requires Router(pools=...)")
        if frid not in self._where:
            raise FleetError(
                f"unknown or finished fleet request {frid}")
        src, lrid = self._where[frid]
        if self._pool_of.get(src) != "prefill":
            raise FleetError(
                f"fleet request {frid} is already on decode-pool "
                f"replica {src!r}")
        se = self._replicas[src].engine
        ready = {r: s for s, r in se.handoff_ready_slots()}
        if lrid not in ready:
            raise FleetError(
                f"fleet request {frid} is mid-prefill on {src!r}: "
                f"handoff moves only completed prefills (the phase "
                f"boundary)")
        if dst is not None:
            dst = str(dst)
            if self._pool_of.get(dst) != "decode":
                raise FleetError(
                    f"handoff target {dst!r} is not in the decode "
                    f"pool")
            rep = self._replica(dst)
            if rep.engine is None or not self._health.serving(dst):
                raise FleetError(
                    f"handoff target {dst!r} is not serving "
                    f"({self._health.state(dst)})")
        if not self._handoff_slot(src, ready[lrid], lrid, frid,
                                  dst=dst):
            raise FleetError(
                f"no decode-pool replica can absorb fleet request "
                f"{frid} right now (capacity precheck refused)")
        return self._where[frid][0]

    def pool_plan(self, policy: Optional[PoolPolicy] = None) -> PoolPlan:
        """Advisory autoscaling plan for the two pools, computed from
        the current summaries (fleet/pools.py): prefill scales OUT on
        queued prefill tokens, decode scales UP on free-page/slot
        watermarks. Pure and deterministic — the operator (or a test)
        decides what to do with it."""
        if self._pools is None:
            raise FleetError("pool_plan requires Router(pools=...)")
        return plan_pools(self.summaries(), self._pools,
                          policy or PoolPolicy())

    def shed(self, src: str, dst: str,
             slots: Optional[List[int]] = None,
             max_slots: Optional[int] = None) -> int:
        """Migrate active slots from replica ``src`` to ``dst``: partial
        ``drain(slots=...)`` → ``absorb()``, token-identically, with the
        fleet-id mapping re-pointed. Default slot choice is the first
        half of the active slots (sorted ids — deterministic); capacity
        is prechecked on the target (free slots AND free pages) so the
        shed either moves everything or moves nothing. Returns the
        number of migrated requests."""
        src, dst = str(src), str(dst)
        if src == dst:
            raise FleetError("shed needs two distinct replicas")
        if (self._pools is not None
                and self._pool_of.get(src) != self._pool_of.get(dst)):
            raise FleetError(
                f"shed cannot cross pools ({src!r} is "
                f"{self._pool_of.get(src)}, {dst!r} is "
                f"{self._pool_of.get(dst)}): the phase boundary moves "
                f"requests via handoff(), not load shedding")
        src_rep, dst_rep = self._replica(src), self._replica(dst)
        if src_rep.engine is None or not self._health.serving(src):
            raise FleetError(f"shed source {src!r} is not serving "
                             f"({self._health.state(src)})")
        if dst_rep.engine is None or not self._health.serving(dst):
            raise FleetError(f"shed target {dst!r} is not serving "
                             f"({self._health.state(dst)})")
        se, de = src_rep.engine, dst_rep.engine
        active = se.active_slot_ids()
        if slots is None:
            n = max(1, len(active) // 2)
            if max_slots is not None:
                n = min(n, int(max_slots))
            slots = active[:n]
        slots = sorted(int(s) for s in slots)
        if not slots:
            return 0
        dst_stats = de.replica_stats()
        free_slots = dst_stats["n_slots"] - dst_stats["active_slots"]
        need_pages = se.pages_referenced(slots)
        if len(slots) > free_slots or need_pages > dst_stats["pages_free"]:
            # Refuse up front: a drain the target cannot absorb would
            # strand the shed requests (they leave the source engine
            # with the snapshot). Tree-only pages on the target are
            # reclaimable, but the conservative check keeps shed
            # all-or-nothing without peeking into the peer's cache.
            raise FleetError(
                f"target {dst!r} cannot absorb {len(slots)} slots / "
                f"{need_pages} pages (free: {free_slots} slots, "
                f"{dst_stats['pages_free']} pages)")
        t0 = self._clock.monotonic()
        snap = se.drain(slots=slots)
        if self._metrics is not None:
            self._c_shed.inc(len(snap.slot_req), replica=str(src))
        mapping = de.absorb(snap)
        self._repoint(src, dst, mapping)
        if self._metrics is not None:
            self._c_migrated.inc(len(mapping), replica=str(dst))
        if self._tracer is not None:
            self._tracer.record(
                "fleet_shed", t0, self._clock.monotonic(), lane="router",
                src=str(src), dst=str(dst), slots=len(slots),
                requests=len(mapping))
        self.publish(str(src))
        self.publish(str(dst))
        return len(mapping)

    def maybe_shed(self) -> int:
        """Pressure-driven shed: when some replica's free-page fraction
        is below ``shed_free_frac`` and another's is above
        ``shed_target_free_frac``, move half the hot replica's active
        slots to the coldest peer (deterministic tiebreak by id).
        Returns migrated requests (0 when no pair qualifies or the
        conservative capacity precheck refuses)."""
        # Disaggregated fleets balance WITHIN each pool: shedding a
        # prefill-pool slot to a decode replica (or back) would cross
        # the phase boundary outside the handoff path.
        groups = ([list(self._replicas)] if self._pools is None
                  else [self._pools["prefill"], self._pools["decode"]])
        moved = 0
        for group in groups:
            stats = {rid: self._replicas[rid].engine.replica_stats()
                     for rid in group
                     if self._replicas[rid].engine is not None
                     and self._health.serving(rid)}

            def frac(st):
                return st["pages_free"] / st["pages_total"] \
                    if st["pages_total"] else 0.0

            hot = [r for r in sorted(stats)
                   if frac(stats[r]) < self.shed_free_frac
                   and stats[r]["active_slots"] > 1]
            cold = [r for r in sorted(stats)
                    if frac(stats[r]) > self.shed_target_free_frac]
            if not hot or not cold:
                continue
            src = min(hot, key=lambda r: (frac(stats[r]), r))
            dst = max(cold, key=lambda r: (frac(stats[r]), r))
            if src == dst:
                continue
            try:
                moved += self.shed(src, dst)
            except FleetError:
                continue             # no capacity this step; retry later
        return moved

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Router-level counters + per-replica aggregate prefix stats —
        what the fleet's callers report."""
        per = {}
        hit = looked = 0.0
        for rid, rep in self._replicas.items():
            if rep.engine is None:
                per[rid] = {"state": self._health.state(rid)}
                continue
            pm = rep.engine.pool_metrics()
            hit += pm.get("prefix_hit_tokens", 0.0)
            looked += pm.get("prefix_lookup_tokens", 0.0)
            per[rid] = {
                "state": self._health.state(rid),
                "pages_free": pm.get("pages_free", 0.0),
                "active_slots": len(rep.engine.active_slot_ids()),
                "prefix_hit_tokens": pm.get("prefix_hit_tokens", 0.0),
                "prefix_lookup_tokens": pm.get("prefix_lookup_tokens",
                                               0.0),
                "requests_shed_total": pm.get("requests_shed_total", 0.0),
                "requests_resumed_total": pm.get("requests_resumed_total",
                                                 0.0),
            }
        return {
            "replicas": per,
            "pools": (None if self._pools is None
                      else {k: list(v) for k, v in self._pools.items()}),
            "handoffs": self._handoffs,
            "aggregate_prefix_hit_rate": hit / looked if looked else 0.0,
            "degraded_routes": self._degraded,
            "store_errors": self._store_errors,
            "health_states": self._health.counts(),
            "failovers": self._failovers,
            "replayed_tokens": self._replayed_tokens,
            "requests_lost": self._lost,
            "deadline_expired": self._expired,
            "journal_inflight": len(self._journal),
            "journal_delivered_tokens": self._journal.delivered_tokens_total,
        }
