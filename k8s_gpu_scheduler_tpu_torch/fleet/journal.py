"""Router-side request journal — the record a crash cannot lose (copy of
the JAX package's ``fleet/journal.py``).

An engine's in-flight state dies with it on a hard crash (no drain, no
snapshot). What must survive is the router's record of what was promised
and what was already delivered: for every fleet request, ``(frid, prompt,
max_new, trace_id, routed-to, deadline)`` written at ``submit()`` and the
delivered tokens appended after every ``step()``. With greedy decode that
record makes recovery token-identical: failover re-submits ``prompt +
delivered`` (less a small verify window) to a surviving replica, checks
the regenerated window against the journal, and streams only the
undelivered suffix (``fleet/router.py`` ``_failover``).

``to_pytree`` packs one JSON doc into a uint8 array, as
``ServingSnapshot`` carries its host bookkeeping, so
``models/lifecycle.persist_journal`` writes it as an ``.npz`` step
directory and a restarted router re-opens it and replays every open
entry. Closed entries leave the map at once (the journal holds in-flight
state, not history), but their token counts stay in the monotonic
counters the ``tpu_fleet_*`` metrics read.

Wire format: the version-1 doc is the JAX package's; journals cross
between the packages. It evolves by adding a ``JournalEntry`` field with
a default; removing or retyping one needs a version bump.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np

# Entry outcomes (close reasons).
DONE = "done"          # stream complete, delivered to the caller
ERROR = "error"        # surfaced failure (poison request, replay divergence)
EXPIRED = "expired"    # per-request deadline passed (submit(deadline_s=))
OUTCOMES = (DONE, ERROR, EXPIRED)


class JournalError(RuntimeError):
    """Journal misuse (unknown frid, double close, bad codec input)."""


@dataclass
class JournalEntry:
    """One fleet request's durable record. ``replica`` tracks where it
    currently computes (updated on shed and failover; None while
    orphaned — dead replica, no live target yet). ``delivered`` is the
    tokens the ROUTER has observed and streamed — the replay baseline;
    tokens an engine emitted but the router never read die with it, and
    replay regenerates them. ``deadline_wall`` is absolute wall clock
    (it must survive a router restart; monotonic clocks do not)."""

    frid: int
    prompt: List[int]
    max_new: int
    trace_id: Optional[str] = None
    replica: Optional[str] = None
    deadline_wall: Optional[float] = None
    submitted_wall: float = 0.0
    delivered: List[int] = field(default_factory=list)
    failovers: int = 0

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.delivered)


class RequestJournal:
    """In-flight fleet requests + monotonic loss-accounting counters.
    Single-threaded like the router that owns it (the durable copy is
    the persisted copy, not a lock)."""

    def __init__(self) -> None:
        self._next_frid = 0
        self._open: Dict[int, JournalEntry] = {}
        # Monotonic counters (survive entry closure and the pytree
        # round trip): the fleet metrics read these.
        self.delivered_tokens_total = 0
        self.closed = {o: 0 for o in OUTCOMES}

    # -- lifecycle ---------------------------------------------------------
    def open(self, prompt: List[int], max_new: int,
             trace_id: Optional[str] = None,
             replica: Optional[str] = None,
             deadline_wall: Optional[float] = None,
             submitted_wall: float = 0.0) -> int:
        """Record one submission; allocates and returns its fleet id
        (the journal owns the namespace so ids stay unique across a
        router restart)."""
        frid = self._next_frid
        self._next_frid += 1
        self._open[frid] = JournalEntry(
            frid=frid, prompt=[int(t) for t in prompt],
            max_new=int(max_new), trace_id=trace_id, replica=replica,
            deadline_wall=deadline_wall, submitted_wall=submitted_wall)
        return frid

    def entry(self, frid: int) -> JournalEntry:
        try:
            return self._open[frid]
        except KeyError:
            raise JournalError(f"unknown or closed fleet request {frid}") \
                from None

    def deliver(self, frid: int, tokens: List[int]) -> None:
        """Append newly delivered tokens (the router calls this after
        every step with each in-flight request's progress delta). The
        budget check runs BEFORE the mutation: an over-emitting engine
        (an accounting bug upstream) must not corrupt the entry — the
        journal is the recovery truth, and a negative ``remaining``
        would replay with an impossible budget."""
        if not tokens:
            return
        e = self.entry(frid)
        if len(e.delivered) + len(tokens) > e.max_new:
            raise JournalError(
                f"request {frid} would deliver "
                f"{len(e.delivered) + len(tokens)} tokens, "
                f"budget {e.max_new}")
        e.delivered.extend(int(t) for t in tokens)
        self.delivered_tokens_total += len(tokens)

    def reassign(self, frid: int, replica: Optional[str],
                 failover: bool = False) -> None:
        e = self.entry(frid)
        e.replica = replica
        if failover:
            e.failovers += 1

    def close(self, frid: int, outcome: str) -> JournalEntry:
        if outcome not in OUTCOMES:
            raise JournalError(f"unknown outcome {outcome!r}")
        e = self.entry(frid)
        del self._open[frid]
        self.closed[outcome] += 1
        return e

    # -- reads -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._open)

    def __contains__(self, frid: int) -> bool:
        return frid in self._open

    def open_frids(self) -> List[int]:
        return sorted(self._open)

    def inflight_on(self, replica: Optional[str]) -> List[JournalEntry]:
        """Open entries currently computing on ``replica`` (None = the
        orphans awaiting a live target), in frid order — the replay set
        a death or a rejoin walks."""
        return [self._open[f] for f in sorted(self._open)
                if self._open[f].replica == replica]

    def stream(self, frid: int) -> List[int]:
        """The full delivered stream — what the caller receives; for a
        failed-over request this is pre-crash delivery + replayed
        suffix, byte-equal to the no-fault stream."""
        return list(self.entry(frid).delivered)

    # -- codec (pure JSON in a numpy carrier, the snapshot convention) -----
    def to_pytree(self) -> Dict[str, np.ndarray]:
        doc = {
            "version": 1,
            "next_frid": self._next_frid,
            "delivered_tokens_total": self.delivered_tokens_total,
            "closed": dict(self.closed),
            "entries": [asdict(self._open[f]) for f in sorted(self._open)],
        }
        raw = json.dumps(doc, sort_keys=True).encode()
        return {"journal_doc": np.frombuffer(raw, dtype=np.uint8).copy()}

    @staticmethod
    def from_pytree(tree: Dict[str, np.ndarray]) -> "RequestJournal":
        # The whole decode is guarded: a truncated doc (partial
        # write at crash time — exactly the scenario this file exists
        # for) or a forward-versioned entry shape must surface as the
        # documented JournalError, not a raw JSONDecodeError/TypeError.
        try:
            raw = np.asarray(tree["journal_doc"], dtype=np.uint8)
            doc = json.loads(raw.tobytes().decode())
            if doc.get("version") != 1:
                raise JournalError(
                    f"unsupported journal version {doc.get('version')!r}")
            j = RequestJournal()
            j._next_frid = int(doc["next_frid"])
            j.delivered_tokens_total = int(doc["delivered_tokens_total"])
            j.closed.update({k: int(v) for k, v in doc["closed"].items()})
            for d in doc["entries"]:
                e = JournalEntry(**d)
                e.frid = int(e.frid)
                j._open[e.frid] = e
            return j
        except JournalError:
            raise
        except Exception as e:  # noqa: BLE001 — any malformed doc, one error type
            raise JournalError(f"not a journal pytree: {e}") from None
