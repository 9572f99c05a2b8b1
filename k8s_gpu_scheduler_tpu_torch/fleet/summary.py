"""Replica state summaries — the routing substrate of the fleet tier (copy
of the JAX package's ``fleet/summary.py``).

A serving replica (one paged ``ContinuousBatcher``) publishes a compact
summary of what a cache-aware router needs: what it has cached (a radix
digest — the top-K hottest cached token-prefix paths,
``PrefixCache.digest``) and how loaded it is (free-page watermark, active
slots, queue depth, prefill backlog, per-phase latency p50s drawn from
the same ``pool_metrics()`` phase batch the Prometheus export consumes).
The summary rides the registry under ``replica/<fleet>/<id>``; writer
and reader share the one schema defined here, and the lister reads the
keys in chunked MGETs.

``prefix_match_len`` is the router's scoring primitive: how many prompt
tokens a replica would serve from its cache, computed against the digest,
page-aligned and capped one page below full cover as
``PrefixCache.match`` is (admission always prefills the last page).
Truncated digest paths under-claim, never over-claim. Tiered replicas
publish a third element per path, the resident token length, and
``prefix_match_parts`` splits a match into resident tokens and demoted
tokens that pay a promotion upload.

``MemoryStore`` is the in-process registry stand-in (the
get/set/get_keys/mget/delete subset of ``registry.Client``); production
passes the real RESP client.

Wire format: ``to_json``'s field set is the registry heartbeat schema
every router of a fleet parses, the JAX package's too. It evolves only by
adding a dataclass field with a default; only ``replica`` has none.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..registry.inventory import REPLICA_KEY_PREFIX, replica_key


@dataclass
class ReplicaSummary:
    """One replica's published state: identity + seq/wall for staleness,
    pool watermarks + slot occupancy for load, per-phase p50s for the
    DistServe-style pressure split (decode p50 = TPOT pressure, prefill
    p50 = TTFT pressure), and the cache digest for prefix affinity."""

    replica: str
    fleet: str = "fleet"
    seq: int = 0
    published_wall: float = 0.0        # Clock.wall() — crosses processes
    page_size: int = 1
    pages_total: int = 0
    pages_free: int = 0
    n_slots: int = 0
    active_slots: int = 0
    queued: int = 0
    decode_p50_s: float = 0.0
    prefill_p50_s: float = 0.0
    # Admitted-but-unfinished prefill tokens (chunked prefill — the
    # engine's _prefill_backlog). Slots/pages alone cannot see a
    # long-prompt flood: a replica grinding through chunked prefills
    # looks as "free" as an idle one on those axes, so without this
    # field the router keeps landing new long prompts on it. Default 0
    # keeps pre-chunking summaries parsing.
    prefill_backlog_tokens: int = 0
    # Island width (multi-chip sharded serving, models/serving.py
    # mesh=): replicas of different tp coexist in one fleet — snapshots
    # are mesh-agnostic, so shed/failover crosses tp boundaries freely —
    # and operators read this to tell scale-UP replicas from scale-OUT
    # ones. Default 1 keeps pre-sharding summaries parsing.
    tp: int = 1
    # Per-chip model-weight residency (Megatron-sliced weights,
    # models/serving.py weight_sharding): 1/tp-sliced projections + the
    # replicated remainder — the capacity axis that distinguishes a
    # replica that actually FITS big weights per chip from a
    # replicated-weight one at the same tp. Default 0 keeps
    # pre-weight-sharding summaries parsing.
    weight_device_bytes: int = 0
    # Host-DRAM tier occupancy (KV tiering, models/serving.py
    # kv_tiering=): pages held off-pool that a match can promote back.
    # Capacity signal only — the per-path upload cost lives in the
    # digest tier flags below. Default 0 keeps pre-tiering summaries
    # parsing.
    dram_cached_pages: int = 0
    # Pool role (disaggregated serving, fleet/router.py pools=): which
    # phase this replica serves — "prefill" (admission + chunked
    # prefill, hands completed prefills off), "decode" (receives
    # handoffs), or "mixed" (colocated, today's engine). Default
    # "mixed" keeps pre-disagg summaries parsing.
    role: str = "mixed"
    # Lifetime speculative accept rate (proposals accepted / proposed,
    # models/serving.py spec gauges): how well this replica's current
    # traffic mix speculates — a router can prefer high-accept replicas
    # for throughput-priority requests. 0.0 on non-speculative replicas
    # and (default) on pre-speculation summaries.
    spec_accept_rate: float = 0.0
    # [(token path, full cached token length)], hottest first. Tiered
    # replicas publish 3-tuples (token path, cached length, RESIDENT
    # length): resident tokens hit for free, the demoted remainder
    # (cached - resident) pays a DRAM→HBM upload at admission. 2-tuples
    # (untiered replicas, pre-tiering summaries) mean fully resident.
    digest: List[Tuple[List[int], int]] = field(default_factory=list)

    def to_json(self) -> str:
        d = asdict(self)
        d["digest"] = [[list(map(int, e[0]))] + [int(x) for x in e[1:]]
                       for e in self.digest]
        return json.dumps(d, sort_keys=True)

    @staticmethod
    def from_json(raw: str) -> "ReplicaSummary":
        d = json.loads(raw)
        digest = [tuple([list(map(int, e[0]))] + [int(x) for x in e[1:]])
                  for e in d.pop("digest", [])]
        return ReplicaSummary(digest=digest, **d)

    @property
    def free_frac(self) -> float:
        return self.pages_free / self.pages_total if self.pages_total \
            else 0.0

    @property
    def free_slot_frac(self) -> float:
        return (1.0 - self.active_slots / self.n_slots) if self.n_slots \
            else 0.0


def summarize(engine, replica: str, fleet: str = "fleet", seq: int = 0,
              now_wall: float = 0.0, decode_p50_s: float = 0.0,
              prefill_p50_s: float = 0.0, top_k: int = 8,
              max_tokens: int = 512) -> ReplicaSummary:
    """Build a summary from a live engine's ``replica_stats()`` +
    ``cache_digest()`` (both cheap host reads — no device sync). The
    phase p50s come from the CALLER (the router keeps rolling windows
    over the ``pool_metrics()`` phase batches it already drains for the
    Prometheus export, so summarize never steals the batch)."""
    st = engine.replica_stats()
    return ReplicaSummary(
        replica=replica, fleet=fleet, seq=seq, published_wall=now_wall,
        page_size=int(st["page_size"]), pages_total=int(st["pages_total"]),
        pages_free=int(st["pages_free"]), n_slots=int(st["n_slots"]),
        active_slots=int(st["active_slots"]), queued=int(st["queued"]),
        decode_p50_s=float(decode_p50_s),
        prefill_p50_s=float(prefill_p50_s),
        prefill_backlog_tokens=int(st.get("prefill_backlog_tokens", 0)),
        tp=int(st.get("tp", 1)),
        weight_device_bytes=int(st.get("weight_device_bytes", 0)),
        dram_cached_pages=int(st.get("dram_cached_pages", 0)),
        role=str(st.get("role", "mixed")),
        spec_accept_rate=float(st.get("spec_accept_rate", 0.0)),
        digest=engine.cache_digest(top_k, max_tokens),
    )


def prefix_match_parts(prompt: Sequence[int],
                       digest: Sequence[Tuple[Sequence[int], int]],
                       page_size: int) -> Tuple[int, int]:
    """``(match tokens, resident tokens)`` a replica with this digest
    would serve for ``prompt``: the longest common token prefix against
    any digest path, floored to page granularity and capped so at least
    the prompt's last page prefills — the exact shape of
    ``PrefixCache.match``'s answer, predicted from the digest alone.
    ``resident`` ≤ ``match`` is the portion already in HBM; the
    remainder is demoted to the DRAM tier and pays a promotion upload
    at admission (2-tuple digest entries count as fully resident). Best
    entry by total match, resident length breaking ties — two replicas
    covering the same prefix differ only in upload cost."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    best, best_res = 0, 0
    for entry in digest:
        tokens, cached_len = entry[0], int(entry[1])
        res_len = int(entry[2]) if len(entry) > 2 else cached_len
        m = 0
        for a, b in zip(prompt, tokens):
            if int(a) != int(b):
                break
            m += 1
        cand = min(m, cached_len)
        cand_res = min(cand, res_len)
        if cand > best or (cand == best and cand_res > best_res):
            best, best_res = cand, cand_res
    match = _page_floor(best, len(prompt), page_size)
    resident = min(match, _page_floor(best_res, len(prompt), page_size))
    return match, resident


def _page_floor(tokens: int, prompt_len: int, page_size: int) -> int:
    pages = tokens // page_size
    if pages and pages * page_size == prompt_len:
        pages -= 1                   # the last page always re-prefills
    return pages * page_size


def prefix_match_len(prompt: Sequence[int],
                     digest: Sequence[Tuple[Sequence[int], int]],
                     page_size: int) -> int:
    """Total cached-prefix tokens (resident + demoted) — see
    ``prefix_match_parts`` for the tier split."""
    return prefix_match_parts(prompt, digest, page_size)[0]


def publish_summary(client, summary: ReplicaSummary) -> None:
    """Replica-side write (the profiler-client pattern, typed)."""
    client.set(replica_key(summary.fleet, summary.replica),
               summary.to_json())


def list_summaries(client, fleet: str) -> Dict[str, ReplicaSummary]:
    """Router-side listing: one chunked MGET per 512 replicas (the
    ``list_inventories`` pattern — kvstored's RESP reader caps a command
    at 1024 array elements). Unparseable values are skipped, not
    fatal — one corrupt writer must not blind the router to the rest of
    the fleet."""
    keys = client.get_keys(f"{REPLICA_KEY_PREFIX}{fleet}/*")
    if not keys:
        return {}
    mget = getattr(client, "mget", None)
    if callable(mget):
        values: List[Optional[str]] = []
        for i in range(0, len(keys), 512):
            values.extend(mget(*keys[i:i + 512]))
    else:
        values = [client.get(k) for k in keys]
    out: Dict[str, ReplicaSummary] = {}
    for raw in values:
        if raw is None:
            continue
        try:
            s = ReplicaSummary.from_json(raw)
        except (ValueError, TypeError, KeyError):
            continue
        if s.fleet == fleet:
            out[s.replica] = s
    return out


class MemoryStore:
    """Dict-backed stand-in for the registry ``Client`` subset the fleet
    uses (get/set/get_keys/mget/delete) — the in-process default so a
    single-binary fleet routes without a kvstored; swap in the real RESP
    client for a shared multi-process registry. No locking: the router
    drives it from one thread, and the real concurrent store is the
    registry server itself."""

    def __init__(self) -> None:
        self._kv: Dict[str, str] = {}

    def set(self, key: str, value: str) -> None:
        self._kv[key] = str(value)

    def get(self, key: str) -> Optional[str]:
        return self._kv.get(key)

    def mget(self, *keys: str) -> List[Optional[str]]:
        return [self._kv.get(k) for k in keys]

    def get_keys(self, pattern: str = "*") -> List[str]:
        if pattern.endswith("*"):
            pre = pattern[:-1]
            return sorted(k for k in self._kv if k.startswith(pre))
        return sorted(k for k in self._kv if k == pattern)

    def delete(self, *keys: str) -> int:
        return sum(1 for k in keys if self._kv.pop(k, None) is not None)
