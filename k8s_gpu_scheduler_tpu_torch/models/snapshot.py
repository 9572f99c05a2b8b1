"""Serving-engine snapshots: the paged engine's drain/restore state (copy
of the JAX package's ``models/snapshot.py``, numpy only; the wire format
is unchanged).

A ``ServingSnapshot`` is the paged ``ContinuousBatcher``'s whole state
machine on the host: the bytes of every referenced pool page (live slots'
own and mounted pages, prefix-tree pages) as ``[L, R, ps, Hkv, hd]``
arrays plus the int8 scale planes, the old page ids of those R rows (a
restore re-lays them out through the fresh engine's allocator, into any
``n_pages``), the per-slot machine (block-table rows, ``lens``, ``last``,
slot bindings, page lists, prompts), the host bookkeeping (budgets,
emitted streams, the queue, eos scan offsets, the id counter, arrival and
first-token clocks, rebased at restore), the prefix tree as token paths
in LRU order, the host tier's pages coldest first, and the adaptive-gamma
state. Speculative proposals are not kept: they are recomputed from the
token mirrors. ``to_pytree``/``from_pytree`` turn it into a dict of numpy
arrays (the bookkeeping rides as one JSON document in a uint8 vector);
``models/lifecycle.py`` writes that dict to disk.

**bf16 pages.** numpy has no bfloat16, so a bf16 pool's pages are held
on the host as their raw 16-bit words (``np.uint16``), and the meta doc's
``payload_dtype`` says ``"bfloat16"``, as the JAX package writes it. An
incoming array whose dtype is named ``bfloat16`` (the JAX package's
``ml_dtypes`` arrays) is taken as its words, bit for bit. f32 and int8
payloads keep their numpy dtypes, so their wire form is the JAX
package's byte for byte. A snapshot's ``flight`` ring (the engine's
flight recorder, ``obs/flight.py``) rides through: ``drain()`` ships the
ring and ``restore()`` seeds the fresh engine's recorder from it,
whichever package drained it.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

SNAPSHOT_VERSION = 1


def host_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a payload of element type ``name`` on
    the host: 16-bit words for ``"bfloat16"``, else ``np.dtype(name)``."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def as_words(a: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """A bfloat16 array (any numpy extension dtype of that name) as its
    raw 16-bit words; any other array, or None, unchanged."""
    if a is not None and np.asarray(a).dtype.name == "bfloat16":
        return np.asarray(a).view(np.uint16)
    return a


class SnapshotError(ValueError):
    """Snapshot/engine mismatch: restoring this snapshot into that
    engine cannot preserve the token streams (or cannot fit)."""


@dataclass
class ServingSnapshot:
    """One drained paged serving engine, host-resident. Produced by
    ``ContinuousBatcher.drain()``, consumed by ``.restore()``; see the
    module docstring for what each field carries."""

    fingerprint: Dict[str, Any]            # engine-compat contract
    page_ids: List[int]                    # old pool ids of the R rows
    k_pages: np.ndarray                    # [L, R, ps, Hkv, hd]
    v_pages: np.ndarray
    k_scales: Optional[np.ndarray]         # [L, R, ps, Hkv, 1] (int8 mode)
    v_scales: Optional[np.ndarray]
    table: np.ndarray                      # [n_slots, n_blocks] old ids
    lens: np.ndarray                       # [n_slots] int32
    last: np.ndarray                       # [n_slots] int32
    slot_req: Dict[int, int]               # slot -> req id
    slot_pages: Dict[int, List[int]]       # slot -> owned old page ids
    slot_shared: Dict[int, List[int]]      # slot -> mounted shared ids
    slot_prompt: Dict[int, List[int]]      # slot -> prompt tokens
    budgets: Dict[int, int]                # req id -> tokens remaining
    out: Dict[int, List[int]]              # req id -> emitted tokens
    queue: List[Tuple[int, List[int]]]     # waiting (req id, prompt)
    next_id: int
    eos_scanned: Dict[int, int]
    tree_paths: List[Tuple[List[int], List[int]]]  # (tokens, pages), LRU order
    arrival: Dict[int, float] = field(default_factory=dict)
    first_tok: Dict[int, float] = field(default_factory=dict)
    drained_mono: float = 0.0              # engine clock's monotonic()
    drained_wall: float = 0.0              # engine clock's wall()
    skipped_tokens: int = 0
    # The draining engine's flight-recorder ring (JSON-safe per-step
    # records), seeded into the restoring engine's recorder. Default []
    # keeps older snapshots loading.
    flight: List[Dict[str, Any]] = field(default_factory=list)
    # PARTIAL snapshot (load shedding): a filter over ``slot_req`` —
    # only the shed slots' pages/bookkeeping, no queue, no prefix tree,
    # and the SOURCE engine keeps running. Consumed by
    # ``ContinuousBatcher.absorb()`` (which merges into a BUSY engine);
    # ``restore()`` rejects it — a partial snapshot is not a whole
    # engine. Default False keeps older snapshots loading.
    partial: bool = False
    # KV tiering (serving ``kv_tiering=True``): the host-DRAM tier's
    # committed page payloads, COLDEST FIRST (disk spills coldest of
    # all), so a restore into a smaller ``dram_pages`` budget keeps the
    # hottest tail. ``tree_paths`` reference a demoted chunk as
    # ``-(key + 1)`` — restore remaps the keys and truncates any path
    # whose entry was dropped. All default-empty: pre-tiering snapshots
    # load unchanged, untiered engines never populate them, and an
    # untiered RESTORE target simply drops the payloads.
    tier_keys: List[int] = field(default_factory=list)
    tier_k: Optional[np.ndarray] = None    # [L, R2, ps, Hkv, hd]
    tier_v: Optional[np.ndarray] = None
    tier_ks: Optional[np.ndarray] = None   # [L, R2, ps, Hkv, 1] (int8)
    tier_vs: Optional[np.ndarray] = None
    # Adaptive speculative gamma (serving ``spec_adaptive=True``): per-
    # request accept-rate EMAs, last effective windows, and the PINNED
    # overshoot-row reservations admission sized each request's pages
    # for, plus the fleet-level EMA that seeds new admissions. All
    # default-empty/1.0: pre-adaptive snapshots load unchanged and
    # non-adaptive engines ship empty dicts (the full gamma is then the
    # implicit reservation, exactly what their admission reserved).
    spec_ema: Dict[int, float] = field(default_factory=dict)
    spec_eff: Dict[int, int] = field(default_factory=dict)
    spec_reserve: Dict[int, int] = field(default_factory=dict)
    spec_fleet_ema: float = 1.0

    def __post_init__(self) -> None:
        for name in ("k_pages", "v_pages", "tier_k", "tier_v"):
            setattr(self, name, as_words(getattr(self, name)))

    # -- derived -----------------------------------------------------------
    @property
    def n_requests_in_flight(self) -> int:
        """Interrupted requests this snapshot can resume: slots mid-decode
        plus the still-waiting queue."""
        return len(self.slot_req) + len(self.queue)

    def nbytes(self) -> int:
        """Approximate serialized size — the number chip_smoke.py prints
        (page payload dominates; the JSON sidecar is KiBs)."""
        n = self.k_pages.nbytes + self.v_pages.nbytes
        if self.k_scales is not None:
            n += self.k_scales.nbytes + self.v_scales.nbytes
        for arr in (self.tier_k, self.tier_v, self.tier_ks,
                    self.tier_vs):
            if arr is not None:
                n += arr.nbytes
        n += self.table.nbytes + self.lens.nbytes + self.last.nbytes
        n += len(json.dumps(self._meta_doc()).encode())
        return n

    def validate(self) -> None:
        """Internal consistency: every page id referenced by a slot row or
        tree path must be in ``page_ids`` (its bytes shipped), page ids
        unique, array row count == len(page_ids)."""
        ids = list(self.page_ids)
        if len(ids) != len(set(ids)):
            raise SnapshotError(f"duplicate page ids in snapshot: {ids}")
        have = set(ids)
        if self.k_pages.shape[1] != len(ids) or \
                self.v_pages.shape[1] != len(ids):
            raise SnapshotError(
                f"page payload rows {self.k_pages.shape[1]} != "
                f"{len(ids)} page ids")
        referenced: set = set()
        for slot, pages in self.slot_pages.items():
            referenced.update(pages)
        for slot, pages in self.slot_shared.items():
            referenced.update(pages)
        demoted_ref: set = set()
        for _, pages in self.tree_paths:
            for p in pages:
                p = int(p)
                if p < 0:          # demoted chunk: -(tier key + 1)
                    demoted_ref.add(-p - 1)
                else:
                    referenced.add(p)
        missing = referenced - have
        if missing:
            raise SnapshotError(
                f"referenced pages missing payloads: {sorted(missing)}")
        tkeys = [int(k) for k in self.tier_keys]
        if len(tkeys) != len(set(tkeys)):
            raise SnapshotError(f"duplicate tier keys: {tkeys}")
        if self.partial and tkeys:
            raise SnapshotError(
                "partial snapshot must not carry a DRAM tier")
        missing_tier = demoted_ref - set(tkeys)
        if missing_tier:
            raise SnapshotError(
                f"tree paths reference demoted pages whose tier "
                f"payloads did not ship: keys {sorted(missing_tier)}")
        if tkeys:
            if self.tier_k is None or self.tier_v is None:
                raise SnapshotError(
                    f"{len(tkeys)} tier keys but no tier payload")
            if self.tier_k.shape[1] != len(tkeys) or \
                    self.tier_v.shape[1] != len(tkeys):
                raise SnapshotError(
                    f"tier payload rows {self.tier_k.shape[1]} != "
                    f"{len(tkeys)} tier keys")
        for rid in self.slot_req.values():
            if rid not in self.budgets:
                raise SnapshotError(f"in-flight request {rid} has no budget")

    # -- pytree codec ------------------------------------------------------
    def _meta_doc(self) -> Dict[str, Any]:
        """The host bookkeeping as one JSON-safe document. Dicts with int
        keys ride as pair lists (JSON would silently stringify the
        keys)."""
        return {
            "version": SNAPSHOT_VERSION,
            "fingerprint": self.fingerprint,
            "page_ids": [int(p) for p in self.page_ids],
            "slot_req": [[int(s), int(r)] for s, r in self.slot_req.items()],
            "slot_pages": [[int(s), [int(p) for p in pg]]
                           for s, pg in self.slot_pages.items()],
            "slot_shared": [[int(s), [int(p) for p in pg]]
                            for s, pg in self.slot_shared.items()],
            "slot_prompt": [[int(s), [int(t) for t in pr]]
                            for s, pr in self.slot_prompt.items()],
            "budgets": [[int(r), int(b)] for r, b in self.budgets.items()],
            "out": [[int(r), [int(t) for t in ts]]
                    for r, ts in self.out.items()],
            "queue": [[int(r), [int(t) for t in pr]]
                      for r, pr in self.queue],
            "next_id": int(self.next_id),
            "eos_scanned": [[int(r), int(n)]
                            for r, n in self.eos_scanned.items()],
            "tree_paths": [[[int(t) for t in toks], [int(p) for p in pgs]]
                           for toks, pgs in self.tree_paths],
            "arrival": [[int(r), float(t)] for r, t in self.arrival.items()],
            "first_tok": [[int(r), float(t)]
                          for r, t in self.first_tok.items()],
            "drained_mono": float(self.drained_mono),
            "drained_wall": float(self.drained_wall),
            "skipped_tokens": int(self.skipped_tokens),
            "flight": list(self.flight),
            "partial": bool(self.partial),
            # Payload geometry, so a ZERO-page snapshot (drain with all
            # slots finished — only the queue ships) can omit its empty
            # arrays from the pytree; from_pytree rebuilds them from here.
            "payload_shape": [int(x) for x in self.k_pages.shape],
            "payload_dtype": self._payload_dtype(),
            "has_scales": self.k_scales is not None,
            # DRAM-tier sidecar (absent-tolerant on load): the payload
            # arrays ride the pytree like the page payload; empty tiers
            # ship nothing.
            "tier_keys": [int(k) for k in self.tier_keys],
            # Adaptive-gamma sidecar (absent-tolerant on load, same
            # convention): int-keyed dicts as pair lists.
            "spec_ema": [[int(r), float(v)]
                         for r, v in self.spec_ema.items()],
            "spec_eff": [[int(r), int(v)]
                         for r, v in self.spec_eff.items()],
            "spec_reserve": [[int(r), int(v)]
                             for r, v in self.spec_reserve.items()],
            "spec_fleet_ema": float(self.spec_fleet_ema),
        }

    def _payload_dtype(self) -> str:
        """The pages' element type as the JAX package names it: a bf16
        engine's 16-bit words are ``"bfloat16"``."""
        name = str(np.asarray(self.k_pages).dtype)
        if name == "uint16" and self.fingerprint.get("dtype") == "bfloat16":
            return "bfloat16"
        return name

    def to_pytree(self) -> Dict[str, np.ndarray]:
        """A pure-numpy dict: arrays as themselves, host bookkeeping as
        JSON bytes in a uint8 vector."""
        meta = np.frombuffer(
            json.dumps(self._meta_doc()).encode("utf-8"), dtype=np.uint8
        ).copy()
        tree: Dict[str, np.ndarray] = {
            "meta_json": meta,
            "table": np.asarray(self.table),
            "lens": np.asarray(self.lens),
            "last": np.asarray(self.last),
        }
        # Zero-size payloads stay out of the pytree (the JAX package's
        # checkpointer cannot write them); the meta doc's payload_shape
        # and payload_dtype rebuild them.
        if np.asarray(self.k_pages).size:
            tree["k_pages"] = np.asarray(self.k_pages)
            tree["v_pages"] = np.asarray(self.v_pages)
        if self.k_scales is not None and np.asarray(self.k_scales).size:
            tree["k_scales"] = np.asarray(self.k_scales)
            tree["v_scales"] = np.asarray(self.v_scales)
        if self.tier_k is not None and np.asarray(self.tier_k).size:
            tree["tier_k"] = np.asarray(self.tier_k)
            tree["tier_v"] = np.asarray(self.tier_v)
        if self.tier_ks is not None and np.asarray(self.tier_ks).size:
            tree["tier_ks"] = np.asarray(self.tier_ks)
            tree["tier_vs"] = np.asarray(self.tier_vs)
        return tree

    @classmethod
    def from_pytree(cls, tree: Dict[str, np.ndarray]) -> "ServingSnapshot":
        meta_arr = np.asarray(tree["meta_json"], dtype=np.uint8)
        doc = json.loads(bytes(meta_arr.tobytes()).decode("utf-8"))
        if doc.get("version") != SNAPSHOT_VERSION:
            raise SnapshotError(
                f"snapshot version {doc.get('version')} != "
                f"{SNAPSHOT_VERSION}")
        pairs = lambda key: {k: v for k, v in doc[key]}  # noqa: E731
        shape = tuple(doc.get("payload_shape", ()))
        dtype = host_dtype(doc.get("payload_dtype", "float32"))
        if "k_pages" in tree:
            k_pages = np.asarray(tree["k_pages"])
            v_pages = np.asarray(tree["v_pages"])
        else:                    # zero-page snapshot: payload omitted
            k_pages = np.zeros(shape, dtype)
            v_pages = np.zeros(shape, dtype)
        if "k_scales" in tree:
            k_scales = np.asarray(tree["k_scales"])
            v_scales = np.asarray(tree["v_scales"])
        elif doc.get("has_scales", False):
            k_scales = np.zeros(shape[:-1] + (1,), np.float32)
            v_scales = np.zeros(shape[:-1] + (1,), np.float32)
        else:
            k_scales = v_scales = None
        snap = cls(
            fingerprint=doc["fingerprint"],
            page_ids=list(doc["page_ids"]),
            k_pages=k_pages,
            v_pages=v_pages,
            k_scales=k_scales,
            v_scales=v_scales,
            table=np.asarray(tree["table"]),
            lens=np.asarray(tree["lens"]),
            last=np.asarray(tree["last"]),
            slot_req=pairs("slot_req"),
            slot_pages=pairs("slot_pages"),
            slot_shared=pairs("slot_shared"),
            slot_prompt=pairs("slot_prompt"),
            budgets=pairs("budgets"),
            out=pairs("out"),
            queue=[(r, list(p)) for r, p in doc["queue"]],
            next_id=doc["next_id"],
            eos_scanned=pairs("eos_scanned"),
            tree_paths=[(list(t), list(p)) for t, p in doc["tree_paths"]],
            arrival=pairs("arrival"),
            first_tok=pairs("first_tok"),
            drained_mono=doc["drained_mono"],
            drained_wall=doc["drained_wall"],
            skipped_tokens=doc["skipped_tokens"],
            flight=list(doc.get("flight", [])),
            partial=bool(doc.get("partial", False)),
            tier_keys=list(doc.get("tier_keys", [])),
            tier_k=(np.asarray(tree["tier_k"])
                    if "tier_k" in tree else None),
            tier_v=(np.asarray(tree["tier_v"])
                    if "tier_v" in tree else None),
            tier_ks=(np.asarray(tree["tier_ks"])
                     if "tier_ks" in tree else None),
            tier_vs=(np.asarray(tree["tier_vs"])
                     if "tier_vs" in tree else None),
            spec_ema={int(r): float(v)
                      for r, v in doc.get("spec_ema", [])},
            spec_eff={int(r): int(v)
                      for r, v in doc.get("spec_eff", [])},
            spec_reserve={int(r): int(v)
                          for r, v in doc.get("spec_reserve", [])},
            spec_fleet_ema=float(doc.get("spec_fleet_ema", 1.0)),
        )
        snap.validate()
        return snap

    # -- clock re-basing ---------------------------------------------------
    def rebased_clock(self, rid_ts: Dict[int, float],
                      now_mono: float, now_wall: float) -> Dict[int, float]:
        """Translate drained ``time.monotonic`` timestamps into the
        restoring process's monotonic frame, charging the real downtime
        (wall-clock drain→restore) to every in-flight request:
        ``now - new_ts == (drained_mono - old_ts) + downtime``. Across a
        process boundary the raw values would be meaningless (monotonic
        clocks share no epoch); rebased, TTFT/latency records stay
        honest — including the preemption gap itself."""
        downtime = max(0.0, now_wall - self.drained_wall)
        return {
            rid: now_mono - downtime - (self.drained_mono - ts)
            for rid, ts in rid_ts.items()
        }


def check_fingerprint(snap_fp: Dict[str, Any],
                      engine_fp: Dict[str, Any]) -> None:
    """Every fingerprint key except the pool size must match: page_size/
    layout/dtype mismatches would silently corrupt KV addressing, and
    chunk/gamma/spec mismatches would break the worst-case page
    reservations already encoded in the slot state. ``n_pages`` is
    exempt — re-layout through the allocator is the design."""
    for key in sorted(set(snap_fp) | set(engine_fp)):
        if key == "n_pages":
            continue
        if snap_fp.get(key) != engine_fp.get(key):
            raise SnapshotError(
                f"snapshot/engine mismatch on {key!r}: snapshot has "
                f"{snap_fp.get(key)!r}, engine has {engine_fp.get(key)!r}")
