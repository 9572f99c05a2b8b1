"""Host-side KV page allocator for the paged serving cache, and the host
tier behind the prefix cache (copy of the JAX package's
``models/paging.py``).

A LIFO free list over a fixed pool of pages; pages are REF-COUNTED so one
physical page can back many slots' block tables (a shared prefix) plus
the radix tree's own reference. ``alloc`` hands out pages at refcount 1,
``retain`` adds a holder, ``free`` drops one — a page returns to the free
list only when its last reference drops. The tree's reference is labeled
via ``adopt``/``drop_cached`` so the pool partitions cleanly into free /
held / cached for ``assert_consistent``.

Page 0 is the reserved null page: writes of inactive slots and of a
padded prefill's overshooting tail land there, and zeroed block-table
rows point at it. Its contents are garbage by design and only ever read
under a length mask.

``HostTierStore`` is the host-DRAM second tier (and optional disk third
tier) of ``kv_tiering`` engines: pages the prefix cache demotes instead of
forgetting, keyed by ints of their own namespace (never a block-table
entry), each one payload ``(k, v, k_scale, v_scale)`` of numpy arrays.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

NULL_PAGE = 0


class HostTierStore:
    """Host-DRAM second tier (plus an optional disk third tier) for
    DEMOTED KV pages — the off-pool half of the tiered cache
    (vLLM-CPU-offload / LMCache-style hierarchy) behind the radix tree.

    Entries are keyed by monotonic ints (a separate namespace from pool
    page ids — a tier key is never a valid block-table entry) and hold a
    page's host-numpy payload ``(k, v, k_scale, v_scale)`` with the
    scale planes ``None`` for non-int8 engines. Lifecycle:

    - ``reserve(page)`` registers a PENDING demotion: the tree node is
      already tier-flagged but the bytes still live in the pool page,
      which stays allocated+cached until the engine's device→host
      readback queue drains at a step boundary (one batched copy per
      boundary, never one per page inside a dispatch). A pending
      entry can be ``cancel``-ed — the mid-match race where a new
      request lands on the path before the drain: the retain pin wins
      and the demotion is undone for free.
    - ``commit(key, payload)`` lands the gathered bytes in DRAM. Over
      ``dram_pages`` capacity the coldest COMMITTED entry that
      ``can_evict`` approves is shed first — spilled to the disk tier
      when ``disk_dir`` is set (demote-before-forget, disk only when
      DRAM is full), forgotten otherwise (``on_drop`` lets the tree
      prune the node). If nothing is evictable the INCOMING entry is
      refused (returns False) and the caller forgets it instead.
    - ``pop(key)`` removes and returns the payload for promotion back
      into freshly-reserved pool pages, transparently loading a
      disk-spilled entry.

    ``can_evict`` exists because only CHILDLESS demoted leaves may
    leave the tier: dropping a mid-path node would strand descendants
    whose match walk can no longer reach them.
    """

    def __init__(self, dram_pages: int,
                 disk_dir: Optional[str] = None) -> None:
        if dram_pages < 1:
            raise ValueError(f"dram_pages must be >= 1, got {dram_pages}")
        self.dram_pages = int(dram_pages)
        self.disk_dir = disk_dir
        self._next_key = 0
        self._pending: "OrderedDict[int, int]" = OrderedDict()  # key -> page
        self._dram: "OrderedDict[int, tuple]" = OrderedDict()   # key -> payload
        self._disk: Set[int] = set()
        # Tier-policy callbacks the radix tree installs (see class doc).
        self.can_evict: Callable[[int], bool] = lambda key: True
        self.on_drop: Callable[[int], None] = lambda key: None
        self._demotions = 0                  # commits (pages landed in DRAM)
        self._spills = 0                     # DRAM -> disk
        self._forgotten = 0                  # shed with nowhere to go
        self._cancelled = 0                  # pending demotions undone

    def __len__(self) -> int:
        """Committed pages in the tier (DRAM + disk)."""
        return len(self._dram) + len(self._disk)

    @property
    def dram_count(self) -> int:
        return len(self._dram)

    @property
    def disk_count(self) -> int:
        return len(self._disk)

    def has(self, key: int) -> bool:
        return key in self._dram or key in self._disk

    def is_pending(self, key: int) -> bool:
        return key in self._pending

    def reserve(self, page: int) -> int:
        """Register a pending demotion of pool ``page``; returns the new
        tier key. The page's bytes are copied later (``commit``) by the
        step-boundary readback drain."""
        key = self._next_key
        self._next_key += 1
        self._pending[key] = int(page)
        return key

    def cancel(self, key: int) -> int:
        """Undo a pending demotion (the page was re-matched before the
        drain — retain pins win); returns the pool page to restore."""
        page = self._pending.pop(key)
        self._cancelled += 1
        return page

    def take_pending(self) -> List[Tuple[int, int]]:
        """Drain the pending queue: ``(key, page)`` pairs in demotion
        order. Called by the engine at a step boundary with the gathered
        bytes committed per pair."""
        out = list(self._pending.items())
        self._pending.clear()
        return out

    def _disk_path(self, key: int) -> str:
        return os.path.join(self.disk_dir, f"kvpage_{key}.npz")

    def _shed_coldest(self) -> bool:
        """Make room for one entry: spill (or forget) the coldest
        evictable committed entry. False when nothing is evictable."""
        for key in self._dram:               # insertion order == coldest first
            if not self.can_evict(key):
                continue
            payload = self._dram.pop(key)
            if self.disk_dir is not None:
                k, v, ks, vs = payload
                os.makedirs(self.disk_dir, exist_ok=True)
                arrs = {"k": k, "v": v}
                if ks is not None:
                    arrs.update(ks=ks, vs=vs)
                np.savez(self._disk_path(key), **arrs)
                self._disk.add(key)
                self._spills += 1
            else:
                self._forgotten += 1
                self.on_drop(key)
            return True
        return False

    def commit(self, key: int, payload: tuple) -> bool:
        """Land gathered page bytes for a pending ``key`` in DRAM,
        shedding the coldest evictable entry first when at capacity.
        Returns False (entry refused, caller forgets the node) when the
        tier is full and nothing can be shed."""
        self._pending.pop(key, None)
        while len(self._dram) >= self.dram_pages:
            if not self._shed_coldest():
                self._forgotten += 1
                return False
        self._dram[key] = payload
        self._demotions += 1
        return True

    def restore_entry(self, payload: tuple) -> Optional[int]:
        """Snapshot-restore path: admit an already-gathered payload under
        a fresh key (counts as a demotion landing). None when refused."""
        key = self._next_key
        self._next_key += 1
        return key if self.commit(key, payload) else None

    def touch(self, key: int) -> None:
        """LRU bump on a match walk through the demoted node."""
        if key in self._dram:
            self._dram.move_to_end(key)

    def pop(self, key: int) -> tuple:
        """Remove and return ``key``'s payload for promotion (loads a
        disk-spilled entry back through DRAM transparently)."""
        if key in self._dram:
            return self._dram.pop(key)
        if key in self._disk:
            self._disk.discard(key)
            path = self._disk_path(key)
            with np.load(path) as z:
                payload = (z["k"], z["v"],
                           z["ks"] if "ks" in z else None,
                           z["vs"] if "vs" in z else None)
            os.remove(path)
            return payload
        raise KeyError(f"tier key {key} is not committed")

    def discard(self, key: int) -> None:
        """Drop an entry without reading it (the chunk became resident
        again via a donated page carrying the same bytes)."""
        if key in self._dram:
            del self._dram[key]
        elif key in self._disk:
            self._disk.discard(key)
            try:
                os.remove(self._disk_path(key))
            except OSError:
                pass

    def items_coldest_first(self) -> List[Tuple[int, tuple]]:
        """Committed DRAM entries, coldest first — the serializable
        order a drain snapshot carries (disk-spilled entries are loaded
        too, coldest of all: they were shed before everything in DRAM)."""
        out = []
        for key in sorted(self._disk):       # read-only: tier unchanged
            with np.load(self._disk_path(key)) as z:
                out.append((key, (z["k"], z["v"],
                                  z["ks"] if "ks" in z else None,
                                  z["vs"] if "vs" in z else None)))
        out.extend(self._dram.items())
        return out

    def assert_consistent(self) -> None:
        """Tier invariants: pending/DRAM/disk key sets are disjoint,
        DRAM within capacity, keys below the monotonic cursor."""
        dram, disk, pend = set(self._dram), self._disk, set(self._pending)
        for a, b, what in ((dram, disk, "DRAM∩disk"),
                           (dram, pend, "DRAM∩pending"),
                           (disk, pend, "disk∩pending")):
            if a & b:
                raise RuntimeError(f"tier key in two states ({what}): "
                                   f"{sorted(a & b)}")
        if len(self._dram) > self.dram_pages:
            raise RuntimeError(
                f"DRAM tier over capacity: {len(self._dram)} > "
                f"{self.dram_pages}")
        over = [k for k in dram | disk | pend if k >= self._next_key]
        if over:
            raise RuntimeError(f"tier keys beyond cursor: {sorted(over)}")

    def metrics(self) -> Dict[str, float]:
        return {
            "tier_dram_pages": float(len(self._dram)),
            "tier_dram_capacity": float(self.dram_pages),
            "tier_disk_pages": float(len(self._disk)),
            "tier_pending_demotions": float(len(self._pending)),
            "page_demotions_total": float(self._demotions),
            "tier_spills_total": float(self._spills),
            "tier_forgotten_total": float(self._forgotten),
            "tier_cancelled_demotions": float(self._cancelled),
        }


class PageAllocator:
    """Fixed-size page pool bookkeeping. ``n_pages`` counts the whole pool
    including the null page, so ``n_pages - 1`` pages are usable."""

    def __init__(self, n_pages: int) -> None:
        if n_pages < 2:
            raise ValueError(
                f"need >= 2 pages (one is the reserved null page), got "
                f"{n_pages}")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, NULL_PAGE, -1))
        self._ref: Dict[int, int] = {}
        self._cached: Set[int] = set()
        self._tier: Optional[HostTierStore] = None
        self._watermark = 0
        self._allocs = 0
        self._frees = 0
        self._denied = 0

    def attach_tier(self, tier: HostTierStore) -> None:
        """Attach the host tier (kv_tiering engines): its invariants join
        ``assert_consistent`` and its gauges ride ``metrics()``."""
        self._tier = tier

    @property
    def tier(self) -> Optional[HostTierStore]:
        return self._tier

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._ref)

    def ref(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int,
              count_denied: bool = True) -> Optional[List[int]]:
        """n pages at refcount 1, or None when fewer than n are free
        (all-or-nothing). ``count_denied=False`` keeps retries of an
        already-counted request out of the denial counter."""
        if n < 0:
            raise ValueError(f"negative page count {n}")
        if n > len(self._free):
            if count_denied:
                self._denied += 1
            return None
        pages, self._free = self._free[len(self._free) - n:], \
            self._free[:len(self._free) - n]
        pages.reverse()
        for p in pages:
            self._ref[p] = 1
        self._watermark = max(self._watermark, len(self._ref))
        self._allocs += n
        return pages

    def retain(self, pages: Iterable[int]) -> None:
        """One more reference per page, validated before any change."""
        pages = list(pages)
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("cannot retain the reserved null page")
            if p not in self._ref:
                raise RuntimeError(
                    f"retain of free/foreign page {p}: only allocated "
                    f"pages can gain references")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: Iterable[int]) -> None:
        """Drop one reference per page, validated before any change: a
        double free would hand one physical page to two requests."""
        pages = list(pages)
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("cannot free the reserved null page")
            if p not in self._ref:
                raise RuntimeError(
                    f"double free (or foreign page): page {p} is not "
                    f"currently allocated")
        drops: Dict[int, int] = {}
        for p in pages:
            drops[p] = drops.get(p, 0) + 1
        for p, n in drops.items():
            if self._ref[p] < n:
                raise RuntimeError(
                    f"double free: page {p} freed {n}x with only "
                    f"{self._ref[p]} live reference(s)")
            if self._ref[p] == n and p in self._cached:
                raise RuntimeError(
                    f"page {p} is still cached by the prefix tree — its "
                    f"tree reference must drop via drop_cached, not free")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)
        self._frees += len(pages)

    def adopt(self, pages: Iterable[int]) -> None:
        """Re-label one existing reference per page as the prefix tree's."""
        pages = list(pages)
        for p in pages:
            if p not in self._ref:
                raise RuntimeError(f"adopt of free/foreign page {p}")
            if p in self._cached:
                raise RuntimeError(f"page {p} is already cached")
        self._cached.update(pages)

    def drop_cached(self, page: int) -> None:
        """Eviction: drop the tree's reference on ``page``."""
        if page not in self._cached:
            raise RuntimeError(f"page {page} is not cached")
        self._cached.discard(page)
        self.free([page])

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    def assert_consistent(self) -> None:
        """Free list, held pages and cached pages partition the usable
        pool: no page twice, none missing, positive refcounts, the null
        page in none of them."""
        usable = set(range(1, self.n_pages))
        free = list(self._free)
        if len(free) != len(set(free)):
            raise RuntimeError(f"free list holds duplicates: {sorted(free)}")
        free_s, held = set(free), set(self._ref)
        if NULL_PAGE in free_s or NULL_PAGE in held:
            raise RuntimeError("null page leaked into the pool bookkeeping")
        if free_s & held:
            raise RuntimeError(
                f"pages both free and allocated: {sorted(free_s & held)}")
        if free_s | held != usable:
            raise RuntimeError(
                f"pool not covered: missing {sorted(usable - free_s - held)}"
                f", foreign {sorted((free_s | held) - usable)}")
        bad = {p: c for p, c in self._ref.items() if c < 1}
        if bad:
            raise RuntimeError(f"non-positive refcounts: {bad}")
        if not self._cached <= held:
            raise RuntimeError(
                f"cached pages not allocated: {sorted(self._cached - held)}")
        if self._tier is not None:
            # A pending demotion is the only overlap of the pool and the
            # tier: its page must still be cached (bytes not yet copied).
            self._tier.assert_consistent()
            stranded = {k: p for k, p in self._tier._pending.items()
                        if p not in self._cached}
            if stranded:
                raise RuntimeError(
                    f"pending demotions of uncached pages: {stranded} — "
                    f"the readback would copy reused bytes")

    def metrics(self) -> Dict[str, float]:
        usable = self.n_pages - 1
        out = {
            "pages_total": float(usable),
            "pages_free": float(len(self._free)),
            "pages_in_use": float(len(self._ref)),
            "pages_cached": float(len(self._cached)),
            "pages_watermark": float(self._watermark),
            "page_allocs": float(self._allocs),
            "page_frees": float(self._frees),
            "page_denied": float(self._denied),
            "page_utilization": (len(self._ref) / usable) if usable else 0.0,
        }
        if self._tier is not None:
            out.update(self._tier.metrics())
        return out
