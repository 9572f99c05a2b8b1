"""Host-side KV page allocator for the paged serving cache (trimmed copy
of the JAX package's ``models/paging.py``; the host tier comes with the
tiering slice).

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
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

NULL_PAGE = 0


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
        self._watermark = 0
        self._allocs = 0
        self._frees = 0
        self._denied = 0

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

    def metrics(self) -> Dict[str, float]:
        usable = self.n_pages - 1
        return {
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
