"""Radix prefix cache over the paged KV pool (trimmed copy of the JAX
package's ``models/prefix_cache.py``; the tiered paths come with the
tiering slice).

A radix tree keyed on ``page_size``-token chunks; each node owns one
physical page whose KV rows are the prefill of that chunk in the context
of the path above it, so a root-to-node path spells a prompt prefix and
its pages are that prefix's complete KV. Every node's page carries the
tree's reference (``PageAllocator.adopt``); a slot that mounts a match
adds one (``retain``) and drops it at reap. Cached pages are read-only: a
match is page-aligned and always leaves the prompt's last token to
prefill, so a slot's own writes land in pages it owns. Eviction removes
only leaves no slot shares, least recently used first. Insertion is
donation: a reaped request's full-chunk pages transfer into the tree
where the path is new.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .paging import PageAllocator


class _Node:
    __slots__ = ("chunk", "page", "parent", "children", "last_used")

    def __init__(self, chunk: Optional[Tuple[int, ...]], page: Optional[int],
                 parent: Optional["_Node"]) -> None:
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Page-granular radix tree of cached prefixes over a ref-counted
    ``PageAllocator``. Host-side only: token chunks and page ids."""

    def __init__(self, allocator: PageAllocator, page_size: int) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self._alloc = allocator
        self.page_size = page_size
        self._root = _Node(None, None, None)
        self._clock = 0
        self._n_nodes = 0
        self._lookups = 0
        self._lookup_hits = 0
        self._lookup_tokens = 0
        self._hit_tokens = 0
        self._inserted_pages = 0
        self._decoded_inserted = 0
        self._evictions = 0

    def __len__(self) -> int:
        return self._n_nodes

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i:i + ps])
                for i in range(0, (len(tokens) // ps) * ps, ps)]

    def match(self, tokens: Sequence[int], count: bool = True) -> List[int]:
        """Page ids of the longest cached page-aligned prefix of
        ``tokens``, shallowest first, leaving at least one token to
        prefill. Touches the path's LRU clocks; takes no references.
        ``count=False`` keeps retries out of the hit counters."""
        self._clock += 1
        chunks = self._chunks(tokens)
        if chunks and len(chunks) * self.page_size == len(tokens):
            chunks = chunks[:-1]
        node, path = self._root, []
        for chunk in chunks:
            child = node.children.get(chunk)
            if child is None:
                break
            path.append(child.page)
            child.last_used = self._clock
            node = child
        if count:
            self._lookups += 1
            self._lookup_tokens += len(tokens)
            self._hit_tokens += len(path) * self.page_size
            if path:
                self._lookup_hits += 1
        return path

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               prompt_len: Optional[int] = None) -> List[int]:
        """Donate ``pages[i]`` as the KV of the i-th full chunk of
        ``tokens``; returns the pages the tree adopted. Chunks already
        cached stay with the caller to free. ``prompt_len`` marks where a
        decoded suffix starts, for the donation metric only."""
        self._clock += 1
        chunks = self._chunks(tokens)
        if len(pages) < len(chunks):
            raise ValueError(
                f"{len(chunks)} full chunks but only {len(pages)} pages")
        node, adopted = self._root, []
        for i, (chunk, page) in enumerate(zip(chunks, pages)):
            page = int(page)
            child = node.children.get(chunk)
            if child is None:
                self._alloc.adopt([page])
                child = _Node(chunk, page, node)
                node.children[chunk] = child
                self._n_nodes += 1
                self._inserted_pages += 1
                if prompt_len is not None \
                        and (i + 1) * self.page_size > prompt_len:
                    self._decoded_inserted += 1
                adopted.append(page)
            child.last_used = self._clock
            node = child
        return adopted

    def _evictable_leaves(self) -> List[_Node]:
        """Childless nodes no slot shares, in reversed depth-first order
        (the JAX package's order, so LRU ties break the same way)."""
        walk: List[_Node] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            walk.append(node)
            stack.extend(node.children.values())
        return [n for n in reversed(walk)
                if n is not self._root and not n.children
                and self._alloc.ref(n.page) == 1]

    def evict(self, n_pages: int) -> int:
        """Release up to ``n_pages`` cached pages, least recently used
        leaf first; only pages no slot shares are candidates. Evicting a
        leaf can expose its parent, so the sweep re-collects until done
        or dry. Returns the number released."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves:
                if freed >= n_pages:
                    break
                del leaf.parent.children[leaf.chunk]
                self._alloc.drop_cached(leaf.page)
                self._n_nodes -= 1
                self._evictions += 1
                freed += 1
        return freed

    def metrics(self) -> Dict[str, float]:
        return {
            "prefix_cached_pages": float(self._n_nodes),
            "prefix_lookups": float(self._lookups),
            "prefix_lookup_hits": float(self._lookup_hits),
            "prefix_lookup_tokens": float(self._lookup_tokens),
            "prefix_hit_tokens": float(self._hit_tokens),
            "prefix_hit_rate": (self._hit_tokens / self._lookup_tokens
                                if self._lookup_tokens else 0.0),
            "prefix_request_hit_rate": (self._lookup_hits / self._lookups
                                        if self._lookups else 0.0),
            "prefix_inserted_pages": float(self._inserted_pages),
            "prefix_evictions": float(self._evictions),
            "decoded_pages_donated_total": float(self._decoded_inserted),
        }
