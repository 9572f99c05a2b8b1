"""Radix prefix cache over the paged KV pool (copy of the JAX package's
``models/prefix_cache.py``; the fleet's routing ``digest`` comes with the
fleet slice).

A radix tree keyed on ``page_size``-token chunks; each node owns one
physical page whose KV rows are the prefill of that chunk in the context
of the path above it, so a root-to-node path spells a prompt prefix and
its pages are that prefix's complete KV. Every node's page carries the
tree's reference (``PageAllocator.adopt``); a slot that mounts a match
adds one (``retain``) and drops it at reap. Cached pages are read-only: a
match is page-aligned and always leaves the prompt's last token to
prefill, so a slot's own writes land in pages it owns. Eviction removes
only effective leaves no slot shares, least recently used first.
Insertion is donation: a reaped request's full-chunk pages transfer into
the tree where the path is new.

With a host tier (``kv_tiering=True`` engines, ``paging.HostTierStore``)
eviction demotes instead of forgetting: the node stays in the tree with
``demoted`` set to its tier key and ``page = None``, and its page waits on
the engine's step-boundary readback queue. ``match_tiered`` walks through
demoted nodes, so admission can promote their bytes back into fresh pool
pages before the slot's first prefill. ``dump_paths`` writes the tree as
token paths, a demoted chunk as ``-(key + 1)``, for a drain snapshot.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .paging import HostTierStore, PageAllocator


class _Node:
    """One cached page: ``chunk`` (page_size token ids) under its parent,
    holding physical page ``page``. The root is a chunk-less sentinel.
    A DEMOTED node (kv_tiering) has ``page is None`` and ``demoted`` set
    to its host-tier key — the chunk's KV bytes live off-pool until a
    match promotes them back into freshly-reserved pool pages."""

    __slots__ = ("chunk", "page", "parent", "children", "last_used",
                 "demoted")

    def __init__(self, chunk: Optional[Tuple[int, ...]], page: Optional[int],
                 parent: Optional["_Node"]) -> None:
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0
        self.demoted: Optional[int] = None


class PrefixCache:
    """Page-granular radix tree of cached prompt prefixes over a
    ref-counted ``PageAllocator``. Purely host-side: it stores token
    chunks and page IDS — the KV bytes never leave the device pool."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 tier: Optional[HostTierStore] = None) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self._alloc = allocator
        self.page_size = page_size
        self._root = _Node(None, None, None)
        self._clock = 0                      # logical LRU time
        self._n_nodes = 0
        # kv_tiering: demoted nodes keep their place in the tree with
        # the KV bytes parked in the host tier; ``_demoted`` maps tier
        # keys back to nodes for promotion / tier-eviction pruning.
        self._tier = tier
        self._demoted: Dict[int, _Node] = {}
        self._n_demoted = 0
        self._promotions = 0                 # pages re-uploaded on a match
        if tier is not None:
            tier.can_evict = self._tier_can_evict
            tier.on_drop = self.drop_demoted
            allocator.attach_tier(tier)
        # Aggregate counters for pool_metrics()/the bench leg.
        self._lookups = 0                    # match() calls
        self._lookup_hits = 0                # match() calls with >= 1 page
        self._lookup_tokens = 0              # prompt tokens seen by match()
        self._hit_tokens = 0                 # tokens covered by matches
        self._inserted_pages = 0             # pages adopted into the tree
        self._decoded_inserted = 0           # ... whose chunk spans decode
        self._evictions = 0                  # pages evicted (LRU)

    def __len__(self) -> int:
        """Number of RESIDENT cached pages (tree nodes holding a pool
        page; demoted nodes count in ``demoted_count``)."""
        return self._n_nodes

    @property
    def demoted_count(self) -> int:
        """Nodes whose KV is parked in the host tier."""
        return self._n_demoted

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        """The FULL page_size-token chunks of ``tokens`` (the trailing
        partial chunk is never cacheable — it shares a page with rows the
        owning request keeps writing)."""
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i:i + ps])
                for i in range(0, (len(tokens) // ps) * ps, ps)]

    def match(self, tokens: Sequence[int],
              count: bool = True) -> List[int]:
        """Longest cached page-aligned prefix of ``tokens``: the page ids
        of the matched path, shallowest first. Capped so at least ONE
        prompt token is left to prefill — the admission needs the
        last-position logits to sample the first output token, so a fully
        cached prompt still re-prefills its final page. Touches the
        matched path's LRU clocks; takes NO references (the caller
        retains what it actually mounts). ``count=False`` suppresses the
        hit/lookup counters for RETRIES of a page-blocked queue head —
        the batcher re-matches it every decode step, and counting each
        retry would let one waiting request swamp the hit rate. On a
        tiered cache this is the RESIDENT-only view (truncated at the
        first demoted node); promotion-aware admission uses
        ``match_tiered``."""
        pages, demoted = self.match_tiered(tokens, count=count)
        if demoted:
            pages = pages[:pages.index(None)]
        return pages

    def match_tiered(self, tokens: Sequence[int], count: bool = True,
                     ) -> Tuple[List[Optional[int]], List[_Node]]:
        """The promotion-aware match: walks through RESIDENT and DEMOTED
        nodes alike and returns ``(path, demoted)`` — ``path`` is the
        matched page ids in path order with ``None`` at demoted
        positions, ``demoted`` the corresponding nodes (shallowest
        first) whose tier payloads admission must re-upload into fresh
        pool pages BEFORE the slot's first prefill dispatch. A node
        whose demotion is still PENDING (bytes not yet drained off-pool)
        is un-demoted in place — the mid-match race where the retain pin
        wins and the copy is cancelled for free. Hit counters cover the
        full path: demoted chunks skip prefill exactly like resident
        ones once promoted."""
        self._clock += 1
        chunks = self._chunks(tokens)
        if chunks and len(chunks) * self.page_size == len(tokens):
            chunks = chunks[:-1]             # leave the last token's page
        node, path, demoted = self._root, [], []
        for chunk in chunks:
            child = node.children.get(chunk)
            if child is None:
                break
            if child.demoted is not None and self._tier is not None \
                    and self._tier.is_pending(child.demoted):
                self._cancel_demotion(child)
            if child.demoted is not None:
                if self._tier is None or not self._tier.has(child.demoted):
                    break                    # dead key: path not promotable
                self._tier.touch(child.demoted)
                demoted.append(child)
                path.append(None)
            else:
                path.append(child.page)
            child.last_used = self._clock
            node = child
        if count:
            self._lookups += 1
            self._lookup_tokens += len(tokens)
            self._hit_tokens += len(path) * self.page_size
            if path:
                self._lookup_hits += 1
        return path, demoted

    def _cancel_demotion(self, node: _Node) -> None:
        """Pending-demotion rollback: the page bytes never left the pool
        (the readback queue had not drained), so the node simply takes
        its page back."""
        key = node.demoted
        node.page = self._tier.cancel(key)
        node.demoted = None
        del self._demoted[key]
        self._n_demoted -= 1
        self._n_nodes += 1

    def insert(self, tokens: Sequence[int],
               pages: Sequence[int],
               prompt_len: Optional[int] = None) -> List[int]:
        """Donate ``pages[i]`` as the cached KV of the i-th full chunk of
        ``tokens`` (the reaped request's block-table prefix, shared hit
        pages included; since the decoded-suffix donation, ``tokens``
        may be the whole conversation — prompt + resident decoded
        suffix). Returns the pages the tree ADOPTED (their reference now
        belongs to the tree); every other page — chunks already cached,
        by this request's own hit path or by a concurrent donor — stays
        with the caller, which must ``free`` its reference as usual.
        ``prompt_len`` marks where the decoded suffix starts: adopted
        pages whose chunk extends past it count into the
        ``decoded_pages_donated_total`` metric (the multi-turn reuse
        signal — None attributes everything to the prompt, the pre-
        decoded-donation accounting). Raises if ``pages`` is shorter
        than the chunk walk it must cover.

        Tiering extensions: a NEGATIVE entry ``-(key + 1)`` denotes a
        chunk whose KV lives in the host tier under ``key`` (the
        snapshot-restore wire form of ``dump_paths``) — the node is
        created demoted, nothing is adopted. Donating a REAL page where
        a demoted node already sits un-demotes it in place: prefill KV
        of a chunk is a deterministic function of its prefix, so the
        donated bytes equal the parked ones and the tier copy is
        dropped."""
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
                if page < 0:                 # restore of a demoted chunk
                    key = -page - 1
                    child = _Node(chunk, None, node)
                    child.demoted = key
                    self._demoted[key] = child
                    self._n_demoted += 1
                else:
                    self._alloc.adopt([page])
                    child = _Node(chunk, page, node)
                    self._n_nodes += 1
                    self._inserted_pages += 1
                    if prompt_len is not None \
                            and (i + 1) * self.page_size > prompt_len:
                        self._decoded_inserted += 1
                    adopted.append(page)
                node.children[chunk] = child
            elif child.demoted is not None and page >= 0:
                # Donor offers resident bytes for a demoted chunk
                # (absorb of a shed slot whose prefix demoted here):
                # adopt the donated page and drop the tier copy.
                if self._tier is not None \
                        and self._tier.is_pending(child.demoted):
                    # Pending entry: its pool page would strand — the
                    # cancel returns it to the tree, and the DONATED
                    # duplicate stays with the caller (not adopted).
                    self._cancel_demotion(child)
                else:
                    key = child.demoted
                    self._alloc.adopt([page])
                    child.page = page
                    child.demoted = None
                    del self._demoted[key]
                    if self._tier is not None:
                        self._tier.discard(key)
                    self._n_demoted -= 1
                    self._n_nodes += 1
                    self._inserted_pages += 1
                    adopted.append(page)
            child.last_used = self._clock
            node = child
        return adopted

    def _evictable_leaves(self) -> List[_Node]:
        """Resident refcount-1 nodes with NO resident descendants — the
        'effective leaves' for pool-page eviction. Without tiering no
        demoted nodes exist, so this degenerates to the classic
        childless-leaf rule; with tiering a node whose entire subtree
        has demoted stays evictable (its descendants' bytes are already
        off-pool)."""
        out: List[_Node] = []
        resident_below: Dict[int, int] = {}
        post: List[_Node] = []
        stack = [self._root]
        while stack:                         # iterative post-order
            node = stack.pop()
            post.append(node)
            stack.extend(node.children.values())
        for node in reversed(post):
            below = sum(resident_below[id(c)]
                        for c in node.children.values())
            here = 0 if node.page is None else 1
            resident_below[id(node)] = here + below
            if (node is not self._root and here and below == 0
                    and self._alloc.ref(node.page) == 1):
                out.append(node)
        return out

    def evict(self, n_pages: int) -> int:
        """Release up to ``n_pages`` cached pool pages, least-recently-
        used effective leaf first. Only pages no slot shares (tree
        refcount the sole holder) are candidates; evicting a leaf can
        expose its parent, so the sweep re-collects until satisfied or
        dry. Without a tier this FORGETS (the pages return to the free
        list immediately); with one it DEMOTES — the node stays in the
        tree tier-flagged and its page is enqueued on the readback
        queue, returning to the free list only when the engine drains
        the queue at the step boundary (``take_pending``/``commit``).
        Returns the number of pages released-or-enqueued."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves:
                if freed >= n_pages:
                    break
                if self._tier is not None:
                    self._demote_leaf(leaf)
                else:
                    del leaf.parent.children[leaf.chunk]
                    self._alloc.drop_cached(leaf.page)
                    self._n_nodes -= 1
                self._evictions += 1
                freed += 1
        return freed

    def _demote_leaf(self, node: _Node) -> None:
        """Demote-instead-of-forget: tier-flag the node and enqueue its
        page for the step-boundary device→host readback. The pool page
        stays allocated+cached (the 'pending' window) until the engine
        gathers its bytes — the pool is donated every dispatch, so the
        copy can only be scheduled from the host at a boundary."""
        key = self._tier.reserve(node.page)
        node.demoted = key
        node.page = None
        self._demoted[key] = node
        self._n_nodes -= 1
        self._n_demoted += 1

    def promote(self, nodes: Sequence[_Node],
                pages: Sequence[int]) -> None:
        """Bookkeeping for a completed promotion: ``pages[i]`` (fresh
        from ``alloc``, refcount 1) now holds the uploaded bytes of
        demoted ``nodes[i]``. The allocation's reference is re-labeled
        as the tree's (``adopt``) — mirroring donation — so the caller
        must still ``retain`` what it mounts. Tier payloads must already
        be popped (the engine needed them for the upload)."""
        for node, page in zip(nodes, pages):
            key = node.demoted
            self._alloc.adopt([page])
            node.page = int(page)
            node.demoted = None
            self._demoted.pop(key, None)
            self._n_demoted -= 1
            self._n_nodes += 1
            self._promotions += 1

    def drop_demoted(self, key: int) -> None:
        """Forget a demoted entry (tier capacity shed, or a refused
        commit): prune its node. Normally the node is childless (the
        tier's ``can_evict`` filter guarantees it for capacity sheds);
        a refused commit can in principle hit a node that acquired
        children since enqueue — then the whole subtree is forgotten,
        since a severed path can never be matched again."""
        node = self._demoted.pop(key, None)
        if node is None:
            return                           # restore-time shed: no node yet
        self._n_demoted -= 1
        if node.parent is not None:
            del node.parent.children[node.chunk]
        stack = list(node.children.values())
        while stack:
            sub = stack.pop()
            stack.extend(sub.children.values())
            if sub.demoted is not None:
                self._demoted.pop(sub.demoted, None)
                if self._tier is not None:
                    if self._tier.is_pending(sub.demoted):
                        page = self._tier.cancel(sub.demoted)
                        self._alloc.drop_cached(page)
                    else:
                        self._tier.discard(sub.demoted)
                self._n_demoted -= 1
            elif sub.page is not None:
                self._alloc.drop_cached(sub.page)
                self._n_nodes -= 1

    def _tier_can_evict(self, key: int) -> bool:
        """Capacity-shed filter: only CHILDLESS demoted leaves may leave
        the tier — dropping a mid-path entry would strand descendants
        the match walk could no longer reach."""
        node = self._demoted.get(key)
        return node is not None and not node.children

    def digest(self, top_k: int = 8,
               max_tokens: int = 512) -> List[Tuple]:
        """Compact routing digest: the ``top_k`` hottest root-to-leaf
        token paths (most recent ``last_used`` first) as ``(tokens,
        cached_len)`` pairs, each token list truncated to ``max_tokens``
        — what a fleet replica publishes so the router can score
        ``prefix_match_len(prompt, digest)`` without the whole tree.
        ``cached_len`` is the path's full cached length (it can exceed
        ``len(tokens)``): a match against a truncated path under-claims,
        never over-claims. Tiered caches emit ``(tokens, cached_len,
        resident_len)`` triples, ``resident_len`` the path's longest
        fully resident prefix in tokens; the remainder pays a promotion
        upload."""
        paths = self.dump_paths()                # coldest first
        out: List[Tuple] = []
        for tokens, pages in reversed(paths[-top_k:] if top_k else []):
            cached = len(pages) * self.page_size
            if self._tier is None:
                out.append((tokens[:max_tokens], cached))
            else:
                resident = next(
                    (i for i, p in enumerate(pages) if p < 0), len(pages))
                out.append((tokens[:max_tokens], cached,
                            resident * self.page_size))
        return out

    def dump_paths(self) -> List[Tuple[List[int], List[int]]]:
        """The tree as root-to-LEAF ``(tokens, pages)`` paths, ordered by
        the leaf's LRU clock (coldest first) — the serializable form a
        drain snapshot carries (models/snapshot.py). Every node lies on
        at least one leaf path, so replaying the paths through
        ``insert`` in this order rebuilds the whole tree: shared prefix
        nodes are created by the first (coldest) path that walks them
        and de-duplicated by the later ones, and inserting coldest-first
        reproduces the eviction order at leaf granularity — the
        restored tree evicts the same suffixes first. Demoted nodes
        appear as ``-(tier_key + 1)`` in the pages list (the negative
        wire form ``insert`` accepts back)."""
        leaves: List[_Node] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root and not node.children:
                leaves.append(node)
            stack.extend(node.children.values())
        leaves.sort(key=lambda n: n.last_used)
        paths: List[Tuple[List[int], List[int]]] = []
        for leaf in leaves:
            tokens: List[int] = []
            pages: List[int] = []
            node = leaf
            while node is not self._root:
                tokens[:0] = node.chunk
                pages.insert(0, node.page if node.demoted is None
                             else -(node.demoted + 1))
                node = node.parent
            paths.append((tokens, pages))
        return paths

    def metrics(self) -> Dict[str, float]:
        """Prefix-reuse counters for pool_metrics()/the exporter: token
        and request hit rates, cached-page count, adoption/eviction
        churn. ``prefix_hit_rate`` is token-weighted (cached tokens /
        prompt tokens looked up) — the number that predicts prefill FLOPs
        saved; ``prefix_request_hit_rate`` is the fraction of lookups
        that matched at all."""
        out = {
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
            # Decoded-suffix donations (multi-turn reuse): adopted pages
            # whose token chunk extends past the donor's prompt — the
            # pages that let turn N+1 mount turn N's answer.
            "decoded_pages_donated_total": float(self._decoded_inserted),
        }
        if self._tier is not None:
            # Tiering gauges ride only on tiered caches — untiered
            # engines keep the pre-tiering exposition byte-identical.
            out["prefix_demoted_pages"] = float(self._n_demoted)
            out["page_promotions_total"] = float(self._promotions)
        return out
