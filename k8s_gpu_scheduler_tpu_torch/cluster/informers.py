"""Shared informers, listers and indexers over the APIServer watch stream
(copy of the JAX package's ``cluster/informers.py``), built once at
scheduler construction, with no package-level mutable state."""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional

from .apiserver import APIServer, Watch, WatchEvent

log = logging.getLogger(__name__)


class Informer:
    def __init__(self, server: APIServer, kind: str) -> None:
        self._server = server
        self.kind = kind
        # RLock: add_event_handler replays synthetic ADDs while holding the
        # lock (ordering guarantee below), and a handler may legitimately
        # call back into list()/get().
        self._mu = threading.RLock()
        self._cache: Dict[str, Any] = {}
        self._synced = threading.Event()
        self._watch: Optional[Watch] = None
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._handlers: List[Dict[str, Callable[..., None]]] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start the watch loop. Informers are single-use (client-go
        semantics): once stopped they cannot be restarted — build a new
        factory instead."""
        if self._started:
            return
        self._started = True
        # Initial list under the same subscription guarantees no missed events.
        self._watch = self._server.watch(self.kind, send_initial=True)
        with self._mu:
            for obj in self._server.list(self.kind):
                self._cache[obj.metadata.key] = obj
            initial = list(self._cache.values())
            handlers = list(self._handlers)
            # _synced set inside the same critical section as the handler
            # snapshot: a handler registered concurrently either is in
            # ``handlers`` (registered before, no replay — it gets the loop
            # below) or sees _synced and replays the cache itself — never
            # neither, never both.
            self._synced.set()
        # Synthetic ADD delivery for the initial list — client-go semantics:
        # handlers registered before start() see every pre-existing object.
        # (The watch replay of these same objects is then dropped as stale by
        # _apply's resource_version check, so no double delivery.)
        for obj in initial:
            self._dispatch("ADDED", None, obj, handlers)
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self.kind}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        assert self._watch is not None
        while True:
            ev = self._watch.next()
            if ev is None:
                return
            self._apply(ev)

    def _apply(self, ev: WatchEvent) -> None:
        key = ev.obj.metadata.key
        old = None
        with self._mu:
            old = self._cache.get(key)
            if ev.type == "DELETED":
                self._cache.pop(key, None)
            else:
                # Drop stale events (ABA on out-of-order delivery).
                if old is not None and old.metadata.resource_version >= ev.obj.metadata.resource_version:
                    return
                self._cache[key] = ev.obj
            # Snapshot handlers under the SAME lock as the cache update: a
            # handler registered after this point sees the object via its
            # synthetic-add replay instead, never both (exactly-once).
            handlers = list(self._handlers)
        self._dispatch(ev.type, old, ev.obj, handlers)

    def _dispatch(self, ev_type: str, old: Any, obj: Any, handlers: List[Dict[str, Callable[..., None]]]) -> None:
        # Handlers run outside the cache lock (so they may observe a cache
        # already newer than their event — same relaxation client-go makes).
        # A raising handler must not kill the watch thread.
        for h in handlers:
            try:
                if ev_type == "ADDED" and "on_add" in h:
                    h["on_add"](obj)
                elif ev_type == "MODIFIED" and "on_update" in h:
                    h["on_update"](old, obj)
                elif ev_type == "DELETED" and "on_delete" in h:
                    h["on_delete"](obj)
            except Exception:  # noqa: BLE001
                log.exception("informer %s handler failed on %s", self.kind, ev_type)

    def add_event_handler(
        self,
        on_add: Optional[Callable[[Any], None]] = None,
        on_update: Optional[Callable[[Any, Any], None]] = None,
        on_delete: Optional[Callable[[Any], None]] = None,
    ) -> None:
        """Register handlers. If the informer has already synced, ``on_add``
        is immediately invoked for every object in the cache (client-go's
        synthetic-add semantics for late handler registration)."""
        h: Dict[str, Callable[..., None]] = {}
        if on_add:
            h["on_add"] = on_add
        if on_update:
            h["on_update"] = on_update
        if on_delete:
            h["on_delete"] = on_delete
        # Append + replay in ONE critical section: _apply updates the cache
        # and snapshots handlers under the same lock, so an object arrives
        # either via the watch dispatch (handler already appended) or via
        # this replay (object already cached) — never both. Replaying while
        # still holding the lock also guarantees ordering: a concurrent
        # DELETE/MODIFY for a replayed object cannot reach this handler
        # before its synthetic ADD, because the watch thread's cache update
        # (which precedes its dispatch) blocks on the lock until the replay
        # finishes.
        with self._mu:
            self._handlers.append(h)
            if on_add and self._synced.is_set():
                for obj in list(self._cache.values()):
                    try:
                        on_add(obj)
                    except Exception:  # noqa: BLE001
                        log.exception("informer %s synthetic add failed", self.kind)

    def has_synced(self) -> bool:
        return self._synced.is_set()

    # -- lister / indexer --------------------------------------------------
    #
    # READ-ONLY CONTRACT: list()/get() return the cached objects by
    # reference, exactly as client-go listers do — callers MUST NOT mutate
    # them (mutate via Descriptor/APIServer instead, which deep-copies).
    # This keeps the hot scheduling path allocation-free.
    def list(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        filter_fn: Optional[Callable[[Any], bool]] = None,
    ) -> List[Any]:
        with self._mu:
            out = []
            for obj in self._cache.values():
                if namespace is not None and obj.metadata.namespace != namespace:
                    continue
                if label_selector and any(
                    obj.metadata.labels.get(k) != v for k, v in label_selector.items()
                ):
                    continue
                if filter_fn is not None and not filter_fn(obj):
                    continue
                out.append(obj)
            return out

    def get(self, name: str, namespace: str = "default") -> Optional[Any]:
        """Indexer GetByKey — parity with resources.Descriptor.Get
        (pkg/resources/pods.go:87-96); returns None on miss instead of the
        reference's hardcoded-key bug (nodes.go:28-37)."""
        with self._mu:
            return self._cache.get(f"{namespace}/{name}")


class SharedInformerFactory:
    def __init__(self, server: APIServer) -> None:
        self._server = server
        self._mu = threading.Lock()
        self._informers: Dict[str, Informer] = {}

    def informer(self, kind: str) -> Informer:
        with self._mu:
            inf = self._informers.get(kind)
            if inf is None:
                inf = Informer(self._server, kind)
                self._informers[kind] = inf
            return inf

    def start(self) -> None:
        with self._mu:
            informers = list(self._informers.values())
        for inf in informers:
            inf.start()

    def wait_for_cache_sync(self, timeout: float = 5.0) -> bool:
        with self._mu:
            informers = list(self._informers.values())
        return all(inf._synced.wait(timeout) for inf in informers)

    def stop(self) -> None:
        with self._mu:
            informers = list(self._informers.values())
        for inf in informers:
            inf.stop()
