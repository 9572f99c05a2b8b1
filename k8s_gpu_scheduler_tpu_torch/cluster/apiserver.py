"""Hermetic in-memory API server with watch streams (copy of the JAX
package's ``cluster/apiserver.py``).

Every layer above it (informers, scheduler, plugins) sees list/watch
semantics like Kubernetes', so the whole control plane runs in one
process. One mutex guards the store; watch delivery goes through
per-subscriber queues, so a slow consumer never blocks a writer."""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..api.objects import deepcopy_obj, kind_of


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    obj: Any


class Conflict(Exception):
    pass


class NotFound(Exception):
    pass


class AlreadyExists(Exception):
    pass


class APIServer:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        # kind -> "ns/name" -> object
        self._store: Dict[str, Dict[str, Any]] = {}
        self._rv = 0
        self._watchers: Dict[str, List[queue.Queue]] = {}

    # -- helpers -----------------------------------------------------------
    def _bump_locked(self, obj: Any) -> None:
        self._rv += 1
        obj.metadata.resource_version = self._rv

    def _notify_locked(self, kind: str, ev: WatchEvent) -> None:
        for q in self._watchers.get(kind, []):
            q.put(ev)

    # -- CRUD --------------------------------------------------------------
    def create(self, obj: Any) -> Any:
        kind = kind_of(obj)
        obj = deepcopy_obj(obj)
        with self._mu:
            bucket = self._store.setdefault(kind, {})
            key = obj.metadata.key
            if key in bucket:
                raise AlreadyExists(f"{kind} {key}")
            self._bump_locked(obj)
            bucket[key] = obj
            self._notify_locked(kind, WatchEvent("ADDED", deepcopy_obj(obj)))
        return deepcopy_obj(obj)

    def get(self, kind: str, name: str, namespace: str = "default") -> Any:
        with self._mu:
            obj = self._store.get(kind, {}).get(f"{namespace}/{name}")
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name}")
            return deepcopy_obj(obj)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        field_fn: Optional[Callable[[Any], bool]] = None,
    ) -> List[Any]:
        with self._mu:
            out = []
            for key, obj in self._store.get(kind, {}).items():
                if namespace is not None and obj.metadata.namespace != namespace:
                    continue
                if label_selector and any(
                    obj.metadata.labels.get(k) != v for k, v in label_selector.items()
                ):
                    continue
                if field_fn is not None and not field_fn(obj):
                    continue
                out.append(deepcopy_obj(obj))
            return out

    def update(self, obj: Any, expect_rv: Optional[int] = None) -> Any:
        """Replace; optimistic concurrency when expect_rv given."""
        kind = kind_of(obj)
        obj = deepcopy_obj(obj)
        with self._mu:
            bucket = self._store.setdefault(kind, {})
            key = obj.metadata.key
            cur = bucket.get(key)
            if cur is None:
                raise NotFound(f"{kind} {key}")
            if expect_rv is not None and cur.metadata.resource_version != expect_rv:
                raise Conflict(
                    f"{kind} {key}: rv {cur.metadata.resource_version} != {expect_rv}"
                )
            self._bump_locked(obj)
            bucket[key] = obj
            self._notify_locked(kind, WatchEvent("MODIFIED", deepcopy_obj(obj)))
        return deepcopy_obj(obj)

    def mutate(self, kind: str, name: str, namespace: str, fn: Callable[[Any], None]) -> Any:
        """Atomic read-modify-write under the store lock — the primitive the
        scheduler uses for ConfigMap appends (the reference's racy
        read-then-Update at pkg/resources/pods.go:156-175 becomes atomic)."""
        with self._mu:
            cur = self._store.get(kind, {}).get(f"{namespace}/{name}")
            if cur is None:
                raise NotFound(f"{kind} {namespace}/{name}")
            # fn runs on a copy: a raising fn leaves the store untouched. The
            # stored object is a further copy, so even a fn that retains its
            # argument can never reach live store state afterwards.
            obj = deepcopy_obj(cur)
            fn(obj)
            stored = deepcopy_obj(obj)
            self._bump_locked(stored)
            self._store[kind][f"{namespace}/{name}"] = stored
            self._notify_locked(kind, WatchEvent("MODIFIED", deepcopy_obj(stored)))
            return deepcopy_obj(stored)

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        with self._mu:
            bucket = self._store.get(kind, {})
            key = f"{namespace}/{name}"
            obj = bucket.pop(key, None)
            if obj is None:
                raise NotFound(f"{kind} {key}")
            self._notify_locked(kind, WatchEvent("DELETED", deepcopy_obj(obj)))

    # -- watch -------------------------------------------------------------
    def watch(self, kind: str, send_initial: bool = True) -> "Watch":
        q: queue.Queue = queue.Queue()
        with self._mu:
            if send_initial:
                for obj in self._store.get(kind, {}).values():
                    q.put(WatchEvent("ADDED", deepcopy_obj(obj)))
            self._watchers.setdefault(kind, []).append(q)
        return Watch(self, kind, q)

    def _unwatch(self, kind: str, q: queue.Queue) -> None:
        with self._mu:
            try:
                self._watchers.get(kind, []).remove(q)
            except ValueError:
                pass


class Watch:
    """Iterable watch stream; ``stop()`` to unsubscribe."""

    _SENTINEL = object()

    def __init__(self, server: APIServer, kind: str, q: queue.Queue) -> None:
        self._server = server
        self._kind = kind
        self._q = q
        self._stopped = False

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if ev is Watch._SENTINEL:
            return None
        return ev

    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._server._unwatch(self._kind, self._q)
            self._q.put(Watch._SENTINEL)
