"""Kubernetes REST adapter (copy of the JAX package's
``cluster/kubeapi.py``): the ``cluster.APIServer`` interface (create/get/
list/mutate/delete/watch) over the Kubernetes REST API, with nothing but
the standard library, so the same Scheduler/informers/plugins run
in-cluster (``cmd.scheduler --in-cluster``):

- auth: in-cluster service-account token + CA
  (/var/run/secrets/kubernetes.io/serviceaccount) or explicit
  ``base_url``/``token`` (tests drive a fake HTTP apiserver);
- objects: k8s JSON ↔ the typed model in api/objects.py (Pod, Node,
  ConfigMap, Lease, and the PodGroup CRD at scheduling.tpu.dev/v1);
- watch: chunked streaming GET (?watch=1&resourceVersion=N) per kind, one
  reader thread feeding the same Watch queue contract the informers expect;
- binding: setting spec.nodeName is rejected by a real apiserver, so
  ``mutate`` detects the bind pattern and POSTs a Binding subresource
  instead (what kube-scheduler itself does).
"""
from __future__ import annotations

import http.client
import json
import logging
import queue
import socket
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from ..api.objects import (
    ConfigMap,
    ConfigMapRef,
    Container,
    EnvVar,
    Lease,
    Node,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodGroup,
    PodSpec,
    PodStatus,
    ResourceRequirements,
)
from .apiserver import AlreadyExists, Conflict, NotFound, WatchEvent

log = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class StatusError(RuntimeError):
    """Non-404/409 HTTP failure, carrying the status code so callers can
    react to specific ones (410 Gone → watch re-list)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code

# kind -> (api prefix, plural, namespaced)
_ROUTES = {
    "Pod": ("/api/v1", "pods", True),
    "Node": ("/api/v1", "nodes", False),
    "ConfigMap": ("/api/v1", "configmaps", True),
    "PodGroup": ("/apis/scheduling.tpu.dev/v1", "podgroups", True),
    "Lease": ("/apis/coordination.k8s.io/v1", "leases", True),
}


# -- JSON ↔ typed objects -----------------------------------------------------

def _meta_from(d: Dict) -> ObjectMeta:
    rv = d.get("resourceVersion", 0)
    return ObjectMeta(
        name=d.get("name", ""),
        namespace=d.get("namespace", "default"),
        labels=d.get("labels") or {},
        annotations=d.get("annotations") or {},
        uid=d.get("uid") or d.get("name", ""),
        resource_version=int(rv) if str(rv).isdigit() else 0,
        owner_references=[
            f"{r.get('kind', '')}/{r.get('name', '')}"
            for r in d.get("ownerReferences") or []
        ],
    )


def _meta_to(m: ObjectMeta, namespaced: bool) -> Dict:
    out: Dict[str, Any] = {"name": m.name, "labels": m.labels,
                           "annotations": m.annotations}
    if namespaced:
        out["namespace"] = m.namespace
    if m.owner_references:
        # Inverse of _meta_from's "Kind/name" flattening — without this a
        # pod CREATED through this adapter silently loses its controller
        # reference, and both preemption victim eligibility and the gang
        # bare-pod eviction guard key on having one. The model keeps only
        # kind+name, so the emitted refs are the create-side minimum
        # (apiVersion inferred for the common controller kinds); callers
        # that PATCH must strip the key (see mutate) — merge-patch would
        # REPLACE a real apiserver's full refs (uid, controller flags)
        # with this reduced form.
        api_of = {"StatefulSet": "apps/v1", "Deployment": "apps/v1",
                  "ReplicaSet": "apps/v1", "DaemonSet": "apps/v1",
                  "Job": "batch/v1"}
        out["ownerReferences"] = [
            {"apiVersion": api_of.get(r.split("/", 1)[0], "v1"),
             "kind": r.split("/", 1)[0], "name": r.split("/", 1)[-1]}
            for r in m.owner_references
        ]
    return out


def _quantity(v) -> float:
    """k8s quantity → float (chips are integers; tolerate '4' and 4)."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def pod_from_json(d: Dict) -> Pod:
    spec = d.get("spec") or {}
    containers = []
    for c in spec.get("containers", []):
        res = c.get("resources") or {}
        containers.append(Container(
            name=c.get("name", "main"),
            image=c.get("image", ""),
            env=[EnvVar(e["name"], e.get("value", ""))
                 for e in c.get("env", []) if "name" in e],
            env_from=[ConfigMapRef(ref["configMapRef"]["name"])
                      for ref in c.get("envFrom", []) if "configMapRef" in ref],
            resources=ResourceRequirements(
                requests={k: _quantity(v)
                          for k, v in (res.get("requests") or {}).items()},
                limits={k: _quantity(v)
                        for k, v in (res.get("limits") or {}).items()},
            ),
        ))
    status = d.get("status") or {}
    return Pod(
        metadata=_meta_from(d.get("metadata") or {}),
        spec=PodSpec(
            containers=containers,
            node_name=spec.get("nodeName", ""),
            scheduler_name=spec.get("schedulerName", "default-scheduler"),
            node_selector=spec.get("nodeSelector") or {},
            hostname=spec.get("hostname", ""),
            subdomain=spec.get("subdomain", ""),
        ),
        status=PodStatus(
            phase=status.get("phase", "Pending"),
            host_ip=status.get("hostIP", ""),
            pod_ip=status.get("podIP", ""),
        ),
    )


def node_from_json(d: Dict) -> Node:
    status = d.get("status") or {}
    raw_conditions = status.get("conditions", [])
    conditions = [c.get("type", "") for c in raw_conditions
                  if c.get("status") == "True"]
    # Only default to Ready when the node reports NO conditions at all
    # (fake/test servers). A real NotReady node (conditions present, none
    # True) must map to an empty list so the plugin's readiness filter
    # fires — defaulting it to Ready would bind pods to dead nodes.
    if not raw_conditions:
        conditions = ["Ready"]
    addresses = [a.get("address", "") for a in status.get("addresses", [])]
    return Node(
        metadata=_meta_from(d.get("metadata") or {}),
        status=NodeStatus(
            capacity={k: _quantity(v)
                      for k, v in (status.get("capacity") or {}).items()},
            allocatable={k: _quantity(v)
                         for k, v in (status.get("allocatable") or {}).items()},
            addresses=addresses,
            conditions=conditions,
        ),
    )


def configmap_from_json(d: Dict) -> ConfigMap:
    return ConfigMap(metadata=_meta_from(d.get("metadata") or {}),
                     data=dict(d.get("data") or {}))


def _rfc3339(epoch: float) -> Optional[str]:
    if not epoch:
        return None
    import datetime as _dt

    return _dt.datetime.fromtimestamp(
        epoch, _dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def _from_rfc3339(s: Optional[str]) -> float:
    if not s:
        return 0.0
    import datetime as _dt

    try:
        return _dt.datetime.strptime(
            s.replace("Z", "+0000"), "%Y-%m-%dT%H:%M:%S.%f%z").timestamp()
    except ValueError:
        try:
            return _dt.datetime.strptime(
                s.replace("Z", "+0000"), "%Y-%m-%dT%H:%M:%S%z").timestamp()
        except ValueError:
            return 0.0


def lease_from_json(d: Dict) -> Lease:
    spec = d.get("spec") or {}
    return Lease(
        metadata=_meta_from(d.get("metadata") or {}),
        holder_identity=spec.get("holderIdentity") or "",
        lease_duration_s=float(spec.get("leaseDurationSeconds", 15)),
        acquire_time=_from_rfc3339(spec.get("acquireTime")),
        renew_time=_from_rfc3339(spec.get("renewTime")),
        lease_transitions=int(spec.get("leaseTransitions", 0)),
    )


def podgroup_from_json(d: Dict) -> PodGroup:
    spec = d.get("spec") or {}
    return PodGroup(
        metadata=_meta_from(d.get("metadata") or {}),
        min_member=int(spec.get("minMember", 1)),
        topology=spec.get("topology", ""),
        schedule_timeout_s=float(spec.get("scheduleTimeoutSeconds", 60)),
    )


def obj_to_json(obj: Any) -> Dict:
    kind = obj.kind
    _, _, namespaced = _ROUTES[kind]
    meta = _meta_to(obj.metadata, namespaced)
    if kind == "Pod":
        return {
            "apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {
                "schedulerName": obj.spec.scheduler_name,
                "nodeName": obj.spec.node_name or None,
                "nodeSelector": obj.spec.node_selector,
                "hostname": obj.spec.hostname or None,
                "subdomain": obj.spec.subdomain or None,
                "containers": [{
                    "name": c.name, "image": c.image,
                    "env": [{"name": e.name, "value": e.value} for e in c.env],
                    "envFrom": [{"configMapRef": {"name": r.name}}
                                for r in c.env_from],
                    "resources": {
                        "requests": {k: str(int(v)) for k, v in
                                     c.resources.requests.items()},
                        "limits": {k: str(int(v)) for k, v in
                                   c.resources.limits.items()},
                    },
                } for c in obj.spec.containers],
            },
        }
    if kind == "ConfigMap":
        return {"apiVersion": "v1", "kind": "ConfigMap", "metadata": meta,
                "data": obj.data}
    if kind == "Node":
        return {"apiVersion": "v1", "kind": "Node", "metadata": meta}
    if kind == "PodGroup":
        return {
            "apiVersion": "scheduling.tpu.dev/v1", "kind": "PodGroup",
            "metadata": meta,
            "spec": {"minMember": obj.min_member, "topology": obj.topology,
                     "scheduleTimeoutSeconds": int(obj.schedule_timeout_s)},
        }
    if kind == "Lease":
        return {
            "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": meta,
            "spec": {
                "holderIdentity": obj.holder_identity or None,
                "leaseDurationSeconds": int(obj.lease_duration_s),
                "acquireTime": _rfc3339(obj.acquire_time),
                "renewTime": _rfc3339(obj.renew_time),
                "leaseTransitions": obj.lease_transitions,
            },
        }
    raise TypeError(f"unsupported kind {kind}")


_FROM_JSON = {
    "Pod": pod_from_json,
    "Node": node_from_json,
    "ConfigMap": configmap_from_json,
    "PodGroup": podgroup_from_json,
    "Lease": lease_from_json,
}


# -- the adapter --------------------------------------------------------------

class KubeAPIServer:
    """Speaks kube REST; quacks like cluster.APIServer."""

    def __init__(self, base_url: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_file: Optional[str] = None,
                 timeout_s: float = 10.0):
        if base_url is None:
            import os

            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in-cluster: KUBERNETES_SERVICE_HOST unset "
                    "(pass base_url explicitly)"
                )
            base_url = f"https://{host}:{port}"
            token = token or open(f"{SA_DIR}/token").read().strip()
            ca_file = ca_file or f"{SA_DIR}/ca.crt"
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout_s = timeout_s
        self._ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            self._ctx = ssl.create_default_context(
                cafile=ca_file) if ca_file else ssl.create_default_context()
        # One persistent keep-alive connection per thread (client-go reuses
        # HTTP/2 streams the same way). A fresh TCP+TLS handshake per
        # request is not just slow — under a burst of concurrent binds the
        # connection storm overflows the apiserver's accept backlog and
        # dropped SYNs stall individual requests for the full 1 s
        # retransmit timeout (measured against the bench fake).
        self._local = threading.local()
        # Path prefix of base_url (proxied apiservers like
        # https://gw.example/k8s) — http.client takes host/port only, so
        # the prefix must be re-applied per request or pooled calls would
        # silently hit the wrong URL while watches (urllib) work.
        self._base_path = urllib.parse.urlsplit(self.base_url).path.rstrip("/")

    # -- HTTP plumbing -----------------------------------------------------
    def _new_conn(self):
        u = urllib.parse.urlsplit(self.base_url)
        if u.scheme == "https":
            conn = http.client.HTTPSConnection(
                u.hostname, u.port or 443, timeout=self.timeout_s,
                context=self._ctx)
        else:
            conn = http.client.HTTPConnection(
                u.hostname, u.port or 80, timeout=self.timeout_s)
        # TCP_NODELAY: on a reused keep-alive connection, Nagle holds the
        # request's second segment until the server's delayed ACK —
        # a constant ~100 ms floor per request (measured). Real apiserver
        # clients disable Nagle for exactly this reason.
        conn.connect()
        try:
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except (OSError, AttributeError):
            pass
        return conn

    def _request(self, method: str, path: str, body: Optional[Dict] = None,
                 content_type: str = "application/json", stream: bool = False):
        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        data = json.dumps(body).encode() if body is not None else None
        if data is not None:
            headers["Content-Type"] = content_type

        if stream:
            # Watches hold their connection for the stream's lifetime —
            # never pooled; urllib's per-call connection is the right shape.
            req = urllib.request.Request(
                self.base_url + path, data=data, method=method, headers=headers)
            try:
                return urllib.request.urlopen(req, timeout=None, context=self._ctx)
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")[:300]
                raise self._status_error(method, path, e.code, detail) from e

        full_path = self._base_path + path
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            reused = conn is not None
            if conn is None:
                conn = self._new_conn()
                self._local.conn = conn
            sent = False
            try:
                conn.request(method, full_path, body=data, headers=headers)
                sent = True
                resp = conn.getresponse()
                payload = resp.read()
                break
            except socket.timeout:
                # The server may have APPLIED the request and only the
                # response is late — re-sending a non-idempotent verb
                # (bind POST, create) could double-apply. Surface it.
                self._local.conn = None
                conn.close()
                raise
            except (http.client.HTTPException, ConnectionError, OSError):
                self._local.conn = None
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                # Retry ONLY when re-sending cannot double-apply: the send
                # itself failed (an incomplete request is never processed),
                # or the verb is idempotent and the reused keep-alive died
                # in the response phase. PATCH counts as idempotent here:
                # every merge-patch this client issues sets absolute values
                # (no increments), so replaying one is a no-op. POST (bind,
                # create) that was fully sent may have been applied even
                # though the connection then broke; re-sending it could
                # double-apply, so surface the error instead.
                idempotent = method in ("GET", "HEAD", "PUT", "PATCH", "DELETE")
                if attempt or (sent and not (reused and idempotent)):
                    raise
        if resp.status >= 400:
            detail = payload.decode(errors="replace")[:300]
            raise self._status_error(method, path, resp.status, detail)
        return json.loads(payload or b"{}")

    @staticmethod
    def _status_error(method: str, path: str, code: int, detail: str):
        if code == 404:
            return NotFound(f"{method} {path}: {detail}")
        if code == 409:
            if "AlreadyExists" in detail or method == "POST":
                return AlreadyExists(detail)
            return Conflict(detail)
        return StatusError(code, f"{method} {path} -> {code}: {detail}")

    def _path(self, kind: str, namespace: Optional[str] = None,
              name: Optional[str] = None, suffix: str = "") -> str:
        prefix, plural, namespaced = _ROUTES[kind]
        parts = [prefix]
        if namespaced and namespace is not None:
            parts.append(f"namespaces/{namespace}")
        parts.append(plural)
        if name:
            parts.append(name)
        path = "/".join(parts)
        return path + suffix

    # -- APIServer interface ----------------------------------------------
    def create(self, obj: Any) -> Any:
        kind = obj.kind
        _, _, namespaced = _ROUTES[kind]
        ns = obj.metadata.namespace if namespaced else None
        doc = self._request("POST", self._path(kind, ns), obj_to_json(obj))
        return _FROM_JSON[kind](doc)

    def get(self, kind: str, name: str, namespace: str = "default") -> Any:
        doc = self._request("GET", self._path(kind, namespace, name))
        return _FROM_JSON[kind](doc)

    def list(self, kind: str, namespace: Optional[str] = None,
             label_fn: Optional[Callable] = None,
             field_fn: Optional[Callable] = None) -> List[Any]:
        # all-namespaces list (the informer's view, like client-go factories)
        doc = self._request("GET", self._path(kind, namespace))
        objs = [_FROM_JSON[kind](item) for item in doc.get("items", [])]
        if label_fn:
            objs = [o for o in objs if label_fn(o.metadata.labels)]
        if field_fn:
            objs = [o for o in objs if field_fn(o)]
        return objs

    def mutate(self, kind: str, name: str, namespace: str,
               fn: Callable[[Any], None]) -> Any:
        current = self.get(kind, name, namespace)
        before_node = getattr(getattr(current, "spec", None), "node_name", None)
        # Snapshot the mutable maps BEFORE fn: RFC-7386 merge-patch leaves
        # absent keys untouched, so keys fn() deletes must be sent as
        # explicit nulls or a real apiserver never removes them (the
        # reshaper pops its state annotation this way — without nulls the
        # node would stay filtered as "repartition in progress" forever).
        before = {
            "labels": dict(current.metadata.labels),
            "annotations": dict(current.metadata.annotations),
            "data": dict(current.data) if kind == "ConfigMap" else {},
        }
        fn(current)
        after_node = getattr(getattr(current, "spec", None), "node_name", None)
        if kind == "Pod" and not before_node and after_node:
            # bind: POST the Binding subresource (spec.nodeName is immutable
            # through PATCH on a real apiserver).
            self._request(
                "POST", self._path("Pod", namespace, name, "/binding"),
                {"apiVersion": "v1", "kind": "Binding",
                 "metadata": {"name": name},
                 "target": {"apiVersion": "v1", "kind": "Node",
                            "name": after_node}},
            )
            return current
        body = obj_to_json(current)
        # ownerReferences are read-only through this adapter: a merge-PATCH
        # carrying the model's reduced kind/name form would REPLACE the
        # apiserver's full refs (uid, controller, blockOwnerDeletion) and
        # break garbage collection — and on a strict server 422 for the
        # missing uid. Omitting the key leaves the server's refs untouched.
        body.get("metadata", {}).pop("ownerReferences", None)
        if kind == "Node":
            # only metadata is ours to change on nodes (labels/annotations)
            body = {"metadata": body["metadata"]}
        for field, prev in (("labels", before["labels"]),
                            ("annotations", before["annotations"])):
            removed = set(prev) - set(getattr(current.metadata, field))
            if removed:
                body["metadata"][field] = {**body["metadata"].get(field, {}),
                                           **{k: None for k in removed}}
        if kind == "ConfigMap":
            removed = set(before["data"]) - set(current.data)
            if removed:
                body["data"] = {**body.get("data", {}),
                                **{k: None for k in removed}}
        doc = self._request(
            "PATCH", self._path(kind, namespace, name), body,
            content_type="application/merge-patch+json",
        )
        return _FROM_JSON[kind](doc)

    def bind(self, name: str, namespace: str, node_name: str) -> None:
        """Direct Binding-subresource POST — ONE round trip. The generic
        bind path (mutate) costs a node GET (for host_ip, which a real
        apiserver populates via kubelet anyway) plus a pod GET before the
        POST; on the bind hot path that tripled the HTTP work per pod."""
        self._request(
            "POST", self._path("Pod", namespace, name, "/binding"),
            {"apiVersion": "v1", "kind": "Binding",
             "metadata": {"name": name},
             "target": {"apiVersion": "v1", "kind": "Node",
                        "name": node_name}},
        )

    def patch_configmap_data(self, name: str, namespace: str,
                             data: Dict[str, str]) -> Any:
        """Append keys to a ConfigMap in ONE merge-PATCH — no read-modify-
        write. PostBind's injection is a pure key append, so the GET half of
        mutate() is wasted work on the bind hot path (two round trips and
        two JSON codecs per pod, measured as the largest share of bind-task
        time under churn)."""
        doc = self._request(
            "PATCH", self._path("ConfigMap", namespace, name),
            {"data": dict(data)},
            content_type="application/merge-patch+json",
        )
        return _FROM_JSON["ConfigMap"](doc)

    def update(self, obj: Any, expect_rv: Optional[int] = None) -> Any:
        kind = obj.kind
        _, _, namespaced = _ROUTES[kind]
        ns = obj.metadata.namespace if namespaced else None
        if expect_rv is not None:
            # Compare-and-swap: PUT with metadata.resourceVersion — the
            # apiserver 409s on mismatch (leader election depends on this).
            body = obj_to_json(obj)
            body["metadata"]["resourceVersion"] = str(expect_rv)
            doc = self._request(
                "PUT", self._path(kind, ns, obj.metadata.name), body)
            return _FROM_JSON[kind](doc)
        doc = self._request(
            "PATCH", self._path(kind, ns, obj.metadata.name), obj_to_json(obj),
            content_type="application/merge-patch+json",
        )
        return _FROM_JSON[kind](doc)

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        self._request("DELETE", self._path(kind, namespace, name))

    def watch(self, kind: str, send_initial: bool = True) -> "KubeWatch":
        return KubeWatch(self, kind, send_initial)


class KubeWatch:
    """Streams watch events for one kind; same next()/stop() contract as
    cluster.apiserver.Watch (informers consume it unchanged).

    Reflector semantics on expiry: when the apiserver returns **410 Gone**
    (our resourceVersion was compacted away — routine after a disconnect) or
    an ERROR watch event, the stream cannot resume, so we re-LIST and emit a
    synthetic diff against the objects we have forwarded so far — ADDED for
    everything live (informers drop unchanged ones by resourceVersion) and
    DELETED for keys that vanished while we were blind, as client-go's
    reflector does."""

    def __init__(self, server: KubeAPIServer, kind: str, send_initial: bool):
        self.server = server
        self.kind = kind
        self._q: "queue.Queue" = queue.Queue()
        self._stopped = threading.Event()
        self._known: Dict[str, Any] = {}  # key -> last object forwarded
        rv = "0"
        if send_initial:
            doc = server._request("GET", server._path(kind, None))
            rv = (doc.get("metadata") or {}).get("resourceVersion", "0")
            for item in doc.get("items", []):
                self._emit("ADDED", _FROM_JSON[kind](item))
        self._thread = threading.Thread(
            target=self._stream, args=(rv,), daemon=True,
            name=f"kubewatch-{kind}",
        )
        self._thread.start()

    def _emit(self, ev_type: str, obj: Any) -> None:
        key = obj.metadata.key
        if ev_type == "DELETED":
            self._known.pop(key, None)
        else:
            self._known[key] = obj
        self._q.put(WatchEvent(ev_type, obj))

    def _relist(self) -> str:
        """Fresh LIST; emit the synthetic diff. Returns the new list rv."""
        doc = self.server._request("GET", self.server._path(self.kind, None))
        live = {}
        for item in doc.get("items", []):
            obj = _FROM_JSON[self.kind](item)
            live[obj.metadata.key] = obj
        for key in list(self._known):
            if key not in live:
                self._emit("DELETED", self._known[key])
        for obj in live.values():
            self._emit("ADDED", obj)
        return (doc.get("metadata") or {}).get("resourceVersion", "0")

    def _stream(self, rv: str) -> None:
        while not self._stopped.is_set():
            try:
                path = self.server._path(self.kind, None) + (
                    f"?watch=1&allowWatchBookmarks=true&resourceVersion={rv}"
                )
                resp = self.server._request("GET", path, stream=True)
                for line in resp:
                    if self._stopped.is_set():
                        return
                    if not line.strip():
                        continue
                    ev = json.loads(line)
                    ev_type = ev.get("type", "")
                    obj_doc = ev.get("object") or {}
                    if ev_type == "ERROR":
                        # Status object; code 410 (or anything else fatal)
                        # means this stream is unresumable.
                        raise StatusError(
                            int(obj_doc.get("code", 410) or 410),
                            f"watch ERROR event: {obj_doc.get('message', '')}")
                    new_rv = (obj_doc.get("metadata") or {}).get(
                        "resourceVersion")
                    if new_rv:
                        rv = new_rv
                    if ev_type == "BOOKMARK":
                        continue
                    if ev_type not in ("ADDED", "MODIFIED", "DELETED"):
                        continue
                    self._emit(ev_type, _FROM_JSON[self.kind](obj_doc))
            except StatusError as e:
                if self._stopped.is_set():
                    return
                if e.code == 410:
                    log.warning("watch %s expired (410); re-listing",
                                self.kind)
                    try:
                        rv = self._relist()
                        continue
                    except Exception as le:  # noqa: BLE001 — retry below
                        log.warning("watch %s re-list failed (%s)",
                                    self.kind, le)
                else:
                    log.warning("watch %s dropped (%s); reconnecting",
                                self.kind, e)
                self._stopped.wait(1.0)
            except Exception as e:  # noqa: BLE001 — reconnect with backoff
                if self._stopped.is_set():
                    return
                log.warning("watch %s dropped (%s); reconnecting", self.kind, e)
                self._stopped.wait(1.0)

    _SENTINEL = object()

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if ev is KubeWatch._SENTINEL:
            return None  # informer run loops exit on None after stop()
        return ev

    def stop(self) -> None:
        self._stopped.set()
        self._q.put(KubeWatch._SENTINEL)
