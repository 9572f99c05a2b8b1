"""High-level resource CRUD of the port (copy of the JAX package's
``cluster/resources.py``).

``Descriptor`` mirrors the reference's resources.Descriptor
(pkg/resources/pods.go:182-212): the wrapper the scheduler and its
plugins use for pod, ConfigMap and node operations. By design
``append_to_pod_configmaps`` is atomic through ``APIServer.mutate``, and
``get_node`` takes the node's name."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..api.objects import ConfigMap, Node, Pod
from .apiserver import APIServer, NotFound


@dataclass
class PatchNodeParam:
    """Parity with resources.PatchNodeParam (nodes.go:14-26)."""

    node_name: str
    operator: str  # add | replace | remove
    path: str  # e.g. /metadata/labels/tpu.sched~1slice.config
    value: Dict[str, str]


class Descriptor:
    def __init__(self, server: APIServer) -> None:
        self.server = server

    # -- pods --------------------------------------------------------------
    def list_pods(self, namespace: Optional[str] = None, node_name: Optional[str] = None,
                  phase: Optional[str] = None) -> List[Pod]:
        def field_fn(p: Pod) -> bool:
            if node_name is not None and p.spec.node_name != node_name:
                return False
            if phase is not None and p.status.phase != phase:
                return False
            return True

        return self.server.list("Pod", namespace=namespace, field_fn=field_fn)

    def get_pod(self, name: str, namespace: str = "default") -> Pod:
        return self.server.get("Pod", name, namespace)

    def create_pod(self, pod: Pod) -> Pod:
        return self.server.create(pod)

    def bind_pod(self, name: str, namespace: str, node_name: str) -> Optional[Pod]:
        """The Bind verb: set spec.nodeName (upstream kube-scheduler does this
        through the binding subresource; the plugin never binds directly).
        Servers exposing a direct Binding POST (the REST adapter) take it —
        one round trip; host_ip is the kubelet's to report there. The
        in-memory path keeps filling host_ip so tests see a full object."""
        bind = getattr(self.server, "bind", None)
        if bind is not None:
            bind(name, namespace, node_name)
            return None
        host_ip = node_name
        try:
            node = self.get_node(node_name)
            if node.status.addresses:
                host_ip = node.status.addresses[0]
        except NotFound:
            pass

        def fn(p: Pod) -> None:
            p.spec.node_name = node_name
            p.status.host_ip = host_ip

        return self.server.mutate("Pod", name, namespace, fn)

    def set_pod_phase(self, name: str, namespace: str, phase: str) -> Pod:
        def fn(p: Pod) -> None:
            p.status.phase = phase

        return self.server.mutate("Pod", name, namespace, fn)

    def delete_pod(self, name: str, namespace: str = "default") -> None:
        """Parity with DeletePod grace-period-0 (pods.go:176-181) — used by
        the reference to bounce the profiler DaemonSet pod after MIG reshape
        (gpu_plugins.go:416-433)."""
        self.server.delete("Pod", name, namespace)

    def patch_pod(self, name: str, namespace: str, fn: Callable[[Pod], None]) -> Pod:
        return self.server.mutate("Pod", name, namespace, fn)

    # -- configmaps --------------------------------------------------------
    def create_configmap(self, cm: ConfigMap) -> ConfigMap:
        return self.server.create(cm)

    def get_configmap(self, name: str, namespace: str = "default") -> ConfigMap:
        return self.server.get("ConfigMap", name, namespace)

    def update_configmap(self, name: str, namespace: str, data: Dict[str, str]) -> ConfigMap:
        # Key-append is expressible as a single merge-PATCH; servers that
        # support it directly (the REST adapter) skip mutate's read half —
        # one round trip instead of two on the bind hot path.
        patch = getattr(self.server, "patch_configmap_data", None)
        if patch is not None:
            return patch(name, namespace, data)

        def fn(cm: ConfigMap) -> None:
            cm.data.update(data)

        return self.server.mutate("ConfigMap", name, namespace, fn)

    def append_to_pod_configmaps(self, pod: Pod, data: Dict[str, str]) -> List[str]:
        """Write ``data`` into every ConfigMap the pod EnvFrom-references —
        the device-assignment side channel (parity:
        AppendToExistingConfigMapsInPod pods.go:156-175; consumed by kubelet
        EnvFrom resolution, SURVEY.md §3.3). Returns names written."""
        written: List[str] = []
        for c in pod.spec.containers:
            for ref in c.env_from:
                try:
                    self.update_configmap(ref.name, pod.metadata.namespace, data)
                    written.append(ref.name)
                except NotFound:
                    continue
        return written

    # -- nodes -------------------------------------------------------------
    def list_nodes(self) -> List[Node]:
        return self.server.list("Node")

    def get_node(self, name: str) -> Node:
        return self.server.get("Node", name, "default")

    def label_node(self, param: PatchNodeParam) -> Node:
        """Parity with PatchNodeParam.LabelNode (nodes.go:39-67) — the
        mechanism the reference uses to trigger MIG repartitioning via the
        nvidia.com/mig.config label (gpu_plugins.go:402-410); ours carries
        tpu.sched/slice.config."""

        def fn(n: Node) -> None:
            if param.operator == "remove":
                for k in param.value:
                    n.metadata.labels.pop(k, None)
            else:
                n.metadata.labels.update(param.value)

        return self.server.mutate("Node", param.node_name, "default", fn)
