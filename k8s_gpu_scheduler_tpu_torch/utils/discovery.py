"""Service and pod discovery helpers (copy of the JAX package's
``utils/discovery.py``): locate a pod's node, the addresses of the nodes
that host pods matching a name substring, and a node's agent pod, over a
``cluster.resources.Descriptor``. Explicit configuration (the registry
and metrics endpoints of ``config.py``) comes first; these name-substring
lookups are the fallback. Errors are returned or raised to the caller."""
from __future__ import annotations

from typing import List, Optional

from ..api.objects import Pod
from ..cluster.resources import Descriptor


def exists_substring(items: List[str], sub: str) -> bool:
    """Whether any item contains ``sub``."""
    return any(sub in s for s in items)


def find_node_from_pod(desc: Descriptor, pod_substring: str, namespace: str) -> Optional[str]:
    """Node name hosting the first pod whose name contains
    ``pod_substring``."""
    for pod in desc.list_pods(namespace=namespace):
        if pod_substring in pod.metadata.name:
            return pod.spec.node_name or None
    return None


def find_nodes_ip_from_pod(
    desc: Descriptor, pod_substring: str, namespace: str
) -> List[str]:
    """Addresses of nodes hosting pods whose name contains
    ``pod_substring`` (the node's name where it has no address)."""
    out: List[str] = []
    for pod in desc.list_pods(namespace=namespace):
        if pod_substring in pod.metadata.name and pod.spec.node_name:
            try:
                node = desc.get_node(pod.spec.node_name)
            except Exception:
                continue
            if node.status.addresses:
                out.append(node.status.addresses[0])
            else:
                out.append(pod.spec.node_name)
    return out


def find_agent_pod_on_node(
    desc: Descriptor, node_name: str, agent_substring: str = "tpu-agent", namespace: Optional[str] = None
) -> Optional[Pod]:
    """The node's metrics-agent pod: the first pod on ``node_name`` whose
    name contains ``agent_substring``."""
    for pod in desc.list_pods(namespace=namespace, node_name=node_name):
        if agent_substring in pod.metadata.name:
            return pod
    return None
