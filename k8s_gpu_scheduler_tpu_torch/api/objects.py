"""Typed Kubernetes-style object model of the port (copy of the JAX
package's ``api/objects.py``).

A minimal, hermetic model (the reference consumes these objects through
client-go, its pkg/resources/pods.go and nodes.go) so the scheduler, its
plugins and its tests run with no live cluster, with field names aligned
with the Kubernetes API.

Conventions, kept from the JAX package so every placement can be held
against it:
- chips are requested through the extended resource ``google.com/tpu``;
- accelerator generation and slice topology ride on the GKE node labels
  ``cloud.google.com/gke-tpu-accelerator`` and
  ``cloud.google.com/gke-tpu-topology``.
These describe the cluster being scheduled; the card the port's workloads
run on is described by the workloads themselves."""
from __future__ import annotations

import copy
import time
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

TPU_RESOURCE = "google.com/tpu"

# GKE TPU node labels (public label schema).
LABEL_TPU_ACCELERATOR = "cloud.google.com/gke-tpu-accelerator"
LABEL_TPU_TOPOLOGY = "cloud.google.com/gke-tpu-topology"

# GKE groups the hosts of one multi-host slice into one node pool.
LABEL_NODEPOOL = "cloud.google.com/gke-nodepool"

# Our framework's own annotations/labels.
LABEL_POD_GROUP = "tpu.sched/pod-group"
LABEL_SLICE_GROUP = "tpu.sched/slice-group"    # falls back to LABEL_NODEPOOL
LABEL_WORKER_INDEX = "tpu.sched/worker-index"  # host's index within its slice
ANN_SLICE_CONFIG = "tpu.sched/slice.config"  # analogue of nvidia.com/mig.config
ANN_RESHAPE_STATE = "tpu.sched/slice.reshape-state"


def _now() -> float:
    return time.time()


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = field(default_factory=lambda: str(_uuid.uuid4()))
    resource_version: int = 0
    creation_timestamp: float = field(default_factory=_now)
    # "kind/name" of each ownerReference controller (StatefulSet/Job/...).
    # Empty = bare pod: deleting it is permanent, so preemption and gang
    # collapse must never evict it (no controller will recreate it).
    owner_references: List[str] = field(default_factory=list)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class EnvVar:
    name: str
    value: str = ""


@dataclass
class ConfigMapRef:
    name: str


@dataclass
class ResourceRequirements:
    requests: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)

    def tpu_chips(self) -> int:
        return int(self.requests.get(TPU_RESOURCE, self.limits.get(TPU_RESOURCE, 0)))


@dataclass
class Container:
    name: str = "main"
    image: str = ""
    env: List[EnvVar] = field(default_factory=list)
    env_from: List[ConfigMapRef] = field(default_factory=list)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)

    def get_env(self, name: str) -> Optional[str]:
        for e in self.env:
            if e.name == name:
                return e.value
        return None


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    node_name: str = ""
    scheduler_name: str = "tpu-scheduler"
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[str] = field(default_factory=list)
    # StatefulSet pods carry hostname=<pod name> and subdomain=<serviceName>
    # (the governing headless Service), giving them the stable DNS name
    # <hostname>.<subdomain>.<ns>.svc — the address gang PostBind injects so
    # the distributed runtime can rendezvous POD-to-POD (node addresses
    # are unreachable without hostNetwork).
    hostname: str = ""
    subdomain: str = ""

    def tpu_chips(self) -> int:
        return sum(c.resources.tpu_chips() for c in self.containers)


@dataclass
class PodStatus:
    phase: str = "Pending"  # Pending | Running | Succeeded | Failed
    conditions: List[str] = field(default_factory=list)
    host_ip: str = ""
    pod_ip: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind = "Pod"

    def get_env(self, name: str) -> Optional[str]:
        """Env var of container[0] — parity with utils.GetEnv
        (the reference's utils/utils.go:124-131), which the reference uses to
        read the pod's ``SLO``."""
        if not self.spec.containers:
            return None
        return self.spec.containers[0].get_env(name)

    def pod_group(self) -> Optional[str]:
        return self.metadata.labels.get(LABEL_POD_GROUP)


@dataclass
class NodeStatus:
    capacity: Dict[str, float] = field(default_factory=dict)
    allocatable: Dict[str, float] = field(default_factory=dict)
    addresses: List[str] = field(default_factory=list)
    conditions: List[str] = field(default_factory=lambda: ["Ready"])


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: NodeStatus = field(default_factory=NodeStatus)

    kind = "Node"

    def tpu_capacity(self) -> int:
        return int(self.status.allocatable.get(TPU_RESOURCE, 0))

    def tpu_accelerator(self) -> Optional[str]:
        """e.g. 'tpu-v5-lite-podslice', 'tpu-v5p-slice'."""
        return self.metadata.labels.get(LABEL_TPU_ACCELERATOR)

    def tpu_topology(self) -> Optional[str]:
        """e.g. '2x4' (v5e host), '2x2x2' (v5p sub-slice)."""
        return self.metadata.labels.get(LABEL_TPU_TOPOLOGY)


@dataclass
class ConfigMap:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)

    kind = "ConfigMap"


@dataclass
class PodGroup:
    """Gang-scheduling unit — all-or-nothing admission of ``min_member`` pods.

    The reference has no gang scheduling at all (SURVEY.md §2: each pod is
    scored/bound independently); this is the new first-class capability needed
    for multi-host JAX jobs (a v5p-16 Llama pretrain is 4 pods that must land
    together or not at all).
    """

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_member: int = 1
    # Desired slice topology for the whole gang, e.g. '4x4' → 4 hosts of 2x2.
    topology: str = ""
    schedule_timeout_s: float = 60.0

    kind = "PodGroup"


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease — leader election for scheduler HA.

    The reference gets leader election from upstream kube-scheduler config
    (the reference's deploy/scheduler.yaml:10-13 ``leaderElection:
    leaderElect: true``); we own the framework, so the Lease object and the
    elector (sched/leaderelection.py) live here. Times are epoch seconds
    (converted to RFC3339 MicroTime at the REST boundary)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_s: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0

    kind = "Lease"

    def expired(self, now: float) -> bool:
        return not self.holder_identity or (
            self.renew_time + self.lease_duration_s <= now)


_KINDS = {"Pod": Pod, "Node": Node, "ConfigMap": ConfigMap,
          "PodGroup": PodGroup, "Lease": Lease}


def deepcopy_obj(obj: Any) -> Any:
    return copy.deepcopy(obj)


def kind_of(obj: Any) -> str:
    k = getattr(obj, "kind", None)
    if k is None:
        raise TypeError(f"not an API object: {obj!r}")
    return k
