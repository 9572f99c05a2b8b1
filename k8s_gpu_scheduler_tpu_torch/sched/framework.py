"""Scheduling-framework plugin interfaces (copy of the JAX package's
``sched/framework.py``).

The full extension-point set with kube-scheduler's semantics: PreFilter
→ Filter → Score/NormalizeScore → Reserve → Permit → PostBind.

- Filter runs per (pod, node) and returns Success/Unschedulable.
- Score returns 0..MAX_NODE_SCORE per node; NormalizeScore may rescale the
  whole map afterwards.
- Reserve mutates only scheduler-local state; Unreserve must roll it
  back. Side effects on cluster state belong in PostBind.
- Permit may return WAIT, parking the pod as a WaitingPod; another cycle
  (a gang peer) or a timeout resolves it."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0

SUCCESS = "Success"
UNSCHEDULABLE = "Unschedulable"
WAIT = "Wait"
ERROR = "Error"


@dataclass
class Status:
    code: str = SUCCESS
    message: str = ""

    @property
    def ok(self) -> bool:
        return self.code == SUCCESS

    @staticmethod
    def success() -> "Status":
        return Status(SUCCESS)

    @staticmethod
    def unschedulable(msg: str) -> "Status":
        return Status(UNSCHEDULABLE, msg)

    @staticmethod
    def wait(msg: str = "") -> "Status":
        return Status(WAIT, msg)

    @staticmethod
    def error(msg: str) -> "Status":
        return Status(ERROR, msg)


class CycleState:
    """Per-scheduling-cycle scratch space shared across a pod's plugins —
    kube-scheduler's framework.CycleState. The TPU plugin stashes its Reserve
    decision here for PostBind to write (instead of the reference's
    write-during-Score side channel)."""

    def __init__(self) -> None:
        self._data: Dict[str, Any] = {}
        # Filter/Score fan out over nodes on a thread pool
        # (scheduler._parallel_each); plugins write per-node keys
        # concurrently, and clone() must never iterate a mutating dict.
        self._mu = threading.Lock()

    def write(self, key: str, value: Any) -> None:
        with self._mu:
            self._data[key] = value

    def read(self, key: str, default: Any = None) -> Any:
        with self._mu:
            return self._data.get(key, default)

    def clone(self) -> "CycleState":
        """Shallow copy for speculative re-runs (preemption dry-run Filter):
        the copy sees everything written so far (gang.group, tpu.request)
        but its own writes never leak back into the real cycle."""
        out = CycleState()
        with self._mu:
            out._data = dict(self._data)
        return out


class Plugin:
    name = "Plugin"


class PreFilterPlugin(Plugin):
    def pre_filter(self, state: CycleState, pod) -> Status:
        raise NotImplementedError


class FilterPlugin(Plugin):
    def filter(self, state: CycleState, pod, node_info) -> Status:
        raise NotImplementedError


class PostFilterPlugin(Plugin):
    def post_filter(self, state: CycleState, pod,
                    filtered_reasons: Dict[str, str]) -> Status:
        """Runs only when Filter left NO feasible node. ``filtered_reasons``
        maps node name → why it was rejected. Returning Success means the
        plugin changed the cluster (e.g. preempted victims) such that a
        retry may succeed — kube-scheduler's PostFilter/DefaultPreemption
        contract (inherited whole by the reference via
        cmd/scheduler/main.go:20-22)."""
        raise NotImplementedError


class ScorePlugin(Plugin):
    # weight multiplies this plugin's normalized scores in the final sum
    # (deploy/scheduler.yaml:8-24 gives the reference's plugin weight 10100).
    weight: float = 1.0

    def score(self, state: CycleState, pod, node_name: str) -> Tuple[float, Status]:
        raise NotImplementedError

    def normalize_scores(self, state: CycleState, pod, scores: Dict[str, float]) -> Status:
        """Optional in-place rescale of the full node→score map (parity:
        NormalizeScore gpu_plugins.go:816-841)."""
        return Status.success()


class ReservePlugin(Plugin):
    def reserve(self, state: CycleState, pod, node_name: str) -> Status:
        raise NotImplementedError

    def unreserve(self, state: CycleState, pod, node_name: str) -> None:
        """Roll back reserve; must be idempotent (kube-scheduler contract)."""


class PermitPlugin(Plugin):
    def permit(self, state: CycleState, pod, node_name: str) -> Tuple[Status, float]:
        """Return (status, timeout_s). WAIT parks the pod up to timeout_s."""
        raise NotImplementedError


class PostBindPlugin(Plugin):
    def post_bind(self, state: CycleState, pod, node_name: str) -> None:
        raise NotImplementedError


@dataclass
class Profile:
    """Which plugins run at each extension point (a scheduler profile —
    KubeSchedulerConfiguration's plugins block, deploy/scheduler.yaml:14-24)."""

    pre_filter: List[PreFilterPlugin] = field(default_factory=list)
    filter: List[FilterPlugin] = field(default_factory=list)
    post_filter: List[PostFilterPlugin] = field(default_factory=list)
    score: List[ScorePlugin] = field(default_factory=list)
    reserve: List[ReservePlugin] = field(default_factory=list)
    permit: List[PermitPlugin] = field(default_factory=list)
    post_bind: List[PostBindPlugin] = field(default_factory=list)


class WaitingPod:
    """A pod parked by a Permit WAIT — kube-scheduler's framework.WaitingPod.

    Gang peers call ``allow(plugin_name)``; when every pending plugin has
    allowed, the binder thread proceeds. ``reject`` fails the pod's cycle
    (triggering unreserve + requeue)."""

    def __init__(self, pod, node_name: str, pending_plugins: List[str]) -> None:
        self.pod = pod
        self.node_name = node_name
        self._mu = threading.Lock()
        self._pending = set(pending_plugins)
        self._event = threading.Event()
        self._rejected: Optional[str] = None

    @property
    def uid(self) -> str:
        return self.pod.metadata.uid

    def allow(self, plugin_name: str) -> None:
        with self._mu:
            self._pending.discard(plugin_name)
            if not self._pending:
                self._event.set()

    def reject(self, reason: str) -> None:
        with self._mu:
            if self._rejected is None:
                self._rejected = reason
            self._event.set()

    def wait(self, timeout: float) -> Status:
        """Block until allowed by all plugins, rejected, or timed out."""
        fired = self._event.wait(timeout)
        with self._mu:
            if self._rejected is not None:
                return Status.unschedulable(self._rejected)
            if fired and not self._pending:
                return Status.success()
            return Status.unschedulable("permit wait timed out")


class Nominator:
    """In-memory nominated-pod table — kube-scheduler's PodNominator.

    After preemption frees capacity on a node, the preemptor is *nominated*
    to it. Until the preemptor binds (or is deleted), other pods' Filter
    treats the nominated chips as taken when the nominee has equal or higher
    priority — so the freed capacity cannot be sniped by a pod the eviction
    was not for (the equal-priority race).
    kube-scheduler persists the nomination in pod.status.nominatedNodeName;
    ours is scheduler-local like the rest of the assume state — a failover
    leader re-preempts at worst."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # pod uid -> (pod object at nomination time, node name)
        self._nominated: Dict[str, Tuple[Any, str]] = {}

    def nominate(self, pod, node_name: str) -> None:
        with self._mu:
            self._nominated[pod.metadata.uid] = (pod, node_name)

    def clear(self, pod_uid: str) -> None:
        with self._mu:
            self._nominated.pop(pod_uid, None)

    def node_for(self, pod_uid: str) -> Optional[str]:
        with self._mu:
            entry = self._nominated.get(pod_uid)
            return entry[1] if entry else None

    def pods_on(self, node_name: str) -> List[Any]:
        """Pods currently nominated to this node."""
        with self._mu:
            return [p for p, n in self._nominated.values() if n == node_name]

    def has_nominations(self) -> bool:
        """True when ANY nomination exists — lets the Filter hot path skip
        the per-node pods_on scan in the overwhelmingly common no-recent-
        preemption case (a bare len read is atomic under the GIL). An
        explicit method, not __bool__: truthiness on a Nominator must keep
        meaning 'exists' for `if handle.nominator:` callers."""
        # graftcheck: ignore[lock-guard] — deliberate lock-free read: GIL-atomic, staleness acceptable (docstring above)
        return bool(self._nominated)


class Handle:
    """What plugins get to see — kube-scheduler's framework.Handle. Carries
    the informer factory, resource Descriptor, cluster cache, config, the
    waiting-pod table (for gang admission), and the nominator (preemption)."""

    def __init__(self, factory, descriptor, cache, config) -> None:
        self.factory = factory
        self.descriptor = descriptor
        self.cache = cache
        self.config = config
        self.nominator = Nominator()
        self._waiting_mu = threading.Lock()
        self._waiting: Dict[str, WaitingPod] = {}

    # -- waiting pods (Permit) --------------------------------------------
    def add_waiting_pod(self, wp: WaitingPod) -> None:
        with self._waiting_mu:
            self._waiting[wp.uid] = wp

    def remove_waiting_pod(self, uid: str) -> None:
        with self._waiting_mu:
            self._waiting.pop(uid, None)

    def get_waiting_pod(self, uid: str) -> Optional[WaitingPod]:
        with self._waiting_mu:
            return self._waiting.get(uid)

    def iterate_waiting_pods(self, fn: Callable[[WaitingPod], None]) -> None:
        with self._waiting_mu:
            pods = list(self._waiting.values())
        for wp in pods:
            fn(wp)
