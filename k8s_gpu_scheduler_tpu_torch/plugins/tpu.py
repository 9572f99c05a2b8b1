"""The TPU scheduler plugin — Filter/Score/Reserve/PostBind (copy of the
JAX package's ``plugins/tpu.py``, the rebuild of the reference's GPU
plugin, pkg/plugins/gpu_plugin/gpu_plugins.go:455-930).

- The assignable unit is a *sub-slice partition* of a host's board
  (``SLICE_CONFIGS`` in ``api/topology.py``), identified by a partition
  key.
- Score is side-effect-free: every decision is stashed in CycleState
  during Score, adopted by Reserve for the winning node only, and written
  to the cluster in PostBind.
- The SLO-slack/interference formula (gpu_plugins.go:616-622, 727-733):
  slack = SLO - (predicted_qps - interference), violated SLOs accumulate
  1/(1+(|slack/SLO|+1)^2), satisfied ones 1/(1+|slack/SLO|), and the
  partition score is 100*((1-k)*pos_avg + k*neg_avg) with
  k = neg_count/(neg_count+pos_count).
- Without a registry or predictor the plugin scores 100*(1-utilization).
- Right-sizing: for shareable hosts the plugin picks the cheapest
  partitioning whose predicted QPS still meets the pod's SLO and records
  it for PostBind.

The recommender and Prometheus clients are not ported yet; the plugin
takes any objects that follow ``PredictionClient`` and the Prometheus
client's ``node_duty_cycle``."""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

from ..api.objects import ANN_RESHAPE_STATE, Pod
from ..api.topology import SliceTopology, TPUGen, chip_count, parse_topology
from ..registry.inventory import NodeInventory, node_key
from ..sched.cache import NodeInfo
from ..sched.framework import (
    CycleState,
    FilterPlugin,
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    PostBindPlugin,
    PreFilterPlugin,
    ReservePlugin,
    ScorePlugin,
    Status,
)

log = logging.getLogger(__name__)

# ConfigMap/env keys injected at PostBind — the CUDA_VISIBLE_DEVICES /
# CUDA_MPS_* analogues (gpu_plugins.go:910-920) in GKE-TPU vocabulary.
ENV_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"
ENV_WORKER_ID = "TPU_WORKER_ID"
ENV_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TOPOLOGY = "TPU_TOPOLOGY"
ENV_ACCELERATOR = "TPU_ACCELERATOR_TYPE"
ENV_HBM_LIMIT = "TPU_HBM_LIMIT_BYTES"
ENV_DUTY_PCT = "TPU_DUTY_CYCLE_PERCENTAGE"
ENV_NEIGHBORS = "TPU_NEIGHBORS"
ENV_SLO = "SLO"
# Latency SLO (p99 ms). The QPS SLO scores against the recommender's
# PREDICTIONS; this one scores against MEASURED latency — serving engines
# publish per-request p99 (models/llama.py --serve), the collector folds
# it into latency/<workload>/<column> keys, and Score/rightsize read them
# here: an SLO you never measure cannot be verified.
ENV_SLO_P99 = "SLO_P99_MS"

_GEN_SHORT = {TPUGen.V5E: "V5E", TPUGen.V6E: "V6E", TPUGen.V5P: "V5P", TPUGen.V4: "V4"}


def gen_short(gen: TPUGen) -> str:
    return _GEN_SHORT[gen]


class PredictionClient(Protocol):
    """What the plugin needs from the recommender (C8 parity —
    go_client/pkg/client_call.go:11-37). Implementations: the gRPC client in
    recommender/client.py; tests inject an in-memory fake."""

    def impute_configurations(self, index: str) -> Dict[str, float]: ...

    def impute_interference(self, index: str) -> Dict[str, float]: ...


class InventorySource(Protocol):
    """Registry read seam (redis Get(nodeName) analogue, gpu_plugins.go:536)."""

    def get(self, key: str) -> Optional[str]: ...


@dataclass
class Partition:
    """One assignable sub-slice of a host board (the MIG-instance analogue).
    chip_ids is a tuple: Partition objects are shared read-only from the
    carve cache across cycles, so an in-place edit would poison every later
    Score call."""

    key: str                    # e.g. "part-0/2x2"
    topology: str               # sub-slice shape, e.g. "2x2"
    chip_ids: Tuple[int, ...]   # device ids owned by this partition


@dataclass
class Decision:
    """What Score decided for one node; Reserve adopts the winner's, PostBind
    writes it. Replaces the reference's mid-score ConfigMap side channel."""

    node_name: str
    partition: Optional[Partition] = None
    # Right-sized partitioning chosen for the pod (MPS_<node> analogue),
    # e.g. "2x2" meaning: this pod is happy with a quarter board.
    rightsized_config: str = ""
    worker_id: int = 0
    hostnames: List[str] = field(default_factory=list)
    accelerator: str = ""
    hbm_limit_bytes: int = 0
    duty_pct: int = 100


def pod_slo(pod: Pod) -> float:
    """Parse the pod's SLO env (QPS target) — parity with the tolerant parse
    at gpu_plugins.go:460-469 (unset/garbage → 0)."""
    raw = pod.get_env(ENV_SLO)
    if not raw:
        return 0.0
    try:
        return float(raw)
    except ValueError:
        return 0.0


def pod_latency_slo(pod: Pod) -> float:
    """The pod's p99 latency SLO in ms (SLO_P99_MS env; unset/garbage → 0),
    same tolerant parse as the QPS SLO."""
    raw = pod.get_env(ENV_SLO_P99)
    if not raw:
        return 0.0
    try:
        return float(raw)
    except ValueError:
        return 0.0


def slo_slack_terms(slo: float, predicted: float, interference: float) -> Tuple[float, bool]:
    """One pod's contribution to the partition score (gpu_plugins.go:616-622).

    Returns (term, violated): violated pods feed negative_sum with a
    quadratically-penalized term; satisfied pods feed positive_sum.
    """
    slack = slo - (predicted - interference)
    rel = abs(slack / slo)
    if slo > predicted - interference:
        return 1.0 / (1.0 + (rel + 1.0) ** 2), True
    return 1.0 / (1.0 + rel), False


def combine_terms(pos_sum: float, pos_n: int, neg_sum: float, neg_n: int) -> float:
    """Blend satisfied/violated contributions (gpu_plugins.go:676-688)."""
    if pos_n and neg_n:
        k = neg_n / (neg_n + pos_n)
        return 100.0 * ((1 - k) * pos_sum / pos_n + k * neg_sum / neg_n)
    if neg_n:
        return 100.0 * neg_sum / neg_n
    if pos_n:
        return 100.0 * pos_sum / pos_n
    return 0.0


def match_interference(interference: Dict[str, float], pod_name: str) -> float:
    """First row of the interference reply whose key is a substring of the
    (normalized) pod name — parity with the '-'→'_' substring match at
    gpu_plugins.go:595-612."""
    normalized = pod_name.replace("-", "_")
    for key, val in interference.items():
        if key in normalized:
            return val
    return 0.0


class TPUPlugin(
    PreFilterPlugin, FilterPlugin, ScorePlugin, ReservePlugin, PostBindPlugin
):
    """The plugin. Construction mirrors New(_, handle) (gpu_plugins.go:928):
    everything it touches arrives via the Handle plus two injected clients."""

    name = "TPU"

    def __init__(
        self,
        handle,
        registry: Optional[InventorySource] = None,
        prom=None,
        recommender: Optional[PredictionClient] = None,
        reshaper=None,
        metrics=None,
    ) -> None:
        self.handle = handle
        self.registry = registry
        self.prom = prom
        self.recommender = recommender
        self.reshaper = reshaper
        # Degraded-scoring accounting (metrics: a metrics.exporter
        # Registry or None): when a recommender RPC exhausts its bounded
        # retries (recommender/client.py RetryPolicy), the cycle SCORES
        # WITHOUT that signal — skip, log once per outage, count — never
        # fails the pod. A scheduler that dies with its advisor inverts
        # the dependency hierarchy: predictions improve placement, their
        # absence must only degrade it.
        self._m_degraded = (metrics.counter(
            "tpu_sched_score_degraded_total",
            "Score decisions that skipped a failing signal source")
            if metrics is not None else None)
        self._recommender_down = False
        self.weight = handle.config.tpu_score_weight
        # Register the ConfigMap informer NOW (before factory.start()) so
        # Score's assignment readbacks hit the lister cache instead of one
        # API-server GET per resident pod per scored node — the reference
        # reads through its configMapLister for the same reason
        # (gpu_plugins.go:60-67,893). Writes still go through the
        # Descriptor (listers are read-only).
        try:
            self._cm_lister = handle.factory.informer("ConfigMap")
        except Exception:  # noqa: BLE001 — factory absent in bare unit tests
            self._cm_lister = None
        # node -> (raw registry value, parsed inventory); see _inventory.
        self._inv_parse_cache: Dict[str, Tuple[str, Optional[NodeInventory]]] = {}
        # (dims, gen, config-annotation) -> carved Partition tuple (read-only).
        self._carve_cache: Dict[Tuple, Tuple[Partition, ...]] = {}
        # pod uid -> (node, partition key) recorded at Reserve; bridges the
        # Reserve -> ConfigMap-visible-in-lister window (see reserve()).
        self._assigned_memo: Dict[str, Tuple[str, str]] = {}
        self._assign_mu = threading.Lock()

    # -- PreFilter ---------------------------------------------------------
    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        chips = pod.spec.tpu_chips()
        if chips < 0:
            return Status.unschedulable("negative TPU request")
        state.write("tpu.request", chips)
        state.write("tpu.slo", pod_slo(pod))
        state.write("tpu.slo_p99", pod_latency_slo(pod))
        return Status.success()

    # -- Filter ------------------------------------------------------------
    def filter(self, state: CycleState, pod: Pod, info: NodeInfo) -> Status:
        # node_selector must match (the reference encodes GPU model in the
        # node NAME and substring-matches it, gpu_plugins.go:478-499; we use
        # labels, the GKE-native mechanism).
        for k, v in pod.spec.node_selector.items():
            if info.node.metadata.labels.get(k) != v:
                return Status.unschedulable(f"node selector {k}={v} not matched")
        if "Ready" not in info.node.status.conditions:
            return Status.unschedulable("node not Ready")
        if info.node.metadata.annotations.get(ANN_RESHAPE_STATE) == "applying":
            # Chips are in flux mid-repartition — the reference instead
            # BLOCKS the scheduling thread through the whole MIG reconfig
            # (gpu_plugins.go:436-452); we skip the node and keep scheduling.
            return Status.unschedulable("slice repartition in progress")
        chips = self._requested_chips(state, pod)
        if chips == 0:
            # CPU-only pod (busybox smoke, BASELINE config 1) — any Ready
            # node that matches the selector will do.
            state.write(f"tpu.nodeinfo/{info.name}", info)
            return Status.success()
        if info.allocatable_tpu == 0:
            return Status.unschedulable("node has no TPUs")
        free = info.free_tpu - self._nominated_chips(pod, info)
        if free < chips:
            return Status.unschedulable(
                f"insufficient TPU chips: want {chips}, free {free}"
            )
        topo = info.slice_topology()
        if topo is None:
            return Status.unschedulable("node missing TPU accelerator/topology labels")
        if chips > topo.chips:
            return Status.unschedulable(
                f"request {chips} exceeds slice size {topo.chips}"
            )
        state.write(f"tpu.nodeinfo/{info.name}", info)
        return Status.success()

    @staticmethod
    def _requested_chips(state: CycleState, pod: Pod) -> int:
        """The pod's chip request, from PreFilter's per-cycle cache when
        present — Filter/Score run per NODE, and re-summing container
        resources each time was ~8% of the 1024-node cycle."""
        chips = state.read("tpu.request")
        return pod.spec.tpu_chips() if chips is None else chips

    def _nominated_chips(self, pod: Pod, info: NodeInfo) -> int:
        """Chips reserved on this node for pods nominated by preemption —
        kube-scheduler's addNominatedPods: when filtering pod P, nominated
        pods with priority >= P's count as already placed (their capacity
        was freed FOR them), so P cannot snipe it; lower-priority nominees
        yield to P exactly as they would on a real node."""
        from ..sched.queue import pod_priority

        nominator = getattr(self.handle, "nominator", None)
        if nominator is None or not nominator.has_nominations():
            return 0
        my_prio = pod_priority(pod)
        my_uid = pod.metadata.uid
        placed = {p.metadata.uid for p in info.pods}
        return sum(
            np.spec.tpu_chips()
            for np in nominator.pods_on(info.name)
            if np.metadata.uid != my_uid
            and np.metadata.uid not in placed
            and pod_priority(np) >= my_prio
        )

    # -- Score -------------------------------------------------------------
    def score(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[float, Status]:
        try:
            decision, raw = self._decide(state, pod, node_name)
        except Exception as e:  # noqa: BLE001 — a scoring dependency down ≠ cycle abort
            log.warning("score(%s) degraded: %s", node_name, e)
            return 0.0, Status.success()
        state.write(f"tpu.decision/{node_name}", decision)
        return raw, Status.success()

    def normalize_scores(self, state: CycleState, pod: Pod, scores: Dict[str, float]) -> Status:
        """Min-max rescale to [MIN,MAX] — parity NormalizeScore
        (gpu_plugins.go:816-841)."""
        if not scores:
            return Status.success()
        lo, hi = min(scores.values()), max(scores.values())
        if hi == lo:
            for k in scores:
                scores[k] = float(MAX_NODE_SCORE)
            return Status.success()
        span = MAX_NODE_SCORE - MIN_NODE_SCORE
        for k, v in scores.items():
            scores[k] = MIN_NODE_SCORE + span * (v - lo) / (hi - lo)
        return Status.success()

    # -- Reserve -----------------------------------------------------------
    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        decision = state.read(f"tpu.decision/{node_name}")
        if decision is None:
            # Score was skipped (single feasible node) — decide now.
            try:
                decision, _ = self._decide(state, pod, node_name)
            except Exception as e:  # noqa: BLE001
                log.warning("reserve-time decide(%s) degraded: %s", node_name, e)
                decision = Decision(node_name=node_name)
        reshape = self._maybe_reshape(state, pod, node_name, decision)
        if reshape is not None:
            return reshape
        state.write("tpu.reserved", decision)
        if decision.partition is not None:
            # Scheduler-local assignment memo: the authoritative record is
            # the ConfigMap written at PostBind, but between Reserve and
            # the lister observing that write there's a window where a
            # concurrent cycle reading only ConfigMaps would not see this
            # pod's partition and could double-place onto it.
            # residents_by_partition consults this memo first.
            with self._assign_mu:
                self._assigned_memo[pod.metadata.uid] = (
                    node_name, decision.partition.key)
                while len(self._assigned_memo) > 4096:
                    self._assigned_memo.pop(next(iter(self._assigned_memo)))
        return Status.success()

    def _maybe_reshape(
        self, state: CycleState, pod: Pod, node_name: str, decision: Decision
    ) -> Optional[Status]:
        """Empty winning node whose partitioning can't serve this pod's SLO:
        kick off the ASYNC repartition and requeue the pod (reconfigure
        parity, gpu_plugins.go:357-452 — triggered on an empty A30 — minus
        its scheduling-thread block). The pod retries via backoff and lands
        once the agent confirms the new layout."""
        if self.reshaper is None or not decision.rightsized_config:
            return None
        info: Optional[NodeInfo] = state.read(f"tpu.nodeinfo/{node_name}")
        if info is None or any(p.spec.tpu_chips() > 0 for p in info.pods):
            return None  # only idle hosts repartition (reference parity)
        current = decision.partition.topology if decision.partition else ""
        if decision.rightsized_config == current:
            return None
        if self.reshaper.request(node_name, decision.rightsized_config):
            return Status.unschedulable(
                f"repartitioning {node_name} to {decision.rightsized_config}"
            )
        return None

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        state.write("tpu.reserved", None)
        with self._assign_mu:
            self._assigned_memo.pop(pod.metadata.uid, None)

    # -- PostBind ----------------------------------------------------------
    def post_bind(self, state: CycleState, pod: Pod, node_name: str) -> None:
        """Inject the device assignment through the pod's EnvFrom ConfigMaps —
        the mechanism of gpu_plugins.go:843-920 (kubelet resolves EnvFrom at
        container start, after this write)."""
        decision: Optional[Decision] = state.read("tpu.reserved")
        if decision is None or decision.node_name != node_name:
            decision = Decision(node_name=node_name)
        data: Dict[str, str] = {}
        if decision.partition is not None:
            part = decision.partition
            data[ENV_VISIBLE_CHIPS] = ",".join(str(i) for i in part.chip_ids)
            data[ENV_TOPOLOGY] = part.topology
            # {nodeName: selectedUUID} parity (gpu_plugins.go:760-772) so
            # GetSLOs-style reverse lookups can attribute pods to partitions.
            data[node_name] = part.key
            # Co-located workloads on this partition, injected so the
            # workload can tag its throughput observations — the collector
            # folds tagged samples into the interference matrix. Besides the (static) env
            # for the pod being bound, the LIVE per-pod registry keys of
            # every affected resident are refreshed: an already-running
            # tenant must stop tagging its samples as solo the moment a
            # neighbor arrives, or its degraded throughput poisons the
            # solo baseline. (Departures are not tracked — a stale tag
            # folds a ~zero delta into interference, the damped direction.)
            residents = self._partition_residents_confirmed(
                pod, node_name, part)
            neighbors = sorted({self._workload_of(p) for p in residents})
            if neighbors:
                data[ENV_NEIGHBORS] = ",".join(neighbors)
            if self.registry is not None:
                my_workload = self._workload_of(pod)
                try:
                    set_fn = getattr(self.registry, "set", None)
                    if set_fn is not None:
                        set_fn(f"neighbors/{pod.metadata.name}",
                               ",".join(neighbors))
                        for r in residents:
                            others = sorted(
                                {self._workload_of(q) for q in residents
                                 if q.metadata.uid != r.metadata.uid}
                                | {my_workload})
                            set_fn(f"neighbors/{r.metadata.name}",
                                   ",".join(others))
                except Exception:  # noqa: BLE001 — observability never blocks binds
                    log.debug("neighbor registry update failed", exc_info=True)
        if decision.accelerator:
            data[ENV_ACCELERATOR] = decision.accelerator
        if decision.rightsized_config:
            # MPS_<node> analogue (gpu_plugins.go:653-666).
            data[f"RIGHTSIZE_{node_name}"] = decision.rightsized_config
        if decision.duty_pct < 100:
            # CUDA_MPS_PINNED_DEVICE_MEM_LIMIT / ACTIVE_THREAD_PERCENTAGE
            # analogues (gpu_plugins.go:896-904). Keyed on duty_pct, not the
            # HBM value: the HBM debit can legitimately reach 0 on a
            # fully-occupied partition, and a shared-host pod must still get
            # its caps then — 0 free is a cap, not an exemption.
            data[ENV_HBM_LIMIT] = str(decision.hbm_limit_bytes)
            data[ENV_DUTY_PCT] = str(decision.duty_pct)
        data[ENV_WORKER_ID] = str(decision.worker_id)
        if decision.hostnames:
            data[ENV_WORKER_HOSTNAMES] = ",".join(decision.hostnames)
        written = self.handle.descriptor.append_to_pod_configmaps(pod, data)
        if not written:
            log.info("pod %s has no EnvFrom ConfigMap; assignment not injected",
                     pod.metadata.key)

    def _partition_residents_confirmed(
        self, pod: Pod, node_name: str, part: Partition
    ) -> List[Pod]:
        """Chip-consuming pods whose CONFIRMED assignment is this partition
        (excluding the pod being bound). Deliberately NOT
        residents_by_partition: its partitions[0] fallback is conservative
        for capacity accounting but would FABRICATE co-residency for pods
        whose assignment couldn't be read back — interference rows keyed on
        a neighbor that never shared chips."""
        info = self.handle.cache.snapshot().get(node_name)
        if info is None:
            return []
        with self._assign_mu:
            memo = dict(self._assigned_memo)
        out = []
        cm_cache: Dict[Tuple[str, str], object] = {}
        for p in info.pods:
            if p.spec.tpu_chips() == 0 or p.metadata.uid == pod.metadata.uid:
                continue
            held = memo.get(p.metadata.uid)
            if held is not None and held[0] == node_name:
                key = held[1]
            else:
                key = self._assigned_partition(p, node_name, cm_cache)
            if key == part.key:
                out.append(p)
        return out

    @staticmethod
    def _workload_of(pod: Pod) -> str:
        """Interference-matrix identity of a pod: its WORKLOAD_NAME env
        (the label the train matrices key on), else the pod name normalized
        to the matrix convention (dashes→underscores, trailing replica
        ordinal stripped) so learned columns merge with seed columns and
        match_interference's substring rule can hit them."""
        name = pod.get_env("WORKLOAD_NAME")
        if name:
            return name
        base = pod.metadata.name.replace("-", "_")
        head, _, tail = base.rpartition("_")
        return head if head and tail.isdigit() else base

    # -- decision core -----------------------------------------------------
    def _decide(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[Decision, float]:
        """Compute (decision, raw_score) for one node. Pure read-only."""
        info: Optional[NodeInfo] = state.read(f"tpu.nodeinfo/{node_name}")
        if info is None:
            for name, i in self.handle.cache.snapshot().items():
                if name == node_name:
                    info = i
                    break
        if info is None:
            return Decision(node_name=node_name), 0.0

        chips_wanted = self._requested_chips(state, pod)
        topo = info.slice_topology()
        if chips_wanted == 0 or topo is None:
            # CPU pod or unlabeled node: score by inverse utilization only.
            return Decision(node_name=node_name), self._utilization_score(node_name)

        inv = self._inventory(node_name)
        partitions = self._partitions(info, topo, inv)
        slo = state.read("tpu.slo") or pod_slo(pod)
        slo_p99 = state.read("tpu.slo_p99")
        if slo_p99 is None:
            slo_p99 = pod_latency_slo(pod)
        workload = self._workload_of(pod)

        if inv is None and self.registry is not None:
            # Registry reachable but node unpublished — conservative parity
            # with the no-registry DCGM fallback (gpu_plugins.go:508-527).
            decision = Decision(node_name=node_name, accelerator=topo.gen.value)
            decision.partition = self._pick_free_partition(info, partitions, chips_wanted)
            return decision, self._utilization_score(node_name, inv)

        decision = Decision(node_name=node_name, accelerator=topo.gen.value)
        if slo <= 0 or self.recommender is None:
            # No QPS SLO or no predictor: inverse-utilization score,
            # emptiest fitting partition (per-chip duty/HBM break
            # pod-count ties). A latency SLO still right-sizes — measured
            # p99 needs only the registry, not the recommender.
            decision.partition = self._pick_free_partition(
                info, partitions, chips_wanted, inv)
            if slo_p99 > 0:
                decision.rightsized_config = self._rightsize(
                    topo, slo, chips_wanted, workload, slo_p99)
            self._fill_sharing_limits(decision, topo, partitions, inv)
            return decision, self._utilization_score(node_name, inv=inv)

        # One registry GET per latency size per _decide call — _slo_score's
        # partition loop and _rightsize's config loop read the same
        # latency/<workload>/<size> keys.
        lat_cache: Dict[int, Optional[float]] = {}
        score, best = self._slo_score(info, topo, partitions, pod, slo,
                                      chips_wanted, inv, slo_p99, lat_cache)
        decision.partition = best or self._pick_free_partition(
            info, partitions, chips_wanted, inv)
        decision.rightsized_config = self._rightsize(
            topo, slo, chips_wanted, workload, slo_p99, lat_cache)
        self._fill_sharing_limits(decision, topo, partitions, inv)
        return decision, score

    def _impute(self, kind: str, index: str) -> Dict[str, float]:
        """Recommender prediction with graceful degradation: a client
        whose bounded retries are spent (deadline expired, attempts
        exhausted — recommender/client.py) raises, and the answer here
        is the EMPTY prediction — every downstream consumer already
        treats a missing column as "no signal", so the cycle completes
        with utilization/latency-only scoring instead of dying. Logged
        once per outage transition (not per call — Score makes 2 calls
        per resident pod per node) and counted per skipped signal so the
        degradation is visible on /metrics while it lasts."""
        assert self.recommender is not None
        fn = (self.recommender.impute_configurations if kind == "conf"
              else self.recommender.impute_interference)
        try:
            reply = fn(index)
        except Exception as e:  # noqa: BLE001 — degrade, never fail the cycle
            if not self._recommender_down:
                log.warning(
                    "recommender degraded (%s: %s); scoring without its "
                    "signal", type(e).__name__, e)
                self._recommender_down = True
            if self._m_degraded is not None:
                self._m_degraded.inc(client="recommender")
            return {}
        if self._recommender_down:
            log.info("recommender recovered; full scoring resumed")
            self._recommender_down = False
        return reply

    def _slo_score(
        self,
        info: NodeInfo,
        topo: SliceTopology,
        partitions: Sequence[Partition],
        pod: Pod,
        slo: float,
        chips_wanted: int,
        inv: Optional[NodeInventory] = None,
        slo_p99: float = 0.0,
        lat_cache: Optional[Dict[int, Optional[float]]] = None,
    ) -> Tuple[float, Optional[Partition]]:
        """The hot loop (gpu_plugins.go:561-756): for every partition, blend
        SLO slack of already-placed pods and of the incoming pod; argmax.
        Per-chip duty cycle breaks SLO-score ties so the emptier sub-slice
        wins — the per-UUID DCGM richness (gpu_plugins.go:162-236) the
        reference feeds its loop. With a
        latency SLO, the incoming pod also contributes a MEASURED-latency
        term per partition size (same slack shape, latency units), so a
        node carved into sub-slices this workload has been observed to
        violate its p99 on loses to a node with bigger partitions."""
        assert self.recommender is not None
        gen = gen_short(topo.gen)
        lat_workload = self._workload_of(pod)
        if lat_cache is None:
            lat_cache = {}
        parts_count = max(len(partitions), 1)
        conf_index = f"{parts_count}P_{gen}"
        placed = self._placed_slos(info, partitions)

        best_score, best_part = float(MIN_NODE_SCORE), None
        best_duty = float("inf")
        incoming_conf = self._impute("conf", pod.metadata.name)
        incoming_intf = self._impute("intf", f"{pod.metadata.name}_{gen}")
        # Hoist per-resident-pod predictions out of the partition loop —
        # conf_index and gen are loop-invariant, so with the real gRPC
        # recommender this is 2 roundtrips per resident pod instead of
        # 2 × partition_count (the reference pays the full quadratic cost,
        # gpu_plugins.go:577-590).
        pred_cache: Dict[str, Tuple[Optional[float], Dict[str, float]]] = {}
        for names in placed.values():
            for other_name in names:
                if other_name not in pred_cache:
                    pred_cache[other_name] = (
                        self._impute("conf", other_name).get(conf_index),
                        self._impute("intf", f"{other_name}_{gen}"),
                    )
        for part in partitions:
            if len(part.chip_ids) < chips_wanted:
                continue
            pos_sum, neg_sum, pos_n, neg_n = 0.0, 0.0, 0, 0
            co_located = placed.get(part.key, {})
            for other_name, other_slo in co_located.items():
                if other_slo <= 0:
                    continue
                conf, intf_row = pred_cache[other_name]
                if conf is None:
                    continue
                intf = sum(
                    match_interference(intf_row, third)
                    for third in co_located
                    if third != other_name
                )
                intf += match_interference(intf_row, pod.metadata.name)
                term, violated = slo_slack_terms(other_slo, conf, intf)
                if violated:
                    neg_sum += term
                    neg_n += 1
                else:
                    pos_sum += term
                    pos_n += 1

            conf = incoming_conf.get(conf_index)
            if conf is not None:
                intf = sum(
                    match_interference(incoming_intf, third) for third in co_located
                )
                term, violated = slo_slack_terms(slo, conf, intf)
                if violated:
                    neg_sum += term
                    neg_n += 1
                else:
                    pos_sum += term
                    pos_n += 1

            if slo_p99 > 0:
                chips_p = len(part.chip_ids)
                if chips_p not in lat_cache:
                    # One registry GET per partition SIZE per score call —
                    # a carved board repeats the same size across its
                    # partitions, and this sits in the hot loop.
                    lat_cache[chips_p] = self._measured_p99(
                        lat_workload, chips_p, gen)
                measured = lat_cache[chips_p]
                if measured is not None:
                    # Same slack shape as slo_slack_terms, latency units
                    # (violation = measured ABOVE the target).
                    rel = abs(measured - slo_p99) / slo_p99
                    if measured > slo_p99:
                        neg_sum += 1.0 / (1.0 + (rel + 1.0) ** 2)
                        neg_n += 1
                    else:
                        pos_sum += 1.0 / (1.0 + rel)
                        pos_n += 1

            part_score = combine_terms(pos_sum, pos_n, neg_sum, neg_n)
            duty, _, _ = self._partition_load(part, inv)
            if part_score > best_score or (
                part_score == best_score and duty < best_duty
            ):
                best_score, best_part, best_duty = part_score, part, duty
        return best_score, best_part

    def _rightsize(self, topo: SliceTopology, slo: float, chips_wanted: int,
                   workload: str = "", slo_p99: float = 0.0,
                   lat_cache: Optional[Dict[int, Optional[float]]] = None,
                   ) -> str:
        """Cheapest partitioning that still meets the SLO — V100/MPS
        right-sizing parity (gpu_plugins.go:638-666), smallest sub-slice
        preferred (the reference prefers the *lowest predicted QPS* that
        still clears the SLO). Sub-slices smaller than the pod's own chip
        request are never candidates — repartitioning a node so the
        triggering pod can't fit would strand it.

        Latency overlay (``slo_p99`` > 0): a candidate whose MEASURED p99
        for this workload at that sub-slice size violates the latency SLO
        is excluded — so a serving pod observed missing its p99 on a small
        partition gets a bigger one on its next placement, even when the
        recommender's QPS prediction says the small one suffices. Without
        a QPS SLO the latency overlay alone right-sizes, but only when a
        violation was actually observed (no measured violation → no
        reshape churn)."""
        if self.recommender is None and slo_p99 <= 0:
            return ""
        from ..api.topology import SLICE_CONFIGS

        gen = gen_short(topo.gen)
        if lat_cache is None:
            lat_cache = {}
        candidates: List[Tuple[str, int, int]] = []   # (cfg, parts, chips)
        max_violating = 0
        for cfg, parts in SLICE_CONFIGS[topo.gen]:
            chips_c = chip_count(parse_topology(cfg))
            if chips_c < chips_wanted:
                continue
            if slo_p99 > 0:
                if chips_c not in lat_cache:
                    lat_cache[chips_c] = self._measured_p99(
                        workload, chips_c, gen)
                measured = lat_cache[chips_c]
                if measured is not None and measured > slo_p99:
                    max_violating = max(max_violating, chips_c)
                    continue
            candidates.append((cfg, parts, chips_c))
        # Latency is monotone in partition size for a fixed workload: any
        # config AT OR BELOW a measured-violating size is out too, even if
        # never measured itself — otherwise a violation at 4 chips could
        # "rightsize" the pod down to an unmeasured 1-chip slice, the
        # opposite of escaping the violation.
        eligible = [c for c in candidates if c[2] > max_violating]
        if slo <= 0 or self.recommender is None:
            # Latency-only mode: smallest non-violating sub-slice, and only
            # when a measured violation exists to escape from.
            if not max_violating or not eligible:
                return ""
            return min(eligible, key=lambda e: e[2])[0]
        best_cfg, best_pred = "", -1.0
        for cfg, parts, _ in eligible:
            preds = self._impute("conf", cfg)
            pred = preds.get(f"{parts}P_{gen}")
            if pred is None:
                continue
            if pred > slo and (best_pred < 0 or pred < best_pred):
                best_cfg, best_pred = cfg, pred
        return best_cfg

    # -- measured latency (SLO_P99_MS loop) --------------------------------
    def _measured_p99(self, workload: str, chips: int,
                      gen: str) -> Optional[float]:
        """Collector-folded p99 for (workload, {chips}P_{gen}) from the
        registry (recommender/collector.py _fold_latencies writes it);
        None = never measured / registry absent."""
        if self.registry is None or not workload:
            return None
        from ..registry.inventory import latency_key

        try:
            raw = self.registry.get(latency_key(workload, f"{chips}P_{gen}"))
        except Exception:  # noqa: BLE001 — registry down = no latency signal
            return None
        if not raw:
            return None
        try:
            return float(raw)
        except ValueError:
            return None


    # -- partition / inventory helpers ------------------------------------
    def _inventory(self, node_name: str) -> Optional[NodeInventory]:
        """Registry read with a parse cache keyed on the RAW value: Score
        reads every feasible node's inventory every cycle, but the agent
        republishes each node at most every heartbeat — re-decoding an
        unchanged JSON blob per (pod × node) was the top cycle cost at 256
        nodes. The raw string is the cache key, so a republished value is
        picked up immediately; dict ops are GIL-atomic, so concurrent Score
        threads at worst parse the same blob twice."""
        if self.registry is None:
            return None
        try:
            raw = self.registry.get(node_key(node_name))
        except Exception:  # noqa: BLE001 — registry down = degrade, don't abort
            return None
        if raw is None:
            return None
        cached = self._inv_parse_cache.get(node_name)
        if cached is not None and cached[0] == raw:
            return cached[1]
        try:
            inv = NodeInventory.from_json(raw)
        except (ValueError, TypeError, KeyError):
            inv = None
        self._inv_parse_cache[node_name] = (raw, inv)
        return inv

    def _partitions(
        self, info: NodeInfo, topo: SliceTopology, inv: Optional[NodeInventory]
    ) -> Tuple[Partition, ...]:
        """Carve the host board into assignable partitions according to the
        node's current slice config annotation (the nvidia.com/mig.config
        analogue) — default one whole-board partition. Board size comes from
        host_board (a multi-host v5e host owns a 2x2 4-chip board, NOT the
        full 2x4 — topology.py:100-118), so partition chip ids always exist
        on this host."""
        from ..api.objects import ANN_SLICE_CONFIG
        from ..api.topology import format_topology, host_board

        cfg = info.node.metadata.annotations.get(ANN_SLICE_CONFIG, "")
        # The carve is a pure function of (board, config annotation) and
        # Partition objects are read-only after construction — memoized so
        # Score at fleet scale doesn't rebuild identical lists per node per
        # cycle (it was a top allocation site in the 256-node profile).
        memo_key = (topo.dims, topo.gen, cfg)
        cached = self._carve_cache.get(memo_key)
        if cached is not None:
            return cached
        board = host_board(topo.dims, topo.gen)
        total = chip_count(board)
        if cfg:
            try:
                per = chip_count(parse_topology(cfg))
            except ValueError:
                per = total
            shown = cfg
        else:
            shown = format_topology(board)
            per = total
        per = max(1, min(per, total))
        count = total // per
        parts = tuple(
            Partition(
                key=f"part-{i}/{shown}",
                topology=shown,
                chip_ids=tuple(range(i * per, (i + 1) * per)),
            )
            for i in range(count)
        )
        if len(self._carve_cache) > 1024:
            self._carve_cache.clear()
        self._carve_cache[memo_key] = parts
        return parts

    def residents_by_partition(
        self, info: NodeInfo, partitions: Sequence[Partition]
    ) -> Dict[str, List[Pod]]:
        """partition key → chip-consuming residents, attributed by ConfigMap
        readback ({nodeName: partition} written at PostBind); pods with no
        assignment yet go to the first partition so its capacity still
        counts (conservative). The ONE attribution rule — Score
        (_placed_slos) and preemption victim selection both call this, so
        they can never diverge. ConfigMap fetches are memoized per call:
        gang members share one map, and each fetch is an API-server
        round-trip (cluster/resources.py get_configmap)."""
        fallback = partitions[0].key if partitions else ""
        out: Dict[str, List[Pod]] = {p.key: [] for p in partitions}
        cm_cache: Dict[Tuple[str, str], object] = {}
        # Per-resident .get()s under the lock, NOT a dict copy: the memo
        # holds up to 4096 entries and this runs once per Score call — the
        # copy dominated the 256-node cycle profile.
        with self._assign_mu:
            held_by_uid = [
                (p, self._assigned_memo.get(p.metadata.uid))
                for p in info.pods if p.spec.tpu_chips() > 0
            ]
        for p, held in held_by_uid:
            if held is not None and held[0] == info.name and held[1] in out:
                key = held[1]
            else:
                key = self._assigned_partition(p, info.name, cm_cache)
            if key is None or key not in out:
                key = fallback
            out.setdefault(key, []).append(p)
        return out

    def _placed_slos(
        self, info: NodeInfo, partitions: Sequence[Partition]
    ) -> Dict[str, Dict[str, float]]:
        """partition key → {pod name → SLO} for pods already on the node —
        GetSLOs parity (gpu_plugins.go:87-160)."""
        out: Dict[str, Dict[str, float]] = {}
        for key, residents in self.residents_by_partition(info, partitions).items():
            for p in residents:
                out.setdefault(key, {})[p.metadata.name] = pod_slo(p)
        return out

    def _assigned_partition(
        self,
        pod: Pod,
        node_name: str,
        cm_cache: Optional[Dict] = None,
    ) -> Optional[str]:
        for c in pod.spec.containers:
            for ref in c.env_from:
                cache_key = (ref.name, pod.metadata.namespace)
                if cm_cache is not None and cache_key in cm_cache:
                    cm = cm_cache[cache_key]
                else:
                    cm = self._read_configmap(ref.name, pod.metadata.namespace)
                    if cm_cache is not None:
                        cm_cache[cache_key] = cm
                if cm is not None and node_name in cm.data:
                    return cm.data[node_name]
        return None

    def _read_configmap(self, name: str, namespace: str):
        """Lister-first ConfigMap read (see __init__); API GET fallback when
        the informer isn't running (unit tests, bare construction)."""
        if self._cm_lister is not None and self._cm_lister.has_synced():
            return self._cm_lister.get(name, namespace)
        try:
            return self.handle.descriptor.get_configmap(name, namespace)
        except Exception:  # noqa: BLE001 — NotFound or API hiccup
            return None

    def _pick_free_partition(
        self,
        info: NodeInfo,
        partitions: Sequence[Partition],
        chips_wanted: int,
        inv: Optional[NodeInventory] = None,
    ) -> Optional[Partition]:
        """Emptiest partition with enough chips: fewest pods already
        attributed, then lowest live per-chip duty cycle, then least HBM in
        use — the per-UUID metrics the reference scores with
        (GetDcgmMetricsForUUIDS, gpu_plugins.go:162-236 feeding :561-756).
        Deterministic (the reference shuffles UUIDs at :561 — determinism
        makes hermetic tests exact)."""
        if not partitions:
            return None
        placed = self._placed_slos(info, partitions)
        eligible = [p for p in partitions if len(p.chip_ids) >= chips_wanted]
        if not eligible:
            return None

        def rank(p: Partition):
            duty, hbm_used, _ = self._partition_load(p, inv)
            return (len(placed.get(p.key, {})), duty, hbm_used, p.key)

        return min(eligible, key=rank)

    @staticmethod
    def _partition_load(
        part: Partition, inv: Optional[NodeInventory]
    ) -> Tuple[float, int, int]:
        """(mean duty cycle 0..1, HBM bytes used, HBM bytes total) over the
        partition's chips, from the agent-published per-chip inventory
        (registry/inventory.py ChipInfo). No inventory → all zeros, so
        ranking degrades to pod-count order."""
        if inv is None or not inv.chips:
            return 0.0, 0, 0
        chips = [c for c in inv.chips if c.device_id in part.chip_ids]
        if not chips:
            return 0.0, 0, 0
        duty = sum(c.duty_cycle for c in chips) / len(chips)
        used = sum(c.hbm_used_bytes for c in chips)
        total = sum(c.hbm_total_bytes for c in chips)
        return duty, used, total

    def _fill_sharing_limits(
        self,
        decision: Decision,
        topo: SliceTopology,
        partitions: Sequence[Partition],
        inv: Optional[NodeInventory] = None,
    ) -> None:
        """HBM/duty caps when the host is shared — the MPS-limit analogue
        (gpu_plugins.go:896-904: 2 partitions → half memory/50%, 4 →
        quarter/25%). HBM already in use on the assigned partition (per-chip
        agent inventory) is debited from the cap, so a pod landing next to a
        resident tenant is budgeted what is actually free, not the nameplate
        capacity."""
        n = len(partitions)
        if n <= 1:
            return
        per_chip_hbm = int(topo.gen.hbm_gib * (1 << 30))
        chips = len(decision.partition.chip_ids) if decision.partition else 1
        limit = per_chip_hbm * chips
        if decision.partition is not None:
            _, hbm_used, hbm_total = self._partition_load(decision.partition, inv)
            if hbm_total > 0:
                limit = min(limit, hbm_total)
            limit = max(0, limit - hbm_used)
        decision.hbm_limit_bytes = limit
        decision.duty_pct = max(1, 100 // n)

    _UNFETCHED = object()  # sentinel: caller hasn't consulted the registry

    def _utilization_score(self, node_name: str, inv=_UNFETCHED) -> float:
        """100*(1-utilization) — the DCGM_FI_PROF_GR_ENGINE_ACTIVE fallback
        (gpu_plugins.go:508-527). Prefers the agent-published inventory
        (0..1), then the Prometheus duty-cycle series (0..100), then neutral
        0. Callers that already read the registry pass their result (possibly
        None) to avoid a second roundtrip."""
        if inv is TPUPlugin._UNFETCHED:
            inv = self._inventory(node_name)
        if inv is not None:
            return 100.0 * (1.0 - max(0.0, min(1.0, inv.utilization)))
        if self.prom is not None:
            try:
                duty_pct = self.prom.node_duty_cycle(node_name)
            except Exception:  # noqa: BLE001
                duty_pct = None
            if duty_pct is not None:
                return 100.0 - max(0.0, min(100.0, duty_pct))
        return 0.0
