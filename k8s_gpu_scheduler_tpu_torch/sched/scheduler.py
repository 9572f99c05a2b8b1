"""The scheduling cycle (copy of the JAX package's ``sched/scheduler.py``):

  pop → snapshot → PreFilter → Filter×nodes → Score×nodes → NormalizeScore →
  select → assume → Reserve → Permit (may WAIT) → bind → PostBind

with kube-scheduler's error contract: any failure after assume runs every
Reserve plugin's unreserve, forgets the assumed pod, and requeues with
backoff. Binding runs on a binder pool so a gang pod waiting in Permit
never blocks the next pod's scheduling cycle. Filter and Score fan out on
a pool above ``parallelize_threshold`` nodes, and above
``min_feasible_to_find`` nodes the feasible-node search samples from a
rotating offset."""
from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ..api.objects import LABEL_POD_GROUP, Pod
from ..cluster.apiserver import APIServer
from ..cluster.informers import SharedInformerFactory
from ..cluster.resources import Descriptor
from ..config import SchedulerConfig
from ..metrics.exporter import Registry
from ..obs import SYSTEM_CLOCK
from .cache import Cache, NodeInfo
from .framework import (
    CycleState,
    Handle,
    Profile,
    Status,
    UNSCHEDULABLE,
    WAIT,
    WaitingPod,
)
from .queue import SchedulingQueue, pod_priority

log = logging.getLogger(__name__)


def pod_class(pod: Pod) -> str:
    """Latency class for the per-class e2e histograms: ``gang`` (pod-group
    label — e2e includes Permit quorum wait), ``preempting`` (non-zero
    priority per queue.pod_priority, the ONE parser of the annotation —
    e2e includes the victims' eviction), else ``single`` (the
    kube-comparable population)."""
    if pod.metadata.labels.get(LABEL_POD_GROUP):
        return "gang"
    if pod_priority(pod) > 0:
        return "preempting"
    return "single"


class Scheduler:
    def __init__(
        self,
        server: APIServer,
        profile: Optional[Profile] = None,
        config: Optional[SchedulerConfig] = None,
        metrics: Optional[Registry] = None,
        elector=None,
        fault_injector=None,
        tracer=None,
        clock=None,
    ) -> None:
        self.config = config or SchedulerConfig()
        # Observability (obs/): the injected clock is the one time source
        # for every cycle/e2e duration (virtual time in tests); the tracer
        # (None in production) records the control-plane half of the
        # request lifecycle — sched_queue (first enqueue -> pop, backoff
        # round-trips included), sched_cycle (Filter->Permit) and
        # sched_bind — on the "sched" lane, rid = the pod name, so a
        # serving caller that submits with trace_id=<pod name> gets one
        # correlated scheduler->engine timeline.
        self._clock = clock or SYSTEM_CLOCK
        self._tracer = tracer
        # Chaos harness hook (testing/faults.py): ``sched.cycle`` fires at
        # the top of every scheduling cycle — an injected drop unwinds the
        # cycle exactly like any plugin failure (the pod requeues with
        # backoff), which is the contract chaos tests verify. None in
        # production: one `is None` check per cycle.
        self._faults = fault_injector
        # Exported metrics — the BASELINE north-star (p50 schedule latency)
        # reads tpu_sched_e2e_duration_seconds; the reference exports nothing
        # of its own (SURVEY.md §5 "Metrics / observability").
        self.metrics = metrics or Registry()
        self._m_cycle = self.metrics.histogram(
            "tpu_sched_scheduling_cycle_seconds", "One Filter->Permit cycle duration"
        )
        self._m_e2e = self.metrics.histogram(
            "tpu_sched_e2e_duration_seconds", "Cycle start to successful bind"
        )
        # Per-class e2e split (one distribution for two populations
        # would mix them): gang members' e2e includes Permit quorum wait —
        # workload shape, not scheduler work — which buries the
        # kube-comparable singleton tail. Class is derived from the pod
        # itself (pod-group label / priority annotation), so the split
        # needs no bench-side cooperation.
        self._m_e2e_class = {
            cls: self.metrics.histogram(
                f"tpu_sched_e2e_duration_seconds_class_{cls}",
                f"Cycle start to successful bind, {cls} pods")
            for cls in ("single", "gang", "preempting")
        }
        self._m_attempts = self.metrics.counter(
            "tpu_sched_attempts_total", "Scheduling attempts by result"
        )
        self.server = server
        self.descriptor = Descriptor(server)
        self.factory = SharedInformerFactory(server)
        self.cache = Cache()
        self.queue = SchedulingQueue(
            backoff_initial_s=self.config.backoff_initial_s,
            backoff_max_s=self.config.backoff_max_s,
            clock=self._clock,
        )
        self.profile = profile or Profile()
        self.handle = Handle(self.factory, self.descriptor, self.cache, self.config)
        # Why the last cycle for a pod failed — introspection + tests.
        self.failure_reasons: Dict[str, str] = {}
        self._fail_mu = threading.Lock()
        # Binds are pure IO (one POST + PostBind writes) — a deeper pool
        # shortens the queue-wait share of e2e latency under churn bursts
        # (kube-scheduler spawns one goroutine per bind, i.e. unbounded).
        self._binder = ThreadPoolExecutor(max_workers=32, thread_name_prefix="binder")
        # Filter/Score fan-out pool (kube-scheduler's --parallelism); the
        # cycle thread blocks on each wave, so one pool serves all cycles.
        self._cycle_pool = ThreadPoolExecutor(
            max_workers=max(1, self.config.parallelism),
            thread_name_prefix="fanout",
        )
        self._scan_offset = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Optional LeaderElector (sched/leaderelection.py): the cycle loop
        # only pops while holding the lease; informers stay warm on standby
        # replicas — kube-scheduler's HA shape, which the reference turns on
        # via deploy config (deploy/scheduler.yaml:10-13).
        self.elector = elector
        self._wire_informers()

    # -- informer wiring ---------------------------------------------------
    def _wire_informers(self) -> None:
        nodes = self.factory.informer("Node")
        pods = self.factory.informer("Pod")
        nodes.add_event_handler(
            on_add=lambda n: (self.cache.add_node(n), self.queue.move_all_to_active("node-add")),
            on_update=self._on_node_update,
            on_delete=self.cache.delete_node,
        )
        pods.add_event_handler(
            on_add=self._on_pod_add, on_update=self._on_pod_update, on_delete=self._on_pod_delete
        )

    def _on_node_update(self, old, new) -> None:
        self.cache.update_node(old, new)
        # Flush the backoff pool only for changes that can make an
        # unschedulable pod schedulable. Unfiltered, EVERY node write —
        # status heartbeats, our own reshaper/agent annotations mid-flight —
        # reset every backed-off pod's wait, a retry-storm generator under
        # churn (kube-scheduler filters queue moves by event usefulness the
        # same way).
        if old is None or self._node_update_useful(old, new):
            self.queue.move_all_to_active("node-update")

    @staticmethod
    def _node_update_useful(old, new) -> bool:
        return (
            old.metadata.labels != new.metadata.labels
            or old.metadata.annotations != new.metadata.annotations
            or old.status.allocatable != new.status.allocatable
            or old.status.capacity != new.status.capacity
            or old.status.conditions != new.status.conditions
        )

    def _ours(self, pod: Pod) -> bool:
        return pod.spec.scheduler_name == self.config.scheduler_name

    @staticmethod
    def _terminal(pod: Pod) -> bool:
        return pod.status.phase in ("Succeeded", "Failed")

    def _on_pod_add(self, pod: Pod) -> None:
        if pod.spec.node_name:
            if not self._terminal(pod):  # finished pods hold no chips
                self.cache.add_pod(pod)
        elif self._ours(pod) and pod.status.phase == "Pending":
            self.queue.add(pod)

    def _on_pod_update(self, old: Optional[Pod], new: Pod) -> None:
        if new.spec.node_name:
            if self._terminal(new):
                # Terminal pods release their chips (idempotent vs. the
                # following DELETE event).
                self.cache.delete_pod(new)
                self.queue.move_all_to_active("pod-finished")
            else:
                self.cache.update_pod(old, new)
        elif self._ours(new) and new.status.phase == "Pending":
            self.queue.add(new)

    def _on_pod_delete(self, pod: Pod) -> None:
        if pod.spec.node_name:
            self.cache.delete_pod(pod)
            self.queue.move_all_to_active("pod-deleted")
        else:
            self.queue.remove(pod)
        self.handle.nominator.clear(pod.metadata.uid)
        with self._fail_mu:
            self.failure_reasons.pop(pod.metadata.key, None)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.factory.informer("Node")
        self.factory.informer("Pod")
        self.factory.start()
        self.factory.wait_for_cache_sync()
        if self.elector is not None:
            self.elector.start()
        self._thread = threading.Thread(target=self._run, name="sched-cycle", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        # Join the cycle thread FIRST — both so no new waiting pod can be
        # parked after the reject pass below (shutdown would block for its
        # full permit timeout), and so the leadership lease is released only
        # after this replica's in-flight cycle has finished binding.
        # Releasing first would let a standby acquire the lease and start
        # binding while our last cycle still binds: two leaders.
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.elector is not None:
            self.elector.stop()
        self.handle.iterate_waiting_pods(lambda wp: wp.reject("scheduler shutting down"))
        self._binder.shutdown(wait=True)
        self._cycle_pool.shutdown(wait=True)
        self.factory.stop()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.elector is not None and not self.elector.is_leader():
                self._stop.wait(0.05)
                continue
            pod = self.queue.pop(timeout=0.5)
            if pod is None:
                continue
            if self.elector is not None and not self.elector.is_leader():
                # Leadership lapsed while blocked in pop (the pop window
                # straddles a demotion — found by the chaos failover
                # test): the new leader owns this pod now. Requeue it
                # locally with backoff so a re-elected replica still has
                # it; never run a cycle without the lease.
                self.queue.add_unschedulable(pod)
                continue
            try:
                self.schedule_pod(pod)
            except Exception:  # noqa: BLE001 — the cycle must survive anything
                log.exception("scheduling cycle failed for %s", pod.metadata.key)
                self.queue.add_unschedulable(pod)

    # -- one cycle ---------------------------------------------------------
    def schedule_pod(self, pod: Pod) -> None:
        # Revalidate against the live informer: the queued object may be
        # stale (deleted or already bound while queued).
        live = self.factory.informer("Pod").get(pod.metadata.name, pod.metadata.namespace)
        if live is None or live.spec.node_name:
            self.queue.done(pod)
            return
        pod = live

        if self._faults is not None:
            self._faults.fire("sched.cycle")
        if self._tracer is not None:
            # Queue wait ends where the cycle begins; t0 is the FIRST
            # enqueue (backoff round-trips count toward the wait — the
            # number an SLO investigation needs).
            now = self._clock.monotonic()
            t0 = self.queue.enqueued_at(pod.metadata.uid)
            self._tracer.record("sched_queue", t0 if t0 is not None
                                else now, now, lane="sched",
                                rid=pod.metadata.name)
        state = CycleState()
        state.write("cycle_start", self._clock.monotonic())
        try:
            self._run_cycle(state, pod)
        finally:
            dt = self._clock.monotonic() - state.read("cycle_start")
            self._m_cycle.observe(dt)
            if self._tracer is not None:
                self._tracer.record(
                    "sched_cycle", state.read("cycle_start"),
                    state.read("cycle_start") + dt, lane="sched",
                    rid=pod.metadata.name)

    def _run_cycle(self, state: CycleState, pod: Pod) -> None:
        for pl in self.profile.pre_filter:
            st = pl.pre_filter(state, pod)
            if st.code == UNSCHEDULABLE:
                self._record_failure(pod, f"{pl.name}: {st.message}")
                self._m_attempts.inc(result="unschedulable")
                self.queue.add_unschedulable(pod)
                return
            if not st.ok:
                self._m_attempts.inc(result="error")
                self.queue.add_unschedulable(pod)
                return

        snapshot = self.cache.snapshot()
        feasible, reasons = self._find_feasible(state, pod, snapshot)

        if not feasible:
            msg = "; ".join(f"{n}: {r}" for n, r in sorted(reasons.items())) or "no nodes"
            self._record_failure(pod, f"0/{len(snapshot)} nodes available: {msg}")
            # PostFilter (preemption): a plugin may free capacity so the
            # requeued pod succeeds next cycle — the victims' delete events
            # move it from backoff to active, and the priority queue pops
            # the (higher-priority) preemptor before anything that could
            # steal the freed chips.
            for pl in self.profile.post_filter:
                st = pl.post_filter(state, pod, reasons)
                if st.ok:
                    self._record_failure(
                        pod, f"{pl.name}: preempted victims; waiting for "
                             f"capacity release")
                    self._m_attempts.inc(result="preempted")
                    self.queue.add_unschedulable(pod)
                    return
                if st.message:
                    self._record_failure(
                        pod, f"0/{len(snapshot)} nodes available: {msg}; "
                             f"{pl.name}: {st.message}")
            self._m_attempts.inc(result="unschedulable")
            self.queue.add_unschedulable(pod)
            return

        best = self._select_node(state, pod, feasible)

        # Reserve: debit the cache first so concurrent cycles see the chips
        # taken, then run Reserve plugins (scheduler-local state only). Any
        # failure OR exception past this point must credit the chips back —
        # a leaked assume would permanently shrink the node.
        self.cache.assume(pod, best)
        try:
            for pl in self.profile.reserve:
                st = pl.reserve(state, pod, best)
                if not st.ok:
                    self._record_failure(pod, f"{pl.name}: {st.message}")
                    self._abort_after_assume(state, pod, best)
                    return

            # Permit: may park the pod (gang admission).
            wait_plugins: List[str] = []
            wait_timeout = self.config.permit_timeout_s
            for pl in self.profile.permit:
                st, timeout = pl.permit(state, pod, best)
                if st.code == WAIT:
                    wait_plugins.append(pl.name)
                    wait_timeout = min(wait_timeout, timeout) if timeout > 0 else wait_timeout
                elif not st.ok:
                    self._record_failure(pod, f"{pl.name}: {st.message}")
                    self._abort_after_assume(state, pod, best)
                    return

            # submit can itself raise (executor shut down mid-cycle) — the
            # enclosing except must credit the chips back then too.
            if wait_plugins:
                wp = WaitingPod(pod, best, wait_plugins)
                self.handle.add_waiting_pod(wp)
                self._binder.submit(self._wait_then_bind, state, wp, wait_timeout)
            else:
                self._binder.submit(self._bind, state, pod, best)
        except Exception as e:  # noqa: BLE001 — plugin raised instead of returning Status
            self.handle.remove_waiting_pod(pod.metadata.uid)
            self._record_failure(pod, f"plugin exception: {e}")
            self._abort_after_assume(state, pod, best)
            return

    # -- feasible-node search (parallel + sampled) -------------------------
    def _find_feasible(
        self, state: CycleState, pod: Pod, snapshot: Dict[str, NodeInfo]
    ) -> "tuple[List[NodeInfo], Dict[str, str]]":
        """Run the Filter chain over the snapshot — kube-scheduler's
        findNodesThatFitPod shape: a bounded worker pool over nodes
        (--parallelism=16) and early stop once ``num_to_find`` feasible
        nodes exist (percentageOfNodesToScore). The scan starts at a
        rotating offset so sampling doesn't always favor the same
        alphabetical prefix of the fleet."""
        infos = list(snapshot.values())
        num_to_find = self._num_feasible_to_find(len(infos))
        start = getattr(self, "_scan_offset", 0) % max(len(infos), 1)
        infos = infos[start:] + infos[:start]
        self._scan_offset = (start + 1) % max(len(infos), 1)
        # The pod's nominated node (preemption) is always scanned FIRST:
        # sampling may otherwise early-stop before reaching it, and binding
        # anywhere else wastes the eviction while the nomination keeps the
        # freed chips fenced (kube-scheduler evaluates the nominated node
        # ahead of the list for the same reason).
        nominated = self.handle.nominator.node_for(pod.metadata.uid)
        if nominated is not None:
            infos.sort(key=lambda i: i.name != nominated)

        feasible: List[NodeInfo] = []
        reasons: Dict[str, str] = {}

        def check(info: NodeInfo):
            for pl in self.profile.filter:
                st = pl.filter(state, pod, info)
                if not st.ok:
                    return info, f"{pl.name}: {st.message}"
            return info, None

        if len(infos) < self.config.parallelize_threshold:
            for info in infos:
                if len(feasible) >= num_to_find:
                    break
                info, verdict = check(info)
                (feasible.append(info) if verdict is None
                 else reasons.__setitem__(info.name, verdict))
            return feasible, reasons

        # Parallel: one future per worker SLICE (not per node — 256 futures
        # of submit/set_result overhead cost more than the filters they
        # run), waves so the early-stop check runs between them.
        wave = max(1, self.config.parallelism) * 8
        for i in range(0, len(infos), wave):
            if len(feasible) >= num_to_find:
                break
            for info, verdict in self._parallel_map(infos[i:i + wave], check):
                if verdict is None:
                    if len(feasible) < num_to_find:
                        feasible.append(info)
                else:
                    reasons[info.name] = verdict
        return feasible, reasons

    def _parallel_map(self, items: List, fn) -> List:
        """Map ``fn`` over ``items`` on the cycle pool, one future per
        worker slice; results in input order."""
        workers = max(1, self.config.parallelism)
        per = max(1, (len(items) + workers - 1) // workers)
        slices = [items[j:j + per] for j in range(0, len(items), per)]
        return [
            r
            for chunk in self._cycle_pool.map(
                lambda sl: [fn(x) for x in sl], slices)
            for r in chunk
        ]

    def _num_feasible_to_find(self, n_nodes: int) -> int:
        """kube-scheduler's numFeasibleNodesToFind: all nodes below the
        floor; above it, an adaptive percentage (50 - nodes/125, min 5) or
        the configured literal percentage."""
        floor = self.config.min_feasible_to_find
        if n_nodes <= floor:
            return n_nodes
        pct = self.config.percentage_of_nodes_to_score
        if pct <= 0:
            pct = max(5, int(50 - n_nodes / 125))
        return max(floor, n_nodes * pct // 100)

    def _select_node(self, state: CycleState, pod: Pod, feasible: List[NodeInfo]) -> str:
        # A preemption nomination wins outright when still feasible: the
        # victims were evicted on THIS node for THIS pod, so landing anywhere
        # else wastes the eviction (kube-scheduler checks the nominated node
        # before the full list for the same reason).
        nominated = self.handle.nominator.node_for(pod.metadata.uid)
        if nominated is not None and any(i.name == nominated for i in feasible):
            return nominated
        if len(feasible) == 1 or not self.profile.score:
            return sorted(info.name for info in feasible)[0]
        totals: Dict[str, float] = {info.name: 0.0 for info in feasible}
        parallel = len(feasible) >= self.config.parallelize_threshold
        for pl in self.profile.score:
            if parallel:
                vals = self._parallel_map(
                    feasible, lambda info: pl.score(state, pod, info.name))
                scores = {
                    info.name: (val if st.ok else 0.0)
                    for info, (val, st) in zip(feasible, vals)
                }
            else:
                scores = {}
                for info in feasible:
                    val, st = pl.score(state, pod, info.name)
                    scores[info.name] = val if st.ok else 0.0
            pl.normalize_scores(state, pod, scores)
            for name, val in scores.items():
                totals[name] += pl.weight * val
        # Deterministic tie-break by name (upstream randomizes; determinism
        # makes hermetic tests exact).
        return max(sorted(totals), key=lambda n: totals[n])

    # -- binding (async) ---------------------------------------------------
    def _wait_then_bind(self, state: CycleState, wp: WaitingPod, timeout: float) -> None:
        st = wp.wait(timeout)
        self.handle.remove_waiting_pod(wp.uid)
        if not st.ok:
            self._record_failure(wp.pod, st.message)
            self._abort_after_assume(state, wp.pod, wp.node_name)
            return
        self._bind(state, wp.pod, wp.node_name)

    def _bind(self, state: CycleState, pod: Pod, node_name: str) -> None:
        t_bind = self._clock.monotonic()
        try:
            self.descriptor.bind_pod(pod.metadata.name, pod.metadata.namespace, node_name)
        except Exception as e:  # noqa: BLE001
            self._record_failure(pod, f"bind failed: {e}")
            self._abort_after_assume(state, pod, node_name)
            return
        self.cache.finish_binding(pod)
        self.handle.nominator.clear(pod.metadata.uid)
        self.queue.done(pod)
        self._m_attempts.inc(result="scheduled")
        if self._tracer is not None:
            self._tracer.record("sched_bind", t_bind,
                                self._clock.monotonic(), lane="sched",
                                rid=pod.metadata.name, node=node_name)
        start = state.read("cycle_start")
        if start is not None:
            dt = self._clock.monotonic() - start
            self._m_e2e.observe(dt)
            self._m_e2e_class[pod_class(pod)].observe(dt)
        with self._fail_mu:
            self.failure_reasons.pop(pod.metadata.key, None)
        for pl in self.profile.post_bind:
            try:
                pl.post_bind(state, pod, node_name)
            except Exception:  # noqa: BLE001
                log.exception("post_bind %s failed for %s", pl.name, pod.metadata.key)

    # -- failure path ------------------------------------------------------
    def _abort_after_assume(self, state: CycleState, pod: Pod, node_name: str) -> None:
        # Every terminal failure after node selection lands here (reserve/
        # permit rejection, plugin exception, permit timeout, bind failure),
        # so the attempts counter can't under-report a retry storm.
        self._m_attempts.inc(result="error")
        for pl in self.profile.reserve:
            try:
                pl.unreserve(state, pod, node_name)
            except Exception:  # noqa: BLE001
                log.exception("unreserve %s failed", pl.name)
        self.cache.forget(pod)
        self.queue.add_unschedulable(pod)

    def _record_failure(self, pod: Pod, reason: str) -> None:
        with self._fail_mu:
            self.failure_reasons[pod.metadata.key] = reason
        log.info("cannot schedule %s: %s", pod.metadata.key, reason)
