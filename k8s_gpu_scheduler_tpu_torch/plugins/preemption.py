"""Preemption PostFilter (copy of the JAX package's
``plugins/preemption.py``, kube-scheduler's DefaultPreemption shape
extended for slice topology): an unschedulable high-priority pod may evict
lower-priority pods to make room.

- only pods with strictly LOWER priority are candidates;
- gang members are never victims, nor are pods without a controller owner;
- **topology-aware**: the freed chips must form a *partition* the
  preemptor fits (the TPU plugin's sub-slice carving);
- **dry-run Filter**: before any eviction, the full Filter chain is re-run
  against a hypothetical NodeInfo with the victims removed;
- per node, victims are taken lowest-priority-first; the chosen node
  minimizes (victim count, summed victim priority).

On success the victims are deleted through the API server, the preemptor
is **nominated** to the node (``framework.Nominator``), and the pod is
requeued."""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ..api.objects import Pod
from ..sched.cache import NodeInfo
from ..sched.framework import CycleState, PostFilterPlugin, Status
from ..sched.queue import pod_priority

log = logging.getLogger(__name__)


class PreemptionPlugin(PostFilterPlugin):
    name = "Preemption"

    def __init__(self, handle, filter_plugins: Optional[list] = None,
                 tpu=None) -> None:
        """``filter_plugins``: the profile's Filter chain, re-run against the
        victims-removed NodeInfo (dry run). ``tpu``: the TPUPlugin, borrowed
        for partition carving so victim selection is topology-aware. Both
        optional — without them selection degrades to the node-level
        capacity greedy."""
        self.handle = handle
        self.filter_plugins = filter_plugins or []
        self.tpu = tpu

    # -- PostFilter ----------------------------------------------------------
    def post_filter(self, state: CycleState, pod: Pod,
                    filtered_reasons: Dict[str, str]) -> Status:
        prio = pod_priority(pod)
        if prio <= 0:
            return Status.unschedulable(
                "priority 0 pods never preempt (set tpu.sched/priority)")
        need = pod.spec.tpu_chips()
        if need <= 0:
            return Status.unschedulable("pod requests no TPU chips")

        best: Optional[Tuple[Tuple[int, int], str, List[Pod]]] = None
        for info in self.handle.cache.snapshot().values():
            victims = self._victims_for(state, pod, prio, need, info)
            if victims is None:
                continue
            cost = (len(victims), sum(pod_priority(v) for v in victims))
            if best is None or cost < best[0]:
                best = (cost, info.name, victims)

        if best is None:
            return Status.unschedulable(
                "no node frees enough chips by evicting lower-priority pods")
        _, node_name, victims = best
        for v in victims:
            try:
                self.handle.descriptor.delete_pod(
                    v.metadata.name, v.metadata.namespace)
                log.info("preempted %s (prio %d) on %s for %s (prio %d)",
                         v.metadata.key, pod_priority(v), node_name,
                         pod.metadata.key, prio)
            except Exception as e:  # noqa: BLE001 — victim may be gone already
                log.warning("preemption delete %s failed: %s",
                            v.metadata.key, e)
        # Reserve the hole: Filter subtracts nominated chips for rivals of
        # equal/lower priority, and the preemptor's own next cycle prefers
        # this node (scheduler._select_node).
        self.handle.nominator.nominate(pod, node_name)
        state.write("preemption/node", node_name)
        return Status.success()

    # -- victim selection ------------------------------------------------------
    def _victims_for(self, state: CycleState, pod: Pod, prio: int, need: int,
                     info: NodeInfo) -> Optional[List[Pod]]:
        """Minimal victim list on this node, or None if preemption there
        cannot make the pod schedulable."""
        if info.allocatable_tpu < need:
            # Eviction can never create capacity the node doesn't have.
            return None
        # Effective free capacity mirrors Filter's view: chips held by
        # equal-or-higher-priority nominations are NOT free (evicting
        # residents can still help around them), so a node whose raw
        # free_tpu looks sufficient may genuinely need victims. Without
        # the subtraction such a node is skipped as "capacity was never
        # the problem" and the preemptor starves behind a stuck rival
        # nomination.
        nominated = (self.tpu._nominated_chips(pod, info)
                     if self.tpu is not None else 0)
        free = info.free_tpu - nominated
        if free >= need:
            # Capacity was never the problem on this node — Filter rejected
            # it for a reason eviction cannot fix (selector, NotReady,
            # reshape in flight, gang conflict).
            return None
        candidates = sorted(
            (p for p in info.pods
             if pod_priority(p) < prio
             and not p.pod_group()
             and p.metadata.owner_references),
            key=pod_priority,
        )
        victims = self._partition_victims(info, need, candidates, free,
                                          nominated)
        if victims is None:
            return None
        if not self._dry_run_filter(state, pod, info, victims):
            return None
        return victims

    def _partition_victims(self, info: NodeInfo, need: int,
                           candidates: List[Pod], node_free: int,
                           nominated: int = 0) -> Optional[List[Pod]]:
        """Pick victims so the freed chips form a usable hole.

        With the TPU plugin available the node's board is carved into its
        current partitions and victims are taken within the single partition
        that frees >= ``need`` chips at minimal cost. ``nominated`` chips
        (reserved for equal/higher-priority nominees) aren't
        partition-attributed, so each candidate partition plans for the
        nominee too: it consumes raw free space in the OTHER partitions
        first; the unabsorbed remainder must either fit in this partition
        beyond ``need`` (evicting further residents here) or be made by
        evicting lower-priority residents elsewhere on the board. Debiting
        every partition by the full nominated count instead would make
        eviction look futile exactly when a sibling partition can host the
        nominee — the starvation case the nomination adjustment exists
        for. The dry-run Filter is the final arbiter either way. Without
        the TPU plugin (or topology labels), falls back to node-level
        greedy over ``node_free`` (nomination-adjusted free chips)."""
        parts = self._partitions_of(info)
        if not parts:
            return self._greedy_victims(node_free, need, candidates)

        evictable = {p.metadata.uid for p in candidates}
        # Attribute every chip-consuming resident to a partition — the ONE
        # attribution rule shared with Score (tpu.residents_by_partition),
        # ConfigMap fetches memoized inside.
        by_part = self.tpu.residents_by_partition(info, parts)
        raw_free = {
            p.key: len(p.chip_ids) - sum(
                r.spec.tpu_chips() for r in by_part[p.key])
            for p in parts
        }

        def evict_within(part, amount) -> Optional[List[Pod]]:
            """Cheapest victims inside ``part`` so its free chips reach
            ``amount``; None if its occupants can't free that much."""
            free = raw_free[part.key]
            out: List[Pod] = []
            for r in sorted(by_part[part.key], key=pod_priority):
                if free >= amount:
                    break
                if r.metadata.uid not in evictable:
                    continue
                out.append(r)
                free += r.spec.tpu_chips()
            return out if free >= amount else None

        def cost(victims: List[Pod]) -> Tuple[int, int]:
            return (len(victims), sum(pod_priority(v) for v in victims))

        best_cost: Optional[Tuple[int, int]] = None
        best_victims: Optional[List[Pod]] = None
        for part in parts:
            if len(part.chip_ids) < need:
                continue  # this hole can never fit the preemptor
            # The nominee needs its chips in ONE partition too — planning
            # it as divisible (summed scattered free chips) would evict
            # workloads for a placement that can never happen. With
            # multiple nominees this single-partition requirement is
            # conservative: it declines some feasible preemptions, never
            # the reverse. Options per candidate partition:
            options: List[List[Pod]] = []
            if nominated <= 0:
                v = evict_within(part, need)
                if v is not None:
                    options.append(v)
            else:
                # (a) nominee shares this partition with the preemptor;
                if len(part.chip_ids) >= need + nominated:
                    v = evict_within(part, need + nominated)
                    if v is not None:
                        options.append(v)
                # (b) nominee lands whole in another partition q (evicting
                #     there too if q's occupants allow it).
                base = evict_within(part, need)
                if base is not None:
                    for q in parts:
                        if q.key == part.key or len(q.chip_ids) < nominated:
                            continue
                        vq = evict_within(q, nominated)
                        if vq is not None:
                            options.append(base + vq)
            for victims in options:
                c = cost(victims)
                if best_cost is None or c < best_cost:
                    best_cost, best_victims = c, victims
        return best_victims

    def _partitions_of(self, info: NodeInfo):
        if self.tpu is None:
            return []
        topo = info.slice_topology()
        if topo is None:
            return []
        try:
            inv = self.tpu._inventory(info.name)
            return self.tpu._partitions(info, topo, inv)
        except Exception:  # noqa: BLE001 — degrade to node-level greedy
            return []

    @staticmethod
    def _greedy_victims(free: int, need: int,
                        candidates: List[Pod]) -> Optional[List[Pod]]:
        if free >= need:
            return None  # capacity was never the problem here
        victims: List[Pod] = []
        for v in candidates:
            victims.append(v)
            free += v.spec.tpu_chips()
            if free >= need:
                return victims
        return None

    # -- dry run ---------------------------------------------------------------
    def _dry_run_filter(self, state: CycleState, pod: Pod, info: NodeInfo,
                        victims: List[Pod]) -> bool:
        """Re-run the Filter chain against this node with the victims gone —
        kube's DefaultPreemption contract. Catches every non-capacity
        rejection (NotReady, selector, reshape 'applying', gang slice-group)
        without parsing reason strings. No chain wired → legacy checks."""
        if not self.filter_plugins:
            node = info.node
            for k, v in pod.spec.node_selector.items():
                if node.metadata.labels.get(k) != v:
                    return False
            return "Ready" in node.status.conditions
        gone = {v.metadata.uid for v in victims}
        hypo = info.shallow_copy()
        hypo.pods = [p for p in hypo.pods if p.metadata.uid not in gone]
        hypo.requested_tpu -= sum(v.spec.tpu_chips() for v in victims)
        shadow = state.clone()
        for pl in self.filter_plugins:
            try:
                if not pl.filter(shadow, pod, hypo).ok:
                    return False
            except Exception:  # noqa: BLE001 — a crashing filter is a veto
                return False
        return True
