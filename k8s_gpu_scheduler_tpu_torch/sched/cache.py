"""Cluster cache with chip accounting — the scheduler's world model (copy
of the JAX package's ``sched/cache.py``).

Per-node chip accounting (allocatable − Σ requests of bound and assumed
pods), kube-scheduler's assume/forget state machine, and incremental
per-node snapshots. Chips are the ``google.com/tpu`` extended resource
(``api/objects.py``); slice shape and generation ride on node labels."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api.objects import Node, ObjectMeta, Pod, TPU_RESOURCE
from ..api.topology import SliceTopology, TPUGen


@dataclass
class NodeInfo:
    """Point-in-time view of one node. Snapshots hand these out by value —
    plugins may read freely; mutation happens only inside the Cache."""

    node: Node
    pods: List[Pod] = field(default_factory=list)
    requested_tpu: int = 0
    # Bumped by the Cache on every mutation of this node — lets snapshot()
    # reuse unchanged per-node copies across cycles (kube-scheduler's
    # nodeInfo.Generation / cache.UpdateSnapshot design).
    generation: int = 0
    # ((accelerator, topology), parsed) memo — see slice_topology().
    _topo_cache: Optional[tuple] = field(default=None, repr=False, compare=False)

    @property
    def name(self) -> str:
        return self.node.metadata.name

    @property
    def allocatable_tpu(self) -> int:
        return int(self.node.status.allocatable.get(TPU_RESOURCE, 0))

    @property
    def free_tpu(self) -> int:
        return self.allocatable_tpu - self.requested_tpu

    def slice_topology(self) -> Optional[SliceTopology]:
        # Parsed once per (node object, label pair): Filter + Score call
        # this for every (pod × node) and the labels almost never change —
        # re-parsing the topology string was ~10% of cycle time at 256
        # nodes. Keyed on the label values, so a relabel invalidates.
        acc, topo = self.node.tpu_accelerator(), self.node.tpu_topology()
        if not acc or not topo:
            return None
        cached = self._topo_cache
        if cached is not None and cached[0] == (acc, topo):
            return cached[1]
        try:
            parsed = SliceTopology.parse(TPUGen(acc), topo)
        except ValueError:
            parsed = None
        self._topo_cache = ((acc, topo), parsed)
        return parsed

    def shallow_copy(self) -> "NodeInfo":
        c = NodeInfo(node=self.node, pods=list(self.pods),
                     requested_tpu=self.requested_tpu,
                     generation=self.generation)
        # Carry the topology memo: labels rarely change and the memo is
        # keyed on their values, so a stale carry self-invalidates.
        c._topo_cache = self._topo_cache
        return c


class Cache:
    """Thread-safe node/pod cache with assume semantics.

    Lifecycle of a pod through the cache (kube-scheduler's state machine):
      assume(pod, node)      — Reserve succeeded; chips debited immediately so
                               the next cycle's snapshot sees them taken.
      finish_binding(pod)    — bind API call succeeded; the assumed entry now
                               waits for the watch to confirm.
      forget(pod)            — Reserve/Permit/bind failed; chips credited back.
      add/update/delete_pod  — watch events; a confirmed add replaces the
                               assumed entry.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._nodes: Dict[str, NodeInfo] = {}
        # uid -> (pod, node_name) reserved in-flight
        self._assumed: Dict[str, tuple] = {}
        # Monotonic mutation counter + per-node snapshot copies keyed by the
        # generation they were taken at: snapshot() re-copies only nodes
        # that changed since the last cycle (O(churn), not O(fleet)).
        self._gen = 0
        self._snap: Dict[str, NodeInfo] = {}

    def _touch_locked(self, info: NodeInfo) -> None:
        self._gen += 1
        info.generation = self._gen

    # -- node events -------------------------------------------------------
    def add_node(self, node: Node) -> None:
        with self._mu:
            info = self._nodes.get(node.metadata.name)
            if info is None:
                info = NodeInfo(node=node)
                self._nodes[node.metadata.name] = info
            else:
                info.node = node
            self._touch_locked(info)

    def update_node(self, _old: Optional[Node], new: Node) -> None:
        self.add_node(new)

    def delete_node(self, node: Node) -> None:
        with self._mu:
            self._nodes.pop(node.metadata.name, None)

    # -- pod events (from the watch) --------------------------------------
    #
    # All of these are IDEMPOTENT: adding a pod already accounted is a
    # no-op object refresh, removing one already gone is a no-op. The watch
    # can deliver redundant events (terminal update followed by DELETE, a
    # replayed ADD) and accounting must never double-debit or double-credit.
    def add_pod(self, pod: Pod) -> None:
        if not pod.spec.node_name:
            return
        with self._mu:
            uid = pod.metadata.uid
            assumed = self._assumed.pop(uid, None)
            if assumed is not None:
                a_pod, a_node = assumed
                if a_node != pod.spec.node_name:
                    # bound somewhere else than assumed — move the debit
                    self._remove_locked(a_node, a_pod)
                else:
                    # already debited by assume; just swap the pod object in
                    self._refresh_locked(a_node, pod)
                    return
            self._add_locked(pod.spec.node_name, pod)

    def update_pod(self, old: Optional[Pod], new: Pod) -> None:
        if old is not None and old.spec.node_name and old.spec.node_name != new.spec.node_name:
            self.delete_pod(old)
        if not (old is not None and old.spec.node_name == new.spec.node_name):
            self.add_pod(new)
            return
        with self._mu:
            self._refresh_locked(new.spec.node_name, new)

    def delete_pod(self, pod: Pod) -> None:
        if not pod.spec.node_name:
            return
        with self._mu:
            self._remove_locked(pod.spec.node_name, pod)

    # -- assume / forget ---------------------------------------------------
    def assume(self, pod: Pod, node_name: str) -> None:
        with self._mu:
            prev = self._assumed.get(pod.metadata.uid)
            if prev is not None:
                if prev[1] == node_name:
                    return  # already assumed here — idempotent
                self._remove_locked(prev[1], prev[0])
            self._assumed[pod.metadata.uid] = (pod, node_name)
            self._add_locked(node_name, pod)

    def finish_binding(self, pod: Pod) -> None:
        # No-op beyond bookkeeping: the assumed entry is reconciled when the
        # watch delivers the bound pod (add_pod above).
        pass

    def forget(self, pod: Pod) -> None:
        with self._mu:
            assumed = self._assumed.pop(pod.metadata.uid, None)
            if assumed is None:
                return
            a_pod, a_node = assumed
            self._remove_locked(a_node, a_pod)

    def is_assumed(self, pod: Pod) -> bool:
        with self._mu:
            return pod.metadata.uid in self._assumed

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> Dict[str, NodeInfo]:
        """Copy-on-read view for one scheduling cycle (kube-scheduler's
        Snapshot().NodeInfos(), used by the reference at gpu_plugins.go:798).

        Incremental: per-node copies are reused until that node's
        generation changes (kube's cache.UpdateSnapshot). A cycle holding
        last cycle's dict keeps reading its own consistent copies — the
        cache only ever REPLACES entries here, never mutates them."""
        with self._mu:
            snap = self._snap
            for name, info in self._nodes.items():
                prev = snap.get(name)
                if prev is None or prev.generation != info.generation:
                    snap[name] = info.shallow_copy()
            if len(snap) != len(self._nodes):
                for name in [n for n in snap if n not in self._nodes]:
                    del snap[name]
            return dict(snap)

    def node_names(self) -> List[str]:
        with self._mu:
            return list(self._nodes)

    # -- internals (call with lock held) ----------------------------------
    def _node_info_locked(self, node_name: str) -> NodeInfo:
        info = self._nodes.get(node_name)
        if info is None:
            # Node not (yet) known — placeholder so accounting survives
            # pod-before-node watch ordering; add_node fills in the object.
            info = NodeInfo(node=Node(metadata=ObjectMeta(name=node_name)))
            self._nodes[node_name] = info
        return info

    def _add_locked(self, node_name: str, pod: Pod) -> None:
        info = self._node_info_locked(node_name)
        for i, p in enumerate(info.pods):
            if p.metadata.uid == pod.metadata.uid:
                info.pods[i] = pod  # already accounted — refresh only
                self._touch_locked(info)
                return
        info.pods.append(pod)
        info.requested_tpu += pod.spec.tpu_chips()
        self._touch_locked(info)

    def _remove_locked(self, node_name: str, pod: Pod) -> None:
        info = self._nodes.get(node_name)
        if info is None:
            return
        for i, p in enumerate(info.pods):
            if p.metadata.uid == pod.metadata.uid:
                del info.pods[i]
                info.requested_tpu -= p.spec.tpu_chips()
                self._touch_locked(info)
                return
        # not present — already credited; no-op

    def _refresh_locked(self, node_name: str, pod: Pod) -> None:
        """Swap the stored object WITHOUT touching accounting; ignores pods
        the cache no longer tracks (e.g. an update trailing a terminal
        credit)."""
        info = self._nodes.get(node_name)
        if info is None:
            return
        for i, p in enumerate(info.pods):
            if p.metadata.uid == pod.metadata.uid:
                info.pods[i] = pod
                self._touch_locked(info)
                return
