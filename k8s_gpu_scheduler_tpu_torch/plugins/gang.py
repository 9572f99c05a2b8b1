"""Gang scheduling — all-or-nothing admission with ICI-aware placement
(copy of the JAX package's ``plugins/gang.py``).

- Pods opt in with the ``tpu.sched/pod-group`` label naming a ``PodGroup``
  object (min_member, topology, schedule_timeout_s).
- **Permit** parks each gang pod as a WaitingPod; when waiting+bound members
  reach ``min_member``, every parked peer is allowed and the gang binds as a
  unit. A timeout (or any member's failure) rejects every parked peer, whose
  cycles then unreserve — chips never leak to a half-placed gang.
- **Filter/Score** steer members onto hosts of ONE slice (same slice-group
  label) with minimal added ICI torus diameter, using the worker-index label
  and the slice shape from ``host_coordinates`` (``api/topology.py``).
- **Multislice**: when NO single slice group can host ``min_member``
  hosts, the gang may span groups; Score still packs members into as few
  groups as possible, and PostBind also injects TPU_SLICE_ID /
  TPU_NUM_SLICES / TPU_SLICE_HOSTNAMES. The spanning decision is
  re-evaluated while the gang is still confined to one group, and sticky
  once it actually spans."""
from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from ..api.objects import (
    LABEL_NODEPOOL,
    LABEL_SLICE_GROUP,
    LABEL_WORKER_INDEX,
    Pod,
    PodGroup,
)
from ..api.topology import SliceTopology, ici_hop_distance
from ..sched.cache import NodeInfo
from ..sched.framework import (
    CycleState,
    FilterPlugin,
    MAX_NODE_SCORE,
    PermitPlugin,
    PostBindPlugin,
    PreFilterPlugin,
    ReservePlugin,
    ScorePlugin,
    Status,
)
from .tpu import ENV_WORKER_HOSTNAMES, ENV_WORKER_ID

log = logging.getLogger(__name__)


def slice_group_of(info: NodeInfo) -> str:
    labels = info.node.metadata.labels
    return labels.get(LABEL_SLICE_GROUP) or labels.get(LABEL_NODEPOOL) or ""


def worker_index_of(info: NodeInfo) -> int:
    try:
        return int(info.node.metadata.labels.get(LABEL_WORKER_INDEX, "0"))
    except ValueError:
        return 0


class GangPlugin(
    PreFilterPlugin, FilterPlugin, ScorePlugin, ReservePlugin, PermitPlugin, PostBindPlugin
):
    name = "Gang"
    weight = 1.0

    def __init__(self, handle) -> None:
        self.handle = handle
        self._mu = threading.Lock()
        # group key -> {pod uid -> node name}, reserved-but-not-yet-confirmed
        # AND bound members (pruned when the pod or group is deleted).
        self._assignments: Dict[str, Dict[str, str]] = {}
        # Gangs allowed to span slice groups (no single group fits them) —
        # see pre_filter. Pruned with the assignments.
        self._multislice: set = set()
        # Prune bookkeeping when gang members disappear, so a re-created
        # gang under the same name starts from a clean count.
        self.handle.factory.informer("Pod").add_event_handler(
            on_delete=self._on_pod_delete
        )

    def _on_pod_delete(self, pod: Pod) -> None:
        name = pod.pod_group()
        if not name:
            return
        key = f"{pod.metadata.namespace}/{name}"
        with self._mu:
            members = self._assignments.get(key, {})
            members.pop(pod.metadata.uid, None)
            if not members:
                self._assignments.pop(key, None)
                self._multislice.discard(key)

    # -- group lookup ------------------------------------------------------
    def _group_of(self, pod: Pod) -> Optional[PodGroup]:
        name = pod.pod_group()
        if not name:
            return None
        try:
            return self.handle.descriptor.server.get(
                "PodGroup", name, pod.metadata.namespace
            )
        except Exception:  # noqa: BLE001 — NotFound
            return None

    # -- PreFilter ---------------------------------------------------------
    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        name = pod.pod_group()
        if not name:
            return Status.success()
        group = self._group_of(pod)
        if group is None:
            return Status.unschedulable(f"pod group {name!r} not found")
        state.write("gang.group", group)
        # Early total-capacity check so a gang that can never fit doesn't
        # assume chips pod by pod and thrash the cluster.
        chips = pod.spec.tpu_chips()
        if chips > 0:
            # ONE snapshot pass serves the capacity check AND the
            # multislice decision (at 1024 nodes, repeated O(nodes) scans
            # per gang-member cycle were the mixed-load p99 tail).
            snap = self._cycle_infos(state)
            free_hosts = sum(
                1 for info in snap.values() if info.free_tpu >= chips)
            key = self._key(group)
            with self._mu:
                already = len(self._assignments.get(key, {}))
            if free_hosts + already < group.min_member:
                return Status.unschedulable(
                    f"gang {name}: {free_hosts} candidate hosts + {already} "
                    f"reserved < min_member {group.min_member}"
                )
            self._update_multislice(group, chips, snap)
        return Status.success()

    def _cycle_infos(self, state: CycleState) -> Dict[str, NodeInfo]:
        """The node snapshot, taken ONCE per scheduling cycle (CycleState
        memo): snapshot() walks every node under the cache lock, and the
        gang plugin needs it from PreFilter, Filter, and per-node Score."""
        infos = state.read("gang.cycle_infos")
        if infos is None:
            infos = self.handle.cache.snapshot()
            state.write("gang.cycle_infos", infos)
        return infos

    def _update_multislice(self, group: PodGroup, chips: int,
                           snap: Dict[str, NodeInfo]) -> None:
        """Decide (or re-decide) whether this gang may span slice groups:
        spanning turns on when NO single group can host min_member members,
        and heals back to single-slice only while the gang is still
        confined to at most one group — once members actually sit in two
        groups, flipping the flag would strand the rest at Filter."""
        key = self._key(group)
        with self._mu:
            assigned_nodes = set(
                self._assignments.get(key, {}).values())
            flagged = key in self._multislice
        spanning = len(self._slice_groups_of_nodes(assigned_nodes, snap)) > 1
        if flagged and spanning:
            return
        feasible = self._single_slice_feasible(group, chips, assigned_nodes,
                                               snap)
        with self._mu:
            if feasible:
                self._multislice.discard(key)
            else:
                self._multislice.add(key)

    def _single_slice_feasible(self, group: PodGroup, chips: int,
                               assigned_nodes: set,
                               snap: Dict[str, NodeInfo]) -> bool:
        """Can ANY one slice group provide min_member hosts (counting the
        gang's own reserved hosts as available in their group)?"""
        per_group: Dict[str, int] = {}
        for info in snap.values():
            g = slice_group_of(info)
            if info.name in assigned_nodes or info.free_tpu >= chips:
                per_group[g] = per_group.get(g, 0) + 1
        return any(n >= group.min_member for n in per_group.values())

    def _is_multislice(self, group: PodGroup) -> bool:
        with self._mu:
            return self._key(group) in self._multislice

    @staticmethod
    def _key(group: PodGroup) -> str:
        return group.metadata.key

    # -- Filter ------------------------------------------------------------
    def filter(self, state: CycleState, pod: Pod, info: NodeInfo) -> Status:
        group: Optional[PodGroup] = state.read("gang.group")
        if group is None:
            return Status.success()
        with self._mu:
            assigned = dict(self._assignments.get(self._key(group), {}))
        # One gang member per host — a multi-host JAX job runs exactly one
        # worker process per TPU VM.
        if info.name in assigned.values():
            return Status.unschedulable("host already holds a gang peer")
        if group.topology:
            topo = info.slice_topology()
            if topo is None:
                return Status.unschedulable("node missing TPU topology labels")
            try:
                want = SliceTopology.parse(topo.gen, group.topology)
            except ValueError as e:
                # PodGroup.topology is user data — a malformed value must be
                # a terminal verdict, not a retry-storm exception.
                return Status.unschedulable(f"bad gang topology: {e}")
            if topo.dims != want.dims:
                return Status.unschedulable(
                    f"slice shape {topo.dims} != gang topology {want.dims}"
                )
        # All members ride one slice's ICI: once any member is reserved, the
        # rest must share its slice group — unless the gang is in
        # multislice mode (no single group fits it; dp spans groups over
        # DCN, Score still packs).
        if assigned and not self._is_multislice(group):
            peer_groups = state.read("gang.peer_slice_groups")
            if peer_groups is None:
                peer_groups = self._slice_groups_of_nodes(
                    set(assigned.values()), self._cycle_infos(state))
                state.write("gang.peer_slice_groups", peer_groups)
            mine = slice_group_of(info)
            if peer_groups and mine not in peer_groups:
                return Status.unschedulable(
                    f"slice group {mine!r} differs from gang's {sorted(peer_groups)}"
                )
        return Status.success()

    def _slice_groups_of_nodes(self, node_names,
                               snap: Dict[str, NodeInfo]) -> set:
        """Slice groups of the named nodes — O(members) dict lookups, not a
        fleet scan (the snapshot is name-keyed; snap is REQUIRED so no
        caller can silently regress to one cache-lock snapshot per call,
        the 1024-node p99 tail)."""
        groups = set()
        for name in node_names:
            info = snap.get(name)
            if info is not None:
                g = slice_group_of(info)
                if g:
                    groups.add(g)
        return groups

    # -- Score -------------------------------------------------------------
    def score(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[float, Status]:
        group: Optional[PodGroup] = state.read("gang.group")
        if group is None:
            return 0.0, Status.success()
        info: Optional[NodeInfo] = state.read(f"tpu.nodeinfo/{node_name}")
        if info is None:
            return 0.0, Status.success()
        topo = info.slice_topology()
        if topo is None:
            return 0.0, Status.success()
        with self._mu:
            assigned = dict(self._assignments.get(self._key(group), {}))
        if not assigned:
            # First member: prefer low worker indices so gangs pack from the
            # slice origin and leave contiguous room for the next gang —
            # but ONLY in a slice group that can actually host min_member
            # members (a first member landing in a too-small group strands
            # the gang there until the Permit timeout collapses it, then
            # the retry can pick the same group forever).
            base = float(
                MAX_NODE_SCORE - min(worker_index_of(info), MAX_NODE_SCORE))
            if not self._group_fits(state, pod, group, slice_group_of(info)):
                base /= 4.0
            return base, Status.success()
        # Later members: minimize added ICI hops to the reserved peers.
        # Distances are measured on the HOST grid (host_grid units), not chip
        # dims — wraparound shortcuts exist at host granularity too. In
        # multislice mode only IN-GROUP peers have meaningful ICI distance;
        # a node opening a NEW slice group scores at half scale (every
        # extra group is an extra DCN edge — pack first, span only when
        # packing is impossible).
        snap = self._cycle_infos(state)
        if self._is_multislice(group):
            mine_group = slice_group_of(info)
            in_group = {
                uid: node for uid, node in assigned.items()
                if (slice_group_of(snap[node]) if node in snap else "")
                == mine_group
            }
            if not in_group:
                base = float(
                    MAX_NODE_SCORE - min(worker_index_of(info), MAX_NODE_SCORE))
                return base / 2.0, Status.success()
            assigned = in_group      # in-group peers: full-scale ICI scoring
        try:
            coords, grid = self._host_coords(topo)
        except ValueError:
            return 0.0, Status.success()
        peers = self._peer_indices(assigned, snap)
        mine = worker_index_of(info)
        if mine >= len(coords) or any(p >= len(coords) for p in peers):
            return 0.0, Status.success()
        wrap = topo.has_wraparound
        added = sum(
            ici_hop_distance(coords[mine], coords[p], grid, wrap=wrap)
            for p in peers
        )
        worst = sum(grid) * max(len(peers), 1)
        score = max(0.0, MAX_NODE_SCORE * (1.0 - added / max(worst, 1)))
        return score, Status.success()

    def _group_fits(self, state: CycleState, pod: Pod, group: PodGroup,
                    slice_group: str) -> bool:
        """Can ``slice_group`` host min_member members? Candidate counts
        are computed once per cycle (CycleState memo) — Score runs per
        node."""
        sizes = state.read("gang.group_candidates")
        if sizes is None:
            chips = pod.spec.tpu_chips()
            sizes = {}
            for info in self._cycle_infos(state).values():
                if info.free_tpu >= chips:
                    g = slice_group_of(info)
                    sizes[g] = sizes.get(g, 0) + 1
            state.write("gang.group_candidates", sizes)
        return sizes.get(slice_group, 0) >= group.min_member

    @staticmethod
    def _host_coords(topo: SliceTopology):
        from ..api.topology import host_coordinates, host_grid

        return host_coordinates(topo.dims, topo.gen), host_grid(topo.dims, topo.gen)

    def _peer_indices(self, assigned: Dict[str, str],
                      snap: Dict[str, NodeInfo]) -> List[int]:
        """Worker indices of the reserved peers — O(members) lookups (this
        runs once per SCORED NODE; a fleet scan here was part of the
        1024-node mixed-load p99 tail)."""
        out = []
        for node in assigned.values():
            info = snap.get(node)
            if info is not None:
                out.append(worker_index_of(info))
        return out

    # -- Reserve -----------------------------------------------------------
    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        group: Optional[PodGroup] = state.read("gang.group")
        if group is None:
            return Status.success()
        with self._mu:
            members = self._assignments.setdefault(self._key(group), {})
            members[pod.metadata.uid] = node_name
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        group: Optional[PodGroup] = state.read("gang.group")
        if group is None:
            return
        key = self._key(group)
        with self._mu:
            members = self._assignments.get(key, {})
            members.pop(pod.metadata.uid, None)
            if not members:
                self._assignments.pop(key, None)
        # All-or-nothing: one member's failure collapses the whole gang —
        # reject every parked peer so their cycles unreserve too.
        self._reject_gang(key, f"gang peer {pod.metadata.name} failed")

    def _reject_gang(self, group_key: str, reason: str) -> None:
        def maybe_reject(wp) -> None:
            g = wp.pod.pod_group()
            if g and f"{wp.pod.metadata.namespace}/{g}" == group_key:
                wp.reject(reason)

        self.handle.iterate_waiting_pods(maybe_reject)
        # Post-quorum failure window: peers that were already ALLOWED and
        # bound are no longer waiting, but a gang with a missing worker
        # deadlocks the distributed runtime's init. Evict members that are bound yet
        # still Pending (never started) so the owner recreates them and the
        # gang reschedules as a unit; Running members mean the gang
        # previously succeeded and must not be touched.
        ns, name = group_key.split("/", 1)
        try:
            pods = self.handle.factory.informer("Pod").list()
            group = self.handle.descriptor.server.get("PodGroup", name, ns)
        except Exception:  # noqa: BLE001 — informer not started / group gone
            return
        bound = [
            p for p in pods
            if p.metadata.namespace == ns and p.pod_group() == name
            and p.spec.node_name and p.status.phase not in ("Succeeded", "Failed")
        ]
        if len(bound) >= group.min_member:
            # The gang is still viable (a straggler beyond min_member
            # failed) — leave the quorum alone.
            return
        for p in pods:
            if (
                p.metadata.namespace == ns
                and p.pod_group() == name
                and p.spec.node_name
                and p.status.phase == "Pending"
            ):
                if not p.metadata.owner_references:
                    # A bare pod has no controller to recreate it — deleting
                    # it would be permanent, worse than the deadlock we're
                    # clearing. Leave it; the operator owns its lifecycle.
                    log.warning(
                        "gang %s collapsed (%s): NOT evicting bare member %s "
                        "(no ownerReferences)", group_key, reason,
                        p.metadata.key,
                    )
                    continue
                log.warning(
                    "gang %s collapsed (%s): evicting bound member %s",
                    group_key, reason, p.metadata.key,
                )
                try:
                    self.handle.descriptor.delete_pod(
                        p.metadata.name, p.metadata.namespace
                    )
                except Exception:  # noqa: BLE001 — already gone
                    pass

    # -- Permit ------------------------------------------------------------
    def permit(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[Status, float]:
        group: Optional[PodGroup] = state.read("gang.group")
        if group is None:
            return Status.success(), 0.0
        key = self._key(group)
        # Members already through Reserve (this pod included).
        with self._mu:
            reserved = len(self._assignments.get(key, {}))
        if reserved >= group.min_member:
            # Quorum: release every parked peer, proceed ourselves.
            def allow(wp) -> None:
                g = wp.pod.pod_group()
                if g and f"{wp.pod.metadata.namespace}/{g}" == key:
                    wp.allow(self.name)

            self.handle.iterate_waiting_pods(allow)
            log.info("gang %s reached quorum (%d/%d) — admitting",
                     key, reserved, group.min_member)
            return Status.success(), 0.0
        return Status.wait(
            f"gang {key}: {reserved}/{group.min_member} members reserved"
        ), group.schedule_timeout_s

    # -- PostBind ----------------------------------------------------------
    def post_bind(self, state: CycleState, pod: Pod, node_name: str) -> None:
        """Write the distributed-runtime env: this worker's id and every
        member's ADDRESS — what the distributed runtime's rendezvous needs
        (coordinator = worker 0). Overrides the single-host values the TPU
        plugin wrote (profile order puts Gang after TPU).

        Addresses are pod-reachable, not node names: a pod doesn't listen on
        its node's address without hostNetwork, so a gang injected with node
        names places fine and then hangs at rendezvous. Per member: stable pod DNS
        ``<hostname>.<subdomain>.<ns>.svc`` (StatefulSet pods always carry
        hostname+subdomain — deploy/workloads/llama-gang.yaml's headless
        Service provides the records), else the node name (correct only for
        hostNetwork pods, which is what plain-pod gangs must use — there is
        no stable pod address before the pod starts). Deliberately NO pod-IP
        fallback: IPs are assigned after binding, so early members' PostBind
        would see no IPs and late members' would — each member would inject
        a DIFFERENT list (different coordinator!) and the rendezvous hangs.
        Both remaining inputs (pod spec fields, node assignment) are fixed
        before any PostBind runs, so every member derives the identical
        list. The reference never faces this class of bug: its injected
        env, CUDA_VISIBLE_DEVICES, is node-local (gpu_plugins.go:910-920)."""
        group: Optional[PodGroup] = state.read("gang.group")
        if group is None:
            return
        with self._mu:
            assigned = dict(self._assignments.get(self._key(group), {}))
        if not assigned:
            return
        # Deterministic worker ids: sort members SLICE-GROUP-major, then by
        # their host's worker-index label (falling back to node name), so
        # every member derives the same order independently AND a
        # multislice gang's ids are contiguous per slice — the slice-major
        # device order multislice_mesh (parallel/mesh.py) expects, putting
        # the outer dp axis across slices. Single-slice gangs sort exactly
        # as before (one group).
        infos = self.handle.cache.snapshot()        # already name-keyed

        def member_key(kv):
            node = kv[1]
            info = infos.get(node)
            return (slice_group_of(info) if info is not None else "",
                    worker_index_of(info) if info is not None else 0, node)

        members = sorted(assigned.items(), key=member_key)
        ns, gname = pod.metadata.namespace, group.metadata.name
        try:
            peers = self.handle.factory.informer("Pod").list()
        except Exception:  # noqa: BLE001 — informer not started (unit tests)
            peers = []
        by_uid = {p.metadata.uid: p
                  for p in peers
                  if p.metadata.namespace == ns and p.pod_group() == gname}
        by_uid[pod.metadata.uid] = pod
        addresses = [
            self._member_address(by_uid.get(uid), node)
            for uid, node in members
        ]
        my_id = next(
            (i for i, (uid, _) in enumerate(members)
             if uid == pod.metadata.uid), 0)
        data = {
            ENV_WORKER_ID: str(my_id),
            ENV_WORKER_HOSTNAMES: ",".join(addresses),
            "TPU_WORKER_COUNT": str(len(addresses)),
        }
        # Multislice gang: also inject the slice coordinates so the
        # workload can build the slice-major mesh (outer dp over DCN) —
        # pure functions of node labels + assignments, so every member
        # derives the same values.
        node_group = {
            node: (slice_group_of(infos[node]) if node in infos else "")
            for _, node in members
        }
        member_groups = sorted(set(node_group.values()))
        if len(member_groups) > 1:
            my_group = node_group.get(node_name, "")
            slice_hosts = [
                addr for (_, node), addr in zip(members, addresses)
                if node_group[node] == my_group
            ]
            data["TPU_SLICE_ID"] = str(member_groups.index(my_group))
            data["TPU_NUM_SLICES"] = str(len(member_groups))
            data["TPU_SLICE_HOSTNAMES"] = ",".join(slice_hosts)
        self.handle.descriptor.append_to_pod_configmaps(pod, data)

    @staticmethod
    def _member_address(peer: Optional[Pod], node_name: str) -> str:
        """One gang member's reachable address (see post_bind docstring).
        Must be a pure function of pod SPEC fields + node assignment so all
        members derive the same list — never of late-bound status like
        pod IP."""
        if peer is not None and peer.spec.subdomain:
            host = peer.spec.hostname or peer.metadata.name
            return f"{host}.{peer.spec.subdomain}.{peer.metadata.namespace}.svc"
        return node_name
