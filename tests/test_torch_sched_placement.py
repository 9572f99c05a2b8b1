"""Placement parity: three seeded clusters, each scheduled by both
packages' ``cmd.scheduler.build_scheduler`` (the whole control plane:
informers over the in-memory APIServer, the TPU, Gang and Preemption
plugins, bind and PostBind) with the same in-memory registry and test
doubles for the recommender and Prometheus clients.

- ``demo``: ``demo_cluster(8)``, as ``--demo 8`` boots it.
- ``mixed64``: 64 nodes in slice groups of 4, a 2-node hot zone filled
  by low-priority fillers that two preemptors then evict, a node left
  mid-reshape, gangs (one on a fixed topology, one with pod DNS names,
  one too large for a slice group), singletons with SLOs, partitioned
  hosts and a node that is not Ready.
- ``sampled128``: 128 nodes, above ``min_feasible_to_find`` (100), so
  the feasible-node search samples from its rotating scan offset and
  Filter and Score fan out on the pool.

Pods arrive in waves, in a fixed order (the scan offset rotates once a
cycle, so the two packages place alike only on the same cycles in the
same order); each wave is drained before the next. Every pod's node,
every ConfigMap's data, every preemption (preemptor, node, victims) and
every PodGroup's phase must be equal, except ``TPU_NEIGHBORS``: PostBind
reads the residents of the pod's partition on a binder thread while the
cycle thread assumes later pods, so which later pods it names depends on
timing in the JAX package itself. For it, each package is held to the
invariant it keeps: it names only workloads that share the pod's
partition in the final state, and every workload placed on that
partition before the pod. Each run is also held to the scheduler's own
invariants: zero-sum chip accounting per node, the cache agreeing with
the API server, every gang on one slice group unless the gang plugin put
it in multislice mode (no group could host it when it was placed),
nothing on the reshaping node."""
import time
from unittest import mock

import numpy as np
import pytest

from test_torch_sched_plugins import (
    ROOTS, FakeProm, FakeRecommender, MemRegistry, mod,
)

ENV_NEIGHBORS = "TPU_NEIGHBORS"


CONF = {"llama": {"1P_V5E": 30.0, "2P_V5E": 61.0, "4P_V5E": 95.0,
                  "1P_V5P": 70.0},
        "bert": {"1P_V5E": 12.0, "2P_V5E": 25.0, "4P_V5E": 26.0,
                 "1P_V5P": 40.0}}
INTF = {"llama": {"bert": 4.0}, "bert": {"llama": 9.5, "bert": 2.0}}


# -- the clusters (data only: either package builds its objects from it) ---

def node(name, i, gen="tpu-v5-lite-podslice", topo="2x4", chips=8,
         group=None, hot=False, annotations=None, ready=True):
    labels = {"cloud.google.com/gke-tpu-accelerator": gen,
              "cloud.google.com/gke-tpu-topology": topo}
    if group is not None:
        labels["tpu.sched/slice-group"] = group
        labels["tpu.sched/worker-index"] = str(i)
    if hot:
        labels["zone"] = "hot"
    return dict(name=name, labels=labels, annotations=annotations or {},
                chips=chips, ready=ready)


def pod(name, chips, env=None, selector=None, priority=None, group=None,
        owner=None, dns=False):
    return dict(name=name, chips=chips, env=env or {}, selector=selector,
                priority=priority, group=group, owner=owner, dns=dns)


def inventory(side, nodes, rng, skip=()):
    """Each node's published inventory (utilization and per-chip duty and
    HBM), some left unpublished so Score falls back to Prometheus."""
    inv = mod(side, "registry.inventory")
    data = {}
    for i, n in enumerate(nodes):
        util = float(rng.random())
        duties = [float(rng.random()) for _ in range(n["chips"])]
        used = [int(rng.integers(0, 4 << 30)) for _ in range(n["chips"])]
        if n["name"] in skip:
            continue
        data[inv.node_key(n["name"])] = inv.NodeInventory(
            node_name=n["name"], utilization=util,
            accelerator=n["labels"]["cloud.google.com/gke-tpu-accelerator"],
            topology=n["labels"]["cloud.google.com/gke-tpu-topology"],
            chips=[inv.ChipInfo(device_id=c, duty_cycle=duties[c],
                                hbm_used_bytes=used[c],
                                hbm_total_bytes=16 << 30)
                   for c in range(n["chips"])]).to_json()
    return data


def mixed64(seed=0):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(64):
        ann = {}
        if i % 8 == 3:
            ann["tpu.sched/slice.config"] = "2x2"     # two 4-chip partitions
        if i % 8 == 5:
            ann["tpu.sched/slice.config"] = "1x2"     # four 2-chip ones
        if i == 2:
            ann["tpu.sched/slice.reshape-state"] = "applying"
        # The reshaping and the NotReady node share the hot zone's slice
        # group, which the fillers fill: no gang counts on that group's
        # hosts (the gang plugin counts hosts by free chips alone).
        nodes.append(node(f"v5e-{i:02d}", i % 4, group=f"sg-{i // 4:02d}",
                          hot=i < 2, annotations=ann, ready=i != 3))
    fillers = [pod(f"filler-{i}", 8, selector={"zone": "hot"},
                   owner="StatefulSet/fillers") for i in range(2)]
    storm = []
    gangs = []
    for i in range(56):
        env = {}
        kind = ("llama", "bert", "job")[i % 3]
        if kind != "job" and i % 2:
            env["SLO"] = str(float(rng.choice([10.0, 20.0, 50.0, 90.0])))
        storm.append(pod(f"{kind}-{i}", (1, 2, 4, 8, 0)[i % 5], env=env,
                         owner="Job/storm" if i % 4 else None))
        if i % 12 == 5:
            g = len(gangs)
            size = 6 if g == 3 else 4
            gangs.append(dict(name=f"gang-{g}", min_member=size,
                              topology="2x4" if g == 1 else "",
                              timeout=20.0))
            storm.extend(pod(f"gang-{g}-{m}", 8, group=f"gang-{g}",
                             owner="StatefulSet/gang", dns=g == 2)
                         for m in range(size))
    preemptors = [pod(f"preemptor-{i}", 8, selector={"zone": "hot"},
                      priority=100) for i in range(2)]
    return dict(nodes=nodes, groups=gangs, waves=[fillers, storm, preemptors],
                skip={"v5e-07", "v5e-19", "v5e-40"}, reshaping="v5e-02",
                hot={"v5e-00", "v5e-01"}, seed=seed)


def sampled128(seed=1):
    rng = np.random.default_rng(seed)
    nodes = [node(f"n{i:03d}", 0,
                  annotations={"tpu.sched/slice.config": "2x2"}
                  if i % 5 == 0 else {}) for i in range(128)]
    pods = []
    for i in range(90):
        kind = ("llama", "bert")[i % 2]
        env = {"SLO": str(float(rng.choice([15.0, 40.0])))} if i % 3 else {}
        pods.append(pod(f"{kind}-{i}", (1, 2, 4)[i % 3], env=env))
    return dict(nodes=nodes, groups=[], waves=[pods], skip={"n017"},
                reshaping=None, hot=set(), seed=seed)


# -- one package's run ------------------------------------------------------

def build_objects(side, spec):
    o = mod(side, "api.objects")
    out = []
    for n in spec["nodes"]:
        out.append(o.Node(
            metadata=o.ObjectMeta(name=n["name"], uid=f"uid-{n['name']}",
                                  creation_timestamp=1.0,
                                  labels=dict(n["labels"]),
                                  annotations=dict(n["annotations"])),
            status=o.NodeStatus(
                capacity={o.TPU_RESOURCE: n["chips"]},
                allocatable={o.TPU_RESOURCE: n["chips"]},
                addresses=[f"10.1.{len(out) // 250}.{len(out) % 250}"],
                conditions=["Ready"] if n["ready"] else ["NotReady"])))
    return out


def pod_objects(side, p, ts):
    o = mod(side, "api.objects")
    cm = o.ConfigMap(metadata=o.ObjectMeta(
        name=f"cm-{p['name']}", uid=f"uid-cm-{p['name']}",
        creation_timestamp=ts))
    labels = {o.LABEL_POD_GROUP: p["group"]} if p["group"] else {}
    ann = ({"tpu.sched/priority": str(p["priority"])}
           if p["priority"] else {})
    obj = o.Pod(
        metadata=o.ObjectMeta(
            name=p["name"], uid=f"uid-{p['name']}", creation_timestamp=ts,
            labels=labels, annotations=ann,
            owner_references=[p["owner"]] if p["owner"] else []),
        spec=o.PodSpec(
            node_selector=dict(p["selector"] or {}),
            hostname=p["name"] if p["dns"] else "",
            subdomain="gang-svc" if p["dns"] else "",
            containers=[o.Container(
                env=[o.EnvVar(k, v) for k, v in p["env"].items()],
                env_from=[o.ConfigMapRef(f"cm-{p['name']}")],
                resources=o.ResourceRequirements(
                    requests={o.TPU_RESOURCE: p["chips"]}))]))
    return cm, obj


def wait_for(fn, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not fn():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def run(side, spec, registry, demo=False):
    """Schedule ``spec`` (or ``demo_cluster(8)``) with one package; return
    what the comparison reads and what the invariants read."""
    cmd = mod(side, "cmd.scheduler")
    o = mod(side, "api.objects")
    cfg = mod(side, "config").SchedulerConfig(
        backoff_initial_s=0.02, backoff_max_s=0.1, permit_timeout_s=20.0)
    reg = MemRegistry(registry)
    rec = FakeRecommender(CONF, INTF)
    prom = FakeProm({"v5e-07": 10.0, "v5e-19": 95.0, "n017": 50.0})
    if demo:
        server = cmd.demo_cluster(8)
    else:
        server = mod(side, "cluster").APIServer()
        for n in build_objects(side, spec):
            server.create(n)
    patches = [mock.patch.object(mod(side, "registry.client"), "Client",
                                 lambda *a, **k: reg)]
    if side == "jax":
        # The JAX entry point builds its gRPC and Prometheus clients here;
        # the port has neither yet, and takes the doubles on its plugin.
        patches += [
            mock.patch.object(mod(side, "recommender.client"), "Client",
                              lambda *a, **k: rec),
            mock.patch.object(mod(side, "metrics.client"), "PromClient",
                              lambda *a, **k: prom)]
    for p in patches:
        p.start()
    try:
        sched = cmd.build_scheduler(server, cfg, allow_simulated_reshape=True)
    finally:
        for p in patches:
            p.stop()
    tpu = sched.profile.score[0]
    if side == "torch":
        assert tpu.recommender is None and tpu.prom is None
        tpu.recommender, tpu.prom = rec, prom
    assert (tpu.registry, tpu.recommender, tpu.prom) == (reg, rec, prom)
    preempt = sched.profile.post_filter[0]
    preemptions = []
    real = preempt.post_filter

    def post_filter(state, pod, reasons):
        st = real(state, pod, reasons)
        if st.ok:
            preemptions.append((pod.metadata.name,
                                state.read("preemption/node")))
        return st
    preempt.post_filter = post_filter
    # Placement order: the order each pod reached Reserve (the cycle
    # thread's order; binds finish on the binder pool in any order).
    order = []
    real_reserve = tpu.reserve

    def reserve(state, pod, node_name):
        st = real_reserve(state, pod, node_name)
        if st.ok:
            order.append((pod.metadata.name, node_name))
        return st
    tpu.reserve = reserve
    deleted = server.watch("Pod", send_initial=False)
    sched.start()
    try:
        waves = [[]] if demo else spec["waves"]
        ts = 100.0
        for wave in waves:
            for g in (spec or {}).get("groups", ()):
                if any(p["group"] == g["name"] for p in wave):
                    server.create(o.PodGroup(
                        metadata=o.ObjectMeta(name=g["name"],
                                              uid=f"uid-{g['name']}"),
                        min_member=g["min_member"], topology=g["topology"],
                        schedule_timeout_s=g["timeout"]))
            for p in wave:
                ts += 1.0
                cm, obj = pod_objects(side, p, ts)
                server.create(cm)
                server.create(obj)
            names = {p["name"] for p in wave} or {
                p.metadata.name for p in server.list("Pod")}
            wait_for(lambda: all(p.spec.node_name for p in server.list("Pod")
                                 if p.metadata.name in names),
                     f"{side}: wave of {len(names)} pods bound")
    finally:
        sched.stop()
        sched._reshaper.stop()
    events = []
    while True:
        ev = deleted.next(timeout=0.01)
        if ev is None:
            break
        if ev.type == "DELETED":
            events.append(ev.obj.metadata.name)
    deleted.stop()
    pods = {p.metadata.name: p for p in server.list("Pod")}
    cms = {c.metadata.name: dict(c.data) for c in server.list("ConfigMap")}
    groups = {}
    for g in server.list("PodGroup"):
        bound = sum(1 for p in pods.values()
                    if p.pod_group() == g.metadata.name and p.spec.node_name)
        groups[g.metadata.name] = "Scheduled" if bound >= g.min_member \
            else "Pending"
    return dict(
        placements={n: p.spec.node_name for n, p in pods.items()},
        configmaps=cms, victims=sorted(set(events)),
        preemptions=sorted(set(preemptions)), groups=groups,
        order=order,
        registry_neighbors={k: v for k, v in reg.data.items()
                            if k.startswith("neighbors/")},
        multislice=sorted(sched.profile.permit[0]._multislice),
        server=server, sched=sched, pods=pods, tpu=tpu)


# -- the invariants one run keeps ---------------------------------------------

def check_invariants(side, res, spec):
    server, sched, pods = res["server"], res["sched"], res["pods"]
    by_node = {}
    for p in pods.values():
        if p.spec.node_name:
            by_node[p.spec.node_name] = by_node.get(p.spec.node_name, 0) + \
                p.spec.tpu_chips()
    for n in server.list("Node"):
        assert by_node.get(n.metadata.name, 0) <= n.tpu_capacity(), \
            (side, n.metadata.name)
    snap = sched.cache.snapshot()
    drift = [(name, by_node.get(name, 0), info.requested_tpu)
             for name, info in snap.items()
             if by_node.get(name, 0) != info.requested_tpu
             or info.requested_tpu != sum(p.spec.tpu_chips()
                                          for p in info.pods)]
    assert not drift, (side, drift)
    if spec is None:
        return
    if spec["reshaping"]:
        assert not by_node.get(spec["reshaping"]), side
    groups = {}
    for p in pods.values():
        if p.pod_group():
            sg = next(n for n in server.list("Node")
                      if n.metadata.name == p.spec.node_name
                      ).metadata.labels.get("tpu.sched/slice-group")
            groups.setdefault(p.pod_group(), set()).add(sg)
    # A gang spans slice groups only when no single group could host it
    # when it was placed (the gang plugin's multislice mode).
    spanning = {key.split("/", 1)[1] for key in res["multislice"]}
    for g in spec["groups"]:
        assert (len(groups[g["name"]]) > 1) == (g["name"] in spanning), \
            (side, g, groups, spanning)
    # TPU_NEIGHBORS: only workloads that share the pod's partition in the
    # final state, and every one placed there before the pod.
    tpu = res["tpu"]
    placed_at = {name: i for i, (name, _) in enumerate(res["order"])}
    part_of = {}
    for name, p in pods.items():
        data = res["configmaps"].get(f"cm-{name}", {})
        if p.spec.node_name and p.spec.node_name in data:
            part_of[name] = (p.spec.node_name, data[p.spec.node_name])
    for name, where in part_of.items():
        data = res["configmaps"][f"cm-{name}"]
        sharing = {o for o, w in part_of.items() if w == where and o != name}
        named = set(filter(None, data.get(ENV_NEIGHBORS, "").split(",")))
        allowed = {tpu._workload_of(pods[o]) for o in sharing}
        earlier = {tpu._workload_of(pods[o]) for o in sharing
                   if placed_at[o] < placed_at[name]}
        assert earlier <= named <= allowed, (side, name, named, earlier,
                                             allowed)


def without_neighbors(cms):
    return {k: {kk: vv for kk, vv in v.items() if kk != ENV_NEIGHBORS}
            for k, v in cms.items()}


CLUSTERS = {"demo": None, "mixed64": mixed64, "sampled128": sampled128}


@pytest.mark.parametrize("cluster", list(CLUSTERS))
def test_placements_equal(cluster):
    spec = CLUSTERS[cluster]() if CLUSTERS[cluster] else None
    out = {}
    for side in ROOTS:
        registry = {} if spec is None else inventory(
            side, spec["nodes"], np.random.default_rng(spec["seed"]),
            spec["skip"])
        out[side] = res = run(side, spec, registry, demo=spec is None)
        check_invariants(side, res, spec)
        out[side]["registry"] = registry
    j, t = out["jax"], out["torch"]
    assert j["registry"] == t["registry"]        # the same bytes published
    assert j["placements"] == t["placements"]
    assert j["order"] == t["order"]
    assert without_neighbors(j["configmaps"]) == \
        without_neighbors(t["configmaps"])
    assert j["victims"] == t["victims"]
    assert j["preemptions"] == t["preemptions"]
    assert j["groups"] == t["groups"]
    assert j["multislice"] == t["multislice"]
    assert set(j["registry_neighbors"]) == set(t["registry_neighbors"])
    # The run reached what it was built for.
    assert all(t["placements"].values())
    if cluster == "demo":
        assert set(t["placements"].values()) == {"v5e-0"}
    if cluster == "mixed64":
        assert t["victims"] == ["filler-0", "filler-1"]
        assert {n for _, n in t["preemptions"]} == spec["hot"]
        assert set(t["groups"].values()) == {"Scheduled"}
        assert "default/gang-3" in t["multislice"]      # 6 hosts > a group
        assert "default/gang-0" not in t["multislice"]
        data = t["configmaps"]
        assert any("TPU_HBM_LIMIT_BYTES" in d for d in data.values())
        assert any("TPU_SLICE_ID" in d for d in data.values())
        assert any(".gang-svc.default.svc" in d.get("TPU_WORKER_HOSTNAMES",
                                                    "") for d in data.values())
        assert not any(n == "v5e-03" for n in t["placements"].values())
    if cluster == "sampled128":
        assert t["sched"]._scan_offset == len(spec["waves"][0]) % 128
