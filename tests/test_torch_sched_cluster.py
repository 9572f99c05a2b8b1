"""The port's cluster layer (``cluster/``) and the scheduler's queue and
cache against the JAX package's, on seeded scripts: the API server's
answers and resource versions, the watch streams, the informers' handler
sequences, the Descriptor's verbs, the queue's pop order and backoff
under a VirtualClock, and the cache's chip accounting, all exact."""
import threading
import time

import numpy as np
import pytest

from test_torch_sched_plugins import ROOTS, mod

KINDS = ("Pod", "Node", "ConfigMap", "PodGroup")


def make_obj(side, kind, name, rng, ns="default"):
    o = mod(side, "api.objects")
    meta = o.ObjectMeta(name=name, namespace=ns, uid=f"uid-{name}",
                        creation_timestamp=1000.0,
                        labels={"l": str(int(rng.integers(0, 3)))})
    if kind == "Pod":
        return o.Pod(metadata=meta, spec=o.PodSpec(containers=[o.Container(
            env_from=[o.ConfigMapRef(f"cm-{name}")],
            resources=o.ResourceRequirements(
                requests={o.TPU_RESOURCE: int(rng.integers(0, 5))}))]))
    if kind == "Node":
        return o.Node(metadata=meta, status=o.NodeStatus(
            allocatable={o.TPU_RESOURCE: 8},
            addresses=[f"10.0.0.{int(rng.integers(1, 250))}"]))
    if kind == "ConfigMap":
        return o.ConfigMap(metadata=meta, data={"k": str(rng.random())})
    return o.PodGroup(metadata=meta, min_member=int(rng.integers(1, 5)))


def script(seed, n=160):
    """A seeded create/update/mutate/delete/get script: (verb, kind, name,
    extra) tuples, independent of either package."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        verb = ("create", "update", "stale_update", "mutate", "delete",
                "get")[int(rng.integers(0, 6))]
        kind = KINDS[int(rng.integers(0, len(KINDS)))]
        name = f"{kind.lower()}-{int(rng.integers(0, 6))}"
        ns = ("default", "other")[int(rng.integers(0, 2))]
        out.append((verb, kind, name, ns, int(rng.integers(0, 1 << 30))))
    return out


def run_script(side, steps, server=None):
    """Apply ``steps`` to one package's APIServer: the answer of each
    (resource version, or the exception's name) and the final store."""
    cl = mod(side, "cluster.apiserver")
    server = server or cl.APIServer()
    answers = []
    for verb, kind, name, ns, seed in steps:
        rng = np.random.default_rng(seed)
        try:
            if verb == "create":
                got = server.create(make_obj(side, kind, name, rng, ns))
            elif verb in ("update", "stale_update"):
                cur = server.get(kind, name, ns)
                new = make_obj(side, kind, name, rng, ns)
                rv = cur.metadata.resource_version - (verb == "stale_update")
                got = server.update(new, expect_rv=rv)
            elif verb == "mutate":
                def fn(obj, v=str(seed)):
                    obj.metadata.annotations["m"] = v
                got = server.mutate(kind, name, ns, fn)
            elif verb == "delete":
                server.delete(kind, name, ns)
                got = None
            else:
                got = server.get(kind, name, ns)
            answers.append((verb, kind, ns, name, None if got is None else (
                got.metadata.resource_version, got.metadata.labels,
                got.metadata.annotations)))
        except Exception as e:  # noqa: BLE001 — the refusal is the answer
            answers.append((verb, kind, ns, name, type(e).__name__))
    store = {k: sorted((o.metadata.key, o.metadata.resource_version)
                       for o in server.list(k)) for k in KINDS}
    return answers, store


@pytest.mark.parametrize("seed", range(4))
def test_apiserver_answers_and_resource_versions_equal(seed):
    steps = script(seed)
    j, t = run_script("jax", steps), run_script("torch", steps)
    assert j == t
    # The script reaches every verb's refusal as well as its success.
    names = {a[-1] for a in t[0] if isinstance(a[-1], str)}
    assert {"Conflict", "NotFound", "AlreadyExists"} <= names


def drained(watch):
    out = []
    while True:
        ev = watch.next(timeout=0.01)
        if ev is None:
            return out
        out.append((ev.type, ev.obj.metadata.key,
                    ev.obj.metadata.resource_version))


def test_watch_streams_equal():
    """Watches opened before the script (no initial list) and after it
    (the initial ADDs), per kind."""
    out = {}
    for side in ROOTS:
        server = mod(side, "cluster.apiserver").APIServer()
        steps = script(11)
        early = {k: server.watch(k, send_initial=False) for k in KINDS}
        run_script(side, steps[:80], server)
        late = {k: server.watch(k, send_initial=True) for k in KINDS}
        run_script(side, steps[80:], server)
        out[side] = {k: (drained(early[k]), drained(late[k])) for k in KINDS}
        for w in list(early.values()) + list(late.values()):
            w.stop()
            assert w.next(timeout=0.01) is None
    assert out["jax"] == out["torch"]
    assert sum(len(a) + len(b) for a, b in out["torch"].values()) > 60


def informer_run(side, steps):
    """A factory over Pod and Node informers with handlers registered
    before start (they get the synthetic ADDs of the pre-existing
    objects) and one registered late; the script runs around start."""
    cl = mod(side, "cluster")
    server = cl.APIServer()
    run_script(side, steps[:60], server)
    factory = cl.SharedInformerFactory(server)
    seen = {k: [] for k in ("Pod", "Node", "late")}

    def handlers(tag):
        return dict(
            on_add=lambda o: seen[tag].append(
                ("add", o.metadata.key, o.metadata.resource_version)),
            on_update=lambda old, new: seen[tag].append(
                ("update", new.metadata.key,
                 None if old is None else old.metadata.resource_version,
                 new.metadata.resource_version)),
            on_delete=lambda o: seen[tag].append(
                ("delete", o.metadata.key, o.metadata.resource_version)))

    for kind in ("Pod", "Node"):
        factory.informer(kind).add_event_handler(**handlers(kind))
    factory.start()
    assert factory.wait_for_cache_sync(5.0)
    run_script(side, steps[60:120], server)
    pods = factory.informer("Pod")
    # Late registration: the synthetic ADDs replay the cache at that
    # point, so wait for the informer to reach the store first.
    want = sorted((p.metadata.key, p.metadata.resource_version)
                  for p in server.list("Pod"))
    deadline = time.monotonic() + 5
    while sorted((p.metadata.key, p.metadata.resource_version)
                 for p in pods.list()) != want:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    pods.add_event_handler(**handlers("late"))
    run_script(side, steps[120:], server)
    want = {k: sorted((o.metadata.key, o.metadata.resource_version)
                      for o in server.list(k)) for k in ("Pod", "Node")}
    deadline = time.monotonic() + 5
    while {k: sorted((o.metadata.key, o.metadata.resource_version)
                     for o in factory.informer(k).list())
           for k in ("Pod", "Node")} != want:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    lister = (pods.get("pod-1"), pods.get("pod-1", "other"),
              len(pods.list(namespace="other")),
              len(pods.list(label_selector={"l": "1"})),
              pods.has_synced())
    factory.stop()
    lister = tuple(x.metadata.resource_version if hasattr(x, "metadata")
                   else x for x in lister)
    return seen, lister


@pytest.mark.parametrize("seed", range(3))
def test_informer_handler_sequences_equal(seed):
    steps = script(100 + seed, n=200)
    j, t = informer_run("jax", steps), informer_run("torch", steps)
    assert j == t
    assert all(j[0][k] for k in ("Pod", "Node"))


def test_descriptor_verbs_equal():
    out = {}
    for side in ROOTS:
        o, cl = mod(side, "api.objects"), mod(side, "cluster")
        server = cl.APIServer()
        d = cl.Descriptor(server)
        rng = np.random.default_rng(3)
        server.create(make_obj(side, "Node", "n1", rng))
        server.create(make_obj(side, "ConfigMap", "cm-p", rng))
        d.create_pod(make_obj(side, "Pod", "p", rng))
        d.create_pod(make_obj(side, "Pod", "q", rng))
        rec = [d.bind_pod("p", "default", "n1").status.host_ip,
               d.bind_pod("q", "default", "ghost").status.host_ip,
               d.set_pod_phase("q", "default", "Running").status.phase,
               d.append_to_pod_configmaps(d.get_pod("p"), {"A": "1"}),
               d.append_to_pod_configmaps(d.get_pod("q"), {"A": "2"}),
               d.get_configmap("cm-p").data["A"],
               [p.metadata.name for p in d.list_pods(node_name="n1")],
               [p.metadata.name for p in d.list_pods(phase="Running")],
               d.label_node(cl.PatchNodeParam(
                   "n1", "add", "/metadata/labels", {"x": "y"}
               )).metadata.labels,
               d.label_node(cl.PatchNodeParam(
                   "n1", "remove", "/metadata/labels", {"x": ""}
               )).metadata.labels]
        d.delete_pod("q")
        rec.append(sorted(p.metadata.name for p in d.list_pods()))
        out[side] = rec
    assert out["jax"] == out["torch"]


# -- the scheduling queue under a VirtualClock ----------------------------

def queue_run(side, seed):
    """Seeded add / unschedulable / remove / move / pop traffic on a queue
    whose clock only moves when the script says so: the pop order, every
    pop's wait, and the backoff readiness."""
    o, q_mod = mod(side, "api.objects"), mod(side, "sched.queue")
    clock = mod(side, "obs").VirtualClock()
    q = q_mod.SchedulingQueue(backoff_initial_s=1.0, backoff_max_s=8.0,
                              clock=clock)
    rng = np.random.default_rng(seed)
    pods = [o.Pod(metadata=o.ObjectMeta(
        name=f"p{i}", uid=f"u{i}", creation_timestamp=float(
            rng.integers(0, 5)),
        annotations={q_mod.ANN_PRIORITY: str(int(rng.integers(-1, 3)))}
        if i % 3 else {q_mod.ANN_PRIORITY: "garbage"}))
        for i in range(24)]
    log = []
    for _ in range(200):
        op = int(rng.integers(0, 7))
        pod = pods[int(rng.integers(0, len(pods)))]
        if op == 0:
            q.add(pod)
        elif op == 1:
            q.add_unschedulable(pod)
        elif op == 2:
            q.remove(pod)
        elif op == 3:
            q.move_all_to_active("x")
        elif op == 4:
            clock.advance(float(rng.integers(0, 4)) * 0.5)
        elif op == 5:
            q.done(pod)
        else:
            got = q.pop(timeout=0.0)
            log.append(None if got is None else got.metadata.name)
        log.append((q.pending_count(), q.enqueued_at(pod.metadata.uid)))
    # Drain: the clock jumps past every backoff, then everything pops.
    clock.advance(100.0)
    while True:
        got = q.pop(timeout=0.0)
        if got is None:
            break
        log.append(got.metadata.name)
    q.close()
    log.append(q.pop(timeout=None))
    return log, [q_mod.pod_priority(p) for p in pods]


@pytest.mark.parametrize("seed", range(6))
def test_queue_pop_order_and_backoff_equal(seed):
    j, t = queue_run("jax", seed), queue_run("torch", seed)
    assert j == t
    assert any(isinstance(x, str) for x in t[0])


def test_queue_backoff_doubles_to_its_cap():
    """The backoff of each attempt, read off the virtual clock, in both
    packages: 1, 2, 4, 8, 8 s (initial 1, max 8)."""
    out = {}
    for side in ROOTS:
        o, q_mod = mod(side, "api.objects"), mod(side, "sched.queue")
        clock = mod(side, "obs").VirtualClock()
        q = q_mod.SchedulingQueue(backoff_initial_s=1.0, backoff_max_s=8.0,
                                  clock=clock)
        pod = o.Pod(metadata=o.ObjectMeta(name="p", uid="u"))
        q.add(pod)
        assert q.pop(timeout=0.0) is pod
        waits = []
        for _ in range(5):
            q.add_unschedulable(pod)
            t0 = clock.monotonic()
            while q.pop(timeout=0.0) is None:
                clock.advance(0.25)
            waits.append(clock.monotonic() - t0)
        out[side] = waits
    assert out["jax"] == out["torch"] == [1.0, 2.0, 4.0, 8.0, 8.0]


def test_queue_pop_wakes_on_add():
    """A blocked pop returns the pod another thread adds (both packages)."""
    for side in ROOTS:
        o, q_mod = mod(side, "api.objects"), mod(side, "sched.queue")
        q = q_mod.SchedulingQueue()
        pod = o.Pod(metadata=o.ObjectMeta(name="p", uid="u"))
        threading.Timer(0.05, q.add, args=(pod,)).start()
        assert q.pop(timeout=5.0) is pod


# -- the cache's chip accounting ------------------------------------------

def cache_run(side, seed):
    o, c_mod = mod(side, "api.objects"), mod(side, "sched.cache")
    cache = c_mod.Cache()
    rng = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(4)]
    for n in nodes[:3]:
        cache.add_node(o.Node(
            metadata=o.ObjectMeta(name=n, labels={
                o.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                o.LABEL_TPU_TOPOLOGY: "2x4"}),
            status=o.NodeStatus(allocatable={o.TPU_RESOURCE: 8})))

    def pod(i, node=""):
        return o.Pod(metadata=o.ObjectMeta(name=f"p{i}", uid=f"u{i}"),
                     spec=o.PodSpec(node_name=node, containers=[o.Container(
                         resources=o.ResourceRequirements(
                             requests={o.TPU_RESOURCE: 1 + i % 3}))]))
    log = []
    for _ in range(300):
        op, i = int(rng.integers(0, 7)), int(rng.integers(0, 12))
        node = nodes[int(rng.integers(0, 4))]
        if op == 0:
            cache.assume(pod(i), node)
        elif op == 1:
            cache.forget(pod(i))
        elif op == 2:
            cache.add_pod(pod(i, node))
        elif op == 3:
            cache.update_pod(pod(i, nodes[i % 4]), pod(i, node))
        elif op == 4:
            cache.delete_pod(pod(i, node))
        elif op == 5:
            cache.finish_binding(pod(i))
            log.append(cache.is_assumed(pod(i)))
        else:
            snap = cache.snapshot()
            log.append(sorted(
                (n, info.requested_tpu, info.free_tpu,
                 sorted(p.metadata.name for p in info.pods),
                 None if info.slice_topology() is None
                 else info.slice_topology().dims)
                for n, info in snap.items()))
    log.append(sorted(cache.node_names()))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_cache_accounting_equal(seed):
    j, t = cache_run("jax", seed), cache_run("torch", seed)
    assert j == t
