"""The port's leader elector (``sched/leaderelection.py``) against the JAX
package's:

- under an injected ``clock=``, one acquire, renew, partition, local
  demotion, steal, recovery and release script, stepped one loop turn at
  a time, gives the same ``is_leader`` transitions, callbacks, waits and
  Lease fields, on the in-memory APIServer and over REST (the Lease's
  times through RFC 3339);
- the ``renew_deadline_s < lease_duration_s`` guard;
- two scheduler replicas on one API server: exactly one binds, and after
  the leader stops the standby takes over and binds the next pod."""
import time

import pytest

from tests.fakekube import FakeKube
from test_torch_sched_plugins import ROOTS, MemRegistry, mod


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class OneTurn:
    """Stands in for the elector's stop event: ``_run`` makes one turn of
    its loop and records the wait it asked for."""

    def __init__(self):
        self.waited = None

    def is_set(self):
        return self.waited is not None

    def wait(self, timeout=None):
        self.waited = timeout
        return True

    def set(self):
        pass

    def clear(self):
        pass


def turn(el):
    el._stop = OneTurn()
    el._run()
    return el._stop.waited


class Partitionable:
    """One replica's view of the API server; ``down`` makes every call
    fail as a lost connection does."""

    def __init__(self, server):
        self.server, self.down = server, False

    def __getattr__(self, name):
        real = getattr(self.server, name)

        def call(*a, **kw):
            if self.down:
                raise ConnectionError("apiserver unreachable")
            return real(*a, **kw)
        return call


def election_script(side, server):
    le = mod(side, "sched.leaderelection")
    clock = Clock()
    views = {n: Partitionable(server) for n in "ab"}
    calls = []
    els = {n: le.LeaderElector(
        views[n], f"replica-{n}", lease_duration_s=15.0, clock=clock,
        on_started_leading=lambda n=n: calls.append(("start", n)),
        on_stopped_leading=lambda n=n: calls.append(("stop", n)))
        for n in "ab"}
    trace = []

    def lease():
        try:
            ls = server.get("Lease", "tpu-scheduler", "default")
        except Exception as e:  # noqa: BLE001
            return type(e).__name__
        return (ls.holder_identity, ls.lease_duration_s, ls.acquire_time,
                ls.renew_time, ls.lease_transitions)

    def at(t, who, action="turn"):
        clock.t = t
        if action == "turn":
            waited = turn(els[who])
        elif action == "down":
            views[who].down, waited = True, None
        elif action == "up":
            views[who].down, waited = False, None
        else:                                    # release
            els[who].stop()
            waited = None
        trace.append((t, who, action, waited, els["a"].is_leader(),
                      els["b"].is_leader(), lease(), list(calls)))

    at(100.25, "a")              # creates the lease
    at(100.5, "b")               # held: retry
    at(105.25, "a")              # renews
    at(106.0, "b")
    at(107.0, "a", "down")       # the holder loses the API server
    at(110.0, "a")               # a failed renew inside the deadline
    at(117.0, "a")               # 11.75 s stale: still leading
    at(117.25, "a")              # 12 s: demotes itself locally
    at(119.0, "b")               # not expired yet (105.25 + 15)
    at(120.25, "b")              # expired: steals, transition 1
    at(121.0, "a", "up")
    at(121.5, "a")               # sees b's live lease
    at(125.0, "b")               # renews
    at(126.0, "b", "release")    # stop: release the lease
    at(126.5, "a")               # takes the released lease, transition 2
    return trace


@pytest.mark.parametrize("transport", ["memory", "rest"])
def test_election_script_equal(transport):
    out = {}
    for side in ROOTS:
        fake = None
        if transport == "memory":
            server = mod(side, "cluster").APIServer()
        else:
            fake = FakeKube()
            server = mod(side, "cluster.kubeapi").KubeAPIServer(base_url=fake.url)
        try:
            out[side] = election_script(side, server)
        finally:
            if fake is not None:
                fake.close()
    assert out["jax"] == out["torch"]
    leaders = [(t, a, b) for t, _, _, _, a, b, _, _ in out["torch"]]
    assert leaders[0] == (100.25, True, False)
    assert leaders[7] == (117.25, False, False)      # demoted before the steal
    assert leaders[9] == (120.25, False, True)
    assert leaders[-1] == (126.5, True, False)
    assert out["torch"][-1][6] == ("replica-a", 15.0, 126.5, 126.5, 2)
    assert out["torch"][-1][7] == [("start", "a"), ("stop", "a"),
                                   ("start", "b"), ("stop", "b"),
                                   ("start", "a")]
    waits = [w for _, _, act, w, *_ in out["torch"] if act == "turn"]
    assert waits[:2] == [5.0, 3.0]                   # renew, retry periods


def test_renew_deadline_guard():
    for side in ROOTS:
        le = mod(side, "sched.leaderelection").LeaderElector
        server = mod(side, "cluster").APIServer()
        with pytest.raises(ValueError, match="renew_deadline_s"):
            le(server, "x", lease_duration_s=2.0, renew_deadline_s=2.0)
        el = le(server, "x", lease_duration_s=2.0)
        assert (el.renew_period_s, el.retry_period_s, el.renew_deadline_s) \
            == (2.0 / 3.0, 0.4, 1.6)


def replica(side, server, ident, registry):
    o = mod(side, "sched")
    cfg = mod(side, "config").SchedulerConfig(backoff_initial_s=0.05,
                                              backoff_max_s=0.2)
    # Whole seconds: the Lease carries leaseDurationSeconds as an integer
    # over REST (a 0.6 s lease would read back as 0, always expired).
    el = mod(side, "sched.leaderelection").LeaderElector(
        server, ident, lease_duration_s=1.0, renew_period_s=0.1,
        retry_period_s=0.05)
    sched = o.Scheduler(server, profile=o.Profile(), config=cfg, elector=el)
    tpu = mod(side, "plugins").TPUPlugin(sched.handle, registry=registry)
    sched.profile = o.Profile(pre_filter=[tpu], filter=[tpu], score=[tpu],
                              reserve=[tpu], post_bind=[tpu])
    return sched


def submit(side, server, name):
    o = mod(side, "api.objects")
    server.create(o.ConfigMap(metadata=o.ObjectMeta(name=f"cm-{name}")))
    server.create(o.Pod(metadata=o.ObjectMeta(name=name), spec=o.PodSpec(
        containers=[o.Container(
            env_from=[o.ConfigMapRef(f"cm-{name}")],
            resources=o.ResourceRequirements(requests={o.TPU_RESOURCE: 2}))])))


def wait_bound(server, name, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not server.get("Pod", name, "default").spec.node_name:
        assert time.monotonic() < deadline, f"{name} never bound"
        time.sleep(0.01)


def scheduled(replicas, total, timeout=10.0):
    """Each replica's count of pods it scheduled, once they add up to
    ``total`` (a bind is counted after its POST returns)."""
    deadline = time.monotonic() + timeout
    while True:
        counts = [s.metrics.counter("tpu_sched_attempts_total").value(
            result="scheduled") for s in replicas]
        if sum(counts) >= total or time.monotonic() > deadline:
            return counts
        time.sleep(0.01)


def failover(side, transport):
    fake = None
    if transport == "rest":
        fake = FakeKube()
        fake.add_node("n1")
        server = mod(side, "cluster.kubeapi").KubeAPIServer(base_url=fake.url)
    else:
        server = mod(side, "cluster").APIServer()
        o = mod(side, "api.objects")
        server.create(o.Node(
            metadata=o.ObjectMeta(name="n1", labels={
                o.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                o.LABEL_TPU_TOPOLOGY: "2x4"}),
            status=o.NodeStatus(capacity={o.TPU_RESOURCE: 8},
                                allocatable={o.TPU_RESOURCE: 8})))
    s1 = replica(side, server, "replica-1", MemRegistry({}))
    s2 = replica(side, server, "replica-2", MemRegistry({}))
    try:
        s1.start()
        assert s1.elector.wait_until_leader(5)
        s2.start()
        submit(side, server, "p1")
        wait_bound(server, "p1")
        counts = scheduled((s1, s2), 1)
        s1.stop()
        assert s2.elector.wait_until_leader(5)
        submit(side, server, "p2")
        wait_bound(server, "p2")
        counts += scheduled((s1, s2), 2)
        holder = server.get("Lease", "tpu-scheduler", "default")
        # The standby acquired the released lease, not an expired one:
        # less than a lease duration after the leader's last renew.
        gap = holder.acquire_time - s1.elector._last_renew
        posts = list(fake.binding_posts) if fake else None
        return counts, holder.holder_identity, holder.lease_transitions, \
            gap, posts
    finally:
        s1.stop()
        s2.stop()
        if fake is not None:
            fake.close()


@pytest.mark.parametrize("transport", ["memory", "rest"])
def test_two_replicas_exactly_one_binds(transport):
    out = {side: failover(side, transport) for side in ROOTS}
    for side, (counts, holder, transitions, gap, posts) in out.items():
        # Before: the leader bound p1, the standby nothing; after: the
        # standby bound p2, the stopped leader nothing more.
        assert counts == [1, 0, 1, 1], side
        assert holder == "replica-2" and transitions == 1, side
        # A clean stop releases the lease: no lease duration waited out.
        assert 0 < gap < 1.0, (side, gap)
        if posts is not None:
            assert [p[1] for p in posts] == ["p1", "p2"], side
    assert out["jax"][:3] == out["torch"][:3]
    assert out["jax"][4] == out["torch"][4]
