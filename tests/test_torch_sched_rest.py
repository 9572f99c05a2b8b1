"""The port's REST adapter (``cluster/kubeapi.py``) against the JAX
package's:

- the JSON mapping: ``obj_to_json`` and every ``*_from_json`` equal on
  seeded objects and documents, the Lease times' RFC 3339 codec exact;
- one scripted session against an in-process ``tests.fakekube.FakeKube``
  (create, get, list, mutate, bind, patch, update with a stale
  ``expect_rv``, delete, a watch with a forced 410): the same answers,
  the same ``binding_posts`` and the same store;
- ``cmd.scheduler --apiserver URL --once`` over a fakekube subprocess
  prints the same ``scheduled`` lines;
- ``--in-cluster`` construction from a patched ``SA_DIR`` and
  ``KUBERNETES_SERVICE_HOST``, and a fakekube behind TLS that the other
  scheduler tests use."""
import dataclasses
import os
import pathlib
import re
import ssl
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.fakekube import FakeKube
from test_torch_sched_plugins import ROOTS, mod

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCHEDULED = re.compile(r"scheduled (\S+) -> (\S+)$")


def plain(obj):
    """An object as nested dicts, without the creation time (each decode
    stamps its own)."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k != "creation_timestamp"}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return {"kind": obj.kind, **strip(dataclasses.asdict(obj))}


# -- helpers the scheduler tests share ------------------------------------------

def make_cert(d):
    """A self-signed certificate for 127.0.0.1: (cert path, key path)."""
    cert, key = str(d / "ca.crt"), str(d / "tls.key")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    return cert, key


def tls_fake(d):
    """A FakeKube that speaks HTTPS with a certificate from ``make_cert``:
    (fake, port, cert path)."""
    cert, key = make_cert(d)
    fake = FakeKube()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    fake.server.socket = ctx.wrap_socket(fake.server.socket, server_side=True)
    return fake, fake.server.server_port, cert


def service_account(d, monkeypatch, side, port, cert, token="sa-token"):
    """An in-cluster environment: the service account's token and CA under
    ``d`` (patched in as ``SA_DIR``) and the service host and port."""
    (d / "token").write_text(token + "\n")
    if cert != str(d / "ca.crt"):
        (d / "ca.crt").write_bytes(pathlib.Path(cert).read_bytes())
    monkeypatch.setattr(mod(side, "cluster.kubeapi"), "SA_DIR", str(d))
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(port))


def start_fakekube(*args):
    """``python -m tests.fakekube ARGS`` as a subprocess: (process, URL)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tests.fakekube", *args], cwd=ROOT,
        stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline().strip()
    assert line.startswith("PORT "), line
    return proc, f"http://127.0.0.1:{line.split()[1]}"


def stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


# -- the JSON mapping -------------------------------------------------------------

def seeded_objects(side, rng):
    o = mod(side, "api.objects")
    out = []
    for i in range(6):
        env = [o.EnvVar(f"E{j}", str(int(rng.integers(0, 99))))
               for j in range(int(rng.integers(0, 3)))]
        res = o.ResourceRequirements(
            requests={o.TPU_RESOURCE: int(rng.integers(0, 9))},
            limits={o.TPU_RESOURCE: 8} if i % 2 else {})
        owners = [["StatefulSet/s", "Job/j", "Deployment/d", "Custom/c"][i % 4]
                  ] if i % 3 else []
        meta = o.ObjectMeta(
            name=f"p{i}", namespace=("default", "team-a")[i % 2],
            labels={"tpu.sched/pod-group": "g"} if i % 2 else {},
            annotations={"tpu.sched/priority": str(i)} if i else {},
            uid=f"u{i}", owner_references=owners)
        out.append(o.Pod(metadata=meta, spec=o.PodSpec(
            containers=[o.Container(
                name=f"c{i}", image="img", env=env,
                env_from=[o.ConfigMapRef(f"cm-{i}")], resources=res)],
            node_name="n1" if i == 3 else "",
            node_selector={"zone": "hot"} if i % 2 else {},
            hostname=f"p{i}" if i == 4 else "",
            subdomain="svc" if i == 4 else "")))
    out.append(o.Node(metadata=o.ObjectMeta(
        name="n1", labels={o.LABEL_TPU_TOPOLOGY: "2x4"},
        annotations={o.ANN_RESHAPE_STATE: "applying"}, uid="un")))
    out.append(o.ConfigMap(metadata=o.ObjectMeta(name="cm", uid="uc"),
                           data={"A": "1", "B": ""}))
    out.append(o.PodGroup(metadata=o.ObjectMeta(name="g", uid="ug"),
                          min_member=4, topology="4x4",
                          schedule_timeout_s=12.7))
    for k in range(3):
        t = 1.7e9 + float(rng.integers(0, 10**9)) / 1e3
        out.append(o.Lease(
            metadata=o.ObjectMeta(name=f"l{k}", uid=f"ul{k}"),
            holder_identity=("", "host_1", "host_2")[k],
            lease_duration_s=(15.0, 2.5, 7.0)[k],
            acquire_time=t if k else 0.0, renew_time=t + 1.5 if k else 0.0,
            lease_transitions=k))
    return out


def json_docs(rng):
    """Documents as a kube-apiserver sends them (status, strings for
    quantities, rv strings, nulls), and the edge cases of the mappers."""
    t = f"2025-0{int(rng.integers(1, 9))}-1{int(rng.integers(0, 9))}"
    return {
        "Pod": [
            {"metadata": {"name": "a", "resourceVersion": "123",
                          "ownerReferences": [{"kind": "Job", "name": "j"}]},
             "spec": {"containers": [{
                 "name": "m", "env": [{"name": "X", "value": "1"},
                                      {"name": "Y"}, {"value": "nameless"}],
                 "envFrom": [{"configMapRef": {"name": "cm"}},
                             {"secretRef": {"name": "s"}}],
                 "resources": {"requests": {"google.com/tpu": "4",
                                            "cpu": "500m"},
                               "limits": None}}],
                 "nodeName": "n1", "schedulerName": "tpu-scheduler"},
             "status": {"phase": "Running", "hostIP": "10.0.0.1",
                        "podIP": "10.1.0.2"}},
            {"metadata": {"name": "b", "namespace": "ns",
                          "resourceVersion": "x12", "uid": "uid-b",
                          "labels": None}},
            {}],
        "Node": [
            {"metadata": {"name": "n"}, "status": {
                "capacity": {"google.com/tpu": "8"},
                "allocatable": {"google.com/tpu": 8},
                "addresses": [{"type": "InternalIP", "address": "10.0.0.9"}],
                "conditions": [{"type": "Ready", "status": "False"},
                               {"type": "DiskPressure", "status": "True"}]}},
            {"metadata": {"name": "m"}, "status": {"conditions": []}}],
        "ConfigMap": [{"metadata": {"name": "c"}, "data": None},
                      {"metadata": {"name": "d"}, "data": {"k": "v"}}],
        "PodGroup": [{"metadata": {"name": "g"}, "spec": {
            "minMember": 3, "scheduleTimeoutSeconds": 30}}, {}],
        "Lease": [
            {"metadata": {"name": "l"}, "spec": {
                "holderIdentity": "h", "leaseDurationSeconds": 15,
                "acquireTime": f"{t}T10:11:12.123456Z",
                "renewTime": f"{t}T10:11:13Z", "leaseTransitions": 4}},
            {"metadata": {"name": "k"}, "spec": {
                "holderIdentity": None, "acquireTime": "garbage",
                "renewTime": None}}],
    }


@pytest.mark.parametrize("seed", range(2))
def test_json_mapping_equal(seed):
    jk, tk = mod("jax", "cluster.kubeapi"), mod("torch", "cluster.kubeapi")
    jobjs = seeded_objects("jax", np.random.default_rng(seed))
    tobjs = seeded_objects("torch", np.random.default_rng(seed))
    for j, t in zip(jobjs, tobjs):
        jd, td = jk.obj_to_json(j), tk.obj_to_json(t)
        assert jd == td
        back_j = jk._FROM_JSON[j.kind](jd)
        back_t = tk._FROM_JSON[t.kind](td)
        assert plain(back_j) == plain(back_t)
        if t.kind == "Lease":
            assert (back_t.acquire_time, back_t.renew_time) == \
                (t.acquire_time, t.renew_time)
    for kind, docs in json_docs(np.random.default_rng(seed)).items():
        for doc in docs:
            assert plain(jk._FROM_JSON[kind](doc)) == \
                plain(tk._FROM_JSON[kind](doc))
    assert list(jk._ROUTES.items()) == list(tk._ROUTES.items())
    assert sorted(jk._FROM_JSON) == sorted(tk._FROM_JSON)
    assert getattr(tk, "pod_from_json") is tk._FROM_JSON["Pod"]
    with pytest.raises(KeyError):                # a kind with no route
        tk.obj_to_json(type("X", (), {"kind": "Secret"})())


def test_rfc3339_codec_exact():
    jk, tk = mod("jax", "cluster.kubeapi"), mod("torch", "cluster.kubeapi")
    rng = np.random.default_rng(3)
    epochs = [0.0, 1.0, 1.7e9] + [float(x) for x in rng.uniform(1e9, 2e9, 200)]
    epochs += [float(int(x)) + int(rng.integers(0, 10**6)) / 1e6
               for x in rng.uniform(1e9, 2e9, 200)]
    for e in epochs:
        s = tk._rfc3339(e)
        assert s == jk._rfc3339(e)
        assert tk._from_rfc3339(s) == jk._from_rfc3339(s)
    for s in (None, "", "2025-01-02T03:04:05Z", "2025-01-02T03:04:05.5Z",
              "2025-01-02T03:04:05+01:00", "not a time"):
        assert tk._from_rfc3339(s) == jk._from_rfc3339(s)


# -- one scripted session against FakeKube ------------------------------------------

def session(side, fake):
    """The script: every answer as data (objects as ``plain``, errors by
    class name)."""
    o = mod(side, "api.objects")
    k = mod(side, "cluster.kubeapi")
    api = k.KubeAPIServer(base_url=fake.url, token="t0k")
    answers = []

    def ask(fn, *a, **kw):
        try:
            r = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — the class is the answer
            answers.append(("error", type(e).__name__))
            return None
        if isinstance(r, list):
            answers.append([plain(x) for x in r])
        elif r is not None and hasattr(r, "kind"):
            answers.append(plain(r))
        else:
            answers.append(r)
        return r

    fake.add_node("n1", labels={"zone": "hot"})
    fake.add_node("n2")
    for i in range(3):
        ask(api.create, o.ConfigMap(metadata=o.ObjectMeta(name=f"cm-{i}"),
                                    data={"x": str(i)}))
        ask(api.create, o.Pod(
            metadata=o.ObjectMeta(name=f"p{i}", labels={"app": f"a{i % 2}"},
                                  owner_references=["StatefulSet/s"]),
            spec=o.PodSpec(containers=[o.Container(
                env=[o.EnvVar("SLO", "5")],
                env_from=[o.ConfigMapRef(f"cm-{i}")],
                resources=o.ResourceRequirements(
                    requests={o.TPU_RESOURCE: 2}))])))
    ask(api.create, o.Pod(metadata=o.ObjectMeta(name="p0")))   # exists
    ask(api.create, o.PodGroup(metadata=o.ObjectMeta(name="g"), min_member=2))
    ask(api.get, "Pod", "p1", "default")
    ask(api.get, "Pod", "nope", "default")
    ask(api.get, "Node", "n1")
    for kind in ("Pod", "Node", "ConfigMap", "PodGroup", "Lease"):
        ask(api.list, kind)
    ask(api.list, "Pod", label_fn=lambda lab: lab.get("app") == "a1")
    ask(api.list, "Node", field_fn=lambda n: n.metadata.name == "n2")

    def annotate(n):
        n.metadata.annotations["tpu.sched/slice.reshape-state"] = "applying"
        n.metadata.labels["x"] = "1"

    def clear(n):
        n.metadata.annotations.pop("tpu.sched/slice.reshape-state")
        n.metadata.labels.pop("x")
    ask(api.mutate, "Node", "n1", "default", annotate)
    ask(api.mutate, "Node", "n1", "default", clear)
    ask(api.mutate, "ConfigMap", "cm-0", "default",
        lambda c: (c.data.pop("x"), c.data.update(y="2")))
    ask(api.mutate, "Pod", "p0", "default",          # the bind pattern
        lambda p: setattr(p.spec, "node_name", "n1"))
    ask(api.mutate, "Pod", "p0", "default",
        lambda p: p.metadata.annotations.update(seen="1"))
    ask(api.bind, "p1", "default", "n2")
    ask(api.bind, "ghost", "default", "n2")
    ask(api.patch_configmap_data, "cm-1", "default", {"TPU_VISIBLE_CHIPS": "0,1"})
    lease = o.Lease(metadata=o.ObjectMeta(name="lease"), holder_identity="a",
                    lease_duration_s=15.0, acquire_time=1.7e9 + 0.25,
                    renew_time=1.7e9 + 0.5)
    got = ask(api.create, lease)
    got.holder_identity = "b"
    got.renew_time += 2.0
    ask(api.update, got, expect_rv=got.metadata.resource_version)
    ask(api.update, got, expect_rv=got.metadata.resource_version)  # stale
    got.lease_transitions = 3
    ask(api.update, got)                                  # merge-patch
    ask(api.get, "Lease", "lease", "default")
    ask(api.delete, "Pod", "p2", "default")
    ask(api.delete, "Pod", "p2", "default")

    # A watch: the initial list, a live event, then a forced 410 while a
    # pod vanishes silently: the re-list's diff.
    fake.watch_idle_s = 0.3
    w = api.watch("Pod", send_initial=True)
    events = []

    def take(n):
        deadline = time.monotonic() + 10
        while len(events) < n and time.monotonic() < deadline:
            ev = w.next(timeout=0.5)
            if ev is not None:
                events.append((ev.type, plain(ev.obj)))
        return events
    take(2)
    ask(api.create, o.Pod(metadata=o.ObjectMeta(name="p3")))
    take(3)
    with fake.mu:
        fake.store["pods"].pop("default/p1")
        fake.gone_on_watch = True
    take(6)                       # DELETED p1, then ADDED p0 and p3
    w.stop()
    assert w.next(timeout=1) is None
    answers.append(events)
    return answers


def test_scripted_session_equal():
    out = {}
    for side in ROOTS:
        fake = FakeKube()
        try:
            out[side] = (session(side, fake), list(fake.binding_posts),
                         {k: dict(v) for k, v in fake.store.items()}, fake.rv)
        finally:
            fake.close()
    assert out["jax"] == out["torch"]
    answers, posts, store, _ = out["torch"]
    assert posts == [("default", "p0", "n1"), ("default", "p1", "n2")]
    kinds = [e[0] for e in answers[-1]]
    assert kinds == ["ADDED", "ADDED", "ADDED", "DELETED", "ADDED", "ADDED"]
    assert ("error", "AlreadyExists") in answers
    assert ("error", "NotFound") in answers and ("error", "Conflict") in answers
    assert store["configmaps"]["default/cm-1"]["data"] == {
        "x": "1", "TPU_VISIBLE_CHIPS": "0,1"}
    assert "tpu.sched/slice.reshape-state" not in \
        store["nodes"]["default/n1"]["metadata"]["annotations"]


def test_stream_error_without_410_reconnects():
    """A watch whose stream drops (not 410) reconnects from its last rv and
    loses nothing."""
    fake = FakeKube()
    fake.watch_idle_s = 0.2
    try:
        o = mod("torch", "api.objects")
        api = mod("torch", "cluster.kubeapi").KubeAPIServer(base_url=fake.url)
        w = api.watch("ConfigMap", send_initial=False)
        time.sleep(0.5)                         # the stream idles out once
        api.create(o.ConfigMap(metadata=o.ObjectMeta(name="late")))
        ev = w.next(timeout=10)
        w.stop()
        assert ev is not None and (ev.type, ev.obj.metadata.name) == \
            ("ADDED", "late")
    finally:
        fake.close()


# -- the entry point over REST ----------------------------------------------------

def apiserver_once_lines(side):
    proc, url = start_fakekube("--nodes", "2", "--slice-size", "2")
    try:
        o = mod("torch", "api.objects")
        api = mod("torch", "cluster.kubeapi").KubeAPIServer(base_url=url)
        for i in range(6):
            api.create(o.ConfigMap(metadata=o.ObjectMeta(name=f"cm-{i}")))
            api.create(o.Pod(metadata=o.ObjectMeta(name=f"rest-{i}"),
                             spec=o.PodSpec(containers=[o.Container(
                                 env_from=[o.ConfigMapRef(f"cm-{i}")],
                                 resources=o.ResourceRequirements(
                                     requests={o.TPU_RESOURCE: 1 + i % 4}))])))
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   TPU_SCHED_REGISTRY_PORT="1", TPU_SCHED_RECOMMENDER_PORT="1",
                   TPU_SCHED_METRICS_URL="http://127.0.0.1:1")
        run = subprocess.run(
            [sys.executable, "-m", f"{ROOTS[side]}.cmd.scheduler",
             "--apiserver", url, "--once", "--metrics-port", "0"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        lines = [m.group(0) for m in map(SCHEDULED.search,
                                         run.stderr.splitlines()) if m]
        cms = {c.metadata.name: c.data for c in api.list("ConfigMap")}
        return run.returncode, lines, run.stderr, cms
    finally:
        stop(proc)


def test_apiserver_once_lines_equal_jax():
    jcode, jlines, jerr, jcms = apiserver_once_lines("jax")
    tcode, tlines, terr, tcms = apiserver_once_lines("torch")
    assert jcode == tcode == 0, (jerr[-2000:], terr[-2000:])
    assert tlines == jlines and len(tlines) == 6
    assert "connected to kube-apiserver at http://127.0.0.1:" in terr
    assert all("TPU_VISIBLE_CHIPS" in tcms[f"cm-{i}"] for i in range(6))
    # The injected keys, but TPU_NEIGHBORS: PostBind reads a partition's
    # residents on a binder thread, so whom it names depends on timing in
    # the JAX package itself (tests/test_torch_sched_placement.py).
    def keys(cms):
        return {k: sorted(set(v) - {"TPU_NEIGHBORS"}) for k, v in cms.items()}
    assert keys(tcms) == keys(jcms)


def test_in_cluster_construction(tmp_path, monkeypatch):
    cert, _ = make_cert(tmp_path)
    built = {}
    for side in ROOTS:
        service_account(tmp_path, monkeypatch, side, 6443, cert)
        api = mod(side, "cluster.kubeapi").KubeAPIServer()
        built[side] = (api.base_url, api.token, api._base_path,
                       isinstance(api._ctx, ssl.SSLContext), api.timeout_s)
        monkeypatch.delenv("KUBERNETES_SERVICE_HOST")
        with pytest.raises(RuntimeError, match="not in-cluster"):
            mod(side, "cluster.kubeapi").KubeAPIServer()
    assert built["jax"] == built["torch"] == (
        "https://127.0.0.1:6443", "sa-token", "", True, 10.0)
    # An explicit URL with a path prefix keeps the prefix.
    api = mod("torch", "cluster.kubeapi").KubeAPIServer(
        base_url="http://gw.example:8080/k8s/", token="x")
    assert (api.base_url, api._base_path, api._ctx) == \
        ("http://gw.example:8080/k8s", "/k8s", None)


def test_in_cluster_over_tls(tmp_path, monkeypatch):
    """The service-account construction talks to a TLS apiserver: the CA
    verifies it, and a session runs over it."""
    fake, port, cert = tls_fake(tmp_path)
    try:
        service_account(tmp_path, monkeypatch, "torch", port, cert)
        o = mod("torch", "api.objects")
        api = mod("torch", "cluster.kubeapi").KubeAPIServer()
        fake.add_node("n1")
        w = api.watch("Node", send_initial=True)
        ev = w.next(timeout=10)
        w.stop()
        assert ev is not None and ev.obj.metadata.name == "n1"
        api.create(o.ConfigMap(metadata=o.ObjectMeta(name="c"), data={"a": "b"}))
        assert api.get("ConfigMap", "c").data == {"a": "b"}
        # Another CA refuses the server.
        other = tmp_path / "other"
        other.mkdir()
        wrong, _ = make_cert(other)
        bad = mod("torch", "cluster.kubeapi").KubeAPIServer(
            base_url=f"https://127.0.0.1:{port}", ca_file=wrong, timeout_s=5)
        with pytest.raises(ssl.SSLError):
            bad.get("ConfigMap", "c")
    finally:
        fake.close()
