"""The port's recommender and Prometheus client against the JAX
package's, on the same numpy-seeded inputs:

- the proto3 codec: byte-equal encodings, equal decodings of seeded
  requests and replies, unknown fields and unpacked floats included;
- the imputer: ``fit_transform``/``transform`` equal bit for bit on
  seeded NaN matrices;
- the server's ``_Table.lookup`` for every seed label and suffixed pod
  names, and the md5-watched hot swap;
- the ``Collector``: one registry script folded by both leaves
  byte-identical TSVs and latency keys;
- gRPC across packages (a JAX client against the port's server and the
  port's client against JAX's), the TTL cache, no caching of errors,
  the bounded retry through the ``recommender.call`` fault hook;
- the Prometheus client on JAX's golden fixture and against one stub;
- SLO placements: both packages' ``build_scheduler`` with their real
  recommender clients on the seed matrices place ``demo_cluster(8)`` and
  the 64-node mixed cluster alike."""
import dataclasses
import pathlib
import shutil
import struct
import time

import numpy as np
import pytest

from test_metrics import GOLDEN, MockProm
from test_torch_sched_plugins import ROOTS, mod

ROOT = pathlib.Path(__file__).resolve().parents[1]


def seed_data(side):
    return ROOT / ROOTS[side] / "recommender" / "data"


# -- the wire codec -----------------------------------------------------------

def seeded_strings(rng, n):
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789-_") + ["é", "ß", "東"]
    out = [""]
    for _ in range(n):
        k = int(rng.integers(1, 300))      # lengths past one varint byte
        out.append("".join(rng.choice(alphabet, k)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_codec_bytes_equal(seed):
    jw, tw = mod("jax", "recommender.wire"), mod("torch", "recommender.wire")
    rng = np.random.default_rng(seed)
    for s in seeded_strings(rng, 40):
        jb = jw.encode_request(s)
        assert jb == tw.encode_request(s)
        assert jw.decode_request(jb) == tw.decode_request(jb) == s
    for _ in range(40):
        n = int(rng.integers(0, 40))
        values = [float(np.float32(v)) for v in rng.normal(0, 1e3, n)]
        columns = seeded_strings(rng, int(rng.integers(0, 8)))[1:]
        jb = jw.encode_reply(values, columns)
        assert jb == tw.encode_reply(values, columns)
        assert jw.decode_reply(jb) == tw.decode_reply(jb) == (values, columns)
        # Unknown fields of every wire type, and the floats unpacked.
        unknown = (b"\x18" + jw._varint(int(rng.integers(0, 1 << 40)))
                   + b"\x21" + rng.bytes(8)
                   + b"\x2a\x03xyz" + b"\x35" + rng.bytes(4))
        unpacked = b"".join(b"\x0d" + struct.pack("<f", v) for v in values)
        unpacked += b"".join(b"\x12" + jw._varint(len(c.encode())) + c.encode()
                             for c in columns)
        for buf in (unknown + jb, jb + unknown, unpacked, unknown + unpacked):
            assert jw.decode_reply(buf) == tw.decode_reply(buf) == \
                (values, columns)
        assert tw.decode_request(unknown + jw.encode_request("ix")) == "ix"
    with pytest.raises(ValueError):
        tw.decode_reply(b"\x0b")                 # wire type 3: unsupported
    with pytest.raises(ValueError):
        tw.decode_request(b"\x0a\x80")           # truncated varint
    assert (tw.SERVICE, tw.METHOD_CONFIGURATIONS, tw.METHOD_INTERFERENCE) == \
        (jw.SERVICE, jw.METHOD_CONFIGURATIONS, jw.METHOD_INTERFERENCE)


# -- the imputer ----------------------------------------------------------------

def nan_matrix(rng, n, d, frac):
    X = rng.normal(0, 1, (n, 2)) @ rng.normal(0, 3, (2, d)) + rng.normal(
        0, 0.1, (n, d)) + 50
    X[rng.random((n, d)) < frac] = np.nan
    X[:, d - 1] = np.nan                     # a column with no signal
    X[1:, 0] = np.nan if d > 3 else X[1:, 0]  # one observed cell
    return X


@pytest.mark.parametrize("seed,shape,frac", [
    (0, (8, 7), 0.2), (1, (20, 5), 0.4), (2, (5, 3), 0.3), (3, (40, 9), 0.1)])
def test_imputer_equal_bit_for_bit(seed, shape, frac):
    rng = np.random.default_rng(seed)
    X = nan_matrix(rng, *shape, frac)
    rows = nan_matrix(rng, 6, shape[1], 0.5)
    out = {}
    for side in ROOTS:
        imp = mod(side, "recommender.model").IterativeImputer()
        done = imp.fit_transform(X.copy())
        out[side] = (done, imp.transform(rows.copy()), imp.means_,
                     imp.weights_)
    (jd, jt, jm, jw), (td, tt, tm, tw) = out["jax"], out["torch"]
    assert jd.tobytes() == td.tobytes() and jt.tobytes() == tt.tobytes()
    assert jm.tobytes() == tm.tobytes()
    assert sorted(jw) == sorted(tw)
    assert all(jw[k].tobytes() == tw[k].tobytes() for k in jw)
    assert np.isfinite(td).all()
    with pytest.raises(RuntimeError):
        mod("torch", "recommender.model").IterativeImputer().transform(rows)


# -- the server's tables ------------------------------------------------------

def requests_for(labels):
    out = ["nosuch-workload", "", "V5E"]
    for label in labels:
        dashed = label.replace("_", "-")
        stem, _, gen = label.rpartition("_")
        out += [label, dashed, dashed + "-7f9c", f"pod-{dashed}-0"]
        if stem and gen in ("V5E", "V5P"):
            out.append(f"{stem.replace('_', '-')}-0_{gen}")
    return out


def test_table_lookups_equal():
    for name in ("configurations_train.tsv", "interference_train.tsv"):
        assert (seed_data("jax") / name).read_bytes() == \
            (seed_data("torch") / name).read_bytes()
        jt = mod("jax", "recommender.server")._Table(
            str(seed_data("jax") / name))
        tt = mod("torch", "recommender.server")._Table(
            str(seed_data("torch") / name))
        assert (jt.labels, jt.columns) == (tt.labels, tt.columns)
        assert jt.completed.tobytes() == tt.completed.tobytes()
        assert jt.version == tt.version
        reqs = requests_for(tt.labels)
        got = [tt.lookup(r) for r in reqs]
        assert [jt.lookup(r) for r in reqs] == got
        assert sum(1 for r, _ in got if r) >= 4 * len(tt.labels)
    # The suffixed-pod fallback: a replica suffix inside the workload name.
    tt = mod("torch", "recommender.server")._Table(
        str(seed_data("torch") / "interference_train.tsv"))
    vals, cols = tt.lookup("llama3-8b-serve-0_V5E")
    assert vals[cols.index("resnet50_train")] == 118.0


def test_load_matrix_equal_on_ragged_rows(tmp_path):
    p = tmp_path / "m.tsv"
    p.write_text("w\ta\tb\tc\nx\t1\t\ty\nshort\t2\n\n \t3\nz\t4\t5\t6\t7\n")
    j = mod("jax", "recommender.server").load_matrix(str(p))
    t = mod("torch", "recommender.server").load_matrix(str(p))
    assert j[:2] == t[:2] and j[2].tobytes() == t[2].tobytes()
    assert t[0] == ["x", "short", "z"]


def test_md5_hot_swap(tmp_path):
    """The retrain thread swaps the serving model when the file's md5
    changes; the swapped reply equals the JAX table's on the new file."""
    conf, intf = tmp_path / "conf.tsv", tmp_path / "intf.tsv"
    conf.write_text("workload\t1P_V5E\t2P_V5E\njob_a\t100\t\njob_b\t40\t21\n")
    intf.write_text("pair\tjob_a\njob_a_V5E\t5\n")
    tables = {s: mod(s, "recommender.server")._Table(str(conf)) for s in ROOTS}
    srv = mod("torch", "recommender.server").RecommenderServer(
        str(conf), str(intf), port=0, retrain_interval_s=0.05).start()
    try:
        with mod("torch", "recommender.client").Client(
                port=srv.port, cache_ttl_s=0.0) as c:
            assert c.impute_configurations("job_a")["1P_V5E"] == 100.0
            conf.write_text(
                "workload\t1P_V5E\t2P_V5E\njob_a\t250\t\njob_b\t40\t21\n")
            deadline = time.monotonic() + 10
            while c.impute_configurations("job_a")["1P_V5E"] != 250.0:
                assert time.monotonic() < deadline, "no hot swap"
                time.sleep(0.02)
            swapped = c.impute_configurations("job_a")
        for side, t in tables.items():
            assert t.refresh() is True and t.refresh() is False, side
        vals, cols = tables["jax"].lookup("job_a")
        assert tables["torch"].lookup("job_a") == (vals, cols)
        # The reply carries float32 on the wire.
        assert swapped == {c: float(np.float32(v)) for c, v in zip(cols, vals)}
        assert srv.configurations.version == tables["jax"].version
    finally:
        srv.stop()


# -- the collector ------------------------------------------------------------

class KV:
    """Dict-backed registry (set/get/get_keys)."""

    def __init__(self):
        self.data = {}

    def set(self, key, value):
        self.data[key] = value

    def get(self, key):
        return self.data.get(key)

    def get_keys(self, pattern="*"):
        return sorted(k for k in self.data if k.startswith(pattern.rstrip("*")))


def collector_script(rng):
    """Three passes of registry writes: (key, raw value) each, made with
    the JAX package's ``Observation`` (the port must read the same
    bytes)."""
    inv = mod("jax", "registry.inventory")

    def obs(workload, column, qps, at, neighbors=(), p99=0.0):
        key = inv.observed_key(workload, column, co_located=bool(neighbors))
        return key, inv.Observation(workload, column, qps, at,
                                    neighbors=sorted(neighbors),
                                    p99_ms=p99).to_json()
    q = [float(round(v, 3)) for v in rng.uniform(1, 4000, 12)]
    return [
        [obs("llama3_8b_serve", "4P_V5E", q[0], 1.0, p99=40.5),
         obs("mixtral_serve", "1P_V5E", q[1], 1.0, p99=12.0),
         obs("gpt2_infer", "3P_V5E", q[2], 1.0),              # unknown column
         obs("bert_base_infer", "1P_V5E", q[3], 1.0,
             neighbors=["llama3_8b_serve", "gpt2_infer"], p99=9.0),
         obs("new_job", "2P_V5E", q[4], 1.0, neighbors=["t5_base_infer"],
             p99=30.0),                                        # deferred
         ("observed/bad/1P_V5E", "{not json")],
        [obs("llama3_8b_serve", "4P_V5E", q[5], 2.0, p99=80.25),
         obs("new_job", "2P_V5E", q[6], 2.0),                  # its baseline
         obs("resnet50_train", "8P_V5E", q[7], 2.0, neighbors=["sd_unet_step"])],
        [],                                                    # nothing new
    ]


def test_collector_folds_to_identical_files(tmp_path):
    script = collector_script(np.random.default_rng(7))
    runs = {}
    for side in ROOTS:
        d = tmp_path / side
        d.mkdir()
        conf, intf = d / "conf.tsv", d / "intf.tsv"
        shutil.copy(seed_data(side) / "configurations_train.tsv", conf)
        shutil.copy(seed_data(side) / "interference_train.tsv", intf)
        reg = KV()
        col = mod(side, "recommender.collector").Collector(
            reg, str(conf), interval_s=999, interference_path=str(intf))
        steps = []
        for writes in script:
            for k, v in writes:
                reg.set(k, v)
            steps.append((col.collect_once(), conf.read_bytes(),
                          intf.read_bytes(),
                          {k: v for k, v in reg.data.items()
                           if k.startswith("latency/")}))
        runs[side] = steps
    assert runs["jax"] == runs["torch"]
    changed = [s[0] for s in runs["torch"]]
    assert changed == [True, True, False]
    assert b"mixtral_serve" in runs["torch"][0][1]
    assert b"new_job_V5E" in runs["torch"][1][2]          # deferred, folded
    assert runs["torch"][1][3]["latency/llama3_8b_serve/4P_V5E"] == \
        f"{0.5 * 80.25 + 0.5 * 40.5:g}"


def test_collector_thread_and_outage(tmp_path):
    class Down(KV):
        def get_keys(self, pattern="*"):
            raise ConnectionError("registry down")

    conf = tmp_path / "conf.tsv"
    shutil.copy(seed_data("torch") / "configurations_train.tsv", conf)
    C = mod("torch", "recommender.collector").Collector
    assert C(Down(), str(conf)).collect_once() is False
    reg = KV()
    mod("torch", "recommender.collector").publish_observation(
        reg, "llama3_8b_serve", "4P_V5E", 4.5)     # a blank seed cell
    load = mod("torch", "recommender.server").load_matrix
    col = C(reg, str(conf), interval_s=0.02).start()
    try:
        deadline = time.monotonic() + 5
        while True:
            labels, cols, X = load(str(conf))
            if X[labels.index("llama3_8b_serve"), cols.index("4P_V5E")] == 4.5:
                break
            assert time.monotonic() < deadline, "the thread folded nothing"
            time.sleep(0.01)
    finally:
        col.stop()
    assert col._thread is None


# -- gRPC across packages -------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    out = {}
    for side in ROOTS:
        out[side] = mod(side, "recommender.server").RecommenderServer(
            configurations_path=str(seed_data(side) / "configurations_train.tsv"),
            interference_path=str(seed_data(side) / "interference_train.tsv"),
            port=0, retrain_interval_s=60.0).start()
    yield out
    for s in out.values():
        s.stop()


def test_grpc_across_packages(servers):
    table = mod("torch", "recommender.server")._Table(
        str(seed_data("torch") / "configurations_train.tsv"))
    intf = mod("torch", "recommender.server")._Table(
        str(seed_data("torch") / "interference_train.tsv"))
    reqs = requests_for(table.labels) + requests_for(intf.labels)
    replies = {}
    for client_side in ROOTS:
        for server_side in ROOTS:
            with mod(client_side, "recommender.client").Client(
                    port=servers[server_side].port) as c:
                replies[client_side, server_side] = [
                    (c.impute_configurations(r), c.impute_interference(r))
                    for r in reqs]
    first = replies["jax", "jax"]
    assert all(v == first for v in replies.values())
    assert sum(1 for a, _ in first if a) > len(table.labels)
    a, _ = replies["torch", "torch"][reqs.index("bert-base-infer-7f9c")]
    assert a["1P_V5E"] == 3900.0 and np.isfinite(a["4P_V5P"])
    find = mod("torch", "recommender.client").find_max_index
    jfind = mod("jax", "recommender.client").find_max_index
    for preds, _ in first:
        for sub in ("", "V5E", "V5P", "8P", "nosuch"):
            assert find(preds, sub) == jfind(preds, sub)


def counting_client(side, port, **kw):
    c = mod(side, "recommender.client").Client(port=port, **kw)
    calls = {"n": 0, "fail": False}
    orig = c._conf

    def counted(index, timeout=None):
        calls["n"] += 1
        if calls["fail"]:
            raise RuntimeError("transient")
        return orig(index, timeout=timeout)
    c._conf = counted
    return c, calls


def test_client_ttl_cache_and_no_error_caching(servers):
    port = servers["torch"].port
    c, calls = counting_client("torch", port, cache_ttl_s=60.0)
    with c:
        a = c.impute_configurations("bert-base-infer")
        assert c.impute_configurations("bert-base-infer") == a
        assert calls["n"] == 1                       # second hit cached
        c.impute_configurations("resnet50-train")
        assert calls["n"] == 2                       # another index: a miss
        assert c.impute_interference("bert-base-infer") != a
        assert calls["n"] == 2                       # its own channel and key
        again = c.impute_configurations("bert-base-infer")
        again["1P_V5E"] = -1.0                       # callers own their dict
        assert c.impute_configurations("bert-base-infer")["1P_V5E"] == 3900.0
        calls["fail"] = True
        with pytest.raises(RuntimeError):
            c.impute_configurations("gpt2-infer")
        calls["fail"] = False
        assert c.impute_configurations("gpt2-infer")["1P_V5E"] == 990.0
    c, calls = counting_client("torch", port, cache_ttl_s=0.0)
    with c:
        c.impute_configurations("bert-base-infer")
        c.impute_configurations("bert-base-infer")
        assert calls["n"] == 2                       # ttl 0: no memo


def test_bounded_retry_through_the_fault_hook(servers):
    """A ``drop`` at ``recommender.call`` retries under the policy, counts
    on ``on_retry``, and gives the same reply; past the attempt cap it
    raises, as JAX's does."""
    out = {}
    for side in ROOTS:
        faults = mod(side, "testing.faults")
        retry = mod(side, "utils.retry")
        inj = faults.FaultInjector(0, rules=[faults.FaultRule(
            site="recommender.call", kind="drop", at=[1, 3, 4, 5])])
        retries = []
        with mod(side, "recommender.client").Client(
                port=servers[side].port, cache_ttl_s=0.0, fault_injector=inj,
                on_retry=lambda: retries.append(1),
                retry=retry.RetryPolicy(attempts=3, base_s=0.001,
                                        max_s=0.002, deadline_s=5.0)) as c:
            first = c.impute_configurations("t5-base-infer")
            with pytest.raises(faults.InjectedFault):
                c.impute_configurations("t5-base-infer")
        out[side] = (first, len(retries), inj.log)
    assert out["jax"] == out["torch"]
    assert out["torch"][1] == 3 and out["torch"][0]["1P_V5E"] == 640.0


# -- the Prometheus client ------------------------------------------------------

def test_parse_response_equal_on_golden():
    raw = pathlib.Path(GOLDEN).read_bytes()
    j = [dataclasses.asdict(s) for s in mod("jax", "metrics").parse_response(raw)]
    t = [dataclasses.asdict(s) for s in mod("torch", "metrics").parse_response(raw)]
    assert j == t and len(t) == 4
    tm = mod("torch", "metrics")
    assert tm.parse_response(None) == tm.parse_response(b"") == []
    for bad in (b'{"status": "error", "error": "query parse error"}',
                b"<html>not prometheus</html>",
                b'{"status": "success", "data": {"resultType": "matrix"}}'):
        with pytest.raises(tm.MetricsError):
            tm.parse_response(bad)
    assert mod("jax", "metrics").TPU_SERIES == tm.TPU_SERIES


def test_prom_client_against_one_stub():
    stub = MockProm()
    try:
        out = {}
        for side in ROOTS:
            c = mod(side, "metrics").PromClient(stub.url + "/", timeout_s=2.0)
            series = mod(side, "metrics").TPU_SERIES
            out[side] = (
                c.base_url,
                [c.query_url(q) for q in series + ['x{node="a b"}', "up"]],
                {k: [dataclasses.asdict(s) for s in v]
                 for k, v in c.tpu_metrics_for_node("v5e-node-0").items()},
                {k: [dataclasses.asdict(s) for s in v]
                 for k, v in c.tpu_metrics().items()},
                [c.node_duty_cycle(n) for n in ("v5e-node-0", "v5e-node-1",
                                                "nosuch")])
        assert out["jax"] == out["torch"]
        duty = out["torch"][4]
        assert duty[2] is None and all(isinstance(d, float) for d in duty[:2])
        n = len(stub.received)
        assert n == 2 * (2 * len(mod("torch", "metrics").TPU_SERIES) + 3)
    finally:
        stub.stop()
    dead = mod("torch", "metrics").PromClient("http://127.0.0.1:1",
                                              timeout_s=0.5)
    with pytest.raises(mod("torch", "metrics").MetricsError):
        dead.instant_query("up")
    assert dead.fan_out(["up", "down"]) == {"up": [], "down": []}


# -- SLO placements with the real recommender clients ---------------------------

def slo_mixed64():
    """The 64-node mixed cluster, its llama and bert pods named after the
    seed matrices' workloads (the scorer asks the recommender by pod
    name; ``WORKLOAD_NAME`` names the interference column), so the SLO
    scorer reads real predictions and interference rows."""
    from test_torch_sched_placement import mixed64

    spec = mixed64()
    names = {"llama": "llama3_8b_serve", "bert": "bert_base_infer"}
    for wave in spec["waves"]:
        for p in wave:
            kind, _, i = p["name"].partition("-")
            if kind in names:
                p["name"] = f"{names[kind].replace('_', '-')}-{i}"
                p["env"]["WORKLOAD_NAME"] = names[kind]
    return spec


@pytest.mark.parametrize("cluster", ["demo", "mixed64"])
def test_slo_placements_equal_with_real_recommender(cluster, servers):
    from test_torch_sched_placement import (
        check_invariants, inventory, run, without_neighbors)

    spec = slo_mixed64() if cluster == "mixed64" else None
    out = {}
    for side in ROOTS:
        client = mod(side, "recommender.client").Client(
            port=servers[side].port)
        calls = []
        real = client.impute_configurations

        def counted(index, real=real, calls=calls):
            calls.append(index)
            return real(index)
        client.impute_configurations = counted
        registry = {} if spec is None else inventory(
            side, spec["nodes"], np.random.default_rng(spec["seed"]),
            spec["skip"])
        try:
            res = run(side, spec, registry, demo=spec is None,
                      recommender=client)
        finally:
            client.close()
        check_invariants(side, res, spec)
        out[side] = res
        res["calls"] = calls
    j, t = out["jax"], out["torch"]
    assert j["placements"] == t["placements"]
    assert j["order"] == t["order"]
    assert without_neighbors(j["configmaps"]) == \
        without_neighbors(t["configmaps"])
    assert j["victims"] == t["victims"]
    assert j["preemptions"] == t["preemptions"]
    assert j["groups"] == t["groups"]
    assert all(t["placements"].values())
    for res in (j, t):
        assert res["sched"].metrics.counter(
            "tpu_sched_score_degraded_total").value(client="recommender") == 0
    assert sorted(set(j["calls"])) == sorted(set(t["calls"]))
    if cluster == "mixed64":
        assert any("llama3_8b_serve" in c.replace("-", "_")
                   for c in t["calls"])
