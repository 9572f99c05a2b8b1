"""The port's scheduler plugins against the JAX package's, formula by
formula: the SLO slack terms and their blend over a seeded grid (floats
equal bit for bit), the interference match, the SLO parses, min-max
normalization, and one node's whole decision (partition, right-sizing,
sharing limits, utilization score with the ``_UNFETCHED`` registry
sentinel and the Prometheus fallback) through test doubles of the
recommender and Prometheus clients (``tests/test_torch_recommender.py``
holds the real clients across the packages)."""
import importlib

import numpy as np
import pytest

ROOTS = {"jax": "k8s_gpu_scheduler_tpu", "torch": "k8s_gpu_scheduler_tpu_torch"}


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def grid(seed, n=4000):
    rng = np.random.default_rng(seed)
    slo = rng.choice([0.5, 1.0, 10.0, 37.5, 100.0, 1e3], n) * \
        rng.uniform(0.1, 3.0, n)
    pred = rng.uniform(0.0, 200.0, n)
    intf = rng.choice([0.0, 1.0], n) * rng.uniform(0.0, 80.0, n)
    # Exact boundaries too: slack 0 (slo == pred - intf).
    pred[:50] = slo[:50] + intf[:50]
    return [(float(a), float(b), float(c)) for a, b, c in zip(slo, pred, intf)]


@pytest.mark.parametrize("seed", range(3))
def test_slo_slack_terms_and_blend_equal_bit_for_bit(seed):
    jt, tt = mod("jax", "plugins.tpu"), mod("torch", "plugins.tpu")
    rows = grid(seed)
    js = [jt.slo_slack_terms(*r) for r in rows]
    ts = [tt.slo_slack_terms(*r) for r in rows]
    assert js == ts
    assert {v for _, v in ts} == {True, False}
    rng = np.random.default_rng(seed)
    for _ in range(2000):
        k = int(rng.integers(0, 6))
        idx = rng.integers(0, len(rows), k)
        pos = [js[i][0] for i in idx if not js[i][1]]
        neg = [js[i][0] for i in idx if js[i][1]]
        args = (sum(pos), len(pos), sum(neg), len(neg))
        a, b = jt.combine_terms(*args), tt.combine_terms(*args)
        assert a == b and (np.isnan(a) or a.hex() == b.hex())


def test_interference_match_and_slo_parses_equal():
    out = {}
    for side in ROOTS:
        t, o = mod(side, "plugins.tpu"), mod(side, "api.objects")
        intf = {"llama_serve": 3.5, "bert": 1.25, "resnet_50": 7.0}
        names = ["llama-serve-0", "bert-large-1", "resnet-50-x", "gpt-2",
                 "llama_serve", ""]

        def pod(env):
            return o.Pod(spec=o.PodSpec(containers=[o.Container(
                env=[o.EnvVar(k, v) for k, v in env.items()])]))
        envs = [{}, {"SLO": "12.5"}, {"SLO": "x"}, {"SLO": ""},
                {"SLO_P99_MS": "250"}, {"SLO_P99_MS": "nan?"},
                {"SLO": "3", "SLO_P99_MS": "40"}]
        out[side] = ([t.match_interference(intf, n) for n in names],
                     [(t.pod_slo(pod(e)), t.pod_latency_slo(pod(e)))
                      for e in envs],
                     [t.TPUPlugin._workload_of(o.Pod(
                         metadata=o.ObjectMeta(name=n),
                         spec=o.PodSpec(containers=[o.Container(
                             env=[o.EnvVar("WORKLOAD_NAME", "w")]
                             if n == "gpt-2" else [])])))
                      for n in names if n],
                     [getattr(t, k) for k in dir(t) if k.startswith("ENV_")])
    assert out["jax"] == out["torch"]


class FakeRecommender:
    """The recommender's ``PredictionClient`` protocol: canned rows whose
    key is a substring of the (dash-normalized) index; ``fail`` makes
    every call raise, as a client whose retries are spent."""

    def __init__(self, conf, intf, fail=False):
        self.conf, self.intf, self.fail = conf, intf, fail

    def _row(self, table, index):
        if self.fail:
            raise ConnectionError("recommender down")
        for key, row in table.items():
            if key in index.replace("-", "_"):
                return dict(row)
        return {}

    def impute_configurations(self, index):
        return self._row(self.conf, index)

    def impute_interference(self, index):
        return self._row(self.intf, index)


class FakeProm:
    """The Prometheus client's ``node_duty_cycle`` (0..100 a node)."""

    def __init__(self, duty):
        self.duty = duty

    def node_duty_cycle(self, node):
        if node == "boom":
            raise RuntimeError("prometheus down")
        return self.duty.get(node)


class MemRegistry:
    """In-memory registry with the RESP client's surface."""

    def __init__(self, data):
        self.data = dict(data)

    def ping(self):
        return True

    def get(self, key):
        return self.data.get(key)

    def set(self, key, value):
        self.data[key] = value

    def get_keys(self, pattern="*"):
        return [k for k in self.data if k.startswith(pattern.rstrip("*"))]


def decision_world(side, seed, recommender, prom, annotate, inventory):
    """One v5e or v5p node with a few residents, scored for one incoming
    pod by a bare TPUPlugin: (decision fields, raw score, normalized
    scores) per node."""
    o = mod(side, "api.objects")
    t = mod(side, "plugins.tpu")
    inv_mod = mod(side, "registry.inventory")
    sched = mod(side, "sched")
    cl = mod(side, "cluster")
    rng = np.random.default_rng(seed)
    server = cl.APIServer()
    cache = sched.Cache()
    reg = {}
    nodes = []
    for i, (gen, topo, chips) in enumerate(
            [("tpu-v5-lite-podslice", "2x4", 8), ("tpu-v5p-slice", "2x2x1", 4),
             ("tpu-v6e-slice", "2x4", 8), ("tpu-v4-podslice", "2x2x2", 4),
             ("tpu-v5-lite-podslice", "4x4", 4)]):
        name = f"n{i}"
        ann = {}
        if annotate and i < 4:
            cfgs = mod(side, "api.topology").SLICE_CONFIGS[
                mod(side, "api.topology").TPUGen(gen)]
            ann[o.ANN_SLICE_CONFIG] = cfgs[int(rng.integers(0, len(cfgs)))][0]
        node = o.Node(metadata=o.ObjectMeta(name=name, annotations=ann, labels={
            o.LABEL_TPU_ACCELERATOR: gen, o.LABEL_TPU_TOPOLOGY: topo}),
            status=o.NodeStatus(allocatable={o.TPU_RESOURCE: chips}))
        server.create(node)
        cache.add_node(node)
        nodes.append(name)
        if inventory and i != 2:
            reg[inv_mod.node_key(name)] = inv_mod.NodeInventory(
                node_name=name, utilization=float(rng.random()),
                chips=[inv_mod.ChipInfo(
                    device_id=c, duty_cycle=float(rng.random()),
                    hbm_used_bytes=int(rng.integers(0, 8 << 30)),
                    hbm_total_bytes=(16 << 30) if i % 2 == 0 else (95 << 30))
                    for c in range(chips)]).to_json()
        # Residents, with SLOs and ConfigMaps naming their partition.
        for r in range(int(rng.integers(0, 3))):
            pname = ("llama-serve", "bert", "resnet-50")[r] + f"-{i}"
            server.create(o.ConfigMap(metadata=o.ObjectMeta(name=f"cm-{pname}"),
                                      data={name: f"part-{r % 2}/x"}))
            pod = o.Pod(metadata=o.ObjectMeta(name=pname, uid=f"u-{pname}"),
                        spec=o.PodSpec(node_name=name, containers=[o.Container(
                            env=[o.EnvVar("SLO", str(5.0 + 10 * r))],
                            env_from=[o.ConfigMapRef(f"cm-{pname}")],
                            resources=o.ResourceRequirements(
                                requests={o.TPU_RESOURCE: 1}))]))
            cache.add_pod(pod)
    reg[inv_mod.latency_key("llama_serve", "2P_V5E")] = "300"
    reg[inv_mod.latency_key("llama_serve", "4P_V5E")] = "80"
    handle = sched.Handle(cl.SharedInformerFactory(server),
                          cl.Descriptor(server), cache,
                          mod(side, "config").SchedulerConfig())
    plugin = t.TPUPlugin(handle, registry=MemRegistry(reg) if inventory else None,
                         prom=prom, recommender=recommender)
    out = []
    for chips, slo, p99 in ((1, "40", ""), (2, "", "100"), (4, "15", "100"),
                            (0, "", ""), (2, "500", "")):
        env = [o.EnvVar("SLO", slo)] if slo else []
        if p99:
            env.append(o.EnvVar("SLO_P99_MS", p99))
        pod = o.Pod(metadata=o.ObjectMeta(name="llama-serve-9", uid="u-in"),
                    spec=o.PodSpec(containers=[o.Container(
                        env=env, resources=o.ResourceRequirements(
                            requests={o.TPU_RESOURCE: chips}))]))
        state = sched.CycleState()
        assert plugin.pre_filter(state, pod).ok
        snap = cache.snapshot()
        verdicts = {n: plugin.filter(state, pod, snap[n]) for n in nodes}
        scores = {}
        for n in nodes:
            d, raw = plugin._decide(state, pod, n)
            part = d.partition
            out.append((n, chips, slo, p99, verdicts[n].code, raw,
                        None if part is None else (part.key, part.chip_ids),
                        d.rightsized_config, d.accelerator,
                        d.hbm_limit_bytes, d.duty_pct))
            if verdicts[n].ok:
                scores[n] = plugin.score(state, pod, n)[0]
        plugin.normalize_scores(state, pod, scores)
        out.append(sorted(scores.items()))
    out.append([plugin._utilization_score(n) for n in nodes + ["boom"]])
    return out


CONF = {"llama_serve": {"1P_V5E": 30.0, "2P_V5E": 60.0, "4P_V5E": 120.0,
                        "8P_V5E": 45.0, "1P_V5P": 80.0, "2P_V5P": 20.0,
                        "4P_V6E": 10.0, "2P_V4": 41.0},
        "bert": {"1P_V5E": 4.0, "2P_V5E": 9.0, "4P_V5P": 11.0},
        "resnet_50": {"2P_V5E": 200.0},
        "2x2": {"2P_V5E": 70.0, "2P_V6E": 20.0}, "1x2": {"4P_V5E": 44.0},
        "2x1x1": {"2P_V5P": 300.0}}
INTF = {"llama_serve": {"bert": 2.0, "resnet_50": 5.5},
        "bert": {"llama_serve": 1.0}}


@pytest.mark.parametrize("case", ["slo", "no-recommender", "recommender-down",
                                  "no-registry", "unannotated"])
@pytest.mark.parametrize("seed", range(3))
def test_node_decisions_equal(case, seed):
    """Decisions through every branch of ``_decide``: the SLO loop with
    its latency overlay, utilization scoring, a failing recommender, no
    registry (the Prometheus fallback), whole-board partitions."""
    def run(side):
        rec = None if case in ("no-recommender", "no-registry") else \
            FakeRecommender(CONF, INTF, fail=case == "recommender-down")
        prom = FakeProm({"n0": 35.0, "n2": 150.0, "n3": -4.0})
        return decision_world(side, seed, rec, prom,
                              annotate=case != "unannotated",
                              inventory=case != "no-registry")
    j, t = run("jax"), run("torch")
    assert j == t
    decided = [r for r in t if isinstance(r, tuple)]
    assert any(r[6] is not None for r in decided)
    if case == "slo":
        assert any(r[7] for r in decided)       # a right-sizing was chosen
        assert any(r[10] < 100 for r in decided)  # and a sharing cap


def test_normalize_scores_equal():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(0, 6))
        raw = {f"n{i}": float(rng.choice([rng.random() * 100, 50.0]))
               for i in range(n)}
        got = []
        for side in ROOTS:
            t = mod(side, "plugins.tpu")
            scores = dict(raw)
            t.TPUPlugin.normalize_scores(None, None, None, scores)
            got.append(scores)
        assert got[0] == got[1]
