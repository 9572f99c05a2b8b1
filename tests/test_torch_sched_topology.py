"""The port's object model and slice topology (``api/``) against the JAX
package's: every function of ``api/topology.py`` over each TPUGen and a
set of topology strings, the partition table, and the objects' helpers
and inventory JSON, exact."""
import dataclasses
import json

import numpy as np
import pytest

import k8s_gpu_scheduler_tpu.api.objects as jobj
import k8s_gpu_scheduler_tpu.api.topology as jtopo
import k8s_gpu_scheduler_tpu.registry.inventory as jinv
import k8s_gpu_scheduler_tpu_torch.api.objects as tobj
import k8s_gpu_scheduler_tpu_torch.api.topology as ttopo
import k8s_gpu_scheduler_tpu_torch.registry.inventory as tinv

TOPOLOGIES = ("1x1", "1x2", "2x2", "2x4", "4x4", "2x8", "16x16", "1x16",
              "4x8", "1x1x1", "2x1x1", "2x2x1", "2x2x2", "2x2x4", "4x4x4",
              "4x1x1", "8x8x16", "4x4x8", "3x3", "bad", "2xx2", "0x4", "")


def outcome(fn, *args):
    """A function's value, or the type of what it raised."""
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 — the refusal is the value
        return ("raises", type(e).__name__)
    if isinstance(out, tuple) and out and hasattr(out[0], "value"):
        return tuple(g.value for g in out)
    return out


def both(name, *args):
    """Call ``name`` in each package, generations passed by value."""
    def conv(mod, a):
        return mod.TPUGen(a.value) if isinstance(a, jtopo.TPUGen) else a
    return (outcome(getattr(jtopo, name), *args),
            outcome(getattr(ttopo, name), *[conv(ttopo, a) for a in args]))


def test_generations_and_partition_table_equal():
    assert [g.value for g in jtopo.TPUGen] == [g.value for g in ttopo.TPUGen]
    for g in jtopo.TPUGen:
        t = ttopo.TPUGen(g.value)
        for prop in ("chips_per_host", "host_topology", "torus_dims",
                     "peak_bf16_tflops", "hbm_gib"):
            assert getattr(g, prop) == getattr(t, prop), (g, prop)
        assert jtopo.SLICE_CONFIGS[g] == ttopo.SLICE_CONFIGS[t]
        assert jtopo.partitions_for(g) == ttopo.partitions_for(t)
        for parts in (1, 2, 3, 4, 8):
            j, t = both("config_for_partitions", g, parts)
            assert j == t, parts


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("gen", [g.value for g in jtopo.TPUGen])
def test_topology_functions_equal(gen, topo):
    g = jtopo.TPUGen(gen)
    j, t = both("parse_topology", topo)
    assert j == t
    dims = outcome(jtopo.parse_topology, topo)
    if dims and dims[0] == "raises":
        j = outcome(jtopo.SliceTopology.parse, gen, topo)
        t = outcome(ttopo.SliceTopology.parse, gen, topo)
        assert j == t == dims
        return
    for name, args in (("format_topology", (dims,)), ("chip_count", (dims,)),
                       ("slice_diameter", (dims, False)),
                       ("slice_diameter", (dims, True))):
        j, t = both(name, *args)
        assert j == t, name
    for name in ("host_board", "host_grid", "hosts_needed",
                 "host_coordinates"):
        j, t = both(name, dims, g)
        assert j == t, name
    js, ts = (outcome(jtopo.SliceTopology.parse, gen, topo),
              outcome(ttopo.SliceTopology.parse, gen, topo))
    for prop in ("chips", "hosts", "is_multi_host", "has_wraparound"):
        assert outcome(lambda: getattr(js, prop)) == \
            outcome(lambda: getattr(ts, prop)), prop
    assert outcome(js.diameter) == outcome(ts.diameter)
    # ICI hops between every pair of host coordinates of the slice, and
    # between seeded chip coordinates, with and without wraparound.
    coords = outcome(jtopo.host_coordinates, dims, g)
    grid = outcome(jtopo.host_grid, dims, g)
    if isinstance(coords, list):
        rng = np.random.default_rng(len(coords))
        pairs = [(a, b) for a in coords for b in coords][:256]
        chips = [tuple(int(rng.integers(0, d)) for d in dims)
                 for _ in range(32)]
        pairs += list(zip(chips, chips[::-1]))
        for wrap in (False, True):
            for a, b in pairs:
                space = grid if a in coords and b in coords else dims
                j, t = both("ici_hop_distance", a, b, space, wrap)
                assert j == t, (a, b, space, wrap)
    j, t = both("ici_hop_distance", (0, 1), (1,), (2, 2))
    assert j == t == ("raises", "ValueError")


def test_objects_helpers_and_kinds_equal():
    for name in ("TPU_RESOURCE", "LABEL_TPU_ACCELERATOR", "LABEL_TPU_TOPOLOGY",
                 "LABEL_NODEPOOL", "LABEL_POD_GROUP", "LABEL_SLICE_GROUP",
                 "LABEL_WORKER_INDEX", "ANN_SLICE_CONFIG",
                 "ANN_RESHAPE_STATE"):
        assert getattr(jobj, name) == getattr(tobj, name), name
    assert sorted(jobj._KINDS) == sorted(tobj._KINDS)
    for kind, cls in jobj._KINDS.items():
        tcls = tobj._KINDS[kind]
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(tcls)], kind
        assert tobj.kind_of(tcls()) == kind
    for mod in (jobj, tobj):
        pod = mod.Pod(
            metadata=mod.ObjectMeta(name="p", labels={
                mod.LABEL_POD_GROUP: "g"}),
            spec=mod.PodSpec(containers=[
                mod.Container(env=[mod.EnvVar("SLO", "12")],
                              resources=mod.ResourceRequirements(
                                  requests={mod.TPU_RESOURCE: 4})),
                mod.Container(resources=mod.ResourceRequirements(
                    limits={mod.TPU_RESOURCE: 2}))]))
        node = mod.Node(metadata=mod.ObjectMeta(name="n", labels={
            mod.LABEL_TPU_ACCELERATOR: "tpu-v5p-slice",
            mod.LABEL_TPU_TOPOLOGY: "2x2x2"}),
            status=mod.NodeStatus(allocatable={mod.TPU_RESOURCE: 4}))
        lease = mod.Lease(holder_identity="a", renew_time=10.0,
                          lease_duration_s=5.0)
        got = (pod.spec.tpu_chips(), pod.get_env("SLO"), pod.get_env("X"),
               pod.pod_group(), pod.metadata.key, node.tpu_capacity(),
               node.tpu_accelerator(), node.tpu_topology(),
               lease.expired(14.0), lease.expired(15.0))
        if mod is jobj:
            want = got
    assert got == want == (6, "12", None, "g", "default/p", 4,
                           "tpu-v5p-slice", "2x2x2", False, True)


def seeded_inventory(mod, rng, name):
    return mod.NodeInventory(
        node_name=name, accelerator="tpu-v5-lite-podslice", topology="2x4",
        chips=[mod.ChipInfo(device_id=c, coords=[c // 4, c % 4],
                            duty_cycle=float(rng.random()),
                            hbm_used_bytes=int(rng.integers(0, 1 << 34)),
                            hbm_total_bytes=16 << 30) for c in range(8)],
        worker_id=int(rng.integers(0, 4)),
        utilization=float(rng.random()),
        published_at=float(rng.random() * 1e9))


def test_inventory_json_crosses_byte_for_byte():
    """The state the two packages share through the registry: each
    package's inventory JSON, read by the other, writes back the same
    bytes; the key layout is the same."""
    for seed in range(8):
        j = seeded_inventory(jinv, np.random.default_rng(seed), f"n{seed}")
        t = seeded_inventory(tinv, np.random.default_rng(seed), f"n{seed}")
        assert j.to_json() == t.to_json()
        assert tinv.NodeInventory.from_json(j.to_json()).to_json() == \
            j.to_json()
        assert jinv.NodeInventory.from_json(t.to_json()).to_json() == \
            t.to_json()
        assert json.loads(t.to_json())["chips"][3]["coords"] == [0, 3]
    assert (jinv.node_key("a"), jinv.HEARTBEAT_SUFFIX, jinv.NODE_KEY_PREFIX) \
        == (tinv.node_key("a"), tinv.HEARTBEAT_SUFFIX, tinv.NODE_KEY_PREFIX)


class KV:
    def __init__(self):
        self.data = {}

    def get(self, key):
        return self.data.get(key)

    def set(self, key, value):
        self.data[key] = value

    def get_keys(self, pattern="*"):
        return [k for k in self.data if k.startswith(pattern.rstrip("*"))]


class KVWithMget(KV):
    def mget(self, *keys):
        assert len(keys) <= 512
        return [self.data.get(k) for k in keys]


@pytest.mark.parametrize("store", [KV, KVWithMget])
def test_publish_read_list_inventories_equal(store):
    """The agent's write and the scheduler's reads, across the packages:
    the port publishes, JAX reads, and the other way; heartbeats and
    garbage are skipped alike."""
    rng = np.random.default_rng(5)
    kv = store()
    for i in range(600):
        mod = tinv if i % 2 else jinv
        mod.publish_inventory(kv, seeded_inventory(mod, rng, f"node-{i}"))
        kv.set(mod.node_key(f"node-{i}") + mod.HEARTBEAT_SUFFIX, "1.5")
    kv.set(tinv.node_key("broken"), "{not json")
    jl, tl = jinv.list_inventories(kv), tinv.list_inventories(kv)
    assert sorted(jl) == sorted(tl) and len(tl) == 600
    assert all(jl[k].to_json() == tl[k].to_json() for k in jl)
    for name in ("node-7", "node-8", "broken", "absent"):
        j, t = jinv.read_inventory(kv, name), tinv.read_inventory(kv, name)
        assert (j is None) == (t is None)
        if j is not None:
            assert j.to_json() == t.to_json()
