"""The port's ``parallel/`` package against the JAX package's: mesh
shapes, the sharding rules and specs (a ``PartitionSpec`` of JAX is a
tuple of axis names here), the weight specs of the serving islands, the
gang bootstrap from the scheduler's env, and the spawner of local worlds.
Everything pure is compared value for value with JAX; the meshes are
built in a gloo world of CPU processes (``tests/torch_tp_workers.py``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu.ops.quant import quantize_llama_params as j_quant
from k8s_gpu_scheduler_tpu.parallel import distributed as jdist
from k8s_gpu_scheduler_tpu.parallel import mesh as jmesh
from k8s_gpu_scheduler_tpu.parallel import sharding as jsharding
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models import llama
from k8s_gpu_scheduler_tpu_torch.ops.quant import (
    Int8Weight, quantize_llama_params,
)
from k8s_gpu_scheduler_tpu_torch.parallel import distributed, sharding, spawn
from k8s_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from test_torch_serving import configs
from torch_tp_workers import world_meshes, world_sleeps


def as_tuples(tree):
    """A JAX spec tree with each ``PartitionSpec`` as a tuple."""
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("n,kw", [
    (8, {}), (8, dict(tp=2)), (8, dict(fsdp=2, tp=2)),
    (16, dict(fsdp=2, sp=2, ep=2, tp=2)), (4, dict(tp=4)), (6, dict(tp=4))])
def test_mesh_spec_for_devices_is_jaxs(n, kw):
    try:
        want = jmesh.MeshSpec.for_devices(n, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshSpec.for_devices(n, **kw)
        assert str(got.value) == str(e)
        return
    got = MeshSpec.for_devices(n, **kw)
    assert got.axes == want.axes
    assert (got.names, got.shape, got.size) == (want.names, want.shape,
                                                want.size)


def test_rules_tables_are_jaxs():
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    assert sharding.KV_POOL_AXES == jsharding.KV_POOL_AXES
    assert sharding.WEIGHT_SPECS == jsharding.WEIGHT_SPECS
    assert (sharding.WEIGHT_COLUMN_DIM, sharding.WEIGHT_ROW_DIM) == (
        jsharding.WEIGHT_COLUMN_DIM, jsharding.WEIGHT_ROW_DIM)
    over = {"layers": None, "embed": None, "seq": ("sp", "tp")}
    assert sharding.logical_axis_rules() == jsharding.logical_axis_rules()
    assert sharding.logical_axis_rules(over) == \
        jsharding.logical_axis_rules(over)


@pytest.mark.parametrize("axes", [
    jsharding.KV_POOL_AXES, ("batch", "seq", "embed"), ("vocab", "embed"),
    ("layers", "expert", "embed", "mlp"), ("unknown", "heads")])
def test_spec_for_is_jaxs(axes):
    for rules in (jsharding.DEFAULT_RULES,
                  jsharding.logical_axis_rules({"embed": None})):
        assert sharding.spec_for(axes, rules) == \
            tuple(jsharding.spec_for(axes, rules))


def test_weight_slice_spec_is_jaxs():
    for kind in ("column", "row"):
        assert sharding.weight_slice_spec(kind) == \
            tuple(jsharding.weight_slice_spec(kind))
    rules = jsharding.logical_axis_rules({"kv_heads": "model"})
    assert sharding.weight_slice_spec("row", rules) == \
        tuple(jsharding.weight_slice_spec("row", rules)) == (None, "model",
                                                              None)
    with pytest.raises(ValueError) as got:
        sharding.weight_slice_spec("diagonal")
    with pytest.raises(ValueError) as want:
        jsharding.weight_slice_spec("diagonal")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_param_specs_are_jaxs(moe):
    jcfg, cfg = configs()
    if moe:
        jcfg = dataclasses.replace(jcfg, n_experts=4)
        cfg = dataclasses.replace(cfg, n_experts=4)
    assert llama.param_axes(cfg) == jllama.param_axes(jcfg)
    assert llama.param_specs(cfg) == as_tuples(jllama.param_specs(jcfg))
    rules = jsharding.logical_axis_rules({"layers": None, "embed": None})
    assert llama.param_specs(cfg, rules) == as_tuples(
        jllama.param_specs(jcfg, rules))
    assert sharding.shard_params_spec(llama.param_axes(cfg)) == as_tuples(
        jsharding.shard_params_spec(jllama.param_axes(jcfg)))


@pytest.fixture(scope="module")
def trees():
    jcfg, cfg = configs()
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    qtree = jax.tree.map(np.asarray, j_quant(params))
    return cfg, params, tree, qtree


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
def test_serving_weight_specs_are_jaxs(trees, int8):
    """On the JAX tree and on the port's model built from it: column
    slices on N, row slices on K, an int8 row slice's scale whole."""
    cfg, params, tree, qtree = trees
    src = j_quant(params) if int8 else params
    want = as_tuples(jllama.serving_weight_specs(src))
    assert llama.serving_weight_specs(qtree if int8 else tree) == want
    model = params_from_numpy(tree, cfg, "cpu")
    if int8:
        model = quantize_llama_params(model)
    assert llama.serving_weight_specs(model) == want


def test_serving_weight_specs_refuse_moe_as_jax():
    jcfg, cfg = configs()
    jcfg = dataclasses.replace(jcfg, n_experts=2, moe_top_k=1)
    with pytest.raises(ValueError, match="MoE") as want:
        jllama.serving_weight_specs(
            jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    model = llama.init_params(dataclasses.replace(cfg, n_experts=2,
                                                  moe_top_k=1),
                              torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError) as got:
        llama.serving_weight_specs(model)
    assert str(got.value) == str(want.value)
    assert llama.sliced_weight_bytes(model) == 0


class FakeMesh:
    """The three things ``mesh_coords`` reads of a ``DeviceMesh``."""

    def __init__(self, tp, rank):
        self.mesh_dim_names = ("dp", "tp")
        self._size, self._rank = {"dp": 1, "tp": tp}, {"dp": 0, "tp": rank}

    def size(self, i):
        return self._size[self.mesh_dim_names[i]]

    def get_local_rank(self, name):
        return self._rank[name]


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("rank", [0, 1])
def test_rank_slices_of_the_bridge_and_the_engine_agree(trees, rank, int8):
    """``params_from_numpy(mesh=)`` cuts the numpy tree, and
    ``sliced_for_serving`` the full model, to the same rank-``rank``
    blocks: q/k/v/gate/up column blocks, o/down row blocks (an int8 row
    slice keeps its whole scale), everything else whole and shared."""
    cfg, _, tree, qtree = trees
    src = qtree if int8 else tree
    full = params_from_numpy(src, cfg, "cpu")
    by_bridge = params_from_numpy(src, cfg, "cpu", mesh=FakeMesh(2, rank))
    by_engine = llama.sliced_for_serving(full, {"tp": 2}, {"tp": rank})
    assert llama.sliced_for_serving(by_bridge, {"tp": 2},
                                    {"tp": rank}) is by_bridge
    for name in ("wq", "wk", "wv", "w_gate", "w_up", "wo", "w_down",
                 "attn_norm", "mlp_norm"):
        kind = sharding.WEIGHT_SPECS.get(name)
        for layer in range(cfg.n_layers):
            w = getattr(full.blocks[layer], name)
            a = getattr(by_bridge.blocks[layer], name)
            b = getattr(by_engine.blocks[layer], name)
            parts = ({"q": w.q, "s": w.s} if isinstance(w, Int8Weight)
                     else {"w": w})
            for key, t in parts.items():
                ta = a[key] if isinstance(a, Int8Weight) else a
                tb = b[key] if isinstance(b, Int8Weight) else b
                if kind == "column" or (kind == "row" and key != "s"):
                    dim = 1 if kind == "column" else 0
                    n = t.shape[dim] // 2
                    t = t.narrow(dim, rank * n, n)
                assert torch.equal(ta, t) and torch.equal(tb, t)
            if kind is None:
                assert b is w                      # shared, not copied
    assert by_engine.embed is full.embed
    assert torch.equal(by_bridge.lm_head if not int8 else
                       by_bridge.lm_head.q,
                       full.lm_head if not int8 else full.lm_head.q)
    assert llama.sliced_weight_bytes(by_engine) * 2 == \
        llama.sliced_weight_bytes(full)
    wq = full.blocks[0].wq
    assert tuple((wq.q if int8 else wq).shape) == (
        cfg.d_model, cfg.n_heads * cfg.head_dim)            # source kept


def test_rank_slice_cuts_numpy_and_tensors():
    a = np.arange(24).reshape(2, 4, 3)
    spec = (None, ("dp", "tp"), None)
    sizes, index = {"dp": 2, "tp": 2}, {"dp": 1, "tp": 0}
    np.testing.assert_array_equal(sharding.rank_slice(a, spec, sizes, index),
                                  a[:, 2:3])
    t = torch.as_tensor(a)
    assert torch.equal(sharding.rank_slice(t, (None, "tp"), sizes, index),
                       t[:, :2])
    assert torch.equal(sharding.rank_slice(t, (), sizes, index), t)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.rank_slice(a, (None, None, "tp"), sizes, index)


ENVS = [
    {},
    {"TPU_WORKER_HOSTNAMES": "w0.gang"},
    {"TPU_WORKER_HOSTNAMES": "w0.gang.svc,w1.gang.svc", "HOSTNAME": "w1"},
    {"TPU_WORKER_HOSTNAMES": "10.0.0.1,10.0.0.2", "HOSTNAME": "pod-x",
     "TPU_WORKER_ID": "1"},
    {"TPU_WORKER_HOSTNAMES": "a,b,c,", "HOSTNAME": "c",
     "TPU_WORKER_COUNT": "3"},
    {"TPU_WORKER_HOSTNAMES": "a,b", "HOSTNAME": "", "TPU_WORKER_ID": ""},
]


@pytest.mark.parametrize("env", ENVS)
def test_gang_env_is_read_as_jax_reads_it(env, monkeypatch):
    """worker_addresses, self_worker_id and the rendezvous that
    distributed_init_from_env starts: the port's init_process_group gets
    JAX's coordinator (worker 0 at the port), world size and rank, and
    the backend it is given."""
    addrs = distributed.worker_addresses(env)
    assert addrs == jdist.worker_addresses(env)
    assert distributed.self_worker_id(addrs, env) == \
        jdist.self_worker_id(addrs, env)
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.setdefault("jax", kw))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.setdefault(
                            "port", dict(kw, backend=backend)))
    ran = distributed.distributed_init_from_env(env, backend="gloo",
                                                coordinator_port=1234)
    assert ran == jdist.distributed_init_from_env(env,
                                                  coordinator_port=1234)
    if ran:
        j, p = seen["jax"], seen["port"]
        assert p == dict(backend="gloo",
                         init_method=f"tcp://{j['coordinator_address']}",
                         world_size=j["num_processes"], rank=j["process_id"])
    else:
        assert seen == {}


@pytest.mark.parametrize("env,local,want", [
    ({"TPU_WORKER_HOSTNAMES": "w0,w1", "HOSTNAME": "w1"}, (3, 4),
     ("tcp://w0:1234", 8, 7)),
    ({}, (1, 2), ("tcp://localhost:1234", 2, 1)),
    ({"TPU_WORKER_HOSTNAMES": "10.0.0.1,10.0.0.2,10.0.0.3",
      "TPU_WORKER_ID": "2"}, (0, 2), ("tcp://10.0.0.1:1234", 6, 4)),
    ({}, (0, 1), None),
], ids=["two-workers-of-4", "one-worker-of-2", "three-workers-of-2",
        "alone"])
def test_a_worker_runs_a_rank_a_card(env, local, want, monkeypatch):
    """A worker of ``local_size`` cards joins ``local_size`` ranks: the
    world is workers x cards, a rank's global rank worker id x cards +
    its card, the store worker 0's address (localhost for a worker
    alone); one rank alone joins nothing."""
    seen = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(kw))
    ran = distributed.distributed_init_from_env(
        env, backend="gloo", coordinator_port=1234, local_rank=local[0],
        local_size=local[1])
    assert ran == (want is not None)
    if want:
        assert (seen["init_method"], seen["world_size"], seen["rank"]) == \
            want


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(MeshSpec({"tp": 2}), "cpu")


def test_meshes_in_a_world_of_two(tmp_path):
    """make_mesh names its dims as MeshSpec does (tp innermost, JAX's
    mesh axes and shape) and multislice_mesh keeps JAX's axis order;
    each rank's tp coordinate is its rank."""
    outs = spawn(world_meshes, 2, "gloo", rendezvous=str(tmp_path / "rdv"),
                 timeout=120)
    jm = jmesh.make_mesh(jmesh.MeshSpec.for_devices(2, tp=2))
    js = jmesh.multislice_mesh(2)
    for rank, out in enumerate(outs):
        names, shape, coords, tp = out["for_devices"]
        assert names == tuple(jm.axis_names)
        assert shape == tuple(jm.devices.shape)
        assert coords["tp"] == rank and tp == 2
        names, shape, coords, tp = out["multislice"]
        assert names == tuple(js.axis_names)
        assert shape == tuple(js.devices.shape)
        assert coords["dp"] == rank and tp == 1
        assert out["too_big"] == "mesh {'tp': 3} needs 3 ranks, have 2"


def test_spawn_kills_a_world_past_its_timeout(tmp_path):
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not done after"):
        spawn(world_sleeps, 2, "gloo", rendezvous=str(tmp_path / "rdv"),
              timeout=5)
    assert time.monotonic() - t0 < 40
