"""Tensor-parallel paged serving in the port (``ContinuousBatcher(mesh=)``)
against its tp = 1 engine and against the JAX engine's tp islands.

The port runs in gloo worlds of CPU processes (``parallel.spawn``, a
``file://`` rendezvous under the test's temporary directory): a world of
2 runs every tp = 2 case in one spawn, a world of 4 the tp = 4 ones. The
rank workers are in ``tests/torch_tp_workers.py``, which imports no JAX.
The JAX engine runs its tp = 2 islands on two of the eight virtual CPU
devices ``tests/conftest.py`` sets. Weights are JAX's f32 tiny ones
(``init_params`` at key 0) carried by the bridge; the traffic is JAX's tp
tests' ``mixed_prompts``.

Tolerances: greedy streams are compared token for token (f32 weights; the
all_gather combine moves bytes only, and the psum streams agree on this
seed). The psum helper is held to the JAX test's bound for bf16 inputs
(rtol 5e-2, atol 8e-2 against the monolithic qdot) and, for f32 inputs,
to 1e-5 of the product's largest magnitude."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu_torch.parallel import WorldError, spawn
from test_torch_serving import configs
from torch_tp_workers import (
    BUILD, mixed_prompts, world_follower_fails, world_four, world_two,
)

# Port cells (engine kwargs; n_kv_heads goes to the config), each held
# to the port's tp = 1 engine.
CELLS = [
    ("plain", {}),
    ("int8", dict(kv_dtype="int8")),
    ("prefix", dict(prefix_cache=True)),
    ("spec", dict(speculative=True, gamma=2)),
    ("chunked", dict(prefix_cache=True, prefill_chunk_tokens=8)),
    ("int8-spec-prefix", dict(kv_dtype="int8", speculative=True, gamma=2,
                              prefix_cache=True)),
    ("sampled", dict(temperature=0.8, top_k=5)),
    ("gqa", dict(n_kv_heads=2)),
]
# Cells also held to the JAX engine's tp = 2 island (greedy, JAX weights).
JAX_CELLS = ["plain", "int8-spec-prefix", "chunked"]
SHED_SEED = 2


def jax_engine(params, jcfg, tp, **kw):
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
    build = {k: v for k, v in BUILD.items() if k != "device"}
    return JEngine(params, jcfg, mesh=mesh, **build, **kw)


@pytest.fixture(scope="module")
def jax_side():
    jcfg, cfg = configs()
    params = j_init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, tree, mixed_prompts(cfg.vocab)


@pytest.fixture(scope="module")
def jax_snapshot(jax_side):
    """The JAX tp = 2 engine drained after one step (its tokens so far,
    its snapshot's pytree) and its uninterrupted streams."""
    jcfg, _, params, _, prompts = jax_side
    eng = jax_engine(params, jcfg, 2, kv_dtype="int8")
    for p in prompts:
        eng.submit(p, max_new=6)
    done = dict(eng.step())
    snap = jax.tree.map(np.asarray, eng.drain().to_pytree())
    ref = jax_engine(params, jcfg, 2, kv_dtype="int8")
    for p in prompts:
        ref.submit(p, max_new=6)
    return done, snap, ref.run()


@pytest.fixture(scope="module")
def world2(jax_side, jax_snapshot, tmp_path_factory):
    _, cfg, _, tree, prompts = jax_side
    rng = np.random.default_rng(SHED_SEED)
    shed = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in (6, 9)]
    rdv = tmp_path_factory.mktemp("tp2") / "rdv"
    (out,) = spawn(world_two, 2, "gloo",
                   args=(tree, prompts, CELLS, jax_snapshot[1], shed),
                   rendezvous=str(rdv), timeout=240)[:1]
    return out


@pytest.fixture(scope="module")
def world4(jax_side, world2, tmp_path_factory):
    tree = jax_side[3]
    rdv = tmp_path_factory.mktemp("tp4") / "rdv"
    return spawn(world_four, 4, "gloo",
                 args=(tree, mixed_prompts(256, seed=3), world2["hop"][1]),
                 rendezvous=str(rdv), timeout=240)[0]


@pytest.mark.parametrize("cell", [c for c, _ in CELLS])
def test_tp2_streams_equal_tp1(world2, cell):
    """tp = 2 (all_gather combine, sliced weights; the plain cell's
    slices cut by the bridge) equals the port's tp = 1 engine token for
    token, with int8 KV, the prefix cache, speculation, chunked prefill,
    sampling and GQA (K1 at group 4 on 4/1 local heads)."""
    got, ref = world2["grid"][cell]
    assert got == ref and len(got) == 4
    assert all(len(s) == 4 for s in got.values())


@pytest.mark.parametrize("cell", JAX_CELLS)
def test_tp2_streams_equal_jax_tp2(jax_side, world2, cell):
    """The port's tp = 2 streams equal the JAX engine's tp = 2 island's."""
    jcfg, _, params, _, prompts = jax_side
    eng = jax_engine(params, jcfg, 2, **dict(CELLS)[cell])
    for p in prompts:
        eng.submit(p, max_new=4)
    assert world2["grid"][cell][0] == eng.run()


def test_tp1_mesh_serves_without_an_island(world2):
    """A mesh whose tp axis is 1 (here dp 2, ``MeshSpec.for_devices``'
    default) runs the single-card bodies: no island, every rank its own
    leader, the tp = 1 engine's streams."""
    no_island, leader, tp, streams = world2["tp1_mesh"]
    assert no_island and leader and tp == 1.0
    assert streams == world2["grid"]["plain"][1]


def test_psum_streams_and_tolerance(world2):
    got, ref, combine = world2["psum"]
    assert combine == "psum"
    assert got == ref
    for (dt, kind), (err, scale) in world2["psum_err"].items():
        if "bfloat16" in dt:
            assert err <= 8e-2 + 5e-2 * scale, (dt, kind, err)
        else:
            assert err <= 1e-5 * scale, (dt, kind, err)


def test_weight_sharding_off_equal_warned_once_and_counted(world2):
    streams, pm = world2["replicated"]
    assert streams == world2["grid"]["plain"][1]
    assert pm["tp_combine"] == "replicated"
    assert pm["weight_sliced_device_bytes"] == \
        world2["stats"][1]["weight_sliced_device_bytes"]
    assert world2["replicated_counts"] == {"weights_replicated": 2}
    assert world2["replicated_warnings"] == 1


def test_per_rank_pool_and_weight_bytes(world2):
    """A rank holds exactly half the tp = 1 pool and half the sliced
    weights; its total weight bytes shrink (embed, norms and lm_head stay
    whole)."""
    tp2, tp1 = world2["stats"][:2]
    assert tp2["tp"] == 2.0 and tp1["tp"] == 1.0
    assert tp2["kv_pool_device_bytes"] * 2 == tp1["kv_pool_device_bytes"]
    assert tp2["weight_sliced_device_bytes"] * 2 == \
        tp1["weight_sliced_device_bytes"] > 0
    assert tp2["weight_device_bytes"] < tp1["weight_device_bytes"]
    assert tp2["tp_combine"] == "all_gather" and tp1["tp_combine"] == "none"


def test_fingerprint_ignores_the_mesh(world2):
    assert world2["stats"][2] == world2["stats"][3]


def test_replica_stats_and_summary_carry_tp(world2):
    assert world2["stats"][4]["tp"] == 2
    assert world2["stats"][5] == 2


def test_snapshot_tp2_tp1_tp4(world2, world4):
    """drain on tp = 2 → restore on tp = 1 → drain → restore on tp = 4:
    every stream finishes as the uninterrupted tp = 1 run's."""
    done = dict(world2["hop"][0])
    done.update(world4["hop"][0])
    assert done == world2["hop_ref"]
    assert world4["hop"][1]["tp"] == 4.0


def test_jax_tp2_snapshot_restores_in_port(jax_snapshot, world2):
    done, _, ref = jax_snapshot
    done = dict(done)
    done.update(world2["jax_restore"])
    assert done == ref


@pytest.mark.parametrize("way", ["tp2->tp1", "tp1->tp2"])
def test_shed_absorbs_across_tp(world2, way):
    assert world2["shed"][way] == world2["shed"]["ref"]


def test_router_mixes_tp2_and_tp1(world2):
    streams, moved, tps = world2["shed"]["router"]
    assert moved == 1
    assert tps == {"r0": 2, "r1": 1}
    ref = world2["hop_ref"]
    assert streams == [ref[k] for k in sorted(ref)]


def jax_refusal(jcfg, tp, **kw) -> str:
    import dataclasses

    jcfg = dataclasses.replace(jcfg, **kw.pop("cfg", {}))
    params = j_init(jcfg, jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()[:tp]), kw.pop("axes", ("tp",)))
    build = {k: v for k, v in BUILD.items() if k != "device"}
    try:
        JEngine(params, jcfg, mesh=mesh, **{**build, **kw})
    except ValueError as e:
        return f"ValueError: {e}"
    return "built"


@pytest.mark.parametrize("case,jax_kw", [
    ("no_tp_axis", dict(axes=("dp",))),
    ("kv_heads", dict(cfg=dict(n_heads=6, n_kv_heads=3, d_model=48))),
    ("moe", dict(cfg=dict(n_experts=2, moe_top_k=1))),
])
def test_refusals_match_jax(jax_side, world2, case, jax_kw):
    """A mesh without a tp dim, kv heads tp does not divide (with the
    valid divisors) and MoE under weight sharding raise the JAX engine's
    ValueError, word for word."""
    got = world2["refusals"][case]
    assert got == jax_refusal(jax_side[0], 2, **jax_kw)
    assert got.startswith("ValueError")


def test_contiguous_on_a_mesh_is_refused(world2):
    got = world2["refusals"]["contiguous"]
    assert got.startswith("NotImplementedError")
    assert "standing rule" in got and "no later slice" in got


def test_tp4_streams_and_d_ff_refusal(jax_side, world4):
    got, ref = world4["streams"]
    assert got == ref
    assert world4["d_ff"] == jax_refusal(jax_side[0], 4, cfg=dict(d_ff=130))
    assert "valid tp divisors" in world4["d_ff"]
    assert world4["d_ff_replicated"] == "replicated"


def test_follower_failure_fails_the_leader(jax_side, tmp_path):
    """A follower whose step raises ends its process; the leader's next
    collective with it raises instead of waiting, so the world fails with
    both ranks' tracebacks."""
    _, _, _, tree, prompts = jax_side
    with pytest.raises(WorldError) as e:
        spawn(world_follower_fails, 2, "gloo", args=(tree, prompts),
              rendezvous=str(tmp_path / "rdv"), timeout=120,
              group_timeout=20)
    assert set(e.value.failures) == {0, 1}
    assert "follower decode failed on purpose" in e.value.failures[1]
    assert "the leader finished" not in str(e.value)
