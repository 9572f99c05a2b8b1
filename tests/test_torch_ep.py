"""Mixture-of-experts training on a mesh with an ``ep`` axis in the port
(``make_train_step(cfg, mesh, opt)``, ``moe_ffn(..., ax=)``) against the
JAX package's MoE step and the port's one-card step, on the CPU.

The port runs in gloo worlds of CPU processes (``parallel.spawn``): one
world of 2 ({ep 2}) and one of 4 ({ep 2, tp 2}, {fsdp 2, ep 2}, {sp 2,
ep 2}, {dp 2, ep 2}), each running its cells in one spawn; the rank
workers are in ``tests/torch_train_workers.py``, which imports no JAX.
Each mesh runs dense attention at capacity factor 1.0, where tokens drop
(so the sp cells need the choices of the sp rank before them), and flash
attention (the plain K5-K7 on each rank; ring attention over sp, as in
JAX) at 2.0, where none do.

The config is JAX's MoE-test config (``tests/test_models.py``: vocab
128, d 32, 2 layers, 4 heads, 4 experts, top 2, f32) with remat, from
the JAX init (key 0), B 4, T 32, two AdamW(3e-4) steps. JAX's references
are its unsharded step and its loss on ``MeshSpec.for_devices(8,
fsdp=2, ep=2, tp=2)``; the weights of the {sp 2, ep 2} flash cell (ring
attention) are held to JAX's step on that mesh (``assert_ring_blocks``).
Tolerances are those of ``tests/test_torch_shard_train.py``: losses to 1e-5 relative, weights to
1e-5 absolute."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu.parallel import MeshSpec as JMeshSpec
from k8s_gpu_scheduler_tpu.parallel import make_mesh as j_make_mesh
from k8s_gpu_scheduler_tpu_torch.bridge import (
    params_from_numpy, params_to_numpy)
from k8s_gpu_scheduler_tpu_torch.models import llama
from k8s_gpu_scheduler_tpu_torch.parallel import spawn
from k8s_gpu_scheduler_tpu_torch.parallel.sharding import rank_slice
from test_torch_shard_train import assert_blocks
from torch_train_workers import (
    LR, STEPS, batch_of, moe_config, moe_drops, world_ep)

MESHES = {2: [("ep2", {"ep": 2})],
          4: [("ep2-tp2", {"ep": 2, "tp": 2}),
              ("fsdp2-ep2", {"fsdp": 2, "ep": 2}),
              ("sp2-ep2", {"sp": 2, "ep": 2}),
              ("dp2-ep2", {"ep": 2})]}
# (attn_impl, capacity factor) of each mesh's two cells.
RUNS = (("dense", 1.0), ("flash", 2.0))
CELLS = {w: [(f"{name}-{impl}", impl, axes, cf) for name, axes in meshes
             for impl, cf in RUNS] for w, meshes in MESHES.items()}
ALL = [(w, c) for w, cells in CELLS.items() for c in cells]
IDS = [c[0] for _, c in ALL]


def jax_cfg(impl, cf):
    return jllama.LlamaConfig(
        vocab=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=64, max_seq=64, dtype=jnp.float32, remat=False, n_experts=4,
        moe_top_k=2, moe_capacity_factor=cf, attn_impl=impl)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(
        jax_cfg("dense", 2.0), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 128, (4, 32))


def jbatch(tokens):
    t = jnp.asarray(tokens)
    return {"tokens": t, "targets": jnp.roll(t, -1, axis=1)}


def jax_references(tree, tokens):
    """For each run: JAX's unsharded two steps (losses, weights) and its
    loss on {fsdp 2, ep 2, tp 2}."""
    mesh = j_make_mesh(JMeshSpec.for_devices(8, fsdp=2, ep=2, tp=2),
                       jax.devices())
    out = {}
    for impl, cf in RUNS:
        cfg = jax_cfg(impl, cf)
        params = jax.tree.map(jnp.asarray, tree)
        opt = optax.adamw(LR)
        state = opt.init(params)
        step = jllama.make_train_step(cfg, None, opt)
        mesh_loss = float(jllama.loss_fn(params, jbatch(tokens), cfg, mesh))
        losses = []
        for _ in range(STEPS):
            params, state, loss = step(params, state, jbatch(tokens))
            losses.append(float(loss))
        out[impl, cf] = dict(losses=losses, mesh_loss=mesh_loss,
                             params=jax.tree.map(np.asarray, params))
    # Over sp, flash runs ring attention (in JAX too), held to JAX's step
    # on the same mesh, with the first step's gradients for the AdamW
    # zone (``assert_ring_blocks``).
    sp_mesh = j_make_mesh(JMeshSpec.for_devices(4, sp=2, ep=2),
                          jax.devices()[:4])
    cfg = jax_cfg("flash", 2.0)
    params = jax.tree.map(jnp.asarray, tree)
    grads = jax.grad(jllama.loss_fn)(params, jbatch(tokens), cfg, sp_mesh)
    opt = optax.adamw(LR)
    state = opt.init(params)
    step = jllama.make_train_step(cfg, sp_mesh, opt)
    for _ in range(STEPS):
        params, state, _ = step(params, state, jbatch(tokens))
    out["ring"] = dict(params=jax.tree.map(np.asarray, params),
                       grads=jax.tree.map(np.asarray, grads))
    return out


ADAM_ZONE = 1e-6


def assert_ring_blocks(got, ring, cfg):
    """The ring cell's blocks against JAX's step on the same mesh: every
    weight to 1e-5, except where JAX's first-step gradient is below
    ``ADAM_ZONE`` (chip_smoke.py phase 18b's rule): there AdamW's
    g / (|g| + 1e-8) turns the gradient's last bits (ring attention's
    sums against JAX's, in another order) into a move of up to 2 lr a
    step, so such a weight is held to 2 lr a step, and there are few."""
    specs = llama.param_specs(cfg)
    sizes, index = got["sizes"], got["coords"]
    zone = 0
    leaves = [(k, got["blocks"][k], ring["params"][k], ring["grads"][k],
               specs[k]) for k in ("embed", "final_norm", "lm_head")] + [
        (k, a, ring["params"]["blocks"][k], ring["grads"]["blocks"][k],
         specs["blocks"][k]) for k, a in got["blocks"]["blocks"].items()]
    for key, a, w, g, spec in leaves:
        w, g = (rank_slice(x, spec, sizes, index) for x in (w, g))
        diff = np.abs(a - w)
        small = np.abs(g) < ADAM_ZONE
        assert diff[~small].max(initial=0) <= 1e-5, key
        assert diff.max() <= 2 * LR * STEPS, key
        zone += int((diff[small] > 1e-5).sum())
    assert zone <= 4, zone


@pytest.fixture(scope="module")
def both(tree, tokens, tmp_path_factory):
    """Both worlds, started together (their directories made first:
    ``mktemp`` from two threads races on pytest's base temporary directory),
    and JAX's references, computed while they run."""
    from concurrent.futures import ThreadPoolExecutor

    dirs = {w: tmp_path_factory.mktemp(f"ep{w}") for w in CELLS}

    def run(world):
        d = dirs[world]
        return spawn(world_ep, world, "gloo",
                     args=(tree, tokens, CELLS[world]),
                     rendezvous=str(d / "rdv"), timeout=480)

    with ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(run, w) for w in CELLS}
        refs = jax_references(tree, tokens)
        return {w: f.result() for w, f in futs.items()}, refs


@pytest.fixture(scope="module")
def one_card(tree, tokens):
    """The port's one-card step for each run: losses, weights, drops."""
    out = {}
    for impl, cf in RUNS:
        cfg = moe_config(impl, cf)
        model = params_from_numpy(tree, cfg, "cpu", trainable=True)
        drops = moe_drops(model, tokens, None)
        step = llama.make_train_step(cfg, None, llama.make_optimizer(
            model, LR))
        losses = [float(step(model, batch_of(tokens))) for _ in range(STEPS)]
        out[impl, cf] = dict(losses=losses, drops=drops,
                             params=params_to_numpy(model))
    return out


@pytest.mark.parametrize("world,cell", ALL, ids=IDS)
def test_ep_step_matches_jax(both, world, cell):
    """Every rank's losses equal JAX's unsharded step's (and the first
    JAX's loss on {fsdp 2, ep 2, tp 2}), and its blocks after two steps
    are its slices of JAX's weights (over sp, flash is ring attention:
    JAX's step on the same mesh, ``assert_ring_blocks``)."""
    worlds, refs = both
    name, impl, axes, cf = cell
    ref = refs[impl, cf]
    np.testing.assert_allclose(ref["mesh_loss"], ref["losses"][0],
                               rtol=1e-5)
    for r, res in enumerate(worlds[world]):
        got = res[name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["losses"][0], ref["mesh_loss"],
                                   rtol=1e-5)
        if impl == "flash" and "sp" in axes:
            assert_ring_blocks(got, refs["ring"], moe_config(impl, cf))
        else:
            assert_blocks(got, ref["params"], moe_config(impl, cf))


@pytest.mark.parametrize("world,cell", ALL, ids=IDS)
def test_ep_step_matches_the_ports_one_card_step(both, one_card, world,
                                                 cell):
    """Against the port's one-card step: the losses and weights, the
    drops (each layer's, summed over the ranks that split the tokens,
    with tokens dropped at capacity factor 1.0), and, for flash, the
    plain K5-K7 on each rank: K5 twice a layer a step (remat), K6/K7
    once."""
    worlds, _ = both
    name, impl, axes, cf = cell
    ref = one_card[impl, cf]
    ranks = worlds[world]
    for r, res in enumerate(ranks):
        got = res[name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                                   err_msg=f"rank {r}")
        assert_blocks(got, ref["params"], moe_config(impl, cf))
        if impl == "flash" and "sp" not in axes:
            c, layers = got["calls"], 2
            assert c["flash_forward_reference"] == 2 * layers * STEPS
            assert c["flash_backward_reference"] == layers * STEPS
    # One rank of each (ep, tp) group counts its tokens' drops.
    heads = [res[name] for res in ranks
             if res[name]["coords"]["ep"] == res[name]["coords"]["tp"] == 0]
    total = np.sum([h["drops"] for h in heads], axis=0).tolist()
    assert total == ref["drops"]
    assert (sum(ref["drops"]) > 0) == (cf == 1.0)
    if "sp" in axes and cf == 1.0:
        # The later half of each row sees the earlier half's queue.
        by_sp = {h["coords"]["sp"]: sum(h["drops"]) for h in heads}
        assert by_sp[1] > by_sp[0]


@pytest.mark.parametrize("world,cell", ALL, ids=IDS)
def test_ep_rank_bytes_are_the_specs_slices(tree, both, world, cell):
    """Each rank holds exactly its slices (the router's columns and the
    expert stacks over ep), and ``rank_leaf_shapes`` and
    ``train_state_bytes`` at the mesh's sizes predict them."""
    worlds, _ = both
    name, impl, axes, cf = cell
    cfg = moe_config(impl, cf)
    specs = llama.param_specs(cfg)
    for res in worlds[world]:
        got = res[name]
        sizes, index = got["sizes"], got["coords"]
        want = sum(rank_slice(tree[k], specs[k], sizes, index).size
                   for k in ("embed", "final_norm", "lm_head")) + sum(
            rank_slice(a, specs["blocks"][k], sizes, index).size
            for k, a in tree["blocks"].items())
        shapes = llama.rank_leaf_shapes(cfg, sizes)
        assert shapes["blocks.0.w_gate"][0] == (4 // sizes["ep"], 32 //
                                                sizes["fsdp"],
                                                64 // sizes["tp"])
        assert shapes["blocks.0.router"][0] == (32 // sizes["fsdp"],
                                                4 // sizes["ep"])
        assert got["numel"] == want == sum(
            int(np.prod(s)) for s, _ in shapes.values())
        assert got["bytes"] == got["grad_bytes"] == 4 * want
        assert got["moment_bytes"] == 2 * 4 * want
        assert llama.train_state_bytes(cfg, sizes) == 4 * 4 * want


def test_moe_layers_cover_the_ep_specs():
    """The router is [D, E] over (fsdp, ep) and each expert stack's
    leading axis over ep, the JAX package's rules table; a mesh of one
    rank is the one-card step, and the pipeline still refuses MoE."""
    cfg = moe_config()
    specs = llama.leaf_specs(cfg)
    assert specs["blocks.0.router"] == ("fsdp", "ep")
    assert specs["blocks.0.w_gate"] == ("ep", "fsdp", "tp")
    assert specs["blocks.0.w_down"] == ("ep", "tp", "fsdp")
    jspecs = jllama.param_specs(jax_cfg("dense", 2.0))
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(jspecs["blocks"][k]) == llama.param_specs(cfg)[
            "blocks"][k]
    with pytest.raises(ValueError, match="leaf blocks.0.router"):
        llama.rank_layout(dataclasses.replace(cfg, n_experts=3),
                          {"ep": 2}, {"ep": 0})


@pytest.mark.parametrize("world", [2, 4])
def test_gathers_on_the_last_dim(both, world):
    """``all_gather`` and ``gather_from`` over dim -1 concatenate the
    ranks' blocks in rank order (the router's logits over ep), and their
    backwards return this rank's block of the summed gradient and of its
    own gradient. (A negative dim once interleaved the ranks' columns.)"""
    worlds, _ = both
    blocks = [100.0 * r + np.arange(6.0).reshape(2, 3) for r in range(world)]
    whole = np.concatenate(blocks, axis=-1)
    ups = [1000.0 * r + np.arange(6.0 * world).reshape(2, 3 * world)
           for r in range(world)]
    for r, res in enumerate(worlds[world]):
        outs, grads = res["gathers"]
        for name in ("all_gather", "gather_from"):
            assert np.array_equal(outs[name], whole)
        mine = slice(3 * r, 3 * r + 3)
        assert np.array_equal(grads["all_gather"],
                              np.sum(ups, axis=0)[:, mine])
        assert np.array_equal(grads["gather_from"], ups[r][:, mine])
