"""Sharded training in the port (``make_train_step(cfg, mesh, opt)``)
against the JAX package's sharded step and against the port's
``mesh=None`` step, on the CPU.

The port runs in gloo worlds of CPU processes (``parallel.spawn``, a
``file://`` rendezvous under the test's temporary directory): one world
of 2 and one of 4, each running its grid of cells in one spawn. The rank
workers are in ``tests/torch_train_workers.py``, which imports no JAX.
The JAX step runs on the same ``MeshSpec`` over as many of the eight
virtual CPU devices ``tests/conftest.py`` sets; its flash attention is
the Pallas kernels in interpret mode inside ``shard_map``, the port's the
plain versions of K5-K7 on each rank's batch and heads.

Every cell is ``LlamaConfig.tiny()`` (8 heads; GQA: 2 kv heads) at f32
with remat, B 4, T 32, two AdamW(3e-4) steps from the JAX init (key 0,
carried by the bridge as each rank's blocks). Tolerances are those of
``tests/test_torch_train.py``: losses to 1e-5 relative, every weight
after the steps to 1e-5 absolute (a thirtieth of one step's move)."""
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu.ops.attention import (
    ring_attention as j_ring, ulysses_attention as j_ulysses)
from k8s_gpu_scheduler_tpu.parallel import MeshSpec as JMeshSpec
from k8s_gpu_scheduler_tpu.parallel import make_mesh as j_make_mesh
from k8s_gpu_scheduler_tpu.parallel.sharding import shard_map
from jax.sharding import PartitionSpec as P
from k8s_gpu_scheduler_tpu_torch.bridge import (
    params_from_numpy, params_to_numpy)
from k8s_gpu_scheduler_tpu_torch.models import llama
from k8s_gpu_scheduler_tpu_torch.parallel import spawn
from k8s_gpu_scheduler_tpu_torch.parallel.sharding import rank_slice
from torch_train_workers import (
    LR, STEPS, batch_of, config, moe_config, world_attention, world_cells,
    world_init, world_main, world_restore, world_resume)

# (name, attn_impl, MeshSpec.for_devices axes, GQA), by world size.
CELLS = {
    2: [("flash-tp2", "flash", {"tp": 2}, False),
        ("flash-fsdp2", "flash", {"fsdp": 2}, False),
        ("gqa-flash-tp2", "flash", {"tp": 2}, True)],
    4: [("dense-fsdp2-tp2", "dense", {"fsdp": 2, "tp": 2}, False),
        ("dense-dp2-tp2", "dense", {"tp": 2}, False),
        ("ring-sp2-tp2", "ring", {"sp": 2, "tp": 2}, False),
        ("ulysses-sp4", "ulysses", {"sp": 4}, False)],
}
ALL = [(w, c) for w, cells in CELLS.items() for c in cells]
IDS = [c[0] for _, c in ALL]
ATTN_SHAPE = (2, 16, 4, 2, 8)      # B, T, H, Hkv, d for ring/Ulysses alone


def jax_config(impl, gqa):
    return dataclasses.replace(jllama.LlamaConfig.tiny(impl),
                               dtype=jnp.float32, remat=True,
                               n_kv_heads=2 if gqa else 8)


@pytest.fixture(scope="module")
def trees():
    """The JAX init (key 0) of the MHA and GQA configs, as numpy."""
    return {gqa: jax.tree.map(np.asarray, jllama.init_params(
        jax_config("dense", gqa), jax.random.PRNGKey(0)))
        for gqa in (False, True)}


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, (4, 32))


def attn_inputs():
    B, T, H, Hkv, d = ATTN_SHAPE
    rng = np.random.default_rng(5)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, d), (B, T, Hkv, d), (B, T, Hkv, d),
                           (B, T, H, d)))


def world_all(rank, world, trees, tokens, cells, attn, ckpt_dir, init_axes):
    """One spawn per world: the training cells, ring and Ulysses alone
    over every rank as sp, init_params on a mesh, and (world of 2) the
    sharded checkpoint, on its mesh and across meshes."""
    out = {"cells": world_cells(rank, world, trees[False], trees[True],
                                tokens, cells),
           "attn": world_attention(rank, world, *attn, {"sp": world}),
           "init": world_init(rank, world, init_axes)}
    if ckpt_dir is not None:
        out["resume"] = world_resume(rank, world, ckpt_dir, tokens)
        out["restore"] = world_restore(rank, world, ckpt_dir + "-across")
    return out


@pytest.fixture(scope="module")
def worlds(trees, tokens, tmp_path_factory):
    """Both worlds, started together (their directories made first:
    ``mktemp`` from two threads races on pytest's base temporary directory)."""
    from concurrent.futures import ThreadPoolExecutor

    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}

    def run(world, init_axes):
        d = dirs[world]
        return spawn(
            world_all, world, "gloo",
            args=(trees, tokens, CELLS[world], attn_inputs(),
                  str(d / "ckpt") if world == 2 else None, init_axes),
            rendezvous=str(d / "rdv"), timeout=480)

    with ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(run, w, axes) for w, axes in
                ((2, {"tp": 2}), (4, {"fsdp": 2, "tp": 2}))}
        return {w: f.result() for w, f in futs.items()}


def jax_run(tree, tokens, impl, gqa, mesh):
    """Two AdamW steps of the JAX step (``mesh`` None: one device):
    losses and the final weights as numpy."""
    jcfg = jax_config(impl, gqa)
    params = jax.tree.map(jnp.asarray, tree)
    opt = optax.adamw(LR)
    state = opt.init(params)
    step = jllama.make_train_step(jcfg, mesh, opt)
    batch = {"tokens": jnp.asarray(tokens),
             "targets": jnp.roll(jnp.asarray(tokens), -1, axis=1)}
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def port_run(tree, tokens, impl, gqa):
    """The port's ``mesh=None`` step on the same weights and batch."""
    cfg = config(impl, 2 if gqa else 8)
    model = params_from_numpy(tree, cfg, "cpu", trainable=True)
    step = llama.make_train_step(cfg, None, llama.make_optimizer(model, LR))
    batch = batch_of(tokens)
    return ([float(step(model, batch)) for _ in range(STEPS)],
            params_to_numpy(model))


def assert_blocks(rank_out, full, cfg):
    """A rank's blocks equal the rank's slices of ``full`` to 1e-5."""
    specs = llama.param_specs(cfg)
    sizes, index = rank_out["sizes"], rank_out["coords"]
    for key in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(
            rank_out["blocks"][key],
            rank_slice(full[key], specs[key], sizes, index), atol=1e-5,
            rtol=0, err_msg=key)
    for key, got in rank_out["blocks"]["blocks"].items():
        np.testing.assert_allclose(
            got, rank_slice(full["blocks"][key], specs["blocks"][key], sizes,
                            index), atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("axes", [{"fsdp": 2, "tp": 2}, {"sp": 2, "tp": 4},
                                  {"fsdp": 4}], ids=["dp2-fsdp2-tp2",
                                                     "sp2-tp4", "dp2-fsdp4"])
def test_rank_slices_are_jaxs_shards(trees, axes):
    """On a mesh of the 8 virtual devices, every leaf of the training
    tree (a leaf split over two dims: (fsdp, tp)) and the batch (a dim
    split over two axes: (dp, fsdp)) cut by ``rank_slice`` at a device's
    coordinates is JAX's shard of it on that device."""
    from jax.sharding import NamedSharding

    mesh = j_make_mesh(JMeshSpec.for_devices(8, **axes), jax.devices())
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    specs = llama.param_specs(config())
    tokens = np.arange(8 * 16).reshape(8, 16)
    cases = [(tokens, (("dp", "fsdp"), "sp"))] + [
        (leaf, spec) for key in ("embed", "lm_head", "final_norm")
        for leaf, spec in [(trees[False][key], specs[key])]] + [
        (trees[False]["blocks"][k], specs["blocks"][k])
        for k in trees[False]["blocks"]]
    for leaf, spec in cases:
        arr = jax.device_put(leaf, NamedSharding(mesh, P(*spec)))
        for shard in arr.addressable_shards:
            coord = np.argwhere(mesh.devices == shard.device)[0]
            index = dict(zip(mesh.axis_names, map(int, coord)))
            assert np.array_equal(np.asarray(shard.data),
                                  rank_slice(leaf, spec, sizes, index))


@pytest.mark.parametrize("world,cell", ALL, ids=IDS)
def test_sharded_step_matches_jax_on_the_same_mesh(trees, tokens, worlds,
                                                   world, cell):
    name, impl, axes, gqa = cell
    mesh = j_make_mesh(JMeshSpec.for_devices(world, **axes),
                       jax.devices()[:world])
    want, params = jax_run(trees[gqa], tokens, impl, gqa, mesh)
    cfg = config(impl, 2 if gqa else 8)
    for r, res in enumerate(worlds[world]):
        got = res["cells"][name]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5,
                                   err_msg=f"rank {r}")
        assert_blocks(got, params, cfg)


@pytest.mark.parametrize("world,cell", ALL, ids=IDS)
def test_sharded_step_matches_the_ports_unsharded_step(trees, tokens, worlds,
                                                       world, cell):
    name, impl, axes, gqa = cell
    want, params = port_run(trees[gqa], tokens, impl, gqa)
    for r, res in enumerate(worlds[world]):
        got = res["cells"][name]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5,
                                   err_msg=f"rank {r}")
        assert_blocks(got, params, config(impl, 2 if gqa else 8))
        if impl == "flash":
            # Remat: the forward and the recompute each run the plain K5
            # on the rank's batch and heads, the backward K6 + K7.
            layers = config().n_layers
            c = got["calls"]
            assert c["flash_forward_reference"] == 2 * layers * STEPS
            assert c["flash_backward_reference"] == layers * STEPS
            assert not (c["flash_forward"] or c["flash_backward_dq"]
                        or c["flash_backward_dkv"]), c


@pytest.mark.parametrize("world,cell", ALL, ids=IDS)
def test_per_rank_bytes_are_the_specs_slices(trees, worlds, world, cell):
    """Each rank holds exactly its ``param_specs`` slices (parameters,
    gradients, AdamW's two moments), never a whole sharded leaf, and
    ``train_state_bytes`` at the mesh's sizes predicts the four."""
    name, impl, axes, gqa = cell
    cfg = config(impl, 2 if gqa else 8)
    tree, specs = trees[gqa], llama.param_specs(cfg)
    for res in worlds[world]:
        got = res["cells"][name]
        sizes, index = got["sizes"], got["coords"]
        want = 0
        for key in ("embed", "final_norm", "lm_head", "blocks"):
            leaves = (tree[key].items() if key == "blocks"
                      else [(key, tree[key])])
            for leaf, a in leaves:
                spec = specs["blocks"][leaf] if key == "blocks" else \
                    specs[key]
                part = rank_slice(a, spec, sizes, index)
                want += part.size
                split = any(sizes.get(ax, 1) > 1 for dim in spec if dim
                            for ax in (dim if isinstance(dim, tuple)
                                       else (dim,)))
                assert (part.size < a.size) == split, (leaf, spec)
        assert got["numel"] == want
        assert got["bytes"] == got["grad_bytes"] == 4 * want
        assert got["moment_bytes"] == 2 * 4 * want
        assert llama.train_state_bytes(cfg, sizes) == 4 * 4 * want


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_jax(worlds, impl, world):
    """``ring_attention`` / ``ulysses_attention`` alone (GQA, causal):
    each rank's output and q/k/v gradients for its sequence block equal
    JAX's inside ``shard_map`` over ``sp`` (f32, 1e-5)."""
    q, k, v, do = attn_inputs()
    mesh = j_make_mesh(JMeshSpec({"sp": world}), jax.devices()[:world])
    spec = P(None, "sp", None, None)
    fn = shard_map(
        lambda q, k, v: (j_ring if impl == "ring" else j_ulysses)(
            q, k, v, axis_name="sp", causal=True),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)
    out, vjp = jax.vjp(jax.jit(fn), q, k, v)
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    t = q.shape[1] // world
    for r, res in enumerate(worlds[world]):
        for w, g in zip(want, res["attn"][impl]):
            np.testing.assert_allclose(g, w[:, r * t:(r + 1) * t],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_refuses_heads_sp_does_not_divide_as_jax(worlds, world):
    mesh = j_make_mesh(JMeshSpec({"sp": world}), jax.devices()[:world])
    spec = P(None, "sp", None, None)
    fn = shard_map(lambda q: j_ulysses(q, q, q, axis_name="sp"),
                   mesh=mesh, in_specs=(spec,), out_specs=spec,
                   check_vma=False)
    with pytest.raises(ValueError) as e:
        fn(jnp.zeros((1, 8 * world, 3, 4)))
    for res in worlds[world]:
        assert res["attn"]["refusal"] == str(e.value)


@pytest.mark.parametrize("world", [2, 4])
def test_init_params_on_a_mesh_is_the_slice_of_the_unsharded_init(worlds,
                                                                  world):
    cfg = config("dense", 2)
    full = params_to_numpy(llama.init_params(
        cfg, torch.Generator().manual_seed(4), "cpu"))
    specs = llama.param_specs(cfg)
    for res in worlds[world]:
        got = res["init"]
        for key in ("embed", "final_norm", "lm_head"):
            assert np.array_equal(got["blocks"][key], rank_slice(
                full[key], specs[key], got["sizes"], got["index"]))
        for key, a in got["blocks"]["blocks"].items():
            assert np.array_equal(a, rank_slice(
                full["blocks"][key], specs["blocks"][key], got["sizes"],
                got["index"]))


def test_sharded_checkpoint_resumes_bit_for_bit(worlds):
    """Two steps, a save at step 2 by every rank, a restore into fresh
    objects and steps 3-4 give the unstopped run's losses bit for bit;
    each rank wrote its own file and rank 0 the commit; a mesh of
    another shape (fsdp 2) restores step 4 and takes step 5 as the tp 2
    run does."""
    for res in worlds[2]:
        got = res["resume"]
        assert got["resumed"] == got["ref"]
        assert got["step_no"] == 2 and got["steps"] == [2, 4]
        assert got["files"] == ["commit.json", "rank-0.pt", "rank-1.pt"]
        across = got["across"]
        assert across["step_no"] == 4
        np.testing.assert_allclose(across["loss"], across["fifth"],
                                   rtol=1e-5)


def assert_state_slices(state, full, specs, sizes, index, stage=None):
    """A rank's ``state_numpy`` state is, bit for bit, its block of the
    whole state ``full`` (by ``specs`` at the mesh's ``sizes`` and its
    ``index``; or, for pipeline ``stage`` s of n-layer stages, its
    layers whole)."""
    for name, parts in state.items():
        whole = name
        if stage is not None and name.startswith("blocks."):
            s, n = stage
            i = name.split(".")
            whole = ".".join(["blocks", str(s * n + int(i[1]))] + i[2:])
        want = full[whole]
        for k in range(3):
            block = (want[k] if stage is not None else
                     rank_slice(want[k], specs[whole], sizes, index))
            assert np.array_equal(parts[k], block), (name, k)
        assert parts[3] == want[3] == float(STEPS), name


ACROSS = [("tp2->fsdp2", "fsdp2"), ("tp2->pp2", "pp2"),
          ("tp2->one", "one"), ("one->tp2", "one_to_tp2"),
          ("ep2->one", "ep2_to_one")]


@pytest.mark.parametrize("case", ACROSS, ids=[c[0] for c in ACROSS])
def test_restore_across_meshes_is_bit_for_bit(worlds, case):
    """A step saved at step 2 on one mesh or layout and restored onto
    another: every parameter and both AdamW moments of every rank are,
    bit for bit, its block of the saved state, and the step count too.
    The whole state is the one-card restore of the saved step, itself
    held to each saving rank's blocks."""
    name, key = case
    ranks = [res["restore"] for res in worlds[2]]
    cfg = moe_config() if name.startswith("ep2") else config("dense", 2)
    specs = llama.leaf_specs(cfg)
    tp = {"dp": 1, "fsdp": 1, "sp": 1, "ep": 1, "tp": 2}
    if name == "ep2->one":
        full = ranks[0]["ep2_to_one"]["state"]
        saved = [(r["saved_ep2"][0], r["ep2_coords"]) for r in ranks]
        sizes = dict(tp, tp=1, ep=2)
    elif name == "one->tp2":
        full = ranks[0]["saved_one"][0]
        saved = [(r["one_to_tp2"]["state"], r["tp2_coords"]) for r in ranks]
        sizes = tp
    else:
        full = ranks[0]["one"]["state"]
        saved = [(r["saved_tp2"][0], r["tp2_coords"]) for r in ranks]
        sizes = tp
    for state, coords in saved:
        assert_state_slices(state, full, specs, sizes, coords)
    for r in ranks:
        assert r[key]["step_no"] == STEPS
        if key == "fsdp2":
            assert_state_slices(r[key]["state"], full, specs,
                                dict(tp, tp=1, fsdp=2), r["fsdp2_coords"])
        elif key == "pp2":
            assert_state_slices(r[key]["state"], full, specs, {}, {},
                                stage=(r["pp2_coords"]["pp"], 1))
        elif key in ("one", "ep2_to_one"):
            assert_state_slices(r[key]["state"], full, specs, {}, {})


@pytest.mark.parametrize("case", ACROSS, ids=[c[0] for c in ACROSS])
def test_next_step_after_a_restore_across_meshes(worlds, case):
    """The step after a restore onto another mesh (a pipeline step on
    pp 2) has the loss of the saving mesh's next step, to 1e-5."""
    _, key = case
    for res in worlds[2]:
        r = res["restore"]
        saved = (r["saved_ep2"] if key == "ep2_to_one" else
                 worlds[2][0]["restore"]["saved_one"] if key == "one_to_tp2"
                 else r["saved_tp2"])
        np.testing.assert_allclose(r[key]["loss"], saved[1], rtol=1e-5)


def test_restore_refuses_a_mesh_its_leaves_cannot_tile(tmp_path):
    """Restoring onto tp 4 a step of a model with 2 kv heads raises
    ``ValueError`` naming the first leaf tp 4 cannot cut."""
    from k8s_gpu_scheduler_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)
    from test_torch_pipeline import FakeMesh

    cfg = config("dense", 2)
    model = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = llama.make_optimizer(model, LR)
    TrainCheckpointer(str(tmp_path)).save(1, (model, opt))
    ck = TrainCheckpointer(str(tmp_path), mesh=FakeMesh(tp=4))
    with pytest.raises(ValueError, match="leaf blocks.0.wk"):
        ck.restore(like=(model, opt))
    with pytest.raises(ValueError, match="needs like="):
        ck.restore()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_main_trains_a_gang_of_two(tmp_path):
    """``main()``'s training branch as two workers of a gloo gang (the
    gang env, a tiny config at B 4, T 32, two steps, a checkpoint every
    step): one line per step on each rank, the ranks' losses equal; a
    second run to step 3 resumes from the sharded checkpoint at step 2."""
    ck = str(tmp_path / "ck")
    argv = ["--ckpt-dir", ck, "--ckpt-every", "1"]
    lines = spawn(world_main, 2, None, args=(_free_port(), argv, (4, 32), 2),
                  rendezvous=str(tmp_path / "rdv"), timeout=240)
    assert [len(x) for x in lines] == [2, 2]
    for r, rank_lines in enumerate(lines):
        for step, ln in enumerate(rank_lines, 1):
            assert ln.startswith(f"llama pretrain worker={r} step={step} "
                                 f"tok/s=")
    assert [ln.split("loss=")[1] for ln in lines[0]] == \
        [ln.split("loss=")[1] for ln in lines[1]]
    again = spawn(world_main, 2, None, args=(_free_port(), argv, (4, 32), 3),
                  rendezvous=str(tmp_path / "rdv2"), timeout=240)
    for r, rank_lines in enumerate(again):
        assert rank_lines[0] == (f"llama pretrain worker={r} resumed at "
                                 f"step 2 from {ck}")
        assert rank_lines[1].startswith(f"llama pretrain worker={r} step=3 ")
        assert len(rank_lines) == 2


def test_main_resumes_a_gang_that_comes_back_at_another_size(tmp_path):
    """A gang of two (tp 2) checkpoints steps 1-2; the gang rescheduled
    as four workers (tp 4; 8 kv heads) resumes at step 2 from the
    two-rank files and runs step 3 on every rank with one loss."""
    ck = str(tmp_path / "ck")
    argv = ["--ckpt-dir", ck, "--ckpt-every", "1"]
    first = spawn(world_main, 2, None,
                  args=(_free_port(), argv, (4, 32), 2, 8),
                  rendezvous=str(tmp_path / "rdv"), timeout=240)
    assert [len(x) for x in first] == [2, 2]
    again = spawn(world_main, 4, None,
                  args=(_free_port(), argv, (4, 32), 3, 8),
                  rendezvous=str(tmp_path / "rdv2"), timeout=240)
    for r, rank_lines in enumerate(again):
        assert rank_lines[0] == (f"llama pretrain worker={r} resumed at "
                                 f"step 2 from {ck}")
        assert rank_lines[1].startswith(f"llama pretrain worker={r} step=3 ")
        assert len(rank_lines) == 2
    assert len({ln[1].split("loss=")[1] for ln in again}) == 1
