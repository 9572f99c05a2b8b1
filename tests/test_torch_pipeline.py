"""The port's pipeline (``models/pipeline.py``: GPipe and 1F1B over a
``pp`` mesh axis) against the JAX package's on the CPU.

The port runs in gloo worlds of CPU processes (``parallel.spawn``): one
world of 2 (pp 2) and one of 4 (pp 4, and pp 2 × dp 2, whose dp ranks
run the same stages), each running its cells in one spawn; the rank
workers are in ``tests/torch_train_workers.py``, which imports no JAX.
The JAX functions run on ``Mesh(jax.devices()[:P], ("pp",))`` over
``tests/conftest.py``'s virtual CPU devices.

The config is JAX's pipeline-test config (``tests/test_models.py``:
vocab 128, d 32, 4 layers, 4 heads, f32) from the JAX init (key 0),
carried to each stage by the bridge, at B 8, T 16; remat off and on
(JAX's references run remat off: the recompute changes no value).
Tolerances are those of ``tests/test_torch_shard_train.py``: losses to
1e-5 relative, gradients to 1e-5 of each leaf's largest, weights after
two AdamW(3e-4) steps to 1e-5 absolute."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu.models import pipeline as jpipe
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models import llama
from k8s_gpu_scheduler_tpu_torch.models import pipeline
from k8s_gpu_scheduler_tpu_torch.parallel import spawn
from torch_train_workers import (
    LR, PP_MICROBATCHES, PP_TRAIN_M, STEPS, batch_of, pp_config,
    world_pipeline)

# (name, mesh axes in rank order, remat), by world size.
CELLS = {
    2: [("pp2", {"pp": 2}, False), ("pp2-remat", {"pp": 2}, True)],
    4: [("pp4", {"pp": 4}, False), ("pp4-remat", {"pp": 4}, True),
        ("dp2-pp2", {"dp": 2, "pp": 2}, False)],
}
ALL = [(w, c) for w, cells in CELLS.items() for c in cells]
IDS = [c[0] for _, c in ALL]
STASH_MB, STASH_M = 2, (2, 8)      # the stash test: microbatch 2, M 2 and 8


def jax_cfg(**kw):
    return jllama.LlamaConfig(**{
        **dict(vocab=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=4,
               d_ff=64, max_seq=64, dtype=jnp.float32, remat=False), **kw})


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_params(
        jax_cfg(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 128, (8, 16))


def stash_tokens():
    rng = np.random.default_rng(1)
    return {M: rng.integers(0, 128, (M * STASH_MB, 16)) for M in STASH_M}


@pytest.fixture(scope="module")
def both(tree, tokens, tmp_path_factory):
    """Both worlds, started together (their directories made first:
    ``mktemp`` from two threads races on pytest's base temporary directory),
    and JAX's references, computed while they run."""
    from concurrent.futures import ThreadPoolExecutor

    dirs = {w: tmp_path_factory.mktemp(f"pp{w}") for w in CELLS}

    def run(world):
        d = dirs[world]
        return spawn(world_pipeline, world, "gloo",
                     args=(tree, tokens, stash_tokens(), CELLS[world]),
                     rendezvous=str(d / "rdv"), timeout=480)

    with ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(run, w) for w in CELLS}
        refs = jax_references(tree, tokens)
        return {w: f.result() for w, f in futs.items()}, refs


@pytest.fixture(scope="module")
def worlds(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_refs(both):
    return both[1]


def jax_mesh(P):
    return Mesh(np.array(jax.devices()[:P]), ("pp",))


def jbatch(tokens):
    t = jnp.asarray(tokens)
    return {"tokens": t, "targets": jnp.roll(t, -1, axis=1)}


def jax_references(tree, tokens):
    """JAX's GPipe losses and 1F1B losses and gradients for each M, and
    two steps of each schedule, at pp 2 and pp 4."""
    params = jax.tree.map(jnp.asarray, tree)
    batch = jbatch(tokens)
    out = {}
    for P in (2, 4):
        mesh, cfg = jax_mesh(P), jax_cfg()
        ref = {"gpipe": {}, "f1b": {}, "grads": {}, "train": {}}
        for M in PP_MICROBATCHES:
            ref["gpipe"][M] = float(jax.jit(partial(
                jpipe.pp_loss_fn, cfg=cfg, mesh=mesh, microbatches=M))(
                    params, batch))
            loss, grads = jax.jit(partial(
                jpipe.pp_1f1b_loss_and_grads, cfg=cfg, mesh=mesh,
                microbatches=M))(params, batch)
            ref["f1b"][M] = float(loss)
            ref["grads"][M] = jax.tree.map(np.asarray, grads)
        for sched in ("gpipe", "1f1b"):
            opt = optax.adamw(LR)
            step = jpipe.make_pp_train_step(cfg, mesh, opt, PP_TRAIN_M,
                                            schedule=sched)
            p, st, losses = jax.tree.map(jnp.copy, params), None, []
            st = opt.init(p)
            for _ in range(STEPS):
                p, st, loss = step(p, st, batch)
                losses.append(float(loss))
            ref["train"][sched] = (losses, jax.tree.map(np.asarray, p))
        out[P] = ref
    return out


def whole_name(name, stage, per_stage):
    """A stage parameter's name and layer in the JAX tree."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return parts[0], None
    return parts[2], stage * per_stage + int(parts[1])


def assert_stage_tree(got, want, res, tol, scale_by_leaf):
    """Each of a stage's leaves (``got`` by name) against the JAX tree
    ``want``: to ``tol`` absolute, or of each leaf's largest."""
    stage, n = res["index"]["pp"], res["blocks"]
    for name, a in got.items():
        key, layer = whole_name(name, stage, n)
        b = np.asarray(want[key] if layer is None
                       else want["blocks"][key][layer])
        bound = tol * (np.abs(b).max() if scale_by_leaf else 1.0)
        assert np.abs(a - b).max() <= bound, (name, np.abs(a - b).max())


def stage_params(blocks_tree, res):
    """A stage's ``params_to_numpy`` tree as {parameter name: array}."""
    out = {k: blocks_tree[k] for k in ("embed", "final_norm", "lm_head")}
    for key, stack in blocks_tree["blocks"].items():
        for i, a in enumerate(stack):
            out[f"blocks.{i}.{key}"] = a
    return out


@pytest.mark.parametrize("world,cell", ALL, ids=IDS)
def test_gpipe_loss_matches_jax_and_one_card(tree, tokens, worlds,
                                             jax_refs, world, cell):
    """For M 2, 4, 8 every rank's GPipe loss equals JAX's ``pp_loss_fn``
    on a pp mesh of the same size and the port's one-card ``loss_fn``."""
    name, axes, remat = cell
    cfg = pp_config(remat)
    one = float(llama.loss_fn(params_from_numpy(tree, cfg, "cpu"),
                              batch_of(tokens)))
    for r, res in enumerate(worlds[world]):
        got = res[name]
        assert got["blocks"] == 4 // axes["pp"]
        for M in PP_MICROBATCHES:
            want = jax_refs[axes["pp"]]["gpipe"][M]
            np.testing.assert_allclose(got["gpipe"][M], want, rtol=1e-5,
                                       err_msg=f"rank {r} M {M}")
            np.testing.assert_allclose(got["gpipe"][M], one, rtol=1e-5)


@pytest.mark.parametrize("world,cell", ALL, ids=IDS)
def test_1f1b_loss_and_grads_match_jax(worlds, jax_refs, world, cell):
    """For M 2, 4, 8 the 1F1B loss and every gradient of a stage equal
    JAX's ``pp_1f1b_loss_and_grads``; GPipe's gradients (``backward()``
    of ``pp_loss_fn``) equal them too."""
    name, axes, _ = cell
    ref = jax_refs[axes["pp"]]
    for r, res in enumerate(worlds[world]):
        got = res[name]
        for M in PP_MICROBATCHES:
            np.testing.assert_allclose(got["f1b"][M], ref["f1b"][M],
                                       rtol=1e-5, err_msg=f"rank {r}")
            assert_stage_tree(got["grads"][M], ref["grads"][M], got, 1e-5,
                              True)
        assert_stage_tree(got["gpipe_grads"], ref["grads"][PP_TRAIN_M], got,
                          1e-5, True)


@pytest.mark.parametrize("world,cell", ALL, ids=IDS)
def test_two_steps_of_each_schedule_match_jax(worlds, jax_refs, world,
                                              cell):
    """Two ``make_pp_train_step`` steps of each schedule: losses and every
    weight equal JAX's, and 1F1B's weights equal GPipe's; a stage's
    optimizer holds its own parameters only."""
    name, axes, _ = cell
    ref = jax_refs[axes["pp"]]["train"]
    for r, res in enumerate(worlds[world]):
        got = res[name]["train"]
        for sched in ("gpipe", "1f1b"):
            losses, params = ref[sched]
            np.testing.assert_allclose(got[sched]["losses"], losses,
                                       rtol=1e-5, err_msg=f"rank {r}")
            assert_stage_tree(stage_params(got[sched]["blocks"], res[name]),
                              params, res[name], 1e-5, False)
            n = res[name]["blocks"]
            assert got[sched]["moments"] == 9 * n + 3
        a = stage_params(got["gpipe"]["blocks"], res[name])
        b = stage_params(got["1f1b"]["blocks"], res[name])
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0)


@pytest.mark.parametrize("world,cell",
                         [(w, c) for w, c in ALL if not c[2]],
                         ids=[c[0] for w, c in ALL if not c[2]])
def test_gpipe_stash_grows_with_m_and_1f1b_stays_bounded(worlds, world,
                                                         cell):
    """At a fixed microbatch size (2 rows), GPipe's saved activations
    grow with M (M 2 → 8: at least 2×), while a 1F1B stage holds at most
    2(P - 1 - s) + 1 inputs (the last stage none) and the same saved
    bytes at any M (the port's form of the JAX package's stash test)."""
    name, axes, _ = cell
    P = axes["pp"]
    for res in worlds[world]:
        got = res[name]
        s = got["index"]["pp"]
        saved = got["saved"]
        assert saved[("gpipe", 8)]["peak"] >= 2 * saved[("gpipe", 2)]["peak"]
        assert saved[("gpipe", 2)]["peak"] >= STASH_MB * 16 * 32 * 4
        assert saved[("1f1b", 8)]["peak"] == saved[("1f1b", 2)]["peak"]
        assert saved[("1f1b", 8)]["peak"] < saved[("gpipe", 8)]["peak"]
        for M in STASH_M:
            assert saved[("1f1b", M)]["stash"] <= 2 * (P - 1 - s) + 1
        for M in PP_MICROBATCHES:
            assert got["stash"][M] <= 2 * (P - 1 - s) + 1
        if s == P - 1:
            assert got["stash"][8] == 0


class FakeMesh:
    """What ``parallel.sharding.mesh_coords`` reads of a ``DeviceMesh``:
    enough for the refusals, which come before any collective."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = sizes

    def size(self, i):
        return self._sizes[self.mesh_dim_names[i]]

    def get_local_rank(self, name):
        return 0


REFUSALS = [
    ("layers", dict(n_layers=3), 4, 2, "gpipe", AssertionError),
    ("batch", {}, 2, 4, "gpipe", AssertionError),
    ("moe", dict(n_experts=4), 2, 2, "gpipe", NotImplementedError),
    ("flash", dict(attn_impl="flash"), 2, 2, "gpipe", NotImplementedError),
    ("ring", dict(attn_impl="ring"), 2, 2, "1f1b", NotImplementedError),
    ("1f1b-one-stage", {}, 1, 2, "1f1b", ValueError),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_refusals_are_jaxs(tokens, case):
    """Each refusal raises JAX's exception type (and, for the
    ``NotImplementedError``/``ValueError`` ones, its message)."""
    _, kw, P, M, sched, exc = case
    jcfg = jax_cfg(**kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jfn = (jpipe.pp_loss_fn if sched == "gpipe"
           else jpipe.pp_1f1b_loss_and_grads)
    with pytest.raises(exc) as want:
        jfn(jparams, jbatch(tokens[:6]), jcfg, jax_mesh(P), M)
    cfg = pp_config(**kw)
    model = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fn = (pipeline.pp_loss_fn if sched == "gpipe"
          else pipeline.pp_1f1b_loss_and_grads)
    with pytest.raises(exc) as got:
        fn(model, batch_of(tokens[:6]), cfg, FakeMesh(pp=P), M)
    if exc is not AssertionError:
        assert str(got.value) == str(want.value)


def test_make_pp_train_step_refusals():
    """A bad schedule and 1F1B on one stage raise ``ValueError`` as JAX's
    do; the plain train step refuses a pp axis, naming the pipeline's."""
    opt = optax.adamw(LR)
    with pytest.raises(ValueError) as want:
        jpipe.make_pp_train_step(jax_cfg(), jax_mesh(2), opt, 2, "zb")
    cfg = pp_config()
    model = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    torch_opt = llama.make_optimizer(model)
    with pytest.raises(ValueError) as got:
        pipeline.make_pp_train_step(cfg, FakeMesh(pp=2), torch_opt, 2, "zb")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="1F1B needs >= 2 stages"):
        pipeline.make_pp_train_step(cfg, FakeMesh(pp=1), torch_opt, 2,
                                    "1f1b")
    with pytest.raises(ValueError, match="make_pp_train_step"):
        llama.make_train_step(cfg, FakeMesh(pp=2, tp=2), torch_opt)


def test_a_stage_holds_its_layers_and_the_rest_whole(tree):
    """``rank_layout`` and ``train_state_bytes`` at pp 2: stage s holds
    layers 2s and 2s + 1 whole and every other leaf whole, which is what
    the bridge's ``specs="pipeline"`` gives it; a one-stage world is one
    card's layout."""
    cfg = pp_config()
    for s in (0, 1):
        layout = llama.rank_layout(cfg, {"pp": 2}, {"pp": s})
        assert layout["blocks.1.wq"][0] == f"blocks.{2 * s + 1}.wq"
        assert layout["embed"] == ("embed", (slice(0, 128), slice(0, 32)))
        model = params_from_numpy(tree, cfg, "cpu", mesh=FakeMesh(pp=2),
                                  specs="pipeline") if s == 0 else None
        if model is not None:
            assert len(model.blocks) == 2
            assert np.array_equal(model.blocks[1].wq.numpy(),
                                  tree["blocks"]["wq"][1])
    one = llama.train_state_bytes(cfg)
    stage = llama.train_state_bytes(cfg, {"pp": 2})
    per_layer = (one - llama.train_state_bytes(
        dataclasses.replace(cfg, n_layers=0))) // 4
    assert stage == one - 2 * per_layer
    assert llama.rank_layout(cfg, {"pp": 1}) == llama.rank_layout(cfg)
    with pytest.raises(ValueError, match="layer stack"):
        llama.rank_layout(cfg, {"pp": 3})


def test_pp_of_one_stage_is_the_one_card_step(tokens):
    """A one-stage GPipe step (no mesh) matches ``make_train_step``'s
    loss and weights: the microbatches only split the sum."""
    cfg = pp_config(True)
    a = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    step_a = llama.make_train_step(cfg, None, llama.make_optimizer(a, LR))
    step_b = pipeline.make_pp_train_step(cfg, None,
                                         llama.make_optimizer(b, LR), 4)
    batch = batch_of(tokens)
    la = [float(step_a(a, batch)) for _ in range(STEPS)]
    lb = [float(step_b(b, batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   atol=1e-5, rtol=0)
