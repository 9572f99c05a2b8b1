"""Weight-only int8 on a gang's mesh in the port
(``quantize_llama_params(model, mesh=)``, ``params_from_numpy(...,
specs="training")`` of an int8 tree, ``make_server_step(mesh=)`` on the
rank's int8 blocks), against the JAX package and the port's ``mesh=None``
path, on the CPU.

The port runs in one gloo world of 4 CPU processes (``parallel.spawn``)
that serves two cells: the f32 serving config of
``tests/test_torch_gang_serve.py`` at ``{fsdp 2, tp 2}`` and its MoE
variant (4 experts, top 2) at ``{ep 2, tp 2}``. Weights are JAX's
``init_params`` (key 0) carried across by the bridge, or the port's own
``init_params`` (seed 0) on the mesh; prompts come from numpy seeds. The
rank workers are in ``tests/torch_gang_int8_workers.py``, which imports no
JAX. The JAX references: ``quantize_weight`` of each whole leaf, cut to
the rank's block (``q`` by the leaf's ``param_specs`` spec, the scale by
the same with the contraction dim whole), and ``make_server_step(cfg,
mesh, ...)`` on conftest's 8 virtual devices with the same mesh axes.

Tolerances: exact for every rank's ``q`` and ``s`` (bit for bit), for its
bytes, and for the f32 greedy streams (token for token)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu.models import serving as jserving
from k8s_gpu_scheduler_tpu.ops import quant as jquant
from k8s_gpu_scheduler_tpu.parallel import MeshSpec as JMeshSpec
from k8s_gpu_scheduler_tpu.parallel import make_mesh as j_make_mesh
from k8s_gpu_scheduler_tpu_torch.bridge import (
    params_from_numpy, params_to_numpy)
from k8s_gpu_scheduler_tpu_torch.models import llama
from k8s_gpu_scheduler_tpu_torch.models.serving import generate
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params
from k8s_gpu_scheduler_tpu_torch.parallel import spawn
from k8s_gpu_scheduler_tpu_torch.parallel.sharding import rank_slice
from torch_gang_int8_workers import CELLS, MAX_LEN, world_int8
from torch_gang_workers import CacheSpy, serve_config

WORLD_TIMEOUT = 300
BY_NAME = {c[0]: c for c in CELLS}
NAMES = list(BY_NAME)


def jcfg(kw):
    return dataclasses.replace(jllama.LlamaConfig(**kw), dtype=jnp.float32)


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """JAX's init (key 0) of each cell's config, as numpy."""
    return {name: as_numpy(jllama.init_params(jcfg(kw),
                                              jax.random.PRNGKey(0)))
            for name, _, kw, _, _ in CELLS}


@pytest.fixture(scope="module")
def qtrees(trees):
    """JAX's ``quantize_llama_params`` of each tree, as numpy."""
    return {k: as_numpy(jquant.quantize_llama_params(
        jax.tree.map(jnp.asarray, t))) for k, t in trees.items()}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(2)
    return {name: rng.integers(0, kw["vocab"], (B, 8))
            for name, _, kw, B, _ in CELLS}


@pytest.fixture(scope="module")
def world(trees, qtrees, prompts, tmp_path_factory):
    """The world of 4, spawned once for the file."""
    d = tmp_path_factory.mktemp("int8gang")
    return spawn(world_int8, 4, "gloo", args=(trees, qtrees, prompts),
                 rendezvous=str(d / "rdv"), timeout=WORLD_TIMEOUT)


def scale_spec(spec):
    """A scale ``[..., 1, N]``'s spec: the weight's, its K dim whole."""
    return spec[:-2] + (None,) + spec[-1:]


def assert_rank_cut(got, whole, cfg, sizes, coords):
    """Every leaf of the rank's tree ``got`` is exactly its cut of the
    whole tree ``whole``: a plain leaf by ``param_specs``, an int8 leaf's
    ``q`` by the same spec and its scale by ``scale_spec``."""
    specs = llama.param_specs(cfg)
    leaves = [(k, got[k], whole[k], specs[k])
              for k in ("embed", "final_norm", "lm_head")] + [
        (k, a, whole["blocks"][k], specs["blocks"][k])
        for k, a in got["blocks"].items()]
    assert set(got["blocks"]) == set(whole["blocks"])
    for key, a, w, spec in leaves:
        if isinstance(w, dict):
            assert isinstance(a, dict), key
            pairs = ((a["q"], w["q"], spec), (a["s"], w["s"],
                                              scale_spec(spec)))
        else:
            pairs = ((a, w, spec),)
        for mine, full, sp in pairs:
            cut = rank_slice(np.asarray(full), sp, sizes, coords)
            assert mine.dtype == cut.dtype, key
            np.testing.assert_array_equal(mine, cut, err_msg=key)


def port_whole_init(cfg):
    """The port's ``init_params`` (seed 0) of the whole model, as numpy:
    what each rank's ``init_params(..., mesh=)`` cuts."""
    return params_to_numpy(llama.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))


SOURCES = ("init", "bridged", "jax")


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("name", NAMES)
def test_rank_int8_blocks_are_the_cut_of_jax_whole_leaf_quantization(
        world, trees, qtrees, name, source):
    """Each rank's int8 blocks equal, bit for bit, the cut of JAX's
    ``quantize_weight`` of every whole leaf (the router, norms and
    embedding plain): ``init``, the rank quantizing its own
    ``init_params(..., mesh=)`` blocks (JAX quantizes the port's whole
    init); ``bridged``, quantizing its bridged blocks of JAX's init;
    ``jax``, ``params_from_numpy(..., specs="training")`` of JAX's
    quantized tree. The scale's max crosses ranks: fsdp splits K of
    q/k/v/gate/up and the lm_head, tp that of o/down."""
    _, _, kw, _, _ = BY_NAME[name]
    cfg = serve_config(**kw)
    whole = (as_numpy(jquant.quantize_llama_params(jax.tree.map(
        jnp.asarray, port_whole_init(cfg)))) if source == "init"
        else qtrees[name])
    for r in world:
        cell = r[name]
        assert_rank_cut(cell[source], whole, cfg, cell["sizes"],
                        cell["coords"])


@pytest.mark.parametrize("name", NAMES)
def test_rank_quantization_equals_the_bridged_jax_quantization(world, name):
    """A rank that quantizes its bridged blocks holds exactly what the
    bridge cuts from JAX's quantized tree."""
    for r in world:
        a, b = r[name]["bridged"], r[name]["jax"]
        flat_a, flat_b = (jax.tree_util.tree_leaves_with_path(t)
                          for t in (a, b))
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (path, x), (_, y) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(x, y, err_msg=str(path))


def jax_streams(tree, kw, axes, prompt, max_new):
    mesh = j_make_mesh(JMeshSpec.for_devices(8, **axes), jax.devices())
    step = jserving.make_server_step(jcfg(kw), mesh, max_new,
                                     max_len=MAX_LEN)
    return np.asarray(step(jax.tree.map(jnp.asarray, tree),
                           jnp.asarray(prompt)))


def port_one_device(tree, cfg, prompt, max_new):
    """The port's ``mesh=None`` int8 ``generate`` of JAX's init: streams,
    K4's split counts and the kernels' counters."""
    model = quantize_llama_params(params_from_numpy(tree, cfg, "cpu"))
    da.reset_counters()
    with CacheSpy() as spy:
        out = generate(model, torch.from_numpy(prompt), cfg, max_new,
                       max_len=MAX_LEN)
    return dict(streams=out.numpy(), splits=spy.splits,
                counters=da.counters())


@pytest.fixture(scope="module")
def references(trees, qtrees, prompts):
    """Per cell: JAX's mesh streams and the port's one-device run."""
    out = {}
    for name, axes, kw, _, max_new in CELLS:
        out[name] = (jax_streams(qtrees[name], kw, axes, prompts[name],
                                 max_new),
                     port_one_device(trees[name], serve_config(**kw),
                                     prompts[name], max_new))
    return out


@pytest.mark.parametrize("source", ("bridged", "jax"))
@pytest.mark.parametrize("name", NAMES)
def test_int8_streams_on_a_mesh_match_jax_and_one_device(
        world, references, name, source):
    """f32 greedy ``make_server_step(cfg, mesh, ...)`` on every rank's
    int8 blocks (``bridged``: quantized on the rank; ``jax``: cut from
    JAX's quantized tree) returns JAX's ``make_server_step`` on the same
    mesh axes over 8 devices, token for token, and the port's
    ``mesh=None`` int8 ``generate``; K4's plain version ran once a layer
    a token after the prefill, at one card's split counts."""
    _, _, kw, _, max_new = BY_NAME[name]
    cfg = serve_config(**kw)
    want, one = references[name]
    np.testing.assert_array_equal(one["streams"], want)
    for r in world:
        got = r[name]["streams"][source]
        np.testing.assert_array_equal(got["streams"], want)
        assert got["splits"] == one["splits"]
        assert got["counters"] == one["counters"]
        assert got["counters"]["flash_decode_reference"] == \
            cfg.n_layers * (max_new - 1)


@pytest.mark.parametrize("name", NAMES)
def test_rank_holds_only_its_int8_blocks(world, name):
    """A rank's parameters and buffers are exactly
    ``rank_leaf_shapes(cfg, sizes, int8=True)`` (each quantized leaf's
    ``q`` int8 and its K-whole scale f32, no leaf whole unless its spec
    keeps it whole), and a whole int8 model on the mesh is refused."""
    _, axes, kw, _, _ = BY_NAME[name]
    cfg = serve_config(**kw)
    for r in world:
        cell = r[name]
        held, want = cell["shapes"]
        assert held == want
        assert cell["bytes"][0] == cell["bytes"][1]
        whole_q = (cfg.d_model, cfg.n_heads * cfg.head_dim)
        assert held["blocks.0.wq.q"][0] != whole_q
        assert "the model's wq is " + str(whole_q) in cell["whole_refused"]


def test_int8_rank_shapes_cut_each_scale_by_its_columns():
    """``rank_leaf_shapes(int8=True)`` at {fsdp 2, tp 2}: ``q`` is the
    weight's block, the scale keeps K at 1 and cuts N as ``q`` does (tp
    for q/k/v/gate/up and the lm_head, fsdp for o/down)."""
    cfg = serve_config(**BY_NAME["dense"][2])
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    sizes = {"fsdp": 2, "tp": 2}
    shapes = llama.rank_leaf_shapes(cfg, sizes, int8=True)
    assert shapes["blocks.0.wq.q"] == ((D // 2, cfg.n_heads * cfg.head_dim
                                        // 2), torch.int8)
    assert shapes["blocks.0.wq.s"] == ((1, cfg.n_heads * cfg.head_dim // 2),
                                       torch.float32)
    assert shapes["blocks.0.wo.s"] == ((1, D // 2), torch.float32)
    assert shapes["blocks.0.w_down.q"] == ((F // 2, D // 2), torch.int8)
    assert shapes["lm_head.s"] == ((1, V // 2), torch.float32)
    assert shapes["embed"] == ((V // 2, D // 2), cfg.dtype)
    plain = llama.rank_leaf_shapes(cfg, sizes)
    assert shapes["blocks.1.attn_norm"] == plain["blocks.1.attn_norm"]
    assert "blocks.0.wq" not in shapes
