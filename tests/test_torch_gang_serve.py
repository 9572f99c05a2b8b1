"""Gang serving in the port (``generate``/``make_server_step(mesh=)`` and
``main --serve`` on more than one rank) and the multislice training step,
against the JAX package on the same mesh and against the port's
``mesh=None`` path, on the CPU.

The port runs in gloo worlds of CPU processes (``parallel.spawn``): one
world of 8 (JAX's sharded-cache test mesh, ``for_devices(8, fsdp=2,
tp=2)``; JAX ``main()``'s B = 1 at ``for_devices(8, tp=4)``; the
multislice step on ``multislice_mesh(2, fsdp=2, tp=2)``), one world of 2
(tp 2, dp 2 with a padded row, GQA at tp 2, fsdp 2, K4's split plan and
the vocab-split argmax), and ``main()`` as a gang of two workers and as
one worker of two local ranks. The rank workers are in
``tests/torch_gang_workers.py``, which imports no JAX. The JAX references
run on the eight virtual CPU devices of ``tests/conftest.py``.

Tolerances: greedy streams identical (f32); the multislice loss to 1e-5
relative and its weights to 1e-5 outside AdamW's eps zone (where JAX's
gradient is below 1e-6 a weight may move by up to 2 lr; at most 4 such
entries, ``tests/test_torch_ep.py``'s rule)."""
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu.models import serving as jserving
from k8s_gpu_scheduler_tpu.parallel import MeshSpec as JMeshSpec
from k8s_gpu_scheduler_tpu.parallel import make_mesh as j_make_mesh
from k8s_gpu_scheduler_tpu.parallel import multislice_mesh as j_multislice
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models import llama
from k8s_gpu_scheduler_tpu_torch.models.serving import generate
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from k8s_gpu_scheduler_tpu_torch.parallel import spawn
from k8s_gpu_scheduler_tpu_torch.parallel.sharding import rank_slice
from torch_gang_workers import (
    MULTISLICE, MULTISLICE_LR, PLAN_CELL, SERVE_F32, TWO_CELLS, CacheSpy,
    serve_config, two_prompts, world_eight, world_serve_main, world_two)

WORLD_TIMEOUT = 300
ADAM_ZONE = 1e-6
LINE = (r"^llama serve qps=[\d.]+ decode_tok_s=[\d.]+ prefill_tok=(\d+) "
        r"slo=[\d.]+$")


def jcfg(**kw):
    return dataclasses.replace(jllama.LlamaConfig(**kw), dtype=jnp.float32)


JCFGS = {"serve": jcfg(**SERVE_F32),
         "gqa": dataclasses.replace(jllama.LlamaConfig.tiny(),
                                    dtype=jnp.float32, n_kv_heads=4),
         "multislice": jcfg(**MULTISLICE)}


@pytest.fixture(scope="module")
def trees():
    """The JAX init (key 0) of each config, as numpy."""
    return {k: jax.tree.map(np.asarray, jllama.init_params(
        c, jax.random.PRNGKey(0))) for k, c in JCFGS.items()}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return {"fsdp2-tp2": rng.integers(0, SERVE_F32["vocab"], (4, 8)),
            "b1-tp4": rng.integers(0, 256, (1, 8))}


@pytest.fixture(scope="module")
def ms_tokens():
    return np.random.default_rng(11).integers(0, MULTISLICE["vocab"], (8, 64))


# Logits [3, 8] split into two vocab blocks of 4: equal maxima on both
# ranks (row 0), equal maxima inside rank 1's block (row 1), and a
# strictly larger logit on rank 1 (row 2).
TIE_LOGITS = np.array([[0, 3, 1, 0, 0, 1, 3, 0],
                       [0, 1, 0, 0, 2, 5, 0, 5],
                       [4, 0, 0, 0, 0, 0, 4.5, 0]], np.float32)


@pytest.fixture(scope="module")
def worlds(trees, prompts, ms_tokens, tmp_path_factory):
    """The world of 8, then the world of 2 (one at a time: at most eight
    rank processes load the CPU at once)."""
    runs = {8: (world_eight, (trees, prompts, ms_tokens)),
            2: (world_two, (TIE_LOGITS,))}
    out = {}
    for world, (fn, args) in runs.items():
        d = tmp_path_factory.mktemp(f"gang{world}")
        out[world] = spawn(fn, world, "gloo", args=args,
                           rendezvous=str(d / "rdv"), timeout=WORLD_TIMEOUT)
    return out


def port_reference(tree, cfg, prompt, max_new, max_len):
    """The port's ``mesh=None`` generate: streams, cache shapes, K4 splits
    and plain calls."""
    model = (params_from_numpy(tree, cfg, "cpu") if tree is not None
             else llama.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"))
    da.reset_counters()
    with CacheSpy() as spy:
        out = generate(model, torch.from_numpy(prompt), cfg, max_new,
                       max_len=max_len)
    return dict(streams=out.numpy(), cache_shapes=spy.shapes,
                splits=spy.splits, counters=da.counters())


def jax_streams(tree, key, prompt, max_new, mesh_axes):
    mesh = j_make_mesh(JMeshSpec.for_devices(8, **mesh_axes), jax.devices())
    step = jserving.make_server_step(JCFGS[key], mesh, max_new, max_len=32)
    return np.asarray(step(jax.tree.map(jnp.asarray, tree),
                           jnp.asarray(prompt)))


EIGHT = [("fsdp2-tp2", "serve", {"fsdp": 2, "tp": 2}, 5,
          dict(SERVE_F32)),
         ("b1-tp4", "gqa", {"tp": 4}, 6, dict(n_kv_heads=4))]


@pytest.mark.parametrize("cell,key,axes,max_new,cfg_kw", EIGHT,
                         ids=[c[0] for c in EIGHT])
def test_generate_on_a_mesh_of_eight_matches_jax_and_one_device(
        worlds, trees, prompts, cell, key, axes, max_new, cfg_kw):
    """Every rank's streams are JAX's ``make_server_step`` on the same
    mesh of 8 CPU devices and the port's ``mesh=None``, in the prompt's
    dtype; each rank's cache is [L, B/(dp·fsdp), S, Hkv/tp, hd] (B = 1 on
    dp 2 pads one row); K4's plain version ran once a layer a token after
    the prefill on every rank."""
    prompt = prompts[cell]
    want = jax_streams(trees[key], key, prompt, max_new, axes)
    cfg = serve_config(**cfg_kw)
    ref = port_reference(trees[key], cfg, prompt, max_new, 32)
    np.testing.assert_array_equal(ref["streams"], want)
    sizes = dict(JMeshSpec.for_devices(8, **axes).axes)
    rows = sizes["dp"] * sizes["fsdp"]
    B = prompt.shape[0]
    local = (cfg.n_layers, -(-B // rows), 32, cfg.n_kv_heads // sizes["tp"],
             cfg.head_dim)
    for r in worlds[8]:
        got = r[cell]
        np.testing.assert_array_equal(got["streams"], want)
        assert got["dtype"] == str(torch.from_numpy(prompt).dtype)
        assert got["cache_shapes"] == [local]
        assert got["counters"]["flash_decode_reference"] == \
            cfg.n_layers * (max_new - 1)
        assert got["counters"]["flash_decode_attention"] == 0


def test_mesh_coordinates_are_jaxs_devices():
    """Rank r of each mesh the world of 8 builds sits where JAX puts
    device r (``MeshSpec.for_devices`` and ``multislice_mesh``)."""
    for axes in ({"fsdp": 2, "tp": 2}, {"tp": 4}):
        jm = j_make_mesh(JMeshSpec.for_devices(8, **axes), jax.devices())
        spec = JMeshSpec.for_devices(8, **axes)
        grid = np.arange(8).reshape(spec.shape)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        np.testing.assert_array_equal(ids, grid)
    jm = j_multislice(2, fsdp=2, tp=2, devices=jax.devices())
    np.testing.assert_array_equal(np.vectorize(lambda d: d.id)(jm.devices),
                                  np.arange(8).reshape(2, 2, 1, 1, 2))


def jax_multislice(tree, tokens):
    """JAX's step on ``multislice_mesh(2, fsdp=2, tp=2)``: the loss, the
    weights after it and the first step's gradients (AdamW's zone)."""
    mesh = j_multislice(2, fsdp=2, tp=2, devices=jax.devices())
    cfg = JCFGS["multislice"]
    params = jax.tree.map(jnp.asarray, tree)
    t = jnp.asarray(tokens)
    batch = {"tokens": t, "targets": jnp.roll(t, -1, axis=1)}
    grads = jax.grad(jllama.loss_fn)(params, batch, cfg, mesh)
    opt = optax.adamw(MULTISLICE_LR)
    step = jllama.make_train_step(cfg, mesh, opt)
    params, _, loss = step(params, opt.init(params), batch)
    return (float(loss), jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, grads), mesh)


def test_multislice_training_step_matches_jax(worlds, trees, ms_tokens):
    """``make_train_step(cfg, multislice_mesh(2, fsdp=2, tp=2), adamw)``
    on JAX's dryrun config (f32): every rank's loss within 1e-5 relative
    of JAX's step on the same mesh, its blocks after the step JAX's
    blocks to 1e-5 outside AdamW's eps zone, and rank r at device r's
    mesh coordinates."""
    loss, params, grads, mesh = jax_multislice(trees["multislice"],
                                               ms_tokens)
    cfg = dataclasses.replace(llama.LlamaConfig(**MULTISLICE),
                              dtype=torch.float32)
    specs = llama.param_specs(cfg)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for r, res in enumerate(worlds[8]):
        got = res["multislice"]
        assert got["names"] == mesh.axis_names
        coords = dict(zip(mesh.axis_names,
                          map(int, np.argwhere(np.vectorize(
                              lambda d: d.id)(mesh.devices) == r)[0])))
        assert got["coords"] == coords
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        zone = 0
        leaves = [(k, got["blocks"][k], params[k], grads[k], specs[k])
                  for k in ("embed", "final_norm", "lm_head")] + [
            (k, a, params["blocks"][k], grads["blocks"][k],
             specs["blocks"][k]) for k, a in got["blocks"]["blocks"].items()]
        for key, a, w, g, spec in leaves:
            w, g = (rank_slice(x, spec, sizes, coords) for x in (w, g))
            diff = np.abs(a - w)
            small = np.abs(g) < ADAM_ZONE
            assert diff[~small].max(initial=0) <= 1e-5, key
            assert diff.max() <= 2 * MULTISLICE_LR, key
            zone += int((diff[small] > 1e-5).sum())
        assert zone <= 4, zone


@pytest.mark.parametrize("cell", [c[0] for c in TWO_CELLS])
def test_generate_on_two_ranks_matches_one_device(worlds, cell):
    """tp 2, dp 2 (B 3: one padded row), GQA at tp 2 (one kv head a rank),
    fsdp 2 and an MoE model with its experts over ep 2 (gathered whole,
    routed dropless; ep replicates the work): both ranks return the
    port's ``mesh=None`` streams, and each rank's cache is [L,
    B/(dp·fsdp), S, Hkv/tp, hd]."""
    _, axes, kw, B = next(c for c in TWO_CELLS if c[0] == cell)
    cfg = serve_config(**kw)
    ref = port_reference(None, cfg, two_prompts(kw, B), 4, 32)
    sizes = {"dp": 1, "fsdp": 1, "ep": 1, "tp": 1, **axes}
    sizes["dp"] = 2 // (sizes["fsdp"] * sizes["ep"] * sizes["tp"])
    rows = sizes["dp"] * sizes["fsdp"]
    local = (cfg.n_layers, -(-B // rows), 32, cfg.n_kv_heads // sizes["tp"],
             cfg.head_dim)
    for r in worlds[2]:
        got = r[cell]
        np.testing.assert_array_equal(got["streams"], ref["streams"])
        assert got["cache_shapes"] == [local]
        assert got["counters"] == ref["counters"]


def test_k4_split_count_on_a_rank_is_one_cards(worlds):
    """At tp 2 a rank holds 4 of the 8 kv heads; the split count K4's
    wrapper plans for every decode call of a rank (its host-side
    ``last_splits``) is one card's, which differs from a plan made for
    the rank's own heads at these lengths."""
    p = PLAN_CELL
    cfg = serve_config(max_seq=p["max_seq"])
    prompt = two_prompts({}, p["batch"], p["prompt"], 1)
    ref = port_reference(None, cfg, prompt, p["max_new"], p["max_seq"])
    assert len(ref["splits"]) == cfg.n_layers * (p["max_new"] - 1)
    local = [da.flash_decode_plan(p["prompt"] + 1 + i, p["batch"],
                                  cfg.n_kv_heads // 2)
             for i in range(p["max_new"] - 1) for _ in range(cfg.n_layers)]
    assert local != ref["splits"]
    for r in worlds[2]:
        assert r["plan"]["splits"] == ref["splits"]
        np.testing.assert_array_equal(r["plan"]["streams"], ref["streams"])


def test_vocab_split_argmax_breaks_ties_to_the_lower_index(worlds):
    """Equal maxima on two tp ranks give the lower index (rank 0's), as
    ``torch.argmax`` over the whole vocab; so do equal maxima inside one
    rank's block; a larger logit on rank 1 wins."""
    want = torch.argmax(torch.from_numpy(TIE_LOGITS), dim=-1).numpy()
    np.testing.assert_array_equal(want, [1, 5, 6])
    for r in worlds[2]:
        np.testing.assert_array_equal(r["argmax"], want)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_main_serves_a_gang_of_two_workers(tmp_path):
    """``main(["--serve"])`` as two workers of a gloo gang (the gang env,
    a tiny config, prompt 16, max_new 4, two waves): each worker prints
    JAX's multi-process line twice (prefill_tok = B × prompt = 16) and
    publishes twice, its publisher built with ``n_devices`` 2."""
    import re

    argv = ["--serve", "--prompt-len", "16", "--max-new", "4"]
    res = spawn(world_serve_main, 2, None, args=(_free_port(), argv, 2),
                rendezvous=str(tmp_path / "rdv"), timeout=WORLD_TIMEOUT)
    for r in res:
        assert len(r["lines"]) == 2, r["lines"]
        for ln in r["lines"]:
            m = re.match(LINE, ln)
            assert m and m.group(1) == "16", ln
        assert r["n_devices"] == [2]
        assert len(r["values"]) == 2


def test_main_serves_a_worker_of_two_local_ranks(tmp_path):
    """``main(["--serve"], local_ranks=2)`` on one worker: two ranks on a
    tp 2 mesh serving the paged engine (``ContinuousBatcher(mesh=)``, the
    leader's boot line names the mesh and the layout), the leader
    printing the single-process wave line (with p99) for two waves
    before the guard stops it and the follower."""
    import re

    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    argv = ["--serve", "--prompt-len", "16", "--max-new", "4"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run(
        [sys.executable, "-c", "import sys; from torch_gang_workers import "
         "local_serve_main; local_serve_main(int(sys.argv[1]), sys.argv[2:])",
         str(_free_port()), *argv], env=env, capture_output=True, text=True,
        timeout=WORLD_TIMEOUT, cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    serve = [ln for ln in lines if ln.startswith("llama serve")]
    assert serve[0].startswith("llama serve worker=0 rank=0 mesh={'dp': 1, "
                               "'fsdp': 1, 'sp': 1, 'ep': 1, 'tp': 2}")
    assert serve[0].endswith("kv_layout=paged")
    waves = serve[1:]
    assert len(waves) == 2, lines
    for ln in waves:
        assert re.match(r"^llama serve qps=[\d.]+ decode_tok_s=[\d.]+ "
                        r"prefill_tok=512 slo=[\d.]+ p99_ms=[\d.]+$", ln), ln
