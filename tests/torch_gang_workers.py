"""Rank workers of the port's gang-serving tests
(``tests/test_torch_gang_serve.py``). ``parallel.spawn`` pickles a worker
by its module and name and every rank re-imports that module, so the
workers live here, in a module that imports no JAX. Each world function
runs on every rank of a gloo world on the CPU and returns that rank's
results; the test holds them to the JAX package and to the port's
``mesh=None`` path."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from k8s_gpu_scheduler_tpu_torch.bridge import (
    params_from_numpy, params_to_numpy)
from k8s_gpu_scheduler_tpu_torch.models import lifecycle, llama, serving
from k8s_gpu_scheduler_tpu_torch.models.llama import (
    LlamaConfig, init_params, make_optimizer, make_train_step)
from k8s_gpu_scheduler_tpu_torch.models.serving import (
    make_server_step, vocab_parallel_argmax)
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from k8s_gpu_scheduler_tpu_torch.parallel import (
    MeshSpec, make_mesh, multislice_mesh)
from k8s_gpu_scheduler_tpu_torch.parallel.mesh import MeshAxes

# The JAX serving tests' f32 config (``tests/test_models.py``
# ``TestServing.f32_cfg``), decoded through K4.
SERVE_F32 = dict(vocab=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=64, max_seq=64, remat=False)
# The JAX dryrun's multislice config (``__graft_entry__.py``), at f32.
MULTISLICE = dict(vocab=256, d_model=64, n_layers=2, n_heads=8, n_kv_heads=8,
                  d_ff=128, max_seq=64, remat=True)
MULTISLICE_LR = 1e-3
# K4's split plan differs between a rank and one card only past a few
# 64-row chunks: a tiny config with room for a 400-token prompt.
PLAN_CELL = dict(max_seq=512, prompt=400, batch=8, max_new=3)
# The card's cell: the kernels take head dims 64 and 128 only.
CARD_CELL = dict(max_seq=512, d_model=256, n_heads=4, n_kv_heads=4,
                 d_ff=512)


def serve_config(**kw) -> LlamaConfig:
    """A tiny f32 serving config decoded through K4 (``decode_attn``
    "fused")."""
    base = {**dataclasses.asdict(LlamaConfig.tiny()), **kw}
    return dataclasses.replace(LlamaConfig(**base), dtype=torch.float32,
                               decode_attn="fused")


def rank_setup(world: int, axes: dict):
    torch.set_num_threads(1)
    return make_mesh(MeshSpec.for_devices(world, **axes), "cpu")


class CacheSpy:
    """Records the shape of every cache ``generate`` allocates and every
    split count K4's wrapper plans, while installed."""

    def __init__(self):
        self.shapes, self.splits = [], []
        self._init, self._k4 = serving.init_cache, serving.flash_decode_attention

    def __enter__(self):
        def init_cache(*a, **kw):
            cache = self._init(*a, **kw)
            self.shapes.append(tuple(cache["k"].shape))
            return cache

        def k4(*a, **kw):
            out = self._k4(*a, **kw)
            self.splits.append(self._k4.last_splits)
            return out

        serving.init_cache, serving.flash_decode_attention = init_cache, k4
        return self

    def __exit__(self, *exc):
        serving.init_cache = self._init
        serving.flash_decode_attention = self._k4


def serve_cell(tree, cfg, mesh, prompt, max_new, max_len):
    """``make_server_step(cfg, mesh, ...)`` on this rank's training blocks
    of the JAX tree (``tree`` None: ``init_params`` from seed 0 on the
    mesh): the streams, the caches allocated, K4's split counts and the
    plain-version calls."""
    model = (params_from_numpy(tree, cfg, "cpu", mesh=mesh,
                               specs="training") if tree is not None
             else init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                              mesh=mesh))
    step = make_server_step(cfg, mesh, max_new, max_len=max_len)
    da.reset_counters()
    with CacheSpy() as spy:
        out = step(model, torch.from_numpy(prompt))
    return dict(streams=out.numpy(), dtype=str(out.dtype),
                cache_shapes=spy.shapes, splits=spy.splits,
                counters=da.counters(), coords=MeshAxes(mesh).index)


def multislice_step(rank, world, tree, tokens):
    """One AdamW(1e-3) step of ``make_train_step`` on
    ``multislice_mesh(2, fsdp=2, tp=2)`` from the JAX tree: the loss, the
    rank's blocks after it and its coordinates."""
    cfg = dataclasses.replace(LlamaConfig(**MULTISLICE), dtype=torch.float32)
    mesh = multislice_mesh(2, fsdp=2, tp=2, device_type="cpu")
    model = params_from_numpy(tree, cfg, "cpu", trainable=True, mesh=mesh,
                              specs="training")
    step = make_train_step(cfg, mesh, make_optimizer(model, MULTISLICE_LR))
    t = torch.from_numpy(tokens)
    loss = float(step(model, {"tokens": t, "targets": torch.roll(t, -1, 1)}))
    return dict(loss=loss, blocks=params_to_numpy(model),
                coords=MeshAxes(mesh).index, names=mesh.mesh_dim_names)


def world_eight(rank, world, trees, prompts, ms_tokens):
    """The world of 8: JAX's sharded-cache test mesh (fsdp 2, tp 2, dp 2)
    and JAX ``main()``'s B = 1 at tp 4 (dp 2: one padded row), then the
    multislice training step."""
    out = {}
    mesh = rank_setup(world, {"fsdp": 2, "tp": 2})
    out["fsdp2-tp2"] = serve_cell(trees["serve"], serve_config(**SERVE_F32),
                                  mesh, prompts["fsdp2-tp2"], 5, 32)
    mesh = rank_setup(world, {"tp": 4})
    out["b1-tp4"] = serve_cell(trees["gqa"], serve_config(n_kv_heads=4),
                               mesh, prompts["b1-tp4"], 6, 32)
    out["multislice"] = multislice_step(rank, world, trees["multislice"],
                                        ms_tokens)
    return out


# (name, MeshSpec.for_devices axes, config overrides, B) of the world of 2.
TWO_CELLS = (("tp2", {"tp": 2}, {}, 4),
             ("dp2", {}, {}, 3),
             ("gqa-tp2", {"tp": 2}, {"n_kv_heads": 2}, 4),
             ("fsdp2", {"fsdp": 2}, {"n_kv_heads": 2}, 2),
             ("moe-ep2", {"ep": 2}, {"n_experts": 4}, 2))


def two_prompts(cfg_kw, B, T=8, seed=0):
    cfg = serve_config(**cfg_kw)
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T))


def world_two(rank, world, tie_logits):
    """The world of 2: the cells of ``TWO_CELLS`` and K4's plan cell
    (``init_params`` from seed 0 on the mesh), and the vocab-split
    argmax of ``tie_logits`` at tp 2."""
    out = {}
    for name, axes, kw, B in TWO_CELLS:
        out[name] = serve_cell(None, serve_config(**kw),
                               rank_setup(world, axes), two_prompts(kw, B),
                               4, 32)
    p = PLAN_CELL
    mesh = rank_setup(world, {"tp": 2})
    out["plan"] = serve_cell(None, serve_config(max_seq=p["max_seq"]), mesh,
                             two_prompts({}, p["batch"], p["prompt"], 1),
                             p["max_new"], p["max_seq"])
    ax = MeshAxes(mesh)
    cols = tie_logits.shape[-1] // 2
    block = torch.from_numpy(tie_logits)[..., rank * cols:(rank + 1) * cols]
    out["argmax"] = vocab_parallel_argmax(block, ax).numpy()
    return out


# -- main() on a gang --------------------------------------------------------

class AfterWaves(lifecycle.PreemptionGuard):
    """A guard whose drain request comes at the wave boundary after two
    waves (the first read is before the first wave)."""

    waves = 2

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.reads = 0

    @property
    def requested(self):
        self.reads += 1
        return self.reads > self.waves or super().requested


def _tiny_serve() -> LlamaConfig:
    return dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               n_kv_heads=4)


def world_serve_main(rank, world, port, argv, waves):
    """``main(argv)``'s ``--serve`` as one worker of a gang of ``world``:
    the gang env, a tiny config, the loop stopped after ``waves`` waves,
    and the publisher recorded. Returns the serve lines this worker
    printed and the publisher's ``n_devices`` and values."""
    import contextlib
    import functools
    import io

    from k8s_gpu_scheduler_tpu_torch.parallel import distributed
    from k8s_gpu_scheduler_tpu_torch.recommender import collector

    torch.set_num_threads(1)
    os.environ["TPU_WORKER_HOSTNAMES"] = ",".join(["localhost"] * world)
    os.environ["TPU_WORKER_ID"] = str(rank)
    os.environ.pop("HOSTNAME", None)
    distributed.COORDINATOR_PORT = port
    llama.LlamaConfig.serve = staticmethod(_tiny_serve)
    llama.gang_serve_loop = functools.partial(
        llama.gang_serve_loop, max_waves=waves, sleep=lambda s: None)
    published = {"n_devices": [], "values": []}

    def publisher(n_devices=1, **kw):
        published["n_devices"].append(n_devices)
        return lambda *a, **k: published["values"].append(a)

    collector.make_workload_publisher = publisher
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        llama.main(argv, device="cpu", backend="gloo")
    return dict(lines=[ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("llama serve")], **published)


def local_serve_main(port, argv):
    """``main(argv, local_ranks=2)``'s ``--serve``, run as a process of its
    own (``python -c``): one worker that starts two local ranks (new
    processes, to which ``main`` hands the tiny config and a guard that
    stops after two waves). They print to this process's output."""
    from k8s_gpu_scheduler_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    os.environ.pop("TPU_WORKER_HOSTNAMES", None)
    distributed.COORDINATOR_PORT = port
    llama.LlamaConfig.serve = staticmethod(_tiny_serve)
    lifecycle.PreemptionGuard = AfterWaves
    llama.main(argv, device="cpu", backend="gloo", local_ranks=2)


def card_gang_world(rank, world, axes):
    """On the card (every rank on card 0): ``PLAN_CELL``'s prompt, at
    ``CARD_CELL``'s widths (head dim 64), through ``generate`` on ``MeshSpec.for_devices(world, **axes)`` and, on rank
    0, with ``mesh=None``, at f32 (TF32 off). Returns each run's streams,
    K4's split counts and the kernels' counters."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    p = PLAN_CELL
    cfg = serve_config(**CARD_CELL)
    prompt = two_prompts({}, p["batch"], p["prompt"], 1)

    def run(mesh):
        model = init_params(cfg, torch.Generator().manual_seed(0), dev,
                            mesh=mesh)
        da.reset_counters()
        with CacheSpy() as spy:
            out = make_server_step(cfg, mesh, p["max_new"],
                                   max_len=p["max_seq"])(
                model, torch.from_numpy(prompt).to(dev))
        torch.cuda.synchronize()
        return dict(streams=out.cpu().numpy(), splits=spy.splits,
                    counters=da.counters())

    out = {"mesh": run(make_mesh(MeshSpec.for_devices(world, **axes),
                                 "cuda"))}
    if rank == 0:
        out["one"] = run(None)
    return out
