"""Rank workers of the port's sharded-training tests
(``tests/test_torch_shard_train.py``). ``parallel.spawn`` pickles a worker
by its module and name, and every rank re-imports that module, so the
workers live here, in a module that imports no JAX. Each world function
runs on every rank of a gloo world on the CPU and returns that rank's
results; the test holds them to the JAX package and to the port's
``mesh=None`` step."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from k8s_gpu_scheduler_tpu_torch.bridge import (
    params_from_numpy, params_to_numpy)
from k8s_gpu_scheduler_tpu_torch.models import llama
from k8s_gpu_scheduler_tpu_torch.models.llama import (
    LlamaConfig, make_optimizer, make_train_step)
from k8s_gpu_scheduler_tpu_torch.ops.attention import (
    ring_attention, ulysses_attention)
from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
    counters, reset_counters)
from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh
from k8s_gpu_scheduler_tpu_torch.parallel.mesh import MeshAxes

STEPS = 2          # AdamW steps a cell takes
LR = 3e-4


def config(attn_impl: str = "dense", n_kv_heads: int = 8,
           **kw) -> LlamaConfig:
    """The tiny config at f32 with remat (every cell recomputes its
    blocks' collectives in the backward)."""
    return dataclasses.replace(LlamaConfig.tiny(attn_impl),
                               dtype=torch.float32, n_kv_heads=n_kv_heads,
                               remat=True, **kw)


def mesh_of(world: int, axes: dict):
    """``MeshSpec.for_devices(world, **axes)`` over the world (dp takes
    the rest), on the CPU."""
    return make_mesh(MeshSpec.for_devices(world, **axes), "cpu")


def batch_of(tokens: np.ndarray) -> dict:
    t = torch.from_numpy(tokens)
    return {"tokens": t, "targets": torch.roll(t, -1, dims=1)}


def train_cell(tree, tokens, cfg, mesh, steps=STEPS):
    """``steps`` AdamW steps of the sharded step from the JAX tree: the
    losses, the rank's blocks after them (JAX layout), the rank's
    parameter elements and bytes, its optimizer moments' bytes and its
    plain flash calls."""
    model = params_from_numpy(tree, cfg, "cpu", trainable=True, mesh=mesh,
                              specs="training")
    opt = make_optimizer(model, LR)
    step = make_train_step(cfg, mesh, opt)
    batch = batch_of(tokens)
    reset_counters()
    losses = [float(step(model, batch)) for _ in range(steps)]
    moments = sum(t.numel() * t.element_size()
                  for st in opt.state.values()
                  for k, t in st.items() if k in ("exp_avg", "exp_avg_sq"))
    return dict(
        losses=losses, blocks=params_to_numpy(model),
        numel=sum(p.numel() for p in model.parameters()),
        bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
        grad_bytes=sum(p.grad.numel() * p.grad.element_size()
                       for p in model.parameters()),
        moment_bytes=moments, coords=MeshAxes(mesh).index,
        sizes=MeshAxes(mesh).sizes, calls=counters())


def world_cells(rank, world, tree, gqa_tree, tokens, cells):
    """Every (name, attn_impl, mesh axes, gqa) cell of ``cells`` on this
    world, one after the other."""
    torch.set_num_threads(1)
    out = {}
    for name, impl, axes, gqa in cells:
        cfg = config(impl, 2 if gqa else 8)
        out[name] = train_cell(gqa_tree if gqa else tree, tokens, cfg,
                               mesh_of(world, axes))
    return out


def world_attention(rank, world, q, k, v, do, sp_axes):
    """``ring_attention`` and ``ulysses_attention`` alone over an ``sp``
    group of the world: this rank's output and q/k/v gradients for its
    sequence block of the global q/k/v [B, T, H(kv), d], and the
    refusal of a head count sp does not divide."""
    torch.set_num_threads(1)
    mesh = mesh_of(world, sp_axes)
    ax = MeshAxes(mesh)
    group, n, i = ax.group("sp"), ax.size("sp"), ax.index["sp"]
    t = q.shape[1] // n
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        xs = [torch.from_numpy(np.ascontiguousarray(a[:, i * t:(i + 1) * t]))
              .requires_grad_() for a in (q, k, v)]
        o = fn(*xs, group, causal=True)
        o.backward(torch.from_numpy(np.ascontiguousarray(
            do[:, i * t:(i + 1) * t])))
        out[name] = [o.detach().numpy()] + [x.grad.numpy() for x in xs]
    try:
        bad = torch.zeros((1, t, 3, 4))
        ulysses_attention(bad, bad, bad, group)
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def world_resume(rank, world, ckpt_dir, tokens):
    """Four steps straight against two steps saved at step 2 by a
    sharded ``TrainCheckpointer`` and steps 3-4 on fresh objects restored
    from it (tp 2, flash, remat); then a mesh of another shape must be
    refused. Returns both runs' losses and the refusal."""
    from k8s_gpu_scheduler_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)

    torch.set_num_threads(1)
    cfg = config("flash", 2)
    mesh = mesh_of(world, {"tp": world})
    batch = batch_of(tokens)

    def fresh():
        model = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu", mesh=mesh)
        return model, make_optimizer(model, LR)

    ref = [x.item() for x in llama.train_loop(*fresh(), batch, mesh=mesh,
                                              max_steps=4, worker=rank)]
    first = llama.train_loop(*fresh(), batch,
                             TrainCheckpointer(ckpt_dir, mesh=mesh),
                             every=2, max_steps=2, mesh=mesh, worker=rank)
    ck = TrainCheckpointer(ckpt_dir, mesh=mesh)
    step_no, (model, opt) = ck.restore_or(fresh)
    rest = llama.train_loop(model, opt, batch, ck, step_no=step_no, every=2,
                            max_steps=4, mesh=mesh, worker=rank)
    other = TrainCheckpointer(ckpt_dir, mesh=mesh_of(world, {"fsdp": world}))
    try:
        other.restore_or(fresh)
        refusal = None
    except NotImplementedError as e:
        refusal = str(e)
    return dict(ref=ref, resumed=[x.item() for x in first + rest],
                step_no=step_no, steps=ck.all_steps(),
                files=sorted(os.listdir(os.path.join(ckpt_dir, "2"))),
                refusal=refusal)


def world_init(rank, world, axes):
    """``init_params(..., mesh=)`` on this rank: its blocks as numpy (JAX
    layout) and its coordinates."""
    torch.set_num_threads(1)
    cfg = config("dense", 2)
    mesh = mesh_of(world, axes)
    model = llama.init_params(cfg, torch.Generator().manual_seed(4), "cpu",
                              mesh=mesh)
    return dict(blocks=params_to_numpy(model), sizes=MeshAxes(mesh).sizes,
                index=MeshAxes(mesh).index)


def world_main(rank, world, port, argv, bt, max_steps):
    """``main()``'s gang training as one worker of a gang of ``world``:
    the gang env (``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID``), a tiny
    config and batch ``bt`` patched in, and the loop stopped after step
    ``max_steps``.
    Returns the pretrain lines this worker printed."""
    import contextlib
    import functools
    import io

    from k8s_gpu_scheduler_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    os.environ["TPU_WORKER_HOSTNAMES"] = ",".join(["localhost"] * world)
    os.environ["TPU_WORKER_ID"] = str(rank)
    os.environ.pop("HOSTNAME", None)
    distributed.COORDINATOR_PORT = port
    llama.LlamaConfig.llama3_8b = staticmethod(
        lambda: config("flash", 2))
    llama.TRAIN_BATCH = bt
    llama.train_loop = functools.partial(llama.train_loop,
                                         max_steps=max_steps)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        llama.main(argv, device="cpu", backend="gloo")
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("llama pretrain")]


def card_train_world(rank, world, axes):
    """On the card (every rank on card 0): three f32 steps of a small
    config with flash attention (the kernels K5-K7 at hd 64) on the mesh
    ``MeshSpec.for_devices(world, **axes)``, and, on rank 0, the same
    steps with ``mesh=None``. Returns each run's losses and kernel
    launches."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(config("flash", 2), d_model=256, n_heads=4,
                              d_ff=512)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 128))
    batch = {k: v.to(dev) for k, v in batch_of(tokens).items()}

    def run(mesh):
        model = llama.init_params(cfg, torch.Generator().manual_seed(0), dev,
                                  mesh=mesh)
        step = make_train_step(cfg, mesh, make_optimizer(model, LR))
        reset_counters()
        losses = [float(step(model, batch)) for _ in range(3)]
        torch.cuda.synchronize()
        return dict(losses=losses, launches=counters())

    mesh = make_mesh(MeshSpec.for_devices(world, **axes), "cuda")
    out = {"mesh": run(mesh)}
    if rank == 0:
        out["one"] = run(None)
    return out
