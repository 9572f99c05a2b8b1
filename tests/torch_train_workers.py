"""Rank workers of the port's sharded-training tests
(``tests/test_torch_shard_train.py``). ``parallel.spawn`` pickles a worker
by its module and name, and every rank re-imports that module, so the
workers live here, in a module that imports no JAX. Each world function
runs on every rank of a gloo world on the CPU and returns that rank's
results; the test holds them to the JAX package and to the port's
``mesh=None`` step."""
from __future__ import annotations

import dataclasses
import functools
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


def mesh_of(world: int, axes: dict, device_type: str = "cpu"):
    """``MeshSpec.for_devices(world, **axes)`` over the world (dp takes
    the rest), made once a rank: every mesh makes its process groups,
    each a round through the world's rendezvous."""
    return _mesh(world, tuple(sorted(axes.items())), device_type)


@functools.lru_cache(maxsize=None)
def _mesh(world: int, axes: tuple, device_type: str):
    return make_mesh(MeshSpec.for_devices(world, **dict(axes)), device_type)


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
    from it (tp 2, flash, remat); then step 4 restored onto a mesh of
    another shape (fsdp) takes step 5. Returns both runs' losses and
    step 5's loss on each mesh."""
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
    fifth = float(make_train_step(cfg, mesh, opt)(model, batch))
    fsdp = mesh_of(world, {"fsdp": world})
    other = llama.init_params(cfg, torch.Generator().manual_seed(9), "cpu",
                              mesh=fsdp)
    at, (other, other_opt) = TrainCheckpointer(
        ckpt_dir, mesh=fsdp).restore_or(
            lambda: (other, make_optimizer(other, LR)))
    across = dict(step_no=at, fifth=fifth, loss=float(
        make_train_step(cfg, fsdp, other_opt)(other, batch)))
    return dict(ref=ref, resumed=[x.item() for x in first + rest],
                step_no=step_no, steps=ck.all_steps(),
                files=sorted(os.listdir(os.path.join(ckpt_dir, "2"))),
                across=across)


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


def state_numpy(model, opt) -> dict:
    """A rank's parameters and AdamW state by parameter name, as numpy:
    {name: (weight, exp_avg, exp_avg_sq, step)}."""
    out = {}
    for name, p in model.named_parameters():
        st = opt.state[p]
        out[name] = (p.detach().numpy().copy(),
                     st["exp_avg"].numpy().copy(),
                     st["exp_avg_sq"].numpy().copy(), float(st["step"]))
    return out


def world_restore(rank, world, ckpt_dir):
    """A step saved at step 2 and restored onto other meshes and
    layouts: tp 2 → fsdp 2, tp 2 → pp 2 (a stage), tp 2 → one card
    (every rank alone), one card → tp 2, and ep 2 → one card (MoE).
    Returns each state as saved and as restored (``state_numpy``), the
    step restored at, and the next step's loss on the new mesh."""
    import torch.distributed as dist

    from k8s_gpu_scheduler_tpu_torch.models.pipeline import (
        make_pp_train_step)
    from k8s_gpu_scheduler_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)

    torch.set_num_threads(1)
    cfg, moe = config("dense", 2), moe_config()
    batch = batch_of(np.random.default_rng(3).integers(0, 128, (4, 32)))
    out = {}

    def fresh(c, mesh, seed=7):
        model = llama.init_params(c, torch.Generator().manual_seed(seed),
                                  "cpu", mesh=mesh)
        return model, make_optimizer(model, LR)

    def trained(c, mesh, d):
        """Two steps saved at step 2: the state, and the next step's loss
        on the same mesh."""
        model, opt = fresh(c, mesh, seed=0)
        llama.train_loop(model, opt, batch, TrainCheckpointer(d, mesh=mesh),
                         every=2, max_steps=2, mesh=mesh, worker=rank)
        state = state_numpy(model, opt)
        return state, float(make_train_step(c, mesh, opt)(model, batch))

    def restored(c, mesh, d, key, step=None):
        model, opt = fresh(c, mesh)
        n, (model, opt) = TrainCheckpointer(d, mesh=mesh).restore_or(
            lambda: (model, opt))
        state = state_numpy(model, opt)
        make = step or (lambda o: make_train_step(c, mesh, o))
        out[key] = dict(state=state, step_no=n,
                        loss=float(make(opt)(model, batch)))

    tp2 = os.path.join(ckpt_dir, "tp2")
    out["saved_tp2"] = trained(cfg, mesh_of(world, {"tp": 2}), tp2)
    out["tp2_coords"] = MeshAxes(mesh_of(world, {"tp": 2})).index
    fsdp2 = mesh_of(world, {"fsdp": 2})
    restored(cfg, fsdp2, tp2, "fsdp2")
    out["fsdp2_coords"] = MeshAxes(fsdp2).index
    pp2 = pp_mesh((("pp", 2),))
    restored(cfg, pp2, tp2, "pp2",
             step=lambda opt: make_pp_train_step(cfg, pp2, opt, 2))
    out["pp2_coords"] = MeshAxes(pp2).index
    restored(cfg, None, tp2, "one")
    one = os.path.join(ckpt_dir, "one")
    if rank == 0:
        out["saved_one"] = trained(cfg, None, one)
    dist.barrier()
    restored(cfg, mesh_of(world, {"tp": 2}), one, "one_to_tp2")
    ep2 = os.path.join(ckpt_dir, "ep2")
    out["saved_ep2"] = trained(moe, mesh_of(world, {"ep": 2}), ep2)
    out["ep2_coords"] = MeshAxes(mesh_of(world, {"ep": 2})).index
    restored(moe, None, ep2, "ep2_to_one")
    return out


def world_main(rank, world, port, argv, bt, max_steps, kv_heads=2):
    """``main()``'s gang training as one worker of a gang of ``world``:
    the gang env (``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID``), a tiny
    config and batch ``bt`` patched in, and the loop stopped after step
    ``max_steps``; ``kv_heads`` (2) must divide by the mesh's tp (min(4,
    world)). Returns the pretrain lines this worker printed."""
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
        lambda: config("flash", kv_heads))
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


# -- the pipeline (tests/test_torch_pipeline.py) ------------------------------
PP_MICROBATCHES = (2, 4, 8)
PP_TRAIN_M = 4


def pp_config(remat: bool = False, **kw) -> LlamaConfig:
    """JAX's pipeline-test config: vocab 128, d 32, 4 layers, 4 heads,
    f32."""
    return LlamaConfig(**{
        **dict(vocab=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=4,
               d_ff=64, max_seq=64, dtype=torch.float32, remat=remat),
        **kw})


class LiveSaved:
    """Saved-tensor hooks that count the bytes autograd holds for the
    backward at once, and the most it held (parameters not counted)."""

    def __init__(self, model) -> None:
        self.params = {p.data_ptr() for p in model.parameters()}
        self.now = self.peak = 0

    def pack(self, t):
        n = 0 if t.data_ptr() in self.params else \
            t.numel() * t.element_size()
        self.now += n
        self.peak = max(self.peak, self.now)
        return _Held(t, n, self)

    @staticmethod
    def unpack(held):
        return held.t


class _Held:
    def __init__(self, t, n, live) -> None:
        self.t, self.n, self.live = t, n, live

    def __del__(self) -> None:
        self.live.now -= self.n


def pp_stash(model, cfg, mesh, tokens, M, schedule):
    """One pass of ``schedule`` over ``tokens``: the most saved-tensor
    bytes held at once and 1F1B's stash peak."""
    from torch.autograd.graph import saved_tensors_hooks

    from k8s_gpu_scheduler_tpu_torch.models.pipeline import (
        pp_1f1b_loss_and_grads, pp_loss_fn)

    live, stats = LiveSaved(model), {}
    with saved_tensors_hooks(live.pack, live.unpack):
        if schedule == "gpipe":
            pp_loss_fn(model, batch_of(tokens), cfg, mesh, M).backward()
        else:
            pp_1f1b_loss_and_grads(model, batch_of(tokens), cfg, mesh, M,
                                   stats=stats)
    return dict(peak=live.peak, stash=stats.get("stash_peak"))


@functools.lru_cache(maxsize=None)
def pp_mesh(axes: tuple):
    """The mesh of ``MeshSpec(dict(axes))`` (axes in rank order), made
    once a rank."""
    return make_mesh(MeshSpec(dict(axes)), "cpu")


def world_pipeline(rank, world, tree, tokens, stash_tokens, cells):
    """Every (name, mesh axes, remat) cell on this rank: the GPipe loss
    and the 1F1B loss and gradients for each of ``PP_MICROBATCHES``, the
    GPipe gradients at ``PP_TRAIN_M``, two steps of each schedule, and
    (remat off) the saved bytes of both schedules at a fixed microbatch
    size (``stash_tokens`` by M)."""
    from k8s_gpu_scheduler_tpu_torch.models.pipeline import (
        make_pp_train_step, pp_1f1b_loss_and_grads, pp_loss_fn)

    torch.set_num_threads(1)

    def grads_np(grads):
        return {k: v.detach().numpy().copy() for k, v in grads.items()}

    out = {}
    for name, axes, remat in cells:
        cfg = pp_config(remat)
        mesh = pp_mesh(tuple(axes.items()))
        model = params_from_numpy(tree, cfg, "cpu", trainable=True,
                                  mesh=mesh, specs="pipeline")
        batch = batch_of(tokens)
        res = dict(gpipe={}, f1b={}, grads={}, stash={},
                   sizes=MeshAxes(mesh).sizes, index=MeshAxes(mesh).index,
                   blocks=len(model.blocks))
        for M in PP_MICROBATCHES:
            with torch.no_grad():
                res["gpipe"][M] = float(pp_loss_fn(model, batch, cfg, mesh,
                                                   M))
            stats = {}
            loss, grads = pp_1f1b_loss_and_grads(model, batch, cfg, mesh, M,
                                                 stats=stats)
            res["f1b"][M] = float(loss)
            res["grads"][M] = grads_np(grads)
            res["stash"][M] = stats["stash_peak"]
        loss = pp_loss_fn(model, batch, cfg, mesh, PP_TRAIN_M)
        loss.backward()
        res["gpipe_grads"] = grads_np({n: p.grad for n, p in
                                       model.named_parameters()})
        res["train"] = {}
        for sched in ("gpipe", "1f1b"):
            m = params_from_numpy(tree, cfg, "cpu", trainable=True,
                                  mesh=mesh, specs="pipeline")
            opt = make_optimizer(m, LR)
            step = make_pp_train_step(cfg, mesh, opt, PP_TRAIN_M, sched)
            res["train"][sched] = dict(
                losses=[float(step(m, batch)) for _ in range(STEPS)],
                blocks=params_to_numpy(m),
                moments=sum(1 for _ in opt.state.values()))
        if not remat:
            res["saved"] = {(sched, M): pp_stash(model, cfg, mesh, t, M,
                                                 sched)
                            for M, t in stash_tokens.items()
                            for sched in ("gpipe", "1f1b")}
        out[name] = res
    return out


# -- MoE over ep (tests/test_torch_ep.py) -------------------------------------
def moe_config(attn_impl: str = "dense", cf: float = 2.0) -> LlamaConfig:
    """JAX's MoE-test config (vocab 128, d 32, 2 layers, 4 heads, 4
    experts, top 2, f32) with remat and capacity factor ``cf``."""
    return LlamaConfig(vocab=128, d_model=32, n_layers=2, n_heads=4,
                       n_kv_heads=4, d_ff=64, max_seq=64,
                       dtype=torch.float32, remat=True, n_experts=4,
                       moe_top_k=2, moe_capacity_factor=cf,
                       attn_impl=attn_impl)


def moe_drops(model, tokens, mesh):
    """The (token, choice) pairs each layer's capacity dropped in a
    forward of ``tokens`` (this rank's tokens on a mesh)."""
    from k8s_gpu_scheduler_tpu_torch.ops.moe import recording_drops

    with torch.no_grad(), recording_drops() as drops:
        llama.loss_fn(model, batch_of(tokens), mesh)
    return [int(d) for d in drops]


def last_dim_gathers(world):
    """``all_gather`` and ``gather_from`` on the last dim over every rank
    (a [2, 3] block of rank r holds 100 r + its index), with the
    gradient each passes back for an upstream gradient of 1000 r + the
    index: (outputs, gradients)."""
    from k8s_gpu_scheduler_tpu_torch.parallel.collectives import (
        all_gather, gather_from)

    ax = MeshAxes(mesh_of(world, {"tp": world}))
    r, group = ax.index["tp"], ax.group("tp")
    outs, grads = {}, {}
    for name, fn in (("all_gather", all_gather),
                     ("gather_from", gather_from)):
        x = (100.0 * r + torch.arange(6.0).reshape(2, 3)).requires_grad_()
        y = fn(x, -1, group)
        y.backward(1000.0 * r + torch.arange(y.numel(), dtype=torch.float32)
                   .reshape(y.shape))
        outs[name], grads[name] = y.detach().numpy(), x.grad.numpy()
    return outs, grads


def world_ep(rank, world, tree, tokens, cells):
    """Every (name, attn_impl, mesh axes, capacity factor) cell on this
    rank: the drops of a forward, then ``train_cell``'s two steps; and
    the last-dim gathers."""
    torch.set_num_threads(1)
    out = {"gathers": last_dim_gathers(world)}
    for name, impl, axes, cf in cells:
        cfg = moe_config(impl, cf)
        mesh = mesh_of(world, axes)
        model = params_from_numpy(tree, cfg, "cpu", mesh=mesh,
                                  specs="training")
        drops = moe_drops(model, tokens, mesh)
        out[name] = dict(train_cell(tree, tokens, cfg, mesh), drops=drops)
    return out


# -- on the card (tests/test_torch_gpu.py) ------------------------------------
def _card():
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def card_pp_world(rank, world):
    """On the card (every rank on card 0): two f32 steps of each schedule
    on a pp mesh of the world (4 microbatches) and, on rank 0, the same
    steps on one card. Returns the losses."""
    from k8s_gpu_scheduler_tpu_torch.models.pipeline import (
        make_pp_train_step)

    dev = _card()
    cfg = pp_config(True, d_model=256, n_heads=4, d_ff=512)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 128))
    batch = {k: v.to(dev) for k, v in batch_of(tokens).items()}
    mesh = make_mesh(MeshSpec({"pp": world}), "cuda")
    out = {}
    for sched in ("gpipe", "1f1b"):
        model = llama.init_params(cfg, torch.Generator().manual_seed(0), dev,
                                  mesh=mesh)
        step = make_pp_train_step(cfg, mesh, make_optimizer(model, LR), 4,
                                  sched)
        out[sched] = [float(step(model, batch)) for _ in range(STEPS)]
    if rank == 0:
        model = llama.init_params(cfg, torch.Generator().manual_seed(0), dev)
        step = make_train_step(cfg, None, make_optimizer(model, LR))
        out["one"] = [float(step(model, batch)) for _ in range(STEPS)]
    return out


def card_ep_world(rank, world):
    """On the card: two f32 steps of a small MoE config with flash
    attention (K5-K7) on an ep mesh of the world and, on rank 0, on one
    card. Returns each run's losses and kernel launches."""
    dev = _card()
    cfg = dataclasses.replace(moe_config("flash"), d_model=256, n_heads=4,
                              d_ff=512)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 128))
    batch = {k: v.to(dev) for k, v in batch_of(tokens).items()}

    def run(mesh):
        model = llama.init_params(cfg, torch.Generator().manual_seed(0), dev,
                                  mesh=mesh)
        step = make_train_step(cfg, mesh, make_optimizer(model, LR))
        reset_counters()
        losses = [float(step(model, batch)) for _ in range(STEPS)]
        torch.cuda.synchronize()
        return dict(losses=losses, launches=counters())

    out = {"mesh": run(mesh_of(world, {"ep": world}, "cuda"))}
    if rank == 0:
        out["one"] = run(None)
    return out


def card_restore_world(rank, world, ckpt_dir):
    """On the card: two steps at tp 2 saved at step 2, restored onto one
    card by every rank. Returns whether each of this rank's saved
    blocks (weights and AdamW moments) is its slice of the restored
    state bit for bit."""
    from k8s_gpu_scheduler_tpu_torch.parallel.sharding import rank_slice
    from k8s_gpu_scheduler_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)

    dev = _card()
    cfg = config("dense", 2)            # hd 8: below the kernels' 64
    batch = {k: v.to(dev) for k, v in batch_of(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 64))).items()}
    mesh = mesh_of(world, {"tp": world}, "cuda")
    model = llama.init_params(cfg, torch.Generator().manual_seed(0), dev,
                              mesh=mesh)
    opt = make_optimizer(model, LR)
    llama.train_loop(model, opt, batch, TrainCheckpointer(ckpt_dir,
                                                          mesh=mesh),
                     every=2, max_steps=2, mesh=mesh, worker=rank)
    saved = state_numpy_cpu(model, opt)
    whole = llama.init_params(cfg, torch.Generator().manual_seed(5), dev)
    step_no, (whole, whole_opt) = TrainCheckpointer(ckpt_dir).restore_or(
        lambda: (whole, make_optimizer(whole, LR)))
    full = state_numpy_cpu(whole, whole_opt)
    ax, specs = MeshAxes(mesh), llama.leaf_specs(cfg)
    equal = all(np.array_equal(saved[n][k], rank_slice(
        full[n][k], specs[n], ax.sizes, ax.index))
        for n in saved for k in range(3))
    return dict(step_no=step_no, equal=equal)


def state_numpy_cpu(model, opt) -> dict:
    """``state_numpy`` of a model on the card."""
    return {name: (p.detach().cpu().numpy(),
                   opt.state[p]["exp_avg"].cpu().numpy(),
                   opt.state[p]["exp_avg_sq"].cpu().numpy())
            for name, p in model.named_parameters()}
