"""Rank workers of the port's int8 gang-serving tests
(``tests/test_torch_gang_int8.py``). ``parallel.spawn`` pickles a worker
by its module and name and every rank re-imports that module, so the
workers live here, in a module that imports no JAX. The world function
runs on every rank of a gloo world on the CPU and returns that rank's
results; the test holds them to the JAX package and to the port's
``mesh=None`` path."""
from __future__ import annotations

import numpy as np
import torch

from k8s_gpu_scheduler_tpu_torch.bridge import (
    params_from_numpy, params_to_numpy)
from k8s_gpu_scheduler_tpu_torch.models.llama import (
    init_params, rank_leaf_shapes)
from k8s_gpu_scheduler_tpu_torch.models.serving import make_server_step
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params
from k8s_gpu_scheduler_tpu_torch.parallel.mesh import MeshAxes
from torch_gang_workers import SERVE_F32, CacheSpy, rank_setup, serve_config

# (name, MeshSpec.for_devices axes of the world of 4, config overrides,
# B, max_new): the dense serving config over fsdp and tp, and its MoE
# variant over ep and tp.
CELLS = (("dense", {"fsdp": 2, "tp": 2}, dict(SERVE_F32), 4, 5),
         ("moe", {"ep": 2, "tp": 2}, dict(SERVE_F32, n_experts=4), 4, 5))
MAX_LEN = 32


def rank_bytes(model) -> int:
    """Bytes of every parameter and buffer the rank holds."""
    return sum(t.numel() * t.element_size() for t in
               [*model.parameters(), *model.buffers()])


def _serve(model, cfg, mesh, prompt, max_new):
    da.reset_counters()
    with CacheSpy() as spy:
        out = make_server_step(cfg, mesh, max_new, max_len=MAX_LEN)(
            model, torch.from_numpy(prompt))
    return dict(streams=out.numpy(), splits=spy.splits,
                counters=da.counters())


def world_int8(rank, world, trees, qtrees, prompts):
    """Every cell of ``CELLS`` on this rank: the int8 blocks it holds when
    it quantizes its own ``init_params(..., mesh=)`` blocks (``init``) or
    its bridged blocks of the JAX tree (``bridged``), and those
    ``params_from_numpy`` cuts from the JAX-quantized tree (``jax``); the
    streams of the last two; the rank's bytes against
    ``rank_leaf_shapes(int8=True)``; and the refusal of a whole int8
    model on the mesh."""
    out = {}
    for name, axes, kw, _, max_new in CELLS:
        cfg = serve_config(**kw)
        mesh = rank_setup(world, axes)
        ax = MeshAxes(mesh)
        cell = dict(coords=ax.index, sizes=ax.sizes)
        init = quantize_llama_params(init_params(
            cfg, torch.Generator().manual_seed(0), "cpu", mesh=mesh),
            mesh=mesh)
        cell["init"] = params_to_numpy(init)
        bridged = quantize_llama_params(params_from_numpy(
            trees[name], cfg, "cpu", mesh=mesh, specs="training"), mesh=mesh)
        cell["bridged"] = params_to_numpy(bridged)
        cut = params_from_numpy(qtrees[name], cfg, "cpu", mesh=mesh,
                                specs="training")
        cell["jax"] = params_to_numpy(cut)
        want = rank_leaf_shapes(cfg, ax.sizes, int8=True)
        cell["bytes"] = (rank_bytes(init), sum(
            int(np.prod(s)) * torch.empty(0, dtype=d).element_size()
            for s, d in want.values()))
        cell["shapes"] = (
            {k: (tuple(v.shape), v.dtype) for k, v in
             [*init.named_parameters(), *init.named_buffers()]}, want)
        cell["streams"] = {
            src: _serve(model, cfg, mesh, prompts[name], max_new)
            for src, model in (("bridged", bridged), ("jax", cut))}
        whole = quantize_llama_params(params_from_numpy(trees[name], cfg,
                                                        "cpu"))
        try:
            make_server_step(cfg, mesh, max_new, max_len=MAX_LEN)(
                whole, torch.from_numpy(prompts[name]))
        except ValueError as e:
            cell["whole_refused"] = str(e)
        out[name] = cell
    return out
