"""Pipeline parallelism over a ``pp`` mesh axis: GPipe and 1F1B (port of
the JAX package's ``models/pipeline.py``).

A rank of a mesh with a ``pp`` axis of P is stage s: it holds layers
[s·L/P, (s+1)·L/P) and every other leaf whole (``llama.rank_layout``;
build it with ``init_params(..., mesh=)`` or ``bridge.params_from_numpy
(..., specs="pipeline")``). Every other axis of the mesh replicates: its
ranks run the same stages on the same batch, as JAX's ``P()`` specs do.
Stage 0 embeds, the last stage applies the final norm and the head and
sums the token NLL; the loss is the mean over every token.

JAX runs the schedule as one ``lax.scan`` of ticks inside ``shard_map``
and moves activations with ``ppermute``; GPipe's backward is autodiff
through the scan. Here a tick is a step of a Python loop on each rank,
and each stage keeps its autograd graph to itself: activations cross the
stage boundary detached, and every exchange, forward (activations) and
backward (cotangents), is posted explicitly by every stage at every
tick, bubble ticks included (``parallel.collectives.shift`` around the
ring), so the stages' exchanges always pair. A bubble tick computes
nothing (JAX computes garbage there and masks it out of the loss).

- **GPipe** (``pp_loss_fn``): M + P - 1 forward ticks that keep every
  microbatch's graph, then M + P - 1 backward ticks in reverse, run by
  the loss's ``backward()``: the stash grows with M.
- **1F1B** (``pp_1f1b_loss_and_grads``): at tick t, stage s runs the
  forward of microbatch t - s and the backward of microbatch
  t - 2(P - 1) + s. The forward keeps only the stage's input, at most
  2(P - 1 - s) + 1 of them; the backward recomputes the stage from it.
  The last stage runs both for the same microbatch in one tick and
  stashes nothing.

The gradients of the embedding, the head and the final norm are summed
over ``pp`` (only stage 0, or the last stage, has them), so every stage
applies the same update to them; a stage's optimizer lists only its own
parameters. ``cfg.remat`` recomputes each layer inside a stage, as
``jax.checkpoint`` does. Attention is ``dense_attention``, as in JAX: the
pipeline reaches no kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.utils.checkpoint

from ..ops.attention import dense_attention
from ..ops.layers import rms_norm, rope_freqs
from ..parallel.collectives import all_reduce_, shift
from .llama import Llama, LlamaConfig, attn_sublayer, mlp_sublayer

SCHEDULES = ("gpipe", "1f1b")


def _block(cfg: LlamaConfig, x: torch.Tensor, blk,
           angles: torch.Tensor) -> torch.Tensor:
    """One decoder layer on [mb, T, D]: the sublayers of ``llama.py``
    with dense causal attention."""
    x = attn_sublayer(cfg, x, blk, angles,
                      lambda q, k, v: dense_attention(q, k, v, causal=True))
    x, _ = mlp_sublayer(cfg, x, blk)
    return x


def _check_pp_config(cfg: LlamaConfig, n_stages: int) -> None:
    """JAX's refusals, with its exception types."""
    if cfg.n_layers % n_stages:
        raise AssertionError((cfg.n_layers, n_stages))
    if cfg.n_experts > 1:
        raise NotImplementedError(
            "pipeline parallelism does not compose with MoE configs yet "
            "(route expert dispatch per stage); use dense layers")
    if cfg.attn_impl != "dense":
        raise NotImplementedError(
            f"pipeline parallelism runs dense attention only (got "
            f"attn_impl={cfg.attn_impl!r}); flash/ring/ulysses per stage "
            f"is future work")


def _pp_axis(mesh):
    """(stages, this rank's stage, the ``MeshAxes`` or None)."""
    if mesh is None:
        return 1, 0, None
    from ..parallel.mesh import MeshAxes

    ax = MeshAxes.of(mesh)
    return ax.size("pp"), ax.index.get("pp", 0), ax


class _Stage:
    """One rank's part of a schedule: its stage, its layers and the
    batch cut into microbatches."""

    def __init__(self, model: Llama, batch: Dict[str, torch.Tensor],
                 cfg: LlamaConfig, mesh, microbatches: int) -> None:
        self.P, self.s, ax = _pp_axis(mesh)
        _check_pp_config(cfg, self.P)
        B, T = batch["tokens"].shape
        M = microbatches
        if B % M:
            raise AssertionError((B, M))
        if model.cfg != cfg:
            raise ValueError("the model's config differs from the step's")
        if len(model.blocks) != cfg.n_layers // self.P:
            raise ValueError(
                f"the model holds {len(model.blocks)} blocks, a stage of "
                f"{self.P} holds {cfg.n_layers // self.P}: build it with "
                f"init_params(..., mesh=) or params_from_numpy(..., mesh=, "
                f"specs='pipeline')")
        self.group = None if ax is None else ax.group("pp")
        self.model, self.cfg, self.M = model, cfg, M
        self.first, self.last = self.s == 0, self.s == self.P - 1
        mb = B // M
        self.tokens = batch["tokens"].reshape(M, mb, T)
        self.targets = batch["targets"].reshape(M, mb, T).long()
        self.scale = 1.0 / (B * T)
        self.angles = rope_freqs(cfg.head_dim, T, cfg.rope_theta,
                                 device=model.device)
        self.zeros = torch.zeros((mb, T, cfg.d_model), dtype=cfg.dtype,
                                 device=model.device)
        self.stash_peak = 0

    def params(self, blocks_only: bool = False) -> List[torch.nn.Parameter]:
        """The trainable parameters this stage's work reaches."""
        m = self.model
        out = list(m.blocks.parameters())
        if self.first and not blocks_only:
            out.append(m.embed)
        if self.last and not blocks_only:
            out += [m.final_norm, m.lm_head]
        return [p for p in out if p.requires_grad]

    def embed(self, m: int) -> torch.Tensor:
        return self.model.embed[self.tokens[m]].to(self.cfg.dtype)

    def run_local(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.model.blocks:
            x = (torch.utils.checkpoint.checkpoint(
                _block, self.cfg, x, blk, self.angles, use_reentrant=False)
                 if remat else _block(self.cfg, x, blk, self.angles))
        return x

    def head_nll(self, y: torch.Tensor, m: int) -> torch.Tensor:
        """The summed NLL of microbatch ``m``'s tokens, f32."""
        h = rms_norm(y, self.model.final_norm)
        logits = (h @ self.model.lm_head).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, self.targets[m][..., None])[..., 0]
        return (lse - tgt).sum()

    def exchange(self, forward: torch.Tensor, backward: torch.Tensor):
        """The tick's two exchanges, in the same order on every stage:
        ``forward`` to the next stage, ``backward`` to the one before;
        returns what the previous and the next stage sent."""
        return (shift(forward, 1, self.group), shift(backward, -1,
                                                     self.group))

    def loss(self, nll_sum: torch.Tensor) -> torch.Tensor:
        """The global mean NLL from this stage's sum (the last stage's)."""
        return all_reduce_(nll_sum, self.group) * self.scale

    def sum_replicated(self, grads: Dict[torch.nn.Parameter, torch.Tensor]
                       ) -> None:
        """The embedding's, the head's and the final norm's gradients
        summed over pp into every stage's ``grads``."""
        m = self.model
        for p in (m.embed, m.final_norm, m.lm_head):
            g = grads.get(p)
            grads[p] = all_reduce_(torch.zeros_like(p) if g is None else g,
                                   self.group)

    # -- GPipe -------------------------------------------------------------
    def gpipe_forward(self, keep: bool) -> torch.Tensor:
        """The forward ticks; with ``keep``, each microbatch's graph stays
        in ``self.graphs`` for ``gpipe_backward``."""
        self.graphs = {}
        nll_sum = torch.zeros((), dtype=torch.float32,
                              device=self.zeros.device)
        act = self.zeros
        for t in range(self.M + self.P - 1):
            f, out = t - self.s, self.zeros
            if 0 <= f < self.M:
                x = self.embed(f) if self.first else (
                    act.requires_grad_() if keep else act)
                y = self.run_local(x)
                if self.last:
                    nll = self.head_nll(y, f)
                    nll_sum = nll_sum + nll.detach()
                    y = nll
                else:
                    out = y.detach()
                if keep:
                    self.graphs[f] = (x, y)
            act = shift(out, 1, self.group)
        return self.loss(nll_sum)

    def gpipe_backward(self, g: torch.Tensor) -> None:
        """The backward ticks, last microbatch's graph first on each
        stage; accumulates into each parameter's ``.grad``."""
        params = self.params()
        grads: Dict[torch.nn.Parameter, torch.Tensor] = {}
        cot = self.zeros
        for u in range(self.M + self.P - 1):
            b, dx = self.M - 1 - (u - (self.P - 1 - self.s)), self.zeros
            if 0 <= b < self.M:
                x, y = self.graphs.pop(b)
                seed = (g * self.scale).to(y.dtype) if self.last else cot
                inputs = params if self.first else [x] + params
                got = torch.autograd.grad(y, inputs, seed, allow_unused=True)
                if not self.first:
                    dx, got = got[0], got[1:]
                _accumulate(grads, params, got)
            cot = shift(dx, -1, self.group)
        self.sum_replicated(grads)
        for p, gr in grads.items():
            p.grad = gr if p.grad is None else p.grad + gr

    # -- 1F1B --------------------------------------------------------------
    def one_f_one_b(self):
        """The synchronous 1F1B schedule: (loss, gradients by parameter)."""
        P, s, M = self.P, self.s, self.M
        params = self.params()
        blocks = self.params(blocks_only=True)
        grads: Dict[torch.nn.Parameter, torch.Tensor] = {}
        nll_sum = torch.zeros((), dtype=torch.float32,
                              device=self.zeros.device)
        stash: Dict[int, torch.Tensor] = {}
        act = cot = self.zeros
        for t in range(M + 2 * (P - 1)):
            f, b = t - s, t - 2 * (P - 1) + s
            y_out, dx_out = self.zeros, self.zeros
            if 0 <= f < M:
                with torch.no_grad():
                    x_in = self.embed(f) if self.first else act
                if self.last:
                    # b == f: the loss's cotangent is made and used here.
                    with torch.enable_grad():
                        x = x_in.detach().requires_grad_()
                        nll = self.head_nll(self.run_local(x), f)
                        dx_out, *got = torch.autograd.grad(
                            nll * self.scale, [x] + params,
                            allow_unused=True)
                    nll_sum = nll_sum + nll.detach()
                    _accumulate(grads, params, got)
                else:
                    stash[f] = x_in
                    self.stash_peak = max(self.stash_peak, len(stash))
                    with torch.no_grad():
                        y_out = self.run_local(x_in)
            if not self.last and 0 <= b < M:
                with torch.enable_grad():
                    x = stash.pop(b).requires_grad_()
                    dx_out, *got = torch.autograd.grad(
                        self.run_local(x), [x] + blocks, cot)
                _accumulate(grads, blocks, got)
                if self.first:
                    # The embedding's gradient: the scatter-add of dx.
                    emb = self.model.embed
                    g = grads.setdefault(emb, torch.zeros_like(emb))
                    g.index_add_(0, self.tokens[b].reshape(-1),
                                 dx_out.reshape(-1, dx_out.shape[-1])
                                 .to(g.dtype))
            act, cot = self.exchange(y_out, dx_out)
        self.sum_replicated(grads)
        return self.loss(nll_sum), grads


def _accumulate(grads: Dict, params: Sequence[torch.nn.Parameter],
                got: Sequence[Optional[torch.Tensor]]) -> None:
    for p, g in zip(params, got):
        if g is not None:
            grads[p] = g if p not in grads else grads[p] + g


class _GPipe(torch.autograd.Function):
    """The GPipe loss as one autograd node: its forward runs the forward
    ticks keeping every microbatch's stage graph, its backward runs the
    backward ticks. The stage's parameters are inputs only so that the
    node is part of the graph; their gradients go to ``.grad``."""

    @staticmethod
    def forward(ctx, stage: _Stage, *params):
        ctx.stage = stage
        with torch.enable_grad():
            return stage.gpipe_forward(keep=True)

    @staticmethod
    def backward(ctx, g):
        stage, ctx.stage = ctx.stage, None
        stage.gpipe_backward(g)
        return (None,) * len(ctx.needs_input_grad)


def pp_loss_fn(model: Llama, batch: Dict[str, torch.Tensor],
               cfg: LlamaConfig, mesh, microbatches: int) -> torch.Tensor:
    """Causal-LM loss through the GPipe pipeline, on every rank of
    ``mesh`` at once: ``batch["tokens"]`` [B, T] (the global batch, the
    same on every rank) with B divisible by ``microbatches``, and
    ``cfg.n_layers`` divisible by the ``pp`` axis's size. ``model`` is
    this rank's stage. The loss, the same on every rank, is
    differentiable when autograd records and the parameters take
    gradients: ``loss.backward()`` (on every rank) runs the backward
    schedule and leaves each stage parameter's gradient, the replicated
    leaves' summed over pp, in ``.grad``."""
    stage = _Stage(model, batch, cfg, mesh, microbatches)
    params = [p for p in stage.params() if p.requires_grad]
    if torch.is_grad_enabled() and params:
        return _GPipe.apply(stage, *params)
    with torch.no_grad():
        return stage.gpipe_forward(keep=False)


def pp_1f1b_loss_and_grads(model: Llama, batch: Dict[str, torch.Tensor],
                           cfg: LlamaConfig, mesh, microbatches: int,
                           stats: Optional[dict] = None):
    """(loss, gradients) through the synchronous 1F1B schedule: the loss
    as ``pp_loss_fn``'s and each of this stage's parameters' gradient by
    its name in ``model`` (the replicated leaves' summed over pp). Needs
    at least 2 stages. ``stats``, when given, gets ``stash_peak``: the
    most stage inputs this rank held at once."""
    stage = _Stage(model, batch, cfg, mesh, microbatches)
    if stage.P < 2:
        raise ValueError("1F1B needs >= 2 stages; use the plain train step")
    loss, grads = stage.one_f_one_b()
    if stats is not None:
        stats["stash_peak"] = stage.stash_peak
    return loss, {name: grads.get(p, torch.zeros_like(p))
                  for name, p in model.named_parameters()}


def make_pp_train_step(cfg: LlamaConfig, mesh,
                       optimizer: torch.optim.Optimizer, microbatches: int,
                       schedule: str = "gpipe"):
    """The pipeline's train step: ``step(model, batch) -> loss`` on every
    rank of ``mesh``, in the same order, with this rank's stage in
    ``model`` and the global batch in ``batch``; the gradients of
    ``schedule`` ("gpipe": ``pp_loss_fn``'s backward; "1f1b":
    ``pp_1f1b_loss_and_grads``), then one ``optimizer`` update of the
    stage's parameters in place. The loss comes back detached, the same
    on every rank."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be 'gpipe' or '1f1b', got "
                         f"{schedule!r}")
    n_stages = _pp_axis(mesh)[0]
    _check_pp_config(cfg, n_stages)
    if schedule == "1f1b" and n_stages < 2:
        raise ValueError("1F1B needs >= 2 stages; use the plain train step")

    def step(model: Llama, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        if schedule == "1f1b":
            loss, grads = pp_1f1b_loss_and_grads(model, batch, cfg, mesh,
                                                 microbatches)
            for name, p in model.named_parameters():
                p.grad = grads[name]
        else:
            loss = pp_loss_fn(model, batch, cfg, mesh, microbatches)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step
