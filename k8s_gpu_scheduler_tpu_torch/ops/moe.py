"""Mixture-of-Experts FFN (port of the JAX package's ``ops/moe.py``).

Top-k gating over ``E`` SwiGLU experts stacked on a leading axis
(``w_gate``/``w_up [E, D, F]``, ``w_down [E, F, D]``, router ``[D, E]``
in f32). Training routes with a fixed per-expert capacity (the
Switch/GShard formulation of ``moe_ffn``): a choice past its expert's
capacity is dropped, and the residual add passes its token through.
Serving routes dropless (``moe_ffn_dropless``): every token gets its top
k experts, a gate-weighted sum over all experts' outputs, so a token's
output does not depend on its neighbours or on padding.

No Pallas kernel sits behind any of it: the reference is XLA einsums, so
the port is PyTorch matmuls. Router math runs in f32; expert products run
in the input's dtype. Ties among routing probabilities go to the lower
expert index, as ``jax.lax.top_k`` breaks them (``_top_k``).

On a mesh (``moe_ffn(..., ax=)``, a ``parallel.mesh.MeshAxes``) a rank
computes what GSPMD made of the JAX function over the global arrays: the
batch lies over (dp, fsdp) and the sequence over sp, the experts over ep
and each expert's ffn columns over tp; the ranks of an ep group hold the
same tokens and each runs them through its own E/ep experts.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import (
    all_gather, all_reduce, all_reduce_, copy_to, gather_from)
from .quant import Weight, qeinsum

# The list that ``recording_drops`` collects into, where one is open.
_DROPS: ContextVar[Optional[list]] = ContextVar("moe_drops", default=None)


@contextlib.contextmanager
def recording_drops() -> Iterator[List[torch.Tensor]]:
    """Inside the block, each capacity-path ``moe_ffn`` call appends the
    number of (token, choice) pairs of its tokens that their expert's
    capacity dropped: a 0-d tensor on the input's device, read when the
    caller wants it (on a mesh, the rank's tokens; every rank of an ep or
    tp group counts the same ones). A remat recompute counts again, so
    record under ``torch.no_grad()``."""
    drops: List[torch.Tensor] = []
    token = _DROPS.set(drops)
    try:
        yield drops
    finally:
        _DROPS.reset(token)


def expert_capacity(tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert queue length: perfectly balanced load times the slack
    factor, at least 1."""
    return max(1, int(capacity_factor * top_k * tokens / n_experts))


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of the last axis,
    largest first and equal values in index order (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none for ties)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """(probs [B, T, E] f32, top-k gate values and indices [B, T, k])."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    return (probs, *_top_k(probs, top_k))


def _renormalize(gate_vals: torch.Tensor) -> torch.Tensor:
    """Gate values over the chosen k (Mixtral's convention)."""
    return gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, top_k: int = 2,
            capacity_factor: float = 1.25, ax=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed SwiGLU experts with per-expert capacity. x [B, T, D]
    → (out [B, T, D], the Switch balance aux from the same routing
    probabilities). Capacity counts one batch row's T tokens; a choice's
    queue position is its rank among the row's choices of that expert in
    (token, choice) order, so a token's second choice can be dropped
    while its first is kept.

    ``ax`` (a ``MeshAxes`` of more than one rank): ``x`` is the rank's
    tokens [B/(dp·fsdp), T/sp, D], ``router`` its columns [D, E/ep],
    the expert stacks its experts' tp blocks ([E/ep, D, F/tp], [E/ep,
    F/tp, D]). Every rank of the ep group routes its tokens alike, on
    the logits gathered over ep; the capacity comes from the row's whole
    T, and a choice's queue position counts the choices of the sp ranks
    before this one. ``out`` is summed over ep and tp and the aux is the
    global batch's, the same on every rank."""
    B, T, _ = x.shape
    ep = tp = None
    T_row = T
    if ax is not None:
        ep, tp = ax.group("ep"), ax.group("tp")
        T_row = T * ax.size("sp")
    h = copy_to(x, ep)
    probs = torch.softmax(gather_from(h.float() @ router.float(), -1, ep),
                          dim=-1)                                # [B,T,E]
    E = probs.shape[-1]
    C = expert_capacity(T_row, E, top_k, capacity_factor)
    gate_vals, gate_idx = _top_k(probs, top_k)
    aux = _balance_aux(probs, gate_idx, E, top_k, ax)
    # Each (ep, tp) rank's expert products see the gates through its own
    # experts and ffn columns: their gradients are summed over both.
    gate_vals = copy_to(copy_to(_renormalize(gate_vals), ep), tp)

    oh = F.one_hot(gate_idx, E).float()                         # [B,T,k,E]
    flat = oh.reshape(B, T * top_k, E)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    if ax is not None and ax.group("sp") is not None:
        pos_flat = pos_flat + _choices_before(flat.sum(1), ax)[:, None]
    pos = (pos_flat * flat).sum(-1).reshape(B, T, top_k)        # [B,T,k]
    keep = (pos < C).float()
    drops = _DROPS.get()
    if drops is not None:
        drops.append((keep == 0).sum())
    E_l = w_gate.shape[0]                      # this rank's experts
    e0 = 0 if ax is None else ax.index.get("ep", 0) * E_l
    # A position past the capacity has no slot: its one-hot row is zero.
    slot_oh = (pos[..., None] == torch.arange(
        C, device=x.device, dtype=pos.dtype)).float()           # [B,T,k,C]
    combine = torch.einsum("btke,btkc->btec",
                           (gate_vals * keep)[..., None]
                           * oh[..., e0:e0 + E_l], slot_oh)
    dispatch = (combine > 0.0).to(x.dtype)

    expert_in = torch.einsum("btec,btd->ebcd", dispatch, copy_to(h, tp))
    g = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in, w_gate))
    u = torch.einsum("ebcd,edf->ebcf", expert_in, w_up)
    expert_out = torch.einsum("ebcf,efd->ebcd", g * u, w_down)
    out = torch.einsum("btec,ebcd->btd", combine.to(x.dtype), expert_out)
    return all_reduce(all_reduce(out, tp), ep), aux


def _choices_before(counts: torch.Tensor, ax) -> torch.Tensor:
    """[B, E]: each row's choices of each expert on the sp ranks before
    this one (``counts`` is this rank's [B, E])."""
    per_rank = all_gather(counts[None], 0, ax.group("sp"))     # [sp,B,E]
    return per_rank[:ax.index["sp"]].sum(0)


def _balance_aux(probs: torch.Tensor, idx: torch.Tensor, n_experts: int,
                 top_k: int, ax=None) -> torch.Tensor:
    """Switch balance loss E · Σ_e fraction_tokens(e) · mean_prob(e),
    averaged over the batch rows; 1 at uniform routing. ``ax``: the
    fractions and mean probabilities are summed over sp (a row's whole
    sequence) and the rows over (dp, fsdp), so every rank returns the
    global batch's aux."""
    T = probs.shape[1]
    counts = F.one_hot(idx, n_experts).float().sum((1, 2))      # [B,E]
    if ax is None:
        frac = counts / (T * top_k)
        mean_prob = probs.mean(dim=1)                            # [B,E]
        return n_experts * (frac * mean_prob).sum(-1).mean()
    sp = ax.group("sp")
    T *= ax.size("sp")
    frac = all_reduce_(counts, sp) / (T * top_k)
    mean_prob = all_reduce(probs.sum(dim=1), sp) / T
    rows = n_experts * (frac * mean_prob).sum(-1).sum()
    for a in ("dp", "fsdp"):
        rows = all_reduce(rows, ax.group(a))
    return rows / (probs.shape[0] * ax.size("dp", "fsdp"))


def moe_ffn_dropless(x: torch.Tensor, router: torch.Tensor, w_gate: Weight,
                     w_up: Weight, w_down: Weight,
                     top_k: int = 2) -> torch.Tensor:
    """Dropless routing for serving: every expert's FFN over every token,
    summed with the gate weights (0 off the top k). Equal to ``moe_ffn``
    wherever that drops nothing. Expert stacks may be plain tensors or
    int8 weights (``qeinsum``)."""
    _, gate_vals, gate_idx = _route(x, router, top_k)
    weights = torch.zeros(*gate_idx.shape[:-1], router.shape[1],
                          device=x.device).scatter_(
        -1, gate_idx, _renormalize(gate_vals))                  # [B,T,E]
    g = F.silu(qeinsum("btd,edf->betf", x, w_gate))
    u = qeinsum("btd,edf->betf", x, w_up)
    out_e = qeinsum("betf,efd->betd", g * u, w_down)            # [B,E,T,D]
    return torch.einsum("bte,betd->btd", weights.to(x.dtype), out_e)


def load_balancing_loss(x: torch.Tensor, router: torch.Tensor,
                        top_k: int = 2) -> torch.Tensor:
    """The balance loss alone, for callers without a ``moe_ffn`` pass."""
    probs, _, idx = _route(x, router, top_k)
    return _balance_aux(probs, idx, router.shape[1], top_k)
