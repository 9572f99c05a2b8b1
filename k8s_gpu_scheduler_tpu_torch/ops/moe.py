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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .quant import Weight, qeinsum


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
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed SwiGLU experts with per-expert capacity. x [B, T, D]
    → (out [B, T, D], the Switch balance aux from the same routing
    probabilities). Capacity counts one batch row's T tokens; a choice's
    queue position is its rank among the row's choices of that expert in
    (token, choice) order, so a token's second choice can be dropped
    while its first is kept."""
    B, T, _ = x.shape
    E = router.shape[1]
    C = expert_capacity(T, E, top_k, capacity_factor)
    probs, gate_vals, gate_idx = _route(x, router, top_k)
    aux = _balance_aux(probs, gate_idx, E, top_k)
    gate_vals = _renormalize(gate_vals)

    oh = F.one_hot(gate_idx, E).float()                         # [B,T,k,E]
    flat = oh.reshape(B, T * top_k, E)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    pos = (pos_flat * flat).sum(-1).reshape(B, T, top_k)        # [B,T,k]
    keep = (pos < C).float()
    # A position past the capacity has no slot: its one-hot row is zero.
    slot_oh = (pos[..., None] == torch.arange(
        C, device=x.device, dtype=pos.dtype)).float()           # [B,T,k,C]
    combine = torch.einsum("btke,btkc->btec",
                           (gate_vals * keep)[..., None] * oh, slot_oh)
    dispatch = (combine > 0.0).to(x.dtype)

    expert_in = torch.einsum("btec,btd->ebcd", dispatch, x)
    g = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in, w_gate))
    u = torch.einsum("ebcd,edf->ebcf", expert_in, w_up)
    expert_out = torch.einsum("ebcf,efd->ebcd", g * u, w_down)
    out = torch.einsum("btec,ebcd->btd", combine.to(x.dtype), expert_out)
    return out, aux


def _balance_aux(probs: torch.Tensor, idx: torch.Tensor, n_experts: int,
                 top_k: int) -> torch.Tensor:
    """Switch balance loss E · Σ_e fraction_tokens(e) · mean_prob(e),
    averaged over the batch rows; 1 at uniform routing."""
    T = probs.shape[1]
    frac = F.one_hot(idx, n_experts).float().sum((1, 2)) / (T * top_k)
    mean_prob = probs.mean(dim=1)                                # [B,E]
    return n_experts * (frac * mean_prob).sum(-1).mean()


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
