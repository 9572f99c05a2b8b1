"""Dense causal attention (port of the JAX package's ``ops/attention.py``
``dense_attention``) — the training forward's reference path. The
sequence-parallel variants (ring, Ulysses) belong to the multi-device
slice."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30   # large-negative, not -inf: a fully masked row stays finite


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: tile kv heads up to n_heads. k: [B, T, Hkv, d]."""
    h_kv = k.shape[2]
    if h_kv == n_heads:
        return k
    if n_heads % h_kv:
        raise ValueError(
            f"GQA needs n_heads ({n_heads}) divisible by kv heads ({h_kv})")
    return torch.repeat_interleave(k, n_heads // h_kv, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Tq, H, d]; k/v: [B, Tk, Hkv, d] → [B, Tq, H, d]. Scores and
    softmax in f32, probabilities cast back to q's dtype."""
    n_heads, head_dim = q.shape[-2:]
    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
