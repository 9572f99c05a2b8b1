"""Attention: dense, ring (sequence-parallel) and Ulysses (head-parallel)
(port of the JAX package's ``ops/attention.py``).

- ``dense_attention`` is the single-device reference.
- ``ring_attention``: K/V blocks rotate around the ``sp`` ranks
  (``parallel.collectives.ring_shift``, each send posted with its
  receive) while each rank keeps flash-style running statistics (m, l,
  o) in f32; the global causal mask comes from the block indices.
- ``ulysses_attention``: two all-to-alls re-shard [B, T/n, H, d] →
  [B, T, H/n, d] and back, so each rank runs dense attention over the
  whole sequence for a subset of the heads; H must divide by n.

Both take one rank's blocks and the ``sp`` process group (JAX ran them
inside ``shard_map`` over the ``sp`` axis), are plain tensor code, as in
JAX, and are differentiable: each collective carries its conjugate in
the backward.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..parallel.collectives import all_to_all, ring_shift

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
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [B, Tq, H, d]; k/v: [B, Tk, Hkv, d] → [B, Tq, H, d]. Scores and
    softmax in f32, probabilities cast back to q's dtype. ``q_offset``:
    the position in k's rows of q's first row (a sequence block's queries
    against the whole sequence's keys); 0 aligns them."""
    n_heads, head_dim = q.shape[-2:]
    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(q_offset, q_offset + tq,
                             device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _sp_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sp_rank(group) -> int:
    return 0 if group is None else dist.get_group_rank(group,
                                                       dist.get_rank())


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention over the ``sp`` ranks of ``group``.

    Shapes are one rank's: q/k/v [B, T/n, H(kv), d], rank i holding
    sequence block i. After ``s`` rotations rank i holds the K/V block
    that started on rank (i - s) mod n, so the global causal mask needs
    only the block indices. The running max is a constant shift of the
    softmax, so it carries no gradient; o and l do."""
    n, me = _sp_size(group), _sp_rank(group)
    b, t_local, n_heads, head_dim = q.shape
    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    scale = 1.0 / math.sqrt(head_dim)
    q_pos = me * t_local + torch.arange(t_local, device=q.device)
    o = torch.zeros((b, n_heads, t_local, head_dim), dtype=torch.float32,
                    device=q.device)
    m = torch.full((b, n_heads, t_local), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n_heads, t_local), dtype=torch.float32,
                    device=q.device)
    k_blk, v_blk = k, v
    for s in range(n):
        src = (me - s) % n
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
        if causal:
            k_pos = src * t_local + torch.arange(t_local, device=q.device)
            scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores,
                                 NEG_INF)
        m_new = torch.maximum(m, scores.detach().amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                v_blk.float())
        m = m_new
        if s + 1 < n:                  # the last block needs no onward send
            k_blk, v_blk = ring_shift(k_blk, group), ring_shift(v_blk, group)
    out = o / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, causal: bool = True) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): re-shard
    seq → heads, dense attention over the whole sequence locally, re-shard
    heads → seq. One rank's in/out: [B, T/n, H, d]; H must divide by n
    (GQA kv heads are repeated up to H first: the scatter splits
    heads)."""
    n = _sp_size(group)
    n_heads = q.shape[2]
    if n_heads % n:
        raise ValueError(f"ulysses needs heads ({n_heads}) divisible by "
                         f"sp ({n})")
    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    q_full, k_full, v_full = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    out = dense_attention(q_full, k_full, v_full, causal=causal)
    return all_to_all(out, 1, 2, group)
