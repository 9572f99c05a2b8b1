"""Paged, prefix-cached continuous batching for the Llama decoder (port of
the JAX package's ``models/serving.py``, single-device paged path).

A request goes through four steps:

1. admission (``ContinuousBatcher._admit_paged``): free slot, free pages
   from ``PageAllocator``, and the longest cached page-aligned prefix from
   ``PrefixCache.match`` mounted read-only;
2. one batched paged prefill (``_prefill_multi_paged_fn``): the hb == 0
   rung runs the dense causal forward (``forward_with_cache``); the hb > 0
   rung prefills only the uncached tail through K2
   (``ops.paged_prefill_attention``). With ``prefill_chunk_tokens`` the
   prompt is prefilled a budget of pages per step instead
   (``_advance_prefill``), each continuation chunk an hb > 0 prefill over
   the slot's own earlier chunks;
3. decode chunks (``_decode_chunk_paged_fn``): ``chunk`` ticks, each one
   K1 launch (``ops.paged_decode_attention``) per layer — or, with
   ``speculative=True``, one verify of a 1 + gamma proposal window per
   step (``_verify_chunk_paged_fn``), one K3 launch
   (``ops.paged_verify_attention``) per layer, read back at once because
   the next proposals depend on it;
4. reaping (``_free_slot_pages``/``_retire_pages``): pages are freed and
   the conversation's full pages donated into the radix tree.

The pool ``[L, n_pages, ps, Hkv, hd]`` is updated in place by each
dispatch (JAX donated and replaced it; in place keeps one copy). Token
reads are deferred exactly as in the JAX engine (``_reads``/``_flush``):
a step enqueues its result tensors and ``step()`` reads them once, so the
decoded-suffix donation sees the same flushed tokens and the prefix-cache
counters match the JAX engine's on the same trace. Random draws come from
``torch.Generator``s seeded from (engine seed, stream, dispatch, tick or
slot); there is no global RNG.
"""
from __future__ import annotations

import math
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.decode_attention import (
    DEFAULT_PAGE_SIZE, paged_decode_attention, paged_plan,
    paged_prefill_attention, paged_verify_attention,
)
from ..ops.layers import apply_rope, rms_norm, rope_freqs
from ..ops.quant import qdot
from .llama import Block, Llama, LlamaConfig, mlp_sublayer
from .paging import NULL_PAGE, PageAllocator
from .prefix_cache import PrefixCache
from .proposers import SlotView, resolve_proposer

NEG_INF = -1e30
_MASK64 = (1 << 64) - 1
# Adaptive gamma: per-request and fleet accept-rate EMA weights.
_SPEC_EMA_ALPHA = 0.3
_SPEC_FLEET_ALPHA = 0.05


def _generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator seeded by splitmix64 over ``key``: one independent
    stream per (engine seed, stream, dispatch, tick or slot)."""
    h = 0x9E3779B97F4A7C15
    for k in key:
        h = (h ^ (int(k) & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 29
    gen = torch.Generator(device=device)
    gen.manual_seed(h & ((1 << 63) - 1))
    return gen


def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               device="cuda") -> Dict[str, object]:
    """Zeros cache [L, B, S, Hkv, hd]; ``len`` is the filled prefix."""
    S = max_len or cfg.max_seq
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "len": 0}


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """q [B, t, H, hd] at absolute positions pos..pos+t-1 against the cache
    [B, S, Hkv, hd], masked to entries <= each query's position. The
    grouped dense path (GQA through a [B, Hkv, g, ...] head axis)."""
    b, t, n_heads, d = q.shape
    s, h_kv = k_cache.shape[1], k_cache.shape[2]
    g = n_heads // h_kv
    qg = q.reshape(b, t, h_kv, g, d)
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache).float() * scale
    q_pos = pos + torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    scores = torch.where(k_pos <= q_pos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache)
    return out.reshape(b, t, n_heads, d)


def _qkv(cfg: LlamaConfig, h: torch.Tensor, blk: Block, angles: torch.Tensor,
         lead: Tuple[int, ...]):
    """Roped q and k, and v, of one block for rows shaped ``lead``."""
    hd = cfg.head_dim
    q = qdot(h, blk.wq).reshape(*lead, cfg.n_heads, hd)
    kk = qdot(h, blk.wk).reshape(*lead, cfg.n_kv_heads, hd)
    vv = qdot(h, blk.wv).reshape(*lead, cfg.n_kv_heads, hd)
    return apply_rope(q, angles), apply_rope(kk, angles), vv


def forward_with_cache(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
                       cache: Dict[str, object]):
    """tokens [B, t] starting at absolute position ``cache["len"]`` →
    (logits [B, t, vocab] f32, cache). The cache's K/V are written in
    place; the returned dict carries the advanced length."""
    B, t = tokens.shape
    pos = int(cache["len"])
    angles = rope_freqs(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                        device=tokens.device)[pos:pos + t]
    x = model.embed[tokens].to(cfg.dtype)
    k_all, v_all = cache["k"], cache["v"]
    for layer, blk in enumerate(model.blocks):
        h = rms_norm(x, blk.attn_norm)
        q, k, v = _qkv(cfg, h, blk, angles, (B, t))
        k_all[layer, :, pos:pos + t] = k
        v_all[layer, :, pos:pos + t] = v
        attn = cached_attention(q, k_all[layer], v_all[layer], pos)
        x = x + qdot(attn.reshape(B, t, cfg.n_heads * cfg.head_dim), blk.wo)
        x = mlp_sublayer(cfg, x, blk)
    x = rms_norm(x, model.final_norm)
    logits = qdot(x, model.lm_head).float()
    return logits, {"k": k_all, "v": v_all, "len": pos + t}


def _kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric int8 for K/V rows: x [..., hd] →
    (int8 [..., hd], f32 scale [..., 1]). Rounds half to even."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / s), -127, 127)
    return q.to(torch.int8), s


def _shaped_logits(logits: torch.Tensor, temperature: float,
                   top_k: int) -> torch.Tensor:
    """The logits temperature/top-k sampling draws from: scaled by
    1/temperature, every logit below the top_k-th set to NEG_INF."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    return logits


def _sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                   temperature: float, top_k: int) -> torch.Tensor:
    """Next token from [..., vocab] logits: argmax when temperature == 0,
    else temperature/top-k categorical sampling by the Gumbel-max trick
    with noise from ``generator`` (each row draws independently)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _shaped_logits(logits, temperature, top_k)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def _decode_chunk_paged_fn(model: Llama, cfg: LlamaConfig, chunk: int,
                           page_size: int, k, v, k_s, v_s,
                           table: torch.Tensor, lens: torch.Tensor,
                           last: torch.Tensor, active: torch.Tensor,
                           angles_full: torch.Tensor, seed: Tuple[int, ...],
                           temperature: float = 0.0, top_k: int = 0):
    """Advance every active slot ``chunk`` tokens against the paged pool
    k/v [L, n_pages, ps, Hkv, hd] (written in place) through ``table``
    [B, n_blocks]. ``lens`` [B] is the rope position, the write address
    and the attention bound at once. Inactive slots still run: their
    K/V row goes to the null page (garbage by contract), their stale
    ``lens`` may sit at capacity (the table and rope lookups clamp), and
    ``lens + 1`` keeps their attention length >= 1. Returns (lens, last,
    emitted [B, chunk] with -1 for inactive slots)."""
    quant = k_s is not None
    B = last.shape[0]
    n_blocks = table.shape[1]
    S = n_blocks * page_size
    dev = last.device
    row_ids = torch.arange(B, device=dev)
    hidden = cfg.n_heads * cfg.head_dim
    toks = []
    for tick in range(chunk):
        x = model.embed[last[:, None]].to(cfg.dtype)            # [B, 1, D]
        angles = angles_full[torch.clamp(lens, max=S - 1)][:, None]
        pg = table[row_ids, torch.clamp(lens // page_size, max=n_blocks - 1)]
        pg_w = torch.where(active, pg, NULL_PAGE)
        off_w = torch.where(active, lens % page_size, 0)
        for layer, blk in enumerate(model.blocks):
            h = rms_norm(x, blk.attn_norm)
            q, kk, vv = _qkv(cfg, h, blk, angles, (B, 1))
            scales = {}
            if quant:
                kq, ksn = _kv_quant(kk[:, 0])
                vq, vsn = _kv_quant(vv[:, 0])
                k[layer][pg_w, off_w] = kq
                v[layer][pg_w, off_w] = vq
                k_s[layer][pg_w, off_w] = ksn
                v_s[layer][pg_w, off_w] = vsn
                scales = dict(k_scale=k_s[layer], v_scale=v_s[layer])
            else:
                k[layer][pg_w, off_w] = kk[:, 0]
                v[layer][pg_w, off_w] = vv[:, 0]
            attn = paged_decode_attention(q[:, 0], k[layer], v[layer], table,
                                          lens + 1, **scales)
            x = x + qdot(attn.reshape(B, 1, hidden), blk.wo)
            x = mlp_sublayer(cfg, x, blk)
        x = rms_norm(x, model.final_norm)
        logits = qdot(x[:, 0], model.lm_head).float()
        gen = (_generator(dev, *seed, tick) if temperature > 0 else None)
        nxt = _sample_tokens(logits, gen, temperature, top_k).to(last.dtype)
        toks.append(torch.where(active, nxt, -1))
        last = torch.where(active, nxt, last)
        lens = lens + active.to(lens.dtype)
    return lens, last, torch.stack(toks, dim=1)


def _verify_chunk_paged_fn(model: Llama, cfg: LlamaConfig, gamma: int,
                           page_size: int, k, v, k_s, v_s,
                           table: torch.Tensor, lens: torch.Tensor,
                           last: torch.Tensor, props: torch.Tensor,
                           active: torch.Tensor, angles_full: torch.Tensor,
                           seed: Tuple[int, ...],
                           eff: Optional[torch.Tensor] = None,
                           q: Optional[torch.Tensor] = None,
                           temperature: float = 0.0, top_k: int = 0):
    """One batched speculative verify dispatch over every slot: score the
    t = 1 + gamma window [last, props...] of each active slot in one
    forward, accept the longest valid proposal prefix, and commit the
    accepted tokens plus one model token.

    The window's K/V rows are written at logical rows lens..lens+gamma
    first (inactive slots write to the null page; a row past the table
    clamps into the slot's last block, as in the JAX engine), then K3
    (``paged_verify_attention``) attends with row i bounded by lens + i +
    1. ``lens`` advances by accepts + 1 only: the rejected overshoot rows
    stay above it, inside the slot's own reserved pages, masked by every
    later read until the next window overwrites them. That clamp is the
    whole rewind.

    ``temperature == 0``: exact match against the verify pass's own
    argmax (cumprod of hits). ``temperature > 0``: rejection sampling —
    proposal i accepts with prob ``min(1, p_i/q_i)`` at its token, or
    ``p_i[prop_i]`` when ``q`` is None (a deterministic proposer); on the
    first rejection the continuation is drawn from ``max(0, p - q)`` (p
    with the proposal zeroed for delta-q), on full acceptance the bonus
    token from p. One generator per dispatch draws [B, gamma] uniforms and
    [B, V] Gumbel noise, so a slot's draws depend on (seed, slot) only.
    ``eff`` [B] is the per-slot effective window: proposal rows at or past
    it never accept. Returns (lens, last, emitted [B, t] with -1 past the
    commit and for inactive slots, accepts [B])."""
    quant = k_s is not None
    B = last.shape[0]
    t = 1 + gamma
    n_blocks = table.shape[1]
    S = n_blocks * page_size
    dev = last.device
    row_ids = torch.arange(B, device=dev)
    hidden = cfg.n_heads * cfg.head_dim
    window = torch.cat([last[:, None], props.to(last.dtype)], dim=1)  # [B, t]
    pos = lens[:, None] + torch.arange(t, dtype=lens.dtype, device=dev)
    pg = table[row_ids[:, None], torch.clamp(pos // page_size,
                                             max=n_blocks - 1)]
    pg_w = torch.where(active[:, None], pg, NULL_PAGE).long()
    off_w = torch.where(active[:, None], pos % page_size, 0).long()
    angles = angles_full[torch.clamp(pos, max=S - 1)]           # [B, t, hd/2]
    x = model.embed[window.long()].to(cfg.dtype)                # [B, t, D]
    for layer, blk in enumerate(model.blocks):
        h = rms_norm(x, blk.attn_norm)
        qq, kk, vv = _qkv(cfg, h, blk, angles, (B, t))
        scales = {}
        if quant:
            kq, ksn = _kv_quant(kk)
            vq, vsn = _kv_quant(vv)
            k[layer][pg_w, off_w] = kq
            v[layer][pg_w, off_w] = vq
            k_s[layer][pg_w, off_w] = ksn
            v_s[layer][pg_w, off_w] = vsn
            scales = dict(k_scale=k_s[layer], v_scale=v_s[layer])
        else:
            k[layer][pg_w, off_w] = kk
            v[layer][pg_w, off_w] = vv
        attn = paged_verify_attention(qq, k[layer], v[layer], table, lens,
                                      **scales)
        x = x + qdot(attn.reshape(B, t, hidden), blk.wo)
        x = mlp_sublayer(cfg, x, blk)
    x = rms_norm(x, model.final_norm)
    logits = qdot(x, model.lm_head).float()                     # [B, t, V]
    eff_i = (torch.full((B,), gamma, dtype=torch.int64, device=dev)
             if eff is None else eff.to(torch.int64))
    pos_ok = torch.arange(gamma, device=dev)[None, :] < eff_i[:, None]
    prop_t = window[:, 1:].long()                               # [B, gamma]
    if temperature <= 0.0:
        greedy = torch.argmax(logits, dim=-1)                   # [B, t]
        hits = ((prop_t == greedy[:, :-1]) & pos_ok).long()
        accepts = torch.cumprod(hits, dim=1).sum(dim=1)
        toks = greedy
    else:
        p = torch.softmax(_shaped_logits(logits, temperature, top_k),
                          dim=-1)                               # [B, t, V]
        vocab = p.shape[-1]
        gen = _generator(dev, *seed)
        u = torch.rand((B, gamma), generator=gen, device=dev)
        p_prop = p[:, :gamma].gather(-1, prop_t[..., None])[..., 0]
        if q is None:
            a_prob = p_prop
        else:
            q_prop = q.gather(-1, prop_t[..., None])[..., 0]
            a_prob = torch.clamp(p_prop / torch.clamp(q_prop, min=1e-20),
                                 max=1.0)
        acc = (pos_ok & (u < a_prob)).long()
        accepts = torch.cumprod(acc, dim=1).sum(dim=1)          # [B]
        p_at = p.gather(1, accepts[:, None, None].expand(B, 1, vocab))[:, 0]
        safe = torch.clamp(accepts, max=gamma - 1)
        if q is None:
            rej = prop_t.gather(1, safe[:, None])[:, 0]
            resid = p_at * (1.0 - torch.nn.functional.one_hot(
                rej, vocab).to(p_at.dtype))
        else:
            q_at = q.gather(1, safe[:, None, None].expand(B, 1, vocab))[:, 0]
            resid = torch.clamp(p_at - q_at, min=0.0)
        corr_dist = torch.where((accepts >= eff_i)[:, None], p_at, resid)
        corr = _sample_tokens(torch.log(corr_dist + 1e-20), gen, 1.0, 0)
        idx_t = torch.arange(t, device=dev)[None, :]
        prop_pad = torch.cat([prop_t, prop_t[:, -1:]], dim=1)
        toks = torch.where(idx_t == accepts[:, None], corr[:, None], prop_pad)
    toks = toks.to(last.dtype)
    commit = torch.arange(t, device=dev)[None, :] <= accepts[:, None]
    emitted = torch.where(commit & active[:, None], toks, -1)
    new_last = toks.gather(1, accepts[:, None])[:, 0]
    last = torch.where(active, new_last, last)
    lens = lens + torch.where(active, accepts + 1, 0).to(lens.dtype)
    accepts = torch.where(active, accepts, 0)
    return lens, last, emitted, accepts


def _prefill_multi_paged_fn(model: Llama, cfg: LlamaConfig, page_size: int,
                            k, v, k_s, v_s, lens: torch.Tensor,
                            last: torch.Tensor, slots: np.ndarray,
                            page_ids: np.ndarray, prefix_tables: np.ndarray,
                            hit_lens: np.ndarray, tokens: np.ndarray,
                            tail_lens: np.ndarray, angles_full: torch.Tensor,
                            seed: Tuple[int, ...], temperature: float = 0.0,
                            top_k: int = 0):
    """Prefill M slots from right-padded tails [M, tb] in one dispatch and
    scatter their K/V rows page-granular into the pool at ``page_ids``
    [M, tb/ps] (the entry's own pages, the bucket overshoot on the null
    page). Host inputs are numpy arrays.

    hb == 0 (``prefix_tables`` [M, 0]): tokens are whole prompts, run by
    the dense causal ``forward_with_cache`` over a zeroed mini cache.
    hb > 0: tokens are the uncached tails; tail row i sits at absolute
    position hit_len + i and attends the cached prefix pages plus itself
    causally through K2. An int8 pool is read dequantized by the tail
    queries while the tail's own K/V stay exact — the JAX engine's
    asymmetry, kept.

    Returns (lens, last, firsts [M]) with each real slot's ``lens`` set to
    hit_len + tail_len and ``last`` to its first sampled token (keyed by
    slot, so a pad row re-draws its entry's token)."""
    quant = k_s is not None
    dev = lens.device
    M, tb = tokens.shape
    npg = page_ids.shape[1]
    hb = prefix_tables.shape[1]
    tok_t = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    if hb == 0:
        shape = (cfg.n_layers, M, tb, cfg.n_kv_heads, cfg.head_dim)
        mini = {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "len": 0}
        logits, mini = forward_with_cache(model, tok_t, cfg, mini)
        mk, mv = mini["k"], mini["v"]
    else:
        hits_t = torch.as_tensor(hit_lens, dtype=torch.int32, device=dev)
        ptab_t = torch.as_tensor(prefix_tables, dtype=torch.int32, device=dev)
        pos_q = hits_t[:, None] + torch.arange(tb, device=dev)[None, :]
        angles = angles_full[torch.clamp(pos_q, max=cfg.max_seq - 1)]
        x = model.embed[tok_t].to(cfg.dtype)
        mks, mvs = [], []
        for layer, blk in enumerate(model.blocks):
            h = rms_norm(x, blk.attn_norm)
            q, kk, vv = _qkv(cfg, h, blk, angles, (M, tb))
            scales = (dict(k_scale=k_s[layer], v_scale=v_s[layer])
                      if quant else {})
            attn = paged_prefill_attention(q, k[layer], v[layer], ptab_t,
                                           hits_t, kk, vv, **scales)
            x = x + qdot(attn.reshape(M, tb, cfg.n_heads * cfg.head_dim),
                         blk.wo)
            x = mlp_sublayer(cfg, x, blk)
            mks.append(kk)
            mvs.append(vv)
        mk, mv = torch.stack(mks), torch.stack(mvs)
        x = rms_norm(x, model.final_norm)
        logits = qdot(x, model.lm_head).float()

    def page_blocks(a):
        # [L, M, tb, Hkv, x] -> [L, M*npg, ps, Hkv, x]
        return a.reshape(a.shape[0], M * npg, page_size, *a.shape[3:])

    # Pad rows repeat a real entry, so duplicate page ids carry identical
    # values and the scatter's write order cannot matter; the null page
    # collects every entry's bucket overshoot (garbage by contract).
    ids = torch.as_tensor(page_ids.reshape(M * npg), dtype=torch.int64,
                          device=dev)
    if quant:
        mkq, mks_ = _kv_quant(mk)
        mvq, mvs_ = _kv_quant(mv)
        k[:, ids] = page_blocks(mkq)
        v[:, ids] = page_blocks(mvq)
        k_s[:, ids] = page_blocks(mks_)
        v_s[:, ids] = page_blocks(mvs_)
    else:
        k[:, ids] = page_blocks(mk)
        v[:, ids] = page_blocks(mv)
    rows = torch.arange(M, device=dev)
    tl = torch.as_tensor(tail_lens, dtype=torch.int64, device=dev)
    sel = logits[rows, tl - 1]                                   # [M, vocab]
    if temperature > 0:
        firsts = torch.stack([
            _sample_tokens(sel[i], _generator(dev, *seed, int(slots[i])),
                           temperature, top_k) for i in range(M)])
    else:
        firsts = _sample_tokens(sel, None, temperature, top_k)
    firsts = firsts.to(last.dtype)
    # The last entry for a slot wins, as in the JAX engine's in-order
    # updates (a slot freed by a max_new == 1 entry can be reused later
    # in the same run); resolved on the host so the device scatter has
    # unique indices.
    last_row = {int(s): i for i, s in enumerate(slots)}
    uniq = torch.as_tensor(list(last_row.values()), dtype=torch.int64,
                           device=dev)
    dst = torch.as_tensor(list(last_row.keys()), dtype=torch.int64,
                          device=dev)
    new_len = torch.as_tensor(np.asarray(hit_lens) + np.asarray(tail_lens),
                              dtype=lens.dtype, device=dev)
    lens = lens.clone()
    last = last.clone()
    lens[dst] = new_len[uniq]
    last[dst] = firsts[uniq]
    return lens, last, firsts


# Options of the JAX engine that later slices of the port bring, with the
# value that means "off".
_LATER_SLICES = {
    "kv_layout": ("paged", "the contiguous-engine slice"),
    "kv_tiering": (False, "the lifecycle and tiering slice"),
    "mesh": (None, "the multi-device slice"),
    "role": ("mixed", "the fleet slice"),
    "fault_injector": (None, "the lifecycle slice"),
    "tracer": (None, "the observability slice"),
    "flight_capacity": (0, "the observability slice"),
}


class ContinuousBatcher:
    """Host-side orchestrator over the paged pool: admit requests into
    free slots between decode chunks (mounting cached prefixes), prefill
    them in one batched dispatch per (tb, hb) rung, decode every active
    slot ``chunk`` tokens per step, and free each finished slot's pages at
    once (donating its full pages into the prefix tree).

    ``speculative=True`` replaces each decode chunk with one verify
    dispatch (``_verify_chunk_paged_fn``, kernel K3) over a 1 + ``gamma``
    window of proposals from ``proposer`` (``models/proposers.py``);
    ``spec_adaptive`` sizes each request's effective window from its
    accept-rate EMA. ``prefill_chunk_tokens`` (a page multiple) caps the
    prompt tokens prefilled per step: admission only binds the slot and
    ``_advance_prefill`` spends the budget page by page, round robin.

    ``model`` must live on ``device`` (default ``"cuda"``; the CPU only
    when asked). ``cfg.decode_attn`` must be ``"fused"``: the port serves
    through the paged kernels. The JAX engine's other options raise
    ``NotImplementedError`` naming the slice that brings them."""

    def __init__(self, model: Llama, cfg: LlamaConfig, n_slots: int = 8,
                 max_len: Optional[int] = None, chunk: int = 8,
                 prefill_bucket: int = 128, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 kv_dtype: Optional[str] = None, kv_layout: str = "paged",
                 page_size: int = DEFAULT_PAGE_SIZE,
                 n_pages: Optional[int] = None, prefix_cache: bool = False,
                 seed: int = 0, device="cuda", speculative: bool = False,
                 gamma: int = 4, proposer=None, spec_adaptive: bool = False,
                 prefill_chunk_tokens: Optional[int] = None,
                 kv_tiering: bool = False, mesh=None, role: str = "mixed",
                 fault_injector=None, tracer=None, flight_capacity: int = 0):
        given = dict(kv_layout=kv_layout, kv_tiering=kv_tiering, mesh=mesh,
                     role=role, fault_injector=fault_injector, tracer=tracer,
                     flight_capacity=flight_capacity)
        for name, (off, slice_name) in _LATER_SLICES.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"{name}={given[name]!r} is not ported yet: it comes "
                    f"with {slice_name}")
        if cfg.decode_attn != "fused":
            raise NotImplementedError(
                f"decode_attn={cfg.decode_attn!r}: the port serves through "
                f"the paged attention kernels; use decode_attn='fused'")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine device "
                             f"is {self.device}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got "
                             f"{kv_dtype!r}")
        if prefill_bucket < 1:
            raise ValueError(f"prefill_bucket must be >= 1, got "
                             f"{prefill_bucket}")
        if top_k > cfg.vocab:
            raise ValueError(f"top_k {top_k} exceeds vocab {cfg.vocab}")
        self.model = model
        self.cfg = cfg
        self.n_slots = n_slots
        self.chunk = chunk
        self.bucket = prefill_bucket
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.kv_dtype = kv_dtype
        self.seed = int(seed)
        self.S = min(max_len or cfg.max_seq, cfg.max_seq)
        if self.S % page_size:
            raise ValueError(f"cache capacity {self.S} not divisible by "
                             f"page_size {page_size}")
        self.page_size = page_size
        self.n_blocks = self.S // page_size
        if paged_plan(self.n_blocks, page_size) is None:
            raise ValueError(f"page_size {page_size} is not a power of two "
                             f"in [8, 256]")
        self.spec = bool(speculative)
        self.gamma = int(gamma)
        self.spec_adaptive = bool(spec_adaptive) and self.spec
        if self.spec:
            if self.gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            self._proposer = resolve_proposer(proposer)
            # Speculation gauges: proposals accepted and proposed, tokens
            # committed per active slot per dispatch, overshoot rewound.
            self._spec_slot_steps = 0
            self._spec_proposed = 0
            self._spec_accepted = 0
            self._spec_emitted = 0
            self._spec_rewound = 0
            self._spec_accept_buf: list = []     # per-dispatch accept rates
            # Adaptive gamma: per-request accept-rate EMA, last effective
            # window, and the overshoot rows pinned at submit (the
            # effective window never exceeds them, so accepted rows land
            # inside reserved pages).
            self._spec_ema: Dict[int, float] = {}
            self._spec_eff_last: Dict[int, int] = {}
            self._spec_reserve: Dict[int, int] = {}
            self._spec_fleet_ema = 1.0
        if prefill_chunk_tokens is not None:
            prefill_chunk_tokens = int(prefill_chunk_tokens)
            if (prefill_chunk_tokens < page_size
                    or prefill_chunk_tokens % page_size):
                raise ValueError(
                    f"prefill_chunk_tokens ({prefill_chunk_tokens}) must be "
                    f"a positive multiple of page_size ({page_size})")
        self._prefill_chunk = prefill_chunk_tokens
        # slot -> prompt tokens already resident; insertion order is the
        # budget's FCFS order.
        self._prefill_pending: "OrderedDict[int, int]" = OrderedDict()
        self._prefill_chunks_total = 0
        n_pages = n_pages or (1 + n_slots * self.n_blocks)
        self._alloc = PageAllocator(n_pages)
        pool = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
                cfg.head_dim)
        dev = self.device
        if kv_dtype == "int8":
            self._k = torch.zeros(pool, dtype=torch.int8, device=dev)
            self._v = torch.zeros(pool, dtype=torch.int8, device=dev)
            self._ks = torch.zeros(pool[:-1] + (1,), dtype=torch.float32,
                                   device=dev)
            self._vs = torch.zeros(pool[:-1] + (1,), dtype=torch.float32,
                                   device=dev)
        else:
            self._k = torch.zeros(pool, dtype=cfg.dtype, device=dev)
            self._v = torch.zeros(pool, dtype=cfg.dtype, device=dev)
            self._ks = self._vs = None
        self._angles = rope_freqs(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                  device=dev)
        # Host mirror of the block table; the device copy is re-uploaded
        # only on steps whose admissions or frees changed it.
        self._table_np = np.zeros((n_slots, self.n_blocks), np.int32)
        self._table = torch.as_tensor(self._table_np, device=dev)
        self._table_dirty = False
        self._lens = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self._last = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self._slot_pages: Dict[int, list] = {}   # slot -> owned page ids
        self._slot_shared: Dict[int, list] = {}  # slot -> mounted hit pages
        self._slot_prompt: Dict[int, list] = {}
        self._last_denied: Optional[int] = None
        self._prefix = (PrefixCache(self._alloc, page_size)
                        if prefix_cache else None)
        self._skipped_tokens = 0
        # Prefill dispatches per (tb, hb) rung; hb > 0 rungs run K2.
        self.prefill_rungs: Dict[Tuple[int, int], int] = {}
        self._dispatch_no = 0
        self._eos_scanned: Dict[int, int] = {}
        self._slot_req: Dict[int, int] = {}      # slot -> req id
        self._budget: Dict[int, int] = {}        # req id -> tokens left
        self._out: Dict[int, list] = {}          # req id -> tokens
        self._queue: list = []                   # (req id, prompt)
        self._reads: list = []                   # deferred readbacks
        self._next_id = 0
        self._arrival: Dict[int, float] = {}
        self._first_tok: Dict[int, float] = {}
        self._metrics: Dict[int, Dict[str, float]] = {}
        self.errors: Dict[int, str] = {}         # req id -> failure text
        self._request_errors = 0

    # -- API ---------------------------------------------------------------
    def submit(self, prompt, max_new: int) -> int:
        """Queue one request; returns its id. ``prompt``: 1-D token ids."""
        prompt = [int(t) for t in prompt]
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + self._rows_needed(max_new) > self.S:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"cache capacity {self.S}")
        need = self._pages_needed(len(prompt), max_new)
        if need > self._alloc.n_pages - 1:
            raise ValueError(
                f"request needs {need} pages worst-case but the pool has "
                f"only {self._alloc.n_pages - 1} usable pages")
        req_id = self._next_id
        self._next_id += 1
        self._budget[req_id] = max_new
        self._out[req_id] = []
        if self.spec:
            # Pin the overshoot this request's pages are reserved for at
            # submit: admission quotes the same figure on every retry.
            self._spec_reserve[req_id] = self._spec_overshoot()
            self._spec_ema[req_id] = self._spec_fleet_ema
        self._arrival[req_id] = time.monotonic()
        self._queue.append((req_id, prompt))
        return req_id

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._slot_req)

    def drain(self, slots=None):
        raise NotImplementedError("drain() comes with the lifecycle slice")

    def restore(self, snap):
        raise NotImplementedError("restore() comes with the lifecycle slice")

    def absorb(self, snap):
        raise NotImplementedError("absorb() comes with the lifecycle slice")

    def _ladder(self, prompt_len: int) -> int:
        """Prefill bucket: the base bucket doubled until it fits, clamped
        to the cache capacity."""
        tb = self.bucket
        while tb < prompt_len:
            tb *= 2
        return min(tb, self.S)

    def _spec_overshoot(self, rid: Optional[int] = None) -> int:
        """Overshoot rows reserved beyond the committed stream: gamma, or
        under adaptive gamma the request's pinned reservation (the fleet
        estimate for a request not yet pinned)."""
        if not self.spec_adaptive:
            return self.gamma
        if rid is not None and rid in self._spec_reserve:
            return self._spec_reserve[rid]
        est = int(math.ceil(self._spec_fleet_ema * self.gamma))
        return max(1, min(self.gamma, est))

    def _rows_needed(self, budget: int, rid: Optional[int] = None) -> int:
        """Worst-case decode rows: remaining steps rounded up to chunks;
        speculative mode commits one row per token but each verify writes
        up to its window past the committed rows, so the overshoot is
        reserved too (that is what makes rewind a lens clamp inside the
        slot's own pages)."""
        steps = max(0, budget - 1)                   # first token = prefill
        if self.spec:
            return steps + self._spec_overshoot(rid)
        return -(-steps // self.chunk) * self.chunk

    def _pages_needed(self, prompt_len: int, budget: int,
                      rid: Optional[int] = None) -> int:
        """Worst-case pages a request can touch, reserved in full at
        admission so a request in flight never waits for a page."""
        return -(-(prompt_len + self._rows_needed(budget, rid))
                 // self.page_size)

    def _hb_bucket(self, n_hit_pages: int) -> int:
        """Prefix-table width rung: 0, or the next power of two clamped to
        the table width."""
        if n_hit_pages == 0:
            return 0
        hb = 1
        while hb < n_hit_pages:
            hb *= 2
        return min(hb, self.n_blocks)

    @staticmethod
    def _group_admissions(adm: list) -> list:
        """Group one step's admissions into prefill runs, one per (tb, hb)
        rung. When a slot repeats within the step (freed by a max_new == 1
        entry and reused), fall back to contiguous runs so per-slot order
        is kept."""
        if len({e[1] for e in adm}) == len(adm):
            by_rung: Dict[tuple, list] = {}
            for entry in adm:
                by_rung.setdefault(entry[4], []).append(entry)
            return list(by_rung.values())
        runs: list = []
        for entry in adm:
            if runs and runs[-1][0][4] == entry[4]:
                runs[-1].append(entry)
            else:
                runs.append([entry])
        return runs

    # -- page lifecycle ----------------------------------------------------
    def _retire_pages(self, own: list, shared: list, prompt: Optional[list],
                      decoded: Optional[list] = None) -> None:
        """Donate the conversation's full pages (prompt plus the verified
        decoded suffix) into the prefix tree where the path is new, and
        drop one reference on everything else."""
        adopted: set = set()
        if self._prefix is not None and prompt is not None:
            conv = list(prompt) + list(decoded or ())
            n_full = min(len(conv) // self.page_size, len(shared) + len(own))
            adopted = set(self._prefix.insert(
                conv[:n_full * self.page_size], (shared + own)[:n_full],
                prompt_len=len(prompt)))
        release = [p for p in shared + own if p not in adopted]
        if release:
            self._alloc.free(release)

    def _donatable_decoded(self, rid: int) -> list:
        """The flushed emitted tokens whose KV rows are resident: every
        flushed token but the last (its row is written by the next tick),
        capped at an eos."""
        if self._prefix is None:
            return []
        raw = self._out.get(rid)
        if not raw or len(raw) < 2:
            return []
        trunc = self._truncate_eos(list(raw))
        return [int(t) for t in trunc[:min(len(trunc), len(raw) - 1)]]

    def _free_slot_pages(self, slot: int,
                         decoded: Optional[list] = None) -> None:
        """Retire a slot's whole reservation. A slot still mid-prefill has
        only ``prefill_done`` prompt rows resident, so its donation stops
        there."""
        prompt = self._slot_prompt.pop(slot, None)
        done = self._prefill_pending.pop(slot, None)
        if done is not None and prompt is not None:
            prompt, decoded = prompt[:done], None
        self._retire_pages(self._slot_pages.pop(slot),
                           self._slot_shared.pop(slot, []), prompt, decoded)
        self._table_np[slot] = NULL_PAGE
        self._table_dirty = True

    def _drop_spec(self, slot: int, rid: int) -> None:
        """Forget a freed slot's proposer mirror and its request's
        speculation state."""
        if self.spec:
            self._proposer.drop(slot)
            self._spec_ema.pop(rid, None)
            self._spec_eff_last.pop(rid, None)
            self._spec_reserve.pop(rid, None)

    def _fail_request(self, slot: int, rid: int, exc: BaseException) -> None:
        """Per-request error isolation: a request whose proposal failed is
        retired with its error in ``self.errors``; every other slot keeps
        its pages and its stream."""
        self.errors[rid] = f"{type(exc).__name__}: {exc}"
        self._request_errors += 1
        self._slot_req.pop(slot, None)
        self._budget.pop(rid, None)
        self._eos_scanned.pop(rid, None)
        self._drop_spec(slot, rid)
        self._free_slot_pages(slot)
        self._out.pop(rid, None)
        self._arrival.pop(rid, None)
        self._first_tok.pop(rid, None)

    # -- step --------------------------------------------------------------
    def _admit_paged(self) -> list:
        """Admit queued requests into free slots (strict FCFS: a head that
        cannot get its pages blocks the queue until reaps free some) and
        dispatch their prefills. Returns the max_new == 1 requests that
        finished at admission."""
        ps = self.page_size
        finished: list = []
        free = [s for s in range(self.n_slots) if s not in self._slot_req]
        adm: list = []           # (req id, slot, pages, prompt, rung, hits)
        free_after: list = []    # max_new == 1 pages, retired post-dispatch
        while free and self._queue and len(adm) < self.n_slots:
            req_id, prompt = self._queue[0]
            P = len(prompt)
            hits: list = []
            if self._prefix is not None:
                # Retain before any eviction: the slot's reference pins
                # the hit path so the LRU sweep cannot reclaim it.
                hits = self._prefix.match(
                    prompt, count=req_id != self._last_denied)
                if hits:
                    self._alloc.retain(hits)
            need = (self._pages_needed(P, self._budget[req_id], req_id)
                    - len(hits))
            if self._prefix is not None and need > self._alloc.free_count:
                self._prefix.evict(need - self._alloc.free_count)
            pages = self._alloc.alloc(
                need, count_denied=req_id != self._last_denied)
            if pages is None:
                if hits:
                    self._alloc.free(hits)
                self._last_denied = req_id
                break
            if req_id == self._last_denied:
                self._last_denied = None
            self._queue.pop(0)
            slot = free.pop()
            row = self._table_np[slot]
            row[:] = NULL_PAGE
            row[:len(hits)] = hits                   # shared, read-only
            row[len(hits):len(hits) + len(pages)] = pages
            self._table_dirty = True
            hit_tok = len(hits) * ps
            self._skipped_tokens += hit_tok
            # The uncached tail's bucket, rounded up to whole pages (the
            # prefill scatter writes whole pages).
            tb = -(-self._ladder(P - hit_tok) // ps) * ps
            adm.append((req_id, slot, pages, prompt,
                        (tb, self._hb_bucket(len(hits))), hits))
            if self._prefill_chunk is not None:
                # Chunked admission: bind the slot and queue its prefill
                # for _advance_prefill; the first token (and the budget
                # decrement) come with its final chunk.
                self._slot_req[slot] = req_id
                self._slot_pages[slot] = pages
                self._slot_shared[slot] = hits
                self._slot_prompt[slot] = prompt
                self._prefill_pending[slot] = hit_tok
                continue
            self._budget[req_id] -= 1                # first token = prefill
            if self._budget[req_id] <= 0:            # max_new == 1
                finished.append(req_id)
                del self._budget[req_id]
                self._drop_spec(slot, req_id)
                free.append(slot)
                free_after.append((pages, hits, prompt))
            else:
                self._slot_req[slot] = req_id
                self._slot_pages[slot] = pages
                self._slot_shared[slot] = hits
                self._slot_prompt[slot] = prompt
        if self._prefill_chunk is not None:
            return finished                  # _advance_prefill dispatches
        for run in self._group_admissions(adm):
            tb, hb = run[0][4]
            npg = -(-tb // ps)
            # Pad with the LAST entry: nothing supersedes it within a run.
            rows = run + [run[-1]] * (self.n_slots - len(run))
            norm = []
            for _, slot, pg, p, _, h in rows:
                tail = p[len(h) * ps:]
                norm.append((
                    slot,
                    [pg[j] if j < len(pg) else NULL_PAGE for j in range(npg)],
                    [h[j] if j < len(h) else NULL_PAGE for j in range(hb)],
                    len(h) * ps, tail, len(tail)))
            firsts = self._dispatch_prefill_paged(norm, tb, hb)
            self._reads.append(("firsts", firsts, [rid for rid, *_ in run]))
        for pages, hits, prompt in free_after:
            self._retire_pages(pages, hits, prompt)
        return finished

    def _dispatch_prefill_paged(self, rows, tb: int, hb: int):
        """One padded prefill dispatch. ``rows``: (slot, page-id row,
        prefix row, hit_len, tail tokens, tail_len), padded to n_slots."""
        self._dispatch_no += 1
        self.prefill_rungs[(tb, hb)] = self.prefill_rungs.get((tb, hb), 0) + 1
        self._lens, self._last, firsts = _prefill_multi_paged_fn(
            self.model, self.cfg, self.page_size, self._k, self._v, self._ks,
            self._vs, self._lens, self._last,
            slots=np.asarray([r[0] for r in rows], np.int32),
            page_ids=np.asarray([r[1] for r in rows], np.int32),
            prefix_tables=np.asarray([r[2] for r in rows],
                                     np.int32).reshape(len(rows), hb),
            hit_lens=np.asarray([r[3] for r in rows], np.int32),
            tokens=np.asarray([t + [0] * (tb - len(t))
                               for _, _, _, _, t, _ in rows], np.int32),
            tail_lens=np.asarray([r[5] for r in rows], np.int32),
            angles_full=self._angles,
            seed=(self.seed, 1, self._dispatch_no),
            temperature=self.temperature, top_k=self.top_k)
        return firsts

    def _device_table(self) -> torch.Tensor:
        if self._table_dirty:
            self._table = torch.as_tensor(self._table_np.copy(),
                                          device=self.device)
            self._table_dirty = False
        return self._table

    # -- chunked prefill ---------------------------------------------------
    def _chunk_ladder(self, n: int) -> int:
        """Prefill-chunk bucket: the page size doubled until the chunk
        fits, clamped to the cache capacity (page multiple by
        construction)."""
        tb = self.page_size
        while tb < n:
            tb *= 2
        return min(tb, self.S)

    def _prefill_backlog(self) -> int:
        """Admitted but not yet prefilled prompt tokens."""
        return sum(len(self._slot_prompt[s]) - d
                   for s, d in self._prefill_pending.items())

    def _advance_prefill(self) -> list:
        """Spend the per-step prefill budget on partially prefilled slots,
        page-quantum round robin, oldest admission first: each pass hands
        every pending slot one page of its prompt (or its final partial
        remainder) until the budget is spent, so a short prompt slips in
        beside a long one. One dispatch per (tb, hb) rung through
        ``_dispatch_prefill_paged``: a continuation chunk is a prefix-hit
        tail prefill whose "hit" is the rows the slot's own earlier chunks
        made resident (K2). The final chunk emits the first token, where
        the budget decrement and the max_new == 1 finish happen. Returns
        the requests that finished."""
        if not self._prefill_pending:
            return []
        ps = self.page_size
        remaining = {s: len(self._slot_prompt[s]) - d
                     for s, d in self._prefill_pending.items()}
        grants: Dict[int, int] = {}
        left = self._prefill_chunk
        progressed = True
        while progressed and left > 0:
            progressed = False
            for slot in self._prefill_pending:
                rem = remaining[slot] - grants.get(slot, 0)
                if rem <= 0:
                    continue
                # A whole page or the final partial tail, never a partial
                # non-final quantum; one the leftover cannot fund waits
                # for the next step, where the slot draws first.
                q = min(ps, rem)
                if q > left:
                    continue
                grants[slot] = grants.get(slot, 0) + q
                left -= q
                progressed = True
                if left <= 0:
                    break
        # (rid, slot, chunk page ids, chunk tokens, (tb, hb), done, size,
        # final): slot at [1] and the rung at [4], as _group_admissions
        # reads them.
        entries: list = []
        for slot, done in list(self._prefill_pending.items()):
            cb = grants.get(slot, 0)
            if cb <= 0:
                continue
            prompt = self._slot_prompt[slot]
            tb = self._chunk_ladder(cb)
            start_pg = done // ps
            row = self._table_np[slot]
            pids = [int(row[start_pg + j]) if start_pg + j < self.n_blocks
                    else NULL_PAGE for j in range(tb // ps)]
            entries.append((self._slot_req[slot], slot, pids,
                            [int(t) for t in prompt[done:done + cb]],
                            (tb, self._hb_bucket(start_pg)), done, cb,
                            done + cb >= len(prompt)))
        for run in self._group_admissions(entries):
            tb, hb = run[0][4]
            rows = run + [run[-1]] * (self.n_slots - len(run))
            # Resident prefix: the table row below prefill_done (shared
            # hit pages, then this slot's earlier chunks), null-padded.
            norm = [(e[1], e[2],
                     [int(self._table_np[e[1]][j]) if j < e[5] // ps
                      else NULL_PAGE for j in range(hb)],
                     e[5], e[3], e[6]) for e in rows]
            firsts = self._dispatch_prefill_paged(norm, tb, hb)
            # Only final chunks carry a first token; the others read back
            # as None and _flush drops them.
            self._reads.append(("firsts", firsts,
                                [e[0] if e[7] else None for e in run]))
            self._prefill_chunks_total += len(run)
        finished: list = []
        retire: list = []
        for rid, slot, _, _, _, done, cb, fin in entries:
            if not fin:
                self._prefill_pending[slot] = done + cb
                continue
            del self._prefill_pending[slot]
            self._budget[rid] -= 1                   # first token
            if self._budget[rid] <= 0:               # max_new == 1
                finished.append(rid)
                del self._budget[rid]
                del self._slot_req[slot]
                self._drop_spec(slot, rid)
                retire.append(slot)
        for slot in retire:                          # after every dispatch
            self._free_slot_pages(slot)
        return finished

    # -- step --------------------------------------------------------------
    @torch.no_grad()
    def _step_lazy(self) -> list:
        """Admit, advance pending prefill chunks, then dispatch one decode
        chunk (or, speculative, one verify) over the fully prefilled
        slots — mid-prefill slots ride it inactive. Only the verify reads
        back. Returns the finished req ids."""
        finished = self._admit_paged()
        finished.extend(self._advance_prefill())
        ready = {s: r for s, r in self._slot_req.items()
                 if s not in self._prefill_pending}
        if ready:
            step = self._verify_step if self.spec else self._decode_step
            finished.extend(step(ready))
        return finished

    def _active(self, ready: dict) -> torch.Tensor:
        return torch.as_tensor([s in ready for s in range(self.n_slots)],
                               device=self.device)

    def _decode_step(self, ready: dict) -> list:
        """One decode chunk over ``ready`` {slot: req id}; its tokens are
        read back later (``_flush``)."""
        self._dispatch_no += 1
        self._lens, self._last, toks = _decode_chunk_paged_fn(
            self.model, self.cfg, self.chunk, self.page_size, self._k,
            self._v, self._ks, self._vs, self._device_table(), self._lens,
            self._last, self._active(ready), self._angles,
            (self.seed, 0, self._dispatch_no), self.temperature, self.top_k)
        finished: list = []
        takes: list = []                             # (req id, slot, n)
        for slot, req_id in ready.items():
            budget = self._budget[req_id]
            take = min(budget, self.chunk)
            takes.append((req_id, slot, take))
            self._budget[req_id] = budget - take
            if self._budget[req_id] <= 0:
                finished.append(req_id)
                del self._budget[req_id]
                del self._slot_req[slot]
                # This chunk's tokens are not flushed yet: only the
                # flushed prefix donates (the conservative bound).
                self._free_slot_pages(slot, self._donatable_decoded(req_id))
        self._reads.append(("chunk", toks, takes))
        return finished

    def _spec_eff_window(self, rid: int) -> int:
        """This dispatch's effective verify window for one request: gamma,
        or under adaptive gamma the EMA's estimate, capped at the pinned
        reservation; a window stuck at 0 probes with 1 every 8th
        dispatch so a self-repeating stream can reopen it."""
        if not self.spec_adaptive:
            return self.gamma
        ema = self._spec_ema.get(rid, self._spec_fleet_ema)
        w = int(round(ema * self.gamma))
        if w <= 0 and self._dispatch_no % 8 == 0:
            w = 1
        return max(0, min(w, self._spec_reserve.get(rid, self.gamma)))

    def _verify_step(self, ready: dict) -> list:
        """Propose for every ready slot, then one verify dispatch; each
        slot commits 1..gamma+1 tokens. The next proposals depend on this
        step's tokens, so the step reads them back at once — after
        flushing the pending prefill firsts the proposers read."""
        self._flush()
        self._dispatch_no += 1
        props = np.zeros((self.n_slots, self.gamma), np.int32)
        views = []
        for slot, rid in ready.items():
            # A proposal that fails fails only its own request.
            try:
                view = SlotView(slot, rid, self._slot_prompt[slot],
                                self._out[rid])
                if self._proposer.batched:
                    views.append(view)
                else:
                    props[slot] = self._proposer.propose(view, self.gamma)
            except Exception as e:  # noqa: BLE001 — isolate the request
                self._fail_request(slot, rid, e)
        q = None
        if self._proposer.distributional:
            q = np.zeros((self.n_slots, self.gamma, self.cfg.vocab),
                         np.float32)
        if views:
            # A batched proposer (the draft model) failing is an engine
            # fault, not one request's.
            p_arr, q_arr = self._proposer.propose_batch(
                views, self.gamma, self._dispatch_no)
            for i, vw in enumerate(views):
                props[vw.slot] = p_arr[i]
                if q is not None and q_arr is not None:
                    q[vw.slot] = q_arr[i]
        ready = {s: r for s, r in self._slot_req.items()
                 if s not in self._prefill_pending}
        if not ready:                                # every slot failed
            return []
        eff = np.zeros((self.n_slots,), np.int32)
        for slot, rid in ready.items():
            eff[slot] = self._spec_eff_window(rid)
        dev = self.device
        self._lens, self._last, toks, accepts = _verify_chunk_paged_fn(
            self.model, self.cfg, self.gamma, self.page_size, self._k,
            self._v, self._ks, self._vs, self._device_table(), self._lens,
            self._last, torch.as_tensor(props, device=dev),
            self._active(ready), self._angles,
            (self.seed, 2, self._dispatch_no),
            eff=torch.as_tensor(eff, device=dev),
            q=None if q is None else torch.as_tensor(q, device=dev),
            temperature=self.temperature, top_k=self.top_k)
        toks, accepts = toks.cpu().numpy(), accepts.cpu().numpy()
        finished: list = []
        step_used = step_eff = 0
        for slot, rid in ready.items():
            take = min(self._budget[rid], int(accepts[slot]) + 1)
            self._out[rid].extend(int(tk) for tk in toks[slot, :take])
            # The gauges count what the stream kept: proposals accepted
            # past the budget are rewound like any rejection.
            used = take - 1
            eff_i = int(eff[slot])
            step_used += used
            step_eff += eff_i
            if self.spec_adaptive:
                if eff_i > 0:            # a closed window carries no signal
                    rate = min(used, eff_i) / eff_i
                    ema = self._spec_ema.get(rid, self._spec_fleet_ema)
                    self._spec_ema[rid] = ((1.0 - _SPEC_EMA_ALPHA) * ema
                                           + _SPEC_EMA_ALPHA * rate)
                    self._spec_fleet_ema = (
                        (1.0 - _SPEC_FLEET_ALPHA) * self._spec_fleet_ema
                        + _SPEC_FLEET_ALPHA * rate)
                self._spec_eff_last[rid] = eff_i
            self._spec_slot_steps += 1
            self._spec_proposed += eff_i
            self._spec_accepted += used
            self._spec_emitted += take
            self._spec_rewound += self.gamma - used
            self._budget[rid] -= take
            if self._budget[rid] <= 0:
                finished.append(rid)
                del self._budget[rid]
                del self._slot_req[slot]
                self._drop_spec(slot, rid)
                # The commits are in _out already: the donation sees the
                # whole stream.
                self._free_slot_pages(slot, self._donatable_decoded(rid))
        if step_eff:
            self._spec_accept_buf.append(step_used / step_eff)
        return finished

    def _flush(self) -> None:
        """Read every outstanding result tensor and replay them, in
        dispatch order, into ``self._out``."""
        if not self._reads:
            return
        vals = [arr.cpu().numpy() for _, arr, _ in self._reads]
        now = time.monotonic()
        for (kind, _, meta), got in zip(self._reads, vals):
            if kind == "firsts":
                for req_id, val in zip(meta, got):   # pad rows fall off
                    if req_id is None:               # intermediate chunk
                        continue
                    if not self._out[req_id]:
                        self._first_tok.setdefault(req_id, now)
                    self._out[req_id].append(int(val))
            else:
                for req_id, slot, take in meta:
                    if take and not self._out[req_id]:
                        self._first_tok.setdefault(req_id, now)
                    self._out[req_id].extend(int(t) for t in got[slot, :take])
        self._reads = []

    def _record_done(self, req_ids, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        for rid in req_ids:
            arrival = self._arrival.pop(rid, now)
            first = self._first_tok.pop(rid, now)
            self._metrics[rid] = {
                "ttft_s": first - arrival,
                "latency_s": now - arrival,
                "tokens": float(len(self._out.get(rid, ()))),
            }

    def pop_request_metrics(self) -> Dict[int, Dict[str, float]]:
        """Per-request latency records since the last call: {req id:
        {ttft_s, latency_s, tokens}} (host clock at flush)."""
        out, self._metrics = self._metrics, {}
        return out

    def pool_metrics(self) -> Dict[str, object]:
        """Page-pool gauges; with the prefix cache on, the reuse counters
        and ``prefill_tokens_skipped``; the chunked-prefill backlog and
        chunk count; isolated request failures; and, speculative, the
        accept rate (accepted / proposed), tokens committed per slot per
        verify, overshoot rows rewound, the proposer's name, the spread of
        the last effective windows and the per-dispatch accept rates since
        the last call (drained here)."""
        out: Dict[str, object] = self._alloc.metrics()
        if self._prefix is not None:
            out.update(self._prefix.metrics())
            out["prefill_tokens_skipped"] = float(self._skipped_tokens)
        out["prefill_backlog_tokens"] = float(self._prefill_backlog())
        out["prefill_chunks_total"] = float(self._prefill_chunks_total)
        out["request_errors_total"] = float(self._request_errors)
        if self.spec:
            out["spec_accept_rate"] = (
                self._spec_accepted / self._spec_proposed
                if self._spec_proposed else 0.0)
            out["spec_tokens_per_dispatch"] = (
                self._spec_emitted / self._spec_slot_steps
                if self._spec_slot_steps else 0.0)
            out["spec_rewound_tokens_total"] = float(self._spec_rewound)
            out["spec_proposer"] = self._proposer.name
            effs = ([self._spec_eff_last[r] for r in self._slot_req.values()
                     if r in self._spec_eff_last]
                    if self.spec_adaptive else [])
            if not effs:
                effs = [self.gamma if not self.spec_adaptive
                        else self._spec_overshoot()]
            out["spec_gamma_agg"] = {"min": float(min(effs)),
                                     "mean": float(sum(effs) / len(effs)),
                                     "max": float(max(effs))}
            if self._spec_accept_buf:
                out["spec_accept_batch"] = tuple(self._spec_accept_buf)
                self._spec_accept_buf = []
        return out

    def _reap_eos(self) -> list:
        """Free slots whose flushed output now holds eos."""
        reaped: list = []
        for slot, req_id in list(self._slot_req.items()):
            out = self._out[req_id]
            seen = self._eos_scanned.get(req_id, 0)
            if self.eos_id in out[seen:]:
                del self._slot_req[slot]
                del self._budget[req_id]
                self._eos_scanned.pop(req_id, None)
                self._drop_spec(slot, req_id)
                self._free_slot_pages(slot, self._donatable_decoded(req_id))
                reaped.append(req_id)
            else:
                self._eos_scanned[req_id] = len(out)
        return reaped

    def _truncate_eos(self, toks: list) -> list:
        if self.eos_id is None:
            return toks
        try:
            return toks[: toks.index(self.eos_id) + 1]
        except ValueError:
            return toks

    def step(self) -> Dict[int, list]:
        """Admit, decode one chunk, read back; returns newly finished
        {req id: tokens}."""
        finished = self._step_lazy()
        self._flush()
        if self.eos_id is not None:
            finished.extend(self._reap_eos())
            for rid in finished:
                self._eos_scanned.pop(rid, None)
        self._record_done(finished)
        return {rid: self._truncate_eos(self._out.pop(rid))
                for rid in finished}

    def run(self) -> Dict[int, list]:
        """Drain everything submitted; returns {req id: tokens}. Without
        an eos every chunk dispatches back to back and the results are
        read once at the end."""
        if self.eos_id is not None:
            done: Dict[int, list] = {}
            while self.pending:
                done.update(self.step())
            return done
        finished: list = []
        while self.pending:
            finished.extend(self._step_lazy())
        self._flush()
        self._record_done(finished)
        return {rid: self._out.pop(rid) for rid in finished}
