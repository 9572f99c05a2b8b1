"""Serving for the Llama decoder (port of the JAX package's
``models/serving.py``, single device): the single-sequence functions
(``generate``, ``generate_speculative`` and their server steps) and
continuous batching over two cache layouts.

**Paged, prefix-cached** (``kv_layout="paged"``, the production serving
path; the default is the JAX engine's, ``"contiguous"``). A request goes
through four steps:

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
   the conversation's full pages (and, with ``donate_decoded``, the
   verified decoded suffix) donated into the radix tree.

**Contiguous, shared cursor** (``kv_layout="contiguous"``). The caches are
``[L, B, S, Hkv, hd]`` and every slot writes its decode row at ONE scalar
cursor; slots at different request offsets are reconciled by a per-slot
``rope_pos`` and a validity bitmap ``[B, S]`` that masks attention to the
rows each slot wrote. Admission (``_step_contiguous``) writes the prompt
backward from the cursor into the freed slot's rows
(``_prefill_multi_fn``), strictly first come first served; decode chunks
(``_decode_chunk_fn``) run one K4 launch (``ops.flash_decode_attention``,
``cursor + 1`` and the bitmap) per layer per tick; when every slot has
drained, the cursor and the bitmap reset (an epoch roll).

**Lifecycle and KV tier** (paged only). ``drain()`` flushes, gathers every
referenced pool page once and returns a ``ServingSnapshot``
(``models/snapshot.py``, the JAX package's wire format); ``restore()``
re-lays it out into a fresh engine of any pool size, and ``absorb()`` merges
a partial drain (``drain(slots=...)``) into a running one.
``kv_tiering=True`` demotes evicted prefix pages into a host tier
(``paging.HostTierStore``) in one batched gather a step boundary and
promotes them back in one scatter (``_scatter_pages``) before the matching
slot's first prefill. ``fault_injector`` (``testing/faults.py``) fires
``serve.step`` and ``serve.propose``.

**Observability** (``obs/``). Every host time the engine reads goes
through its ``clock`` (a ``VirtualClock`` in tests). ``tracer`` collects
the JAX engine's phase spans, under its names, lanes and attributes
(queue, admit, prefill, prefill_chunk, decode_chunk, verify, rewind,
reap; drain, shed, restore, absorb; demote, promote); the flight recorder
(``flight_capacity``, 256 by default, 0 for none) keeps one record per
step and rides the snapshot through drain and restore. A span brackets
host work: a dispatch span ends when its kernels are enqueued. No hook
reads a device value.

**Single sequence.** ``generate`` prefills a ``[B, T]`` prompt batch and
decodes greedily through ``forward_with_cache`` (K4 per layer per token
with ``cfg.decode_attn="fused"``); ``generate_speculative`` (B = 1)
proposes by bigram lookup and verifies each 1 + gamma window in one
forward, K3 over the contiguous cache viewed as pages
(``ops.contiguous_as_paged``).

The pool and the caches are updated in place by each dispatch (JAX
donated and replaced them; in place keeps one copy). Token reads are
deferred exactly as in the JAX engine (``_reads``/``_flush``): a step
enqueues its result tensors and ``step()`` reads them once, so the
decoded-suffix donation sees the same flushed tokens and the prefix-cache
counters match the JAX engine's on the same trace. Random draws come from
``torch.Generator``s seeded from (seed, stream, dispatch or position, tick
or slot); there is no global RNG.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict, deque
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs.flight import FlightRecorder
from ..obs.trace import SYSTEM_CLOCK
from ..ops.decode_attention import (
    DEFAULT_PAGE_SIZE, contiguous_as_paged, decode_plan,
    flash_decode_attention, paged_decode_attention, paged_plan,
    paged_prefill_attention, paged_verify_attention,
)
from ..ops.layers import apply_rope, rms_norm, rope_freqs
from ..ops.quant import qdot
from ..testing.faults import Preempted
from .llama import Block, Llama, LlamaConfig, mlp_sublayer
from .paging import NULL_PAGE, HostTierStore, PageAllocator
from .prefix_cache import PrefixCache
from .proposers import SlotView, resolve_proposer
from .snapshot import (
    ServingSnapshot, SnapshotError, as_words, check_fingerprint, host_dtype,
)

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
                     v_cache: torch.Tensor, pos: int, impl: str = "dense",
                     verify: bool = False) -> torch.Tensor:
    """q [B, t, H, hd] at absolute positions pos..pos+t-1 against the cache
    [B, S, Hkv, hd], masked to entries <= each query's position.

    ``impl="fused"`` routes the decode shape (t == 1) through K4
    (``flash_decode_attention`` at ``pos + 1``) and, with ``verify=True``,
    the speculative 1 + gamma window (t > 1) through K3
    (``paged_verify_attention``), the contiguous cache viewed as a page
    pool of ``decode_plan(S)``'s block size with an ``arange`` table. An S
    that no such block divides raises on that route. Every other t > 1
    call is a prefill and takes the grouped dense path (GQA through a
    [B, Hkv, g, ...] head axis), as does ``impl="dense"``."""
    b, t, n_heads, d = q.shape
    s, h_kv = k_cache.shape[1], k_cache.shape[2]
    if impl == "fused" and t == 1:
        return flash_decode_attention(q[:, 0], k_cache, v_cache,
                                      int(pos) + 1)[:, None]
    if impl == "fused" and verify and t > 1:
        plan = decode_plan(s)
        if plan is None:
            raise ValueError(
                f"decode_attn='fused': the verify window needs a cache "
                f"capacity divisible by a power of two from 8 to 256, got "
                f"S={s}")
        kp, table = contiguous_as_paged(k_cache, plan[0])
        vp, _ = contiguous_as_paged(v_cache, plan[0])
        return paged_verify_attention(q, kp, vp, table, int(pos))
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
                       cache: Dict[str, object], verify: bool = False):
    """tokens [B, t] starting at absolute position ``cache["len"]`` →
    (logits [B, t, vocab] f32, cache). The cache's K/V are written in
    place; the returned dict carries the advanced length. Attention
    follows ``cfg.decode_attn`` (``cached_attention``); ``verify=True``
    marks a speculative 1 + gamma window, which is how the fused route
    tells it from a prefill."""
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
        attn = cached_attention(q, k_all[layer], v_all[layer], pos,
                                impl=cfg.decode_attn, verify=verify)
        x = x + qdot(attn.reshape(B, t, cfg.n_heads * cfg.head_dim), blk.wo)
        x = mlp_sublayer(cfg, x, blk)
    x = rms_norm(x, model.final_norm)
    logits = qdot(x, model.lm_head).float()
    return logits, {"k": k_all, "v": v_all, "len": pos + t}


@torch.no_grad()
def generate(model: Llama, prompt, cfg: LlamaConfig, max_new: int,
             mesh=None, max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy decode on the model's device: prefill the prompt [B, Tp],
    then one single-token forward per new token. Returns [B, max_new]
    token ids in the prompt's dtype."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh is not ported yet: it comes with the multi-device slice")
    prompt = torch.as_tensor(prompt, device=model.device)
    B, t_prompt = prompt.shape
    S = min(max_len or cfg.max_seq, cfg.max_seq)
    if t_prompt + max_new > S:
        raise ValueError(
            f"prompt ({t_prompt}) + max_new ({max_new}) exceeds cache/rope "
            f"capacity ({S})")
    cache = init_cache(cfg, B, S, device=model.device)
    logits, cache = forward_with_cache(model, prompt, cfg, cache)
    toks = [torch.argmax(logits[:, -1], dim=-1)]
    for _ in range(max_new - 1):
        logits, cache = forward_with_cache(model, toks[-1][:, None], cfg,
                                           cache)
        toks.append(torch.argmax(logits[:, -1], dim=-1))
    return torch.stack(toks, dim=1)[:, :max_new].to(prompt.dtype)


def make_server_step(cfg: LlamaConfig, mesh, max_new: int,
                     max_len: Optional[int] = None):
    """Request handler: (model, prompt [B, Tp]) → [B, max_new]."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh is not ported yet: it comes with the multi-device slice")
    return partial(generate, cfg=cfg, max_new=max_new, max_len=max_len)


def _kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric int8 for K/V rows: x [..., hd] →
    (int8 [..., hd], f32 scale [..., 1]). Rounds half to even."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / s), -127, 127)
    return q.to(torch.int8), s


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype that holds a pool plane on the host: bf16 as its
    16-bit words, f32 and int8 as themselves."""
    return host_dtype(str(dtype).replace("torch.", ""))


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


def _bigram_lookup(seq: np.ndarray, n: int, gamma: int) -> np.ndarray:
    """Prompt-lookup proposal over the decided tokens ``seq[:n]``: the
    latest j <= n - 2 with seq[j-1:j+1] == seq[n-2:n] guesses
    seq[j+1 : j+1+gamma]; with no match the guess is seq[1 : 1+gamma]
    (garbage the verify rejects). Rows at and past n are scratch."""
    a, b = seq[n - 2], seq[n - 1]
    hits = np.flatnonzero((seq[:n - 2] == a) & (seq[1:n - 1] == b))
    j = int(hits[-1]) + 1 if hits.size else 0
    return seq[j + 1:j + 1 + gamma]


@torch.no_grad()
def generate_speculative(model: Llama, prompt, cfg: LlamaConfig, max_new: int,
                         gamma: int = 4, max_len: Optional[int] = None,
                         temperature: float = 0.0, top_k: int = 0,
                         seed: int = 0) -> torch.Tensor:
    """Decode one request (B = 1) with prompt-lookup speculation: each
    iteration proposes ``gamma`` tokens by bigram match against the
    sequence so far and verifies them in one (1 + gamma)-token forward
    (``verify=True``: K3 with ``cfg.decode_attn="fused"``).

    ``temperature == 0`` accepts the longest prefix that agrees with the
    verify pass's own argmax, plus the model's token at the first
    disagreement: the output equals ``generate``'s up to float near-ties.
    ``temperature > 0`` runs speculative-sampling rejection in its
    deterministic-proposer (delta-q) form against the temperature/top-k
    target law: proposal i accepts with probability p_i[prop_i], the first
    rejection resamples from p with the proposed token zeroed, a full
    accept draws the bonus token from p_gamma. Draws come from a generator
    keyed by (seed, decided-token count), so a seed replays its stream.

    The accept length decides the next proposal, so every iteration reads
    back once. The rewind sets ``cache["len"]``: stale rows above it lie
    inside the next verify's write window and are rewritten before any
    query can attend them. Returns [1, max_new] in the prompt's dtype."""
    dev = model.device
    prompt = torch.as_tensor(prompt, device=dev)
    B, t_prompt = prompt.shape
    if B != 1:
        raise ValueError(f"speculative decode is single-request (B=1), got {B}")
    S = min(max_len or cfg.max_seq, cfg.max_seq)
    if t_prompt + max_new + gamma > S:
        # Overshoot room: a verify may write gamma rows past the last
        # accepted position before the rewind.
        raise ValueError(
            f"prompt ({t_prompt}) + max_new ({max_new}) + gamma ({gamma}) "
            f"exceeds cache/rope capacity ({S})")
    if cfg.decode_attn == "fused" and decode_plan(S) is None:
        raise ValueError(
            f"decode_attn='fused': the verify window needs a cache capacity "
            f"divisible by a power of two from 8 to 256, got S={S}")
    sampled = temperature > 0.0
    seq = np.zeros(t_prompt + max_new + gamma + 1, np.int64)
    seq[:t_prompt] = prompt[0].cpu().numpy()
    cache = init_cache(cfg, 1, S, device=dev)
    logits, cache = forward_with_cache(model, prompt, cfg, cache)
    gen = _generator(dev, seed, 3, t_prompt) if sampled else None
    seq[t_prompt] = int(_sample_tokens(logits[0, -1], gen, temperature,
                                       top_k))
    # Invariant: seq[:n] are decided tokens; the cache holds K/V for
    # seq[:n-1] (the newest token is fed to the next forward).
    n = t_prompt + 1
    while n - t_prompt < max_new:
        prop = torch.as_tensor(_bigram_lookup(seq, n, gamma), device=dev)
        window = torch.cat([torch.as_tensor(seq[n - 1:n], device=dev), prop])
        logits, cache = forward_with_cache(model, window[None], cfg, cache,
                                           verify=True)
        if sampled:
            p = torch.softmax(_shaped_logits(logits[0], temperature, top_k),
                              dim=-1)                       # [1+gamma, V]
            gen = _generator(dev, seed, 3, n)
            u = torch.rand((gamma,), generator=gen, device=dev)
            p_prop = p[:gamma].gather(-1, prop[:, None])[:, 0]
            accept = torch.cumprod((u < p_prop).long(), dim=0).sum()
            p_at = p[accept]
            rej = prop[torch.clamp(accept, max=gamma - 1)]
            resid = p_at * (1.0 - torch.nn.functional.one_hot(
                rej, p.shape[-1]).to(p_at.dtype))
            dist = torch.where(accept >= gamma, p_at, resid)
            corr = _sample_tokens(torch.log(dist + 1e-20), gen, 1.0, 0)
            toks = torch.where(torch.arange(1 + gamma, device=dev) == accept,
                               corr, torch.cat([prop, prop[-1:]]))
        else:
            toks = torch.argmax(logits[0], dim=-1)
            accept = torch.cumprod((prop == toks[:-1]).long(), dim=0).sum()
        got = torch.cat([toks, accept[None]]).cpu().numpy()  # the read-back
        accept = int(got[-1])
        # The whole window is written and n advances by accept + 1 only:
        # rows past it are scratch, overwritten before they are read as
        # decided tokens.
        seq[n:n + 1 + gamma] = got[:-1]
        cache["len"] = n + accept            # rewind to the accepted prefix
        n += accept + 1
    out = seq[None, t_prompt:t_prompt + max_new]
    return torch.as_tensor(out, device=dev).to(prompt.dtype)


def make_speculative_server_step(cfg: LlamaConfig, max_new: int,
                                 gamma: int = 4,
                                 max_len: Optional[int] = None,
                                 temperature: float = 0.0, top_k: int = 0,
                                 seed: int = 0):
    """Request handler: (model, prompt [1, Tp]) → [1, max_new], the
    ``make_server_step`` analogue of the speculative path."""
    return partial(generate_speculative, cfg=cfg, max_new=max_new,
                   gamma=gamma, max_len=max_len, temperature=temperature,
                   top_k=top_k, seed=seed)


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
        attend = lens + 1                 # every layer's attention bound
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
                                          attend, **scales)
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


def _decode_chunk_fn(model: Llama, cfg: LlamaConfig, chunk: int, k, v, k_s,
                     v_s, bitmap: torch.Tensor, cursor: int,
                     rope_pos: torch.Tensor, last: torch.Tensor,
                     active: torch.Tensor, angles_full: torch.Tensor,
                     seed: Tuple[int, ...], temperature: float = 0.0,
                     top_k: int = 0):
    """Advance every active slot ``chunk`` tokens against the contiguous
    caches k/v [L, B, S, Hkv, hd] (written in place, as is ``bitmap``
    [B, S]). Every slot's row of a tick is written at the one shared
    ``cursor`` — an inactive slot's too, garbage that is never marked
    valid — and the row's bit is set for active slots before attention,
    so the new token attends itself. Attention is K4 at ``cursor + 1``
    with the bitmap: the cursor bounds every set bit, the bitmap picks
    each slot's own rows. ``rope_pos`` [B] is the slot's request-relative
    position. ``k_s``/``v_s`` [L, B, S, Hkv, 1] switch to int8 caches
    whose rows are quantised at the write. Returns (rope_pos, last,
    emitted [B, chunk] with -1 for inactive slots); the caller advances
    its cursor by ``chunk``."""
    quant = k_s is not None
    B = last.shape[0]
    S = k.shape[2]
    if cursor < 0 or cursor + chunk > S:
        raise ValueError(f"decode chunk rows {cursor}..{cursor + chunk - 1} "
                         f"leave the cache (S={S})")
    dev = last.device
    hidden = cfg.n_heads * cfg.head_dim
    toks = []
    for tick in range(chunk):
        row = cursor + tick
        bitmap[:, row] |= active
        x = model.embed[last[:, None]].to(cfg.dtype)            # [B, 1, D]
        # A finished slot's stale rope_pos may sit at S: clamp the lookup.
        angles = angles_full[torch.clamp(rope_pos, max=S - 1)][:, None]
        for layer, blk in enumerate(model.blocks):
            h = rms_norm(x, blk.attn_norm)
            q, kk, vv = _qkv(cfg, h, blk, angles, (B, 1))
            scales = {}
            if quant:
                kq, ksn = _kv_quant(kk[:, 0])
                vq, vsn = _kv_quant(vv[:, 0])
                k[layer][:, row] = kq
                v[layer][:, row] = vq
                k_s[layer][:, row] = ksn
                v_s[layer][:, row] = vsn
                scales = dict(k_scale=k_s[layer], v_scale=v_s[layer])
            else:
                k[layer][:, row] = kk[:, 0]
                v[layer][:, row] = vv[:, 0]
            attn = flash_decode_attention(q[:, 0], k[layer], v[layer],
                                          row + 1, bitmap=bitmap, **scales)
            x = x + qdot(attn.reshape(B, 1, hidden), blk.wo)
            x = mlp_sublayer(cfg, x, blk)
        x = rms_norm(x, model.final_norm)
        logits = qdot(x[:, 0], model.lm_head).float()
        gen = (_generator(dev, *seed, tick) if temperature > 0 else None)
        nxt = _sample_tokens(logits, gen, temperature, top_k).to(last.dtype)
        toks.append(torch.where(active, nxt, -1))
        last = torch.where(active, nxt, last)
        rope_pos = rope_pos + active.to(rope_pos.dtype)
    return rope_pos, last, torch.stack(toks, dim=1)


def _prefill_multi_fn(model: Llama, cfg: LlamaConfig, k, v, k_s, v_s,
                      bitmap: torch.Tensor, rope_pos: torch.Tensor,
                      last: torch.Tensor, slots, cursors, tokens: np.ndarray,
                      real_lens, seed: Tuple[int, ...],
                      temperature: float = 0.0, top_k: int = 0):
    """Prefill M freed slots of the contiguous caches from right-padded
    prompts [M, tb] in one dispatch: every prompt's K/V is computed in a
    batched mini cache (rope from 0, ``forward_with_cache``), then each
    entry's tb rows are written into its slot's window ending at its
    cursor (rows cursor - real_len .. cursor - real_len + tb - 1). Only
    the real_len prompt rows are marked valid; the padded tail lands ahead
    of the cursor and is overwritten by the slot's own decode steps before
    it could be attended. Entries apply in order, so a slot that repeats
    within the dispatch (freed by a max_new == 1 entry and reused) ends
    with its last entry's state. The caches, ``bitmap``, ``rope_pos`` and
    ``last`` are written in place.

    Per entry the host guarantees cursor >= real_len and cursor - real_len
    + tb <= S; a breach raises. int8 caches quantise the prompt's K/V
    once on the way in: prefill math is untouched.

    Returns firsts [M]: each entry's first token from the logits at its
    last prompt position (sampled by a generator keyed by slot)."""
    quant = k_s is not None
    dev = last.device
    S = k.shape[2]
    M, tb = tokens.shape
    for slot, cursor, real_len in zip(slots, cursors, real_lens):
        if not (1 <= real_len <= cursor and cursor - real_len + tb <= S):
            raise ValueError(
                f"prefill window of slot {slot} (cursor {cursor}, prompt "
                f"{real_len}, bucket {tb}) leaves the cache (S={S})")
    shape = (cfg.n_layers, M, tb, cfg.n_kv_heads, cfg.head_dim)
    mini = {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev), "len": 0}
    logits, mini = forward_with_cache(
        model, torch.as_tensor(tokens, dtype=torch.int64, device=dev), cfg,
        mini)
    mk, mv = mini["k"], mini["v"]
    if quant:
        (mk, mks), (mv, mvs) = _kv_quant(mk), _kv_quant(mv)
    sel = logits[torch.arange(M, device=dev),
                 torch.as_tensor(real_lens, dtype=torch.int64,
                                 device=dev) - 1]               # [M, vocab]
    if temperature > 0:
        firsts = torch.stack([
            _sample_tokens(sel[i], _generator(dev, *seed, int(slots[i])),
                           temperature, top_k) for i in range(M)])
    else:
        firsts = _sample_tokens(sel, None, temperature, top_k)
    firsts = firsts.to(last.dtype)
    col = torch.arange(S, device=dev)
    for i, (slot, cursor, real_len) in enumerate(
            zip(slots, cursors, real_lens)):
        slot, cursor, start = int(slot), int(cursor), int(cursor - real_len)
        k[:, slot, start:start + tb] = mk[:, i]
        v[:, slot, start:start + tb] = mv[:, i]
        if quant:
            k_s[:, slot, start:start + tb] = mks[:, i]
            v_s[:, slot, start:start + tb] = mvs[:, i]
        bitmap[slot] = (col >= start) & (col < cursor)
        rope_pos[slot] = int(real_len)
        last[slot] = firsts[i]
    return firsts


# Options of the JAX engine that later slices of the port bring, with the
# value that means "off" (for weight_sharding and tp_combine: JAX's
# defaults, which change nothing without a mesh).
_LATER_SLICES = {
    "mesh": (None, "the multi-device slice"),
    "weight_sharding": (True, "the multi-device slice"),
    "tp_combine": ("all_gather", "the multi-device slice"),
    "role": ("mixed", "the fleet slice"),
}


class ContinuousBatcher:
    """Host-side orchestrator of continuous batching: admit requests into
    free slots between decode chunks, prefill them in one batched dispatch
    per bucket rung, decode every active slot ``chunk`` tokens per step,
    and hand a finished request's slot to the next one at once.

    ``kv_layout="paged"`` keeps K/V in a page pool behind per-slot block
    tables: admission needs free pages and mounts cached prefixes
    (``prefix_cache=True``, prefill rungs (tb, hb), kernels K2 and K1),
    and a finished slot's pages are freed at once, its full pages donated
    into the prefix tree. ``speculative=True`` replaces each
    decode chunk with one verify dispatch (``_verify_chunk_paged_fn``,
    kernel K3) over a 1 + ``gamma`` window of proposals from ``proposer``
    (``models/proposers.py``); ``spec_adaptive`` sizes each request's
    effective window from its accept-rate EMA. ``prefill_chunk_tokens`` (a
    page multiple) caps the prompt tokens prefilled per step: admission
    only binds the slot and ``_advance_prefill`` spends the budget page by
    page, round robin. ``donate_decoded`` (default True) also donates a
    finished request's verified decoded suffix into the prefix tree, so a
    follow-up turn mounts its whole transcript.

    ``kv_layout="contiguous"`` (default, as in the JAX engine) keeps K/V
    in ``[L, B, S, Hkv, hd]`` caches with one shared write cursor, a
    per-slot validity bitmap and per-slot rope positions (kernel K4): a prompt is written backward from the
    cursor, admission is strictly first come first served (a head whose
    window or decode rows do not fit under S blocks the queue), and once
    every slot has drained the cursor and the bitmap reset (an epoch
    roll; ``epoch_rolls`` and ``fcfs_stops`` count both). The options that
    need pages (``speculative``, ``prefix_cache``, ``prefill_chunk_tokens``,
    ``prefill_attn``) raise ``ValueError`` on this layout, and
    ``pool_metrics()`` is empty.

    The paged engine drains to a snapshot (``drain``), restores one into a
    fresh engine (``restore``) and absorbs a shed slot (``absorb``);
    ``kv_tiering`` demotes evicted prefix pages to host DRAM
    (``dram_pages``, then disk under ``kv_tier_disk``) and promotes them
    back; ``fault_injector`` is the chaos hook.

    ``clock`` (default the system clock) is the time every queue wait,
    TTFT, watchdog age and span reads; ``tracer`` (an ``obs.Tracer``,
    default None) records the phase spans; ``flight_capacity`` (default
    256, 0 for none) sizes the flight recorder's ring.

    ``model`` must live on ``device`` (default ``"cuda"``; the CPU only
    when asked). ``cfg.decode_attn`` must be ``"fused"``: the port serves
    through the attention kernels. The JAX engine's other options raise
    ``NotImplementedError`` naming the slice that brings them."""

    def __init__(self, model: Llama, cfg: LlamaConfig, n_slots: int = 8,
                 max_len: Optional[int] = None, chunk: int = 8,
                 prefill_bucket: int = 128, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 kv_dtype: Optional[str] = None,
                 kv_layout: str = "contiguous",
                 page_size: int = DEFAULT_PAGE_SIZE,
                 n_pages: Optional[int] = None, prefix_cache: bool = False,
                 seed: int = 0, device="cuda", speculative: bool = False,
                 gamma: int = 4, proposer=None, spec_adaptive: bool = False,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefill_attn: Optional[str] = None,
                 donate_decoded: bool = True,
                 kv_tiering: bool = False, dram_pages: Optional[int] = None,
                 kv_tier_disk: Optional[str] = None, mesh=None,
                 weight_sharding: bool = True,
                 tp_combine: str = "all_gather", role: str = "mixed",
                 fault_injector=None, tracer=None, clock=None,
                 flight_capacity: int = 256):
        given = dict(mesh=mesh, weight_sharding=weight_sharding,
                     tp_combine=tp_combine, role=role)
        for name, (off, slice_name) in _LATER_SLICES.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"{name}={given[name]!r} is not ported yet: it comes "
                    f"with {slice_name}")
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"kv_layout must be 'contiguous' or 'paged', "
                             f"got {kv_layout!r}")
        if cfg.decode_attn != "fused":
            raise NotImplementedError(
                f"decode_attn={cfg.decode_attn!r}: the port serves through "
                f"the attention kernels; use decode_attn='fused'")
        if prefill_attn not in (None, "auto", "kernel", "gather"):
            raise ValueError(f"prefill_attn must be None/'auto'/'kernel'/"
                             f"'gather', got {prefill_attn!r}")
        paged = kv_layout == "paged"
        # KV tiering: a capacity knob behind the prefix tree, absent from
        # fingerprint() like n_pages.
        if kv_tiering and not paged:
            raise ValueError(
                "kv_tiering=True requires kv_layout='paged' (the tier "
                "demotes page-pool pages behind the radix tree)")
        if kv_tiering and not prefix_cache:
            raise ValueError(
                "kv_tiering=True requires prefix_cache=True (demotion "
                "parks CACHED tree pages; without the tree there is "
                "nothing to tier)")
        if not kv_tiering and (dram_pages is not None
                               or kv_tier_disk is not None):
            raise ValueError(
                "dram_pages/kv_tier_disk require kv_tiering=True")
        if not paged:
            for name, on, why in (
                    ("speculative=True", speculative,
                     "rewind is a lens clamp inside the slot's own pages"),
                    ("prefix_cache=True", prefix_cache,
                     "the contiguous cursor cache has no shareable pages"),
                    ("prefill_chunk_tokens", prefill_chunk_tokens is not None,
                     "chunks land page-granular through the block tables"),
                    ("prefill_attn", prefill_attn in ("kernel", "gather"),
                     "the prefix-attention prefill streams pool pages by "
                     "block table")):
                if on:
                    raise ValueError(
                        f"{name} requires kv_layout='paged' ({why})")
        if prefill_attn == "gather":
            raise NotImplementedError(
                "prefill_attn='gather': the port prefills cached prefixes "
                "through the prefix-attention kernel only")
        self.layout = kv_layout
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
        self._donate_decoded = bool(donate_decoded)
        self.S = min(max_len or cfg.max_seq, cfg.max_seq)
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
        dev = self.device
        self._angles = rope_freqs(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                  device=dev)
        self._last = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        # Observability: every host time read goes through ``_clock``;
        # ``_obs_mu`` guards what a scrape thread reads while the step
        # loop writes, so pool_metrics() takes one consistent snapshot.
        # Every buffer is bounded, dropping its oldest entry.
        self._clock = clock or SYSTEM_CLOCK
        self._tracer = tracer
        self._flight = (FlightRecorder(flight_capacity, self._clock)
                        if flight_capacity else None)
        self._obs_mu = threading.Lock()
        self._phase_buf: deque = deque(maxlen=4096)
        self._timelines: "OrderedDict[int, list]" = OrderedDict()
        self._rid_label: Dict[int, str] = {}
        self._step_faults: list = []      # fault kinds fired this step
        self._step_admitted = 0           # admissions this step
        # Chaos hook (testing/faults.py): ``serve.step`` fires once a step
        # before any state changes, ``serve.propose`` once a slot a
        # proposal; page-pressure rules hold pool pages hostage.
        self._faults = fault_injector
        self._chaos_pages: list = []
        # Lifecycle: a drained engine refuses further work; restore()
        # fills a fresh one. Durations and the resumed count are gauges.
        self._drained = False
        self._drain_s: Optional[float] = None
        self._restore_s: Optional[float] = None
        self._resumed = 0
        self._shed_total = 0                     # requests shed to a peer
        if paged:
            self._init_paged(page_size, n_pages, prefix_cache,
                             prefill_chunk_tokens, kv_tiering, dram_pages,
                             kv_tier_disk)
        else:
            # One shared write cursor; per-slot validity bitmap and rope
            # position reconcile slots at different request offsets.
            self._k, self._v, self._ks, self._vs = self._kv_buffers(
                (cfg.n_layers, n_slots, self.S, cfg.n_kv_heads, cfg.head_dim))
            self._bitmap = torch.zeros((n_slots, self.S), dtype=torch.bool,
                                       device=dev)
            self._cursor = 0
            self._rope_pos = torch.zeros(n_slots, dtype=torch.int32,
                                         device=dev)
            self.epoch_rolls = 0     # cursor + bitmap resets
            self.fcfs_stops = 0      # steps whose admission stopped at a
            #                          head with no room left this epoch
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
        # Liveness: host time of the last step's start
        # (``last_step_age_seconds``).
        self._last_step_t = self._clock.monotonic()

    def _kv_buffers(self, shape: Tuple[int, ...]):
        """Zeroed (k, v, k_scale, v_scale) of ``shape`` [..., hd]: int8
        with f32 [..., 1] scale planes under ``kv_dtype="int8"``, else the
        config's dtype and no scales."""
        dev = self.device
        if self.kv_dtype == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                device=dev),
                    torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                device=dev))
        return (torch.zeros(shape, dtype=self.cfg.dtype, device=dev),
                torch.zeros(shape, dtype=self.cfg.dtype, device=dev),
                None, None)

    def _init_paged(self, page_size: int, n_pages: Optional[int],
                    prefix_cache: bool, prefill_chunk_tokens: Optional[int],
                    kv_tiering: bool, dram_pages: Optional[int],
                    kv_tier_disk: Optional[str]) -> None:
        """The paged layout's state: pool, allocator, block table, lens,
        prefix tree (over a host tier when tiering) and the
        chunked-prefill queue."""
        cfg, n_slots, dev = self.cfg, self.n_slots, self.device
        if self.S % page_size:
            raise ValueError(f"cache capacity {self.S} not divisible by "
                             f"page_size {page_size}")
        self.page_size = page_size
        self.n_blocks = self.S // page_size
        if paged_plan(self.n_blocks, page_size) is None:
            raise ValueError(f"page_size {page_size} is not a power of two "
                             f"in [8, 256]")
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
        self._k, self._v, self._ks, self._vs = self._kv_buffers(
            (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim))
        # Host mirror of the block table; the device copy is re-uploaded
        # only on steps whose admissions or frees changed it.
        self._table_np = np.zeros((n_slots, self.n_blocks), np.int32)
        self._table = torch.as_tensor(self._table_np, device=dev)
        self._table_dirty = False
        self._lens = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self._slot_pages: Dict[int, list] = {}   # slot -> owned page ids
        self._slot_shared: Dict[int, list] = {}  # slot -> mounted hit pages
        self._slot_prompt: Dict[int, list] = {}
        self._last_denied: Optional[int] = None
        # KV tiering: LRU eviction demotes cached leaves into the host
        # tier (default capacity: the pool's pages) instead of forgetting
        # them; a match through a demoted path promotes its pages back
        # before the slot's first prefill (_admit_paged). kv_tier_disk
        # spills the tier's coldest pages there when its DRAM is full.
        self._tier = (HostTierStore(int(dram_pages) if dram_pages is not None
                                    else int(n_pages), disk_dir=kv_tier_disk)
                      if kv_tiering else None)
        self._prefix = (PrefixCache(self._alloc, page_size, tier=self._tier)
                        if prefix_cache else None)
        self._skipped_tokens = 0
        # Per-admission prefix hit lengths (tokens, a miss is 0), drained by
        # pool_metrics() as ``prefix_hit_token_batch``; oldest dropped.
        self._hit_tok_buf: deque = deque(maxlen=4096)
        # The promoted subset of those hit lengths (tokens whose pages
        # came back from the host tier), drained the same way.
        self._promoted_hit_buf: deque = deque(maxlen=4096)
        # Device bytes of the pool and of the weights, fixed at build:
        # numel x element size, never a read of the live tensors.
        self._kv_pool_dev_bytes = sum(
            t.numel() * t.element_size()
            for t in (self._k, self._v, self._ks, self._vs) if t is not None)
        self._weight_dev_bytes = sum(
            t.numel() * t.element_size()
            for t in (*self.model.parameters(), *self.model.buffers()))
        # Prefill dispatches per (tb, hb) rung; hb > 0 rungs run K2.
        self.prefill_rungs: Dict[Tuple[int, int], int] = {}

    # -- observability -----------------------------------------------------
    _TIMELINE_MAX = 1024                  # completed-request timeline cap

    def _rid(self, req_id: int) -> str:
        """Span correlation label of a request: its ``trace_id`` or
        ``req-<n>``."""
        return self._rid_label.get(req_id, f"req-{req_id}")

    def _obs_span(self, phase: str, t0: float, t1: float,
                  rid: Optional[int] = None, lane: str = "engine",
                  fold: bool = True, **attrs) -> None:
        """Record one phase span: to the tracer (with the rid label), to
        the request's timeline, and — when ``fold`` — into the
        phase-duration batch pool_metrics() drains. Per-slot lane copies
        of an engine-wide dispatch span pass fold=False so the histogram
        counts each dispatch once."""
        label = None if rid is None else self._rid(rid)
        self._tracer.record(phase, t0, t1, lane=lane, rid=label, **attrs)
        evicted: list = []
        with self._obs_mu:
            if fold:
                self._phase_buf.append((phase, t1 - t0))
            if rid is not None:
                tl = self._timelines.get(rid)
                if tl is None:
                    while len(self._timelines) >= self._TIMELINE_MAX:
                        evicted.append(self._timelines.popitem(last=False)[0])
                    tl = self._timelines.setdefault(rid, [])
                tl.append({"phase": phase, "t0": t0, "t1": t1, **attrs})
        for old in evicted:
            # A trace label lives as long as the timeline that needs it.
            self._rid_label.pop(old, None)

    def request_timeline(self, rid) -> Optional[Dict[str, object]]:
        """A traced request's timeline: the ordered phase events and a
        per-phase rollup {count, total_s}; None if it was never traced.
        ``rid`` is the request id or its trace label."""
        if isinstance(rid, str):
            # A copy: submit() and the timeline eviction change the dict.
            matches = [i for i, lbl in self._rid_label.copy().items()
                       if lbl == rid]
            if not matches and rid.startswith("req-"):
                try:
                    matches = [int(rid[4:])]
                except ValueError:
                    matches = []
            if not matches:
                return None
            rid = matches[-1]
        with self._obs_mu:
            events = [dict(e) for e in self._timelines.get(rid, [])]
        if not events:
            return None
        phases: Dict[str, Dict[str, float]] = {}
        for e in events:
            p = phases.setdefault(e["phase"], {"count": 0, "total_s": 0.0})
            p["count"] += 1
            p["total_s"] += e["t1"] - e["t0"]
        return {"request": rid, "trace_id": self._rid(rid),
                "events": events, "phases": phases}

    def label_request(self, req_id: int, label: Optional[str]) -> None:
        """Attach a trace label to a live request (after ``absorb()``
        gave it a fresh local id: labels do not ride snapshots)."""
        if label:
            self._rid_label[int(req_id)] = str(label)

    # -- API ---------------------------------------------------------------
    def submit(self, prompt, max_new: int,
               trace_id: Optional[str] = None) -> int:
        """Queue one request; returns its id. ``prompt``: 1-D token ids;
        ``trace_id`` labels its spans (default ``req-<id>``)."""
        if self._drained:
            raise RuntimeError(
                "engine is drained: admission is stopped; restore() the "
                "snapshot into a fresh engine")
        prompt = [int(t) for t in prompt]
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + self._rows_needed(max_new) > self.S:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"cache capacity {self.S}")
        if self.layout == "paged":
            # The worst-case reservation must fit the pool, or the request
            # could never admit and strict FCFS would spin forever.
            need = self._pages_needed(len(prompt), max_new)
            if need > self._alloc.n_pages - 1:
                raise ValueError(
                    f"request needs {need} pages worst-case but the pool "
                    f"has only {self._alloc.n_pages - 1} usable pages")
        req_id = self._next_id
        self._next_id += 1
        self._budget[req_id] = max_new
        self._out[req_id] = []
        if self.spec:
            # Pin the overshoot this request's pages are reserved for at
            # submit: admission quotes the same figure on every retry.
            self._spec_reserve[req_id] = self._spec_overshoot()
            self._spec_ema[req_id] = self._spec_fleet_ema
        self._arrival[req_id] = self._clock.monotonic()
        if trace_id is not None:
            self._rid_label[req_id] = str(trace_id)
        self._queue.append((req_id, prompt))
        return req_id

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._slot_req)

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
        """Worst-case decode rows (cursor rows on the contiguous layout,
        where the shared cursor advances a chunk per dispatch): remaining
        steps rounded up to chunks;
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
        capped at an eos; none with ``donate_decoded=False``."""
        if not self._donate_decoded or self._prefix is None:
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
        if slot in self._slot_pages:
            self._free_slot_pages(slot)
        else:
            self._prefill_pending.pop(slot, None)
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
            t_adm = self._clock.monotonic()
            evicted = 0
            hits: list = []
            demoted: list = []
            if self._prefix is not None:
                # Retain before any eviction: the slot's reference pins
                # the hit path so the LRU sweep cannot reclaim it.
                if self._tier is not None:
                    # The path runs through demoted nodes too: the
                    # resident prefix mounts as usual, the demoted suffix
                    # is promoted into fresh pages below (a pending
                    # demotion the walk crosses is cancelled in place).
                    path, demoted = self._prefix.match_tiered(
                        prompt, count=req_id != self._last_denied)
                    hits = path[:len(path) - len(demoted)]
                else:
                    hits = self._prefix.match(
                        prompt, count=req_id != self._last_denied)
                if hits:
                    self._alloc.retain(hits)
            # Fresh pages: the slot's own reservation plus one per demoted
            # hit page to promote into.
            need = (self._pages_needed(P, self._budget[req_id], req_id)
                    - len(hits) - len(demoted))
            if self._prefix is not None \
                    and need + len(demoted) > self._alloc.free_count:
                evicted = need + len(demoted) - self._alloc.free_count
                self._prefix.evict(evicted)
                if self._tier is not None:
                    # evict() only enqueued demotions: their pages free
                    # once the readback drains. The tier's capacity shed
                    # in that drain may forget the tail of this very
                    # path; keep the still-promotable prefix.
                    self._drain_demotions()
                    alive = 0
                    for nd in demoted:
                        if nd.demoted is None \
                                or not self._tier.has(nd.demoted):
                            break
                        alive += 1
                    if alive < len(demoted):
                        del demoted[alive:]
                        need = (self._pages_needed(
                            P, self._budget[req_id], req_id)
                            - len(hits) - len(demoted))
            pages = self._alloc.alloc(
                need + len(demoted),
                count_denied=req_id != self._last_denied)
            if pages is None:
                if hits:
                    self._alloc.free(hits)
                if self._tracer is not None \
                        and req_id != self._last_denied:
                    # The admission-stall marker, once per blocked head.
                    self._tracer.event(
                        "page_shortage", lane="engine",
                        rid=self._rid(req_id), need=need,
                        free=self._alloc.free_count)
                self._last_denied = req_id
                break
            if req_id == self._last_denied:
                self._last_denied = None
            self._queue.pop(0)
            slot = free.pop()
            if demoted:
                # Promotion: the demoted suffix's parked bytes land in the
                # first len(demoted) fresh pages before the slot's first
                # prefill; they then mount like resident hits. The tree
                # adopts the allocation's reference, the slot retains.
                t_pr = self._clock.monotonic()
                promo, pages = pages[:len(demoted)], pages[len(demoted):]
                pay = [self._tier.pop(nd.demoted) for nd in demoted]
                self._scatter_pages(promo, *(
                    None if pay[0][i] is None
                    else np.stack([p[i] for p in pay], axis=1)
                    for i in range(4)))
                self._prefix.promote(demoted, promo)
                self._alloc.retain(promo)
                hits = hits + promo
                with self._obs_mu:
                    self._promoted_hit_buf.append(len(promo) * ps)
                if self._tracer is not None:
                    self._obs_span("promote", t_pr, self._clock.monotonic(),
                                   rid=req_id, pages=len(promo))
            row = self._table_np[slot]
            row[:] = NULL_PAGE
            row[:len(hits)] = hits                   # shared, read-only
            row[len(hits):len(hits) + len(pages)] = pages
            self._table_dirty = True
            hit_tok = len(hits) * ps
            self._skipped_tokens += hit_tok
            if self._prefix is not None:
                with self._obs_mu:
                    self._hit_tok_buf.append(hit_tok)
            # The uncached tail's bucket, rounded up to whole pages (the
            # prefill scatter writes whole pages).
            tb = -(-self._ladder(P - hit_tok) // ps) * ps
            adm.append((req_id, slot, pages, prompt,
                        (tb, self._hb_bucket(len(hits))), hits))
            if self._tracer is not None:
                self._obs_span("queue", self._arrival.get(req_id, t_adm),
                               t_adm, rid=req_id, prompt_len=P)
                self._obs_span("admit", t_adm, self._clock.monotonic(),
                               rid=req_id, slot=slot, bucket=tb,
                               hit_pages=len(hits), new_pages=len(pages),
                               evicted=evicted)
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
            self._step_admitted = len(adm)
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
            t_pf = self._clock.monotonic()
            firsts = self._dispatch_prefill_paged(norm, tb, hb)
            self._reads.append(("firsts", firsts, [rid for rid, *_ in run]))
            if self._tracer is not None:
                t1 = self._clock.monotonic()
                self._obs_span("prefill", t_pf, t1, bucket=tb,
                               prefix_bucket=hb,
                               requests=[self._rid(r) for r, *_ in run])
                for rid, slot, _, _, _, h in run:
                    self._obs_span("prefill", t_pf, t1, rid=rid,
                                   lane=f"slot{slot}", fold=False,
                                   hit_pages=len(h))
        for pages, hits, prompt in free_after:
            self._retire_pages(pages, hits, prompt)
        self._step_admitted = len(adm)
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
        # Chunking off: a slot restored or absorbed mid-prefill finishes
        # its whole remainder in one chunk.
        left = self._prefill_chunk
        if left is None:
            grants = dict(remaining)
        progressed = left is not None
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
            t_pf = self._clock.monotonic()
            firsts = self._dispatch_prefill_paged(norm, tb, hb)
            # Only final chunks carry a first token; the others read back
            # as None and _flush drops them.
            self._reads.append(("firsts", firsts,
                                [e[0] if e[7] else None for e in run]))
            self._prefill_chunks_total += len(run)
            if self._tracer is not None:
                t1 = self._clock.monotonic()
                self._obs_span("prefill_chunk", t_pf, t1, bucket=tb,
                               prefix_bucket=hb,
                               tokens=int(sum(e[6] for e in run)),
                               requests=[self._rid(e[0]) for e in run])
                for e in run:
                    self._obs_span("prefill_chunk", t_pf, t1, rid=e[0],
                                   lane=f"slot{e[1]}", fold=False,
                                   tokens=e[6], done=e[5] + e[6],
                                   final=e[7])
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
                if self._tracer is not None:
                    t_rp = self._clock.monotonic()
                    self._obs_span("reap", t_rp, self._clock.monotonic(),
                                   rid=rid, slot=slot)
        for slot in retire:                          # after every dispatch
            self._free_slot_pages(slot)
        if entries and self._flight is not None:
            self._flight.record(
                "prefill_chunk", slots=len(entries),
                tokens=int(sum(e[6] for e in entries)),
                backlog=self._prefill_backlog(), retired=len(finished))
        return finished

    # -- step --------------------------------------------------------------
    @torch.no_grad()
    def _step_lazy(self) -> list:
        """Admit, advance pending prefill chunks, then dispatch one decode
        chunk (or, speculative, one verify) over the fully prefilled
        slots — mid-prefill slots ride it inactive. Only the verify reads
        back. Returns the finished req ids."""
        if self._drained:
            raise RuntimeError(
                "engine is drained: restore() the snapshot into a fresh "
                "engine")
        with self._obs_mu:
            self._last_step_t = self._clock.monotonic()
        self._step_faults = []
        if self._faults is not None:
            # May raise (drop, preempt) before any state changes this
            # step; page-pressure rules come back to be applied. The
            # faults fired this step land in the flight recorder, as a
            # ``fault`` record when one raises.
            n0 = len(self._faults.log)
            try:
                rules = self._faults.fire("serve.step")
            except BaseException:
                if self._flight is not None:
                    self._flight.record("fault", injected=[
                        k for _, _, k in self._faults.log[n0:]])
                raise
            self._step_faults = [k for _, _, k in self._faults.log[n0:]]
            self._apply_page_pressure(rules)
        if self.layout == "contiguous":
            return self._step_contiguous()
        finished = self._admit_paged()
        finished.extend(self._advance_prefill())
        ready = {s: r for s, r in self._slot_req.items()
                 if s not in self._prefill_pending}
        if ready:
            step = self._verify_step if self.spec else self._decode_step
            return step(ready, finished)
        if not self.spec and self._flight is not None:
            self._flight.record("admit_only", active=0,
                                admitted=self._step_admitted,
                                retired=len(finished),
                                pool_free=self._alloc.free_count,
                                faults=self._step_faults)
        return finished

    def _step_contiguous(self) -> list:
        """The contiguous layout's step: roll the epoch when every slot
        has drained, admit queued requests backward from the shared
        cursor (strict FCFS), prefill them in one dispatch per bucket
        rung, then decode one chunk at the cursor. Nothing is read back.
        Returns the finished req ids."""
        if not self._slot_req and self._cursor:
            # Epoch roll: every slot drained — reclaim the cursor space.
            self._cursor = 0
            self._bitmap.zero_()
            self.epoch_rolls += 1
        finished: list = []
        free = [s for s in range(self.n_slots) if s not in self._slot_req]
        adm: list = []                   # (req id, slot, cursor, prompt, tb)
        # len(adm) < n_slots: a max_new == 1 admission hands its slot
        # straight back, so a burst of them could otherwise admit without
        # bound within one step.
        while free and self._queue and len(adm) < self.n_slots:
            req_id, prompt = self._queue[0]
            P = len(prompt)
            tb = self._ladder(P)
            # The prompt writes backward from the cursor; bump the cursor
            # forward (free: it only skips rows) if the window would start
            # below 0. Both bounds are _prefill_multi_fn's contract.
            cursor = max(self._cursor, P)
            if (cursor - P + tb > self.S
                    or cursor + self._rows_needed(self._budget[req_id])
                    > self.S):
                # No room this epoch: stop admitting (strict FCFS). Later,
                # smaller requests let past the blocked head would keep
                # consuming cursor rows, the slots would never all drain,
                # the epoch never roll and the head starve. With admission
                # frozen the occupied slots finish, the epoch rolls, and
                # the head admits at cursor == P.
                self.fcfs_stops += 1
                break
            self._queue.pop(0)
            self._cursor = cursor
            slot = free.pop()
            adm.append((req_id, slot, cursor, prompt, tb))
            if self._tracer is not None:
                now = self._clock.monotonic()
                self._obs_span("queue", self._arrival.get(req_id, now),
                               now, rid=req_id, prompt_len=P)
                self._obs_span("admit", now, self._clock.monotonic(),
                               rid=req_id, slot=slot, bucket=tb)
            self._budget[req_id] -= 1                # first token = prefill
            if self._budget[req_id] <= 0:            # max_new == 1
                finished.append(req_id)
                del self._budget[req_id]
                free.append(slot)                    # slot never occupied
            else:
                self._slot_req[slot] = req_id
        for run in self._group_admissions(adm):
            tb = run[0][4]
            self._dispatch_no += 1
            t_pf = self._clock.monotonic()
            firsts = _prefill_multi_fn(
                self.model, self.cfg, self._k, self._v, self._ks, self._vs,
                self._bitmap, self._rope_pos, self._last,
                slots=[e[1] for e in run], cursors=[e[2] for e in run],
                tokens=np.asarray([e[3] + [0] * (tb - len(e[3]))
                                   for e in run], np.int32),
                real_lens=[len(e[3]) for e in run],
                seed=(self.seed, 1, self._dispatch_no),
                temperature=self.temperature, top_k=self.top_k)
            if self._tracer is not None:
                t1 = self._clock.monotonic()
                self._obs_span("prefill", t_pf, t1, bucket=tb,
                               requests=[self._rid(e[0]) for e in run])
                for e in run:
                    self._obs_span("prefill", t_pf, t1, rid=e[0],
                                   lane=f"slot{e[1]}", fold=False)
            self._reads.append(("firsts", firsts, [e[0] for e in run]))
        if not self._slot_req:
            if self._flight is not None:
                self._flight.record("admit_only", active=0,
                                    admitted=len(adm),
                                    retired=len(finished),
                                    faults=self._step_faults)
            return finished
        n_active = len(self._slot_req)
        self._dispatch_no += 1
        t_dec = self._clock.monotonic()
        self._rope_pos, self._last, toks = _decode_chunk_fn(
            self.model, self.cfg, self.chunk, self._k, self._v, self._ks,
            self._vs, self._bitmap, self._cursor, self._rope_pos, self._last,
            self._active(self._slot_req), self._angles,
            (self.seed, 0, self._dispatch_no), self.temperature, self.top_k)
        self._cursor += self.chunk
        takes: list = []                             # (req id, slot, n)
        for slot, req_id in list(self._slot_req.items()):
            take = min(self._budget[req_id], self.chunk)
            takes.append((req_id, slot, take))
            self._budget[req_id] -= take
            if self._budget[req_id] <= 0:
                finished.append(req_id)
                del self._budget[req_id]
                del self._slot_req[slot]             # slot free now
                if self._tracer is not None:
                    now = self._clock.monotonic()
                    self._obs_span("reap", now, now, rid=req_id, slot=slot)
        self._reads.append(("chunk", toks, takes))
        self._record_decode(t_dec, n_active, len(adm), takes, finished,
                            cursor=self._cursor)
        return finished

    def _record_decode(self, t_dec: float, n_active: int, admitted: int,
                       takes: list, finished: list, **fields) -> None:
        """A decode dispatch's ``decode_chunk`` spans (the engine lane and
        one per slot) and its ``decode`` flight record, from host state
        only (``n_active`` counts the slots the dispatch ran)."""
        if self._tracer is not None:
            t1 = self._clock.monotonic()
            self._obs_span("decode_chunk", t_dec, t1, active=n_active,
                           chunk=self.chunk)
            for req_id, slot, take in takes:
                self._obs_span("decode_chunk", t_dec, t1, rid=req_id,
                               lane=f"slot{slot}", fold=False, tokens=take)
        if self._flight is not None:
            self._flight.record(
                "decode",
                wall_ms=round((self._clock.monotonic() - t_dec) * 1e3, 3),
                active=n_active, admitted=admitted,
                tokens=sum(t for _, _, t in takes),
                retired=len(finished), **fields,
                faults=self._step_faults)

    def _active(self, ready: dict) -> torch.Tensor:
        return torch.as_tensor([s in ready for s in range(self.n_slots)],
                               device=self.device)

    def _decode_step(self, ready: dict, finished: list) -> list:
        """One decode chunk over ``ready`` {slot: req id}; its tokens are
        read back later (``_flush``). Appends the requests it finishes to
        ``finished`` (this step's so far) and returns it."""
        self._dispatch_no += 1
        t_dec = self._clock.monotonic()
        self._lens, self._last, toks = _decode_chunk_paged_fn(
            self.model, self.cfg, self.chunk, self.page_size, self._k,
            self._v, self._ks, self._vs, self._device_table(), self._lens,
            self._last, self._active(ready), self._angles,
            (self.seed, 0, self._dispatch_no), self.temperature, self.top_k)
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
                t_rp = self._clock.monotonic()
                # This chunk's tokens are not flushed yet: only the
                # flushed prefix donates (the conservative bound).
                self._free_slot_pages(slot, self._donatable_decoded(req_id))
                if self._tracer is not None:
                    self._obs_span("reap", t_rp, self._clock.monotonic(),
                                   rid=req_id, slot=slot)
        self._reads.append(("chunk", toks, takes))
        self._record_decode(t_dec, len(ready), self._step_admitted, takes,
                            finished, pool_free=self._alloc.free_count,
                            pool_in_use=self._alloc.in_use)
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

    def _verify_step(self, ready: dict, finished: list) -> list:
        """Propose for every ready slot, then one verify dispatch; each
        slot commits 1..gamma+1 tokens. The next proposals depend on this
        step's tokens, so the step reads them back at once — after
        flushing the pending prefill firsts the proposers read. Appends
        the requests it finishes to ``finished`` and returns it."""
        self._flush()
        self._dispatch_no += 1
        props = np.zeros((self.n_slots, self.gamma), np.int32)
        views = []
        for slot, rid in ready.items():
            # A proposal that fails fails only its own request; Preempted
            # is the whole engine's drain signal and passes through.
            try:
                if self._faults is not None:
                    self._faults.fire("serve.propose")
                view = SlotView(slot, rid, self._slot_prompt[slot],
                                self._out[rid])
                if self._proposer.batched:
                    views.append(view)
                else:
                    props[slot] = self._proposer.propose(view, self.gamma)
            except Preempted:
                raise
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
            return finished
        eff = np.zeros((self.n_slots,), np.int32)
        for slot, rid in ready.items():
            eff[slot] = self._spec_eff_window(rid)
        dev = self.device
        t_ver = self._clock.monotonic()
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
        t_ver1 = self._clock.monotonic()
        step_used = step_emitted = step_eff = 0
        for slot, rid in ready.items():
            take = min(self._budget[rid], int(accepts[slot]) + 1)
            self._out[rid].extend(int(tk) for tk in toks[slot, :take])
            # The gauges count what the stream kept: proposals accepted
            # past the budget are rewound like any rejection.
            used = take - 1
            eff_i = int(eff[slot])
            step_used += used
            step_emitted += take
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
            with self._obs_mu:
                self._spec_slot_steps += 1
                self._spec_proposed += eff_i
                self._spec_accepted += used
                self._spec_emitted += take
                self._spec_rewound += self.gamma - used
            if self._tracer is not None:
                self._obs_span("verify", t_ver, t_ver1, rid=rid,
                               lane=f"slot{slot}", fold=False,
                               accepted=used, tokens=take)
                if self.gamma - used:
                    # The rewind is a host-side lens clamp: an instant.
                    self._obs_span("rewind", t_ver1, t_ver1, rid=rid,
                                   lane=f"slot{slot}",
                                   rewound=self.gamma - used)
            self._budget[rid] -= take
            if self._budget[rid] <= 0:
                finished.append(rid)
                del self._budget[rid]
                del self._slot_req[slot]
                self._drop_spec(slot, rid)
                t_rp = self._clock.monotonic()
                # The commits are in _out already: the donation sees the
                # whole stream.
                self._free_slot_pages(slot, self._donatable_decoded(rid))
                if self._tracer is not None:
                    self._obs_span("reap", t_rp, self._clock.monotonic(),
                                   rid=rid, slot=slot)
        with self._obs_mu:
            if step_eff:
                self._spec_accept_buf.append(step_used / step_eff)
        if self._tracer is not None:
            self._obs_span("verify", t_ver, t_ver1, active=len(ready),
                           gamma=self.gamma)
        if self._flight is not None:
            self._flight.record(
                "verify", wall_ms=round((t_ver1 - t_ver) * 1e3, 3),
                active=len(ready), admitted=self._step_admitted,
                tokens=step_emitted,
                accept_rate=(round(step_used / step_eff, 4)
                             if step_eff else 0.0),
                retired=len(finished), pool_free=self._alloc.free_count,
                pool_in_use=self._alloc.in_use, faults=self._step_faults)
        return finished

    def _flush(self) -> None:
        """Read every outstanding result tensor and replay them, in
        dispatch order, into ``self._out``."""
        if not self._reads:
            return
        vals = [arr.cpu().numpy() for _, arr, _ in self._reads]
        now = self._clock.monotonic()
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
            now = self._clock.monotonic()
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
        the last call (drained here); the pool's and the weights' device
        bytes (constants of the build), the age of the last step's start
        while work is pending (else 0.0), and the per-admission prefix hit
        lengths since the last call (``prefix_hit_token_batch``, drained
        here); the last drain's and restore's seconds and the requests
        resumed; on a tiered engine the tier's gauges and the promoted hit
        lengths since the last call (``promoted_hit_token_batch``, drained
        here); with a tracer, the ``(phase, seconds)`` spans since the last
        call (``phase_durations``, drained here). What the step loop
        writes is read in one ``_obs_mu`` snapshot, so a scrape thread
        never pairs one step's counters with another's age or batches.
        The contiguous layout has no pool: {}."""
        if self.layout != "paged":
            return {}
        out: Dict[str, object] = self._alloc.metrics()
        out["drain_duration_seconds"] = self._drain_s or 0.0
        out["restore_duration_seconds"] = self._restore_s or 0.0
        out["requests_resumed_total"] = float(self._resumed)
        out["requests_shed_total"] = float(self._shed_total)
        if self._prefix is not None:
            out.update(self._prefix.metrics())
            out["prefill_tokens_skipped"] = float(self._skipped_tokens)
        out["prefill_backlog_tokens"] = float(self._prefill_backlog())
        out["prefill_chunks_total"] = float(self._prefill_chunks_total)
        out["request_errors_total"] = float(self._request_errors)
        out["kv_pool_device_bytes"] = float(self._kv_pool_dev_bytes)
        out["weight_device_bytes"] = float(self._weight_dev_bytes)
        with self._obs_mu:
            out["last_step_age_seconds"] = (
                max(0.0, self._clock.monotonic() - self._last_step_t)
                if self.pending else 0.0)
            if self.spec:
                out["spec_accept_rate"] = (
                    self._spec_accepted / self._spec_proposed
                    if self._spec_proposed else 0.0)
                out["spec_tokens_per_dispatch"] = (
                    self._spec_emitted / self._spec_slot_steps
                    if self._spec_slot_steps else 0.0)
                out["spec_rewound_tokens_total"] = float(self._spec_rewound)
                out["spec_proposer"] = self._proposer.name
                effs = ([self._spec_eff_last[r]
                         for r in self._slot_req.values()
                         if r in self._spec_eff_last]
                        if self.spec_adaptive else [])
                if not effs:
                    effs = [self.gamma if not self.spec_adaptive
                            else self._spec_overshoot()]
                out["spec_gamma_agg"] = {
                    "min": float(min(effs)),
                    "mean": float(sum(effs) / len(effs)),
                    "max": float(max(effs))}
                if self._spec_accept_buf:
                    out["spec_accept_batch"] = tuple(self._spec_accept_buf)
                    self._spec_accept_buf.clear()
            if self._phase_buf:
                out["phase_durations"] = tuple(self._phase_buf)
                self._phase_buf.clear()
            if self._hit_tok_buf:
                out["prefix_hit_token_batch"] = tuple(self._hit_tok_buf)
                self._hit_tok_buf.clear()
            if self._promoted_hit_buf:
                out["promoted_hit_token_batch"] = \
                    tuple(self._promoted_hit_buf)
                self._promoted_hit_buf.clear()
        return out

    # -- lifecycle: drain / restore / absorb -------------------------------
    def fingerprint(self) -> Dict[str, object]:
        """The engine-compat contract a snapshot carries, key for key the
        JAX engine's: what must match for restored page bytes to be
        addressed and decoded the same (layout, page geometry, dtypes,
        model dims) and the knobs the slot state's page reservations
        assume (chunk, speculative, gamma). ``n_pages`` is recorded but
        exempt from the check (pages are re-laid out through the
        allocator); tiering, chunked prefill, donation and the weights
        are not recorded: none changes how a restored page decodes."""
        cfg = self.cfg
        paged = self.layout == "paged"
        fp: Dict[str, object] = {
            "layout": self.layout,
            "kv_dtype": self.kv_dtype,
            "dtype": str(cfg.dtype).replace("torch.", ""),
            "decode_attn": cfg.decode_attn,
            "n_layers": cfg.n_layers,
            "n_kv_heads": cfg.n_kv_heads,
            "n_heads": cfg.n_heads,
            "head_dim": cfg.head_dim,
            "vocab": cfg.vocab,
            "n_slots": self.n_slots,
            "chunk": self.chunk,
            "bucket": self.bucket,
            "capacity": self.S,
            "eos_id": self.eos_id,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "speculative": self.spec,
            "gamma": self.gamma if self.spec else None,
            "prefix_cache": paged and self._prefix is not None,
        }
        if paged:
            fp["page_size"] = self.page_size
            fp["n_pages"] = self._alloc.n_pages
        return fp

    def _planes(self) -> list:
        """The pool's planes: k, v and, int8, the two scale planes."""
        return [t for t in (self._k, self._v, self._ks, self._vs)
                if t is not None]

    def _gather_pages(self, pages) -> list:
        """Host copies ``[L, len(pages), ps, Hkv, x]`` of pool ``pages`` in
        every plane: one ``index_select`` a plane into one flat device
        buffer, then one device-to-host copy (into pinned memory on a
        card). bf16 planes come back as their 16-bit words
        (``np.uint16``)."""
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=self.device)
        picked = [t.index_select(1, idx) for t in self._planes()]
        dev = torch.cat([t.reshape(-1).view(torch.uint8) for t in picked])
        host = torch.empty(dev.numel(), dtype=torch.uint8,
                           pin_memory=dev.is_cuda)
        flat = host.copy_(dev).numpy()
        out, off = [], 0
        for t in picked:
            n = t.numel() * t.element_size()
            out.append(flat[off:off + n].view(_host_dtype(t.dtype))
                       .reshape(tuple(t.shape)))
            off += n
        return out

    def _scatter_pages(self, pages, k, v, ks=None, vs=None) -> None:
        """Land host page bytes ``[L, len(pages), ps, Hkv, x]`` (+ int8
        scale planes) in pool ``pages``: the one copy path of restore,
        absorb and tier promotion. Every plane's bytes go through one
        staging tensor (pinned on a card) in one non-blocking
        host-to-device copy, then one ``index_copy_`` a plane. bf16
        planes take 16-bit words (or an array whose dtype is named
        bfloat16)."""
        if self._ks is not None and ks is None:
            raise SnapshotError(
                "int8-KV engine but the shipped pages carry no scale planes")
        planes = self._planes()
        host = []
        for t, a in zip(planes, (k, v, ks, vs)):
            a = np.ascontiguousarray(as_words(np.asarray(a)))
            want = (t.shape[0], len(pages)) + tuple(t.shape[2:])
            if a.shape != want or a.dtype.itemsize != t.element_size():
                raise SnapshotError(
                    f"page payload {a.dtype} {a.shape} does not fit the "
                    f"{t.dtype} pool's {want}")
            host.append(a)
        staging = torch.empty(sum(a.nbytes for a in host), dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
        buf, off = staging.numpy(), 0
        for a in host:
            buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
            off += a.nbytes
        dev = staging.to(self.device, non_blocking=True)
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=self.device)
        off = 0
        for t, a in zip(planes, host):
            t.index_copy_(1, idx,
                          dev[off:off + a.nbytes].view(t.dtype).view(a.shape))
            off += a.nbytes

    def _drain_demotions(self) -> None:
        """Resolve the pending demotions at a step boundary: one batched
        gather of their pages (``_gather_pages``), committed into the host
        tier page by page; each pool page then returns to the free list.
        A commit the tier refuses (full, nothing evictable) forgets the
        node instead: demote-before-forget never blocks admission."""
        if self._tier is None:
            return
        pend = self._tier.take_pending()
        if not pend:
            return
        t0 = self._clock.monotonic()
        planes = self._gather_pages([p for _, p in pend])
        for i, (key, page) in enumerate(pend):
            payload = tuple(np.ascontiguousarray(a[:, i]) for a in planes)
            if len(payload) == 2:                # no int8 scale planes
                payload += (None, None)
            if not self._tier.commit(key, payload):
                self._prefix.drop_demoted(key)
            self._alloc.drop_cached(page)
        if self._tracer is not None:
            self._obs_span("demote", t0, self._clock.monotonic(),
                           pages=len(pend))

    def _apply_page_pressure(self, rules) -> None:
        """Apply the ``page_pressure`` rules the step hook returned: hold
        the largest requested count of pages out of the allocator (as many
        as are free: pressure takes what is there), and release hostages
        no rule wants any more."""
        if self.layout != "paged":
            return
        want = max((r.pages for r in rules), default=0)
        held = len(self._chaos_pages)
        if want > held:
            take = min(want - held, self._alloc.free_count)
            if take:
                got = self._alloc.alloc(take, count_denied=False)
                if got:
                    self._chaos_pages.extend(got)
        elif want < held:
            release = self._chaos_pages[want:]
            del self._chaos_pages[want:]
            self._alloc.free(release)

    @torch.no_grad()
    def drain(self, slots=None) -> ServingSnapshot:
        """Stop admission and serialise the in-flight state machine to the
        host (a preemption's first half; ``restore`` on a fresh engine is
        the second). Deferred reads are flushed, pending demotions
        resolved, page-pressure hostages freed, and every referenced pool
        page (live slots' own and mounted pages, prefix-tree pages) is
        gathered once, with the block tables, ``lens``, slot bindings,
        budgets, emitted streams, the queue, the tree as token paths and
        the host tier coldest first. Speculative proposals are not kept:
        they are recomputed after restore. The engine refuses further
        work afterwards.

        ``slots`` drains only those active slots (load shedding): the
        snapshot is ``partial`` (no queue, tree or tier), goes to
        ``absorb()`` on another engine, and this engine keeps serving;
        the shed slots retire through the reap path, their pages donated
        into the local tree."""
        if self.layout != "paged":
            raise SnapshotError(
                "drain() requires kv_layout='paged' (the snapshot format "
                "is pool pages + block tables)")
        if self._drained:
            raise RuntimeError("engine already drained")
        partial = slots is not None
        if partial:
            slots = sorted(int(s) for s in slots)
            if not slots:
                raise ValueError("partial drain needs at least one slot")
            missing = [s for s in slots if s not in self._slot_req]
            if missing:
                raise ValueError(
                    f"cannot shed inactive slot(s) {missing}: only active "
                    f"slots carry migratable requests")
        t0 = self._clock.monotonic()
        self._flush()
        # dump_paths names demoted chunks by tier key, so every pending
        # demotion commits before the tree is walked.
        self._drain_demotions()
        if not partial and self._chaos_pages:  # hostages are not state
            self._alloc.free(self._chaos_pages)
            self._chaos_pages = []
        ids: list = []
        seen: set = set()

        def add(pages):
            for p in pages:
                p = int(p)
                # A negative entry is a demoted chunk, -(tier key + 1):
                # its bytes ride the tier sidecar.
                if p > 0 and p not in seen:
                    seen.add(p)
                    ids.append(p)

        shed = slots if partial else sorted(self._slot_req)
        for slot in shed:
            add(self._slot_shared.get(slot, ()))
            add(self._slot_pages.get(slot, ()))
        tree_paths = (self._prefix.dump_paths()
                      if self._prefix is not None and not partial else [])
        for _, pages in tree_paths:
            add(pages)
        tier_entries = (self._tier.items_coldest_first()
                        if self._tier is not None and not partial else [])
        tier = [None] * 4
        if tier_entries:
            tier = [None if tier_entries[0][1][i] is None
                    else np.stack([p[i] for _, p in tier_entries], axis=1)
                    for i in range(4)]
        if ids:
            planes = self._gather_pages(ids)
        else:
            cfg = self.cfg
            empty = (cfg.n_layers, 0, self.page_size, cfg.n_kv_heads,
                     cfg.head_dim)
            planes = [np.zeros(empty, _host_dtype(self._k.dtype))] * 2
            if self._ks is not None:
                planes += [np.zeros(empty[:-1] + (1,), np.float32)] * 2
        lens = self._lens.cpu().numpy().astype(np.int32)
        last = self._last.cpu().numpy().astype(np.int32)
        if self._flight is not None and not partial:
            # Recorded before the ring is shipped, so the drain marker
            # rides the snapshot: a restored ring reads ... decode,
            # drain, restore ... across the process boundary.
            self._flight.record(
                "drain", pages=len(ids), in_flight=len(self._slot_req),
                queued=len(self._queue),
                wall_ms=round((self._clock.monotonic() - t0) * 1e3, 3))
        shed_set = set(shed)
        shed_rids = ({int(self._slot_req[s]) for s in shed_set}
                     if partial else None)
        if partial:
            # Rows of slots that stay must not ride: their pages do not.
            table = np.full_like(self._table_np, NULL_PAGE)
            table[shed] = self._table_np[shed]
        else:
            table = self._table_np.copy()

        def keep_slot(s):
            return not partial or int(s) in shed_set

        def keep_rid(r):
            return not partial or int(r) in shed_rids

        # A mid-prefill slot's device lens is not authoritative; the host
        # chunk scheduler is. lens = prefill_done is also how restore and
        # absorb re-queue its unprefilled tail.
        for s, d in self._prefill_pending.items():
            if keep_slot(s):
                lens[s] = d
        snap = ServingSnapshot(
            fingerprint=self.fingerprint(),
            page_ids=ids,
            k_pages=planes[0],
            v_pages=planes[1],
            k_scales=planes[2] if self._ks is not None else None,
            v_scales=planes[3] if self._ks is not None else None,
            table=table,
            lens=lens,
            last=last,
            slot_req={int(s): int(r) for s, r in self._slot_req.items()
                      if keep_slot(s)},
            slot_pages={int(s): [int(p) for p in pg]
                        for s, pg in self._slot_pages.items()
                        if keep_slot(s)},
            slot_shared={int(s): [int(p) for p in pg]
                         for s, pg in self._slot_shared.items()
                         if keep_slot(s)},
            slot_prompt={int(s): [int(t) for t in pr]
                         for s, pr in self._slot_prompt.items()
                         if keep_slot(s)},
            budgets={int(r): int(b) for r, b in self._budget.items()
                     if keep_rid(r)},
            out={int(r): [int(t) for t in ts]
                 for r, ts in self._out.items() if keep_rid(r)},
            queue=[] if partial else [(int(r), [int(t) for t in pr])
                                     for r, pr in self._queue],
            next_id=0 if partial else self._next_id,
            eos_scanned={int(r): int(n)
                         for r, n in self._eos_scanned.items()
                         if keep_rid(r)},
            tree_paths=tree_paths,
            tier_keys=[int(key) for key, _ in tier_entries],
            tier_k=tier[0], tier_v=tier[1], tier_ks=tier[2],
            tier_vs=tier[3],
            arrival={r: t for r, t in self._arrival.items() if keep_rid(r)},
            first_tok={r: t for r, t in self._first_tok.items()
                       if keep_rid(r)},
            drained_mono=self._clock.monotonic(),
            drained_wall=self._clock.wall(),
            skipped_tokens=0 if partial else self._skipped_tokens,
            flight=([] if partial or self._flight is None
                    else self._flight.to_payload()),
            partial=partial,
            spec_ema=({int(r): float(v) for r, v in self._spec_ema.items()
                       if keep_rid(r)} if self.spec else {}),
            spec_eff=({int(r): int(v)
                       for r, v in self._spec_eff_last.items()
                       if keep_rid(r)} if self.spec else {}),
            spec_reserve=({int(r): int(v)
                           for r, v in self._spec_reserve.items()
                           if keep_rid(r)} if self.spec else {}),
            spec_fleet_ema=(float(self._spec_fleet_ema)
                            if self.spec else 1.0),
        )
        snap.validate()
        if partial:
            # The shed slots leave through the reap path: their
            # transcript-so-far donates into the local tree, the rest
            # frees now; the requests continue on the absorbing engine.
            self._shed_total += len(shed)
            for slot in shed:
                rid = self._slot_req.pop(slot)
                decoded = self._donatable_decoded(rid)
                for book in (self._budget, self._out, self._eos_scanned,
                             self._arrival, self._first_tok):
                    book.pop(rid, None)
                self._drop_spec(slot, rid)
                self._free_slot_pages(slot, decoded)
            if self._flight is not None:
                self._flight.record(
                    "shed", slots=len(shed), pages=len(ids),
                    requests=len(snap.slot_req),
                    pool_free=self._alloc.free_count,
                    wall_ms=round((self._clock.monotonic() - t0) * 1e3, 3))
            if self._tracer is not None:
                self._obs_span("shed", t0, self._clock.monotonic(),
                               slots=len(shed), pages=len(ids))
            return snap
        self._drained = True
        self._drain_s = self._clock.monotonic() - t0
        if self._tracer is not None:
            self._obs_span("drain", t0, self._clock.monotonic(),
                           pages=len(ids))
        return snap

    @torch.no_grad()
    def restore(self, snap: ServingSnapshot) -> int:
        """Fill this fresh engine from a whole drained snapshot and resume
        every interrupted stream as an uninterrupted run would. The pages
        are re-laid out through this engine's allocator (any ``n_pages``
        they fit in) and every block table, slot page list and tree path
        is remapped; refcounts are rebuilt so ``assert_consistent`` holds
        (and is asserted). The host tier's hottest entries that fit
        ``dram_pages`` are kept (none on an untiered engine), and tree
        paths stop at a dropped one. Clocks are rebased so latency
        records charge the downtime. Sampled streams stay valid samples,
        not the same ones: dispatch seeds restart. Returns the number of
        resumed requests (in flight and queued)."""
        if self.layout != "paged":
            raise SnapshotError("restore() requires kv_layout='paged'")
        if self._drained:
            raise RuntimeError(
                "cannot restore into a drained engine — build a fresh one")
        if (self._slot_req or self._queue or self._next_id
                or self._reads or self._alloc.in_use):
            raise SnapshotError(
                "restore() needs a FRESH engine (no admitted slots, no "
                "queue, no allocated pages)")
        if snap.partial:
            raise SnapshotError(
                "partial snapshot (a shed slot subset): absorb() it into "
                "a running replica; restore() rebuilds a whole engine")
        check_fingerprint(snap.fingerprint, self.fingerprint())
        snap.validate()
        t0 = self._clock.monotonic()
        lut = self._upload_snapshot_pages(snap)
        table = np.asarray(snap.table, np.int64)
        if table.shape != self._table_np.shape:
            raise SnapshotError(
                f"block table shape {table.shape} != "
                f"{self._table_np.shape}")
        if table.max(initial=0) >= len(lut) or (lut[table] < 0).any():
            raise SnapshotError(
                "block table references pages the snapshot did not ship")
        self._table_np = lut[table].astype(np.int32)
        self._table_dirty = True
        self._lens = torch.as_tensor(np.array(snap.lens, np.int32),
                                     device=self.device)
        self._last = torch.as_tensor(np.array(snap.last, np.int32),
                                     device=self.device)

        def remap(pages):
            return [int(lut[p]) for p in pages]

        if snap.tree_paths and self._prefix is None:
            raise SnapshotError(
                "snapshot carries a prefix tree but prefix_cache=False")
        # Tier entries ship coldest first: keep the hottest tail that
        # fits; an untiered engine drops them all.
        keymap: Dict[int, int] = {}
        if snap.tier_keys and self._tier is not None:
            lo = max(0, len(snap.tier_keys) - self._tier.dram_pages)
            for i in range(lo, len(snap.tier_keys)):
                payload = tuple(
                    None if a is None else np.ascontiguousarray(a[:, i])
                    for a in (snap.tier_k, snap.tier_v, snap.tier_ks,
                              snap.tier_vs))
                nk = self._tier.restore_entry(payload)
                if nk is not None:
                    keymap[int(snap.tier_keys[i])] = nk
        for tokens, pages in snap.tree_paths:
            mapped: list = []
            for p in pages:
                p = int(p)
                if p >= 0:
                    mapped.append(int(lut[p]))
                    continue
                nk = keymap.get(-p - 1)
                if nk is None:               # dropped tier entry: truncate
                    break
                mapped.append(-(nk + 1))
            if mapped:
                self._prefix.insert(
                    list(tokens)[:len(mapped) * self.page_size], mapped)
        self._slot_req = dict(snap.slot_req)
        self._slot_pages = {s: remap(pg) for s, pg in snap.slot_pages.items()}
        self._slot_shared = {s: remap(pg)
                             for s, pg in snap.slot_shared.items()}
        for pg in self._slot_shared.values():
            if pg:
                self._alloc.retain(pg)
        self._slot_prompt = {s: list(pr) for s, pr in snap.slot_prompt.items()}
        self._budget = dict(snap.budgets)
        self._out = {r: list(ts) for r, ts in snap.out.items()}
        self._queue = [(r, list(pr)) for r, pr in snap.queue]
        self._next_id = snap.next_id
        self._eos_scanned = dict(snap.eos_scanned)
        self._skipped_tokens = snap.skipped_tokens
        if self.spec:
            # The pinned reservations are load-bearing: the restored
            # effective windows must keep to the pages admitted for.
            self._spec_ema = dict(snap.spec_ema)
            self._spec_eff_last = dict(snap.spec_eff)
            self._spec_reserve = dict(snap.spec_reserve)
            self._spec_fleet_ema = float(snap.spec_fleet_ema)
        # Slots drained mid-prefill (lens < prompt length) re-queue their
        # unprefilled tail, oldest request first.
        lens = np.asarray(snap.lens)
        for s in sorted(self._slot_req, key=lambda s: self._slot_req[s]):
            pr = self._slot_prompt.get(s)
            if pr is not None and int(lens[s]) < len(pr):
                self._prefill_pending[s] = int(lens[s])
        now_m, now_w = self._clock.monotonic(), self._clock.wall()
        self._arrival = snap.rebased_clock(snap.arrival, now_m, now_w)
        self._first_tok = snap.rebased_clock(snap.first_tok, now_m, now_w)
        self._alloc.assert_consistent()
        self._resumed = snap.n_requests_in_flight
        self._restore_s = self._clock.monotonic() - t0
        if self._flight is not None:
            # The drained engine's ring (this package's or the JAX one's)
            # carries on here, its seq continued; this record marks the
            # seam.
            self._flight.seed(snap.flight)
            self._flight.record(
                "restore", resumed=self._resumed,
                pages=len(snap.page_ids),
                downtime_s=round(max(0.0, now_w - snap.drained_wall), 3),
                wall_ms=round(self._restore_s * 1e3, 3))
        if self._tracer is not None:
            self._obs_span("restore", t0, self._clock.monotonic(),
                           resumed=self._resumed)
        return self._resumed

    def _upload_snapshot_pages(self, snap: ServingSnapshot) -> np.ndarray:
        """Restore's and absorb's page move: fresh pages for the shipped
        ids (evicting tree-only pages on a shortage), the bytes scattered
        in (``_scatter_pages``); returns the old→new id table (-1 for an
        unshipped id, the null page onto itself)."""
        need = len(snap.page_ids)
        if self._prefix is not None and need > self._alloc.free_count:
            self._prefix.evict(need - self._alloc.free_count)
            self._drain_demotions()
        new = self._alloc.alloc(need)
        if new is None:
            raise SnapshotError(
                f"snapshot references {need} pages but the pool has "
                f"only {self._alloc.free_count} free")
        lut = np.full(max(snap.page_ids, default=0) + 1, -1, np.int64)
        lut[NULL_PAGE] = NULL_PAGE
        for old, nw in zip(snap.page_ids, new):
            lut[old] = nw
        if new:
            self._scatter_pages(new, snap.k_pages, snap.v_pages,
                                snap.k_scales, snap.v_scales)
        return lut

    @torch.no_grad()
    def absorb(self, snap: ServingSnapshot) -> Dict[int, int]:
        """Merge a partial snapshot (``drain(slots=...)`` on another
        engine) into this running engine. Each shed slot takes a free
        local slot and its request a fresh local id; returns
        ``{old id: new id}``. Pages the source had mounted read-only
        arrive slot-owned (a page two shed slots shared is allocated once
        and retained per extra holder), so ``assert_consistent`` holds on
        both engines; latency clocks rebase across the hop."""
        if self.layout != "paged":
            raise SnapshotError("absorb() requires kv_layout='paged'")
        if self._drained:
            raise RuntimeError("cannot absorb into a drained engine")
        if not snap.partial:
            raise SnapshotError(
                "absorb() takes a PARTIAL snapshot (drain(slots=...)); "
                "restore() a full snapshot into a fresh engine")
        if snap.tree_paths:
            raise SnapshotError(
                "partial snapshot must not carry a prefix tree")
        check_fingerprint(snap.fingerprint, self.fingerprint())
        snap.validate()
        free_slots = sorted(s for s in range(self.n_slots)
                            if s not in self._slot_req)
        if len(snap.slot_req) > len(free_slots):
            raise SnapshotError(
                f"snapshot carries {len(snap.slot_req)} slots but only "
                f"{len(free_slots)} are free here")
        t0 = self._clock.monotonic()
        need = len(snap.page_ids)
        lut = self._upload_snapshot_pages(snap)
        now_m, now_w = self._clock.monotonic(), self._clock.wall()
        arrival = snap.rebased_clock(snap.arrival, now_m, now_w)
        first = snap.rebased_clock(snap.first_tok, now_m, now_w)
        lens = self._lens.cpu().numpy().copy()
        last = self._last.cpu().numpy().copy()
        mapping: Dict[int, int] = {}
        claimed: set = set()
        # Source-id order: the chunk scheduler keeps charging the oldest
        # migrated request first.
        for src in sorted(snap.slot_req, key=lambda s: snap.slot_req[s]):
            rid = int(snap.slot_req[src])
            tgt = free_slots.pop(0)
            new_rid = self._next_id
            self._next_id += 1
            mapping[rid] = new_rid
            row = np.asarray(snap.table[src], np.int64)
            if row.max(initial=0) >= len(lut) or (lut[row] < 0).any():
                raise SnapshotError(
                    "block table references pages the snapshot did not "
                    "ship")
            self._table_np[tgt] = lut[row].astype(np.int32)
            pages = [int(lut[p])
                     for p in (list(snap.slot_shared.get(src, []))
                               + list(snap.slot_pages.get(src, [])))]
            for p in pages:
                if p in claimed:
                    self._alloc.retain([p])
                claimed.add(p)
            self._slot_req[tgt] = new_rid
            self._slot_pages[tgt] = pages
            self._slot_shared[tgt] = []
            self._slot_prompt[tgt] = [int(t) for t in snap.slot_prompt[src]]
            self._budget[new_rid] = int(snap.budgets[rid])
            self._out[new_rid] = [int(t) for t in snap.out.get(rid, [])]
            if rid in snap.eos_scanned:
                self._eos_scanned[new_rid] = int(snap.eos_scanned[rid])
            if rid in arrival:
                self._arrival[new_rid] = arrival[rid]
            if rid in first:
                self._first_tok[new_rid] = first[rid]
            if self.spec:
                if rid in snap.spec_ema:
                    self._spec_ema[new_rid] = float(snap.spec_ema[rid])
                if rid in snap.spec_eff:
                    self._spec_eff_last[new_rid] = int(snap.spec_eff[rid])
                if rid in snap.spec_reserve:
                    self._spec_reserve[new_rid] = int(snap.spec_reserve[rid])
            lens[tgt] = int(snap.lens[src])
            last[tgt] = int(snap.last[src])
            if lens[tgt] < len(self._slot_prompt[tgt]):
                self._prefill_pending[tgt] = int(lens[tgt])
        self._lens = torch.as_tensor(lens.astype(np.int32),
                                     device=self.device)
        self._last = torch.as_tensor(last.astype(np.int32),
                                     device=self.device)
        self._table_dirty = True
        self._alloc.assert_consistent()
        self._resumed += len(mapping)
        if self._flight is not None:
            self._flight.record(
                "absorb", resumed=len(mapping), pages=need,
                pool_free=self._alloc.free_count,
                wall_ms=round((self._clock.monotonic() - t0) * 1e3, 3))
        if self._tracer is not None:
            self._obs_span("absorb", t0, self._clock.monotonic(),
                           resumed=len(mapping), pages=need)
        return mapping

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
                t_rp = self._clock.monotonic()
                if self.layout == "paged":
                    self._free_slot_pages(slot,
                                          self._donatable_decoded(req_id))
                if self._tracer is not None:
                    self._obs_span("reap", t_rp, self._clock.monotonic(),
                                   rid=req_id, slot=slot, eos=True)
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
