"""Paged, prefix-cached continuous batching for the Llama decoder (port of
the JAX package's ``models/serving.py``, single-device paged path).

A request goes through four steps:

1. admission (``ContinuousBatcher._admit_paged``): free slot, free pages
   from ``PageAllocator``, and the longest cached page-aligned prefix from
   ``PrefixCache.match`` mounted read-only;
2. one batched paged prefill (``_prefill_multi_paged_fn``): the hb == 0
   rung runs the dense causal forward (``forward_with_cache``); the hb > 0
   rung prefills only the uncached tail through K2
   (``ops.paged_prefill_attention``);
3. decode chunks (``_decode_chunk_paged_fn``): ``chunk`` ticks, each one
   K1 launch (``ops.paged_decode_attention``) per layer;
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

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.decode_attention import (
    DEFAULT_PAGE_SIZE, paged_decode_attention, paged_plan,
    paged_prefill_attention,
)
from ..ops.layers import apply_rope, rms_norm, rope_freqs
from ..ops.quant import qdot
from .llama import Block, Llama, LlamaConfig, mlp_sublayer
from .paging import NULL_PAGE, PageAllocator
from .prefix_cache import PrefixCache

NEG_INF = -1e30
_MASK64 = (1 << 64) - 1


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


def _sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                   temperature: float, top_k: int) -> torch.Tensor:
    """Next token from [..., vocab] logits: argmax when temperature == 0,
    else temperature/top-k categorical sampling by the Gumbel-max trick
    with noise from ``generator`` (each row draws independently)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
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
    "speculative": (False, "the speculative-decoding slice (kernel K3)"),
    "kv_tiering": (False, "the lifecycle and tiering slice"),
    "prefill_chunk_tokens": (None, "the chunked-prefill slice"),
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
                 seed: int = 0, device="cuda", speculative: bool = False, kv_tiering: bool = False,
                 prefill_chunk_tokens: Optional[int] = None, mesh=None,
                 role: str = "mixed", fault_injector=None, tracer=None,
                 flight_capacity: int = 0):
        given = dict(kv_layout=kv_layout, speculative=speculative,
                     kv_tiering=kv_tiering,
                     prefill_chunk_tokens=prefill_chunk_tokens, mesh=mesh,
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

    def _rows_needed(self, budget: int) -> int:
        """Worst-case decode rows: remaining steps rounded up to chunks."""
        steps = max(0, budget - 1)                   # first token = prefill
        return -(-steps // self.chunk) * self.chunk

    def _pages_needed(self, prompt_len: int, budget: int) -> int:
        """Worst-case pages a request can touch, reserved in full at
        admission so a request in flight never waits for a page."""
        return -(-(prompt_len + self._rows_needed(budget)) // self.page_size)

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
        self._retire_pages(self._slot_pages.pop(slot),
                           self._slot_shared.pop(slot, []),
                           self._slot_prompt.pop(slot, None), decoded)
        self._table_np[slot] = NULL_PAGE
        self._table_dirty = True

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
            need = self._pages_needed(P, self._budget[req_id]) - len(hits)
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
            self._budget[req_id] -= 1                # first token = prefill
            if self._budget[req_id] <= 0:            # max_new == 1
                finished.append(req_id)
                del self._budget[req_id]
                free.append(slot)
                free_after.append((pages, hits, prompt))
            else:
                self._slot_req[slot] = req_id
                self._slot_pages[slot] = pages
                self._slot_shared[slot] = hits
                self._slot_prompt[slot] = prompt
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

    @torch.no_grad()
    def _step_lazy(self) -> list:
        """Admit, then dispatch one decode chunk over the occupied slots —
        without reading anything back. Returns the finished req ids."""
        finished = self._admit_paged()
        ready = dict(self._slot_req)
        if not ready:
            return finished
        active = torch.as_tensor(
            [s in ready for s in range(self.n_slots)], device=self.device)
        table = self._device_table()
        self._dispatch_no += 1
        self._lens, self._last, toks = _decode_chunk_paged_fn(
            self.model, self.cfg, self.chunk, self.page_size, self._k,
            self._v, self._ks, self._vs, table, self._lens, self._last,
            active, self._angles, (self.seed, 0, self._dispatch_no),
            self.temperature, self.top_k)
        takes: list = []                             # (req id, slot, n)
        for slot, req_id in list(ready.items()):
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

    def pool_metrics(self) -> Dict[str, float]:
        """Page-pool gauges plus, with the prefix cache on, the reuse
        counters and ``prefill_tokens_skipped``."""
        out = self._alloc.metrics()
        if self._prefix is not None:
            out.update(self._prefix.metrics())
            out["prefill_tokens_skipped"] = float(self._skipped_tokens)
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
