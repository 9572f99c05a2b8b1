"""Decode-time attention for the serving engines: four hand-written CUDA
kernels and their plain PyTorch versions.

- ``paged_decode_attention`` (K1) replaces the JAX package's Pallas
  ``paged_decode_attention`` (``k8s_gpu_scheduler_tpu/ops/
  decode_attention.py``): one query row per slot against a shared page
  pool ``[n_pages, ps, Hkv, hd]`` through a ``[B, n_blocks]`` block table,
  masked to ``col < lengths``, pages past the length skipped, int8 K/V
  dequantized with per-row f32 scales. The JAX package merged its split-K
  partials in XLA; the kernel merges them itself, across the thread-block
  cluster its splits form.
- ``paged_prefill_attention`` (K2) replaces the Pallas
  ``paged_prefill_attention``: the prefix-cache tail prefill — cached
  prefix pages through ``prefix_table`` (fully visible below
  ``hit_lens``) plus the tail's own K/V (causal), one online softmax.
- ``paged_verify_attention`` (K3) replaces the Pallas
  ``paged_verify_attention``: the speculative verify window, ``t`` query
  rows per slot with row i bounded by ``col < lengths + i + 1``, split
  over the live pages and merged in the kernel as K1 is; bf16 q runs on
  the tensor cores. A contiguous cache reaches it through
  ``contiguous_as_paged`` (a view and an ``arange`` table).
- ``flash_decode_attention`` (K4) replaces the Pallas
  ``flash_decode_attention``: one query row per slot against a
  contiguous cache ``[B, S, Hkv, hd]``, masked to ``col < lengths`` and
  an optional validity ``bitmap [B, S]`` (the shared-cursor engine's slot
  windows), any S, split over the live rows and merged in the kernel as
  K1 is.

bf16 q of K1, K3 and K4 runs on one tensor-core body (``ops/csrc/
decode_mma.cu``), which reads a page pool through the table or a
contiguous cache through its bitmap. Each wrapper runs its kernel on CUDA
tensors (``ops/csrc/paged_attention.cu``, ``paged_prefill_mma.cu``,
``decode_mma.cu`` and ``flash_decode.cu``, built at first use by
``ops/_build.py``) and its plain version on CPU tensors; any other
device raises, and a CUDA tensor never reaches the plain version.
``paged_decode_reference`` (= ``gather_paged_kv`` +
``dense_decode_reference``), ``dense_prefill_reference``,
``paged_verify_reference`` (= ``gather_paged_kv`` +
``dense_verify_reference``) and ``flash_decode_reference`` (=
``dense_decode_reference`` with fully masked rows zeroed, as the kernel
yields them) are those plain versions, ported op for op from the JAX
package's references. Each wrapper counts its kernel launches
(``.launches``) and each plain version its calls (``.calls``), and is one
leaf op of an op record on either route (``_leaf.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._leaf import leaf_op

DEFAULT_PAGE_SIZE = 64
NEG_INF = -1e30

# The kernels' contract (ops/csrc/paged_attention.cu).
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)          # g = n_heads / n_kv_heads
# K3's stacked query rows a block: 64 on the tensor cores (bf16, kVfQ),
# 32 on the CUDA cores (f32, kQRows).
VERIFY_Q_ROWS = {torch.bfloat16: 64, torch.float32: 32}
# The most splits of one (slot, kv head) for K1, K3 and K4: the splits are
# the blocks of one thread-block cluster, at most the portable 8
# (kMaxSplits).
MAX_SPLITS = 8
_SM_COUNT_H100 = 132


def paged_plan(n_blocks: int, page_size: int, batch: int = 1,
               n_kv: int = 1) -> Optional[int]:
    """K1's split count on the card for a ``[batch, n_blocks]`` block
    table over an ``n_kv``-head pool, or None when the shape is not
    pageable (page sizes are powers of two from 8 to 256; at least one
    block). The JAX package's rule fits the TPU's sequential grid; on the
    card the splits are there to fill the SMs: enough (slot x kv head x
    split) blocks for about two per SM, never more splits than pages nor
    than ``MAX_SPLITS`` (one cluster). The kernel divides each slot's live
    pages, not the table, among them."""
    if page_size < 8 or page_size > 256 or page_size & (page_size - 1):
        return None
    if n_blocks < 1:
        return None
    want = -(-2 * _SM_COUNT_H100 // max(1, batch * n_kv))
    return max(1, min(n_blocks, want, MAX_SPLITS))


def decode_plan(s: int, block_k: Optional[int] = None,
                n_splits: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """The JAX package's blocking of a contiguous cache of S rows, kept
    letter for letter: legal (block_k, n_splits), or None when no
    power-of-two block from 256 down to 8 divides S. K4 takes any S and
    does not read it; ``block_k`` is the page size under which the
    verify route views a contiguous cache as a page pool
    (``contiguous_as_paged``)."""
    if block_k is None:
        for cand in (256, 128, 64, 32, 16, 8):
            if s % cand == 0:
                block_k = cand
                break
        else:
            return None
    elif s % block_k:
        return None
    n_blocks = s // block_k
    if n_splits is None:
        n_splits = 1
        if n_blocks >= 8:
            for cand in (8, 4, 2):
                if n_blocks % cand == 0:
                    n_splits = cand
                    break
    elif n_blocks % n_splits:
        return None
    return block_k, n_splits


# Rows of one K4 chunk (the tensor-core body's, kChunkRows; the f32 body's
# loop step at hd 64): a split narrower than this leaves lanes idle.
_FLASH_DECODE_SPLIT_ROWS = 64


def flash_decode_plan(live_rows: int, batch: int = 1, n_kv: int = 1) -> int:
    """K4's split count on the card for at most ``live_rows`` attendable
    rows per slot: enough (slot x kv head x split) blocks for about two
    per SM, as ``paged_plan`` fills them, never a split narrower than one
    64-row chunk nor more than ``MAX_SPLITS`` (one cluster). The kernel
    divides each slot's own live rows (``< lengths[b]``), not S, among the
    splits."""
    want = -(-2 * _SM_COUNT_H100 // max(1, batch * n_kv))
    most = -(-max(1, live_rows) // _FLASH_DECODE_SPLIT_ROWS)
    return max(1, min(most, want, MAX_SPLITS))


def contiguous_as_paged(cache: torch.Tensor, block_k: int):
    """View a contiguous cache [B, S, ...] as a page pool and a block
    table without moving data: block j of batch row b is page
    b*(S/block_k) + j, so the pool is a reshape (a view) and the table an
    ``arange``. Lets K3 serve the contiguous path (the 1 + gamma window of
    ``generate_speculative``)."""
    b, s = cache.shape[:2]
    nb = s // block_k
    pool = cache.reshape(b * nb, block_k, *cache.shape[2:])
    table = torch.arange(b * nb, dtype=torch.int32,
                         device=cache.device).reshape(b, nb)
    return pool, table


# -- plain versions -------------------------------------------------------------

def gather_paged_kv(pages: torch.Tensor,
                    block_table: torch.Tensor) -> torch.Tensor:
    """pages [n_pages, ps, ...] gathered through block_table [B, n_blocks]
    → [B, n_blocks*ps, ...]: the sequence-contiguous view."""
    g = pages[block_table.long()]                   # [B, n_blocks, ps, ...]
    b, n_blocks, ps = g.shape[:3]
    return g.reshape(b, n_blocks * ps, *pages.shape[2:])


def _mask_from(lengths, bitmap, s: int, device) -> Optional[torch.Tensor]:
    """[B or 1, S] bool: rows < ``lengths`` (scalar or [B]) AND set in
    ``bitmap`` [B, S]; None when neither is given."""
    mask = None
    if lengths is not None:
        cols = torch.arange(s, device=device)[None, :]
        if isinstance(lengths, int):     # no host-to-device copy
            mask = cols < lengths
        else:
            mask = cols < torch.as_tensor(
                lengths, dtype=torch.int32, device=device).reshape(-1, 1)
    if bitmap is not None:
        mask = bitmap if mask is None else mask & bitmap
    return mask


def dense_decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths=None, k_scale=None, v_scale=None,
                           bitmap=None) -> torch.Tensor:
    """Grouped-einsum decode attention: q [B, H, hd] against the cache
    [B, S, Hkv, hd] → [B, H, hd]. int8-KV (``k_scale``/``v_scale``
    [B, S, Hkv, 1]) factors the per-row scales onto the scores and the
    probabilities. ``lengths`` keeps rows < length, ``bitmap`` [B, S] bool
    keeps set rows; both given = AND. A fully masked row softmaxes
    uniform (garbage by contract)."""
    b, n_heads, hd = q.shape
    s, h_kv = k.shape[1], k.shape[2]
    if n_heads % h_kv:
        raise ValueError(
            f"GQA needs n_heads ({n_heads}) divisible by kv heads ({h_kv})")
    g = n_heads // h_kv
    quant = k_scale is not None
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, h_kv, g, hd)
    kf = k.to(q.dtype) if quant else k
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, kf).float() * scale
    if quant:
        scores = scores * k_scale[..., 0].permute(0, 2, 1)[:, :, None]
    mask = _mask_from(lengths, bitmap, s, q.device)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if quant:
        probs = probs * v_scale[..., 0].permute(0, 2, 1)[:, :, None].to(
            q.dtype)
        vf = v.to(q.dtype)
    else:
        vf = v
    out = torch.einsum("bhgk,bkhd->bhgd", probs, vf)
    return out.reshape(b, n_heads, hd)


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths, k_scale=None, v_scale=None,
                           bitmap=None) -> torch.Tensor:
    """K4's plain version: the grouped dense decode over the contiguous
    cache, with a fully masked row (length 0, or no set bit below the
    length) yielding zeros as the kernel's split merge does."""
    flash_decode_reference.calls += 1
    out = dense_decode_reference(q, k, v, lengths=lengths, k_scale=k_scale,
                                 v_scale=v_scale, bitmap=bitmap)
    live = _mask_from(lengths, bitmap, k.shape[1], q.device).any(dim=-1)
    return torch.where(live[:, None, None], out, torch.zeros_like(out))


flash_decode_reference.calls = 0


def paged_decode_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """K1's plain version: the table gather + the grouped dense decode."""
    paged_decode_reference.calls += 1
    sc = {}
    if k_scale is not None:
        sc = dict(k_scale=gather_paged_kv(k_scale, block_table),
                  v_scale=gather_paged_kv(v_scale, block_table))
    return dense_decode_reference(
        q, gather_paged_kv(k_pages, block_table),
        gather_paged_kv(v_pages, block_table), lengths=lengths, **sc)


paged_decode_reference.calls = 0


def dense_prefill_reference(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor,
                            prefix_table: torch.Tensor, hit_lens,
                            tail_k: torch.Tensor, tail_v: torch.Tensor,
                            k_scale=None, v_scale=None) -> torch.Tensor:
    """K2's plain version: the tail window q [M, tb, H, hd] against [the
    cached prefix gathered through ``prefix_table`` [M, hb]] ++ [the
    tail's own K/V [M, tb, Hkv, hd]] → [M, tb, H, hd]. Prefix column c is
    visible iff c < hit_len; tail column j is visible to tail query i iff
    j <= i. int8-KV dequantizes the gathered prefix only — the tail K/V
    are exact-dtype rows this dispatch computed."""
    dense_prefill_reference.calls += 1
    m, tb, n_heads, hd = q.shape
    ps, h_kv = k_pages.shape[1], k_pages.shape[2]
    if n_heads % h_kv:
        raise ValueError(
            f"GQA needs n_heads ({n_heads}) divisible by kv heads ({h_kv})")
    hb = prefix_table.shape[1]
    hp = hb * ps
    quant = k_scale is not None
    if quant and v_scale is None:
        raise ValueError("int8-KV mode needs both k_scale and v_scale")
    hit_lens = torch.as_tensor(hit_lens, dtype=torch.int32, device=q.device)
    if hit_lens.ndim == 0:
        hit_lens = hit_lens.expand(m)
    idx = prefix_table.long()

    def gather(pool):
        return pool[idx].reshape(m, hp, *pool.shape[2:])

    if quant:
        pk = (gather(k_pages).float() * gather(k_scale)).to(q.dtype)
        pv = (gather(v_pages).float() * gather(v_scale)).to(q.dtype)
    else:
        pk, pv = gather(k_pages), gather(v_pages)
    kf = torch.cat([pk, tail_k], dim=1)              # [M, hp+tb, Hkv, hd]
    vf = torch.cat([pv, tail_v], dim=1)
    kcol = torch.arange(hp + tb, device=q.device)[None, None, :]
    qrow = torch.arange(tb, device=q.device)[None, :, None]
    valid = torch.where(kcol < hp, kcol < hit_lens[:, None, None],
                        (kcol - hp) <= qrow)         # [M, tb, hp+tb]
    g = n_heads // h_kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(m, tb, h_kv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf).float() * scale
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
    return out.reshape(m, tb, n_heads, hd)


dense_prefill_reference.calls = 0


def verify_plan(n_blocks: int, page_size: int, t: int, batch: int = 1,
                n_kv: int = 1) -> Optional[int]:
    """K3's split count for a ``t``-row verify window, or None when the
    window is empty or the shape is not pageable. The window rides as
    extra query rows, never as extra grid, so the kv side is exactly K1's
    plan (``paged_plan``)."""
    if t < 1:
        return None
    return paged_plan(n_blocks, page_size, batch, n_kv)


def dense_verify_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Grouped-einsum multi-query verify attention: the window q [B, t, H,
    hd] against the cache [B, S, Hkv, hd] → [B, t, H, hd]. ``lengths``
    (scalar or [B]) counts the committed rows before the window, whose
    own K/V already sit at rows lengths..lengths+t-1; window row i attends
    cols < lengths + i + 1. int8-KV factors the per-row scales onto the
    scores and the probabilities as ``dense_decode_reference`` does.
    Masked columns are zeroed after the softmax, so a fully masked row
    yields zeros, as the kernel's does (any visible column already drives
    them to exactly 0)."""
    b, t, n_heads, hd = q.shape
    s, h_kv = k.shape[1], k.shape[2]
    if n_heads % h_kv:
        raise ValueError(
            f"GQA needs n_heads ({n_heads}) divisible by kv heads ({h_kv})")
    g = n_heads // h_kv
    quant = k_scale is not None
    if quant and v_scale is None:
        raise ValueError("int8-KV mode needs both k_scale and v_scale")
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, t, h_kv, g, hd)
    kf = k.to(q.dtype) if quant else k
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf).float() * scale
    if quant:
        scores = scores * k_scale[..., 0].permute(0, 2, 1)[:, :, None, None]
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    if lengths.ndim == 0:
        lengths = lengths.expand(b)
    bound = lengths[:, None] + torch.arange(t, device=q.device)[None] + 1
    mask = torch.arange(s, device=q.device)[None, None, :] < bound[..., None]
    mask = mask[:, None, None]                         # [B, 1, 1, t, S]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.where(mask, torch.softmax(scores, dim=-1), 0.0).to(q.dtype)
    if quant:
        probs = probs * v_scale[..., 0].permute(0, 2, 1)[
            :, :, None, None].to(q.dtype)
        vf = v.to(q.dtype)
    else:
        vf = v
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
    return out.reshape(b, t, n_heads, hd)


def paged_verify_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """K3's plain version: the table gather + the grouped dense verify."""
    paged_verify_reference.calls += 1
    sc = {}
    if k_scale is not None:
        sc = dict(k_scale=gather_paged_kv(k_scale, block_table),
                  v_scale=gather_paged_kv(v_scale, block_table))
    return dense_verify_reference(
        q, gather_paged_kv(k_pages, block_table),
        gather_paged_kv(v_pages, block_table), lengths, **sc)


paged_verify_reference.calls = 0


# -- wrappers -------------------------------------------------------------------

def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version
    (CPU tensor); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"paged attention takes CUDA or CPU tensors, got "
                     f"{t.device}")


def _check_kernel_args(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, k_scale, v_scale,
                       n_heads: int, n_kv: int, hd: int) -> bool:
    """Validate what the CUDA kernel takes; returns the int8-KV flag."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {KERNEL_HEAD_DIMS}")
    if n_heads % n_kv or n_heads // n_kv not in KERNEL_GROUPS:
        raise ValueError(f"{name}: n_heads/n_kv_heads = {n_heads}/{n_kv} "
                         f"must be a group size in {KERNEL_GROUPS}")
    quant = k_pages.dtype == torch.int8
    if not quant and k_pages.dtype != q.dtype:
        raise ValueError(f"{name}: pool dtype {k_pages.dtype} must be q's "
                         f"({q.dtype}) or int8")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name}: k/v pool dtypes differ")
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError(f"{name}: an int8 pool needs k_scale and v_scale "
                         f"(and only an int8 pool takes them)")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError(f"{name}: scales must be float32")
    for t in (q, k_pages, v_pages) + ((k_scale, v_scale) if quant else ()):
        if t.device != q.device:
            raise ValueError(f"{name}: all operands must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return quant


def _lengths_vector(lengths, b: int, device) -> torch.Tensor:
    """``lengths`` (an int, or a 0-dim or [B] tensor or array) as a
    contiguous int32 [B] vector on ``device``. An int becomes a fill on the
    device: a host-to-device copy of a scalar would wait for the stream."""
    if isinstance(lengths, int):
        return torch.full((b,), lengths, dtype=torch.int32, device=device)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return (lens.expand(b) if lens.ndim == 0 else lens).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _raise_on(err: int, name: str) -> None:
    if err:
        from ._build import error_string

        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{error_string(err)} ({err})")


@leaf_op
def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           plan_kv_heads: Optional[int] = None
                           ) -> torch.Tensor:
    """Decode attention over a paged KV cache: q [B, H, hd] against the
    pool k/v [n_pages, ps, Hkv, hd] through ``block_table`` [B, n_blocks]
    int32, masked to logical rows < ``lengths`` [B] → [B, H, hd] in q's
    dtype. ``k_scale``/``v_scale`` [n_pages, ps, Hkv, 1] f32 switch to an
    int8 pool. Rows past a length may be garbage; they never contribute.
    ``plan_kv_heads`` (default Hkv) is the kv-head count the split plan
    is made for: a rank of a tp island holds Hkv/tp heads and passes the
    model's Hkv, so each head is split and merged as on one card."""
    b, n_heads, hd = q.shape
    if k_pages.shape[3] != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"page pool shape {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be [B={b}, n_blocks], got "
                         f"{tuple(block_table.shape)}")
    ps, n_kv = k_pages.shape[1], k_pages.shape[2]
    n_blocks = block_table.shape[1]
    ns = paged_plan(n_blocks, ps, b, plan_kv_heads or n_kv)
    if ns is None:
        raise ValueError(f"no legal paged blocking for n_blocks={n_blocks}, "
                         f"page_size={ps}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV mode needs both k_scale and v_scale")
    if not _route(q):
        return paged_decode_reference(q, k_pages, v_pages, block_table,
                                      lengths, k_scale, v_scale)
    quant = _check_kernel_args("paged_decode_attention", q, k_pages,
                               v_pages, k_scale, v_scale, n_heads, n_kv, hd)
    table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = _lengths_vector(lengths, b, q.device)
    out = torch.empty_like(q)
    from ._build import load_library

    lib = load_library()
    err = lib.paged_decode_attention_launch(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(table), _ptr(lens), _ptr(out),
        b, n_heads, n_kv, hd, ps, n_blocks, ns,
        # The dtype and int8 flags are host bools:
        # graftcheck: ignore[host-sync-in-dispatch]
        int(q.dtype == torch.bfloat16), int(quant),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _raise_on(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


@leaf_op
def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor,
                            prefix_table: torch.Tensor, hit_lens,
                            tail_k: torch.Tensor, tail_v: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Prefix-attention prefill over a paged KV cache: the tail window q
    [M, tb, H, hd] (tail query i at absolute position hit_len + i, rope
    applied) against [each entry's cached prefix, read from the pool
    through ``prefix_table`` [M, hb] int32] ++ [the tail's own K/V
    [M, tb, Hkv, hd], q's dtype] → [M, tb, H, hd]. ``hit_lens`` [M]
    counts cached prefix rows (<= hb·ps; table entries past them are
    never read). ``tb`` must be a multiple of the page size. hb == 0 is
    the pure causal window. An int8 pool dequantizes the prefix only."""
    m, tb, n_heads, hd = q.shape
    if k_pages.shape[3] != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"page pool shape {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if prefix_table.ndim != 2 or prefix_table.shape[0] != m:
        raise ValueError(f"prefix_table must be [M={m}, hb], got "
                         f"{tuple(prefix_table.shape)}")
    ps, n_kv = k_pages.shape[1], k_pages.shape[2]
    if tuple(tail_k.shape) != (m, tb, n_kv, hd) \
            or tail_v.shape != tail_k.shape:
        raise ValueError(f"tail K/V {tuple(tail_k.shape)}/"
                         f"{tuple(tail_v.shape)} must be [M={m}, tb={tb}, "
                         f"Hkv={n_kv}, hd={hd}]")
    if tb % ps:
        raise ValueError(f"tail bucket tb={tb} must be a multiple of the "
                         f"page size {ps}")
    if paged_plan(1, ps) is None:
        raise ValueError(f"no legal paged blocking for page_size={ps}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV mode needs both k_scale and v_scale")
    if not _route(q):
        return dense_prefill_reference(q, k_pages, v_pages, prefix_table,
                                       hit_lens, tail_k, tail_v,
                                       k_scale, v_scale)
    quant = _check_kernel_args("paged_prefill_attention", q, k_pages,
                               v_pages, k_scale, v_scale, n_heads, n_kv, hd)
    for t in (tail_k, tail_v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("paged_prefill_attention: tail K/V must have "
                             "q's dtype and device")
    tail_k, tail_v, q = tail_k.contiguous(), tail_v.contiguous(), \
        q.contiguous()
    hb = prefix_table.shape[1]
    table = prefix_table.to(device=q.device, dtype=torch.int32).contiguous()
    hits = _lengths_vector(hit_lens, m, q.device)
    out = torch.empty_like(q)
    from ._build import load_library

    lib = load_library()
    err = lib.paged_prefill_attention_launch(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(table), _ptr(hits), _ptr(tail_k), _ptr(tail_v), _ptr(out),
        m, tb, n_heads, n_kv, hd, ps, hb,
        # The dtype and int8 flags are host bools:
        # graftcheck: ignore[host-sync-in-dispatch]
        int(q.dtype == torch.bfloat16), int(quant),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _raise_on(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


@leaf_op
def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           plan_kv_heads: Optional[int] = None
                           ) -> torch.Tensor:
    """Multi-query verify attention over a paged KV cache: the speculative
    window q [B, t, H, hd] (t = 1 + gamma) against the pool k/v [n_pages,
    ps, Hkv, hd] through ``block_table`` [B, n_blocks] int32 → [B, t, H,
    hd] in q's dtype. ``lengths`` [B] counts the committed rows before the
    window, whose own K/V must already sit at rows lengths..lengths+t-1;
    window row i attends cols < lengths + i + 1. Rows above a row's bound
    (a rejected overshoot, stale pages) never contribute. At t == 1 this
    is ``paged_decode_attention`` at ``lengths + 1``. ``k_scale``/
    ``v_scale`` [n_pages, ps, Hkv, 1] f32 switch to an int8 pool;
    ``plan_kv_heads`` as in ``paged_decode_attention``."""
    b, t, n_heads, hd = q.shape
    if k_pages.shape[3] != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"page pool shape {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be [B={b}, n_blocks], got "
                         f"{tuple(block_table.shape)}")
    ps, n_kv = k_pages.shape[1], k_pages.shape[2]
    if n_heads % n_kv:
        raise ValueError(
            f"GQA needs n_heads ({n_heads}) divisible by kv heads ({n_kv})")
    g = n_heads // n_kv
    n_blocks = block_table.shape[1]
    n_groups = -(-t * g // VERIFY_Q_ROWS.get(q.dtype, 32))
    ns = verify_plan(n_blocks, ps, t, b * n_groups, plan_kv_heads or n_kv)
    if ns is None:
        raise ValueError(f"no legal verify blocking for n_blocks={n_blocks},"
                         f" page_size={ps}, t={t}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV mode needs both k_scale and v_scale")
    if not _route(q):
        return paged_verify_reference(q, k_pages, v_pages, block_table,
                                      lengths, k_scale, v_scale)
    q = q.contiguous()
    quant = _check_kernel_args("paged_verify_attention", q, k_pages,
                               v_pages, k_scale, v_scale, n_heads, n_kv, hd)
    table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = _lengths_vector(lengths, b, q.device)
    out = torch.empty_like(q)
    from ._build import load_library

    lib = load_library()
    err = lib.paged_verify_attention_launch(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(table), _ptr(lens), _ptr(out),
        b, t, n_heads, n_kv, hd, ps, n_blocks, ns,
        # The dtype and int8 flags are host bools:
        # graftcheck: ignore[host-sync-in-dispatch]
        int(q.dtype == torch.bfloat16), int(quant),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _raise_on(err, "paged_verify_attention")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0


@leaf_op
def flash_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           bitmap: Optional[torch.Tensor] = None,
                           plan_batch: Optional[int] = None,
                           plan_kv_heads: Optional[int] = None
                           ) -> torch.Tensor:
    """Decode attention over a contiguous KV cache: q [B, H, hd] (one
    decode step) against k/v [B, S, Hkv, hd], any S → [B, H, hd] in q's
    dtype. ``lengths`` (an int, or a [B] or 0-dim int tensor, required):
    rows < length are attendable and rows past it are never read.
    ``k_scale``/``v_scale`` [B, S, Hkv, 1] f32 switch to an int8 cache.
    ``bitmap`` [B, S] bool refines the length mask to exactly the valid
    rows (the shared-cursor engine's slot windows); unset rows get exactly
    zero weight and their K/V are not read. A fully masked row yields
    zeros.

    ``plan_batch`` and ``plan_kv_heads`` (default B and Hkv) are the batch
    and kv-head counts the split plan is made for: a rank of a mesh holds
    B/(dp·fsdp) rows and Hkv/tp heads and passes the model's, so each
    (row, head) is split and merged as on one card. The split count of the
    last call, on either route, is ``flash_decode_attention.last_splits``."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"q must be [B, H, hd] and k/v [B, S, Hkv, hd], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, n_heads, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"cache shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    s, n_kv = k.shape[1], k.shape[2]
    if s < 1:
        raise ValueError("the cache has no rows")
    if n_heads % n_kv:
        raise ValueError(
            f"GQA needs n_heads ({n_heads}) divisible by kv heads ({n_kv})")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV mode needs both k_scale and v_scale")
    for sc in (k_scale, v_scale):
        if sc is not None and tuple(sc.shape) != (b, s, n_kv, 1):
            raise ValueError(f"scales must be [B={b}, S={s}, Hkv={n_kv}, 1], "
                             f"got {tuple(sc.shape)}")
    if bitmap is not None and (tuple(bitmap.shape) != (b, s)
                               or bitmap.dtype != torch.bool):
        raise ValueError(f"bitmap must be bool [B={b}, S={s}], got "
                         f"{bitmap.dtype} {tuple(bitmap.shape)}")
    if isinstance(lengths, torch.Tensor):
        if lengths.dtype not in (torch.int32, torch.int64) \
                or tuple(lengths.shape) not in ((), (b,)):
            raise ValueError(f"lengths must be an int or an int tensor of "
                             f"shape () or [B={b}], got {lengths.dtype} "
                             f"{tuple(lengths.shape)}")
        live_rows = s                    # not read back: plan for the most
    else:
        # A non-tensor length is the host's cursor:
        # graftcheck: ignore[host-sync-in-dispatch]
        lengths = int(lengths)
        live_rows = min(max(lengths, 0), s)
    ns = flash_decode_plan(live_rows, plan_batch or b, plan_kv_heads or n_kv)
    flash_decode_attention.last_splits = ns
    if not _route(q):
        return flash_decode_reference(q, k, v, lengths, k_scale, v_scale,
                                      bitmap)
    quant = _check_kernel_args("flash_decode_attention", q, k, v, k_scale,
                               v_scale, n_heads, n_kv, hd)
    if bitmap is not None and (bitmap.device != q.device
                               or not bitmap.is_contiguous()):
        raise ValueError(f"flash_decode_attention: the bitmap must be "
                         f"contiguous on {q.device}")
    # An int length (the engine's cursor) rides as a kernel argument: no
    # fill, so the output is the wrapper's one allocation.
    lens = None if isinstance(lengths, int) else _lengths_vector(
        lengths, b, q.device)
    out = torch.empty_like(q)
    from ._build import load_library

    lib = load_library()
    err = lib.flash_decode_attention_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(k_scale), _ptr(v_scale),
        _ptr(bitmap), _ptr(lens), live_rows if lens is None else 0, _ptr(out),
        b, n_heads, n_kv, hd, s, ns,
        # The dtype and int8 flags are host bools:
        # graftcheck: ignore[host-sync-in-dispatch]
        int(q.dtype == torch.bfloat16), int(quant),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _raise_on(err, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention.last_splits = None

_KERNELS = (paged_decode_attention, paged_prefill_attention,
            paged_verify_attention, flash_decode_attention)
_PLAIN = (paged_decode_reference, dense_prefill_reference,
          paged_verify_reference, flash_decode_reference)


def reset_counters() -> None:
    """Zero every kernel launch counter and plain-version call counter."""
    for fn in _KERNELS:
        fn.launches = 0
    for fn in _PLAIN:
        fn.calls = 0


def counters() -> dict:
    """{wrapper name: kernel launches, plain version name: calls}."""
    return {**{fn.__name__: fn.launches for fn in _KERNELS},
            **{fn.__name__: fn.calls for fn in _PLAIN}}
