#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (k8s_gpu_scheduler_tpu_torch).

    python3 chip_smoke.py [--profile [--parent DIR]] [--train-layers N]
    python3 chip_smoke.py --kernels-only [--package-root DIR]

Needs one CUDA card and the CUDA toolkit; exits non-zero without them. It
imports nothing of JAX. Phases, each of which fails the run on error:

0. build: compile the kernels from ``ops/csrc`` (one nvcc per source, in
   parallel, linked into one library) and print each kernel's registers,
   shared memory and spills, the count of tensor-core (HMMA) instructions
   in each kernel's SASS where cuobjdump exists (each bf16 mma.sync kernel
   must have some: K2 ``paged_prefill_mma.cu``, K1, K3 and K4
   ``decode_mma.cu`` with paged and with contiguous rows, K5
   ``flash_forward_mma.cu``, K6 and K7 ``flash_backward_mma.cu``), and the
   card's name and power limit (nvidia-smi).
1. kernels against their plain PyTorch versions on the card: K1
   (paged_decode_attention), K2 (paged_prefill_attention) and K3
   (paged_verify_attention, window t = 5) at the serve width (B 8, H =
   Hkv = 16, hd 64, page 64, 32 blocks, lengths up to 2048; K2 with tb
   512, hb 8) and at a GQA shape (H 32, Hkv 8, hd 128), each in bf16 and
   with an int8 KV pool; K2 also at phase 4's chunked-prefill shape (tb
   64 over 512 resident rows, hb 8, 8 padded entries), and each of that
   run's 15 continuation shapes timed alone, summed to the 240 launches'
   total. bf16 runs K1-K4 on the tensor cores (``paged_prefill_mma.cu``;
   ``decode_mma.cu``, one body for K1, K3 and K4); K1, K3 and K4 merge
   their splits across a thread-block cluster and write their output
   themselves. K1's case also times K3 at t = 1 over lengths - 1 (K1's
   mask) on the same inputs. Max error against a stated tolerance;
   CUDA-event times of the kernel, the plain version and one library call
   (scaled_dot_product_attention over the gathered K/V, a yardstick the
   port never calls), beside the least time the card could take (bytes
   over 3.35 TB/s or operations over 989 TFLOP/s). Then the flash
   attention kernels K5 (forward), K6 (dq) and K7 (dk, dv), causal, bf16,
   at train-8b (B 8, T 2048, H 32, Hkv 8, hd 128: the shapes phase 6
   gives them) and train-hd64 (B 4, T 1024, H = Hkv = 16, hd 64), K5's
   f32 lse held to the f32 tolerance (2e-5); the yardstick is
   scaled_dot_product_attention with is_causal (K5) and its autograd
   backward, which yields dq, dk and dv together (K6, K7); bf16 runs K5
   (``flash_forward_mma.cu``), K6 and K7 (``flash_backward_mma.cu``) on
   the tensor cores. And K4
   (flash_decode_attention) over a contiguous cache of S 2048 with the
   cursor at row 1024 and each slot's bitmap a 576-row window ending
   there (a 512-token prompt plus 64 decode rows: what a slot holds in
   the serve traffic), at the serve width and the GQA shape, bf16 and
   int8, plus a no-bitmap case with ragged [B] lengths; its bound counts
   the set rows only, and the bound of reading every row under the
   cursor is printed beside it; one call of each must launch one CUDA
   kernel (torch.profiler) and allocate only its output. Each case also
   prints its achieved rate (its operations over its time) and its share
   of the bound.
2. the engine on the card against the engine on the CPU, a small f32
   config: plain, speculative (bigram, gamma 3) and chunked-prefill (2
   pages a step) engines; greedy streams, prefill_tokens_skipped and the
   accept counts must be identical, and the card must have run K2 and K3
   and no plain version. Then the contiguous path the same way: the
   shared-cursor engine (through an FCFS stop and an epoch roll),
   generate and generate_speculative; streams identical, the card's K4
   and K3 launches equal to the CPU's plain-version calls (and to layers
   x ticks), no plain version on the card.
3. the main path at full width: the serve config (d_model 1024, 8 layers,
   16 heads, vocab 32000) in bf16 with 8 slots, page 64, chunk 64 and
   prefill bucket 512, 32 requests of 512-token prompts sharing a
   384-token system prompt. Counters are zeroed just before and read just
   after: K1 and K2 must have launched and no plain version been called.
   A second greedy run must reproduce the streams. Then a shorter pass
   with int8 weights and an int8 KV pool.
4. the speculative path at full width: the same config with
   speculative=True, gamma 4, the bigram proposer, prefill bucket 128, on
   32 requests of a random 16-token phrase repeated 8 times, max_new 64
   (the JAX bench's speculative leg); the same traffic with speculation
   off; an int8-KV sampled run at temperature 0.005, twice (the replay
   must match); and 8 random 1024-token prompts with
   prefill_chunk_tokens=256. K3 must have launched, the accept rate be
   above 0, and no plain version been called.

5. training on the card against training on the CPU: f32, TF32 off,
   vocab 256, d_model 256, 2 layers, 4 heads, 2 kv heads, T 128, remat,
   flash attention, 3 AdamW steps. The losses must agree to 1e-5
   relative, the card launch K5 2·L·steps times and K6 and K7 L·steps
   times and call no plain version, and a second card run give the same
   losses bit for bit.
6. the training path at full width: the llama3_8b widths (vocab 128256,
   d_model 4096, 32 heads, 8 kv heads, d_ff 14336) with depth cut to 4
   layers, bf16, remat, flash attention, AdamW 3e-4, B 8, T 2048, one
   fixed batch: one warm-up step, then 5 timed steps (counters zeroed just
   before and read just after). Prints each loss, step ms, tokens/s, MFU
   (against 989 TFLOP/s) and peak memory. Every loss must be finite, the
   last below the first, K5 launch 2·L (8) and K6 and K7 L (4) times per
   step, and no plain version run.
7. the contiguous path at full width: the serve config in bf16,
   kv_layout="contiguous", 8 slots, prefill bucket 512, chunk 64, the
   serve loop's traffic: 32 requests of 512 tokens, max_new 64 (K4 must
   launch layers x ticks times and no plain version run);
   then 80 requests whose max_new is drawn from {64, 256}, so that slots
   drain apart, the cursor climbs towards S and both an FCFS stop and an
   epoch roll happen; a pass with int8 weights and an int8 KV cache;
   make_server_step at B 1, prompt 512, max_new 64; and
   generate_speculative at B 1 on phase 4's repeated-phrase prompt, gamma
   4 (K3 through the paged view of the cache), with its tokens per verify
   and how far its greedy stream agrees with generate's (bf16: near-ties
   may part them; phase 2 holds the identity at f32).
8. the serving lifecycle and the KV tier. (a) phase 2's f32 config, a
   17-page pool and four waves of five requests (A on a shared system
   prompt, B unique, C on A's system prompt, D = B again): a card engine
   drained in the middle of wave C, persisted by
   ``lifecycle.drain_to_checkpoint`` into a temporary directory and
   resumed by ``resume_or_fresh`` into a fresh card engine must give the
   streams of the CPU engine's undrained, untiered run (plain, int8 KV,
   speculative, and tiered with ``dram_pages=24``), the resumed engine
   launching K2 and K1 (K3 speculative) and no plain version. (b) phase 3's
   engine and shared-prefix traffic in bf16 with max_new 128 (32
   requests; then 16 with int8 KV): drained after one step and restored
   into a 160-page pool, the streams must equal an uninterrupted run;
   prints the drain and restore ms, ``snap.nbytes()`` and the pages
   moved. (c) three waves of 8 requests of 512 tokens at the serve config
   (A on a 384-token system prompt, B unique, C on A's system prompt)
   with ``kv_tiering=True, dram_pages=64`` in 73 pages (B evicts all of
   A's cached pages), tiering off in 73 pages, and the default pool that
   evicts nothing: the tiered streams must equal the large pool's, wave
   C's skipped prefill tokens equal the large pool's and exceed the
   untiered run's; prints the demote and promote ms, promotions and K2
   launches of each run, and the untiered run's first divergence from
   the large pool (its dense prefill may part at a bf16 near-tie). The
   allocator's and the tier's invariants are asserted after every drain,
   restore and wave.

9. observability at full width: phase 3's engine and traffic (and then
   phase 4's speculative engine and traffic) run untraced with no flight
   recorder, then with an ``obs.Tracer`` and the default recorder (256):
   the streams and the kernel launches (K1 and K2; K3) must be equal and
   no plain version run, no span dropped, the spans (queue, admit,
   prefill, decode_chunk, reap; verify and rewind) written by
   ``write_perfetto`` must pass ``validate_perfetto``, and one
   ``pool_metrics()`` snapshot exported by ``export_serving_pool`` must
   expose ``tpu_serve_phase_duration_seconds`` for every phase that ran.
   Prints each phase's span count, total host ms and mean ms a span (a
   dispatch span ends when its kernels are enqueued), then decode tokens/s
   and wall for untraced (flight 0), the defaults and traced, three runs
   of each in turn (no gate: the host's spread is wider than the
   instrumentation).

``--profile`` adds profiled serving runs (plain decode, speculative and
the contiguous engine) and one profiled training step: the card's busy
share and its time by kernel; and the CUDA kernels one paged decode
dispatch launches per layer per tick, one verify dispatch per layer per
verify and one contiguous decode dispatch per layer per tick (``--parent
DIR``: the same count for the package in DIR, a copy of another tree, in a
process of its own). ``--train-layers N`` runs phase 6 at depth N instead
of 4, to measure how step time and peak memory grow with depth.
``--kernels-only`` runs phases 0 and 1 alone and prints their cases, not
the contract's last lines (``--package-root DIR``: the package in DIR, to
time another tree's kernels).

The line before the last is a JSON object listing every kernel with its
launches on the main path, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
CSRC = "k8s_gpu_scheduler_tpu_torch/ops/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "paged_decode_attention": (
        "decode_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:497"),
    "paged_prefill_attention": (
        "paged_prefill_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:999"),
    "paged_verify_attention": (
        "decode_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:688"),
    "flash_decode_attention": (
        "decode_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:360"),
    "flash_forward": (
        "flash_forward_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/flash_attention.py:117"),
    "flash_backward_dq": (
        "flash_backward_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/flash_attention.py:159"),
    "flash_backward_dkv": (
        "flash_backward_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/flash_attention.py:209"),
}
PLAIN = ("paged_decode_reference", "dense_prefill_reference",
         "paged_verify_reference", "flash_decode_reference")
FLASH = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
FLASH_PLAIN = ("flash_forward_reference", "flash_backward_reference")
# The bf16 kernels on mma.sync, each named by the words its SASS name
# holds: phase 0 finds HMMA instructions in each. The shared body of K1,
# K3 (paged rows) and K4 (contiguous rows) is checked in both sources.
TENSOR_CORE_KERNELS = (("paged_prefill_mma_kernel",),
                       ("decode_mma_kernel", "PagedRows"),
                       ("decode_mma_kernel", "ContiguousRows"),
                       ("flash_fwd_mma_kernel",), ("flash_bwd_dq_mma_kernel",),
                       ("flash_bwd_dkv_mma_kernel",))


def log(*parts) -> None:
    print(*parts, flush=True)


# -- timing ---------------------------------------------------------------------

class _L2Flush:
    """Writes 256 MiB before each timed launch so every launch finds the
    50 MB L2 cold, as a layer's pool slice is on the main path."""

    def __init__(self, device):
        self.buf = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms (CUDA events), the
    L2 flushed before each call. The card first spins until the host has
    enqueued every call, so the events bracket the device's work alone and
    not the host's Python and launch overhead."""
    for _ in range(warmup):
        fn()
    hold = 1 << 25                       # cycles: ~17 ms at 1.98 GHz
    for _ in range(4):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(hold)
        for a, b in ev:
            flush()
            a.record()
            fn()
            b.record()
        if not ev[0][0].query():         # still spinning: all enqueued
            torch.cuda.synchronize()
            return float(np.median([a.elapsed_time(b) for a, b in ev]))
        hold *= 4
    raise SystemExit("could not hold the card busy past the host's enqueue")


def max_err(got: torch.Tensor, ref: torch.Tensor, tol: float):
    """(max |got - ref|, whether |got - ref| <= tol + tol*|ref| holds)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    ok = bool(torch.all(d <= tol + tol * r.abs())) and bool(
        torch.isfinite(g).all())
    return float(d.max()), ok


# -- phase 1: kernels against plain ----------------------------------------------

def _pool(gen, n_pages, ps, n_kv, hd, dtype, int8, dev):
    from k8s_gpu_scheduler_tpu_torch.models.serving import _kv_quant

    k = torch.randn((n_pages, ps, n_kv, hd), generator=gen).to(dtype)
    v = torch.randn((n_pages, ps, n_kv, hd), generator=gen).to(dtype)
    if not int8:
        return k.to(dev), v.to(dev), {}
    kq, ks = _kv_quant(k)
    vq, vs = _kv_quant(v)
    return kq.to(dev), vq.to(dev), dict(k_scale=ks.to(dev),
                                        v_scale=vs.to(dev))


def _deq(pages, scale, dtype):
    return pages if scale is None else (pages.float() * scale).to(dtype)


def _gather(scale, table):
    from k8s_gpu_scheduler_tpu_torch.ops.decode_attention import (
        gather_paged_kv)

    return None if scale is None else gather_paged_kv(scale, table)


def _heads(kv, n_heads):
    """[B, S, Hkv, hd] -> [B, H, S, hd], kv heads repeated per group."""
    return kv.repeat_interleave(n_heads // kv.shape[2], dim=2).transpose(1, 2)


def decode_case(name, B, H, n_kv, hd, ps, n_blocks, int8, dev, flush,
                seed=0):
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    n_pages = 1 + B * n_blocks
    q = torch.randn((B, H, hd), generator=gen).to(dtype).to(dev)
    kp, vp, sc = _pool(gen, n_pages, ps, n_kv, hd, dtype, int8, dev)
    table = (torch.randperm(n_pages - 1, generator=gen)[:B * n_blocks] + 1) \
        .reshape(B, n_blocks).to(torch.int32).to(dev)
    S = n_blocks * ps
    lens = torch.randint(1, S + 1, (B,), generator=gen)
    lens[0], lens[-1] = S, 1
    lens = lens.to(torch.int32).to(dev)
    out = da.paged_decode_attention(q, kp, vp, table, lens, **sc)
    ref = da.paged_decode_reference(q, kp, vp, table, lens, **sc)
    torch.cuda.synchronize()
    err, ok = max_err(out, ref, TOL[dtype])
    ms = time_ms(lambda: da.paged_decode_attention(
        q, kp, vp, table, lens, **sc), flush)
    plain_ms = time_ms(lambda: da.paged_decode_reference(
        q, kp, vp, table, lens, **sc), flush)
    # Library yardstick: SDPA over the gathered (dequantized) K/V.
    K = _heads(_deq(da.gather_paged_kv(kp, table),
                    _gather(sc.get("k_scale"), table), dtype), H)
    V = _heads(_deq(da.gather_paged_kv(vp, table),
                    _gather(sc.get("v_scale"), table), dtype), H)
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None].long()
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: lib(q4, K, V, attn_mask=mask), flush)
    lib_err, _ = max_err(lib(q4, K, V, attn_mask=mask)[:, :, 0], ref,
                         TOL[dtype])
    # Yardstick: K3 at t = 1 over lengths - 1 masks col < length, K1's
    # mask (every length here is at least 1), on the same inputs.
    yard = (q[:, None], kp, vp, table, lens - 1)
    k3_err, k3_ok = max_err(da.paged_verify_attention(*yard, **sc)[:, 0],
                            ref, TOL[dtype])
    k3_ms = time_ms(lambda: da.paged_verify_attention(*yard, **sc), flush)
    live = int(lens.sum())
    eb = 1 if int8 else 2
    nbytes = (B * H * hd * 2 * 2 + B * n_blocks * 4 + B * 4
              + live * n_kv * hd * eb * 2 + (live * n_kv * 4 * 2 if int8
                                             else 0))
    flops = 4 * live * H * hd
    return dict(case=name, kernel="paged_decode_attention", int8=int8,
                max_abs_err=err, tol=TOL[dtype], ok=ok and k3_ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                k3_t1_ms=k3_ms, k3_t1_err=k3_err,
                **_bound(nbytes, flops, dtype))


def prefill_case(name, M, tb, hb, H, n_kv, hd, ps, int8, dev, flush,
                 seed=1, hits=None):
    """K2 against its plain version. ``hits``: the entries' cached rows;
    by default ragged page-aligned hits (the main path's 6 pages, full,
    half, none)."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    n_pages = 1 + M * hb
    q = torch.randn((M, tb, H, hd), generator=gen).to(dtype).to(dev)
    tk = torch.randn((M, tb, n_kv, hd), generator=gen).to(dtype).to(dev)
    tv = torch.randn((M, tb, n_kv, hd), generator=gen).to(dtype).to(dev)
    kp, vp, sc = _pool(gen, n_pages, ps, n_kv, hd, dtype, int8, dev)
    table = (torch.randperm(n_pages - 1, generator=gen)[:M * hb] + 1) \
        .reshape(M, hb).to(torch.int32).to(dev)
    choices = [6 * ps, hb * ps, (hb // 2) * ps, 0]
    hits = torch.tensor(hits or [choices[i % 4] for i in range(M)],
                        dtype=torch.int32, device=dev)
    args = (q, kp, vp, table, hits, tk, tv)
    out = da.paged_prefill_attention(*args, **sc)
    ref = da.dense_prefill_reference(*args, **sc)
    torch.cuda.synchronize()
    err, ok = max_err(out, ref, TOL[dtype])
    ms = time_ms(lambda: da.paged_prefill_attention(*args, **sc), flush)
    plain_ms = time_ms(lambda: da.dense_prefill_reference(*args, **sc),
                       flush)
    hp = hb * ps
    pk = _deq(da.gather_paged_kv(kp, table),
              _gather(sc.get("k_scale"), table), dtype)
    pv = _deq(da.gather_paged_kv(vp, table),
              _gather(sc.get("v_scale"), table), dtype)
    K = _heads(torch.cat([pk, tk], 1), H)
    V = _heads(torch.cat([pv, tv], 1), H)
    kcol = torch.arange(hp + tb, device=dev)[None, None, :]
    qrow = torch.arange(tb, device=dev)[None, :, None]
    mask = torch.where(kcol < hp, kcol < hits[:, None, None].long(),
                       (kcol - hp) <= qrow)[:, None]
    qt = q.transpose(1, 2)
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: lib(qt, K, V, attn_mask=mask), flush)
    lib_err, _ = max_err(lib(qt, K, V, attn_mask=mask).transpose(1, 2),
                         ref, TOL[dtype])
    hit_rows = int(hits.sum())
    eb = 1 if int8 else 2
    nbytes = (M * tb * H * hd * 2 * 2 + M * tb * n_kv * hd * 2 * 2
              + hit_rows * n_kv * hd * eb * 2
              + (hit_rows * n_kv * 4 * 2 if int8 else 0) + M * hb * 4 + M * 4)
    flops = 4 * H * hd * (tb * hit_rows + M * tb * (tb + 1) // 2)
    return dict(case=name, kernel="paged_prefill_attention", int8=int8,
                max_abs_err=err, tol=TOL[dtype], ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                **_bound(nbytes, flops, dtype))


def verify_case(name, B, t, H, n_kv, hd, ps, n_blocks, int8, dev, flush,
                seed=2):
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    n_pages = 1 + B * n_blocks
    q = torch.randn((B, t, H, hd), generator=gen).to(dtype).to(dev)
    kp, vp, sc = _pool(gen, n_pages, ps, n_kv, hd, dtype, int8, dev)
    table = (torch.randperm(n_pages - 1, generator=gen)[:B * n_blocks] + 1) \
        .reshape(B, n_blocks).to(torch.int32).to(dev)
    S = n_blocks * ps
    lens = torch.randint(0, S - t + 1, (B,), generator=gen)
    lens[0], lens[-1] = S - t, 0
    lens = lens.to(torch.int32).to(dev)
    args = (q, kp, vp, table, lens)
    out = da.paged_verify_attention(*args, **sc)
    ref = da.paged_verify_reference(*args, **sc)
    torch.cuda.synchronize()
    err, ok = max_err(out, ref, TOL[dtype])
    ms = time_ms(lambda: da.paged_verify_attention(*args, **sc), flush)
    plain_ms = time_ms(lambda: da.paged_verify_reference(*args, **sc), flush)
    # Library yardstick: SDPA over the gathered K/V, a [B, 1, t, S] mask.
    K = _heads(_deq(da.gather_paged_kv(kp, table),
                    _gather(sc.get("k_scale"), table), dtype), H)
    V = _heads(_deq(da.gather_paged_kv(vp, table),
                    _gather(sc.get("v_scale"), table), dtype), H)
    bound = lens[:, None].long() + torch.arange(t, device=dev)[None] + 1
    mask = (torch.arange(S, device=dev)[None, None] < bound[..., None]
            )[:, None]
    qt = q.transpose(1, 2)
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: lib(qt, K, V, attn_mask=mask), flush)
    lib_err, _ = max_err(lib(qt, K, V, attn_mask=mask).transpose(1, 2), ref,
                         TOL[dtype])
    rows = int(torch.clamp(lens.long() + t, max=S).sum())   # K/V rows read
    eb = 1 if int8 else 2
    nbytes = (B * t * H * hd * 2 * 2 + rows * n_kv * hd * eb * 2
              + (rows * n_kv * 4 * 2 if int8 else 0) + B * n_blocks * 4
              + B * 4)
    cols = int((lens.long()[:, None] + torch.arange(
        1, t + 1, device=dev)[None]).sum())                 # visible (q, k)
    flops = 4 * H * hd * cols
    return dict(case=name, kernel="paged_verify_attention", int8=int8,
                max_abs_err=err, tol=TOL[dtype], ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                **_bound(nbytes, flops, dtype))


def flash_decode_case(name, B, H, n_kv, hd, S, int8, bitmap, dev, flush,
                      cursor=1024, window=576, seed=4):
    """K4 over a contiguous cache. ``bitmap``: the engine's call, a scalar
    cursor and each slot's last ``window`` rows under it set; else the
    ``cached_attention`` call, ragged [B] lengths and no bitmap."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, hd), generator=gen).to(dtype).to(dev)
    k, v, sc = _pool(gen, B, S, n_kv, hd, dtype, int8, dev)
    cols = torch.arange(S, device=dev)[None, :]
    if bitmap:
        lengths = cursor
        mask = ((cols >= cursor - window) & (cols < cursor)).expand(B, S) \
            .contiguous()
        kw = dict(bitmap=mask, **sc)
        under = B * cursor
    else:
        lens = torch.randint(1, S + 1, (B,), generator=gen)
        lens[0], lens[-1] = S, 1
        lengths = lens.to(torch.int32).to(dev)
        mask = cols < lengths[:, None].long()
        kw = dict(sc)
        under = int(lens.sum())
    out = da.flash_decode_attention(q, k, v, lengths, **kw)
    ref = da.flash_decode_reference(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    err, ok = max_err(out, ref, TOL[dtype])
    # The wrapper's cost beside the kernel: one call must launch one CUDA
    # kernel and allocate only its output.
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    da.flash_decode_attention(q, k, v, lengths, **kw)
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - allocs
    kernels = device_kernels(
        lambda: da.flash_decode_attention(q, k, v, lengths, **kw))
    ms = time_ms(lambda: da.flash_decode_attention(q, k, v, lengths, **kw),
                 flush)
    plain_ms = time_ms(lambda: da.flash_decode_reference(
        q, k, v, lengths, **kw), flush)
    # Library yardstick: SDPA over the K/V dequantized and repeated to H
    # heads beforehand, a boolean [B, 1, 1, S] mask.
    K = _heads(_deq(k, sc.get("k_scale"), dtype), H)
    V = _heads(_deq(v, sc.get("v_scale"), dtype), H)
    m4 = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: lib(q4, K, V, attn_mask=m4), flush)
    lib_err, _ = max_err(lib(q4, K, V, attn_mask=m4)[:, :, 0], ref,
                         TOL[dtype])
    live = int(mask.sum())                    # attendable rows, all slots
    eb = 1 if int8 else 2

    def kv_bytes(rows):
        return rows * n_kv * hd * eb * 2 + (rows * n_kv * 4 * 2 if int8
                                            else 0)

    # q and the output, the lengths, the bitmap's bytes under the cursor.
    fixed = B * H * hd * 2 * 2 + B * 4 + (under if bitmap else 0)
    return dict(case=name, kernel="flash_decode_attention", int8=int8,
                max_abs_err=err, tol=TOL[dtype], ok=ok, ms=ms,
                kernels_per_call=kernels, allocations_per_call=allocs,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                bound_under_cursor_ms=(fixed + kv_bytes(under))
                / HBM_BYTES_PER_S * 1e3,
                **_bound(fixed + kv_bytes(live), 4 * live * H * hd, dtype))


def chunked_prefill_sweep(dev, flush, n_layers=8, prompt=1024, budget=256,
                          ps=64, n_slots=8, H=16, hd=64) -> dict:
    """K2 at each continuation shape that phase 4's chunked run gives it
    (``ContinuousBatcher._advance_prefill``: a 256-token budget grants one
    64-token page to each of the four oldest pending slots a step, so a
    prompt's chunk j > 0 is a K2 launch of tb 64 over hit j·64 rows, hb the
    power-of-two bucket of j pages, the 4 entries padded to the 8 slots by
    repeating the last), timed alone; the 240 launches' total is their sum
    times the two groups of four prompts times the layers."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    gen = torch.Generator().manual_seed(5)
    dtype = torch.bfloat16
    tb, n_chunks = ps, prompt // ps
    n_blocks = 2048 // ps
    q = torch.randn((n_slots, tb, H, hd), generator=gen).to(dtype).to(dev)
    tk, tv = (torch.randn((n_slots, tb, H, hd), generator=gen).to(dtype)
              .to(dev) for _ in range(2))
    kp, vp, _ = _pool(gen, 1 + n_slots * n_blocks, ps, H, hd, dtype, False,
                      dev)
    per = {}
    for j in range(1, n_chunks):
        hb = min(1 << (j - 1).bit_length(), n_blocks)
        table = torch.arange(1, 1 + n_slots * hb, dtype=torch.int32,
                             device=dev).reshape(n_slots, hb)
        hits = torch.full((n_slots,), j * ps, dtype=torch.int32, device=dev)
        per[j * ps] = time_ms(lambda: da.paged_prefill_attention(
            q, kp, vp, table, hits, tk, tv), flush)
    groups = n_slots // (budget // ps)
    return dict(launch_ms=per, launches=(n_chunks - 1) * groups * n_layers,
                total_ms=sum(per.values()) * groups * n_layers)


def flash_cases(name, B, T, H, n_kv, hd, dev, flush, seed=3) -> list:
    """K5, K6 and K7 (causal, bf16) against their plain versions, each
    timed beside its plain version, the SDPA yardstick and its bound."""
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        flash_backward_reference, flash_forward_reference, launch_backward_dkv,
        launch_backward_dq, launch_forward)

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((B, T, H, hd), generator=gen).to(dtype).to(dev)
             for _ in range(2))
    k, v = (torch.randn((B, T, n_kv, hd), generator=gen).to(dtype).to(dev)
            for _ in range(2))
    out, lse = launch_forward(q, k, v, True, True)
    dq, delta = launch_backward_dq(q, k, v, out, lse, do, True)
    dk, dv = launch_backward_dkv(q, k, v, lse, delta, do, True)
    ref_out, ref_lse = flash_forward_reference(q, k, v, True)
    refs = flash_backward_reference(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    # lse is f32 on both sides: it is held to the f32 tolerance.
    errs = [max_err(a, b, t) for a, b, t in
            [(out, ref_out, tol), (lse, ref_lse, TOL[torch.float32]),
             (dq, refs[0], tol), (dk, refs[1], tol), (dv, refs[2], tol)]]
    # Library yardstick: SDPA over K/V repeated to H heads beforehand
    # (not timed), and its autograd backward (dq, dk, dv of the repeated
    # heads, without the GQA sum).
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (_heads(x, H).contiguous().requires_grad_() for x in (k, v))
    dot = do.transpose(1, 2).contiguous()
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_fwd_ms = time_ms(lambda: lib(qt, kt, vt, is_causal=True), flush)
    lib_out = lib(qt, kt, vt, is_causal=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), flush)
    lq, lk, lv = torch.autograd.grad(lib_out, (qt, kt, vt), dot)
    g = H // n_kv

    def kv_sum(x):                # [B, H, T, hd] -> [B, T, Hkv, hd]
        return x.float().reshape(B, n_kv, g, T, hd).sum(2).transpose(1, 2)

    lib_errs = [max_err(lib_out.detach().transpose(1, 2), ref_out, tol)[0],
                max_err(lq.transpose(1, 2), refs[0], tol)[0],
                max(max_err(kv_sum(lk), refs[1], tol)[0],
                    max_err(kv_sum(lv), refs[2], tol)[0])]
    pairs = B * H * T * (T + 1) // 2          # visible (q, k) pairs
    e = 2                                     # bf16 bytes
    qb, kvb, lseb = B * T * H * hd * e, B * T * n_kv * hd * e, B * H * T * 4
    cases = [
        dict(kernel="flash_forward", max_abs_err=max(errs[0][0], errs[1][0]),
             lse_err=errs[1][0], ok=errs[0][1] and errs[1][1],
             ms=time_ms(lambda: launch_forward(q, k, v, True, True), flush),
             plain_ms=time_ms(lambda: flash_forward_reference(q, k, v, True),
                              flush),
             library_ms=lib_fwd_ms,
             **_bound(qb + 2 * kvb + qb + lseb, 2 * 2 * pairs * hd, dtype)),
        dict(kernel="flash_backward_dq", max_abs_err=errs[2][0],
             ok=errs[2][1],
             ms=time_ms(lambda: launch_backward_dq(q, k, v, out, lse, do,
                                                   True), flush),
             plain_ms=time_ms(lambda: flash_backward_reference(
                 q, k, v, out, lse, do, True), flush),
             library_ms=lib_bwd_ms,
             **_bound(3 * qb + 2 * kvb + lseb + qb + lseb,
                      3 * 2 * pairs * hd, dtype)),
        dict(kernel="flash_backward_dkv",
             max_abs_err=max(errs[3][0], errs[4][0]),
             ok=errs[3][1] and errs[4][1],
             ms=time_ms(lambda: launch_backward_dkv(q, k, v, lse, delta, do,
                                                    True), flush),
             library_ms=lib_bwd_ms,
             **_bound(2 * qb + 2 * kvb + 2 * lseb + 2 * kvb,
                      4 * 2 * pairs * hd, dtype)),
    ]
    # The plain backward computes dq, dk and dv in one call: it is the
    # plain version of K6 and of K7 alike.
    cases[2]["plain_ms"] = cases[1]["plain_ms"]
    for c, lib_err in zip(cases, lib_errs):
        c.update(case=name, int8=False, tol=tol, library_err=lib_err)
    return cases


def _device_kernels(prof) -> int:
    """CUDA kernels in a torch.profiler trace, memsets and copies apart."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("Memcpy", "Memset")))


def device_kernels(fn, calls: int = 10, attempts: int = 3) -> float:
    """The CUDA kernels one call of ``fn`` launches (after a warm-up): the
    most that ``attempts`` traces of ``calls`` calls each record, over
    ``calls``. A trace may drop some of a short kernel's device records
    (seen on the card), never add any, so the most is the count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        most = max(most, _device_kernels(prof))
    return most / calls


def _bound(nbytes: int, flops: int, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev, this_tree=True) -> list:
    """Phase 1. ``this_tree``: also hold K4's wrapper to one kernel and
    one allocation a call (False when timing another tree's kernels)."""
    flush = _L2Flush(dev)
    cases = []
    for int8 in (False, True):
        tag = "int8kv" if int8 else "bf16"
        cases.append(decode_case(f"serve-{tag}", 8, 16, 16, 64, 64, 32,
                                 int8, dev, flush))
        cases.append(decode_case(f"gqa128-{tag}", 8, 32, 8, 128, 64, 32,
                                 int8, dev, flush))
        cases.append(prefill_case(f"serve-{tag}", 8, 512, 8, 16, 16, 64, 64,
                                  int8, dev, flush))
        cases.append(prefill_case(f"gqa128-{tag}", 8, 512, 8, 32, 8, 128, 64,
                                  int8, dev, flush))
        # Phase 4's chunked run, its middle continuation chunk: tb 64 over
        # 512 resident rows (hb 8) in every padded row.
        cases.append(prefill_case(f"chunked-{tag}", 8, 64, 8, 16, 16, 64, 64,
                                  int8, dev, flush, hits=[512] * 8))
        cases.append(verify_case(f"serve-{tag}", 8, 5, 16, 16, 64, 64, 32,
                                 int8, dev, flush))
        cases.append(verify_case(f"gqa128-{tag}", 8, 5, 32, 8, 128, 64, 32,
                                 int8, dev, flush))
        cases.append(flash_decode_case(f"serve-{tag}", 8, 16, 16, 64, 2048,
                                       int8, True, dev, flush))
        cases.append(flash_decode_case(f"gqa128-{tag}", 8, 32, 8, 128, 2048,
                                       int8, True, dev, flush))
    cases.append(flash_decode_case("serve-bf16-lengths", 8, 16, 16, 64, 2048,
                                   False, False, dev, flush))
    cases += flash_cases("train-8b", 8, 2048, 32, 8, 128, dev, flush)
    cases += flash_cases("train-hd64", 4, 1024, 16, 16, 64, dev, flush)
    for c in cases:
        log(f"  {c['kernel']:24s} {c['case']:14s} max_abs_err "
            f"{c['max_abs_err']:.3e} (tol {c['tol']}"
            + (f"; lse {c['lse_err']:.1e}, tol {TOL[torch.float32]}"
               if "lse_err" in c else "") + f") ms {c['ms']:.4f} "
            f"plain {c['plain_ms']:.4f} sdpa {c['library_ms']:.4f} (err "
            f"{c['library_err']:.1e}) bound "
            f"{c['bound_ms']:.4f} ({c['bound_by']}) "
            + (f"[K3 at t = 1 {c['k3_t1_ms']:.4f} ms, err "
               f"{c['k3_t1_err']:.1e}] " if "k3_t1_ms" in c else "")
            + (f"[one call: {c['kernels_per_call']:g} kernel(s), "
               f"{c['allocations_per_call']} allocation(s)] "
               if "kernels_per_call" in c else "")
            + (f"[every row under the cursor "
               f"{c['bound_under_cursor_ms']:.4f}] "
               if "bound_under_cursor_ms" in c else "")
            + f"{c['flops'] / c['ms'] / 1e9:.1f} TFLOP/s, "
            f"{c['bound_ms'] / c['ms']:.1%} of bound "
            + f"{'ok' if c['ok'] else 'MISMATCH'}")
    bad = [c["kernel"] + ":" + c["case"] for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    heavy = [c["case"] for c in cases if "kernels_per_call" in c and (
        c["kernels_per_call"], c["allocations_per_call"]) != (1, 1)]
    if heavy and this_tree:
        raise SystemExit(f"K4's wrapper launched more than one kernel or "
                         f"allocated more than its output: {heavy}")
    sweep = chunked_prefill_sweep(dev, flush)
    log(f"  paged_prefill_attention, phase 4's chunked run: "
        f"{sweep['launches']} launches, {sweep['total_ms']:.4f} ms in all "
        f"(kernel alone); ms a launch by hit rows: "
        f"{json.dumps(sweep['launch_ms'])}")
    return cases


# -- phases 2 and 3: the engine ---------------------------------------------------

def per_request(max_new, n) -> list:
    return list(max_new) if np.ndim(max_new) else [max_new] * n


def drive(eng, prompts, max_new):
    """Submit ``prompts`` (``max_new`` one budget or one per request) and
    step the engine dry; returns the streams in submission order."""
    ids = [eng.submit(p, max_new=int(m))
           for p, m in zip(prompts, per_request(max_new, len(prompts)))]
    done = {}
    while eng.pending:
        done.update(eng.step())
    return [done[i] for i in ids]


def shared_prefix_traffic(rng, vocab, n, sys_len, uniq_len):
    system = list(rng.integers(0, vocab, sys_len))
    return [system + list(rng.integers(0, vocab, uniq_len))
            for _ in range(n)]


def phase_engine_vs_cpu(dev) -> dict:
    """Plain, speculative and chunked-prefill engines, each on the CPU and
    on the card, f32: identical streams and gauges; the card runs the
    kernels and never a plain version."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=256,
                      dtype=torch.float32, decode_attn="fused", remat=False)
    engines = {"plain": {}, "spec": dict(speculative=True, gamma=3),
               "chunked": dict(prefill_chunk_tokens=32)}
    out = {}
    for name, kw in engines.items():
        got = {}
        for where in ("cpu", dev):
            model = init_params(cfg, torch.Generator().manual_seed(0), where)
            eng = ContinuousBatcher(model, cfg, n_slots=4, max_len=128,
                                    chunk=4, prefill_bucket=16,
                                    kv_layout="paged", page_size=16,
                                    prefix_cache=True, device=where, **kw)
            rng = np.random.default_rng(0)
            da.reset_counters()
            streams = []
            for _ in range(2):          # the second wave hits the cache
                streams += drive(eng, shared_prefix_traffic(
                    rng, cfg.vocab, 4, 32, 9), 12)
            conv = shared_prefix_traffic(rng, cfg.vocab, 1, 32, 9)[0]
            streams += drive(eng, [conv], 8)
            streams += drive(eng, [conv + streams[-1] + [7, 8, 9]], 8)
            phrase = list(rng.integers(0, cfg.vocab, 6))
            streams += drive(eng, [phrase * 5, phrase * 3 + [1, 2]], 20)
            eng._alloc.assert_consistent()
            m = eng.pool_metrics()
            got[str(where)] = (streams, m["prefill_tokens_skipped"],
                               m.get("spec_accept_rate"),
                               m["prefill_chunks_total"], da.counters())
        cpu, gpu = got["cpu"], got[str(dev)]
        log(f"  {name}: cpu skipped {cpu[1]} accept {cpu[2]} chunks "
            f"{cpu[3]} counters {cpu[4]}")
        log(f"  {name}: gpu skipped {gpu[1]} accept {gpu[2]} chunks "
            f"{gpu[3]} counters {gpu[4]}")
        if gpu[:4] != cpu[:4]:
            raise SystemExit(f"{name} engine on the card diverges from the "
                             f"CPU engine:\n  gpu {gpu[:4]}\n  cpu {cpu[:4]}")
        c = gpu[4]
        need = ["paged_prefill_attention"] + (
            ["paged_verify_attention"] if name == "spec"
            else ["paged_decode_attention"])
        if not all(c[k] for k in need) or cpu[1] <= 0:
            raise SystemExit(f"{name} engine on the card missed {need} or "
                             f"the cache: {c}, skipped {gpu[1]}")
        if any(c[k] for k in PLAIN):
            raise SystemExit(f"{name} engine on the card called a plain "
                             f"version: {c}")
        if name == "spec" and not gpu[2]:
            raise SystemExit("speculative engine accepted nothing")
        out[name] = dict(streams=len(gpu[0]), tokens=sum(map(len, gpu[0])),
                         skipped=gpu[1], accept_rate=gpu[2], chunks=gpu[3])
    return out


def phase_contiguous_vs_cpu(dev) -> dict:
    """The contiguous path, on the CPU and on the card, f32: the
    shared-cursor engine (exact and int8 KV; through an FCFS stop and an
    epoch roll), ``generate`` and ``generate_speculative``. Streams must be
    identical; every plain-version call of the CPU run must be one kernel
    launch on the card (K4: layers x ticks; K3: layers x verifies), and
    the card must call no plain version."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import (
        ContinuousBatcher, generate, generate_speculative)
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=256,
                      dtype=torch.float32, decode_attn="fused", remat=False)
    requests = [(5, 9), (7, 33), (12, 5), (9, 9), (40, 6), (3, 1), (6, 13),
                (33, 5), (8, 8)]
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n, _ in requests]
    budgets = [m for _, m in requests]
    batch = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 9)))
    phrase = torch.from_numpy(np.tile(rng.integers(0, cfg.vocab, 6), 5)[None])
    launched = {"flash_decode_reference": "flash_decode_attention",
                "paged_verify_reference": "paged_verify_attention"}

    def engine(model, where, **kw):
        eng = ContinuousBatcher(model, cfg, n_slots=3, max_len=64, chunk=4,
                                prefill_bucket=16, kv_layout="contiguous",
                                device=where, **kw)
        streams = drive(eng, prompts, budgets)
        if not (eng.fcfs_stops and eng.epoch_rolls):
            raise SystemExit(f"the small contiguous traffic missed an FCFS "
                             f"stop or an epoch roll: {eng.fcfs_stops}, "
                             f"{eng.epoch_rolls}")
        return streams

    runs = {
        "engine": lambda m, w: engine(m, w),
        "engine-int8kv": lambda m, w: engine(m, w, kv_dtype="int8"),
        "generate": lambda m, w: generate(
            m, batch, cfg, max_new=12, max_len=64).tolist(),
        "generate_speculative": lambda m, w: generate_speculative(
            m, phrase, cfg, max_new=24, gamma=3, max_len=64).tolist(),
    }
    out = {}
    for name, fn in runs.items():
        got = []
        for where in ("cpu", dev):
            model = init_params(cfg, torch.Generator().manual_seed(0), where)
            da.reset_counters()
            streams = fn(model, where)
            got.append((streams, {k: v for k, v in da.counters().items()
                                  if v}))
        (cpu, cpu_c), (gpu, gpu_c) = got
        log(f"  {name}: cpu calls {cpu_c}, gpu launches {gpu_c}")
        if gpu != cpu:
            raise SystemExit(f"{name} on the card diverges from the CPU:\n"
                             f"  gpu {gpu}\n  cpu {cpu}")
        want = {launched[k]: v for k, v in cpu_c.items()}
        if gpu_c != want or not want:
            raise SystemExit(f"{name} on the card launched {gpu_c}, want "
                             f"{want} and no plain version")
        out[name] = dict(tokens=sum(map(len, gpu)), launches=gpu_c)
    want = cfg.n_layers * (12 - 1)
    if out["generate"]["launches"] != {"flash_decode_attention": want}:
        raise SystemExit(f"generate launched {out['generate']['launches']}, "
                         f"want K4 x {want} (layers x decoded tokens)")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    kw = dict(max_new=24, max_len=64)
    if generate_speculative(model, phrase, cfg, gamma=3, **kw).tolist() \
            != generate(model, phrase, cfg, **kw).tolist():
        raise SystemExit("generate_speculative diverges from generate (f32)")
    return out


class _DecodeTimer:
    """Times the engine's decode-chunk and verify dispatches on the host
    clock, synchronised at both ends, by wrapping the module functions the
    engine calls for the duration of a ``with`` block."""

    NAMES = ("_decode_chunk_paged_fn", "_verify_chunk_paged_fn",
             "_decode_chunk_fn")

    def __enter__(self):
        from k8s_gpu_scheduler_tpu_torch.models import serving

        self.seconds, self._mod = 0.0, serving
        self._orig = {n: getattr(serving, n) for n in self.NAMES}

        def wrap(orig):
            def timed(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = orig(*args, **kw)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t
                return out
            return timed

        for n, fn in self._orig.items():
            setattr(serving, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._mod, n, fn)


def serve_run(model, cfg, prompts, max_new, **kw):
    """One measured serving run on a fresh engine: (streams, stats).
    Decode tokens are every emitted token but each request's first (the
    prefill's); ``decode_tokens_per_s`` divides them by the time spent in
    decode-chunk or verify dispatches. ``kw`` overrides the engine's
    settings (8 slots, chunk = the largest max_new, prefill bucket 512,
    the paged layout, page 64 with the prefix cache on; the page settings
    only where ``kw`` keeps the paged layout)."""
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    paged = kw.get("kv_layout", "paged") == "paged"
    eng = ContinuousBatcher(model, cfg, device=model.device, **{
        **dict(n_slots=8, max_len=cfg.max_seq, chunk=int(np.max(max_new)),
               prefill_bucket=512),
        **(dict(kv_layout="paged", page_size=64, prefix_cache=True)
           if paged else {}), **kw})
    torch.cuda.synchronize()
    da.reset_counters()
    t0 = time.perf_counter()
    with _DecodeTimer() as dec:
        streams = drive(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = da.counters()
    metrics = eng.pop_request_metrics()
    ttft = sorted(m["ttft_s"] for m in metrics.values())
    n_tok = sum(map(len, streams))
    st = dict(
        requests=len(prompts), tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall, decode_s=dec.seconds,
        decode_tokens_per_s=(n_tok - len(prompts)) / dec.seconds,
        ttft_p50_ms=1e3 * ttft[len(ttft) // 2], launches=counts)
    if paged:
        pool = eng.pool_metrics()
        eng._alloc.assert_consistent()
        st.update({k: pool[k] for k in (
            "prefill_tokens_skipped", "prefill_chunks_total",
            "spec_accept_rate", "spec_tokens_per_dispatch",
            "spec_rewound_tokens_total") if k in pool})
        st["rungs"] = {f"{tb}x{hb}": n for (tb, hb), n in
                       sorted(eng.prefill_rungs.items())}
    else:
        st.update(epoch_rolls=eng.epoch_rolls, fcfs_stops=eng.fcfs_stops)
    return streams, st


def phase_full_width(dev, card) -> dict:
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)
    max_new = 64
    # Warm-up on other prompts (allocator growth, cuBLAS handles).
    serve_run(model, cfg, shared_prefix_traffic(rng, cfg.vocab, 8, 384, 128),
              max_new)
    prompts = shared_prefix_traffic(rng, cfg.vocab, 32, 384, 128)
    streams, st = serve_run(model, cfg, prompts, max_new)
    log(f"  [{card}] bf16: {json.dumps(st)}")
    c = st["launches"]
    if not (c["paged_decode_attention"] > 0
            and c["paged_prefill_attention"] > 0
            and st["prefill_tokens_skipped"] > 0):
        raise SystemExit(f"main path missed a kernel or the cache: {st}")
    if any(c[k] for k in PLAIN):
        raise SystemExit(f"main path called a plain version: {c}")
    if malformed(streams, max_new, cfg.vocab):
        raise SystemExit("malformed streams on the main path")
    again, st2 = serve_run(model, cfg, prompts, max_new)
    if again != streams:
        raise SystemExit("a second greedy run did not reproduce the streams")
    log(f"  [{card}] second greedy run reproduced {len(streams)} streams")
    qmodel = quantize_llama_params(model)
    del model
    q_prompts = prompts[:16]
    qs, qst = serve_run(qmodel, cfg, q_prompts, max_new, kv_dtype="int8")
    log(f"  [{card}] int8 weights + int8 KV: {json.dumps(qst)}")
    qc = qst["launches"]
    if not (qc["paged_decode_attention"] > 0
            and qc["paged_prefill_attention"] > 0) \
            or any(qc[k] for k in PLAIN):
        raise SystemExit(f"int8 pass missed a kernel: {qst}")
    if malformed(qs, max_new, cfg.vocab):
        raise SystemExit("malformed streams in the int8 pass")
    return dict(bf16=st, int8=qst)


def malformed(streams, max_new, vocab) -> bool:
    return any(len(s) != m or min(s) < 0 or max(s) >= vocab
               for s, m in zip(streams, per_request(max_new, len(streams))))


SPEC_ENGINE = dict(speculative=True, gamma=4, proposer="bigram",
                   prefill_bucket=128)


def repeated_phrases(rng, vocab, n, phrase_len=16, reps=8):
    """The speculative leg's traffic: each request a random phrase
    repeated, the regime where prompt lookup hits (code, boilerplate,
    templated text)."""
    return [list(rng.integers(0, vocab, phrase_len)) * reps
            for _ in range(n)]


def phase_speculative(dev, card) -> dict:
    """The speculative path at full width (phase 4)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(2)
    max_new = 64
    serve_run(model, cfg, repeated_phrases(rng, cfg.vocab, 8), 16,
              **SPEC_ENGINE)                     # warm-up, other prompts
    prompts = repeated_phrases(rng, cfg.vocab, 32)
    streams, st = serve_run(model, cfg, prompts, max_new, **SPEC_ENGINE)
    log(f"  [{card}] speculative bf16: {json.dumps(st)}")
    c = st["launches"]
    if not c["paged_verify_attention"]:
        raise SystemExit(f"the speculative path never launched K3: {c}")
    if any(c[k] for k in PLAIN):
        raise SystemExit(f"the speculative path called a plain version: "
                         f"{c}")
    if not st["spec_accept_rate"] > 0:
        raise SystemExit(f"the speculative path accepted nothing: {st}")
    if malformed(streams, max_new, cfg.vocab):
        raise SystemExit("malformed streams on the speculative path")
    _, off = serve_run(model, cfg, prompts, max_new, prefill_bucket=128,
                       chunk=8)
    log(f"  [{card}] speculation off (chunk 8): {json.dumps(off)}")
    sampled = []
    for _ in range(2):
        s_streams, s_st = serve_run(model, cfg, prompts, max_new,
                                    kv_dtype="int8", temperature=0.005,
                                    **SPEC_ENGINE)
        sampled.append(s_streams)
        log(f"  [{card}] int8 KV, temperature 0.005: {json.dumps(s_st)}")
        sc = s_st["launches"]
        if not sc["paged_verify_attention"] or any(sc[k] for k in PLAIN) \
                or malformed(s_streams, max_new, cfg.vocab):
            raise SystemExit(f"sampled speculative run failed: {s_st}")
    if sampled[0] != sampled[1]:
        raise SystemExit("the sampled speculative run did not replay")
    log(f"  [{card}] sampled replay identical over {len(prompts)} streams")
    long_prompts = [list(rng.integers(0, cfg.vocab, 1024)) for _ in range(8)]
    ch_streams, ch = serve_run(model, cfg, long_prompts, 16,
                               prefill_chunk_tokens=256, **SPEC_ENGINE)
    log(f"  [{card}] chunked prefill (256 tokens a step): {json.dumps(ch)}")
    cc = ch["launches"]
    if not (cc["paged_prefill_attention"] and cc["paged_verify_attention"]
            and ch["prefill_chunks_total"] > 0) or any(cc[k] for k in PLAIN) \
            or malformed(ch_streams, 16, cfg.vocab):
        raise SystemExit(f"chunked-prefill run failed: {ch}")
    return dict(spec=st, off=off, chunked=ch)


CONTIGUOUS_ENGINE = dict(kv_layout="contiguous", chunk=64)


def phase_contiguous_full_width(dev, card, profile_too) -> dict:
    """The contiguous path at full width (phase 7): the serve loop's
    traffic through the shared-cursor engine (K4), a mixed-length run that
    reaches an FCFS stop and an epoch roll, an int8 pass, then the
    single-sequence server steps (K4 at B = 1; K3 from
    ``generate_speculative``)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import (
        make_server_step, make_speculative_server_step)
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
    from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(3)
    max_new = 64

    def random_prompts(n, length=512):
        return [list(rng.integers(0, cfg.vocab, length)) for _ in range(n)]

    def check(label, streams, st, budgets, ticks):
        c = st["launches"]
        log(f"  [{card}] {label}: {json.dumps(st)}")
        only = {k: v for k, v in c.items() if v}
        if only != {"flash_decode_attention": cfg.n_layers * ticks}:
            raise SystemExit(f"{label}: launched {only}, want K4 x "
                             f"{cfg.n_layers} layers x {ticks} ticks and "
                             f"nothing else")
        if malformed(streams, budgets, cfg.vocab):
            raise SystemExit(f"{label}: malformed streams")

    serve_run(model, cfg, random_prompts(8), max_new, **CONTIGUOUS_ENGINE)
    prompts = random_prompts(32)
    # Eight requests admit at the epoch start, decode one 64-tick chunk
    # and drain together: 4 waves of 64 ticks.
    streams, st = serve_run(model, cfg, prompts, max_new,
                            **CONTIGUOUS_ENGINE)
    check("bf16, 32 x (512 + 64)", streams, st, max_new, 4 * 64)
    if profile_too:
        log("profile: where a contiguous serving run's device time goes")
        profiled(card, "contiguous decode", lambda: serve_run(
            model, cfg, prompts[:16], max_new, **CONTIGUOUS_ENGINE))
    # Budgets drawn from {64, 256}: slots drain apart, the cursor climbs
    # past S - 256 with requests still queued (an FCFS stop), the slots
    # drain and the epoch rolls. 64 requests finish inside one epoch; 80
    # do not.
    budgets = [int(b) for b in rng.choice([64, 256], 80)]
    mixed, mst = serve_run(model, cfg, random_prompts(80), budgets,
                           **CONTIGUOUS_ENGINE)
    ticks = mst["launches"]["flash_decode_attention"] // cfg.n_layers
    check("bf16, 80 x (512 + {64, 256})", mixed, mst, budgets, ticks)
    if ticks % 64 or not (mst["fcfs_stops"] and mst["epoch_rolls"]):
        raise SystemExit(f"the mixed run missed an FCFS stop or an epoch "
                         f"roll, or a chunk was cut: {mst}")
    log(f"  [{card}] mixed run: {mst['fcfs_stops']} FCFS stops, "
        f"{mst['epoch_rolls']} epoch rolls, {ticks} ticks")
    qmodel = quantize_llama_params(model)
    qs, qst = serve_run(qmodel, cfg, prompts[:16], max_new, kv_dtype="int8",
                        **CONTIGUOUS_ENGINE)
    check("int8 weights + int8 KV, 16 x (512 + 64)", qs, qst, max_new,
          2 * 64)
    del qmodel

    def timed(fn, *args):
        torch.cuda.synchronize()
        da.reset_counters()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out.tolist(), time.perf_counter() - t, {
            k: v for k, v in da.counters().items() if v}

    one = torch.as_tensor(np.asarray(random_prompts(1)), device=dev)
    step = make_server_step(cfg, None, max_new)
    step(model, one)                                         # warm-up
    toks, secs, c = timed(step, model, one)
    log(f"  [{card}] make_server_step B 1, 512 + 64: {secs * 1e3:.1f} ms, "
        f"{max_new / secs:.1f} tokens/s, launches {c}")
    if c != {"flash_decode_attention": cfg.n_layers * (max_new - 1)} \
            or malformed(toks, max_new, cfg.vocab):
        raise SystemExit(f"make_server_step: launches {c}")
    phrase = torch.as_tensor(np.asarray(repeated_phrases(
        np.random.default_rng(2), cfg.vocab, 1)), device=dev)
    spec_step = make_speculative_server_step(cfg, max_new, gamma=4)
    spec_step(model, phrase)                                 # warm-up
    spec, spec_s, sc = timed(spec_step, model, phrase)
    plain, plain_s, _ = timed(step, model, phrase)
    verifies = sc.get("paged_verify_attention", 0) // cfg.n_layers
    agree = next((i for i, (a, b) in enumerate(zip(spec[0], plain[0]))
                  if a != b), max_new)
    gs = dict(k3_launches=sc.get("paged_verify_attention", 0),
              verifies=verifies,
              tokens_per_verify=(max_new - 1) / max(verifies, 1),
              spec_ms=spec_s * 1e3, generate_ms=plain_s * 1e3,
              greedy_identical=spec == plain, agreeing_prefix=agree)
    log(f"  [{card}] generate_speculative B 1, 128 + 64, gamma 4: "
        f"{json.dumps(gs)}")
    if set(sc) != {"paged_verify_attention"} or not verifies \
            or sc["paged_verify_attention"] % cfg.n_layers \
            or malformed(spec, max_new, cfg.vocab):
        raise SystemExit(f"generate_speculative: launches {sc}")
    return dict(bf16=st, mixed=mst, int8=qst, generate_speculative=gs)


# -- phase 8: the serving lifecycle and the KV tier ------------------------------

def check_pools(eng) -> None:
    """The page allocator's partition and, on a tiered engine, the host
    tier's invariants; a breach raises and fails the run."""
    eng._alloc.assert_consistent()
    if eng._alloc.tier is not None:
        eng._alloc.tier.assert_consistent()


def lifecycle_waves(rng, vocab, n, sys_len, uniq_len):
    """Phase 8's waves: A shares a system prompt, B is unique prompts, C
    shares A's system prompt again, D repeats B (its pages by then
    demoted or forgotten)."""
    a = shared_prefix_traffic(rng, vocab, n, sys_len, uniq_len)
    b = [list(rng.integers(0, vocab, sys_len + uniq_len)) for _ in range(n)]
    c = [a[0][:sys_len] + list(rng.integers(0, vocab, uniq_len))
         for _ in range(n)]
    return a, b, c, b


def phase_lifecycle_vs_cpu(dev) -> dict:
    """(a) Phase 2's small f32 config: a card engine is drained in the
    middle of wave C, persisted through ``lifecycle.drain_to_checkpoint``,
    resumed with ``resume_or_fresh`` into a fresh card engine and run to
    the end; its streams must equal the CPU engine's undrained run with
    tiering off (plain, int8 KV, speculative, tiered). The resumed card
    engine must launch K2 and K1 (K3 speculative) and no plain version."""
    import tempfile

    from k8s_gpu_scheduler_tpu_torch.models import lifecycle
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=256,
                      dtype=torch.float32, decode_attn="fused", remat=False)
    # 17 pages: four requests in flight fill the pool, so wave B evicts
    # wave A's cached pages and wave C evicts B's.
    base = dict(n_slots=4, max_len=128, chunk=4, prefill_bucket=16,
                kv_layout="paged", page_size=16, prefix_cache=True,
                n_pages=17)
    kinds = {"plain": {}, "int8kv": dict(kv_dtype="int8"),
             "spec": dict(speculative=True, gamma=3),
             "tiered": dict(kv_tiering=True, dram_pages=24)}
    # Five requests a wave on four slots: the fifth of wave C, queued at
    # the drain, mounts the pages its wave's first finisher donated (K2).
    waves = lifecycle_waves(np.random.default_rng(0), cfg.vocab, 5, 32, 9)
    out = {}
    for name, kw in kinds.items():
        ref_kw = {k: v for k, v in kw.items()
                  if k not in ("kv_tiering", "dram_pages")}
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        ref_eng = ContinuousBatcher(model, cfg, device="cpu", **base,
                                    **ref_kw)
        ref = [s for w in waves for s in drive(ref_eng, w, 12)]
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)

        def make():
            return ContinuousBatcher(model, cfg, device=dev, **base, **kw)

        eng = make()
        got = drive(eng, waves[0], 12) + drive(eng, waves[1], 12)
        ids = [eng.submit(p, max_new=12) for p in waves[2]]
        done = dict(eng.step())
        with tempfile.TemporaryDirectory() as d:
            snap = lifecycle.drain_to_checkpoint(eng, d)
            check_pools(eng)
            eng, resumed = lifecycle.resume_or_fresh(make, d)
        check_pools(eng)
        da.reset_counters()
        while eng.pending:
            done.update(eng.step())
        got += [done[i] for i in ids] + drive(eng, waves[3], 12)
        check_pools(eng)
        c = da.counters()
        m = eng.pool_metrics()
        log(f"  {name}: resumed {resumed} requests, {len(snap.page_ids)} "
            f"pages, {len(snap.tier_keys)} tier pages; after: {c}, "
            f"promotions {m.get('page_promotions_total')}")
        if got != ref:
            raise SystemExit(f"{name}: card drain/persist/resume diverges "
                             f"from the CPU's undrained run:\n  gpu {got}\n"
                             f"  cpu {ref}")
        need = ["paged_prefill_attention", "paged_verify_attention"
                if kw.get("speculative") else "paged_decode_attention"]
        if not (resumed and all(c[k] for k in need)) \
                or any(c[k] for k in PLAIN):
            raise SystemExit(f"{name}: the resumed engine missed {need} or "
                             f"called a plain version: {c}")
        if kw.get("kv_tiering") and not (snap.tier_keys
                                         and m["page_promotions_total"]):
            raise SystemExit(f"tiered: the snapshot shipped no tier or the "
                             f"resumed engine promoted nothing: {m}")
        out[name] = dict(tokens=sum(map(len, got)), resumed=resumed,
                         pages=len(snap.page_ids),
                         tier_pages=len(snap.tier_keys))
    return out


def _synced_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def phase_drain_restore_full_width(dev, card) -> dict:
    """(b) Phase 3's engine and shared-prefix traffic in bf16, max_new 128
    (two steps a request at chunk 64, so a drain after one step catches
    every slot mid-stream): drained after one step and restored into an
    engine of another ``n_pages``, the streams must equal an uninterrupted
    run in this process; then the same with int8 KV."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(8)
    base = dict(n_slots=8, max_len=cfg.max_seq, chunk=64, prefill_bucket=512,
                kv_layout="paged", page_size=64, prefix_cache=True)
    max_new = 128
    out = {}
    for name, n, kw in (("bf16", 32, {}), ("int8kv", 16,
                                           dict(kv_dtype="int8"))):
        prompts = shared_prefix_traffic(rng, cfg.vocab, n, 384, 128)
        ref = drive(ContinuousBatcher(model, cfg, device=dev, **base, **kw),
                    prompts, max_new)
        eng = ContinuousBatcher(model, cfg, device=dev, **base, **kw)
        ids = [eng.submit(p, max_new=max_new) for p in prompts]
        done = dict(eng.step())
        snap, drain_ms = _synced_ms(eng.drain)
        check_pools(eng)
        # The default pool is 1 + 8 * 32 = 257 pages; restore into 160.
        fresh = ContinuousBatcher(model, cfg, device=dev, n_pages=160,
                                  **base, **kw)
        resumed, restore_ms = _synced_ms(lambda: fresh.restore(snap))
        check_pools(fresh)
        da.reset_counters()
        while fresh.pending:
            done.update(fresh.step())
        check_pools(fresh)
        c = da.counters()
        got = [done[i] for i in ids]
        st = dict(requests=n, in_flight=len(snap.slot_req),
                  queued=len(snap.queue), resumed=resumed,
                  pages_moved=len(snap.page_ids),
                  snapshot_bytes=snap.nbytes(), drain_ms=drain_ms,
                  restore_ms=restore_ms,
                  drain_duration_seconds=eng.pool_metrics()[
                      "drain_duration_seconds"],
                  restore_duration_seconds=fresh.pool_metrics()[
                      "restore_duration_seconds"], launches=c)
        log(f"  [{card}] {name}: {json.dumps(st)}")
        if got != ref:
            first = next(i for i, (a, b) in enumerate(zip(got, ref))
                         if a != b)
            raise SystemExit(f"{name}: drain/restore changed stream {first}"
                             f":\n  got {got[first]}\n  ref {ref[first]}")
        if not (snap.slot_req and c["paged_decode_attention"]
                and c["paged_prefill_attention"]) \
                or any(c[k] for k in PLAIN):
            raise SystemExit(f"{name}: the restore caught no slot in flight "
                             f"or missed K1/K2: {st}")
        out[name] = st
    return out


def _timed_method(eng, name, acc) -> None:
    """Wrap ``eng.<name>`` so each call adds its synchronised ms to
    ``acc[name]`` and one to ``acc[name + "_calls"]``."""
    orig = getattr(eng, name)

    def timed(*args, **kw):
        res, ms = _synced_ms(lambda: orig(*args, **kw))
        acc[name] = acc.get(name, 0.0) + ms
        acc[name + "_calls"] = acc.get(name + "_calls", 0) + 1
        return res

    setattr(eng, name, timed)


def phase_tiering_full_width(dev, card) -> dict:
    """(c) Tiering at the serve config, bf16, three waves of 8 requests of
    512 tokens (A on a 384-token system prompt, B unique, C on A's system
    prompt again), max_new 64, chunk 64, page 64: with ``kv_tiering=True,
    dram_pages=64`` and 73 pages (B evicts all of A's cached pages), with
    tiering off at 73 pages, and with the default 257-page pool that evicts
    nothing. The tiered run's streams must equal the large pool's (C reads
    A's promoted bytes through the same K2 and K1), and wave C's skipped
    prefill tokens equal the large pool's and exceed the untiered run's;
    the untiered run recomputes the prefix densely, so its first
    divergence from the large pool, if any, is printed."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    a, b, c, _ = lifecycle_waves(np.random.default_rng(9), cfg.vocab, 8,
                                 384, 128)
    base = dict(n_slots=8, max_len=cfg.max_seq, chunk=64, prefill_bucket=512,
                kv_layout="paged", page_size=64, prefix_cache=True)
    runs = {"tiered": dict(n_pages=73, kv_tiering=True, dram_pages=64),
            "untiered": dict(n_pages=73), "large": {}}
    out, streams = {}, {}
    for name, kw in runs.items():
        eng = ContinuousBatcher(model, cfg, device=dev, **base, **kw)
        acc: dict = {}
        if kw.get("kv_tiering"):
            _timed_method(eng, "_drain_demotions", acc)
            _timed_method(eng, "_scatter_pages", acc)
        da.reset_counters()
        got, skipped = [], []
        for wave in (a, b, c):
            before = eng.pool_metrics()["prefill_tokens_skipped"]
            got += drive(eng, wave, 64)
            check_pools(eng)
            skipped.append(eng.pool_metrics()["prefill_tokens_skipped"]
                           - before)
        counts = da.counters()
        m = eng.pool_metrics()
        streams[name] = got
        st = dict(skipped_by_wave=skipped,
                  k2_launches=counts["paged_prefill_attention"],
                  k1_launches=counts["paged_decode_attention"],
                  evictions=m.get("prefix_evictions"),
                  demotions=m.get("page_demotions_total"),
                  promotions=m.get("page_promotions_total"),
                  demote_ms=acc.get("_drain_demotions"),
                  demote_calls=acc.get("_drain_demotions_calls"),
                  promote_ms=acc.get("_scatter_pages"),
                  promote_calls=acc.get("_scatter_pages_calls"))
        log(f"  [{card}] {name}: {json.dumps(st)}")
        if any(counts[k] for k in PLAIN) or malformed(got, 64, cfg.vocab):
            raise SystemExit(f"{name}: a plain version ran or a stream is "
                             f"malformed: {counts}")
        out[name] = st
    if streams["tiered"] != streams["large"]:
        raise SystemExit("the tiered run's streams differ from the large "
                         "pool's")
    div = next((i for i, (x, y) in enumerate(zip(streams["untiered"],
                                                  streams["large"]))
                if x != y), None)
    where = "none" if div is None else (
        f"stream {div}, token "
        f"{next(j for j, (p, q) in enumerate(zip(streams['untiered'][div], streams['large'][div])) if p != q)}")
    log(f"  [{card}] untiered vs large pool, first divergence: {where}")
    out["untiered_first_divergence"] = where
    t, u, g = (out[k]["skipped_by_wave"][2]
               for k in ("tiered", "untiered", "large"))
    if not (t == g > u and out["tiered"]["promotions"]):
        raise SystemExit(f"wave C skipped {t} (tiered), {g} (large), {u} "
                         f"(untiered), promotions "
                         f"{out['tiered']['promotions']}")
    return out


# -- phase 9: observability ------------------------------------------------------

def obs_run(model, cfg, prompts, max_new, traced, **kw):
    """Phase 3's engine (``kw`` overrides) over ``prompts``: traced with an
    ``obs.Tracer`` and the default flight recorder, or untraced with none;
    nothing synchronises inside the run. Returns (streams, counters,
    engine, tracer, one pool_metrics() snapshot, wall s)."""
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.obs import Tracer
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    tr = Tracer() if traced else None
    eng = ContinuousBatcher(model, cfg, device=model.device, **{
        **dict(n_slots=8, max_len=cfg.max_seq, chunk=max_new,
               prefill_bucket=512, kv_layout="paged", page_size=64,
               prefix_cache=True), **kw,
        **(dict(tracer=tr) if traced else dict(flight_capacity=0))})
    torch.cuda.synchronize()
    da.reset_counters()
    t0 = time.perf_counter()
    streams = drive(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return streams, da.counters(), eng, tr, eng.pool_metrics(), wall


def check_traced(card, label, model, cfg, prompts, max_new, spans,
                 kernels, **kw) -> dict:
    """An untraced run and a traced run of the same traffic: equal streams
    and launches of ``kernels``, no plain version, no span dropped, the
    ``spans`` named, a Perfetto file that validates, and an exposition
    with every phase that ran. Prints the phases' host-time rollup."""
    from k8s_gpu_scheduler_tpu_torch.metrics import (
        PHASE_HISTOGRAM, Registry, export_serving_pool)
    from k8s_gpu_scheduler_tpu_torch.obs import (
        validate_perfetto, write_perfetto)

    off = obs_run(model, cfg, prompts, max_new, False, **kw)
    streams, counts, eng, tr, pool, wall = obs_run(
        model, cfg, prompts, max_new, True, **kw)
    launched = {k: counts[k] for k in kernels}
    if streams != off[0]:
        raise SystemExit(f"{label}: the traced streams differ from the "
                         f"untraced ones")
    if launched != {k: off[1][k] for k in kernels} \
            or not all(launched.values()) \
            or any(c[k] for c in (counts, off[1]) for k in PLAIN):
        raise SystemExit(f"{label}: traced launches {counts}, untraced "
                         f"{off[1]}")
    names = {s.name for s in tr.spans()}
    if tr.dropped or not spans <= names:
        raise SystemExit(f"{label}: {tr.dropped} spans dropped, spans "
                         f"{sorted(names)} lack {sorted(spans - names)}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        write_perfetto(tr.spans(), path)
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    problems = validate_perfetto(doc)
    if problems:
        raise SystemExit(f"{label}: the Perfetto document fails: "
                         f"{problems[:5]}")
    reg = Registry()
    export_serving_pool(reg, pool)
    text = reg.expose()
    ran = sorted({p for p, _ in pool.get("phase_durations", ())})
    missing = [p for p in ran
               if f'{PHASE_HISTOGRAM}_count{{phase="{p}"}}' not in text]
    if not ran or missing:
        raise SystemExit(f"{label}: the exposition lacks phases {missing} "
                         f"(ran {ran})")
    rollup: dict = {}
    for phase, sec in pool["phase_durations"]:
        n, ms = rollup.get(phase, (0, 0.0))
        rollup[phase] = (n + 1, ms + 1e3 * sec)
    for phase, (n, ms) in sorted(rollup.items(), key=lambda x: -x[1][1]):
        log(f"  [{card}] {label} {phase}: {n} spans, {ms:.3f} host ms, "
            f"{ms / n:.4f} ms a span")
    kinds: dict = {}
    for r in eng._flight.records():
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    st = dict(spans=len(tr), perfetto_events=len(doc["traceEvents"]),
              flight_records=kinds, launches=launched, wall_s=wall,
              untraced_wall_s=off[5],
              phases={p: dict(spans=n, host_ms=ms)
                      for p, (n, ms) in rollup.items()})
    log(f"  [{card}] {label}: {json.dumps(st)}")
    return st


def phase_observability(dev, card) -> dict:
    """Phase 9: phase 3's and phase 4's traffic traced against untraced
    (``check_traced``), then the instrumentation's cost on decode tokens/s
    and wall, three runs of each setting in turn."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.obs import Tracer

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)               # phase 3's prompts
    shared_prefix_traffic(rng, cfg.vocab, 8, 384, 128)
    prompts = shared_prefix_traffic(rng, cfg.vocab, 32, 384, 128)
    rng = np.random.default_rng(2)               # phase 4's prompts
    repeated_phrases(rng, cfg.vocab, 8)
    phrases = repeated_phrases(rng, cfg.vocab, 32)
    out = dict(paged=check_traced(
        card, "paged", model, cfg, prompts, 64,
        {"queue", "admit", "prefill", "decode_chunk", "reap"},
        ("paged_decode_attention", "paged_prefill_attention")))
    out["speculative"] = check_traced(
        card, "speculative", model, cfg, phrases, 64,
        {"queue", "admit", "prefill", "verify", "rewind", "reap"},
        ("paged_verify_attention",), **SPEC_ENGINE)
    settings = {"untraced, flight 0": lambda: dict(flight_capacity=0),
                "defaults (flight 256)": dict,
                "traced": lambda: dict(tracer=Tracer())}
    runs: dict = {name: [] for name in settings}
    for _ in range(3):
        for name, kw in settings.items():
            _, st = serve_run(model, cfg, prompts, 64, **kw())
            runs[name].append((st["decode_tokens_per_s"], st["wall_s"]))
    for name, rs in runs.items():
        log(f"  [{card}] overhead, {name}: decode tokens/s "
            f"{[round(r[0], 1) for r in rs]}, wall s "
            f"{[round(r[1], 4) for r in rs]}")
    out["overhead"] = runs
    return out


def profiled(card, label, fn) -> None:
    """Run ``fn`` (returning (streams, stats)) under torch.profiler and
    print the card's busy share of the wall time and its device time by
    kernel. The profiler slows the host, so the busy share is a lower
    bound on an unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, st = fn()
    rows = {}
    for e in prof.key_averages():
        # Kernel rows only: a CPU op's device time is the sum of the
        # kernels it launched, which have rows of their own, and a user
        # annotation (the optimizer's step) spans kernels counted already.
        if e.device_type == DeviceType.CPU or getattr(
                e, "is_user_annotation", False):
            continue
        if e.self_device_time_total > 0:
            rows[e.key] = (e.self_device_time_total / 1e3, e.count)
    busy = sum(ms for ms, _ in rows.values())
    wall = st["wall_s"] * 1e3
    log(f"  [{card}] {label} profiled: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} %), {json.dumps(st)}")
    for key, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:20]:
        log(f"    {ms:10.3f} ms {n:7d}x {100 * ms / busy:5.1f} %  {key[:100]}")


def phase_profile(dev, card) -> None:
    """``--profile``: 16 full-width bf16 requests (two waves) of the main
    path's traffic, then 16 of the speculative path's, each profiled."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(1)
    serve_run(model, cfg, shared_prefix_traffic(rng, cfg.vocab, 8, 384, 128),
              64)
    prompts = shared_prefix_traffic(rng, cfg.vocab, 16, 384, 128)
    profiled(card, "plain decode",
             lambda: serve_run(model, cfg, prompts, 64))
    serve_run(model, cfg, repeated_phrases(rng, cfg.vocab, 8), 16,
              **SPEC_ENGINE)
    phrases = repeated_phrases(rng, cfg.vocab, 16)
    profiled(card, "speculative",
             lambda: serve_run(model, cfg, phrases, 64, **SPEC_ENGINE))


class _Capture:
    """Keeps the arguments of the first call of the serving module's
    function ``name`` while a ``with`` block runs."""

    def __init__(self, name):
        self.name, self.call = name, None

    def __enter__(self):
        from k8s_gpu_scheduler_tpu_torch.models import serving

        self._mod, self._orig = serving, getattr(serving, self.name)

        def keep(*args, **kw):
            if self.call is None:
                self.call = (args, kw)
            return self._orig(*args, **kw)

        setattr(serving, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.name, self._orig)


def dispatch_launches(dev) -> dict:
    """The CUDA kernels that one paged decode dispatch launches per layer
    per tick, one verify dispatch per layer per verify and one contiguous
    decode dispatch per layer per tick (memsets and copies apart), at the
    serve config: the first dispatch of a short run (8 requests, chunk
    16), replayed alone under torch.profiler (its K/V writes land where
    they did). A layer-tick is one K1 or K4 launch, a layer-verify one K3
    launch."""
    from torch.profiler import ProfilerActivity, profile

    from k8s_gpu_scheduler_tpu_torch.models import serving
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(4)
    out = {}
    for label, name, attn, kw, prompts in (
            ("decode tick", "_decode_chunk_paged_fn", "paged_decode_attention",
             {}, shared_prefix_traffic(rng, cfg.vocab, 8, 384, 128)),
            ("verify", "_verify_chunk_paged_fn", "paged_verify_attention",
             SPEC_ENGINE, repeated_phrases(rng, cfg.vocab, 8)),
            ("contiguous decode tick", "_decode_chunk_fn",
             "flash_decode_attention", dict(kv_layout="contiguous"),
             [list(rng.integers(0, cfg.vocab, 512)) for _ in range(8)])):
        with _Capture(name) as cap:
            serve_run(model, cfg, prompts, 16, **kw)
        fn = getattr(serving, name)
        args, kwargs = cap.call
        fn(*args, **kwargs)                              # warm-up
        torch.cuda.synchronize()
        da.reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args, **kwargs)
            torch.cuda.synchronize()
        steps = da.counters()[attn]
        kernels = _device_kernels(prof)
        out[label] = dict(layer_steps=steps, kernels=kernels,
                          kernels_per_layer_step=kernels / max(steps, 1))
    return out


def phase_dispatch_launches(dev, parent) -> None:
    """``--profile``: kernels per layer per decode tick and per verify, for
    this tree and, with ``--parent DIR``, for the package in DIR."""
    log(f"  this tree: {json.dumps(dispatch_launches(dev))}")
    if parent is None:
        return
    import os

    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--launch-counts",
         "--package-root", os.path.abspath(parent)], capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"the parent tree's count failed:\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"  parent tree ({parent}): {proc.stdout.strip().splitlines()[-1]}")


# -- phases 5 and 6: training ------------------------------------------------------

TRAIN_STEPS = 5                 # timed full-width steps, after one warm-up


def train_setup(dev, cfg, B, T, seed=0):
    """A model from ``seed``, its AdamW(3e-4) train step, and one fixed
    batch {tokens, targets = tokens rolled by one} on ``dev``."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        init_params, make_optimizer, make_train_step)

    model = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    step = make_train_step(cfg, None, make_optimizer(model, 3e-4))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)))
    batch = {"tokens": tokens.to(dev),
             "targets": torch.roll(tokens, -1, dims=1).to(dev)}
    return model, step, batch


def phase_train_vs_cpu(dev) -> dict:
    """Three f32 AdamW steps with flash attention and remat, on the CPU
    (plain versions) and twice on the card (kernels)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters, reset_counters)

    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=128,
                      dtype=torch.float32, attn_impl="flash", remat=True)
    steps = 3

    def losses(where):
        model, step, batch = train_setup(where, cfg, 2, 128)
        return [float(step(model, batch)) for _ in range(steps)]

    cpu = losses("cpu")
    reset_counters()
    card = losses(dev)
    c = counters()
    again = losses(dev)
    log(f"  cpu losses {cpu}")
    log(f"  gpu losses {card}, replay {again}, counters {c}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    want = (2 * cfg.n_layers * steps, cfg.n_layers * steps,
            cfg.n_layers * steps)
    if rel > 1e-5:
        raise SystemExit(f"training on the card diverges from the CPU: "
                         f"{card} vs {cpu} (rel {rel:.2e})")
    if tuple(c[k] for k in FLASH) != want or any(c[k] for k in FLASH_PLAIN):
        raise SystemExit(f"card training launched {c}, want {want} and no "
                         f"plain version")
    if again != card:
        raise SystemExit(f"a second card run did not replay: {again}")
    return dict(cpu=cpu, gpu=card, max_rel_diff=rel, launches=c)


def phase_train_full_width(dev, card, profile_too, n_layers) -> dict:
    """The training main path at the llama3_8b widths, depth cut to
    ``n_layers``."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters, reset_counters)

    B, T = 8, 2048
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=n_layers,
                              attn_impl="flash")
    log(f"  cut: n_layers 32 -> {cfg.n_layers} (weights, gradients and "
        f"AdamW moments of 32 layers do not fit one 80 GB card; the default "
        f"4 keeps the peak far below the card's memory, PERF.md gives the "
        f"deepest that fits); widths, B {B} and T {T} as main()")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, step, batch = train_setup(dev, cfg, B, T)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  [{card}] {n_params} parameters, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    losses = [float(step(model, batch))]                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    step_s, pending = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pending.append(step(model, batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    c = counters()
    losses += [float(x) for x in pending]
    mean_s = sum(step_s) / len(step_s)
    tok_s = B * T / mean_s
    st = dict(B=B, T=T, n_layers=cfg.n_layers, n_params=n_params,
              losses=losses, step_ms=[1e3 * x for x in step_s],
              mean_step_ms=1e3 * mean_s, tokens_per_s=tok_s,
              mfu=tok_s * cfg.flops_per_token(T) / PEAK_FLOPS[torch.bfloat16],
              flops_per_token=cfg.flops_per_token(T),
              max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
              launches=c)
    log(f"  [{card}] {json.dumps(st)}")
    want = (2 * cfg.n_layers * TRAIN_STEPS, cfg.n_layers * TRAIN_STEPS,
            cfg.n_layers * TRAIN_STEPS)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"full-width training: losses {losses}")
    if tuple(c[k] for k in FLASH) != want or any(c[k] for k in FLASH_PLAIN):
        raise SystemExit(f"full-width training launched {c}, want {want} "
                         f"and no plain version")
    if profile_too:
        log("profile: where a full-width training step's device time goes")
        profiled(card, "train step", lambda: timed_step(step, model, batch))
    return st


def timed_step(step, model, batch):
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = step(model, batch)
    torch.cuda.synchronize()
    return loss, dict(wall_s=time.perf_counter() - t, loss=float(loss))


# -- main ---------------------------------------------------------------------------

def sass_counts(lib, opcode: str) -> dict:
    """{kernel: count of ``opcode`` instructions in its SASS} for the
    kernels of ``lib`` that have any, from ``cuobjdump -sass``; empty where
    the toolkit has no cuobjdump."""
    import shutil
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    if shutil.which("c++filt"):                    # readable kernel names
        sass = subprocess.run(["c++filt"], input=sass, capture_output=True,
                              text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
        elif name and f" {opcode}" in line:
            counts[name] = counts.get(name, 0) + 1
    return counts


def main() -> int:
    t_start = time.perf_counter()
    args = sys.argv[1:]

    def value(flag, default=None):
        return args[args.index(flag) + 1] if flag in args else default

    profile_too = "--profile" in args
    train_layers = int(value("--train-layers", 4))
    if "--package-root" in args:        # another tree's package (--parent)
        sys.path.insert(0, value("--package-root"))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from k8s_gpu_scheduler_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    if "--launch-counts" in args:
        print(json.dumps(dispatch_launches(dev)), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    card = smi.splitlines()[0]
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    log(f"phase 0: built {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    for r in _build.ptxas_report():
        log(f"  ptxas {r['registers']} regs, {r['smem_bytes']} B smem, "
            f"spill {r['spill_stores']}/{r['spill_loads']} B: {r['kernel']}")
    hmma = sass_counts(_build.library_path(), "HMMA")
    for name, n in hmma.items():
        log(f"  sass {n} HMMA: {name}")
    this_tree = "--package-root" not in args
    if hmma and this_tree:           # cuobjdump exists: every mma kernel
        for words in TENSOR_CORE_KERNELS:     # must use the tensor cores
            if not any(all(w in name for w in words) for name in hmma):
                raise SystemExit(f"no HMMA instruction in {words}")
    log("phase 1: kernels against their plain versions "
        "(atol = rtol = 2e-2 in bf16, 2e-5 for K5's f32 lse)")
    cases = phase_kernels(dev, this_tree)
    if "--kernels-only" in args:
        log(json.dumps({"card": card, "kernel_cases": cases}))
        return 0
    log("phase 2: engines on the card against the engines on the CPU "
        "(f32, TF32 off)")
    e2 = phase_engine_vs_cpu(dev)
    log(f"  identical greedy streams: {json.dumps(e2)}")
    log(f"  contiguous path, identical greedy streams: "
        f"{json.dumps(phase_contiguous_vs_cpu(dev))}")
    log("phase 3: full-width serve config, bf16")
    full = phase_full_width(dev, card)
    log("phase 4: full-width speculative path, bf16")
    spec = phase_speculative(dev, card)
    if profile_too:
        log("profile: where a serving run's device time goes")
        phase_profile(dev, card)
        log("profile: CUDA kernels a paged dispatch launches per layer per "
            "decode tick and per verify")
        phase_dispatch_launches(dev, value("--parent"))
    log("phase 5: training on the card against training on the CPU "
        "(f32, TF32 off)")
    log(f"  {json.dumps(phase_train_vs_cpu(dev))}")
    log(f"phase 6: full-width training path (llama3_8b widths, "
        f"{train_layers} layers), bf16")
    train = phase_train_full_width(dev, card, profile_too, train_layers)
    log("phase 7: full-width contiguous path, bf16")
    contig = phase_contiguous_full_width(dev, card, profile_too)
    log("phase 8: the serving lifecycle and the KV tier")
    log("  (a) drain, persist and resume on the card against the CPU's "
        "undrained run (f32, TF32 off)")
    log(f"  {json.dumps(phase_lifecycle_vs_cpu(dev))}")
    log("  (b) full-width drain and restore into another pool, bf16")
    phase_drain_restore_full_width(dev, card)
    log("  (c) full-width tiering: waves A, B, C, bf16")
    phase_tiering_full_width(dev, card)
    log("phase 9: observability at full width: traced against untraced, "
        "bf16")
    phase_observability(dev, card)
    # Each kernel's launches come from the run of the path that runs it:
    # K1 and K2 from phase 3's main path, K3 from phase 4's, K4 from phase
    # 7's serve-loop run, K5-K7 from phase 6's timed steps.
    launches = dict(full["bf16"]["launches"])
    launches["paged_verify_attention"] = \
        spec["spec"]["launches"]["paged_verify_attention"]
    launches["flash_decode_attention"] = \
        contig["bf16"]["launches"]["flash_decode_attention"]
    launches.update({k: train["launches"][k] for k in FLASH})
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        case = "train-8b" if name in FLASH else "serve-bf16"
        c = next(c for c in cases
                 if c["kernel"] == name and c["case"] == case)
        kernels.append(dict(
            name=name, route="cuda", source=CSRC + source, replaces=replaces,
            launches=launches[name], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"]))
    log(json.dumps({"card": card, "kernel_cases": cases}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
