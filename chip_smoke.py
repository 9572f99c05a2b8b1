#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (k8s_gpu_scheduler_tpu_torch).

    python3 chip_smoke.py [--profile] [--train-layers N]

Needs one CUDA card and the CUDA toolkit; exits non-zero without them. It
imports nothing of JAX. Phases, each of which fails the run on error:

0. build: compile the kernels from ``ops/csrc`` (one nvcc per source, in
   parallel, linked into one library) and print each kernel's registers,
   shared memory and spills, and the card's name and power limit
   (nvidia-smi).
1. kernels against their plain PyTorch versions on the card: K1
   (paged_decode_attention), K2 (paged_prefill_attention) and K3
   (paged_verify_attention, window t = 5) at the serve width (B 8, H =
   Hkv = 16, hd 64, page 64, 32 blocks, lengths up to 2048; K2 with tb
   512, hb 8) and at a GQA shape (H 32, Hkv 8, hd 128), each in bf16 and
   with an int8 KV pool. Max error against a stated tolerance; CUDA-event
   times of the kernel, the plain version and one library call
   (scaled_dot_product_attention over the gathered K/V, a yardstick the
   port never calls), beside the least time the card could take (bytes
   over 3.35 TB/s or operations over 989 TFLOP/s). Then the flash
   attention kernels K5 (forward), K6 (dq) and K7 (dk, dv), causal, bf16,
   at train-8b (B 8, T 2048, H 32, Hkv 8, hd 128: the shapes phase 6
   gives them) and train-hd64 (B 4, T 1024, H = Hkv = 16, hd 64), K5's
   f32 lse held to the f32 tolerance (2e-5); the yardstick is
   scaled_dot_product_attention with is_causal (K5) and its autograd
   backward, which yields dq, dk and dv together (K6, K7).
2. the engine on the card against the engine on the CPU, a small f32
   config: plain, speculative (bigram, gamma 3) and chunked-prefill (2
   pages a step) engines; greedy streams, prefill_tokens_skipped and the
   accept counts must be identical, and the card must have run K2 and K3
   and no plain version.
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

``--profile`` adds profiled serving runs (plain decode and speculative)
and one profiled training step: the card's busy share and its time by
kernel. ``--train-layers N`` runs phase 6 at depth N instead of 4, to
measure how step time and peak memory grow with depth.

The line before the last is a JSON object listing every kernel with its
launches on the main path, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
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
        "paged_attention.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:497"),
    "paged_prefill_attention": (
        "paged_attention.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:999"),
    "paged_verify_attention": (
        "paged_attention.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:688"),
    "flash_forward": (
        "flash_attention.cu",
        "k8s_gpu_scheduler_tpu/ops/flash_attention.py:117"),
    "flash_backward_dq": (
        "flash_attention.cu",
        "k8s_gpu_scheduler_tpu/ops/flash_attention.py:159"),
    "flash_backward_dkv": (
        "flash_attention.cu",
        "k8s_gpu_scheduler_tpu/ops/flash_attention.py:209"),
}
PLAIN = ("paged_decode_reference", "dense_prefill_reference",
         "paged_verify_reference")
FLASH = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
FLASH_PLAIN = ("flash_forward_reference", "flash_backward_reference")


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
    live = int(lens.sum())
    eb = 1 if int8 else 2
    nbytes = (B * H * hd * 2 * 2 + B * n_blocks * 4 + B * 4
              + live * n_kv * hd * eb * 2 + (live * n_kv * 4 * 2 if int8
                                             else 0))
    flops = 4 * live * H * hd
    return dict(case=name, kernel="paged_decode_attention", int8=int8,
                max_abs_err=err, tol=TOL[dtype], ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                **_bound(nbytes, flops, dtype))


def prefill_case(name, M, tb, hb, H, n_kv, hd, ps, int8, dev, flush,
                 seed=1):
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
    # Ragged page-aligned hits: the main path's 6 pages, full, half, none.
    choices = [6 * ps, hb * ps, (hb // 2) * ps, 0]
    hits = torch.tensor([choices[i % 4] for i in range(M)],
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


def _bound(nbytes: int, flops: int, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev) -> list:
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
        cases.append(verify_case(f"serve-{tag}", 8, 5, 16, 16, 64, 64, 32,
                                 int8, dev, flush))
        cases.append(verify_case(f"gqa128-{tag}", 8, 5, 32, 8, 128, 64, 32,
                                 int8, dev, flush))
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
            f"{'ok' if c['ok'] else 'MISMATCH'}")
    bad = [c["kernel"] + ":" + c["case"] for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return cases


# -- phases 2 and 3: the engine ---------------------------------------------------

def drive(eng, prompts, max_new):
    """Submit ``prompts`` and step the engine dry; returns the streams in
    submission order."""
    ids = [eng.submit(p, max_new=max_new) for p in prompts]
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
                                    chunk=4, prefill_bucket=16, page_size=16,
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


class _DecodeTimer:
    """Times the engine's decode-chunk and verify dispatches on the host
    clock, synchronised at both ends, by wrapping the module functions the
    engine calls for the duration of a ``with`` block."""

    NAMES = ("_decode_chunk_paged_fn", "_verify_chunk_paged_fn")

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
    settings (8 slots, chunk = max_new, prefill bucket 512, page 64,
    prefix cache on)."""
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    eng = ContinuousBatcher(model, cfg, device=model.device, **{
        **dict(n_slots=8, max_len=cfg.max_seq, chunk=max_new,
               prefill_bucket=512, page_size=64, prefix_cache=True), **kw})
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
    pool = eng.pool_metrics()
    eng._alloc.assert_consistent()
    n_tok = sum(map(len, streams))
    spec = {k: pool[k] for k in ("spec_accept_rate",
                                 "spec_tokens_per_dispatch",
                                 "spec_rewound_tokens_total") if k in pool}
    return streams, dict(
        requests=len(prompts), tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall, decode_s=dec.seconds,
        decode_tokens_per_s=(n_tok - len(prompts)) / dec.seconds,
        ttft_p50_ms=1e3 * ttft[len(ttft) // 2],
        prefill_tokens_skipped=pool["prefill_tokens_skipped"],
        prefill_chunks_total=pool["prefill_chunks_total"], **spec,
        rungs={f"{tb}x{hb}": n for (tb, hb), n in
               sorted(eng.prefill_rungs.items())},
        launches=counts)


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
    return any(len(s) != max_new or min(s) < 0 or max(s) >= vocab
               for s in streams)


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
        raise SystemExit(f"the speculative path called a plain version: {c}")
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

def main() -> int:
    t_start = time.perf_counter()
    args = sys.argv[1:]
    profile_too = "--profile" in args
    train_layers = (int(args[args.index("--train-layers") + 1])
                    if "--train-layers" in args else 4)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from k8s_gpu_scheduler_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
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
    log("phase 1: kernels against their plain versions "
        "(atol = rtol = 2e-2 in bf16, 2e-5 for K5's f32 lse)")
    cases = phase_kernels(dev)
    log("phase 2: engines on the card against the engines on the CPU "
        "(f32, TF32 off)")
    e2 = phase_engine_vs_cpu(dev)
    log(f"  identical greedy streams: {json.dumps(e2)}")
    log("phase 3: full-width serve config, bf16")
    full = phase_full_width(dev, card)
    log("phase 4: full-width speculative path, bf16")
    spec = phase_speculative(dev, card)
    if profile_too:
        log("profile: where a serving run's device time goes")
        phase_profile(dev, card)
    log("phase 5: training on the card against training on the CPU "
        "(f32, TF32 off)")
    log(f"  {json.dumps(phase_train_vs_cpu(dev))}")
    log(f"phase 6: full-width training path (llama3_8b widths, "
        f"{train_layers} layers), bf16")
    train = phase_train_full_width(dev, card, profile_too, train_layers)
    # Each kernel's launches come from the run of the path that runs it:
    # K1 and K2 from phase 3's main path, K3 from phase 4's, K5-K7 from
    # phase 6's timed steps.
    launches = dict(full["bf16"]["launches"])
    launches["paged_verify_attention"] = \
        spec["spec"]["launches"]["paged_verify_attention"]
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
