#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (k8s_gpu_scheduler_tpu_torch).

    python3 chip_smoke.py [--profile]

Needs one CUDA card and the CUDA toolkit; exits non-zero without them. It
imports nothing of JAX. Phases, each of which fails the run on error:

0. build: compile the kernels from ``ops/csrc`` (nvcc) and print each
   kernel's registers, shared memory and spills, and the card's name and
   power limit (nvidia-smi).
1. kernels against their plain PyTorch versions on the card: K1
   (paged_decode_attention) and K2 (paged_prefill_attention) at the serve
   width (B 8, H = Hkv = 16, hd 64, page 64, 32 blocks, lengths up to
   2048; K2 with tb 512, hb 8) and at a GQA shape (H 32, Hkv 8, hd 128),
   each in bf16 and with an int8 KV pool. Max error against a stated
   tolerance; CUDA-event times of the kernel, the plain version and one
   library call (scaled_dot_product_attention over the gathered K/V, a
   yardstick the port never calls), beside the least time the card could
   take (bytes over 3.35 TB/s or operations over 989 TFLOP/s).
2. the engine on the card against the engine on the CPU: a small f32
   config; greedy streams and prefill_tokens_skipped must be identical.
3. the slice at full width: the serve config (d_model 1024, 8 layers, 16
   heads, vocab 32000) in bf16 with 8 slots, page 64, chunk 64 and
   prefill bucket 512, 32 requests of 512-token prompts sharing a
   384-token system prompt. Counters are zeroed just before and read just
   after: both kernels must have launched and neither plain version been
   called. A second greedy run must reproduce the streams. Then a shorter
   pass with int8 weights and an int8 KV pool.

``--profile`` adds a profiled serving run: the card's busy share and its
time by kernel.

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
SOURCE = "k8s_gpu_scheduler_tpu_torch/ops/csrc/paged_attention.cu"
REPLACES = {
    "paged_decode_attention":
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:497",
    "paged_prefill_attention":
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:999",
}


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
    for c in cases:
        log(f"  {c['kernel']:24s} {c['case']:14s} max_abs_err "
            f"{c['max_abs_err']:.3e} (tol {c['tol']}) ms {c['ms']:.4f} "
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
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=256,
                      dtype=torch.float32, decode_attn="fused", remat=False)
    got = {}
    for where in ("cpu", dev):
        model = init_params(cfg, torch.Generator().manual_seed(0), where)
        eng = ContinuousBatcher(model, cfg, n_slots=4, max_len=128, chunk=4,
                                prefill_bucket=16, page_size=16,
                                prefix_cache=True, device=where)
        rng = np.random.default_rng(0)
        da.reset_counters()
        streams = []
        for _ in range(2):              # the second wave hits the cache
            streams += drive(eng, shared_prefix_traffic(rng, cfg.vocab, 4,
                                                        32, 9), 12)
        conv = shared_prefix_traffic(rng, cfg.vocab, 1, 32, 9)[0]
        streams += drive(eng, [conv], 8)
        streams += drive(eng, [conv + streams[-1] + [7, 8, 9]], 8)
        eng._alloc.assert_consistent()
        got[str(where)] = (streams,
                           eng.pool_metrics()["prefill_tokens_skipped"],
                           da.counters())
    (cs, cskip, ccnt), (gs, gskip, gcnt) = got["cpu"], got[str(dev)]
    log(f"  cpu skipped {cskip} counters {ccnt}")
    log(f"  gpu skipped {gskip} counters {gcnt}")
    if gs != cs or gskip != cskip:
        raise SystemExit(f"engine on the card diverges from the CPU engine:"
                         f"\n  gpu {gs}\n  cpu {cs}")
    if not (gcnt["paged_decode_attention"] and gcnt["paged_prefill_attention"]
            and cskip > 0):
        raise SystemExit(f"card engine did not run both kernels on a "
                         f"prefix hit: {gcnt}, skipped {gskip}")
    if gcnt["paged_decode_reference"] or gcnt["dense_prefill_reference"]:
        raise SystemExit(f"card engine called a plain version: {gcnt}")
    return dict(streams=len(gs), tokens=sum(map(len, gs)), skipped=gskip)


class _DecodeTimer:
    """Times the engine's decode-chunk dispatches on the host clock,
    synchronised at both ends, by wrapping the module function the engine
    calls for the duration of a ``with`` block."""

    def __enter__(self):
        from k8s_gpu_scheduler_tpu_torch.models import serving

        self.seconds, self._mod = 0.0, serving
        self._orig = orig = serving._decode_chunk_paged_fn

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t
            return out

        serving._decode_chunk_paged_fn = timed
        return self

    def __exit__(self, *exc):
        self._mod._decode_chunk_paged_fn = self._orig


def serve_run(model, cfg, prompts, max_new, **kw):
    """One measured serving run on a fresh engine: (streams, stats).
    Decode tokens are every emitted token but each request's first (the
    prefill's); ``decode_tokens_per_s`` divides them by the time spent in
    decode-chunk dispatches."""
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    eng = ContinuousBatcher(model, cfg, n_slots=8, max_len=cfg.max_seq,
                            chunk=max_new, prefill_bucket=512, page_size=64,
                            prefix_cache=True, device=model.device, **kw)
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
    return streams, dict(
        requests=len(prompts), tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall, decode_s=dec.seconds,
        decode_tokens_per_s=(n_tok - len(prompts)) / dec.seconds,
        ttft_p50_ms=1e3 * ttft[len(ttft) // 2],
        prefill_tokens_skipped=pool["prefill_tokens_skipped"],
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
    if c["paged_decode_reference"] or c["dense_prefill_reference"]:
        raise SystemExit(f"main path called a plain version: {c}")
    if any(len(s) != max_new or min(s) < 0 or max(s) >= cfg.vocab
           for s in streams):
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
            or qc["paged_decode_reference"] or qc["dense_prefill_reference"]:
        raise SystemExit(f"int8 pass missed a kernel: {qst}")
    if any(len(s) != max_new or min(s) < 0 or max(s) >= cfg.vocab
           for s in qs):
        raise SystemExit("malformed streams in the int8 pass")
    return dict(bf16=st, int8=qst)


def phase_profile(dev, card) -> None:
    """``--profile``: 16 full-width bf16 requests (two waves) under
    torch.profiler; prints the card's busy share of the wall time and the
    device time by kernel. The profiler slows the host, so the busy share
    is a lower bound on an unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(1)
    serve_run(model, cfg, shared_prefix_traffic(rng, cfg.vocab, 8, 384, 128),
              64)
    prompts = shared_prefix_traffic(rng, cfg.vocab, 16, 384, 128)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, st = serve_run(model, cfg, prompts, 64)
    rows = {}
    for e in prof.key_averages():
        # Device-side rows only: a CPU op's device time is the sum of the
        # kernels it launched, which have rows of their own.
        if e.device_type == DeviceType.CPU:
            continue
        if e.self_device_time_total > 0:
            rows[e.key] = (e.self_device_time_total / 1e3, e.count)
    busy = sum(ms for ms, _ in rows.values())
    wall = st["wall_s"] * 1e3
    log(f"  [{card}] profiled: wall {wall:.3f} ms, device busy {busy:.3f} ms"
        f" ({100 * busy / wall:.1f} %), {json.dumps(st)}")
    for key, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:20]:
        log(f"    {ms:10.3f} ms {n:7d}x {100 * ms / busy:5.1f} %  {key[:100]}")


# -- main ---------------------------------------------------------------------------

def main() -> int:
    profile_too = "--profile" in sys.argv[1:]
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
        "(atol = rtol = 2e-2 in bf16)")
    cases = phase_kernels(dev)
    log("phase 2: engine on the card against the engine on the CPU "
        "(f32, TF32 off)")
    e2 = phase_engine_vs_cpu(dev)
    log(f"  identical greedy streams: {json.dumps(e2)}")
    log("phase 3: full-width serve config, bf16")
    full = phase_full_width(dev, card)
    launches = full["bf16"]["launches"]
    if profile_too:
        log("profile: where a serving run's device time goes")
        phase_profile(dev, card)
    kernels = []
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        c = next(c for c in cases
                 if c["kernel"] == name and c["case"] == "serve-bf16")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"]))
    log(json.dumps({"card": card, "kernel_cases": cases}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
