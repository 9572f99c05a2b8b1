"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``gpu`` marker and skips without a CUDA
device: the kernels have no CPU mode. The card's machine has no JAX, so
this file imports only torch and the port, and runs there without the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 at f32 (the kernel and the plain version sum in other
orders), 2e-2 at bf16 (the plain versions round at other places: the
prefill reference rounds its normalised probabilities to bf16 before the
PV product, the tensor-core kernels K2, K3 and K5 their unnormalised ones;
``tests/test_torch_paged_attention.py``,
``tests/test_torch_verify_attention.py`` and
``tests/test_torch_flash_attention.py`` show on the CPU that this
rounding stays inside 2e-2). A row with
length 0 is compared against zeros: the plain version's softmax over a
fully masked row is uniform garbage by contract. The flash kernels'
gradients are held to 1e-4 at f32: each sums up to T*g products, in
another order than the plain version's einsums; and to 2e-2 at bf16,
where the tensor-core backward also rounds P and dS to bf16 once before
its second products (``tests/test_torch_flash_attention.py`` shows on
the CPU that this rounding stays inside 2e-2)."""
import dataclasses

import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu_torch.models.llama import (
    LlamaConfig, init_params, make_optimizer, make_train_step)
from k8s_gpu_scheduler_tpu_torch.models.serving import (
    ContinuousBatcher, _kv_quant, generate, generate_speculative)
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
    counters, flash_backward, flash_backward_reference, flash_forward,
    flash_forward_reference, reset_counters)
from k8s_gpu_scheduler_tpu_torch.parallel import spawn
from torch_gang_workers import (
    CARD_CELL, PLAN_CELL, card_gang_world, serve_config)
from torch_tp_workers import card_world
from torch_train_workers import (
    card_ep_world, card_pp_world, card_restore_world, card_train_world)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])
QUANT = pytest.mark.parametrize("quant", [False, True],
                                ids=["exact", "int8"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool(gen, n_pages, ps, n_kv, hd, dtype, quant, dev):
    kv = [torch.randn((n_pages, ps, n_kv, hd), generator=gen).to(dtype)
          for _ in range(2)]
    if not quant:
        return kv[0].to(dev), kv[1].to(dev), {}
    (kq, ks), (vq, vs) = (_kv_quant(x) for x in kv)
    return kq.to(dev), vq.to(dev), dict(k_scale=ks.to(dev),
                                        v_scale=vs.to(dev))


def _close(got, ref, dtype):
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _lengths(B, pattern, dev):
    """[B] int32 committed lengths: ``pattern`` repeated to B slots."""
    return torch.tensor([pattern[i % len(pattern)] for i in range(B)],
                        dtype=torch.int32, device=dev)


# (hd, n_heads, n_kv, ps, n_blocks, B) -> the split count (one cluster of
# that many blocks a slot and kv head) that paged_plan gives: 1, 3, 5 and 8
# among them, B = 1 too.
DECODE_SHAPES = {
    "serve": ((64, 16, 16, 64, 32, 5), 4),
    "gqa4-hd128": ((128, 32, 8, 16, 12, 5), 7),
    "g8-ps8": ((64, 8, 1, 8, 5, 5), 5),
    "g2-ps256": ((128, 4, 2, 256, 2, 5), 2),
    "serve-b8-ns3": ((64, 16, 16, 64, 32, 8), 3),
    "ns5": ((64, 24, 12, 16, 12, 5), 5),
    "b1-ns8": ((64, 16, 16, 64, 32, 1), 8),
    "ns1": ((128, 8, 2, 64, 1, 5), 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ns", list(DECODE_SHAPES.values()),
                         ids=list(DECODE_SHAPES))
@DTYPES
@QUANT
def test_decode_kernel_matches_plain(cuda, shape, ns, dtype, quant):
    """K1 against its plain version at split counts 1 to 8 (each one
    cluster), B = 1, lengths 0, 1 and the full table: the kernel merges its
    splits itself and writes [B, H, hd] in q's dtype."""
    hd, n_heads, n_kv, ps, n_blocks, B = shape
    assert da.paged_plan(n_blocks, ps, B, n_kv) == ns
    gen = torch.Generator().manual_seed(hd + n_heads + ps)
    n_pages = 1 + B * n_blocks
    q = torch.randn((B, n_heads, hd), generator=gen).to(dtype).to(cuda)
    kp, vp, sc = _pool(gen, n_pages, ps, n_kv, hd, dtype, quant, cuda)
    table = (torch.randperm(n_pages - 1, generator=gen)[:B * n_blocks] + 1) \
        .reshape(B, n_blocks).to(torch.int32).to(cuda)
    S = n_blocks * ps
    lens = _lengths(B, [S, 1, 0, S // 2 + 3, min(ps + 1, S)], cuda)
    n0 = da.paged_decode_reference.calls
    launches = da.paged_decode_attention.launches
    got = da.paged_decode_attention(q, kp, vp, table, lens, **sc)
    assert da.paged_decode_attention.launches == launches + 1
    assert da.paged_decode_reference.calls == n0
    ref = da.paged_decode_reference(q, kp, vp, table, lens, **sc)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    live = lens > 0
    _close(got[live], ref[live], dtype)
    assert not got[~live].any()


@pytest.mark.gpu
@pytest.mark.parametrize("hd,n_heads,n_kv,ps,tb,hb,hits", [
    (64, 16, 16, 64, 128, 4, None), (128, 32, 8, 16, 48, 3, None),
    (64, 8, 1, 8, 8, 2, None), (64, 4, 2, 32, 64, 0, None),
    (64, 16, 16, 64, 512, 8, None), (128, 8, 2, 8, 64, 12, (90, 57, 0, 96)),
    (64, 8, 4, 16, 48, 8, None)],
    ids=["serve", "gqa4-hd128", "g8-ps8", "hb0", "serve-tb512",
         "hit-not-64", "ps16-chunk-spans-pages"])
@DTYPES
@QUANT
def test_prefill_kernel_matches_plain(cuda, hd, n_heads, n_kv, ps, tb, hb,
                                      hits, dtype, quant):
    """K2 against its plain version: bf16 q on the tensor cores (64-row
    K/V chunks read page by page through the table, so a chunk may span
    several pages or end inside one), f32 q on the CUDA cores; the serve
    shape (tb 512, hb 8, page 64), hits that are not multiples of the
    64-row chunk, and pages of 16 rows under 64-row chunks."""
    gen = torch.Generator().manual_seed(hd + tb + hb)
    M = 4
    n_pages = 1 + M * max(hb, 1)
    q = torch.randn((M, tb, n_heads, hd), generator=gen).to(dtype).to(cuda)
    tk = torch.randn((M, tb, n_kv, hd), generator=gen).to(dtype).to(cuda)
    tv = torch.randn((M, tb, n_kv, hd), generator=gen).to(dtype).to(cuda)
    kp, vp, sc = _pool(gen, n_pages, ps, n_kv, hd, dtype, quant, cuda)
    table = (torch.randperm(n_pages - 1, generator=gen)[:M * hb] + 1) \
        .reshape(M, hb).to(torch.int32).to(cuda)
    # Ragged page-aligned hits by default: full, half, none, one page.
    hits = torch.tensor(hits or [hb * ps, (hb // 2) * ps, 0, min(hb, 1) * ps],
                        dtype=torch.int32, device=cuda)
    args = (q, kp, vp, table, hits, tk, tv)
    n0 = da.dense_prefill_reference.calls
    got = da.paged_prefill_attention(*args, **sc)
    assert da.dense_prefill_reference.calls == n0
    ref = da.dense_prefill_reference(*args, **sc)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref, dtype)


# (hd, n_heads, n_kv, ps, n_blocks, t, B) -> the split count paged_plan
# gives at bf16 (64-row groups; f32 tiles 32 rows, so a stack over 32 rows
# may plan fewer splits there).
VERIFY_SHAPES = {
    "serve": ((64, 16, 16, 64, 32, 5, 5), 4),
    "gqa4-hd128": ((128, 32, 8, 16, 12, 5, 5), 7),
    "g8-ps8": ((64, 8, 1, 8, 5, 3, 5), 5),
    "g2-t1": ((128, 4, 2, 256, 2, 1, 5), 2),
    "g8-two-tiles": ((64, 16, 2, 32, 6, 6, 5), 6),
    "serve-b8-ns3": ((64, 16, 16, 64, 32, 5, 8), 3),
    "ns5": ((64, 24, 12, 16, 12, 5, 5), 5),
    "b1-ns8": ((64, 16, 16, 64, 32, 5, 1), 8),
    "ns1": ((128, 8, 2, 64, 1, 5, 5), 1),
    "g8-t10-two-groups": ((128, 16, 2, 16, 12, 10, 3), 8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ns", list(VERIFY_SHAPES.values()),
                         ids=list(VERIFY_SHAPES))
@DTYPES
@QUANT
def test_verify_kernel_matches_plain(cuda, shape, ns, dtype, quant):
    """K3 against its plain version: ragged committed lengths (0, 1, a
    full table less the window, mid-page), stale rows above every bound,
    split counts 1 to 8 (each one cluster), B = 1, stacks of one to four
    16-row tiles (t*g 1 to 48) and of two 64-row groups (t*g = 80); bf16
    runs on the tensor cores, f32 on the CUDA cores."""
    hd, n_heads, n_kv, ps, n_blocks, t, B = shape
    g = n_heads // n_kv
    assert da.verify_plan(n_blocks, ps, t, B * -(-t * g // 64), n_kv) == ns
    gen = torch.Generator().manual_seed(hd + n_heads + ps + t)
    n_pages = 1 + B * n_blocks
    q = torch.randn((B, t, n_heads, hd), generator=gen).to(dtype).to(cuda)
    kp, vp, sc = _pool(gen, n_pages, ps, n_kv, hd, dtype, quant, cuda)
    table = (torch.randperm(n_pages - 1, generator=gen)[:B * n_blocks] + 1) \
        .reshape(B, n_blocks).to(torch.int32).to(cuda)
    S = n_blocks * ps
    lens = _lengths(B, [S - t, 0, S // 2 + 3, 1, min(ps + 1, S - t)], cuda)
    n0 = da.paged_verify_reference.calls
    launches = da.paged_verify_attention.launches
    got = da.paged_verify_attention(q, kp, vp, table, lens, **sc)
    assert da.paged_verify_attention.launches == launches + 1
    assert da.paged_verify_reference.calls == n0
    ref = da.paged_verify_reference(q, kp, vp, table, lens, **sc)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref, dtype)


@pytest.mark.gpu
@DTYPES
def test_verify_rows_equal_decode_kernel(cuda, dtype):
    """Window row i of K3 is K1 at lengths + i + 1 (f32; bf16, where K3
    runs on the tensor cores, at the bf16 tolerance)."""
    gen = torch.Generator().manual_seed(7)
    B, t, H, n_kv, hd, ps, nb = 4, 4, 8, 2, 64, 16, 8
    q = torch.randn((B, t, H, hd), generator=gen).to(dtype).to(cuda)
    kp, vp, _ = _pool(gen, 1 + B * nb, ps, n_kv, hd, dtype, False, cuda)
    table = (torch.randperm(B * nb, generator=gen) + 1).reshape(B, nb) \
        .to(torch.int32).to(cuda)
    lens = torch.tensor([0, 9, 60, 124], dtype=torch.int32, device=cuda)
    got = da.paged_verify_attention(q, kp, vp, table, lens)
    for i in range(t):
        one = da.paged_decode_attention(q[:, i].contiguous(), kp, vp, table,
                                        lens + i + 1)
        _close(got[:, i], one, dtype)


@pytest.mark.gpu
@DTYPES
@QUANT
def test_decode_and_verify_kernels_are_deterministic(cuda, dtype, quant):
    """K1 and K3 merge their splits across the cluster in a fixed order
    and with no atomics: two launches on the same inputs give the same
    bits."""
    gen = torch.Generator().manual_seed(3)
    B, t, H, n_kv, hd, ps, nb = 3, 5, 32, 8, 128, 16, 24
    q = torch.randn((B, t, H, hd), generator=gen).to(dtype).to(cuda)
    kp, vp, sc = _pool(gen, 1 + B * nb, ps, n_kv, hd, dtype, quant, cuda)
    table = (torch.randperm(B * nb, generator=gen) + 1).reshape(B, nb) \
        .to(torch.int32).to(cuda)
    lens = torch.tensor([370, 0, 201], dtype=torch.int32, device=cuda)
    assert da.paged_plan(nb, ps, B, n_kv) > 1          # splits to merge
    for fn, qq in ((da.paged_decode_attention, q[:, 0].contiguous()),
                   (da.paged_verify_attention, q)):
        a = fn(qq, kp, vp, table, lens, **sc)
        b = fn(qq, kp, vp, table, lens, **sc)
        assert torch.equal(a, b), fn.__name__


@pytest.mark.gpu
def test_kernel_contract_raises_on_card(cuda):
    """What the kernels do not take raises before any launch; nothing
    falls back to the plain version."""
    gen = torch.Generator().manual_seed(0)
    table = torch.ones((2, 2), dtype=torch.int32, device=cuda)
    lens = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    calls = da.paged_decode_reference.calls
    for H, n_kv, hd, dtype in [(4, 4, 32, torch.float32),
                               (6, 2, 64, torch.float32),
                               (4, 4, 64, torch.float16)]:
        q = torch.randn((2, H, hd), generator=gen).to(dtype).to(cuda)
        kv = torch.randn((3, 8, n_kv, hd), generator=gen).to(dtype).to(cuda)
        with pytest.raises(ValueError):
            da.paged_decode_attention(q, kv, kv, table, lens)
    assert da.paged_decode_reference.calls == calls


@pytest.mark.gpu
@pytest.mark.parametrize("hd,n_heads,n_kv,S", [
    (64, 16, 16, 2048), (128, 32, 8, 1000), (64, 8, 1, 77), (128, 4, 2, 300),
    (64, 4, 4, 5)], ids=["serve", "gqa4-hd128-S1000", "g8-S77", "g2-S300",
                         "g1-S5"])
@pytest.mark.parametrize("bitmap", [False, True], ids=["lengths", "bitmap"])
@DTYPES
@QUANT
def test_flash_decode_kernel_matches_plain(cuda, hd, n_heads, n_kv, S, bitmap,
                                           dtype, quant):
    """K4 against its plain version: ragged lengths (0, 1, S, mid), an S
    no power of two divides, and a bitmap with holes, a long all-zero
    stretch and one slot with no set bit (zeros on both sides)."""
    gen = torch.Generator().manual_seed(hd + n_heads + S)
    B = 5
    q = torch.randn((B, n_heads, hd), generator=gen).to(dtype).to(cuda)
    k, v, sc = _pool(gen, B, S, n_kv, hd, dtype, quant, cuda)
    lens = torch.tensor([S, 1, 0, S // 2 + 3, min(70, S)], dtype=torch.int32,
                        device=cuda)
    bm = None
    if bitmap:
        bm = torch.rand((B, S), generator=gen) < 0.6
        bm[0, : S // 2] = False              # whole warp steps unset
        bm[0, S - 1] = True
        bm[3, :] = False                     # an empty slot
        bm[4, 0] = True
        bm = bm.to(cuda)
    n0 = da.flash_decode_reference.calls
    launches = da.flash_decode_attention.launches
    got = da.flash_decode_attention(q, k, v, lens, bitmap=bm, **sc)
    assert da.flash_decode_attention.launches == launches + 1
    assert da.flash_decode_reference.calls == n0
    ref = da.flash_decode_reference(q, k, v, lens, bitmap=bm, **sc)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref, dtype)
    assert not got[2].any()
    if bitmap:
        assert not got[3].any()
    assert torch.equal(got, da.flash_decode_attention(q, k, v, lens,
                                                      bitmap=bm, **sc))


# (hd, n_heads, n_kv, S, B) -> the split count flash_decode_plan gives at a
# cursor of S rows (one cluster of that many blocks a slot and kv head):
# 1, 3, 5 and 8, B = 1 too.
FLASH_DECODE_SHAPES = {
    "serve-ns3": ((64, 16, 16, 2048, 8), 3),
    "b1-ns8": ((64, 16, 16, 2048, 1), 8),
    "gqa4-b1-ns5": ((128, 32, 8, 320, 1), 5),
    "gqa4-ns1": ((128, 32, 8, 64, 8), 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ns", list(FLASH_DECODE_SHAPES.values()),
                         ids=list(FLASH_DECODE_SHAPES))
@DTYPES
@QUANT
def test_flash_decode_splits_merge_in_kernel(cuda, shape, ns, dtype, quant):
    """K4 at split counts 1 to 8 (each one cluster, merged in the kernel):
    the engine's call (the cursor as an int, the bitmap) with a window at
    the end of the length, one at its start, a slot with no set bit and
    one with holes; then [B] lengths with 0 and 1 and no bitmap. Each call
    launches once, allocates only its output, and replays bit for bit."""
    hd, n_heads, n_kv, S, B = shape
    assert da.flash_decode_plan(S, B, n_kv) == ns
    gen = torch.Generator().manual_seed(hd + n_heads + S + B)
    q = torch.randn((B, n_heads, hd), generator=gen).to(dtype).to(cuda)
    k, v, sc = _pool(gen, B, S, n_kv, hd, dtype, quant, cuda)
    w = max(S // 4, 1)
    bm = torch.rand((B, S), generator=gen) < 0.5
    bm[0] = False
    bm[0, S - w:] = True                     # the window ending at the cursor
    if B > 1:
        bm[1] = False
        bm[1, :w] = True                     # a window at the start
        bm[2] = False                        # no set bit
    bm = bm.to(cuda)
    lens = _lengths(B, [S, 1, 0, S // 2 + 3, 65], cuda)
    for lengths, bitmap in ((S, bm), (lens, None)):
        calls = da.flash_decode_reference.calls
        launches = da.flash_decode_attention.launches
        allocs = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
        got = da.flash_decode_attention(q, k, v, lengths, bitmap=bitmap, **sc)
        assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] \
            == allocs + 1
        assert da.flash_decode_attention.launches == launches + 1
        assert da.flash_decode_reference.calls == calls
        ref = da.flash_decode_reference(q, k, v, lengths, bitmap=bitmap, **sc)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        _close(got, ref, dtype)
        # Slot 2 has no set bit, and lengths put 0 at slot 2: zeros.
        if B > 2:
            assert not got[2].any()
        assert torch.equal(got, da.flash_decode_attention(
            q, k, v, lengths, bitmap=bitmap, **sc))


@pytest.mark.gpu
def test_flash_decode_scalar_length_and_paged_view(cuda):
    """A scalar length (the engine's cursor) equals a [B] vector of it, and
    K4 over the contiguous cache equals K1 over the same cache viewed as a
    page pool (f32)."""
    gen = torch.Generator().manual_seed(11)
    B, H, n_kv, hd, S = 3, 8, 2, 64, 512
    q = torch.randn((B, H, hd), generator=gen).to(cuda)
    k, v, _ = _pool(gen, B, S, n_kv, hd, torch.float32, False, cuda)
    got = da.flash_decode_attention(q, k, v, 301)
    vec = da.flash_decode_attention(
        q, k, v, torch.full((B,), 301, dtype=torch.int32, device=cuda))
    _close(got, vec, torch.float32)
    kp, table = da.contiguous_as_paged(k, 64)
    vp, _ = da.contiguous_as_paged(v, 64)
    assert kp.data_ptr() == k.data_ptr()             # a view, not a copy
    paged = da.paged_decode_attention(
        q, kp, vp, table, torch.full((B,), 301, dtype=torch.int32,
                                     device=cuda))
    _close(got, paged, torch.float32)


@pytest.mark.gpu
def test_flash_decode_contract_raises_on_card(cuda):
    """What K4 does not take raises before any launch; nothing falls back
    to the plain version."""
    gen = torch.Generator().manual_seed(0)
    calls = da.flash_decode_reference.calls
    launches = da.flash_decode_attention.launches
    for H, n_kv, hd, dtype in [(4, 4, 32, torch.float32),
                               (6, 2, 64, torch.float32),
                               (4, 4, 64, torch.float16)]:
        q = torch.randn((2, H, hd), generator=gen).to(dtype).to(cuda)
        kv = torch.randn((2, 16, n_kv, hd), generator=gen).to(dtype).to(cuda)
        with pytest.raises(ValueError):
            da.flash_decode_attention(q, kv, kv, 9)
    q = torch.randn((2, 4, 64), generator=gen).to(cuda)
    kv = torch.randn((2, 16, 4, 64), generator=gen).to(cuda)
    bm = torch.ones((2, 16), dtype=torch.bool, device=cuda)
    for kw in (dict(bitmap=bm.cpu()), dict(bitmap=bm.T.contiguous().T),
               dict(bitmap=bm.to(torch.uint8)), dict(bitmap=bm[:, :8]),
               dict(k_scale=torch.ones((2, 16, 4, 1), device=cuda)),
               dict(k_scale=torch.ones((2, 16, 4, 1), device=cuda),
                    v_scale=torch.ones((2, 16, 4, 1), device=cuda))):
        with pytest.raises(ValueError):
            da.flash_decode_attention(q, kv, kv, 9, **kw)
    with pytest.raises(ValueError):
        da.flash_decode_attention(q, kv[:, ::2], kv[:, ::2], 5)
    with pytest.raises(ValueError):
        da.flash_decode_attention(q, kv, kv, torch.tensor([3.0, 4.0]))
    assert da.flash_decode_reference.calls == calls
    assert da.flash_decode_attention.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    {}, dict(speculative=True, gamma=3),
    dict(speculative=True, gamma=3, kv_dtype="int8",
         prefill_chunk_tokens=32)], ids=["plain", "spec", "spec-int8-chunked"])
def test_engine_on_card_matches_cpu(cuda, kw):
    """The engine on the card (kernels) and on the CPU (plain versions)
    give identical greedy streams and gauges over prefix-hit traffic at
    f32 — plain, speculative (K3), and speculative with an int8 pool and
    chunked prefill (K2 continuation chunks)."""
    cfg = LlamaConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                      n_kv_heads=1, d_ff=256, max_seq=128,
                      dtype=torch.float32, decode_attn="fused", remat=False)
    got = []
    for dev in ("cpu", cuda):
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = ContinuousBatcher(model, cfg, n_slots=3, max_len=128, chunk=4,
                                prefill_bucket=16, kv_layout="paged",
                                page_size=16, prefix_cache=True, device=dev,
                                **kw)
        rng = np.random.default_rng(0)
        system = list(rng.integers(0, cfg.vocab, 32))
        phrase = list(rng.integers(0, cfg.vocab, 5))
        ids = [eng.submit(system + phrase * 3 + list(
            rng.integers(0, cfg.vocab, 7)), 16) for _ in range(5)]
        da.reset_counters()
        done = {}
        while eng.pending:
            done.update(eng.step())
        eng._alloc.assert_consistent()
        m = eng.pool_metrics()
        got.append(([done[i] for i in ids], m["prefill_tokens_skipped"],
                     m.get("spec_accept_rate"), m["prefill_chunks_total"]))
        if dev != "cpu":
            c = da.counters()
            assert not (c["paged_decode_reference"]
                        or c["dense_prefill_reference"]
                        or c["paged_verify_reference"]), c
            if kw.get("speculative"):
                assert c["paged_verify_attention"] > 0, c
    assert got[0] == got[1]
    assert got[1][1] > 0


SMALL = dict(vocab=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=256, max_seq=128, dtype=torch.float32, decode_attn="fused",
             remat=False)
# 13 pages: three requests in flight fill the pool, so each wave evicts
# the pages the one before it cached.
LIFECYCLE = dict(n_slots=3, max_len=128, chunk=4, prefill_bucket=16,
                 kv_layout="paged", page_size=16, prefix_cache=True,
                 n_pages=13)


def _waves(vocab):
    """Wave A: four requests on a 32-token system prompt; B: four unique;
    C: A's system prompt again. Four requests on three slots: each wave's
    last request mounts what its first finisher donated."""
    rng = np.random.default_rng(0)
    system = list(rng.integers(0, vocab, 32))
    a = [system + list(rng.integers(0, vocab, 9)) for _ in range(4)]
    b = [list(rng.integers(0, vocab, 41)) for _ in range(4)]
    c = [system + list(rng.integers(0, vocab, 9)) for _ in range(4)]
    return a, b, c


def _lifecycle_streams(cfg, dev, drain=False, restore_kw=None, **kw):
    """The waves' streams on one engine; with ``drain``, the engine is
    drained after wave C's first step and restored into a fresh one
    (``restore_kw`` overrides) that finishes. Returns (streams, the last
    engine, the snapshot or None)."""
    model = init_params(LlamaConfig(**cfg), torch.Generator().manual_seed(0),
                        dev)

    def make(**over):
        return ContinuousBatcher(model, LlamaConfig(**cfg), device=dev,
                                 **{**LIFECYCLE, **kw, **over})

    eng, streams, snap = make(), [], None
    for i, wave in enumerate(_waves(cfg["vocab"])):
        ids = [eng.submit(p, 12) for p in wave]
        done = {}
        if drain and i == 2:
            done.update(eng.step())
            snap = eng.drain()
            eng._alloc.assert_consistent()
            eng = make(**(restore_kw or {}))
            assert eng.restore(snap) == snap.n_requests_in_flight > 0
        while eng.pending:
            done.update(eng.step())
        eng._alloc.assert_consistent()
        streams += [done[r] for r in ids]
    return streams, eng, snap


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8"),
                                dict(speculative=True, gamma=3)],
                         ids=["f32", "int8kv", "spec"])
def test_drain_restore_on_card_matches_cpu(cuda, kw):
    """A card engine drained mid-stream and restored into a fresh card
    engine with a larger pool finishes every stream as the CPU engine's
    undrained run does (f32); the resumed engine launches the kernels and
    calls no plain version."""
    ref, _, _ = _lifecycle_streams(SMALL, "cpu", **kw)
    da.reset_counters()
    got, eng, snap = _lifecycle_streams(SMALL, cuda, drain=True,
                                        restore_kw=dict(n_pages=40), **kw)
    assert got == ref
    assert snap.slot_req and snap.queue
    c = da.counters()
    assert c["paged_prefill_attention"] > 0
    assert c["paged_verify_attention" if kw.get("speculative")
             else "paged_decode_attention"] > 0
    assert not (c["paged_decode_reference"] or c["dense_prefill_reference"]
                or c["paged_verify_reference"]), c


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(speculative=True, gamma=3)],
                         ids=["plain", "spec"])
def test_traced_engine_on_card_matches_untraced(cuda, kw, tmp_path):
    """A traced engine with the flight recorder on the card gives the
    streams and the kernel launches of an untraced one without it, calls
    no plain version, and its spans export to a Perfetto document that
    validates."""
    from k8s_gpu_scheduler_tpu_torch.obs import (
        Tracer, validate_perfetto, write_perfetto)

    got = []
    for traced in (False, True):
        tr = Tracer() if traced else None
        da.reset_counters()
        streams, eng, _ = _lifecycle_streams(
            SMALL, cuda, tracer=tr, flight_capacity=256 if traced else 0,
            **kw)
        c = da.counters()
        got.append((streams, c))
    assert got[0] == got[1]
    c = got[1][1]
    assert c["paged_prefill_attention"] > 0
    assert c["paged_verify_attention" if kw else "paged_decode_attention"] > 0
    assert not (c["paged_decode_reference"] or c["dense_prefill_reference"]
                or c["paged_verify_reference"]), c
    names = {s.name for s in tr.spans()}
    assert {"queue", "admit", "prefill", "reap"} <= names
    assert ({"verify", "rewind"} if kw else {"decode_chunk"}) <= names
    doc = write_perfetto(tr.spans(), str(tmp_path / "trace.json"))
    assert validate_perfetto(doc) == []
    kinds = {r["kind"] for r in eng._flight.records()}
    assert ("verify" if kw else "decode") in kinds


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8")],
                         ids=["f32", "int8kv"])
def test_tiering_on_card_matches_cpu_untiered(cuda, kw):
    """KV tiering on the card (demotion gathers, promotion scatters) gives
    the CPU engine's streams with tiering off, at f32; wave C promotes
    wave A's pages back, and a drain with a populated tier restores into
    a tiered card engine that finishes the same streams."""
    ref, _, _ = _lifecycle_streams(SMALL, "cpu", **kw)
    tier = dict(kv_tiering=True, dram_pages=16)
    got, eng, _ = _lifecycle_streams(SMALL, cuda, **tier, **kw)
    assert got == ref
    m = eng.pool_metrics()
    assert m["page_demotions_total"] > 0 and m["page_promotions_total"] > 0
    again, eng, snap = _lifecycle_streams(SMALL, cuda, drain=True,
                                          restore_kw=tier, **tier, **kw)
    assert again == ref and snap.tier_keys
    eng._alloc.tier.assert_consistent()



@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8")],
                         ids=["f32", "int8kv"])
def test_contiguous_engine_on_card_matches_cpu(cuda, kw):
    """The shared-cursor engine on the card (K4) and on the CPU (plain
    version) give identical greedy streams at f32, through an FCFS stop
    and epoch rolls; the card launches K4 once per layer per tick and
    calls no plain version."""
    cfg = LlamaConfig(**SMALL)
    got = []
    for dev in ("cpu", cuda):
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = ContinuousBatcher(model, cfg, n_slots=3, max_len=64, chunk=4,
                                prefill_bucket=16, kv_layout="contiguous",
                                device=dev, **kw)
        rng = np.random.default_rng(0)
        ids = [eng.submit(list(rng.integers(0, cfg.vocab, n)), m)
               for n, m in [(5, 9), (7, 33), (12, 5), (9, 9), (40, 6),
                            (3, 1), (6, 13), (33, 5), (8, 8)]]
        da.reset_counters()
        done = {}
        while eng.pending:
            done.update(eng.step())
        got.append([done[i] for i in ids])
        assert eng.fcfs_stops > 0 and eng.epoch_rolls > 0
        if dev != "cpu":
            c = da.counters()
            assert c["flash_decode_attention"] > 0
            assert c["flash_decode_attention"] % (cfg.n_layers
                                                  * eng.chunk) == 0
            assert not (c["flash_decode_reference"]
                        or c["paged_decode_attention"]), c
    assert got[0] == got[1]


@pytest.mark.gpu
def test_generate_and_speculative_on_card_match_cpu(cuda):
    """``generate`` (K4) and ``generate_speculative`` (K3 through the
    paged view, K4 for nothing: every forward is a window) on the card
    equal the CPU at f32, and each other."""
    cfg = LlamaConfig(**SMALL)
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 9)))
    phrase = torch.from_numpy(np.tile(rng.integers(0, cfg.vocab, 5), 4)[None])
    out = {}
    for dev in ("cpu", cuda):
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)
        da.reset_counters()
        g = generate(model, batch, cfg, max_new=12, max_len=64)
        c = da.counters()
        want = {"cpu": "flash_decode_reference",
                "cuda": "flash_decode_attention"}[torch.device(dev).type]
        assert {k: v for k, v in c.items() if v} == {
            want: cfg.n_layers * 11}
        da.reset_counters()
        s = generate_speculative(model, phrase, cfg, max_new=20, gamma=3,
                                 max_len=64)
        c = da.counters()
        want = {"cpu": "paged_verify_reference",
                "cuda": "paged_verify_attention"}[torch.device(dev).type]
        assert set(k for k, v in c.items() if v) == {want}
        assert 0 < c[want] < cfg.n_layers * 19       # some window accepted
        assert torch.equal(s.cpu(), generate(model, phrase, cfg, max_new=20,
                                             max_len=64).cpu())
        assert g.device.type == torch.device(dev).type
        sampled = [generate_speculative(model, phrase, cfg, max_new=12,
                                        gamma=3, max_len=64, temperature=0.8,
                                        top_k=10, seed=4).cpu()
                   for _ in range(2)]
        assert torch.equal(sampled[0], sampled[1])
        out[torch.device(dev).type] = (g.cpu(), s.cpu())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])


FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_inputs(gen, B, T, H, n_kv, hd, dtype, dev):
    return [torch.randn(shape, generator=gen).to(dtype).to(dev)
            for shape in ((B, T, H, hd), (B, T, n_kv, hd), (B, T, n_kv, hd),
                          (B, T, H, hd))]


@pytest.mark.gpu
@pytest.mark.parametrize("hd,n_heads,n_kv,T", [
    (64, 8, 8, 200), (128, 8, 4, 256), (64, 16, 4, 130), (128, 16, 2, 320),
    (64, 4, 4, 1), (128, 8, 4, 15), (64, 8, 2, 77), (128, 4, 4, 77),
    (128, 16, 2, 1000), (64, 16, 2, 1000)],
    ids=["g1-hd64-T200", "g2-hd128-T256", "g4-hd64-T130", "g8-hd128-T320",
         "g1-hd64-T1", "g2-hd128-T15", "g4-hd64-T77", "g1-hd128-T77",
         "g8-hd128-T1000", "g8-hd64-T1000"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@DTYPES
def test_flash_kernels_match_plain(cuda, hd, n_heads, n_kv, T, causal,
                                   dtype):
    """K5 (out, lse), K6 (dq) and K7 (dk, dv) against the plain versions
    over several 64-row tiles and a ragged last tile, and at T 1, 15 and
    77 (one partial tile of the tensor-core kernels, K7's 32-row q steps at
    hd 128 included) and 1000; each kernel launches once per call, no
    plain version runs, and a second call reproduces every output bit for
    bit. bf16 runs the forward and the backward on the tensor cores, f32
    on the CUDA cores; the lse is held to the f32 tolerance either way."""
    gen = torch.Generator().manual_seed(hd + n_heads + T)
    q, k, v, do = _flash_inputs(gen, 2, T, n_heads, n_kv, hd, dtype, cuda)
    reset_counters()
    out, lse = flash_forward(q, k, v, causal)
    dq, dk, dv = flash_backward(q, k, v, out, lse, do, causal)
    c = counters()
    assert (c["flash_forward"], c["flash_backward_dq"],
            c["flash_backward_dkv"]) == (1, 1, 1), c
    assert not (c["flash_forward_reference"]
                or c["flash_backward_reference"]), c
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal)
    refs = flash_backward_reference(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
    tol = FLASH_GRAD_TOL[dtype]
    for got, ref, like in zip((dq, dk, dv), refs, (q, k, v)):
        assert got.dtype == dtype and got.shape == like.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)
    again = flash_forward(q, k, v, causal) + flash_backward(
        q, k, v, out, lse, do, causal)
    for a, b in zip(again, (out, lse, dq, dk, dv)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_forward_only_skips_lse(cuda):
    gen = torch.Generator().manual_seed(5)
    q, k, v, _ = _flash_inputs(gen, 1, 96, 4, 2, 64, torch.float32, cuda)
    out, lse = flash_forward(q, k, v, True, with_lse=False)
    assert lse is None
    torch.testing.assert_close(out, flash_forward(q, k, v, True)[0],
                               atol=0, rtol=0)


@pytest.mark.gpu
def test_flash_contract_raises_on_card(cuda):
    """A head dim or dtype the kernels do not take raises before any
    launch; nothing falls back to the plain version."""
    gen = torch.Generator().manual_seed(0)
    reset_counters()
    for hd, dtype in [(32, torch.float32), (96, torch.bfloat16),
                      (64, torch.float16)]:
        q, k, v, _ = _flash_inputs(gen, 1, 64, 2, 2, hd, dtype, cuda)
        with pytest.raises(ValueError):
            flash_forward(q, k, v)
    q, k, v, do = _flash_inputs(gen, 1, 64, 2, 2, 64, torch.float32, cuda)
    out, lse = flash_forward(q, k, v)
    reset_counters()
    for bad in (lse[:, :32], lse.double(), lse.T.contiguous()):
        with pytest.raises(ValueError):
            flash_backward(q, k, v, out, bad, do)
    with pytest.raises(ValueError):
        flash_backward(q, k, v, out, lse, do[:, :32])
    assert not any(counters().values()), counters()


def _train_losses(cfg, dev, steps=3, B=2, T=128, seed=0):
    model = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    step = make_train_step(cfg, None, make_optimizer(model, 3e-4))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)))
    batch = {"tokens": tokens.to(dev),
             "targets": torch.roll(tokens, -1, dims=1).to(dev)}
    return [float(step(model, batch)) for _ in range(steps)]


@pytest.mark.gpu
def test_train_steps_on_card_match_cpu(cuda):
    """Three f32 AdamW steps with flash attention and remat (hd 64, GQA,
    two 64-row tiles): the card's losses equal the CPU's to 1e-5 relative,
    the kernels launch 2L / L / L times per step, no plain version runs,
    and a second run on the card gives the same losses bit for bit."""
    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=128,
                      dtype=torch.float32, attn_impl="flash", remat=True)
    cpu = _train_losses(cfg, "cpu")
    reset_counters()
    card = _train_losses(cfg, cuda)
    c = counters()
    assert (c["flash_forward"], c["flash_backward_dq"],
            c["flash_backward_dkv"]) == (2 * 2 * 3, 2 * 3, 2 * 3), c
    assert not (c["flash_forward_reference"]
                or c["flash_backward_reference"]), c
    assert card == pytest.approx(cpu, rel=1e-5)
    assert card[-1] < card[0]
    assert _train_losses(cfg, cuda) == card
    dense = _train_losses(dataclasses.replace(cfg, attn_impl="dense"), cuda)
    assert dense == pytest.approx(card, rel=1e-4)


def _fleet_traffic(vocab, n=8, seed=0):
    """``n`` prompts over two shared 32-token system prompts."""
    rng = np.random.default_rng(seed)
    hot = [list(rng.integers(0, vocab, 32)) for _ in range(2)]
    return [hot[i % 2] + list(rng.integers(0, vocab, 3 + i % 5))
            for i in range(n)]


def _fleet_engine(model, dev, **kw):
    return ContinuousBatcher(model, LlamaConfig(**SMALL), device=dev, **{
        **dict(n_slots=3, max_len=128, chunk=4, prefill_bucket=16,
               kv_layout="paged", page_size=16, prefix_cache=True), **kw})


@pytest.mark.gpu
@pytest.mark.parametrize("role", ["mixed", "prefill"])
def test_fleet_engine_methods_on_card_match_cpu(cuda, role):
    """The methods the router reads (``emitted``, ``replica_stats``,
    ``cache_digest``, ``active_slot_ids``, ``pages_referenced``,
    ``handoff_ready_slots``, ``cancel``) on a card engine equal the CPU
    engine's over the same steps (f32); a ``role="prefill"`` engine parks
    its ready slots and launches no decode kernel."""
    got = []
    for dev in ("cpu", cuda):
        model = init_params(LlamaConfig(**SMALL),
                            torch.Generator().manual_seed(0), dev)
        eng = _fleet_engine(model, dev, role=role,
                            prefill_chunk_tokens=16)
        ids = [eng.submit(p, 12) for p in _fleet_traffic(256, n=5)]
        da.reset_counters()
        seen = []
        for _ in range(4):
            eng.step()
            seen.append(([eng.emitted(r) for r in ids],
                         eng.replica_stats(), eng.cache_digest(4, 64),
                         eng.active_slot_ids(),
                         eng.pages_referenced(eng.active_slot_ids()),
                         eng.handoff_ready_slots()))
        cancelled = (eng.cancel(ids[-1], reason="deadline"),
                     eng.cancel(10 ** 6), dict(eng.errors))
        eng._alloc.assert_consistent()
        got.append((seen, cancelled))
        if dev != "cpu":
            c = da.counters()
            assert not (c["paged_decode_reference"]
                        or c["dense_prefill_reference"]), c
            assert (c["paged_decode_attention"] == 0) == (role == "prefill")
    assert got[0] == got[1]
    assert got[1][1][:2] == (True, False)


@pytest.mark.gpu
def test_router_on_card_launches_kernels_and_matches_cpu(cuda):
    """A 2-replica ``Router`` over card engines, with a forced shed: the
    streams equal the CPU fleet's and a single CPU engine's (f32), K1 and
    K2 launch, and no plain version runs on the card."""
    from k8s_gpu_scheduler_tpu_torch import fleet, obs

    prompts = _fleet_traffic(256)
    got = []
    for dev in ("cpu", cuda):
        model = init_params(LlamaConfig(**SMALL),
                            torch.Generator().manual_seed(0), dev)
        clk = obs.VirtualClock()
        engines = {f"r{i}": _fleet_engine(model, dev, clock=clk)
                   for i in range(2)}
        rtr = fleet.Router(list(engines.items()), clock=clk)
        da.reset_counters()
        frids = [rtr.submit(p, max_new=12) for p in prompts]
        done = rtr.step()
        src = max(engines, key=lambda r: len(engines[r].active_slot_ids()))
        moved = rtr.shed(src, "r1" if src == "r0" else "r0",
                         slots=engines[src].active_slot_ids()[:1])
        done.update(rtr.run())
        c = da.counters()
        got.append(([done[f] for f in frids], moved, rtr.stats()))
        if dev != "cpu":
            assert c["paged_decode_attention"] > 0
            assert c["paged_prefill_attention"] > 0
            assert not (c["paged_decode_reference"]
                        or c["dense_prefill_reference"]
                        or c["paged_verify_reference"]), c
        else:
            ref = _fleet_engine(model, "cpu")
            ids = [ref.submit(p, 12) for p in prompts]
            single = {}
            while ref.pending:
                single.update(ref.step())
            assert got[0][0] == [single[i] for i in ids]
    assert got[0] == got[1]
    assert got[1][1] == 1 and got[1][2]["aggregate_prefix_hit_rate"] > 0


# -- mixture-of-experts, BERT and ResNet ------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8")],
                         ids=["f32", "int8kv"])
def test_moe_engine_on_card_matches_cpu(cuda, kw):
    """The paged, prefix-cached engine at a small f32 MoE config (dropless
    experts on every serving path): the card's greedy streams and skipped
    prefill tokens equal the CPU's; K1 and K2 launch, no plain version."""
    cfg = LlamaConfig(**SMALL, n_experts=4, moe_top_k=2)
    prompts = _fleet_traffic(cfg.vocab, n=6)
    got = []
    for dev in ("cpu", cuda):
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = ContinuousBatcher(model, cfg, n_slots=3, max_len=128, chunk=4,
                                prefill_bucket=16, kv_layout="paged",
                                page_size=16, prefix_cache=True, device=dev,
                                **kw)
        da.reset_counters()
        streams = []
        for wave in (prompts[:2], prompts[2:]):    # the second wave hits
            ids = [eng.submit(p, 10) for p in wave]
            done = {}
            while eng.pending:
                done.update(eng.step())
            streams += [done[i] for i in ids]
        got.append((streams, eng.pool_metrics()["prefill_tokens_skipped"]))
        if dev != "cpu":
            c = da.counters()
            assert c["paged_decode_attention"] and c["paged_prefill_attention"]
            assert not (c["paged_decode_reference"]
                        or c["dense_prefill_reference"]), c
    assert got[0] == got[1] and got[1][1] > 0


@pytest.mark.gpu
def test_moe_train_steps_on_card_match_cpu(cuda):
    """Three f32 AdamW steps of an MoE config (capacity path, balance aux)
    with flash attention and remat: the card's losses equal the CPU's to
    1e-5 relative, K5-K7 launch 2L / L / L times a step, and a second card
    run replays bit for bit."""
    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=128,
                      dtype=torch.float32, attn_impl="flash", remat=True,
                      n_experts=4, moe_top_k=2)
    cpu = _train_losses(cfg, "cpu")
    reset_counters()
    card = _train_losses(cfg, cuda)
    c = counters()
    assert (c["flash_forward"], c["flash_backward_dq"],
            c["flash_backward_dkv"]) == (2 * 2 * 3, 2 * 3, 2 * 3), c
    assert card == pytest.approx(cpu, rel=1e-5)
    assert _train_losses(cfg, cuda) == card


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_bert_classify_on_card_matches_cpu(cuda, dtype, tol):
    """Tiny BERT's logits on the card against the CPU, relative to the
    largest logit: 1e-5 at f32 (TF32 off), 2^-6 at bf16 (products summed
    in other orders, as the JAX comparison's bf16 bound)."""
    from k8s_gpu_scheduler_tpu_torch.models.bert import (
        BertConfig, classify, init_params as bert_init)

    cfg = dataclasses.replace(BertConfig.tiny(), dtype=dtype)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 48)))
    cpu, gpu = (classify(bert_init(cfg, torch.Generator().manual_seed(0),
                                   dev), tokens.to(dev)).cpu()
                for dev in ("cpu", cuda))
    assert float((gpu - cpu).abs().max() / cpu.abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("size", [32, 33])
def test_resnet_forward_and_step_on_card_match_cpu(cuda, size):
    """Tiny f32 ResNet on the card (cuDNN, TF32 off) against the CPU on
    32x32 ("SAME" pads asymmetrically) and 33x33 images: logits to 1e-4
    and the losses of three SGD-momentum steps to 1e-5 relative."""
    from k8s_gpu_scheduler_tpu_torch.models.resnet import (
        ResNetConfig, forward, init_params as resnet_init, make_optimizer,
        make_train_step as resnet_step)

    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(ResNetConfig.tiny(), dtype=torch.float32)
    rng = np.random.default_rng(size)
    images = torch.from_numpy(rng.standard_normal(
        (4, size, size, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes, 4))
    out = []
    for dev in ("cpu", cuda):
        model = resnet_init(cfg, torch.Generator().manual_seed(0), dev)
        logits = forward(model, images.to(dev)).detach().cpu()
        step = resnet_step(cfg, make_optimizer(model))
        batch = {"images": images.to(dev), "labels": labels.to(dev)}
        out.append((logits, [float(step(model, batch)) for _ in range(3)]))
    torch.testing.assert_close(out[1][0], out[0][0], atol=1e-4, rtol=0)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-5)


# -- tensor-parallel islands (chip_smoke phase 17 at tiny widths) -------------

def _island_world(tmp_path, world, backend, combine):
    return spawn(card_world, world, backend, args=(combine,),
                 rendezvous=str(tmp_path / "rdv"), timeout=300)


def _island_checks(outs, world):
    """Every rank launched K1 and K2 as often as one card did and ran no
    plain version; its pool is 1/world of one card's; the leader's f32
    streams are one card's."""
    streams, one_counts, one_bytes = outs[0]["one"]
    assert outs[0]["island"][0] == streams
    assert one_counts["paged_decode_attention"] > 0
    for _, counts, nbytes in (o["island"] for o in outs):
        assert counts == one_counts
        assert nbytes * world == one_bytes


@pytest.mark.gpu
def test_tp1_mesh_on_an_nccl_world_of_one(cuda, tmp_path):
    """17a at tiny widths: a tp = 1 mesh over an NCCL world of one serves
    the single-card engine's streams with its launches."""
    _island_checks(_island_world(tmp_path, 1, "nccl", "all_gather"), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["all_gather", "psum"])
def test_tp2_gloo_ranks_sharing_the_card(cuda, tmp_path, combine):
    """17b at tiny widths: two gloo ranks on one card, each holding half
    the pool and half the sliced weights, launch K1/K2 on their heads as
    often as one card does; the f32 streams are one card's."""
    _island_checks(_island_world(tmp_path, 2, "gloo", combine), 2)


# -- gang serving (chip_smoke phase 20 at tiny widths) --------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("world,backend,axes", [
    (1, "nccl", {}), (2, "gloo", {"tp": 2}), (2, "gloo", {})],
    ids=["nccl-one", "gloo-tp2", "gloo-dp2"])
def test_gang_generate_on_the_card(cuda, tmp_path, world, backend, axes):
    """20a/20b at small widths (f32, hd 64, a 400-token prompt, B 8): every
    rank's streams are one card's; each launches K4 once a layer a token
    after the prefill under one card's split counts and runs no plain
    version."""
    outs = spawn(card_gang_world, world, backend, args=(axes,),
                 rendezvous=str(tmp_path / "rdv"), timeout=300)
    one = outs[0]["one"]
    n = serve_config(**CARD_CELL).n_layers * (PLAN_CELL["max_new"] - 1)
    assert one["counters"]["flash_decode_attention"] == n
    for out in outs:
        got = out["mesh"]
        np.testing.assert_array_equal(got["streams"], one["streams"])
        assert got["splits"] == one["splits"]
        assert got["counters"]["flash_decode_attention"] == n
        assert not got["counters"]["flash_decode_reference"]


# -- sharded training (chip_smoke phase 18 at small widths) --------------------

@pytest.mark.gpu
def test_size1_mesh_training_on_an_nccl_world_of_one(cuda, tmp_path):
    """18a at small widths: a mesh of one rank over an NCCL world of one
    trains with the single-card step: the same losses bit for bit and the
    same K5-K7 launches."""
    (out,) = spawn(card_train_world, 1, "nccl", args=({},),
                   rendezvous=str(tmp_path / "rdv"), timeout=300)
    assert out["mesh"]["losses"] == out["one"]["losses"]
    assert out["mesh"]["launches"] == out["one"]["launches"]
    assert out["one"]["launches"]["flash_forward"] > 0


@pytest.mark.gpu
def test_tp2_training_on_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """18b at small widths: two gloo ranks on one card at tp 2 give one
    card's f32 losses (1e-5 relative), each launching K5-K7 on its heads
    as often as one card does and running no plain version."""
    outs = spawn(card_train_world, 2, "gloo", args=({"tp": 2},),
                 rendezvous=str(tmp_path / "rdv"), timeout=300)
    one = outs[0]["one"]
    for out in outs:
        assert out["mesh"]["losses"] == pytest.approx(one["losses"],
                                                      rel=1e-5)
        assert out["mesh"]["launches"] == one["launches"]
    assert one["launches"]["flash_forward"] > 0
    assert not one["launches"]["flash_forward_reference"]


# -- pipeline stages, MoE over ep, restore across meshes (phase 19) ----------

@pytest.mark.gpu
def test_pp2_steps_on_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """19b at small widths: two gloo ranks on one card as pipeline stages
    give one card's f32 losses (1e-5 relative) for GPipe and 1F1B."""
    outs = spawn(card_pp_world, 2, "gloo",
                 rendezvous=str(tmp_path / "rdv"), timeout=300)
    one = outs[0]["one"]
    for out in outs:
        for sched in ("gpipe", "1f1b"):
            assert out[sched] == pytest.approx(one, rel=1e-5)


@pytest.mark.gpu
def test_ep2_moe_steps_on_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """19d at small widths: an ep 2 MoE step on two gloo ranks gives one
    card's f32 losses, each rank launching K5-K7 as one card does and
    running no plain version."""
    outs = spawn(card_ep_world, 2, "gloo",
                 rendezvous=str(tmp_path / "rdv"), timeout=300)
    one = outs[0]["one"]
    for out in outs:
        assert out["mesh"]["losses"] == pytest.approx(one["losses"],
                                                      rel=1e-5)
        assert out["mesh"]["launches"] == one["launches"]
    assert one["launches"]["flash_forward"] > 0
    assert not one["launches"]["flash_forward_reference"]


@pytest.mark.gpu
def test_tp2_checkpoint_restores_onto_one_card(cuda, tmp_path):
    """19e at small widths: a step saved by two gloo ranks at tp 2
    restores onto one card, every rank's saved blocks its slices of the
    restored weights and AdamW moments bit for bit."""
    outs = spawn(card_restore_world, 2, "gloo",
                 args=(str(tmp_path / "ck"),),
                 rendezvous=str(tmp_path / "rdv"), timeout=300)
    for out in outs:
        assert out["step_no"] == 2 and out["equal"]


# -- graftcheck for the port (chip_smoke phase 21 at tiny widths) -------------

@pytest.mark.gpu
def test_smem_query_equals_the_mirror(cuda):
    """21b for one instantiation of each kernel on each route: the bytes
    its launcher requests (the .cu query) equal analysis/smem.py's
    mirror, which only the card's compiler can hold to the constexprs."""
    from k8s_gpu_scheduler_tpu_torch.analysis import smem
    from k8s_gpu_scheduler_tpu_torch.ops import _build

    lib = _build.load_library()
    first = {}
    for e in smem.reached_entries():
        first.setdefault((e.kernel, e.source), e)
    assert {k for k, _ in first} == {f"K{i}" for i in range(1, 8)}
    for e in first.values():
        assert smem.lib_query(lib, e) == e.dynamic_bytes, e.label


@pytest.mark.gpu
def test_alias_scenario_on_card(cuda):
    """21c at the tiny config: a decode chunk over mounted shared pages
    leaves them byte-identical on the card, through K1."""
    from k8s_gpu_scheduler_tpu_torch.analysis.alias import (
        audit_shared_pages)
    from k8s_gpu_scheduler_tpu_torch.analysis.entrypoints import (
        alias_scenarios)

    build = dict(alias_scenarios())["batcher_decode_paged_prefix"]
    da.reset_counters()
    assert audit_shared_pages(build, "decode", cuda) == []
    c = da.counters()
    assert c["paged_decode_attention"] > 0, c
    assert not c["paged_decode_reference"], c


@pytest.mark.gpu
def test_steady_scenario_on_card(cuda):
    """21d at the tiny config: three steady paged decode dispatches keep
    the pool's and table's storage, allocate nothing more, and rebuild
    and configure nothing."""
    from k8s_gpu_scheduler_tpu_torch.analysis.entrypoints import (
        steady_scenarios)
    from k8s_gpu_scheduler_tpu_torch.analysis.steady import run_steady

    build = dict(steady_scenarios())["batcher_steady_decode_paged"]
    found, st = run_steady(build, "paged", cuda, count_syncs=True)
    assert found == []
    assert {"k", "v", "table"} <= set(st["tracked"])
    assert len(st["allocated"]) == len(st["syncs"]) == 3


# -- the rest of graftcheck (chip_smoke phase 22 at the audit widths) ----------

@pytest.mark.gpu
def test_op_record_matches_cpu_on_card(cuda):
    """22a: every single-card op-audit entry records on the card, with the
    kernels launched inside its leaves and no plain version, op for op as
    the same entry's CPU record; none has a finding."""
    from k8s_gpu_scheduler_tpu_torch.analysis.entrypoints import (
        op_entrypoints)
    from k8s_gpu_scheduler_tpu_torch.analysis.opaudit import audit_entry
    from k8s_gpu_scheduler_tpu_torch.analysis.oprecord import (
        first_difference)

    for name, entry in op_entrypoints():
        if entry.world > 1:
            continue
        found, recs = audit_entry(entry, name, cuda)
        _, cpu_recs = audit_entry(entry, name, torch.device("cpu"))
        assert found == [], [f.render() for f in found]
        for card_rec, cpu_rec in zip(recs, cpu_recs):
            assert first_difference(card_rec, cpu_rec) is None, name
        launched = recs[0].launched()
        assert not any(k.endswith("_reference") for k in launched), launched
        if cpu_recs[0].leaves():
            assert launched, name


@pytest.mark.gpu
def test_traffic_contracts_on_card(cuda):
    """22b at the audit geometry: every single-card row meets its
    contract on the card (the gather rungs refused), with K1, K2 and K3
    launched inside the decode, verify and prefix-prefill records and the
    dispatch's max_memory_allocated growth inside the residency bound."""
    from k8s_gpu_scheduler_tpu_torch.analysis.entrypoints import (
        traffic_entrypoints)
    from k8s_gpu_scheduler_tpu_torch.analysis.traffic import (
        run_traffic_entry)

    want = {"traffic_decode_chunk": "paged_decode_attention",
            "traffic_verify_window": "paged_verify_attention",
            "traffic_verify_window_sampled": "paged_verify_attention",
            "traffic_prefill_tb16_hb4_kernel": "paged_prefill_attention"}
    for name, entry in traffic_entrypoints():
        if entry.world > 1:
            continue
        found, st = run_traffic_entry(entry, name, cuda)
        assert found == [], [f.render() for f in found]
        if "gather" in name:
            assert "refused" in st
            continue
        assert st["growth"] is not None and st["peak_pool"] == 0
        if name in want:
            assert st["launched"].get(want[name]), (name, st["launched"])
        assert not any(k.endswith("_reference") for k in st["launched"])


@pytest.mark.gpu
def test_scheduler_handoff_caps_the_allocator(cuda):
    """The handoff from the port's scheduler to a pod on the card: a 4-chip
    pod placed on one of two 2x2 partitions of a v5e host gets
    TPU_HBM_LIMIT_BYTES and TPU_DUTY_CYCLE_PERCENTAGE in its ConfigMap,
    and that environment caps the card's allocator at exactly the
    fraction ``enforcement.hbm_fraction`` computes from the card's
    memory (chip_smoke phase 23c serves ``main --serve`` under it)."""
    import time

    from k8s_gpu_scheduler_tpu_torch.api import objects as o
    from k8s_gpu_scheduler_tpu_torch.cluster import APIServer
    from k8s_gpu_scheduler_tpu_torch.cmd.scheduler import build_scheduler
    from k8s_gpu_scheduler_tpu_torch.config import SchedulerConfig
    from k8s_gpu_scheduler_tpu_torch.utils import enforcement

    server = APIServer()
    server.create(o.Node(
        metadata=o.ObjectMeta(name="v5e-shared", labels={
            o.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
            o.LABEL_TPU_TOPOLOGY: "2x4"},
            annotations={o.ANN_SLICE_CONFIG: "2x2"}),
        status=o.NodeStatus(allocatable={o.TPU_RESOURCE: 8})))
    server.create(o.ConfigMap(metadata=o.ObjectMeta(name="cm-pod")))
    server.create(o.Pod(
        metadata=o.ObjectMeta(name="pod"),
        spec=o.PodSpec(containers=[o.Container(
            env_from=[o.ConfigMapRef("cm-pod")],
            resources=o.ResourceRequirements(
                requests={o.TPU_RESOURCE: 4}))])))
    sched = build_scheduler(server, SchedulerConfig(),
                            allow_simulated_reshape=True)
    sched.start()
    try:
        deadline = time.monotonic() + 30
        while not server.get("Pod", "pod").spec.node_name:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        sched.stop()
        sched._reshaper.stop()
    env = server.get("ConfigMap", "cm-pod").data
    assert env["TPU_VISIBLE_CHIPS"] == "0,1,2,3"
    assert env["TPU_DUTY_CYCLE_PERCENTAGE"] == "50"
    assert int(env["TPU_HBM_LIMIT_BYTES"]) == 4 * (16 << 30)
    card = torch.device("cuda", torch.cuda.current_device())
    total = torch.cuda.get_device_properties(card).total_memory
    want = enforcement.hbm_fraction(env, total)
    try:
        got = enforcement.apply_hbm_limit(env, card)
        assert got == want == min(1.0, (16 << 30) / total)
        # The allocator keeps its cap in whole bytes: the fraction it
        # reports is that cap over the card's bytes.
        cap = torch.cuda.get_per_process_memory_fraction(card) * total
        assert round(cap) == int(want * total)
        assert enforcement.duty_throttle(env).pct == 50
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, card)


@pytest.mark.gpu
def test_rest_placed_pod_serves_on_the_card(cuda):
    """24c's handoff at a small size: a scheduler leader-elected over the
    REST adapter (``cluster/kubeapi.py`` against ``tests/fakekube.py``)
    scores an SLO pod on the recommender's gRPC predictions and places it
    on a 2x2 partition; its ConfigMap, read back over REST, caps the
    card's allocator at ``enforcement.hbm_fraction``'s bytes, and a
    paged engine (tiny config) serves a wave under its throttle through
    K1, with no plain call."""
    import os
    import shutil
    import tempfile
    import time

    from fakekube import FakeKube

    from k8s_gpu_scheduler_tpu_torch.api import objects as o
    from k8s_gpu_scheduler_tpu_torch.cluster.kubeapi import KubeAPIServer
    from k8s_gpu_scheduler_tpu_torch.cmd.scheduler import build_scheduler
    from k8s_gpu_scheduler_tpu_torch.config import SchedulerConfig
    from k8s_gpu_scheduler_tpu_torch.recommender import server as rserver
    from k8s_gpu_scheduler_tpu_torch.utils import enforcement

    data = os.path.join(os.path.dirname(rserver.__file__), "data")
    tmp = tempfile.mkdtemp()
    for name in ("configurations_train.tsv", "interference_train.tsv"):
        shutil.copy(os.path.join(data, name), tmp)
    rec = rserver.RecommenderServer(
        os.path.join(tmp, "configurations_train.tsv"),
        os.path.join(tmp, "interference_train.tsv"), port=0).start()
    fake = FakeKube()
    fake.add_node("v5e-0")
    api = KubeAPIServer(base_url=fake.url)
    api.mutate("Node", "v5e-0", "default", lambda n: n.metadata.annotations
               .update({o.ANN_SLICE_CONFIG: "2x2"}))
    cfg = SchedulerConfig(backoff_initial_s=0.05)
    cfg.registry.port = 1
    cfg.recommender.host, cfg.recommender.port = "127.0.0.1", rec.port
    cfg.metrics.url = "http://127.0.0.1:1"
    sched = build_scheduler(api, cfg, leader_elect=True)
    calls = []
    tpu = sched.profile.score[0]
    real = tpu.recommender.impute_configurations
    tpu.recommender.impute_configurations = lambda ix: calls.append(ix) \
        or real(ix)
    api.create(o.ConfigMap(metadata=o.ObjectMeta(name="cm-solo")))
    api.create(o.Pod(
        metadata=o.ObjectMeta(name="llama3-8b-serve-0"),
        spec=o.PodSpec(containers=[o.Container(
            env=[o.EnvVar("SLO", "5"),
                 o.EnvVar("WORKLOAD_NAME", "llama3_8b_serve")],
            env_from=[o.ConfigMapRef("cm-solo")],
            resources=o.ResourceRequirements(requests={o.TPU_RESOURCE: 2}))])))
    sched.start()
    try:
        deadline = time.monotonic() + 30
        while "TPU_VISIBLE_CHIPS" not in api.get("ConfigMap", "cm-solo").data:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        env = dict(api.get("ConfigMap", "cm-solo").data)
    finally:
        sched.stop()
        sched._reshaper.stop()
        rec.stop()
        fake.close()
        shutil.rmtree(tmp, ignore_errors=True)
    assert "llama3-8b-serve-0" in calls
    assert fake.binding_posts == [("default", "llama3-8b-serve-0", "v5e-0")]
    assert env["TPU_DUTY_CYCLE_PERCENTAGE"] == "50"
    card = torch.device("cuda", torch.cuda.current_device())
    total = torch.cuda.get_device_properties(card).total_memory
    want = enforcement.hbm_fraction(env, total)
    mcfg = LlamaConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                       n_kv_heads=1, d_ff=256, max_seq=128,
                       dtype=torch.float32, decode_attn="fused", remat=False)
    try:
        throttle = enforcement.apply_env_limits(env, card)
        cap = torch.cuda.get_per_process_memory_fraction(card) * total
        assert round(cap) == int(want * total)
        slept = []
        real_pace = throttle.pace
        throttle.pace = lambda a: slept.append(real_pace(a)) or slept[-1]
        model = init_params(mcfg, torch.Generator().manual_seed(0), card)
        eng = ContinuousBatcher(model, mcfg, n_slots=4, max_len=128, chunk=8,
                                prefill_bucket=32, kv_layout="paged",
                                page_size=16, device=card)
        rng = np.random.default_rng(24)
        for _ in range(4):
            eng.submit(list(rng.integers(0, mcfg.vocab, 20)), 16)
        da.reset_counters()
        with throttle:
            done = eng.run()
            torch.cuda.synchronize()
        c = da.counters()
        assert len(done) == 4 and all(len(s) == 16 for s in done.values())
        assert c["paged_decode_attention"] > 0, c
        assert not (c["paged_decode_reference"]
                    or c["dense_prefill_reference"]), c
        assert slept and slept[-1] > 0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, card)
        torch.cuda.empty_cache()


# -- the node agent --------------------------------------------------------------

@pytest.mark.gpu
def test_prober_reports_the_cards_through_nvml(cuda, monkeypatch):
    """The port's prober, with no fake file and no device glob, reads the
    node's cards through NVML: one chip a card, ids 0..n-1, each total
    within 1 MiB of ``nvidia-smi``'s memory.total (MiB), and a live
    ``Scraper`` parses the same count."""
    import json
    import subprocess

    from k8s_gpu_scheduler_tpu_torch.agent import Scraper, _build

    for var in ("TPUPROBE_FAKE", "TPUPROBE_DEV_GLOB", "TPUPROBE_NVML_LIB",
                "TPUPROBE_BIN"):
        monkeypatch.delenv(var, raising=False)
    proc = subprocess.run([str(_build.build()), "--once"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    chips = json.loads(proc.stdout)["chips"]
    n = torch.cuda.device_count()
    assert [c["device_id"] for c in chips] == list(range(n))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    assert len(smi) == n
    for c, mib in zip(chips, smi):
        assert abs(c["hbm_total"] - int(mib) * 1048576) <= 1048576, (c, mib)
        assert 0.0 <= c["duty_cycle"] <= 1.0
        assert 0 < c["hbm_used"] <= c["hbm_total"]
    assert len(Scraper().scrape()) == n
