"""K4's plain version against the JAX package's Pallas flash-decode kernel.

On CPU tensors the port's ``flash_decode_attention`` runs its plain
PyTorch version (``flash_decode_reference``); here it is held against the
JAX ``flash_decode_attention`` run in Pallas interpret mode (as
``tests/test_decode_attention.py`` runs it on the CPU) and against the JAX
``dense_decode_reference``, over that suite's grid: GQA groups 1/4/8, f32
and bf16, ragged and scalar lengths, int8 KV, a cache that splits, and the
validity bitmap with a block that holds no set bit. Tolerance: 2e-5 at
f32, 2e-2 at bf16 (the two frameworks round bf16 probabilities at other
places). ``decode_plan`` and ``contiguous_as_paged`` are held to the JAX
functions exactly. The CUDA kernel itself is held to this plain version on
the card (``-m gpu`` and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.ops import decode_attention as jda
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from test_torch_paged_attention import DT, DTYPES, both, close, pool


def qkv(seed, dt, B=2, H=8, Hkv=4, hd=32, S=64, quant=False):
    """((jax q, k, v, scales), (torch q, k, v, scales), tol) of one random
    contiguous cache [B, S, Hkv, hd]."""
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(seed)
    jq, tq = both(rng.normal(size=(B, H, hd)).astype(np.float32), jdt, tdt)
    (jk, jv, jsc), (tk, tv, tsc) = pool(rng, B, S, Hkv, hd, jdt, tdt, quant)
    return (jq, jk, jv, jsc), (tq, tk, tv, tsc), tol


def check(j, t, tol, lengths, bitmap=None, **jkw):
    """The port's wrapper (CPU: plain version) == the interpreted Pallas
    kernel == the JAX dense reference; no launch on the CPU."""
    jq, jk, jv, jsc = j
    tq, tk, tv, tsc = t
    jlen = jnp.asarray(lengths, jnp.int32)
    jbm = None if bitmap is None else jnp.asarray(bitmap)
    tbm = None if bitmap is None else torch.from_numpy(bitmap)
    tlen = (torch.from_numpy(np.asarray(lengths, np.int32))
            if np.ndim(lengths) else int(lengths))
    da.reset_counters()
    got = da.flash_decode_attention(tq, tk, tv, tlen, bitmap=tbm, **tsc)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    c = da.counters()
    assert c["flash_decode_attention"] == 0
    assert c["flash_decode_reference"] == 1
    close(got, jda.flash_decode_attention(jq, jk, jv, jlen, bitmap=jbm,
                                          interpret=True, **jsc, **jkw), tol)
    close(got, jda.dense_decode_reference(
        jq, jk, jv, lengths=jnp.broadcast_to(jlen, (jq.shape[0],)),
        bitmap=jbm, **jsc), tol)
    return got


@DT
@pytest.mark.parametrize("hkv", [8, 2, 1], ids=["g1", "g4", "g8"])
def test_gqa_and_dtypes(dt, hkv):
    j, t, tol = qkv(0, dt, Hkv=hkv)
    check(j, t, tol, np.array([17, 63]), block_k=16)


def test_ragged_fill_lengths():
    """pos = 0, 1, block-1, block, S-1 (lengths = pos + 1)."""
    j, t, tol = qkv(1, "f32", B=5)
    check(j, t, tol, np.array([1, 2, 16, 17, 64]), block_k=16)


def test_scalar_length_broadcasts():
    j, t, tol = qkv(2, "f32")
    check(j, t, tol, 23, block_k=16)


@DT
def test_int8_kv(dt):
    j, t, tol = qkv(3, dt, quant=True)
    check(j, t, tol, np.array([9, 64]), block_k=16)


def test_cache_that_splits():
    """S 128 in 16-row blocks, 4 splits on the JAX side, one of them past
    row 0's length; the port's plain version has no splits to get wrong,
    the card's kernel divides the live rows (the gpu tests)."""
    j, t, tol = qkv(4, "f32", S=128)
    check(j, t, tol, np.array([5, 100]), block_k=16, n_splits=4)


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_bitmap_masking(quant):
    """The engine's validity-bitmap mode: set bits below the lengths with
    holes, and one 16-row block (rows 16..31) with no set bit at all."""
    j, t, tol = qkv(5, "f32", quant=quant)
    lengths = np.array([40, 64])
    rng = np.random.default_rng(3)
    bm = rng.random((2, 64)) < 0.6
    bm &= np.arange(64)[None, :] < lengths[:, None]
    bm[:, 16:32] = False
    bm[:, 0] = True                                  # keep rows non-empty
    check(j, t, tol, lengths, bitmap=bm, block_k=16)


def test_fully_masked_rows_yield_zeros():
    """Length 0 and an empty bitmap give zeros from the plain version, as
    the JAX kernel's split merge does (the JAX dense reference softmaxes
    uniform there, so it is not compared)."""
    (jq, jk, jv, _), (tq, tk, tv, _), tol = qkv(6, "f32", B=3)
    lengths = np.array([0, 30, 30])
    bm = np.ones((3, 64), bool)
    bm[1] = False
    got = da.flash_decode_attention(
        tq, tk, tv, torch.from_numpy(lengths.astype(np.int32)),
        bitmap=torch.from_numpy(bm))
    ref = jda.flash_decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                     bitmap=jnp.asarray(bm), block_k=16,
                                     interpret=True)
    close(got, ref, tol)
    assert not got[:2].any() and got[2].any()
    dense = da.dense_decode_reference(
        tq, tk, tv, lengths=torch.from_numpy(lengths),
        bitmap=torch.from_numpy(bm))
    assert dense[0].any()                            # uniform, by contract
    close(dense, jda.dense_decode_reference(
        jq, jk, jv, lengths=jnp.asarray(lengths), bitmap=jnp.asarray(bm)),
        tol)


def test_any_cache_length_runs():
    """S = 100 has no JAX blocking (``decode_plan`` is None, the JAX
    kernel raises); the port takes any S."""
    j, t, tol = qkv(7, "f32", S=100)
    with pytest.raises(ValueError):
        jda.flash_decode_attention(*j[:3], jnp.asarray([50, 99]),
                                   interpret=True)
    got = da.flash_decode_attention(*t[:3], torch.tensor([50, 99]))
    close(got, jda.dense_decode_reference(*j[:3],
                                          lengths=jnp.asarray([50, 99])), tol)


@pytest.mark.parametrize("s", [8192, 2048, 512, 96, 64, 40, 32, 8, 100, 7,
                               2047])
def test_decode_plan_equals_jax(s):
    assert da.decode_plan(s) == jda.decode_plan(s)
    for kw in (dict(block_k=8), dict(block_k=48), dict(block_k=8, n_splits=3),
               dict(block_k=8, n_splits=4), dict(n_splits=2)):
        assert da.decode_plan(s, **kw) == jda.decode_plan(s, **kw)


def test_split_plan_fills_the_card():
    """K4's split count: about two blocks per SM, never a split under one
    64-row chunk, one split for one row, and at most MAX_SPLITS: the
    splits of a (slot, kv head) are one thread-block cluster."""
    assert da.flash_decode_plan(1024, batch=8, n_kv=16) == 3
    assert da.flash_decode_plan(2048, batch=1, n_kv=16) == 8
    assert da.flash_decode_plan(100, batch=1, n_kv=1) == 2
    assert da.flash_decode_plan(0, batch=1, n_kv=1) == 1
    assert da.flash_decode_plan(4096, batch=64, n_kv=8) == 1


@pytest.mark.parametrize("batch", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("n_kv", [1, 2, 8, 16])
def test_split_plan_fits_one_cluster(batch, n_kv):
    """No K4 plan exceeds the cluster cap at any live length, and every
    plan is at least one split."""
    for rows in (0, 1, 63, 64, 65, 512, 1024, 2048, 8192, 1 << 20):
        ns = da.flash_decode_plan(rows, batch, n_kv)
        assert 1 <= ns <= da.MAX_SPLITS
        assert ns <= max(1, -(-rows // 64))


def _decode_rounded(q, k, v, lengths, bitmap, k_scale=None, v_scale=None):
    """K4's bf16 tensor-core arithmetic (``decode_mma.cu``) on the CPU: the
    raw cache rows as operands (an int8 value is exact in bf16), f32
    scores times the row's k_scale, masked to rows < length that the
    bitmap sets, the unnormalised p = exp(s - m) in f32 summed into l,
    then p times v_scale rounded once to bf16 against the raw V rows."""
    b, n_heads, hd = q.shape
    g = n_heads // k.shape[2]
    s = torch.einsum("bhgd,bkhd->bhgk", q.float().reshape(b, -1, g, hd),
                     k.float()) / hd ** 0.5
    if k_scale is not None:
        s = s * k_scale[..., 0].permute(0, 2, 1)[:, :, None]
    mask = (torch.arange(k.shape[1])[None] < lengths[:, None]) & bitmap
    s = torch.where(mask[:, None, None], s, -np.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[..., 0].permute(0, 2, 1)[:, :, None]
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(torch.bfloat16).float(),
                       v.float()) / l
    return out.reshape(b, n_heads, hd)


@pytest.mark.parametrize("hkv", [8, 2, 1], ids=["g1", "g4", "g8"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_bf16_decode_rounding_fits_card_tolerance(hkv, quant):
    """K4's bf16 numerics on the tensor cores (f32 scores, int8 scales on
    the scores and on p, P rounded once to bf16, l from the unscaled p),
    over a bitmap window, stay inside atol = rtol = 2e-2, the card's
    tolerance, of the plain version on the same bf16 inputs and of the
    JAX kernel (interpret mode); the rounding is visible (it differs from
    the all-f32 result)."""
    j, t, tol = qkv(12, "bf16", B=3, Hkv=hkv, hd=64, S=128, quant=quant)
    lengths = np.array([128, 100, 37], np.int32)
    bitmap = np.zeros((3, 128), bool)
    bitmap[:, 20:90] = True                     # the slot's window
    bitmap[2, :30] = True
    tq, tk, tv, tsc = t
    tlen, tbm = torch.from_numpy(lengths), torch.from_numpy(bitmap)
    got = _decode_rounded(tq, tk, tv, tlen, tbm, **tsc)
    torch.testing.assert_close(
        got, da.flash_decode_reference(tq, tk, tv, tlen, bitmap=tbm,
                                       **tsc).float(), atol=tol, rtol=tol)
    jq, jk, jv, jsc = j
    close(got, jda.flash_decode_attention(
        jq, jk, jv, jnp.asarray(lengths), bitmap=jnp.asarray(bitmap),
        block_k=16, interpret=True, **jsc), tol)
    f32 = da.flash_decode_reference(
        tq.float(), tk if quant else tk.float(), tv if quant else tv.float(),
        tlen, bitmap=tbm, **tsc)
    torch.testing.assert_close(got, f32, atol=tol, rtol=tol)
    assert not torch.equal(got, f32)


def test_contiguous_as_paged_equals_jax():
    rng = np.random.default_rng(8)
    cache = rng.normal(size=(3, 64, 2, 16)).astype(np.float32)
    t = torch.from_numpy(cache)
    pool_t, table_t = da.contiguous_as_paged(t, 16)
    pool_j, table_j = jda.contiguous_as_paged(jnp.asarray(cache), 16)
    np.testing.assert_array_equal(pool_t.numpy(), np.asarray(pool_j))
    np.testing.assert_array_equal(table_t.numpy(), np.asarray(table_j))
    assert table_t.dtype == torch.int32
    assert pool_t.data_ptr() == t.data_ptr()         # a view, not a copy
    np.testing.assert_array_equal(
        da.gather_paged_kv(pool_t, table_t).numpy(), cache)


def test_wrapper_contract_errors():
    (_, _, _, _), (q, k, v, _), _ = qkv(9, "f32")
    ones = torch.ones((2, 64, 4, 1))
    bad = [
        dict(args=(q, k[:, :, :3], v[:, :, :3], 9)),          # 8 % 3
        dict(args=(q, k, v[:, :32], 9)),                      # k/v differ
        dict(args=(q, k[:1], v[:1], 9)),                      # batch
        dict(args=(q, k[..., :16], v[..., :16], 9)),          # head dim
        dict(args=(q[0], k, v, 9)),                           # q rank
        dict(args=(q, k, v, 9), k_scale=ones),                # one scale
        dict(args=(q, k, v, 9), k_scale=ones[:, :8], v_scale=ones[:, :8]),
        dict(args=(q, k, v, 9), bitmap=torch.ones((2, 64))),  # not bool
        dict(args=(q, k, v, 9), bitmap=torch.ones((2, 32), dtype=torch.bool)),
        dict(args=(q, k, v, torch.tensor([1, 2, 3]))),        # lengths [3]
        dict(args=(q, k, v, torch.tensor([1.0, 2.0]))),       # float lengths
    ]
    da.reset_counters()
    for case in bad:
        args = case.pop("args")
        with pytest.raises(ValueError):
            da.flash_decode_attention(*args, **case)
    assert not any(da.counters().values())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        da.flash_decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), 9)
