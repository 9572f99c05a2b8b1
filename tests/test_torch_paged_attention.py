"""K1/K2 plain versions against the JAX package's Pallas kernels.

On CPU tensors the port's wrappers run their plain PyTorch versions; here
those are held against the JAX ``paged_decode_attention`` and
``paged_prefill_attention`` run in Pallas interpret mode (as the JAX
package's own tests run them on the CPU) and against the JAX dense
references. Tolerance: 2e-5 at f32, 2e-2 at bf16 — the JAX suite's own
(tests/test_prefill_attention.py). The CUDA kernels themselves are held to
these plain versions on the card (``-m gpu`` and chip_smoke.py). K2's bf16
kernel computes its scores in f32 and rounds the unnormalised
probabilities to bf16 once before P V, where the plain version rounds its
scores and its normalised probabilities;
``test_bf16_prefill_rounding_fits_card_tolerance`` shows here that this
stays inside the card's bf16 tolerance, 2e-2."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models.serving import _kv_quant as j_kv_quant
from k8s_gpu_scheduler_tpu.ops import decode_attention as jda
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
HEADS = pytest.mark.parametrize("n_heads,n_kv", [(8, 8), (8, 2)],
                                ids=["mha", "gqa4"])
DT = pytest.mark.parametrize("dt", ["f32", "bf16"])
QUANT = pytest.mark.parametrize("quant", [False, True],
                                ids=["exact", "int8"])


def both(x, jdt, tdt):
    """One numpy array as (jax array, torch tensor) in the given dtypes
    (both round f32 -> bf16 to nearest even)."""
    return jnp.asarray(x, jdt), torch.from_numpy(np.array(x)).to(tdt)


def pool(rng, n_pages, ps, n_kv, hd, jdt, tdt, quant):
    """(jax k, v, scales), (torch k, v, scales) of one random pool."""
    kv = [rng.normal(size=(n_pages, ps, n_kv, hd)).astype(np.float32)
          for _ in range(2)]
    if not quant:
        (jk, tk), (jv, tv) = (both(a, jdt, tdt) for a in kv)
        return (jk, jv, {}), (tk, tv, {})
    qs = [tuple(np.asarray(a) for a in j_kv_quant(jnp.asarray(x, jdt)))
          for x in kv]
    jsc = dict(k_scale=jnp.asarray(qs[0][1]), v_scale=jnp.asarray(qs[1][1]))
    tsc = dict(k_scale=torch.from_numpy(qs[0][1].copy()),
               v_scale=torch.from_numpy(qs[1][1].copy()))
    return ((jnp.asarray(qs[0][0]), jnp.asarray(qs[1][0]), jsc),
            (torch.from_numpy(qs[0][0].copy()),
             torch.from_numpy(qs[1][0].copy()), tsc))


def close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


# -- K1 -------------------------------------------------------------------------

def decode_case(seed, n_heads, n_kv, dt, quant, B=4, hd=16, ps=8,
                n_blocks=4):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * n_blocks
    jq, tq = both(rng.normal(size=(B, n_heads, hd)).astype(np.float32),
                  jdt, tdt)
    (jk, jv, jsc), (tk, tv, tsc) = pool(rng, n_pages, ps, n_kv, hd, jdt,
                                        tdt, quant)
    # A scrambled table: each slot's pages anywhere in the pool.
    table = (rng.permutation(n_pages - 1)[:B * n_blocks] + 1) \
        .reshape(B, n_blocks).astype(np.int32)
    lens = np.array([1, n_blocks * ps, 13, 20], np.int32)[:B]
    return (jq, jk, jv, jsc), (tq, tk, tv, tsc), table, lens, tol


@HEADS
@DT
@QUANT
def test_decode_plain_matches_jax_kernel(n_heads, n_kv, dt, quant):
    """MHA/GQA-4 x f32/bf16 x exact/int8-KV, ragged lengths (1 and full),
    scrambled block table: the plain version == the interpreted Pallas
    kernel and == the JAX dense reference."""
    (jq, jk, jv, jsc), (tq, tk, tv, tsc), table, lens, tol = decode_case(
        0, n_heads, n_kv, dt, quant)
    n0 = da.paged_decode_reference.calls
    got = da.paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                    torch.from_numpy(lens), **tsc)
    assert da.paged_decode_reference.calls == n0 + 1
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kern = jda.paged_decode_attention(jq, jk, jv, jnp.asarray(table),
                                      jnp.asarray(lens), interpret=True,
                                      **jsc)
    close(got, kern, tol)
    jsc_d = {k: jda.gather_paged_kv(s, jnp.asarray(table))
             for k, s in jsc.items()}
    dense = jda.dense_decode_reference(
        jq, jda.gather_paged_kv(jk, jnp.asarray(table)),
        jda.gather_paged_kv(jv, jnp.asarray(table)), lengths=lens, **jsc_d)
    close(got, dense, tol)


def test_gather_paged_kv_matches_jax():
    rng = np.random.default_rng(1)
    pages = rng.normal(size=(9, 4, 2, 3)).astype(np.float32)
    table = rng.integers(0, 9, size=(2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        da.gather_paged_kv(torch.from_numpy(pages),
                           torch.from_numpy(table)).numpy(),
        np.asarray(jda.gather_paged_kv(jnp.asarray(pages),
                                       jnp.asarray(table))))


def test_combine_splits_matches_jax():
    """The split-K merge's contract, which K1, K3 and K4 keep inside their
    kernels (a cluster merge on the card): the JAX kernel split four ways
    and merged by its ``_combine_splits`` equals the port's unsplit plain
    version, with empty splits (every row of a split past a short length)
    and a fully masked row, which yields zeros on both sides."""
    rng = np.random.default_rng(2)
    b, s, n_kv, g, hd = 3, 64, 2, 2, 16
    jq, tq = both(rng.normal(size=(b, n_kv * g, hd)).astype(np.float32),
                  jnp.float32, torch.float32)
    (jk, tk), (jv, tv) = (
        both(rng.normal(size=(b, s, n_kv, hd)).astype(np.float32),
             jnp.float32, torch.float32) for _ in range(2))
    lens = np.array([20, 0, 64], np.int32)
    ref = jda.flash_decode_attention(jq, jk, jv, jnp.asarray(lens),
                                     block_k=8, n_splits=4, interpret=True)
    got = da.flash_decode_reference(tq, tk, tv, torch.from_numpy(lens))
    close(got, ref, 2e-5)
    assert not got[1].any() and not np.asarray(ref)[1].any()


# -- K2 -------------------------------------------------------------------------

def prefill_case(seed, n_heads, n_kv, dt, quant, m=3, tb=16, hd=16, ps=8,
                 hb=4, n_pages=12):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(seed)
    jq, tq = both(rng.normal(size=(m, tb, n_heads, hd)).astype(np.float32),
                  jdt, tdt)
    jtk, ttk = both(rng.normal(size=(m, tb, n_kv, hd)).astype(np.float32),
                    jdt, tdt)
    jtv, ttv = both(rng.normal(size=(m, tb, n_kv, hd)).astype(np.float32),
                    jdt, tdt)
    (jk, jv, jsc), (tk, tv, tsc) = pool(rng, n_pages, ps, n_kv, hd, jdt,
                                        tdt, quant)
    table = rng.integers(1, n_pages, size=(m, hb)).astype(np.int32)
    # Ragged page-aligned hits: full cover, half, and none.
    choices = [hb * ps, (hb // 2) * ps, 0]
    hits = np.asarray([choices[i % 3] for i in range(m)], np.int32)
    return ((jq, jk, jv, jnp.asarray(table), jnp.asarray(hits), jtk, jtv),
            jsc, (tq, tk, tv, torch.from_numpy(table),
                  torch.from_numpy(hits), ttk, ttv), tsc, tol)


@HEADS
@DT
@QUANT
def test_prefill_plain_matches_jax_kernel(n_heads, n_kv, dt, quant):
    """The same grid for K2 with ragged page-aligned hit lengths (full,
    half, 0): the plain version == the interpreted Pallas kernel."""
    jargs, jsc, targs, tsc, tol = prefill_case(0, n_heads, n_kv, dt, quant)
    n0 = da.dense_prefill_reference.calls
    got = da.paged_prefill_attention(*targs, **tsc)
    assert da.dense_prefill_reference.calls == n0 + 1
    kern = jda.paged_prefill_attention(*jargs, interpret=True, **jsc)
    close(got, kern, tol)


def test_prefill_hb0_degenerate_pure_causal():
    """hb == 0 (nothing cached) is the pure causal window."""
    jargs, _, targs, _, tol = prefill_case(1, 8, 2, "f32", False)
    jempty = jnp.zeros((3, 0), jnp.int32)
    tempty = torch.zeros((3, 0), dtype=torch.int32)
    jargs = jargs[:3] + (jempty, jnp.zeros(3, jnp.int32)) + jargs[5:]
    targs = targs[:3] + (tempty, torch.zeros(3, dtype=torch.int32)) \
        + targs[5:]
    got = da.paged_prefill_attention(*targs)
    close(got, jda.paged_prefill_attention(*jargs, interpret=True), tol)
    close(got, jda.dense_prefill_reference(*jargs), tol)


def test_prefill_null_padded_table_rows_ignored():
    """Table entries past ceil(hit/ps) (null or garbage) are never read."""
    _, _, targs, _, _ = prefill_case(2, 8, 8, "f32", False)
    q, kp, vp, table, _, tk, tv = targs
    hits = torch.tensor([16, 8, 0], dtype=torch.int32)
    junk = table.clone()
    junk[0, 2:] = 0
    junk[1, 1:] = 9
    clean = da.paged_prefill_attention(q, kp, vp, table, hits, tk, tv)
    dirty = da.paged_prefill_attention(q, kp, vp, junk, hits, tk, tv)
    assert torch.equal(clean, dirty)


def _prefill_rounded(q, k_pages, v_pages, table, hits, tail_k, tail_v,
                     k_scale=None, v_scale=None):
    """K2's tensor-core arithmetic: int8 prefix rows dequantized to q's
    dtype (as the kernel stages them), f32 scores of the operands, the
    unnormalised p = exp(s - m) rounded once to bf16 before P V, and the
    row sum from the f32 p."""
    m, tb, n_heads, hd = q.shape
    ps, n_kv = k_pages.shape[1], k_pages.shape[2]
    hp = table.shape[1] * ps
    idx = table.long()

    def prefix(pool, scale):
        rows = pool[idx].reshape(m, hp, n_kv, hd)
        if scale is not None:
            rows = (rows.float() * scale[idx].reshape(m, hp, n_kv, 1)
                    ).to(q.dtype)
        return rows.float()

    kf = torch.cat([prefix(k_pages, k_scale), tail_k.float()], dim=1)
    vf = torch.cat([prefix(v_pages, v_scale), tail_v.float()], dim=1)
    kcol = torch.arange(hp + tb)[None, None, :]
    qrow = torch.arange(tb)[None, :, None]
    valid = torch.where(kcol < hp, kcol < hits[:, None, None],
                        (kcol - hp) <= qrow)[:, None, None]
    g = n_heads // n_kv
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(m, tb, n_kv, g, hd), kf) / math.sqrt(hd)
    s = torch.where(valid, s, -math.inf)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.bfloat16).float(), vf)
    out = pv / p.sum(-1, keepdim=True).permute(0, 3, 1, 2, 4)
    return out.reshape(m, tb, n_heads, hd)


@HEADS
@QUANT
def test_bf16_prefill_rounding_fits_card_tolerance(n_heads, n_kv, quant):
    """K2's bf16 numerics (f32 scores, P rounded once to bf16) stay inside
    atol = rtol = 2e-2 of the plain version on the same bf16 inputs, the
    card's tolerance, and of the plain version in f32; the rounding is
    visible (it differs from the all-f32 result)."""
    _, _, targs, tsc, tol = prefill_case(3, n_heads, n_kv, "bf16", quant,
                                         hd=64)
    got = _prefill_rounded(*targs, **tsc)
    want = da.dense_prefill_reference(*targs, **tsc)
    torch.testing.assert_close(got, want.float(), atol=tol, rtol=tol)
    q, kp, vp, table, hits, tk, tv = targs
    f32 = da.dense_prefill_reference(
        q.float(), kp if quant else kp.float(), vp if quant else vp.float(),
        table, hits, tk.float(), tv.float(), **tsc)
    torch.testing.assert_close(got, f32, atol=tol, rtol=tol)
    assert not torch.equal(got, f32)


# -- wrapper contract -----------------------------------------------------------

def test_wrappers_route_by_device_and_validate():
    """CPU tensors take the plain version and launch nothing; any other
    device raises; malformed shapes raise before any work."""
    (_, _, _, _), (tq, tk, tv, _), table, lens, _ = decode_case(
        3, 8, 2, "f32", False)
    tt, tl = torch.from_numpy(table), torch.from_numpy(lens)
    launches = da.paged_decode_attention.launches
    da.paged_decode_attention(tq, tk, tv, tt, tl)
    assert da.paged_decode_attention.launches == launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        da.paged_decode_attention(tq.to("meta"), tk.to("meta"),
                                  tv.to("meta"), tt.to("meta"), tl)
    with pytest.raises(ValueError, match="block_table"):
        da.paged_decode_attention(tq, tk, tv, tt[:2], tl)
    _, _, targs, _, _ = prefill_case(4, 8, 8, "f32", False)
    q, kp, vp, ptab, hits, tk2, tv2 = targs
    with pytest.raises(ValueError, match="multiple of the page"):
        da.paged_prefill_attention(q[:, :12], kp, vp, ptab, hits,
                                   tk2[:, :12], tv2[:, :12])
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        da.paged_decode_attention(tq, tk, tv, tt, tl,
                                  k_scale=torch.ones(1))


def test_counters_reset():
    da.paged_decode_reference.calls += 1
    da.reset_counters()
    assert set(da.counters().values()) == {0}


@pytest.mark.parametrize("b,n_kv,n_blocks,want", [
    (8, 16, 32, 3), (8, 8, 32, 5), (1, 1, 4, 4), (64, 16, 32, 1),
    (1, 16, 32, 8), (1, 8, 32, 8)])
def test_decode_splits_fill_the_card(b, n_kv, n_blocks, want):
    """About two blocks per SM, never more splits than pages nor than one
    thread-block cluster holds (B = 1 would want 17 and 33)."""
    assert da.paged_plan(n_blocks, 64, b, n_kv) == want
    assert da.paged_plan(n_blocks, 48, b, n_kv) is None
