"""K3's plain version against the JAX package's Pallas verify kernel.

On CPU tensors ``paged_verify_attention`` runs ``paged_verify_reference``
(the table gather + ``dense_verify_reference``); here it is held against
the JAX ``paged_verify_attention`` in Pallas interpret mode (as the JAX
package's own tests run it on the CPU) over f32/bf16, kv groups 1/2/4,
exact and int8 pools and windows t = 1/3/5. Tolerance: 2e-5 at f32, 2e-2
at bf16, the port's K1/K2 parity tolerances. The CUDA kernel itself is
held to this plain version on the card (``-m gpu`` and chip_smoke.py).
K3's bf16 kernel runs on the tensor cores and rounds at other places than
the plain version (f32 scores, int8 scales applied to the scores and to
p, P rounded once to bf16); ``test_bf16_verify_rounding_fits_card_
tolerance`` shows here that this stays inside the card's 2e-2."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.ops import decode_attention as jda
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from test_torch_paged_attention import DTYPES, both, close, pool


def verify_case(seed, n_heads, n_kv, dt, quant, t, B=3, hd=16, ps=8,
                n_blocks=4):
    """(jax args, jax scales), (torch args, torch scales), tol for one
    window over a scrambled table; committed lengths 0, mid-page and the
    full table less the window."""
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * n_blocks
    jq, tq = both(rng.normal(size=(B, t, n_heads, hd)).astype(np.float32),
                  jdt, tdt)
    (jk, jv, jsc), (tk, tv, tsc) = pool(rng, n_pages, ps, n_kv, hd, jdt,
                                        tdt, quant)
    table = (rng.permutation(n_pages - 1)[:B * n_blocks] + 1) \
        .reshape(B, n_blocks).astype(np.int32)
    lens = np.array([0, 13, n_blocks * ps - t], np.int32)[:B]
    return ((jq, jk, jv, jnp.asarray(table), jnp.asarray(lens)), jsc,
            (tq, tk, tv, torch.from_numpy(table), torch.from_numpy(lens)),
            tsc, tol)


# Every (dtype, group, pool) cell once, with the windows t = 1/3/5
# rotated through it so each t meets each dtype and each pool kind (the
# full product triples the interpreted JAX calls, about 1 s each).
GRID = [(dt, n_kv, quant, (1, 3, 5)[(i + 2 * j + k) % 3])
        for i, dt in enumerate(("f32", "bf16"))
        for j, n_kv in enumerate((8, 4, 2))
        for k, quant in enumerate((False, True))]


@pytest.mark.parametrize(
    "dt,n_kv,quant,t", GRID,
    ids=[f"{dt}-g{8 // n_kv}-{'int8' if qu else 'exact'}-t{t}"
         for dt, n_kv, qu, t in GRID])
def test_verify_plain_matches_jax_kernel(dt, n_kv, quant, t):
    jargs, jsc, targs, tsc, tol = verify_case(t, 8, n_kv, dt, quant, t)
    n0 = da.paged_verify_reference.calls
    got = da.paged_verify_attention(*targs, **tsc)
    assert da.paged_verify_reference.calls == n0 + 1
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    kern = jda.paged_verify_attention(*jargs, interpret=True, **jsc)
    close(got, kern, tol)


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_dense_verify_reference_matches_jax(quant):
    """The dense oracle itself, op for op, on a contiguous cache."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 4, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    lens = np.array([3, 30], np.int32)
    sc_j, sc_t = {}, {}
    if quant:
        k = np.round(k * 20).clip(-127, 127).astype(np.int8)
        v = np.round(v * 20).clip(-127, 127).astype(np.int8)
        s = [rng.uniform(0.01, 0.1, size=(2, 40, 2, 1)).astype(np.float32)
             for _ in range(2)]
        sc_j = dict(k_scale=jnp.asarray(s[0]), v_scale=jnp.asarray(s[1]))
        sc_t = dict(k_scale=torch.from_numpy(s[0]),
                    v_scale=torch.from_numpy(s[1]))
    got = da.dense_verify_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), **sc_t)
    ref = jda.dense_verify_reference(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens),
                                     **sc_j)
    close(got, ref, 2e-5)


def test_t1_is_decode_at_lengths_plus_one():
    """At t == 1 the verify is K1's plain version at lengths + 1, and
    every window row i equals it at lengths + i + 1."""
    _, _, (q, kp, vp, table, lens), _, _ = verify_case(0, 8, 2, "f32",
                                                       False, 4)
    got = da.paged_verify_attention(q, kp, vp, table, lens)
    for i in range(4):
        one = da.paged_decode_reference(q[:, i], kp, vp, table, lens + i + 1)
        torch.testing.assert_close(got[:, i], one, atol=2e-6, rtol=2e-6)
    t1 = da.paged_verify_attention(q[:, :1], kp, vp, table, lens)
    torch.testing.assert_close(
        t1[:, 0], da.paged_decode_reference(q[:, 0], kp, vp, table, lens + 1),
        atol=2e-6, rtol=2e-6)


def test_stale_overshoot_rows_are_masked():
    """Garbage above each row's bound (a rejected overshoot) never
    contributes: poisoning every row past lengths + t changes nothing."""
    _, _, (q, kp, vp, table, lens), _, _ = verify_case(1, 8, 4, "f32",
                                                       False, 3)
    ref = da.paged_verify_attention(q, kp, vp, table, lens)
    ps = kp.shape[1]
    kp2, vp2 = kp.clone(), vp.clone()
    for b in range(table.shape[0]):
        for c in range(int(lens[b]) + q.shape[1], table.shape[1] * ps):
            page, off = int(table[b, c // ps]), c % ps
            kp2[page, off] = 1e4
            vp2[page, off] = -1e4
    got = da.paged_verify_attention(q, kp2, vp2, table, lens)
    assert torch.equal(got, ref)


def test_wrapper_routes_validates_and_counts():
    """CPU tensors take the plain version and launch nothing; other
    devices raise; malformed shapes and an empty window raise."""
    _, _, (q, kp, vp, table, lens), _, _ = verify_case(2, 8, 2, "f32",
                                                       False, 3)
    launches = da.paged_verify_attention.launches
    da.paged_verify_attention(q, kp, vp, table, lens)
    assert da.paged_verify_attention.launches == launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        da.paged_verify_attention(q.to("meta"), kp.to("meta"),
                                  vp.to("meta"), table.to("meta"), lens)
    with pytest.raises(ValueError, match="block_table"):
        da.paged_verify_attention(q, kp, vp, table[:1], lens)
    with pytest.raises(ValueError, match="GQA"):
        da.paged_verify_attention(q[:, :, :7], kp, vp, table, lens)
    with pytest.raises(ValueError, match="verify blocking"):
        da.paged_verify_attention(q[:, :0], kp, vp, table, lens)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        da.paged_verify_attention(q, kp, vp, table, lens,
                                  k_scale=torch.ones(1))
    da.paged_verify_reference.calls += 1
    da.paged_verify_attention.launches += 1
    da.reset_counters()
    assert da.counters()["paged_verify_reference"] == 0
    assert da.counters()["paged_verify_attention"] == 0


def test_verify_plan():
    assert da.verify_plan(4, 16, 0) is None
    assert da.verify_plan(4, 12, 3) is None
    assert da.verify_plan(32, 64, 5, 8, 16) == da.paged_plan(32, 64, 8, 16)
    # B = 1 (generate_speculative): capped at one cluster's 8 blocks.
    assert da.verify_plan(32, 64, 5, 1, 16) == 8
    assert da.verify_plan(32, 64, 5, 1, 8) == 8


def _verify_rounded(q, k_pages, v_pages, table, lengths, k_scale=None,
                    v_scale=None):
    """K3's tensor-core arithmetic (``decode_mma.cu``) on the CPU:
    the raw pool rows as operands (an int8 value is exact in bf16), f32
    scores times the row's f32 k_scale after the product, the unnormalised
    p = exp(s - m) in f32 summed into l, then p times v_scale rounded once
    to bf16 against the raw V rows."""
    b, t, n_heads, hd = q.shape
    g = n_heads // k_pages.shape[2]
    k = da.gather_paged_kv(k_pages, table).float()
    v = da.gather_paged_kv(v_pages, table).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(b, t, -1, g, hd), k) / math.sqrt(hd)

    def per_col(scale):                                  # [B, Hkv, 1, 1, S]
        return da.gather_paged_kv(scale, table)[..., 0].permute(
            0, 2, 1)[:, :, None, None]

    if k_scale is not None:
        s = s * per_col(k_scale)
    bound = lengths.long()[:, None] + torch.arange(t)[None] + 1
    mask = (torch.arange(k.shape[1])[None, None] < bound[..., None]
            )[:, None, None]
    s = torch.where(mask, s, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = p * per_col(v_scale)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p.to(torch.bfloat16).float(),
                       v) / l
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, n_heads, hd)


@pytest.mark.parametrize("n_kv", [8, 2, 1], ids=["g1", "g4", "g8"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_bf16_verify_rounding_fits_card_tolerance(n_kv, quant):
    """K3's bf16 numerics (f32 scores, int8 scales on the scores and on p,
    P rounded once to bf16, l from the unscaled p) stay inside atol = rtol
    = 2e-2, the card's tolerance, of the plain version on the same bf16
    inputs and of the JAX kernel (interpret mode); the rounding is visible
    (it differs from the all-f32 result)."""
    jargs, jsc, targs, tsc, tol = verify_case(11, 8, n_kv, "bf16", quant, 5,
                                              hd=64)
    got = _verify_rounded(*targs, **tsc)
    torch.testing.assert_close(
        got, da.paged_verify_reference(*targs, **tsc).float(), atol=tol,
        rtol=tol)
    close(got, jda.paged_verify_attention(*jargs, interpret=True, **jsc),
          tol)
    q, kp, vp, table, lens = targs
    f32 = da.paged_verify_reference(
        q.float(), kp if quant else kp.float(), vp if quant else vp.float(),
        table, lens, **tsc)
    torch.testing.assert_close(got, f32, atol=tol, rtol=tol)
    assert not torch.equal(got, f32)
