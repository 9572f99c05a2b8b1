"""Flash attention (K5-K7): the port's CPU path against the JAX package.

On CPU tensors ``flash_forward``/``flash_backward`` run their plain
versions (``flash_forward_reference``/``flash_backward_reference``);
here they are held against the JAX ``flash_attention``/
``flash_attention_diff`` run as the JAX package's own tests run them on
the CPU (the Pallas kernels in interpret mode). Inputs are made with numpy
from a seed. Tolerances, each an absolute bound on the largest difference:
2e-5 for the forward and lse (the JAX tests' bound, ``tests/test_ops.py``)
and 2e-5 for the gradients, tighter than the JAX tests' 3e-4 because it
holds (the largest difference seen is 3.1e-6, at gradients up to 6.3).
The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``). The bf16 backward
kernels round P and dS to bf16 once before their second products;
``test_bf16_rounding_of_p_and_ds_fits_card_tolerance`` shows here that
this rounding alone stays inside the card's bf16 tolerance, 2e-2; the bf16
forward rounds P once before P V, and
``test_bf16_rounding_of_p_fits_card_tolerance_and_keeps_lse`` shows the
same for its output, and that its lse (from the f32 P) does not move."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.ops import flash_attention as jflash
from k8s_gpu_scheduler_tpu.ops import flash_attention_diff as jflash_diff
from k8s_gpu_scheduler_tpu.ops.flash_attention import _bh, _flash_forward
from k8s_gpu_scheduler_tpu_torch.ops.attention import _repeat_kv
from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
    NEG_INF, _grouped, _probabilities, counters, flash_attention,
    flash_attention_diff, flash_backward_reference, flash_forward,
    flash_forward_reference, reset_counters,
)

FWD_TOL = 2e-5
GRAD_TOL = 2e-5


def qkv(seed, B=2, T=256, H=4, Hkv=2, d=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, h, d)).astype(np.float32)
                 for h in (H, Hkv, Hkv))


def t(a):
    return torch.from_numpy(np.array(a))


def max_diff(port, ref) -> float:
    return float(np.abs(port.detach().numpy() - np.asarray(ref)).max())


@pytest.mark.parametrize("T,H,Hkv,d,blocks,causal", [
    (256, 4, 2, 64, {}, True),
    (256, 4, 2, 64, {}, False),
    (512, 2, 2, 64, dict(block_q=128, block_k=128), True),
    (100, 2, 2, 64, {}, True),
], ids=["T256-gqa-causal", "T256-gqa-full", "T512-multiblock", "T100-clamped"])
def test_forward_matches_jax(T, H, Hkv, d, blocks, causal):
    q, k, v = qkv(T + H, T=T, H=H, Hkv=Hkv, d=d)
    reset_counters()
    got = flash_attention(t(q), t(k), t(v), causal=causal, **blocks)
    ref = jflash(q, k, v, causal=causal, interpret=True, **blocks)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert max_diff(got, ref) < FWD_TOL
    c = counters()
    assert c["flash_forward_reference"] == 1
    assert not (c["flash_forward"] or c["flash_backward_dq"]
                or c["flash_backward_dkv"]), c


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_lse_matches_jax_kernel(causal):
    """lse [B*H, T] equals JAX's ``_flash_forward(...)[1][..., 0]`` (the
    TPU kernel writes it broadcast over 128 lanes)."""
    q, k, v = qkv(5, T=256, H=4, Hkv=2)
    out, lse = flash_forward(t(q), t(k), t(v), causal)
    kr, vr = (jnp.repeat(x, 2, axis=2) for x in (k, v))
    jout, jlse = _flash_forward(_bh(jnp.asarray(q)), _bh(kr), _bh(vr),
                                causal, 256, 256, True)
    assert lse.shape == (2 * 4, 256) and lse.dtype == torch.float32
    assert max_diff(lse, jlse[..., 0]) < FWD_TOL
    assert max_diff(out, jnp.swapaxes(jout.reshape(2, 4, 256, 64), 1, 2)) \
        < FWD_TOL


@pytest.mark.parametrize("T,H,Hkv,causal,blocks", [
    (256, 4, 2, True, {}),
    (256, 4, 2, False, {}),
    (256, 4, 4, True, {}),
    (512, 2, 2, True, dict(block_q=128, block_k=128)),
], ids=["gqa-causal", "gqa-full", "mha-causal", "T512-multiblock"])
def test_gradients_match_jax(T, H, Hkv, causal, blocks):
    """dq, dk, dv under a non-uniform cotangent (a ``.sum()`` loss would
    cancel p/ds mix-ups); GQA dk/dv sum over each kv head's query
    heads."""
    q, k, v = qkv(T + 10 * H + Hkv, T=T, H=H, Hkv=Hkv)
    w = np.random.default_rng(99).normal(size=q.shape).astype(np.float32)
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    reset_counters()
    (flash_attention_diff(tq, tk, tv, causal, **blocks) * t(w)).sum() \
        .backward()
    bq, bk = blocks.get("block_q", 256), blocks.get("block_k", 512)
    ref = jax.grad(lambda q, k, v: (jflash_diff(q, k, v, causal, bq, bk)
                                    * w).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        assert got.shape == want.shape
        assert max_diff(got, want) < GRAD_TOL
    c = counters()
    assert c["flash_forward_reference"] == 1
    assert c["flash_backward_reference"] == 1
    assert not (c["flash_forward"] or c["flash_backward_dq"]
                or c["flash_backward_dkv"]), c


def test_gradients_match_dense_autograd():
    """The plain backward equals autograd through the f32 dense attention
    (an oracle independent of both flash implementations), at a ragged T
    the kernels tile with a partial last tile."""
    q, k, v = qkv(11, T=100, H=4, Hkv=2)
    w = t(np.random.default_rng(12).normal(size=q.shape).astype(np.float32))
    grads = []
    for fn in (flash_attention_diff,
               lambda q, k, v, c: _dense(q, k, v, c)):
        xs = [t(x).requires_grad_() for x in (q, k, v)]
        (fn(*xs, True) * w).sum().backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def _dense(q, k, v, causal):
    d = q.shape[-1]
    k, v = _repeat_kv(k, q.shape[2]), _repeat_kv(v, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(mask, s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def test_ragged_blocks_rejected():
    """As the JAX wrapper: T <= block clamps to one block; an explicit
    block that does not divide T raises."""
    q, k, v = qkv(3, T=100, H=2, Hkv=2, d=64)
    with pytest.raises(ValueError):
        flash_attention(t(q), t(k), t(v), block_q=64, block_k=64)
    with pytest.raises(ValueError):
        jflash(q, k, v, block_q=64, block_k=64, interpret=True)
    with pytest.raises(ValueError):
        flash_attention_diff(t(q), t(k), t(v), True, 64, 64)


def test_gqa_head_divisibility_rejected():
    q, _, _ = qkv(4, T=128, H=6, Hkv=6, d=64)
    _, k, v = qkv(4, T=128, H=6, Hkv=4, d=64)
    with pytest.raises(ValueError):
        jflash(q, k, v, interpret=True)
    for fn in (flash_attention, flash_attention_diff):
        with pytest.raises(ValueError):
            fn(t(q), t(k), t(v))


def test_other_devices_raise():
    q = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q, q, q)


def _backward_rounded(q, k, v, out, lse, dout, causal):
    """``flash_backward_reference``'s arithmetic with P and dS rounded to
    bf16 before the second products (dq = dS K, dk = dS^T Q, dv = P^T dO),
    as the tensor-core kernels round them, and nothing else changed."""
    b, t, n_heads, d = q.shape
    n_kv = k.shape[2]
    scale = 1.0 / d ** 0.5
    p = _probabilities(q, k, causal, lse)
    do = _grouped(dout, n_kv)
    delta = (do * _grouped(out, n_kv)).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    p, ds = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, _grouped(q, n_kv)) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    return dq.reshape(b, t, n_heads, d), dk, dv


@pytest.mark.parametrize("T,H,Hkv,d,causal", [
    (77, 4, 2, 64, True),
    (130, 8, 2, 128, False),
    (256, 8, 1, 128, True),
    (200, 4, 4, 64, False),
], ids=["g2-hd64-T77-causal", "g4-hd128-T130-full", "g8-hd128-T256-causal",
        "g1-hd64-T200-full"])
def test_bf16_rounding_of_p_and_ds_fits_card_tolerance(T, H, Hkv, d, causal):
    """The one change to the numerics in the tensor-core backward — P and
    dS rounded once to bf16 — keeps dq, dk and dv inside atol = rtol =
    2e-2 of the f32 plain version, the card's bf16 tolerance
    (``FLASH_GRAD_TOL``), on bf16-valued inputs; and the rounding is
    visible (the two differ)."""
    rng = np.random.default_rng(T + H + d)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, T, h, d)).astype(
        np.float32)).to(torch.bfloat16).float() for h in (H, Hkv, Hkv, H))
    out, lse = flash_forward_reference(q, k, v, causal)
    want = flash_backward_reference(q, k, v, out, lse, do, causal)
    got = _backward_rounded(q, k, v, out, lse, do, causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)
    assert any(not torch.equal(a, b) for a, b in zip(got, want))


def _forward_rounded(q, k, v, causal):
    """``flash_forward_reference``'s arithmetic with the unnormalised
    probabilities p = exp(s - m) rounded to bf16 before P V, as the
    tensor-core forward rounds them, and nothing else changed: the row sum
    l, and with it the lse, comes from the f32 p."""
    b, t, n_heads, d = q.shape
    s, mask = _probabilities(q, k, causal)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.bfloat16).float(),
                      v.float())
    out = pv / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(b * n_heads, t)
    return out.reshape(b, t, n_heads, d), lse


@pytest.mark.parametrize("T,H,Hkv,d,causal", [
    (77, 4, 2, 64, True),
    (130, 8, 2, 128, False),
    (256, 8, 1, 128, True),
    (200, 4, 4, 64, False),
], ids=["g2-hd64-T77-causal", "g4-hd128-T130-full", "g8-hd128-T256-causal",
        "g1-hd64-T200-full"])
def test_bf16_rounding_of_p_fits_card_tolerance_and_keeps_lse(T, H, Hkv, d,
                                                              causal):
    """The one change to the numerics in the tensor-core forward — P
    rounded once to bf16 before P V — keeps the output inside atol = rtol =
    2e-2 of the f32 plain version, the card's bf16 tolerance, on
    bf16-valued inputs; the rounding is visible (the outputs differ), and
    the lse, held to the f32 tolerance on the card, is the plain version's
    bit for bit."""
    rng = np.random.default_rng(T + H + d + 1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, T, h, d)).astype(
        np.float32)).to(torch.bfloat16).float() for h in (H, Hkv, Hkv))
    want, want_lse = flash_forward_reference(q, k, v, causal)
    got, lse = _forward_rounded(q, k, v, causal)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert not torch.equal(got, want)
    assert torch.equal(lse, want_lse)
