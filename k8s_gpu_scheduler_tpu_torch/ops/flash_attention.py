"""Flash attention for training: three hand-written CUDA kernels and their
plain PyTorch versions (port of the JAX package's ``ops/flash_attention.py``).

- K5, the forward, replaces the Pallas ``_flash_forward``: causal or full
  attention with an online softmax, writing ``out`` and the per-row
  log-sum-exp ``lse`` (the backward's only extra residual).
- K6 and K7, the backward, replace the two Pallas kernels of
  ``_flash_backward``. With p = exp(s - lse) recomputed from the saved
  lse and D_i = do_i . o_i:

      ds_ij = p_ij (do_i . v_j - D_i)
      dq_i  = scale * sum_j ds_ij k_j      (K6, which also writes D)
      dk_j  = scale * sum_i ds_ij q_i      (K7)
      dv_j  = sum_i p_ij do_i              (K7)

Shapes are the JAX package's: q ``[B, T, H, d]``, k/v ``[B, T, Hkv, d]``.
GQA is folded into the kernels (query head h reads kv head ``h // g``, and
K7 sums dk/dv over the g query heads of each kv head), where the JAX
package repeated K/V per head and summed the groups afterwards; the
function is the same. ``lse`` is ``[B*H, T]`` f32 (the TPU kernel's
128-lane broadcast was a layout matter).

``flash_forward`` and ``flash_backward`` run the kernels on CUDA tensors
(``ops/csrc/flash_attention.cu``; K6 and K7 in bf16 on the tensor cores,
``ops/csrc/flash_backward_mma.cu``, which rounds P and dS to bf16 once
before the second products; all built at first use by ``ops/_build.py``)
and the plain versions on CPU tensors; any other device raises, and a CUDA
tensor never reaches a plain version. ``flash_forward_reference`` and
``flash_backward_reference`` are those plain versions: the equations above
in f32, whatever the input dtype. ``flash_attention`` (forward only) and
``flash_attention_diff`` (an autograd function: forward K5 saving
``q, k, v, out, lse``; backward K6 then K7) are the entry points the
model calls. ``counters()`` reports each kernel's launches and each plain
version's calls. ``flash_forward`` (K5) and ``flash_backward`` (K6 + K7:
their plain version is one function) are leaf ops of an op record
(``_leaf.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._leaf import leaf_op

NEG_INF = -1e30

# The kernels' contract (ops/csrc/flash_attention.cu, flash_backward_mma.cu).
KERNEL_HEAD_DIMS = (64, 128)

_LAUNCHES = {"flash_forward": 0, "flash_backward_dq": 0,
             "flash_backward_dkv": 0}
_CALLS = {"flash_forward_reference": 0, "flash_backward_reference": 0}


def reset_counters() -> None:
    """Zero every kernel launch counter and plain-version call counter."""
    for d in (_LAUNCHES, _CALLS):
        for name in d:
            d[name] = 0


def counters() -> dict:
    return {**_LAUNCHES, **_CALLS}


# -- plain versions -------------------------------------------------------------

def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, T, H, d] → f32 [B, T, Hkv, g, d] (head h = kv head h // g)."""
    b, t, n_heads, d = q.shape
    return q.float().reshape(b, t, n_kv, n_heads // n_kv, d)


def _probabilities(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   lse: Optional[torch.Tensor] = None):
    """Scaled f32 scores [B, Hkv, g, T, T] and the visibility mask; with
    ``lse`` [B*H, T], the normalised probabilities exp(s - lse) instead,
    masked entries exactly 0."""
    b, t, n_heads, d = q.shape
    n_kv = k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(q, n_kv),
                     k.float()) / math.sqrt(d)
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    if lse is None:
        return s, mask
    lse = lse.reshape(b, n_kv, n_heads // n_kv, t, 1)
    return torch.where(mask, torch.exp(s - lse), 0.0)


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: (out [B, T, H, d] in q's dtype, lse [B*H, T]
    f32), every step in f32."""
    _CALLS["flash_forward_reference"] += 1
    b, t, n_heads, d = q.shape
    s, mask = _probabilities(q, k, causal)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float())
    lse = (m + torch.log(l)).reshape(b * n_heads, t)
    return out.reshape(b, t, n_heads, d).to(q.dtype), lse


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True):
    """K6 and K7's plain version: (dq, dk, dv) in the inputs' dtypes from
    the saved ``out`` and ``lse``, every step in f32; dk/dv summed over
    each kv head's query heads."""
    _CALLS["flash_backward_reference"] += 1
    b, t, n_heads, d = q.shape
    n_kv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    p = _probabilities(q, k, causal, lse)              # [B, Hkv, g, T, T]
    do = _grouped(dout, n_kv)                          # [B, T, Hkv, g, d]
    delta = (do * _grouped(out, n_kv)).sum(-1)         # [B, T, Hkv, g]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, _grouped(q, n_kv)) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    return (dq.reshape(b, t, n_heads, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# -- wrappers -------------------------------------------------------------------

def _resolve(t: int, block_q: int, block_k: int) -> None:
    """The JAX package's block contract: each block, clamped to T, must
    divide T. The kernels tile T themselves; the blocks only keep that
    contract."""
    block_q, block_k = min(block_q, t), min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"seq len {t} not divisible by blocks "
                         f"({block_q}/{block_k})")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Validate the shapes; True for the kernel (CUDA tensors), False for
    the plain version (CPU tensors); any other device raises."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q [B, T, H, d] and k/v [B, T, Hkv, d] expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, n_heads, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, t, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if n_heads % k.shape[2]:
        raise ValueError(f"GQA needs n_heads ({n_heads}) divisible by kv "
                         f"heads ({k.shape[2]})")
    if q.device.type == "cpu":
        return False
    if not q.is_cuda:
        raise ValueError(f"flash attention takes CUDA or CPU tensors, got "
                         f"{q.device}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention: head_dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    for x in (k, v):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("flash attention: k/v must have q's dtype and "
                             "device")
    return True


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err:
        from ._build import error_string

        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{error_string(err)} ({err})")


def _operands(*ts: torch.Tensor):
    """Contiguous operands whose rows start 16-byte aligned (the kernels'
    vector loads)."""
    out = tuple(t.contiguous() for t in ts)
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError("flash attention: operands must be 16-byte aligned")
    return out


def _dims(q: torch.Tensor, k: torch.Tensor):
    b, t, n_heads, d = q.shape
    # graftcheck: ignore[host-sync-in-dispatch] — the dtype flag is a host bool
    return b, t, n_heads, k.shape[2], d, int(q.dtype == torch.bfloat16)


def _check_kernel_args(q, k, v, like_q=(), rows=()) -> None:
    """What a kernel launch takes: CUDA q/k/v as ``_check`` validates them,
    ``like_q`` (out, dout) matching q, ``rows`` (lse, delta) [B*H, T] f32
    on q's device."""
    if not _check(q, k, v):
        raise ValueError("flash attention kernels take CUDA tensors")
    b, t, n_heads, _ = q.shape
    for x in like_q:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError("flash attention: out and dout must match q")
    for x in rows:
        if (tuple(x.shape) != (b * n_heads, t) or x.dtype != torch.float32
                or x.device != q.device):
            raise ValueError(f"flash attention: lse and delta must be "
                             f"[B*H={b * n_heads}, T={t}] float32")


def launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, with_lse: bool):
    """K5 on CUDA tensors: (out, lse or None)."""
    _check_kernel_args(q, k, v)
    q, k, v = _operands(q, k, v)
    b, t, n_heads, n_kv, d, bf16 = _dims(q, k)
    out = torch.empty_like(q)
    lse = (torch.empty((b * n_heads, t), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    from ._build import load_library

    err = load_library().flash_forward_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b, t, n_heads, n_kv,
        # graftcheck: ignore[host-sync-in-dispatch] — causal is a host bool
        d, int(causal), bf16, _stream(q))
    _raise_on(err, "flash_forward")
    _LAUNCHES["flash_forward"] += 1
    return out, lse


def launch_backward_dq(q, k, v, out, lse, dout, causal: bool):
    """K6 on CUDA tensors: (dq, delta [B*H, T] f32 = rowsum(dout * out))."""
    _check_kernel_args(q, k, v, (out, dout), (lse,))
    q, k, v, out, dout, lse = _operands(q, k, v, out, dout, lse)
    b, t, n_heads, n_kv, d, bf16 = _dims(q, k)
    dq = torch.empty_like(q)
    delta = torch.empty((b * n_heads, t), dtype=torch.float32,
                        device=q.device)
    from ._build import load_library

    err = load_library().flash_backward_dq_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(lse), _ptr(dq),
        # graftcheck: ignore[host-sync-in-dispatch] — causal is a host bool
        _ptr(delta), b, t, n_heads, n_kv, d, int(causal), bf16, _stream(q))
    _raise_on(err, "flash_backward_dq")
    _LAUNCHES["flash_backward_dq"] += 1
    return dq, delta


def launch_backward_dkv(q, k, v, lse, delta, dout, causal: bool):
    """K7 on CUDA tensors: (dk, dv) in k's layout."""
    _check_kernel_args(q, k, v, (dout,), (lse, delta))
    q, k, v, dout, lse, delta = _operands(q, k, v, dout, lse, delta)
    b, t, n_heads, n_kv, d, bf16 = _dims(q, k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    from ._build import load_library

    err = load_library().flash_backward_dkv_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta),
        # graftcheck: ignore[host-sync-in-dispatch] — causal is a host bool
        _ptr(dk), _ptr(dv), b, t, n_heads, n_kv, d, int(causal), bf16,
        _stream(q))
    _raise_on(err, "flash_backward_dkv")
    _LAUNCHES["flash_backward_dkv"] += 1
    return dk, dv


@leaf_op
def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, with_lse: bool = True):
    """(out [B, T, H, d] in q's dtype, lse [B*H, T] f32 or None): K5 on
    CUDA tensors (``with_lse=False`` skips the lse write), the plain
    version on CPU tensors."""
    if q.is_cuda:
        return launch_forward(q, k, v, causal, with_lse)
    _check(q, k, v)
    out, lse = flash_forward_reference(q, k, v, causal)
    return out, (lse if with_lse else None)


@leaf_op
def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   causal: bool = True):
    """(dq, dk, dv): K6 then K7 on CUDA tensors, the plain version on CPU
    tensors."""
    if not q.is_cuda:
        _check(q, k, v)
        return flash_backward_reference(q, k, v, out, lse, dout, causal)
    dq, delta = launch_backward_dq(q, k, v, out, lse, dout, causal)
    dk, dv = launch_backward_dkv(q, k, v, lse, delta, dout, causal)
    return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 256,
                    block_k: int = 512) -> torch.Tensor:
    """Drop-in for dense_attention: q [B, T, H, d], k/v [B, T, Hkv, d] →
    [B, T, H, d], forward only (no lse written). T must divide by the
    blocks clamped to T, as in the JAX package."""
    _resolve(q.shape[1], block_q, block_k)
    return flash_forward(q, k, v, causal, with_lse=False)[0]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, block_q: int = 256,
                         block_k: int = 512) -> torch.Tensor:
    """Differentiable flash attention, flash cost forward and backward;
    the contract of ``flash_attention`` (GQA: dk/dv sum over each kv
    head's query heads)."""
    _resolve(q.shape[1], block_q, block_k)
    return _FlashAttention.apply(q, k, v, causal)
