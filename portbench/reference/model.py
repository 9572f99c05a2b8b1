"""The dense decoder, written out from the published description (Mistral
7B, arXiv:2310.06825) in plain float32 PyTorch, one sequence at a time.

Pre-norm blocks: RMSNorm (weight after the normalised f32 activations),
grouped-query attention with rotary position embedding over half-split
channel pairs (theta from the config), causal; then RMSNorm and a SwiGLU
feed-forward. A final RMSNorm and the output head give the logits.

Departure, stated in the configuration files: RMSNorm's epsilon is the
config's ``rms_norm_eps`` as run (1e-6, the port's fixed value), not the
published 1e-5.

``lowp="fp8"`` is the control: every weight product takes operands
rounded to float8 e4m3 (a per-tensor scale to the format's largest value),
the precision a later change could be tempted to train in; its gradients
are rounded to float8 e5m2.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

def precise() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    top = torch.finfo(fmt).max
    scale = top / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(fmt).to(torch.float32) / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        return gq @ wq.t(), xq.t() @ gq


def mm(x: torch.Tensor, w: torch.Tensor, lowp: Optional[str] = None
       ) -> torch.Tensor:
    """x [N, K] @ w [K, M] in float32, or with float8 operands
    (``lowp="fp8"``)."""
    if lowp == "fp8":
        return _Fp8MatMul.apply(x, w)
    if lowp:
        raise ValueError(f"lowp {lowp!r}: None or 'fp8'")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, hd] rotated at positions ``pos`` [T]: channel i pairs with
    i + hd/2, at angle pos * theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal grouped-query attention of one sequence: q [T, H, hd], k/v
    [T, Hkv, hd] -> [T, H * hd]."""
    T, H, hd = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(T, H * hd)


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Dict,
          pos: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    """One decoder block over one sequence's rows x [T, D]."""
    T = x.shape[0]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = rms_norm(x, w["attn_norm"], eps)
    q = rope(mm(h, w["wq"], lowp).reshape(T, H, hd), pos, theta)
    k = rope(mm(h, w["wk"], lowp).reshape(T, Hkv, hd), pos, theta)
    v = mm(h, w["wv"], lowp).reshape(T, Hkv, hd)
    x = x + mm(attention(q, k, v), w["wo"], lowp)
    h = rms_norm(x, w["mlp_norm"], eps)
    return x + mm(F.silu(mm(h, w["w_gate"], lowp)) * mm(h, w["w_up"], lowp),
                  w["w_down"], lowp)
