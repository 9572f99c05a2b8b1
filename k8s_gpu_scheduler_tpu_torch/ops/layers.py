"""Transformer primitives: RMSNorm, RoPE, SwiGLU (port of the JAX
package's ``ops/layers.py``). Norm statistics and rotations compute in
f32 whatever the activation dtype; RoPE rotates half-split channel pairs
(``x[..., :hd/2]`` with ``x[..., hd/2:]``), not interleaved ones."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant import Weight, qdot


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * weight


def rope_freqs(head_dim: int, max_len: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """[max_len, head_dim//2] f32 rotation angles."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=device), exps)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate half-split channel pairs. x: [..., T, H, hd]; angles:
    [..., T, hd/2] (broadcast over the head axis)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(angles).unsqueeze(-2)
    sin = torch.sin(angles).unsqueeze(-2)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: Weight, w_up: Weight,
           w_down: Weight) -> torch.Tensor:
    """down(silu(x @ gate) * (x @ up)); weights plain or int8."""
    g = F.silu(qdot(x, w_gate))
    return qdot(g * qdot(x, w_up), w_down)
