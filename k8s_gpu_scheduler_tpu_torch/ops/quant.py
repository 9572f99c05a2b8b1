"""Weight-only int8 quantization for serving (port of the JAX package's
``ops/quant.py``).

Scheme: symmetric per-output-channel int8. For a weight ``w [..., K, N]``
(``x @ w`` orientation, K = contraction dim), ``s = max|w| / 127`` over K
gives ``s [..., 1, N]`` and ``q = round(w / s)``; by linearity
``(x @ q) * s == x @ (q * s)``, so ``qdot`` applies the scale after the
matmul. ``qdot`` stays a PyTorch op: the JAX package left the int8
convert to XLA's fusion, and no Pallas kernel sits behind it. Expert
stacks (``[E, D, F]``, ``[E, F, D]``) quantize by the same rule, one scale
per (expert, channel), and go through ``qeinsum``; the f32 router is
never quantized.

A quantized weight is an ``Int8Weight`` module (buffers ``q`` int8 and
``s`` f32) or, for functional callers, a ``{"q", "s"}`` dict.
"""
from __future__ import annotations

import copy
from typing import Dict, Union

import torch
from torch import nn

# Block weights that are matmul operands; norms and the embedding gather
# stay in the model dtype.
BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class Int8Weight(nn.Module):
    """A quantized matmul weight: ``q`` int8 [..., K, N], ``s`` f32
    [..., 1, N]."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)

    def __getitem__(self, key: str) -> torch.Tensor:
        return {"q": self.q, "s": self.s}[key]


Weight = Union[torch.Tensor, Int8Weight, Dict[str, torch.Tensor]]


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w [..., K, N] → {"q": int8, "s": f32 [..., 1, N]}; exact for the
    all-zero channel (scale floored). ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    w32 = w.float()
    return _quantize(w32, w32.abs().amax(dim=-2, keepdim=True))


def _quantize(w32: torch.Tensor, amax: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """``quantize_weight``'s rule from the per-channel ``max|w|``."""
    s = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_weight(wq: Weight, dtype: torch.dtype) -> torch.Tensor:
    return (wq["q"].float() * wq["s"]).to(dtype)


def qdot(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x @ w for a plain tensor or a quantized weight. The int8 operand is
    converted to x's dtype for the product; the per-channel scale applies
    to the [..., N] result in f32."""
    if isinstance(w, (Int8Weight, dict)):
        y = x @ w["q"].to(x.dtype)
        return (y.float() * w["s"]).to(x.dtype)
    return x @ w


def qeinsum(spec: str, x: torch.Tensor, w: Weight) -> torch.Tensor:
    """``einsum(spec, x, w)`` for a plain or quantized expert stack, for
    the two MoE specs ``"btd,edf->betf"`` and ``"betf,efd->betd"``. Each
    is one batched matmul over the expert axis into ``[E, B·T, N]``, where
    an int8 stack's ``[E, 1, N]`` scale applies in f32; the result is a
    ``[B, E, T, N]`` view of it. (``torch.einsum`` would copy the whole
    ``[E, D, F]`` weight for the first spec, to put its contraction axis
    first.)"""
    quantized = isinstance(w, (Int8Weight, dict))
    wt = w["q"].to(x.dtype) if quantized else w
    E, N = wt.shape[0], wt.shape[-1]
    if spec == "btd,edf->betf":
        B, T, _ = x.shape
        lhs = x.reshape(1, B * T, -1)
    elif spec == "betf,efd->betd":
        B, _, T, _ = x.shape
        lhs = x.transpose(0, 1).reshape(E, B * T, -1)
    else:
        raise ValueError(f"qeinsum: unsupported spec {spec!r}")
    y = torch.matmul(lhs, wt)
    if quantized:
        y = (y.float() * w["s"]).to(x.dtype)
    return y.view(E, B, T, N).transpose(0, 1)


def quantize_llama_params(model: nn.Module, mesh=None) -> nn.Module:
    """A copy of a ``models.llama.Llama`` with every block matmul weight
    (expert stacks included) and the lm_head replaced by ``Int8Weight``
    modules (the JAX function's tree rewrite, on modules). The source model
    is left untouched.

    ``mesh`` (a mesh of more than one rank; every rank calls this):
    ``model`` is this rank's training blocks (``init_params(..., mesh=)``)
    and each scale still spans the whole contraction dim K: the rank's
    ``max|w|`` over its rows is max-reduced over the axes that split K in
    ``param_specs`` (fsdp for q/k/v/gate/up and the lm_head, tp for o and
    down, the same for the expert stacks), so every rank holds exactly its
    cut of the one-card quantization, ``q`` and ``s``, and no rank ever
    holds a whole leaf."""
    from ..models.llama import _mesh_axes, _spec_axes, leaf_specs
    from ..parallel.collectives import all_max_

    ax = _mesh_axes(mesh)
    specs = leaf_specs(model.cfg) if ax is not None else {}

    def quantize(name: str, w: torch.Tensor) -> Int8Weight:
        w32 = w.detach().float()
        amax = w32.abs().amax(dim=-2, keepdim=True)
        if ax is not None:                  # K's axes, in one order
            for axis in sorted(_spec_axes(specs[name][-2:-1])):
                all_max_(amax, ax.group(axis))
        return Int8Weight(**_quantize(w32, amax))

    out = copy.deepcopy(model)
    for i, blk in enumerate(out.blocks):
        for name in BLOCK_WEIGHTS:
            w = getattr(blk, name)
            delattr(blk, name)
            setattr(blk, name, quantize(f"blocks.{i}.{name}", w))
    w = out.lm_head
    del out.lm_head
    out.lm_head = quantize("lm_head", w)
    return out
