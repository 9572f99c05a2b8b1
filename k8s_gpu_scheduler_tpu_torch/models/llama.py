"""Llama-family decoder (port of the JAX package's ``models/llama.py``,
inference half).

``Llama`` is an ``nn.Module`` whose ``blocks`` ``ModuleList`` replaces the
JAX package's layer-stacked pytree and ``lax.scan``; weights keep JAX's
``[K, N]`` orientation (``x @ w``), so an int8 weight's per-output-channel
scale stays ``[1, N]`` and the weight bridge (``bridge.py``) is a copy.
Randomness comes only from the ``torch.Generator`` passed to
``init_params``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops.attention import dense_attention
from ..ops.layers import apply_rope, rms_norm, rope_freqs, swiglu
from ..ops.quant import qdot


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "dense"
    # Serving decode attention: "fused" is the paged kernel path (K1/K2),
    # the only one the port's engine serves.
    decode_attn: str = "dense"
    remat: bool = True
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    def __post_init__(self) -> None:
        if self.n_experts > 1:
            raise NotImplementedError(
                "mixture-of-experts configs (n_experts > 1) come with the "
                "training slice of the port")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            d_ff=14336, max_seq=8192)

    @staticmethod
    def serve() -> "LlamaConfig":
        """The ``main --serve`` configuration of the JAX package."""
        return LlamaConfig(
            vocab=32000, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=16,
            d_ff=4096, max_seq=2048, remat=False)

    @staticmethod
    def tiny(attn_impl: str = "dense") -> "LlamaConfig":
        """Test scale: full architecture, toy widths."""
        return LlamaConfig(
            vocab=256, d_model=64, n_layers=2, n_heads=8, n_kv_heads=8,
            d_ff=128, max_seq=128, attn_impl=attn_impl, remat=False)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One decoder block's weights: pre-norm attention + SwiGLU MLP."""

    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        D, H, Hkv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.d_ff)
        dt = cfg.dtype

        def z(*shape):
            return _param(torch.zeros(shape, dtype=dt, device=device))

        self.attn_norm = _param(torch.ones(D, dtype=dt, device=device))
        self.wq, self.wk, self.wv = z(D, H * hd), z(D, Hkv * hd), z(D, Hkv * hd)
        self.wo = z(H * hd, D)
        self.mlp_norm = _param(torch.ones(D, dtype=dt, device=device))
        self.w_gate, self.w_up, self.w_down = z(D, F), z(D, F), z(F, D)


class Llama(nn.Module):
    """The decoder's weights (``embed [V, D]``, ``blocks``, ``final_norm``,
    ``lm_head [D, V]``); ``forward(tokens)`` is the dense causal forward."""

    def __init__(self, cfg: LlamaConfig, device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = _param(torch.zeros(cfg.vocab, cfg.d_model,
                                        dtype=cfg.dtype, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(torch.ones(cfg.d_model, dtype=cfg.dtype,
                                            device=device))
        self.lm_head = _param(torch.zeros(cfg.d_model, cfg.vocab,
                                          dtype=cfg.dtype, device=device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device="cuda") -> Llama:
    """Random weights: normal(0, 0.02) matrices (drawn in f32, cast to the
    model dtype) and unit norms, from ``generator`` alone. The draws are
    made on the CPU so a seed gives the same weights on every device."""
    model = Llama(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm"):
                continue
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32) * 0.02
            p.copy_(w.to(cfg.dtype))
    return model


def attn_sublayer(cfg: LlamaConfig, x: torch.Tensor, blk: Block,
                  angles: torch.Tensor, attention_fn) -> torch.Tensor:
    B, T, _ = x.shape
    h = rms_norm(x, blk.attn_norm)
    q = qdot(h, blk.wq).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = qdot(h, blk.wk).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = qdot(h, blk.wv).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, angles), apply_rope(k, angles)
    attn = attention_fn(q, k, v)
    return x + qdot(attn.reshape(B, T, cfg.n_heads * cfg.head_dim), blk.wo)


def mlp_sublayer(cfg: LlamaConfig, x: torch.Tensor,
                 blk: Block) -> torch.Tensor:
    h = rms_norm(x, blk.mlp_norm)
    return x + swiglu(h, blk.w_gate, blk.w_up, blk.w_down)


def forward(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] → logits [B, T, vocab] f32."""
    logits, _ = forward_with_aux(model, tokens)
    return logits


def forward_with_aux(model: Llama, tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [B, T, vocab] f32, balance aux — 0.0, dense configs only).
    Dense causal attention; the flash and sequence-parallel attention
    implementations come with the training and multi-device slices."""
    cfg = model.cfg
    if cfg.attn_impl != "dense":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r}: the port's forward is dense; "
            f"flash attention (K5-K7) comes with the training slice")
    B, T = tokens.shape
    angles = rope_freqs(cfg.head_dim, T, cfg.rope_theta, device=model.device)
    x = model.embed[tokens].to(cfg.dtype)
    for blk in model.blocks:
        x = attn_sublayer(cfg, x, blk, angles,
                          lambda q, k, v: dense_attention(q, k, v, True))
        x = mlp_sublayer(cfg, x, blk)
    x = rms_norm(x, model.final_norm)
    logits = qdot(x, model.lm_head).float()
    return logits, torch.zeros((), dtype=torch.float32, device=model.device)
