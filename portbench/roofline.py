"""The yardstick's arithmetic: the H100's peaks, the least time a piece of
work can take on it, and the operations and bytes of the flash attention
kernels and of a training token. Bytes count each input read once and each output
written once; operations count the work these inputs need."""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card can take: bytes at full bandwidth or
    operations at the bf16 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def flash_costs(batch: int, seq: int, n_heads: int, n_kv_heads: int,
                head_dim: int) -> Dict[str, Dict[str, float]]:
    """Bytes and operations of one causal bf16 launch of K5 (forward), K6
    (dq) and K7 (dk, dv) over [batch, seq] with these heads, counted as
    the kernel smoke test counts them (``chip_smoke.flash_cases``)."""
    pairs = batch * n_heads * seq * (seq + 1) // 2
    e = 2
    qb = batch * seq * n_heads * head_dim * e
    kvb = batch * seq * n_kv_heads * head_dim * e
    lseb = batch * n_heads * seq * 4
    return {
        "flash_forward": {"bytes": float(qb + 2 * kvb + qb + lseb),
                          "flops": float(2 * 2 * pairs * head_dim)},
        "flash_backward_dq": {"bytes": float(3 * qb + 2 * kvb + lseb + qb
                                             + lseb),
                              "flops": float(3 * 2 * pairs * head_dim)},
        "flash_backward_dkv": {"bytes": float(2 * qb + 2 * kvb + 2 * lseb
                                              + 2 * kvb),
                               "flops": float(4 * 2 * pairs * head_dim)}}


def flash_step_bound_s(batch: int, seq: int, n_heads: int, n_kv_heads: int,
                       head_dim: int, layers: int, forwards: int = 2) -> float:
    """K5 + K6 + K7 of one training step: ``forwards`` K5 launches a layer
    (the forward and its recompute under remat), one K6 and one K7."""
    c = {k: bound_s(v["bytes"], v["flops"]) for k, v in
         flash_costs(batch, seq, n_heads, n_kv_heads, head_dim).items()}
    return layers * (forwards * c["flash_forward"] + c["flash_backward_dq"]
                     + c["flash_backward_dkv"])


def active_matmul_params(cfg: Dict) -> float:
    """Parameters a token multiplies by in a dense decoder: q/k/v/o, the
    SwiGLU and the output head. The embedding is a lookup and is not
    counted."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    return cfg["num_hidden_layers"] * (attn + 3 * d * f) \
        + d * cfg["vocab_size"]


def train_token_flops(cfg: Dict, seq: int) -> float:
    """Model operations of one training token (forward and backward, no
    recompute): 6 per active parameter plus causal attention, 6 * L * d *
    T (QK^T and PV at half the pairs, three times for the backward)."""
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    return 6.0 * active_matmul_params(cfg) + 6.0 * layers * d * seq
