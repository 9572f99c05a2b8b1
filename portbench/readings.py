"""What the metric readers in ``metrics/`` share: each reader is one line
that names its function here. A reader gets the run's context (``ctx``:
the configuration, the window's steps, the loop's host spans, the device
trace of the traced run) and returns a number, or None where the run
holds nothing for it to read."""
from __future__ import annotations

from typing import Dict, Optional

from .roofline import PEAK_BF16_FLOPS, flash_step_bound_s, train_token_flops


def _dims(cfg: Dict):
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return H, Hkv, cfg["hidden_size"] // H, cfg["num_hidden_layers"]


def _pct(x: float) -> float:
    return 100.0 * x


# -- end to end -------------------------------------------------------------
def train_tok_s(ctx) -> Optional[float]:
    """B * T for every step of the window, over the window's seconds."""
    if not hasattr(ctx, "batch"):
        return None
    s = ctx.steps
    return ctx.batch * ctx.seq * len(s) / (s[-1][1] - s[0][0])


def setup_s(ctx) -> float:
    return ctx.setup_s


# -- per layer ----------------------------------------------------------------
def device_idle(ctx) -> Optional[float]:
    """One minus the union of the device's operations over the traced
    window."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return _pct(1.0 - t.busy_s / t.window_s)


def _is_flash(name: str) -> bool:
    return any(k in name for k in ("flash_fwd_mma_kernel",
                                   "flash_bwd_dq_mma_kernel",
                                   "flash_bwd_dkv_mma_kernel"))


def flash_roofline(ctx) -> Optional[float]:
    """The least time of K5 (twice a layer: forward and recompute), K6
    and K7 at the step's shapes, for the traced steps, over their device
    time."""
    if getattr(ctx, "trace", None) is None or not hasattr(ctx, "batch"):
        return None
    H, Hkv, hd, L = _dims(ctx.cfg)
    need = ctx.traced_steps * flash_step_bound_s(ctx.batch, ctx.seq, H, Hkv,
                                                 hd, L)
    got = ctx.trace.seconds(_is_flash)
    return _pct(need / got) if got > 0 else None


def train_mfu(ctx) -> Optional[float]:
    """(6 x active parameters + causal attention) x the window's tokens,
    over the seconds of its steps (each ended by a synchronise) at the
    bf16 peak."""
    if not hasattr(ctx, "batch"):
        return None
    tokens = ctx.batch * ctx.seq * len(ctx.steps)
    secs = sum(b - a for a, b in ctx.steps)
    return _pct(train_token_flops(ctx.cfg, ctx.seq) * tokens
                / (secs * PEAK_BF16_FLOPS))
