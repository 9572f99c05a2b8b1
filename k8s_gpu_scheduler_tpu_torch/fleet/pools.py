"""Pool sizing for disaggregated serving (copy of the JAX package's
``fleet/pools.py``): the two pools scale in different units.

Prefill is compute-bound and parallel across requests, so the prefill
pool scales out: the plan's unit is a replica count, driven by the
queued prefill tokens the summaries publish (``prefill_backlog_tokens``).
Decode is bound by KV residency, so the decode pool scales up: the unit
is pages per replica, driven by the free-page and free-slot watermarks.

Everything here is a pure function of published summaries —
deterministic and advisory: the in-process fleet cannot spawn replicas,
so :meth:`Router.pool_plan` returns the plan and the operator acts on it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

from .summary import ReplicaSummary

__all__ = ["PoolPolicy", "PoolPlan", "plan_pools"]


@dataclass(frozen=True)
class PoolPolicy:
    """Knobs for :func:`plan_pools`.

    ``prefill_tokens_per_replica`` is the backlog one prefill replica
    is expected to chew through within SLO — desired prefill replicas =
    ceil(total backlog / this). ``decode_free_page_frac_low`` /
    ``decode_free_slot_frac_low`` are the watermarks below which the
    decode pool is declared capacity-starved; ``decode_page_headroom``
    is the pool-size multiplier the plan then asks for."""

    prefill_tokens_per_replica: int = 4096
    decode_free_page_frac_low: float = 0.15
    decode_free_slot_frac_low: float = 0.25
    decode_page_headroom: float = 2.0

    def __post_init__(self) -> None:
        if self.prefill_tokens_per_replica < 1:
            raise ValueError(
                f"prefill_tokens_per_replica must be >= 1, got "
                f"{self.prefill_tokens_per_replica}")
        for name in ("decode_free_page_frac_low",
                     "decode_free_slot_frac_low"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if self.decode_page_headroom < 1.0:
            raise ValueError(
                f"decode_page_headroom must be >= 1.0, got "
                f"{self.decode_page_headroom}")


@dataclass(frozen=True)
class PoolPlan:
    """One advisory sizing decision, in each pool's own unit."""

    prefill_replicas: int            # currently summarized
    prefill_replicas_desired: int    # scale-OUT target (replica count)
    prefill_backlog_tokens: int      # fleet-wide queued prefill tokens
    decode_replicas: int             # currently summarized
    decode_scale_up: bool            # below a capacity watermark?
    decode_pages_total: int          # pool pages across decode replicas
    decode_pages_desired: int        # scale-UP target (pages)
    reasons: Tuple[str, ...]         # human-readable derivation


def plan_pools(summaries: Dict[str, ReplicaSummary],
               pools: Dict[str, Sequence[str]],
               policy: PoolPolicy = PoolPolicy()) -> PoolPlan:
    """Size the two pools from published summaries — pure and
    deterministic (same summaries, same plan). Replicas without a
    summary (dead, or the plane dropped a write) simply don't
    contribute: the plan is computed over what is OBSERVED, the same
    bounded-staleness posture routing takes."""
    reasons = []
    pre = [summaries[r] for r in pools["prefill"] if r in summaries]
    dec = [summaries[r] for r in pools["decode"] if r in summaries]

    backlog = sum(max(0, int(s.prefill_backlog_tokens)) for s in pre)
    desired = max(1, math.ceil(
        backlog / policy.prefill_tokens_per_replica))
    if desired > len(pre):
        reasons.append(
            f"prefill: {backlog} backlog tokens need {desired} "
            f"replicas at {policy.prefill_tokens_per_replica} "
            f"tokens/replica (have {len(pre)})")
    else:
        reasons.append(
            f"prefill: {backlog} backlog tokens fit "
            f"{len(pre)} replicas")

    pages_total = sum(int(s.pages_total) for s in dec)
    scale_up = False
    for s in dec:
        if s.free_frac < policy.decode_free_page_frac_low:
            scale_up = True
            reasons.append(
                f"decode: {s.replica} free-page frac "
                f"{s.free_frac:.3f} < "
                f"{policy.decode_free_page_frac_low}")
        if s.free_slot_frac < policy.decode_free_slot_frac_low:
            scale_up = True
            reasons.append(
                f"decode: {s.replica} free-slot frac "
                f"{s.free_slot_frac:.3f} < "
                f"{policy.decode_free_slot_frac_low}")
    pages_desired = (math.ceil(pages_total * policy.decode_page_headroom)
                     if scale_up else pages_total)
    if not scale_up:
        reasons.append("decode: above both watermarks")
    return PoolPlan(
        prefill_replicas=len(pre),
        prefill_replicas_desired=desired,
        prefill_backlog_tokens=backlog,
        decode_replicas=len(dec),
        decode_scale_up=scale_up,
        decode_pages_total=pages_total,
        decode_pages_desired=pages_desired,
        reasons=tuple(reasons),
    )
