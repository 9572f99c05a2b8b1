"""Workload-side enforcement of the scheduler-injected sharing limits
(port of the JAX package's ``utils/enforcement.py``).

The scheduler injects the same environment it injects for the JAX
workloads (``TPU_HBM_LIMIT_BYTES``, ``TPU_DUTY_CYCLE_PERCENTAGE``,
``TPU_VISIBLE_CHIPS``); every entry point calls ``apply_env_limits()``
before it allocates on the card:

- **Memory**: the partition's byte budget, split evenly over the visible
  chips, becomes a fraction of the card's memory
  (``torch.cuda.get_device_properties(device).total_memory``) and is set
  with ``torch.cuda.set_per_process_memory_fraction``. Where the JAX
  package writes ``XLA_PYTHON_CLIENT_MEM_FRACTION`` before the backend
  initialises, this call needs an initialised device, and it caps only
  PyTorch's caching allocator: memory taken outside it (the CUDA context,
  cuBLAS workspaces, another library's allocations) is not counted. A pod
  that overflows its share gets an out-of-memory error from the
  allocator instead of evicting its neighbour's working set.
- **Duty cycle**: a host-side pacing throttle between steps — after each
  active interval of t seconds the workload sleeps t*(100-pct)/pct, so
  its duty ratio converges to pct/100 (the arithmetic is JAX's, letter
  for letter).
"""
from __future__ import annotations

import os
import time
from typing import Mapping, Optional

import torch

from ..device import resolve_device

ENV_HBM_LIMIT = "TPU_HBM_LIMIT_BYTES"
ENV_DUTY_PCT = "TPU_DUTY_CYCLE_PERCENTAGE"
ENV_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"

# A fully debited partition (a limit of 0) keeps a 1 % share, so the
# process can start and its first real allocation is what fails.
MIN_FRACTION = 0.01


def hbm_fraction(env: Mapping[str, str], per_chip_bytes: int
                 ) -> Optional[float]:
    """The memory fraction ``env``'s limit leaves each visible chip of
    ``per_chip_bytes``, or None when no cap applies (limit absent,
    malformed or negative)."""
    raw = env.get(ENV_HBM_LIMIT)
    if not raw:
        return None
    try:
        limit = int(raw)
    except ValueError:
        return None
    if limit < 0:
        return None
    chips = len([c for c in env.get(ENV_VISIBLE_CHIPS, "").split(",") if c])
    chips = max(1, chips)
    # The scheduler's cap is the partition total and the fraction is per
    # device: the pod sees exactly the partition's chips, so divide evenly.
    return max(MIN_FRACTION, min(1.0, (limit / chips) / per_chip_bytes))


def apply_hbm_limit(env: Optional[Mapping[str, str]] = None,
                    device="cuda") -> Optional[float]:
    """Cap the caching allocator of ``device`` at the fraction of its
    memory ``TPU_HBM_LIMIT_BYTES`` leaves this pod; returns the fraction
    set, or None when no cap applies. On the CPU there is no allocator to
    cap, and nothing is set."""
    if env is None:
        env = os.environ
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    per_chip = torch.cuda.get_device_properties(dev).total_memory
    fraction = hbm_fraction(env, per_chip)
    if fraction is not None:
        torch.cuda.set_per_process_memory_fraction(fraction, dev)
    return fraction


class DutyCycleThrottle:
    """Inter-step duty-cycle pacing: ``pace(active_s)`` (or the context
    manager) sleeps so that active time stays at ``pct`` percent of wall
    time. Sleep is computed from a running balance rather than per call,
    so many short steps throttle as accurately as few long ones — and
    natural idle between pace() calls pays the debt down first: a loop
    that already sleeps (the 1 Hz publish pacing of the serve loop) is
    under its duty budget and is not slowed further. Banked idle is
    capped (credit_cap_s) so a long warmup cannot buy an unthrottled
    burst later."""

    def __init__(self, pct: int, credit_cap_s: float = 1.0) -> None:
        if not 1 <= pct <= 100:
            raise ValueError(f"duty pct must be in [1, 100], got {pct}")
        self.pct = pct
        self.credit_cap_s = credit_cap_s
        self._debt_s = 0.0
        self._last_mark: Optional[float] = None
        self._t0: Optional[float] = None

    def pace(self, active_s: float) -> float:
        """Record one active interval; sleep off the accumulated idle debt
        (returns the seconds slept)."""
        active_s = max(0.0, active_s)
        now = time.perf_counter()
        if self._last_mark is not None:
            idle = max(0.0, (now - self._last_mark) - active_s)
            self._debt_s = max(-self.credit_cap_s, self._debt_s - idle)
        self._debt_s += active_s * (100.0 - self.pct) / self.pct
        slept = 0.0
        if self._debt_s > 1e-4:
            slept = self._debt_s
            time.sleep(slept)
            self._debt_s = 0.0
        self._last_mark = time.perf_counter()
        return slept

    def __enter__(self) -> "DutyCycleThrottle":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t0, self._t0 = self._t0, None
        if t0 is not None:
            self.pace(time.perf_counter() - t0)


def duty_throttle(env: Optional[Mapping[str, str]] = None
                  ) -> Optional[DutyCycleThrottle]:
    """Build the throttle from TPU_DUTY_CYCLE_PERCENTAGE; None when the
    pod is unthrottled (absent, malformed, or >= 100)."""
    if env is None:
        env = os.environ
    raw = env.get(ENV_DUTY_PCT)
    if not raw:
        return None
    try:
        pct = int(raw)
    except ValueError:
        return None
    if pct >= 100 or pct < 1:
        return None
    return DutyCycleThrottle(pct)


def apply_env_limits(env: Optional[Mapping[str, str]] = None,
                     device="cuda") -> Optional[DutyCycleThrottle]:
    """The one call every entry point makes before allocating on the
    card: cap the allocator at the injected memory share and return the
    duty-cycle throttle (None = run unthrottled)."""
    apply_hbm_limit(env, device)
    return duty_throttle(env)
