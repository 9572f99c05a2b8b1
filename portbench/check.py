"""The comparison that decides ``correct``: a training run's first steps
against the float32 reference's."""
from __future__ import annotations

from typing import Dict

import numpy as np


# A leaf whose reference gradient is under this share of the median
# leaf's moves under AdamW by round-off alone.
MOVED_SHARE = 1e-3


def train_gaps(prog: Dict, want: Dict) -> Dict[str, float]:
    """Gaps between the program's and the reference's readings of the
    first steps: the worst step's loss (relative), the worst leaf's first
    gradient norm and its change norm after the steps, each against the
    larger of the reference's norm of that leaf and of the median leaf.
    Leaves whose reference gradient is under ``MOVED_SHARE`` of the
    median leaf's are left out of the change."""
    def worst(vals) -> float:          # NaN, where one is, wins
        return float(np.max(np.asarray(list(vals), dtype=np.float64)))

    loss = worst(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                      want["losses"]))
    g_med = float(np.median(list(want["grad1"].values())))
    c_med = float(np.median(list(want["change"].values())))
    grad = worst(abs(prog["grad1"][n] - g) / max(g, g_med)
                 for n, g in want["grad1"].items())
    change = worst(abs(prog["change"][n] - c) / max(c, c_med)
                   for n, c in want["change"].items()
                   if want["grad1"][n] >= MOVED_SHARE * g_med)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """{name: {value, limit}} for each limited reading."""
    return {k: {"value": readings.get(k, float("nan")), "limit": v}
            for k, v in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
