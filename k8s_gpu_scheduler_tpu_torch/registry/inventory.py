"""Registry key layout and the workload observation schema (trimmed copy
of the JAX package's ``registry/inventory.py``: the keys the workload
publisher and the fleet write, and ``Observation``)."""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import List

OBSERVED_KEY_PREFIX = "observed/"  # observed/<workload>/<column> -> Observation
LATENCY_KEY_PREFIX = "latency/"    # latency/<workload>/<column> -> p99 ms
REPLICA_KEY_PREFIX = "replica/"    # replica/<fleet>/<id> -> ReplicaSummary


def replica_key(fleet: str, replica: str) -> str:
    """Where a serving replica publishes its state summary for the
    cache-aware router (``fleet/summary.py``)."""
    return f"{REPLICA_KEY_PREFIX}{fleet}/{replica}"


def latency_key(workload: str, column: str) -> str:
    """Collector-folded measured p99 per (workload, partition size)."""
    return f"{LATENCY_KEY_PREFIX}{workload}/{column}"


def observed_key(workload: str, column: str, co_located: bool = False) -> str:
    """Solo and co-located samples get distinct keys: they feed different
    matrices (configurations vs interference)."""
    suffix = "/co" if co_located else ""
    return f"{OBSERVED_KEY_PREFIX}{workload}/{column}{suffix}"


@dataclass
class Observation:
    """One measured workload throughput sample, published by the workload
    itself. ``neighbors`` names the workloads co-located on the same
    partition when the sample was taken (an interference measurement when
    not empty); ``p99_ms`` is the measured per-request p99 latency (0 =
    not measured)."""

    workload: str      # train-matrix row label, e.g. llama3_8b_serve
    column: str        # train-matrix column, e.g. 4P_V5E
    qps: float         # observed throughput (requests/s or steps/s)
    at: float = 0.0    # unix ts of the sample
    neighbors: List[str] = field(default_factory=list)
    p99_ms: float = 0.0

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(raw: str) -> "Observation":
        d = json.loads(raw)
        return Observation(
            workload=d.get("workload", ""), column=d.get("column", ""),
            qps=float(d.get("qps", 0.0)), at=float(d.get("at", 0.0)),
            neighbors=[str(n) for n in d.get("neighbors", [])],
            p99_ms=float(d.get("p99_ms", 0.0)),
        )
