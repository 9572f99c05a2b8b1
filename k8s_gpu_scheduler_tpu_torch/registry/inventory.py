"""Typed registry schema of the port (copy of the JAX package's
``registry/inventory.py``): the key layout, the workload observation, and
the node inventory (``ChipInfo``, ``NodeInventory``) that the node agent
writes and the scheduler reads. The JSON of ``NodeInventory.to_json`` is
the JAX package's byte for byte, so either package reads the other's."""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

# Key layout in the registry (db 0).
NODE_KEY_PREFIX = "node/"          # node/<name>   -> NodeInventory JSON
HEARTBEAT_SUFFIX = "/heartbeat"    # node/<name>/heartbeat -> unix ts
OBSERVED_KEY_PREFIX = "observed/"  # observed/<workload>/<column> -> Observation
LATENCY_KEY_PREFIX = "latency/"    # latency/<workload>/<column> -> p99 ms
REPLICA_KEY_PREFIX = "replica/"    # replica/<fleet>/<id> -> ReplicaSummary


def node_key(node_name: str) -> str:
    return NODE_KEY_PREFIX + node_name


def replica_key(fleet: str, replica: str) -> str:
    """Serving-replica state summary published for the cache-aware
    router (fleet/summary.py) — the serving-tier analogue of the
    reference's per-node GPU-UUID keys: each replica writes its radix
    digest + pool watermarks here, the router lists them with the same
    chunked-MGET pattern ``list_inventories`` uses."""
    return f"{REPLICA_KEY_PREFIX}{fleet}/{replica}"


def latency_key(workload: str, column: str) -> str:
    """Collector-folded MEASURED p99 per (workload, partition size) — what
    Score/rightsize consult so placement answers to observed latency, not
    only predicted QPS. Columns use the workload publisher's
    chips-based convention ({chips}P_{GEN}) — both ends of this key are
    owned by this codebase, so the convention is self-consistent."""
    return f"{LATENCY_KEY_PREFIX}{workload}/{column}"


def observed_key(workload: str, column: str, co_located: bool = False) -> str:
    """Solo and co-located samples get DISTINCT keys: they feed different
    matrices (configurations vs interference), and sharing one key would
    let whichever replica wrote last clobber the other stream."""
    suffix = "/co" if co_located else ""
    return f"{OBSERVED_KEY_PREFIX}{workload}/{column}{suffix}"


@dataclass
class Observation:
    """One measured workload throughput sample, published by the workload
    itself (models print tok/s; models/llama.py pushes it here when the
    registry env is set). The recommender's Collector folds these back into
    the train matrices — closing the loop BASELINE's north star describes
    ("right-sizes pod requests against observed step utilization").

    ``neighbors`` names the workloads co-located on the same partition when
    the sample was taken (the scheduler injects them as TPU_NEIGHBORS at
    PostBind). A sample WITH neighbors is an interference measurement — the
    collector folds its throughput DELTA vs the solo configurations cell
    into the interference matrix; a sample without neighbors is the solo
    throughput itself."""

    workload: str      # train-matrix row label, e.g. llama3_8b_serve
    column: str        # train-matrix column, e.g. 4P_V5E
    qps: float         # observed throughput (requests/s or steps/s)
    at: float = 0.0    # unix ts of the sample
    neighbors: List[str] = field(default_factory=list)
    # Measured per-request p99 latency (serving engines report it from
    # ContinuousBatcher.pop_request_metrics); 0 = not measured. The
    # collector folds it into latency/<workload>/<column> so the scheduler
    # right-sizes against observed latency.
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


@dataclass
class ChipInfo:
    """One TPU chip as the agent sees it (device id within the host)."""

    device_id: int
    # Torus coordinates of the chip within its slice, e.g. [0, 1] / [0, 1, 0].
    coords: List[int] = field(default_factory=list)
    # Live utilization 0..1 (MXU duty cycle), HBM bytes.
    duty_cycle: float = 0.0
    hbm_used_bytes: int = 0
    hbm_total_bytes: int = 0


@dataclass
class NodeInventory:
    node_name: str
    # GKE label values: accelerator type + slice topology.
    accelerator: str = ""
    topology: str = ""
    chips: List[ChipInfo] = field(default_factory=list)
    # Worker index of this host within a multi-host slice (the value the
    # scheduler injects as TPU_WORKER_ID's base).
    worker_id: int = 0
    # Mean MXU duty cycle over the chips, 0..1 — the Score input replacing
    # the reference's DCGM_FI_PROF_GR_ENGINE_ACTIVE (prom_metrics.go:64).
    utilization: float = 0.0
    published_at: float = 0.0

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(raw: str) -> "NodeInventory":
        d = json.loads(raw)
        chips = [ChipInfo(**c) for c in d.pop("chips", [])]
        return NodeInventory(chips=chips, **d)


def publish_inventory(client, inv: NodeInventory) -> None:
    """Agent-side write (parity: profiler client Set(nodeName, jsonUuids),
    cmd/client/client.go:70-79 — but typed)."""
    client.set(node_key(inv.node_name), inv.to_json())


def read_inventory(client, node_name: str) -> Optional[NodeInventory]:
    """Scheduler-side read (parity: redis Get(nodeName) + JSON decode,
    gpu_plugins.go:536-542)."""
    raw = client.get(node_key(node_name))
    if raw is None:
        return None
    try:
        return NodeInventory.from_json(raw)
    except (ValueError, TypeError, KeyError):
        return None


def list_inventories(client) -> Dict[str, NodeInventory]:
    keys = [k for k in client.get_keys(NODE_KEY_PREFIX + "*")
            if not k.endswith(HEARTBEAT_SUFFIX)]
    if not keys:
        return {}
    # One MGET round trip per 512 keys (N+1 GETs before — at 256 nodes
    # that was 257 network round trips per listing). Chunked: kvstored's
    # RESP reader caps a command at 1024 array elements, so an unchunked
    # fleet-wide MGET would hard-drop the connection at >=1023 nodes.
    # Registries without mget (test fakes, plain KV stores) keep the
    # per-key path.
    mget = getattr(client, "mget", None)
    if callable(mget):
        values: List[Optional[str]] = []
        for i in range(0, len(keys), 512):
            values.extend(mget(*keys[i:i + 512]))
    else:
        values = [client.get(k) for k in keys]
    out: Dict[str, NodeInventory] = {}
    for raw in values:
        if raw is None:
            continue
        try:
            inv = NodeInventory.from_json(raw)
        except (ValueError, TypeError, KeyError):
            continue
        out[inv.node_name] = inv
    return out
