"""Fleet serving tier of the port (copies of the JAX package's ``fleet/``
modules): cache-aware routing, load shedding, crash tolerance (replica
health states, a durable request journal, failover by deterministic
replay) and disaggregated prefill/decode pools over N paged
``ContinuousBatcher`` replicas (``router.py``, ``summary.py``,
``health.py``, ``journal.py``, ``pools.py``)."""
from .health import (
    DEAD, HealthMonitor, HealthPolicy, LIVE, QUARANTINED, REJOINING,
    ReplicaHealth, STATES, SUSPECT,
)
from .journal import (
    DONE, ERROR, EXPIRED, JournalEntry, JournalError, RequestJournal,
)
from .pools import PoolPlan, PoolPolicy, plan_pools
from .router import FleetError, Router
from .summary import (
    MemoryStore, ReplicaSummary, list_summaries, prefix_match_len,
    prefix_match_parts, publish_summary, summarize,
)

__all__ = [
    "DEAD",
    "DONE",
    "ERROR",
    "EXPIRED",
    "FleetError",
    "HealthMonitor",
    "HealthPolicy",
    "JournalEntry",
    "JournalError",
    "LIVE",
    "MemoryStore",
    "PoolPlan",
    "PoolPolicy",
    "QUARANTINED",
    "REJOINING",
    "ReplicaHealth",
    "ReplicaSummary",
    "RequestJournal",
    "Router",
    "STATES",
    "SUSPECT",
    "list_summaries",
    "plan_pools",
    "prefix_match_len",
    "prefix_match_parts",
    "publish_summary",
    "summarize",
]
