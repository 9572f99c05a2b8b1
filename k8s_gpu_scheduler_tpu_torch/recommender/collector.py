"""The workload side of the recommender's feedback loop (trimmed copy of
the JAX package's ``recommender/collector.py``): a workload publishes
each measured interval as an ``Observation`` under
``observed/<workload>/<column>[/co]`` in the registry, tagged with its
live co-located neighbours; the recommender's collector (not ported)
folds the samples into its matrices.

``make_workload_publisher`` builds the ``publish(qps, p99_ms=)`` callable
from the scheduler-injected env, or returns None when ``WORKLOAD_NAME``
is unset. Observability never kills work: a registry that cannot be
reached disables publishing with a warning, and a failed publish is
logged and dropped.
"""
from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

from ..registry.inventory import Observation, observed_key

log = logging.getLogger(__name__)

# The accelerator generations the scheduler names in TPU_ACCELERATOR_TYPE
# (the JAX package's ``api/topology.TPUGen``), by the column label the
# recommender's matrices use.
_GENERATIONS = {
    "tpu-v5-lite-podslice": "V5E",
    "tpu-v5p-slice": "V5P",
    "tpu-v4-podslice": "V4",
    "tpu-v6e-slice": "V6E",
}


def publish_observation(registry, workload: str, column: str,
                        qps: float, neighbors: Optional[List[str]] = None,
                        p99_ms: float = 0.0) -> None:
    """Push one throughput sample; failures are logged and swallowed.
    ``neighbors`` tags the sample as an interference measurement;
    ``p99_ms`` is the measured per-request p99 latency, when the
    workload has one."""
    try:
        neighbors = sorted(neighbors or [])
        registry.set(
            observed_key(workload, column, co_located=bool(neighbors)),
            Observation(workload, column, qps, time.time(),
                        neighbors=neighbors, p99_ms=p99_ms).to_json())
    except Exception as e:  # noqa: BLE001
        log.debug("observation publish failed: %s", e)


def make_workload_publisher(n_devices: int = 1):
    """Build a ``publish(qps, p99_ms=0.0)`` callable from the workload env
    (WORKLOAD_NAME row label, TPU_VISIBLE_CHIPS and TPU_ACCELERATOR_TYPE
    column, registry address), or None when publishing is not
    configured. Each publish reads the live neighbour list."""
    workload_name = os.environ.get("WORKLOAD_NAME", "")
    if not workload_name:
        return None
    try:
        from ..config import SchedulerConfig
        from ..registry.client import Client as RegistryClient

        rc = SchedulerConfig.from_env().registry
        reg = RegistryClient(rc.host, rc.port, password=rc.password)
        reg.ping()
        chips = len([c for c in
                     os.environ.get("TPU_VISIBLE_CHIPS", "").split(",")
                     if c]) or n_devices
        gen = _GENERATIONS.get(os.environ.get("TPU_ACCELERATOR_TYPE", ""),
                               "V5E")
        column = f"{chips}P_{gen}"
        pod_name = os.environ.get("HOSTNAME", "")
        env_neighbors = os.environ.get("TPU_NEIGHBORS", "")

        def publish(qps: float, p99_ms: float = 0.0) -> None:
            publish_observation(
                reg, workload_name, column, qps,
                neighbors=current_neighbors(reg, pod_name, env_neighbors),
                p99_ms=p99_ms)

        return publish
    except Exception as e:  # noqa: BLE001 — observability never kills work
        log.warning("observation publishing disabled: %s", e)
        return None


def current_neighbors(registry, pod_name: str, env_value: str = "") -> List[str]:
    """The live neighbour list of a pod: ``neighbors/<pod>`` in the
    registry (refreshed by the scheduler at every bind that changes the
    partition's co-residency), else the bind-time TPU_NEIGHBORS env."""
    try:
        raw = registry.get(f"neighbors/{pod_name}")
    except Exception:  # noqa: BLE001
        raw = None
    if raw is None:
        raw = env_value
    return sorted(n for n in raw.split(",") if n)
