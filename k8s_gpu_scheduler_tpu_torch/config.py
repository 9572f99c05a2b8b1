"""Central configuration of the port's scheduler and workloads (copy of
the JAX package's ``config.py``): every endpoint and tuning knob in one
dataclass, overridable from the environment (``TPU_SCHED_*``). The
workload publisher reads ``registry`` from it too."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


def _env(name: str, default, cast=None):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is None:
        cast = type(default) if default is not None else str
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class RegistryConfig:
    """KV registry (the Redis analogue — NodePort 32767, password "1234" in
    the reference; deploy/redis/redis-config.yaml)."""

    host: str = "127.0.0.1"
    port: int = 32767
    password: Optional[str] = None
    db: int = 0
    # Service-discovery fallback: pod-name substring + namespace, parity with
    # FindNodesIPFromPod("-0", "redis") (utils/utils.go:59-70).
    discovery_substring: str = "-0"
    discovery_namespace: str = "registry"


@dataclass
class MetricsConfig:
    """Prometheus-compatible instant-query endpoint (reference port 30090,
    gpu_plugins.go:185)."""

    url: str = "http://127.0.0.1:30090"
    query_timeout_s: float = 2.0


@dataclass
class RecommenderConfig:
    """Prediction service endpoint (reference NodePort 32700,
    gpu_plugins.go:317)."""

    host: str = "127.0.0.1"
    port: int = 32700
    timeout_s: float = 2.0


@dataclass
class SchedulerConfig:
    scheduler_name: str = "tpu-scheduler"
    # Permit phase: how long a gang pod may wait for its peers before the
    # whole gang is rejected (PodGroup.schedule_timeout_s overrides per-group).
    permit_timeout_s: float = 60.0
    # Unschedulable-pod backoff (kube-scheduler defaults).
    backoff_initial_s: float = 1.0
    backoff_max_s: float = 10.0
    # Score weight for the TPU plugin (reference uses weight 10100 in
    # deploy/scheduler.yaml:8-24 to drown out default plugins).
    tpu_score_weight: float = 1.0
    # Filter/Score fan-out: worker threads per cycle (kube-scheduler's
    # --parallelism, default 16); node counts below parallelize_threshold
    # run serial (thread handoff costs more than it saves on small pools).
    parallelism: int = 16
    parallelize_threshold: int = 32
    # Feasible-node sampling above min_feasible_to_find nodes
    # (kube-scheduler's percentageOfNodesToScore): 0 = adaptive
    # (50 - nodes/125, floor 5), otherwise the literal percentage.
    percentage_of_nodes_to_score: int = 0
    min_feasible_to_find: int = 100
    registry: RegistryConfig = field(default_factory=RegistryConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    recommender: RecommenderConfig = field(default_factory=RecommenderConfig)

    @staticmethod
    def from_env() -> "SchedulerConfig":
        cfg = SchedulerConfig()
        cfg.scheduler_name = _env("TPU_SCHED_NAME", cfg.scheduler_name)
        cfg.permit_timeout_s = _env("TPU_SCHED_PERMIT_TIMEOUT", cfg.permit_timeout_s, float)
        cfg.backoff_initial_s = _env("TPU_SCHED_BACKOFF_INITIAL", cfg.backoff_initial_s, float)
        cfg.backoff_max_s = _env("TPU_SCHED_BACKOFF_MAX", cfg.backoff_max_s, float)
        cfg.tpu_score_weight = _env("TPU_SCHED_SCORE_WEIGHT", cfg.tpu_score_weight, float)
        cfg.parallelism = _env("TPU_SCHED_PARALLELISM", cfg.parallelism, int)
        cfg.percentage_of_nodes_to_score = _env(
            "TPU_SCHED_PCT_NODES_TO_SCORE", cfg.percentage_of_nodes_to_score, int)
        cfg.registry.host = _env("TPU_SCHED_REGISTRY_HOST", cfg.registry.host)
        cfg.registry.port = _env("TPU_SCHED_REGISTRY_PORT", cfg.registry.port, int)
        cfg.registry.password = _env("TPU_SCHED_REGISTRY_PASSWORD", cfg.registry.password, str)
        cfg.metrics.url = _env("TPU_SCHED_METRICS_URL", cfg.metrics.url)
        cfg.recommender.host = _env("TPU_SCHED_RECOMMENDER_HOST", cfg.recommender.host)
        cfg.recommender.port = _env("TPU_SCHED_RECOMMENDER_PORT", cfg.recommender.port, int)
        return cfg
