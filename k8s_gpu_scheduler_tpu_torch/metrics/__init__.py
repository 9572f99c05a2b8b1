"""Metrics layer of the port: the Prometheus text-format exporter and
the serving-pool export (copy of the JAX package's exporter, less the
fleet metrics and the decode-fallback counter)."""
from .exporter import (
    DEFAULT_BUCKETS, PHASE_BUCKETS, PHASE_HISTOGRAM, PREFIX_HIT_BUCKETS,
    PREFIX_HIT_HISTOGRAM, PROMOTED_HIT_HISTOGRAM, SERVING_POOL_GAUGES,
    SPEC_ACCEPT_BUCKETS, SPEC_ACCEPT_HISTOGRAM, SPEC_GAMMA_GAUGE,
    TP_COMBINE_INFO, Counter, Gauge, Histogram, MetricsServer, Registry,
    export_serving_pool,
)

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsServer",
    "PHASE_BUCKETS",
    "PHASE_HISTOGRAM",
    "PREFIX_HIT_BUCKETS",
    "PREFIX_HIT_HISTOGRAM",
    "PROMOTED_HIT_HISTOGRAM",
    "Registry",
    "SERVING_POOL_GAUGES",
    "SPEC_ACCEPT_BUCKETS",
    "SPEC_ACCEPT_HISTOGRAM",
    "SPEC_GAMMA_GAUGE",
    "TP_COMBINE_INFO",
    "export_serving_pool",
]
