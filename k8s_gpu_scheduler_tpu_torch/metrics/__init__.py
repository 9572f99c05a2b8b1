"""Metrics layer of the port: the Prometheus text-format exporter and
the serving-pool export and the fleet router's metric names (copy of the
JAX package's exporter)."""
from .exporter import (
    DECODE_FALLBACK_TOTAL, FLEET_COUNTERS, FLEET_GAUGES, FLEET_HISTOGRAMS, DEFAULT_BUCKETS, PHASE_BUCKETS, PHASE_HISTOGRAM, PREFIX_HIT_BUCKETS,
    PREFIX_HIT_HISTOGRAM, PROMOTED_HIT_HISTOGRAM, SERVING_POOL_GAUGES,
    SPEC_ACCEPT_BUCKETS, SPEC_ACCEPT_HISTOGRAM, SPEC_GAMMA_GAUGE,
    TP_COMBINE_INFO, Counter, Gauge, Histogram, MetricsServer, Registry,
    export_decode_fallbacks, export_serving_pool,
)

__all__ = [
    "Counter",
    "DECODE_FALLBACK_TOTAL",
    "DEFAULT_BUCKETS",
    "FLEET_COUNTERS",
    "FLEET_GAUGES",
    "FLEET_HISTOGRAMS",
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
    "export_decode_fallbacks",
    "export_serving_pool",
]
