"""Prometheus instant-query client (copy of the JAX package's
``metrics/client.py``): the ``/api/v1/query`` API, a concurrent
multi-series fan-out on a thread pool, and the TPU series names below.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# TPU metric series, in place of DCGM's five GPU series. Names follow the GKE tpu-device-plugin /
# libtpu-exporter convention (memory in bytes, utilizations in percent).
MXU_DUTY_CYCLE = "tpu_duty_cycle_percent"            # ≈ GR_ENGINE_ACTIVE
TENSORCORE_UTIL = "tpu_tensorcore_utilization"       # ≈ MEM_COPY_UTIL slot
HBM_BANDWIDTH_UTIL = "tpu_memory_bandwidth_utilization"
HBM_USED = "tpu_hbm_memory_usage_bytes"              # ≈ FB_USED
HBM_TOTAL = "tpu_hbm_memory_total_bytes"             # ≈ FB_FREE (inverted)

TPU_SERIES = [MXU_DUTY_CYCLE, TENSORCORE_UTIL, HBM_BANDWIDTH_UTIL, HBM_USED, HBM_TOTAL]


class MetricsError(Exception):
    pass


@dataclass
class Sample:
    """One vector sample — parity with prom Response (prom_metrics.go:14-26):
    MetricName/Exporter/Value/GPU_I_ID/UUID become
    metric_name/exporter/value/device_id/node."""

    metric_name: str
    value: float
    node: str = ""
    device_id: str = ""
    exporter: str = ""
    labels: Dict[str, str] = field(default_factory=dict)


def parse_response(raw: Optional[bytes]) -> List[Sample]:
    """Parse a Prometheus instant-query vector response into samples —
    parity with ParseResponse (prom_metrics.go:28-61), including its
    nil-input and empty-result cases."""
    if not raw:
        return []
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise MetricsError(f"bad metrics JSON: {e}") from e
    if doc.get("status") != "success":
        raise MetricsError(f"query failed: {doc.get('error', 'unknown error')}")
    data = doc.get("data", {})
    if data.get("resultType") not in (None, "vector"):
        raise MetricsError(f"unexpected resultType {data.get('resultType')!r}")
    out: List[Sample] = []
    for item in data.get("result", []):
        metric = item.get("metric", {})
        value = item.get("value", [None, "nan"])
        try:
            v = float(value[1])
        except (TypeError, ValueError, IndexError):
            continue
        out.append(
            Sample(
                metric_name=metric.get("__name__", ""),
                value=v,
                node=metric.get("node", metric.get("kubernetes_node", "")),
                device_id=metric.get("device_id", metric.get("chip", "")),
                exporter=metric.get("pod", metric.get("exported_pod", "")),
                labels=dict(metric),
            )
        )
    return out


class PromClient:
    """Instant-query client with concurrent fan-out.

    ``base_url`` points at a Prometheus-compatible API.
    """

    def __init__(self, base_url: str, timeout_s: float = 2.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def query_url(self, query: str) -> str:
        """The instant-query URL of ``query``."""
        return f"{self.base_url}/api/v1/query?{urllib.parse.urlencode({'query': query})}"

    def instant_query(self, query: str) -> List[Sample]:
        try:
            with urllib.request.urlopen(self.query_url(query), timeout=self.timeout_s) as r:
                return parse_response(r.read())
        except urllib.error.URLError as e:
            raise MetricsError(f"metrics endpoint unreachable: {e}") from e

    def fan_out(self, queries: List[str]) -> Dict[str, List[Sample]]:
        """Run all queries concurrently. A failed series yields [] rather
        than failing the batch."""
        def one(q: str) -> List[Sample]:
            try:
                return self.instant_query(q)
            except MetricsError:
                return []

        with ThreadPoolExecutor(max_workers=max(2, len(queries))) as pool:
            results = list(pool.map(one, queries))
        return dict(zip(queries, results))

    # -- TPU-specific entry points ----------------------------------------
    def tpu_metrics_for_node(self, node_name: str) -> Dict[str, List[Sample]]:
        """All TPU series restricted to one node (the no-registry
        fallback scoring path's input)."""
        queries = [f'{s}{{node="{node_name}"}}' for s in TPU_SERIES]
        raw = self.fan_out(queries)
        return {s: raw[q] for s, q in zip(TPU_SERIES, queries)}

    def tpu_metrics(self) -> Dict[str, List[Sample]]:
        """Cluster-wide fan-out of all TPU series."""
        return {s: r for s, r in zip(TPU_SERIES, self.fan_out(list(TPU_SERIES)).values())}

    def node_duty_cycle(self, node_name: str) -> Optional[float]:
        """Mean MXU duty cycle across a node's chips, 0..100, or None if the
        series is absent — the Score fallback input."""
        samples = self.instant_query(f'{MXU_DUTY_CYCLE}{{node="{node_name}"}}')
        if not samples:
            return None
        return sum(s.value for s in samples) / len(samples)
