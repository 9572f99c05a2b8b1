"""Publish loop of the node agent (copy of the JAX package's
``agent/publisher.py``): scrape every ``interval_s`` and write the node's
``NodeInventory`` to the registry only when it CHANGED (the payload
compared with ``published_at`` zeroed) or the last write is older than
``heartbeat_s`` on the monotonic clock; each write also sets the node's
heartbeat key so the scheduler can age out dead agents. The node's name
comes from ``NODE_NAME`` (the downward API), its labels from
``TPU_ACCELERATOR_TYPE`` and ``TPU_TOPOLOGY`` or explicit arguments.

    NODE_NAME=<node> python -m k8s_gpu_scheduler_tpu_torch.agent.publisher
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ..registry.inventory import (
    HEARTBEAT_SUFFIX,
    NodeInventory,
    node_key,
    publish_inventory,
)
from .scrape import Scraper

log = logging.getLogger(__name__)


class Publisher:
    def __init__(
        self,
        registry,
        scraper: Optional[Scraper] = None,
        node_name: Optional[str] = None,
        accelerator: str = "",
        topology: str = "",
        worker_id: int = 0,
        interval_s: float = 2.0,
        heartbeat_s: float = 30.0,
        metrics_registry=None,
        clock=None,
    ):
        """``metrics_registry``: optional metrics.exporter.Registry — every
        scrape also updates the node's own Prometheus gauges (the TPU_SERIES
        names metrics/client.py queries), so a cluster WITHOUT a third-party
        exporter still has a live /metrics source per node: agent →
        (registry AND re-exporter) → Prometheus → scheduler's PromClient
        fallback."""
        from ..obs import SYSTEM_CLOCK

        self.registry = registry
        self.scraper = scraper or Scraper()
        # Injected time source (obs.Clock): heartbeat STALENESS is a
        # duration and rides monotonic; published_at stays wall time —
        # it crosses processes (the reshaper compares it to its own wall
        # clock).
        self._clock = clock or SYSTEM_CLOCK
        self.metrics_registry = metrics_registry
        self.node_name = node_name or os.environ.get("NODE_NAME", "")
        if not self.node_name:
            raise ValueError("node name required (arg or NODE_NAME env)")
        self.accelerator = accelerator or os.environ.get("TPU_ACCELERATOR_TYPE", "")
        self.topology = topology or os.environ.get("TPU_TOPOLOGY", "")
        self.worker_id = worker_id
        self.interval_s = interval_s
        self.heartbeat_s = heartbeat_s
        self._last_json: Optional[str] = None
        self._last_publish = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def build_inventory(self) -> NodeInventory:
        chips = self.scraper.scrape()
        util = (
            sum(c.duty_cycle for c in chips) / len(chips) if chips else 0.0
        )
        return NodeInventory(
            node_name=self.node_name,
            accelerator=self.accelerator,
            topology=self.topology,
            chips=chips,
            worker_id=self.worker_id,
            utilization=util,
            published_at=self._clock.wall(),
        )

    def export_metrics(self, inv: NodeInventory) -> None:
        """Refresh the re-exporter gauges from one inventory (see __init__).
        Series names/labels match what metrics/client.py parses back."""
        if self.metrics_registry is None:
            return
        from ..metrics.client import HBM_TOTAL, HBM_USED, MXU_DUTY_CYCLE

        duty = self.metrics_registry.gauge(
            MXU_DUTY_CYCLE, "Per-chip MXU duty cycle, percent")
        used = self.metrics_registry.gauge(
            HBM_USED, "Per-chip HBM bytes in use")
        total = self.metrics_registry.gauge(
            HBM_TOTAL, "Per-chip HBM bytes total")
        for c in inv.chips:
            labels = {"node": inv.node_name, "device_id": str(c.device_id)}
            duty.set(round(100.0 * c.duty_cycle, 3), **labels)
            used.set(float(c.hbm_used_bytes), **labels)
            total.set(float(c.hbm_total_bytes), **labels)

    def publish_once(self, force: bool = False) -> bool:
        """Scrape and publish if changed/stale. Returns True if written."""
        inv = self.build_inventory()
        self.export_metrics(inv)
        # Change detection must ignore the timestamp (else every tick
        # "changes") — compare the payload with published_at zeroed.
        probe = NodeInventory(**{**inv.__dict__, "published_at": 0.0}).to_json()
        # Monotonic staleness: on the old wall-clock math an NTP step
        # backward silenced heartbeats for the step's width (dead-agent
        # aging on the scheduler side would fire), a step forward forced
        # a spurious publish — durations never ride the wall clock.
        stale = (self._clock.monotonic() - self._last_publish
                 >= self.heartbeat_s)
        if not force and not stale and probe == self._last_json:
            return False
        publish_inventory(self.registry, inv)
        self.registry.set(
            node_key(self.node_name) + HEARTBEAT_SUFFIX, str(inv.published_at)
        )
        self._last_json = probe
        self._last_publish = self._clock.monotonic()
        return True

    # -- loop --------------------------------------------------------------
    def start(self) -> "Publisher":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"agent-{self.node_name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.publish_once()
            except Exception:  # noqa: BLE001 — scrape/registry hiccups retry
                log.exception("agent publish failed for %s", self.node_name)
            self._stop.wait(self.interval_s)


def main() -> None:  # pragma: no cover — exercised via CLI
    from ..config import SchedulerConfig
    from ..metrics.exporter import MetricsServer, Registry
    from ..registry.client import Client

    logging.basicConfig(level=logging.INFO)
    cfg = SchedulerConfig.from_env()
    registry = Client(cfg.registry.host, cfg.registry.port,
                      password=cfg.registry.password)
    metrics_registry = Registry()
    port = int(os.environ.get("TPU_AGENT_METRICS_PORT", "8478") or 0)
    if port > 0:
        try:
            server = MetricsServer(
                metrics_registry, host="0.0.0.0", port=port).start()
            log.info("agent re-exporter serving /metrics on :%d", server.port)
        except OSError as e:
            # hostNetwork means the port is shared with the whole node —
            # a taken port must not take down inventory publishing
            # (observability never breaks the agent's primary job).
            log.warning("re-exporter disabled (port %d): %s", port, e)
    Publisher(registry, metrics_registry=metrics_registry)._run()


if __name__ == "__main__":  # pragma: no cover
    main()
