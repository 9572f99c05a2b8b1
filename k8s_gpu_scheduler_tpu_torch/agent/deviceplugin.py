"""Live utilization from a node's device-plugin metrics endpoint (copy of
the JAX package's ``agent/deviceplugin.py``): the agent's third probe
source, whose per-chip duty cycle and HBM numbers are overlaid onto the
prober's chip inventory before publishing.

The parser accepts both the GKE device-plugin names (``duty_cycle``,
``memory_used``, ``memory_total``, ``tensorcore_utilization`` with an
``accelerator_id`` label ending in ``-<device>``) and the agent's own
re-exported names (``metrics/client.py``'s TPU series with a
``device_id`` label), so an agent can also scrape a peer agent's
exporter.
"""
from __future__ import annotations

import logging
import re
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

log = logging.getLogger(__name__)

# Metric-name synonyms: GKE device-plugin convention first, our re-exported
# series (metrics/client.py) second.
DUTY_NAMES = ("duty_cycle", "tpu_duty_cycle_percent")
HBM_USED_NAMES = ("memory_used", "tpu_hbm_memory_usage_bytes")
HBM_TOTAL_NAMES = ("memory_total", "tpu_hbm_memory_total_bytes")
TENSORCORE_NAMES = ("tensorcore_utilization", "tpu_tensorcore_utilization")

_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)"
)
_LABEL = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"')


def parse_prom_text(text: str) -> Iterator[Tuple[str, Dict[str, str], float]]:
    """Minimal Prometheus text-format parser: (name, labels, value) per
    sample line; comments/HELP/TYPE and malformed lines are skipped."""
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {
            lm.group("k"): lm.group("v").replace('\\"', '"')
            for lm in _LABEL.finditer(m.group("labels") or "")
        }
        yield m.group("name"), labels, value


def device_index(labels: Dict[str, str]) -> Optional[int]:
    """Chip index within the host from sample labels: explicit
    ``device_id``/``chip`` first, else the trailing ``-<n>`` of the GKE
    ``accelerator_id`` (e.g. ``4804277629165885214-3`` → 3)."""
    for key in ("device_id", "chip"):
        raw = labels.get(key)
        if raw is not None and raw.isdigit():
            return int(raw)
    acc = labels.get("accelerator_id", "")
    if "-" in acc:
        tail = acc.rsplit("-", 1)[1]
        if tail.isdigit():
            return int(tail)
    return None


@dataclass
class ChipMetrics:
    duty_cycle: float = 0.0        # 0..1
    hbm_used_bytes: int = 0
    hbm_total_bytes: int = 0
    tensorcore_util: float = 0.0   # 0..1


class DevicePluginSource:
    """Scrapes one metrics endpoint into per-chip metrics."""

    def __init__(self, url: str, timeout_s: float = 2.0) -> None:
        self.url = url
        self.timeout_s = timeout_s

    def fetch_text(self) -> str:
        with urllib.request.urlopen(self.url, timeout=self.timeout_s) as r:
            return r.read().decode(errors="replace")

    def read(self) -> Dict[int, ChipMetrics]:
        """One scrape → {device index → metrics}. Unreachable endpoint or
        unparsable payload returns {} (the agent degrades to prober-only
        inventory — observability must never break publishing)."""
        try:
            text = self.fetch_text()
        except (urllib.error.URLError, OSError, ValueError) as e:
            log.debug("device-plugin endpoint %s unreachable: %s", self.url, e)
            return {}
        out: Dict[int, ChipMetrics] = {}
        has_duty = set()
        for name, labels, value in parse_prom_text(text):
            idx = device_index(labels)
            if idx is None:
                continue
            cm = out.setdefault(idx, ChipMetrics())
            if name in DUTY_NAMES:
                # Both conventions report percent 0..100.
                cm.duty_cycle = max(0.0, min(1.0, value / 100.0))
                has_duty.add(idx)
            elif name in HBM_USED_NAMES:
                cm.hbm_used_bytes = int(value)
            elif name in HBM_TOTAL_NAMES:
                cm.hbm_total_bytes = int(value)
            elif name in TENSORCORE_NAMES:
                cm.tensorcore_util = max(0.0, min(1.0, value / 100.0))
        # An endpoint exporting only tensorcore_utilization (some libtpu
        # exporter versions) must still drive scoring — without the
        # fallback such nodes publish duty 0 and score as idle, the exact
        # defect this module exists to fix.
        for idx, cm in out.items():
            if idx not in has_duty and cm.tensorcore_util > 0.0:
                cm.duty_cycle = cm.tensorcore_util
        return out


def overlay(chips: List, metrics: Dict[int, ChipMetrics]) -> None:
    """Merge live endpoint metrics into prober ChipInfos in place. The
    prober owns chip EXISTENCE (device files); the endpoint owns
    utilization — its numbers win whenever its index matches a probed
    chip."""
    for chip in chips:
        cm = metrics.get(chip.device_id)
        if cm is None:
            continue
        chip.duty_cycle = cm.duty_cycle
        if cm.hbm_used_bytes:
            chip.hbm_used_bytes = cm.hbm_used_bytes
        if cm.hbm_total_bytes:
            chip.hbm_total_bytes = cm.hbm_total_bytes
