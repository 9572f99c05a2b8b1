"""Inventory scraping (copy of the JAX package's ``agent/scrape.py``):
exec the node prober, parse its JSON into ``ChipInfo``s. The seams are the
binary path (``TPUPROBE_BIN``) and the fake-metrics file
(``TPUPROBE_FAKE``), so everything is testable without a device.

Without ``TPUPROBE_BIN`` the prober is the port's own
(``csrc/tpuprobe.cpp``), built by ``_build.py`` at the first ``scrape()``.
With no fake file and no ``TPUPROBE_DEV_GLOB`` it reads the node's GPUs
through NVML: one chip per NVML index, in PCI bus order, whatever
``CUDA_VISIBLE_DEVICES`` says — the agent is a node daemon and reports
every device of the node, as the JAX package's prober reports every
``/dev/accel*``. A prober that fails (NVML missing or an NVML call
failing, or no device) exits 1 and ``scrape()`` raises.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import List, Optional

from ..registry.inventory import ChipInfo
from . import _build


def probe_binary_path() -> str:
    """``TPUPROBE_BIN``, else the port's build of the prober (which the
    first ``scrape()`` makes)."""
    return os.environ.get("TPUPROBE_BIN", str(_build.binary_path()))


class Scraper:
    def __init__(self, binary: Optional[str] = None, fake_file: Optional[str] = None,
                 timeout_s: float = 5.0, device_plugin=None):
        """``device_plugin``: optional agent.deviceplugin.DevicePluginSource
        (or env TPU_DEVICE_PLUGIN_URL) overlaying live duty-cycle/HBM onto
        the prober's inventory — the prober knows which chips exist, the
        device-plugin endpoint knows how busy they are."""
        self.binary = binary or probe_binary_path()
        # The port's own prober is built at the first scrape, and only then.
        self._unbuilt = self.binary == str(_build.binary_path())
        self.fake_file = fake_file or os.environ.get("TPUPROBE_FAKE")
        self.timeout_s = timeout_s
        if device_plugin is None:
            url = os.environ.get("TPU_DEVICE_PLUGIN_URL", "")
            if url:
                from .deviceplugin import DevicePluginSource

                device_plugin = DevicePluginSource(url)
        self.device_plugin = device_plugin

    def scrape(self) -> List[ChipInfo]:
        """One probe → chip list. Raises RuntimeError when the prober is
        missing or emits garbage (the agent loop logs and retries)."""
        if self._unbuilt:
            _build.build()
            self._unbuilt = False
        argv = [self.binary, "--once"]
        if self.fake_file:
            argv += ["--fake", self.fake_file]
        try:
            proc = subprocess.run(
                argv, capture_output=True, timeout=self.timeout_s, check=False
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"tpuprobe failed: {e}") from e
        if proc.returncode != 0:
            # exit 1 = probe found NO devices (or NVML failed) — a broken
            # node must not masquerade as a fully idle one (utilization 0
            # would make it the top-scored target).
            raise RuntimeError(
                f"tpuprobe exit {proc.returncode}: {proc.stderr.decode()!r}"
            )
        try:
            doc = json.loads(proc.stdout.decode() or "{}")
        except ValueError as e:
            raise RuntimeError(f"tpuprobe emitted non-JSON: {proc.stdout!r}") from e
        chips = []
        for c in doc.get("chips", []):
            chips.append(ChipInfo(
                device_id=int(c.get("device_id", 0)),
                duty_cycle=float(c.get("duty_cycle", 0.0)),
                hbm_used_bytes=int(c.get("hbm_used", 0)),
                hbm_total_bytes=int(c.get("hbm_total", 0)),
            ))
        if self.device_plugin is not None and chips:
            from .deviceplugin import overlay

            overlay(chips, self.device_plugin.read())
        return chips
