"""Node agent of the port (copy of the JAX package's ``agent/``): a
per-host daemon that execs the node prober (``csrc/tpuprobe.cpp``, built
by ``_build.py``), overlays a device-plugin metrics endpoint where one is
configured, and publishes a typed ``NodeInventory`` (chips, topology
labels, utilization) to the registry on change, with a heartbeat refresh.
"""
from .scrape import Scraper, probe_binary_path
from .publisher import Publisher

__all__ = ["Scraper", "Publisher", "probe_binary_path"]
