"""Offline chip-metrics logger (copy of the JAX package's
``agent/metrics_logger.py``): poll the node prober (the same seam the
agent uses, ``agent/scrape.py``) for each chip's duty cycle and HBM
occupancy, keep the rows in memory, and write them as TSV on SIGINT or
SIGTERM, or when ``--samples`` runs out.

Usage:
    python -m k8s_gpu_scheduler_tpu_torch.agent.metrics_logger
        [-o chip_metrics.tsv] [--interval 1.0] [--samples N]
        [--fake FILE]   # Ctrl-C to stop and dump
"""
from __future__ import annotations

import argparse
import signal
import sys
import time
from typing import List, Tuple

from .scrape import Scraper

COLUMNS = ("timestamp", "device_id", "duty_cycle", "hbm_used_bytes",
           "hbm_total_bytes")


class MetricsLogger:
    def __init__(self, scraper: Scraper, out_path: str,
                 interval_s: float = 1.0) -> None:
        self.scraper = scraper
        self.out_path = out_path
        self.interval_s = interval_s
        self.rows: List[Tuple] = []
        self._stop = False

    def sample_once(self) -> int:
        """Poll once; append one row per chip. Returns chips seen."""
        now = time.time()
        chips = self.scraper.scrape()
        for c in chips:
            self.rows.append((now, c.device_id, c.duty_cycle,
                              c.hbm_used_bytes, c.hbm_total_bytes))
        return len(chips)

    def dump(self) -> str:
        """Write the accumulated samples as TSV, one row a chip a
        sample under a header of ``COLUMNS``."""
        with open(self.out_path, "w") as f:
            f.write("\t".join(COLUMNS) + "\n")
            for row in self.rows:
                f.write("\t".join(
                    f"{v:.6f}" if isinstance(v, float) else str(v)
                    for v in row) + "\n")
        return self.out_path

    def run(self, max_samples: int = 0) -> None:
        taken = 0
        while not self._stop and (not max_samples or taken < max_samples):
            try:
                self.sample_once()
            except RuntimeError as e:
                print(f"sample failed: {e}", file=sys.stderr, flush=True)
            taken += 1
            if max_samples and taken >= max_samples:
                break
            time.sleep(self.interval_s)

    def request_stop(self, *_args) -> None:
        self._stop = True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu-metrics-logger",
        description="poll the TPU prober into a TSV (SIGINT dumps and exits)")
    parser.add_argument("-o", "--out", default="chip_metrics.tsv")
    parser.add_argument("--interval", type=float, default=1.0)
    parser.add_argument("--samples", type=int, default=0,
                        help="stop after N samples (0 = until SIGINT)")
    parser.add_argument("--fake", default=None,
                        help="fake metrics file for the prober (test seam)")
    args = parser.parse_args(argv)

    logger = MetricsLogger(Scraper(fake_file=args.fake), args.out,
                           interval_s=args.interval)
    signal.signal(signal.SIGINT, logger.request_stop)
    signal.signal(signal.SIGTERM, logger.request_stop)
    logger.run(max_samples=args.samples)
    path = logger.dump()
    print(f"wrote {len(logger.rows)} samples to {path}", flush=True)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
