"""The recommender's feedback loop (copy of the JAX package's
``recommender/collector.py``).

  workload (models/llama.py) → Observation in the registry
      → Collector (this module) updates the configurations TSV
          → RecommenderServer's md5-watch retrains (server.py _Table.refresh)
              → next ImputeConfigurations reply is observation-anchored

A workload publishes each measured interval as an ``Observation`` under
``observed/<workload>/<column>[/co]`` in the registry, tagged with its
live co-located neighbours (``make_workload_publisher`` builds the
``publish(qps, p99_ms=)`` callable from the scheduler-injected env, or
returns None when ``WORKLOAD_NAME`` is unset; observability never kills
work).

Cell update policy: a blank (imputed-only) cell takes the observation
verbatim; a measured cell moves by EWMA (``alpha`` on the new sample) so
one noisy run cannot wreck a row. New workloads append a row;
observations for unknown columns are dropped. Each registry sample is
folded at most once (the collector remembers the ``Observation.at`` it
last folded per key). The TSV write is atomic (tmp + rename), so the
server never reads a torn file.
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional

from ..registry.inventory import OBSERVED_KEY_PREFIX, Observation, observed_key
from .server import load_matrix

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


class Collector:
    def __init__(self, registry, configurations_path: str,
                 interval_s: float = 30.0, alpha: float = 0.5,
                 interference_path: Optional[str] = None) -> None:
        """``interference_path``: when given, samples tagged with neighbors
        (TPU_NEIGHBORS-injected co-residents) fold their throughput DELTA
        vs the solo configurations cell into the interference matrix."""
        self.registry = registry
        self.path = configurations_path
        self.interference_path = interference_path
        self.interval_s = interval_s
        self.alpha = alpha
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # key -> Observation.at of the last sample folded from that key.
        self._folded_at: Dict[str, float] = {}

    # -- one pass ----------------------------------------------------------
    def collect_once(self) -> bool:
        """Fold all registry observations into the TSV. True iff the file
        changed (and therefore a retrain will trigger)."""
        try:
            keys = self.registry.get_keys(OBSERVED_KEY_PREFIX + "*")
        except Exception as e:  # noqa: BLE001 — registry outage is routine
            log.warning("collector: registry unavailable (%s)", e)
            return False
        observations: List["tuple[str, Observation]"] = []
        for key in keys:
            raw = self.registry.get(key)
            if not raw:
                continue
            try:
                obs = Observation.from_json(raw)
            except (ValueError, TypeError) as e:
                log.warning("collector: bad observation at %s: %s", key, e)
                continue
            # Fold each sample at most once: a key whose ``at`` hasn't
            # advanced since the last pass is the same sample still sitting
            # in the registry, not a new measurement.
            if obs.at <= self._folded_at.get(key, -math.inf):
                continue
            self._folded_at[key] = obs.at
            observations.append((key, obs))
        # Drop tracking for keys that vanished so the map can't grow forever.
        live = set(keys)
        for stale in [k for k in self._folded_at if k not in live]:
            del self._folded_at[stale]
        if not observations:
            return False

        solo = [o for _, o in observations if not o.neighbors]
        co = [(k, o) for k, o in observations if o.neighbors]
        changed = self._fold_configurations(solo)
        deferred_keys: set = set()
        if self.interference_path is not None and co:
            folded, deferred_keys = self._fold_interference(co)
            changed = folded or changed
            # A sample whose solo baseline doesn't exist yet is genuinely
            # DEFERRED: forget its fold timestamp so the next pass retries
            # it (by then the baseline may have landed).
            for key in deferred_keys:
                self._folded_at.pop(key, None)
        # Latencies fold AFTER the defer decision and skip deferred keys:
        # a deferred sample re-enters observations on every pass, and
        # re-EWMA-ing its p99 each time would give one sample the weight
        # of N (the interference matrices are protected by the timestamp
        # gate; the latency keys need the same discipline).
        self._fold_latencies(
            [o for k, o in observations if k not in deferred_keys])
        return changed

    def _fold_latencies(self, observations: List[Observation]) -> None:
        """Measured p99 samples → EWMA'd latency/<workload>/<column> keys
        (registry/inventory.py latency_key) — the read side is the TPU
        plugin's rightsize/score path, which must prefer partitions whose
        MEASURED latency meets the pod's SLO_P99_MS. Solo and co-located
        samples blend into one key: the pod's next placement should answer
        to the latency it actually experienced, neighbors included. The
        caller excludes interference-deferred samples (collect_once) — a
        deferred key re-enters every pass and would otherwise re-EWMA one
        sample with the weight of many."""
        from ..registry.inventory import latency_key

        for obs in observations:
            if obs.p99_ms <= 0 or not obs.workload or not obs.column:
                continue
            key = latency_key(obs.workload, obs.column)
            try:
                old_raw = self.registry.get(key)
                old = float(old_raw) if old_raw else float("nan")
                new = obs.p99_ms if math.isnan(old) else (
                    self.alpha * obs.p99_ms + (1 - self.alpha) * old)
                self.registry.set(key, f"{new:g}")
            except Exception as e:  # noqa: BLE001 — latency fold is advisory
                log.debug("latency fold failed for %s: %s", key, e)

    def _fold_configurations(self, observations: List[Observation]) -> bool:
        if not observations:
            return False
        labels, columns, X = load_matrix(self.path)
        rows = [list(r) for r in X]
        changed = False
        for obs in observations:
            if obs.qps <= 0 or not obs.workload:
                continue
            if obs.column not in columns:
                log.warning("collector: unknown column %r (workload %s) — "
                            "dropped", obs.column, obs.workload)
                continue
            j = columns.index(obs.column)
            if obs.workload in labels:
                i = labels.index(obs.workload)
            else:
                labels.append(obs.workload)
                rows.append([float("nan")] * len(columns))
                i = len(labels) - 1
                changed = True
            old = rows[i][j]
            new = obs.qps if math.isnan(old) else (
                self.alpha * obs.qps + (1 - self.alpha) * old)
            if math.isnan(old) or abs(new - old) > 1e-9:
                rows[i][j] = new
                changed = True
        if changed:
            self._write(self.path, labels, columns, rows)
            log.info("collector: folded %d solo observation(s) into %s",
                     len(observations), self.path)
        return changed

    def _fold_interference(
        self, observations: List["tuple[str, Observation]"]
    ) -> "tuple[bool, set]":
        """Co-located samples → interference rows. The degradation is the
        solo configurations cell minus the observed co-located QPS, split
        evenly across the neighbors present (with >1 neighbor the split is
        the unbiased first-order attribution). Row key is the
        ``{workload}_{gen}`` convention of the server's row labels; columns
        are neighbor workload names and may grow (every row pads with
        NaN — the imputer fills them). Takes (registry key, observation)
        pairs; returns (changed, keys of deferred observations — no
        baseline yet, retry next pass)."""
        deferred: set = set()
        labels, columns, X = load_matrix(self.path)

        def solo_qps(workload: str, column: str) -> Optional[float]:
            if workload in labels and column in columns:
                v = X[labels.index(workload)][columns.index(column)]
                return None if math.isnan(v) else v
            return None

        ilabels, icolumns, iX = load_matrix(self.interference_path)
        irows = [list(r) for r in iX]
        changed = False
        for key, obs in observations:
            if obs.qps < 0 or not obs.workload:
                continue
            base = solo_qps(obs.workload, obs.column)
            if base is None:
                log.info("collector: no solo baseline for %s/%s — "
                         "interference sample deferred",
                         obs.workload, obs.column)
                deferred.add(key)
                continue
            delta = max(0.0, base - obs.qps) / max(len(obs.neighbors), 1)
            gen = obs.column.rsplit("_", 1)[-1]
            row_label = f"{obs.workload}_{gen}"
            if row_label in ilabels:
                i = ilabels.index(row_label)
            else:
                ilabels.append(row_label)
                irows.append([float("nan")] * len(icolumns))
                i = len(ilabels) - 1
                changed = True
            for nb in obs.neighbors:
                if nb not in icolumns:
                    icolumns.append(nb)
                    for r in irows:
                        r.append(float("nan"))
                    changed = True
                j = icolumns.index(nb)
                old = irows[i][j]
                new = delta if math.isnan(old) else (
                    self.alpha * delta + (1 - self.alpha) * old)
                if math.isnan(old) or abs(new - old) > 1e-9:
                    irows[i][j] = new
                    changed = True
        if changed:
            self._write(self.interference_path, ilabels, icolumns, irows)
            log.info("collector: folded %d co-location observation(s) "
                     "into %s", len(observations) - len(deferred),
                     self.interference_path)
        return changed, deferred

    @staticmethod
    def _write(path: str, labels: List[str], columns: List[str],
               rows: List[List[float]]) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w", newline="") as f:
            f.write("workload\t" + "\t".join(columns) + "\n")
            for label, row in zip(labels, rows):
                cells = ["" if math.isnan(v) else f"{v:g}" for v in row]
                f.write(label + "\t" + "\t".join(cells) + "\n")
        os.replace(tmp, path)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Collector":
        self._thread = threading.Thread(
            target=self._run, name="recom-collector", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.collect_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("collector pass failed")


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
