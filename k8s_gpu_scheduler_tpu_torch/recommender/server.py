"""gRPC imputation server (copy of the JAX package's
``recommender/server.py``).

- Two RPCs look up the requested index by substring match of a train-row
  label inside the ('-'→'_'-normalized) request, impute that row, and
  return (values, columns).
- Paths and port come from the environment (CONFIGURATIONS_DATA_PATH /
  INTERFERENCE_DATA_PATH / PORT / JOB_DELAY); the defaults are the seed
  matrices under ``data/`` beside this file.
- A background thread re-fits when a train file's md5 changes and swaps
  the serving model atomically.

Data format: TSV, first column = row label, header = column labels, empty
cells = missing (to impute). Configuration columns are {parts}P_{gen}
(e.g. 4P_V5E); interference rows are {workload}_{gen}.
"""
from __future__ import annotations

import csv
import hashlib
import logging
import os
import threading
from concurrent import futures
from typing import Dict, List, Optional, Tuple

import numpy as np

from .model import IterativeImputer
from .wire import (
    SERVICE,
    decode_request,
    encode_reply,
)

log = logging.getLogger(__name__)


def load_matrix(path: str) -> Tuple[List[str], List[str], np.ndarray]:
    """(row_labels, columns, values) from TSV; empty/non-numeric → nan."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        columns = header[1:]
        labels: List[str] = []
        rows: List[List[float]] = []
        for rec in reader:
            if not rec or not rec[0].strip():
                continue
            labels.append(rec[0].strip())
            vals = []
            for cell in rec[1 : len(columns) + 1]:
                try:
                    vals.append(float(cell))
                except ValueError:
                    vals.append(float("nan"))
            vals += [float("nan")] * (len(columns) - len(vals))
            rows.append(vals)
    return labels, columns, np.array(rows, dtype=np.float64)


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


class _Table:
    """One train matrix + its fitted imputer, hot-swappable."""

    def __init__(self, path: str):
        self.path = path
        self.version = ""
        self.labels: List[str] = []
        self.columns: List[str] = []
        self.completed: Optional[np.ndarray] = None
        self._mu = threading.Lock()
        self.refresh(force=True)

    def refresh(self, force: bool = False) -> bool:
        try:
            version = _md5(self.path)
        except OSError:
            return False
        # self.version is lock-guarded state — snapshot it under _mu. Two
        # refreshers racing here at worst both retrain (idempotent); a torn
        # read against the locked writer is what the lock rules out.
        with self._mu:
            current = self.version
        if not force and version == current:
            return False
        labels, columns, X = load_matrix(self.path)
        completed = IterativeImputer().fit_transform(X)
        with self._mu:
            self.version = version
            self.labels, self.columns, self.completed = labels, columns, completed
        log.info("recommender: (re)trained %s (%d rows)", self.path, len(labels))
        return True

    def lookup(self, request_index: str) -> Tuple[List[float], List[str]]:
        """First train row whose label occurs inside the normalized
        request. Fallback for suffixed pod names: a label
        '{workload}_{gen}' also matches when the request ends with
        '_{gen}' and contains the workload ('llama3-8b-serve-0_V5E'
        against row 'llama3_8b_serve_V5E', where the replica suffix
        interrupts the substring)."""
        normalized = request_index.replace("-", "_")
        with self._mu:
            for i, label in enumerate(self.labels):
                if label in normalized:
                    return list(self.completed[i]), list(self.columns)
            for i, label in enumerate(self.labels):
                stem, _, suffix = label.rpartition("_")
                if stem and normalized.endswith("_" + suffix) and stem in normalized:
                    return list(self.completed[i]), list(self.columns)
        return [], []


class RecommenderServer:
    def __init__(
        self,
        configurations_path: str,
        interference_path: str,
        port: int = 0,
        retrain_interval_s: float = 30.0,
        workers: int = 10,
    ):
        self.configurations = _Table(configurations_path)
        self.interference = _Table(interference_path)
        self.retrain_interval_s = retrain_interval_s
        self._port = port
        self._workers = workers
        self._server = None
        self._stop = threading.Event()
        self._retrainer: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._port

    # -- RPC handlers ------------------------------------------------------
    def _impute(self, table: _Table, index: str, context) -> bytes:
        result, columns = table.lookup(index)
        return encode_reply(result, columns)

    def start(self) -> "RecommenderServer":
        import grpc

        handlers = grpc.method_handlers_generic_handler(
            SERVICE,
            {
                "ImputeConfigurations": grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: self._impute(self.configurations, req, ctx),
                    request_deserializer=decode_request,
                    response_serializer=lambda b: b,
                ),
                "ImputeInterference": grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: self._impute(self.interference, req, ctx),
                    request_deserializer=decode_request,
                    response_serializer=lambda b: b,
                ),
            },
        )
        self._server = grpc.server(futures.ThreadPoolExecutor(self._workers))
        self._server.add_generic_rpc_handlers((handlers,))
        self._port = self._server.add_insecure_port(f"[::]:{self._port}")
        self._server.start()
        self._retrainer = threading.Thread(target=self._retrain_loop, daemon=True)
        self._retrainer.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop(grace=1)
        if self._retrainer is not None:
            self._retrainer.join(timeout=2)

    def _retrain_loop(self) -> None:
        while not self._stop.wait(self.retrain_interval_s):
            for table in (self.configurations, self.interference):
                try:
                    table.refresh()
                except Exception:  # noqa: BLE001 — bad data must not kill serving
                    log.exception("retrain failed for %s", table.path)


def main() -> None:  # pragma: no cover — exercised via the CLI
    logging.basicConfig(level=logging.INFO)
    here = os.path.dirname(os.path.abspath(__file__))
    configurations_path = os.environ.get(
        "CONFIGURATIONS_DATA_PATH",
        os.path.join(here, "data/configurations_train.tsv"))
    interference_path = os.environ.get(
        "INTERFERENCE_DATA_PATH",
        os.path.join(here, "data/interference_train.tsv"))
    server = RecommenderServer(
        configurations_path=configurations_path,
        interference_path=interference_path,
        port=int(os.environ.get("PORT", "32700")),
        retrain_interval_s=float(os.environ.get("JOB_DELAY", "30")),
    ).start()
    print(f"recommender serving on :{server.port}", flush=True)
    # Observation collector: when the registry is configured, measured
    # workload throughput flows back into the train matrix (the md5-watch
    # retrain above then picks it up). Optional with graceful degradation,
    # like every sidecar in this framework.
    collector = None
    try:
        from ..config import SchedulerConfig
        from ..registry.client import Client as RegistryClient
        from .collector import Collector

        rc = SchedulerConfig.from_env().registry
        reg = RegistryClient(rc.host, rc.port, password=rc.password)
        reg.ping()
        collector = Collector(
            reg, configurations_path,
            interval_s=float(os.environ.get("JOB_DELAY", "30")),
            interference_path=interference_path,
        ).start()
        print(f"collector polling registry at {rc.host}:{rc.port}",
              flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"collector disabled (no registry: {e})", flush=True)
    try:
        threading.Event().wait()
    finally:
        if collector is not None:
            collector.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
