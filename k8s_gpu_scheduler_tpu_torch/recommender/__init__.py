"""Prediction service of the port (copies of the JAX package's
``recommender/`` modules): throughput/interference imputation over gRPC
(``server.py``, ``wire.py``'s hand-written proto3 codec, ``model.py``'s
numpy imputer), its client with a TTL cache and bounded retry
(``client.py``), and the feedback loop (``collector.py``: the workload
side's publisher and the server side's ``Collector``)."""
from .client import Client, find_max_index
from .collector import (
    Collector, current_neighbors, make_workload_publisher, publish_observation,
)
from .model import IterativeImputer
from .server import RecommenderServer

__all__ = ["Client", "Collector", "IterativeImputer", "RecommenderServer",
           "current_neighbors", "find_max_index", "make_workload_publisher",
           "publish_observation"]
