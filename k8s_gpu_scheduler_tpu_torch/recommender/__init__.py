"""The workload-side publisher of the recommender's observations
(``collector.py``)."""
from .collector import (
    current_neighbors, make_workload_publisher, publish_observation,
)

__all__ = ["current_neighbors", "make_workload_publisher",
           "publish_observation"]
