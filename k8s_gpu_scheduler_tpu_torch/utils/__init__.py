"""Utilities of the port: bounded retries (``retry.py``), the training
checkpointer (``checkpoint.py``), the enforcement of the
scheduler-injected sharing limits (``enforcement.py``) and pod discovery
(``discovery.py``, exported as the JAX package's ``utils`` exports it).
The checkpointer's and enforcement's names import torch, so they are
imported at first use: the registry client, the node agent and the
scheduler use ``retry`` and ``discovery`` alone."""
import importlib

from .discovery import (
    exists_substring, find_agent_pod_on_node, find_node_from_pod,
    find_nodes_ip_from_pod,
)
from .retry import RetryPolicy, retry_call

_LAZY = {"TrainCheckpointer": "checkpoint", "DutyCycleThrottle": "enforcement",
         "apply_env_limits": "enforcement", "apply_hbm_limit": "enforcement",
         "duty_throttle": "enforcement", "hbm_fraction": "enforcement"}

__all__ = ["DutyCycleThrottle", "RetryPolicy", "TrainCheckpointer",
           "apply_env_limits", "apply_hbm_limit", "duty_throttle",
           "exists_substring", "find_agent_pod_on_node",
           "find_node_from_pod", "find_nodes_ip_from_pod", "hbm_fraction",
           "retry_call"]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
