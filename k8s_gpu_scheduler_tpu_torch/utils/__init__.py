"""Workload utilities of the port: bounded retries (``retry.py``), the
training checkpointer (``checkpoint.py``) and the enforcement of the
scheduler-injected sharing limits (``enforcement.py``)."""
from .checkpoint import TrainCheckpointer
from .enforcement import (
    DutyCycleThrottle, apply_env_limits, apply_hbm_limit, duty_throttle,
    hbm_fraction,
)
from .retry import RetryPolicy, retry_call

__all__ = ["DutyCycleThrottle", "RetryPolicy", "TrainCheckpointer",
           "apply_env_limits", "apply_hbm_limit", "duty_throttle",
           "hbm_fraction", "retry_call"]
