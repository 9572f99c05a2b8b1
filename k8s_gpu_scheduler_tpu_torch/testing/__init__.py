"""Test harness pieces of the port: seeded fault injection
(``faults.py``)."""
from .faults import (
    FaultInjector, FaultProxy, FaultRule, InjectedFault, Preempted,
    ReplicaCrashed,
)

__all__ = ["FaultInjector", "FaultProxy", "FaultRule", "InjectedFault",
           "Preempted", "ReplicaCrashed"]
