"""Test harness pieces of the port: seeded fault injection
(``faults.py``)."""
from .faults import FaultInjector, FaultRule, InjectedFault, Preempted

__all__ = ["FaultInjector", "FaultRule", "InjectedFault", "Preempted"]
