"""Scheduler plugins of the port (copies of the JAX package's
``plugins/``).

``tpu``  — chip-accounting Filter, SLO-slack/interference Score with the
           utilization fallback, Reserve-decided device assignment written
           in PostBind.
``gang`` — Permit-based all-or-nothing admission with ICI-topology-aware
           node-set selection.
``preemption`` — PostFilter evicting lower-priority pods for a starving
           high-priority pod."""
from .tpu import TPUPlugin
from .gang import GangPlugin
from .preemption import PreemptionPlugin

__all__ = ["TPUPlugin", "GangPlugin", "PreemptionPlugin"]
