"""Scheduler control plane of the port (copies of the JAX package's
``sched/`` modules): queue, cache with chip accounting, plugin extension
points, the reshaper and the scheduling/binding cycle. The leader
elector (``sched/leaderelection.py``) is not ported yet."""
from .cache import Cache, NodeInfo
from .framework import (
    CycleState,
    FilterPlugin,
    Handle,
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    PermitPlugin,
    Plugin,
    PostBindPlugin,
    PostFilterPlugin,
    PreFilterPlugin,
    Profile,
    ReservePlugin,
    ScorePlugin,
    Status,
    WaitingPod,
)
from .queue import SchedulingQueue, pod_priority
from .reshaper import SliceReshaper
from .scheduler import Scheduler

__all__ = [
    "Cache",
    "NodeInfo",
    "CycleState",
    "FilterPlugin",
    "Handle",
    "MAX_NODE_SCORE",
    "MIN_NODE_SCORE",
    "PermitPlugin",
    "Plugin",
    "PostBindPlugin",
    "PostFilterPlugin",
    "PreFilterPlugin",
    "Profile",
    "ReservePlugin",
    "ScorePlugin",
    "Status",
    "WaitingPod",
    "SchedulingQueue",
    "pod_priority",
    "SliceReshaper",
    "Scheduler",
]
