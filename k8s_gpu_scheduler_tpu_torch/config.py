"""The registry part of the JAX package's ``config.py``: where the
workload publisher finds the registry, overridable from the environment
(``TPU_SCHED_REGISTRY_*``)."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


def _env(name: str, default, cast=None):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is None:
        cast = type(default) if default is not None else str
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class RegistryConfig:
    """The KV registry's address and credentials."""

    host: str = "127.0.0.1"
    port: int = 32767
    password: Optional[str] = None
    db: int = 0


@dataclass
class SchedulerConfig:
    registry: RegistryConfig = field(default_factory=RegistryConfig)

    @staticmethod
    def from_env() -> "SchedulerConfig":
        cfg = SchedulerConfig()
        cfg.registry.host = _env("TPU_SCHED_REGISTRY_HOST", cfg.registry.host)
        cfg.registry.port = _env("TPU_SCHED_REGISTRY_PORT", cfg.registry.port,
                                 int)
        cfg.registry.password = _env("TPU_SCHED_REGISTRY_PASSWORD",
                                     cfg.registry.password, str)
        return cfg
