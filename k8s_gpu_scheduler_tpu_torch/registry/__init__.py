"""Registry layer of the port: the RESP client of the kvstored registry
and the key layout the workload publisher and the fleet write (copies of
the JAX package's ``registry/`` modules)."""
from .client import AuthError, Client, ConnectionLost, RegistryError
from .inventory import (
    LATENCY_KEY_PREFIX, OBSERVED_KEY_PREFIX, REPLICA_KEY_PREFIX, Observation,
    latency_key, observed_key, replica_key,
)

__all__ = ["AuthError", "Client", "ConnectionLost", "LATENCY_KEY_PREFIX",
           "OBSERVED_KEY_PREFIX", "Observation", "REPLICA_KEY_PREFIX",
           "RegistryError", "latency_key", "observed_key", "replica_key"]
