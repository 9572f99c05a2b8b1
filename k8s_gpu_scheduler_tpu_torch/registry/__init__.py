"""Registry layer of the port: the RESP client of the kvstored registry
and the typed schema the node agent, the scheduler, the workload
publisher and the fleet share (copies of the JAX package's ``registry/``
modules)."""
from .client import AuthError, Client, ConnectionLost, RegistryError
from .inventory import (
    HEARTBEAT_SUFFIX, LATENCY_KEY_PREFIX, NODE_KEY_PREFIX,
    OBSERVED_KEY_PREFIX, REPLICA_KEY_PREFIX, ChipInfo, NodeInventory,
    Observation, latency_key, list_inventories, node_key, observed_key,
    publish_inventory, read_inventory, replica_key,
)

__all__ = ["AuthError", "ChipInfo", "Client", "ConnectionLost",
           "HEARTBEAT_SUFFIX", "LATENCY_KEY_PREFIX", "NODE_KEY_PREFIX",
           "NodeInventory", "OBSERVED_KEY_PREFIX", "Observation",
           "REPLICA_KEY_PREFIX", "RegistryError", "latency_key",
           "list_inventories", "node_key", "observed_key",
           "publish_inventory", "read_inventory", "replica_key"]
