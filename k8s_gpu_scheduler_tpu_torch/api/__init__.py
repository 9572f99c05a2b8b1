from .objects import (  # noqa: F401
    Container,
    ConfigMap,
    ConfigMapRef,
    EnvVar,
    Node,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodGroup,
    PodSpec,
    PodStatus,
    ResourceRequirements,
    TPU_RESOURCE,
)
from .topology import SliceTopology, TPUGen, ici_hop_distance  # noqa: F401
