"""storage.k8s.io/v1 + scheduling.k8s.io/v1 types.

Reference: staging/src/k8s.io/api/storage/v1/types.go (StorageClass,
CSINode) and scheduling/v1/types.go (PriorityClass).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .types import ObjectMeta


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = "Immediate"  # Immediate | WaitForFirstConsumer
    reclaim_policy: str = "Delete"  # Delete | Retain
    # [{"matchLabelExpressions": [{"key": ..., "values": [...]}]}] — the
    # TopologySelectorTerm shape provisioners honour (storage/v1 types.go
    # AllowedTopologies).
    allowed_topologies: Optional[List[dict]] = None
    # storage/v1 StorageClass.AllowVolumeExpansion — gates the
    # persistentvolume-expander controller
    allow_volume_expansion: bool = False
    kind: str = "StorageClass"
    api_version: str = "storage.k8s.io/v1"

# Provisioner value that means "static provisioning only" (storage/v1).
PROVISIONER_NO_PROVISIONER = "kubernetes.io/no-provisioner"


@dataclass
class CSINodeDriver:
    name: str = ""
    node_id: str = ""
    count: Optional[int] = None  # allocatable volume count


@dataclass
class CSINodeSpec:
    drivers: Optional[List[CSINodeDriver]] = None


@dataclass
class CSINode:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CSINodeSpec = field(default_factory=CSINodeSpec)
    kind: str = "CSINode"
    api_version: str = "storage.k8s.io/v1"


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    description: str = ""
    preemption_policy: Optional[str] = None
    kind: str = "PriorityClass"
    api_version: str = "scheduling.k8s.io/v1"


# -- node.k8s.io/v1 RuntimeClass (staging/src/k8s.io/api/node/v1/types.go)


@dataclass
class RuntimeClassOverhead:
    pod_fixed: Optional[Dict[str, str]] = None


@dataclass
class RuntimeClassScheduling:
    node_selector: Optional[Dict[str, str]] = None
    tolerations: Optional[List] = None  # List[v1.Toleration]


@dataclass
class RuntimeClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    handler: str = ""
    overhead: Optional[RuntimeClassOverhead] = None
    scheduling: Optional[RuntimeClassScheduling] = None
    kind: str = "RuntimeClass"
    api_version: str = "node.k8s.io/v1"
