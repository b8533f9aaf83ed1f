"""apps/v1 workload types: ReplicaSet, Deployment, DaemonSet, StatefulSet.

Hand-written equivalents of the reference's apps group structs
(reference: staging/src/k8s.io/api/apps/v1/types.go). Only the fields the
controllers reconcile on are carried; everything round-trips through
utils.serde with camelCase keys like the reference's JSON tags.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .types import LabelSelector, ObjectMeta, PodTemplateSpec

# ---------------------------------------------------------------------------
# ReplicaSet (reference: apps/v1/types.go ReplicaSet)


@dataclass
class ReplicaSetSpec:
    replicas: Optional[int] = None  # default 1
    min_ready_seconds: int = 0
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class ReplicaSetStatus:
    replicas: int = 0
    fully_labeled_replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicaSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicaSetSpec = field(default_factory=ReplicaSetSpec)
    status: ReplicaSetStatus = field(default_factory=ReplicaSetStatus)
    kind: str = "ReplicaSet"
    api_version: str = "apps/v1"


# ---------------------------------------------------------------------------
# Deployment (reference: apps/v1/types.go Deployment; RollingUpdate strategy)


@dataclass
class RollingUpdateDeployment:
    max_unavailable: Optional[str] = None  # int or percent string, default 25%
    max_surge: Optional[str] = None  # default 25%


@dataclass
class DeploymentStrategy:
    type: str = "RollingUpdate"  # RollingUpdate | Recreate
    rolling_update: Optional[RollingUpdateDeployment] = None


@dataclass
class DeploymentSpec:
    replicas: Optional[int] = None
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    strategy: DeploymentStrategy = field(default_factory=DeploymentStrategy)
    min_ready_seconds: int = 0
    revision_history_limit: Optional[int] = None
    paused: bool = False


@dataclass
class DeploymentStatus:
    observed_generation: int = 0
    replicas: int = 0
    updated_replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    unavailable_replicas: int = 0


@dataclass
class Deployment:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)
    status: DeploymentStatus = field(default_factory=DeploymentStatus)
    kind: str = "Deployment"
    api_version: str = "apps/v1"


# ---------------------------------------------------------------------------
# DaemonSet (reference: apps/v1/types.go DaemonSet)


@dataclass
class DaemonSetSpec:
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    min_ready_seconds: int = 0


@dataclass
class DaemonSetStatus:
    current_number_scheduled: int = 0
    number_misscheduled: int = 0
    desired_number_scheduled: int = 0
    number_ready: int = 0
    observed_generation: int = 0


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)
    status: DaemonSetStatus = field(default_factory=DaemonSetStatus)
    kind: str = "DaemonSet"
    api_version: str = "apps/v1"


# ---------------------------------------------------------------------------
# StatefulSet (reference: apps/v1/types.go StatefulSet; ordered identity)


@dataclass
class StatefulSetSpec:
    replicas: Optional[int] = None
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    service_name: str = ""
    pod_management_policy: str = "OrderedReady"  # OrderedReady | Parallel


@dataclass
class StatefulSetStatus:
    observed_generation: int = 0
    replicas: int = 0
    ready_replicas: int = 0
    current_replicas: int = 0
    updated_replicas: int = 0


@dataclass
class StatefulSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: StatefulSetSpec = field(default_factory=StatefulSetSpec)
    status: StatefulSetStatus = field(default_factory=StatefulSetStatus)
    kind: str = "StatefulSet"
    api_version: str = "apps/v1"
