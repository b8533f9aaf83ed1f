"""Core API types (the v1 data model subset the control plane needs).

Hand-written equivalents of the reference's generated API structs
(reference: staging/src/k8s.io/api/core/v1/types.go). Resource maps are kept
as {name: quantity-string} and parsed to exact int64 via api.quantity at the
edges, mirroring how the reference carries resource.Quantity and converts to
framework.Resource int64 milli-units inside the scheduler
(pkg/scheduler/framework/types.go:318 Resource.Add).

JSON round-trip uses utils.serde (camelCase keys, omitempty) so objects are
wire-compatible in shape with the reference's REST API.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# meta/v1


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: Optional[bool] = None
    block_owner_deletion: Optional[bool] = None


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    generation: int = 0
    creation_timestamp: Optional[float] = None  # unix seconds
    deletion_timestamp: Optional[float] = None
    labels: Optional[Dict[str, str]] = None
    annotations: Optional[Dict[str, str]] = None
    owner_references: Optional[List[OwnerReference]] = None
    finalizers: Optional[List[str]] = None


@dataclass
class LabelSelectorRequirement:
    key: str = ""
    operator: str = ""  # In | NotIn | Exists | DoesNotExist
    values: Optional[List[str]] = None


@dataclass
class LabelSelector:
    match_labels: Optional[Dict[str, str]] = None
    match_expressions: Optional[List[LabelSelectorRequirement]] = None


# ---------------------------------------------------------------------------
# Node


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = ""  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: Optional[List[Taint]] = None
    pod_cidr: str = field(default="", metadata={"json": "podCIDR"})
    provider_id: str = field(default="", metadata={"json": "providerID"})


@dataclass
class ContainerImage:
    names: Optional[List[str]] = None
    size_bytes: int = 0


@dataclass
class NodeCondition:
    type: str = ""  # Ready | MemoryPressure | DiskPressure | PIDPressure | ...
    status: str = ""  # True | False | Unknown
    last_heartbeat_time: Optional[float] = None
    last_transition_time: Optional[float] = None
    reason: str = ""
    message: str = ""


@dataclass
class AttachedVolume:
    """core/v1 AttachedVolume (node.status.volumesAttached entries, kept
    by the attach/detach controller)."""

    name: str = ""
    device_path: str = ""


@dataclass
class NodeStatus:
    capacity: Optional[Dict[str, str]] = None
    allocatable: Optional[Dict[str, str]] = None
    conditions: Optional[List[NodeCondition]] = None
    images: Optional[List[ContainerImage]] = None
    phase: str = ""
    volumes_attached: Optional[List[AttachedVolume]] = None
    volumes_in_use: Optional[List[str]] = None


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)
    kind: str = "Node"
    api_version: str = "v1"


# ---------------------------------------------------------------------------
# Pod spec: affinity


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = ""  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: Optional[List[str]] = None


@dataclass
class NodeSelectorTerm:
    match_expressions: Optional[List[NodeSelectorRequirement]] = None
    match_fields: Optional[List[NodeSelectorRequirement]] = None


@dataclass
class NodeSelector:
    node_selector_terms: Optional[List[NodeSelectorTerm]] = None


@dataclass
class PreferredSchedulingTerm:
    weight: int = 0  # 1-100
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class NodeAffinity:
    required_during_scheduling_ignored_during_execution: Optional[NodeSelector] = None
    preferred_during_scheduling_ignored_during_execution: Optional[
        List[PreferredSchedulingTerm]
    ] = None


@dataclass
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    namespaces: Optional[List[str]] = None
    topology_key: str = ""


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 0  # 1-100
    pod_affinity_term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required_during_scheduling_ignored_during_execution: Optional[
        List[PodAffinityTerm]
    ] = None
    preferred_during_scheduling_ignored_during_execution: Optional[
        List[WeightedPodAffinityTerm]
    ] = None


@dataclass
class PodAntiAffinity:
    required_during_scheduling_ignored_during_execution: Optional[
        List[PodAffinityTerm]
    ] = None
    preferred_during_scheduling_ignored_during_execution: Optional[
        List[WeightedPodAffinityTerm]
    ] = None


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class Toleration:
    key: str = ""
    operator: str = ""  # Exists | Equal (default Equal)
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = ""  # DoNotSchedule | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None


# ---------------------------------------------------------------------------
# Pod spec: containers


@dataclass
class ContainerPort:
    name: str = ""
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = field(default="", metadata={"json": "hostIP"})


@dataclass
class ResourceRequirements:
    limits: Optional[Dict[str, str]] = None
    requests: Optional[Dict[str, str]] = None


@dataclass
class Probe:
    """Liveness/readiness probe (core/v1 Probe; the exec handler is the
    one with runtime behavior here — CRI ExecSync)."""

    exec_command: Optional[List[str]] = None
    initial_delay_seconds: float = 0.0
    period_seconds: float = 10.0
    failure_threshold: int = 3
    success_threshold: int = 1


@dataclass
class Container:
    name: str = ""
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: Optional[List[ContainerPort]] = None
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    image_pull_policy: str = ""  # "" (default by tag) | Always | IfNotPresent | Never
    # core/v1 SecurityContext subset, carried as a dict (privileged,
    # runAsNonRoot, allowPrivilegeEscalation, capabilities, ...)
    security_context: Optional[Dict[str, object]] = None


@dataclass
class Volume:
    name: str = ""
    # volume sources are opaque to the scheduler core; carried as a dict
    source: Optional[Dict[str, object]] = None


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: Optional[List[Container]] = None
    node_name: str = ""
    node_selector: Optional[Dict[str, str]] = None
    affinity: Optional[Affinity] = None
    tolerations: Optional[List[Toleration]] = None
    topology_spread_constraints: Optional[List[TopologySpreadConstraint]] = None
    priority: Optional[int] = None
    priority_class_name: str = ""
    preemption_policy: Optional[str] = None  # PreemptLowerPriority | Never
    scheduler_name: str = ""
    overhead: Optional[Dict[str, str]] = None
    runtime_class_name: Optional[str] = None  # node.k8s.io RuntimeClass
    host_network: bool = False
    host_pid: bool = False
    host_ipc: bool = False
    volumes: Optional[List[Volume]] = None
    restart_policy: str = "Always"
    termination_grace_period_seconds: Optional[int] = None
    service_account_name: str = ""
    automount_service_account_token: Optional[bool] = None


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    last_transition_time: Optional[float] = None
    reason: str = ""
    message: str = ""


@dataclass
class ContainerStatus:
    name: str = ""
    ready: bool = False
    restart_count: int = 0
    image: str = ""
    state: str = ""  # waiting | running | terminated
    exit_code: Optional[int] = None


@dataclass
class PodStatus:
    phase: str = ""  # Pending | Running | Succeeded | Failed | Unknown
    conditions: Optional[List[PodCondition]] = None
    nominated_node_name: str = ""
    start_time: Optional[float] = None
    pod_ip: str = field(default="", metadata={"json": "podIP"})
    host_ip: str = field(default="", metadata={"json": "hostIP"})
    container_statuses: Optional[List[ContainerStatus]] = None
    reason: str = ""  # e.g. UnexpectedAdmissionError, Evicted
    message: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    kind: str = "Pod"
    api_version: str = "v1"


# Well-known labels (reference: staging/src/k8s.io/api/core/v1/well_known_labels.go)
# ---------------------------------------------------------------------------
# coordination.k8s.io/v1 Lease (leader election + node heartbeats;
# reference: staging/src/k8s.io/api/coordination/v1/types.go)


@dataclass
class LeaseSpec:
    holder_identity: str = ""
    lease_duration_seconds: int = 0
    acquire_time: Optional[float] = None
    renew_time: Optional[float] = None
    lease_transitions: int = 0


@dataclass
class Lease:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)
    kind: str = "Lease"
    api_version: str = "coordination.k8s.io/v1"


# ---------------------------------------------------------------------------
# policy/v1beta1 PodDisruptionBudget (subset preemption needs;
# reference: staging/src/k8s.io/api/policy/v1beta1/types.go)


@dataclass
class PodDisruptionBudgetSpec:
    min_available: Optional[str] = None  # int or percentage string
    max_unavailable: Optional[str] = None
    selector: Optional[LabelSelector] = None


@dataclass
class PodDisruptionBudgetStatus:
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(default_factory=PodDisruptionBudgetStatus)
    kind: str = "PodDisruptionBudget"
    api_version: str = "policy/v1beta1"


# ---------------------------------------------------------------------------
# Pod templates (workload controllers stamp pods from these;
# reference: staging/src/k8s.io/api/core/v1/types.go PodTemplateSpec)


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


# ---------------------------------------------------------------------------
# Service / Endpoints (reference: core/v1 Service, Endpoints)


@dataclass
class ServicePort:
    name: str = ""
    protocol: str = "TCP"
    port: int = 0
    target_port: int = 0
    node_port: int = 0


@dataclass
class ServiceSpec:
    selector: Optional[Dict[str, str]] = None
    ports: Optional[List[ServicePort]] = None
    cluster_ip: str = field(default="", metadata={"json": "clusterIP"})
    type: str = "ClusterIP"  # ClusterIP | NodePort | LoadBalancer | ExternalName
    session_affinity: str = ""
    external_name: str = ""


@dataclass
class ServiceStatus:
    load_balancer_ingress: Optional[List[str]] = None


@dataclass
class ReplicationControllerSpec:
    replicas: Optional[int] = None
    selector: Optional[Dict[str, str]] = None  # map selector (core/v1)
    template: Optional[PodTemplateSpec] = None
    min_ready_seconds: int = 0


@dataclass
class ReplicationControllerStatus:
    replicas: int = 0
    ready_replicas: int = 0


@dataclass
class ReplicationController:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicationControllerSpec = field(
        default_factory=ReplicationControllerSpec
    )
    status: ReplicationControllerStatus = field(
        default_factory=ReplicationControllerStatus
    )
    kind: str = "ReplicationController"
    api_version: str = "v1"


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: ServiceStatus = field(default_factory=ServiceStatus)
    kind: str = "Service"
    api_version: str = "v1"


@dataclass
class EndpointAddress:
    ip: str = ""
    node_name: str = ""
    target_ref_name: str = ""  # pod name (flattened ObjectReference)
    target_ref_namespace: str = ""


@dataclass
class EndpointPort:
    name: str = ""
    port: int = 0
    protocol: str = "TCP"


@dataclass
class EndpointSubset:
    addresses: Optional[List[EndpointAddress]] = None
    not_ready_addresses: Optional[List[EndpointAddress]] = None
    ports: Optional[List[EndpointPort]] = None


@dataclass
class Endpoints:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subsets: Optional[List[EndpointSubset]] = None
    kind: str = "Endpoints"
    api_version: str = "v1"


# ---------------------------------------------------------------------------
# Namespace (reference: core/v1 Namespace; finalizer-driven deletion)


@dataclass
class NamespaceSpec:
    finalizers: Optional[List[str]] = None


@dataclass
class NamespaceStatus:
    phase: str = ""  # Active | Terminating


@dataclass
class Namespace:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NamespaceSpec = field(default_factory=NamespaceSpec)
    status: NamespaceStatus = field(default_factory=NamespaceStatus)
    kind: str = "Namespace"
    api_version: str = "v1"


# ---------------------------------------------------------------------------
# ConfigMap (reference: core/v1 ConfigMap)


@dataclass
class ConfigMap:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Optional[Dict[str, str]] = None
    kind: str = "ConfigMap"
    api_version: str = "v1"


@dataclass
class Secret:
    """core/v1 Secret (string data only; the service-account token
    controller's token secrets are the load-bearing use)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Optional[Dict[str, str]] = None
    type: str = "Opaque"
    kind: str = "Secret"
    api_version: str = "v1"


SECRET_TYPE_SERVICE_ACCOUNT_TOKEN = "kubernetes.io/service-account-token"
SERVICE_ACCOUNT_NAME_ANNOTATION = "kubernetes.io/service-account.name"


# ---------------------------------------------------------------------------
# Persistent volumes (subset VolumeBinding needs; reference: core/v1
# PersistentVolume/PersistentVolumeClaim + volume node affinity)


@dataclass
class VolumeNodeAffinity:
    required: Optional[NodeSelector] = None


@dataclass
class PersistentVolumeSpec:
    capacity: Optional[Dict[str, str]] = None
    access_modes: Optional[List[str]] = None
    storage_class_name: str = ""
    claim_ref_namespace: str = ""  # flattened ObjectReference to bound claim
    claim_ref_name: str = ""
    node_affinity: Optional[VolumeNodeAffinity] = None
    persistent_volume_reclaim_policy: str = ""
    # volume source (PersistentVolumeSource, types.go): the CSI member
    # carries scheduling semantics (driver -> attach limits); the three
    # in-tree cloud-disk members exist for CSI MIGRATION
    # (csi-translation-lib) — the scheduler sees them only through
    # volume/csi_translation.py's translated copies
    csi: Optional[Dict[str, str]] = None  # {driver, volumeHandle}
    gce_persistent_disk: Optional[Dict[str, str]] = None  # {pdName, fsType}
    aws_elastic_block_store: Optional[Dict[str, str]] = None  # {volumeID}
    azure_disk: Optional[Dict[str, str]] = None  # {diskName}


@dataclass
class PersistentVolumeStatus:
    phase: str = ""  # Pending | Available | Bound | Released | Failed


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    status: PersistentVolumeStatus = field(default_factory=PersistentVolumeStatus)
    kind: str = "PersistentVolume"
    api_version: str = "v1"


@dataclass
class PersistentVolumeClaimSpec:
    access_modes: Optional[List[str]] = None
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    storage_class_name: Optional[str] = None
    volume_name: str = ""


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = ""  # Pending | Bound | Lost
    # granted capacity (core/v1 PersistentVolumeClaimStatus.Capacity) —
    # the expand controller reconciles spec.resources.requests against it
    capacity: Optional[Dict[str, str]] = None
    conditions: Optional[List[PodCondition]] = None  # e.g. Resizing


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)
    status: PersistentVolumeClaimStatus = field(
        default_factory=PersistentVolumeClaimStatus
    )
    kind: str = "PersistentVolumeClaim"
    api_version: str = "v1"


# ---------------------------------------------------------------------------
# ResourceQuota / LimitRange (reference: core/v1 ResourceQuota :5512,
# LimitRange :5415 in staging/src/k8s.io/api/core/v1/types.go)


@dataclass
class ResourceQuotaSpec:
    hard: Optional[Dict[str, str]] = None  # resource name -> quantity
    scopes: Optional[List[str]] = None


@dataclass
class ResourceQuotaStatus:
    hard: Optional[Dict[str, str]] = None
    used: Optional[Dict[str, str]] = None


@dataclass
class ResourceQuota:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceQuotaSpec = field(default_factory=ResourceQuotaSpec)
    status: ResourceQuotaStatus = field(default_factory=ResourceQuotaStatus)
    kind: str = "ResourceQuota"
    api_version: str = "v1"


@dataclass
class LimitRangeItem:
    type: str = "Container"  # Container | Pod
    max: Optional[Dict[str, str]] = None
    min: Optional[Dict[str, str]] = None
    default: Optional[Dict[str, str]] = None  # default limits
    default_request: Optional[Dict[str, str]] = None


@dataclass
class LimitRangeSpec:
    limits: Optional[List[LimitRangeItem]] = None


@dataclass
class LimitRange:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LimitRangeSpec = field(default_factory=LimitRangeSpec)
    kind: str = "LimitRange"
    api_version: str = "v1"


LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"
LABEL_ZONE_LEGACY = "failure-domain.beta.kubernetes.io/zone"
LABEL_REGION_LEGACY = "failure-domain.beta.kubernetes.io/region"

TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"

# Resource names (subset of v1.ResourceName)
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"


def pod_key(pod: Pod) -> str:
    """namespace/name cache key (reference: framework.GetPodKey)."""
    return f"{pod.metadata.namespace}/{pod.metadata.name}"
