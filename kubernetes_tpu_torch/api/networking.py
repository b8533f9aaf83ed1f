"""networking.k8s.io/v1 types: NetworkPolicy, Ingress, IngressClass.

Reference: staging/src/k8s.io/api/networking/v1/types.go — NetworkPolicy
(:30) with PolicyTypes/Ingress/Egress rules over peers (podSelector /
namespaceSelector / ipBlock) and ports; Ingress (:393 area) with rules,
TLS, and the ingressClassName pointer; IngressClass (:550 area) with the
is-default-class annotation the DefaultIngressClass admission plugin
consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from .types import LabelSelector, ObjectMeta

# annotation marking the cluster-default IngressClass
# (ingressclass.go AnnotationIsDefaultIngressClass)
DEFAULT_INGRESS_CLASS_ANNOTATION = \
    "ingressclass.kubernetes.io/is-default-class"

POLICY_TYPE_INGRESS = "Ingress"
POLICY_TYPE_EGRESS = "Egress"


# -- NetworkPolicy (types.go:30) -------------------------------------------


@dataclass
class IPBlock:
    cidr: str = ""
    except_: Optional[List[str]] = field(
        default=None, metadata={"json": "except"}
    )


@dataclass
class NetworkPolicyPeer:
    pod_selector: Optional[LabelSelector] = None
    namespace_selector: Optional[LabelSelector] = None
    ip_block: Optional[IPBlock] = None


@dataclass
class NetworkPolicyPort:
    protocol: str = "TCP"
    # None = every port; int = numeric; str = a NAMED container port,
    # resolved against the destination pod's container specs
    # (types.go IntOrString — networking/v1/types.go NetworkPolicyPort)
    port: Optional[Union[int, str]] = None
    end_port: Optional[int] = None  # inclusive range [port, endPort]


@dataclass
class NetworkPolicyIngressRule:
    # empty/missing from_ = every source; empty ports = every port
    from_: Optional[List[NetworkPolicyPeer]] = field(
        default=None, metadata={"json": "from"}
    )
    ports: Optional[List[NetworkPolicyPort]] = None


@dataclass
class NetworkPolicyEgressRule:
    to: Optional[List[NetworkPolicyPeer]] = None
    ports: Optional[List[NetworkPolicyPort]] = None


@dataclass
class NetworkPolicySpec:
    pod_selector: LabelSelector = field(default_factory=LabelSelector)
    ingress: Optional[List[NetworkPolicyIngressRule]] = None
    egress: Optional[List[NetworkPolicyEgressRule]] = None
    # which directions this policy constrains; defaulted per types.go:
    # always Ingress, plus Egress when egress rules are present
    policy_types: Optional[List[str]] = None


@dataclass
class NetworkPolicy:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NetworkPolicySpec = field(default_factory=NetworkPolicySpec)
    kind: str = "NetworkPolicy"
    api_version: str = "networking.k8s.io/v1"


def effective_policy_types(spec: NetworkPolicySpec) -> List[str]:
    """types.go PolicyType defaulting: unset -> [Ingress] plus Egress
    iff egress rules exist."""
    if spec.policy_types:
        return list(spec.policy_types)
    out = [POLICY_TYPE_INGRESS]
    if spec.egress:
        out.append(POLICY_TYPE_EGRESS)
    return out


# -- Ingress (types.go Ingress area) ---------------------------------------


@dataclass
class ServiceBackendPort:
    name: str = ""
    number: int = 0


@dataclass
class IngressServiceBackend:
    name: str = ""  # Service name
    port: ServiceBackendPort = field(default_factory=ServiceBackendPort)


@dataclass
class IngressBackend:
    service: Optional[IngressServiceBackend] = None


@dataclass
class HTTPIngressPath:
    path: str = ""
    path_type: str = "Prefix"  # Exact | Prefix | ImplementationSpecific
    backend: IngressBackend = field(default_factory=IngressBackend)


@dataclass
class HTTPIngressRuleValue:
    paths: List[HTTPIngressPath] = field(default_factory=list)


@dataclass
class IngressRule:
    host: str = ""
    http: Optional[HTTPIngressRuleValue] = None


@dataclass
class IngressTLS:
    hosts: Optional[List[str]] = None
    secret_name: str = ""


@dataclass
class IngressSpec:
    ingress_class_name: Optional[str] = None
    default_backend: Optional[IngressBackend] = None
    rules: Optional[List[IngressRule]] = None
    tls: Optional[List[IngressTLS]] = None


@dataclass
class IngressPortStatus:
    port: int = 0
    protocol: str = "TCP"


@dataclass
class IngressLoadBalancerIngress:
    ip: str = ""
    hostname: str = ""
    ports: Optional[List[IngressPortStatus]] = None


@dataclass
class IngressStatus:
    load_balancer_ingress: Optional[List[IngressLoadBalancerIngress]] = None


@dataclass
class Ingress:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: IngressSpec = field(default_factory=IngressSpec)
    status: IngressStatus = field(default_factory=IngressStatus)
    kind: str = "Ingress"
    api_version: str = "networking.k8s.io/v1"


# -- IngressClass ----------------------------------------------------------


@dataclass
class IngressClassParametersReference:
    api_group: str = ""
    kind: str = ""
    name: str = ""
    namespace: str = ""
    scope: str = "Cluster"


@dataclass
class IngressClassSpec:
    controller: str = ""
    parameters: Optional[IngressClassParametersReference] = None


@dataclass
class IngressClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: IngressClassSpec = field(default_factory=IngressClassSpec)
    kind: str = "IngressClass"
    api_version: str = "networking.k8s.io/v1"
