"""discovery.k8s.io EndpointSlice types.

Reference: staging/src/k8s.io/api/discovery/v1beta1/types.go — EndpointSlice
(:33) with AddressType, Endpoints[] (:87 Endpoint: Addresses, Conditions,
Topology/NodeName, TargetRef) and Ports[]; slices are tied to their Service
by the kubernetes.io/service-name label (:169 LabelServiceName). The
endpointslice controller caps endpoints per slice at 100 by default
(pkg/controller/endpointslice/endpointslice_controller.go:61
maxEndpointsPerSlice default).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .types import ObjectMeta

LABEL_SERVICE_NAME = "kubernetes.io/service-name"
MAX_ENDPOINTS_PER_SLICE = 100


@dataclass
class EndpointConditions:
    ready: bool = True


@dataclass
class Endpoint:
    addresses: List[str] = field(default_factory=list)
    conditions: EndpointConditions = field(default_factory=EndpointConditions)
    node_name: str = ""
    target_ref_name: str = ""  # pod name (flattened ObjectReference)
    target_ref_namespace: str = ""
    topology: Optional[Dict[str, str]] = None


@dataclass
class EndpointSlicePort:
    name: str = ""
    protocol: str = "TCP"
    port: int = 0


@dataclass
class EndpointSlice:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    address_type: str = "IPv4"
    endpoints: Optional[List[Endpoint]] = None
    ports: Optional[List[EndpointSlicePort]] = None
    kind: str = "EndpointSlice"
    api_version: str = "discovery.k8s.io/v1beta1"
