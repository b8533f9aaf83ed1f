"""Resource helpers the encoders import.

Partial copy of kubernetes_tpu/scheduler/plugins/noderesources.py: only
calculate_pod_resource_request (resource_allocation.go:117), not the
plugins.
"""

from __future__ import annotations

from typing import Dict, Optional

from ...api import types as v1
from ...api.quantity import Quantity
from ..framework.types import _nonzero_requests, is_scalar_resource_name


def calculate_pod_resource_request(pod: v1.Pod, resource: str) -> int:
    """resource_allocation.go:117 calculatePodResourceRequest (non-zero)."""
    total = 0
    for c in pod.spec.containers:
        total += _nonzero_request_for(resource, c.resources.requests)
    for ic in pod.spec.init_containers or []:
        total = max(total, _nonzero_request_for(resource, ic.resources.requests))
    if pod.spec.overhead and resource in pod.spec.overhead:
        total += Quantity(pod.spec.overhead[resource]).value()
    return total


def _nonzero_request_for(resource: str, requests: Optional[Dict[str, str]]) -> int:
    cpu, mem = _nonzero_requests(requests)
    if resource == v1.RESOURCE_CPU:
        return cpu
    if resource == v1.RESOURCE_MEMORY:
        return mem
    requests = requests or {}
    if resource not in requests:
        return 0
    if resource == v1.RESOURCE_EPHEMERAL_STORAGE or is_scalar_resource_name(resource):
        return Quantity(requests[resource]).value()
    return 0
