"""NodeResources plugins: Fit, BalancedAllocation, LeastAllocated,
MostAllocated, RequestedToCapacityRatio.

Reference: pkg/scheduler/framework/plugins/noderesources/ —
fit.go:148 computePodResourceRequest / :230 fitsRequest,
resource_allocation.go:45 score / :91 calculateResourceAllocatableRequest,
balanced_allocation.go:82 balancedResourceScorer,
least_allocated.go:93 leastResourceScorer,
most_allocated.go:91 mostResourceScorer,
requested_to_capacity_ratio.go:124 scorer + :158 buildBrokenLinearFunction.

All math is int64 except BalancedAllocation's fractions (float64 in the
reference too); truncation (Go int64() conversion) is preserved.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ...api import types as v1
from ...api.quantity import Quantity
from ..framework import interface as fwk
from ..framework.interface import CycleState, Status
from ..framework.types import (
    NodeInfo,
    Resource,
    calculate_resource,
    is_scalar_resource_name,
    _nonzero_requests,
)

PRE_FILTER_STATE_KEY = "PreFilterNodeResourcesFit"


def _go_div(a: int, b: int) -> int:
    """Go int64 division: truncation toward zero (Python // floors)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def compute_pod_resource_request(pod: v1.Pod) -> Resource:
    """fit.go:148: sum(containers) maxed with init containers + overhead."""
    res, _, _ = calculate_resource(pod)
    return res


class Fit(fwk.PreFilterPlugin, fwk.FilterPlugin):
    name = "NodeResourcesFit"

    def __init__(self, args: Optional[dict] = None, handle=None):
        args = args or {}
        self.ignored_resources = set(args.get("ignoredResources", []))
        self.ignored_resource_groups = set(args.get("ignoredResourceGroups", []))

    def pre_filter(self, state: CycleState, pod: v1.Pod) -> Optional[Status]:
        state.write(PRE_FILTER_STATE_KEY, compute_pod_resource_request(pod))
        return None

    def filter(self, state: CycleState, pod: v1.Pod, node_info: NodeInfo) -> Optional[Status]:
        try:
            req: Resource = state.read(PRE_FILTER_STATE_KEY)
        except KeyError as e:
            return Status.error(str(e))
        insufficient = fits_request(
            req, node_info, self.ignored_resources, self.ignored_resource_groups
        )
        if insufficient:
            return Status.unschedulable(*[r for _, r in insufficient])
        return None


def fits_request(
    pod_request: Resource,
    node_info: NodeInfo,
    ignored_resources=frozenset(),
    ignored_resource_groups=frozenset(),
) -> List[Tuple[str, str]]:
    """fit.go:230 fitsRequest → [(resource, reason)]."""
    insufficient: List[Tuple[str, str]] = []
    if len(node_info.pods) + 1 > node_info.allocatable.allowed_pod_number:
        insufficient.append((v1.RESOURCE_PODS, "Too many pods"))
    if (
        pod_request.milli_cpu == 0
        and pod_request.memory == 0
        and pod_request.ephemeral_storage == 0
        and not pod_request.scalar_resources
    ):
        return insufficient
    if pod_request.milli_cpu > node_info.allocatable.milli_cpu - node_info.requested.milli_cpu:
        insufficient.append((v1.RESOURCE_CPU, "Insufficient cpu"))
    if pod_request.memory > node_info.allocatable.memory - node_info.requested.memory:
        insufficient.append((v1.RESOURCE_MEMORY, "Insufficient memory"))
    if (
        pod_request.ephemeral_storage
        > node_info.allocatable.ephemeral_storage - node_info.requested.ephemeral_storage
    ):
        insufficient.append((v1.RESOURCE_EPHEMERAL_STORAGE, "Insufficient ephemeral-storage"))
    for name, quant in pod_request.scalar_resources.items():
        if name in ignored_resources:
            continue
        if "/" in name and name.split("/", 1)[0] in ignored_resource_groups:
            continue
        if quant > node_info.allocatable.scalar_resources.get(name, 0) - node_info.requested.scalar_resources.get(name, 0):
            insufficient.append((name, f"Insufficient {name}"))
    return insufficient


# ---------------------------------------------------------------------------
# Score plugins sharing resource_allocation.go's scorer scaffold


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


def calculate_resource_allocatable_request(
    node_info: NodeInfo, pod: v1.Pod, resource: str
) -> Tuple[int, int]:
    """resource_allocation.go:91: (allocatable, requested+pod); cpu/mem use
    NonZeroRequested, others use Requested."""
    pod_request = calculate_pod_resource_request(pod, resource)
    if resource == v1.RESOURCE_CPU:
        return node_info.allocatable.milli_cpu, node_info.non_zero_requested.milli_cpu + pod_request
    if resource == v1.RESOURCE_MEMORY:
        return node_info.allocatable.memory, node_info.non_zero_requested.memory + pod_request
    if resource == v1.RESOURCE_EPHEMERAL_STORAGE:
        return (
            node_info.allocatable.ephemeral_storage,
            node_info.requested.ephemeral_storage + pod_request,
        )
    if is_scalar_resource_name(resource):
        return (
            node_info.allocatable.scalar_resources.get(resource, 0),
            node_info.requested.scalar_resources.get(resource, 0) + pod_request,
        )
    return 0, 0


class _ResourceAllocationScorer(fwk.ScorePlugin):
    """resource_allocation.go:36 resourceAllocationScorer scaffold."""

    resource_weights: Dict[str, int] = {v1.RESOURCE_CPU: 1, v1.RESOURCE_MEMORY: 1}

    def __init__(self, args: Optional[dict] = None, handle=None):
        self.handle = handle
        args = args or {}
        if args.get("resources"):
            self.resource_weights = {
                r["name"]: r.get("weight", 1) for r in args["resources"]
            }

    def _scorer(self, requested: Dict[str, int], allocatable: Dict[str, int]) -> int:
        raise NotImplementedError

    def score(self, state: CycleState, pod: v1.Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        snapshot = self.handle.snapshot_shared_lister()
        try:
            node_info = snapshot.get(node_name)
        except KeyError as e:
            return 0, Status.error(str(e))
        requested: Dict[str, int] = {}
        allocatable: Dict[str, int] = {}
        for resource in self.resource_weights:
            allocatable[resource], requested[resource] = calculate_resource_allocatable_request(
                node_info, pod, resource
            )
        return self._scorer(requested, allocatable), None


def _fraction_of_capacity(requested: int, capacity: int) -> float:
    if capacity == 0:
        return 1.0
    return requested / capacity


class BalancedAllocation(_ResourceAllocationScorer):
    name = "NodeResourcesBalancedAllocation"

    def _scorer(self, requested, allocatable) -> int:
        """balanced_allocation.go:82: (1 - |cpuFrac - memFrac|) * 100."""
        cpu_fraction = _fraction_of_capacity(
            requested[v1.RESOURCE_CPU], allocatable[v1.RESOURCE_CPU]
        )
        memory_fraction = _fraction_of_capacity(
            requested[v1.RESOURCE_MEMORY], allocatable[v1.RESOURCE_MEMORY]
        )
        if cpu_fraction >= 1 or memory_fraction >= 1:
            return 0
        diff = abs(cpu_fraction - memory_fraction)
        return int((1 - diff) * fwk.MAX_NODE_SCORE)


def least_requested_score(requested: int, capacity: int) -> int:
    """least_allocated.go:108."""
    if capacity == 0 or requested > capacity:
        return 0
    return (capacity - requested) * fwk.MAX_NODE_SCORE // capacity


def most_requested_score(requested: int, capacity: int) -> int:
    """most_allocated.go:108."""
    if capacity == 0 or requested > capacity:
        return 0
    return requested * fwk.MAX_NODE_SCORE // capacity


class LeastAllocated(_ResourceAllocationScorer):
    name = "NodeResourcesLeastAllocated"

    def _scorer(self, requested, allocatable) -> int:
        node_score = 0
        weight_sum = 0
        for resource, weight in self.resource_weights.items():
            node_score += least_requested_score(requested[resource], allocatable[resource]) * weight
            weight_sum += weight
        return node_score // weight_sum


class MostAllocated(_ResourceAllocationScorer):
    name = "NodeResourcesMostAllocated"

    def _scorer(self, requested, allocatable) -> int:
        node_score = 0
        weight_sum = 0
        for resource, weight in self.resource_weights.items():
            node_score += most_requested_score(requested[resource], allocatable[resource]) * weight
            weight_sum += weight
        return node_score // weight_sum


MAX_CUSTOM_PRIORITY_SCORE = 10  # requested_to_capacity_ratio.go:32


class RequestedToCapacityRatio(_ResourceAllocationScorer):
    name = "RequestedToCapacityRatio"

    def __init__(self, args: Optional[dict] = None, handle=None):
        super().__init__(args, handle)
        args = args or {}
        shape = args.get("shape") or [
            {"utilization": 0, "score": 0},
            {"utilization": 100, "score": MAX_CUSTOM_PRIORITY_SCORE},
        ]
        # scale scores to MaxNodeScore range (requested_to_capacity_ratio.go:63)
        self.shape = [
            (int(p["utilization"]), int(p["score"]) * fwk.MAX_NODE_SCORE // MAX_CUSTOM_PRIORITY_SCORE)
            for p in shape
        ]

    def _raw(self, p: int) -> int:
        """buildBrokenLinearFunction (requested_to_capacity_ratio.go:158).

        Go int64 division truncates toward zero; matters on decreasing
        segments where the interpolation numerator is negative.
        """
        shape = self.shape
        for i, (util, score) in enumerate(shape):
            if p <= util:
                if i == 0:
                    return score
                prev_util, prev_score = shape[i - 1]
                return prev_score + _go_div(
                    (score - prev_score) * (p - prev_util), util - prev_util
                )
        return shape[-1][1]

    def _scorer(self, requested, allocatable) -> int:
        """requested_to_capacity_ratio.go:133-145: only resources scoring > 0
        contribute to the weighted average; result is math.Round'ed."""
        node_score = 0
        weight_sum = 0
        for resource, weight in self.resource_weights.items():
            capacity = allocatable[resource]
            req = requested[resource]
            if capacity == 0 or req > capacity:
                resource_score = self._raw(100)  # maxUtilization
            else:
                resource_score = self._raw(100 - _go_div((capacity - req) * 100, capacity))
            if resource_score > 0:
                node_score += resource_score * weight
                weight_sum += weight
        if weight_sum == 0:
            return 0
        # Go math.Round: half away from zero (all values non-negative here)
        return int(math.floor(node_score / weight_sum + 0.5))
