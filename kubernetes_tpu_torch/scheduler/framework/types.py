"""Scheduler-internal representations the encoders need.

Partial copy of kubernetes_tpu/scheduler/framework/types.py (reference:
pkg/scheduler/framework/types.go): Resource (int64 milli-units, :318),
calculate_resource and PodInfo (:72) with pre-parsed affinity terms.
NodeInfo, QueuedPodInfo and HostPortInfo belong to the scheduler loop,
which a later slice ports.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ...api import types as v1
from ...api.labels import Selector
from ...api.quantity import milli_value_of, value_of

# Non-zero request defaults (reference: pkg/scheduler/util/non_zero.go:33-38)
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


def is_scalar_resource_name(name: str) -> bool:
    """v1helper.IsScalarResourceName: extended, hugepages, attachable-volumes.

    Native resources are unprefixed or under *kubernetes.io/; everything else
    with a domain is an extended resource.
    """
    if name.startswith("hugepages-") or name.startswith("attachable-volumes-"):
        return True
    if "/" in name:
        domain = name.split("/", 1)[0]
        return not (domain == "kubernetes.io" or domain.endswith(".kubernetes.io"))
    return False


class Resource:
    """framework.Resource (types.go:318): int64 milli-CPU, bytes, scalars."""

    __slots__ = ("milli_cpu", "memory", "ephemeral_storage", "allowed_pod_number", "scalar_resources")

    def __init__(self):
        self.milli_cpu = 0
        self.memory = 0
        self.ephemeral_storage = 0
        self.allowed_pod_number = 0
        self.scalar_resources: Dict[str, int] = {}

    def add(self, resource_list: Optional[Dict[str, str]]) -> None:
        """Resource.Add (types.go:345)."""
        for name, q in (resource_list or {}).items():
            if name == v1.RESOURCE_CPU:
                self.milli_cpu += milli_value_of(q)
            elif name == v1.RESOURCE_MEMORY:
                self.memory += value_of(q)
            elif name == v1.RESOURCE_PODS:
                self.allowed_pod_number += value_of(q)
            elif name == v1.RESOURCE_EPHEMERAL_STORAGE:
                self.ephemeral_storage += value_of(q)
            elif is_scalar_resource_name(name):
                self.scalar_resources[name] = (
                    self.scalar_resources.get(name, 0) + value_of(q)
                )

    def set_max(self, resource_list: Optional[Dict[str, str]]) -> None:
        """Resource.SetMaxResource (types.go:393) — per-dimension max."""
        for name, q in (resource_list or {}).items():
            if name == v1.RESOURCE_CPU:
                self.milli_cpu = max(self.milli_cpu, milli_value_of(q))
            elif name == v1.RESOURCE_MEMORY:
                self.memory = max(self.memory, value_of(q))
            elif name == v1.RESOURCE_EPHEMERAL_STORAGE:
                self.ephemeral_storage = max(self.ephemeral_storage, value_of(q))
            elif is_scalar_resource_name(name):
                self.scalar_resources[name] = max(
                    self.scalar_resources.get(name, 0), value_of(q)
                )

    def clone(self) -> "Resource":
        r = Resource()
        r.milli_cpu = self.milli_cpu
        r.memory = self.memory
        r.ephemeral_storage = self.ephemeral_storage
        r.allowed_pod_number = self.allowed_pod_number
        r.scalar_resources = dict(self.scalar_resources)
        return r

    def __repr__(self):
        return (
            f"Resource(cpu={self.milli_cpu}m, mem={self.memory}, "
            f"eph={self.ephemeral_storage}, pods={self.allowed_pod_number}, "
            f"scalar={self.scalar_resources})"
        )


def _nonzero_requests(requests: Optional[Dict[str, str]]) -> Tuple[int, int]:
    """GetNonzeroRequests (util/non_zero.go:42): defaults for unset cpu/mem."""
    requests = requests or {}
    if v1.RESOURCE_CPU in requests:
        cpu = milli_value_of(requests[v1.RESOURCE_CPU])
    else:
        cpu = DEFAULT_MILLI_CPU_REQUEST
    if v1.RESOURCE_MEMORY in requests:
        mem = value_of(requests[v1.RESOURCE_MEMORY])
    else:
        mem = DEFAULT_MEMORY_REQUEST
    return cpu, mem


def calculate_resource(pod: v1.Pod) -> Tuple[Resource, int, int]:
    """types.go:671 calculateResource: pod request = sum(containers) maxed
    with each initContainer, plus overhead; plus the NonZero cpu/mem pair."""
    res = Resource()
    non0_cpu = 0
    non0_mem = 0
    for c in pod.spec.containers:
        res.add(c.resources.requests)
        cpu, mem = _nonzero_requests(c.resources.requests)
        non0_cpu += cpu
        non0_mem += mem
    for ic in pod.spec.init_containers or []:
        res.set_max(ic.resources.requests)
        cpu, mem = _nonzero_requests(ic.resources.requests)
        non0_cpu = max(non0_cpu, cpu)
        non0_mem = max(non0_mem, mem)
    if pod.spec.overhead:
        res.add(pod.spec.overhead)
        if v1.RESOURCE_CPU in pod.spec.overhead:
            non0_cpu += milli_value_of(pod.spec.overhead[v1.RESOURCE_CPU])
        if v1.RESOURCE_MEMORY in pod.spec.overhead:
            non0_mem += value_of(pod.spec.overhead[v1.RESOURCE_MEMORY])
    return res, non0_cpu, non0_mem


# ---------------------------------------------------------------------------
# Affinity terms (types.go:60-70, :136-216)


class AffinityTerm:
    """Pre-parsed PodAffinityTerm: namespaces set + compiled selector."""

    __slots__ = ("namespaces", "selector", "topology_key")

    def __init__(self, namespaces: Set[str], selector: Selector, topology_key: str):
        self.namespaces = namespaces
        self.selector = selector
        self.topology_key = topology_key

    def matches(self, pod: v1.Pod) -> bool:
        """PodMatchesTermsNamespaceAndSelector (util/topologies.go:40)."""
        if pod.metadata.namespace not in self.namespaces:
            return False
        return self.selector.matches(pod.metadata.labels)


class WeightedAffinityTerm(AffinityTerm):
    __slots__ = ("weight",)

    def __init__(self, namespaces, selector, topology_key, weight: int):
        super().__init__(namespaces, selector, topology_key)
        self.weight = weight


def _term_namespaces(pod: v1.Pod, term: v1.PodAffinityTerm) -> Set[str]:
    """util/topologies.go:28 getNamespacesFromPodAffinityTerm: empty list
    means the pod's own namespace."""
    if term.namespaces:
        return set(term.namespaces)
    return {pod.metadata.namespace}


def _parse_terms(pod: v1.Pod, terms: Optional[List[v1.PodAffinityTerm]]) -> List[AffinityTerm]:
    out = []
    for t in terms or []:
        out.append(
            AffinityTerm(
                _term_namespaces(pod, t),
                Selector.from_label_selector(t.label_selector),
                t.topology_key,
            )
        )
    return out


def _parse_weighted_terms(
    pod: v1.Pod, terms: Optional[List[v1.WeightedPodAffinityTerm]]
) -> List[WeightedAffinityTerm]:
    out = []
    for wt in terms or []:
        t = wt.pod_affinity_term
        out.append(
            WeightedAffinityTerm(
                _term_namespaces(pod, t),
                Selector.from_label_selector(t.label_selector),
                t.topology_key,
                wt.weight,
            )
        )
    return out


class PodInfo:
    """Pod plus pre-parsed affinity terms (types.go:72 PodInfo)."""

    __slots__ = (
        "pod",
        "required_affinity_terms",
        "required_anti_affinity_terms",
        "preferred_affinity_terms",
        "preferred_anti_affinity_terms",
    )

    def __init__(self, pod: v1.Pod):
        self.pod = pod
        affinity = pod.spec.affinity
        pa = affinity.pod_affinity if affinity else None
        paa = affinity.pod_anti_affinity if affinity else None
        self.required_affinity_terms = _parse_terms(
            pod, pa.required_during_scheduling_ignored_during_execution if pa else None
        )
        self.required_anti_affinity_terms = _parse_terms(
            pod, paa.required_during_scheduling_ignored_during_execution if paa else None
        )
        self.preferred_affinity_terms = _parse_weighted_terms(
            pod, pa.preferred_during_scheduling_ignored_during_execution if pa else None
        )
        self.preferred_anti_affinity_terms = _parse_weighted_terms(
            pod, paa.preferred_during_scheduling_ignored_during_execution if paa else None
        )
