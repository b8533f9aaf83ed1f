"""Scheduler-internal representations of cluster state.

Reimplements framework types (reference: pkg/scheduler/framework/types.go):
Resource (int64 milli-units, :318), NodeInfo (:224) with the secondary
affinity lists and generation counter the incremental snapshot depends on,
PodInfo (:72) with pre-parsed affinity terms, QueuedPodInfo (:45), and
HostPortInfo (:608) conflict semantics.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Set, Tuple

from ...api import types as v1
from ...api.labels import Selector
from ...api.quantity import milli_value_of, value_of

# Non-zero request defaults (reference: pkg/scheduler/util/non_zero.go:33-38)
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

_generation = itertools.count(1)


def next_generation() -> int:
    """Monotonic generation for incremental snapshots (types.go:38)."""
    return next(_generation)


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


class QueuedPodInfo:
    """PodInfo + queueing bookkeeping (types.go:45)."""

    __slots__ = (
        "pod_info",
        "timestamp",
        "attempts",
        "initial_attempt_timestamp",
        "last_failure_timestamp",
        "pop_timestamp",
        "nominated_node",
    )

    def __init__(self, pod: v1.Pod, timestamp: Optional[float] = None):
        self.pod_info = PodInfo(pod)
        self.timestamp = timestamp if timestamp is not None else time.monotonic()
        self.attempts = 0
        self.initial_attempt_timestamp = self.timestamp
        self.last_failure_timestamp = 0.0
        # stamped by the scheduler at queue pop; bind-sent minus this is
        # the per-attempt latency (pod_scheduling_duration measures from
        # initial_attempt_timestamp, i.e. includes queue wait)
        self.pop_timestamp = 0.0
        # set when this pod preempted victims on a node: the in-memory
        # mirror of status.nominatedNodeName (the API echo can lag the
        # victims' delete events; the queue's event-driven re-admission
        # and the scheduler's nominated-node short-circuit read this)
        self.nominated_node = ""

    @property
    def pod(self) -> v1.Pod:
        return self.pod_info.pod

    @pod.setter
    def pod(self, pod: v1.Pod) -> None:
        self.pod_info = PodInfo(pod)


# ---------------------------------------------------------------------------
# Host ports (types.go:608 HostPortInfo)

DEFAULT_BIND_ALL_HOST_IP = "0.0.0.0"


class HostPortInfo:
    """map[ip]set[(protocol, port)] with 0.0.0.0 wildcard conflicts."""

    __slots__ = ("ports",)

    def __init__(self):
        self.ports: Dict[str, Set[Tuple[str, int]]] = {}

    @staticmethod
    def _sanitize(ip: str, protocol: str) -> Tuple[str, str]:
        return ip or DEFAULT_BIND_ALL_HOST_IP, protocol or "TCP"

    def add(self, ip: str, protocol: str, port: int) -> None:
        if port <= 0:
            return
        ip, protocol = self._sanitize(ip, protocol)
        self.ports.setdefault(ip, set()).add((protocol, port))

    def remove(self, ip: str, protocol: str, port: int) -> None:
        if port <= 0:
            return
        ip, protocol = self._sanitize(ip, protocol)
        s = self.ports.get(ip)
        if s is not None:
            s.discard((protocol, port))
            if not s:
                del self.ports[ip]

    def check_conflict(self, ip: str, protocol: str, port: int) -> bool:
        if port <= 0:
            return False
        ip, protocol = self._sanitize(ip, protocol)
        key = (protocol, port)
        if ip == DEFAULT_BIND_ALL_HOST_IP:
            return any(key in s for s in self.ports.values())
        return key in self.ports.get(DEFAULT_BIND_ALL_HOST_IP, set()) or key in self.ports.get(ip, set())

    def clone(self) -> "HostPortInfo":
        h = HostPortInfo()
        h.ports = {ip: set(s) for ip, s in self.ports.items()}
        return h

    def __len__(self):
        return sum(len(s) for s in self.ports.values())


class ImageStateSummary:
    """types.go:205 ImageStateSummary: size + cluster spread."""

    __slots__ = ("size", "num_nodes")

    def __init__(self, size: int, num_nodes: int):
        self.size = size
        self.num_nodes = num_nodes


class NodeInfo:
    """Aggregated per-node scheduling state (types.go:224 NodeInfo)."""

    __slots__ = (
        "node",
        "pods",
        "pods_with_affinity",
        "pods_with_required_anti_affinity",
        "used_ports",
        "requested",
        "non_zero_requested",
        "allocatable",
        "image_states",
        "generation",
    )

    def __init__(self, *pods: v1.Pod):
        self.node: Optional[v1.Node] = None
        self.pods: List[PodInfo] = []
        self.pods_with_affinity: List[PodInfo] = []
        self.pods_with_required_anti_affinity: List[PodInfo] = []
        self.used_ports = HostPortInfo()
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = Resource()
        self.image_states: Dict[str, ImageStateSummary] = {}
        self.generation = next_generation()
        for p in pods:
            self.add_pod(p)

    def set_node(self, node: v1.Node) -> None:
        """types.go:553 SetNode: ingest allocatable."""
        self.node = node
        alloc = Resource()
        alloc.add(node.status.allocatable or node.status.capacity)
        self.allocatable = alloc
        self.generation = next_generation()

    def add_pod(self, pod: v1.Pod) -> None:
        """types.go:489 AddPod."""
        self.add_pod_info(PodInfo(pod))

    def add_pod_info(self, pod_info: PodInfo, res3=None) -> None:
        """Shares an already-parsed PodInfo (the reference's AddPod path).
        `res3` optionally carries a precomputed calculate_resource(pod)
        triple so batch callers (SchedulerCache.assume_pods) parse each
        pod's Quantity strings exactly once."""
        pod = pod_info.pod
        res, non0_cpu, non0_mem = res3 if res3 is not None \
            else calculate_resource(pod)
        self.requested.milli_cpu += res.milli_cpu
        self.requested.memory += res.memory
        self.requested.ephemeral_storage += res.ephemeral_storage
        for name, val in res.scalar_resources.items():
            self.requested.scalar_resources[name] = (
                self.requested.scalar_resources.get(name, 0) + val
            )
        self.non_zero_requested.milli_cpu += non0_cpu
        self.non_zero_requested.memory += non0_mem
        self.pods.append(pod_info)
        if _pod_with_affinity(pod):
            self.pods_with_affinity.append(pod_info)
        if _pod_with_required_anti_affinity(pod):
            self.pods_with_required_anti_affinity.append(pod_info)
        self._update_used_ports(pod, add=True)
        self.generation = next_generation()

    def remove_pod(self, pod: v1.Pod, res3=None) -> None:
        """types.go:517 RemovePod. `res3` optionally carries a
        precomputed calculate_resource(pod) triple (see add_pod_info)."""
        key = v1.pod_key(pod)

        def _strip(lst: List[PodInfo]) -> None:
            for i, pi in enumerate(lst):
                if v1.pod_key(pi.pod) == key:
                    lst[i] = lst[-1]
                    lst.pop()
                    return

        _strip(self.pods_with_affinity)
        _strip(self.pods_with_required_anti_affinity)
        for i, pi in enumerate(self.pods):
            if v1.pod_key(pi.pod) == key:
                self.pods[i] = self.pods[-1]
                self.pods.pop()
                res, non0_cpu, non0_mem = res3 if res3 is not None \
                    else calculate_resource(pod)
                self.requested.milli_cpu -= res.milli_cpu
                self.requested.memory -= res.memory
                self.requested.ephemeral_storage -= res.ephemeral_storage
                for name, val in res.scalar_resources.items():
                    self.requested.scalar_resources[name] = (
                        self.requested.scalar_resources.get(name, 0) - val
                    )
                self.non_zero_requested.milli_cpu -= non0_cpu
                self.non_zero_requested.memory -= non0_mem
                self._update_used_ports(pod, add=False)
                self.generation = next_generation()
                return
        raise KeyError(f"no corresponding pod {key} in pods of node")

    def _update_used_ports(self, pod: v1.Pod, add: bool) -> None:
        for container in pod.spec.containers:
            for port in container.ports or []:
                if add:
                    self.used_ports.add(port.host_ip, port.protocol, port.host_port)
                else:
                    self.used_ports.remove(port.host_ip, port.protocol, port.host_port)

    def clone(self) -> "NodeInfo":
        """types.go:445 Clone — shares immutable PodInfos, copies aggregates."""
        c = NodeInfo()
        c.node = self.node
        c.pods = list(self.pods)
        c.pods_with_affinity = list(self.pods_with_affinity)
        c.pods_with_required_anti_affinity = list(self.pods_with_required_anti_affinity)
        c.used_ports = self.used_ports.clone()
        c.requested = self.requested.clone()
        c.non_zero_requested = self.non_zero_requested.clone()
        c.allocatable = self.allocatable.clone()
        c.image_states = dict(self.image_states)
        c.generation = self.generation
        return c


def _pod_with_affinity(pod: v1.Pod) -> bool:
    a = pod.spec.affinity
    return a is not None and (a.pod_affinity is not None or a.pod_anti_affinity is not None)


def _pod_with_required_anti_affinity(pod: v1.Pod) -> bool:
    a = pod.spec.affinity
    return (
        a is not None
        and a.pod_anti_affinity is not None
        and bool(a.pod_anti_affinity.required_during_scheduling_ignored_during_execution)
    )
