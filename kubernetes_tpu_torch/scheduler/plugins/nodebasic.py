"""Simple node-attribute plugins: NodeName, NodePorts, NodeUnschedulable,
TaintToleration, NodeAffinity, ImageLocality, NodePreferAvoidPods,
PrioritySort, DefaultBinder.

References:
  nodename/node_name.go, nodeports/node_ports.go,
  nodeunschedulable/node_unschedulable.go,
  tainttoleration/taint_toleration.go, nodeaffinity/node_affinity.go,
  imagelocality/image_locality.go,
  nodepreferavoidpods/node_prefer_avoid_pods.go,
  queuesort/priority_sort.go, defaultbinder/default_binder.go
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

from ...api import types as v1
from ...api.labels import (
    match_node_selector_terms,
    node_fields,
    pod_matches_node_selector_and_affinity,
)
from ...api.taints import (
    TAINT_EFFECT_NO_EXECUTE,
    TAINT_EFFECT_NO_SCHEDULE,
    TAINT_EFFECT_PREFER_NO_SCHEDULE,
    find_matching_untolerated_taint,
    tolerations_tolerate_taint,
)
from ..framework import interface as fwk
from ..framework.interface import CycleState, NodeScore, Status
from ..framework.types import HostPortInfo, NodeInfo
from .helper import default_normalize_score

# ---------------------------------------------------------------------------


class NodeName(fwk.FilterPlugin):
    """node_name.go: pod.Spec.NodeName, if set, must equal the node name."""

    name = "NodeName"
    ERR_REASON = "node(s) didn't match the requested hostname"

    def __init__(self, args=None, handle=None):
        pass

    def filter(self, state, pod, node_info) -> Optional[Status]:
        if node_info.node is None:
            return Status.error("node not found")
        if pod.spec.node_name and pod.spec.node_name != node_info.node.metadata.name:
            return Status.unschedulable_and_unresolvable(self.ERR_REASON)
        return None


# ---------------------------------------------------------------------------

PRE_FILTER_PORTS_KEY = "PreFilterNodePorts"


def get_container_ports(*pods: v1.Pod) -> List[v1.ContainerPort]:
    """node_ports.go:60 getContainerPorts."""
    ports = []
    for pod in pods:
        for container in pod.spec.containers:
            for port in container.ports or []:
                if port.host_port > 0:
                    ports.append(port)
    return ports


class NodePorts(fwk.PreFilterPlugin, fwk.FilterPlugin):
    name = "NodePorts"
    ERR_REASON = "node(s) didn't have free ports for the requested pod ports"

    def __init__(self, args=None, handle=None):
        pass

    def pre_filter(self, state, pod) -> Optional[Status]:
        state.write(PRE_FILTER_PORTS_KEY, get_container_ports(pod))
        return None

    def filter(self, state, pod, node_info) -> Optional[Status]:
        try:
            want_ports: List[v1.ContainerPort] = state.read(PRE_FILTER_PORTS_KEY)
        except KeyError as e:
            return Status.error(str(e))
        if not fits_ports(want_ports, node_info.used_ports):
            return Status.unschedulable(self.ERR_REASON)
        return None


def fits_ports(want_ports: List[v1.ContainerPort], used: HostPortInfo) -> bool:
    for port in want_ports:
        if used.check_conflict(port.host_ip, port.protocol, port.host_port):
            return False
    return True


# ---------------------------------------------------------------------------


class NodeUnschedulable(fwk.FilterPlugin):
    """node_unschedulable.go: .spec.unschedulable gated by the well-known
    unschedulable-taint toleration."""

    name = "NodeUnschedulable"
    ERR_REASON_UNSCHEDULABLE = "node(s) were unschedulable"
    ERR_REASON_UNKNOWN = "node(s) had unknown conditions"

    def __init__(self, args=None, handle=None):
        pass

    def filter(self, state, pod, node_info) -> Optional[Status]:
        if node_info.node is None:
            return Status.unschedulable_and_unresolvable(self.ERR_REASON_UNKNOWN)
        pod_tolerates = tolerations_tolerate_taint(
            pod.spec.tolerations,
            v1.Taint(key=v1.TAINT_NODE_UNSCHEDULABLE, effect=TAINT_EFFECT_NO_SCHEDULE),
        )
        if node_info.node.spec.unschedulable and not pod_tolerates:
            return Status.unschedulable_and_unresolvable(self.ERR_REASON_UNSCHEDULABLE)
        return None


# ---------------------------------------------------------------------------

PRE_SCORE_TAINT_KEY = "PreScoreTaintToleration"


class TaintToleration(fwk.FilterPlugin, fwk.PreScorePlugin, fwk.ScorePlugin):
    name = "TaintToleration"
    has_normalize = True

    def __init__(self, args=None, handle=None):
        self.handle = handle

    def filter(self, state, pod, node_info) -> Optional[Status]:
        if node_info.node is None:
            return Status.error("invalid nodeInfo")
        taint, untolerated = find_matching_untolerated_taint(
            node_info.node.spec.taints,
            pod.spec.tolerations,
            lambda t: t.effect in (TAINT_EFFECT_NO_SCHEDULE, TAINT_EFFECT_NO_EXECUTE),
        )
        if not untolerated:
            return None
        return Status.unschedulable_and_unresolvable(
            f"node(s) had taint {{{taint.key}: {taint.value}}}, that the pod didn't tolerate"
        )

    def pre_score(self, state, pod, nodes) -> Optional[Status]:
        if not nodes:
            return None
        tolerations = [
            t
            for t in pod.spec.tolerations or []
            if not t.effect or t.effect == TAINT_EFFECT_PREFER_NO_SCHEDULE
        ]
        state.write(PRE_SCORE_TAINT_KEY, tolerations)
        return None

    def score(self, state, pod, node_name) -> Tuple[int, Optional[Status]]:
        try:
            node_info = self.handle.snapshot_shared_lister().get(node_name)
        except KeyError as e:
            return 0, Status.error(str(e))
        try:
            tolerations = state.read(PRE_SCORE_TAINT_KEY)
        except KeyError as e:
            return 0, Status.error(str(e))
        count = 0
        for taint in node_info.node.spec.taints or []:
            if taint.effect != TAINT_EFFECT_PREFER_NO_SCHEDULE:
                continue
            if not tolerations_tolerate_taint(tolerations, taint):
                count += 1
        return count, None

    def normalize_score(self, state, pod, scores) -> Optional[Status]:
        default_normalize_score(fwk.MAX_NODE_SCORE, True, scores)
        return None


# ---------------------------------------------------------------------------

PRE_SCORE_NODE_AFFINITY_KEY = "PreScoreNodeAffinity"


class NodeAffinity(fwk.FilterPlugin, fwk.PreScorePlugin, fwk.ScorePlugin):
    name = "NodeAffinity"
    has_normalize = True
    ERR_REASON = "node(s) didn't match Pod's node affinity/selector"

    def __init__(self, args=None, handle=None):
        self.handle = handle

    def filter(self, state, pod, node_info) -> Optional[Status]:
        if node_info.node is None:
            return Status.error("node not found")
        if not pod_matches_node_selector_and_affinity(pod, node_info.node):
            return Status.unschedulable_and_unresolvable(self.ERR_REASON)
        return None

    @staticmethod
    def _preferred_terms(pod: v1.Pod) -> List[v1.PreferredSchedulingTerm]:
        a = pod.spec.affinity
        if a is None or a.node_affinity is None:
            return []
        return a.node_affinity.preferred_during_scheduling_ignored_during_execution or []

    def pre_score(self, state, pod, nodes) -> Optional[Status]:
        if not nodes:
            return None
        state.write(PRE_SCORE_NODE_AFFINITY_KEY, self._preferred_terms(pod))
        return None

    def score(self, state, pod, node_name) -> Tuple[int, Optional[Status]]:
        try:
            node_info = self.handle.snapshot_shared_lister().get(node_name)
        except KeyError as e:
            return 0, Status.error(str(e))
        node = node_info.node
        try:
            terms = state.read(PRE_SCORE_NODE_AFFINITY_KEY)
        except KeyError:
            terms = self._preferred_terms(pod)
        count = 0
        labels = node.metadata.labels or {}
        fields = node_fields(node)
        for term in terms:
            if term.weight == 0:
                continue
            # a preference is a single NodeSelectorTerm (nodeaffinity.go:139)
            if match_node_selector_terms([term.preference], labels, fields):
                count += term.weight
        return count, None

    def normalize_score(self, state, pod, scores) -> Optional[Status]:
        default_normalize_score(fwk.MAX_NODE_SCORE, False, scores)
        return None


# ---------------------------------------------------------------------------

MB = 1024 * 1024
MIN_IMG_THRESHOLD = 23 * MB  # image_locality.go:33
MAX_CONTAINER_THRESHOLD = 1000 * MB


def normalized_image_name(name: str) -> str:
    """image_locality.go:118: append :latest when untagged."""
    if name.rfind(":") <= name.rfind("/"):
        name += ":latest"
    return name


class ImageLocality(fwk.ScorePlugin):
    name = "ImageLocality"

    def __init__(self, args=None, handle=None):
        self.handle = handle

    def score(self, state, pod, node_name) -> Tuple[int, Optional[Status]]:
        snapshot = self.handle.snapshot_shared_lister()
        try:
            node_info = snapshot.get(node_name)
        except KeyError as e:
            return 0, Status.error(str(e))
        total_num_nodes = snapshot.num_nodes()
        sum_scores = 0
        for container in pod.spec.containers:
            st = node_info.image_states.get(normalized_image_name(container.image))
            if st is not None:
                spread = st.num_nodes / total_num_nodes
                sum_scores += int(st.size * spread)
        num_containers = len(pod.spec.containers)
        max_threshold = MAX_CONTAINER_THRESHOLD * num_containers
        if sum_scores < MIN_IMG_THRESHOLD:
            sum_scores = MIN_IMG_THRESHOLD
        elif sum_scores > max_threshold:
            sum_scores = max_threshold
        return (
            fwk.MAX_NODE_SCORE * (sum_scores - MIN_IMG_THRESHOLD) // (max_threshold - MIN_IMG_THRESHOLD),
            None,
        )


# ---------------------------------------------------------------------------

PREFER_AVOID_PODS_ANNOTATION = "scheduler.alpha.kubernetes.io/preferAvoidPods"


class NodePreferAvoidPods(fwk.ScorePlugin):
    """node_prefer_avoid_pods.go: annotation-driven avoidance for
    RC/ReplicaSet-owned pods; weight 10000 in the default profile."""

    name = "NodePreferAvoidPods"

    def __init__(self, args=None, handle=None):
        self.handle = handle

    def score(self, state, pod, node_name) -> Tuple[int, Optional[Status]]:
        try:
            node_info = self.handle.snapshot_shared_lister().get(node_name)
        except KeyError as e:
            return 0, Status.error(str(e))
        node = node_info.node
        if node is None:
            return 0, Status.error("node not found")
        controller = None
        for ref in pod.metadata.owner_references or []:
            if ref.controller:
                controller = ref
                break
        if controller is not None and controller.kind not in ("ReplicationController", "ReplicaSet"):
            controller = None
        if controller is None:
            return fwk.MAX_NODE_SCORE, None
        raw = (node.metadata.annotations or {}).get(PREFER_AVOID_PODS_ANNOTATION)
        if not raw:
            return fwk.MAX_NODE_SCORE, None
        try:
            avoids = json.loads(raw)
        except ValueError:
            return fwk.MAX_NODE_SCORE, None
        for avoid in avoids.get("preferAvoidPods", []):
            ctrl = avoid.get("podSignature", {}).get("podController", {})
            if ctrl.get("kind") == controller.kind and ctrl.get("uid") == controller.uid:
                return 0, None
        return fwk.MAX_NODE_SCORE, None


# ---------------------------------------------------------------------------


class PrioritySort(fwk.QueueSortPlugin):
    """queuesort/priority_sort.go: higher priority first, FIFO within."""

    name = "PrioritySort"

    def __init__(self, args=None, handle=None):
        pass

    def less(self, pod_info1, pod_info2) -> bool:
        p1 = pod_info1.pod.spec.priority or 0
        p2 = pod_info2.pod.spec.priority or 0
        return p1 > p2 or (p1 == p2 and pod_info1.timestamp < pod_info2.timestamp)


class DefaultBinder(fwk.BindPlugin):
    """defaultbinder/default_binder.go: POST .../pods/{name}/binding."""

    name = "DefaultBinder"

    def __init__(self, args=None, handle=None):
        self.handle = handle

    def bind(self, state, pod, node_name) -> Optional[Status]:
        client = getattr(self.handle, "client", None)
        if client is None:
            return Status.error("no client configured for DefaultBinder")
        try:
            client.bind(pod, node_name)
        except Exception as e:  # conflict/apply errors surface as bind errors
            return Status.error(str(e))
        return None
