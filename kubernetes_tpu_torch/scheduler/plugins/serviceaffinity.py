"""ServiceAffinity plugin (legacy Policy TestServiceAffinity /
ServiceAntiAffinityPriority).

Reference: pkg/scheduler/framework/plugins/serviceaffinity/
service_affinity.go — Filter: pods of the same Service must land on nodes
that agree on the configured affinityLabels (the first scheduled pod of a
service pins the label values; later pods must match); Score: spread
service pods across values of antiAffinityLabelsPreference (fewer matching
pods under this node's label value scores higher).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ...api import types as v1
from ...api.labels import Selector
from ..framework import interface as fwk
from ..framework.interface import CycleState, NodeScore, Status

STATE_KEY = "PreFilterServiceAffinity"


def _service_selectors(pod: v1.Pod, services: List[v1.Service]) -> List[Selector]:
    out = []
    labels = pod.metadata.labels or {}
    for svc in services:
        if svc.metadata.namespace != pod.metadata.namespace:
            continue
        sel = Selector.from_match_labels(svc.spec.selector)
        if svc.spec.selector and sel.matches(labels):
            out.append(sel)
    return out


class _State:
    __slots__ = ("matching_pods",)

    def __init__(self, matching_pods: List[v1.Pod]):
        self.matching_pods = matching_pods


PRESCORE_KEY = "PreScoreServiceAffinity"


class ServiceAffinity(fwk.PreFilterPlugin, fwk.FilterPlugin, fwk.PreScorePlugin, fwk.ScorePlugin):
    name = "ServiceAffinity"
    has_normalize = True
    ERR_REASON = "node(s) didn't match service affinity"

    def __init__(self, args=None, handle=None):
        self.handle = handle
        args = args or {}
        self.affinity_labels = list(args.get("affinityLabels", []))
        self.anti_affinity_labels_preference = list(
            args.get("antiAffinityLabelsPreference", [])
        )

    def _services(self) -> List[v1.Service]:
        h = self.handle
        fn = getattr(h, "service_lister", None) if h else None
        return fn() if fn else []

    def _all_scheduled_service_pods(self, pod: v1.Pod) -> List[v1.Pod]:
        """Scheduled pods in the pod's namespace selected by any of the
        pod's services (service_affinity.go filtering on the snapshot)."""
        lister = self.handle.snapshot_shared_lister() if self.handle else None
        if lister is None:
            return []
        selectors = _service_selectors(pod, self._services())
        if not selectors:
            return []
        out = []
        for node_info in lister.list():
            for pi in node_info.pods:
                other = pi.pod
                if other.metadata.namespace != pod.metadata.namespace:
                    continue
                if any(s.matches(other.metadata.labels) for s in selectors):
                    out.append(other)
        return out

    # -- PreFilter/Filter ---------------------------------------------------

    def pre_filter(self, state: CycleState, pod: v1.Pod) -> Optional[Status]:
        if self.affinity_labels:
            state.write(STATE_KEY, _State(self._all_scheduled_service_pods(pod)))
        return None

    def filter(self, state: CycleState, pod: v1.Pod, node_info) -> Optional[Status]:
        if not self.affinity_labels:
            return None
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        try:
            data: _State = state.read(STATE_KEY)
        except KeyError:
            data = _State(self._all_scheduled_service_pods(pod))
        # pin label values from the first scheduled service pod's node
        pinned: Dict[str, str] = {}
        lister = self.handle.snapshot_shared_lister() if self.handle else None
        if data.matching_pods and lister is not None:
            first = data.matching_pods[0]
            try:
                first_node = lister.get(first.spec.node_name).node
            except KeyError:
                first_node = None
            if first_node is not None:
                labels = first_node.metadata.labels or {}
                for k in self.affinity_labels:
                    if k in labels:
                        pinned[k] = labels[k]
        node_labels = node.metadata.labels or {}
        for k in self.affinity_labels:
            if k not in node_labels:
                return Status.unschedulable_and_unresolvable(self.ERR_REASON)
            if k in pinned and node_labels[k] != pinned[k]:
                return Status.unschedulable(self.ERR_REASON)
        return None

    # -- Score ---------------------------------------------------------------

    def pre_score(self, state: CycleState, pod: v1.Pod, nodes) -> Optional[Status]:
        """Resolve the service pods and their nodes' preference-label values
        ONCE; score() is then a per-node counter lookup (the snapshot scan
        here is O(pods), not O(nodes x pods))."""
        if not self.anti_affinity_labels_preference:
            return None
        lister = self.handle.snapshot_shared_lister() if self.handle else None
        # (label key, label value) -> number of service pods under it
        counts: Dict[Tuple[str, str], int] = {}
        if lister is not None:
            for other in self._all_scheduled_service_pods(pod):
                try:
                    other_node = lister.get(other.spec.node_name).node
                except KeyError:
                    continue
                other_labels = (other_node.metadata.labels or {}) if other_node else {}
                for k in self.anti_affinity_labels_preference:
                    if k in other_labels:
                        counts[(k, other_labels[k])] = counts.get((k, other_labels[k]), 0) + 1
        state.write(PRESCORE_KEY, counts)
        return None

    def score(self, state: CycleState, pod: v1.Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        """ServiceAntiAffinityPriority: count service pods whose node shares
        this node's value for the preference label; raw count (inverted in
        normalize)."""
        if not self.anti_affinity_labels_preference:
            return 0, None
        lister = self.handle.snapshot_shared_lister() if self.handle else None
        if lister is None:
            return 0, None
        try:
            node = lister.get(node_name).node
        except KeyError as e:
            return 0, Status.error(str(e))
        node_labels = (node.metadata.labels or {}) if node else {}
        try:
            counts = state.read(PRESCORE_KEY)
        except KeyError:
            st = self.pre_score(state, pod, [])  # direct-call path (tests)
            if st is not None:
                return 0, st
            counts = state.read(PRESCORE_KEY)
        count = 0
        for k in self.anti_affinity_labels_preference:
            if k in node_labels:
                count += counts.get((k, node_labels[k]), 0)
        return count, None

    def normalize_score(self, state: CycleState, pod: v1.Pod, scores: List[NodeScore]) -> Optional[Status]:
        max_count = max((ns.score for ns in scores), default=0)
        for ns in scores:
            if max_count > 0:
                ns.score = int(
                    fwk.MAX_NODE_SCORE * (max_count - ns.score) / max_count
                )
            else:
                ns.score = fwk.MAX_NODE_SCORE
        return None
