"""InterPodAffinity plugin (PreFilter+AddPod/RemovePod+Filter+PreScore+Score+Normalize).

Reference: pkg/scheduler/framework/plugins/interpodaffinity/
  filtering.go  preFilterState: 3 topology-pair count maps
                (:162 getTPMapMatchingExistingAntiAffinity,
                 :194 getTPMapMatchingIncomingAffinityAntiAffinity);
                Filter (:374): affinity -> UnschedulableAndUnresolvable,
                anti-affinity & existing anti-affinity -> Unschedulable
  scoring.go    processExistingPod (:88), Score (:225) sums weights by the
                node's topology labels, Normalize (:247) min-max to [0,100]
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ...api import types as v1
from ..framework import interface as fwk
from ..framework.interface import CycleState, Status
from ..framework.types import NodeInfo, PodInfo, WeightedAffinityTerm

PRE_FILTER_STATE_KEY = "PreFilterInterPodAffinity"
PRE_SCORE_STATE_KEY = "PreScoreInterPodAffinity"

ERR_REASON_AFFINITY_NOT_MATCH = "node(s) didn't match pod affinity/anti-affinity rules"
ERR_REASON_AFFINITY_RULES_NOT_MATCH = "node(s) didn't match pod affinity rules"
ERR_REASON_ANTI_AFFINITY_RULES_NOT_MATCH = "node(s) didn't match pod anti-affinity rules"
ERR_REASON_EXISTING_ANTI_AFFINITY_RULES_NOT_MATCH = (
    "node(s) didn't satisfy existing pods anti-affinity rules"
)

DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1  # apis/config/v1beta1/defaults.go


def _pod_matches_all_affinity_terms(pod: v1.Pod, terms) -> bool:
    """filtering.go:147 podMatchesAllAffinityTerms (empty terms -> False)."""
    if not terms:
        return False
    return all(term.matches(pod) for term in terms)


class _TopologyCounts(dict):
    """topologyToMatchedTermCount: (key,value) -> signed count."""

    def update_with_affinity_terms(self, target_pod: v1.Pod, node: v1.Node, terms, value: int):
        if _pod_matches_all_affinity_terms(target_pod, terms):
            labels = node.metadata.labels or {}
            for t in terms:
                if t.topology_key in labels:
                    pair = (t.topology_key, labels[t.topology_key])
                    self[pair] = self.get(pair, 0) + value
                    if self[pair] == 0:
                        del self[pair]

    def update_with_anti_affinity_terms(self, target_pod: v1.Pod, node: v1.Node, terms, value: int):
        labels = node.metadata.labels or {}
        for t in terms:
            if t.matches(target_pod) and t.topology_key in labels:
                pair = (t.topology_key, labels[t.topology_key])
                self[pair] = self.get(pair, 0) + value
                if self[pair] == 0:
                    del self[pair]


class _PreFilterState:
    __slots__ = ("affinity_counts", "anti_affinity_counts", "existing_anti_affinity_counts", "pod_info")

    def __init__(self, pod_info: PodInfo):
        self.pod_info = pod_info
        self.affinity_counts = _TopologyCounts()
        self.anti_affinity_counts = _TopologyCounts()
        self.existing_anti_affinity_counts = _TopologyCounts()

    def clone(self) -> "_PreFilterState":
        c = _PreFilterState(self.pod_info)
        c.affinity_counts = _TopologyCounts(self.affinity_counts)
        c.anti_affinity_counts = _TopologyCounts(self.anti_affinity_counts)
        c.existing_anti_affinity_counts = _TopologyCounts(self.existing_anti_affinity_counts)
        return c

    def update_with_pod(self, pod_info: PodInfo, node: v1.Node, multiplier: int) -> None:
        """filtering.go:84 updateWithPod (AddPod/RemovePod extension)."""
        self.existing_anti_affinity_counts.update_with_anti_affinity_terms(
            self.pod_info.pod, node, pod_info.required_anti_affinity_terms, multiplier
        )
        self.affinity_counts.update_with_affinity_terms(
            pod_info.pod, node, self.pod_info.required_affinity_terms, multiplier
        )
        self.anti_affinity_counts.update_with_anti_affinity_terms(
            pod_info.pod, node, self.pod_info.required_anti_affinity_terms, multiplier
        )


class InterPodAffinity(
    fwk.PreFilterPlugin, fwk.FilterPlugin, fwk.PreScorePlugin, fwk.ScorePlugin
):
    name = "InterPodAffinity"
    has_normalize = True

    def __init__(self, args: Optional[dict] = None, handle=None):
        self.handle = handle
        args = args or {}
        self.hard_pod_affinity_weight = args.get(
            "hardPodAffinityWeight", DEFAULT_HARD_POD_AFFINITY_WEIGHT
        )

    # -- PreFilter ---------------------------------------------------------

    def pre_filter(self, state: CycleState, pod: v1.Pod) -> Optional[Status]:
        snapshot = self.handle.snapshot_shared_lister()
        all_nodes = snapshot.list()
        nodes_with_required_anti = snapshot.have_pods_with_required_anti_affinity_list
        pod_info = PodInfo(pod)
        s = _PreFilterState(pod_info)
        # existing pods' anti-affinity terms matching the incoming pod
        for ni in nodes_with_required_anti:
            node = ni.node
            if node is None:
                continue
            for existing in ni.pods_with_required_anti_affinity:
                s.existing_anti_affinity_counts.update_with_anti_affinity_terms(
                    pod, node, existing.required_anti_affinity_terms, 1
                )
        # incoming pod's required (anti-)affinity vs existing pods
        if pod_info.required_affinity_terms or pod_info.required_anti_affinity_terms:
            for ni in all_nodes:
                node = ni.node
                if node is None:
                    continue
                for existing in ni.pods:
                    s.affinity_counts.update_with_affinity_terms(
                        existing.pod, node, pod_info.required_affinity_terms, 1
                    )
                    s.anti_affinity_counts.update_with_anti_affinity_terms(
                        existing.pod, node, pod_info.required_anti_affinity_terms, 1
                    )
        state.write(PRE_FILTER_STATE_KEY, s)
        return None

    def pre_filter_extensions(self):
        return self

    def add_pod(self, state, pod_to_schedule, pod_info_to_add, node_info) -> Optional[Status]:
        s = _get_state(state)
        s.update_with_pod(pod_info_to_add, node_info.node, 1)
        return None

    def remove_pod(self, state, pod_to_schedule, pod_info_to_remove, node_info) -> Optional[Status]:
        s = _get_state(state)
        s.update_with_pod(pod_info_to_remove, node_info.node, -1)
        return None

    # -- Filter ------------------------------------------------------------

    def filter(self, state: CycleState, pod: v1.Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status.error("node not found")
        s = _get_state(state)
        if not self._satisfy_pod_affinity(s, node_info):
            return Status.unschedulable_and_unresolvable(
                ERR_REASON_AFFINITY_NOT_MATCH, ERR_REASON_AFFINITY_RULES_NOT_MATCH
            )
        if not self._satisfy_pod_anti_affinity(s, node_info):
            return Status.unschedulable(
                ERR_REASON_AFFINITY_NOT_MATCH, ERR_REASON_ANTI_AFFINITY_RULES_NOT_MATCH
            )
        if not self._satisfy_existing_pods_anti_affinity(s, node_info):
            return Status.unschedulable(
                ERR_REASON_AFFINITY_NOT_MATCH,
                ERR_REASON_EXISTING_ANTI_AFFINITY_RULES_NOT_MATCH,
            )
        return None

    @staticmethod
    def _satisfy_existing_pods_anti_affinity(s: _PreFilterState, node_info: NodeInfo) -> bool:
        if s.existing_anti_affinity_counts:
            for k, val in (node_info.node.metadata.labels or {}).items():
                if s.existing_anti_affinity_counts.get((k, val), 0) > 0:
                    return False
        return True

    @staticmethod
    def _satisfy_pod_anti_affinity(s: _PreFilterState, node_info: NodeInfo) -> bool:
        if s.anti_affinity_counts:
            labels = node_info.node.metadata.labels or {}
            for term in s.pod_info.required_anti_affinity_terms:
                if term.topology_key in labels:
                    if s.anti_affinity_counts.get((term.topology_key, labels[term.topology_key]), 0) > 0:
                        return False
        return True

    @staticmethod
    def _satisfy_pod_affinity(s: _PreFilterState, node_info: NodeInfo) -> bool:
        pods_exist = True
        labels = node_info.node.metadata.labels or {}
        for term in s.pod_info.required_affinity_terms:
            if term.topology_key in labels:
                if s.affinity_counts.get((term.topology_key, labels[term.topology_key]), 0) <= 0:
                    pods_exist = False
            else:
                return False  # all topology labels must exist on the node
        if not pods_exist:
            # first-pod-in-series escape hatch (filtering.go:357)
            if not s.affinity_counts and _pod_matches_all_affinity_terms(
                s.pod_info.pod, s.pod_info.required_affinity_terms
            ):
                return True
            return False
        return True

    # -- PreScore / Score --------------------------------------------------

    def pre_score(self, state: CycleState, pod: v1.Pod, nodes) -> Optional[Status]:
        if not nodes:
            return None
        snapshot = self.handle.snapshot_shared_lister()
        pod_info = PodInfo(pod)
        has_preferred = bool(pod_info.preferred_affinity_terms) or bool(
            pod_info.preferred_anti_affinity_terms
        )
        node_infos = snapshot.list() if has_preferred else snapshot.have_pods_with_affinity_list
        topology_score: Dict[Tuple[str, str], int] = {}

        def process_term(term: WeightedAffinityTerm, pod_to_check: v1.Pod, fixed_node: v1.Node, multiplier: int):
            """scoring.go:48 processTerm."""
            labels = fixed_node.metadata.labels or {}
            if not labels:
                return
            if term.matches(pod_to_check) and term.topology_key in labels:
                pair = (term.topology_key, labels[term.topology_key])
                topology_score[pair] = topology_score.get(pair, 0) + term.weight * multiplier

        for ni in node_infos:
            node = ni.node
            if node is None:
                continue
            pods_to_process = ni.pods if has_preferred else ni.pods_with_affinity
            for existing in pods_to_process:
                # scoring.go:88 processExistingPod
                for term in pod_info.preferred_affinity_terms:
                    process_term(term, existing.pod, node, 1)
                for term in pod_info.preferred_anti_affinity_terms:
                    process_term(term, existing.pod, node, -1)
                if self.hard_pod_affinity_weight > 0:
                    for req in existing.required_affinity_terms:
                        wt = WeightedAffinityTerm(
                            req.namespaces, req.selector, req.topology_key,
                            self.hard_pod_affinity_weight,
                        )
                        process_term(wt, pod, node, 1)
                for term in existing.preferred_affinity_terms:
                    process_term(term, pod, node, 1)
                for term in existing.preferred_anti_affinity_terms:
                    process_term(term, pod, node, -1)
        state.write(PRE_SCORE_STATE_KEY, topology_score)
        return None

    def score(self, state: CycleState, pod: v1.Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        try:
            node_info = self.handle.snapshot_shared_lister().get(node_name)
        except KeyError as e:
            return 0, Status.error(str(e))
        try:
            topology_score = state.read(PRE_SCORE_STATE_KEY)
        except KeyError as e:
            return 0, Status.error(str(e))
        score = 0
        labels = node_info.node.metadata.labels or {}
        for (k, val), weight in topology_score.items():
            if labels.get(k) == val:
                score += weight
        return score, None

    def normalize_score(self, state: CycleState, pod: v1.Pod, scores) -> Optional[Status]:
        try:
            topology_score = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            return None
        if not topology_score:
            return None
        min_count = math.inf
        max_count = -math.inf
        for ns in scores:
            max_count = max(max_count, ns.score)
            min_count = min(min_count, ns.score)
        max_min_diff = max_count - min_count
        for ns in scores:
            fscore = 0.0
            if max_min_diff > 0:
                fscore = fwk.MAX_NODE_SCORE * ((ns.score - min_count) / max_min_diff)
            ns.score = int(fscore)
        return None


def _get_state(state: CycleState) -> _PreFilterState:
    return state.read(PRE_FILTER_STATE_KEY)
