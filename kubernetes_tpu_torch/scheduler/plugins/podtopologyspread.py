"""PodTopologySpread plugin (PreFilter+Filter+PreScore+Score+Normalize).

Reference: pkg/scheduler/framework/plugins/podtopologyspread/
  common.go    topologySpreadConstraint, filterTopologySpreadConstraints,
               countPodsMatchSelector (terminating pods skipped)
  filtering.go preFilterState (:224 TpPairToMatchNum, :268 criticalPaths),
               Filter (:313): matchNum + selfMatch - minMatchNum > maxSkew
  scoring.go   preScoreState, topologyNormalizingWeight=log(size+2) (:279),
               score = sum cnt*tpWeight + (maxSkew-1) (:287),
               normalize 100*(max+min-s)/max with ignored nodes -> 0 (:247)
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ...api import types as v1
from ...api.labels import Selector, pod_matches_node_selector_and_affinity
from ..framework import interface as fwk
from ..framework.interface import CycleState, Status
from ..framework.types import NodeInfo, PodInfo

PRE_FILTER_STATE_KEY = "PreFilterPodTopologySpread"
PRE_SCORE_STATE_KEY = "PreScorePodTopologySpread"

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

ERR_REASON_CONSTRAINTS_NOT_MATCH = "node(s) didn't match pod topology spread constraints"
ERR_REASON_NODE_LABEL_NOT_MATCH = (
    ERR_REASON_CONSTRAINTS_NOT_MATCH + " (missing required label)"
)

INVALID_SCORE = -1


class _Constraint:
    __slots__ = ("max_skew", "topology_key", "selector")

    def __init__(self, max_skew: int, topology_key: str, selector: Selector):
        self.max_skew = max_skew
        self.topology_key = topology_key
        self.selector = selector


def filter_constraints(
    constraints: List[v1.TopologySpreadConstraint], action: str
) -> List[_Constraint]:
    """common.go filterTopologySpreadConstraints."""
    out = []
    for c in constraints or []:
        if c.when_unsatisfiable == action:
            out.append(
                _Constraint(
                    c.max_skew,
                    c.topology_key,
                    Selector.from_label_selector(c.label_selector),
                )
            )
    return out


def node_labels_match_constraints(labels: Optional[Dict[str, str]], constraints) -> bool:
    labels = labels or {}
    return all(c.topology_key in labels for c in constraints)


def count_pods_match_selector(pod_infos: List[PodInfo], selector: Selector, ns: str) -> int:
    """common.go countPodsMatchSelector — skips terminating pods."""
    count = 0
    for pi in pod_infos:
        p = pi.pod
        if p.metadata.deletion_timestamp is not None or p.metadata.namespace != ns:
            continue
        if selector.matches(p.metadata.labels):
            count += 1
    return count


class _CriticalPaths:
    """filtering.go:47 criticalPaths: the two smallest (value, matchNum)."""

    __slots__ = ("paths",)

    def __init__(self):
        self.paths = [["", math.inf], ["", math.inf]]

    def update(self, tp_val: str, num: int) -> None:
        # filtering.go:88-112: update-in-place when the value is already a
        # critical path (re-sorting after either update), else displace.
        i = -1
        if self.paths[0][0] == tp_val:
            i = 0
        elif self.paths[1][0] == tp_val:
            i = 1
        if i >= 0:
            self.paths[i][1] = num
            if self.paths[0][1] > self.paths[1][1]:
                self.paths[0], self.paths[1] = self.paths[1], self.paths[0]
        elif num < self.paths[0][1]:
            self.paths[1] = self.paths[0]
            self.paths[0] = [tp_val, num]
        elif num < self.paths[1][1]:
            self.paths[1] = [tp_val, num]

    @property
    def min_match(self):
        return self.paths[0][1]


class _PreFilterState:
    __slots__ = ("constraints", "tp_pair_to_match_num", "tp_key_to_critical_paths")

    def __init__(self):
        self.constraints: List[_Constraint] = []
        self.tp_pair_to_match_num: Dict[Tuple[str, str], int] = {}
        self.tp_key_to_critical_paths: Dict[str, _CriticalPaths] = {}

    def clone(self) -> "_PreFilterState":
        c = _PreFilterState()
        c.constraints = self.constraints
        c.tp_pair_to_match_num = dict(self.tp_pair_to_match_num)
        c.tp_key_to_critical_paths = {}
        for k, paths in self.tp_key_to_critical_paths.items():
            cp = _CriticalPaths()
            cp.paths = [list(paths.paths[0]), list(paths.paths[1])]
            c.tp_key_to_critical_paths[k] = cp
        return c

    def update_with_pod(self, updated_pod: v1.Pod, preemptor_pod: v1.Pod, node: v1.Node, delta: int) -> None:
        """filtering.go:194 updateWithPod (used by AddPod/RemovePod)."""
        if not self.constraints or updated_pod.metadata.namespace != preemptor_pod.metadata.namespace or node is None:
            return
        if not node_labels_match_constraints(node.metadata.labels, self.constraints):
            return
        labels = updated_pod.metadata.labels
        for c in self.constraints:
            if not c.selector.matches(labels):
                continue
            k = c.topology_key
            v = (node.metadata.labels or {})[k]
            pair = (k, v)
            if pair not in self.tp_pair_to_match_num:
                continue
            self.tp_pair_to_match_num[pair] += delta
            self.tp_key_to_critical_paths[k].update(v, self.tp_pair_to_match_num[pair])


class PodTopologySpread(
    fwk.PreFilterPlugin, fwk.FilterPlugin, fwk.PreScorePlugin, fwk.ScorePlugin
):
    name = "PodTopologySpread"
    has_normalize = True

    def __init__(self, args: Optional[dict] = None, handle=None):
        self.handle = handle
        args = args or {}
        self.default_constraints: List[v1.TopologySpreadConstraint] = [
            v1.TopologySpreadConstraint(
                max_skew=c.get("maxSkew", 1),
                topology_key=c.get("topologyKey", ""),
                when_unsatisfiable=c.get("whenUnsatisfiable", ""),
            )
            for c in args.get("defaultConstraints", [])
        ]

    # -- PreFilter ---------------------------------------------------------

    def _constraints_for(self, pod: v1.Pod, action: str) -> List[_Constraint]:
        if pod.spec.topology_spread_constraints:
            return filter_constraints(pod.spec.topology_spread_constraints, action)
        # buildDefaultConstraints (common.go): plugin-arg defaults use the
        # pod's own labels as the selector stand-in via services etc.; for
        # List-defaulting the constraints carry no selector -> match nothing
        # unless the pod defines one. System-default mode is not yet wired.
        return filter_constraints(self.default_constraints, action)

    def pre_filter(self, state: CycleState, pod: v1.Pod) -> Optional[Status]:
        s = _PreFilterState()
        s.constraints = self._constraints_for(pod, DO_NOT_SCHEDULE)
        state.write(PRE_FILTER_STATE_KEY, s)
        if not s.constraints:
            return None
        all_nodes: List[NodeInfo] = self.handle.snapshot_shared_lister().list()
        # register eligible topology pairs (filtering.go:224)
        for ni in all_nodes:
            node = ni.node
            if node is None:
                continue
            if not pod_matches_node_selector_and_affinity(pod, node):
                continue
            if not node_labels_match_constraints(node.metadata.labels, s.constraints):
                continue
            for c in s.constraints:
                pair = (c.topology_key, node.metadata.labels[c.topology_key])
                s.tp_pair_to_match_num.setdefault(pair, 0)
        # count matching pods per registered pair
        for ni in all_nodes:
            node = ni.node
            if node is None:
                continue
            for c in s.constraints:
                pair = (c.topology_key, (node.metadata.labels or {}).get(c.topology_key))
                if pair not in s.tp_pair_to_match_num:
                    continue
                s.tp_pair_to_match_num[pair] += count_pods_match_selector(
                    ni.pods, c.selector, pod.metadata.namespace
                )
        for c in s.constraints:
            s.tp_key_to_critical_paths[c.topology_key] = _CriticalPaths()
        for (k, v), num in s.tp_pair_to_match_num.items():
            s.tp_key_to_critical_paths[k].update(v, num)
        return None

    def pre_filter_extensions(self):
        return self

    def add_pod(self, state, pod_to_schedule, pod_info_to_add, node_info) -> Optional[Status]:
        s = _get_state(state)
        s.update_with_pod(pod_info_to_add.pod, pod_to_schedule, node_info.node, 1)
        return None

    def remove_pod(self, state, pod_to_schedule, pod_info_to_remove, node_info) -> Optional[Status]:
        s = _get_state(state)
        s.update_with_pod(pod_info_to_remove.pod, pod_to_schedule, node_info.node, -1)
        return None

    # -- Filter ------------------------------------------------------------

    def filter(self, state: CycleState, pod: v1.Pod, node_info: NodeInfo) -> Optional[Status]:
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        s = _get_state(state)
        if not s.constraints:
            return None
        labels = node.metadata.labels or {}
        for c in s.constraints:
            tp_key = c.topology_key
            if tp_key not in labels:
                return Status.unschedulable_and_unresolvable(ERR_REASON_NODE_LABEL_NOT_MATCH)
            tp_val = labels[tp_key]
            self_match = 1 if c.selector.matches(pod.metadata.labels) else 0
            paths = s.tp_key_to_critical_paths.get(tp_key)
            if paths is None:
                continue
            min_match = paths.min_match
            match_num = s.tp_pair_to_match_num.get((tp_key, tp_val), 0)
            if min_match is math.inf:
                min_match = 0
            if match_num + self_match - min_match > c.max_skew:
                return Status.unschedulable(ERR_REASON_CONSTRAINTS_NOT_MATCH)
        return None

    # -- PreScore / Score --------------------------------------------------

    def pre_score(self, state: CycleState, pod: v1.Pod, filtered_nodes) -> Optional[Status]:
        all_nodes = self.handle.snapshot_shared_lister().list()
        if not filtered_nodes or not all_nodes:
            return None
        constraints = self._constraints_for(pod, SCHEDULE_ANYWAY)
        ps = {
            "constraints": constraints,
            "ignored_nodes": set(),
            "pair_counts": {},  # (key,value) -> matching pod count
            "weights": [],
        }
        state.write(PRE_SCORE_STATE_KEY, ps)
        if not constraints:
            return None
        topo_size = [0] * len(constraints)
        for node in filtered_nodes:
            labels = node.metadata.labels or {}
            if not node_labels_match_constraints(labels, constraints):
                ps["ignored_nodes"].add(node.metadata.name)
                continue
            for i, c in enumerate(constraints):
                if c.topology_key == v1.LABEL_HOSTNAME:
                    continue
                pair = (c.topology_key, labels[c.topology_key])
                if pair not in ps["pair_counts"]:
                    ps["pair_counts"][pair] = 0
                    topo_size[i] += 1
        ps["weights"] = [
            math.log(
                (len(filtered_nodes) - len(ps["ignored_nodes"]) if c.topology_key == v1.LABEL_HOSTNAME else topo_size[i])
                + 2
            )
            for i, c in enumerate(constraints)
        ]
        for ni in all_nodes:
            node = ni.node
            if node is None:
                continue
            if not pod_matches_node_selector_and_affinity(pod, node):
                continue
            labels = node.metadata.labels or {}
            if not node_labels_match_constraints(labels, constraints):
                continue
            for c in constraints:
                pair = (c.topology_key, labels[c.topology_key])
                if pair not in ps["pair_counts"]:
                    continue
                ps["pair_counts"][pair] += count_pods_match_selector(
                    ni.pods, c.selector, pod.metadata.namespace
                )
        return None

    def score(self, state: CycleState, pod: v1.Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        try:
            node_info = self.handle.snapshot_shared_lister().get(node_name)
        except KeyError as e:
            return 0, Status.error(str(e))
        node = node_info.node
        try:
            ps = state.read(PRE_SCORE_STATE_KEY)
        except KeyError as e:
            return 0, Status.error(str(e))
        if not ps["constraints"] or node.metadata.name in ps["ignored_nodes"]:
            return 0, None
        labels = node.metadata.labels or {}
        score = 0.0
        for i, c in enumerate(ps["constraints"]):
            if c.topology_key in labels:
                if c.topology_key == v1.LABEL_HOSTNAME:
                    cnt = count_pods_match_selector(
                        node_info.pods, c.selector, pod.metadata.namespace
                    )
                else:
                    cnt = ps["pair_counts"].get((c.topology_key, labels[c.topology_key]), 0)
                score += cnt * ps["weights"][i] + (c.max_skew - 1)
        return int(score), None

    def normalize_score(self, state: CycleState, pod: v1.Pod, scores) -> Optional[Status]:
        try:
            ps = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            return None
        if not ps["constraints"]:
            return None
        min_score = math.inf
        max_score = 0
        for ns in scores:
            if ns.name in ps["ignored_nodes"]:
                ns.score = INVALID_SCORE
                continue
            min_score = min(min_score, ns.score)
            max_score = max(max_score, ns.score)
        for ns in scores:
            if ns.score == INVALID_SCORE:
                ns.score = 0
                continue
            if max_score == 0:
                ns.score = fwk.MAX_NODE_SCORE
                continue
            s = ns.score
            ns.score = fwk.MAX_NODE_SCORE * (max_score + int(min_score) - s) // max_score
        return None


def _get_state(state: CycleState) -> _PreFilterState:
    return state.read(PRE_FILTER_STATE_KEY)
