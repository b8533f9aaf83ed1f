"""SelectorSpread plugin: PreScore + Score + NormalizeScore.

Reference: pkg/scheduler/framework/plugins/selectorspread/selector_spread.go
— spread pods of the same Service / ReplicationController / ReplicaSet /
StatefulSet across nodes and zones. Score counts matching pods on the
node; NormalizeScore inverts against the max and blends a zone-level
count at 2/3 weight (selector_spread.go:42 zoneWeighting).

Selector resolution mirrors plugins/helper/spread.go DefaultSelector:
the union of selectors of every owning-kind object in the pod's namespace
whose selector matches the pod, combined as a conjunction.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ...api import types as v1
from ...api.labels import Selector
from ..framework import interface as fwk
from ..framework.interface import CycleState, NodeScore, Status

STATE_KEY = "PreScoreSelectorSpread"
ZONE_WEIGHTING = 2.0 / 3.0  # selector_spread.go:42


def default_selector(
    pod: v1.Pod,
    services: List[v1.Service],
    rcs: List[v1.ReplicationController],
    rss: List,
    sss: List,
) -> Selector:
    """helper/spread.go:40 DefaultSelector: conjunction of the selectors of
    all services/RCs/RSs/SSs selecting this pod."""
    labels = pod.metadata.labels or {}
    namespace = pod.metadata.namespace
    reqs = []

    def add_map_selector(sel_map):
        sel = Selector.from_match_labels(sel_map)
        if sel_map and sel.matches(labels):
            reqs.extend(sel.requirements)

    def add_label_selector(sel):
        s = Selector.from_label_selector(sel)
        if sel is not None and s.matches(labels):
            reqs.extend(s.requirements)

    for svc in services:
        if svc.metadata.namespace == namespace:
            add_map_selector(svc.spec.selector)
    for rc in rcs:
        if rc.metadata.namespace == namespace:
            add_map_selector(rc.spec.selector)
    for rs in rss:
        if rs.metadata.namespace == namespace:
            add_label_selector(rs.spec.selector)
    for ss in sss:
        if ss.metadata.namespace == namespace:
            add_label_selector(ss.spec.selector)
    if not reqs:
        return Selector.nothing()
    return Selector(reqs)


class _State:
    __slots__ = ("selector",)

    def __init__(self, selector: Selector):
        self.selector = selector


def _count_matching(pod: v1.Pod, selector: Selector, node_info) -> int:
    """selector_spread.go countMatchingPods: same namespace, selector match,
    not terminating."""
    if selector.is_everything() or not selector.requirements:
        return 0
    n = 0
    for pi in node_info.pods:
        other = pi.pod
        if other.metadata.namespace != pod.metadata.namespace:
            continue
        if other.metadata.deletion_timestamp is not None:
            continue
        if selector.matches(other.metadata.labels):
            n += 1
    return n


def _node_zone(node: Optional[v1.Node]) -> str:
    if node is None:
        return ""
    labels = node.metadata.labels or {}
    return labels.get(v1.LABEL_ZONE) or labels.get(v1.LABEL_ZONE_LEGACY) or ""


class SelectorSpread(fwk.PreScorePlugin, fwk.ScorePlugin):
    name = "SelectorSpread"
    has_normalize = True

    def __init__(self, args=None, handle=None):
        self._handle = handle

    def _listers(self):
        h = self._handle
        fn: Optional[Callable] = getattr(h, "spread_listers", None) if h else None
        if fn is None:
            return [], [], [], []
        return fn()

    def pre_score(self, state: CycleState, pod: v1.Pod, nodes) -> Optional[Status]:
        services, rcs, rss, sss = self._listers()
        state.write(STATE_KEY, _State(default_selector(pod, services, rcs, rss, sss)))
        return None

    def score(self, state: CycleState, pod: v1.Pod, node_name: str):
        try:
            data: _State = state.read(STATE_KEY)
        except KeyError as e:
            return 0, Status.error(str(e))
        lister = self._handle.snapshot_shared_lister() if self._handle else None
        if lister is None:
            return 0, None
        node_info = lister.get(node_name)
        return _count_matching(pod, data.selector, node_info), None

    def normalize_score(self, state: CycleState, pod: v1.Pod, scores: List[NodeScore]) -> Optional[Status]:
        """selector_spread.go NormalizeScore: invert vs max; blend per-zone
        counts at 2/3 weight when zones exist."""
        lister = self._handle.snapshot_shared_lister() if self._handle else None
        counts_by_zone = {}
        zone_of = {}
        if lister is not None:
            for ns in scores:
                zone = _node_zone(lister.get(ns.name).node)
                zone_of[ns.name] = zone
                if zone:
                    counts_by_zone[zone] = counts_by_zone.get(zone, 0) + ns.score
        max_count_by_node = max((ns.score for ns in scores), default=0)
        max_count_by_zone = max(counts_by_zone.values(), default=0)
        have_zones = bool(counts_by_zone)
        for ns in scores:
            if max_count_by_node > 0:
                fscore = fwk.MAX_NODE_SCORE * (
                    (max_count_by_node - ns.score) / max_count_by_node
                )
            else:
                fscore = float(fwk.MAX_NODE_SCORE)
            if have_zones and max_count_by_zone > 0:
                zone = zone_of.get(ns.name, "")
                if zone:
                    zone_score = fwk.MAX_NODE_SCORE * (
                        (max_count_by_zone - counts_by_zone[zone])
                        / max_count_by_zone
                    )
                    fscore = (1.0 - ZONE_WEIGHTING) * fscore + ZONE_WEIGHTING * zone_score
            ns.score = int(fscore)
        return None
