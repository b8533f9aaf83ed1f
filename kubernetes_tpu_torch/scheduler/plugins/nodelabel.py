"""NodeLabel plugin (legacy Policy CheckNodeLabelPresence / NodeLabelPriority).

Reference: pkg/scheduler/framework/plugins/nodelabel/node_label.go —
Filter: every presentLabels key must exist on the node and every
absentLabels key must not; Score: MaxNodeScore scaled by the fraction of
presence/absence preferences the node satisfies.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ...api import types as v1
from ..framework import interface as fwk
from ..framework.interface import CycleState, Status


class NodeLabel(fwk.FilterPlugin, fwk.ScorePlugin):
    name = "NodeLabel"
    ERR_REASON_PRESENCE = "node(s) didn't have the requested labels"

    def __init__(self, args=None, handle=None):
        self.handle = handle
        args = args or {}
        self.present_labels = list(args.get("presentLabels", []))
        self.absent_labels = list(args.get("absentLabels", []))
        self.present_labels_preference = list(args.get("presentLabelsPreference", []))
        self.absent_labels_preference = list(args.get("absentLabelsPreference", []))

    def filter(self, state: CycleState, pod: v1.Pod, node_info) -> Optional[Status]:
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        labels = node.metadata.labels or {}
        ok = all(k in labels for k in self.present_labels) and all(
            k not in labels for k in self.absent_labels
        )
        if not ok:
            return Status.unschedulable_and_unresolvable(self.ERR_REASON_PRESENCE)
        return None

    def score(self, state: CycleState, pod: v1.Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        size = len(self.present_labels_preference) + len(self.absent_labels_preference)
        if size == 0:
            return 0, None
        snapshot = self.handle.snapshot_shared_lister()
        try:
            node_info = snapshot.get(node_name)
        except KeyError as e:
            return 0, Status.error(str(e))
        labels = (node_info.node.metadata.labels or {}) if node_info.node else {}
        matched = sum(1 for k in self.present_labels_preference if k in labels)
        matched += sum(1 for k in self.absent_labels_preference if k not in labels)
        return int(fwk.MAX_NODE_SCORE * matched / size), None
