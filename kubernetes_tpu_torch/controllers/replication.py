"""ReplicationController controller.

Reference: pkg/controller/replication/replication_controller.go — the
reference literally implements it as a thin adapter over the ReplicaSet
controller (conversion.go wraps RC objects in the RS informer/claims
machinery); this build does the same by subclassing, with the two
core/v1 differences: a map selector and the smaller RC status."""

from __future__ import annotations

from typing import List

from ..api import types as v1
from ..api.labels import Selector
from .replicaset import ReplicaSetController


class ReplicationControllerController(ReplicaSetController):
    name = "replicationcontroller"
    kind = "ReplicationController"
    resource = "replicationcontrollers"

    def _selector(self, rc) -> Selector:
        # core/v1 RC selector is a plain map; an RC with no selector
        # selects its template labels (the apiserver defaults it — mirror
        # that defaulting here for objects created without one)
        sel = rc.spec.selector
        if not sel and rc.spec.template is not None:
            sel = dict(rc.spec.template.metadata.labels or {})
        return Selector.from_label_selector(
            v1.LabelSelector(match_labels=dict(sel or {}))
        )

    def _make_status(self, rc, pods: List[v1.Pod], fully_labeled, ready,
                     available):
        return v1.ReplicationControllerStatus(
            replicas=len(pods),
            ready_replicas=ready,
        )
