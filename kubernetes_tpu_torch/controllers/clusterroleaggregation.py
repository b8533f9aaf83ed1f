"""ClusterRole aggregation controller.

Reference: pkg/controller/clusterroleaggregation/clusterroleaggregation_controller.go
— for every ClusterRole with an aggregationRule, union the rules of all
ClusterRoles matched by its clusterRoleSelectors (sorted by name for a
stable result) and write them back when they differ (:94 syncClusterRole).
"""

from __future__ import annotations

from ..api import rbac
from ..client.informer import EventHandler
from .base import Controller, retry_on_conflict


def _matches(selector_labels: dict, labels: dict) -> bool:
    return all((labels or {}).get(k) == v for k, v in selector_labels.items())


class ClusterRoleAggregationController(Controller):
    name = "clusterrole-aggregation"

    def __init__(self, clientset, informer_factory, workers: int = 1):
        super().__init__(workers=workers)
        self.client = clientset
        self.informer = informer_factory.informer_for("clusterroles")
        self.informer.add_event_handler(EventHandler(
            on_add=self._on_event,
            on_update=lambda o, n: self._on_event(n),
            on_delete=self._on_event,
        ))

    def _on_event(self, role: rbac.ClusterRole) -> None:
        # any change can affect any aggregating role (the reference
        # re-enqueues all aggregating roles on every ClusterRole event,
        # :74 enqueueAll)
        for r in self.informer.list():
            if r.aggregation_rule is not None:
                self.enqueue(r.metadata.name)

    def sync(self, key: str) -> None:
        role = self.informer.get(key)
        if role is None or role.aggregation_rule is None:
            return
        selectors = role.aggregation_rule.cluster_role_selectors or []
        union = []
        seen = set()
        for other in sorted(self.informer.list(),
                            key=lambda r: r.metadata.name):
            if other.metadata.name == role.metadata.name:
                continue
            if not any(_matches(s, other.metadata.labels) for s in selectors):
                continue
            for rule in other.rules or []:
                fp = (tuple(rule.verbs or ()), tuple(rule.api_groups or ()),
                      tuple(rule.resources or ()),
                      tuple(rule.resource_names or ()))
                if fp not in seen:
                    seen.add(fp)
                    union.append(rule)

        def fp_rules(rules):
            return [
                (tuple(r.verbs or ()), tuple(r.api_groups or ()),
                 tuple(r.resources or ()), tuple(r.resource_names or ()))
                for r in rules or []
            ]

        if fp_rules(union) == fp_rules(role.rules):
            return

        def apply():
            fresh = self.client.resource("clusterroles").get(key)
            if fp_rules(fresh.rules) == fp_rules(union):
                return
            fresh.rules = union
            self.client.resource("clusterroles").update(fresh)

        retry_on_conflict(apply)
