"""Deployment controller.

Reference: pkg/controller/deployment — syncDeployment (deployment_controller.go:566),
rolling update (rolling.go: reconcileNewReplicaSet bounded by maxSurge,
reconcileOldReplicaSets bounded by maxUnavailable), Recreate (recreate.go),
newRS identification by pod-template hash (util/deployment_util.go) with the
`pod-template-hash` label stamped on the RS selector/template.
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
from typing import List, Optional, Tuple

from ..api import apps, types as v1
from ..client.informer import EventHandler, meta_namespace_key
from ..utils import serde
from .base import Controller, controller_ref, get_controller_of, retry_on_conflict

POD_TEMPLATE_HASH = "pod-template-hash"
REVISION_ANNOTATION = "deployment.kubernetes.io/revision"
DEFAULT_REVISION_HISTORY_LIMIT = 10  # deployment_util.go / defaults


def rs_revision(rs: apps.ReplicaSet) -> int:
    try:
        return int((rs.metadata.annotations or {}).get(REVISION_ANNOTATION, "0"))
    except ValueError:
        return 0


def _template_hash(tmpl: v1.PodTemplateSpec) -> str:
    """ComputeHash (deployment_util.go:983): deterministic hash of the pod
    template, excluding the hash label itself."""
    d = serde.to_dict(tmpl)
    labels = d.get("metadata", {}).get("labels")
    if labels:
        labels.pop(POD_TEMPLATE_HASH, None)
    raw = json.dumps(d, sort_keys=True).encode()
    return hashlib.sha256(raw).hexdigest()[:10]


def resolve_int_or_percent(val: Optional[str], total: int, round_up: bool) -> int:
    """intstr.GetValueFromIntOrPercent; defaults handled by caller."""
    if val is None:
        return 0
    s = str(val)
    if s.endswith("%"):
        frac = int(s[:-1]) * total / 100.0
        return math.ceil(frac) if round_up else math.floor(frac)
    return int(s)


def max_surge_unavailable(d: apps.Deployment, want: int) -> Tuple[int, int]:
    ru = d.spec.strategy.rolling_update
    surge_s = ru.max_surge if ru and ru.max_surge is not None else "25%"
    unavail_s = ru.max_unavailable if ru and ru.max_unavailable is not None else "25%"
    surge = resolve_int_or_percent(surge_s, want, round_up=True)
    unavail = resolve_int_or_percent(unavail_s, want, round_up=False)
    if surge == 0 and unavail == 0:
        unavail = 1  # both-zero is invalid; reference validation forbids it
    return surge, unavail


class DeploymentController(Controller):
    name = "deployment"
    kind = "Deployment"

    def __init__(self, clientset, informer_factory, workers: int = 2):
        super().__init__(workers=workers)
        self.client = clientset
        self.d_informer = informer_factory.informer_for("deployments")
        self.rs_informer = informer_factory.informer_for("replicasets")
        self._wire_handlers()

    def _wire_handlers(self) -> None:
        self.d_informer.add_event_handler(
            EventHandler(
                on_add=lambda d: self.enqueue(meta_namespace_key(d)),
                on_update=lambda old, new: self.enqueue(meta_namespace_key(new)),
                on_delete=lambda d: self.enqueue(meta_namespace_key(d)),
            )
        )
        self.rs_informer.add_event_handler(
            EventHandler(
                on_add=self._on_rs_event,
                on_update=lambda old, new: self._on_rs_event(new),
                on_delete=self._on_rs_event,
            )
        )

    def _on_rs_event(self, rs: apps.ReplicaSet) -> None:
        ref = get_controller_of(rs)
        if ref is not None and ref.kind == self.kind:
            self.enqueue(f"{rs.metadata.namespace}/{ref.name}")

    # -- sync ---------------------------------------------------------------

    def _owned_rses(self, d: apps.Deployment) -> List[apps.ReplicaSet]:
        out = []
        for rs in self.rs_informer.list():
            if rs.metadata.namespace != d.metadata.namespace:
                continue
            ref = get_controller_of(rs)
            if ref is not None and ref.uid == d.metadata.uid:
                out.append(rs)
        return out

    def _find_new_rs(
        self, d: apps.Deployment, rses: List[apps.ReplicaSet]
    ) -> Optional[apps.ReplicaSet]:
        h = _template_hash(d.spec.template)
        for rs in sorted(rses, key=lambda r: r.metadata.creation_timestamp or 0):
            if (rs.spec.template.metadata.labels or {}).get(POD_TEMPLATE_HASH) == h:
                return rs
        return None

    def _create_new_rs(self, d: apps.Deployment) -> apps.ReplicaSet:
        h = _template_hash(d.spec.template)
        tmpl = serde.from_dict(v1.PodTemplateSpec, serde.to_dict(d.spec.template))
        labels = dict(tmpl.metadata.labels or {})
        labels[POD_TEMPLATE_HASH] = h
        tmpl.metadata.labels = labels
        sel = serde.from_dict(v1.LabelSelector, serde.to_dict(d.spec.selector)) or v1.LabelSelector()
        ml = dict(sel.match_labels or {})
        ml[POD_TEMPLATE_HASH] = h
        sel.match_labels = ml
        rs = apps.ReplicaSet(
            metadata=v1.ObjectMeta(
                name=f"{d.metadata.name}-{h}",
                namespace=d.metadata.namespace,
                labels=dict(labels),
                owner_references=[controller_ref(d, self.kind)],
            ),
            spec=apps.ReplicaSetSpec(
                replicas=0,
                min_ready_seconds=d.spec.min_ready_seconds,
                selector=sel,
                template=tmpl,
            ),
        )
        try:
            return self.client.replicasets.create(rs)
        except Exception:  # noqa: BLE001 — AlreadyExists race: re-read
            return self.client.replicasets.get(rs.metadata.name, rs.metadata.namespace)

    def _scale_rs(self, rs: apps.ReplicaSet, replicas: int) -> None:
        if (rs.spec.replicas or 0) == replicas:
            return

        def do():
            live = self.client.replicasets.get(rs.metadata.name, rs.metadata.namespace)
            if (live.spec.replicas or 0) == replicas:
                return
            live.spec.replicas = replicas
            self.client.replicasets.update(live)

        retry_on_conflict(do)

    def sync(self, key: str) -> None:
        d = self.d_informer.get(key)
        if d is None or d.metadata.deletion_timestamp is not None:
            return
        rses = self._owned_rses(d)
        new_rs = self._find_new_rs(d, rses)
        if new_rs is None and not d.spec.paused:
            new_rs = self._create_new_rs(d)
            rses = rses + [new_rs]
        old_rses = [
            rs for rs in rses if new_rs is None or rs.metadata.uid != new_rs.metadata.uid
        ]
        if new_rs is not None:
            new_rs = self._stamp_revision(new_rs, old_rses)
        if not d.spec.paused and new_rs is not None:
            if d.spec.strategy.type == "Recreate":
                self._rollout_recreate(d, new_rs, old_rses)
            else:
                self._rollout_rolling(d, new_rs, old_rses)
            self._prune_history(d, new_rs, old_rses)
        self._update_status(d, new_rs, old_rses)

    def _stamp_revision(self, new_rs, old_rses):
        """SetNewReplicaSetAnnotations (deployment_util.go:307): the new
        RS carries max(old revisions)+1 — a ROLLBACK re-activates an old
        RS as the new one, so its stale revision number is bumped, which
        is exactly what `rollout history` renders."""
        max_old = max((rs_revision(rs) for rs in old_rses), default=0)
        want = max_old + 1
        cur = rs_revision(new_rs)
        if cur >= want:
            return new_rs
        updated = copy.deepcopy(new_rs)
        anns = dict(updated.metadata.annotations or {})
        anns[REVISION_ANNOTATION] = str(want)
        updated.metadata.annotations = anns
        try:
            return self.client.replicasets.update(updated)
        except Exception:  # noqa: BLE001 — conflict: next sync retries
            return new_rs

    def _prune_history(self, d, new_rs, old_rses) -> None:
        """cleanupDeployment (deployment_controller.go:632): inactive old
        RSes beyond revisionHistoryLimit are deleted, oldest revision
        first."""
        limit = (
            d.spec.revision_history_limit
            if d.spec.revision_history_limit is not None
            else DEFAULT_REVISION_HISTORY_LIMIT
        )
        inactive = [
            rs for rs in old_rses
            if (rs.spec.replicas or 0) == 0 and rs.status.replicas == 0
        ]
        excess = len(inactive) - limit
        if excess <= 0:
            return
        inactive.sort(key=rs_revision)
        for rs in inactive[:excess]:
            try:
                self.client.replicasets.delete(
                    rs.metadata.name, rs.metadata.namespace
                )
            except Exception:  # noqa: BLE001 — already gone
                pass

    # -- strategies ---------------------------------------------------------

    def _rollout_recreate(self, d, new_rs, old_rses) -> None:
        want = d.spec.replicas if d.spec.replicas is not None else 1
        for rs in old_rses:
            self._scale_rs(rs, 0)
        if any(rs.status.replicas > 0 for rs in old_rses):
            self.enqueue_after(meta_namespace_key(d), 0.05)
            return
        self._scale_rs(new_rs, want)

    def _rollout_rolling(self, d, new_rs, old_rses) -> None:
        want = d.spec.replicas if d.spec.replicas is not None else 1
        surge, unavail = max_surge_unavailable(d, want)
        new_want = new_rs.spec.replicas or 0
        # reconcileNewReplicaSet: a fully rolled-out Deployment whose
        # .spec.replicas shrank scales the new RS straight down
        if new_want > want:
            self._scale_rs(new_rs, want)
            return
        # grow new RS up to want, bounded so that the
        # total pod count never exceeds want + maxSurge
        total = sum(rs.spec.replicas or 0 for rs in old_rses) + new_want
        if new_want < want:
            grow = min(want - new_want, max(0, want + surge - total))
            if grow > 0:
                self._scale_rs(new_rs, new_want + grow)
                return
        # reconcileOldReplicaSets: shrink old RSes, bounded so that available
        # pods never drop below want - maxUnavailable
        min_available = want - unavail
        total_available = sum(rs.status.available_replicas for rs in old_rses) + (
            new_rs.status.available_replicas
        )
        budget = total_available - min_available
        # also reclaim pods that are simply not yet available on old RSes
        # (cleanupUnhealthyReplicas): they don't count against the budget
        scaled = False
        for rs in sorted(old_rses, key=lambda r: r.metadata.creation_timestamp or 0):
            cur = rs.spec.replicas or 0
            if cur == 0:
                continue
            unhealthy = max(0, cur - rs.status.available_replicas)
            shrink = min(cur, unhealthy + max(0, budget))
            if shrink > 0:
                self._scale_rs(rs, cur - shrink)
                budget -= max(0, shrink - unhealthy)
                scaled = True
        if scaled:
            return
        if any((rs.spec.replicas or 0) > 0 or rs.status.replicas > 0 for rs in old_rses):
            self.enqueue_after(meta_namespace_key(d), 0.05)

    def _update_status(self, d, new_rs, old_rses) -> None:
        all_rs = ([new_rs] if new_rs is not None else []) + old_rses
        want = d.spec.replicas if d.spec.replicas is not None else 1
        replicas = sum(rs.status.replicas for rs in all_rs)
        ready = sum(rs.status.ready_replicas for rs in all_rs)
        available = sum(rs.status.available_replicas for rs in all_rs)
        new = apps.DeploymentStatus(
            observed_generation=d.metadata.generation,
            replicas=replicas,
            updated_replicas=new_rs.status.replicas if new_rs is not None else 0,
            ready_replicas=ready,
            available_replicas=available,
            unavailable_replicas=max(0, want - available),
        )
        if serde.to_dict(new) != serde.to_dict(d.status):
            updated = copy.deepcopy(d)
            updated.status = new
            try:
                self.client.deployments.update_status(updated)
            except Exception:  # noqa: BLE001
                pass
