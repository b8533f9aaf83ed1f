"""DaemonSet controller.

Reference: pkg/controller/daemon/daemon_controller.go — syncDaemonSet →
podsShouldBeOnNode (:944): one pod per eligible node; pods carry a
required node affinity pinning them to their node
(util/daemonset_util.go ReplaceDaemonSetPodNodeNameNodeAffinity) and
NoExecute/NoSchedule tolerations for node-condition taints
(AddOrUpdateDaemonPodTolerations), then the default scheduler binds
them.
"""

from __future__ import annotations

from typing import Dict, List

from ..api import apps, types as v1
from ..api.labels import pod_matches_node_selector_and_affinity
from ..api.taints import find_matching_untolerated_taint
from ..client.informer import EventHandler, meta_namespace_key
from ..utils import serde
from .base import (
    Controller,
    ControllerExpectations,
    controller_ref,
    get_controller_of,
    rand_suffix,
)

DAEMON_TOLERATIONS = [
    v1.Toleration(key=v1.TAINT_NODE_NOT_READY, operator="Exists", effect="NoExecute"),
    v1.Toleration(key=v1.TAINT_NODE_UNREACHABLE, operator="Exists", effect="NoExecute"),
    v1.Toleration(
        key=v1.TAINT_NODE_UNSCHEDULABLE, operator="Exists", effect="NoSchedule"
    ),
]



def _node_affinity_for(node_name: str) -> v1.Affinity:
    """ReplaceDaemonSetPodNodeNameNodeAffinity: matchFields on
    metadata.name pins the pod to one node through the scheduler."""
    return v1.Affinity(
        node_affinity=v1.NodeAffinity(
            required_during_scheduling_ignored_during_execution=v1.NodeSelector(
                node_selector_terms=[
                    v1.NodeSelectorTerm(
                        match_fields=[
                            v1.NodeSelectorRequirement(
                                key="metadata.name", operator="In", values=[node_name]
                            )
                        ]
                    )
                ]
            )
        )
    )


class DaemonSetController(Controller):
    name = "daemonset"
    kind = "DaemonSet"

    def __init__(self, clientset, informer_factory, workers: int = 2):
        super().__init__(workers=workers)
        self.client = clientset
        self.ds_informer = informer_factory.informer_for("daemonsets")
        self.pod_informer = informer_factory.informer_for("pods")
        self.node_informer = informer_factory.informer_for("nodes")
        self.expectations = ControllerExpectations()
        self._wire_handlers()

    def _wire_handlers(self) -> None:
        self.ds_informer.add_event_handler(
            EventHandler(
                on_add=lambda ds: self.enqueue(meta_namespace_key(ds)),
                on_update=lambda o, n: self.enqueue(meta_namespace_key(n)),
                on_delete=lambda ds: self.enqueue(meta_namespace_key(ds)),
            )
        )
        self.pod_informer.add_event_handler(
            EventHandler(
                on_add=self._on_pod_event,
                on_update=lambda o, n: self._on_pod_event(n, update=True),
                on_delete=lambda p: self._on_pod_event(p, deleted=True),
            )
        )
        self.node_informer.add_event_handler(
            EventHandler(
                on_add=lambda n: self._enqueue_all(),
                on_update=lambda o, n: self._enqueue_all(),
                on_delete=lambda n: self._enqueue_all(),
            )
        )

    def _enqueue_all(self) -> None:
        for ds in self.ds_informer.list():
            self.enqueue(meta_namespace_key(ds))

    def _on_pod_event(
        self, pod: v1.Pod, update: bool = False, deleted: bool = False
    ) -> None:
        ref = get_controller_of(pod)
        if ref is None or ref.kind != self.kind:
            return
        key = f"{pod.metadata.namespace}/{ref.name}"
        if deleted:
            self.expectations.deletion_observed(key)
        elif not update:
            self.expectations.creation_observed(key)
        self.enqueue(key)

    # -- sync ---------------------------------------------------------------

    def _should_run_on(self, ds: apps.DaemonSet, node: v1.Node) -> bool:
        """nodeShouldRunDaemonPod (:1232): simulate the daemon pod against
        the node's selectors and taints (NoSchedule/NoExecute only)."""
        pod = self._new_pod(ds, node.metadata.name, stamp=False)
        if not pod_matches_node_selector_and_affinity(pod, node):
            return False
        taint, _ = find_matching_untolerated_taint(
            node.spec.taints or [],
            pod.spec.tolerations or [],
            lambda t: t.effect in ("NoSchedule", "NoExecute"),
        )
        return taint is None

    def _new_pod(self, ds: apps.DaemonSet, node_name: str, stamp: bool = True) -> v1.Pod:
        tmpl = ds.spec.template
        spec = serde.from_dict(v1.PodSpec, serde.to_dict(tmpl.spec)) or v1.PodSpec()
        spec.affinity = spec.affinity or v1.Affinity()
        spec.affinity.node_affinity = _node_affinity_for(node_name).node_affinity
        spec.tolerations = (spec.tolerations or []) + [
            serde.from_dict(v1.Toleration, serde.to_dict(t)) for t in DAEMON_TOLERATIONS
        ]
        meta = v1.ObjectMeta(
            name=f"{ds.metadata.name}-{rand_suffix()}" if stamp else "probe",
            namespace=ds.metadata.namespace,
            labels=dict(tmpl.metadata.labels or {}),
            owner_references=[controller_ref(ds, self.kind)] if stamp else None,
        )
        return v1.Pod(metadata=meta, spec=spec)

    def sync(self, key: str) -> None:
        ds = self.ds_informer.get(key)
        if ds is None:
            self.expectations.delete_expectations(key)
            return
        pods_by_node: Dict[str, List[v1.Pod]] = {}
        for pod in self.pod_informer.list():
            ref = get_controller_of(pod)
            if ref is None or ref.uid != ds.metadata.uid:
                continue
            if pod.metadata.deletion_timestamp is not None:
                continue
            node = pod.spec.node_name or self._pinned_node(pod)
            pods_by_node.setdefault(node, []).append(pod)

        nodes = self.node_informer.list()
        want_nodes = {
            n.metadata.name for n in nodes if self._should_run_on(ds, n)
        }
        if self.expectations.satisfied(key):
            creates = [n for n in sorted(want_nodes) if not pods_by_node.get(n)]
            deletes: List[v1.Pod] = []
            for node_name, pods in pods_by_node.items():
                if node_name not in want_nodes:
                    deletes.extend(pods)
                else:
                    deletes.extend(
                        sorted(pods, key=lambda p: p.metadata.creation_timestamp or 0)[1:]
                    )
            if creates or deletes:
                self.expectations.set_expectations(key, len(creates), len(deletes))
            if creates:
                for node_name in creates:
                    try:
                        self.client.pods.create(self._new_pod(ds, node_name))
                    except Exception:  # noqa: BLE001
                        self.expectations.creation_observed(key)
            if deletes:
                for pod in deletes:
                    try:
                        self.client.pods.delete(
                            pod.metadata.name, pod.metadata.namespace
                        )
                    except Exception:  # noqa: BLE001
                        self.expectations.deletion_observed(key)
        self._update_status(ds, pods_by_node, want_nodes)

    @staticmethod
    def _pinned_node(pod: v1.Pod) -> str:
        aff = pod.spec.affinity
        if aff and aff.node_affinity:
            req = aff.node_affinity.required_during_scheduling_ignored_during_execution
            for term in (req.node_selector_terms or []) if req else []:
                for m in term.match_fields or []:
                    if m.key == "metadata.name" and m.values:
                        return m.values[0]
        return ""

    def _update_status(self, ds, pods_by_node, want_nodes) -> None:
        import copy

        from .base import is_pod_ready

        scheduled = sum(
            1 for n, pods in pods_by_node.items() if pods and n in want_nodes
        )
        mis = sum(1 for n, pods in pods_by_node.items() if pods and n not in want_nodes)
        ready = sum(
            1
            for n, pods in pods_by_node.items()
            if n in want_nodes and any(is_pod_ready(p) for p in pods)
        )
        new = apps.DaemonSetStatus(
            current_number_scheduled=scheduled,
            number_misscheduled=mis,
            desired_number_scheduled=len(want_nodes),
            number_ready=ready,
            observed_generation=ds.metadata.generation,
        )
        if serde.to_dict(new) != serde.to_dict(ds.status):
            updated = copy.deepcopy(ds)
            updated.status = new
            try:
                self.client.daemonsets.update_status(updated)
            except Exception:  # noqa: BLE001
                pass
