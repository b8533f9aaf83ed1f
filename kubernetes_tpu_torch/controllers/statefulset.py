"""StatefulSet controller.

Reference: pkg/controller/statefulset/stateful_set_control.go —
UpdateStatefulSet: replicas get stable ordinal identities
(<name>-0 … <name>-N-1); with the default OrderedReady policy, pod i is
created only after pods 0..i-1 are running and ready, and scale-down
removes the highest ordinal first (also one at a time).
"""

from __future__ import annotations

import copy
from typing import Dict

from ..api import apps, types as v1
from ..client.informer import EventHandler, meta_namespace_key
from ..utils import serde
from .base import Controller, controller_ref, get_controller_of, is_pod_ready


class StatefulSetController(Controller):
    name = "statefulset"
    kind = "StatefulSet"

    def __init__(self, clientset, informer_factory, workers: int = 2):
        super().__init__(workers=workers)
        self.client = clientset
        self.ss_informer = informer_factory.informer_for("statefulsets")
        self.pod_informer = informer_factory.informer_for("pods")
        self._wire_handlers()

    def _wire_handlers(self) -> None:
        self.ss_informer.add_event_handler(
            EventHandler(
                on_add=lambda s: self.enqueue(meta_namespace_key(s)),
                on_update=lambda o, n: self.enqueue(meta_namespace_key(n)),
                on_delete=lambda s: self.enqueue(meta_namespace_key(s)),
            )
        )
        self.pod_informer.add_event_handler(
            EventHandler(
                on_add=self._on_pod_event,
                on_update=lambda o, n: self._on_pod_event(n),
                on_delete=self._on_pod_event,
            )
        )

    def _on_pod_event(self, pod: v1.Pod) -> None:
        ref = get_controller_of(pod)
        if ref is not None and ref.kind == self.kind:
            self.enqueue(f"{pod.metadata.namespace}/{ref.name}")

    def _owned_pods(self, ss: apps.StatefulSet) -> Dict[int, v1.Pod]:
        prefix = ss.metadata.name + "-"
        out: Dict[int, v1.Pod] = {}
        for pod in self.pod_informer.list():
            ref = get_controller_of(pod)
            if ref is None or ref.uid != ss.metadata.uid:
                continue
            name = pod.metadata.name
            if not name.startswith(prefix):
                continue
            try:
                ordinal = int(name[len(prefix):])
            except ValueError:
                continue
            out[ordinal] = pod
        return out

    def _new_pod(self, ss: apps.StatefulSet, ordinal: int) -> v1.Pod:
        tmpl = ss.spec.template
        spec = serde.from_dict(v1.PodSpec, serde.to_dict(tmpl.spec)) or v1.PodSpec()
        labels = dict(tmpl.metadata.labels or {})
        labels["statefulset.kubernetes.io/pod-name"] = f"{ss.metadata.name}-{ordinal}"
        return v1.Pod(
            metadata=v1.ObjectMeta(
                name=f"{ss.metadata.name}-{ordinal}",
                namespace=ss.metadata.namespace,
                labels=labels,
                owner_references=[controller_ref(ss, self.kind)],
            ),
            spec=spec,
        )

    def sync(self, key: str) -> None:
        ss = self.ss_informer.get(key)
        if ss is None or ss.metadata.deletion_timestamp is not None:
            return
        want = ss.spec.replicas if ss.spec.replicas is not None else 1
        ordered = ss.spec.pod_management_policy != "Parallel"
        pods = self._owned_pods(ss)

        # create missing ordinals 0..want-1 (in order when OrderedReady);
        # failed pods are deleted and recreated (stateful_set_control.go:433)
        for i in range(want):
            pod = pods.get(i)
            if pod is not None and pod.status.phase == "Failed":
                if pod.metadata.deletion_timestamp is None:
                    try:
                        self.client.pods.delete(
                            pod.metadata.name, pod.metadata.namespace
                        )
                    except Exception:  # noqa: BLE001
                        pass
                if ordered:
                    break
                continue
            if pod is None:
                try:
                    self.client.pods.create(self._new_pod(ss, i))
                except Exception:  # noqa: BLE001 — AlreadyExists race
                    pass
                if ordered:
                    break
            elif ordered and not (
                pod.status.phase == "Running" and is_pod_ready(pod)
            ):
                break  # wait for pod i before creating i+1

        # scale down: highest ordinal first, one at a time when ordered
        extra = sorted((o for o in pods if o >= want), reverse=True)
        for o in extra:
            pod = pods[o]
            if pod.metadata.deletion_timestamp is None:
                try:
                    self.client.pods.delete(pod.metadata.name, pod.metadata.namespace)
                except Exception:  # noqa: BLE001
                    pass
            if ordered:
                break

        self._update_status(ss, pods, want)

    def _update_status(self, ss, pods, want) -> None:
        current = [p for o, p in pods.items() if o < want]
        new = apps.StatefulSetStatus(
            observed_generation=ss.metadata.generation,
            replicas=len(current),
            ready_replicas=sum(1 for p in current if is_pod_ready(p)),
            current_replicas=len(current),
            updated_replicas=len(current),
        )
        if serde.to_dict(new) != serde.to_dict(ss.status):
            updated = copy.deepcopy(ss)
            updated.status = new
            try:
                self.client.statefulsets.update_status(updated)
            except Exception:  # noqa: BLE001
                pass
