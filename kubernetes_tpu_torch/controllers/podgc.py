"""Pod garbage collector.

Reference: pkg/controller/podgc/gc_controller.go — a periodic sweep
(gcCheckPeriod 20s) with three passes:
  gcTerminated (:106): when terminated (Succeeded/Failed) pods exceed the
    threshold, delete the oldest beyond it;
  gcOrphaned (:145): pods bound to a node that no longer exists are
    deleted (the kubelet that would run them is gone);
  gcUnscheduledTerminating (:174): terminating pods never scheduled have
    no kubelet to finalize them — delete outright.
"""

from __future__ import annotations

import threading
from typing import List

from ..api import types as v1
from .base import Controller


class PodGCController(Controller):
    name = "podgc"

    def __init__(self, clientset, informer_factory,
                 terminated_pod_threshold: int = 12500,
                 sync_period: float = 20.0):
        super().__init__(workers=1)
        self.client = clientset
        self.pod_informer = informer_factory.informer_for("pods")
        self.node_informer = informer_factory.informer_for("nodes")
        self.threshold = terminated_pod_threshold
        self.period = sync_period
        self._timer: threading.Thread = threading.Thread(
            target=self._tick_loop, daemon=True
        )

    def run(self) -> None:
        super().run()
        self._timer.start()

    def _tick_loop(self) -> None:
        while not self._stopped.wait(self.period):
            self.enqueue("gc")

    def sync(self, key: str) -> None:
        # a partial node cache would make every bound pod look orphaned —
        # the blast radius of that mistake is the whole running workload
        if not self.node_informer.has_synced() or not self.pod_informer.has_synced():
            return
        pods: List[v1.Pod] = self.pod_informer.list()
        nodes = {n.metadata.name for n in self.node_informer.list()}

        terminated = [
            p for p in pods if p.status.phase in ("Succeeded", "Failed")
        ]
        if self.threshold > 0 and len(terminated) > self.threshold:
            excess = len(terminated) - self.threshold
            terminated.sort(key=lambda p: p.metadata.creation_timestamp or 0.0)
            for p in terminated[:excess]:
                self._delete(p)

        for p in pods:
            if p.spec.node_name and p.spec.node_name not in nodes:
                # double-check against the apiserver before destroying a
                # possibly-running pod (gc_controller.go:145 gcOrphaned
                # re-verifies node absence; informer caches lag)
                if self._node_exists(p.spec.node_name):
                    continue
                self._delete(p)
            elif (p.metadata.deletion_timestamp is not None
                  and not p.spec.node_name):
                self._delete(p)

    def _node_exists(self, name: str) -> bool:
        from ..apiserver.server import NotFound

        try:
            self.client.nodes.get(name)
            return True
        except NotFound:
            return False
        except Exception:  # noqa: BLE001 — uncertainty must not delete
            return True

    def _delete(self, pod: v1.Pod) -> None:
        try:
            self.client.pods.delete(pod.metadata.name, pod.metadata.namespace)
        except Exception:  # noqa: BLE001 — already gone / conflict: next sweep
            pass
