"""Attach/detach controller.

Reference: pkg/controller/volume/attachdetach — the desired state of the
world (which volumes should be attached to which node, from scheduled
pods' PVC-backed volumes, cache/desired_state_of_world.go) is reconciled
against the actual state (node.status.volumesAttached,
reconciler/reconciler.go): missing attachments are attached, attachments
with no consuming pod are detached. The in-tree plugin machinery is
replaced by the status write itself (this build has no cloud volume
backends; the node-status contract is what the kubelet and tests
consume).
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, Set

from ..api import types as v1
from .base import Controller, is_pod_active


class AttachDetachController(Controller):
    name = "attachdetach"

    def __init__(self, clientset, informer_factory, sync_period: float = 1.0):
        super().__init__(workers=1)
        self.client = clientset
        self.pod_informer = informer_factory.informer_for("pods")
        self.node_informer = informer_factory.informer_for("nodes")
        self.pvc_informer = informer_factory.informer_for("persistentvolumeclaims")
        self.period = sync_period
        self._timer = threading.Thread(target=self._tick_loop, daemon=True)

    def run(self) -> None:
        super().run()
        self._timer.start()

    def _tick_loop(self) -> None:
        while not self._stopped.wait(self.period):
            self.enqueue("reconcile")

    def _pv_name(self, namespace: str, claim_name: str) -> str:
        pvc = self.pvc_informer.get(f"{namespace}/{claim_name}")
        if pvc is None:
            return ""
        return pvc.spec.volume_name or ""

    def _desired_state(self) -> Dict[str, Set[str]]:
        """node name -> PV names pods on that node require attached."""
        desired: Dict[str, Set[str]] = {}
        for pod in self.pod_informer.list():
            if not pod.spec.node_name or not is_pod_active(pod):
                continue
            for vol in pod.spec.volumes or []:
                claim = (vol.source or {}).get("persistentVolumeClaim")
                if not claim:
                    continue
                pv = self._pv_name(
                    pod.metadata.namespace, claim.get("claimName", "")
                )
                if pv:
                    desired.setdefault(pod.spec.node_name, set()).add(pv)
        return desired

    def sync(self, key: str) -> None:
        # an unsynced pod/PVC cache yields an EMPTY desired state — acting
        # on it would mass-detach volumes under running pods
        if not (self.pod_informer.has_synced()
                and self.pvc_informer.has_synced()
                and self.node_informer.has_synced()):
            return
        desired = self._desired_state()
        for node in self.node_informer.list():
            name = node.metadata.name
            want = desired.get(name, set())
            have = {
                av.name for av in node.status.volumes_attached or []
            }
            if want == have:
                continue
            try:
                # re-GET before writing: update_status replaces the WHOLE
                # status, and the informer copy may predate a kubelet
                # heartbeat — writing the stale snapshot would revert
                # fresh conditions/capacity (the kubelet's own status
                # loop uses the same re-GET discipline)
                updated = copy.deepcopy(self.client.nodes.get(name))
            except Exception:  # noqa: BLE001 — node gone: next tick
                continue
            updated.status.volumes_attached = [
                v1.AttachedVolume(name=pv, device_path=f"/dev/disk/{pv}")
                for pv in sorted(want)
            ]
            updated.status.volumes_in_use = sorted(want)
            try:
                self.client.nodes.update_status(updated)
            except Exception:  # noqa: BLE001 — conflict: next tick retries
                pass
