"""PVC and PV protection controllers.

Reference: pkg/controller/volume/pvcprotection/pvc_protection_controller.go
and pvprotection/pv_protection_controller.go — add the protection
finalizer to every live object so deletion is soft (deletionTimestamp)
while in use; remove the finalizer once nothing consumes it:
  PVC: in use while any non-terminated pod references it (:172 isBeingUsed);
  PV: in use while bound to a claim (:126).
"""

from __future__ import annotations

import copy

from ..client.informer import EventHandler, meta_namespace_key
from .base import Controller

PVC_PROTECTION_FINALIZER = "kubernetes.io/pvc-protection"
PV_PROTECTION_FINALIZER = "kubernetes.io/pv-protection"


class PVCProtectionController(Controller):
    name = "pvc-protection"

    def __init__(self, clientset, informer_factory):
        super().__init__(workers=1)
        self.client = clientset
        self.pvc_informer = informer_factory.informer_for("persistentvolumeclaims")
        self.pod_informer = informer_factory.informer_for("pods")
        self.pvc_informer.add_event_handler(EventHandler(
            on_add=lambda pvc: self.enqueue(meta_namespace_key(pvc)),
            on_update=lambda old, new: self.enqueue(meta_namespace_key(new)),
        ))
        # pod deletions can unblock a pending PVC delete
        self.pod_informer.add_event_handler(EventHandler(
            on_delete=self._on_pod_change,
            on_update=lambda old, new: self._on_pod_change(new),
        ))

    def _on_pod_change(self, pod) -> None:
        for vol in pod.spec.volumes or []:
            claim = (vol.source or {}).get("persistentVolumeClaim")
            if claim:
                self.enqueue(
                    f"{pod.metadata.namespace}/{claim.get('claimName', '')}"
                )

    def _in_use(self, namespace: str, name: str) -> bool:
        for pod in self.pod_informer.list():
            if pod.metadata.namespace != namespace:
                continue
            if pod.status.phase in ("Succeeded", "Failed"):
                continue
            for vol in pod.spec.volumes or []:
                claim = (vol.source or {}).get("persistentVolumeClaim")
                if claim and claim.get("claimName") == name:
                    return True
        return False

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        pvc = self.pvc_informer.get(key)
        if pvc is None:
            return
        fins = list(pvc.metadata.finalizers or [])
        if pvc.metadata.deletion_timestamp is None:
            if PVC_PROTECTION_FINALIZER not in fins:
                updated = copy.deepcopy(pvc)
                updated.metadata.finalizers = fins + [PVC_PROTECTION_FINALIZER]
                self.client.persistentvolumeclaims.update(updated)
            return
        if PVC_PROTECTION_FINALIZER in fins and not self._in_use(namespace, name):
            self.client.api.remove_finalizer(
                "persistentvolumeclaims", name, namespace,
                PVC_PROTECTION_FINALIZER,
            )
        elif PVC_PROTECTION_FINALIZER in fins:
            # still consumed: poll until the blocking pod goes away
            self.enqueue_after(key, 1.0)


class PVProtectionController(Controller):
    name = "pv-protection"

    def __init__(self, clientset, informer_factory):
        super().__init__(workers=1)
        self.client = clientset
        self.pv_informer = informer_factory.informer_for("persistentvolumes")
        self.pv_informer.add_event_handler(EventHandler(
            on_add=lambda pv: self.enqueue(pv.metadata.name),
            on_update=lambda old, new: self.enqueue(new.metadata.name),
        ))

    def sync(self, key: str) -> None:
        pv = self.pv_informer.get(key)
        if pv is None:
            return
        fins = list(pv.metadata.finalizers or [])
        if pv.metadata.deletion_timestamp is None:
            if PV_PROTECTION_FINALIZER not in fins:
                updated = copy.deepcopy(pv)
                updated.metadata.finalizers = fins + [PV_PROTECTION_FINALIZER]
                self.client.persistentvolumes.update(updated)
            return
        bound = bool(pv.spec.claim_ref_name)
        if PV_PROTECTION_FINALIZER in fins and not bound:
            self.client.api.remove_finalizer(
                "persistentvolumes", key, "", PV_PROTECTION_FINALIZER
            )
        elif PV_PROTECTION_FINALIZER in fins:
            self.enqueue_after(key, 1.0)
