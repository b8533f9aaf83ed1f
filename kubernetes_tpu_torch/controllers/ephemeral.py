"""Generic ephemeral volume controller.

Reference: pkg/controller/volume/ephemeral/controller.go — for every pod
volume with an `ephemeral` source, ensure a PVC named `<pod>-<volume>`
exists, owned by the pod (so its lifecycle tracks the pod's), with the
spec from the volume's volumeClaimTemplate (:192 handleVolume). A
pre-existing PVC NOT owned by the pod is a conflict the controller
refuses to adopt (:213).
"""

from __future__ import annotations

from ..api import types as v1
from ..apiserver.server import AlreadyExists, NotFound
from ..client.informer import EventHandler, meta_namespace_key
from ..utils import serde
from .base import Controller, controller_ref


def ephemeral_claim_name(pod_name: str, volume_name: str) -> str:
    return f"{pod_name}-{volume_name}"


class EphemeralVolumeController(Controller):
    name = "ephemeral-volume"

    def __init__(self, clientset, informer_factory, workers: int = 1):
        super().__init__(workers=workers)
        self.client = clientset
        self.pod_informer = informer_factory.informer_for("pods")
        self.pvc_informer = informer_factory.informer_for(
            "persistentvolumeclaims"
        )
        self.pod_informer.add_event_handler(EventHandler(
            on_add=self._on_pod, on_update=lambda o, n: self._on_pod(n),
        ))

    def _on_pod(self, pod: v1.Pod) -> None:
        if any((vol.source or {}).get("ephemeral")
               for vol in pod.spec.volumes or []):
            self.enqueue(meta_namespace_key(pod))

    def sync(self, key: str) -> None:
        pod = self.pod_informer.get(key)
        if pod is None or pod.metadata.deletion_timestamp is not None:
            return
        for vol in pod.spec.volumes or []:
            eph = (vol.source or {}).get("ephemeral")
            if not eph:
                continue
            claim_name = ephemeral_claim_name(pod.metadata.name, vol.name)
            existing = self.pvc_informer.get(
                f"{pod.metadata.namespace}/{claim_name}"
            )
            if existing is not None:
                refs = existing.metadata.owner_references or []
                if not any(r.uid == pod.metadata.uid for r in refs):
                    raise RuntimeError(
                        f"PVC {claim_name!r} was not created for pod "
                        f"{pod.metadata.name!r} (conflict)"
                    )
                continue
            template = (eph or {}).get("volumeClaimTemplate", {})
            spec_dict = template.get("spec", {})
            pvc = v1.PersistentVolumeClaim(
                metadata=v1.ObjectMeta(
                    name=claim_name,
                    namespace=pod.metadata.namespace,
                    labels=dict(
                        (template.get("metadata", {}) or {}).get("labels", {})
                    ) or None,
                    owner_references=[controller_ref(pod, "Pod")],
                ),
                spec=serde.from_dict(v1.PersistentVolumeClaimSpec, spec_dict),
            )
            try:
                self.client.persistentvolumeclaims.create(pvc)
            except AlreadyExists:
                pass


class ExpandController(Controller):
    """persistentvolume-expander (pkg/controller/volume/expand): when a
    bound PVC's requested storage exceeds its granted capacity and the
    StorageClass allows expansion, grow the PV and record the new
    capacity in the PVC status (in-tree expand without a resizer
    sidecar; expand_controller.go)."""

    name = "persistentvolume-expander"

    def __init__(self, clientset, informer_factory, workers: int = 1):
        super().__init__(workers=workers)
        self.client = clientset
        self.pvc_informer = informer_factory.informer_for(
            "persistentvolumeclaims"
        )
        self.pv_informer = informer_factory.informer_for("persistentvolumes")
        self.sc_informer = informer_factory.informer_for("storageclasses")
        self.pvc_informer.add_event_handler(EventHandler(
            on_add=lambda c: self.enqueue(meta_namespace_key(c)),
            on_update=lambda o, n: self.enqueue(meta_namespace_key(n)),
        ))

    def sync(self, key: str) -> None:
        from ..api.quantity import Quantity

        pvc = self.pvc_informer.get(key)
        if pvc is None or pvc.status.phase != "Bound" or \
                not pvc.spec.volume_name:
            return
        want_s = (pvc.spec.resources.requests or {}).get("storage")
        if not want_s:
            return
        have_s = (pvc.status.capacity or {}).get("storage", "0")
        want, have = Quantity(want_s).value(), Quantity(have_s).value()
        if want <= have:
            return
        sc_name = pvc.spec.storage_class_name or ""
        sc = self.sc_informer.get(sc_name) if sc_name else None
        if sc is None or not sc.allow_volume_expansion:
            return
        pv = self.pv_informer.get(pvc.spec.volume_name)
        if pv is None:
            return
        # grow the PV capacity, then publish it on the claim status —
        # the reference's markForExpansion + updatePVCapacity flow
        try:
            fresh_pv = self.client.persistentvolumes.get(pv.metadata.name)
            caps = dict(fresh_pv.spec.capacity or {})
            if Quantity(caps.get("storage", "0")).value() < want:
                caps["storage"] = want_s
                fresh_pv.spec.capacity = caps
                self.client.persistentvolumes.update(fresh_pv)
        except NotFound:
            return
        fresh = self.client.persistentvolumeclaims.get(
            pvc.metadata.name, pvc.metadata.namespace
        )
        fresh.status.capacity = dict(fresh.status.capacity or {})
        fresh.status.capacity["storage"] = want_s
        self.client.persistentvolumeclaims.update_status(fresh)
