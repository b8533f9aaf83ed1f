"""PersistentVolume binder controller.

Reference: pkg/controller/volume/persistentvolume/pv_controller.go —
syncUnboundClaim (find + bind a matching PV for immediate-mode claims, or
dynamically provision), syncBoundClaim, and volume reclaim
(syncVolume: Released → Delete/Retain by reclaim policy). WaitForFirst-
Consumer claims are skipped until the scheduler's VolumeBinding plugin
annotates/binds them (scheduler_binder.go owns that path in this build).
"""

from __future__ import annotations

import copy

from ..api import types as v1
from ..api.storage import PROVISIONER_NO_PROVISIONER
from ..client.informer import EventHandler
from ..volume.binder import find_matching_volume
from .base import Controller


class PersistentVolumeController(Controller):
    name = "persistentvolume-binder"

    def __init__(self, clientset, informer_factory, workers: int = 2):
        super().__init__(workers=workers)
        self.client = clientset
        self.pvc_informer = informer_factory.informer_for("persistentvolumeclaims")
        self.pv_informer = informer_factory.informer_for("persistentvolumes")
        self.sc_informer = informer_factory.informer_for("storageclasses")
        self.pvc_informer.add_event_handler(
            EventHandler(
                on_add=lambda c: self.enqueue(self._claim_key(c)),
                on_update=lambda o, n: self.enqueue(self._claim_key(n)),
                # a deleted claim releases its PV (syncVolume reclaim path)
                on_delete=lambda c: self.enqueue(f"pv/{c.spec.volume_name}")
                if c.spec.volume_name
                else None,
            )
        )
        self.pv_informer.add_event_handler(
            EventHandler(
                on_add=lambda p: self.enqueue(f"pv/{p.metadata.name}"),
                on_update=lambda o, n: self.enqueue(f"pv/{n.metadata.name}"),
                on_delete=lambda p: self.enqueue(f"pv/{p.metadata.name}"),
            )
        )

    @staticmethod
    def _claim_key(claim) -> str:
        return f"pvc/{claim.metadata.namespace}/{claim.metadata.name}"

    def _get_class(self, name: str):
        for sc in self.sc_informer.list():
            if sc.metadata.name == name:
                return sc
        return None

    def sync(self, key: str) -> None:
        kind, _, rest = key.partition("/")
        if kind == "pvc":
            namespace, _, name = rest.partition("/")
            self._sync_claim(namespace, name)
        else:
            self._sync_volume(rest)

    # -- syncUnboundClaim (pv_controller.go:330) ---------------------------

    def _sync_claim(self, namespace: str, name: str) -> None:
        claim = self.pvc_informer.get(f"{namespace}/{name}")
        if claim is None or claim.spec.volume_name:
            return
        sc = self._get_class(claim.spec.storage_class_name or "")
        delayed = sc is not None and sc.volume_binding_mode == "WaitForFirstConsumer"
        if delayed:
            # WaitForFirstConsumer claims belong to the scheduler's
            # VolumeBinding plugin end to end in this build (it matches,
            # assumes, and provisions at PreBind); touching them here would
            # race the binder and could pick a topology-incompatible PV.
            return
        # A PV already claim_ref'd to this claim (half-finished bind) wins
        # over fresh matching (syncUnboundClaim's pre-bound-volume path).
        pvs = self.pv_informer.list()
        pv = next(
            (
                p
                for p in pvs
                if p.spec.claim_ref_namespace == claim.metadata.namespace
                and p.spec.claim_ref_name == claim.metadata.name
            ),
            None,
        ) or find_matching_volume(claim, pvs)
        if pv is not None:
            self._bind(claim, pv)
            return
        if sc is not None and sc.provisioner and sc.provisioner != PROVISIONER_NO_PROVISIONER:
            self._provision(claim, sc, None)
        else:
            # stay Pending; retry when PVs change
            live = copy.deepcopy(claim)
            if live.status.phase != "Pending":
                live.status.phase = "Pending"
                self.client.persistentvolumeclaims.update(live)

    def _bind(self, claim, pv) -> None:
        live_pv = self.client.persistentvolumes.get(pv.metadata.name)
        if live_pv.spec.claim_ref_name and (
            live_pv.spec.claim_ref_namespace != claim.metadata.namespace
            or live_pv.spec.claim_ref_name != claim.metadata.name
        ):
            return  # raced with another claim; requeue via the PV update event
        # claim_ref may already point at THIS claim: a previous sync updated
        # the PV but crashed before the claim write — finish the half-bind
        # (pv_controller syncUnboundClaim's pre-bound-volume path).
        if not live_pv.spec.claim_ref_name:
            live_pv.spec.claim_ref_namespace = claim.metadata.namespace
            live_pv.spec.claim_ref_name = claim.metadata.name
            live_pv.status.phase = "Bound"
            self.client.persistentvolumes.update(live_pv)
        live_claim = self.client.persistentvolumeclaims.get(
            claim.metadata.name, claim.metadata.namespace
        )
        live_claim.spec.volume_name = live_pv.metadata.name
        live_claim.status.phase = "Bound"
        self.client.persistentvolumeclaims.update(live_claim)

    def _provision(self, claim, sc, selected_node) -> None:
        node_affinity = None
        if selected_node:
            node_affinity = v1.VolumeNodeAffinity(
                required=v1.NodeSelector(
                    node_selector_terms=[
                        v1.NodeSelectorTerm(
                            match_expressions=[
                                v1.NodeSelectorRequirement(
                                    key=v1.LABEL_HOSTNAME,
                                    operator="In",
                                    values=[selected_node],
                                )
                            ]
                        )
                    ]
                )
            )
        pv = v1.PersistentVolume(
            metadata=v1.ObjectMeta(
                name=f"pvc-{claim.metadata.uid or claim.metadata.name}"
            ),
            spec=v1.PersistentVolumeSpec(
                capacity={
                    "storage": (claim.spec.resources.requests or {}).get("storage", "0")
                },
                access_modes=list(claim.spec.access_modes or []),
                storage_class_name=claim.spec.storage_class_name or "",
                claim_ref_namespace=claim.metadata.namespace,
                claim_ref_name=claim.metadata.name,
                node_affinity=node_affinity,
                persistent_volume_reclaim_policy=sc.reclaim_policy,
            ),
            status=v1.PersistentVolumeStatus(phase="Bound"),
        )
        try:
            pv = self.client.persistentvolumes.create(pv)
        except Exception:  # noqa: BLE001 — already provisioned by a racer
            pv = self.client.persistentvolumes.get(pv.metadata.name)
        live_claim = self.client.persistentvolumeclaims.get(
            claim.metadata.name, claim.metadata.namespace
        )
        if not live_claim.spec.volume_name:
            live_claim.spec.volume_name = pv.metadata.name
            live_claim.status.phase = "Bound"
            self.client.persistentvolumeclaims.update(live_claim)

    # -- syncVolume reclaim (pv_controller.go:540) -------------------------

    def _sync_volume(self, name: str) -> None:
        pv = self.pv_informer.get(name)
        if pv is None:
            return
        if not pv.spec.claim_ref_name:
            if pv.status.phase not in ("Available", "Released", "Failed"):
                live = copy.deepcopy(pv)
                live.status.phase = "Available"
                self.client.persistentvolumes.update(live)
            return
        claim = self.pvc_informer.get(
            f"{pv.spec.claim_ref_namespace}/{pv.spec.claim_ref_name}"
        )
        if claim is not None:
            return  # bound and claim exists: nothing to do
        # claim is gone → Released, then reclaim
        policy = pv.spec.persistent_volume_reclaim_policy or "Retain"
        if policy == "Delete":
            self.client.persistentvolumes.delete(pv.metadata.name)
        elif pv.status.phase != "Released":
            live = copy.deepcopy(pv)
            live.status.phase = "Released"
            self.client.persistentvolumes.update(live)
