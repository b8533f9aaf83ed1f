"""Scheduler volume binder: the VolumeBinding plugin's engine.

Reference: pkg/controller/volume/scheduling/scheduler_binder.go —
GetPodVolumes (claim triage), FindPodVolumes (per-node feasibility),
AssumePodVolumes (optimistic PV reservation), BindPodVolumes (API
writes at PreBind), RevertAssumedPodVolumes; PV matching semantics from
pkg/controller/volume/persistentvolume/index.go findBestMatchForClaim.

Design notes (TPU build): the binder is pure host-side control logic —
it never touches the device. It reads cluster state through injected
lister callables (informer caches in production, plain lists in tests)
and keeps a small in-memory assume cache of PV-name→claim reservations so
concurrent scheduling cycles don't hand the same Available PV to two
pods. Dynamic provisioning is performed in-process at bind time
(the reference defers to an external provisioner and polls; we are the
provisioner, which keeps PreBind deterministic).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..api import types as v1
from ..api.labels import match_node_selector_terms, node_fields
from ..api.quantity import parse_quantity
from ..api.storage import PROVISIONER_NO_PROVISIONER, StorageClass

# FindPodVolumes conflict reasons (scheduler_binder.go:52-58)
ERR_REASON_BIND_CONFLICT = "node(s) didn't find available persistent volumes to bind"
ERR_REASON_NODE_CONFLICT = "node(s) had volume node affinity conflict"

# PVC annotation naming the node chosen by the scheduler, consumed by the
# provisioner (pv_controller annSelectedNode).
ANN_SELECTED_NODE = "volume.kubernetes.io/selected-node"


@dataclass
class PodVolumes:
    """Per-(pod,node) binding decision (scheduler_binder.go PodVolumes)."""

    static_bindings: List[Tuple[v1.PersistentVolume, v1.PersistentVolumeClaim]] = field(
        default_factory=list
    )
    dynamic_provisions: List[v1.PersistentVolumeClaim] = field(default_factory=list)


def _claim_request_bytes(claim: v1.PersistentVolumeClaim) -> int:
    req = (claim.spec.resources.requests or {}).get("storage", "0")
    return int(parse_quantity(req))


def _pv_capacity_bytes(pv: v1.PersistentVolume) -> int:
    cap = (pv.spec.capacity or {}).get("storage", "0")
    return int(parse_quantity(cap))


def _class_name(claim: v1.PersistentVolumeClaim) -> str:
    return claim.spec.storage_class_name or ""


def pv_node_affinity_matches(pv: v1.PersistentVolume, node: v1.Node) -> bool:
    """volume_host.go CheckNodeAffinity: nil affinity matches every node."""
    aff = pv.spec.node_affinity
    if aff is None or aff.required is None:
        return True
    return match_node_selector_terms(
        aff.required.node_selector_terms, node.metadata.labels or {}, node_fields(node)
    )


def _access_modes_contained(requested: Sequence[str], offered: Sequence[str]) -> bool:
    return all(m in (offered or []) for m in (requested or []))


def pv_matches_claim(
    pv: v1.PersistentVolume,
    claim: v1.PersistentVolumeClaim,
    node: Optional[v1.Node] = None,
) -> bool:
    """Static-binding compatibility (index.go findMatchingVolume per-PV checks)."""
    if pv.status.phase != "Available":
        return False
    if pv.spec.claim_ref_name:
        return False
    if (pv.spec.storage_class_name or "") != _class_name(claim):
        return False
    if not _access_modes_contained(claim.spec.access_modes, pv.spec.access_modes):
        return False
    if _pv_capacity_bytes(pv) < _claim_request_bytes(claim):
        return False
    if node is not None and not pv_node_affinity_matches(pv, node):
        return False
    return True


def find_matching_volume(
    claim: v1.PersistentVolumeClaim,
    pvs: Sequence[v1.PersistentVolume],
    node: Optional[v1.Node] = None,
    excluded: Optional[set] = None,
) -> Optional[v1.PersistentVolume]:
    """Smallest Available PV that satisfies the claim
    (index.go findBestMatchForClaim's smallest-first ordering)."""
    best = None
    best_cap = None
    for pv in pvs:
        if excluded and pv.metadata.name in excluded:
            continue
        if not pv_matches_claim(pv, claim, node):
            continue
        cap = _pv_capacity_bytes(pv)
        if best is None or cap < best_cap:
            best, best_cap = pv, cap
    return best


def _storage_class_topology_matches(sc: StorageClass, node: v1.Node) -> bool:
    """AllowedTopologies gate for dynamic provisioning
    (scheduler_binder.go checkVolumeProvisions → AllowedTopologies)."""
    if not sc.allowed_topologies:
        return True
    labels = node.metadata.labels or {}
    for term in sc.allowed_topologies:
        exprs = term.get("matchLabelExpressions", [])
        if all(labels.get(e["key"]) in e.get("values", []) for e in exprs):
            return True
    return False


class SchedulerVolumeBinder:
    """scheduler_binder.go volumeBinder, informer-cache backed."""

    def __init__(
        self,
        list_pvcs: Callable[[], List[v1.PersistentVolumeClaim]],
        list_pvs: Callable[[], List[v1.PersistentVolume]],
        list_storage_classes: Callable[[], List[StorageClass]],
        client=None,
        bind_timeout: float = 10.0,
        get_pvc: Optional[Callable[[str], Any]] = None,
    ):
        self._list_pvcs = list_pvcs
        self._list_pvs = list_pvs
        self._list_classes = list_storage_classes
        self._client = client
        self._bind_timeout = bind_timeout
        # keyed 'namespace/name' lookup (the informer store's own get):
        # a full list scan per lookup ran at Reserve AND PreBind per pod
        # — O(pods x PVCs) made the 5000-node PV workload binder-bound
        self._keyed_get_pvc = get_pvc
        self._lock = threading.Lock()
        # pv name -> (claim namespace, claim name) optimistic reservations
        self._assumed: Dict[str, Tuple[str, str]] = {}

    # -- lookups -----------------------------------------------------------

    def _get_pvc(self, namespace: str, name: str) -> Optional[v1.PersistentVolumeClaim]:
        if self._keyed_get_pvc is not None:
            return self._keyed_get_pvc(
                f"{namespace}/{name}" if namespace else name
            )
        for c in self._list_pvcs():
            if c.metadata.namespace == namespace and c.metadata.name == name:
                return c
        return None

    def _get_class(self, name: str) -> Optional[StorageClass]:
        for sc in self._list_classes():
            if sc.metadata.name == name:
                return sc
        return None

    # -- GetPodVolumes (scheduler_binder.go:280 GetPodVolumes) -------------

    def get_pod_volumes(
        self, pod: v1.Pod
    ) -> Tuple[
        List[v1.PersistentVolumeClaim],  # bound
        List[v1.PersistentVolumeClaim],  # to bind (delayed)
        List[v1.PersistentVolumeClaim],  # unbound immediate (blocks scheduling)
        List[str],  # missing claim names (unresolvable)
    ]:
        bound, to_bind, immediate, missing = [], [], [], []
        for vol in pod.spec.volumes or []:
            src = vol.source or {}
            pvc_src = src.get("persistentVolumeClaim")
            if not pvc_src:
                continue
            claim = self._get_pvc(pod.metadata.namespace, pvc_src.get("claimName", ""))
            if claim is None:
                missing.append(pvc_src.get("claimName", ""))
                continue
            if claim.spec.volume_name:
                bound.append(claim)
                continue
            sc = self._get_class(_class_name(claim))
            if sc is not None and sc.volume_binding_mode == "WaitForFirstConsumer":
                to_bind.append(claim)
            else:
                immediate.append(claim)
        return bound, to_bind, immediate, missing

    # -- FindPodVolumes (scheduler_binder.go:320) --------------------------

    def find_pod_volumes(
        self,
        pod: v1.Pod,
        bound_claims: List[v1.PersistentVolumeClaim],
        claims_to_bind: List[v1.PersistentVolumeClaim],
        node: v1.Node,
    ) -> Tuple[List[str], PodVolumes]:
        reasons: List[str] = []
        pod_volumes = PodVolumes()

        # Bound claims: the PV it's bound to must tolerate this node.
        if bound_claims:
            by_name = {pv.metadata.name: pv for pv in self._list_pvs()}
            for claim in bound_claims:
                pv = by_name.get(claim.spec.volume_name)
                if pv is None or not pv_node_affinity_matches(pv, node):
                    reasons.append(ERR_REASON_NODE_CONFLICT)
                    return reasons, pod_volumes

        # Unbound delayed claims: match a PV or check provisionability.
        if claims_to_bind:
            with self._lock:
                assumed = set(self._assumed)
            chosen: set = set()
            pvs = self._list_pvs()
            for claim in claims_to_bind:
                pv = find_matching_volume(claim, pvs, node, excluded=assumed | chosen)
                if pv is not None:
                    chosen.add(pv.metadata.name)
                    pod_volumes.static_bindings.append((pv, claim))
                    continue
                sc = self._get_class(_class_name(claim))
                if (
                    sc is not None
                    and sc.provisioner
                    and sc.provisioner != PROVISIONER_NO_PROVISIONER
                    and _storage_class_topology_matches(sc, node)
                ):
                    pod_volumes.dynamic_provisions.append(claim)
                    continue
                reasons.append(ERR_REASON_BIND_CONFLICT)
                return reasons, PodVolumes()
        return reasons, pod_volumes

    # -- AssumePodVolumes (scheduler_binder.go:389) ------------------------

    def assume_pod_volumes(self, pod: v1.Pod, pod_volumes: PodVolumes) -> bool:
        """Reserve the chosen PVs; returns all_fully_bound."""
        if not pod_volumes.static_bindings and not pod_volumes.dynamic_provisions:
            return True
        with self._lock:
            for pv, claim in pod_volumes.static_bindings:
                self._assumed[pv.metadata.name] = (
                    claim.metadata.namespace,
                    claim.metadata.name,
                )
        return False

    def revert_assumed_pod_volumes(self, pod_volumes: PodVolumes) -> None:
        with self._lock:
            for pv, _claim in pod_volumes.static_bindings:
                self._assumed.pop(pv.metadata.name, None)

    # -- BindPodVolumes (scheduler_binder.go:439) --------------------------

    def bind_pod_volumes(
        self, pod: v1.Pod, node_name: str, pod_volumes: PodVolumes
    ) -> None:
        """Execute the binding via API writes (PreBind). Raises on failure."""
        if self._client is None:
            raise RuntimeError("volume binder has no API client; cannot bind")
        try:
            for pv, claim in pod_volumes.static_bindings:
                self._bind_claim_to_pv(claim, pv)
            for claim in pod_volumes.dynamic_provisions:
                self._provision(claim, node_name)
        finally:
            self.revert_assumed_pod_volumes(pod_volumes)

    def _bind_claim_to_pv(
        self, claim: v1.PersistentVolumeClaim, pv: v1.PersistentVolume
    ) -> None:
        cs = self._client
        live_pv = cs.persistentvolumes.get(pv.metadata.name)
        if live_pv.spec.claim_ref_name and (
            live_pv.spec.claim_ref_namespace != claim.metadata.namespace
            or live_pv.spec.claim_ref_name != claim.metadata.name
        ):
            raise RuntimeError(
                f"pv {pv.metadata.name} already bound to another claim"
            )
        live_pv.spec.claim_ref_namespace = claim.metadata.namespace
        live_pv.spec.claim_ref_name = claim.metadata.name
        live_pv.status.phase = "Bound"
        cs.persistentvolumes.update(live_pv)

        live_claim = cs.persistentvolumeclaims.get(
            claim.metadata.name, claim.metadata.namespace
        )
        live_claim.spec.volume_name = pv.metadata.name
        live_claim.status.phase = "Bound"
        cs.persistentvolumeclaims.update(live_claim)

    def _provision(self, claim: v1.PersistentVolumeClaim, node_name: str) -> None:
        """In-process dynamic provisioning: create a node-affine PV and bind.

        The reference annotates the claim with the selected node and waits
        for an external provisioner (scheduler_binder.go:560
        checkBindings poll); here the binder IS the provisioner.
        """
        cs = self._client
        sc = self._get_class(_class_name(claim))
        live_claim = cs.persistentvolumeclaims.get(
            claim.metadata.name, claim.metadata.namespace
        )
        anns = live_claim.metadata.annotations or {}
        anns[ANN_SELECTED_NODE] = node_name
        live_claim.metadata.annotations = anns
        live_claim = cs.persistentvolumeclaims.update(live_claim)

        pv = v1.PersistentVolume(
            metadata=v1.ObjectMeta(
                name=f"pvc-{live_claim.metadata.uid or live_claim.metadata.name}",
            ),
            spec=v1.PersistentVolumeSpec(
                capacity={
                    "storage": (live_claim.spec.resources.requests or {}).get(
                        "storage", "0"
                    )
                },
                access_modes=list(live_claim.spec.access_modes or []),
                storage_class_name=_class_name(live_claim),
                claim_ref_namespace=live_claim.metadata.namespace,
                claim_ref_name=live_claim.metadata.name,
                node_affinity=v1.VolumeNodeAffinity(
                    required=v1.NodeSelector(
                        node_selector_terms=[
                            v1.NodeSelectorTerm(
                                match_expressions=[
                                    v1.NodeSelectorRequirement(
                                        key=v1.LABEL_HOSTNAME,
                                        operator="In",
                                        values=[node_name],
                                    )
                                ]
                            )
                        ]
                    )
                ),
                persistent_volume_reclaim_policy=sc.reclaim_policy if sc else "Delete",
            ),
            status=v1.PersistentVolumeStatus(phase="Bound"),
        )
        pv = cs.persistentvolumes.create(pv)
        live_claim.spec.volume_name = pv.metadata.name
        live_claim.status.phase = "Bound"
        cs.persistentvolumeclaims.update(live_claim)
