"""Volume filter plugins: VolumeRestrictions, VolumeZone, NodeVolumeLimits.

Reference:
  pkg/scheduler/framework/plugins/volumerestrictions/volume_restrictions.go
    (GCE-PD / AWS-EBS / ISCSI / RBD read-write disk conflicts),
  pkg/scheduler/framework/plugins/volumezone/volume_zone.go
    (bound PV zone/region labels must match the node's),
  pkg/scheduler/framework/plugins/nodevolumelimits/{csi.go,non_csi.go}
    (per-node attachable-volume count limits from CSINode allocatable).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ...api import types as v1
from ..framework import interface as fwk
from ..framework.interface import CycleState, Status

# ---------------------------------------------------------------------------
# VolumeRestrictions


def _disk_conflict_key(src: dict) -> Optional[Tuple[str, str, bool]]:
    """(kind, disk identity, read_only) for conflict-checkable sources."""
    if "gcePersistentDisk" in src:
        d = src["gcePersistentDisk"]
        return ("gce", d.get("pdName", ""), bool(d.get("readOnly", False)))
    if "awsElasticBlockStore" in src:
        d = src["awsElasticBlockStore"]
        # EBS volumes never allow multi-attach, read-only or not
        # (volume_restrictions.go isVolumeConflict AWS branch).
        return ("aws", d.get("volumeID", ""), False)
    if "iscsi" in src:
        d = src["iscsi"]
        ident = f"{d.get('targetPortal', '')}/{d.get('iqn', '')}/{d.get('lun', '')}"
        return ("iscsi", ident, bool(d.get("readOnly", False)))
    if "rbd" in src:
        d = src["rbd"]
        mons = ",".join(sorted(d.get("monitors", [])))
        ident = f"{mons}/{d.get('pool', '')}/{d.get('image', '')}"
        return ("rbd", ident, bool(d.get("readOnly", False)))
    return None


class VolumeRestrictions(fwk.FilterPlugin):
    """volume_restrictions.go: a pod may not mount a disk another pod on the
    node already mounts, unless both mounts are read-only (GCE/ISCSI/RBD);
    AWS EBS conflicts unconditionally."""

    name = "VolumeRestrictions"
    ERR_REASON_DISK_CONFLICT = "node(s) had no available disk"

    def __init__(self, args=None, handle=None):
        pass

    def filter(self, state: CycleState, pod: v1.Pod, node_info) -> Optional[Status]:
        my = [k for vol in pod.spec.volumes or [] if (k := _disk_conflict_key(vol.source or {}))]
        if not my:
            return None
        for pi in node_info.pods:
            for vol in pi.pod.spec.volumes or []:
                existing = _disk_conflict_key(vol.source or {})
                if existing is None:
                    continue
                for mine in my:
                    if mine[0] == existing[0] and mine[1] == existing[1]:
                        if not (mine[2] and existing[2]):
                            return Status.unschedulable(self.ERR_REASON_DISK_CONFLICT)
        return None


# ---------------------------------------------------------------------------
# VolumeZone

_ZONE_LABELS = (
    v1.LABEL_ZONE,
    v1.LABEL_REGION,
    v1.LABEL_ZONE_LEGACY,
    v1.LABEL_REGION_LEGACY,
)


_ZONE_STATE_KEY = "PreFilterVolumeZone"


class VolumeZone(fwk.PreFilterPlugin, fwk.FilterPlugin):
    """volume_zone.go: for each PVC bound to a PV carrying zone/region
    labels, the node must carry a matching label (multi-zone values are
    '__'-joined sets in the reference; we accept comma- or '__'-separated).

    The pod's zone constraints are resolved ONCE in PreFilter (one pass
    over the PVC/PV caches); Filter is then a per-node label check."""

    name = "VolumeZone"
    ERR_REASON_CONFLICT = "node(s) had volume zone conflict"

    def __init__(self, args=None, handle=None):
        self._handle = handle

    def _listers(self):
        h = self._handle
        if h is None or getattr(h, "volume_listers", None) is None:
            return None
        return h.volume_listers  # (list_pvcs, list_pvs)

    def _constraints(self, pod: v1.Pod) -> List[Tuple[str, Set[str]]]:
        """[(zone label key, allowed values)] from the pod's bound PVs."""
        listers = self._listers()
        if listers is None:
            return []
        list_pvcs, list_pvs = listers
        wanted = {
            (vol.source or {}).get("persistentVolumeClaim", {}).get("claimName", "")
            for vol in pod.spec.volumes or []
            if (vol.source or {}).get("persistentVolumeClaim")
        }
        if not wanted:
            return []
        pvcs = {
            c.metadata.name: c
            for c in list_pvcs()
            if c.metadata.namespace == pod.metadata.namespace
            and c.metadata.name in wanted
        }
        volume_names = {
            c.spec.volume_name for c in pvcs.values() if c.spec.volume_name
        }
        out: List[Tuple[str, Set[str]]] = []
        for pv in list_pvs():
            if pv.metadata.name not in volume_names:
                continue
            for key, value in (pv.metadata.labels or {}).items():
                if key in _ZONE_LABELS:
                    out.append((key, set(value.replace("__", ",").split(","))))
        return out

    def pre_filter(self, state: CycleState, pod: v1.Pod) -> Optional[Status]:
        state.write(_ZONE_STATE_KEY, self._constraints(pod))
        return None

    def filter(self, state: CycleState, pod: v1.Pod, node_info) -> Optional[Status]:
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        try:
            constraints = state.read(_ZONE_STATE_KEY)
        except KeyError:
            constraints = self._constraints(pod)  # direct Filter call (tests)
        if not constraints:
            return None
        node_labels = node.metadata.labels or {}
        if not any(k in node_labels for k in _ZONE_LABELS):
            return None
        for key, allowed in constraints:
            # a node with SOME zone labels but missing this one conflicts
            # (volume_zone.go: !ok → unschedulable)
            if node_labels.get(key) not in allowed:
                return Status.unschedulable(self.ERR_REASON_CONFLICT)
        return None


# ---------------------------------------------------------------------------
# NodeVolumeLimits (CSI + in-tree)

# Default per-node attach limits for in-tree drivers when no CSINode
# allocatable is published (non_csi.go DefaultMaxEBSVolumes etc.).
DEFAULT_LIMITS = {"ebs.csi.aws.com": 39, "pd.csi.storage.gke.io": 16, "disk.csi.azure.com": 16}
_INTREE_TO_CSI = {
    "awsElasticBlockStore": "ebs.csi.aws.com",
    "gcePersistentDisk": "pd.csi.storage.gke.io",
    "azureDisk": "disk.csi.azure.com",
}


def _csi_volumes_of(pod: v1.Pod, pvc_to_driver) -> Dict[str, Set[str]]:
    """driver -> set of volume identities used by this pod."""
    out: Dict[str, Set[str]] = {}
    for vol in pod.spec.volumes or []:
        src = vol.source or {}
        if "csi" in src:
            drv = src["csi"].get("driver", "")
            ident = src["csi"].get("volumeHandle", vol.name)
            out.setdefault(drv, set()).add(ident)
            continue
        for key, drv in _INTREE_TO_CSI.items():
            if key in src:
                ident = src[key].get("pdName") or src[key].get("volumeID") or src[key].get("diskName") or vol.name
                out.setdefault(drv, set()).add(ident)
        pvc_src = src.get("persistentVolumeClaim")
        if pvc_src and pvc_to_driver is not None:
            hit = pvc_to_driver(pod.metadata.namespace, pvc_src.get("claimName", ""))
            if hit:
                drv, ident = hit
                out.setdefault(drv, set()).add(ident)
    return out


class NodeVolumeLimits(fwk.PreFilterPlugin, fwk.FilterPlugin):
    """csi.go CSILimits: Σ attached volumes per driver on the node + the
    pod's new volumes must stay within CSINode allocatable (or the in-tree
    default limit).

    The pod's own volume set and the PVC→driver lookup are computed ONCE in
    PreFilter; Filter does per-node counting only."""

    name = "NodeVolumeLimits"
    ERR_REASON = "node(s) exceed max volume count"
    # Subclasses (EBSLimits/GCEPDLimits/AzureDiskLimits) restrict counting
    # to their own driver, like the reference's per-cloud non_csi.go plugins.
    only_driver: Optional[str] = None

    def __init__(self, args=None, handle=None):
        self._handle = handle

    @property
    def _state_key(self) -> str:
        return f"PreFilter{self.name}"

    def pre_filter(self, state: CycleState, pod: v1.Pod) -> Optional[Status]:
        state.write(self._state_key, self._precompute(pod))
        return None

    def _precompute(self, pod: v1.Pod):
        pvc_to_driver = self._pvc_to_driver()
        new_vols = _csi_volumes_of(pod, pvc_to_driver)
        if self.only_driver is not None:
            new_vols = {d: v for d, v in new_vols.items() if d == self.only_driver}
        return new_vols, pvc_to_driver

    def _limits_for(self, node_name: str) -> Dict[str, int]:
        h = self._handle
        limits = dict(DEFAULT_LIMITS)
        if h is not None and getattr(h, "csi_node_lister", None) is not None:
            for cn in h.csi_node_lister():
                if cn.metadata.name != node_name:
                    continue
                for drv in cn.spec.drivers or []:
                    if drv.count is not None:
                        limits[drv.name] = drv.count
        return limits

    def _pvc_to_driver(self):
        h = self._handle
        if h is None or getattr(h, "volume_listers", None) is None:
            return None
        list_pvcs, list_pvs = h.volume_listers
        pvcs = {(c.metadata.namespace, c.metadata.name): c for c in list_pvcs()}
        pvs = {p.metadata.name: p for p in list_pvs()}

        def lookup(namespace: str, name: str):
            claim = pvcs.get((namespace, name))
            if claim is None or not claim.spec.volume_name:
                return None
            pv = pvs.get(claim.spec.volume_name)
            if pv is None:
                return None
            # translation-aware (csi-translation-lib): a migrated
            # in-tree PV counts against its CSI driver's limit
            from ...volume.csi_translation import pv_csi_source

            csi = pv_csi_source(pv)
            if isinstance(csi, dict):
                return csi.get("driver", ""), csi.get("volumeHandle", pv.metadata.name)
            return None

        return lookup

    def filter(self, state: CycleState, pod: v1.Pod, node_info) -> Optional[Status]:
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        try:
            new_vols, pvc_to_driver = state.read(self._state_key)
        except KeyError:
            new_vols, pvc_to_driver = self._precompute(pod)
        if not new_vols:
            return None
        limits = self._limits_for(node.metadata.name)
        in_use: Dict[str, Set[str]] = {}
        for pi in node_info.pods:
            for drv, idents in _csi_volumes_of(pi.pod, pvc_to_driver).items():
                in_use.setdefault(drv, set()).update(idents)
        for drv, idents in new_vols.items():
            limit = limits.get(drv)
            if limit is None:
                continue
            total = len(in_use.get(drv, set()) | idents)
            if total > limit:
                return Status.unschedulable(self.ERR_REASON)
        return None
