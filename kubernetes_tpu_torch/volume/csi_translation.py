"""In-tree -> CSI volume translation (CSI migration).

Reference: staging/src/k8s.io/csi-translation-lib/translate.go:30
(CSITranslator) with the per-cloud plugins
(plugins/{gce_pd,aws_ebs,azure_disk}.go). The reference registers six
in-tree plugins; this build translates the three whose CSI drivers the
scheduler's attach-limit machinery models (DEFAULT_LIMITS /
_INTREE_TO_CSI in scheduler/plugins/volumes.py) — GCE PD, AWS EBS,
Azure Disk. The translation is consumed in two places:

  * VolumeDeviceResolver indexes PVs through `translate_pv` — a
    migratable in-tree PV reaches the kernel path as its CSI twin, so
    SchedulingMigratedInTreePVs rides the same attach-scalar +
    node-affinity machinery as native CSI PVs;
  * the oracle NodeVolumeLimits plugin's PVC->driver lookup uses
    `pv_csi_source`, so fast path and oracle can never disagree about
    a migrated PV's driver.

Topology (translateTopology, translate.go:209): the reference rewrites
zone/region labels into the CSI driver's own topology keys
(e.g. topology.gke.io/zone). This build's nodes carry the standard
kubernetes.io zone labels, so the translated PV keeps its zone labels
AND gains an explicit spec.node_affinity requirement on LABEL_ZONE —
semantically the reference's constraint expressed in the vocabulary the
kernel's node-affinity tables already understand.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

from ..api import types as v1

# in-tree PV spec field -> (CSI driver, identity field in the source)
IN_TREE_SOURCES: Dict[str, Tuple[str, str]] = {
    "gce_persistent_disk": ("pd.csi.storage.gke.io", "pdName"),
    "aws_elastic_block_store": ("ebs.csi.aws.com", "volumeID"),
    "azure_disk": ("disk.csi.azure.com", "diskName"),
}

_UNSPECIFIED = "UNSPECIFIED"  # gce_pd.go UnspecifiedValue


def migratable_plugin(pv: v1.PersistentVolume) -> Optional[str]:
    """The in-tree spec field this PV uses, or None (already CSI or no
    translatable source)."""
    if getattr(pv.spec, "csi", None):
        return None
    for field in IN_TREE_SOURCES:
        if getattr(pv.spec, field, None):
            return field
    return None


def _zones_of(pv: v1.PersistentVolume):
    from ..scheduler.plugins.volumes import _ZONE_LABELS

    for key, value in (pv.metadata.labels or {}).items():
        if key in _ZONE_LABELS and "zone" in key:
            # multi-zone labels join with __ (labelMultiZoneDelimiter)
            return sorted(set(value.replace("__", ",").split(",")))
    return []


def translate_pv(pv: v1.PersistentVolume) -> v1.PersistentVolume:
    """TranslateInTreePVToCSI: returns the PV itself when no translation
    applies, else a COPY with the in-tree source replaced by its CSI
    twin and the zone labels lifted into spec.node_affinity."""
    field = migratable_plugin(pv)
    if field is None:
        return pv
    driver, ident_key = IN_TREE_SOURCES[field]
    src = getattr(pv.spec, field) or {}
    name = src.get(ident_key) or pv.metadata.name
    zones = _zones_of(pv)
    if field == "gce_persistent_disk":
        # gce_pd.go volIDZonalFmt projects/U/zones/<zone|region>/disks/<pd>
        where = zones[0] if len(zones) == 1 else (
            _region_from_zones(zones) if zones else _UNSPECIFIED)
        handle = f"projects/{_UNSPECIFIED}/zones/{where}/disks/{name}"
    else:
        handle = name
    out = copy.deepcopy(pv)
    setattr(out.spec, field, None)
    out.spec.csi = {"driver": driver, "volumeHandle": handle}
    if zones and out.spec.node_affinity is None:
        # translateTopology: the zone constraint becomes an explicit
        # node-affinity requirement (expressed on the standard zone key
        # this build's nodes are labeled with)
        out.spec.node_affinity = v1.VolumeNodeAffinity(
            required=v1.NodeSelector(node_selector_terms=[
                v1.NodeSelectorTerm(match_expressions=[
                    v1.NodeSelectorRequirement(
                        key=v1.LABEL_ZONE, operator="In", values=zones)
                ])
            ])
        )
    return out


def _region_from_zones(zones) -> str:
    """getRegionFromZones: strip the trailing zone suffix (-a, -b, ...);
    heterogeneous prefixes fall back to UNSPECIFIED."""
    regions = {z.rsplit("-", 1)[0] for z in zones if "-" in z}
    return regions.pop() if len(regions) == 1 else _UNSPECIFIED


def pv_csi_source(pv: v1.PersistentVolume) -> Optional[Dict[str, str]]:
    """The PV's effective CSI source, translating in-tree sources — the
    single lookup both the kernel resolver and the oracle plugin use."""
    csi = getattr(pv.spec, "csi", None)
    if isinstance(csi, dict) and csi.get("driver"):
        return csi
    if migratable_plugin(pv) is not None:
        return translate_pv(pv).spec.csi
    return None
