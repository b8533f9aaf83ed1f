"""Volume constraints on the device path.

Reference: the scheduler's volume filters —
pkg/scheduler/framework/plugins/volumebinding/volume_binding.go (bound-
PVC node-affinity conflicts), volumezone/volume_zone.go (PV zone/region
labels must match the node's), nodevolumelimits/csi.go (per-node attach
counts vs CSINode allocatable).

The r3 build diverted EVERY PVC-bearing pod to the host oracle
(scheduler.py _needs_oracle) — structurally oracle-slow for the whole
volume workload class. This module ends that: for pods whose PVCs are
all BOUND, the volume filters are statically resolvable at encode time
and ride the existing kernel machinery with NO new kernel code:

  * PV node affinity + VolumeZone label constraints become extra
    node-affinity OR-groups merged (by term distribution) into the
    pod's compiled node-affinity tables — the kernel's
    mask_node_affinity enforces them;
  * CSI attach limits become scalar resource dimensions named
    attachable-volumes-csi-<driver> (the reference's own resource-name
    convention for in-tree limits): the pod requests its per-driver
    volume count, nodes carry limit-as-allocatable and
    attached-count-as-requested, and the kernel's resource-fit mask
    enforces the limit.

Pods OUTSIDE the envelope keep the oracle path (correctness first):
unbound PVCs (provisioning decisions live in volume/binder.py),
PVCs shared with another pod (attach counting needs unique-handle
semantics), or affinity-term products too large to distribute.
Decision parity inside the envelope is pinned by
tests/test_volume_device.py against the oracle plugins.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from ..api import types as v1
from .plugins.volumes import DEFAULT_LIMITS, _ZONE_LABELS

MAX_DISTRIBUTED_TERMS = 16


def attach_resource_name(driver: str) -> str:
    """util.GetCSIAttachLimitKey: attachable-volumes-csi-<driver>."""
    return f"attachable-volumes-csi-{driver}"


class VolumeResolutionChanged(Exception):
    """A pod gated kernel-safe resolved differently at encode time (a
    PVC/assume event raced the scheduling cycle). The backend fails the
    pod's attempt; the retry re-gates against fresh state."""


class VolumeResolution:
    """What the encoder needs for one kernel-safe PVC-bearing pod."""

    __slots__ = ("term_groups", "extra_scalars")

    def __init__(self, term_groups, extra_scalars):
        # each group: OR of v1.NodeSelectorTerm; groups are ANDed (by
        # distribution into the pod's single OR-group)
        self.term_groups: List[List[v1.NodeSelectorTerm]] = term_groups
        self.extra_scalars: Dict[str, int] = extra_scalars


def pod_pvc_names(pod: v1.Pod) -> List[str]:
    return [
        (vol.source or {}).get("persistentVolumeClaim", {}).get("claimName", "")
        for vol in pod.spec.volumes or []
        if (vol.source or {}).get("persistentVolumeClaim")
    ]


class VolumeDeviceResolver:
    """Resolves a pod's bound-PVC constraints into kernel inputs.

    version bumps on every PVC/PV/CSINode event — consumers key caches
    on it (a PVC binding after a pod was encoded must invalidate that
    encoding)."""

    def __init__(self, list_pvcs, list_pvs, list_csinodes):
        self._list_pvcs = list_pvcs
        self._list_pvs = list_pvs
        self._list_csinodes = list_csinodes
        self.version = 0
        self._lock = threading.Lock()
        # (ns, claim) -> count of ASSIGNED/ASSUMED pods using it (fed by
        # the encoding's add/remove hooks): a claim already in use takes
        # the oracle path (unique-handle attach counting)
        self._pvc_refs: Dict[Tuple[str, str], int] = {}
        self._drivers_in_use: Set[str] = set()
        self._index_cache = None  # (version, pvc index, pv index)
        self._csinode_cache = None  # (version, node -> {driver: count})
        # (node, driver, handle) -> refcount of encoded pods using it
        self._node_handles: Dict[Tuple[str, str, str], int] = {}
        # fired (outside the lock) when a driver enters _drivers_in_use:
        # node rows built before it have no limit column for it (column
        # reads 0 = limit 0 = everything infeasible) — the backend hooks
        # this to queue an encoding rebuild
        self.on_new_driver = None

    # -- event hooks -------------------------------------------------------

    def bump(self, *_args) -> None:
        with self._lock:
            self.version += 1

    def claim_referenced(self, key: Tuple[str, str]) -> bool:
        """True when an ASSIGNED/ASSUMED (encoded) pod uses this claim.
        Callers may hold the backend lock — this lock nests inside it."""
        with self._lock:
            return self._pvc_refs.get(key, 0) > 0

    def drivers_referenced(self, drivers) -> bool:
        with self._lock:
            return bool(self._drivers_in_use & set(drivers))

    def pod_added(self, pod: v1.Pod) -> None:
        ns = pod.metadata.namespace
        with self._lock:
            for claim in pod_pvc_names(pod):
                key = (ns, claim)
                self._pvc_refs[key] = self._pvc_refs.get(key, 0) + 1

    def pod_removed(self, pod: v1.Pod) -> None:
        ns = pod.metadata.namespace
        with self._lock:
            for claim in pod_pvc_names(pod):
                key = (ns, claim)
                n = self._pvc_refs.get(key, 0) - 1
                if n <= 0:
                    self._pvc_refs.pop(key, None)
                else:
                    self._pvc_refs[key] = n

    # -- resolution --------------------------------------------------------

    def _indexes(self):
        """(pvc-by-key, pv-by-name) maps, rebuilt lazily per version —
        per-pod lister scans would be O(n^2) over a benchmark's PVC
        population. The version is captured BEFORE listing: a bump()
        racing the build must leave the cache stamped stale (a stale
        index stamped with the NEW version would serve wrong
        resolutions until an unrelated event)."""
        with self._lock:
            idx = self._index_cache
            if idx is not None and idx[0] == self.version:
                return idx[1], idx[2]
            version = self.version
        pvcs = {
            (c.metadata.namespace, c.metadata.name): c
            for c in self._list_pvcs()
        }
        # CSI migration at index time (volume/csi_translation.py): an
        # in-tree cloud-disk PV reaches everything downstream — driver
        # attach scalars, zone terms, node affinity — as its CSI twin
        from ..volume.csi_translation import translate_pv

        pvs = {p.metadata.name: translate_pv(p) for p in self._list_pvs()}
        with self._lock:
            self._index_cache = (version, pvcs, pvs)
        return pvcs, pvs

    def _pv_of(self, namespace: str, claim: str):
        pvcs, pvs = self._indexes()
        c = pvcs.get((namespace, claim))
        if c is None or not c.spec.volume_name:
            return None
        return pvs.get(c.spec.volume_name)

    def resolve(self, pod: v1.Pod) -> Optional[VolumeResolution]:
        """None = outside the kernel envelope (oracle path)."""
        claims = pod_pvc_names(pod)
        if not claims:
            return VolumeResolution([], {})
        ns = pod.metadata.namespace
        with self._lock:
            if any(self._pvc_refs.get((ns, c), 0) > 0 for c in claims):
                return None  # shared claim: unique-handle counting
        pvs = []
        for claim in claims:
            pv = self._pv_of(ns, claim)
            if pv is None:
                return None  # unbound / missing: binder territory
            pvs.append(pv)
        term_groups: List[List[v1.NodeSelectorTerm]] = []
        # VolumeZone (volume_zone.go): one combined group — every zone
        # constraint matches, OR the node has no zone labels at all
        zone_reqs: List[v1.NodeSelectorRequirement] = []
        for pv in pvs:
            for key, value in (pv.metadata.labels or {}).items():
                if key in _ZONE_LABELS:
                    vals = sorted(set(value.replace("__", ",").split(",")))
                    zone_reqs.append(
                        v1.NodeSelectorRequirement(
                            key=key, operator="In", values=vals
                        )
                    )
        if zone_reqs:
            no_labels = v1.NodeSelectorTerm(match_expressions=[
                v1.NodeSelectorRequirement(key=k, operator="DoesNotExist")
                for k in _ZONE_LABELS
            ])
            term_groups.append([
                v1.NodeSelectorTerm(match_expressions=zone_reqs), no_labels,
            ])
        # PV nodeAffinity (volume_binding.go bound-PVC check): each PV's
        # required terms are one OR-group
        for pv in pvs:
            na = pv.spec.node_affinity
            if na is None or na.required is None:
                continue
            terms = na.required.node_selector_terms or []
            if not terms:
                return None  # required-with-no-terms matches nothing
            term_groups.append(list(terms))
        # term-product cap (distribution explodes combinatorially)
        product = 1
        own = _own_affinity_terms(pod)
        for g in [own] if own else []:
            product *= len(g)
        for g in term_groups:
            product *= len(g)
        if product > MAX_DISTRIBUTED_TERMS:
            return None
        # attach limits -> scalar requests per driver
        scalars: Dict[str, int] = {}
        new_drivers = []
        for pv in pvs:
            drv = _pv_driver(pv)
            if drv:
                name = attach_resource_name(drv)
                scalars[name] = scalars.get(name, 0) + 1
                with self._lock:
                    if drv not in self._drivers_in_use:
                        self._drivers_in_use.add(drv)
                        new_drivers.append(drv)
        if new_drivers and self.on_new_driver is not None:
            self.on_new_driver()
        return VolumeResolution(term_groups, scalars)

    # -- node side ---------------------------------------------------------

    def _csinode_index(self) -> Dict[str, Dict[str, int]]:
        """node name -> {driver: count}, rebuilt lazily per version —
        an encoding rebuild calls node_extra_alloc once PER NODE, and a
        full CSINode list scan each time is O(nodes x csinodes)."""
        with self._lock:
            idx = self._csinode_cache
            if idx is not None and idx[0] == self.version:
                return idx[1]
            version = self.version
        by_node: Dict[str, Dict[str, int]] = {}
        for cn in self._list_csinodes():
            limits = {
                drv.name: drv.count
                for drv in cn.spec.drivers or []
                if drv.count is not None
            }
            if limits:
                by_node[cn.metadata.name] = limits
        with self._lock:
            self._csinode_cache = (version, by_node)
        return by_node

    def node_extra_alloc(self, node: v1.Node) -> Dict[str, int]:
        """Per-driver attach limits as allocatable scalars, for every
        driver any resolved pod uses: CSINode allocatable wins, then the
        in-tree defaults, then effectively-unlimited (csi.go
        _limits_for semantics)."""
        with self._lock:
            drivers = set(self._drivers_in_use)
        if not drivers:
            return {}
        csinode_limits = self._csinode_index().get(node.metadata.name, {})
        out = {}
        for drv in drivers:
            limit = csinode_limits.get(drv, DEFAULT_LIMITS.get(drv))
            if limit is None:
                limit = 1 << 40  # no CSINode, no default: unlimited
            out[attach_resource_name(drv)] = limit
        return out

    def _pod_volumes_by_driver(self, pod: v1.Pod):
        """driver -> volume handles, via the oracle plugin's own walk
        (_csi_volumes_of) so the fast path's accounting and
        NodeVolumeLimits can never diverge."""
        from .plugins.volumes import _csi_volumes_of

        def lookup(namespace: str, name: str):
            pv = self._pv_of(namespace, name)
            if pv is None:
                return None
            drv = _pv_driver(pv)
            return (drv, pv.metadata.name) if drv else None

        return _csi_volumes_of(pod, lookup)

    def pod_extra_scalars(self, pod: v1.Pod) -> Dict[str, int]:
        """The pod's OWN attach requirement (vocab interning + pending
        encode). Node-row accounting goes through attach_delta, which is
        refcounted by handle."""
        return {
            attach_resource_name(drv): len(idents)
            for drv, idents in self._pod_volumes_by_driver(pod).items()
        }

    def attach_delta(self, pod: v1.Pod, node_name: str, sign: int) -> Dict[str, int]:
        """Node-row attach-count delta for adding (sign=+1) or removing
        (sign=-1) this pod on node_name, REFCOUNTED per volume handle:
        the oracle counts unique handles per node
        (plugins/volumes.py NodeVolumeLimits.filter unions idents), so
        the second pod sharing a handle on a node contributes 0 — a
        per-pod count would overcount and reject nodes the oracle
        accepts. Returned values are always positive (the caller applies
        the sign). Handle drift between add and remove (a PV rebinding
        while the pod runs) leaves a stale refcount until the next full
        rebuild (reset_attach) realigns."""
        by_driver = self._pod_volumes_by_driver(pod)
        delta: Dict[str, int] = {}
        new_drivers = []
        with self._lock:
            for drv, idents in by_driver.items():
                d = 0
                for h in idents:
                    key = (node_name, drv, h)
                    n = self._node_handles.get(key, 0)
                    if sign > 0:
                        if n == 0:
                            d += 1
                        self._node_handles[key] = n + 1
                    else:
                        if n <= 1:
                            self._node_handles.pop(key, None)
                            if n == 1:
                                d += 1
                        else:
                            self._node_handles[key] = n - 1
                if d:
                    delta[attach_resource_name(drv)] = d
                if sign > 0 and drv not in self._drivers_in_use:
                    self._drivers_in_use.add(drv)
                    new_drivers.append(drv)
        if new_drivers and self.on_new_driver is not None:
            self.on_new_driver()
        return delta

    def reset_attach(self) -> None:
        """A full encoding rebuild re-applies every pod's attach_delta
        from scratch."""
        with self._lock:
            self._node_handles.clear()


def _pv_driver(pv) -> Optional[str]:
    """PV -> CSI driver (PersistentVolumeSpec models only the CSI
    source; in-tree pod-level sources map through the oracle plugin's
    _INTREE_TO_CSI inside _csi_volumes_of)."""
    csi = getattr(pv.spec, "csi", None)
    if isinstance(csi, dict) and csi.get("driver"):
        return csi["driver"]
    return None


def distribute_term_groups(
    own: Optional[List[v1.NodeSelectorTerm]],
    groups: List[List[v1.NodeSelectorTerm]],
) -> List[v1.NodeSelectorTerm]:
    """AND of OR-groups -> ONE OR-group by distribution (the kernel's
    affinity tables hold a single OR-of-conjunctions). Empty terms match
    nothing (api.labels semantics) and are dropped; a group left empty
    makes the whole conjunction unsatisfiable -> a single never-term."""
    all_groups = ([own] if own is not None else []) + groups
    cleaned: List[List[v1.NodeSelectorTerm]] = []
    for g in all_groups:
        kept = [t for t in g if t.match_expressions or t.match_fields]
        if not kept:
            return [_NEVER_TERM]
        cleaned.append(kept)
    if not cleaned:
        return []
    combos: List[List[v1.NodeSelectorTerm]] = [[]]
    for g in cleaned:
        combos = [c + [t] for c in combos for t in g]
    out = []
    for parts in combos:
        me: List[v1.NodeSelectorRequirement] = []
        mf: List[v1.NodeSelectorRequirement] = []
        for t in parts:
            me.extend(t.match_expressions or [])
            mf.extend(t.match_fields or [])
        out.append(
            v1.NodeSelectorTerm(
                match_expressions=me or None, match_fields=mf or None
            )
        )
    return out


# In with an empty value set can never match
_NEVER_TERM = v1.NodeSelectorTerm(match_expressions=[
    v1.NodeSelectorRequirement(key="kubernetes.io/hostname",
                               operator="In", values=[])
])


def _own_affinity_terms(pod: v1.Pod) -> Optional[List[v1.NodeSelectorTerm]]:
    a = pod.spec.affinity
    if a is None or a.node_affinity is None:
        return None
    req = a.node_affinity.required_during_scheduling_ignored_during_execution
    if req is None:
        return None
    return list(req.node_selector_terms or [])
