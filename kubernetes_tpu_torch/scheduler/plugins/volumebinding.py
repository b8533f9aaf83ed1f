"""VolumeBinding plugin: PreFilter + Filter + Reserve + PreBind.

Reference: pkg/scheduler/framework/plugins/volumebinding/volume_binding.go
(:141 PreFilter claim triage, :186 Filter via FindPodVolumes, :233 Reserve
AssumePodVolumes, :262 PreBind BindPodVolumes, :250 Unreserve).
"""

from __future__ import annotations

from typing import Dict, Optional

from ...api import types as v1
from ...volume.binder import PodVolumes, SchedulerVolumeBinder
from ..framework import interface as fwk
from ..framework.interface import CycleState, Status

STATE_KEY = "PreFilterVolumeBinding"

ERR_REASON_NOT_FOUND = "persistentvolumeclaim not found"
ERR_REASON_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"


class _StateData:
    __slots__ = ("skip", "bound_claims", "claims_to_bind", "pod_volumes_by_node")

    def __init__(self, skip=False, bound_claims=None, claims_to_bind=None):
        self.skip = skip
        self.bound_claims = bound_claims or []
        self.claims_to_bind = claims_to_bind or []
        self.pod_volumes_by_node: Dict[str, PodVolumes] = {}


def _pod_has_pvcs(pod: v1.Pod) -> bool:
    return any(
        (vol.source or {}).get("persistentVolumeClaim")
        for vol in pod.spec.volumes or []
    )


class VolumeBinding(fwk.PreFilterPlugin, fwk.FilterPlugin, fwk.ReservePlugin, fwk.PreBindPlugin):
    name = "VolumeBinding"

    def __init__(self, args=None, handle=None, binder: Optional[SchedulerVolumeBinder] = None):
        if binder is not None:
            self._binder = binder
        elif handle is not None and getattr(handle, "volume_binder", None) is not None:
            self._binder = handle.volume_binder
        else:
            # No volume state available (unit-test frameworks without a
            # cluster); behave as an empty cluster with no PVCs.
            self._binder = SchedulerVolumeBinder(lambda: [], lambda: [], lambda: [])

    # -- PreFilter (volume_binding.go:141) ---------------------------------
    def pre_filter(self, state: CycleState, pod: v1.Pod) -> Optional[Status]:
        if not _pod_has_pvcs(pod):
            state.write(STATE_KEY, _StateData(skip=True))
            return None
        bound, to_bind, immediate, missing = self._binder.get_pod_volumes(pod)
        if missing:
            return Status.unschedulable_and_unresolvable(ERR_REASON_NOT_FOUND)
        if immediate:
            return Status.unschedulable_and_unresolvable(ERR_REASON_UNBOUND_IMMEDIATE)
        state.write(STATE_KEY, _StateData(bound_claims=bound, claims_to_bind=to_bind))
        return None

    # -- Filter (volume_binding.go:186) ------------------------------------
    def filter(self, state: CycleState, pod: v1.Pod, node_info) -> Optional[Status]:
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        try:
            data: _StateData = state.read(STATE_KEY)
        except KeyError as e:
            return Status.error(str(e))
        if data.skip:
            return None
        reasons, pod_volumes = self._binder.find_pod_volumes(
            pod, data.bound_claims, data.claims_to_bind, node
        )
        if reasons:
            return Status.unschedulable(*reasons)
        data.pod_volumes_by_node[node.metadata.name] = pod_volumes
        return None

    # -- Reserve / Unreserve (volume_binding.go:233,:250) ------------------
    def reserve(self, state: CycleState, pod: v1.Pod, node_name: str) -> Optional[Status]:
        try:
            data: _StateData = state.read(STATE_KEY)
        except KeyError:
            # PreFilter never ran for this pod: the kernel path reaches
            # Reserve directly for bound-PVC pods it scheduled
            # (scheduler/volume_device.py gates that path to all-bound
            # claims). All-bound means nothing to assume — the
            # reference's AssumePodVolumes no-op. Anything still
            # unbound here would bind the pod with its PVCs forever
            # Pending — fail loudly (volume_binding.go:233).
            if _pod_has_pvcs(pod):
                bound, to_bind, immediate, missing = \
                    self._binder.get_pod_volumes(pod)
                if to_bind or immediate or missing:
                    return Status.error(
                        "VolumeBinding state missing at Reserve"
                    )
            return None
        if data.skip:
            return None
        pod_volumes = data.pod_volumes_by_node.get(node_name)
        if pod_volumes is None:
            return Status.error(
                f"no VolumeBinding decision recorded for node {node_name!r}"
            )
        self._binder.assume_pod_volumes(pod, pod_volumes)
        return None

    def unreserve(self, state: CycleState, pod: v1.Pod, node_name: str) -> None:
        try:
            data: _StateData = state.read(STATE_KEY)
        except KeyError:
            return
        pod_volumes = data.pod_volumes_by_node.get(node_name)
        if pod_volumes is not None:
            self._binder.revert_assumed_pod_volumes(pod_volumes)

    # -- PreBind (volume_binding.go:262) -----------------------------------
    def pre_bind(self, state: CycleState, pod: v1.Pod, node_name: str) -> Optional[Status]:
        try:
            data: _StateData = state.read(STATE_KEY)
        except KeyError:
            # same no-PreFilter contract as reserve() above: the kernel
            # path's all-bound pods have no bindings to apply; anything
            # unbound reaching PreBind without state is a real error
            if _pod_has_pvcs(pod):
                bound, to_bind, immediate, missing = \
                    self._binder.get_pod_volumes(pod)
                if to_bind or immediate or missing:
                    return Status.error(
                        "VolumeBinding state missing at PreBind"
                    )
            return None
        if data.skip:
            return None
        pod_volumes = data.pod_volumes_by_node.get(node_name)
        if pod_volumes is None or (
            not pod_volumes.static_bindings and not pod_volumes.dynamic_provisions
        ):
            return None
        try:
            self._binder.bind_pod_volumes(pod, node_name, pod_volumes)
        except Exception as e:  # bind failure aborts the binding cycle
            return Status.error(f"binding volumes: {e}")
        return None
