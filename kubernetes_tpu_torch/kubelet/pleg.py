"""PLEG — Pod Lifecycle Event Generator.

Reference: pkg/kubelet/pleg/generic.go:190 relist — every period, list
sandboxes + containers from the runtime, diff per-pod container states
against the previous relist, and emit ContainerStarted / ContainerDied /
ContainerRemoved events that wake the sync loop. The kubelet is
level-triggered on top of these edge events: an event only names the pod;
syncPod re-reads the full runtime state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .cri import CONTAINER_RUNNING, FakeRuntimeService

CONTAINER_STARTED = "ContainerStarted"
CONTAINER_DIED = "ContainerDied"
CONTAINER_REMOVED = "ContainerRemoved"


@dataclass
class PodLifecycleEvent:
    pod_uid: str
    type: str
    data: str = ""  # container id


class PLEG:
    def __init__(self, runtime: FakeRuntimeService):
        self._runtime = runtime
        # pod uid -> {container id: state} from the previous relist
        self._records: Dict[str, Dict[str, str]] = {}

    def relist(self) -> List[PodLifecycleEvent]:
        """One relist pass (generic.go:190): snapshot → diff → events."""
        sandboxes = {s.id: s for s in self._runtime.list_pod_sandboxes()}
        current: Dict[str, Dict[str, str]] = {}
        for c in self._runtime.list_containers():
            sb = sandboxes.get(c.sandbox_id)
            if sb is None:
                continue
            current.setdefault(sb.pod_uid, {})[c.id] = c.state

        events: List[PodLifecycleEvent] = []
        for pod_uid in set(self._records) | set(current):
            old = self._records.get(pod_uid, {})
            new = current.get(pod_uid, {})
            for cid in set(old) | set(new):
                o, n = old.get(cid), new.get(cid)
                if o == n:
                    continue
                if n == CONTAINER_RUNNING:
                    events.append(PodLifecycleEvent(pod_uid, CONTAINER_STARTED, cid))
                elif n is None:
                    events.append(PodLifecycleEvent(pod_uid, CONTAINER_REMOVED, cid))
                elif o == CONTAINER_RUNNING:
                    events.append(PodLifecycleEvent(pod_uid, CONTAINER_DIED, cid))
        self._records = current
        return events
