"""Probe manager: liveness/readiness probing over the CRI.

Reference: pkg/kubelet/prober (worker.go per-container workers with
success/failure streak counting against the thresholds; results cached
in prober/results and consumed by the status manager; a liveness failure
makes syncPod kill the container so restart policy takes over).

Here one manager owns per-(pod, container, kind) streak state and is
ticked from a kubelet loop; probes execute as CRI ExecSync (the fake
runtime's exec_results hook decides the exit code). Readiness starts
False until the first success; liveness starts True — the reference's
initial values (results_manager.go).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

from ..api import types as v1
from .cri import CONTAINER_RUNNING, CRIError

LIVENESS = "liveness"
READINESS = "readiness"


@dataclass
class _WorkerState:
    successes: int = 0
    failures: int = 0
    result: bool = True
    started_at: float = field(default_factory=time.time)
    last_probe: float = 0.0
    container_id: str = ""  # streaks reset when the container is replaced


class ProbeManager:
    def __init__(self, runtime):
        self.runtime = runtime
        self._state: Dict[Tuple[str, str, str], _WorkerState] = {}
        # ticked from the syncloop; read by the status manager and torn
        # down by pod workers — every _state access takes the lock
        self._lock = threading.Lock()

    def _probe_of(self, spec: v1.Container, kind: str) -> Optional[v1.Probe]:
        return spec.liveness_probe if kind == LIVENESS else spec.readiness_probe

    def is_ready(self, uid: str, container_name: str,
                 has_probe: bool = False) -> bool:
        """Readiness result for the status manager. A container WITH a
        readiness probe is NOT ready until its first success (results
        manager initial value) — even before the first probe runs; one
        without a probe is ready by virtue of running (podutil)."""
        with self._lock:
            st = self._state.get((uid, container_name, READINESS))
        if st is None:
            return not has_probe
        return st.result

    def remove_pod(self, uid: str) -> None:
        with self._lock:
            for key in [k for k in self._state if k[0] == uid]:
                del self._state[key]

    def prune(self, live_uids: Iterable[str]) -> None:
        """Drop state for pods no longer desired (a tick racing a delete
        can re-insert entries for a dead uid; the next pass reaps them)."""
        live = set(live_uids)
        with self._lock:
            for key in [k for k in self._state if k[0] not in live]:
                del self._state[key]

    def tick(self, uid: str, pod: v1.Pod, containers) -> None:
        """Run due probes for the pod's RUNNING containers; a liveness
        failure past the threshold kills the container (syncPod's restart
        machinery does the rest)."""
        by_name = {c.name: c for c in containers}
        for spec in pod.spec.containers:
            c = by_name.get(spec.name)
            for kind in (LIVENESS, READINESS):
                probe = self._probe_of(spec, kind)
                if probe is None:
                    continue
                key = (uid, spec.name, kind)
                with self._lock:
                    st = self._state.get(key)
                    if c is None or c.state != CONTAINER_RUNNING:
                        # not running: readiness false, streaks reset on
                        # replacement (worker.go: onHold until new container)
                        if st is not None and kind == READINESS:
                            st.result = False
                        continue
                    if st is None or st.container_id != c.id:
                        st = _WorkerState(
                            result=(kind == LIVENESS), container_id=c.id)
                        self._state[key] = st
                    now = time.time()
                    if now - st.started_at < probe.initial_delay_seconds:
                        continue
                    if now - st.last_probe < probe.period_seconds:
                        continue
                    st.last_probe = now
                # the probe itself (an exec round-trip) runs outside the
                # lock; the streak update re-acquires it so is_ready()/
                # status readers never observe torn streak/result state
                ok = self._run_probe(c, probe)
                kill = False
                with self._lock:
                    if self._state.get(key) is not st:
                        # container replaced mid-probe: stale result
                        continue
                    if ok:
                        st.successes += 1
                        st.failures = 0
                        if st.successes >= probe.success_threshold:
                            st.result = True
                    else:
                        st.failures += 1
                        st.successes = 0
                        if st.failures >= probe.failure_threshold:
                            st.result = False
                            kill = kind == LIVENESS
                if kill:
                    # prober liveness failure → container killed;
                    # restart policy decides what happens next
                    self.runtime.stop_container(c.id, exit_code=137)

    def _run_probe(self, c, probe: v1.Probe) -> bool:
        cmd = probe.exec_command or ["true"]
        try:
            _, code = self.runtime.exec_in_container(c.id, cmd)
        except CRIError:
            return False
        return code == 0
