"""The node agent: syncLoop + pod workers + status/heartbeat managers.

Reference call stack (pkg/kubelet/kubelet.go):
  Run (:1395) → syncLoop (:1831) → syncLoopIteration (:1905) selecting on
  config updates (apiserver watch), PLEG events (1s relist), the sync
  ticker, probe results, and housekeeping (2s); pod work is dispatched to
  per-pod serialized workers (pod_workers.go:158 managePodLoop) whose
  syncPod computes a desired-vs-actual diff and drives the CRI
  (kuberuntime_manager.go SyncPod: sandbox → containers, restart policy);
  the status manager PATCHes pod status; node heartbeats are a
  coordination Lease renewed every 10s (nodelease) plus periodic
  NodeStatus updates (kubelet_node_status.go).

The runtime is injected (CRI contract); with FakeRuntimeService this is
the hollow kubelet (kubemark hollow_kubelet.go:105 — real kubelet code,
fake effectors).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import types as v1
from ..apiserver.server import APIError
from ..client.informer import EventHandler
from .cm import AdmissionError
from .prober import ProbeManager
from .cri import (
    CONTAINER_CREATED,
    CONTAINER_EXITED,
    CONTAINER_RUNNING,
    SANDBOX_READY,
    CRIError,
    FakeRuntimeService,
)
from .pleg import PLEG

LEASE_NAMESPACE = "kube-node-lease"


@dataclass
class KubeletConfig:
    node_name: str = "node-0"
    cpu: str = "4"
    memory: str = "32Gi"
    max_pods: int = 110
    labels: Dict[str, str] = field(default_factory=dict)
    sync_period: float = 10.0  # kubelet.go:1831 1s ticker is the floor;
    # resync of all pods happens at this period
    pleg_period: float = 1.0  # pleg/generic.go relist period
    housekeeping_period: float = 2.0  # kubelet.go housekeepingPeriod
    lease_duration_seconds: int = 40
    lease_renew_period: float = 10.0  # nodelease controller renew interval
    node_status_period: float = 10.0
    # eviction (pkg/kubelet/eviction): soft memory threshold as a fraction
    # of capacity; the stats come from the injected stats provider
    memory_eviction_threshold: float = 0.95


@dataclass
class _PodWorker:
    q: "queue.Queue[Optional[v1.Pod]]"
    thread: threading.Thread


class Kubelet:
    def __init__(
        self,
        clientset,
        informer_factory,
        config: Optional[KubeletConfig] = None,
        runtime: Optional[FakeRuntimeService] = None,
        stats_provider=None,  # () -> memory usage fraction [0,1]
        device_manager=None,  # kubelet.cm.DeviceManager
        cpu_manager=None,  # kubelet.cm.CPUManager
    ):
        self.client = clientset
        self.config = config or KubeletConfig()
        self.runtime = runtime or FakeRuntimeService()
        self.device_manager = device_manager
        self.cpu_manager = cpu_manager
        self.pleg = PLEG(self.runtime)
        self.prober = ProbeManager(self.runtime)
        self.stats_provider = stats_provider or (lambda: 0.0)
        self.pod_informer = informer_factory.informer_for("pods")
        self._workers: Dict[str, _PodWorker] = {}
        self._workers_lock = threading.Lock()
        # desired state: pod uid -> latest Pod seen for this node
        self._pods: Dict[str, v1.Pod] = {}
        self._pods_lock = threading.Lock()
        self._events: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._handler = EventHandler(
            on_add=self._on_pod_change,
            on_update=lambda old, new: self._on_pod_change(new),
            on_delete=self._on_pod_delete,
        )
        self.pod_informer.add_event_handler(self._handler)

    # -- lifecycle ---------------------------------------------------------

    def run(self) -> None:
        """Kubelet.Run: register node, start heartbeats + syncLoop."""
        self._register_node()
        # kubelet node API: logs/exec served to the apiserver's pod
        # subresource proxy (the reference's kubelet server, pkg/kubelet/
        # server/server.go, reached via registry/core/pod/rest)
        api = getattr(self.client, "api", None)
        if api is not None and hasattr(api, "register_node_proxy"):
            api.register_node_proxy(self.config.node_name, self)
        for target, name in (
            (self._lease_loop, "lease"),
            (self._node_status_loop, "nodestatus"),
            (self._sync_loop, "syncloop"),
        ):
            t = threading.Thread(
                target=target, name=f"kubelet-{self.config.node_name}-{name}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        api = getattr(self.client, "api", None)
        if api is not None and hasattr(api, "unregister_node_proxy"):
            api.unregister_node_proxy(self.config.node_name)
        # deregister from the shared informer: a dead kubelet must not
        # keep receiving (and queueing) pod events
        self.pod_informer.remove_event_handler(self._handler)
        with self._workers_lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            w.q.put(None)
        for t in self._threads:
            t.join(timeout=5)

    # -- node registration + heartbeats ------------------------------------

    def _register_node(self) -> None:
        """kubelet_node_status.go registerWithAPIServer."""
        cfg = self.config
        capacity = {"cpu": cfg.cpu, "memory": cfg.memory, "pods": str(cfg.max_pods)}
        if self.device_manager is not None:
            dev_cap, _, _ = self.device_manager.get_capacity()
            capacity.update(dev_cap)
        labels = {v1.LABEL_HOSTNAME: cfg.node_name}
        labels.update(cfg.labels)
        node = v1.Node(
            metadata=v1.ObjectMeta(name=cfg.node_name, labels=labels),
            status=v1.NodeStatus(
                capacity=dict(capacity),
                allocatable=dict(capacity),
                conditions=self._conditions(),
            ),
        )
        try:
            self.client.nodes.create(node)
        except APIError:
            # already registered (restart): reconcile status below
            pass
        self._update_node_status()

    def _conditions(self, memory_pressure: bool = False) -> List[v1.NodeCondition]:
        now = time.time()

        def cond(type_, status, reason):
            return v1.NodeCondition(
                type=type_,
                status=status,
                reason=reason,
                last_heartbeat_time=now,
                last_transition_time=now,
            )

        return [
            cond("Ready", "True", "KubeletReady"),
            cond(
                "MemoryPressure",
                "True" if memory_pressure else "False",
                "KubeletHasMemoryPressure" if memory_pressure else "KubeletHasSufficientMemory",
            ),
            cond("DiskPressure", "False", "KubeletHasNoDiskPressure"),
            cond("PIDPressure", "False", "KubeletHasSufficientPID"),
        ]

    def _lease_loop(self) -> None:
        """nodelease controller: create/renew the Lease every renew period."""
        name = self.config.node_name
        while not self._stop.is_set():
            now = time.time()
            try:
                try:
                    lease = self.client.resource("leases").get(name, LEASE_NAMESPACE)
                    lease.spec.renew_time = now
                    self.client.resource("leases").update(lease)
                except APIError:
                    self.client.resource("leases").create(
                        v1.Lease(
                            metadata=v1.ObjectMeta(name=name, namespace=LEASE_NAMESPACE),
                            spec=v1.LeaseSpec(
                                holder_identity=name,
                                lease_duration_seconds=self.config.lease_duration_seconds,
                                acquire_time=now,
                                renew_time=now,
                            ),
                        )
                    )
            except Exception:  # noqa: BLE001
                traceback.print_exc()
            self._stop.wait(self.config.lease_renew_period)

    def _node_status_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._update_node_status()
            except Exception:  # noqa: BLE001
                traceback.print_exc()
            self._stop.wait(self.config.node_status_period)

    def _update_node_status(self) -> None:
        """kubelet_node_status.go updateNodeStatus + eviction manager's
        memory-pressure condition."""
        pressure = self.stats_provider() >= self.config.memory_eviction_threshold
        try:
            node = self.client.nodes.get(self.config.node_name)
        except APIError:
            return
        node.status.conditions = self._conditions(memory_pressure=pressure)
        # consume the centrally-allocated podCIDR (nodeipam controller,
        # range_allocator.go updateCIDRsAllocation): the fake CNI's pod-IP
        # range follows spec.podCIDR, replacing the node-side invention
        if node.spec.pod_cidr:
            self.runtime.set_pod_cidr(node.spec.pod_cidr)
        if self.device_manager is not None:
            # setNodeStatusAllocatable: plugin resources join capacity;
            # removed resources are zeroed, not dropped (kubelet_node_status.go)
            dev_cap, dev_alloc, removed = self.device_manager.get_capacity()
            node.status.capacity.update(dev_cap)
            node.status.allocatable.update(dev_alloc)
            for res in removed:
                node.status.capacity[res] = "0"
                node.status.allocatable[res] = "0"
        try:
            self.client.nodes.update(node)
        except APIError:
            pass  # conflict: next period wins
        if pressure:
            self._evict_one_pod()

    # -- pod config source -------------------------------------------------

    def _on_pod_change(self, pod: v1.Pod) -> None:
        if pod.spec.node_name != self.config.node_name:
            return
        self._events.put(("pod", pod))

    def _on_pod_delete(self, pod: v1.Pod) -> None:
        if pod.spec.node_name != self.config.node_name:
            return
        self._events.put(("delete", pod))

    # -- syncLoop ----------------------------------------------------------

    def _sync_loop(self) -> None:
        """syncLoopIteration (kubelet.go:1905): config ∥ PLEG ∥ ticker ∥
        housekeeping, multiplexed over one event queue + timers."""
        last_pleg = last_sync = last_housekeeping = 0.0
        while not self._stop.is_set():
            try:
                kind, pod = self._events.get(timeout=0.2)
                if kind == "pod":
                    self._dispatch(pod, deleting=False)
                elif kind == "delete":
                    self._dispatch(pod, deleting=True)
            except queue.Empty:
                pass
            except Exception:  # noqa: BLE001
                traceback.print_exc()
            now = time.monotonic()
            if now - last_pleg >= self.config.pleg_period:
                last_pleg = now
                self._pleg_pass()
            if now - last_sync >= self.config.sync_period:
                last_sync = now
                self._resync_all()
            if now - last_housekeeping >= self.config.housekeeping_period:
                last_housekeeping = now
                self._housekeeping()

    def _pleg_pass(self) -> None:
        try:
            events = self.pleg.relist()
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            return
        self._probe_pass()
        touched = {e.pod_uid for e in events}
        with self._pods_lock:
            pods = {uid: p for uid, p in self._pods.items() if uid in touched}
        for pod in pods.values():
            self._dispatch(pod, deleting=False)

    def _probe_pass(self) -> None:
        """Run due probes for every desired pod (prober tick on the PLEG
        cadence); readiness flips re-dispatch the pod so the status
        manager publishes the change promptly. One runtime listing per
        pass (not per pod), and probe-less pods are skipped outright."""
        with self._pods_lock:
            pods = list(self._pods.items())
        self.prober.prune(uid for uid, _ in pods)
        probed = [
            (uid, pod) for uid, pod in pods
            if any(sp.liveness_probe or sp.readiness_probe
                   for sp in pod.spec.containers)
        ]
        if not probed:
            return
        ready_sandboxes = {
            sb.id: sb.pod_uid
            for sb in self.runtime.list_pod_sandboxes()
            if sb.state == SANDBOX_READY
        }
        by_uid: Dict[str, list] = {}
        for c in self.runtime.list_containers():
            u = ready_sandboxes.get(c.sandbox_id)
            if u is not None:
                by_uid.setdefault(u, []).append(c)
        for uid, pod in probed:
            def readiness(p=pod, u=uid):
                return {
                    sp.name: self.prober.is_ready(
                        u, sp.name, has_probe=sp.readiness_probe is not None)
                    for sp in p.spec.containers
                }

            before = readiness()
            try:
                self.prober.tick(uid, pod, by_uid.get(uid, []))
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                continue
            if readiness() != before:
                self._dispatch(pod, deleting=False)

    def _resync_all(self) -> None:
        with self._pods_lock:
            pods = list(self._pods.values())
        for pod in pods:
            self._dispatch(pod, deleting=False)

    def _housekeeping(self) -> None:
        """Remove runtime state for pods no longer desired (kubelet.go
        HandlePodCleanups)."""
        with self._pods_lock:
            desired = set(self._pods)
        for sb in self.runtime.list_pod_sandboxes():
            if sb.pod_uid not in desired:
                try:
                    self.runtime.stop_pod_sandbox(sb.id)
                    self.runtime.remove_pod_sandbox(sb.id)
                except Exception:  # noqa: BLE001
                    pass

    # -- pod workers -------------------------------------------------------

    @staticmethod
    def _pod_uid(pod: v1.Pod) -> str:
        return pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}"

    def _dispatch(self, pod: v1.Pod, deleting: bool) -> None:
        """podWorkers.UpdatePod: serialized per-pod work queue."""
        uid = self._pod_uid(pod)
        deleting = deleting or pod.metadata.deletion_timestamp is not None
        with self._pods_lock:
            if deleting:
                self._pods.pop(uid, None)
            else:
                self._pods[uid] = pod
        # enqueue under the lock so a worker draining its final None can't
        # miss an update that raced its self-removal
        with self._workers_lock:
            if self._stop.is_set():
                return
            worker = self._workers.get(uid)
            if worker is None:
                if deleting:
                    return  # nothing running for this pod
                q: "queue.Queue" = queue.Queue()
                t = threading.Thread(
                    target=self._manage_pod_loop,
                    args=(uid, q),
                    name=f"podworker-{pod.metadata.name}",
                    daemon=True,
                )
                self._workers[uid] = _PodWorker(q, t)
                t.start()
                worker = self._workers[uid]
            worker.q.put(pod if not deleting else None)

    def _manage_pod_loop(self, uid: str, q: "queue.Queue") -> None:
        """pod_workers.go:158 managePodLoop: process updates serially;
        coalesce to the latest."""
        while True:
            pod = q.get()
            # drain to the most recent update (podWorkers coalescing)
            while True:
                try:
                    nxt = q.get_nowait()
                    pod = nxt
                except queue.Empty:
                    break
            try:
                if pod is None:
                    if self._stop.is_set():
                        # kubelet shutdown, NOT pod deletion: leave runtime
                        # state and device/cpu allocations intact — they are
                        # checkpointed and reconciled on restart (the reason
                        # the checkpoint files exist at all)
                        return
                    self._terminate_pod(uid)
                    # remove self only if no new work raced in (the _dispatch
                    # enqueue happens under _workers_lock, so this is exact)
                    with self._workers_lock:
                        if q.empty():
                            self._workers.pop(uid, None)
                            return
                    continue
                self._sync_pod(pod)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    # -- syncPod -----------------------------------------------------------

    def _pod_runtime_state(self, uid: str):
        sandbox = None
        for sb in self.runtime.list_pod_sandboxes():
            if sb.pod_uid == uid and sb.state == SANDBOX_READY:
                sandbox = sb
                break
        containers = []
        if sandbox is not None:
            containers = [
                c for c in self.runtime.list_containers() if c.sandbox_id == sandbox.id
            ]
        return sandbox, containers

    def _sync_pod(self, pod: v1.Pod) -> None:
        """kuberuntime_manager.go SyncPod: computePodActions diff then act."""
        uid = self._pod_uid(pod)
        restart_policy = pod.spec.restart_policy or "Always"
        init_names = {c.name for c in pod.spec.init_containers or []}
        if pod.status.phase == "Failed" and pod.status.reason in (
            "UnexpectedAdmissionError", "InitContainerFailed"):
            # a rejected pod is terminal with no runtime state; without
            # this the rejection status-write's own watch event would
            # re-dispatch it and admission would re-run forever
            return
        sandbox, containers = self._pod_runtime_state(uid)
        by_name = {c.name: c for c in containers}
        app = [c for c in containers if c.name not in init_names]

        # terminal check: Never/OnFailure pods that finished stay finished
        if self._phase(pod, app, restart_policy) in ("Succeeded", "Failed") and sandbox is not None:
            self._update_pod_status(pod, sandbox, app, restart_policy)
            return

        if sandbox is None:
            # admit: device + exclusive-CPU allocation happen before any
            # runtime state exists (the reference's admit handlers run
            # before syncPod; failure is terminal, not retried)
            try:
                if self.device_manager is not None:
                    self.device_manager.allocate(pod)
                if self.cpu_manager is not None:
                    for spec in pod.spec.containers:
                        self.cpu_manager.add_container(pod, spec.name)
            except AdmissionError as e:
                # roll back partial allocations (devices committed before
                # the CPU manager rejected, or some containers before an
                # exhausted one) — a rejected pod must hold nothing
                if self.device_manager is not None:
                    self.device_manager.remove_pod(uid)
                if self.cpu_manager is not None:
                    self.cpu_manager.remove_pod(uid)
                self._reject_pod(pod, str(e))
                return
            sid = self.runtime.run_pod_sandbox(
                pod.metadata.name, pod.metadata.namespace, uid
            )
            sandbox, containers = self._pod_runtime_state(uid)
            by_name = {}
            if sandbox is None:
                return  # runtime failed; retried by next sync
        # init containers run SEQUENTIALLY to completion before any app
        # container starts (kuberuntime SyncPod: sandbox → init → app;
        # findNextInitContainerToRun). Each sync pass advances at most one
        # step; PLEG events re-trigger sync as inits exit.
        for ispec in pod.spec.init_containers or []:
            existing = by_name.get(ispec.name)
            if existing is None:
                cid = self.runtime.create_container(
                    sandbox.id, ispec.name, ispec.image, restart_count=0
                )
                self.runtime.start_container(cid)
                return
            if existing.state == CONTAINER_CREATED:
                self.runtime.start_container(existing.id)
                return
            if existing.state == CONTAINER_RUNNING:
                return  # wait for this init to finish
            if existing.exit_code != 0:
                if restart_policy == "Never":
                    # init failure is terminal (getPhase: init failed +
                    # Never → Failed)
                    self._fail_pod(pod, "InitContainerFailed",
                                   f"init container {ispec.name} exited "
                                   f"{existing.exit_code}")
                    return
                self.runtime.remove_container(existing.id)
                cid = self.runtime.create_container(
                    sandbox.id, ispec.name, ispec.image,
                    restart_count=existing.restart_count + 1,
                )
                self.runtime.start_container(cid)
                return
            # exited 0: fall through to the next init / app containers
        for spec in pod.spec.containers:
            existing = by_name.get(spec.name)
            if existing is None:
                cid = self.runtime.create_container(
                    sandbox.id, spec.name, spec.image, restart_count=0
                )
                self.runtime.start_container(cid)
            elif existing.state == CONTAINER_EXITED:
                should_restart = restart_policy == "Always" or (
                    restart_policy == "OnFailure" and existing.exit_code != 0
                )
                if should_restart:
                    self.runtime.remove_container(existing.id)
                    cid = self.runtime.create_container(
                        sandbox.id,
                        spec.name,
                        spec.image,
                        restart_count=existing.restart_count + 1,
                    )
                    self.runtime.start_container(cid)
            elif existing.state == CONTAINER_CREATED:
                self.runtime.start_container(existing.id)
        _, containers = self._pod_runtime_state(uid)
        app = [c for c in containers if c.name not in init_names]
        self._update_pod_status(pod, sandbox, app, restart_policy)

    # -- kubelet node API (logs/exec, served to the apiserver proxy) -------

    def _find_container(self, pod_name: str, namespace: str, container: str):
        # READY sandboxes only: a dead sandbox lingering beside a
        # recreated one must not shadow the live containers
        for sb in self.runtime.list_pod_sandboxes():
            if (
                sb.pod_name != pod_name
                or sb.pod_namespace != namespace
                or sb.state != SANDBOX_READY
            ):
                continue
            cs = [
                c for c in self.runtime.list_containers()
                if c.sandbox_id == sb.id
            ]
            if not container and cs:
                return cs[0]
            for c in cs:
                if c.name == container:
                    return c
        return None

    def container_logs(self, pod_name: str, namespace: str,
                       container: str = "", tail=None):
        """GetKubeletContainerLogs (kubelet_pods.go) → CRI ReadLogs."""
        c = self._find_container(pod_name, namespace, container)
        if c is None:
            raise KeyError(
                f"container {container or '<first>'} of pod "
                f"{namespace}/{pod_name} not found on {self.config.node_name}"
            )
        try:
            return self.runtime.container_logs(c.id, tail)
        except CRIError as e:
            # container vanished between lookup and read
            raise KeyError(str(e))

    def exec_in_pod(self, pod_name: str, namespace: str, cmd,
                    container: str = ""):
        """Exec handler → CRI ExecSync; CRI errors surface as the HTTP
        error the reference's kubelet would serve (KeyError → APIError at
        the kubectl boundary)."""
        c = self._find_container(pod_name, namespace, container)
        if c is None:
            raise KeyError(
                f"container {container or '<first>'} of pod "
                f"{namespace}/{pod_name} not found on {self.config.node_name}"
            )
        try:
            return self.runtime.exec_in_container(c.id, list(cmd))
        except CRIError as e:
            raise KeyError(str(e))

    # -- streaming (cri/streaming: the kubelet's streaming server) ---------

    def exec_stream_in_pod(self, pod_name: str, namespace: str, cmd,
                           container: str = ""):
        """Exec (interactive): returns a StreamSession — the reference's
        kubelet returns a streaming URL the apiserver proxies; in-proc
        the session is handed straight through the node proxy."""
        c = self._find_container(pod_name, namespace, container)
        if c is None:
            raise KeyError(
                f"container {container or '<first>'} of pod "
                f"{namespace}/{pod_name} not found")
        try:
            return self.runtime.exec_stream(c.id, list(cmd))
        except CRIError as e:
            raise KeyError(str(e))

    def attach_pod(self, pod_name: str, namespace: str, container: str = ""):
        c = self._find_container(pod_name, namespace, container)
        if c is None:
            raise KeyError(
                f"container {container or '<first>'} of pod "
                f"{namespace}/{pod_name} not found")
        try:
            return self.runtime.attach_container(c.id)
        except CRIError as e:
            raise KeyError(str(e))

    def portforward_pod(self, pod_name: str, namespace: str, port: int):
        for sb in self.runtime.list_pod_sandboxes():
            if sb.pod_name == pod_name and sb.pod_namespace == namespace:
                try:
                    return self.runtime.port_forward(sb.id, port)
                except CRIError as e:
                    raise KeyError(str(e))
        raise KeyError(f"no sandbox for pod {namespace}/{pod_name}")

    def _reject_pod(self, pod: v1.Pod, message: str) -> None:
        """Admission failure: terminal Failed status (kubelet.go
        rejectPod, reason UnexpectedAdmissionError)."""
        self._fail_pod(pod, "UnexpectedAdmissionError", message)

    def _fail_pod(self, pod: v1.Pod, reason: str, message: str) -> None:
        try:
            live = self.client.pods.get(pod.metadata.name, pod.metadata.namespace)
            if live.status.phase == "Failed":
                return  # already failed: no-op, don't churn watch events
            live.status.phase = "Failed"
            live.status.reason = reason
            live.status.message = message
            self.client.pods.update_status(live)
        except APIError:
            pass

    def _terminate_pod(self, uid: str) -> None:
        """Pod removed from desired state: tear down runtime state."""
        self.prober.remove_pod(uid)
        if self.device_manager is not None:
            self.device_manager.remove_pod(uid)
        if self.cpu_manager is not None:
            self.cpu_manager.remove_pod(uid)
        for sb in self.runtime.list_pod_sandboxes():
            if sb.pod_uid == uid:
                try:
                    self.runtime.stop_pod_sandbox(sb.id)
                    self.runtime.remove_pod_sandbox(sb.id)
                except Exception:  # noqa: BLE001
                    pass

    # -- status manager ----------------------------------------------------

    @staticmethod
    def _phase(pod: v1.Pod, containers, restart_policy: str) -> str:
        """podPhase (kubelet_pods.go getPhase)."""
        specs = pod.spec.containers
        by_name = {c.name: c for c in containers}
        if not containers or len(by_name) < len(specs):
            return "Pending"
        running = sum(1 for c in containers if c.state == CONTAINER_RUNNING)
        exited = [c for c in containers if c.state == CONTAINER_EXITED]
        if running == len(specs):
            return "Running"
        if len(exited) == len(specs):
            if restart_policy == "Never":
                return (
                    "Succeeded"
                    if all(c.exit_code == 0 for c in exited)
                    else "Failed"
                )
            if restart_policy == "OnFailure" and all(c.exit_code == 0 for c in exited):
                return "Succeeded"
            # all containers crashed but will be restarted: still Running
            # (getPhase: stopped > 0 && restartPolicy != Never → Running)
            return "Running"
        return "Pending" if running == 0 else "Running"

    def _update_pod_status(self, pod: v1.Pod, sandbox, containers, restart_policy) -> None:
        """status manager syncPod: PATCH .status upstream."""
        phase = self._phase(pod, containers, restart_policy)
        statuses = []
        all_ready = bool(containers) and len(containers) == len(pod.spec.containers)
        uid = self._pod_uid(pod)
        spec_by_name = {sp.name: sp for sp in pod.spec.containers}
        for c in containers:
            sp = spec_by_name.get(c.name)
            ready = (c.state == CONTAINER_RUNNING
                     and self.prober.is_ready(
                         uid, c.name,
                         has_probe=sp is not None
                         and sp.readiness_probe is not None))
            all_ready = all_ready and ready
            statuses.append(
                v1.ContainerStatus(
                    name=c.name,
                    ready=ready,
                    restart_count=c.restart_count,
                    image=c.image,
                    state={
                        CONTAINER_RUNNING: "running",
                        CONTAINER_EXITED: "terminated",
                    }.get(c.state, "waiting"),
                    exit_code=c.exit_code if c.state == CONTAINER_EXITED else None,
                )
            )
        now = time.time()
        try:
            live = self.client.pods.get(pod.metadata.name, pod.metadata.namespace)
        except APIError:
            return
        prev_conds = {c.type: c for c in live.status.conditions or []}

        def cond(type_, status):
            # keep lastTransitionTime stable while the status is unchanged
            # (status manager: needsUpdate compares, timestamps only move on
            # real transitions) — otherwise every write looks like a change
            # and the informer→syncPod→PATCH loop never settles
            prev = prev_conds.get(type_)
            if prev is not None and prev.status == status:
                return prev
            return v1.PodCondition(type=type_, status=status, last_transition_time=now)

        new_conds = [
            cond("PodScheduled", "True"),
            cond("Initialized", "True"),
            cond("ContainersReady", "True" if all_ready else "False"),
            cond("Ready", "True" if all_ready and phase == "Running" else "False"),
        ]

        def status_key(s):
            return (
                s.phase,
                s.host_ip,
                s.pod_ip,
                tuple(
                    (c.name, c.ready, c.restart_count, c.image, c.state, c.exit_code)
                    for c in s.container_statuses or []
                ),
                tuple((c.type, c.status) for c in s.conditions or []),
            )

        before = status_key(live.status)
        live.status.phase = phase
        live.status.host_ip = self.config.node_name
        live.status.pod_ip = sandbox.ip if sandbox else ""
        if live.status.start_time is None:
            live.status.start_time = now
        live.status.container_statuses = statuses
        live.status.conditions = new_conds
        if status_key(live.status) == before and live.status.start_time != now:
            return  # no material change: don't PATCH (status_manager syncPod)
        try:
            self.client.pods.update_status(live)
        except APIError:
            pass  # conflict: retried on next sync

    # -- eviction (pkg/kubelet/eviction) -----------------------------------

    def _evict_one_pod(self) -> None:
        """Memory pressure: evict the lowest-priority pod (eviction
        manager's rank + evict loop, one pod per interval)."""
        with self._pods_lock:
            pods = list(self._pods.values())
        if not pods:
            return
        victim = min(pods, key=lambda p: p.spec.priority or 0)
        try:
            live = self.client.pods.get(
                victim.metadata.name, victim.metadata.namespace
            )
            live.status.phase = "Failed"
            live.status.conditions = [
                v1.PodCondition(
                    type="DisruptionTarget",
                    status="True",
                    reason="Evicted",
                    message="node was low on resource: memory",
                )
            ]
            self.client.pods.update_status(live)
            self.client.pods.delete(victim.metadata.name, victim.metadata.namespace)
        except APIError:
            pass
