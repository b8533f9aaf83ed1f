"""Controller manager: the kube-controller-manager equivalent.

Reference: cmd/kube-controller-manager/app/controllermanager.go —
NewControllerInitializers (:387) maps names to start funcs; Run (:174)
leader-elects, builds the shared informer factory, starts every enabled
loop. Here the initializers build from one clientset + informer factory
and run as daemon threads.
"""

from __future__ import annotations

import random
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..api.metrics import controller_healthy, controller_restarts_total
from ..client.informer import SharedInformerFactory
from ..client.leaderelection import LeaderElectionConfig, LeaderElector
from .attachdetach import AttachDetachController
from .bootstrap import BootstrapSignerController, TokenCleanerController
from .certificates import (
    CSRApprovingController,
    CSRCleanerController,
    CSRSigningController,
)
from .clusterroleaggregation import ClusterRoleAggregationController
from .cronjob import CronJobController
from .endpointslicemirroring import EndpointSliceMirroringController
from .ephemeral import EphemeralVolumeController, ExpandController
from .rootcacertpublisher import RootCACertPublisher
from .daemonset import DaemonSetController
from .deployment import DeploymentController
from .disruption import DisruptionController
from .endpoints import EndpointsController
from .endpointslice import EndpointSliceController
from .garbagecollector import GarbageCollector
from .job import JobController
from .namespace import NamespaceController
from .nodelifecycle import NodeLifecycleController
from .nodeipam import NodeIpamController
from .nodettl import TTLController
from .persistentvolume import PersistentVolumeController
from .podautoscaler import HorizontalController
from .podgc import PodGCController
from .replicaset import ReplicaSetController
from .replication import ReplicationControllerController
from .resourcequota import ResourceQuotaController
from .serviceaccount import ServiceAccountController, TokensController
from .statefulset import StatefulSetController
from .ttlafterfinished import TTLAfterFinishedController
from .volumeprotection import PVCProtectionController, PVProtectionController


def _metrics_api_source(cs):
    from ..api.metrics import pod_metrics_source

    return pod_metrics_source(cs)


def new_controller_initializers() -> Dict[str, Callable]:
    """controllermanager.go:387 NewControllerInitializers equivalent."""
    return {
        "replicaset": lambda cs, inf, opts: ReplicaSetController(cs, inf),
        "deployment": lambda cs, inf, opts: DeploymentController(cs, inf),
        "daemonset": lambda cs, inf, opts: DaemonSetController(cs, inf),
        "statefulset": lambda cs, inf, opts: StatefulSetController(cs, inf),
        "job": lambda cs, inf, opts: JobController(cs, inf),
        "endpoint": lambda cs, inf, opts: EndpointsController(cs, inf),
        "endpointslice": lambda cs, inf, opts: EndpointSliceController(cs, inf),
        "namespace": lambda cs, inf, opts: NamespaceController(cs, inf),
        "garbagecollector": lambda cs, inf, opts: GarbageCollector(cs),
        "persistentvolume-binder": lambda cs, inf, opts: PersistentVolumeController(
            cs, inf
        ),
        "nodelifecycle": lambda cs, inf, opts: NodeLifecycleController(
            cs,
            inf,
            node_monitor_period=opts.get("node_monitor_period", 5.0),
            node_monitor_grace_period=opts.get("node_monitor_grace_period", 40.0),
        ),
        "cronjob": lambda cs, inf, opts: CronJobController(
            cs, inf, sync_period=opts.get("cronjob_sync_period", 10.0)
        ),
        "ttl-after-finished": lambda cs, inf, opts: TTLAfterFinishedController(
            cs, inf, sync_period=opts.get("ttl_sync_period", 5.0)
        ),
        "disruption": lambda cs, inf, opts: DisruptionController(cs, inf),
        "horizontalpodautoscaling": lambda cs, inf, opts: HorizontalController(
            cs,
            inf,
            # default source: the metrics API (metrics-server objects),
            # exactly what the reference HPA consumes
            metrics=opts.get("hpa_metrics") or _metrics_api_source(cs),
            sync_period=opts.get("hpa_sync_period", 15.0),
        ),
        "resourcequota": lambda cs, inf, opts: ResourceQuotaController(
            cs, inf, sync_period=opts.get("quota_sync_period", 5.0)
        ),
        "podgc": lambda cs, inf, opts: PodGCController(
            cs, inf,
            terminated_pod_threshold=opts.get("terminated_pod_threshold", 12500),
            sync_period=opts.get("podgc_sync_period", 20.0),
        ),
        "serviceaccount": lambda cs, inf, opts: ServiceAccountController(cs, inf),
        "serviceaccount-token": lambda cs, inf, opts: TokensController(
            cs, inf, mint=opts.get("token_minter")
        ),
        "replicationcontroller": lambda cs, inf, opts: (
            ReplicationControllerController(cs, inf)
        ),
        "attachdetach": lambda cs, inf, opts: AttachDetachController(
            cs, inf, sync_period=opts.get("attach_detach_sync_period", 1.0)
        ),
        "pvc-protection": lambda cs, inf, opts: PVCProtectionController(cs, inf),
        "pv-protection": lambda cs, inf, opts: PVProtectionController(cs, inf),
        "ttl": lambda cs, inf, opts: TTLController(cs, inf),
        # central podCIDR range allocator (controllermanager.go:412
        # startNodeIpamController; ipam/range_allocator.go:47)
        "nodeipam": lambda cs, inf, opts: NodeIpamController(
            cs, inf,
            cluster_cidr=opts.get("cluster_cidr", "10.244.0.0/16"),
            node_cidr_mask_size=opts.get("node_cidr_mask_size", 24),
        ),
        # round-3 long tail (controllermanager.go:391,406-428)
        "csrsigning": lambda cs, inf, opts: CSRSigningController(
            cs, inf, ca=opts.get("csr_ca") or _default_ca(opts)
        ),
        "csrapproving": lambda cs, inf, opts: CSRApprovingController(cs, inf),
        "csrcleaner": lambda cs, inf, opts: CSRCleanerController(
            cs, inf, sync_period=opts.get("csr_cleaner_period", 60.0)
        ),
        "bootstrapsigner": lambda cs, inf, opts: BootstrapSignerController(
            cs, inf
        ),
        "tokencleaner": lambda cs, inf, opts: TokenCleanerController(
            cs, inf, sync_period=opts.get("token_cleaner_period", 10.0)
        ),
        "clusterrole-aggregation": lambda cs, inf, opts: (
            ClusterRoleAggregationController(cs, inf)
        ),
        "endpointslicemirroring": lambda cs, inf, opts: (
            EndpointSliceMirroringController(cs, inf)
        ),
        "ephemeral-volume": lambda cs, inf, opts: EphemeralVolumeController(
            cs, inf
        ),
        "persistentvolume-expander": lambda cs, inf, opts: ExpandController(
            cs, inf
        ),
        # the published bundle must anchor the SAME CA the CSR signer
        # uses: prefer an explicit root_ca, then the operator's csr_ca,
        # then the shared per-manager default
        "root-ca-cert-publisher": lambda cs, inf, opts: RootCACertPublisher(
            cs, inf, root_ca=opts.get("root_ca", "")
            or (opts.get("csr_ca") or _default_ca(opts)).public_bundle()
        ),
    }


def _default_ca(opts):
    """One shared CertificateAuthority per manager options dict: the CSR
    signer and the root-CA publisher must agree on the CA identity when
    the operator supplies neither."""
    ca = opts.get("_default_ca")
    if ca is None:
        from .. import kubeadm

        ca = kubeadm.CertificateAuthority()
        opts["_default_ca"] = ca
    return ca


class _Supervised:
    """One controller loop under supervision."""

    def __init__(self, name: str, controller, factory: Callable[[], object]):
        self.name = name
        self.controller = controller
        self.factory = factory  # builds a FRESH instance for a restart
        self.on_rebuild: Optional[Callable[[str, object], None]] = None
        self.on_retire: Optional[Callable[[str, object], None]] = None
        self.restarts = 0
        self.running = threading.Event()
        self.kill = threading.Event()  # chaos/drill hook: treat as crashed


class Supervisor:
    """kube-controller-manager's crash containment at per-loop granularity.

    The reference components die whole-process on a loop panic and lean on
    the kubelet/systemd to restart them (crash-and-restart HA). In one
    process that model would take every healthy controller down with the
    sick one, so the supervisor isolates each loop instead: a controller
    whose threads die (or whose run() raises) is stopped, counted, rebuilt
    from its initializer, and restarted with capped exponential backoff +
    full jitter — while every other loop keeps running. Health/restart
    state is exported via api/metrics.py (controller_restarts_total,
    controller_healthy); restarts are fenced through `fence` so a manager
    that lost its leader lease yields instead of touching state.
    """

    def __init__(
        self,
        base_backoff: float = 0.2,
        max_backoff: float = 30.0,
        jitter: float = 0.2,
        probe_period: float = 0.1,
        healthy_reset: float = 60.0,
        fence: Optional[Callable[[], bool]] = None,
        rng: Optional[random.Random] = None,
    ):
        self._base = base_backoff
        self._max = max_backoff
        self._jitter = jitter
        self._probe = probe_period
        self._healthy_reset = healthy_reset
        self._fence = fence
        self._rng = rng or random.Random()
        self._entries: Dict[str, _Supervised] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- registration / lifecycle ------------------------------------------

    def supervise(
        self,
        name: str,
        controller,
        factory: Callable[[], object],
        on_rebuild: Optional[Callable[[str, object], None]] = None,
        on_retire: Optional[Callable[[str, object], None]] = None,
    ) -> None:
        e = _Supervised(name, controller, factory)
        e.on_rebuild = on_rebuild
        e.on_retire = on_retire
        self._entries[name] = e

    def start(self) -> None:
        """First start is synchronous (callers rely on loops running when
        this returns, exactly like the unsupervised path); the monitors
        that restart crashed loops run in the background."""
        for e in self._entries.values():
            if not self._wait_fence():
                return
            try:
                e.controller.run()
                e.running.set()
                controller_healthy.set(1, controller=e.name)
            except Exception:  # noqa: BLE001 — panic isolation starts here
                traceback.print_exc()
                e.kill.set()  # the monitor's backoff path restarts it
            t = threading.Thread(
                target=self._monitor, args=(e,),
                name=f"supervise-{e.name}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        for e in self._entries.values():
            try:
                e.controller.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
            e.running.clear()

    # -- introspection (tests, chaos, metrics scrapers) --------------------

    def names(self) -> List[str]:
        return list(self._entries)

    def running(self, name: str) -> bool:
        return self._entries[name].running.is_set()

    def restart_count(self, name: str) -> int:
        return self._entries[name].restarts

    def wait_running(self, name: str, timeout: float = 30.0) -> bool:
        return self._entries[name].running.wait(timeout)

    def crash(self, name: str) -> None:
        """Drill hook: mark the loop crashed; the monitor stops it and
        restarts it through the normal backoff path (ChaosMonkey's
        crash-controller disruption)."""
        self._entries[name].kill.set()

    # -- the per-loop monitor ----------------------------------------------

    @staticmethod
    def _loop_threads(ctrl) -> List[threading.Thread]:
        threads = list(getattr(ctrl, "_threads", ()) or ())
        for attr in ("_thread", "_scan_thread"):
            t = getattr(ctrl, attr, None)
            if isinstance(t, threading.Thread):
                threads.append(t)
        return [t for t in threads if t.ident is not None]  # started only

    def _crashed(self, e: _Supervised) -> bool:
        if e.kill.is_set():
            return True
        return any(not t.is_alive() for t in self._loop_threads(e.controller))

    def _wait_fence(self) -> bool:
        """Block until we may touch state: a restarted manager re-acquires
        (or cleanly yields) the leader lease before any loop runs."""
        while not self._stop.is_set():
            try:
                if self._fence is None or self._fence():
                    return True
            except Exception:  # noqa: BLE001 — a broken fence must not spin-kill
                pass
            self._stop.wait(self._probe)
        return False

    def _monitor(self, e: _Supervised) -> None:
        backoff = self._base
        while not self._stop.is_set():
            healthy_since = time.monotonic()
            while not self._stop.wait(self._probe):
                if self._crashed(e):
                    break
                if time.monotonic() - healthy_since >= self._healthy_reset:
                    backoff = self._base  # stayed up long enough: forgive
            if self._stop.is_set():
                return
            # contain the crash: count it, stop the wreck, back off, rebuild
            e.running.clear()
            controller_healthy.set(0, controller=e.name)
            e.restarts += 1
            controller_restarts_total.inc(controller=e.name)
            try:
                e.controller.stop()
            except Exception:  # noqa: BLE001 — the loop is already dead
                pass
            if e.on_retire is not None:
                # drop the dead instance's informer event handlers: the
                # rebuild registers a fresh set, and without retirement
                # every restart would leak one full handler fan-out
                try:
                    e.on_retire(e.name, e.controller)
                except Exception:  # noqa: BLE001
                    pass
            delay = min(backoff, self._max) * (1 + self._jitter * self._rng.random())
            backoff = min(backoff * 2, self._max)
            if self._stop.wait(delay):
                return
            if not self._wait_fence():
                return
            e.kill.clear()
            try:
                fresh = e.factory()
                fresh.run()
            except Exception:  # noqa: BLE001 — rebuild crashed: next round
                traceback.print_exc()
                e.kill.set()
                continue
            e.controller = fresh
            if e.on_rebuild is not None:
                e.on_rebuild(e.name, fresh)
            e.running.set()
            controller_healthy.set(1, controller=e.name)


class ControllerManager:
    def __init__(
        self,
        clientset,
        controllers: Optional[List[str]] = None,
        leader_elect: bool = False,
        identity: str = "kcm",
        supervised: bool = True,
        supervisor_opts: Optional[Dict] = None,
        **opts,
    ):
        self.client = clientset
        self.informers = SharedInformerFactory(clientset)
        self._opts = opts
        self._inits = new_controller_initializers()
        names = controllers if controllers is not None else list(self._inits)
        # informer handlers registered by each controller's __init__, so a
        # supervised restart can retire the dead instance's fan-out
        self._build_lock = threading.Lock()
        self._handler_sets: Dict[str, List] = {}
        self.controllers = {name: self._build(name) for name in names}
        self._elector: Optional[LeaderElector] = None
        if leader_elect:
            self._elector = LeaderElector(
                clientset,
                LeaderElectionConfig(
                    lock_name="kube-controller-manager",
                    lock_namespace="kube-system",
                    identity=identity,
                ),
                on_started_leading=self._start_all,
                on_stopped_leading=self.stop,
            )
        self.supervisor: Optional[Supervisor] = None
        if supervised:
            self.supervisor = Supervisor(
                fence=self._fence, **(supervisor_opts or {})
            )
            for name in names:
                self.supervisor.supervise(
                    name,
                    self.controllers[name],
                    factory=lambda n=name: self._build(n),
                    on_rebuild=self._on_rebuild,
                    on_retire=self._retire,
                )

    def _build(self, name: str):
        """Construct one controller, recording which informer event
        handlers its __init__ registered (diff around construction; the
        lock keeps concurrent supervisor rebuilds from attributing each
        other's handlers)."""
        with self._build_lock:
            before = {
                res: set(map(id, inf.event_handlers()))
                for res, inf in self.informers.informers().items()
            }
            ctrl = None
            try:
                ctrl = self._inits[name](self.client, self.informers, self._opts)
            finally:
                added = []
                for res, inf in self.informers.informers().items():
                    seen = before.get(res, set())
                    for h in inf.event_handlers():
                        if id(h) not in seen:
                            added.append((inf, h))
                if ctrl is None:  # construction raised: unhook its partials
                    for inf, handler in added:
                        inf.remove_event_handler(handler)
                else:
                    self._handler_sets[name] = added
            return ctrl

    def _retire(self, name: str, ctrl) -> None:
        for inf, handler in self._handler_sets.pop(name, []):
            inf.remove_event_handler(handler)

    def _fence(self) -> bool:
        """Restart fencing: loops only (re)start while we hold the lease
        (or no election is configured at all)."""
        return self._elector is None or self._elector.is_leader.is_set()

    def _on_rebuild(self, name: str, ctrl) -> None:
        self.controllers[name] = ctrl

    def run(self, wait_sync: float = 10.0) -> None:
        self.informers.start()
        self.informers.wait_for_cache_sync(wait_sync)
        if self._elector is not None:
            self._elector.start()
        else:
            self._start_all()

    def _start_all(self) -> None:
        if self.supervisor is not None:
            self.supervisor.start()
        else:
            for ctrl in self.controllers.values():
                ctrl.run()

    def stop(self) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        else:
            for ctrl in self.controllers.values():
                ctrl.stop()
        self.informers.stop()
        if self._elector is not None:
            self._elector.stop()
