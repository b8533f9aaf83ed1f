"""Cluster bootstrap: bring up a whole control plane in one call.

Reference: cmd/kubeadm's init flow wires the control-plane components
(etcd, apiserver, controller-manager, scheduler) and joins nodes; this is
the in-process equivalent — one object that assembles the store (Python
or native C++), apiserver (+ default admission chain + CRDs), controller
manager, scheduler (oracle or TPU backend), per-node proxies, and hollow
kubelets, with /configz entries installed for each component. Tests and
demos use it as `with Cluster(n_nodes=4) as c: c.kubectl(...)`.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional

from .apiserver.admission import install_default_admission
from .apiserver.crd import CRDManager
from .apiserver.server import APIServer
from .client.clientset import Clientset
from .client.informer import SharedInformerFactory
from .controllers.manager import ControllerManager
from .kubectl import Kubectl
from .kubemark import HollowCluster
from .proxy import Proxier
from .scheduler.apis.config import default_configuration
from .scheduler.factory import create_scheduler
from .utils import configz
from .utils.featuregate import default_feature_gate

DEFAULT_CONTROLLERS = [
    "replicaset",
    "deployment",
    "daemonset",
    "statefulset",
    "job",
    "cronjob",
    "ttl-after-finished",
    "endpoint",
    "endpointslice",
    "namespace",
    "garbagecollector",
    "persistentvolume-binder",
    "nodelifecycle",
    "disruption",
    "resourcequota",
    "podgc",
    "serviceaccount",
    "serviceaccount-token",
    "replicationcontroller",
    "attachdetach",
    "pvc-protection",
    "pv-protection",
    "ttl",
]

FAST_NODE_CONFIG = dict(
    sync_period=0.5,
    pleg_period=0.1,
    housekeeping_period=0.3,
    lease_renew_period=0.3,
    node_status_period=0.3,
)


class Cluster:
    def __init__(
        self,
        n_nodes: int = 0,
        controllers: Optional[List[str]] = None,
        scheduler_backend: Optional[str] = None,
        native_store: bool = False,
        durable_path: Optional[str] = None,
        feature_gates: str = "",
        admission: bool = True,
        proxies: bool = False,
        metrics_server: bool = False,
        node_config: Optional[Dict] = None,
        controller_opts: Optional[Dict] = None,
        fault_injector=None,
        n_schedulers: int = 1,
        leader_election: bool = False,
        election_opts: Optional[Dict] = None,
        scheduler_config=None,
        # the schedulers' device: the card unless the caller names another
        device=None,
    ):
        # save the process-global gate overrides so stop() can restore them
        # (gates must not leak across Cluster instances)
        self._fg_saved = default_feature_gate.overrides()
        try:
            self._init(
                n_nodes,
                controllers,
                scheduler_backend,
                native_store,
                durable_path,
                feature_gates,
                admission,
                proxies,
                metrics_server,
                node_config,
                controller_opts,
                fault_injector,
                n_schedulers,
                leader_election,
                election_opts,
                scheduler_config,
                device,
            )
        except BaseException:
            default_feature_gate.restore(self._fg_saved)
            raise

    def _init(
        self,
        n_nodes,
        controllers,
        scheduler_backend,
        native_store,
        durable_path,
        feature_gates,
        admission,
        proxies,
        metrics_server,
        node_config,
        controller_opts,
        fault_injector=None,
        n_schedulers=1,
        leader_election=False,
        election_opts=None,
        scheduler_config=None,
        device=None,
    ) -> None:
        if feature_gates:
            default_feature_gate.set_from_string(feature_gates)
        if native_store and durable_path:
            raise ValueError("native_store and durable_path are exclusive")
        store = None
        if native_store:
            from .store.native import NativeKVStore

            store = NativeKVStore()
        elif durable_path:
            # WAL+snapshot-backed control plane: survives crash_drill /
            # ChaosMonkey crash-apiserver disruptions with zero lost
            # acknowledged writes
            from .store.kv import DurableKVStore

            store = DurableKVStore(durable_path)
        self.api = APIServer(store=store)
        if admission:
            install_default_admission(self.api)
        self.crds = CRDManager(self.api).install()
        self.client = Clientset(self.api)
        self.hollow: Optional[HollowCluster] = None
        if n_nodes:
            self.hollow = HollowCluster(
                self.client,
                n_nodes=n_nodes,
                config_overrides=node_config or FAST_NODE_CONFIG,
            )
        self.kcm = ControllerManager(
            self.client,
            controllers=controllers if controllers is not None else DEFAULT_CONTROLLERS,
            **(controller_opts or {}),
        )
        self.proxiers: List[Proxier] = []
        if proxies and self.hollow is not None:
            for kl in self.hollow.kubelets:
                self.proxiers.append(
                    Proxier(self.kcm.informers, node_name=kl.config.node_name)
                )
        # scheduler_config: full KubeSchedulerConfiguration override (e.g.
        # apis.config.gang_configuration() for gang drills); the
        # scheduler_backend kwarg still applies on top
        self.scheduler_config = (
            scheduler_config
            if scheduler_config is not None
            else default_configuration()
        )
        if scheduler_backend:
            for profile in self.scheduler_config.profiles:
                profile.backend = scheduler_backend
        # HA scheduling: n_schedulers instances, each with its OWN
        # informer factory (independent watch streams — a partition or
        # crash of one must not stall the others' relists), racing for
        # one leader lease; only the holder pops pods, and every write
        # it issues is fenced with the lease epoch
        elect = leader_election or n_schedulers > 1
        self._sched_factories: List[SharedInformerFactory] = []
        self.schedulers: List = []
        # every scheduler instance's TPUBackend runs on `device`
        from functools import partial
        from .scheduler import factory as device_factory

        create_scheduler = partial(device_factory.create_scheduler, device=device)
        for i in range(max(1, n_schedulers)):
            factory = SharedInformerFactory(self.client)
            sched = create_scheduler(self.client, factory, self.scheduler_config)
            if elect:
                from .client.leaderelection import LeaderElectionConfig

                cfg = LeaderElectionConfig(**(election_opts or {}))
                sched.enable_leader_election(
                    f"{sched.profile_name}-{i}", config=cfg
                )
            self._sched_factories.append(factory)
            self.schedulers.append(sched)
        self._sched_factory = self._sched_factories[0]
        self.scheduler = self.schedulers[0]
        if fault_injector is not None:
            # fault drills (scripts/fault_drill.py, ChaosMonkey
            # wedge-device/crash-scheduler) arm device/worker faults here
            self.scheduler.install_fault_injector(fault_injector)
        self.metrics_server = None
        if metrics_server:
            from .api.metrics import MetricsServer

            self.metrics_server = MetricsServer(self.client, period=2.0)
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Cluster":
        try:
            if self.hollow is not None:
                self.hollow.start()
            self.kcm.run()
            for factory in self._sched_factories:
                factory.start()
                if not factory.wait_for_cache_sync():
                    raise RuntimeError("scheduler informers failed to sync")
            for sched in self.schedulers:
                sched.start()
            if self.metrics_server is not None:
                self.metrics_server.run()
            self._fg_state = default_feature_gate.state()
            configz.install("kubescheduler.config.k8s.io", self.scheduler_config)
            configz.install("featuregates", self._fg_state)
        except BaseException:
            # partial start must not leak component threads or gate
            # overrides (the context manager's __exit__ never runs when
            # __enter__ raises)
            self._teardown()
            raise
        self._started = True
        return self

    def stop(self) -> None:
        if not self._started:
            return
        self._teardown()

    def _teardown(self) -> None:
        for closer in (
            self.metrics_server.stop if self.metrics_server is not None else None,
            # shutdown (vs stop) joins the pipeline worker threads and
            # flushes the completion FIFO deterministically — tests must
            # not lean on daemon-thread teardown
            *[s.shutdown for s in self.schedulers],
            *[f.stop for f in self._sched_factories],
            self.kcm.stop,
            self.hollow.stop if self.hollow is not None else None,
        ):
            if closer is None:
                continue
            try:
                closer()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        store = getattr(self.api, "store", None)
        if hasattr(store, "close"):  # durable store: fsync + release the WAL
            try:
                store.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        # only remove OUR entries (another live cluster may have
        # re-installed the canonical names) and restore gate overrides
        configz.delete_if_is("kubescheduler.config.k8s.io", self.scheduler_config)
        if getattr(self, "_fg_state", None) is not None:
            configz.delete_if_is("featuregates", self._fg_state)
        default_feature_gate.restore(self._fg_saved)
        self._started = False

    def __enter__(self) -> "Cluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- conveniences -------------------------------------------------------

    @property
    def active_scheduler(self):
        """The instance currently holding the leader lease (the only one
        popping pods); the sole scheduler when election is off."""
        for s in self.schedulers:
            if s.elector is not None and s.elector.is_leader.is_set():
                return s
        return self.scheduler

    def kubectl(self, *argv: str) -> str:
        """Run a kubectl command; returns its output (raises on rc != 0)."""
        out = io.StringIO()
        rc = Kubectl(self.client, out=out).run(list(argv))
        if rc != 0:
            raise RuntimeError(f"kubectl {' '.join(argv)} failed:\n{out.getvalue()}")
        return out.getvalue()
