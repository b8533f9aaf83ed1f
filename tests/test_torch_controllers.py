"""The port's workload controllers (kubernetes_tpu_torch/controllers/) hold
to the reference's, on the CPU.

- The cases of tests/test_controllers.py run against each package
  (tests/_dual.py): ReplicaSet, Deployment, Job, DaemonSet, StatefulSet,
  Endpoints, Namespace, the garbage collector and node lifecycle.
- Controller-made pods schedule the same way in both packages. One
  60-node, 3-zone cluster drawn from a numpy seed goes through each
  package's apiserver (with `install_default_admission`), informers,
  Deployment and ReplicaSet controllers, NodeLifecycleController and
  Scheduler: the port's with `TPUBackend(device="cpu")` on its kernel rung
  (the scan kernels' plain versions), the reference's with its backend on
  JAX's CPU. A Deployment of 120 zone-spread replicas (chip_smoke.py
  `web_deployment`, phase 17a's) rolls out, then rolls to a new template
  (maxSurge 25 %, maxUnavailable 25 %); then four
  nodes holding its pods stop heartbeating, are tainted and drained, and
  the ReplicaSet re-creates the evicted pods. Each ReplicaSet's per-node
  pod counts must be equal between the packages after the first rollout,
  after the update and after the re-binds. Pod names come from
  `random.choices` (controllers/base.py `rand_suffix`); the pods of one
  ReplicaSet are identical, so the counts do not depend on the names.

The driver runs in lock step, so that both packages see the same order of
events: the informers catch up with the apiserver, each controller syncs
the keys it has queued (as its worker would), the scheduler schedules
every pending pod as one batch and its binds land, and a status writer
marks each bound pod Running and Ready (the kubelet's part, until the
kubelet is ported).

No transition waits on the wall clock, so that a loaded host sees the
same sequence as an idle one:
- the node lifecycle controller and the scheduling queue read the lock
  step's clock (`_Clock`), which moves only where the lock step moves it: a
  node goes stale because the clock passed its grace period, not because
  the host was slow between a lease renewal and the monitor (that race
  once marked live nodes stale, tainted them and evicted their pods,
  and the rollout never converged);
- a key a controller queues for later (the Deployment's 50 ms re-check,
  a conflict's rate-limited retry) is held and released when a round
  found no work, in the order it was queued;
- that same idle point moves the clock past the scheduling queue's
  backoff and its unschedulable flush;
- the backend's dispatch watchdog is far beyond any batch here, and every
  batch must ride the device rung its backend started on.
"""

from __future__ import annotations

import functools
import importlib
import time
import types

import numpy as np
import pytest

import chip_smoke

from ._dual import PACKAGES, cases, run_case

CASES = cases("test_controllers")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case(case, package, request):
    run_case(request, package, case)


N_NODES = 60
REPLICAS = 120
STALE_NODES = 4
SEED = 17


def _mods(package):
    names = ("api.types", "api.apps", "apiserver.server",
             "apiserver.admission", "client", "controllers.base",
             "controllers.deployment", "controllers.replicaset",
             "controllers.nodelifecycle", "scheduler.scheduler",
             "scheduler.tpu_backend", "scheduler.internal.queue")
    return types.SimpleNamespace(**{
        n.replace(".", "_"): importlib.import_module(f"{package}.{n}")
        for n in names})


def _nodes(m):
    """60 nodes over three zones, their sizes drawn from a numpy seed;
    each reports Ready (the kubelet's first status)."""
    v1 = m.api_types
    rng = np.random.default_rng(SEED)
    cpus = rng.choice([2, 4, 8], size=N_NODES)
    mems = rng.choice([8, 16, 32], size=N_NODES)
    now = time.time()
    out = []
    for i in range(N_NODES):
        alloc = {"cpu": str(cpus[i]), "memory": f"{mems[i]}Gi", "pods": "110"}
        out.append(v1.Node(
            metadata=v1.ObjectMeta(name=f"node-{i}", labels={
                v1.LABEL_HOSTNAME: f"node-{i}",
                v1.LABEL_ZONE: f"zone-{i % 3}"}),
            status=v1.NodeStatus(
                capacity=dict(alloc), allocatable=alloc,
                conditions=[v1.NodeCondition(
                    type="Ready", status="True", last_heartbeat_time=now)])))
    return out


class _Clock:
    """The lock step's time, in seconds since the epoch: it starts at the
    wall clock's reading (`ahead` seconds past it) and moves only by
    `advance`."""

    def __init__(self, ahead=0.0):
        self.now = time.time() + ahead

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


# far beyond any batch of these tests, however loaded the host
WATCHDOG_S = 3600.0


class _Lockstep:
    """One package's control plane, driven in lock step (module
    docstring). `extra(lockstep)`, when given, returns more controllers
    (name -> queue controller), synced one key at a time after the
    Deployment and ReplicaSet controllers."""

    CLOCK_AHEAD = 0.0

    def __init__(self, port: bool, extra=None):
        self.package = PACKAGES[1] if port else PACKAGES[0]
        m = self.m = _mods(self.package)
        self.api = m.apiserver_server.APIServer()
        m.apiserver_admission.install_default_admission(self.api)
        self.cs = m.client.Clientset(self.api)
        self.factories = []     # every informer factory settle() waits on
        self.add_nodes()
        # after the nodes: no creation time or heartbeat is ahead of it
        self.clock = _Clock(self.CLOCK_AHEAD)
        self.factory = m.client.SharedInformerFactory(self.cs)
        self.factories.append(self.factory)
        if port:
            be = m.scheduler_tpu_backend.TPUBackend(device="cpu",
                                                     use_kernel=True)
        else:
            from .test_torch_backend import _private_device_state

            be = m.scheduler_tpu_backend.TPUBackend()
            _private_device_state(be.enc)
        be.watchdog_timeout = WATCHDOG_S
        self.be, self.rung = be, be.ladder.rung()
        self.builds = []    # the class of each session the backend built
        build = be._build_session

        def build_session():
            sess = build()
            self.builds.append(type(sess).__name__)
            return sess

        be._build_session = build_session
        self.sched = m.scheduler_scheduler.Scheduler(
            self.cs, self.factory, backend="tpu", tpu_backend=be,
            max_batch=512)
        self.sched.queue._now = self.clock
        self.sched.queue._last_leftover_flush = self.clock()
        self.batches = []   # pods per batch
        self.held = []      # (queue, key) held for the next idle point
        self.deploy = m.controllers_deployment.DeploymentController(
            self.cs, self.factory)
        self.rs = m.controllers_replicaset.ReplicaSetController(
            self.cs, self.factory)
        self.extra = extra(self) if extra else {}
        self.queued = [self.deploy, self.rs, *self.extra.values()]
        for ctrl in self.queued:
            ctrl.queue.add_after = functools.partial(self._hold, ctrl.queue)
        self.nlc = m.controllers_nodelifecycle.NodeLifecycleController(
            self.cs, self.factory, node_monitor_grace_period=0.5)
        # the clocked modules read the lock step's clock until close()
        self._clocked = [(mod, mod.time) for mod in self.clocked_modules()]
        for mod, _ in self._clocked:
            mod.time = types.SimpleNamespace(time=self.clock,
                                             monotonic=time.monotonic)
        try:
            for factory in self.factories:
                factory.start()
                assert factory.wait_for_cache_sync()
            self.heartbeat()
            # every node reports Ready: the not-ready taint admission put
            # on it at registration comes off
            self.nlc.monitor_node_health()
            self.settle()
            assert not any(n.spec.taints for n in self.cs.nodes.list()[0])
        except BaseException:
            self.close()
            raise

    def add_nodes(self):
        """The cluster's nodes, registered before the clock starts."""
        for node in _nodes(self.m):
            self.cs.nodes.create(node)

    def clocked_modules(self):
        """The modules whose `time.time()` is the lock step's clock."""
        return [self.m.controllers_nodelifecycle]

    def close(self):
        for mod, orig in self._clocked:
            mod.time = orig
        self.sched.shutdown()
        for factory in self.factories:
            factory.stop()

    def _hold(self, queue, item, delay):
        """A controller's add_after: the key waits for the next idle
        point."""
        if delay <= 0:
            queue.add(item)
        else:
            self.held.append((queue, item))

    def idle(self):
        """A round found no work: the held keys are queued in the order
        they were held, and the clock passes every scheduling backoff and
        the unschedulable pods' flush."""
        held, self.held = self.held, []
        for queue, item in held:
            queue.add(item)
        self.clock.advance(
            self.m.scheduler_internal_queue.UNSCHEDULABLE_Q_TIME_INTERVAL)

    def heartbeat(self, skip=()):
        """The kubelets' lease renewals, but those of the nodes in `skip`."""
        v1 = self.m.api_types
        leases = self.cs.resource("leases")
        for i in range(N_NODES):
            name = f"node-{i}"
            if name in skip:
                continue
            try:
                lease = leases.get(name, "kube-node-lease")
            except self.m.apiserver_server.NotFound:
                lease = leases.create(v1.Lease(
                    metadata=v1.ObjectMeta(name=name,
                                           namespace="kube-node-lease"),
                    spec=v1.LeaseSpec(holder_identity=name)))
            lease.spec.renew_time = self.clock()
            leases.update(lease)
        self.settle()

    def settle(self, timeout=30.0):
        """Until every informer holds what the apiserver holds."""
        deadline = time.monotonic() + timeout
        infs = [(resource, inf) for factory in self.factories
                for resource, inf in factory.informers().items()]
        while True:
            behind = []
            for resource, inf in infs:
                items, _ = self.api.list(resource)
                want = {(o.metadata.namespace, o.metadata.name):
                        o.metadata.resource_version for o in items}
                have = {(o.metadata.namespace, o.metadata.name):
                        o.metadata.resource_version for o in inf.list()}
                if want != have:
                    behind.append(resource)
            if not behind:
                return
            assert time.monotonic() < deadline, f"informers behind: {behind}"
            time.sleep(0.01)

    def sync_one(self, ctrl):
        """Sync the first key the controller has queued, as its worker
        does; False when it has none."""
        server = self.m.apiserver_server
        key, _ = ctrl.queue.get(timeout=0)
        if key is None:
            return False
        try:
            ctrl.sync(key)
        except (server.AlreadyExists, server.Conflict):
            ctrl.queue.add_rate_limited(key)
        else:
            ctrl.queue.forget(key)
        finally:
            ctrl.queue.done(key)
        return True

    def controllers(self):
        """One key at a time, the informers caught up before each, until
        no controller has a key queued; the first controller of
        `self.queued` that has a key goes first."""
        work = 0
        while True:
            self.settle()
            if not any(self.sync_one(c) for c in self.queued):
                return work
            work += 1

    def schedule(self):
        """Every pending pod in one batch; its binds landed."""
        sched = self.sched
        infos = []
        while True:
            info = sched.queue.pop(timeout=0)
            if info is None:
                break
            infos.append(info)
        if not infos:
            return 0
        sched._schedule_batch_tpu(infos)
        assert sched._drain_pipeline(timeout=30)
        # the batch rode the device rung: no fault moved the ladder
        assert self.be.ladder.rung() == self.rung
        assert not self.be.ladder.transitions
        self.batches.append(len(infos))
        deadline = time.monotonic() + 30
        while True:
            with sched._inflight_lock:
                if sched._inflight == 0:
                    break
            assert time.monotonic() < deadline, "binds did not land"
            time.sleep(0.005)
        self.settle()
        return len(infos)

    def mark_ready(self):
        """The status writer: each bound pod Running and Ready."""
        v1 = self.m.api_types
        n = 0
        for pod in self.cs.pods.list(namespace="default")[0]:
            if not pod.spec.node_name or pod.status.phase == "Running":
                continue
            pod.status.phase = "Running"
            pod.status.start_time = time.time()
            pod.status.conditions = [v1.PodCondition(type="Ready",
                                                     status="True")]
            self.cs.pods.update_status(pod)
            n += 1
        self.settle()
        return n

    def run_until(self, done, rounds=400, periodic=None):
        """Rounds of every controller, one batch and the status writer
        until `done()`. `periodic()`, when given, opens each round (a
        periodic controller's sync) and returns its work."""
        for _ in range(rounds):
            work = (periodic() if periodic else 0) + self.controllers() \
                + self.schedule() + self.mark_ready()
            if done():
                return
            if not work:
                # a Deployment waiting on availability re-queues itself
                # after 50 ms (controllers/deployment.py): released here
                self.idle()
        raise AssertionError("the controllers did not converge")

    # -- the scenario --------------------------------------------------------

    def rses(self):
        return {rs.metadata.labels["version"]: rs
                for rs in self.cs.replicasets.list(namespace="default")[0]}

    def counts(self):
        """version -> {node: pods of that ReplicaSet}."""
        out = {}
        for pod in self.cs.pods.list(namespace="default")[0]:
            assert pod.spec.node_name, pod.metadata.name
            c = out.setdefault(pod.metadata.labels["version"], {})
            c[pod.spec.node_name] = c.get(pod.spec.node_name, 0) + 1
        return out

    def available(self, version, want):
        rs = self.rses().get(version)
        return rs is not None and rs.status.available_replicas == want

    def rollout(self):
        v1, apps = self.m.api_types, self.m.api_apps
        self.cs.deployments.create(chip_smoke.web_deployment(
            v1, apps, "web", REPLICAS, "v1", "web:1"))
        self.run_until(lambda: self.available("v1", REPLICAS))
        first = self.counts()
        live = self.cs.deployments.get("web", "default")
        live.spec.template = chip_smoke.web_deployment(
            v1, apps, "web", REPLICAS, "v2", "web:2").spec.template
        self.cs.deployments.update(live)

        def rolled():
            rses = self.rses()
            return ("v1" in rses and rses["v1"].status.replicas == 0
                    and self.available("v2", REPLICAS))

        self.run_until(rolled)
        return first, self.counts()

    def partition(self):
        """Four nodes holding v2 pods stop heartbeating; the controller
        taints them and evicts their pods; the ReplicaSet re-creates them.
        -> (the stale nodes, their taint seen, the counts after)."""
        v1 = self.m.api_types
        counts = self.counts()["v2"]
        stale = sorted(counts, key=lambda n: int(n.split("-")[1]))[
            :STALE_NODES]
        # their last heartbeat older than the grace period; every other
        # node renews its lease
        self.clock.advance(2 * self.nlc.grace_period)
        self.heartbeat(skip=stale)
        # monitor periods: the first marks Ready Unknown, and a taint
        # written from the same informer copy conflicts until the next
        for _ in range(3):
            self.nlc.monitor_node_health()
            self.settle()
        tainted = {n.metadata.name for n in self.cs.nodes.list()[0]
                   if any(t.key == v1.TAINT_NODE_UNREACHABLE
                          and t.effect == "NoExecute"
                          for t in n.spec.taints or [])}
        self.nlc.process_evictions()
        self.settle()
        self.run_until(lambda: self.available("v2", REPLICAS))
        return stale, tainted, self.counts()


_RESULTS = {}


def _scenario(port):
    if port not in _RESULTS:
        run = _Lockstep(port)
        try:
            first, updated = run.rollout()
            stale, tainted, evicted = run.partition()
            _RESULTS[port] = dict(first=first, updated=updated, stale=stale,
                                  tainted=tainted, evicted=evicted)
        finally:
            run.close()
    return _RESULTS[port]


def _zone_skew(counts):
    zones = [0, 0, 0]
    for node, n in counts.items():
        zones[int(node.split("-")[1]) % 3] += n
    return max(zones) - min(zones)


def test_rollout_places_as_reference():
    """Per-node counts of each ReplicaSet equal after the first rollout
    and after the rolling update; each ReplicaSet spread over the zones
    within its maxSkew; the old one drained."""
    ref, got = _scenario(False), _scenario(True)
    assert got["first"] == ref["first"]
    assert got["updated"] == ref["updated"]
    assert sum(got["first"]["v1"].values()) == REPLICAS
    assert list(got["updated"]) == ["v2"]
    assert sum(got["updated"]["v2"].values()) == REPLICAS
    assert _zone_skew(got["first"]["v1"]) <= 1
    assert _zone_skew(got["updated"]["v2"]) <= 1


def test_eviction_rebinds_as_reference():
    """Four stale nodes: tainted NoExecute, their pods evicted and
    re-created, none back on a tainted node, the per-node counts equal."""
    ref, got = _scenario(False), _scenario(True)
    assert got["stale"] == ref["stale"]
    assert got["tainted"] == ref["tainted"] == set(got["stale"])
    assert got["evicted"] == ref["evicted"]
    v2 = got["evicted"]["v2"]
    assert sum(v2.values()) == REPLICAS
    assert not set(v2) & got["tainted"]
    moved = sum(got["updated"]["v2"][n] for n in got["stale"])
    assert moved >= STALE_NODES
