"""The kubelet and kube-proxy (ROADMAP.md Queue 1, 10d and 10e) behave
the same in both packages, on the CPU.

Kubelets. tests/test_torch_controllers.py's lock step (`_Lockstep`: 60
seeded nodes over three zones, the Deployment and ReplicaSet
controllers, node lifecycle, the scheduler on `TPUBackend(device="cpu")`
against the reference's backend, informers caught up between steps, no
transition on the wall clock) loses its status writer: each package's
own `Kubelet`s register the nodes and run the pods. No kubelet thread is
started. A kubelet round steps every live kubelet in node order: its
event queue drained (the latest event of each pod, in the order the pods
first came) into a synchronous `_dispatch` (`_sync_pod`, or
`_terminate_pod` for a pod it ran), then `_pleg_pass` (which runs
`_probe_pass`), `_resync_all` and `_housekeeping` once their periods
passed on the lock step's clock (the sync loop's timers; the resync is
what starts a pod's app containers after an init container that exited
at once, which PLEG reports no event for), `_update_node_status` and
one lease renewal, all under the lock step's clock. The global `random` (the controllers' pod-name
suffixes) is seeded alike before each package's run, so the pods' names
match.

The scenario: a Deployment of 120 zone-spread replicas rolls out and
rolls to a new template; a pod with an init container and a failing
readiness probe starts, then its probe heals; a container that exits
with code 1 at every start crash-loops; then one kubelet is no longer
stepped, its node goes stale, is tainted NoExecute, and its pods are
evicted and rebound. At each checkpoint the packages must agree on each
pod's node, phase, conditions, container states, restart counts and IP,
on each node's conditions and taints, and on each runtime's sandboxes
and containers with their ids masked.

Proxies. The same Services (ClusterIP, NodePort, ClientIP affinity, one
with no ready endpoint) and EndpointSlices, drawn from a numpy seed, go
through each package's apiserver and informers into a `Proxier` (with a
seeded `random.Random`) and an `IPVSProxier` per scheduler (rr, lc,
sh). The chains and the virtual servers must be identical, and so must
the routes of 10000 seeded packets (a REJECT or a miss counts as its
exception's type)."""

from __future__ import annotations

import dataclasses
import importlib
import queue
import random

import numpy as np
import pytest

from . import test_torch_controllers as base

SEED = 19
PROBE_PERIOD = 1.0
SYNC_PERIOD = 1.0       # the kubelets' resync, on the lock step's clock
PROBE_ROUNDS = 3
CRASH_ROUNDS = 4
PACKETS = 10000


def _kubelet_mods(package):
    return {n: importlib.import_module(f"{package}.kubelet.{n}")
            for n in ("kubelet", "prober", "cri")}


class _KubeletLockstep(base._Lockstep):
    """`_Lockstep` with each package's kubelets in place of the status
    writer (module docstring). Its clock runs an hour ahead of the wall
    clock: the prober stamps a container's first probe state on the wall
    clock (`_WorkerState.started_at`) and holds the probe back while the
    clock reads earlier than that."""

    CLOCK_AHEAD = 3600.0

    def add_nodes(self):
        m = self.m
        self.kmods = _kubelet_mods(self.package)
        kl_mod = self.kmods["kubelet"]
        self.kl_factory = m.client.SharedInformerFactory(self.cs)
        self.factories.append(self.kl_factory)
        rng = np.random.default_rng(base.SEED)
        cpus = rng.choice([2, 4, 8], size=base.N_NODES)
        mems = rng.choice([8, 16, 32], size=base.N_NODES)
        self.kubelets, self.stopped, self.ran = [], set(), {}
        self.ticks = {}     # node -> the clock at its last resync, cleanup
        for i in range(base.N_NODES):
            cfg = kl_mod.KubeletConfig(
                node_name=f"node-{i}", cpu=str(cpus[i]),
                memory=f"{mems[i]}Gi", max_pods=110,
                labels={m.api_types.LABEL_ZONE: f"zone-{i % 3}"},
                sync_period=SYNC_PERIOD)
            runtime = self.kmods["cri"].FakeRuntimeService(
                ip_prefix=f"10.64.{i}")
            kl = kl_mod.Kubelet(self.cs, self.kl_factory, config=cfg,
                                runtime=runtime)
            kl._dispatch = self._dispatcher(kl)
            kl._register_node()
            self.kubelets.append(kl)

    def clocked_modules(self):
        return super().clocked_modules() + [self.kmods["kubelet"],
                                            self.kmods["prober"]]

    def _dispatcher(self, kl):
        """podWorkers.UpdatePod without a worker thread: the pod synced
        (or torn down) at once."""
        ran = self.ran.setdefault(kl.config.node_name, set())

        def dispatch(pod, deleting):
            uid = kl._pod_uid(pod)
            deleting = deleting or pod.metadata.deletion_timestamp is not None
            with kl._pods_lock:
                if deleting:
                    kl._pods.pop(uid, None)
                else:
                    kl._pods[uid] = pod
            if not deleting:
                ran.add(uid)
                kl._sync_pod(pod)
            elif uid in ran:
                ran.discard(uid)
                kl._terminate_pod(uid)

        return dispatch

    def _renew_lease(self, kl):
        """One pass of the kubelet's lease loop, at the lock step's time."""
        v1 = self.m.api_types
        name, now = kl.config.node_name, self.clock()
        leases = kl.client.resource("leases")
        ns = self.kmods["kubelet"].LEASE_NAMESPACE
        try:
            lease = leases.get(name, ns)
        except self.m.apiserver_server.APIError:
            leases.create(v1.Lease(
                metadata=v1.ObjectMeta(name=name, namespace=ns),
                spec=v1.LeaseSpec(
                    holder_identity=name,
                    lease_duration_seconds=kl.config.lease_duration_seconds,
                    acquire_time=now, renew_time=now)))
            return
        lease.spec.renew_time = now
        leases.update(lease)

    def step(self, kl):
        """One kubelet's round (module docstring)."""
        latest = {}
        while True:
            try:
                kind, pod = kl._events.get_nowait()
            except queue.Empty:
                break
            latest.pop(kl._pod_uid(pod), None)
            latest[kl._pod_uid(pod)] = (kind, pod)
        for kind, pod in latest.values():
            kl._dispatch(pod, deleting=kind == "delete")
        kl._pleg_pass()
        now, cfg = self.clock(), kl.config
        last = self.ticks.setdefault(cfg.node_name, [now, now])
        if now - last[0] >= cfg.sync_period:
            last[0] = now
            kl._resync_all()
        if now - last[1] >= cfg.housekeeping_period:
            last[1] = now
            kl._housekeeping()
        kl._update_node_status()
        self._renew_lease(kl)

    def kubelet_round(self):
        for kl in self.kubelets:
            if kl.config.node_name not in self.stopped:
                self.step(kl)
        self.settle()

    def heartbeat(self, skip=()):
        """The kubelets' round; those of `skip` stop for good."""
        self.stopped |= set(skip)
        self.kubelet_round()

    def mark_ready(self):
        """The kubelets in place of the status writer. -> 0: a crash
        loop writes its status every round, so the round counts no work
        of theirs, and an idle point comes whenever the controllers and
        the scheduler found none."""
        self.kubelet_round()
        return 0

    # -- checkpoints -------------------------------------------------------

    def pods(self):
        out = {}
        for p in self.cs.pods.list(namespace="default")[0]:
            s = p.status
            out[p.metadata.name] = (
                p.spec.node_name, s.phase, s.host_ip, s.pod_ip,
                tuple((c.type, c.status) for c in s.conditions or []),
                tuple((c.name, c.ready, c.restart_count, c.image, c.state,
                       c.exit_code) for c in s.container_statuses or []))
        return out

    def nodes(self):
        return {n.metadata.name: (
            tuple((c.type, c.status, c.reason)
                  for c in n.status.conditions or []),
            tuple((t.key, t.effect) for t in n.spec.taints or []))
            for n in self.cs.nodes.list()[0]}

    def runtimes(self):
        """node -> its sandboxes (pod, state, ip) and containers (pod,
        name, state, exit code, restart count), ids masked."""
        out = {}
        for kl in self.kubelets:
            rt = kl.runtime
            sbs = {sb.id: sb for sb in rt.list_pod_sandboxes()}
            out[kl.config.node_name] = (
                sorted((sb.pod_name, sb.state, sb.ip) for sb in sbs.values()),
                sorted((sbs[c.sandbox_id].pod_name, c.name, c.state,
                        c.exit_code, c.restart_count)
                       for c in rt.list_containers()))
        return out

    def checkpoint(self):
        return dict(pods=self.pods(), nodes=self.nodes(),
                    runtimes=self.runtimes())

    # -- the scenario --------------------------------------------------------

    def special_pods(self):
        """An init container and a failing readiness probe that heals; a
        crash-looping container. -> (probing, healed, crash-looping)."""
        v1 = self.m.api_types
        for kl in self.kubelets:
            kl.runtime.fail_starts.update({"init": 0, "crash": 1})
            kl.runtime.exec_results["app"] = 1
        probe = v1.Probe(exec_command=["cat", "/ready"],
                         period_seconds=PROBE_PERIOD, failure_threshold=1)
        self.cs.pods.create(v1.Pod(
            metadata=v1.ObjectMeta(name="probed", namespace="default",
                                   labels={"version": "probed"}),
            spec=v1.PodSpec(
                init_containers=[v1.Container(name="init", image="init:1")],
                containers=[v1.Container(name="app", image="app:1",
                                         readiness_probe=probe)])))
        self.cs.pods.create(v1.Pod(
            metadata=v1.ObjectMeta(name="crashloop", namespace="default",
                                   labels={"version": "crashloop"}),
            spec=v1.PodSpec(containers=[
                v1.Container(name="crash", image="crash:1")])))
        self.settle()
        assert self.schedule() == 2

        def rounds(n):
            for _ in range(n):
                self.clock.advance(PROBE_PERIOD)
                self.kubelet_round()
            return self.checkpoint()

        probing = rounds(PROBE_ROUNDS)
        for kl in self.kubelets:
            kl.runtime.exec_results["app"] = 0
        healed = rounds(PROBE_ROUNDS)
        # the crash loop ends with its pod: the rounds after this one see
        # no status write of it
        looping = rounds(CRASH_ROUNDS)
        self.cs.pods.delete("crashloop", "default")
        self.settle()
        self.kubelet_round()
        return probing, healed, looping

    def partition(self):
        """The first node holding a v2 pod is no longer stepped: its node
        goes stale, is tainted and drained, and the pods are rebound.
        -> (the stale node, the tainted nodes, the checkpoint after)."""
        v1 = self.m.api_types
        counts = self.counts()["v2"]
        stale = min(counts, key=lambda n: int(n.split("-")[1]))
        self.clock.advance(2 * self.nlc.grace_period)
        self.heartbeat(skip={stale})
        for _ in range(3):
            self.nlc.monitor_node_health()
            self.settle()
        tainted = {n.metadata.name for n in self.cs.nodes.list()[0]
                   if any(t.key == v1.TAINT_NODE_UNREACHABLE
                          and t.effect == "NoExecute"
                          for t in n.spec.taints or [])}
        self.nlc.process_evictions()
        self.settle()
        self.run_until(lambda: self.available("v2", base.REPLICAS))
        return stale, tainted, self.checkpoint()


_RESULTS = {}


def _scenario(port):
    if port not in _RESULTS:
        random.seed(SEED)
        run = _KubeletLockstep(port)
        try:
            registered = run.checkpoint()
            run.rollout()
            rolled = run.checkpoint()
            probing, healed, looping = run.special_pods()
            stale, tainted, evicted = run.partition()
            _RESULTS[port] = dict(
                registered=registered, rolled=rolled, probing=probing,
                healed=healed, looping=looping, stale=stale,
                tainted=tainted, evicted=evicted)
        finally:
            run.close()
    return _RESULTS[port]


def _ready(pod):
    return ("Ready", "True") in pod[4]


def test_kubelets_register_and_roll_out_as_reference():
    """Equal nodes after registration and equal pods, nodes and runtimes
    after the rollout and the rolling update; every v2 pod Running and
    Ready with an IP in its node's range."""
    ref, got = _scenario(False), _scenario(True)
    assert got["registered"] == ref["registered"]
    assert len(got["registered"]["nodes"]) == base.N_NODES
    for conds, taints in got["registered"]["nodes"].values():
        assert ("Ready", "True", "KubeletReady") in conds and not taints
    assert got["rolled"] == ref["rolled"]
    pods = got["rolled"]["pods"]
    assert len(pods) == base.REPLICAS
    for node, phase, host, ip, _, statuses in pods.values():
        assert phase == "Running" and host == node
        assert ip.startswith(f"10.64.{node.split('-')[1]}.")
        assert statuses[0][1:3] == (True, 0)
    assert all(_ready(p) for p in pods.values())


def test_probe_and_crash_loop_as_reference():
    """The init container ran before the app; the app stays unready while
    its probe fails and turns ready once it passes; the crash loop's
    restart count climbs alike in both packages."""
    ref, got = _scenario(False), _scenario(True)
    for key in ("probing", "healed", "looping"):
        assert got[key] == ref[key], key
    probed = got["probing"]["pods"]["probed"]
    assert probed[1] == "Running" and not _ready(probed)
    assert got["healed"]["pods"]["probed"][1] == "Running"
    assert _ready(got["healed"]["pods"]["probed"])
    node = probed[0]
    containers = got["healed"]["runtimes"][node][1]
    assert ("probed", "init", "CONTAINER_EXITED", 0, 0) in containers
    assert ("probed", "app", "CONTAINER_RUNNING", 0, 0) in containers
    before = got["healed"]["pods"]["crashloop"][5][0]
    after = got["looping"]["pods"]["crashloop"][5][0]
    assert before[4] == after[4] == "terminated" and after[5] == 1
    assert after[2] > before[2] > 0
    assert not _ready(got["looping"]["pods"]["crashloop"])


def test_stopped_kubelet_evicts_as_reference():
    """The kubelet no longer stepped: exactly its node tainted, its pods
    evicted and rebound elsewhere, the same pods, nodes and runtimes in
    both packages."""
    ref, got = _scenario(False), _scenario(True)
    assert got["stale"] == ref["stale"]
    assert got["tainted"] == ref["tainted"] == {got["stale"]}
    assert got["evicted"] == ref["evicted"]
    pods = got["evicted"]["pods"]
    web = {n: p for n, p in pods.items() if n.startswith("web-")}
    assert len(web) == base.REPLICAS
    assert all(p[0] != got["stale"] and _ready(p) for p in web.values())
    conds = dict((c[0], c[1]) for c in got["evicted"]["nodes"][
        got["stale"]][0])
    assert conds["Ready"] == "Unknown"


# -- kube-proxy ---------------------------------------------------------------

N_SERVICES = 6
SCHEDULERS = ("rr", "lc", "sh")


def _proxy_world(package):
    """The seeded Services and EndpointSlices through `package`'s
    apiserver and informers into a Proxier and an IPVSProxier per
    scheduler. -> (proxier, {scheduler: ipvs}, services, stop)."""
    v1 = importlib.import_module(f"{package}.api.types")
    discovery = importlib.import_module(f"{package}.api.discovery")
    server = importlib.import_module(f"{package}.apiserver.server")
    client = importlib.import_module(f"{package}.client")
    proxy = importlib.import_module(f"{package}.proxy")
    rng = np.random.default_rng(SEED)
    cs = client.Clientset(server.APIServer())
    services = []
    for s in range(N_SERVICES):
        name = f"svc-{s}"
        kind = ("ClusterIP", "NodePort", "ClusterIP")[s % 3]
        ports = [v1.ServicePort(name="http", port=80, target_port=8080,
                                node_port=30000 + s if kind == "NodePort"
                                else 0)]
        if s % 2:
            ports.append(v1.ServicePort(name="metrics", port=9090,
                                        target_port=9090))
        svc = v1.Service(
            metadata=v1.ObjectMeta(name=name, namespace="default"),
            spec=v1.ServiceSpec(
                selector={"app": name}, cluster_ip=f"10.96.0.{10 + s}",
                type=kind, ports=ports,
                session_affinity="ClientIP" if s == 2 else "None"))
        cs.services.create(svc)
        services.append(svc)
        # the last service has no ready endpoint: REJECT
        n_eps = 0 if s == N_SERVICES - 1 else int(rng.integers(1, 9))
        for part in range(2):
            eps = [discovery.Endpoint(
                addresses=[f"10.{64 + s}.{part}.{e}"],
                conditions=discovery.EndpointConditions(
                    ready=bool(rng.random() < 0.8) or e == 0),
                node_name=f"node-{int(rng.integers(0, 60))}")
                for e in range(n_eps)]
            cs.resource("endpointslices").create(discovery.EndpointSlice(
                metadata=v1.ObjectMeta(
                    name=f"{name}-{part}", namespace="default",
                    labels={discovery.LABEL_SERVICE_NAME: name}),
                endpoints=eps,
                ports=[discovery.EndpointSlicePort(name=p.name,
                                              port=p.target_port)
                       for p in ports]))
    factory = client.SharedInformerFactory(cs)
    proxier = proxy.Proxier(factory, node_name="node-0",
                            rng=random.Random(SEED))
    ipvs = {sch: proxy.IPVSProxier(factory, node_name="node-0",
                                   scheduler=sch) for sch in SCHEDULERS}
    factory.start()
    # a loaded host lists slowly: a generous wait, not the 10 s default
    assert factory.wait_for_cache_sync(timeout=60.0)
    # every slice event reached the caches before the resync
    for p in (proxier, *ipvs.values()):
        p.slice_cache._slices.clear()
        for sl in p.slice_informer.list():
            p.slice_cache.update_slice(sl)
        p.sync_proxy_rules()
    return proxier, ipvs, services, factory.stop


def _packets(services):
    """PACKETS seeded flows: a service port (or a node port), a source
    address from a small pool (affinity repeats), now and then a miss."""
    rng = np.random.default_rng(SEED + 1)
    targets = []
    for svc in services:
        for p in svc.spec.ports:
            targets.append((svc.spec.cluster_ip, p.port))
            if p.node_port:
                targets.append(("192.168.0.1", p.node_port))
    targets.append(("10.96.1.1", 80))
    pick = rng.integers(0, len(targets), size=PACKETS)
    src = rng.integers(0, 32, size=PACKETS)
    return [(targets[t][0], targets[t][1], f"172.16.0.{s}")
            for t, s in zip(pick.tolist(), src.tolist())]


def _routes(route, packet_cls, flows):
    out = []
    for dst, port, src in flows:
        try:
            out.append(route(packet_cls(dst, port, "TCP", src)))
        except (ConnectionRefusedError, LookupError) as e:
            out.append(type(e).__name__)
    return out


def _rules(proxier):
    return {name: (chain.records_affinity,
                   [dataclasses.astuple(r) for r in chain.rules])
            for name, chain in proxier.netfilter.chains.items()}


def _servers(ipvs):
    return [(v.ip, v.port, v.protocol, v.scheduler, v.persistence_seconds,
             [(r.ip, r.port, r.weight) for r in v.reals])
            for v in ipvs.table.virtual_servers()]


def _proxy_run(package):
    proxier, ipvs, services, stop = _proxy_world(package)
    try:
        packet = importlib.import_module(f"{package}.proxy").Packet
        flows = _packets(services)
        return dict(
            rules=_rules(proxier),
            servers={s: _servers(p) for s, p in ipvs.items()},
            routes=_routes(proxier.route, packet, flows),
            ipvs_routes={s: _routes(p.route, packet, flows)
                         for s, p in ipvs.items()},
            ready=_ready_endpoints(proxier, services),
            flows=flows)
    finally:
        stop()


def _ready_endpoints(proxier, services):
    """(destination address, port) -> the ready (ip, port)s behind it:
    each service port at its ClusterIP, and a node port at any other
    address."""
    out = {}
    for svc in services:
        for p in svc.spec.ports:
            eps = sorted((e.ip, e.port) for e in proxier.slice_cache
                         .endpoints_for("default", svc.metadata.name, p.name)
                         if e.ready)
            out[(svc.spec.cluster_ip, p.port)] = eps
            if p.node_port:
                out[("192.168.0.1", p.node_port)] = eps
    return out


@pytest.mark.parametrize("what", ["rules", "servers", "routes",
                                  "ipvs_routes"])
def test_proxies_route_as_reference(what):
    """Identical chains, virtual servers and routes in both packages;
    every route lands on a ready endpoint of its service, the service
    without one rejects, the unknown address misses."""
    ref, got = _proxy_run("kubernetes_tpu"), _proxy_run(
        "kubernetes_tpu_torch")
    assert got[what] == ref[what]
    assert got["ready"] == ref["ready"]
    results = [got["routes"]] if what in ("rules", "routes") else \
        list(got["ipvs_routes"].values())
    for res in results:
        seen = set()
        for (dst, port, _), r in zip(got["flows"], res):
            eps = got["ready"].get((dst, port))
            if eps is None:
                assert r == "LookupError", (dst, port, r)
                seen.add("miss")
            elif not eps:
                assert r == "ConnectionRefusedError", (dst, port, r)
                seen.add("reject")
            else:
                assert tuple(r) in {tuple(e) for e in eps}, (dst, port, r)
                seen.add("route")
        assert seen == {"miss", "reject", "route"}
