"""Chaosmonkey: periodic fault injection against a running cluster.

Reference: test/e2e/chaosmonkey/chaosmonkey.go:48 — a chaosmonkey Do()s
disruptions while registered tests run; the reboot/disruptive e2e suites
use it to prove the control plane re-converges. Here the disruptions are
the ones a hollow cluster can suffer: kubelet kill (node death), kubelet
restart (recovery), random pod deletion (workload churn), and — on
clusters wired for it — control-plane crashes: `crash-apiserver` drops
the durable store to its on-disk state mid-churn (SIGKILL-equivalent;
every acknowledged write survives, every live watch dies and reflectors
re-list) and `crash-controller` kills one supervised controller loop so
the supervisor must restart it with backoff. The crash kinds are opt-in
via `disruptions=` (they no-op on clusters without a DurableKVStore /
Supervisor). Each disruption is recorded so tests can assert recovery
against the actual injection history.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class Disruption:
    kind: str  # kill-kubelet | restart-kubelet | delete-pod | crash-*
    target: str
    at: float = field(default_factory=time.time)


#: the control-plane crash kinds (opt-in: pass via `disruptions=`)
CRASH_KINDS = ("crash-apiserver", "crash-controller")

#: the device/scheduler fault kinds (opt-in): `wedge-device` arms one
#: dispatch-level fault (raise / NaN harvest / wedged wait) on the TPU
#: backend's FaultInjector; `crash-scheduler` kills one pipeline worker
#: thread (scheduling loop or completion worker); `overload` makes the
#: host transiently SLOW — a completion-worker stall wave or a synthetic
#: event burst — so the overload monitor's shed→restore cycle gets
#: exercised (the endurance soak's signature disruption). All no-op on
#: clusters without a TPU-backed scheduler.
FAULT_KINDS = ("wedge-device", "crash-scheduler", "overload")

#: the scheduler-failover kinds (opt-in): `partition-scheduler` cuts the
#: current leader off from the store — its lease renews fail, the
#: self-fence margin demotes it, and a standby adopts the lease while
#: the zombie's straggler writes bounce off the fencing precondition;
#: `failover-scheduler` is the graceful form — the leader abdicates
#: (vacates the lease + cools down) so a warm standby wins
#: deterministically. Both no-op on clusters without leader election.
FAILOVER_KINDS = ("partition-scheduler", "failover-scheduler")

#: the gang-scheduling kinds (opt-in): `kill-gang-member` deletes one
#: member of a live gang — the Coscheduling rollback protocol must
#: unwind the whole waiting wave (never a prefix) and, once a
#: replacement lands, re-complete the gang; `gang-burst` submits a
#: fresh burst of gang pods so admission waves keep forming mid-chaos.
#: Both no-op on clusters without gang pods / without a default
#: namespace to burst into.
GANG_KINDS = ("kill-gang-member", "gang-burst")


class ChaosMonkey:
    def __init__(
        self,
        cluster,  # kubernetes_tpu.cluster.Cluster (needs .hollow/.client)
        period: float = 1.0,
        rng: Optional[random.Random] = None,
        disruptions: Optional[List[str]] = None,
    ):
        self.cluster = cluster
        self.period = period
        self.rng = rng or random.Random(0)
        self.kinds = disruptions or ["kill-kubelet", "restart-kubelet", "delete-pod"]
        self.history: List[Disruption] = []
        self._dead: List = []  # kubelets killed and not yet restarted
        self._crashed_controllers: List[str] = []  # awaiting supervisor
        self._partitioned: List = []  # electors cut off from the store
        self._burst_seq = 0  # gang-burst group-name sequence
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self.do_one()
            except Exception:  # noqa: BLE001 — chaos must not crash the test
                pass

    # -- disruptions --------------------------------------------------------

    def do_one(self, kind: Optional[str] = None) -> Optional[Disruption]:
        kind = kind or self.rng.choice(self.kinds)
        fn = {
            "kill-kubelet": self._kill_kubelet,
            "restart-kubelet": self._restart_kubelet,
            "delete-pod": self._delete_pod,
            "crash-apiserver": self._crash_apiserver,
            "crash-controller": self._crash_controller,
            "wedge-device": self._wedge_device,
            "crash-scheduler": self._crash_scheduler,
            "overload": self._overload,
            "partition-scheduler": self._partition_scheduler,
            "failover-scheduler": self._failover_scheduler,
            "kill-gang-member": self._kill_gang_member,
            "gang-burst": self._gang_burst,
        }[kind]
        d = fn()
        if d is not None:
            self.history.append(d)
        return d

    def _kill_kubelet(self) -> Optional[Disruption]:
        hollow = self.cluster.hollow
        if hollow is None:
            return None
        alive = [kl for kl in hollow.kubelets if kl not in self._dead]
        if len(alive) <= 1:
            return None  # always leave one node standing
        victim = self.rng.choice(alive)
        victim.stop()
        self._dead.append(victim)
        return Disruption("kill-kubelet", victim.config.node_name)

    def _restart_kubelet(self) -> Optional[Disruption]:
        if not self._dead:
            return None
        kl = self._dead.pop(self.rng.randrange(len(self._dead)))
        # a restarted kubelet is a FRESH process over the same node name
        # and runtime (kubelet restart reconciles from CRI via PLEG)
        from ..kubelet.kubelet import Kubelet

        fresh = Kubelet(
            self.cluster.hollow.client,
            self.cluster.hollow.factory,
            config=kl.config,
            runtime=kl.runtime,
        )
        idx = self.cluster.hollow.kubelets.index(kl)
        self.cluster.hollow.kubelets[idx] = fresh
        fresh.run()
        return Disruption("restart-kubelet", kl.config.node_name)

    def _delete_pod(self) -> Optional[Disruption]:
        pods, _ = self.cluster.client.pods.list(namespace="default")
        candidates = [p for p in pods if p.metadata.deletion_timestamp is None]
        if not candidates:
            return None
        victim = self.rng.choice(candidates)
        self.cluster.client.pods.delete(
            victim.metadata.name, victim.metadata.namespace
        )
        return Disruption(
            "delete-pod", f"{victim.metadata.namespace}/{victim.metadata.name}"
        )

    def _crash_apiserver(self) -> Optional[Disruption]:
        """SIGKILL-equivalent on the control plane's store: drop to disk
        state mid-churn (sometimes with a torn final record) and recover.
        Acknowledged writes survive; live watches die and every reflector
        re-lists. No-op unless the cluster runs a DurableKVStore."""
        store = getattr(getattr(self.cluster, "api", None), "store", None)
        if store is None or not hasattr(store, "crash"):
            return None
        store.crash(torn=bool(self.rng.getrandbits(1)))
        return Disruption("crash-apiserver", "apiserver")

    def _crash_controller(self) -> Optional[Disruption]:
        """Kill one supervised controller loop; the supervisor must
        restart it with capped backoff while the rest keep running.
        No-op unless the controller manager runs a Supervisor."""
        sup = getattr(getattr(self.cluster, "kcm", None), "supervisor", None)
        if sup is None:
            return None
        candidates = [n for n in sup.names() if sup.running(n)]
        if not candidates:
            return None
        victim = self.rng.choice(candidates)
        sup.crash(victim)
        self._crashed_controllers.append(victim)
        return Disruption("crash-controller", victim)

    def _fault_injector(self):
        """The scheduler's FaultInjector, installing one on first use.
        None when the cluster has no TPU-backed scheduler (the fault
        kinds then no-op, like the crash kinds on non-durable stores)."""
        sched = getattr(self.cluster, "scheduler", None)
        if sched is None or getattr(sched, "tpu", None) is None:
            return None
        inj = getattr(sched, "faults", None)
        if inj is None:
            from .faults import FaultInjector

            inj = FaultInjector()
            sched.install_fault_injector(inj)
        return inj

    def _wedge_device(self) -> Optional[Disruption]:
        """One device-level fault on the next dispatch: an XLA launch
        raise, a garbage (NaN/saturated) harvest payload, or a wedged
        wait that only the dispatch watchdog ends. The backend must
        detect it, retry with a rebuilt session, and keep every pod
        (fault-parity: same bound set as a clean run)."""
        inj = self._fault_injector()
        if inj is None:
            return None
        kind = self.rng.choice(("raise-dispatch", "nan-harvest", "wedge-wait"))
        inj.arm(kind, shots=1)
        return Disruption("wedge-device", kind)

    def _crash_scheduler(self) -> Optional[Disruption]:
        """Kill one scheduling-pipeline worker thread (the scheduling
        loop or the completion worker); the in-process supervision must
        drain the in-flight FIFO back to the queue and restart it."""
        inj = self._fault_injector()
        if inj is None:
            return None
        kind = self.rng.choice(("kill-scheduler", "kill-completion"))
        inj.arm(kind, shots=1)
        return Disruption("crash-scheduler", kind)

    def _overload(self) -> Optional[Disruption]:
        """Make the host transiently SLOW (not dead): either arm a wave
        of completion-worker stalls — the FIFO ages, the overload
        monitor must shed optional work and restore once the wave passes
        — or fire a synthetic event burst (no-op annotation bumps on a
        slab of pods) that floods every informer/watcher with MODIFIED
        events, exercising queue depth and the wire's slow-consumer
        path. Placements must be untouched either way."""
        inj = self._fault_injector()
        if inj is None:
            return None
        if self.rng.random() < 0.7:
            # a wave of stalled batches, long enough to out-dwell the
            # monitor's shed threshold
            inj.arm("stall-completion", shots=6)
            return Disruption("overload", "stall-completion")
        pods, _ = self.cluster.client.pods.list(namespace="default")
        victims = [p for p in pods if p.metadata.deletion_timestamp is None]
        self.rng.shuffle(victims)
        burst = 0
        for p in victims[:50]:
            ann = dict(p.metadata.annotations or {})
            ann["chaos/overload-burst"] = str(time.time())
            p.metadata.annotations = ann
            try:
                self.cluster.client.pods.update(p)
                burst += 1
            except Exception:  # noqa: BLE001 — racing deletes are fine
                pass
        return Disruption("overload", f"event-burst:{burst}")

    def _kill_gang_member(self) -> Optional[Disruption]:
        """Delete one member of a live gang (waiting or bound — the rng
        doesn't care, and neither may the protocol): a waiting member's
        deletion must roll the WHOLE wave back so no sibling camps on
        capacity; a bound member's deletion leaves its siblings bound
        (still a legal all-bound-minus-departed state) and the owner's
        replacement re-completes the gang off the reserved index. Either
        way the gang may never sit torn — the GangIntegrityChecker
        holds the line. No-op when no gang pods exist."""
        from ..scheduler.plugins.coscheduling import pod_group

        pods, _ = self.cluster.client.pods.list(namespace="default")
        candidates = []
        for p in pods:
            if p.metadata.deletion_timestamp is not None:
                continue
            group, min_available = pod_group(p)
            if group and min_available > 1:
                candidates.append(p)
        if not candidates:
            return None
        victim = self.rng.choice(candidates)
        self.cluster.client.pods.delete(
            victim.metadata.name, victim.metadata.namespace
        )
        return Disruption(
            "kill-gang-member",
            f"{victim.metadata.namespace}/{victim.metadata.name}",
        )

    #: pods per injected gang-burst gang (drills override per shape)
    gang_burst_size = 4
    #: cpu request per burst member — small enough that a burst gang is
    #: placeable on a drill-sized cluster, large enough to contend
    gang_burst_cpu = "10m"

    def _gang_burst(self) -> Optional[Disruption]:
        """Submit one fresh gang (gang_burst_size pods sharing a new
        group, min-available == size) so admission waves keep forming
        mid-chaos — gang identity rides annotations, exactly like the
        perf harness, so the burst never perturbs template hoisting."""
        from ..api import types as v1
        from ..scheduler.plugins.coscheduling import (
            GROUP_LABEL,
            MIN_AVAILABLE_LABEL,
        )

        seq = self._burst_seq
        self._burst_seq += 1
        group = f"chaos-gang-{seq}"
        k = self.gang_burst_size
        for i in range(k):
            pod = v1.Pod(
                metadata=v1.ObjectMeta(
                    name=f"{group}-{i}",
                    namespace="default",
                    annotations={
                        GROUP_LABEL: group,
                        MIN_AVAILABLE_LABEL: str(k),
                    },
                ),
                spec=v1.PodSpec(containers=[v1.Container(
                    name="c", image="img:1",
                    resources=v1.ResourceRequirements(
                        requests={"cpu": self.gang_burst_cpu}),
                )]),
            )
            try:
                self.cluster.client.pods.create(pod)
            except Exception:  # noqa: BLE001 — name races with a prior burst
                return None
        return Disruption("gang-burst", f"{group} x{k}")

    def _electing_schedulers(self) -> List:
        """Every scheduler instance with leader election armed; supports
        both the multi-scheduler cluster (`.schedulers`) and a bare
        single-scheduler one."""
        scheds = getattr(self.cluster, "schedulers", None)
        if not scheds:
            sole = getattr(self.cluster, "scheduler", None)
            scheds = [sole] if sole is not None else []
        return [s for s in scheds if getattr(s, "elector", None) is not None]

    def _leader(self):
        for s in self._electing_schedulers():
            if s.elector.is_leader.is_set():
                return s
        return None

    def _partition_scheduler(self) -> Optional[Disruption]:
        """Netsplit the current leader from the store: heal any previous
        partition first (both instances partitioned means nobody can
        lead), then cut the leader off — its renews fail, the self-fence
        margin demotes it strictly before a standby's adoption window
        opens, and any straggler write it still has in flight carries a
        dead epoch the apiserver rejects (FenceExpired). No-op without
        at least two electing schedulers."""
        if len(self._electing_schedulers()) < 2:
            return None
        while self._partitioned:
            self._partitioned.pop().partitioned = False
        leader = self._leader()
        if leader is None:
            return None
        leader.elector.partitioned = True
        self._partitioned.append(leader.elector)
        return Disruption("partition-scheduler", leader.elector.cfg.identity)

    def _failover_scheduler(self) -> Optional[Disruption]:
        """Graceful leader handoff: the active instance abdicates —
        vacates the lease record and sits out the next race — so a warm
        standby adopts (epoch bump, reconcile, resume) while the old
        leader demotes through the same pause-and-drain path a crash
        would use. No-op without at least two electing schedulers."""
        if len(self._electing_schedulers()) < 2:
            return None
        leader = self._leader()
        if leader is None:
            return None
        # sit out long enough that the standby reliably wins the race
        leader.elector.abdicate(cooldown=2.0 * leader.elector.cfg.lease_duration)
        return Disruption("failover-scheduler", leader.elector.cfg.identity)

    # -- assertions ---------------------------------------------------------

    def restart_all_dead(self, timeout: float = 30.0) -> None:
        """End the experiment with every component back: kubelets
        restarted (fresh process over the same node), crashed controller
        loops re-running under their supervisor, the apiserver store
        healthy (crash() recovers in place, so it already is), and any
        still-armed overload stall wave disarmed so the monitor's
        restore path can run."""
        sched = getattr(self.cluster, "scheduler", None)
        inj = getattr(sched, "faults", None) if sched is not None else None
        if inj is not None:
            inj.disarm("stall-completion")
        while self._dead:
            self._restart_kubelet()
        sup = getattr(getattr(self.cluster, "kcm", None), "supervisor", None)
        while self._crashed_controllers:
            name = self._crashed_controllers.pop()
            if sup is not None and not sup.wait_running(name, timeout):
                # a recovery barrier that shrugs is worse than none: the
                # test would proceed green with a controller still down
                raise RuntimeError(
                    f"controller {name} not restarted within {timeout}s "
                    f"(restarts={sup.restart_count(name)})"
                )
        # heal scheduler netsplits and wait for a leader to re-emerge —
        # the same no-shrug rule: converging with no active scheduler
        # would pass every per-pod check on a cluster that schedules
        # nothing ever again
        while self._partitioned:
            self._partitioned.pop().partitioned = False
        if self._electing_schedulers():
            deadline = time.time() + timeout
            while time.time() < deadline:
                if self._leader() is not None:
                    return
                time.sleep(0.05)
            raise RuntimeError(
                f"no scheduler re-acquired the leader lease within {timeout}s"
            )
