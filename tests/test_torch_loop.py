"""The port's scheduler loop (kubernetes_tpu_torch/scheduler/scheduler.py
Scheduler, with its apiserver, informers, queue and TPUBackend) against
the reference's, on the CPU.

Each case runs the same seeded pod stream through the reference's loop
(APIServer -> informers -> PriorityQueue -> Scheduler -> TPUBackend(), its
jnp hoisted session on the CPU) and the port's (the same modules of
kubernetes_tpu_torch, TPUBackend(device="cpu")), each fed the same
objects in its own package's api.types, and requires the same pod -> node
map:

- tests/test_pipeline_parity.py's stream (`_pod_stream`: zone-spread,
  plain and permanently unschedulable pods; ragged batch boundaries; a
  foreign pod bound straight to node-0 after the second batch), seeds 0
  and 1, at pipeline depth 0 and 2, on the port's hoisted rung and on its
  kernel rung (ScanSession on the scan kernels' plain versions);
- the same stream with backend="oracle" (the framework's plugin chain,
  GenericScheduler's tie-break drawn from a seeded Scheduler.rng on both
  sides);
- `perf.harness.run_workload` at a tiny Workload (12 nodes, 24 init and
  48 measured zone-spread pods, max_batch 16), the bindings read through
  the run's APIServer;
- preemption through the loop: low-priority pods saturate the nodes, then
  high-priority pods arrive: the same victims, the same nominated nodes,
  the same final bindings, with the what-if planner off (the numpy
  planner) and on (KTPU_WHATIF=1 for both: the device rung); and
  affinity-carrying preemptors (Preemption-IPA's shape at six nodes),
  which plan on the device rung;
- the degradation ladder through the live loop (chip_smoke.py phase 13c
  at small size): a dispatch fault from the second measured batch on
  walks the port's backend down to the oracle rung, the framework binds
  the faulted batch, the probe re-promotes to the kernel rung, and a
  foreign pod bound mid-run reaches the live session as a delta.

Alongside: the port's harness and factory raise for the seam that is not
ported (the mesh); `Workload(wire=True)` runs (tests/test_torch_rows.py).

The reference backend reads its encoding's device state through private
copies (tests/test_torch_backend.py `_private_device_state`), since the
stream's foreign pod reaches its live session as a delta.
"""

from __future__ import annotations

import random
import time
import types

import pytest

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.apiserver import APIServer as RefAPIServer
from kubernetes_tpu.client import Clientset as RefClientset
from kubernetes_tpu.client import SharedInformerFactory as RefFactory
from kubernetes_tpu.scheduler.scheduler import Scheduler as RefScheduler
from kubernetes_tpu.scheduler.tpu_backend import TPUBackend as RefBackend
from kubernetes_tpu_torch.apiserver import APIServer
from kubernetes_tpu_torch.client import Clientset, SharedInformerFactory
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

from ._rows import run_row
from .test_pipeline_parity import _bound_map, _pod_stream
from .test_torch_backend import _private_device_state
from .test_torch_encoding import _port_obj
from .util import make_node, make_pod, wait_until

REF = types.SimpleNamespace(APIServer=RefAPIServer, Clientset=RefClientset,
                            Factory=RefFactory, Scheduler=RefScheduler)
PORT = types.SimpleNamespace(APIServer=APIServer, Clientset=Clientset,
                             Factory=SharedInformerFactory,
                             Scheduler=Scheduler)


def _node(i, cpu=None):
    # tests/test_pipeline_parity.py's nodes
    return make_node(
        f"node-{i}", cpu=cpu or str(4 + (i % 3) * 2), memory="16Gi",
        pods=64, labels={v1.LABEL_HOSTNAME: f"node-{i}", "zone": f"z{i % 3}"})


class _Loop:
    """One package's apiserver + informers + Scheduler over `n_nodes`
    nodes. backend "tpu": the reference's TPUBackend() or the port's
    TPUBackend(device="cpu") on `rung`; "oracle": no backend. `rng_seed`
    seeds Scheduler.rng (the oracle's tie-break)."""

    def __init__(self, port: bool, depth: int = 0, rung: str = "hoisted",
                 backend: str = "tpu", rng_seed=None, n_nodes: int = 8,
                 node_cpu=None, max_batch: int = 128):
        M = PORT if port else REF
        self.port = port
        self.api = M.APIServer()
        self.cs = M.Clientset(self.api)
        for i in range(n_nodes):
            self.cs.nodes.create(self.obj(_node(i, node_cpu)))
        self.factory = M.Factory(self.cs)
        tpu = None
        if backend == "tpu":
            if port:
                tpu = TPUBackend(device="cpu", use_kernel=rung == "kernel")
            else:
                tpu = RefBackend()
                _private_device_state(tpu.enc)
        self.sched = M.Scheduler(
            self.cs, self.factory, backend=backend, pipeline_depth=depth,
            tpu_backend=tpu, max_batch=max_batch,
            rng=random.Random(rng_seed) if rng_seed is not None else None)
        self.factory.start()
        assert self.factory.wait_for_cache_sync()

    def obj(self, o):
        return _port_obj(o) if self.port else o

    def step(self, infos):
        if self.sched.backend == "tpu":
            self.sched._schedule_batch_tpu(infos)
        else:
            for info in infos:
                self.sched._schedule_one_oracle(info)

    def drive(self, pods, batch_sizes, mutate_at=None):
        """tests/test_pipeline_parity.py `_drive` for either package and
        either backend: create the pods, pop them in the given batch
        partition, and (after `mutate_at` batches) bind a foreign pod
        straight to node-0."""
        sched = self.sched
        for p in pods:
            self.cs.pods.create(self.obj(p))
        assert wait_until(lambda: sched.queue.num_active() >= len(pods), 30)
        n_batches = 0
        sizes = list(batch_sizes)
        while True:
            info = sched.queue.pop(timeout=0.2)
            if info is None:
                break
            infos = [info]
            want = sizes.pop(0) if sizes else 4
            while len(infos) < want:
                nxt = sched.queue.pop(timeout=0)
                if nxt is None:
                    break
                infos.append(nxt)
            self.step(infos)
            n_batches += 1
            if mutate_at is not None and n_batches == mutate_at:
                self.cs.pods.create(self.obj(make_pod(
                    "squatter", namespace="default", cpu="1",
                    memory="512Mi", node_name="node-0",
                    labels={"app": "foreign"})))
                assert wait_until(
                    lambda: sched.cache.has_pod("default/squatter"), 10)
        assert sched._drain_pipeline(timeout=30)

        def idle():
            with sched._inflight_lock:
                return sched._inflight == 0

        assert wait_until(idle, 30), "binder pool did not drain"

    def close(self):
        self.sched.shutdown()
        self.factory.stop()


def _stream(seed):
    rng = random.Random(seed)
    n = rng.randint(24, 48)
    batch_sizes = [rng.choice([1, 2, 3, 5, 8]) for _ in range(64)]
    return n, batch_sizes


def _run_stream(port, seed, **kw):
    n, batch_sizes = _stream(seed)
    loop = _Loop(port, **kw)
    try:
        loop.drive(_pod_stream(random.Random(seed), n), batch_sizes,
                   mutate_at=2)
        return _bound_map(loop.cs)
    finally:
        loop.close()


_REF_MAPS = {}


def _ref_map(seed, depth):
    key = (seed, depth)
    if key not in _REF_MAPS:
        _REF_MAPS[key] = _run_stream(False, seed, depth=depth)
    return _REF_MAPS[key]


@pytest.mark.parametrize("rung", ["hoisted", "kernel"])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_loop_binds_as_reference(seed, depth, rung):
    ref = _ref_map(seed, depth)
    got = _run_stream(True, seed, depth=depth, rung=rung)
    assert got == ref
    # the stream exercises both outcomes
    assert any(ref.values()) and not all(ref.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_loop_binds_as_reference(seed):
    maps = [_run_stream(port, seed, backend="oracle", rng_seed=seed)
            for port in (False, True)]
    assert maps[0] == maps[1]
    assert any(maps[0].values()) and not all(maps[0].values())


def _harness_bindings(h, monkeypatch, **kw):
    spread = {"spread_zone": True}
    return run_row(h, dict(name="tiny", num_nodes=12, num_init_pods=24,
                           num_pods=48, max_batch=16, init_template=spread,
                           template=spread), monkeypatch, **kw)


def test_run_workload_binds_as_reference(monkeypatch):
    from kubernetes_tpu.perf import harness as ref_harness
    from kubernetes_tpu_torch.perf import harness

    r_ref, ref = _harness_bindings(ref_harness, monkeypatch)
    r, got = _harness_bindings(harness, monkeypatch, device="cpu")
    assert len(got) == 72 and all(got.values())
    assert got == ref
    assert r.num_bound == r_ref.num_bound == 48
    assert r.session_kind == r_ref.session_kind == "HoistedSession"


def _saturate_then_preempt(port):
    """16 priority-1 pods of 900m fill four 4-CPU nodes; three
    priority-100 pods of 900m then fail in one batch and preempt. ->
    (victims, nominated node per preemptor, final bindings)."""
    loop = _Loop(port, n_nodes=4, node_cpu="4")
    cs = loop.cs
    try:
        loop.drive([make_pod(f"low-{i}", cpu="900m", memory="64Mi",
                             priority=1) for i in range(16)], [8, 8])
        assert all(_names(cs, "low-").values())
        loop.drive([make_pod(f"hi-{i}", cpu="900m", memory="64Mi",
                             priority=100) for i in range(3)], [3])
        # the preemptors come back once their victims' deletes echo
        deadline = time.monotonic() + 30
        while not all(_names(cs, "hi-").values()) \
                and time.monotonic() < deadline:
            loop.drive([], [3])
        pods, _ = cs.pods.list(namespace="default")
        victims = {f"low-{i}" for i in range(16)} - set(_names(cs, "low-"))
        nominations = {p.metadata.name: p.status.nominated_node_name
                       for p in pods if p.metadata.name.startswith("hi-")}
        return victims, nominations, {p.metadata.name: p.spec.node_name
                                      for p in pods}
    finally:
        loop.close()


def _names(cs, prefix):
    pods, _ = cs.pods.list(namespace="default")
    return {p.metadata.name: p.spec.node_name for p in pods
            if p.metadata.name.startswith(prefix)}


def _planner_paths():
    from kubernetes_tpu_torch.scheduler import metrics

    out = {}
    for key, val in metrics.preemption_planner.items():
        out[key[0]] = out.get(key[0], 0) + int(val)
    return out


def _paths_since(before):
    return {k: v - before.get(k, 0) for k, v in _planner_paths().items()
            if v - before.get(k, 0)}


@pytest.mark.parametrize("whatif", ["0", "1"])
def test_preemption_through_loop_matches_reference(whatif, monkeypatch):
    """The wave through each package's loop with the what-if planner off
    (the numpy planner) and on (KTPU_WHATIF=1 for both: the device rung,
    the port's plain walk on the CPU)."""
    monkeypatch.setenv("KTPU_WHATIF", whatif)
    ref = _saturate_then_preempt(False)
    before = _planner_paths()
    got = _saturate_then_preempt(True)
    victims, nominations, bound = got
    assert len(victims) == 3
    assert got == ref
    # each preemptor binds where it was nominated
    assert all(bound[k] == n for k, n in nominations.items())
    paths = _paths_since(before)
    assert paths == ({"device": 3} if whatif == "1" else {"fast": 3})


def _affinity_preempt(port):
    """Preemption-IPA-500n-500hi's shape cut to six nodes: 24 priority-1
    pods labelled app=victim fill six 4-CPU nodes in three zones; four
    priority-100 pods carrying a required pod-affinity term toward
    app=victim (zone topology) then fail and preempt. -> (victims,
    nominated node per preemptor, final bindings)."""
    aff = v1.Affinity(pod_affinity=v1.PodAffinity(
        required_during_scheduling_ignored_during_execution=[
            v1.PodAffinityTerm(
                label_selector=v1.LabelSelector(
                    match_labels={"app": "victim"}),
                topology_key="zone")]))
    loop = _Loop(port, n_nodes=6, node_cpu="4")
    cs = loop.cs
    try:
        loop.drive([make_pod(f"low-{i}", cpu="900m", memory="64Mi",
                             priority=1, labels={"app": "victim"})
                    for i in range(24)], [12, 12])
        assert all(_names(cs, "low-").values())
        loop.drive([make_pod(f"hi-{i}", cpu="900m", memory="64Mi",
                             priority=100, labels={"app": "victim"},
                             affinity=aff) for i in range(4)], [4])
        deadline = time.monotonic() + 30
        while not all(_names(cs, "hi-").values()) \
                and time.monotonic() < deadline:
            loop.drive([], [4])
        pods, _ = cs.pods.list(namespace="default")
        victims = {f"low-{i}" for i in range(24)} - set(_names(cs, "low-"))
        nominations = {p.metadata.name: p.status.nominated_node_name
                       for p in pods if p.metadata.name.startswith("hi-")}
        return victims, nominations, {p.metadata.name: p.spec.node_name
                                      for p in pods}
    finally:
        loop.close()


def test_affinity_preemption_through_loop_matches_reference(monkeypatch):
    """Affinity-carrying preemptors are outside the numpy planner's
    envelope: with the what-if on they plan on the device rung (the port's
    plain walk on the CPU) and evict, nominate and bind as the reference
    loop does."""
    monkeypatch.setenv("KTPU_WHATIF", "1")
    ref = _affinity_preempt(False)
    before = _planner_paths()
    got = _affinity_preempt(True)
    victims, nominations, bound = got
    assert len(victims) == 4
    assert got == ref
    assert all(bound[k] == n for k, n in nominations.items())
    assert _paths_since(before) == {"device": 4}


def test_ladder_drill_through_loop():
    """chip_smoke.py phase 13c (`loop_drill`) at small size on the CPU,
    on the port's kernel rung: a dispatch fault from the first wave's
    second batch on walks the ladder kernel -> hoisted -> oracle; the
    framework schedules the faulted batch; once the fault is disarmed the
    probe re-promotes to the kernel rung; a pod bound to node-7 by another
    actor reaches the live ScanSession as a delta. loop_drill raises if a
    pod binds twice or stays unbound or a node holds more than its
    allocatable."""
    import chip_smoke

    out = chip_smoke.loop_drill("cpu", num_nodes=12, num_init=8,
                                waves=(24, 16), max_batch=4, use_kernel=True)
    assert out["binds"] == out["pods"] == 48 and out["unbound"] == 0
    assert out["bind_violations"] == [] and out["overcommitted_nodes"] == []
    assert out["faulted_batch"] and out["faulted_on_oracle"]
    assert out["oracle_pods"] >= 4
    assert out["demotions"] >= 2 and out["promotions"] >= 2
    assert out["rung_at_end"] == out["rung_at_foreign"] == "kernel"
    assert out["foreign"] and out["delta_applies"] >= 1


def test_unported_seams_raise():
    from kubernetes_tpu_torch.perf.harness import Workload, run_workload
    from kubernetes_tpu_torch.scheduler.apis.config import (
        default_configuration,
    )
    from kubernetes_tpu_torch.scheduler.factory import create_scheduler

    with pytest.raises(NotImplementedError):
        run_workload(Workload("mesh", num_nodes=2, mesh_devices=2),
                     device="cpu")
    cs = Clientset(APIServer())
    cfg = default_configuration()
    cfg.profiles[0].mesh_devices = 2
    with pytest.raises(NotImplementedError):
        create_scheduler(cs, SharedInformerFactory(cs), cfg, device="cpu")
    sched = create_scheduler(cs, SharedInformerFactory(cs), device="cpu")
    try:
        assert sched.tpu.device.type == "cpu"
    finally:
        sched.shutdown()
