"""The port's mesh through the backend, the planner and the loop: one
scoring backend over 2/4/8 node-axis shards, decisions equal to the
single-device port's (tests/test_mesh_scaleout.py and the loop of
tests/test_sharded.py, on the port).

Every subsystem that rides the sharded session (session carry deltas,
the multi-pod conflict-suffix contract, the what-if preemption planner,
node churn as lane-column deltas) stays decision-identical to the
single-device backend at every shard count, in both layouts of a port
mesh (one group of k shards; k one-shard groups on one device). The loop
test is the contract the reference's own fails (its mesh session meets
its unbound-`ucnt` defect on the anti-affinity pods): `run_workload`
with `mesh_devices` binds as the single-device loop."""

from __future__ import annotations

import copy
import random

import pytest

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.scheduler.framework.snapshot import Snapshot as RefSnapshot
from kubernetes_tpu_torch.ops.sharded_scan import ShardedScanSession
from kubernetes_tpu_torch.parallel.sharded import make_mesh
from kubernetes_tpu_torch.scheduler import metrics
from kubernetes_tpu_torch.scheduler.framework.snapshot import Snapshot
from kubernetes_tpu_torch.scheduler.internal.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.internal.nominator import PodNominator
from kubernetes_tpu_torch.scheduler.preemption_device import (
    DevicePreemptionPlanner,
)
from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

from .test_preemption import _post_filter
from .test_torch_encoding import _port_obj
from .util import make_node, make_pod

LAYOUTS = ("group", "split")


def _mesh(nsh, layout="group"):
    devs = ["cpu"] if layout == "group" else ["cpu"] * nsh
    return make_mesh(devices=devs, n_devices=nsh)


def _node(i, cpu="8", memory="32Gi"):
    return _port_obj(make_node(f"node-{i}", cpu=cpu, memory=memory,
                               labels={v1.LABEL_HOSTNAME: f"node-{i}"}))


def _mk_backend(n_nodes, mesh=None, cpu="8"):
    cache = SchedulerCache()
    be = TPUBackend(mesh=mesh, device=None if mesh is not None else "cpu")
    cache.add_listener(be)
    for i in range(n_nodes):
        cache.add_node(_node(i, cpu=cpu))
    return cache, be


def _rebuilds(reasons):
    return sum(val for key, val in metrics.session_rebuilds.items()
               if key and key[0] in reasons)


def _pods(prefix, n, cpu="100m", memory="64Mi", seed=None, app=None):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kw = {}
        if seed is not None:
            kw["cpu"] = f"{rng.choice([50, 100, 250, 500])}m"
            kw["memory"] = rng.choice(["64Mi", "256Mi", "1Gi"])
        else:
            kw["cpu"], kw["memory"] = cpu, memory
        out.append(_port_obj(make_pod(f"{prefix}-{i}", namespace="default",
                                      labels={"app": app or prefix}, **kw)))
    return out


# ------------------------------------------------- session-delta parity


class TestSessionDeltaParity:
    """A randomized pod stream through a mesh backend (ShardedScanSession
    and KTPU_SESSION_DELTAS carry patches, node churn on the delta path
    mid-stream) against the single-device backend, pod for pod."""

    @pytest.mark.parametrize("nsh", [2, 4, 8])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_randomized_stream_parity(self, nsh, layout, monkeypatch):
        monkeypatch.setenv("KTPU_SESSION_DELTAS", "1")
        monkeypatch.setenv("KTPU_NODE_HEADROOM", "0.5")

        def drive(mesh):
            cache, be = _mk_backend(10, mesh=mesh)
            got = []
            for batch in range(4):
                pods = _pods(f"b{batch}", 5, seed=1000 * nsh + batch)
                got += [n for _, n in be.schedule_many(pods)]
                if batch == 1 and mesh is not None:
                    # churn on the DELTA path: pod-free lanes, re-added
                    # LIFO so every node returns to its lane
                    sess = be._session
                    victims = [nm for nm in be.enc.node_names[::-1]
                               if nm and not any(n == nm for n in got)][:2]
                    for nm in victims:
                        cache.remove_node(nm)
                    for nm in reversed(victims):
                        cache.add_node(_node(int(nm.split("-")[1])))
                    kinds = [d["kind"] for d in be._deltas]
                    assert kinds.count("node-leave") == len(victims)
                    assert kinds.count("node-join") == len(victims)
                    assert be._session is sess, "churn tore the session"
            return got, type(be._session).__name__

        got, kind = drive(_mesh(nsh, layout))
        ref, ref_kind = drive(None)
        assert kind == "ShardedScanSession"
        assert ref_kind == "HoistedSession"
        assert got == ref, f"nsh={nsh}: {got} != {ref}"

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_delta_patch_kinds_survive_churn(self, layout, monkeypatch):
        """The delta queue carries node-join / node-leave entries, and
        flushing them through a schedule keeps parity with a fresh
        rebuild of the same encoding."""
        monkeypatch.setenv("KTPU_SESSION_DELTAS", "1")
        mesh = _mesh(8, layout)
        cache, be = _mk_backend(12, mesh=mesh)
        warm = _pods("warm", 4)
        got = [n for _, n in be.schedule_many(warm)]
        for nm in ("node-10", "node-11"):
            cache.remove_node(nm)
        cache.add_node(_node(10))
        kinds = [d["kind"] for d in be._deltas]
        assert kinds.count("node-leave") == 2
        assert kinds.count("node-join") == 1
        a0 = sum(v for k, v in metrics.session_delta_applies.items()
                 if k and k[0] in ("node-join", "node-leave"))
        # the warm template again: the live session takes the flush
        tail = _pods("tail", 6, app="warm")
        sess = be._session
        got += [n for _, n in be.schedule_many(tail)]
        assert be._session is sess
        assert sum(v for k, v in metrics.session_delta_applies.items()
                   if k and k[0] in ("node-join", "node-leave")) - a0 == 3

        ref_cache, ref_be = _mk_backend(12, mesh=mesh)
        for nm in ("node-10", "node-11"):
            ref_cache.remove_node(nm)
        ref_cache.add_node(_node(10))
        ref = [n for _, n in ref_be.schedule_many(copy.deepcopy(warm))]
        ref += [n for _, n in ref_be.schedule_many(copy.deepcopy(tail))]
        assert isinstance(ref_be._session, ShardedScanSession)
        assert got == ref


# --------------------------------------- multipod conflict-suffix parity


class TestConflictSuffixParity:
    @pytest.mark.parametrize("nsh", [2, 4, 8])
    @pytest.mark.parametrize("mk", [2, 4])
    def test_backend_replays_suffix(self, nsh, mk, monkeypatch):
        """schedule_many on a mesh backend with k pods a step equals the
        sequential single-device backend, and the conflict went through
        the suffix replay."""
        monkeypatch.setenv("KTPU_MULTIPOD_K", str(mk))
        pods = [_port_obj(make_pod(f"race-{i}", namespace="default",
                                   cpu="2", memory="128Mi",
                                   labels={"app": "race"}))
                for i in range(2 * mk)]
        _, be = _mk_backend(3, mesh=_mesh(nsh, "split"), cpu="3")
        r0 = sum(v for _, v in metrics.conflict_replays.items())
        got = [n for _, n in be.schedule_many(copy.deepcopy(pods))]
        assert be._session.multipod_k == mk
        assert sum(v for _, v in metrics.conflict_replays.items()) > r0
        monkeypatch.setenv("KTPU_MULTIPOD_K", "1")
        _, ref_be = _mk_backend(3, cpu="3")
        ref = [n for _, n in ref_be.schedule_many(copy.deepcopy(pods))]
        assert got == ref, f"nsh={nsh}: {got} != {ref}"


# ------------------------------------------------------- what-if parity


class TestWhatifParity:
    """The device preemption planner over a mesh backend (the what-if view
    on the mesh's lead device over the padded snapshot) plans the victims
    the single-device backend and the oracle plan."""

    @pytest.mark.parametrize("nsh", [2, 4, 8])
    def test_preemption_plan_parity(self, nsh):
        nodes = [make_node(f"node-{i}", cpu="4", memory="16Gi",
                           labels={v1.LABEL_HOSTNAME: f"node-{i}"})
                 for i in range(5)]
        fills = [
            make_pod(f"low-{i}-{j}", namespace="default", cpu="900m",
                     memory="64Mi", labels={"app": "low"},
                     node_name=f"node-{i}", priority=1)
            for i in range(5) for j in range(4)
        ]
        pending = make_pod("hi", namespace="default", cpu="900m",
                           memory="64Mi", labels={"app": "hi"},
                           priority=100)
        pnodes = [_port_obj(n) for n in nodes]
        pfills = [_port_obj(p) for p in fills]
        ppending = _port_obj(pending)
        snapshot = Snapshot.from_objects(pfills, pnodes)

        def plan(mesh):
            be = TPUBackend(mesh=mesh, device=None if mesh else "cpu")
            be.whatif = True  # the CPU default is off; tests opt in
            for n in pnodes:
                be.on_add_node(n)
            for p in pfills:
                be.on_add_pod(p, p.spec.node_name)
            planner = DevicePreemptionPlanner(
                snapshot, PodNominator(), be,
                eligibility={v1.pod_key(ppending): (True, False)})
            (cand,) = planner.plan([ppending])
            assert planner.planner_paths == ["device"]
            assert cand is not None
            return cand, be

        got, be = plan(_mesh(nsh, "split"))
        assert be.whatif_builds == 1
        ref, _ = plan(None)
        oracle, _ = _post_filter(RefSnapshot.from_objects(fills, nodes),
                                 pending)
        assert got.node_name == ref.node_name == oracle.nominated_node_name
        assert (sorted(p.metadata.name for p in got.victims)
                == sorted(p.metadata.name for p in ref.victims)
                == sorted(p.metadata.name for p in oracle.victims))


# ------------------------------------------------- rebuild-storm gates


class TestNodeChurnStorm:
    """Node add/remove churn with pre-warmed vocab stays delta-class: the
    live sharded session is patched per lane, never torn down, and
    decisions stay identical to the rebuild-everything control."""

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_churn_stays_delta_class(self, layout, monkeypatch):
        monkeypatch.setenv("KTPU_SESSION_DELTAS", "1")
        monkeypatch.setenv("KTPU_NODE_HEADROOM", "0.5")
        mesh = _mesh(8, layout)

        def drive(delta_patching):
            cache, be = _mk_backend(20, mesh=mesh)
            be.delta_patching = delta_patching
            got = [n for _, n in be.schedule_many(_pods("warm", 4))]
            sess = be._session
            r0 = _rebuilds({"node-add", "node-remove"})
            for _ in range(3):
                for i in range(12, 16):
                    cache.remove_node(f"node-{i}")
                for i in range(12, 16):
                    cache.add_node(_node(i))
            alive = be._session is sess
            got += [n for _, n in be.schedule_many(_pods("after", 6))]
            return got, alive, _rebuilds({"node-add", "node-remove"}) - r0

        got, alive, churn = drive(True)
        ref, _, ref_churn = drive(False)
        assert got == ref
        assert alive, "pre-warmed churn tore the session down"
        assert churn == 0, f"churn caused {churn} rebuilds"
        assert ref_churn > 0

    def test_structural_event_still_rebuilds(self, monkeypatch):
        """A genuinely new node name (vocab growth) is not forced through
        the delta path."""
        monkeypatch.setenv("KTPU_SESSION_DELTAS", "1")
        cache, be = _mk_backend(8, mesh=_mesh(8))
        got = [n for _, n in be.schedule_many(_pods("warm", 2))]
        cache.add_node(_port_obj(make_node(
            "brand-new-node", cpu="64", memory="256Gi",
            labels={v1.LABEL_HOSTNAME: "brand-new-node"})))
        got += [n for _, n in be.schedule_many(
            _pods("big", 1, cpu="32", memory="128Gi"))]
        assert got[-1] == "brand-new-node"


# ------------------------------------------- ladder rungs and observability


class TestMeshLadder:
    def test_explain_and_demotion_ride_the_lead_device(self, monkeypatch):
        """Explain and a demoted ladder build the hoisted session on the
        lead device, each counted under its reason; the decisions equal
        the sharded session's."""
        from kubernetes_tpu_torch.ops.hoisted import HoistedSession
        from kubernetes_tpu_torch.scheduler.degradation import RUNG_HOISTED

        mesh = _mesh(4, "split")
        pods = _pods("w", 12, seed=7)
        _, be = _mk_backend(9, mesh=mesh)
        want = [n for _, n in be.schedule_many(copy.deepcopy(pods))]
        assert isinstance(be._session, ShardedScanSession)

        def builds(reason):
            return sum(v for k, v in metrics.session_builds.items()
                       if k == ("hoisted", reason, "4"))

        monkeypatch.setenv("KTPU_EXPLAIN", "1")
        e0 = builds("explain")
        _, be = _mk_backend(9, mesh=mesh)
        assert [n for _, n in be.schedule_many(copy.deepcopy(pods))] == want
        assert isinstance(be._session, HoistedSession)
        assert builds("explain") - e0 == 1
        monkeypatch.delenv("KTPU_EXPLAIN")
        d0 = builds("mesh-ladder-demoted")
        _, be = _mk_backend(9, mesh=mesh)
        assert be.ladder.demote()
        assert be.ladder.rung() == RUNG_HOISTED < be.ladder.top
        assert [n for _, n in be.schedule_many(copy.deepcopy(pods))] == want
        assert isinstance(be._session, HoistedSession)
        assert builds("mesh-ladder-demoted") - d0 == 1

    def test_unsupported_shape_counts_mesh_reason(self):
        """A host-port template: the sharded session refuses it as
        ScanSession does, and the mesh build counts mesh-host-ports."""
        from kubernetes_tpu_torch.ops.hoisted import HoistedSession

        _, be = _mk_backend(4, mesh=_mesh(2))
        key = ("hoisted", "mesh-host-ports", "2")
        n0 = dict(metrics.session_builds.items()).get(key, 0)
        pods = [_port_obj(make_pod(f"hp-{i}", namespace="default",
                                   cpu="100m", host_port=8080 + i))
                for i in range(2)]
        got = [n for _, n in be.schedule_many(pods)]
        assert all(got)
        assert isinstance(be._session, HoistedSession)
        assert dict(metrics.session_builds.items()).get(key, 0) - n0 == 1


class TestMeshObservability:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_mesh_shards_gauge_and_labels(self, layout):
        _, be = _mk_backend(6, mesh=_mesh(8, layout))
        assert metrics.mesh_shards.value() == 8.0
        be.schedule_many(_pods("warm", 2))
        keys = [k for k, val in metrics.session_builds.items() if val]
        assert ("kernel", "mesh-sharded", "8") in keys, keys
        assert be._devtime_slug() == "kernel@8"

    def test_no_mesh_blank_shards_label(self):
        _, be = _mk_backend(4, mesh=None)
        be.schedule_many(_pods("warm", 2))
        keys = [k for k, val in metrics.session_builds.items() if val]
        assert any(k[-1] == "" for k in keys), keys
        assert metrics.mesh_shards.value() == 0.0


# ----------------------------------------------------------------- loop


def _loop(mesh_devices, monkeypatch):
    """run_workload at the shape of tests/test_sharded.py's loop: 40
    nodes in 3 zones, 36 pods, required hostname anti-affinity on every
    second one; -> (Result, pod -> node)."""
    from kubernetes_tpu_torch.perf import harness

    apis = []

    class Captured(harness.APIServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            apis.append(self)

    monkeypatch.setattr(harness, "APIServer", Captured)
    w = harness.Workload(
        "mesh-loop", num_nodes=40, num_pods=36, n_zones=3, max_batch=64,
        template=harness.PodTemplate(cpu="100m", labels={"app": "mesh"}),
        second_template=harness.PodTemplate(
            cpu="100m", labels={"app": "mesh"}, anti_affinity_hostname=True),
        second_every=2, mesh_devices=mesh_devices, timeout=120.0)
    r = harness.run_workload(w, device="cpu")
    pods, _ = harness.Clientset(apis[0]).pods.list(namespace="default")
    return r, {p.metadata.name: p.spec.node_name for p in pods}


def test_run_workload_mesh_binds_as_single_device(monkeypatch):
    """The mesh loop binds as the single-device loop (the contract the
    reference's own mesh loop test fails), every batch on the sharded
    session; the anti-affinity pods land one per node."""
    b0 = dict(metrics.session_builds.items())
    r, with_mesh = _loop(8, monkeypatch)
    builds = {k: v - b0.get(k, 0)
              for k, v in metrics.session_builds.items()}
    s, without = _loop(0, monkeypatch)
    assert r.mesh_shards == 8 and s.mesh_shards == 0
    assert r.num_bound == s.num_bound == 36
    bound = {k: v for k, v in with_mesh.items() if v}
    assert bound == {k: v for k, v in without.items() if v}
    assert builds.get(("kernel", "mesh-sharded", "8"), 0) >= 1
    assert not any(v for k, v in builds.items() if k[0] == "hoisted")
    anti = [v for k, v in bound.items()
            if k.startswith("measure-") and int(k.split("-")[-1]) % 2 == 0]
    assert len(set(anti)) == len(anti) > 0
