"""The port's framework and default plugins (kubernetes_tpu_torch/
scheduler/framework/runtime.py Framework over plugins/registry.py
new_in_tree_registry() and default_plugins()) against the reference's, on
the CPU: the oracle rung the port's loop falls to.

Each case builds a snapshot and a pending pod in the reference's
api.types, converts them to the port's, and runs both packages' plugin
chains on them:

- PreFilter's status;
- every filter plugin on every node (no first-failure short cut, as
  scheduler/explain.py oracle_breakdown runs them): code and reasons;
- `run_filter_plugins` (first failure) per node;
- PreScore, then each score plugin's weighted, normalized score on the
  feasible nodes, and the totals;
- GenericScheduler (seeded rng, the default plugins without
  DefaultPreemption): the chosen node, or the FitError's message and
  per-node statuses.

The cases are tests/test_plugins.py's shapes and seeded random snapshots
(resources, taints, unschedulable nodes, zone and hostname labels, spread
constraints, (anti-)affinity, node selectors, host ports, images). Also:
the port's Scheduler with backend="tpu" and no backend raises when there
is no CUDA device (its default backend is the card's).
"""

from __future__ import annotations

import random

import pytest
import torch

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.scheduler.core import GenericScheduler as RefGeneric
from kubernetes_tpu.scheduler.framework import interface as ref_fwk
from kubernetes_tpu.scheduler.framework.runtime import Framework as RefFramework
from kubernetes_tpu.scheduler.framework.snapshot import Snapshot as RefSnapshot
from kubernetes_tpu.scheduler.plugins import registry as ref_registry
from kubernetes_tpu_torch.scheduler.core import GenericScheduler
from kubernetes_tpu_torch.scheduler.framework import interface as fwk
from kubernetes_tpu_torch.scheduler.framework.runtime import Framework
from kubernetes_tpu_torch.scheduler.framework.snapshot import Snapshot
from kubernetes_tpu_torch.scheduler.plugins import registry

from .test_torch_encoding import _port_obj
from .util import (
    anti_affinity,
    make_node,
    make_pod,
    pod_affinity,
    spread_constraint,
)

REF = (RefFramework, RefSnapshot, ref_registry, ref_fwk, RefGeneric)
PORT = (Framework, Snapshot, registry, fwk, GenericScheduler)


def _status(st):
    if st is None:
        return None
    return (st.code.name, tuple(st.reasons))


def _chain(pkg, pods, nodes, pod, seed=0):
    """Everything the plugin chain says about `pod` on this snapshot."""
    Fw, Snap, reg, iface, Generic = pkg
    snap = Snap.from_objects(pods, nodes)
    fw = Fw(reg.new_in_tree_registry(), plugins=reg.default_plugins(),
            snapshot_fn=lambda: snap)
    state = iface.CycleState()
    out = {"prefilter": _status(fw.run_pre_filter_plugins(state, pod))}
    if out["prefilter"] is None:
        feasible = []
        for ni in snap.list():
            name = ni.node.metadata.name
            out[f"filters/{name}"] = {
                pl.name: _status(pl.filter(state, pod, ni))
                for pl in fw.filter_plugins}
            first = fw.run_filter_plugins(state, pod, ni)
            out[f"first/{name}"] = {k: _status(v) for k, v in first.items()}
            if not first:
                feasible.append(ni.node)
        if feasible:
            out["prescore"] = _status(
                fw.run_pre_score_plugins(state, pod, feasible))
            scores, st = fw.run_score_plugins(state, pod, feasible)
            out["score_status"] = _status(st)
            out["scores"] = {pl: {ns.name: ns.score for ns in s}
                             for pl, s in scores.items()}
            totals = {}
            for s in scores.values():
                for ns in s:
                    totals[ns.name] = totals.get(ns.name, 0) + ns.score
            out["totals"] = totals
    plugins = reg.default_plugins_without("DefaultPreemption")
    snap = Snap.from_objects(pods, nodes)
    fw = Fw(reg.new_in_tree_registry(), plugins=plugins,
            snapshot_fn=lambda: snap)
    generic = Generic(percentage_of_nodes_to_score=100,
                      rng=random.Random(seed))
    try:
        out["host"] = generic.schedule(iface.CycleState(), fw, pod,
                                       snap).suggested_host
    except iface.FitError as e:
        out["fit_error"] = (str(e), {k: _status(v) for k, v in
                                     e.filtered_nodes_statuses.items()})
    return out


def _same(pods, nodes, pod, seed=0):
    ref = _chain(REF, pods, nodes, pod, seed)
    got = _chain(PORT, [_port_obj(p) for p in pods],
                 [_port_obj(n) for n in nodes], _port_obj(pod), seed)
    assert got == ref
    return ref


def _web_cluster(extra_nodes=()):
    nodes = [
        make_node("n1", labels={"zone": "z1", v1.LABEL_HOSTNAME: "n1"}),
        make_node("n2", labels={"zone": "z1", v1.LABEL_HOSTNAME: "n2"}),
        make_node("n3", labels={"zone": "z2", v1.LABEL_HOSTNAME: "n3"}),
        *extra_nodes,
    ]
    pods = [make_pod(f"web-{i}", labels={"app": "web"}, node_name=n)
            for i, n in enumerate(("n1", "n1", "n2"))]
    return pods, nodes


def _preferred(weight, term_labels, key, anti=False):
    term = v1.WeightedPodAffinityTerm(
        weight=weight, pod_affinity_term=v1.PodAffinityTerm(
            label_selector=v1.LabelSelector(match_labels=term_labels),
            topology_key=key))
    if anti:
        return v1.Affinity(pod_anti_affinity=v1.PodAntiAffinity(
            preferred_during_scheduling_ignored_during_execution=[term]))
    return v1.Affinity(pod_affinity=v1.PodAffinity(
        preferred_during_scheduling_ignored_during_execution=[term]))


def _node_affinity(weight, key, values):
    return v1.Affinity(node_affinity=v1.NodeAffinity(
        preferred_during_scheduling_ignored_during_execution=[
            v1.PreferredSchedulingTerm(
                weight=weight, preference=v1.NodeSelectorTerm(
                    match_expressions=[v1.NodeSelectorRequirement(
                        key=key, operator="In", values=list(values))]))]))


def _init_container_pod():
    pod = make_pod("init", cpu="1")
    pod.spec.init_containers = [v1.Container(
        name="init",
        resources=v1.ResourceRequirements(requests={"cpu": "1800m"}))]
    return pod


TAINT = v1.Taint(key="k", value="v", effect="NoSchedule")
IMG = v1.ContainerImage(names=["registry.example/app:v1"],
                        size_bytes=500 * 1024 * 1024)

# tests/test_plugins.py's shapes: (existing pods, nodes, pending pod)
CASES = {
    "insufficient-cpu": lambda: (
        [make_pod("e", cpu="1500m", node_name="n1")],
        [make_node("n1", cpu="2")], make_pod("p", cpu="1")),
    "fits-exactly": lambda: (
        [make_pod("e", cpu="1", node_name="n1")],
        [make_node("n1", cpu="2")], make_pod("p", cpu="1")),
    "too-many-pods": lambda: (
        [make_pod("e", node_name="n1")], [make_node("n1", pods=1)],
        make_pod("p")),
    "extended": lambda: (
        [make_pod("e", node_name="n1", extended={"nvidia.com/gpu": "1"})],
        [make_node("n1", extended={"nvidia.com/gpu": "2"}),
         make_node("n2")],
        make_pod("p", extended={"nvidia.com/gpu": "2"})),
    "init-container-max": lambda: (
        [make_pod("e", cpu="500m", node_name="n1")],
        [make_node("n1", cpu="2"), make_node("n2", cpu="4")],
        _init_container_pod()),
    "least-allocated": lambda: (
        [], [make_node("n1", cpu="4", memory="10Gi"),
             make_node("n2", cpu="8", memory="10Gi")],
        make_pod("p", cpu="1", memory="2560Mi")),
    "balanced-skewed": lambda: (
        [], [make_node("n1", cpu="4", memory="8Gi"),
             make_node("n2", cpu="8", memory="8Gi")],
        make_pod("p", cpu="4", memory="2Gi")),
    "nonzero-defaults": lambda: (
        [], [make_node("n1", cpu="1", memory="400Mi"),
             make_node("n2", cpu="2", memory="1Gi")], make_pod("p")),
    "taint-untolerated": lambda: (
        [], [make_node("n1", taints=[TAINT]), make_node("n2")],
        make_pod("p")),
    "taint-tolerated": lambda: (
        [], [make_node("n1", taints=[TAINT]), make_node("n2")],
        make_pod("p", tolerations=[v1.Toleration(
            key="k", operator="Equal", value="v", effect="NoSchedule")])),
    "prefer-no-schedule": lambda: (
        [], [make_node("n1", taints=[v1.Taint(
            key="k", value="v", effect="PreferNoSchedule")]),
            make_node("n2")], make_pod("p")),
    "node-name": lambda: (
        [], [make_node("n1"), make_node("n2")],
        make_pod("p", node_name="n2")),
    "unschedulable": lambda: (
        [], [make_node("n1", unschedulable=True), make_node("n2")],
        make_pod("p")),
    "host-port": lambda: (
        [make_pod("e", node_name="n1", host_port=8080)],
        [make_node("n1"), make_node("n2")], make_pod("p", host_port=8080)),
    "node-selector": lambda: (
        [], [make_node("n1", labels={"zone": "z1"}),
             make_node("n2", labels={"zone": "z2"})],
        make_pod("p", node_selector={"zone": "z2"})),
    "node-affinity-preferred": lambda: (
        [], [make_node("n1", labels={"tier": "gold"}), make_node("n2")],
        make_pod("p", affinity=_node_affinity(80, "tier", ["gold"]))),
    "image-locality": lambda: (
        [], [make_node("n1", images=[IMG]), make_node("n2")],
        make_pod("p", image="registry.example/app:v1")),
    "pts-filter": lambda: (
        *_web_cluster(), make_pod("p", labels={"app": "web"}, constraints=[
            spread_constraint(1, "zone", "DoNotSchedule", {"app": "web"})])),
    "pts-missing-label": lambda: (
        *_web_cluster([make_node("n4")]),
        make_pod("p", labels={"app": "web"}, constraints=[
            spread_constraint(1, "zone", "DoNotSchedule", {"app": "web"})])),
    "pts-score": lambda: (
        *_web_cluster(), make_pod("p", labels={"app": "web"}, constraints=[
            spread_constraint(1, "zone", "ScheduleAnyway", {"app": "web"})])),
    "anti-affinity": lambda: (
        [make_pod("e", labels={"app": "db"}, node_name="n1",
                  affinity=anti_affinity(v1.LABEL_HOSTNAME, {"app": "db"}))],
        [make_node("n1", labels={v1.LABEL_HOSTNAME: "n1"}),
         make_node("n2", labels={v1.LABEL_HOSTNAME: "n2"})],
        make_pod("p", labels={"app": "db"},
                 affinity=anti_affinity(v1.LABEL_HOSTNAME, {"app": "db"}))),
    "existing-anti-affinity": lambda: (
        [make_pod("e", labels={"app": "db"}, node_name="n1",
                  affinity=anti_affinity("zone", {"app": "web"}))],
        [make_node("n1", labels={"zone": "z1"}),
         make_node("n2", labels={"zone": "z2"})],
        make_pod("p", labels={"app": "web"})),
    "required-affinity": lambda: (
        [make_pod("e", labels={"app": "db"}, node_name="n1")],
        [make_node("n1", labels={"zone": "z1"}),
         make_node("n2", labels={"zone": "z2"})],
        make_pod("p", affinity=pod_affinity("zone", {"app": "db"}))),
    "self-affinity-first-pod": lambda: (
        [], [make_node("n1", labels={"zone": "z1"})],
        make_pod("p", labels={"app": "db"},
                 affinity=pod_affinity("zone", {"app": "db"}))),
    "preferred-affinity": lambda: (
        [make_pod("e", labels={"app": "cache"}, node_name="n1")],
        [make_node("n1", labels={"zone": "z1"}),
         make_node("n2", labels={"zone": "z2"})],
        make_pod("p", affinity=_preferred(100, {"app": "cache"}, "zone"))),
    "least-allocated-choice": lambda: (
        [make_pod("e", cpu="3", node_name="n1")],
        [make_node("n1"), make_node("n2")], make_pod("p", cpu="1")),
    "fit-error": lambda: (
        [], [make_node("n1", cpu="1"), make_node("n2", cpu="1",
                                                 taints=[TAINT])],
        make_pod("p", cpu="2")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plugin_chain_matches_reference(case):
    pods, nodes, pod = CASES[case]()
    _same(pods, nodes, pod)


def _random_pod(rng, name, node_name=""):
    zones = ["z0", "z1", "z2"]
    app = rng.choice(["web", "db", "cache"])
    kw = dict(cpu=rng.choice([None, "100m", "500m", "1", "2500m"]),
              memory=rng.choice([None, "64Mi", "512Mi", "2Gi"]),
              labels={"app": app}, node_name=node_name)
    roll = rng.random()
    if roll < 0.15:
        kw["constraints"] = [spread_constraint(
            rng.choice([1, 2]), rng.choice(["zone", v1.LABEL_HOSTNAME]),
            rng.choice(["DoNotSchedule", "ScheduleAnyway"]), {"app": app})]
    elif roll < 0.25:
        kw["affinity"] = anti_affinity(
            rng.choice(["zone", v1.LABEL_HOSTNAME]),
            {"app": rng.choice(["web", "db"])})
    elif roll < 0.35:
        kw["affinity"] = pod_affinity("zone", {"app": rng.choice(
            ["web", "db", "cache"])})
    elif roll < 0.45:
        kw["affinity"] = _preferred(rng.choice([10, 100]),
                                    {"app": rng.choice(["web", "db"])},
                                    "zone", anti=rng.random() < 0.5)
    elif roll < 0.5:
        kw["node_selector"] = {"zone": rng.choice(zones)}
    elif roll < 0.55:
        kw["affinity"] = _node_affinity(50, "zone", rng.sample(zones, 2))
    if rng.random() < 0.15:
        kw["host_port"] = rng.choice([8080, 9090])
    if rng.random() < 0.2:
        kw["tolerations"] = [v1.Toleration(key="k", operator="Exists")]
    return make_pod(name, **kw)


def _random_snapshot(rng):
    nodes = []
    for i in range(rng.randint(3, 7)):
        labels = {v1.LABEL_HOSTNAME: f"n{i}"}
        if rng.random() < 0.9:
            labels["zone"] = f"z{rng.randrange(3)}"
        taints = None
        if rng.random() < 0.2:
            taints = [v1.Taint(key="k", value="v", effect=rng.choice(
                ["NoSchedule", "PreferNoSchedule"]))]
        nodes.append(make_node(
            f"n{i}", cpu=rng.choice(["2", "4", "8"]),
            memory=rng.choice(["4Gi", "16Gi"]), pods=rng.choice([4, 110]),
            labels=labels, taints=taints,
            unschedulable=rng.random() < 0.1,
            images=[IMG] if rng.random() < 0.3 else None))
    pods = [_random_pod(rng, f"e{j}",
                        node_name=rng.choice(nodes).metadata.name)
            for j in range(rng.randint(0, 12))]
    return pods, nodes


@pytest.mark.parametrize("seed", range(8))
def test_plugin_chain_matches_reference_on_random_snapshots(seed):
    rng = random.Random(seed)
    pods, nodes = _random_snapshot(rng)
    for k in range(4):
        _same(pods, nodes, _random_pod(rng, f"p{k}"), seed=seed + k)


def test_scheduler_without_backend_needs_cuda(monkeypatch):
    from kubernetes_tpu_torch.apiserver import APIServer
    from kubernetes_tpu_torch.client import Clientset, SharedInformerFactory
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = Clientset(APIServer())
    with pytest.raises(RuntimeError):
        Scheduler(cs, SharedInformerFactory(cs), backend="tpu")
    sched = Scheduler(cs, SharedInformerFactory(cs), backend="oracle")
    try:
        assert sched.tpu is None
    finally:
        sched.shutdown()


@pytest.mark.parametrize("seed", range(4))
def test_explain_breakdowns_match_reference(seed):
    """scheduler/explain.py on tests/test_explain.py's random clusters:
    the port's oracle_breakdown (every filter plugin on every node, the
    score runners) and device_breakdown (schedule_pod on a fresh
    encoding, on the CPU here; its outputs read back with .cpu()) equal
    the reference's."""
    from kubernetes_tpu.scheduler import explain as ref_explain
    from kubernetes_tpu_torch.scheduler import explain

    from .test_kernel_parity import random_cluster, random_pending

    rng = random.Random(seed)
    nodes, pods = random_cluster(rng)
    port_nodes = [_port_obj(n) for n in nodes]
    port_pods = [_port_obj(p) for p in pods]
    for _ in range(2):
        pending = random_pending(rng)
        ref = ref_explain.oracle_breakdown(
            RefSnapshot.from_objects(list(pods), list(nodes)), pending)
        got = explain.oracle_breakdown(
            Snapshot.from_objects(port_pods, port_nodes), _port_obj(pending))
        assert got == ref
        ref = ref_explain.device_breakdown(nodes, pods, pending)
        got = explain.device_breakdown(port_nodes, port_pods,
                                       _port_obj(pending), device="cpu")
        assert got == ref
