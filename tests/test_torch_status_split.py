"""A pod's status write split around a batch, in both packages, on the CPU.

The scheduler cache hands a pod update to its listeners as a removal and
an add (`scheduler/internal/cache.py` `update_pod`), and the backend takes
each under its own lock. In the reference, a batch dispatched between the
two flushes the removal and not the add, so it is decided as if the pod's
node did not hold the pod (ROADMAP.md, reference quirks). The port's
cache announces the update first (`on_update_pod_begin`), and its backend
holds the removal until the add applies both under one acquisition of its
lock (ROADMAP.md Queue 3).

The interleaving is pinned: the backend's `on_add_pod` dispatches the
batch before it takes the add. Three nodes in three zones; `app=web`
pods bound in zone-0 and zone-1; a web pod with a zone spread (maxSkew
1, DoNotSchedule) pending, after a live session was built. Taken whole,
the status write of zone-0's pod leaves the pending pod zone-2 alone.
Split, the reference puts it in zone-0: zone-0 then holds two web pods
and zone-2 none, a skew of 2 against the constraint's 1. The port still
puts it in zone-2.
"""

from __future__ import annotations

import importlib

import pytest

from ._dual import PACKAGES
from .test_torch_backend import _private_device_state


def _mods(package):
    return (importlib.import_module(f"{package}.api.types"),
            importlib.import_module(f"{package}.scheduler.internal.cache"),
            importlib.import_module(f"{package}.scheduler.tpu_backend"))


def _pod(v1, name, labels, node="", spread=False):
    spec = v1.PodSpec(node_name=node, containers=[v1.Container(
        name="c", image="img", resources=v1.ResourceRequirements(
            requests={"cpu": "100m", "memory": "64Mi"}))])
    if spread:
        spec.topology_spread_constraints = [v1.TopologySpreadConstraint(
            max_skew=1, topology_key=v1.LABEL_ZONE,
            when_unsatisfiable="DoNotSchedule",
            label_selector=v1.LabelSelector(match_labels=dict(labels)))]
    return v1.Pod(metadata=v1.ObjectMeta(
        name=name, namespace="default", uid=name, labels=dict(labels)),
        spec=spec)


def _world(package):
    """-> (v1, the cache, the backend, the bound web pods): three nodes in
    three zones, web-0 and web-1 bound in zone-0 and zone-1, and a live
    session built by another app's pod."""
    v1, cache_mod, be_mod = _mods(package)
    if package == PACKAGES[1]:
        be = be_mod.TPUBackend(device="cpu", use_kernel=True)
    else:
        be = be_mod.TPUBackend()
        _private_device_state(be.enc)
    cache = cache_mod.SchedulerCache()
    cache.add_listener(be)
    for i in range(3):
        alloc = {"cpu": "4", "memory": "8Gi", "pods": "110"}
        cache.add_node(v1.Node(
            metadata=v1.ObjectMeta(name=f"node-{i}", labels={
                v1.LABEL_HOSTNAME: f"node-{i}",
                v1.LABEL_ZONE: f"zone-{i}"}),
            status=v1.NodeStatus(capacity=dict(alloc),
                                 allocatable=alloc)))
    web = {"app": "web"}
    bound = [_pod(v1, f"web-{i}", web, node=f"node-{i}") for i in range(2)]
    for pod in bound:
        cache.add_pod(pod)
    other = _pod(v1, "other-0", {"app": "other"}, spread=True)
    (_, node), = be.schedule_many([other])
    other.spec.node_name = node
    cache.add_pod(other)
    return v1, cache, be, bound


def _running(v1, pod):
    new = _pod(v1, pod.metadata.name, pod.metadata.labels,
               node=pod.spec.node_name)
    new.status.phase = "Running"
    new.status.conditions = [v1.PodCondition(type="Ready", status="True")]
    return new


def _status_write(package, split):
    """-> (the pending web pod's node, web pods a zone after the write,
    the backend's event log over the write)."""
    v1, cache, be, bound = _world(package)
    try:
        pending = _pod(v1, "web-2", {"app": "web"}, spread=True)
        decided = {}
        if split:
            on_add = be.on_add_pod

            def on_add_pod(pod, node_name):
                if pod.metadata.name == "web-0" and not decided:
                    (_, decided["node"]), = be.schedule_many([pending])
                return on_add(pod, node_name)

            be.on_add_pod = on_add_pod
        be.event_log = []
        new = _running(v1, bound[0])
        cache.update_pod(bound[0], new)
        log = [(kind, obj.metadata.name) for _, kind, obj, _ in
               be.event_log or ()]
        if not split:
            (_, decided["node"]), = be.schedule_many([pending])
        zones = [0, 0, 0]
        for pod in (new, bound[1]):
            zones[int(pod.spec.node_name[-1])] += 1
        zones[int(decided["node"][-1])] += 1
        return decided["node"], zones, log
    finally:
        be.close()


@pytest.mark.parametrize("package", PACKAGES)
def test_whole_status_write_keeps_the_spread(package):
    node, zones, _ = _status_write(package, split=False)
    assert node == "node-2"
    assert zones == [1, 1, 1]


@pytest.mark.parametrize("package", PACKAGES[:1])
def test_split_status_write_decides_without_the_pod(package):
    """The reference decides the batch on the half-applied write: the
    constraint's skew of 1 ends at 2."""
    node, zones, _ = _status_write(package, split=True)
    assert node == "node-0"
    assert zones == [2, 1, 0]


def test_port_holds_the_removal_for_the_add():
    """The port's batch between the removal and the add sees the pod as
    it was: the spread holds, and the backend takes the removal and the
    add together, after the batch."""
    node, zones, log = _status_write(PACKAGES[1], split=True)
    assert node == "node-2"
    assert zones == [1, 1, 1]
    assert log == [("remove", "web-0"), ("add", "web-0")]


def test_port_update_without_an_add_applies_the_removal():
    """A removal still held when the update ends (no add came) applies
    then; a removal outside an update applies at once."""
    v1, cache, be, bound = _world(PACKAGES[1])
    try:
        be.event_log = []
        be.on_update_pod_begin(bound[0])
        be.on_remove_pod(bound[0], "node-0")
        assert v1.pod_key(bound[0]) in be.enc._pods
        assert be.event_log == []
        be.on_update_pod_end(bound[0])
        assert v1.pod_key(bound[0]) not in be.enc._pods
        be.on_remove_pod(bound[1], "node-1")
        assert v1.pod_key(bound[1]) not in be.enc._pods
        assert [(k, o.metadata.name) for _, k, o, _ in be.event_log] == [
            ("remove", "web-0"), ("remove", "web-1")]
    finally:
        be.close()


def test_port_event_log_counts_the_batches_before_each_event():
    """`event_log` entries carry the number of batches dispatched before
    the event, and the seconds the backend spent on it."""
    v1, cache, be, bound = _world(PACKAGES[1])
    try:
        be.event_log = []
        n0 = be.dispatches
        cache.update_pod(bound[0], _running(v1, bound[0]))
        h = be.dispatch_many([_pod(v1, "web-2", {"app": "web"},
                                   spread=True)])
        be.harvest(h)
        cache.update_pod(bound[1], _running(v1, bound[1]))
        assert be.dispatches == n0 + 1
        assert [(at - n0, k, o.metadata.name)
                for at, k, o, _ in be.event_log] == [
            (0, "remove", "web-0"), (0, "add", "web-0"),
            (1, "remove", "web-1"), (1, "add", "web-1")]
        assert all(s >= 0.0 for *_, s in be.event_log)
    finally:
        be.close()
