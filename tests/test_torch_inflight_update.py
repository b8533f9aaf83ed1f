"""A pending pod updated while its batch is in flight, in both packages'
loops at pipeline depth 2, on the CPU.

A write to a pending pod (its status, an annotation) reaches the
scheduler's queue as an update (`internal/queue.py`
`PriorityQueue.update`), which queues a pod found in none of its queues. A pod popped into a dispatched batch is in
none of them, so in the reference it is queued again, and the next batch
decides it a second time. That batch's harvest moves the pod in the host
encoding to its second node, while the cache refuses the second assume
and the apiserver holds the first bind: the encoding shows room on the
pod's real node. A preemptor that fails after that is found to fit there
by the failure wave's re-evaluation, which binds it straight to that node
and puts it over its allocatable (seen on the card in chip_smoke.py's row
14b). The port keeps a batch's pods in flight until the batch completes
(`Scheduler._flight_keys`): such an update waits for the batch, and the
pod is queued again only if the batch left it pending.

The interleaving is pinned: the first batch's completion waits (the
completion worker's stall seam) until the update has been delivered and
the queue popped again.
"""

from __future__ import annotations

import pytest

from kubernetes_tpu.api.quantity import parse_quantity

from .test_torch_loop import _Loop
from .test_torch_preemption_race import _Stall
from .util import make_pod, wait_until

NODE_CPU = "2"                 # two nodes of 2 CPUs
POD_CPU = "1500m"              # one such pod a node


def _idle(sched):
    with sched._inflight_lock:
        return sched._inflight == 0


def _settle(sched):
    assert sched._drain_pipeline(timeout=30)
    assert wait_until(lambda: _idle(sched), 30)


def _in_flight_update(port):
    """-> (the pod popped again while in flight, or None; CPU millis bound
    per node; the allocatable CPU millis of a node)."""
    loop = _Loop(port, depth=2, rung="kernel", n_nodes=2, node_cpu=NODE_CPU)
    sched, cs = loop.sched, loop.cs
    try:
        cs.pods.create(loop.obj(make_pod(
            "a", cpu=POD_CPU, memory="64Mi", priority=0)))
        assert wait_until(lambda: sched.queue.num_active() >= 1, 10)
        first = sched.queue.pop(timeout=1)
        stall = _Stall()
        sched.faults = stall
        sched._schedule_batch_tpu([first])
        # a write to the pending pod while its batch flies
        fresh = cs.pods.get("a", "default")
        fresh.metadata.annotations = dict(
            fresh.metadata.annotations or {}, touched="1")
        cs.pods.update(fresh)
        assert wait_until(lambda: (sched.informers.pods().get(
            "default/a").metadata.annotations or {}).get("touched") == "1",
            10)
        again = sched.queue.pop(timeout=0.5)
        if again is not None:
            sched._schedule_batch_tpu([again])
        stall.go.set()
        _settle(sched)
        assert wait_until(lambda: bool(cs.pods.get(
            "a", "default").spec.node_name), 10)
        # a preemptor that no node has room for in the session
        cs.pods.create(loop.obj(make_pod(
            "b", cpu=POD_CPU, memory="64Mi", priority=1000)))
        assert wait_until(lambda: sched.queue.num_active() >= 1, 10)
        sched._schedule_batch_tpu([sched.queue.pop(timeout=1)])
        _settle(sched)
        used = {}
        for p in cs.pods.list(namespace="default")[0]:
            if p.spec.node_name:
                used[p.spec.node_name] = used.get(p.spec.node_name, 0) + \
                    parse_quantity(p.spec.containers[0].resources.requests[
                        "cpu"])
        return (again.pod.metadata.name if again is not None else None,
                used, parse_quantity(NODE_CPU))
    finally:
        loop.close()


@pytest.mark.parametrize("package", ["reference", "port"])
def test_update_of_a_pod_in_flight(package):
    again, used, alloc = _in_flight_update(package == "port")
    if package == "reference":
        # the second decision and what follows it (ROADMAP.md, reference
        # quirks)
        assert again == "a"
        assert max(used.values()) > alloc
    else:
        assert again is None
        assert max(used.values()) <= alloc
