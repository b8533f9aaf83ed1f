"""A failure-wave bind racing a batch in flight, in both packages' loops at
pipeline depth 2, on the CPU.

With the loop pipelined, the failure wave runs on the completion worker.
A redispatched pod that fits now is bound there directly (`scheduler.py`
`_handle_failure_wave` -> `reevaluate` -> `_assume_and_bind`). The
re-evaluation tears the live session down, so a batch the scheduling
thread dispatches before that bind lands builds its session from an
encoding without it, and may give the same room to one of its own pods.
The reference assumes that harvest as it comes and puts the node over its
allocatable. The port checks a harvest whose flight overlapped such a bind
against the cache (`Scheduler._fit_harvest`): the pod that no longer fits
leaves the session and goes back to the queue.

The interleaving is pinned: the batch is dispatched by the loop's own
`_schedule_batch_tpu` between the re-evaluation and the bind, and its
completion waits (the completion worker's stall seam) until the failure
wave has returned.
"""

from __future__ import annotations

import threading

import pytest

from kubernetes_tpu.api.quantity import parse_quantity

from .test_torch_loop import _Loop
from .util import make_pod, wait_until

NODE_CPU = "2"                 # two nodes of 2 CPUs
POD_CPU = "1500m"              # one such pod a node


class _Stall:
    """The completion worker's fault seam: each completion waits for
    `go`."""

    def __init__(self):
        self.go = threading.Event()

    def on_completion(self):
        assert self.go.wait(30)

    def take_kill(self, worker):
        return False


def _race(port):
    """-> (CPU millis bound per node, names of the queued pods, the node's
    allocatable CPU millis)."""
    loop = _Loop(port, depth=2, rung="kernel", n_nodes=2, node_cpu=NODE_CPU)
    sched, cs = loop.sched, loop.cs
    try:
        # node-1 holds a low-priority pod: the cluster's priority floor is
        # 0, so the preemptor takes the failure wave's preemption path
        cs.pods.create(loop.obj(make_pod(
            "low", cpu=POD_CPU, memory="64Mi", priority=0,
            node_name="node-1")))
        assert wait_until(lambda: sched.cache.has_pod("default/low"), 10)
        for name, prio in (("urgent", 1000), ("filler", 0)):
            cs.pods.create(loop.obj(make_pod(
                name, cpu=POD_CPU, memory="64Mi", priority=prio)))
        assert wait_until(lambda: sched.queue.num_active() >= 2, 10)
        urgent, filler = sched.queue.pop(timeout=1), sched.queue.pop(
            timeout=1)
        assert (urgent.pod.metadata.name, filler.pod.metadata.name) == (
            "urgent", "filler")
        stall = _Stall()
        sched.faults = stall
        reevaluate = sched.tpu.reevaluate

        def reevaluate_then_dispatch(pods):
            out = reevaluate(pods)
            # the scheduling thread's next batch, after the session went
            # and before the failure wave binds
            sched._schedule_batch_tpu([filler])
            return out

        sched.tpu.reevaluate = reevaluate_then_dispatch
        # the urgent pod failed in an earlier batch; node-0 is free now
        sched._handle_failure_wave([urgent], sched.queue.scheduling_cycle)
        stall.go.set()
        assert sched._drain_pipeline(timeout=30)

        def idle():
            with sched._inflight_lock:
                return sched._inflight == 0

        assert wait_until(idle, 30)
        used = {}
        for p in cs.pods.list(namespace="default")[0]:
            if p.spec.node_name:
                used[p.spec.node_name] = used.get(p.spec.node_name, 0) + \
                    parse_quantity(p.spec.containers[0].resources.requests[
                        "cpu"])
        queued = []
        while (info := sched.queue.pop(timeout=0.2)) is not None:
            queued.append(info.pod.metadata.name)
        return used, queued, parse_quantity(NODE_CPU)
    finally:
        loop.close()


@pytest.mark.parametrize("package", ["reference", "port"])
def test_failure_wave_bind_and_batch_in_flight(package):
    used, queued, alloc = _race(package == "port")
    if package == "reference":
        # the race as the reference runs it (ROADMAP.md, reference quirks)
        assert used["node-0"] > alloc
        assert queued == []
    else:
        assert max(used.values()) <= alloc
        assert used == {"node-0": parse_quantity(POD_CPU),
                        "node-1": parse_quantity(POD_CPU)}
        assert queued == ["filler"]


def test_fit_harvest_keeps_what_fits():
    """A harvest overlapping a failure-wave bind keeps, in batch order,
    the placements the cache still has room for, and drops only the
    rest."""
    loop = _Loop(True, depth=2, rung="kernel", n_nodes=2, node_cpu="4")
    sched = loop.sched
    try:
        loop.cs.pods.create(loop.obj(make_pod(
            "taken", cpu="2", memory="64Mi", node_name="node-0")))
        assert wait_until(lambda: sched.cache.has_pod("default/taken"), 10)
        for i in range(3):
            loop.cs.pods.create(loop.obj(make_pod(
                f"p-{i}", cpu="1", memory="64Mi")))
        assert wait_until(lambda: sched.queue.num_active() >= 3, 10)
        infos = sorted((sched.queue.pop(timeout=1) for _ in range(3)),
                       key=lambda i: i.pod.metadata.name)
        dropped = []
        sched.tpu.drop_placements = dropped.extend
        kept = sched._fit_harvest([(i, "node-0") for i in infos])
        assert [(i.pod.metadata.name, n) for i, n in kept] == [
            ("p-0", "node-0"), ("p-1", "node-0")]
        assert [(p.metadata.name, n) for p, n in dropped] == [
            ("p-2", "node-0")]
        assert sched.queue.pop(timeout=1).pod.metadata.name == "p-2"
    finally:
        loop.close()

