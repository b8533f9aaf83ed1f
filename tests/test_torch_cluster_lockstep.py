"""The port's ROADMAP.md Queue 1 slice 10f held to the reference on the same
inputs, on the CPU.

- `Cluster`: both packages' whole control plane (12 hollow nodes) on
  their TPU backends, the port's on `device="cpu"` at the kernel rung.
  The scheduler is paused while seeded bare pods with fixed names are
  created, then resumed: the two packages bind every pod to the same
  node.
- testing/invariants.py: `parse_metrics`, `window_p99` and every
  invariant of an `InvariantSuite`, folded over the same recorded
  Prometheus texts, give equal readings, percentiles and violations.
- testing/locks.py: `LockOrderSentinel` over a scripted acquisition
  order, with and without a cycle, gives equal edge graphs and verdicts.
- graft_entry.py: `entry()` on the CPU gives `__graft_entry__.entry()`'s
  outputs, and `dryrun_multichip(8, device="cpu")` passes and counts its
  session build under the `shards` label.
- The port's `Cluster()` raises without CUDA: it never falls back to the
  CPU."""

from __future__ import annotations

import functools
import threading
import time

import numpy as np
import pytest
import torch

import kubernetes_tpu.cluster as ref_cluster
import kubernetes_tpu.testing.invariants as ref_inv
import kubernetes_tpu.testing.locks as ref_locks
import kubernetes_tpu_torch.cluster as port_cluster
import kubernetes_tpu_torch.testing.invariants as port_inv
import kubernetes_tpu_torch.testing.locks as port_locks
from kubernetes_tpu.api import types as ref_v1
from kubernetes_tpu.testing import synth as ref_synth
from kubernetes_tpu_torch.api import types as port_v1
from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend
from kubernetes_tpu_torch.testing import synth as port_synth

SIDES = (
    (ref_cluster, ref_v1, ref_synth, {}),
    (port_cluster, port_v1, port_synth, {"device": "cpu"}),
)


def _wait(fn, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.05)
    return False


def _pod_specs(seed: int, n: int):
    """Seeded bare pods: requests, labels and a hostname spread on some."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(dict(
            name=f"ls-{seed}-{i}",
            cpu=f"{int(rng.integers(1, 12)) * 100}m",
            memory=f"{int(rng.integers(1, 9)) * 256}Mi",
            app=f"app-{int(rng.integers(0, 3))}",
            spread=bool(rng.integers(0, 3) == 0),
        ))
    return out


def _make_pod(v1, synth, spec):
    constraints = None
    if spec["spread"]:
        constraints = [v1.TopologySpreadConstraint(
            max_skew=1, topology_key=v1.LABEL_HOSTNAME,
            when_unsatisfiable="DoNotSchedule",
            label_selector=v1.LabelSelector(
                match_labels={"app": spec["app"]}))]
    return synth.make_pod(spec["name"], cpu=spec["cpu"],
                          memory=spec["memory"],
                          labels={"app": spec["app"]},
                          constraints=constraints)


def _cluster_bindings(cluster_mod, v1, synth, kw, specs):
    with cluster_mod.Cluster(
            n_nodes=12, controllers=["nodelifecycle"],
            controller_opts={"node_monitor_period": 0.3}, **kw) as c:
        sched = c.scheduler
        assert sched.tpu is not None
        # Ready nodes lose the not-ready taint to the lifecycle controller
        assert _wait(lambda: sched.cache.node_count() == 12 and not any(
            n.spec.taints for n in c.client.nodes.list()[0]))
        sched.pause()
        time.sleep(0.3)  # an in-flight pop parks before the pods come
        for s in specs:
            c.client.pods.create(_make_pod(v1, synth, s))
        assert _wait(lambda: sched.queue.num_active() == len(specs))
        sched.resume()

        def bound():
            pods, _ = c.client.pods.list(namespace="default")
            return {p.metadata.name: p.spec.node_name for p in pods
                    if p.spec.node_name}

        assert _wait(lambda: len(bound()) == len(specs)), bound()
        return bound()


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_bindings_equal(seed, monkeypatch):
    """Both packages' `Cluster`s bind the same seeded pods to the same
    nodes; the port's backend on the CPU at the kernel rung."""
    init = TPUBackend.__init__

    @functools.wraps(init)
    def kernel_rung(self, *args, **kw):
        kw["use_kernel"] = True
        init(self, *args, **kw)

    monkeypatch.setattr(TPUBackend, "__init__", kernel_rung)
    specs = _pod_specs(seed, 40)
    got = [_cluster_bindings(*side, specs) for side in SIDES]
    assert got[0] == got[1]
    assert len(set(got[1].values())) > 1


# -- invariants ------------------------------------------------------------

_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0)


def _recorded_texts(seed: int, n: int = 12):
    """A recorded /metricsz run: counters that stay or move, gauges that
    drift and return, a labelled histogram that slows down, comments and
    a malformed line the parser skips."""
    rng = np.random.default_rng(seed)
    drift = 0.0
    transitions = 1.0
    buckets = np.zeros(len(_BUCKETS) + 1)
    texts = []
    for i in range(n):
        if rng.random() < 0.2:
            drift += 1
        if rng.random() < 0.4:
            transitions += 1
        obs = rng.exponential(0.002 * (1 + 3 * i * int(seed % 2)), 20)
        for o in obs:
            buckets[np.searchsorted(_BUCKETS, o):] += 1
        lines = [
            "# HELP scheduler_parity_drift_total drift",
            "# TYPE scheduler_parity_drift_total counter",
            f'scheduler_parity_drift_total{{kind="a"}} {drift}',
            f'scheduler_parity_drift_total{{kind="b"}} {drift / 2}',
            f"scheduler_leader_transitions_total {transitions}",
            f"process_open_fds {40 + int(rng.integers(0, 40)) + i * seed}",
            f"process_threads {100 + int(rng.integers(0, 8))}",
            f"scheduler_pending_pods "
            f"{int(rng.integers(0, 30)) if i < n - 1 else seed}",
            f"scheduler_cache_oldest_assume_seconds {rng.random() * 40:.6f}",
            "this line has no value",
        ]
        for le, cum in zip(_BUCKETS + (float("inf"),), buckets):
            tag = "+Inf" if le == float("inf") else f"{le:g}"
            lines.append(
                f'scheduler_stage_seconds_bucket{{stage="bind",le="{tag}"}} '
                f"{cum:g}")
        texts.append("\n".join(lines) + "\n")
    return texts


def _suite(inv, texts):
    it = iter(texts)
    return inv.InvariantSuite([
        inv.CounterFlat("scheduler_parity_drift_total",
                        label="zero-shadow-drift"),
        inv.CounterMoved("scheduler_leader_transitions_total", min_delta=3),
        inv.GaugeBaseline("scheduler_pending_pods", slack=4),
        inv.BoundedGrowth("process_open_fds", max_abs=32, max_frac=0.5),
        inv.BoundedGrowth("process_threads", max_abs=4),
        inv.GaugeCeiling("scheduler_cache_oldest_assume_seconds",
                         ceiling=30.0),
        inv.HistogramP99Flat("scheduler_stage_seconds", ratio=2.0,
                             floor=0.001),
        inv.Callback("callback", lambda: ["one violation"]),
    ], scrape=lambda: next(it))


@pytest.mark.parametrize("seed", range(6))
def test_invariants_fold_equal(seed):
    """parse_metrics, window_p99 and the suite's verdicts are equal."""
    texts = _recorded_texts(seed)
    readings = [[inv.parse_metrics(t) for t in texts]
                for inv in (ref_inv, port_inv)]
    assert readings[0] == readings[1]
    for a, b in zip(readings[0], readings[0][1:]):
        assert ref_inv.window_p99(a, b, "scheduler_stage_seconds") == \
            port_inv.window_p99(a, b, "scheduler_stage_seconds")
    assert ref_inv.bucket_counts(readings[0][-1], "scheduler_stage_seconds") \
        == port_inv.bucket_counts(readings[1][-1], "scheduler_stage_seconds")
    out = []
    for inv in (ref_inv, port_inv):
        suite = _suite(inv, texts)
        for _ in texts[:-1]:
            suite.sample()
        violations = suite.finish()
        p99 = [(i.first_p99, i.last_p99) for i in suite.invariants
               if hasattr(i, "last_p99")]
        out.append((violations, p99, [i.name for i in suite.invariants]))
    assert out[0] == out[1]
    assert "one violation" in out[0][0]


# -- lock sentinel ---------------------------------------------------------

def _scripted(locks_mod, cycle: bool):
    """Three locks made while the sentinel is installed, taken in a
    scripted order on two threads; the second thread closes a cycle
    when asked."""
    s = locks_mod.LockOrderSentinel()
    s.install()
    try:
        a = threading.Lock()
        b = threading.RLock()
        c = threading.Lock()
    finally:
        s.uninstall()

    def first():
        with a:
            with b:
                with c:
                    pass
        with b:
            with b:  # re-entry adds no edge to itself
                pass

    def second():
        if cycle:
            with c:
                with a:
                    pass
        else:
            with a:
                with c:
                    pass

    for fn in (first, second):
        t = threading.Thread(target=fn, name=f"scripted-{fn.__name__}")
        t.start()
        t.join()
    cyc = s.find_cycle()
    try:
        s.assert_cycle_free()
        verdict = ""
    except AssertionError as e:
        verdict = str(e)
    return dict(s.edges), cyc, verdict


def _normalized(result):
    """Label paths name the package's own file: compare line numbers."""
    edges, cyc, verdict = result

    def label(x):
        return x.rsplit(":", 1)[-1]

    import re

    return ({(label(a), label(b)): t for (a, b), t in edges.items()},
            [label(x) for x in cyc],
            re.sub(r"\S+\.py:(\d+)", r"\1", verdict))


@pytest.mark.parametrize("cycle", [False, True])
def test_lock_sentinel_equal(cycle):
    """Equal acquisition graphs and verdicts on the same scripted order."""
    got = [_normalized(_scripted(m, cycle)) for m in (ref_locks, port_locks)]
    assert got[0] == got[1]
    edges, cyc, verdict = got[1]
    assert len(edges) == 4 if cycle else 3
    assert bool(cyc) == cycle and bool(verdict) == cycle
    assert threading.Lock is port_locks._REAL_LOCK


def test_lock_sentinel_context_raises_on_cycle():
    """`lock_order_sentinel()` asserts at exit in both packages."""
    for m in (ref_locks, port_locks):
        with pytest.raises(AssertionError, match="lock-order cycle"):
            with m.lock_order_sentinel():
                # a lock's label is the line that made it
                a = threading.Lock()
                b = threading.Lock()
                with a, b:
                    pass
                with b, a:
                    pass
        with m.lock_order_sentinel() as s:
            a = threading.Lock()
            b = threading.Lock()
            with a, b:
                pass
        assert len(s.edges) == 1


# -- entry point -------------------------------------------------------------

def test_graft_entry_equals_reference():
    """`entry()`'s function on its arguments (the port on the CPU) gives
    the reference entry's outputs, key by key."""
    import jax

    import __graft_entry__ as ref_entry
    from kubernetes_tpu_torch import graft_entry

    fn, args = ref_entry.entry()
    want = jax.device_get(fn(*args))
    pfn, (cluster, pod) = graft_entry.entry(device="cpu")
    assert cluster["valid"].device.type == "cpu"
    got = pfn(cluster, pod)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    assert bool(got["feasible"].any())


def test_graft_entry_dryrun_multichip_cpu():
    """Eight one-shard CPU groups: every step passes, and the backend's
    mesh session build is counted under kind, reason and shards."""
    from kubernetes_tpu_torch import graft_entry
    from kubernetes_tpu_torch.scheduler.metrics import session_builds

    before = session_builds.value(kind="kernel", reason="mesh-sharded",
                                  shards="8")
    out = graft_entry.dryrun_multichip(8, device="cpu")
    assert out["layout"] == "8x8@1"
    assert session_builds.value(kind="kernel", reason="mesh-sharded",
                                shards="8") >= before + 1
    assert session_builds.label_names == ("kind", "reason", "shards")


def test_graft_entry_defaults_to_the_card(monkeypatch):
    from kubernetes_tpu_torch import graft_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        graft_entry.entry()
    with pytest.raises(RuntimeError):
        graft_entry.dryrun_multichip(1)


def test_port_cluster_raises_without_cuda(monkeypatch):
    """`Cluster()` builds its scheduler's backend on the card: without
    CUDA it raises, and restores the feature gates it set."""
    from kubernetes_tpu_torch.utils.featuregate import default_feature_gate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    saved = default_feature_gate.overrides()
    with pytest.raises(RuntimeError):
        port_cluster.Cluster(feature_gates="CSIStorageCapacity=true")
    assert default_feature_gate.overrides() == saved
    with port_cluster.Cluster(device="cpu") as c:
        assert c.scheduler.tpu.device == torch.device("cpu")
