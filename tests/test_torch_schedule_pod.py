"""The port's `schedule_pod` (ops/kernel.py in torch) equals the
reference's on the shapes of tests/test_kernel_parity.py: every output
(`feasible`, `total`, each `mask_*`, `score_*` and `*_unresolvable`), in
dtype, shape and value, exactly. `schedule_pods` (the batched form)
equals the reference's `schedule_pods_jit`, and the PTS weight table
equals jnp.log in f64 over every argument the sessions here can reach.

The reference runs as tests/test_kernel_parity.py runs it: its
`schedule_pod` eagerly on the CPU, on the reference encoding's device
state; the port gets the same encoding through `cluster_from_numpy`."""

import copy
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.models.encoding import ClusterEncoding
from kubernetes_tpu.models.pod_encoder import PodEncoder
from kubernetes_tpu.ops.kernel import schedule_pod as ref_schedule_pod
from kubernetes_tpu.ops.kernel import schedule_pods_jit as ref_schedule_pods
from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
from kubernetes_tpu_torch.ops import kernel as K

from .test_hoisted import _presized_encoding
from .test_kernel_parity import random_cluster, random_pending
from .util import anti_affinity, make_node, make_pod, pod_affinity
from .util import spread_constraint


def _pod_tensors(arrays):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()
            if not k.startswith("_")}


def _assert_same(ref, got, ctx):
    assert set(got) == set(ref), ctx
    for k in sorted(ref):
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, k, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), (ctx, k)


def _check(nodes, pods, pending, ctx):
    enc = ClusterEncoding()
    enc.set_cluster(nodes, pods)
    enc.device_state()
    pe = PodEncoder(enc)
    arrays = pe.encode(pending)
    cluster = enc.device_state()
    ref = ref_schedule_pod(cluster, arrays)
    got = K.schedule_pod(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                         _pod_tensors(arrays))
    _assert_same(ref, got, ctx)
    return got


def _zone_nodes(n, zones):
    return [make_node(f"n{i}", labels={"zone": f"z{i % zones}",
                                       v1.LABEL_HOSTNAME: f"n{i}"})
            for i in range(n)]


def _fit_and_ports():
    nodes = [make_node("n0", cpu="4", memory="8Gi", pods=10),
             make_node("n1", cpu="2", memory="8Gi", pods=10),
             make_node("n2", cpu="4", memory="8Gi", pods=1)]
    pods = [make_pod(node_name="n2"),
            make_pod(node_name="n0", cpu="1", host_port=8080)]
    return nodes, pods, [make_pod(cpu="3", host_port=8080)]


def _taints():
    nodes = [make_node("n0", taints=[v1.Taint("k1", "v1", "NoSchedule")]),
             make_node("n1", taints=[v1.Taint("k2", "v2",
                                              "PreferNoSchedule")]),
             make_node("n2", unschedulable=True),
             make_node("n3")]
    pending = make_pod(tolerations=[
        v1.Toleration(key="k1", operator="Equal", value="v1")])
    return nodes, [], [pending]


def _topology_spread():
    pods = [make_pod(node_name="n0", labels={"app": "x"}),
            make_pod(node_name="n0", labels={"app": "x"}),
            make_pod(node_name="n1", labels={"app": "x"}),
            make_pod(node_name="n3", labels={"app": "y"})]
    pending = make_pod(labels={"app": "x"}, constraints=[
        spread_constraint(1, "zone", "DoNotSchedule", {"app": "x"}),
        spread_constraint(2, v1.LABEL_HOSTNAME, "ScheduleAnyway",
                          {"app": "x"})])
    return _zone_nodes(6, 3), pods, [pending]


def _inter_pod_affinity():
    pods = [make_pod(node_name="n0", labels={"app": "db"}),
            make_pod(node_name="n1", labels={"app": "web"},
                     affinity=anti_affinity("zone", {"app": "web"}))]
    pending = [make_pod(labels={"app": "web"},
                        affinity=pod_affinity("zone", {"app": "db"})),
               make_pod(labels={"app": "web"})]
    return _zone_nodes(4, 2), pods, pending


# tests/test_kernel_parity.py's directed cases
DIRECTED = {"fit_and_ports": _fit_and_ports, "taints": _taints,
            "topology_spread": _topology_spread,
            "inter_pod_affinity": _inter_pod_affinity}


@pytest.mark.parametrize("case", sorted(DIRECTED))
def test_schedule_pod_directed_equals_reference(case):
    nodes, pods, pending = DIRECTED[case]()
    for i, p in enumerate(pending):
        _check(nodes, pods, p, f"{case}[{i}]")


@pytest.mark.parametrize("seed", range(12))
def test_schedule_pod_fuzz_equals_reference(seed):
    """test_kernel_parity.py's fuzz: a random cluster (taints, images,
    preferAvoidPods, extended resources, existing pods with terms and
    host ports, terminating pods) and three random pending pods."""
    rng = random.Random(seed)
    nodes, pods = random_cluster(rng)
    for trial in range(3):
        _check(nodes, pods, random_pending(rng), f"seed={seed} {trial}")


@pytest.mark.parametrize("seed", [0, 4, 7])
def test_schedule_pods_equals_reference(seed):
    """The batched form over several pending pods of one fuzz cluster,
    against the reference's vmapped schedule_pods_jit."""
    rng = random.Random(100 + seed)
    nodes, pods = random_cluster(rng)
    pending = [random_pending(rng) for _ in range(4)]
    for i, p in enumerate(pending):
        p.metadata.name = f"pending-{i}"
    enc, pe = _presized_encoding(nodes, pods, copy.deepcopy(pending))
    arrays = [{k: v for k, v in pe.encode(p).items()
               if not k.startswith("_")} for p in pending]
    P = {k: np.stack([np.asarray(a[k]) for a in arrays]) for k in arrays[0]}
    ref = ref_schedule_pods(enc.device_state(), P)
    got = K.schedule_pods(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                          {k: torch.from_numpy(v) for k, v in P.items()})
    _assert_same(ref, got, f"seed={seed}")
    assert got["feasible"].shape[0] == len(pending)


def test_log_table_equals_jnp_log():
    """The f64 PTS weight log(n + 2): the port's table equals the
    reference's jnp.log (XLA's CPU f64 log) bit for bit for n in
    [0, 200000], the widest node or pair axis a session here can reach
    and then some. (torch's vectorized f64 log on the CPU is one ulp
    off at a few of these arguments, which is why the port reads a
    table.)"""
    import jax.numpy as jnp

    n = 200000
    x = np.arange(n + 1, dtype=np.float64)
    ref = np.asarray(jnp.log(jnp.asarray(x) + 2.0))
    table = K.log_table(n, torch.device("cpu"))
    assert table.dtype == torch.float64 and table.shape == (n + 1,)
    assert np.array_equal(ref.view(np.int64), table.numpy().view(np.int64))
    got = K.log_plus_2(torch.from_numpy(x[::7].copy()), n)
    assert np.array_equal(got.numpy().view(np.int64),
                          ref[::7].view(np.int64))
