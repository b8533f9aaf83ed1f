"""The port's `schedule_batch` (kubernetes_tpu_torch/ops/batch.py, eager
torch) against the reference's (kubernetes_tpu/ops/batch.py, one jitted
`lax.scan` on the CPU), on tests/test_batch.py's shapes and on seeded
random clusters made with numpy.

The same encoding (the reference's ClusterEncoding: its device state for
the reference, its host snapshot through `cluster_from_numpy` for the
port) and the same encoded pods go through both. Decisions are identical,
and so is every `new_carry` array, in dtype and value (tolerance 0). The
port's decisions also equal its ScanSession's on the same pods (the scan
kernel's plain version on the CPU). `_pack_stacked` / `_unpack_stacked`
round-trip bit for bit, and a pod with affinity terms or host ports is
refused."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.models.encoding import ClusterEncoding
from kubernetes_tpu.models.pod_encoder import PodEncoder
from kubernetes_tpu.ops import batch as ref_batch
from kubernetes_tpu.testing.synth import (
    make_node,
    make_pod,
    synth_cluster,
    synth_pending_pods,
)
from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
from kubernetes_tpu_torch.ops import batch
from kubernetes_tpu_torch.ops.hoisted import template_fingerprint
from kubernetes_tpu_torch.ops.scan import ScanSession

from . import util

CPUS = ("100m", "250m", "500m", "1", "1500m")
MEMS = ("128Mi", "512Mi", "1Gi", "2Gi")


def _random_case(seed):
    """A seeded cluster (numpy draws): 4-14 nodes of varied size in three
    zones, 0-2 bound pods a node, 10-30 pending pods of one shape (zone
    spread or none) in four templates with drawn requests."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 15))
    nodes = [make_node(f"node-{i}", cpu=str(int(rng.integers(2, 9))),
                       memory=f"{int(rng.integers(4, 33))}Gi",
                       pods=int(rng.integers(4, 20)),
                       labels={v1.LABEL_HOSTNAME: f"node-{i}",
                               v1.LABEL_ZONE: f"zone-{i % 3}"})
             for i in range(n)]
    bound = []
    for i in range(n):
        for j in range(int(rng.integers(0, 3))):
            bound.append(make_pod(f"bound-{i}-{j}", node_name=f"node-{i}",
                                  cpu=CPUS[rng.integers(len(CPUS))],
                                  memory=MEMS[rng.integers(len(MEMS))],
                                  labels={"app": f"a{rng.integers(3)}"}))
    spread = bool(rng.integers(2))
    pending = synth_pending_pods(int(rng.integers(10, 31)), spread=spread)
    # requests drawn per template (synth stamps four, round-robin), so the
    # batch stays within the scan kernel's template count
    reqs = [(CPUS[rng.integers(len(CPUS))], MEMS[rng.integers(len(MEMS))])
            for _ in range(4)]
    for i, p in enumerate(pending):
        req = p.spec.containers[0].resources.requests
        req["cpu"], req["memory"] = reqs[i % 4]
    return nodes, bound, pending


CASES = {
    # tests/test_batch.py's three shapes
    "spread": lambda: (*synth_cluster(12, pods_per_node=1),
                       synth_pending_pods(17, spread=True)),
    "plain": lambda: (*synth_cluster(9, pods_per_node=2),
                      synth_pending_pods(13, cpu="500m", memory="2Gi")),
    "exhausts": lambda: (synth_cluster(2)[0], [],
                         synth_pending_pods(6, cpu="1500m", memory="1Gi")),
    **{f"seed{s}": (lambda s=s: _random_case(s)) for s in range(4)},
}


def _encoded(nodes, bound, pending):
    enc = ClusterEncoding()
    enc.set_cluster(nodes, bound)
    pe = PodEncoder(enc)
    for pod in pending:  # intern pass: grow vocabs before the rebuild
        pe.encode(pod)
    enc.device_state()
    arrays = [{k: v for k, v in pe.encode(p).items() if not k.startswith("_")}
              for p in pending]
    slots = [enc._pod_free[-1 - i] for i in range(len(pending))]
    return enc, arrays, slots


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_batch_matches_reference(case):
    enc, arrays, slots = _encoded(*CASES[case]())
    assert all(batch.pod_batchable(a) for a in arrays)
    ref_d, ref_carry = ref_batch.schedule_batch(enc.device_state(), arrays,
                                                slots)
    cluster = cluster_from_numpy(enc.host_snapshot(), "cpu")
    before = {k: cluster[k].clone() for k in batch.CARRY_KEYS}
    got_d, got_carry = batch.schedule_batch(cluster, arrays, slots)
    assert got_d == ref_d
    assert set(got_carry) == set(ref_carry) == set(batch.CARRY_KEYS)
    for k in batch.CARRY_KEYS:
        a, b = np.asarray(ref_carry[k]), got_carry[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
        # the cluster's own tensors are left as they were
        assert torch.equal(cluster[k], before[k]), k
    if case == "exhausts":
        assert -1 in got_d


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_batch_matches_scan_session(case):
    enc, arrays, slots = _encoded(*CASES[case]())
    cluster = cluster_from_numpy(enc.host_snapshot(), "cpu")
    templates, seen = [], set()
    for a in arrays:
        fp = template_fingerprint(a)
        if fp not in seen:
            seen.add(fp)
            templates.append(a)
    sess = ScanSession(cluster, templates, multipod_k=1, device="cpu")
    want = ScanSession.decisions(sess.schedule(arrays))
    got, _ = batch.schedule_batch(cluster, arrays, slots)
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_pack_round_trip(seed):
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 6))
    stacked = {
        "flag": rng.integers(0, 2, (b, 3)).astype(np.bool_),
        "small": rng.integers(-128, 128, (b,)).astype(np.int8),
        "mid": rng.integers(-2 ** 15, 2 ** 15, (b, 2, 2)).astype(np.int16),
        "word": rng.integers(-2 ** 31, 2 ** 31, (b, 4)).astype(np.int32),
        "wide": rng.integers(-2 ** 62, 2 ** 62, (b, 5)).astype(np.int64),
        "scalar": rng.integers(0, 9, (b,)).astype(np.int32),
    }
    packed, layout = batch._pack_stacked(stacked)
    ref_packed, ref_layout = ref_batch._pack_stacked(stacked)
    assert layout == ref_layout
    for g in ref_packed:
        assert packed[g].dtype == ref_packed[g].dtype
        assert np.array_equal(packed[g], ref_packed[g])
    out = batch._unpack_stacked(
        {g: torch.from_numpy(a) for g, a in packed.items()}, layout)
    assert set(out) == set(stacked)
    for k, a in stacked.items():
        got = out[k].numpy()
        assert got.dtype == a.dtype and got.shape == a.shape, k
        assert np.array_equal(got, a), k


@pytest.mark.parametrize("kind", ["anti-affinity", "host-port"])
def test_unbatchable_pod_refused(kind):
    nodes, _ = synth_cluster(4)
    aff = v1.Affinity(pod_anti_affinity=v1.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=[
            v1.PodAffinityTerm(
                label_selector=v1.LabelSelector(match_labels={"app": "x"}),
                topology_key=v1.LABEL_HOSTNAME)]))
    if kind == "anti-affinity":
        pending = [make_pod(n, labels={"app": "x"}, affinity=aff)
                   for n in "pq"]
    else:
        pending = [util.make_pod(n, host_port=8080) for n in "pq"]
    enc, arrays, slots = _encoded(nodes, [], pending)
    assert not batch.pod_batchable(arrays[0])
    cluster = cluster_from_numpy(enc.host_snapshot(), "cpu")
    with pytest.raises(AssertionError, match="pod_batchable"):
        batch.schedule_batch(cluster, arrays, slots)
    plain = make_pod("r", cpu="100m")
    assert batch.pod_batchable(PodEncoder(enc).encode(plain))
