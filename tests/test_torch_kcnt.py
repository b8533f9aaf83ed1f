"""The directed `kcnt` cases (the affinity-term carry that every lane of
the scan reads, not only its owner's) on the CPU: the reference's plain
path (PallasSession in interpret mode) and the port's plain version
(ScanSession on CPU tensors) on the same inputs must give the same
decisions, out rows and carries, `ucnt` and `kcnt` included.

Pods that require (or, in the twin, prefer) a zone affinity toward their
own label, with no bound pod carrying it, on nodes whose zones interleave
over the node lanes (zone = node mod 4), bound pods of another label on
nodes drawn from a seed. The first pod escapes through the empty-counts
rule (or, preferred, finds no affine pod anywhere); every later pod must
land in the first pod's zone, which `kcnt` alone tells it. On the card,
chip_smoke.py runs the same shape at every cluster size, where a block
that read a stale `kcnt` would let a pod into another zone."""

import numpy as np
import pytest

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.ops.pallas_scan import PallasSession
from kubernetes_tpu.testing.synth import synth_cluster
from kubernetes_tpu_torch.ops.scan import ScanSession

from .test_hoisted import _encode_all, _presized_encoding
from .test_torch_scan import _port_session
from .util import make_pod

ZONES = 4


def _kcnt_case(kind, n_nodes=24, n_pods=20, seed=0):
    """(encoding, pod arrays, templates, zone of each node lane)."""
    nodes, _ = synth_cluster(n_nodes, n_zones=ZONES)
    rng = np.random.default_rng(seed)
    init_pods = [make_pod(f"other-{i}", cpu="500m", memory="1Gi",
                          labels={"app": "other"},
                          node_name=nodes[int(j)].metadata.name)
                 for i, j in enumerate(rng.integers(0, n_nodes, n_nodes))]
    labels = {"app": "kz"}
    term = v1.PodAffinityTerm(
        label_selector=v1.LabelSelector(match_labels=dict(labels)),
        topology_key=v1.LABEL_ZONE)
    if kind == "required":
        aff = v1.PodAffinity(
            required_during_scheduling_ignored_during_execution=[term])
    else:
        aff = v1.PodAffinity(
            preferred_during_scheduling_ignored_during_execution=[
                v1.WeightedPodAffinityTerm(weight=100,
                                           pod_affinity_term=term)])
    pending = [make_pod(f"kz-{i}", cpu="100m", memory="128Mi", labels=labels,
                        affinity=v1.Affinity(pod_affinity=aff))
               for i in range(n_pods)]
    enc, pe = _presized_encoding(nodes, init_pods, pending)
    arrays = _encode_all(enc, pe, pending)
    zone = {n.metadata.name: n.metadata.labels[v1.LABEL_ZONE] for n in nodes}
    lane_zone = [zone.get(name) for name in enc.node_names]
    return enc, arrays, arrays[:1], lane_zone


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["required", "preferred"])
def test_kcnt_directed_case(kind, seed):
    enc, arrays, templates, lane_zone = _kcnt_case(kind, seed=seed)
    ps = PallasSession(enc.device_state(), templates, interpret=True,
                       multipod_k=1)
    ss = _port_session(enc, templates)
    assert ss.UR and {"ucnt", "kcnt"} <= set(ss.carry_keys)
    n = len(arrays)
    yp, ys = ps.schedule(arrays), ss.schedule(arrays)
    rp, rs = np.asarray(yp["rows"]), ys["rows"].numpy()
    assert np.array_equal(rp[:3, :n], rs[:3, :n])
    for k in ss.carry_keys:
        assert np.array_equal(np.asarray(ps._carry[k]),
                              ss._carry[k].numpy()), k
    decisions = ScanSession.decisions(ys)
    assert all(d >= 0 for d in decisions)
    # the case discriminates: the zone of every later pod is the first's,
    # and the zones the first pod could have taken span all four
    zones = [lane_zone[d] for d in decisions]
    assert zones[1:] == [zones[0]] * (n - 1)
    assert len(set(lane_zone[:ZONES])) == ZONES
    # one assumed pod per placement in every row of the zone key's counts
    kcnt = ss._carry["kcnt"].numpy()
    assert (kcnt == kcnt[:, :1]).all() and kcnt.max() == n
