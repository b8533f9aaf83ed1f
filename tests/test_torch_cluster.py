"""The cluster design of the port's scan kernel, on the CPU: the lane
partition `cluster_slices` (the Python mirror of the kernel's), the
`cluster` option of `scan_full` (CPU tensors go to the plain version
whatever it says, with and without the affinity-term carries, and count no
launch; sizes and variants the cluster kernel does not take raise), and
`ScanSession` leaving the choice to the wrapper's default. The kernel
itself runs only on the card, under chip_smoke.py (phases 4b, 5 and 6b
hold every cluster size to the plain version)."""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api import types as v1
from kubernetes_tpu_torch.models.encoding import ClusterEncoding
from kubernetes_tpu_torch.models.pod_encoder import PodEncoder
from kubernetes_tpu_torch.ops import scan as scan_mod
from kubernetes_tpu_torch.ops import scan_kernel as sk
from kubernetes_tpu_torch.ops.hoisted import template_fingerprint
from kubernetes_tpu_torch.ops.scan import LANE, ScanSession, batch_prologue
from kubernetes_tpu_torch.testing.synth import (
    make_pod,
    synth_cluster,
    synth_pending_pods,
)


@pytest.mark.parametrize("cb", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("Np", [8, 768, 5248, 5256])
def test_cluster_slices_partition(Np, cb):
    slices = sk.cluster_slices(Np, cb)
    assert len(slices) == cb
    # contiguous from 0 to Np: every lane in exactly one slice
    assert slices[0][0] == 0 and slices[-1][1] == Np
    for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
        assert lo <= hi == lo2
    covered = np.zeros(Np, np.int64)
    for lo, hi in slices:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # empty slices only at the tail
    sizes = [hi - lo for lo, hi in slices]
    first_empty = next((r for r, n in enumerate(sizes) if n == 0), cb)
    assert all(n > 0 for n in sizes[:first_empty])
    assert all(n == 0 for n in sizes[first_empty:])
    # the kernel's owner of lane n: rank n // S, thread (n - lo) % THREADS,
    # and that rank's slice holds the lane
    S = -(-Np // cb)
    for n in range(Np):
        lo, hi = slices[n // S]
        assert lo <= n < hi
        assert 0 <= (n - lo) % sk.THREADS < sk.THREADS


def _templates(arrays):
    templates, seen = [], set()
    for a in arrays:
        fp = template_fingerprint(a)
        if fp not in seen:
            seen.add(fp)
            templates.append(a)
    return templates


def _case(terms=False):
    """(session, pod arrays) on 12 nodes: zone-spread pods, or with
    `terms` pods carrying a hostname anti-affinity (the ur > 0 variant)."""
    nodes, init_pods = synth_cluster(12, pods_per_node=1)
    pending = synth_pending_pods(16, spread=True)
    if terms:
        term = v1.PodAffinityTerm(
            label_selector=v1.LabelSelector(match_labels={"app": "anti"}),
            topology_key=v1.LABEL_HOSTNAME)
        for p in pending[::2]:
            p.metadata.labels = {"app": "anti"}
            p.spec.affinity = v1.Affinity(pod_anti_affinity=v1.PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=[term]))
    enc = ClusterEncoding()
    enc.reserve(pods=2 * (len(init_pods) + len(pending)),
                anti_terms=len(pending), score_terms=len(pending))
    enc.set_cluster(nodes, init_pods)
    pe = PodEncoder(enc)
    arrays = [{k: v for k, v in pe.encode(p).items() if not k.startswith("_")}
              for p in pending]
    sess = ScanSession(enc.device_state("cpu"), _templates(arrays),
                       multipod_k=1, device="cpu")
    assert bool(sess.UR) == terms
    return sess, arrays


def _inputs(sess, arrays, mode="full"):
    Bp, tmpl, mfa, msa = batch_prologue(sess._fps, sess._tp_np, arrays,
                                        minimum=LANE,
                                        require_unbound=mode == "full")
    meta, match = sess._pack_batch(len(arrays), Bp, tmpl, mfa, msa)
    return torch.from_numpy(meta), torch.from_numpy(match)


def _weights(sess):
    return tuple(int(sess.weights[k]) for k in sk.WEIGHT_ORDER)


def _clone(carry):
    return {k: v.clone() for k, v in carry.items()}


@pytest.fixture(scope="module")
def spread_case():
    return _case()


@pytest.fixture(scope="module")
def terms_case():
    return _case(terms=True)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_cpu_tensors_take_the_plain_version(spread_case, cluster):
    sess, arrays = spread_case
    meta, match = _inputs(sess, arrays)
    carry0 = sess._initial_carry()
    statics, w = sess._get_statics(), _weights(sess)
    ref_carry = _clone(carry0)
    ref = sk.scan_full(meta, match, statics, ref_carry, sess.shapes, w)
    launches = (sk.LAUNCHES, dict(sk.VARIANT_LAUNCHES),
                dict(sk.CLUSTER_LAUNCHES))
    carry = _clone(carry0)
    out = sk.scan_full(meta, match, statics, carry, sess.shapes, w,
                       cluster=cluster)
    assert torch.equal(out, ref)
    assert set(carry) == set(ref_carry)
    assert all(torch.equal(carry[k], ref_carry[k]) for k in carry)
    assert (out[0, :len(arrays)] >= 0).any()
    assert launches == (sk.LAUNCHES, dict(sk.VARIANT_LAUNCHES),
                        dict(sk.CLUSTER_LAUNCHES))


@pytest.mark.parametrize("cluster", [0, 3, 32, True, 4.0])
def test_cluster_size_not_taken(spread_case, cluster):
    sess, arrays = spread_case
    meta, match = _inputs(sess, arrays)
    with pytest.raises(ValueError, match="cluster="):
        sk.scan_full(meta, match, sess._get_statics(),
                     sess._initial_carry(), sess.shapes, _weights(sess),
                     cluster=cluster)


@pytest.mark.parametrize("terms", [False, True], ids=["ur0", "ipa"])
@pytest.mark.parametrize("variant", ["eval", "mk4"])
def test_cluster_needs_full_mode_one_pod_per_step(spread_case, terms_case,
                                                  variant, terms):
    sess, arrays = terms_case if terms else spread_case
    mode = "eval" if variant == "eval" else "full"
    mk = 4 if variant == "mk4" else 1
    meta, match = _inputs(sess, arrays, mode)
    kw = dict(mode=mode, mk=mk)
    # the one-block kernel takes every variant; a cluster only full, mk=1
    sk.scan_full(meta, match, sess._get_statics(), sess._initial_carry(),
                 sess.shapes, _weights(sess), cluster=1, **kw)
    with pytest.raises(ValueError, match="cluster=4"):
        sk.scan_full(meta, match, sess._get_statics(),
                     sess._initial_carry(), sess.shapes, _weights(sess),
                     cluster=4, **kw)


@pytest.mark.parametrize("cluster", sk.CLUSTER_SIZES)
def test_cluster_needs_ur_zero(terms_case, cluster):
    """No longer so: with the affinity-term carries (ur > 0) every cluster
    size is taken, and CPU tensors go to the plain version: rows and all
    six carries equal cluster=1's, and no launch is counted."""
    sess, arrays = terms_case
    meta, match = _inputs(sess, arrays)
    carry0 = sess._initial_carry()
    statics, w = sess._get_statics(), _weights(sess)
    ref_carry = _clone(carry0)
    ref = sk.scan_full(meta, match, statics, ref_carry, sess.shapes, w,
                       cluster=1)
    launches = (sk.LAUNCHES, dict(sk.VARIANT_LAUNCHES),
                dict(sk.CLUSTER_LAUNCHES))
    carry = _clone(carry0)
    out = sk.scan_full(meta, match, statics, carry, sess.shapes, w,
                       cluster=cluster)
    assert torch.equal(out, ref)
    assert set(carry) == set(ref_carry) == set(sess.carry_keys)
    assert {"ucnt", "kcnt"} <= set(carry)
    assert all(torch.equal(carry[k], ref_carry[k]) for k in carry)
    # the batch committed assumed-pod term counts
    assert int(carry["kcnt"].sum()) > 0
    assert launches == (sk.LAUNCHES, dict(sk.VARIANT_LAUNCHES),
                        dict(sk.CLUSTER_LAUNCHES))


def test_default_cluster_size():
    assert sk.CLUSTER in sk.CLUSTER_SIZES
    for ur in (0, 16):
        assert sk._cluster_size(None, ur, sk.MODE_FULL) == sk.CLUSTER
    for ur in (0, 16):
        for kmode in (sk.MODE_MULTI, sk.MODE_EVAL, sk.MODE_APPLY):
            assert sk._cluster_size(None, ur, kmode) == 1


def test_session_passes_no_cluster(monkeypatch):
    sess, arrays = _case()
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return sk.scan_full(*args, **kwargs)

    monkeypatch.setattr(scan_mod, "scan_full", spy)
    ys = sess.schedule(arrays)
    assert len(calls) == 1 and "cluster" not in calls[0]
    assert all(d >= 0 for d in ScanSession.decisions(ys))
