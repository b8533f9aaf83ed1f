"""ScanSession (the port's batched scheduling session and its scan_full
kernel, run here through the kernel's plain PyTorch version on the CPU)
against the reference: numpy statics (and, for affinity-term templates,
the IPA arrays of _build_ipa) equal PallasSession's, out rows [:3, :n]
and every carry after every batch equal PallasSession in interpret mode
exactly, and decisions equal HoistedSession — on the session shapes of
tests/test_pallas_scan.py (TestPallasParity and TestPallasTerms) and on
fuzzed clusters, with and without the pending pods' affinity terms."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.hoisted import HoistedSession
from kubernetes_tpu.ops.pallas_scan import PallasSession, PallasUnsupported
from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
from kubernetes_tpu_torch.ops import scan_kernel
from kubernetes_tpu_torch.ops.scan import (
    CARRY_KEYS,
    IPA_CARRY_KEYS,
    ScanSession,
    SessionUnsupported,
)

from .test_hoisted import _encode_all, _presized_encoding
from .test_torch_prologue import CASES, build_case
from .util import make_pod

STATICS = ("_alloc", "_stat", "_requested0", "_nzpc0", "_cnt_fn0",
           "_cnt_sn0", "_prow_f", "_prow_s", "_regrow_f", "_konn_f",
           "_konn_s", "_zvalid_node_s", "_zvalid_s", "_shasall", "_valid_n",
           "_gmat", "_scalars")


def _port_session(enc, templates, **kw):
    return ScanSession(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                       templates, device="cpu", **kw)


def _assert_ipa_equal(ref, got):
    """Two dicts of arrays and scalars (the sessions' `_ipa` or
    `_term_np`) are equal key for key, in dtype, shape and value."""
    assert set(got) == set(ref)
    for k in sorted(ref):
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        if a.ndim == 0:
            assert int(a) == int(b), k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("case", CASES)
def test_scan_session_equals_pallas_and_hoisted(case):
    enc, arrays, templates, batch = build_case(case)
    hs = HoistedSession(enc.device_state(), templates)
    ps = PallasSession(enc.device_state(), templates, interpret=True,
                       multipod_k=1)
    ss = _port_session(enc, templates)
    assert ss.dyn_ipa == ps.dyn_ipa
    if ps.dyn_ipa:
        _assert_ipa_equal(ps._ipa, ss._ipa)
        _assert_ipa_equal(ps._term_np, ss._term_np)
        assert ss.UR == ps._ipa["UR"]
        assert ss.carry_keys == CARRY_KEYS + IPA_CARRY_KEYS
    else:
        assert ss._ipa is None and ss.UR == 0
        assert ss.carry_keys == CARRY_KEYS
    for k in STATICS:
        a, b = getattr(ps, k), getattr(ss, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    launches = scan_kernel.LAUNCHES
    variants = dict(scan_kernel.VARIANT_LAUNCHES)
    got, ref = [], []
    for lo in range(0, len(arrays), batch):
        b = arrays[lo:lo + batch]
        n = len(b)
        yp, ys = ps.schedule(b), ss.schedule(b)
        rp, rs = np.asarray(yp["rows"]), ys["rows"].numpy()
        assert np.array_equal(rp[:3, :n], rs[:3, :n]), (lo, rp[:3, :n],
                                                         rs[:3, :n])
        assert set(ps._carry) == set(ss._carry) == set(ss.carry_keys)
        for k in ss.carry_keys:
            assert np.array_equal(np.asarray(ps._carry[k]),
                                  ss._carry[k].numpy()), (lo, k)
        got.extend(ScanSession.decisions(ys))
        ref.extend(HoistedSession.decisions(hs.schedule(b))[:n])
    assert got == ref
    # the CPU path runs the plain version: no kernel launch is counted
    assert scan_kernel.LAUNCHES == launches
    assert scan_kernel.VARIANT_LAUNCHES == variants


def _unsupported_case(kind):
    from kubernetes_tpu.api import types as v1
    from kubernetes_tpu.testing.synth import synth_cluster, synth_pending_pods

    nodes, init_pods = synth_cluster(4, pods_per_node=1)
    pending = synth_pending_pods(4, spread=True)
    n_templates = 1
    kw = {}
    if kind == "host-ports":
        pending = [make_pod(f"hp-{i}", cpu="10m", host_port=8080)
                   for i in range(2)]
    elif kind == "weights-exceed-f32":
        kw = {"weights": {"balanced": 1, "image": 1, "ipa": 1, "least": 1,
                          "node_affinity": 1, "prefer_avoid": 10 ** 6,
                          "pts": 2, "taint": 1}}
    elif kind == "ipa-score-weights":
        # coprime preferred weights toward the pod's own label: the
        # GCD-scaled D4+D5 weight sum 2 * (97 + 89 + 83) exceeds 255
        terms = [v1.WeightedPodAffinityTerm(
            weight=w, pod_affinity_term=v1.PodAffinityTerm(
                label_selector=v1.LabelSelector(match_labels={"app": "w"}),
                topology_key=key))
            for w, key in ((97, v1.LABEL_ZONE), (89, v1.LABEL_HOSTNAME),
                           (83, v1.LABEL_REGION))]
        pending = [make_pod(f"w-{i}", labels={"app": "w"},
                            affinity=v1.Affinity(pod_affinity=v1.PodAffinity(
                                preferred_during_scheduling_ignored_during_execution=terms)))
                   for i in range(2)]
    elif kind == "too-many-ipa-keys":
        # nine templates, each anti-affine on its own topology key
        pending = [make_pod(f"k-{i}", labels={"app": "k"},
                            affinity=v1.Affinity(
                                pod_anti_affinity=v1.PodAntiAffinity(
                                    required_during_scheduling_ignored_during_execution=[
                                        v1.PodAffinityTerm(
                                            label_selector=v1.LabelSelector(
                                                match_labels={"app": "k"}),
                                            topology_key=f"example.com/key-{i}")])))
                   for i in range(9)]
        n_templates = 9
    elif kind == "multipod":
        kw = {"multipod_k": 4}
    enc, pe = _presized_encoding(nodes, init_pods, pending)
    return enc, _encode_all(enc, pe, pending)[:n_templates], kw


@pytest.mark.parametrize("kind", ["host-ports", "weights-exceed-f32",
                                  "ipa-score-weights", "too-many-ipa-keys"])
def test_unsupported_shape_reason_matches_pallas(kind):
    enc, templates, kw = _unsupported_case(kind)
    with pytest.raises(PallasUnsupported) as ref:
        PallasSession(enc.device_state(), templates, interpret=True, **kw)
    with pytest.raises(SessionUnsupported) as got:
        _port_session(enc, templates, **kw)
    assert got.value.reason == ref.value.reason == kind


@pytest.mark.parametrize("kind", ["multipod"])
def test_later_slice_shapes_raise(kind):
    """The shapes an earlier slice refused as later work no longer raise:
    a multi-pod session builds with the step width asked for, its batch
    carries the conflict-suffix row, and the slug is gone from
    SessionUnsupported's reasons."""
    enc, templates, kw = _unsupported_case(kind)
    ss = _port_session(enc, templates, **kw)
    assert ss.multipod_k == kw["multipod_k"]
    ys = ss.schedule(templates)
    assert ys["mk"] == ss.multipod_k
    assert ScanSession.conflict_stats(ys) == (0, None)
    assert int(ys["rows"][3, 0]) == 0
    assert f"`{kind}`" not in SessionUnsupported.__doc__


def test_term_templates_build_session():
    """An affinity-term template builds a session on the kernel's IPA
    branch: UR = 8 T count rows, zero assumed-pod carries, and the IPA
    statics the ur > 0 kernel variant takes."""
    from kubernetes_tpu.api import types as v1

    from kubernetes_tpu.testing.synth import synth_cluster

    nodes, init_pods = synth_cluster(4, pods_per_node=1)
    term = v1.PodAffinityTerm(
        label_selector=v1.LabelSelector(match_labels={"app": "a"}),
        topology_key=v1.LABEL_HOSTNAME)
    pending = [make_pod(f"aa-{i}", labels={"app": "a"},
                        affinity=v1.Affinity(
                            pod_anti_affinity=v1.PodAntiAffinity(
                                required_during_scheduling_ignored_during_execution=[term])))
               for i in range(2)]
    enc, pe = _presized_encoding(nodes, init_pods, pending)
    ss = _port_session(enc, _encode_all(enc, pe, pending)[:1])
    assert ss.dyn_ipa and ss.UR == 8 * ss.T
    carry = ss._initial_carry()
    assert set(carry) == set(CARRY_KEYS + IPA_CARRY_KEYS)
    assert carry["ucnt"].shape == (ss.UR, ss.Np)
    assert carry["kcnt"].shape == (ss.UR, 128)
    assert not carry["ucnt"].any() and not carry["kcnt"].any()
    assert set(scan_kernel.IPA_STATIC_KEYS) <= set(ss._get_statics())
    ys = ss.schedule(_encode_all(enc, pe, pending))
    assert ScanSession.decisions(ys)[0] >= 0


def test_scan_full_rejects_bad_inputs():
    enc, arrays, templates, batch = build_case("no_constraints")
    ss = _port_session(enc, templates)
    ys = ss.schedule(arrays[:batch])
    assert ys["rows"].dtype == torch.int32
    bad = {k: v.to(torch.int64) for k, v in ss._get_statics().items()}
    meta = torch.zeros(1 + 128, dtype=torch.int32)
    match = torch.zeros((128, 256), dtype=torch.int8)
    with pytest.raises(ValueError):
        scan_kernel.scan_full(meta, match, bad, ss._carry, ss.shapes,
                              (1,) * 8)


def test_log_weights_against_reference():
    """The PTS score weight table equals the reference's f32 log(x + 2)
    (jnp.log on the CPU) bit for bit over [0, 65536)."""
    import jax.numpy as jnp

    x = np.arange(65536, dtype=np.float32)
    ref = np.asarray(jnp.log(jnp.asarray(x) + np.float32(2.0)))
    got = scan_kernel.log_weights(65536)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))
