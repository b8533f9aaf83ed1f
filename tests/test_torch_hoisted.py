"""The port's HoistedSession (ops/hoisted.py in torch) against the
reference's, on the CPU: the same encoding and templates, batch after
batch; decisions, scores, n_feasible and every carry (dtype, shape and
value) after every batch must be equal, exactly.

Cases: tests/test_hoisted.py's TestHoistedSession and TestHoistedParity
shapes, tests/test_hoisted_terms.py's anti-affinity, affinity, preferred
and host-port shapes, and test_torch_prologue.py's affinity-term
sessions; then the one-shot `schedule_batch_hoisted`, explain payloads
(test_explain.py's fuzz seeds, and term / host-port sessions), explicit
multi-pod steps, and cluster churn absorbed by `apply_deltas` (a
delta-patched session decides as a fresh one from the mutated encoding,
and its carry equals the reference's patched carry). The reference runs
as its own tests run it: jitted on the CPU, x64 on."""

import copy
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.models.encoding import ClusterEncoding as RefEncoding
from kubernetes_tpu.models.pod_encoder import PodEncoder as RefPodEncoder
from kubernetes_tpu.ops.hoisted import HoistedSession as RefSession
from kubernetes_tpu.ops.hoisted import schedule_batch_hoisted as ref_one_shot
from kubernetes_tpu.ops.hoisted import template_fingerprint
from kubernetes_tpu.testing.synth import synth_cluster, synth_pending_pods
from kubernetes_tpu_torch.models.encoding import ClusterEncoding
from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
from kubernetes_tpu_torch.models.pod_encoder import PodEncoder
from kubernetes_tpu_torch.ops import hoisted
from kubernetes_tpu_torch.ops.hoisted import HoistedSession
from kubernetes_tpu_torch.ops.scan import ScanSession

from . import test_hoisted_terms as terms_tests
from . import test_torch_deltas as delta_tests
from .test_hoisted import _encode_all, _presized_encoding
from .test_kernel_parity import random_cluster, random_pending
from .test_torch_encoding import _port_obj
from .test_torch_prologue import SHAPES as PROLOGUE_SHAPES
from .util import make_pod

_anti = terms_tests._anti_affinity
_aff = terms_tests._affinity
_pref = terms_tests._preferred_affinity


def _templates_of(arrays):
    templates, seen = [], set()
    for a in arrays:
        fp = template_fingerprint(a)
        if fp not in seen:
            seen.add(fp)
            templates.append(a)
    return templates


# ---------------------------------------------------------------------------
# the cases: name -> () -> (nodes, init_pods, pending, batch)


def _capacity(n, cpu, pending, batch):
    nodes, init_pods = synth_cluster(n, pods_per_node=0)
    for node in nodes:
        node.status.allocatable["cpu"] = cpu
        node.status.capacity["cpu"] = cpu
    return nodes, init_pods, pending, batch


def _hostname_anti():
    nodes, init_pods = synth_cluster(6, pods_per_node=1)
    pending = [make_pod(f"aa-{i}", cpu="50m", labels={"app": "churn"},
                        affinity=_anti(v1.LABEL_HOSTNAME, {"app": "churn"}))
               for i in range(9)]
    return nodes, init_pods, pending, 4


def _zone_anti():
    nodes, init_pods = synth_cluster(9, pods_per_node=1)
    pending = [make_pod(f"za-{i}", cpu="50m", labels={"app": "zonal"},
                        affinity=_anti(v1.LABEL_ZONE, {"app": "zonal"}))
               for i in range(5)]
    return nodes, init_pods, pending, 2


def _cross_template_anti():
    nodes, init_pods = synth_cluster(4, pods_per_node=1)
    b = [make_pod(f"b-{i}", cpu="50m", labels={"role": "db"})
         for i in range(2)]
    a = [make_pod(f"a-{i}", cpu="50m", labels={"role": "web"},
                  affinity=_anti(v1.LABEL_HOSTNAME, {"role": "db"}))
         for i in range(4)]
    return nodes, init_pods, [b[0], a[0], b[1], a[1], a[2], a[3]], 3


def _existing_anti():
    nodes, init_pods = synth_cluster(4, pods_per_node=0)
    guard = make_pod("guard", cpu="50m", labels={"role": "guard"},
                     affinity=_anti(v1.LABEL_HOSTNAME, {"app": "w"}),
                     node_name=nodes[0].metadata.name)
    pending = [make_pod(f"w-{i}", cpu="50m", labels={"app": "w"})
               for i in range(5)]
    return nodes, init_pods + [guard], pending, 2


def _required_affinity():
    nodes, init_pods = synth_cluster(9, pods_per_node=1)
    seed = make_pod("seed", cpu="50m", labels={"app": "group"},
                    node_name=nodes[4].metadata.name)
    pending = [make_pod(f"g-{i}", cpu="50m", labels={"app": "member"},
                        affinity=_aff(v1.LABEL_ZONE, {"app": "group"}))
               for i in range(4)]
    return nodes, init_pods + [seed], pending, 2


def _self_affinity():
    nodes, init_pods = synth_cluster(9, pods_per_node=1)
    pending = [make_pod(f"s-{i}", cpu="50m", labels={"app": "flock"},
                        affinity=_aff(v1.LABEL_ZONE, {"app": "flock"}))
               for i in range(5)]
    return nodes, init_pods, pending, 2


def _affinity_unsatisfied():
    nodes, init_pods = synth_cluster(4, pods_per_node=1)
    pending = [make_pod(f"u-{i}", cpu="50m", labels={"app": "orphan"},
                        affinity=_aff(v1.LABEL_ZONE,
                                      {"app": "nothing-has-this"}))
               for i in range(3)]
    return nodes, init_pods, pending, 2


def _preferred(anti):
    nodes, init_pods = synth_cluster(9 if not anti else 6, pods_per_node=1)
    key = v1.LABEL_HOSTNAME if anti else v1.LABEL_ZONE
    pending = [make_pod(f"p-{i}", cpu="50m", labels={"app": "herd"},
                        affinity=_pref(key, {"app": "herd"}, 50, anti=anti))
               for i in range(6)]
    return nodes, init_pods, pending, 3 if anti else 2


def _mixed_preferred_required():
    nodes, init_pods = synth_cluster(6, pods_per_node=1)
    aff = v1.Affinity(pod_anti_affinity=v1.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=[
            v1.PodAffinityTerm(
                label_selector=v1.LabelSelector(match_labels={"kind": "a"}),
                topology_key=v1.LABEL_HOSTNAME)],
        preferred_during_scheduling_ignored_during_execution=[
            v1.WeightedPodAffinityTerm(
                weight=25, pod_affinity_term=v1.PodAffinityTerm(
                    label_selector=v1.LabelSelector(
                        match_labels={"kind": "b"}),
                    topology_key=v1.LABEL_ZONE))]))
    a = [make_pod(f"ma-{i}", cpu="50m", labels={"kind": "a"}, affinity=aff)
         for i in range(3)]
    b = [make_pod(f"mb-{i}", cpu="50m", labels={"kind": "b"})
         for i in range(3)]
    return nodes, init_pods, [b[0], a[0], b[1], a[1], b[2], a[2]], 3


def _host_port_one_per_node():
    nodes, init_pods = synth_cluster(4, pods_per_node=1)
    pending = [make_pod(f"hp-{i}", cpu="50m", host_port=8080)
               for i in range(6)]
    return nodes, init_pods, pending, 3


def _host_port_against_existing():
    nodes, init_pods = synth_cluster(3, pods_per_node=0)
    holder = make_pod("holder", cpu="50m", host_port=9000,
                      node_name=nodes[1].metadata.name)
    pending = [make_pod(f"hx-{i}", cpu="50m", host_port=9000)
               for i in range(3)]
    return nodes, init_pods + [holder], pending, 2


def _ports_and_spread():
    nodes, init_pods = synth_cluster(6, pods_per_node=1)
    pending = [make_pod(
        f"ps-{i}", cpu="50m", labels={"app": "ps"}, host_port=7070,
        constraints=[v1.TopologySpreadConstraint(
            max_skew=1, topology_key=v1.LABEL_ZONE,
            when_unsatisfiable="ScheduleAnyway",
            label_selector=v1.LabelSelector(match_labels={"app": "ps"}))])
        for i in range(6)]
    return nodes, init_pods, pending, 3


def _ports_mixed():
    """A quarter of the pods carry a hostPort (chip_smoke.py phase 11c's
    shape, small): port and plain spread templates in one session."""
    nodes, init_pods = synth_cluster(5, pods_per_node=1)
    pending = synth_pending_pods(16, spread=True)
    for i, p in enumerate(pending):
        if i % 4 == 0:
            p.spec.containers[0].ports = [v1.ContainerPort(
                container_port=8080, host_port=8080, protocol="TCP")]
    return nodes, init_pods, pending, 6


def _prologue_shape(name):
    def build():
        builder, batch = PROLOGUE_SHAPES[name]
        return builder() + (batch,)
    return build


CASES = {
    # tests/test_hoisted.py TestHoistedSession and TestHoistedParity
    "spread_multi_batch": lambda: synth_cluster(16, pods_per_node=2) + (
        synth_pending_pods(36, spread=True), 12),
    "capacity_exhaustion": lambda: _capacity(
        3, "350m", synth_pending_pods(15, spread=True), 5),
    "no_constraints": lambda: synth_cluster(10, pods_per_node=1) + (
        synth_pending_pods(16, spread=False), 8),
    "capacity_pressure_infeasible_tail": lambda: _capacity(
        3, "250m", synth_pending_pods(12, spread=True), 12),
    "hostname_hard_spread": _prologue_shape("hostname_hard_spread"),
    "mixed_templates_cross_counting": _prologue_shape(
        "mixed_templates_cross_counting"),
    # tests/test_hoisted_terms.py
    "hostname_anti": _hostname_anti,
    "zone_anti": _zone_anti,
    "cross_template_anti": _cross_template_anti,
    "existing_anti": _existing_anti,
    "required_affinity": _required_affinity,
    "self_affinity_escape": _self_affinity,
    "affinity_unsatisfied": _affinity_unsatisfied,
    "preferred_affinity": lambda: _preferred(False),
    "preferred_anti": lambda: _preferred(True),
    "mixed_preferred_required": _mixed_preferred_required,
    "host_port_one_per_node": _host_port_one_per_node,
    "host_port_against_existing": _host_port_against_existing,
    "ports_and_spread": _ports_and_spread,
    "ports_mixed": _ports_mixed,
    # test_torch_prologue.py's affinity-term sessions
    "terms_weight100_preferred": _prologue_shape("terms_weight100_preferred"),
    "terms_preferred_score": _prologue_shape("terms_preferred_score"),
    "terms_survive_batches": _prologue_shape("terms_survive_batches"),
}


def _build(name):
    """(reference encoding, pending arrays, templates, batch)."""
    nodes, init_pods, pending, batch = CASES[name]()
    enc, pe = _presized_encoding(copy.deepcopy(nodes),
                                 copy.deepcopy(init_pods),
                                 copy.deepcopy(pending))
    arrays = _encode_all(enc, pe, pending)
    return enc, arrays, _templates_of(arrays), batch


def _sessions(enc, templates, **kw):
    ref = RefSession(enc.device_state(), templates, **kw)
    port = HoistedSession(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                          templates, device="cpu", **kw)
    return ref, port


def _assert_carries(ref, port, ctx):
    assert set(port._carry) == set(ref._carry), ctx
    for k, v in ref._carry.items():
        a, b = np.asarray(v), port._carry[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, k, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), (ctx, k)


def _assert_ys(ys_ref, ys_port, keys, ctx):
    b = ys_port["_b_real"]
    assert ys_ref["_b_real"] == b, ctx
    for k in keys:
        a, g = np.asarray(ys_ref[k])[:b], ys_port[k].numpy()
        assert a.dtype == g.dtype and a.shape == g.shape, (ctx, k, a.dtype,
                                                           g.dtype)
        assert np.array_equal(a, g), (ctx, k)


def _run_batches(ref, port, arrays, batch, ctx, keys=("best", "score",
                                                      "n_feasible")):
    decisions = []
    for lo in range(0, len(arrays), batch):
        chunk = arrays[lo:lo + batch]
        ys_ref, ys_port = ref.schedule(chunk), port.schedule(chunk)
        got = HoistedSession.decisions(ys_port)
        assert got == RefSession.decisions(ys_ref), (ctx, lo)
        _assert_ys(ys_ref, ys_port, keys, (ctx, lo))
        _assert_carries(ref, port, (ctx, lo))
        decisions += got
    return decisions


@pytest.mark.parametrize("case", sorted(CASES))
def test_session_equals_reference(case):
    enc, arrays, templates, batch = _build(case)
    ref, port = _sessions(enc, templates)
    assert (port.dyn_ipa, port._dyn_ports) == (ref.dyn_ipa, ref._dyn_ports)
    assert port.multipod_k == 1 and port.supports_explain
    decisions = _run_batches(ref, port, arrays, batch, case)
    assert any(d >= 0 for d in decisions) or case == "affinity_unsatisfied"
    if port._dyn_ports:
        # no two placed pods that want a host port share a node
        taken = [d for d, a in zip(decisions, arrays)
                 if d >= 0 and np.asarray(a["want_valid"]).any()]
        assert len(taken) == len(set(taken))


@pytest.mark.parametrize("case", ["spread_multi_batch", "hostname_anti",
                                  "mixed_preferred_required",
                                  "ports_and_spread"])
def test_schedule_batch_hoisted_equals_reference(case):
    """The one-shot path: prologue, match matrices and scan in one call."""
    enc, arrays, _, _ = _build(case)
    want, ys_ref = ref_one_shot(enc.device_state(), arrays)
    got, ys = hoisted.schedule_batch_hoisted(
        cluster_from_numpy(enc.host_snapshot(), "cpu"), arrays)
    assert got == want
    ys["_b_real"] = ys_ref["_b_real"] = len(arrays)
    _assert_ys(ys_ref, ys, ("best", "score", "n_feasible"), case)


def _assert_payloads(ref_ys, port_ys, decisions, ctx):
    want = RefSession.explain_payload(ref_ys)
    got = HoistedSession.explain_payload(port_ys)
    assert got is not None and len(got) == len(want), ctx
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), ctx
        for k in w:
            assert g[k].dtype == np.asarray(w[k]).dtype, (ctx, i, k)
            assert np.array_equal(g[k], np.asarray(w[k])), (ctx, i, k)
        if decisions[i] >= 0:
            assert int(g["topk_idx"][0]) == decisions[i], (ctx, i)
            assert int(g["topk_scores"][0].sum()) == int(g["topk_total"][0])


@pytest.mark.parametrize("seed", [0, 3])
def test_explain_payload_equals_reference(seed):
    """test_explain.py::test_session_explain_payload_matches_oracle's
    fuzz: random clusters and pending pods, explain_k=3; the port's
    payload equals the reference's, and each placed pod's first candidate
    is its decision."""
    rng = random.Random(seed + 40)
    nodes, pods = random_cluster(rng)
    for trial in range(2):
        enc = RefEncoding()
        enc.reserve(pods=256)
        enc.set_cluster(nodes, pods)
        pe = RefPodEncoder(enc)
        enc.device_state()
        pending = random_pending(rng)
        arrays = {k: val for k, val in pe.encode(pending).items()
                  if not k.startswith("_")}
        ref, port = _sessions(enc, [arrays], explain_k=3)
        assert port.explain_k == 3 and port.multipod_k == 1
        ys_ref, ys = ref.schedule([arrays]), port.schedule([arrays])
        decisions = HoistedSession.decisions(ys)
        assert decisions == RefSession.decisions(ys_ref)
        _assert_payloads(ys_ref, ys, decisions, (seed, trial))


@pytest.mark.parametrize("case", ["cross_template_anti", "ports_and_spread",
                                  "spread_multi_batch"])
def test_explain_session_equals_reference(case):
    """Explain over whole sessions: term, host-port and spread templates,
    batch after batch (explain keeps intermediates, decisions unchanged)."""
    enc, arrays, templates, batch = _build(case)
    ref, port = _sessions(enc, templates, explain_k=4)
    plain = HoistedSession(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                           templates, device="cpu")
    for lo in range(0, len(arrays), batch):
        chunk = arrays[lo:lo + batch]
        ys_ref, ys = ref.schedule(chunk), port.schedule(chunk)
        decisions = HoistedSession.decisions(ys)
        assert decisions == RefSession.decisions(ys_ref)
        assert decisions == HoistedSession.decisions(plain.schedule(chunk))
        _assert_payloads(ys_ref, ys, decisions, (case, lo))
        _assert_carries(ref, port, (case, lo))
    assert HoistedSession.explain_payload(plain.schedule(arrays[:1])) is None


@pytest.mark.parametrize("mk", [2, 4])
@pytest.mark.parametrize("case", ["spread_multi_batch", "zone_anti",
                                  "mixed_templates_cross_counting",
                                  "terms_weight100_preferred"])
def test_multipod_equals_reference(case, mk):
    """An explicit multipod_k: the k-wide step with exact replay decides
    as the reference's (and as one pod per step), with equal carries and
    conflict counts."""
    enc, arrays, templates, batch = _build(case)
    ref, port = _sessions(enc, templates, multipod_k=mk)
    assert port.multipod_k == ref.multipod_k == mk
    one = HoistedSession(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                         templates, multipod_k=1, device="cpu")
    for lo in range(0, len(arrays), batch):
        chunk = arrays[lo:lo + batch]
        ys_ref, ys = ref.schedule(chunk), port.schedule(chunk)
        decisions = HoistedSession.decisions(ys)
        assert decisions == RefSession.decisions(ys_ref)
        assert decisions == HoistedSession.decisions(one.schedule(chunk))
        assert (HoistedSession.conflict_stats(ys)
                == RefSession.conflict_stats(ys_ref))
        _assert_ys(ys_ref, ys, ("score", "n_feasible"), (case, lo))
        _assert_carries(ref, port, (case, lo))


# ---------------------------------------------------------------------------
# cluster churn: tests/test_session_deltas.py's contract, on sessions


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("after_batch", [False, True])
def test_random_churn_equals_fresh_session(seed, after_batch):
    """test_torch_deltas.py's seeded churn (foreign pods bound, some
    terminating; evictions; allocatable bumps), classified on each
    package's encoding against its own live hoisted session; the patched
    carries equal the reference's, and the next batch decides as a fresh
    session from the mutated encoding and as the reference does. With
    after_batch, a first batch is scheduled and bound into both
    encodings before the churn."""
    nodes, bound, pending, foreign = delta_tests._churn_cluster()
    ref_enc, arrays = delta_tests._presize(
        RefEncoding, RefPodEncoder, nodes, bound, pending, foreign,
        to_port=False)
    enc, port_arrays = delta_tests._presize(
        ClusterEncoding, PodEncoder, nodes, bound, pending, foreign,
        to_port=True)
    templates = _templates_of(arrays)
    ref = RefSession(ref_enc.device_state(), templates)
    port = HoistedSession(enc.device_state("cpu"), templates, device="cpu")
    first, second = arrays[:12], arrays[12:]
    if after_batch:
        got = HoistedSession.decisions(port.schedule(first))
        assert got == RefSession.decisions(ref.schedule(first))
        for i, best in enumerate(got):
            if best >= 0:
                for e, p in ((ref_enc, pending[i]),
                             (enc, _port_obj(pending[i]))):
                    q = copy.deepcopy(p)
                    q.spec.node_name = e.node_names[best]
                    e.add_pod(q, q.spec.node_name)
    events = delta_tests._events(seed, nodes, bound, foreign)
    ref_deltas = delta_tests._ref_deltas(ref_enc, ref, events)
    deltas = delta_tests._port_deltas(enc, port, events)
    assert len(deltas) == len(ref_deltas) == len(events)
    for a, b in zip(deltas, ref_deltas):
        delta_tests._same_delta(a, b)
    ref.apply_deltas(ref_deltas)
    port.apply_deltas(deltas)
    _assert_carries(ref, port, "after apply_deltas")
    for k in ("alloc", "allowed_pods"):
        assert np.array_equal(port._c_static[k].numpy(),
                              np.asarray(ref._c_static[k])), k
    fresh = HoistedSession(enc.device_state("cpu"), templates, device="cpu")
    if not after_batch:
        for k in port._carry:
            assert torch.equal(port._carry[k], fresh._carry[k]), k
    decisions = HoistedSession.decisions(port.schedule(second))
    assert decisions == HoistedSession.decisions(fresh.schedule(second))
    assert decisions == RefSession.decisions(ref.schedule(second))
    assert any(d >= 0 for d in decisions)


def test_apply_deltas_repeated_nodes_accumulate():
    """Several events on one node in one flush all land (a scatter that
    kept one update per index would drop some): the same events applied
    one flush each give the same carry."""
    enc, arrays, templates, _ = _build("spread_multi_batch")
    host = enc.host_snapshot()
    a = HoistedSession(cluster_from_numpy(host, "cpu"), templates,
                       device="cpu")
    b = HoistedSession(cluster_from_numpy(host, "cpu"), templates,
                       device="cpu")
    t_n, c_n = len(templates), a._S["f_pair_cn"].shape[2]
    r = a._carry["requested"].shape[1]
    rng = np.random.default_rng(5)
    deltas = []
    for i in range(12):
        deltas.append({
            "kind": "pod-add", "node": int(i % 3), "dcount": 1,
            "dres": rng.integers(0, 50, r).astype(np.int64),
            "dnz": rng.integers(0, 50, 2).astype(np.int64),
            "mf": rng.integers(0, 2, (t_n, c_n)).astype(np.int32),
            "ms": rng.integers(0, 2, (t_n, c_n)).astype(np.int32)})
    deltas.append({"kind": "node-alloc", "node": 1, "dallowed": 2,
                   "dalloc": np.full(r, 1000, np.int64)})
    a.apply_deltas(deltas)
    for d in deltas:
        b.apply_deltas([d])
    for k in a._carry:
        assert torch.equal(a._carry[k], b._carry[k]), k
    fresh = HoistedSession(cluster_from_numpy(host, "cpu"), templates,
                           device="cpu")
    assert int((a._carry["pod_count"] - fresh._carry["pod_count"]).sum()) \
        == 12
    assert torch.equal(a._c_static["alloc"], b._c_static["alloc"])


# ---------------------------------------------------------------------------
# the session's surface


def test_session_owns_its_state():
    """The carry and the statics are copies: scheduling moves neither the
    cluster tensors the session was built from nor the encoding's device
    state, and a later in-place refresh of that device state does not move
    the session."""
    nodes, init_pods = synth_cluster(8, pods_per_node=1)
    pending = synth_pending_pods(12, spread=True)
    enc = ClusterEncoding()
    enc.set_cluster([_port_obj(n) for n in nodes],
                    [_port_obj(p) for p in init_pods])
    pe = PodEncoder(enc)
    arrays = [{k: v for k, v in pe.encode(_port_obj(p)).items()
               if not k.startswith("_")} for p in pending]
    state = enc.device_state("cpu")
    before = {k: v.clone() for k, v in state.items()}
    sess = HoistedSession(state, _templates_of(arrays), device="cpu")
    carry0 = {k: v.clone() for k, v in sess._carry.items()}
    static0 = {k: v.clone() for k, v in sess._c_static.items()}
    got = HoistedSession.decisions(sess.schedule(arrays[:6]))
    assert all(d >= 0 for d in got)
    for k, v in before.items():
        assert torch.equal(state[k], v), k
    # the encoding moves (pods bound), its device state is rewritten
    for p, d in zip(pending[:6], got):
        q = _port_obj(copy.deepcopy(p))
        q.spec.node_name = enc.node_names[d]
        enc.add_pod(q, q.spec.node_name)
    enc.device_state("cpu")
    for k, v in static0.items():
        assert torch.equal(sess._c_static[k], v), k
    assert not torch.equal(sess._carry["requested"], carry0["requested"])


def test_session_refusals(monkeypatch):
    enc, arrays, templates, _ = _build("spread_multi_batch")
    cluster = cluster_from_numpy(enc.host_snapshot(), "cpu")
    sess = HoistedSession(cluster, templates[:1], device="cpu")
    other = [a for a in arrays
             if template_fingerprint(a) != template_fingerprint(templates[0])]
    with pytest.raises(KeyError):
        sess.schedule(other[:1])
    bound = dict(arrays[0], has_node_name=np.bool_(True))
    with pytest.raises(ValueError):
        sess.schedule([bound])
    with pytest.raises(ValueError):
        hoisted.prepare_batch([bound], "cpu")
    n, r = sess._c_static["alloc"].shape
    carry = {k: v.clone() for k, v in sess._carry.items()}
    alloc = sess._c_static["alloc"].clone()
    with pytest.raises(ValueError):
        sess.apply_deltas([{"kind": "node-alloc", "node": 0, "dallowed": 1,
                            "dalloc": np.ones(r, np.int64)},
                           {"kind": "node-alloc", "node": n, "dallowed": 1,
                            "dalloc": np.ones(r, np.int64)}])
    assert torch.equal(sess._c_static["alloc"], alloc)
    for k, v in carry.items():
        assert torch.equal(sess._carry[k], v), k
    assert HoistedSession.decisions(sess.schedule([])) == []
    # no device: the card, and without CUDA a refusal
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        HoistedSession(cluster, templates)


def test_scan_session_has_no_explain():
    """ScanSession answers the session ladder's explain questions as the
    reference kernel session does: supports_explain False, and a static
    explain_payload that returns None for any harvested batch."""
    enc, arrays, templates, _ = _build("spread_multi_batch")
    ss = ScanSession(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                     templates, multipod_k=1, device="cpu")
    assert ScanSession.supports_explain is False
    assert ss.supports_explain is False
    ys = ss.schedule(arrays[:4])
    assert ScanSession.explain_payload(ys) is None
    assert ss.explain_payload({}) is None
