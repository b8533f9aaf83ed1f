"""The port's session deltas: cluster churn absorbed into a live
ScanSession (apply_deltas, the scan kernel's delta mode run here through
its plain PyTorch version) against the reference's PallasSession and its
jnp program _carry_delta_scan, exactly.

- `carry_delta_reference` equals `_carry_delta_scan` on seeded random
  signed payloads (-1 pair lanes, per-node and shared-key score rows,
  node-alloc rows), and the factor rows it reads out of the statics equal
  the reference's `_src_rows` / `_perno_rows`;
- `apply_deltas` on the seed path and on the carry path equals
  PallasSession's, array for array, on test_session_deltas.py's
  _pallas_fixture;
- after seeded random churn (foreign pods bound and evicted, terminating
  pods, allocatable bumps), classified by the port's backend
  (TPUBackend._queue_pod_delta / _queue_alloc_patch) exactly as the
  reference backend's classifiers do, the
  patched session's carries equal a fresh session's (in unscaled units)
  and its next batch decides as the fresh session and
  PallasSession(interpret=True) do;
- `delta_compatible`, the cumulative alloc guard and `ipa_term_match_np`
  answer as the reference's do."""

import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.models.encoding import ClusterEncoding as RefEncoding
from kubernetes_tpu.models.pod_encoder import PodEncoder as RefPodEncoder
from kubernetes_tpu.ops.hoisted import ipa_term_match_np as ref_term_match
from kubernetes_tpu.ops.hoisted import match_matrices_np as ref_match
from kubernetes_tpu.ops.hoisted import template_fingerprint
from kubernetes_tpu.ops.pallas_scan import PallasSession, _carry_delta_scan
from kubernetes_tpu.scheduler.tpu_backend import TPUBackend
from kubernetes_tpu_torch.models.encoding import ClusterEncoding
from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
from kubernetes_tpu_torch.models.pod_encoder import PodEncoder
from kubernetes_tpu_torch.ops import scan_kernel
from kubernetes_tpu_torch.ops.hoisted import ipa_term_match_np
from kubernetes_tpu_torch.ops.scan import ScanSession
from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend as PortBackend

from .test_session_deltas import _pallas_fixture, _remove_delta, _spread_pod
from .test_torch_encoding import _port_obj
from .test_torch_prologue import build_case
from .util import make_node, make_pod, spread_constraint

# shapes with shared-key and per-node (hostname) score rows ("churn", the
# random-churn cluster below), several templates, and a term-template
# session (whose ucnt / kcnt stay put)
FACTOR_CASES = ("churn", "mixed_templates_cross_counting",
                "hostname_hard_spread", "terms_weight100_preferred")
TERM_CASES = ("terms_hostname_required_anti", "terms_zone_required_anti",
              "terms_required_affinity_first_pod_escape",
              "terms_preferred_score", "terms_weight100_preferred",
              "terms_cross_template_anti")


def _templates_of(arrays):
    templates, seen = [], set()
    for a in arrays:
        fp = template_fingerprint(a)
        if fp not in seen:
            seen.add(fp)
            templates.append(a)
    return templates


def _port_session(cluster_np, templates):
    return ScanSession(cluster_from_numpy(cluster_np, "cpu"), templates,
                       multipod_k=1, device="cpu")


def _random_payload(rng, ss, E):
    """(node [E], rows [E, Rp + 8 + 2 TCp]) of signed deltas: events on
    every lane kind (padding lanes have -1 pair ids), a quarter of them
    node-alloc events (dnzpc[3] only)."""
    Rp, TCp = ss._requested0.shape[0], ss.TCp
    node = rng.integers(0, ss.Np, E).astype(np.int32)
    node[:E // 2] = rng.integers(0, ss.N, E // 2)
    rows = rng.integers(-3, 4, (E, scan_kernel.delta_width(Rp, TCp)))
    rows = rows.astype(np.int32)
    for e in range(0, E, 4):
        rows[e] = 0
        rows[e, Rp + 3] = rng.integers(-2, 3)
    return node, rows


def _case(name):
    """(reference encoding, templates) of a FACTOR_CASES entry."""
    if name == "churn":
        nodes, bound, pending, foreign = _churn_cluster()
        enc, arrays = _presize(RefEncoding, RefPodEncoder, nodes, bound,
                               pending, foreign, to_port=False)
        return enc, _templates_of(arrays)
    enc, _, templates, _ = build_case(name)
    return enc, templates


@pytest.mark.parametrize("case", FACTOR_CASES)
def test_carry_delta_reference_equals_carry_delta_scan(case):
    enc, templates = _case(case)
    ps = PallasSession(enc.device_state(), templates, interpret=True,
                       multipod_k=1)
    ss = _port_session(enc.host_snapshot(), templates)
    statics = ss._get_statics()
    src_rows, perno_rows = scan_kernel.delta_factor_rows(statics, ss.shapes)
    assert np.array_equal(src_rows.numpy(), ps._src_rows)
    assert np.array_equal(perno_rows.numpy(), ps._perno_rows)
    if case == "churn":  # both kinds of score row
        assert (ps._perno_rows == 1).any() and (ps._perno_rows == 0).any()
    rng = np.random.default_rng(len(case))
    node, rows = _random_payload(rng, ss, 24)
    Rp, TCp = ss._requested0.shape[0], ss.TCp
    carry = ss._initial_carry()
    before = {k: v.clone() for k, v in carry.items()}
    scan_kernel.carry_delta(torch.from_numpy(node), torch.from_numpy(rows),
                            statics, carry, ss.shapes)
    xs = {"node": node, "dres": rows[:, :Rp], "dnzpc": rows[:, Rp:Rp + 8],
          "mf": rows[:, Rp + 8:Rp + 8 + TCp], "ms": rows[:, Rp + 8 + TCp:]}
    want = _carry_delta_scan(
        {k: jnp.asarray(before[k].numpy()) for k in
         ("requested", "nzpc", "cnt_fn", "cnt_sn")},
        jnp.asarray(ps._prow_f), jnp.asarray(ps._prow_s),
        jnp.asarray(ps._src_rows), jnp.asarray(ps._perno_rows),
        {k: jnp.asarray(v) for k, v in xs.items()})
    for k, v in want.items():
        assert np.array_equal(carry[k].numpy(), np.asarray(v)), k
    for k in ("requested", "nzpc"):
        assert not torch.equal(carry[k], before[k]), k
    for k in ("ucnt", "kcnt"):
        if k in carry:
            assert torch.equal(carry[k], before[k]), k


def test_carry_delta_rejects_bad_inputs():
    enc, _, templates, _ = build_case("hostname_hard_spread")
    ss = _port_session(enc.host_snapshot(), templates)
    carry = ss._initial_carry()
    Rp = ss._requested0.shape[0]
    rows = torch.zeros((1, scan_kernel.delta_width(Rp, ss.TCp)),
                       dtype=torch.int32)
    with pytest.raises(ValueError):      # payload width
        scan_kernel.carry_delta(torch.zeros(1, dtype=torch.int32),
                                rows[:, 1:].contiguous(), ss._get_statics(),
                                carry, ss.shapes)
    with pytest.raises(ValueError):      # node past the padded axis
        scan_kernel.carry_delta(torch.full((1,), ss.Np, dtype=torch.int32),
                                rows, ss._get_statics(), carry, ss.shapes)
    with pytest.raises(ValueError):      # apply_deltas: node past N
        ss.apply_deltas([{"kind": "node-alloc", "node": ss.N,
                          "dalloc": np.zeros(ss.R, np.int64),
                          "dallowed": 1}])


@pytest.mark.parametrize("case", FACTOR_CASES)
def test_delta_statics_equal_pallas(case):
    enc, templates = _case(case)
    ps = PallasSession(enc.device_state(), templates, interpret=True,
                       multipod_k=1)
    ss = _port_session(enc.host_snapshot(), templates)
    assert np.array_equal(ss._gcd, ps._gcd)
    assert ss._gcd.dtype == ps._gcd.dtype == np.int64
    assert np.array_equal(ss._src_rows, ps._src_rows)
    assert np.array_equal(ss._perno_rows, ps._perno_rows)


def _private_alloc(ps):
    """Give the reference's device statics an alloc of their own. On the
    CPU, JAX may hand back a buffer that aliases a 64-byte aligned numpy
    array, so PallasSession's bundle alloc can share memory with its host
    `_alloc`; `_patch_alloc_static` then patches the host array in place
    and adds the same patch to the bundle a second time (on a TPU the two
    are separate buffers). The private buffer is made from a host copy
    that nothing writes, and is ready before this returns: a device-side
    copy of the aliased buffer (`alloc + 0`) is dispatched asynchronously
    and can run after `_patch_alloc_static`'s in-place host write, which
    then lands in the bundle twice all the same."""
    cfg, statics, ipa = ps._get_bundle()
    alloc = jnp.array(np.array(ps._alloc, copy=True))
    alloc.block_until_ready()
    ps._bundle = (cfg, dict(statics, alloc=alloc), ipa)


def _fixture_deltas(enc, bound, sess):
    """The fixture's churn in the reference's own terms: a spread pod
    evicted (its match lanes patch cnt_fn / cnt_sn) and a node-alloc
    patch by a GCD multiple."""
    nidx, dres, dnz, dcount, rows = _remove_delta(enc, bound[3])
    mfa, msa = ref_match(sess._tp_np, [rows])
    dalloc = np.zeros(sess._gcd.shape[0], np.int64)
    dalloc[0] = 4 * int(sess._gcd[0])
    return [
        {"kind": "pod-remove", "node": nidx, "dres": dres, "dnz": dnz,
         "dcount": dcount, "mf": mfa[:, 0, :].astype(np.int32) * -1,
         "ms": msa[:, 0, :].astype(np.int32) * -1},
        {"kind": "node-alloc", "node": 2, "dalloc": dalloc, "dallowed": 3},
    ]


@pytest.mark.parametrize("carry_path", [False, True])
def test_apply_deltas_equals_pallas(carry_path):
    """Seed path (no launch yet) and carry path (one delta launch): every
    carry, the host alloc and the device alloc static equal
    PallasSession.apply_deltas's, array for array, padding included."""
    _, enc, bound, tmpl, cluster = _pallas_fixture()
    ps = PallasSession(cluster, [tmpl])
    ss = _port_session(cluster, [tmpl])
    for k in ("_gcd", "_src_rows", "_perno_rows"):
        assert np.array_equal(getattr(ss, k), getattr(ps, k)), k
    deltas = _fixture_deltas(enc, bound, ps)
    if carry_path:
        ps._carry = ps._initial_carry()
        _private_alloc(ps)
        ss._carry = ss._initial_carry()
        ss._get_statics()
    ps.apply_deltas(copy.deepcopy(deltas))
    ss.apply_deltas(copy.deepcopy(deltas))
    if carry_path:
        for k in ss.carry_keys:
            assert np.array_equal(ss._carry[k].numpy(),
                                  np.asarray(ps._carry[k])), k
        assert np.array_equal(ss._statics["alloc"].numpy(),
                              np.asarray(ps._bundle[1]["alloc"]))
        assert np.array_equal(ss._statics["alloc"].numpy(), ss._alloc)
    else:
        for k in ("requested0", "nzpc0", "cnt_fn0", "cnt_sn0"):
            assert np.array_equal(getattr(ss, f"_{k}"),
                                  getattr(ps, f"_{k}")), k
    assert np.array_equal(ss._alloc, ps._alloc)


def test_delta_compatible_equals_pallas():
    """Non-multiples of the GCD and rescaled magnitudes past the int32
    score headroom are refused, as the reference refuses them."""
    _, enc, bound, tmpl, cluster = _pallas_fixture()
    ps = PallasSession(cluster, [tmpl])
    ss = _port_session(cluster, [tmpl])
    g = ss._gcd
    R = g.shape[0]
    assert int(g[0]) > 1
    head = 2 ** 31 // 101 + 1      # the first scaled magnitude refused
    cases = []
    for dres0, dnz0 in ((g[0], 0), (g[0] + 1, 0), (-g[0], -g[0]),
                        (g[0] * head, 0), (g[0] * (head - 1), 0),
                        (0, g[0] * head), (0, 1)):
        dres = np.zeros(R, np.int64)
        dres[0] = dres0
        cases.append((dres, np.array([dnz0, 0], np.int64)))
    cases.append((np.zeros(R - 1, np.int64), np.zeros(2, np.int64)))
    got = [ss.delta_compatible(*c) for c in cases]
    assert got == [ps.delta_compatible(*c) for c in cases]
    assert got == [True, False, True, False, True, False, False, False]


def test_cumulative_alloc_patches_raise():
    """Each patch is compatible alone; their sum overflows the headroom,
    and the port raises where the reference does, on both paths."""
    _, enc, bound, tmpl, cluster = _pallas_fixture()
    for carry_path in (False, True):
        ps = PallasSession(cluster, [tmpl])
        ss = _port_session(cluster, [tmpl])
        if carry_path:
            ss._carry = ss._initial_carry()
            ss._get_statics()
        dalloc = np.zeros(ss._gcd.shape[0], np.int64)
        dalloc[0] = int(ss._gcd[0]) * (2 ** 31 // 101 // 2 + 1)
        d = {"kind": "node-alloc", "node": 1, "dalloc": dalloc,
             "dallowed": 0}
        assert ss.delta_compatible(dalloc, np.zeros(2, np.int64))
        for sess in (ps, ss):
            with pytest.raises(ValueError):
                sess.apply_deltas([dict(d), dict(d)])
        # the first patch landed before the second raised, in both
        assert np.array_equal(ss._alloc, ps._alloc)


@pytest.mark.parametrize("case", TERM_CASES)
def test_ipa_term_match_np_equals_reference(case):
    """Every pending pod's row of the case against the session's own
    terms."""
    enc, arrays, templates, _ = build_case(case)
    ss = _port_session(enc.host_snapshot(), templates)
    ps = PallasSession(enc.device_state(), templates, interpret=True,
                       multipod_k=1)
    for k, v in ps._term_np.items():
        assert np.array_equal(ss._term_np[k], v), k
    rows = [{k: a[k] for k in ("self_ppair", "self_pkey", "self_ns")}
            for a in arrays]
    got = [ipa_term_match_np(ss._term_np, r) for r in rows]
    assert got == [ref_term_match(ps._term_np, r) for r in rows]
    assert any(got)


# ---------------------------------------------------------------------------
# random churn, classified as the backend classifies it


def _host_pod(name, node=None, labels=None):
    labels = labels or {"app": "host"}
    return make_pod(
        name, namespace="default", cpu="100m", memory="64Mi", labels=labels,
        constraints=[
            spread_constraint(1, v1.LABEL_HOSTNAME, "ScheduleAnyway", labels),
            spread_constraint(3, "zone", "DoNotSchedule", labels),
        ],
        node_name=node or "")


def _plain_pod(name, node=None, labels=None):
    return make_pod(name, namespace="default", cpu="100m", memory="32Mi",
                    labels=labels or {"app": "plain"}, node_name=node or "")


N_NODES = 8
LABELS = ({"app": "spread"}, {"app": "host"}, {"app": "plain"},
          {"app": "other"})


def _churn_cluster():
    """(nodes, bound pods, pending pods, foreign pods to pre-size for)."""
    nodes = [make_node(f"n{i}", cpu=str(4 + (i % 2) * 2), memory="16Gi",
                       pods=40, labels={v1.LABEL_HOSTNAME: f"n{i}",
                                        "zone": f"z{i % 3}"})
             for i in range(N_NODES)]
    bound = ([_spread_pod(f"b{i}", node=f"n{i % N_NODES}") for i in range(6)]
             + [_host_pod(f"h{i}", node=f"n{(3 * i) % N_NODES}")
                for i in range(4)]
             + [_plain_pod(f"q{i}", node=f"n{i}", labels={"app": "other"})
                for i in range(3)])
    pending = []
    for i in range(8):
        pending += [_spread_pod(f"s{i}"), _host_pod(f"t{i}"),
                    _plain_pod(f"p{i}")]
    foreign = [_plain_pod(f"f{i}", labels=LABELS[i % 4]) for i in range(16)]
    return nodes, bound, pending, foreign


def _presize(enc_cls, pe_cls, nodes, bound, pending, foreign, to_port):
    """bench.py's phantom pre-sizing for the pending and the foreign pods,
    on either package's encoding (the port's gets its own API objects)."""
    conv = _port_obj if to_port else (lambda o: o)
    enc = enc_cls()
    phantoms = []
    for i, p in enumerate(pending + foreign):
        q = copy.deepcopy(p)
        q.metadata.name = f"phantom-{i}"
        q.spec.node_name = nodes[i % len(nodes)].metadata.name
        phantoms.append(conv(q))
    enc.set_cluster([conv(n) for n in nodes],
                    [conv(b) for b in bound] + phantoms)
    pe = pe_cls(enc)
    arrays = [{k: v for k, v in pe.encode(conv(p)).items()
               if not k.startswith("_")} for p in pending]
    if to_port:
        enc.device_state("cpu")
    else:
        enc.device_state()
    for q in phantoms:
        enc.remove_pod(q)
    return enc, arrays


def _events(seed, nodes, bound, foreign):
    """Seeded churn: (kind, payload) in order — foreign pods bound to
    random nodes (some already terminating), evictions of bound pods,
    allocatable bumps by a whole core and a GiB."""
    rng = random.Random(seed)
    live = list(bound)
    fresh = list(foreign)
    events = []
    for i in range(14):
        r = rng.random()
        if r < 0.4 and fresh:
            p = copy.deepcopy(fresh.pop())
            p.spec.node_name = nodes[rng.randrange(N_NODES)].metadata.name
            if rng.random() < 0.25:
                p.metadata.deletion_timestamp = 1.0e9 + i
            events.append(("add", p))
            live.append(p)
        elif r < 0.7 and live:
            events.append(("remove", live.pop(rng.randrange(len(live)))))
        else:
            node = copy.deepcopy(nodes[rng.randrange(N_NODES)])
            for field in ("allocatable", "capacity"):
                res = getattr(node.status, field)
                res["cpu"] = str(int(res["cpu"]) + 1)
                res["memory"] = f"{int(res['memory'][:-2]) + 1}Gi"
            nodes[int(node.metadata.name[1:])] = node
            events.append(("alloc", node))
    return events


def _ref_backend(enc, sess):
    """A reference backend whose classifiers run against `enc` and
    `sess` (only their state is read)."""
    be = TPUBackend()
    be.enc = enc
    be._session = sess
    be.delta_patching = True
    be._deltas = []
    return be


def _port_deltas(enc, sess, events):
    """The port's backend classifiers against `enc` and `sess`, as
    _ref_backend runs the reference's."""
    be = PortBackend(device="cpu")
    be.enc = enc
    be._session = sess
    be.delta_patching = True
    be._deltas = []
    for kind, obj in events:
        obj = _port_obj(obj)
        n = len(be._deltas)
        if kind == "alloc":
            old = ClusterEncoding.node_fingerprint(
                enc._nodes[obj.metadata.name])
            assert be._queue_alloc_patch(
                obj, old, ClusterEncoding.node_fingerprint(obj))
        else:
            sign = 1 if kind == "add" else -1
            mutate = ((lambda p=obj: enc.add_pod(p, p.spec.node_name))
                      if sign > 0 else (lambda p=obj: enc.remove_pod(p)))
            assert be._queue_pod_delta(obj, obj.spec.node_name, sign,
                                       mutate)
        assert be._session is sess and len(be._deltas) == n + 1, (
            kind, obj.metadata.name)
    return be._deltas


def _ref_deltas(enc, sess, events):
    be = _ref_backend(enc, sess)
    for kind, obj in events:
        if kind == "alloc":
            old = RefEncoding.node_fingerprint(enc._nodes[obj.metadata.name])
            assert be._queue_alloc_patch(obj, old,
                                         RefEncoding.node_fingerprint(obj))
        else:
            sign = 1 if kind == "add" else -1
            mutate = ((lambda p=obj: enc.add_pod(p, p.spec.node_name))
                      if sign > 0 else (lambda p=obj: enc.remove_pod(p)))
            assert be._queue_pod_delta(obj, obj.spec.node_name, sign, mutate)
    return be._deltas


def _same_delta(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _unscaled(sess, carry):
    """Carries and alloc in the encoding's units (x the session's GCD),
    on the valid node lanes."""
    g, R = sess._gcd, sess.R
    c = {k: np.asarray(v).astype(np.int64) for k, v in carry.items()}
    c["requested"] = c["requested"][:R] * g[:, None]
    c["nzpc"][:2] *= g[:2, None]
    c["alloc"] = sess._alloc[:R].astype(np.int64) * g[:, None]
    return c


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("carry_path", [False, True])
def test_random_churn_equals_fresh_session(seed, carry_path):
    """The carry path schedules a batch first and binds its decisions into
    both encodings (the harvest); then the churn, classified on each
    package's encoding, applied to each package's live session; then the
    next batch."""
    nodes, bound, pending, foreign = _churn_cluster()
    ref_enc, arrays = _presize(RefEncoding, RefPodEncoder, nodes, bound,
                               pending, foreign, to_port=False)
    enc, port_arrays = _presize(ClusterEncoding, PodEncoder, nodes, bound,
                                pending, foreign, to_port=True)
    for a, b in zip(arrays, port_arrays):
        assert template_fingerprint(a) == template_fingerprint(b)
    templates = _templates_of(arrays)
    ps = PallasSession(ref_enc.device_state(), templates, interpret=True,
                       multipod_k=1)
    ss = ScanSession(enc.device_state("cpu"), templates, multipod_k=1,
                     device="cpu")
    first, second = arrays[:12], arrays[12:]
    if carry_path:
        got = ScanSession.decisions(ss.schedule(first))
        assert got == ps.decisions(ps.schedule(first))
        _private_alloc(ps)
        for i, best in enumerate(got):
            if best >= 0:
                for e, p in ((ref_enc, pending[i]),
                             (enc, _port_obj(pending[i]))):
                    q = copy.deepcopy(p)
                    q.spec.node_name = e.node_names[best]
                    e.add_pod(q, q.spec.node_name)
    events = _events(seed, nodes, bound, foreign)
    kinds = {k for k, _ in events}
    assert kinds == {"add", "remove", "alloc"}, kinds
    ref_deltas = _ref_deltas(ref_enc, ps, events)
    deltas = _port_deltas(enc, ss, events)
    assert len(deltas) == len(ref_deltas) == len(events)
    for a, b in zip(deltas, ref_deltas):
        _same_delta(a, b)
    assert np.array_equal(enc.device_state("cpu")["alloc"].numpy(),
                          ref_enc.device_state()["alloc"])
    ps.apply_deltas(ref_deltas)
    ss.apply_deltas(deltas)

    fresh = ScanSession(enc.device_state("cpu"), templates, multipod_k=1,
                        device="cpu")
    live_carry = (ss._carry if carry_path else ss._initial_carry())
    got = _unscaled(ss, {k: live_carry[k].numpy() for k in ss.carry_keys})
    want = _unscaled(fresh, {k: v.numpy()
                             for k, v in fresh._initial_carry().items()})
    valid = enc.device_state("cpu")["valid"].numpy().astype(bool)
    n = valid.shape[0]
    for k in want:
        assert np.array_equal(got[k][:, :n][:, valid],
                              want[k][:, :n][:, valid]), k
    decisions = ScanSession.decisions(ss.schedule(second))
    assert decisions == ScanSession.decisions(fresh.schedule(second))
    assert decisions == ps.decisions(ps.schedule(second))
    assert any(d >= 0 for d in decisions)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_churn_wrappers_equal_backend_classifiers(seed):
    """testing/churn.py's wrappers (what chip_smoke.py classifies with)
    give the backend's deltas on the same churn, each on its own copy of
    the encoding."""
    from kubernetes_tpu_torch.testing import churn

    nodes, bound, pending, foreign = _churn_cluster()
    encs = [_presize(ClusterEncoding, PodEncoder, nodes, bound, pending,
                     foreign, to_port=True) for _ in range(2)]
    templates = _templates_of(encs[0][1])
    sessions = [ScanSession(e.device_state("cpu"), templates, multipod_k=1,
                            device="cpu") for e, _ in encs]
    events = _events(seed, nodes, bound, foreign)
    want = _port_deltas(encs[0][0], sessions[0], events)
    enc, sess = encs[1][0], sessions[1]
    got = []
    for kind, obj in events:
        obj = _port_obj(obj)
        if kind == "alloc":
            got.append(churn.alloc_patch(sess, enc, obj))
        else:
            sign = 1 if kind == "add" else -1
            mutate = ((lambda p=obj: enc.add_pod(p, p.spec.node_name))
                      if sign > 0 else (lambda p=obj: enc.remove_pod(p)))
            got.append(churn.pod_delta(sess, enc, obj, obj.spec.node_name,
                                       sign, mutate))
    assert len(got) == len(want) == len(events)
    for a, b in zip(got, want):
        _same_delta(a, b)
