"""ShardedScanSession (the port's two-phase session over a node-axis
mesh) against the reference and the single-device sessions, on the CPU.

The invariant: sharding the node axis must not change ONE decision — the
global normalize min/max, the PTS min-match, zone presence and the
first-max argmax all reduce across shards exactly. Every case runs both
layouts of a port mesh: one group of k shards, and k one-shard groups on
the same device (the cross-group collectives).

- ur = 0 (templates without affinity terms): decisions, score,
  n_feasible and the gathered carries equal the reference's
  ShardedPallasSession on its 8-device virtual CPU mesh, at shard counts
  1, 2, 3, 4 and 8 and at node counts that do not divide them
  (test_sharded_scan.py:113), and ScanSession's;
- ur > 0 (term templates), where the reference's sharded session raises
  (its commit reads an unbound `ucnt`): the same against ScanSession, and
  against PallasSession in interpret mode on the reference test's two
  term shapes;
- k > 1: the conflict-suffix contract — the backend's suffix replay
  (scheduler/tpu_backend.py schedule_exact) decides as one pod per step;
- a seeded stream of pod, allocatable, node-join and node-leave deltas:
  carries and the next batch equal a rebuild's and the reference
  sharded session's fed the same stream."""

import copy
import random

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from kubernetes_tpu.models.encoding import ClusterEncoding as RefEncoding
from kubernetes_tpu.models.pod_encoder import PodEncoder as RefPodEncoder
from kubernetes_tpu.ops.hoisted import HoistedSession
from kubernetes_tpu.ops.pallas_scan import PallasSession
from kubernetes_tpu.ops.sharded_scan import ShardedPallasSession
from kubernetes_tpu.testing.synth import synth_cluster, synth_pending_pods
from kubernetes_tpu_torch.api import types as v1
from kubernetes_tpu_torch.models.encoding import (
    ClusterEncoding,
    cluster_from_numpy,
)
from kubernetes_tpu_torch.models.pod_encoder import PodEncoder
from kubernetes_tpu_torch.ops.scan import ScanSession
from kubernetes_tpu_torch.ops.sharded_scan import ShardedScanSession
from kubernetes_tpu_torch.parallel.sharded import make_mesh
from kubernetes_tpu_torch.scheduler.tpu_backend import schedule_exact
from kubernetes_tpu_torch.testing import churn

from .test_hoisted import _encode_all, _presized_encoding
from .test_torch_deltas import _templates_of, _unscaled
from .test_torch_encoding import _port_obj
from .test_torch_prologue import TERM_SHAPES, build_case
from .util import make_node, make_pod

LAYOUTS = ("group", "split")


def port_mesh(nsh, layout):
    devs = ["cpu"] if layout == "group" else ["cpu"] * nsh
    return make_mesh(devices=devs, n_devices=nsh)


def ref_mesh(nsh):
    return JaxMesh(np.asarray(jax.devices()[:nsh]), ("nodes",))


def _cluster(enc):
    return cluster_from_numpy(enc.host_snapshot(), "cpu")


def _sharded(enc, templates, nsh, layout, **kw):
    return ShardedScanSession(_cluster(enc), templates,
                              mesh=port_mesh(nsh, layout), **kw)


def _assert_rows(want, got, n, ctx):
    assert np.array_equal(want[:3, :n], got[:3, :n]), (ctx, want[:3, :n],
                                                       got[:3, :n])


def _assert_carry_vs_scan(ss, sh, ctx):
    """The gathered sharded carry equals ScanSession's on its Np lanes
    (kcnt: the per-shard partials sum to ScanSession's totals), and the
    lanes past Np are untouched padding."""
    gc = sh.gathered_carry()
    for k in ss.carry_keys:
        a = ss._carry[k].numpy()
        if k == "kcnt":
            assert np.array_equal(a[:, 0], gc[k].sum(1)), (ctx, k)
            continue
        assert np.array_equal(a, gc[k][:, :a.shape[1]]), (ctx, k)
        assert not gc[k][:, a.shape[1]:].any(), (ctx, k)


def _run_against_scan(enc, arrays, templates, batch, nsh, layouts=LAYOUTS):
    """Sharded sessions (both layouts) against ScanSession, batch by
    batch: out rows [:3] and carries. Returns the sessions' rows."""
    ss = ScanSession(_cluster(enc), templates, multipod_k=1, device="cpu")
    shs = [_sharded(enc, templates, nsh, lay) for lay in layouts]
    rows = []
    for lo in range(0, len(arrays), batch):
        b = arrays[lo:lo + batch]
        want = ss.schedule(b)["rows"].numpy()
        got = [sh.schedule(b)["rows"].numpy() for sh in shs]
        for lay, g in zip(layouts, got):
            _assert_rows(want, g, len(b), (nsh, lay, lo))
        for lay, sh in zip(layouts, shs):
            _assert_carry_vs_scan(ss, sh, (nsh, lay, lo))
        rows.append((len(b), got[0]))
    return rows, shs


# ---------------------------------------------- ur = 0: the reference mesh

REF_CASES = [
    ("spread_multi_batch", 1), ("spread_multi_batch", 2),
    ("spread_multi_batch", 3), ("spread_multi_batch", 4),
    ("spread_multi_batch", 8), ("no_constraints", 4),
    ("capacity_exhaustion", 3), ("hostname_hard_spread", 2),
    ("mixed_templates_cross_counting", 8),
    ("tainted_and_labeled_cluster", 4), ("fuzz-0", 8), ("fuzz-2", 3),
    ("fuzz-5", 2),
]


def _against_reference(enc, arrays, templates, batch, nsh):
    ref = ShardedPallasSession(enc.device_state(), templates,
                               mesh=ref_mesh(nsh))
    rows, shs = _run_against_scan(enc, arrays, templates, batch, nsh)
    # replay the reference over the same batches
    for (n, got), lo in zip(rows, range(0, len(arrays), batch)):
        y = ref.schedule(arrays[lo:lo + batch])
        want = np.stack([np.asarray(y[k])[:n] for k in
                         ("best", "score", "n_feasible")])
        assert np.array_equal(want, got[:3, :n]), (nsh, lo, want, got[:3, :n])
    for sh in shs:
        assert (sh.Npl, sh.Nps) == (ref.Npl, ref.Nps)
        gc = sh.gathered_carry()
        assert set(gc) == set(ref._carry)
        for k, v in ref._carry.items():
            assert np.array_equal(np.asarray(v), gc[k]), (nsh, k)
    return rows


@pytest.mark.parametrize("case,nsh", REF_CASES)
def test_against_reference_sharded(case, nsh):
    enc, arrays, templates, batch = build_case(case)
    _against_reference(enc, arrays, templates, batch, nsh)


@pytest.mark.parametrize("n_nodes,nsh", [(7, 4), (17, 8), (5, 2)])
def test_odd_shard_counts(n_nodes, nsh):
    """Node counts that do NOT divide the shard count: padding lanes
    stay infeasible on every shard."""
    nodes, init_pods = synth_cluster(n_nodes, pods_per_node=1)
    pending = synth_pending_pods(12, spread=True)
    enc, pe = _presized_encoding(nodes, init_pods, pending)
    arrays = _encode_all(enc, pe, pending)
    _against_reference(enc, arrays, _templates_of(arrays), 6, nsh)


def test_parity_vs_hoisted_session_too():
    nodes, init_pods = synth_cluster(12, pods_per_node=2)
    pending = synth_pending_pods(18, spread=True)
    enc, pe = _presized_encoding(nodes, init_pods, pending)
    arrays = _encode_all(enc, pe, pending)
    templates = _templates_of(arrays)
    want = HoistedSession.decisions(HoistedSession(
        enc.device_state(), templates).schedule(arrays))[:len(arrays)]
    for lay in LAYOUTS:
        sh = _sharded(enc, templates, 8, lay)
        assert ShardedScanSession.decisions(sh.schedule(arrays)) == want


# ------------------------------------------------------ ur > 0: term templates


@pytest.mark.parametrize("case", list(TERM_SHAPES) + ["fuzzterms-1",
                                                      "fuzzterms-3",
                                                      "fuzzterms-6"])
@pytest.mark.parametrize("nsh", [2, 3, 8])
def test_terms_against_scan_session(case, nsh):
    enc, arrays, templates, batch = build_case(case)
    _, shs = _run_against_scan(enc, arrays, templates, batch, nsh)
    assert shs[0].UR > 0 or case.startswith("fuzz")


def _term_shape(kind):
    """The reference test's two term shapes (test_sharded_scan.py
    test_term_templates_parity, test_preferred_affinity_parity)."""
    from kubernetes_tpu.api import types as rv1

    from .util import make_pod as ref_pod

    if kind == "anti":
        nodes, init_pods = synth_cluster(12, pods_per_node=1)
        aff = rv1.Affinity(pod_anti_affinity=rv1.PodAntiAffinity(
            required_during_scheduling_ignored_during_execution=[
                rv1.PodAffinityTerm(
                    label_selector=rv1.LabelSelector(
                        match_labels={"app": "aff"}),
                    topology_key=rv1.LABEL_HOSTNAME)]))
        pending = [ref_pod(f"aff-{i}", cpu="50m", labels={"app": "aff"},
                           affinity=aff) for i in range(10)]
        return nodes, init_pods, pending, 5
    nodes, init_pods = synth_cluster(9, pods_per_node=1)
    aff = rv1.Affinity(pod_affinity=rv1.PodAffinity(
        preferred_during_scheduling_ignored_during_execution=[
            rv1.WeightedPodAffinityTerm(
                weight=10, pod_affinity_term=rv1.PodAffinityTerm(
                    label_selector=rv1.LabelSelector(
                        match_labels={"app": "pref"}),
                    topology_key=rv1.LABEL_ZONE))]))
    pending = [ref_pod(f"pref-{i}", cpu="50m", labels={"app": "pref"},
                       affinity=aff) for i in range(8)]
    return nodes, init_pods, pending, 4


@pytest.mark.parametrize("kind", ["anti", "pref"])
def test_terms_against_pallas(kind):
    """Where the reference's mesh raises: PallasSession (interpret mode)
    is the standard — rows [:3] and every carry, after every batch, at 8
    shards in both layouts; the anti shape lands one pod per node."""
    nodes, init_pods, pending, batch = _term_shape(kind)
    enc, pe = _presized_encoding(copy.deepcopy(nodes),
                                 copy.deepcopy(init_pods),
                                 copy.deepcopy(pending))
    arrays = _encode_all(enc, pe, pending)
    templates = _templates_of(arrays)
    ps = PallasSession(enc.device_state(), templates, interpret=True,
                       multipod_k=1)
    shs = [_sharded(enc, templates, 8, lay) for lay in LAYOUTS]
    assert shs[0].UR > 0
    got = []
    for lo in range(0, len(arrays), batch):
        b = arrays[lo:lo + batch]
        want = np.asarray(ps.schedule(b)["rows"])
        for sh in shs:
            rows = sh.schedule(b)["rows"].numpy()
            _assert_rows(want, rows, len(b), (kind, lo))
            gc = sh.gathered_carry()
            for k, v in ps._carry.items():
                v = np.asarray(v)
                if k == "kcnt":
                    assert np.array_equal(v[:, 0], gc[k].sum(1)), k
                else:
                    assert np.array_equal(v, gc[k][:, :v.shape[1]]), k
        got.extend(rows[0, :len(b)].tolist())
    if kind == "anti":
        placed = [d for d in got if d >= 0]
        assert len(placed) == len(set(placed)) == 10


# ------------------------------------------------------------ k > 1


@pytest.mark.parametrize("case", ["spread_multi_batch",
                                  "mixed_templates_cross_counting",
                                  "capacity_exhaustion",
                                  "terms_cross_template_anti"])
@pytest.mark.parametrize("mk", [2, 4])
def test_suffix_replay_equals_one_pod_per_step(case, mk):
    """k pods a step under the conflict-suffix contract: the backend's
    replay loop lands every pod where one pod per step does, and the
    carries end equal, in both layouts."""
    enc, arrays, templates, batch = build_case(case)
    one = ScanSession(_cluster(enc), templates, multipod_k=1, device="cpu")
    shs = [_sharded(enc, templates, 3, lay, multipod_k=mk)
           for lay in LAYOUTS]
    for lo in range(0, len(arrays), batch):
        b = arrays[lo:lo + batch]
        want = ScanSession.decisions(one.schedule(b))
        for sh in shs:
            assert sh.multipod_k == mk
            assert schedule_exact(sh, b) == want, (lo, mk)
            _assert_carry_vs_scan(one, sh, lo)


def test_directed_suffix_against_reference():
    """Two pods racing for the last slot in one k = 2 step: the reference
    sharded session and the port's flag the same suffix and leave the
    same rows and carries; the replay decides as one pod per step."""
    nodes, init_pods = synth_cluster(2, pods_per_node=0)
    for node, cpu in zip(nodes, ("3", "1")):
        node.status.allocatable["cpu"] = cpu
        node.status.capacity["cpu"] = cpu
    pending = [make_pod(f"race-{i}", namespace="default", cpu="2",
                        memory="128Mi", labels={"app": "race"})
               for i in range(2)]
    enc, pe = _presized_encoding(nodes, init_pods, pending)
    arrays = _encode_all(enc, pe, pending)
    templates = _templates_of(arrays)
    ref = ShardedPallasSession(enc.device_state(), templates,
                               mesh=ref_mesh(2), multipod_k=2)
    y = ref.schedule(list(arrays))
    want = np.stack([np.asarray(y[k])[:2] for k in
                     ("best", "score", "n_feasible", "conflicts")])
    assert ShardedPallasSession.conflict_stats(y) == (1, 1)
    for lay in LAYOUTS:
        sh = _sharded(enc, templates, 2, lay, multipod_k=2)
        ys = sh.schedule(list(arrays))
        assert np.array_equal(ys["rows"][:4, :2].numpy(), want), lay
        assert ShardedScanSession.conflict_stats(ys) == (1, 1)
        gc = sh.gathered_carry()
        for k, v in ref._carry.items():
            assert np.array_equal(np.asarray(v), gc[k]), k
        fresh = _sharded(enc, templates, 2, lay, multipod_k=2)
        assert schedule_exact(fresh, list(arrays)) == [0, -1]


# --------------------------------------------------------------- deltas

N_NODES = 24


def _node(i, cpu=None):
    return make_node(f"n{i}", cpu=cpu or str(4 + (i % 2) * 2),
                     memory="16Gi", pods=40,
                     labels={v1.LABEL_HOSTNAME: f"n{i}"})


def _host_spread(name, node=""):
    from .util import spread_constraint

    labels = {"app": "host"}
    return make_pod(name, namespace="default", cpu="100m", memory="64Mi",
                    labels=labels, node_name=node,
                    constraints=[spread_constraint(
                        1, v1.LABEL_HOSTNAME, "ScheduleAnyway", labels)])


def _plain(name, node=""):
    return make_pod(name, namespace="default", cpu="200m", memory="32Mi",
                    labels={"app": "plain"}, node_name=node)


def _node_churn_world():
    """A hostname-only cluster (the node-delta envelope): plain pods and
    hostname score spreads, some bound; pending and foreign pods."""
    nodes = [_node(i) for i in range(N_NODES)]
    bound = ([_host_spread(f"b{i}", node=f"n{i}") for i in range(4)]
             + [_plain(f"q{i}", node=f"n{i + 4}") for i in range(3)])
    pending = []
    for i in range(10):
        pending += [_host_spread(f"s{i}"), _plain(f"p{i}")]
    foreign = [_plain(f"f{i}") for i in range(8)]
    return nodes, bound, pending, foreign


def _presize(enc_cls, pe_cls, nodes, bound, pending, foreign, to_port):
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


def _node_events(seed, nodes, bound, foreign, taken):
    """Seeded churn with node leaves and re-joins: foreign pods bound
    and evicted, allocatable bumps, pod-free nodes removed and added back
    under their own names (their lanes and pair ids return)."""
    rng = random.Random(seed)
    live = list(bound)
    fresh = list(foreign)
    events, gone = [], []
    busy = set(taken) | {p.spec.node_name for p in bound}
    for i in range(16):
        r = rng.random()
        free = [n for n in nodes if n.metadata.name not in busy
                and n.metadata.name not in gone]
        if r < 0.25 and fresh:
            p = copy.deepcopy(fresh.pop())
            p.spec.node_name = rng.choice(
                [n for n in nodes if n.metadata.name not in gone]
            ).metadata.name
            busy.add(p.spec.node_name)
            events.append(("add", p))
            live.append(p)
        elif r < 0.4 and live:
            events.append(("remove", live.pop(rng.randrange(len(live)))))
        elif r < 0.55:
            node = copy.deepcopy(rng.choice(
                [n for n in nodes if n.metadata.name not in gone]))
            for field in ("allocatable", "capacity"):
                res = getattr(node.status, field)
                res["cpu"] = str(int(res["cpu"]) + 2)
            nodes[int(node.metadata.name[1:])] = node
            events.append(("alloc", node))
        elif r < 0.8 and free:
            n = rng.choice(free)
            gone.append(n.metadata.name)
            events.append(("leave", n))
        elif gone:
            name = gone.pop()
            events.append(("join", nodes[int(name[1:])]))
    return events


def _apply_events(enc, sess, events, to_port):
    """Each event on one package's encoding, classified against its
    live sharded session: the deltas, in order."""
    conv = _port_obj if to_port else (lambda o: o)
    deltas = []
    for kind, obj in events:
        obj = conv(copy.deepcopy(obj))
        if kind == "leave":
            lane = enc.remove_node(obj.metadata.name)
            assert lane is not None
            d = sess.node_leave_delta(lane)
        elif kind == "join":
            lane = enc.add_node(obj)
            assert lane is not None
            d = sess.node_join_delta(enc.node_slice_cluster(lane), lane)
        elif kind == "alloc":
            d = churn.alloc_patch(sess, enc, obj) if to_port else None
        else:
            sign = 1 if kind == "add" else -1
            mutate = ((lambda p=obj: enc.add_pod(p, p.spec.node_name))
                      if sign > 0 else (lambda p=obj: enc.remove_pod(p)))
            d = churn.pod_delta(sess, enc, obj, obj.spec.node_name, sign,
                                mutate)
        assert d is not None, (kind, obj.metadata.name)
        deltas.append(d)
    return deltas


def _mirror_ref(ref_enc, ref_sess, events, port_deltas):
    """The same churn on the reference encoding; its sharded session's
    own node-join / node-leave deltas must equal the port's."""
    out = []
    for (kind, obj), d in zip(events, port_deltas):
        obj = copy.deepcopy(obj)
        if kind == "leave":
            lane = ref_enc.remove_node(obj.metadata.name)
            rd = ref_sess.node_leave_delta(lane)
        elif kind == "join":
            lane = ref_enc.add_node(obj)
            rd = ref_sess.node_join_delta(ref_enc.node_slice_cluster(lane),
                                          lane)
        else:
            if kind == "alloc":
                # the in-place path of the reference's alloc patch
                assert ref_enc.update_node_alloc(obj) is not None
            elif kind == "add":
                ref_enc.add_pod(obj, obj.spec.node_name)
            else:
                ref_enc.remove_pod(obj)
            out.append(d)
            continue
        assert rd["kind"] == d["kind"] and rd["lane"] == d["lane"]
        for group, cols in rd["cols"].items():
            for k, v in cols.items():
                assert np.array_equal(np.asarray(v),
                                      np.asarray(d["cols"][group][k])), k
        out.append(rd)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_delta_stream_equals_rebuild_and_reference(seed, layout):
    nsh = 4
    nodes, bound, pending, foreign = _node_churn_world()
    ref_enc, arrays = _presize(RefEncoding, RefPodEncoder, nodes, bound,
                               pending, foreign, to_port=False)
    enc, _ = _presize(ClusterEncoding, PodEncoder, nodes, bound, pending,
                      foreign, to_port=True)
    templates = _templates_of(arrays)
    sh = ShardedScanSession(enc.device_state("cpu"), templates,
                            mesh=port_mesh(nsh, layout))
    ref = ShardedPallasSession(ref_enc.device_state(), templates,
                               mesh=ref_mesh(nsh))
    assert sh._node_delta_ok and ref._node_delta_ok
    first, second = arrays[:8], arrays[8:]
    got = ShardedScanSession.decisions(sh.schedule(first))
    assert got == ShardedPallasSession.decisions(ref.schedule(first))
    taken = set()
    for i, best in enumerate(got):
        if best >= 0:
            for e, p in ((ref_enc, pending[i]), (enc, _port_obj(pending[i]))):
                q = copy.deepcopy(p)
                q.spec.node_name = e.node_names[best]
                e.add_pod(q, q.spec.node_name)
            taken.add(enc.node_names[best])
    events = _node_events(seed, nodes, bound, foreign, taken)
    kinds = {k for k, _ in events}
    assert {"leave", "join"} <= kinds, kinds
    deltas = _apply_events(enc, sh, events, to_port=True)
    ref_deltas = _mirror_ref(ref_enc, ref, events, deltas)
    sh.apply_deltas(deltas)
    ref.apply_deltas(ref_deltas)

    gc = sh.gathered_carry()
    for k, v in ref._carry.items():
        assert np.array_equal(np.asarray(v), gc[k]), k
    fresh = ShardedScanSession(enc.device_state("cpu"), templates,
                               mesh=port_mesh(nsh, layout))
    valid = enc.device_state("cpu")["valid"].numpy().astype(bool)
    n = valid.shape[0]
    live = _unscaled(sh, gc)
    want = _unscaled(fresh, fresh.gathered_carry())
    for k in want:
        assert np.array_equal(live[k][:, :n][:, valid],
                              want[k][:, :n][:, valid]), k
    decisions = ShardedScanSession.decisions(sh.schedule(second))
    assert decisions == ShardedScanSession.decisions(fresh.schedule(second))
    assert decisions == ShardedPallasSession.decisions(ref.schedule(second))
    assert any(d >= 0 for d in decisions)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_zone_pod_deltas_equal_scan_session(layout):
    """Pod and allocatable churn on a cluster with zone spreads (pair ids
    shared across groups: an event on one group's node moves the count
    lanes of every group): the sharded carry after the flush equals
    ScanSession's after the same deltas, and so does the next batch."""
    from .test_torch_deltas import _churn_cluster, _events
    from .test_torch_deltas import _presize as churn_presize

    nodes, bound, pending, foreign = _churn_cluster()
    encs = [churn_presize(ClusterEncoding, PodEncoder, nodes, bound, pending,
                          foreign, to_port=True) for _ in range(2)]
    arrays = encs[0][1]
    templates = _templates_of(arrays)
    ss = ScanSession(encs[0][0].device_state("cpu"), templates,
                     multipod_k=1, device="cpu")
    sh = ShardedScanSession(encs[1][0].device_state("cpu"), templates,
                            mesh=port_mesh(3, layout))
    first, second = arrays[:12], arrays[12:]
    assert ScanSession.decisions(ss.schedule(first)) == \
        ShardedScanSession.decisions(sh.schedule(first))
    events = _events(0, copy.deepcopy(nodes), bound, foreign)
    for sess, (enc, _) in ((ss, encs[0]), (sh, encs[1])):
        sess.apply_deltas(_apply_events(enc, sess, events, to_port=True))
    _assert_carry_vs_scan(ss, sh, layout)
    assert ScanSession.decisions(ss.schedule(second)) == \
        ShardedScanSession.decisions(sh.schedule(second))
    _assert_carry_vs_scan(ss, sh, layout)


def test_node_delta_envelope_refuses():
    """Zone score spreads (a global value vocab) keep node events
    structural: node_join_delta / node_leave_delta return None."""
    enc, arrays, templates, _ = build_case("spread_multi_batch")
    sh = _sharded(enc, templates, 2, "group")
    assert not sh._node_delta_ok
    assert sh.node_leave_delta(0) is None
    with pytest.raises(ValueError, match="outside"):
        sh.apply_deltas([{"kind": "pod", "node": sh.Nps, "dres": [0],
                          "dnz": [0, 0], "dcount": 1, "mf": [], "ms": []}])
