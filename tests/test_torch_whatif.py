"""The port's what-if preemption planner (kubernetes_tpu_torch/ops/whatif.py,
ops/whatif_kernel.py's plain version, scheduler/preemption_device.py)
against the reference's, on the CPU. The path is integer and bool
throughout, so every comparison is exact equality.

- The program: the port's `WhatifContext.run` (on the CPU the plain
  version: the torch prologue, then `whatif_walk_reference`) against the
  reference's jitted `_whatif_run`, on
  what-if contexts built from the same real clusters in each package, with
  seeded random victim slots (padded slots, gang slots with v_cnt > 1),
  nominated aggregates and claimed-victim drains: plain, affinity-term
  (dyn_ipa), spread, host-port (dyn_ports) templates, with and without
  nominated pods. fits_now, base and victims must be equal.
- The smaller functions: `_gang_fits_run` at several k,
  `ipa_victim_matches_np`, `WhatifContext.np_slices` / `template_index`.
- The planner: the port's DevicePreemptionPlanner on
  TPUBackend(device="cpu") with the what-if on, against the reference's on
  its TPUBackend() with the what-if on, over tests/test_preemption_fast.py's
  generators (random clusters, PDBs, nominated load, the affinity / spread
  envelope, gang units, waves) and its ladder cases: each candidate's node,
  its victims in order, num_pdb_violations, fits_now and planner_paths.

The reference's cases share shapes, so its jitted program compiles a few
signatures only.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.ops import whatif as ref_whatif
from kubernetes_tpu.scheduler.framework.snapshot import Snapshot as RefSnapshot
from kubernetes_tpu.scheduler.internal.nominator import (
    PodNominator as RefNominator,
)
from kubernetes_tpu.scheduler.preemption_device import (
    ORACLE_FALLBACK as REF_ORACLE,
)
from kubernetes_tpu.scheduler.preemption_device import (
    DevicePreemptionPlanner as RefPlanner,
)
from kubernetes_tpu.testing.synth import make_node, make_pod
from kubernetes_tpu_torch.api import types as port_v1
from kubernetes_tpu_torch.ops import whatif
from kubernetes_tpu_torch.ops.whatif_kernel import (
    outputs,
    whatif_device,
    whatif_walk_reference,
)
from kubernetes_tpu_torch.scheduler.framework.snapshot import Snapshot
from kubernetes_tpu_torch.scheduler.internal.nominator import PodNominator
from kubernetes_tpu_torch.scheduler.preemption_device import (
    ORACLE_FALLBACK,
    DevicePreemptionPlanner,
)
from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

# the module, not its classes: a test class imported here would be
# collected (and run) a second time
from . import test_preemption_fast as fast
from .test_torch_encoding import _port_obj


def _port_backend(nodes, pods, **kw):
    """The port's CPU backend with the what-if on (the CPU default is
    off), the cluster mirrored in through the cache-listener hooks."""
    b = TPUBackend(device="cpu", **kw)
    b.whatif = True
    for n in nodes:
        b.on_add_node(n)
    for p in pods:
        b.on_add_pod(p, p.spec.node_name)
    return b


def _pa(backend, pod):
    return {k: a for k, a in backend.pe.encode(pod).items()
            if not k.startswith("_")}


def _anti(labels, key=v1.LABEL_HOSTNAME):
    return v1.Affinity(pod_anti_affinity=v1.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=[
            v1.PodAffinityTerm(
                label_selector=v1.LabelSelector(match_labels=labels),
                topology_key=key)]))


def _aff(labels, key="zone"):
    return v1.Affinity(pod_affinity=v1.PodAffinity(
        required_during_scheduling_ignored_during_execution=[
            v1.PodAffinityTerm(
                label_selector=v1.LabelSelector(match_labels=labels),
                topology_key=key)]))


def _spread(labels, skew=1):
    return [v1.TopologySpreadConstraint(
        max_skew=skew, topology_key="zone",
        when_unsatisfiable="DoNotSchedule",
        label_selector=v1.LabelSelector(match_labels=labels))]


# ---------------------------------------------------------------------------
# the program


def _cluster(seed):
    """Ten zoned nodes saturated by labelled low-priority pods (the
    program cases all build on it, so the reference compiles few
    signatures)."""
    rng = random.Random(seed)
    nodes = [make_node(f"n{i}", cpu="4", memory="16Gi", pods=8,
                       labels={"zone": f"z{i % 3}",
                               v1.LABEL_HOSTNAME: f"n{i}"})
             for i in range(10)]
    pods = []
    for i in range(10):
        for j in range(rng.randint(1, 4)):
            pods.append(make_pod(
                f"p{i}-{j}", cpu=f"{rng.choice([500, 900, 1500])}m",
                memory="64Mi", node_name=f"n{i}", priority=1,
                labels={"app": rng.choice(["x", "y"])}))
    return nodes, pods


def _preemptor(kind):
    pod = make_pod("hi", cpu="1500m", memory="64Mi", priority=100,
                   labels={"app": "x"})
    if kind == "ipa":
        pod.spec.affinity = v1.Affinity(
            pod_affinity=_aff({"app": "x"}).pod_affinity,
            pod_anti_affinity=_anti({"app": "y"}).pod_anti_affinity)
    elif kind == "ipa-self":
        # affinity toward its own label, which no pod carries yet: the
        # first-pod escape (aff_total == 0 and the pod matches itself)
        pod.metadata.labels = {"app": "z"}
        pod.spec.affinity = _aff({"app": "z"})
    elif kind == "spread":
        pod.spec.topology_spread_constraints = _spread({"app": "x"})
    elif kind == "ports":
        pod.spec.containers[0].ports = [v1.ContainerPort(
            host_port=8080, container_port=8080)]
    return pod


def _random_inputs(rng, ctx, nps, host, L, gang, has_nom, drain=True):
    """Seeded victim slots, nominated aggregates and claimed drains (zero
    without `drain`) in the planner's numpy layout, for a context of
    either package."""
    n = ctx.n_lanes
    alloc = np.asarray(host["alloc"])
    r = alloc.shape[1]
    c = nps["f_same_key"].shape[0]
    taa = nps["ipaaa_valid"].shape[0]
    vnp = ctx.vnp
    valid = rng.random((n, L)) < 0.75
    valid[:, -1] = False                       # a padded slot
    cnt = valid.astype(np.int64)
    if gang:
        cnt = np.where(valid, rng.integers(1, 4, (n, L)), 0)
    req = np.where(valid[..., None],
                   rng.integers(0, alloc[:, None, :] // 3 + 1, (n, L, r)), 0)
    v = {
        "valid": valid, "cnt": cnt.astype(np.int64),
        "req": req.astype(np.int64),
        "mfs": np.where(valid[..., None], rng.integers(0, 3, (n, L, c)),
                        0).astype(np.int32),
        "manti": np.where(valid[..., None], rng.integers(0, 2, (n, L, taa)),
                          0).astype(np.int32),
        "mall": np.where(valid, rng.integers(0, 2, (n, L)), 0
                         ).astype(np.int32),
    }
    nom = {
        "req": (rng.integers(0, alloc // 4 + 1, (n, r))
                * (rng.random((n, 1)) < 0.3)).astype(np.int64),
        "cnt": rng.integers(0, 2, n).astype(np.int64),
        "mfs": rng.integers(0, 3, (n, c)).astype(np.int32),
        "manti": rng.integers(0, 2, (n, taa)).astype(np.int32),
        "mall": rng.integers(0, 2, n).astype(np.int32),
        "has_nom": has_nom,
    }
    pre = {
        "req": (rng.integers(0, alloc // 5 + 1, (n, r))
                * (rng.random((n, 1)) < 0.3)).astype(np.int64),
        "cnt": rng.integers(0, 2, n).astype(np.int64),
        "shared": rng.integers(0, 3, (c, vnp)).astype(np.int32),
        "anti": rng.integers(0, 2, (taa, vnp)).astype(np.int32),
        "aff": rng.integers(0, 2, vnp).astype(np.int32),
    }
    if not drain:
        pre = {k: np.zeros_like(a) for k, a in pre.items()}
    pre["shared"][:, 0] = 0
    pre["anti"][:, 0] = 0
    pre["aff"][0] = 0
    pre["atot"] = np.int32(pre["aff"].sum())
    return v, nom, pre


def _contexts(kind, seed=0):
    nodes, pods = _cluster(seed)
    pending = _preemptor(kind)
    rb = fast._mk_backend(nodes, pods)
    pb = _port_backend([_port_obj(o) for o in nodes],
                       [_port_obj(o) for o in pods])
    rpa, ppa = _pa(rb, pending), _pa(pb, _port_obj(pending))
    rctx = ref_whatif.WhatifContext.from_encoding(rb.enc, rpa)
    pctx = whatif.WhatifContext.from_encoding(pb.enc, ppa, device="cpu")
    return rb, pb, rctx, pctx, rpa, ppa


@pytest.mark.parametrize("kind,has_nom,gang", [
    ("plain", False, False), ("plain", True, True),
    ("ipa", False, False), ("ipa", True, False), ("ipa", True, True),
    ("ipa-self", False, False), ("ipa-self", True, True),
    ("spread", False, True), ("spread", True, False),
    ("ports", True, False),
])
def test_whatif_run_matches_reference(kind, has_nom, gang):
    rb, pb, rctx, pctx, rpa, ppa = _contexts(kind)
    assert pctx.dyn_ipa == rctx.dyn_ipa == kind.startswith("ipa")
    assert pctx.dyn_ports == rctx.dyn_ports == (kind == "ports")
    assert pctx.n_lanes == rctx.n_lanes and pctx.vnp == rctx.vnp
    tj = pctx.template_index(ppa)
    assert tj == rctx.template_index(rpa)
    nps = rctx.np_slices(tj)
    host = rb.enc.host_snapshot()
    seen = set()
    for seed in range(6):
        rng = np.random.default_rng(1000 * seed + len(kind))
        v, nom, pre = _random_inputs(rng, rctx, nps, host, 8, gang, has_nom,
                                     drain=seed % 2 == 1)
        want = rctx.run(tj, v, nom, pre)
        got = outputs(pctx.run(tj, v, nom, pre))
        for key in ("fits_now", "base", "victims"):
            w = np.asarray(want[key])
            g = got[key].numpy()
            assert g.dtype == np.bool_ and g.shape == w.shape, key
            assert np.array_equal(g, w), (key, seed)
        seen.update(("base", bool(b)) for b in np.asarray(want["base"]))
        vm = np.asarray(want["victims"])
        seen.add(("victim", bool(vm.any())))
        seen.add(("reprieve", bool((v["valid"] & ~vm).any())))
    # the inputs exercise both verdicts of the walk
    assert {("base", True), ("base", False), ("victim", True),
            ("reprieve", True)} <= seen


def _assert_same_run(rctx, pctx, tj, v, nom, pre):
    want = rctx.run(tj, v, nom, pre)
    got = outputs(pctx.run(tj, v, nom, pre))
    for key in ("fits_now", "base", "victims"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    return {k: np.asarray(a) for k, a in want.items()}


def test_whatif_run_pts_tied_minimum():
    """Claimed drains level the three zones' match counts (a tie at the
    global minimum) and every node carries a nominated match: base
    feasibility then turns on the minimum with the node's own pair
    excluded, which a tie keeps at the minimum."""
    rb, pb, rctx, pctx, rpa, ppa = _contexts("spread")
    tj = rctx.template_index(rpa)
    nps = rctx.np_slices(tj)
    host = rb.enc.host_snapshot()
    rng = np.random.default_rng(11)
    v, nom, pre = _random_inputs(rng, rctx, nps, host, 4, False, True,
                                 drain=False)
    nodes, pods = _cluster(0)
    zone = {n.metadata.name: n.metadata.labels["zone"] for n in nodes}
    counts = dict.fromkeys(zone.values(), 0)
    for p in pods:
        if p.metadata.labels["app"] == "x":
            counts[zone[p.spec.node_name]] += 1
    lo = min(counts.values())
    for n in nodes:
        lane = rb.enc.node_index[n.metadata.name]
        pre["shared"][0, nps["f_pair_cn"][lane, 0]] = \
            counts[zone[n.metadata.name]] - lo
    # every slot frees a whole node's capacity and moves no match
    v["valid"][:, :2] = True
    v["cnt"] = v["valid"].astype(np.int64)
    v["req"][:, :2] = np.asarray(host["alloc"])[:, None, :]
    v["mfs"][:] = 0
    nom["req"][:] = 0
    nom["cnt"][:] = 0
    nom["mfs"][:, 0] = 1
    out = _assert_same_run(rctx, pctx, tj, v, nom, pre)
    n = len(nodes)
    assert not out["base"][:n].any()
    nom["mfs"][:] = 0
    out = _assert_same_run(rctx, pctx, tj, v, nom, pre)
    assert out["base"][:n].all()


def test_whatif_run_first_pod_escape():
    """An affinity preemptor whose term no pod matches but itself: it
    fits while the effective term total is 0, so claimed drains of the
    total (pre atot) and evicted matches (mall) decide base."""
    rb, pb, rctx, pctx, rpa, ppa = _contexts("ipa-self")
    tj = rctx.template_index(rpa)
    nps = rctx.np_slices(tj)
    host = rb.enc.host_snapshot()
    rng = np.random.default_rng(12)
    v, nom, pre = _random_inputs(rng, rctx, nps, host, 4, False, False,
                                 drain=False)
    v["valid"][:, :2] = True
    v["cnt"] = v["valid"].astype(np.int64)
    v["req"][:, :2] = np.asarray(host["alloc"])[:, None, :]
    v["manti"][:] = 0
    v["mall"][:] = 0
    n = len(_cluster(0)[0])
    assert _assert_same_run(rctx, pctx, tj, v, nom, pre)["base"][:n].all()
    pre["atot"] = np.int32(-1)
    assert not _assert_same_run(rctx, pctx, tj, v, nom, pre)["base"].any()
    v["mall"][:, 0] = 1
    pre["atot"] = np.int32(0)
    assert not _assert_same_run(rctx, pctx, tj, v, nom, pre)["base"].any()


def test_whatif_run_singleton_slots_default_count():
    """v without "cnt": singleton slots count one member each, in both
    packages."""
    rb, pb, rctx, pctx, rpa, ppa = _contexts("plain", seed=1)
    tj = rctx.template_index(rpa)
    rng = np.random.default_rng(5)
    v, nom, pre = _random_inputs(rng, rctx, rctx.np_slices(tj),
                                 rb.enc.host_snapshot(), 4, False, False)
    del v["cnt"]
    want = rctx.run(tj, v, nom, pre)
    got = outputs(pctx.run(tj, v, nom, pre))
    for key in ("fits_now", "base", "victims"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


def test_walk_wrapper_routes_cpu_to_plain():
    """whatif_device on CPU tensors is its plain version (no launch): the
    torch prologue, then the reference's walk, on the packed inputs."""
    from kubernetes_tpu_torch.ops import whatif_kernel

    rb, pb, rctx, pctx, rpa, ppa = _contexts("spread", seed=2)
    tj = pctx.template_index(ppa)
    sess = pctx._sess
    rng = np.random.default_rng(3)
    v, nom, pre = _random_inputs(rng, rctx, rctx.np_slices(tj),
                                 rb.enc.host_snapshot(), 4, True, True)
    tab, d, any_f = pctx.tables(tj)
    dims = whatif_kernel.launch_dims(d, 4, True, any_f)
    buf = np.zeros(whatif_kernel.layout(dims)[1], np.uint8)
    whatif_kernel.pack(v, nom, pre, dims, buf)
    before = whatif_kernel.LAUNCHES, whatif_kernel.CONTEXT_LAUNCHES
    got = outputs(whatif_device(tab, torch.from_numpy(buf), dims))
    assert (whatif_kernel.LAUNCHES, whatif_kernel.CONTEXT_LAUNCHES) == before
    # the torch prologue from the session's tables, nothing cached
    tab0 = whatif_kernel.tables(sess._S, sess._c_static, pctx.carry, tj,
                                False, False)
    tab0.update(whatif_kernel.context_reference(tab0, d))
    p = whatif_kernel.lane_prologue(tab0, {
        f"pre_{k}": torch.from_numpy(np.asarray(a)).reshape(
            (1,) if k == "atot" else np.shape(a))
        for k, a in pre.items()}, False)
    vt = {k: torch.from_numpy(a) for k, a in v.items()}
    nt = {k: torch.from_numpy(np.asarray(a)) for k, a in nom.items()
          if k != "has_nom"}
    plain = whatif_walk_reference(p, vt, nt, has_nom=True, dyn_ipa=False)
    for key in ("fits_now", "base", "victims"):
        assert torch.equal(got[key], plain[key]), key


@pytest.mark.parametrize("kind,has_nom", [
    ("plain", False), ("ipa", True), ("ipa-self", False), ("spread", True),
    ("ports", False),
])
def test_walk_inputs_match_kernel_specs(kind, has_nom, monkeypatch):
    """What the planner's launch hands `whatif_device` is what the CUDA
    kernels read: every table and invariant of the specs present, of its
    dtype and shape, and contiguous, the packed buffer of the layout's
    size, and every dim the kernels take (the wrapper raises on anything
    else on the card)."""
    from kubernetes_tpu_torch.ops import whatif_kernel

    rb, pb, rctx, pctx, rpa, ppa = _contexts(kind, seed=3)
    tj = pctx.template_index(ppa)
    rng = np.random.default_rng(4)
    v, nom, pre = _random_inputs(rng, rctx, rctx.np_slices(tj),
                                 rb.enc.host_snapshot(), 8, True, has_nom)
    seen = []

    def capture(tab, buf, d):
        seen.append((tab, buf, d))
        return whatif_device(tab, buf, d)

    monkeypatch.setattr(whatif, "whatif_device", capture)
    pctx.run(tj, v, nom, pre)
    ((tab, buf, d),) = seen
    assert d["dyn_ipa"] == kind.startswith("ipa")
    assert d["has_nom"] == has_nom and set(whatif_kernel.DIMS) <= set(d)
    specs = dict(whatif_kernel._table_specs(d), **whatif_kernel._inv_specs(d))
    assert set(specs) <= set(whatif_kernel.PTRS)
    for name, (dtype, shape) in specs.items():
        t = tab[name]
        assert (t.dtype, tuple(t.shape)) == (dtype, shape), name
        assert t.is_contiguous(), name
    assert buf.dtype == torch.uint8
    assert tuple(buf.shape) == (whatif_kernel.layout(d)[1],)
    whatif_kernel.check(dict(tab, inp=buf), dict(
        specs, inp=(torch.uint8, (whatif_kernel.layout(d)[1],))), "cpu")


@pytest.mark.parametrize("kind", ["plain", "ports"])
def test_gang_fits_matches_reference(kind):
    rb, pb, rctx, pctx, rpa, ppa = _contexts(kind, seed=3)
    tj = rctx.template_index(rpa)
    answers = set()
    for k in (0, 1, 2, 3, 5, 8, 13, 40):
        want = rctx.gang_fits(tj, k)
        assert pctx.gang_fits(tj, k) == want, k
        answers.add(want)
    assert answers == {True, False}


def test_ipa_victim_matches_np_matches_reference():
    rb, pb, rctx, pctx, rpa, ppa = _contexts("ipa", seed=4)
    tj = rctx.template_index(rpa)
    rn, pn = rctx.np_slices(tj), pctx.np_slices(tj)
    nodes, pods = _cluster(4)
    rows_r = [rb._pod_self_rows(p) for p in pods]
    rows_p = [pb._pod_self_rows(_port_obj(p)) for p in pods]
    want = ref_whatif.ipa_victim_matches_np(rn, rows_r)
    got = whatif.ipa_victim_matches_np(pn, rows_p)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert want[0].any() and want[1].any() and not want[1].all()
    empty = whatif.ipa_victim_matches_np(pn, [])
    assert empty[0].shape == (0, rn["ipaaa_valid"].shape[0])


@pytest.mark.parametrize("kind", ["plain", "ipa"])
def test_np_slices_and_template_index_match_reference(kind):
    rb, pb, rctx, pctx, rpa, ppa = _contexts(kind, seed=5)
    tj = pctx.template_index(ppa)
    assert tj == rctx.template_index(rpa) == 0
    rn, pn = rctx.np_slices(tj), pctx.np_slices(tj)
    assert set(rn) == set(pn)
    for k, a in rn.items():
        assert pn[k].dtype == a.dtype and np.array_equal(pn[k], a), k
    assert pctx.np_slices(tj) is pn  # cached
    assert np.array_equal(pctx.pok_np(), rctx.pok_np())
    other = _pa(pb, _port_obj(make_pod("other", cpu="3", priority=100,
                                       labels={"app": "z"})))
    with pytest.raises(whatif.WhatifUnavailable) as e:
        pctx.template_index(other)
    assert e.value.reason == "template"


def test_slot_bucket_matches_reference():
    for n in (0, 1, 3, 4, 5, 8, 9, 17, 100):
        assert whatif.slot_bucket(n) == ref_whatif.slot_bucket(n)


# ---------------------------------------------------------------------------
# the planner


def _key(c):
    if c is None:
        return None
    if c is REF_ORACLE or c is ORACLE_FALLBACK:
        return "oracle"
    return (c.node_name, [p.metadata.name for p in c.victims],
            c.num_pdb_violations)


def _plan_both(nodes, pods, wave, pdbs=None, nominated=(), elig=None,
               fast_ok=False, ref_backend=None, port_backend=None):
    """The same wave through the reference's planner and the port's, each
    on its own package's objects. -> ((ref planner, keys),
    (port planner, keys))."""
    out = []
    for port in (False, True):
        conv = _port_obj if port else (lambda o: o)
        ns, ps = [conv(o) for o in nodes], [conv(o) for o in pods]
        w = [conv(o) for o in wave]
        pd = [conv(o) for o in pdbs] if pdbs else None
        snap = (Snapshot if port else RefSnapshot).from_objects(ps, ns)
        nom = (PodNominator if port else RefNominator)()
        for pod, node in nominated:
            nom.add_nominated_pod(conv(pod), node)
        backend = (port_backend if port else ref_backend) or (
            _port_backend(ns, ps) if port else fast._mk_backend(ns, ps))
        mod = port_v1 if port else v1
        el = {mod.pod_key(p): (elig[k] if elig else (True, fast_ok))
              for k, p in enumerate(w)}
        planner = (DevicePreemptionPlanner if port else RefPlanner)(
            snap, nom, backend, pdbs=pd, eligibility=el)
        cands = planner.plan(w)
        out.append((planner, [_key(c) for c in cands]))
    return out


def _assert_same_plan(ref, got, paths=None):
    (rp, rk), (pp, pk) = ref, got
    assert pp.planner_paths == rp.planner_paths
    if paths is not None:
        assert pp.planner_paths == paths
    assert pp.fits_now == rp.fits_now
    assert pk == rk
    return rk


def _pending(rng):
    return make_pod("high", cpu=f"{rng.choice([1000, 2500, 3500, 9000])}m",
                    memory="1Gi", priority=100)


@pytest.mark.parametrize("seed", [7, 8])
def test_planner_random_clusters(seed):
    rng = random.Random(seed)
    cands = 0
    for _ in range(10):
        nodes, pods = fast._random_cluster(rng, rng.randint(3, 10))
        keys = _assert_same_plan(*_plan_both(nodes, pods, [_pending(rng)]),
                                 paths=["device"])
        cands += keys[0] is not None
    assert cands >= 1


def test_planner_with_pdbs():
    helper = fast.TestPDBParityFuzz()
    rng = random.Random(33)
    violations = 0
    for _ in range(10):
        nodes, pods, pdbs = helper._random_pdb_cluster(rng, rng.randint(3, 8))
        (keys,) = [_assert_same_plan(*_plan_both(
            nodes, pods, [_pending(rng)], pdbs=pdbs), paths=["device"])]
        violations += bool(keys[0] and keys[0][2])
    assert violations >= 1


def test_planner_with_nominated_load():
    rng = random.Random(11)
    cands = 0
    for _ in range(8):
        nodes, pods = fast._random_cluster(rng, rng.randint(2, 6))
        ghost = make_pod("ghost", cpu="2", memory="1Gi", priority=100)
        where = nodes[rng.randrange(len(nodes))].metadata.name
        pending = make_pod("high", cpu="2500m", memory="1Gi", priority=100)
        keys = _assert_same_plan(*_plan_both(
            nodes, pods, [pending], nominated=[(ghost, where)]),
            paths=["device"])
        cands += keys[0] is not None
    assert cands >= 1


def test_planner_wave_claims_and_nominates():
    """An 8-pod wave on one set of books: later preemptors plan against
    the claims and nominations of earlier ones (the pre_* drains and the
    nominated aggregates reach the program)."""
    nodes = [make_node(f"n{i}", cpu="4", pods=10,
                       labels={"zone": f"z{i % 2}"}) for i in range(6)]
    pods = [make_pod(f"low-{i}-{j}", cpu="900m", memory="64Mi",
                     node_name=f"n{i}", priority=1,
                     labels={"app": "victim"})
            for i in range(6) for j in range(4)]
    wave = [make_pod(f"hi-{k}", cpu="1900m", memory="64Mi", priority=100,
                     labels={"app": "victim"}, affinity=_aff(
                         {"app": "victim"}))
            for k in range(8)]
    keys = _assert_same_plan(*_plan_both(nodes, pods, wave),
                             paths=["device"] * 8)
    assert sum(k is not None for k in keys) >= 4


class TestEnvelope:
    """tests/test_preemption_fast.py TestDeviceEnvelope's preemptors
    (outside the numpy envelope) through both planners."""

    def test_anti_affinity_preemptor(self):
        nodes = [make_node("n0", cpu="4", pods=10, labels={"zone": "z0"})]
        pods = [make_pod("vx", cpu="3500m", node_name="n0", priority=1,
                         labels={"app": "x"})]
        pending = make_pod("hi", cpu="1", priority=100,
                           affinity=_anti({"app": "x"}))
        keys = _assert_same_plan(*_plan_both(nodes, pods, [pending]),
                                 paths=["device"])
        assert keys == [("n0", ["vx"], 0)]

    @pytest.mark.parametrize("anchor_prio", [1, 200])
    def test_affinity_preemptor(self, anchor_prio):
        nodes = [make_node("n0", cpu="4", pods=10, labels={"zone": "z0"})]
        pods = [
            make_pod("anchor", cpu="1900m", node_name="n0",
                     priority=anchor_prio, labels={"app": "y"}),
            make_pod("vz", cpu="1900m", node_name="n0", priority=1,
                     labels={"app": "z"}),
        ]
        pending = make_pod("hi", cpu="1900m", priority=100,
                           affinity=_aff({"app": "y"}))
        keys = _assert_same_plan(*_plan_both(nodes, pods, [pending]),
                                 paths=["device"])
        assert keys == ([None] if anchor_prio == 1 else
                        [("n0", ["vz"], 0)])

    def test_spread_preemptor(self):
        nodes = [make_node(f"n{i}", cpu="4", pods=10,
                           labels={"zone": f"z{i}"}) for i in range(2)]
        pods = [
            make_pod("s0", cpu="3700m", node_name="n0", priority=1,
                     labels={"app": "s"}),
            make_pod("s1", cpu="500m", node_name="n1", priority=1,
                     labels={"app": "s"}),
            make_pod("f1", cpu="3300m", node_name="n1", priority=1,
                     labels={"app": "f"}),
        ]
        pending = make_pod("hi", cpu="1", priority=100, labels={"app": "s"},
                           constraints=_spread({"app": "s"}))
        keys = _assert_same_plan(*_plan_both(nodes, pods, [pending]),
                                 paths=["device"])
        assert keys == [("n0", ["s0"], 0)]

    def test_spread_fuzz(self):
        rng = random.Random(91)
        cands = 0
        for _ in range(10):
            zones = [f"z{i}" for i in range(rng.randint(2, 3))]
            nodes = [make_node(f"n{i}", cpu=str(rng.choice([2, 4])), pods=8,
                               labels={"zone": zones[i % len(zones)]})
                     for i in range(rng.randint(3, 6))]
            pods = [make_pod(f"p{i}-{j}",
                             cpu=f"{rng.choice([900, 1500, 1900])}m",
                             node_name=n.metadata.name,
                             priority=rng.choice([0, 1, 5]),
                             labels={"app": rng.choice(["s", "t"])})
                    for i, n in enumerate(nodes)
                    for j in range(rng.randint(1, 3))]
            pending = make_pod("hi", cpu="1500m", priority=100,
                               labels={"app": "s"},
                               constraints=_spread({"app": "s"}))
            keys = _assert_same_plan(*_plan_both(nodes, pods, [pending]),
                                     paths=["device"])
            cands += keys[0] is not None
        assert cands >= 2


class TestGangUnits:
    """TestGangVictimParity's clusters: co-located gang members are one
    eviction unit (v_cnt > 1 slots)."""

    def test_gang_fuzz(self):
        helper = fast.TestGangVictimParity()
        rng = random.Random(19)
        gang_evictions = 0
        for _ in range(12):
            nodes, pods, gangs = helper._random_gang_cluster(
                rng, rng.randint(3, 9))
            pending = make_pod("high",
                               cpu=f"{rng.choice([2500, 3500, 9000])}m",
                               memory="1Gi", priority=100)
            (keys,) = [_assert_same_plan(*_plan_both(nodes, pods, [pending]),
                                         paths=["device"])]
            if keys[0] is not None:
                names = set(keys[0][1])
                gang_evictions += sum(
                    bool(names & set(m)) for m, _ in gangs.values())
        assert gang_evictions >= 1

    @pytest.mark.parametrize("prios", [(200, 1, 1), (1, 1)])
    def test_directed_gang(self, prios):
        nodes = [make_node("n0", cpu="4", memory="16Gi", pods=110)]
        pods = []
        cpu = "1200m" if len(prios) == 3 else "1500m"
        for j, prio in enumerate(prios):
            p = make_pod(f"g0-{j}", cpu=cpu, memory="256Mi",
                         node_name="n0", priority=prio)
            fast.TestGangVictimParity._stamp(p, "gang-x", len(prios))
            pods.append(p)
        pending = make_pod("high", cpu="2", memory="1Gi", priority=100)
        keys = _assert_same_plan(*_plan_both(nodes, pods, [pending]),
                                 paths=["device"])
        assert keys == ([None] if len(prios) == 3 else
                        [("n0", ["g0-0", "g0-1"], 0)])


class TestLadder:
    """TestDeviceLadder's cases on the port's backend."""

    def _saturated(self, n, per):
        nodes = [make_node(f"n{i}", cpu="4", pods=10) for i in range(n)]
        pods = [make_pod(f"low-{i}-{j}", cpu="900m", memory="64Mi",
                         node_name=f"n{i}", priority=1)
                for i in range(n) for j in range(per)]
        return nodes, pods

    def test_kill_switch_falls_to_fast(self):
        nodes = [make_node("n0", cpu="4", pods=10)]
        pods = [make_pod("low", cpu="3500m", node_name="n0", priority=1)]
        rb = fast._mk_backend(nodes, pods)
        pb = _port_backend([_port_obj(o) for o in nodes],
                           [_port_obj(o) for o in pods])
        rb.whatif = pb.whatif = False   # KTPU_WHATIF=0
        pending = make_pod("hi", cpu="2", priority=100)
        keys = _assert_same_plan(*_plan_both(
            nodes, pods, [pending], fast_ok=True, ref_backend=rb,
            port_backend=pb), paths=["fast"])
        assert keys == [("n0", ["low"], 0)]

    def test_injected_fault_falls_to_fast_no_double_claim(self):
        from kubernetes_tpu_torch.scheduler.metrics import session_rebuilds
        from kubernetes_tpu_torch.testing.faults import FaultInjector

        nodes, pods = self._saturated(3, 4)
        pb = _port_backend([_port_obj(o) for o in nodes],
                           [_port_obj(o) for o in pods])
        inj = FaultInjector()
        inj.arm("raise-whatif", shots=1)
        pb.faults = inj
        r0 = sum(v for _, v in session_rebuilds.items())
        wave = [make_pod(f"hi-{k}", cpu="900m", memory="64Mi", priority=100)
                for k in range(3)]
        (rp, rk), (pp, pk) = _plan_both(nodes, pods, wave, fast_ok=True,
                                        port_backend=pb)
        assert pp.planner_paths == ["fast", "device", "device"]
        assert inj.injected.get("raise-whatif") == 1
        assert all(k is not None for k in pk)
        victims = [v for k in pk for v in k[1]]
        assert len(victims) == len(set(victims)), "double-claimed victim"
        # the fast rung plans on the same books: the same wave as the
        # reference's all-device one
        assert pk == rk
        assert sum(v for _, v in session_rebuilds.items()) == r0
        assert pb.ladder.mode() == "hoisted"

    def test_fault_on_device_only_pod_falls_to_oracle_sentinel(self):
        from kubernetes_tpu_torch.testing.faults import FaultInjector

        nodes = [make_node("n0", cpu="4", pods=10)]
        pods = [make_pod("low", cpu="3500m", node_name="n0", priority=1,
                         labels={"app": "x"})]
        pb = _port_backend([_port_obj(o) for o in nodes],
                           [_port_obj(o) for o in pods])
        inj = FaultInjector()
        inj.arm("raise-whatif", shots=1)
        pb.faults = inj
        pending = make_pod("hi", cpu="2", priority=100,
                           affinity=_anti({"app": "x"}))
        (rp, rk), (pp, pk) = _plan_both(nodes, pods, [pending],
                                        port_backend=pb)
        assert pk == ["oracle"] and pp.planner_paths == ["oracle"]
        assert pp.fits_now == [False]
        assert rk == [("n0", ["low"], 0)]

    @pytest.mark.parametrize("raised", ["kernel", "cuda"])
    def test_kernel_error_propagates(self, raised, monkeypatch):
        """A what-if kernel that fails (a build, input or launch error of
        the wrapper, or any error the launch path meets) raises out of
        the planner: no rung plans the pod, no fallback or device fault
        is counted, and the ladder stays where it was."""
        from kubernetes_tpu_torch.ops.whatif_kernel import WhatifKernelError
        from kubernetes_tpu_torch.scheduler.metrics import (
            device_faults,
            whatif_fallbacks,
        )

        nodes, pods = self._saturated(3, 4)
        pb = _port_backend([_port_obj(o) for o in nodes],
                           [_port_obj(o) for o in pods])

        def fail(*args, **kwargs):
            if raised == "kernel":
                raise WhatifKernelError("what-if kernel launch failed")
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(whatif, "whatif_device", fail)
        f0 = sum(v for _, v in whatif_fallbacks.items())
        d0 = sum(v for _, v in device_faults.items())
        mode = pb.ladder.mode()
        wave = [_port_obj(make_pod("hi", cpu="900m", memory="64Mi",
                                   priority=100))]
        snap = Snapshot.from_objects([_port_obj(o) for o in pods],
                                     [_port_obj(o) for o in nodes])
        planner = DevicePreemptionPlanner(
            snap, PodNominator(), pb,
            eligibility={port_v1.pod_key(wave[0]): (True, True)})
        with pytest.raises(WhatifKernelError):
            planner.plan(wave)
        assert planner.planner_paths == []
        assert sum(v for _, v in whatif_fallbacks.items()) == f0
        assert sum(v for _, v in device_faults.items()) == d0
        assert pb.ladder.mode() == mode

    def test_live_session_scratch_snapshot(self):
        """A live HoistedSession holding the preemptor's template: the
        context clones ITS carry (no snapshot build) and planning leaves
        the session standing."""
        from kubernetes_tpu_torch.ops.hoisted import HoistedSession
        from kubernetes_tpu_torch.scheduler.metrics import session_rebuilds

        nodes, pods = self._saturated(4, 4)
        pb = _port_backend([_port_obj(o) for o in nodes],
                           [_port_obj(o) for o in pods])
        probe = _port_obj(make_pod("probe", cpu="900m", memory="64Mi",
                                   priority=100))
        (res,) = pb.schedule_many([probe])
        assert res[1] is None  # saturated by design
        sess = pb._session
        assert isinstance(sess, HoistedSession)
        r0 = sum(v for _, v in session_rebuilds.items())
        pending = make_pod("hi", cpu="900m", memory="64Mi", priority=100)
        keys = _assert_same_plan(*_plan_both(nodes, pods, [pending],
                                             port_backend=pb),
                                 paths=["device"])
        assert keys[0] is not None
        ctx = pb.whatif_context(_pa(pb, _port_obj(pending)))
        assert ctx._sess is pb._session is sess
        assert ctx.carry["requested"] is not sess._carry["requested"]
        assert pb.whatif_builds == 0
        assert sum(v for _, v in session_rebuilds.items()) == r0

    def test_kernel_session_routes_through_encoding_snapshot(self):
        """With the kernel rung's ScanSession live, the context is a
        snapshot view, built once per encoding version and template."""
        from kubernetes_tpu_torch.ops.scan import ScanSession

        nodes, pods = self._saturated(3, 4)
        pb = _port_backend([_port_obj(o) for o in nodes],
                           [_port_obj(o) for o in pods], use_kernel=True)
        probe = _port_obj(make_pod("probe", cpu="900m", memory="64Mi",
                                   priority=100))
        pb.schedule_many([probe])
        sess = pb._session
        assert isinstance(sess, ScanSession)
        pending = make_pod("hi", cpu="900m", memory="64Mi", priority=100)
        _assert_same_plan(*_plan_both(nodes, pods, [pending],
                                      port_backend=pb), paths=["device"])
        pa = _pa(pb, _port_obj(pending))
        ctx = pb.whatif_context(pa)
        assert ctx._sess is not sess and pb._session is sess
        assert pb.whatif_context(pa) is ctx
        assert pb.whatif_builds == 1 and pb.whatif_build_s > 0


def test_backend_whatif_defaults(monkeypatch):
    """The CPU default is off, KTPU_WHATIF=1 turns it on; gang_feasible
    answers through the what-if path then, None without it."""
    monkeypatch.delenv("KTPU_WHATIF", raising=False)
    nodes = [_port_obj(make_node(f"n{i}", cpu="4", pods=10))
             for i in range(2)]
    b = TPUBackend(device="cpu")
    assert not b.whatif and not b.whatif_enabled()
    for n in nodes:
        b.on_add_node(n)
    gang = _port_obj(make_pod("g", cpu="3", priority=1))
    assert b.gang_feasible(gang, 2) is None
    with pytest.raises(whatif.WhatifUnavailable):
        b.whatif_context(_pa(b, gang))
    monkeypatch.setenv("KTPU_WHATIF", "1")
    b = TPUBackend(device="cpu")
    assert b.whatif and b.whatif_enabled()
    for n in nodes:
        b.on_add_node(n)
    assert b.gang_feasible(gang, 2) is True
    assert b.gang_feasible(gang, 3) is False
