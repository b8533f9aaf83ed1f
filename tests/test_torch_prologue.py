"""The port's per-template prologue (ops/hoisted.py in torch, built on
its ops/kernel.py and ops/eval.py) equals the reference's, key by key in
dtype and value, on the session shapes of tests/test_pallas_scan.py and
on fuzzed clusters whose existing pods carry affinity terms."""

import copy
import random

import numpy as np
import pytest

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.ops.hoisted import _session_prologue as ref_prologue
from kubernetes_tpu.ops.hoisted import _stack_templates as ref_stack
from kubernetes_tpu.ops.hoisted import template_fingerprint
from kubernetes_tpu.testing.synth import synth_cluster, synth_pending_pods
from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
from kubernetes_tpu_torch.ops.hoisted import (
    _session_prologue,
    _stack_templates,
    templates_have_terms,
)

from . import test_pallas_scan as pallas_tests
from .test_hoisted import _encode_all, _presized_encoding
from .test_kernel_parity import random_cluster, random_pending
from .util import make_pod

# TestPallasTerms' helpers (the module, not the class, is imported so
# that pytest does not collect the reference's tests here a second time)
_affinity = pallas_tests._affinity
_nodes = pallas_tests.TestPallasTerms()._nodes
_pref_only_affinity = pallas_tests.TestPallasTerms._pref_only_affinity


def _capacity_nodes():
    nodes, init_pods = synth_cluster(3, pods_per_node=0)
    for node in nodes:
        node.status.allocatable["cpu"] = "350m"
        node.status.capacity["cpu"] = "350m"
    return nodes, init_pods


def _spread(key, action, labels):
    return [v1.TopologySpreadConstraint(
        max_skew=1, topology_key=key, when_unsatisfiable=action,
        label_selector=v1.LabelSelector(match_labels=dict(labels)))]


def _hostname_hard():
    nodes, init_pods = synth_cluster(6, pods_per_node=1)
    pending = [make_pod(f"hard-{i}", cpu="50m", labels={"app": "hard"},
                        constraints=_spread(v1.LABEL_HOSTNAME,
                                            "DoNotSchedule", {"app": "hard"}))
               for i in range(10)]
    return nodes, init_pods, pending


def _mixed_templates():
    nodes, init_pods = synth_cluster(8, pods_per_node=1)
    pending = [make_pod(f"x-{i}", cpu="50m",
                        labels={"tier": "web", "idx": f"t{i % 2}"},
                        constraints=_spread(v1.LABEL_ZONE, "ScheduleAnyway",
                                            {"tier": "web"}))
               for i in range(12)]
    return nodes, init_pods, pending


def _fuzz(seed, keep_terms=False):
    """tests/test_pallas_scan.py TestPallasFuzz style: random nodes,
    existing pods with affinity terms and host ports; pending pods keep
    their spreads, tolerations, selectors and node affinity, without host
    ports (a later slice of the port). keep_terms keeps the pending pods'
    pod (anti-)affinity terms too, as TestPallasFuzz does."""
    rng = random.Random(1000 + seed)
    nodes, init_pods = random_cluster(rng)
    pending = []
    for i in range(10):
        p = random_pending(rng)
        p.metadata.name = f"fz-{seed}-{i}"
        for c in p.spec.containers:
            c.ports = None
        if p.spec.affinity is not None and not keep_terms:
            p.spec.affinity.pod_affinity = None
            p.spec.affinity.pod_anti_affinity = None
        p.spec.node_name = ""
        pending.append(p)
    return nodes, init_pods, pending


def _terms(lbl, affinity, n_nodes=16, n_existing=6, n_pending=24):
    """TestPallasTerms._case: existing bound pods and pending pods share
    one label set and one affinity."""
    nodes = _nodes(n_nodes)
    existing = [make_pod(f"ex-{i}", labels=dict(lbl), affinity=affinity,
                         node_name=f"n-{i * 2}")
                for i in range(n_existing)]
    pending = [make_pod(f"p-{i}", labels=dict(lbl), affinity=affinity)
               for i in range(n_pending)]
    return nodes, existing, pending


def _weight100_preferred(anti):
    """Plain pods mixed with weight-100 preferred zone (anti-)affinity
    pods (the SchedulingPreferredPod(Anti)Affinity template shape)."""
    aff = _pref_only_affinity(100, {"app": "aff"}, anti=anti)
    pending = [make_pod(f"pl-{i}", labels={"app": "aff"}) if i % 3 == 0
               else make_pod(f"pr-{i}", labels={"app": "aff"}, affinity=aff)
               for i in range(18)]
    return _nodes(12), [], pending


def _cross_template_anti():
    """Template A's zone anti terms repel template B pods (which carry
    A's selected label but no terms) assumed in the same session."""
    aff_a = _affinity(zone=True, anti=True, labels={"grp": "x"})
    pending = [make_pod(f"a-{i}", labels={"grp": "x"}, affinity=aff_a)
               if i % 2 == 0 else make_pod(f"b-{i}", labels={"grp": "x"})
               for i in range(16)]
    return _nodes(12), [], pending


# name -> (builder () -> (nodes, init_pods, pending), batch size)
SHAPES = {
    "spread_multi_batch": (
        lambda: synth_cluster(16, pods_per_node=2)
        + (synth_pending_pods(36, spread=True),), 12),
    "no_constraints": (
        lambda: synth_cluster(10, pods_per_node=1)
        + (synth_pending_pods(16, spread=False),), 8),
    "capacity_exhaustion": (
        lambda: _capacity_nodes() + (synth_pending_pods(15, spread=True),), 5),
    "hostname_hard_spread": (_hostname_hard, 5),
    "mixed_templates_cross_counting": (_mixed_templates, 6),
    "tainted_and_labeled_cluster": (
        lambda: synth_cluster(12, pods_per_node=2)
        + (synth_pending_pods(24, spread=True),), 24),
}
# affinity-term templates: the shapes of tests/test_pallas_scan.py
# TestPallasTerms
TERM_SHAPES = {
    "terms_hostname_required_anti": (
        lambda: _terms({"app": "a"}, _affinity(zone=False, anti=True,
                                               labels={"app": "a"})), 10),
    "terms_zone_required_anti": (
        lambda: _terms({"app": "z"}, _affinity(zone=True, anti=True,
                                               labels={"app": "z"})), 10),
    "terms_required_affinity_first_pod_escape": (
        lambda: _terms({"svc": "b"}, _affinity(zone=True, anti=False,
                                               labels={"svc": "b"}),
                       n_existing=0), 10),
    "terms_preferred_score": (
        lambda: _terms({"w": "c"}, _affinity(zone=False, anti=True,
                                             labels={"w": "c"},
                                             pref=(40, {"w": "c"}, True))),
        10),
    "terms_weight100_preferred": (lambda: _weight100_preferred(False), 6),
    "terms_weight100_preferred_anti": (lambda: _weight100_preferred(True), 6),
    "terms_cross_template_anti": (_cross_template_anti, 8),
    "terms_survive_batches": (
        lambda: _terms({"app": "m"}, _affinity(zone=False, anti=True,
                                               labels={"app": "m"}),
                       n_nodes=10, n_existing=0, n_pending=20), 4),
}
SHAPES.update(TERM_SHAPES)
FUZZ_SEEDS = (0, 2, 5)
# TestPallasFuzz seeds whose pending pods keep their (anti-)affinity terms
TERM_FUZZ_SEEDS = (1, 3, 6)
CASES = (list(SHAPES) + [f"fuzz-{s}" for s in FUZZ_SEEDS]
         + [f"fuzzterms-{s}" for s in TERM_FUZZ_SEEDS])


def build_case(name):
    """(reference encoding, pending pod arrays, templates, batch)."""
    if name.startswith("fuzz"):
        kind, seed = name.split("-")
        nodes, init_pods, pending = _fuzz(int(seed),
                                          keep_terms=kind == "fuzzterms")
        batch = 5
    else:
        builder, batch = SHAPES[name]
        nodes, init_pods, pending = builder()
    enc, pe = _presized_encoding(copy.deepcopy(nodes),
                                 copy.deepcopy(init_pods),
                                 copy.deepcopy(pending))
    arrays = _encode_all(enc, pe, pending)
    templates, seen = [], set()
    for a in arrays:
        fp = template_fingerprint(a)
        if fp not in seen:
            seen.add(fp)
            templates.append(a)
    return enc, arrays, templates, batch


@pytest.mark.parametrize("case", CASES)
def test_session_prologue_equals_reference(case):
    """Term-template cases run the dyn_ipa prologue (the affinity mask
    left out of static_mask, its parts and the term gates exposed)."""
    enc, _, templates, _ = build_case(case)
    dyn_ipa = templates_have_terms(templates)
    assert dyn_ipa == (case.startswith("terms_")
                       or case.startswith("fuzzterms-"))
    ref = ref_prologue(enc.device_state(), ref_stack(templates),
                       dyn_ipa=dyn_ipa)
    got = _session_prologue(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                            _stack_templates(templates, "cpu"),
                            dyn_ipa=dyn_ipa)
    assert set(got) == set(ref)
    for k in sorted(ref):
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        assert np.array_equal(a, b), k
