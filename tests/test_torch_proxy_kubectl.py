"""The port's kube-proxy and kubectl (ROADMAP.md Queue 1, 10e:
kubernetes_tpu_torch/proxy/ and kubectl/) hold to the reference's own
cases: those of tests/test_proxy.py (the iptables-style `Proxier`, its
EndpointSlice cache and bounded-frequency runner), tests/test_ipvs.py
(`IPVSTable`, `IPVSProxier`), tests/test_networking.py (NetworkPolicy
evaluation, Ingress, storage classes and the admission around them),
tests/test_kubectl.py, tests/test_gc_rollout.py (rollout history, undo
and the garbage collector through kubectl) and tests/test_metrics_api.py
(`kubectl top`, the HPA on the metrics API) run against each package
through tests/_dual.py.

Every case runs on both packages; `test_pairs_cover_every_case_on_both_packages`
fails if a case is left off either side."""

from __future__ import annotations

import importlib.util

import pytest

from ._dual import PACKAGES, cases, run_case

MODULES = ("test_proxy", "test_ipvs", "test_networking", "test_kubectl",
           "test_gc_rollout", "test_metrics_api")
CASES = [c for m in MODULES for c in cases(m)]
PAIRS = [(c, p) for c in CASES for p in PACKAGES]


@pytest.mark.parametrize("case,package", PAIRS,
                         ids=[f"{c.id}-{p}" for c, p in PAIRS])
def test_reference_case(case, package, request):
    run_case(request, package, case)


def test_pairs_cover_every_case_on_both_packages():
    per_module = {m: sum(c.module == m for c in CASES) for m in MODULES}
    assert per_module == {"test_proxy": 9, "test_ipvs": 7,
                          "test_networking": 27, "test_kubectl": 46,
                          "test_gc_rollout": 5, "test_metrics_api": 2}
    assert len(CASES) == 96
    assert sorted((c.id, p) for c, p in PAIRS) == sorted(
        (c.id, p) for c in CASES for p in PACKAGES)
    for mod in ("proxy.endpointslicecache", "proxy.proxier", "proxy.ipvs",
                "proxy.netpol", "kubectl.cli"):
        assert importlib.util.find_spec(
            f"kubernetes_tpu_torch.{mod}") is not None
