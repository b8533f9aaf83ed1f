"""The port's kubelet and kubemark (ROADMAP.md Queue 1, 10d:
kubernetes_tpu_torch/kubelet/ and kubemark/) hold to the reference's own
cases: those of tests/test_kubelet.py (registration, the sync loop, pod
workers, PLEG, heartbeats and leases, eviction, kubemark),
tests/test_cm.py (the CPU, device and topology managers and their
checkpoints), tests/test_cri_streaming.py (exec, attach and port-forward
through the fake CRI), tests/test_prober.py (liveness, readiness and
startup probes) and tests/test_cluster_e2e.py (hollow kubelets, the
controller manager and the scheduler together) run against each package
through tests/_dual.py.

Every case runs on both packages; `test_pairs_cover_every_case_on_both_packages`
fails if a case is left off either side."""

from __future__ import annotations

import importlib.util

import pytest

from ._dual import PACKAGES, cases, run_case

MODULES = ("test_kubelet", "test_cm", "test_cri_streaming", "test_prober",
           "test_cluster_e2e")
CASES = [c for m in MODULES for c in cases(m)]
PAIRS = [(c, p) for c in CASES for p in PACKAGES]


@pytest.mark.parametrize("case,package", PAIRS,
                         ids=[f"{c.id}-{p}" for c, p in PAIRS])
def test_reference_case(case, package, request):
    run_case(request, package, case)


def test_pairs_cover_every_case_on_both_packages():
    per_module = {m: sum(c.module == m for c in CASES) for m in MODULES}
    assert per_module == {"test_kubelet": 12, "test_cm": 21,
                          "test_cri_streaming": 8, "test_prober": 5,
                          "test_cluster_e2e": 2}
    assert len(CASES) == 48
    assert sorted((c.id, p) for c, p in PAIRS) == sorted(
        (c.id, p) for c in CASES for p in PACKAGES)
    for mod in ("kubelet.cri", "kubelet.streaming", "kubelet.pleg",
                "kubelet.prober", "kubelet.cm", "kubelet.kubelet",
                "kubemark.hollow"):
        assert importlib.util.find_spec(
            f"kubernetes_tpu_torch.{mod}") is not None
