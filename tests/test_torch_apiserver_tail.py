"""The port's copies of the apiserver's remaining modules (auth,
flowcontrol, audit, webhook, crd, aggregator, and utils/featuregate) hold
to the reference's own cases: those of tests/test_auth.py,
test_flowcontrol.py, test_audit.py, test_webhook.py,
test_crd_featuregate.py and test_aggregator.py run against each package
(tests/_dual.py), less the one that needs cluster.py (not ported)."""

from __future__ import annotations

import pytest

from ._dual import PACKAGES, cases, run_case

SKIP = {
    # waits for cluster.py (ROADMAP.md Queue 1, 10f)
    "test_crd_featuregate::TestFeatureGateRestore::"
    "test_cluster_restores_gates",
}
CASES = [c for m in ("test_auth", "test_flowcontrol", "test_audit",
                     "test_webhook", "test_crd_featuregate",
                     "test_aggregator") for c in cases(m, SKIP)]


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case(case, package, request):
    run_case(request, package, case)
