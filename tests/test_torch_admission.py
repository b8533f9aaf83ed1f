"""The port's admission chain (kubernetes_tpu_torch/apiserver/admission.py)
holds to the reference's own cases: those of tests/test_admission_r2.py
and tests/test_admission_r3.py run against each package (tests/_dual.py).

One case runs on the reference only: the token-mount case needs
`controllers.serviceaccount`, which the port does not have yet
(ROADMAP.md, Queue 1, slice 10b). `PORT_WAITS` names it, and
`test_port_waits_only_for_serviceaccount` pins that set to this one case
and fails once the module is ported, so the case cannot stay out of the
port's side by accident."""

from __future__ import annotations

import importlib.util

import pytest

from ._dual import PACKAGES, cases, run_case

PORT_WAITS = {
    "test_admission_r2::TestTokenMountE2E::"
    "test_pod_gets_default_sa_token_mounted": "10b",
}
CASES = [c for m in ("test_admission_r2", "test_admission_r3")
         for c in cases(m)]
PAIRS = [(c, p) for c in CASES for p in PACKAGES
         if not (p == "kubernetes_tpu_torch" and c.id in PORT_WAITS)]


@pytest.mark.parametrize("case,package", PAIRS,
                         ids=[f"{c.id}-{p}" for c, p in PAIRS])
def test_reference_case(case, package, request):
    run_case(request, package, case)


def test_port_waits_only_for_serviceaccount():
    assert PORT_WAITS == {
        "test_admission_r2::TestTokenMountE2E::"
        "test_pod_gets_default_sa_token_mounted": "10b"}
    assert [c.id for c in CASES if c.id in PORT_WAITS] == list(PORT_WAITS)
    assert len(CASES) == 26
    assert len(PAIRS) == 2 * len(CASES) - 1
    assert importlib.util.find_spec(
        "kubernetes_tpu_torch.controllers.serviceaccount") is None
