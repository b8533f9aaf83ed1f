"""The port's third controller slice (ROADMAP.md Queue 1, 10c: the rest
of the controllers, kubeadm and `controllers/manager.py`) holds to the
reference's own cases, on the CPU.

The cases of tests/test_controllers_r2.py (pod GC, service accounts and
their tokens, ReplicationController, attach/detach, volume protection,
node TTL; the initializer registry), tests/test_controllers_r3.py (CSR
approval, signing and cleaning, bootstrap signer and token cleaner,
ClusterRole aggregation, EndpointSlice mirroring, ephemeral volumes and
expansion, the root CA publisher, a kubeadm join through a CSR) and
tests/test_nodeipam.py (the CIDR set and NodeIpamController) run against
each package through tests/_dual.py.

Five of tests/test_nodeipam.py's cases drive the kubelet (Queue 1,
slice 10d), which the port has too: every case runs on both packages.
`PORT_WAITS` stays empty, and `test_port_waits_only_for_kubelet` fails
if a case is left off either side."""

from __future__ import annotations

import importlib.util

import pytest

from ._dual import PACKAGES, cases, run_case

PORT_WAITS: dict = {}
CASES = [c for m in ("test_controllers_r2", "test_controllers_r3",
                     "test_nodeipam") for c in cases(m)]
PAIRS = [(c, p) for c in CASES for p in PACKAGES
         if not (p == "kubernetes_tpu_torch" and c.id in PORT_WAITS)]


@pytest.mark.parametrize("case,package", PAIRS,
                         ids=[f"{c.id}-{p}" for c, p in PAIRS])
def test_reference_case(case, package, request):
    run_case(request, package, case)


def test_port_waits_only_for_kubelet():
    """All 47 cases run on both packages, the five that drive the kubelet
    too."""
    assert not PORT_WAITS
    assert len(CASES) == 47
    assert sorted((c.id, p) for c, p in PAIRS) == sorted(
        (c.id, p) for c in CASES for p in PACKAGES)
    ids = {c.id for c in CASES}
    for case in (
        "TestKubeletConsumption::test_kubelet_applies_pod_cidr_to_cni",
        "TestKubeletConsumption::test_kubelet_status_sync_consumes_spec",
        "TestCidrMaskLengths::test_slash23_uses_both_24s",
        "TestCidrMaskLengths::test_slash24_unchanged",
        "TestCidrMaskLengths::test_slash25_exhausts_at_126",
    ):
        assert f"test_nodeipam::{case}" in ids
    assert importlib.util.find_spec(
        "kubernetes_tpu_torch.kubelet") is not None
