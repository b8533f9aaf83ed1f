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

Five of tests/test_nodeipam.py's cases import the kubelet, which the
port does not have yet (Queue 1, slice 10d). `PORT_WAITS` names them and
`test_port_waits_only_for_kubelet` pins that set and fails once
`kubernetes_tpu_torch.kubelet` exists, so they cannot stay out of the
port's side by accident."""

from __future__ import annotations

import importlib.util

import pytest

from ._dual import PACKAGES, cases, run_case

PORT_WAITS = {
    f"test_nodeipam::{case}": "10d" for case in (
        "TestKubeletConsumption::test_kubelet_applies_pod_cidr_to_cni",
        "TestKubeletConsumption::test_kubelet_status_sync_consumes_spec",
        "TestCidrMaskLengths::test_slash23_uses_both_24s",
        "TestCidrMaskLengths::test_slash24_unchanged",
        "TestCidrMaskLengths::test_slash25_exhausts_at_126",
    )
}
CASES = [c for m in ("test_controllers_r2", "test_controllers_r3",
                     "test_nodeipam") for c in cases(m)]
PAIRS = [(c, p) for c in CASES for p in PACKAGES
         if not (p == "kubernetes_tpu_torch" and c.id in PORT_WAITS)]


@pytest.mark.parametrize("case,package", PAIRS,
                         ids=[f"{c.id}-{p}" for c, p in PAIRS])
def test_reference_case(case, package, request):
    run_case(request, package, case)


def test_port_waits_only_for_kubelet():
    assert len(PORT_WAITS) == 5
    assert {c.id for c in CASES} >= set(PORT_WAITS)
    assert len(CASES) == 47
    assert len(PAIRS) == 2 * len(CASES) - len(PORT_WAITS)
    assert importlib.util.find_spec("kubernetes_tpu_torch.kubelet") is None
