"""Device-side preemption planner: the top rung of the planner ladder.

Three rungs, per failed pod:

  device  — victim search as a batched what-if scan (ops/whatif.py): one
            fused launch per preemptor evaluates base feasibility and
            the exact reprieve walk for EVERY candidate node against a
            scratch copy of the session carry. Covers preemptors with
            pod (anti-)affinity terms and topology-spread constraints —
            the classes the numpy envelope must reject — because the
            session kernels already compute the IPA/PTS count
            interference the dry run needs.
  fast    — the numpy FastPreemptionPlanner (preemption.py): resource
            fit + static gates + vectorized PDB reprieve, host-side.
  oracle  — the DefaultPreemption plugin dry-run via the scheduler's
            redispatch path (per-pod filter chain).

This planner subclasses FastPreemptionPlanner so the WAVE BOOKS are one
set of state across rungs: PDB allowance tensors, the MoreImportantPod
sort, claimed-victim exclusion, and nominated-load accounting are shared
verbatim — two rungs can never double-claim a victim or disagree on the
pick-one ladder, because both read and write the same books. Node
choice, victim sets and PDB handling stay bit-identical to the Go-oracle
semantics pinned in tests/test_preemption_fast.py.

Port of kubernetes_tpu/scheduler/preemption_device.py with the fast and
oracle rungs only: the device rung needs the what-if scan (ops/whatif.py),
which the port does not have yet, and raises NotImplementedError. The
port's backend reports whatif_enabled() False, so the scheduler builds
the numpy FastPreemptionPlanner and never reaches that raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..api import types as v1
from .preemption import (
    FastPreemptionPlanner,
    WaveAntiTerms,
    eviction_invariant_gates,
)

# sentinel candidate: this pod must fall to the ORACLE rung (the
# scheduler routes it through the batched redispatch + DefaultPreemption)
ORACLE_FALLBACK = object()


def device_eligible(pod: v1.Pod, extenders: Sequence,
                    anti_terms: WaveAntiTerms) -> bool:
    """The device rung's envelope: fast_eligible WITHOUT the affinity /
    topology-spread gates (the what-if kernel evaluates those filters
    under eviction), keeping the gates eviction cannot express:
    extenders, Never-policy, a pinned spec.nodeName, host ports, PVCs,
    and existing pods whose required anti-affinity terms match the
    preemptor (a victim eviction can only DECREMENT term counts;
    un-ORing another pod's repulsion is outside the count algebra)."""
    if extenders:
        return False
    if anti_terms.matches(pod):
        return False
    return eviction_invariant_gates(pod)


class DevicePreemptionPlanner(FastPreemptionPlanner):
    """FastPreemptionPlanner books + a device what-if rung.

    `eligibility` maps pod_key -> (device_ok, fast_ok) as computed by
    the scheduler's wave partition (one WaveAntiTerms pass); pods
    missing from the map ride the fast rung (base-class behavior)."""

    def __init__(self, snapshot, nominator, backend, framework=None,
                 args: Optional[dict] = None,
                 claimed_victims: Optional[Set[str]] = None,
                 pdbs: Optional[Sequence[v1.PodDisruptionBudget]] = None,
                 eligibility: Optional[Dict[str, Tuple[bool, bool]]] = None):
        super().__init__(snapshot, nominator, framework=framework,
                         args=args, claimed_victims=claimed_victims,
                         pdbs=pdbs)
        self.backend = backend
        self.eligibility = eligibility or {}
        self.planner_paths: List[str] = []

    # -- per-pod rung routing ----------------------------------------------

    def _plan_one(self, pod: v1.Pod, limit: int):
        dev_ok, fast_ok = self.eligibility.get(v1.pod_key(pod),
                                               (False, True))
        if dev_ok:
            # the port's backend never enables the what-if planner
            # (whatif_enabled() is False), so the scheduler marks no pod
            # device-eligible and builds no planner of this class
            raise NotImplementedError(
                "the device what-if rung (ops/whatif.py) is not ported "
                "yet (ROADMAP.md, Queue 1, item 5)")
        if fast_ok:
            self.planner_paths.append("fast")
            return super()._plan_one(pod, limit)
        self.planner_paths.append("oracle")
        self.fits_now.append(False)
        return ORACLE_FALLBACK
