"""Batched preemption planning for failure waves.

Reference: pkg/scheduler/framework/plugins/defaultpreemption/
default_preemption.go — dryRunPreemption (:320) runs selectVictimsOnNode
(:592) per candidate node on parallel goroutines, re-running the whole
filter chain once per removed/re-added victim. For a saturated cluster
that is O(candidates x victims) full filter-chain runs PER PREEMPTOR
(~80ms of host Python here — the r3 Preemption-500n-500hi crawl at 5.6
pods/s).

The TPU build's answer: a failure wave is planned as a BATCH. For
preemptors whose filter set reduces to statically-checkable node gates
plus resource fit (no pod-affinity terms, no topology spread, no host
ports, no PVCs — and no required-anti-affinity pods or matching PDBs in
the cluster), victim removal can only affect the preemptor through the
node's free-resource vector, so:

  * base feasibility ("all lower-priority pods removed") is ONE numpy
    comparison over every node at once — the per-node count/utilization
    deltas the dry-run simulates pod-by-pod collapse into per-priority
    prefix sums;
  * the reprieve loop (victims added back highest-priority-first while
    the preemptor still fits, :633) needs only vector arithmetic on the
    preemptor's request — no filter re-runs;
  * candidate choice reuses DefaultPreemption._pick_one verbatim, so the
    chosen node and victim set match the oracle plugin exactly (pinned
    by tests/test_preemption_fast.py parity fuzz);
  * pods planned earlier in the wave are accounted as nominated load for
    later pods (the sequential nominator semantics of the serial path),
    and their victims leave the books — two preemptors never claim the
    same victim, which the serial oracle only achieves by informer echo
    luck.

Anything outside that envelope (dense-constraint preemptors, PDBs,
required anti-affinity in the cluster) falls back to the oracle
DefaultPreemption plugin per pod — correctness is never traded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..api import types as v1
from .framework.interface import CycleState
from .framework.types import NodeInfo, calculate_resource
from .plugins.defaultpreemption import (
    Candidate,
    DefaultPreemption,
    MIN_CANDIDATE_NODES_ABSOLUTE,
    MIN_CANDIDATE_NODES_PERCENTAGE,
)


def _prio(pod: v1.Pod) -> int:
    return pod.spec.priority or 0


class WaveAntiTerms:
    """ONE cluster pass per failure wave over the pods with required
    anti-affinity, memoized per preemptor identity.

    fast_eligible's existing-anti check used to re-walk every
    pod-with-anti-affinity node list for EACH failed pod in the wave —
    O(wave x cluster) for a check whose inputs repeat: the terms are a
    wave-constant cluster property, and wave pods are stamped from a
    handful of templates, so the match verdict depends only on the
    preemptor's (namespace, labels) row. The memo key is that row (the
    template-identity analog of _affinity_fingerprint for the
    label-match side): template-stamped waves pay one term walk per
    template instead of one cluster walk per pod."""

    def __init__(self, snapshot):
        self.terms = [
            term
            for ni in snapshot.have_pods_with_required_anti_affinity_list
            for existing in ni.pods_with_required_anti_affinity
            for term in existing.required_anti_affinity_terms
        ]
        self._memo: Dict[Tuple, bool] = {}

    def matches(self, pod: v1.Pod) -> bool:
        """True when ANY existing pod's required anti-affinity term
        matches this preemptor (the filtering.go existing-anti check the
        planner envelopes cannot express under victim eviction)."""
        if not self.terms:
            return False
        key = (
            pod.metadata.namespace,
            tuple(sorted((pod.metadata.labels or {}).items())),
        )
        hit = self._memo.get(key)
        if hit is None:
            hit = any(t.matches(pod) for t in self.terms)
            self._memo[key] = hit
        return hit


def fast_eligible(pod: v1.Pod, snapshot, pdbs: Sequence, extenders: Sequence,
                  anti_terms: Optional[WaveAntiTerms] = None) -> bool:
    """True when the planner's envelope provably matches the oracle
    dry-run for this pod: every filter that victims could influence is
    the resource-fit filter. PDBs are INSIDE the envelope (the planner
    vectorizes filterPodsWithPDBViolation + the violating-first reprieve);
    required anti-affinity bails per POD, not per cluster — an existing
    pod's anti term can only block this preemptor (or change under victim
    removal) if the term MATCHES the preemptor's labels+namespace
    (filtering.go existing-anti check); unmatched anti pods elsewhere in
    the cluster are irrelevant to this pod's dry-run."""
    if extenders:
        return False
    if anti_terms is None:
        anti_terms = WaveAntiTerms(snapshot)  # single-pod callers
    if anti_terms.matches(pod):
        return False
    if not eviction_invariant_gates(pod):
        return False
    spec = pod.spec
    if spec.affinity is not None and (
        spec.affinity.pod_affinity is not None
        or spec.affinity.pod_anti_affinity is not None
    ):
        return False
    if spec.topology_spread_constraints:
        return False
    return True


def eviction_invariant_gates(pod: v1.Pod) -> bool:
    """The planner-envelope gates victim EVICTION cannot express —
    shared by fast_eligible and device_eligible so the two envelopes
    cannot drift: Never-policy, a pinned spec.nodeName, host ports
    (NodePorts reads the preemptor's wants, not the victims'), and PVC
    volumes (binding decisions are host-side)."""
    spec = pod.spec
    if spec.preemption_policy == "Never":
        return False
    if spec.node_name:
        return False
    for c in spec.containers:
        for port in c.ports or []:
            if (port.host_port or 0) > 0:
                return False
    for vol in spec.volumes or []:
        if (vol.source or {}).get("persistentVolumeClaim"):
            return False
    return True


_PRIO_SENTINEL = np.iinfo(np.int64).max  # padding rows never match `< prio`


class FastPreemptionPlanner:
    """Plans preemption for a wave of failed pods against one snapshot.

    Resource dimensions are discovered from the preemptors' requests:
    cpu (milli), memory, ephemeral storage, pod count, plus any scalar
    resource a wave pod requests. Victim bookkeeping tracks the same
    dims. All arrays are [D, N] int64.
    """

    def __init__(self, snapshot, nominator, framework=None,
                 args: Optional[dict] = None,
                 claimed_victims: Optional[Set[str]] = None,
                 pdbs: Optional[Sequence[v1.PodDisruptionBudget]] = None):
        self.snapshot = snapshot
        self.nominator = nominator
        self.framework = framework
        self.pdbs = list(pdbs or [])
        # victims claimed by earlier waves still dying in the cache:
        # treated as already-removed (their resources left the books the
        # moment they were claimed; the claimer's nominated load covers
        # the replacement)
        self.claimed_victims = claimed_victims or set()
        args = args or {}
        self.min_pct = args.get(
            "minCandidateNodesPercentage", MIN_CANDIDATE_NODES_PERCENTAGE
        )
        self.min_abs = args.get(
            "minCandidateNodesAbsolute", MIN_CANDIDATE_NODES_ABSOLUTE
        )
        self.nodes: List[NodeInfo] = snapshot.list()
        self.n = len(self.nodes)
        self._name_to_idx = {
            ni.node.metadata.name: i for i, ni in enumerate(self.nodes)
        }
        self.fits_now: List[bool] = []
        self._static_cache: Dict[Tuple, np.ndarray] = {}
        # nominated load per node: [(prio, req_vec, key)] — seeded from
        # the nominator, grown as the wave claims nodes
        self._nominated: Dict[int, List[Tuple[int, np.ndarray, str]]] = {}
        self._dims: List[str] = []
        self._alloc: Optional[np.ndarray] = None
        self._used: Optional[np.ndarray] = None
        self._npods: Optional[np.ndarray] = None
        self._max_pods: Optional[np.ndarray] = None
        # per-distinct-priority caches
        self._lower_sum: Dict[int, np.ndarray] = {}
        self._lower_cnt: Dict[int, np.ndarray] = {}

    # -- wave setup --------------------------------------------------------

    def _req_vec(self, pod: v1.Pod) -> np.ndarray:
        res, _, _ = calculate_resource(pod)
        vec = np.zeros(len(self._dims), dtype=np.int64)
        for d, name in enumerate(self._dims):
            if name == "cpu":
                vec[d] = res.milli_cpu
            elif name == "memory":
                vec[d] = res.memory
            elif name == "ephemeral-storage":
                vec[d] = res.ephemeral_storage
            else:
                vec[d] = res.scalar_resources.get(name, 0)
        return vec

    def _build(self, wave: List[v1.Pod]) -> None:
        dims = ["cpu", "memory", "ephemeral-storage"]
        scalars: Set[str] = set()
        for pod in wave:
            res, _, _ = calculate_resource(pod)
            scalars.update(res.scalar_resources)
        self._dims = dims + sorted(scalars)
        D, N = len(self._dims), self.n
        self._alloc = np.zeros((D, N), dtype=np.int64)
        self._used = np.zeros((D, N), dtype=np.int64)
        self._npods = np.zeros(N, dtype=np.int64)
        self._max_pods = np.zeros(N, dtype=np.int64)

        wave_prios = sorted({_prio(p) for p in wave})
        cols = getattr(self.snapshot, "columnar_util", None)
        col_base = (
            cols is not None
            and [ni.node.metadata.name for ni in self.nodes] == cols["names"]
        )
        if col_base:
            # the base dims (cpu/memory/ephemeral — the columnar cache's
            # fixed row layout) land as one transposed array copy off
            # the snapshot's utilization gather instead of a per-node
            # Python attribute walk; scalar dims (wave-discovered, not
            # columnar) still walk below
            self._alloc[0:3, :] = cols["alloc"].T
            self._used[0:3, :] = cols["requested"].T
        for d in range(D):
            name = self._dims[d]
            if col_base and d < 3:
                continue
            for i, ni in enumerate(self.nodes):
                if name == "cpu":
                    self._alloc[d, i] = ni.allocatable.milli_cpu
                    self._used[d, i] = ni.requested.milli_cpu
                elif name == "memory":
                    self._alloc[d, i] = ni.allocatable.memory
                    self._used[d, i] = ni.requested.memory
                elif name == "ephemeral-storage":
                    self._alloc[d, i] = ni.allocatable.ephemeral_storage
                    self._used[d, i] = ni.requested.ephemeral_storage
                else:
                    self._alloc[d, i] = ni.allocatable.scalar_resources.get(name, 0)
                    self._used[d, i] = ni.requested.scalar_resources.get(name, 0)
        lo_sum = {p: np.zeros((D, N), dtype=np.int64) for p in wave_prios}
        lo_cnt = {p: np.zeros(N, dtype=np.int64) for p in wave_prios}
        per_node: List[List] = []
        from .plugins.coscheduling import pod_group

        for i, ni in enumerate(self.nodes):
            self._npods[i] = len(ni.pods)
            self._max_pods[i] = ni.allocatable.allowed_pod_number
            # victim slots are same-node eviction UNITS: singletons for
            # plain pods, whole gangs for co-located gang members (the
            # oracle's _victim_units — whole gangs or none). A unit's
            # slot carries the members' summed request vector; its
            # priority is the members' MAX so the `< prio` validity
            # check admits a gang only when EVERY member is outranked
            gang_units: Dict[Tuple[str, str], List[v1.Pod]] = {}
            victims = []
            for pi in ni.pods:
                if v1.pod_key(pi.pod) in self.claimed_victims:
                    # an in-flight wave already evicted it: neither
                    # present (its resources are spoken for) nor
                    # evictable again
                    self._used[:, i] -= self._req_vec(pi.pod)
                    self._npods[i] -= 1
                    continue
                group, min_available = pod_group(pi.pod)
                if group and min_available > 1:
                    gang_units.setdefault(
                        (pi.pod.metadata.namespace, group), []
                    ).append(pi.pod)
                    continue
                vp = _prio(pi.pod)
                if vp >= wave_prios[-1]:
                    continue
                vec = self._req_vec(pi.pod)
                victims.append(
                    (vp, pi.pod.status.start_time or 0.0, vec, [pi.pod])
                )
                for p in wave_prios:
                    if vp < p:
                        lo_sum[p][:, i] += vec
                        lo_cnt[p][i] += 1
            for members in gang_units.values():
                vp = max(_prio(m) for m in members)
                if vp >= wave_prios[-1]:
                    continue
                members.sort(
                    key=lambda m: (-_prio(m), m.status.start_time or 0.0)
                )
                vec = np.sum(
                    [self._req_vec(m) for m in members], axis=0
                ).astype(np.int64)
                start = min(
                    m.status.start_time or 0.0
                    for m in members if _prio(m) == vp
                )
                victims.append((vp, start, vec, members))
                for p in wave_prios:
                    if vp < p:
                        lo_sum[p][:, i] += vec
                        lo_cnt[p][i] += len(members)
            # victims stored in ni.pods ORDER; both PDB allowance
            # consumption (:612 sorts by MoreImportantPod BEFORE
            # filterPodsWithPDBViolation) and the reprieve (highest
            # priority, earliest start, :633) walk the _vsort permutation
            per_node.append(victims)
        self._lower_sum = lo_sum
        self._lower_cnt = lo_cnt
        # padded victim books [N, Vmax, ...] — the reprieve loop runs
        # vectorized over every candidate node at once (per-candidate
        # Python iteration was the wave's dominant cost at 500x100x4)
        Vmax = max((len(v) for v in per_node), default=0)
        self._vmax = Vmax
        self._vvec = np.zeros((N, max(Vmax, 1), D), dtype=np.int64)
        # pad priority with a sentinel above any real priority so the
        # `< prio` validity check rejects padding rows
        self._vprio = np.full((N, max(Vmax, 1)), _PRIO_SENTINEL, dtype=np.int64)
        self._vstart = np.zeros((N, max(Vmax, 1)), dtype=np.float64)
        self._valive = np.zeros((N, max(Vmax, 1)), dtype=bool)
        # per-slot unit shape: member count (pod-count arithmetic +
        # victim tallies), summed member priority (the pick ladder's
        # sum_prio is per POD), and the LATEST start among the slot's
        # highest-priority members (_vstart keeps the EARLIEST — the
        # MoreImportantPod sort key — while the ladder's latest-start
        # tiebreak reads per-pod maxima)
        self._vsize = np.zeros((N, max(Vmax, 1)), dtype=np.int64)
        self._vpriosum = np.zeros((N, max(Vmax, 1)), dtype=np.int64)
        self._vlatest_hi = np.zeros((N, max(Vmax, 1)), dtype=np.float64)
        self._vpods: List[List[List[v1.Pod]]] = []
        # PDB match tensor [N, Vmax, P]: how many of slot (i, j)'s
        # members consume pdb p's budget (same namespace + selector
        # match)? Counts, not booleans — a gang unit can hold several
        # matching members
        P = len(self.pdbs)
        self._pdb_match = np.zeros((N, max(Vmax, 1), max(P, 1)), dtype=np.int64)
        self._pdb_allowed = np.zeros(max(P, 1), dtype=np.int64)
        sels = []
        if P:
            from ..api.labels import Selector

            for p_i, pdb in enumerate(self.pdbs):
                self._pdb_allowed[p_i] = pdb.status.disruptions_allowed
                sels.append(
                    Selector.from_label_selector(pdb.spec.selector)
                    if pdb.spec.selector else None
                )
        for i, victims in enumerate(per_node):
            pods_row: List[List[v1.Pod]] = []
            for j, (vp, start, vec, members) in enumerate(victims):
                self._vvec[i, j] = vec
                self._vprio[i, j] = vp
                self._vstart[i, j] = start
                self._valive[i, j] = True
                self._vsize[i, j] = len(members)
                self._vpriosum[i, j] = sum(_prio(m) for m in members)
                self._vlatest_hi[i, j] = max(
                    m.status.start_time or 0.0
                    for m in members if _prio(m) == vp
                )
                pods_row.append(members)
                for vpod in members:
                    for p_i, pdb in enumerate(self.pdbs):
                        if pdb.metadata.namespace != vpod.metadata.namespace:
                            continue
                        sel = sels[p_i]
                        if sel is not None and sel.matches(
                                vpod.metadata.labels):
                            self._pdb_match[i, j, p_i] += 1
            self._vpods.append(pods_row)
        # reprieve permutation: order victims (highest priority, earliest
        # start); padding rows sort last
        skey = np.where(
            self._valive, self._vprio, np.int64(-(2 ** 62))
        )
        self._vsort = np.lexsort(
            (self._vstart, -skey), axis=1
        )
        # seed nominated load (RunFilterPluginsWithNominatedPods adds
        # nominated pods with priority >= preemptor's, framework.go:610).
        # Running totals make the uniform-priority wave O(1) per pod —
        # rebuilding a [D, N] matrix from the entry lists per planned pod
        # was O(wave^2) and dominated the 500-pod wave
        self._nominated = {}
        self._nom_sum = np.zeros((D, N), dtype=np.int64)
        self._nom_cnt = np.zeros(N, dtype=np.int64)
        self._nom_min_prio: Optional[int] = None  # min prio among entries
        if self.nominator is not None:
            wave_keys = {v1.pod_key(p) for p in wave}
            for i, ni in enumerate(self.nodes):
                for np_pod in self.nominator.nominated_pods_for_node(
                    ni.node.metadata.name
                ):
                    key = v1.pod_key(np_pod)
                    if key in wave_keys:
                        continue  # re-planning pods don't self-block
                    p, vec = _prio(np_pod), self._req_vec(np_pod)
                    self._nominated.setdefault(i, []).append((p, vec, key))
                    self._nom_sum[:, i] += vec
                    self._nom_cnt[i] += 1
                    self._nom_min_prio = (
                        p if self._nom_min_prio is None
                        else min(self._nom_min_prio, p)
                    )

    # -- static node gates (victim-independent filters) --------------------

    def _static_mask(self, pod: v1.Pod) -> np.ndarray:
        """Per-node pass/fail for the preemptor's victim-independent
        filters: NodeUnschedulable, TaintToleration, NodeAffinity — one
        host evaluation per (template, node), cached by the pod fields
        those filters read."""
        key = (
            tuple(sorted((pod.spec.node_selector or {}).items())),
            _affinity_fingerprint(pod),
            _tolerations_fingerprint(pod),
        )
        mask = self._static_cache.get(key)
        if mask is not None:
            return mask
        from .plugins.nodebasic import NodeAffinity, NodeUnschedulable, TaintToleration

        unsched = NodeUnschedulable()
        taints = TaintToleration()
        affinity = NodeAffinity()
        mask = np.zeros(self.n, dtype=bool)
        state = CycleState()
        for i, ni in enumerate(self.nodes):
            ok = (
                unsched.filter(state, pod, ni) is None
                and taints.filter(state, pod, ni) is None
                and affinity.filter(state, pod, ni) is None
            )
            mask[i] = ok
        self._static_cache[key] = mask
        return mask

    # -- planning ----------------------------------------------------------

    def plan(
        self, wave: List[v1.Pod]
    ) -> List[Optional[Candidate]]:
        """One Candidate (nominated node + victims) per pod, or None when
        preemption cannot help. Pods are planned in order; earlier plans
        are visible to later ones as nominated load + claimed victims."""
        self.fits_now: List[bool] = []
        if not wave:
            return []
        self._build(wave)
        limit = self._num_candidates()
        out: List[Optional[Candidate]] = []
        for pod in wave:
            out.append(self._plan_one(pod, limit))
        return out

    def _num_candidates(self) -> int:
        n = self.n * self.min_pct // 100
        n = max(n, self.min_abs)
        return min(n, self.n)

    def _nom_arrays(self, prio: int) -> Tuple[np.ndarray, np.ndarray]:
        """Nominated load per node as [D, N] / [N] arrays for entries
        with priority >= prio. Uniform waves hit the running totals;
        a preemptor outranked by some nominee rebuilds (rare)."""
        if self._nom_min_prio is None or prio <= self._nom_min_prio:
            return self._nom_sum, self._nom_cnt
        vec = np.zeros_like(self._nom_sum)
        cnt = np.zeros_like(self._nom_cnt)
        for i, entries in self._nominated.items():
            for p, req, _ in entries:
                if p >= prio:
                    vec[:, i] += req
                    cnt[i] += 1
        return vec, cnt

    def _plan_one(self, pod: v1.Pod, limit: int) -> Optional[Candidate]:
        from . import metrics

        metrics.preemption_planner.inc(path="fast")
        prio = _prio(pod)
        req = self._req_vec(pod)
        static = self._static_mask(pod)
        lower_sum = self._lower_sum[prio]
        lower_cnt = self._lower_cnt[prio]
        # free with EVERY lower-priority pod removed (the dry-run's base
        # state, :626), before nominated load
        free_all = self._alloc - self._used + lower_sum
        cnt_all = self._npods - lower_cnt
        nom_vec, nom_cnt = self._nom_arrays(prio)
        # fits WITHOUT any eviction (cluster state moved since the batch
        # dispatched): not preemption's business — the caller re-runs the
        # pod through the kernel for a scored placement
        fits_now = bool(
            np.any(
                static
                & np.all(
                    self._alloc - self._used - nom_vec >= req[:, None], axis=0
                )
                & (self._npods + nom_cnt + 1 <= self._max_pods)
            )
        )
        self.fits_now.append(fits_now)
        if fits_now:
            return None
        feasible = (
            static
            & (lower_cnt > 0)
            & np.all(free_all - nom_vec >= req[:, None], axis=0)
            & (cnt_all + nom_cnt + 1 <= self._max_pods)
        )
        idxs = np.flatnonzero(feasible)
        if idxs.size == 0 or self._vmax == 0:
            return None
        # every feasible node yields >=1 victim (all-reprieved would mean
        # the pod fits with nobody removed — excluded by fits_now above),
        # so the oracle's first-`limit`-candidates cut is just a slice
        C = idxs[:limit]
        Csz = C.size
        rows = np.arange(Csz)
        violating = self._pdb_violating(C, prio)
        # -- vectorized reprieve (:633) over all candidates at once, in
        # the oracle's order: the VIOLATING group first, then the rest,
        # each (highest priority, earliest start) via the _vsort
        # permutation; nodes are independent, so per-node sequential
        # semantics hold exactly
        free = free_all[:, C] - nom_vec[:, C] - req[:, None]  # [D, C]
        slots = (
            self._max_pods[C] - cnt_all[C] - nom_cnt[C] - 1
        )  # remaining re-add slots [C]
        n_vict = np.zeros(Csz, dtype=np.int64)
        n_pdbv = np.zeros(Csz, dtype=np.int64)
        sum_prio = np.zeros(Csz, dtype=np.int64)
        max_prio = np.full(Csz, np.iinfo(np.int64).min, dtype=np.int64)
        victim_mask = np.zeros((Csz, self._vmax), dtype=bool)
        for in_violating_group in (True, False):
            for v in range(self._vmax):
                j = self._vsort[C, v]  # per-candidate column [C]
                valid = (
                    self._valive[C, j]
                    & (self._vprio[C, j] < prio)
                    & (violating[rows, j] == in_violating_group)
                )
                vec = self._vvec[C, j].T  # [D, C]
                size = self._vsize[C, j]  # unit member count [C]
                can = valid & (slots >= size) & np.all(vec <= free, axis=0)
                free = free - np.where(can, vec, 0)
                slots = slots - np.where(can, size, 0)
                vic = valid & ~can
                victim_mask[rows, j] |= vic
                n_vict += np.where(vic, size, 0)
                if in_violating_group:
                    n_pdbv += np.where(vic, size, 0)
                sum_prio += np.where(vic, self._vpriosum[C, j], 0)
                vp = self._vprio[C, j]
                max_prio = np.maximum(
                    max_prio, np.where(vic, vp, np.iinfo(np.int64).min))
        # latest start among each candidate's HIGHEST-priority victims
        hi_mask = victim_mask & (self._vprio[C] == max_prio[:, None])
        latest = np.max(
            np.where(hi_mask, self._vlatest_hi[C], -np.inf), axis=1
        )
        ci = self._pick_index(n_vict > 0, n_pdbv, max_prio, sum_prio,
                              n_vict, latest)
        if ci is None:
            return None
        i = int(C[ci])
        victims = _ordered_victims(
            self._vpods[i], victim_mask[ci], violating[ci],
            self._vsort[i], self._vmax,
        )
        best = Candidate(
            self.nodes[i].node.metadata.name, victims,
            num_pdb_violations=int(n_pdbv[ci]),
        )
        self._claim(best, pod, prio, req)
        return best

    def _pdb_violating(self, C: np.ndarray, prio: int) -> np.ndarray:
        """filterPodsWithPDBViolation (:660), vectorized per candidate:
        victims consume PDB allowances in MoreImportantPod order
        (priority desc, earlier start first — the :612 sort runs BEFORE
        the split in the reference), i.e. column-by-column through the
        _vsort permutation; a victim whose matched budget is already
        exhausted at its turn is "violating". Shared verbatim by the
        numpy reprieve and the device what-if planner (PDB accounting
        is host bookkeeping on both rungs)."""
        Csz = C.size
        rows = np.arange(Csz)
        # width max(vmax, 1) like every sibling wave-book array
        # (_valive/_vprio/_vsort): the device rung gathers through the
        # _vsort permutation even when ZERO eviction units exist
        # cluster-wide (e.g. every resident pod sits inside a mixed
        # gang) — it still owes the caller the launch's fits_now
        # verdict — and a width-0 row here would throw the gather
        violating = np.zeros((Csz, max(self._vmax, 1)), dtype=bool)
        if self.pdbs:
            allowed_rem = np.repeat(
                self._pdb_allowed[:, None], Csz, axis=1
            )  # [P, C]
            for v in range(self._vmax):
                j = self._vsort[C, v]  # per-candidate column [C]
                valid_o = self._valive[C, j] & (self._vprio[C, j] < prio)
                # per-slot MATCH COUNTS (a gang unit may hold several
                # members of one budget): the unit violates when its
                # members outnumber the remaining allowance — the exact
                # member-sequential consumption the oracle runs, since
                # members beyond the allowance each hit an exhausted
                # budget at their turn
                m = self._pdb_match[C, j, :].T * valid_o[None, :]  # [P, C]
                avail = np.maximum(allowed_rem, 0)
                violating[rows, j] = np.any(m > avail, axis=0)
                allowed_rem -= np.minimum(m, avail)
        return violating

    @staticmethod
    def _pick_index(alive, n_pdbv, max_prio, sum_prio, n_vict, latest):
        """pickOneNodeForPreemption (:457), vectorized with the same
        tie-break ladder as DefaultPreemption._pick_one (fewest PDB
        violations first); final tie -> first candidate in snapshot
        order. Returns the winning index into the candidate axis, or
        None when no candidate is alive."""
        if not alive.any():
            return None
        best_mask = alive
        for crit, reverse in (
            (n_pdbv, False),
            (max_prio, False), (sum_prio, False),
            (n_vict, False), (latest, True),
        ):
            vals = np.where(best_mask, crit, np.inf if not reverse else -np.inf)
            target = vals.max() if reverse else vals.min()
            best_mask = best_mask & (vals == target)
            if best_mask.sum() == 1:
                break
        return int(np.flatnonzero(best_mask)[0])

    def _claim(self, cand: Candidate, pod: v1.Pod, prio: int, req: np.ndarray) -> None:
        """Apply a chosen candidate to the wave books: the preemptor
        becomes nominated load on the node; its victims leave every
        per-priority prefix (they are being evicted — later wave pods
        must not count them as either present or evictable)."""
        i = self._name_to_idx[cand.node_name]
        self._nominated.setdefault(i, []).append((prio, req, v1.pod_key(pod)))
        self._nom_sum[:, i] += req
        self._nom_cnt[i] += 1
        self._nom_min_prio = (
            prio if self._nom_min_prio is None
            else min(self._nom_min_prio, prio)
        )
        victim_keys = {v1.pod_key(v) for v in cand.victims}
        for j, slot_pods in enumerate(self._vpods[i]):
            if not slot_pods or not any(
                v1.pod_key(vp) in victim_keys for vp in slot_pods
            ):
                continue
            # gone from the node: present-resources AND the
            # lower-priority prefixes both drop. Units leave WHOLE
            # (candidates only ever contain complete units)
            vp = int(self._vprio[i, j])
            vec = self._vvec[i, j]
            size = int(self._vsize[i, j])
            self._valive[i, j] = False
            self._vpods[i][j] = []
            self._used[:, i] -= vec
            self._npods[i] -= size
            for p in self._lower_sum:
                if vp < p:
                    self._lower_sum[p][:, i] -= vec
                    self._lower_cnt[p][i] -= size


def _ordered_victims(pods_row, victim_mask, violating_row, vsort, vmax):
    """Victims in the oracle's append order: the violating group first,
    then the rest, each in reprieve (priority desc, start asc) order —
    Candidate.victims ordering is observable (eviction order). A slot's
    members (one pod, or a whole gang unit pre-sorted by
    MoreImportantPod) append consecutively."""
    out = []
    for in_violating_group in (True, False):
        for v in range(vmax):
            j = int(vsort[v])
            if victim_mask[j] and bool(violating_row[j]) == in_violating_group:
                out.extend(pods_row[j])
    return out


def _affinity_fingerprint(pod: v1.Pod):
    a = pod.spec.affinity
    if a is None or a.node_affinity is None:
        return None
    from ..utils import serde

    return str(serde.to_dict(a.node_affinity))


def _tolerations_fingerprint(pod: v1.Pod):
    return tuple(
        (t.key or "", t.operator or "", t.value or "", t.effect or "")
        for t in pod.spec.tolerations or []
    )
