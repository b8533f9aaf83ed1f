"""DefaultPreemption: the PostFilter plugin that evicts lower-priority pods.

Reference: pkg/scheduler/framework/plugins/defaultpreemption/
default_preemption.go — PostFilter (:90), PodEligibleToPreemptOthers
(:539), calculateNumCandidates (:170: 10% of nodes clamped to
[100, numNodes]), dryRunPreemption (:320), selectVictimsOnNode (:592:
remove all lower-priority pods, verify fit, then reprieve victims
highest-priority-first while fit holds, PDB-violating pods reprieved
last), filterPodsWithPDBViolation (:660), pickOneNodeForPreemption (:457:
fewest PDB violations → lowest max victim priority → smallest priority sum
→ fewest victims → latest highest-priority victim start → first), and
PrepareCandidate (:690: delete victims, clear lower-priority nominations).

The plugin returns the chosen candidate; the Scheduler applies the API
effects (victim deletion + nominatedNodeName patch) — the process split
between decision and actuation that the binding cycle already uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ...api import types as v1
from ...api.labels import Selector
from ..framework import interface as fwk
from ..framework.interface import Code, CycleState, Status
from ..framework.types import NodeInfo, PodInfo

MIN_CANDIDATE_NODES_PERCENTAGE = 10  # default_preemption.go args default
MIN_CANDIDATE_NODES_ABSOLUTE = 100


@dataclass
class Candidate:
    node_name: str
    victims: List[v1.Pod] = field(default_factory=list)
    num_pdb_violations: int = 0


@dataclass
class PostFilterResult:
    nominated_node_name: str
    victims: List[v1.Pod] = field(default_factory=list)


def _pod_priority(pod: v1.Pod) -> int:
    return pod.spec.priority or 0


def _unit_prio(unit: List[PodInfo]) -> int:
    return max(_pod_priority(pi.pod) for pi in unit)


def _unit_sort_key(unit: List[PodInfo]):
    """MoreImportantPod lifted to eviction units: highest member
    priority desc, then the earliest start among the highest-priority
    members (a singleton degenerates to the original per-pod key)."""
    hi = _unit_prio(unit)
    return (
        -hi,
        min(pi.pod.status.start_time or 0.0
            for pi in unit if _pod_priority(pi.pod) == hi),
    )


def _victim_units(node_info: NodeInfo, pod_prio: int) -> List[List[PodInfo]]:
    """Same-node eviction units: singletons for plain pods, WHOLE gangs
    for co-located gang members (gang-aware preemption evicts whole
    gangs or none, so the dry run removes/reprieves a gang's local
    members as one indivisible unit). A gang unit is evictable only
    when EVERY co-located member outranks below the preemptor — a mixed
    gang stays untouched rather than losing a prefix. Members are
    pre-sorted by MoreImportantPod so PDB allowance consumption and the
    victim append order are deterministic."""
    from .coscheduling import pod_group

    def key(pi: PodInfo):
        return (-_pod_priority(pi.pod), pi.pod.status.start_time or 0.0)

    gangs: Dict[Tuple[str, str], List[PodInfo]] = {}
    units: List[List[PodInfo]] = []
    for pi in list(node_info.pods):
        group, min_available = pod_group(pi.pod)
        if group and min_available > 1:
            gangs.setdefault(
                (pi.pod.metadata.namespace, group), []
            ).append(pi)
        elif _pod_priority(pi.pod) < pod_prio:
            units.append([pi])
    for members in gangs.values():
        if all(_pod_priority(pi.pod) < pod_prio for pi in members):
            members.sort(key=key)
            units.append(members)
    return units


class DefaultPreemption(fwk.PostFilterPlugin):
    name = "DefaultPreemption"

    def __init__(self, args=None, handle=None):
        """handle must provide: snapshot_shared_lister(),
        run_filter_plugins_with_nominated_pods, run_pre_filter_extension_
        remove_pod/add_pod, and optionally .nominator and .pdb_lister."""
        self.handle = handle
        args = args or {}
        self.min_candidate_nodes_percentage = args.get(
            "minCandidateNodesPercentage", MIN_CANDIDATE_NODES_PERCENTAGE
        )
        self.min_candidate_nodes_absolute = args.get(
            "minCandidateNodesAbsolute", MIN_CANDIDATE_NODES_ABSOLUTE
        )

    # -- entry (default_preemption.go:90 PostFilter) -----------------------

    def post_filter(
        self, state: CycleState, pod: v1.Pod, filtered_node_status_map: Dict[str, Status]
    ) -> Tuple[Optional[PostFilterResult], Optional[Status]]:
        snapshot = self.handle.snapshot_shared_lister()
        if not self._pod_eligible(pod, snapshot):
            return None, Status.unschedulable(
                "Pod is not eligible for more preemption"
            )
        candidates = self._find_candidates(state, pod, filtered_node_status_map, snapshot)
        if not candidates:
            return None, Status.unschedulable(
                "preemption: 0/%d nodes are available" % snapshot.num_nodes()
            )
        best = self._pick_one(candidates)
        result = PostFilterResult(best.node_name, best.victims)
        return result, Status(Code.SUCCESS)

    # -- eligibility (:539 PodEligibleToPreemptOthers) ---------------------

    def _pod_eligible(self, pod: v1.Pod, snapshot) -> bool:
        if pod.spec.preemption_policy == "Never":
            return False
        nominated = pod.status.nominated_node_name
        if nominated:
            try:
                ni = snapshot.get(nominated)
            except KeyError:
                return True
            # a terminating lower-priority pod there means a previous
            # preemption is in flight — wait for it
            for pi in ni.pods:
                if (
                    pi.pod.metadata.deletion_timestamp is not None
                    and _pod_priority(pi.pod) < _pod_priority(pod)
                ):
                    return False
        return True

    # -- candidates (:145 findCandidates + :320 dryRunPreemption) ----------

    def _num_candidates(self, num_nodes: int) -> int:
        """:170 calculateNumCandidates."""
        n = num_nodes * self.min_candidate_nodes_percentage // 100
        n = max(n, self.min_candidate_nodes_absolute)
        return min(n, num_nodes)

    def _find_candidates(
        self, state: CycleState, pod: v1.Pod, statuses: Dict[str, Status], snapshot
    ) -> List[Candidate]:
        # only Unschedulable (not UnschedulableAndUnresolvable) nodes can be
        # helped by preemption (:128 nodesWherePreemptionMightHelp)
        potential: List[NodeInfo] = []
        for ni in snapshot.list():
            st = statuses.get(ni.node.metadata.name)
            if st is not None and st.code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue
            potential.append(ni)
        if not potential:
            return []
        pdbs = self._pdbs()
        limit = self._num_candidates(snapshot.num_nodes())
        candidates: List[Candidate] = []
        for ni in potential:
            victims = self._select_victims_on_node(state, pod, ni, pdbs)
            if victims is not None:
                candidates.append(victims)
                if len(candidates) >= limit:
                    break
        return candidates

    def _pdbs(self) -> List[v1.PodDisruptionBudget]:
        lister = getattr(self.handle, "pdb_lister", None)
        return lister() if callable(lister) else []

    # -- per-node dry run (:592 selectVictimsOnNode) -----------------------

    def _select_victims_on_node(
        self,
        state: CycleState,
        pod: v1.Pod,
        node_info: NodeInfo,
        pdbs: List[v1.PodDisruptionBudget],
    ) -> Optional[Candidate]:
        state = state.clone()
        node_info = node_info.clone()
        pod_prio = _pod_priority(pod)
        # same-node eviction units: gangs are indivisible (whole gangs
        # or none); a singleton unit reproduces the original per-pod
        # dry run exactly
        units = _victim_units(node_info, pod_prio)
        if not units:
            return None
        # :612 sorts by MoreImportantPod (priority desc, earlier start
        # first) BEFORE filterPodsWithPDBViolation: PDB allowances are
        # consumed most-important-first, so when a budget covers more
        # victims than it allows, the LEAST important ones are the
        # violating group. The reprieve re-sorts each group with the
        # same key, so the sort changes only allowance consumption.
        units.sort(key=_unit_sort_key)
        for unit in units:
            for pi in unit:
                node_info.remove_pod(pi.pod)
                self.handle.run_pre_filter_extension_remove_pod(
                    state, pod, pi, node_info)
        # base feasibility with every lower-priority unit gone
        if self._run_filters(state, pod, node_info) is not None:
            return None
        violating, non_violating = self._split_units_by_pdb(units, pdbs)
        victims: List[v1.Pod] = []
        num_violations = 0

        def reprieve(unit: List[PodInfo]) -> bool:
            for pi in unit:
                node_info.add_pod_info(pi)
                self.handle.run_pre_filter_extension_add_pod(
                    state, pod, pi, node_info)
            if self._run_filters(state, pod, node_info) is None:
                return True  # fits with this unit back — reprieved
            for pi in unit:
                node_info.remove_pod(pi.pod)
                self.handle.run_pre_filter_extension_remove_pod(
                    state, pod, pi, node_info)
            victims.extend(pi.pod for pi in unit)
            return False

        # highest priority first, PDB-violating group first (:633-646)
        for unit in sorted(violating, key=_unit_sort_key):
            if not reprieve(unit):
                num_violations += len(unit)
        for unit in sorted(non_violating, key=_unit_sort_key):
            reprieve(unit)
        if not victims:
            return None
        return Candidate(node_info.node.metadata.name, victims, num_violations)

    def _run_filters(self, state: CycleState, pod: v1.Pod, node_info: NodeInfo):
        nominator = getattr(self.handle, "nominator", None)
        return self.handle.run_filter_plugins_with_nominated_pods(
            state, pod, node_info, nominator
        )

    # -- PDB accounting (:660 filterPodsWithPDBViolation) ------------------

    def _split_by_pdb(
        self, pods: List[PodInfo], pdbs: List[v1.PodDisruptionBudget]
    ) -> Tuple[List[PodInfo], List[PodInfo]]:
        """Consumes allowances in the CALLER'S list order — callers pass
        MoreImportantPod-sorted victims (:612)."""
        if not pdbs:
            return [], list(pods)
        allowed = [p.status.disruptions_allowed for p in pdbs]
        selectors = [
            Selector.from_label_selector(p.spec.selector) if p.spec.selector else None
            for p in pdbs
        ]
        violating, ok = [], []
        for pi in pods:
            pod = pi.pod
            hit = False
            for i, pdb in enumerate(pdbs):
                if pdb.metadata.namespace != pod.metadata.namespace:
                    continue
                sel = selectors[i]
                if sel is None or not sel.matches(pod.metadata.labels):
                    continue
                if allowed[i] <= 0:
                    hit = True
                else:
                    allowed[i] -= 1
            (violating if hit else ok).append(pi)
        return violating, ok

    def _split_units_by_pdb(
        self, units: List[List[PodInfo]], pdbs: List[v1.PodDisruptionBudget]
    ) -> Tuple[List[List[PodInfo]], List[List[PodInfo]]]:
        """_split_by_pdb lifted to eviction units: members consume
        allowances in the caller's unit order (members within a unit in
        their pre-sorted order); a unit is violating when ANY member
        hits an exhausted budget — the whole gang moves to the
        reprieved-last group together."""
        if not pdbs:
            return [], list(units)
        allowed = [p.status.disruptions_allowed for p in pdbs]
        selectors = [
            Selector.from_label_selector(p.spec.selector) if p.spec.selector else None
            for p in pdbs
        ]
        violating, ok = [], []
        for unit in units:
            hit = False
            for pi in unit:
                pod = pi.pod
                for i, pdb in enumerate(pdbs):
                    if pdb.metadata.namespace != pod.metadata.namespace:
                        continue
                    sel = selectors[i]
                    if sel is None or not sel.matches(pod.metadata.labels):
                        continue
                    if allowed[i] <= 0:
                        hit = True
                    else:
                        allowed[i] -= 1
            (violating if hit else ok).append(unit)
        return violating, ok

    # -- candidate choice (:457 pickOneNodeForPreemption) ------------------

    @staticmethod
    def _pick_one(candidates: List[Candidate]) -> Candidate:
        def max_priority(c: Candidate) -> int:
            return max((_pod_priority(p) for p in c.victims), default=0)

        def sum_priorities(c: Candidate) -> int:
            # :497 uses priority+MaxInt32+1 per victim to stay positive;
            # python ints don't overflow, plain sum keeps the same order
            return sum(_pod_priority(p) for p in c.victims)

        def latest_start_of_highest(c: Candidate) -> float:
            hi = max_priority(c)
            return max(
                (p.status.start_time or 0.0 for p in c.victims if _pod_priority(p) == hi),
                default=0.0,
            )

        best = candidates
        for key, reverse in (
            (lambda c: c.num_pdb_violations, False),
            (max_priority, False),
            (sum_priorities, False),
            (lambda c: len(c.victims), False),
            (latest_start_of_highest, True),
        ):
            vals = [key(c) for c in best]
            target = max(vals) if reverse else min(vals)
            best = [c for c, v in zip(best, vals) if v == target]
            if len(best) == 1:
                return best[0]
        return best[0]


def get_lower_priority_nominated_pods(
    nominator, pod: v1.Pod, node_name: str
) -> List[v1.Pod]:
    """:736 getLowerPriorityNominatedPods: nominations to clear after a
    successful preemption."""
    if nominator is None:
        return []
    return [
        p
        for p in nominator.nominated_pods_for_node(node_name)
        if _pod_priority(p) < _pod_priority(pod)
    ]
