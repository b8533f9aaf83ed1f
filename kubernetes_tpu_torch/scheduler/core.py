"""Core scheduling algorithm: snapshot -> prefilter -> filter -> score -> select.

Reference: pkg/scheduler/core/generic_scheduler.go —
  Schedule (:95), findNodesThatFitPod (:201), findNodesThatPassFilters
  (:235) with the adaptive numFeasibleNodesToFind (:177: 50% - nodes/125,
  floor 5%, min 100) and the rotating nextStartNodeIndex, prioritizeNodes
  (:342), selectHost (:152, reservoir sampling across max-score ties).

This CPU path is the semantic oracle. The TPU path (ops/, parallel/)
replaces findNodesThatPassFilters + RunScorePlugins with one XLA dispatch
over all nodes — no subsampling — and must produce identical decisions when
percentageOfNodesToScore=100.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from ..api.types import Node, Pod
from .framework.interface import CycleState, FitError, NodeScore, Status
from .framework.runtime import Framework
from .framework.snapshot import Snapshot

MIN_FEASIBLE_NODES_TO_FIND = 100  # generic_scheduler.go:45
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5  # generic_scheduler.go:50


class ScheduleResult:
    __slots__ = ("suggested_host", "evaluated_nodes", "feasible_nodes")

    def __init__(self, suggested_host: str, evaluated_nodes: int, feasible_nodes: int):
        self.suggested_host = suggested_host
        self.evaluated_nodes = evaluated_nodes
        self.feasible_nodes = feasible_nodes


class GenericScheduler:
    def __init__(
        self,
        percentage_of_nodes_to_score: int = 0,
        extenders: Optional[list] = None,
        rng: Optional[random.Random] = None,
    ):
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.extenders = extenders or []
        self.next_start_node_index = 0
        self.rng = rng or random.Random()

    # -- entry point (generic_scheduler.go:95 Schedule) --------------------
    def schedule(
        self,
        state: CycleState,
        fwk: Framework,
        pod: Pod,
        snapshot: Snapshot,
        nominator=None,
    ) -> ScheduleResult:
        if snapshot.num_nodes() == 0:
            raise FitError(pod, 0, {})
        feasible_nodes, filtered_statuses = self.find_nodes_that_fit_pod(
            state, fwk, pod, snapshot, nominator
        )
        if not feasible_nodes:
            raise FitError(pod, snapshot.num_nodes(), filtered_statuses)
        if len(feasible_nodes) == 1:
            return ScheduleResult(
                feasible_nodes[0].metadata.name,
                1 + len(filtered_statuses),
                1,
            )
        priority_list = self.prioritize_nodes(state, fwk, pod, feasible_nodes)
        host = self.select_host(priority_list)
        return ScheduleResult(
            host, len(feasible_nodes) + len(filtered_statuses), len(feasible_nodes)
        )

    # -- filtering ---------------------------------------------------------
    def num_feasible_nodes_to_find(self, num_all_nodes: int) -> int:
        """generic_scheduler.go:177 adaptive subsampling."""
        if (
            num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND
            or self.percentage_of_nodes_to_score >= 100
        ):
            return num_all_nodes
        adaptive = self.percentage_of_nodes_to_score
        if adaptive <= 0:
            adaptive = 50 - num_all_nodes // 125
            if adaptive < MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND:
                adaptive = MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND
        num_nodes = num_all_nodes * adaptive // 100
        return max(num_nodes, MIN_FEASIBLE_NODES_TO_FIND)

    def find_nodes_that_fit_pod(
        self, state: CycleState, fwk: Framework, pod: Pod, snapshot: Snapshot, nominator
    ) -> Tuple[List[Node], Dict[str, Status]]:
        """generic_scheduler.go:201 findNodesThatFitPod."""
        filtered_statuses: Dict[str, Status] = {}
        status = fwk.run_pre_filter_plugins(state, pod)
        if status is not None and not status.is_success():
            if status.is_unschedulable():
                # all nodes share the prefilter rejection (:215)
                for ni in snapshot.list():
                    filtered_statuses[ni.node.metadata.name] = status
                raise FitError(pod, snapshot.num_nodes(), filtered_statuses)
            raise RuntimeError(f"prefilter error: {status.message()}")
        feasible = self._find_nodes_that_pass_filters(
            state, fwk, pod, snapshot, filtered_statuses, nominator
        )
        feasible = self._find_nodes_that_pass_extenders(pod, feasible, filtered_statuses)
        return feasible, filtered_statuses

    def _find_nodes_that_pass_filters(
        self, state, fwk, pod, snapshot, filtered_statuses, nominator
    ) -> List[Node]:
        """generic_scheduler.go:235: rotate start index; stop at numNodesToFind."""
        all_nodes = snapshot.list()
        num_all = len(all_nodes)
        num_to_find = self.num_feasible_nodes_to_find(num_all)
        feasible: List[Node] = []
        if not fwk.has_filter_plugins():
            start = self.next_start_node_index
            for i in range(num_to_find):
                feasible.append(all_nodes[(start + i) % num_all].node)
            self.next_start_node_index = (start + num_to_find) % num_all
            return feasible
        processed = 0
        for i in range(num_all):
            node_info = all_nodes[(self.next_start_node_index + i) % num_all]
            processed += 1
            status = fwk.run_filter_plugins_with_nominated_pods(
                state, pod, node_info, nominator
            )
            if status is None:
                feasible.append(node_info.node)
                if len(feasible) >= num_to_find:
                    break
            else:
                if not status.is_unschedulable():
                    raise RuntimeError(f"filter error: {status.message()}")
                filtered_statuses[node_info.node.metadata.name] = status
        self.next_start_node_index = (self.next_start_node_index + processed) % num_all
        return feasible

    def _find_nodes_that_pass_extenders(
        self, pod: Pod, feasible: List[Node], filtered_statuses: Dict[str, Status]
    ) -> List[Node]:
        """generic_scheduler.go:307 — HTTP extender Filter round-trips."""
        for extender in self.extenders:
            if not feasible:
                break
            if not extender.is_interested(pod):
                continue
            feasible, failed = extender.filter(pod, feasible)
            for name, reason in failed.items():
                filtered_statuses[name] = Status.unschedulable(
                    f"FailedExtenderFilter: {reason}"
                )
        return feasible

    # -- scoring -----------------------------------------------------------
    def prioritize_nodes(
        self, state: CycleState, fwk: Framework, pod: Pod, nodes: List[Node]
    ) -> List[NodeScore]:
        """generic_scheduler.go:342 prioritizeNodes."""
        if not self.extenders and not fwk.has_score_plugins():
            return [NodeScore(n.metadata.name, 1) for n in nodes]
        status = fwk.run_pre_score_plugins(state, pod, nodes)
        if status is not None and not status.is_success():
            raise RuntimeError(f"prescore error: {status.message()}")
        scores_map, status = fwk.run_score_plugins(state, pod, nodes)
        if status is not None and not status.is_success():
            raise RuntimeError(f"score error: {status.message()}")
        result = [NodeScore(n.metadata.name, 0) for n in nodes]
        for i in range(len(nodes)):
            for plugin_scores in scores_map.values():
                result[i].score += plugin_scores[i].score
        if self.extenders:
            combined: Dict[str, int] = {ns.name: 0 for ns in result}
            for extender in self.extenders:
                if not extender.is_interested(pod):
                    continue
                prioritized, weight = extender.prioritize(pod, nodes)
                for host_priority in prioritized:
                    combined[host_priority["host"]] += host_priority["score"] * weight
            for ns in result:
                ns.score += combined[ns.name]
        return result

    def select_host(self, node_score_list: List[NodeScore]) -> str:
        """generic_scheduler.go:152 selectHost — reservoir sampling over ties."""
        if not node_score_list:
            raise ValueError("empty priorityList")
        max_score = node_score_list[0].score
        selected = node_score_list[0].name
        cnt_of_max = 1
        for ns in node_score_list[1:]:
            if ns.score > max_score:
                max_score = ns.score
                selected = ns.name
                cnt_of_max = 1
            elif ns.score == max_score:
                cnt_of_max += 1
                if self.rng.randrange(cnt_of_max) == 0:
                    selected = ns.name
        return selected
