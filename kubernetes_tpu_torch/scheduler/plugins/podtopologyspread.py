"""PodTopologySpread helpers the encoders import.

Partial copy of kubernetes_tpu/scheduler/plugins/podtopologyspread.py:
the constraint filter (common.go filterTopologySpreadConstraints) and
the two whenUnsatisfiable actions, not the plugin.
"""

from __future__ import annotations

from typing import List

from ...api import types as v1
from ...api.labels import Selector

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


class _Constraint:
    __slots__ = ("max_skew", "topology_key", "selector")

    def __init__(self, max_skew: int, topology_key: str, selector: Selector):
        self.max_skew = max_skew
        self.topology_key = topology_key
        self.selector = selector


def filter_constraints(
    constraints: List[v1.TopologySpreadConstraint], action: str
) -> List[_Constraint]:
    """common.go filterTopologySpreadConstraints."""
    out = []
    for c in constraints or []:
        if c.when_unsatisfiable == action:
            out.append(
                _Constraint(
                    c.max_skew,
                    c.topology_key,
                    Selector.from_label_selector(c.label_selector),
                )
            )
    return out
