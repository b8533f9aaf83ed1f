"""Scheduling Framework plugin API.

Reimplements the extension-point contract of the reference's Scheduling
Framework (reference: pkg/scheduler/framework/interface.go):

  QueueSort, PreFilter (+ AddPod/RemovePod extensions), Filter, PostFilter,
  PreScore, Score (+ NormalizeScore), Reserve, Permit, PreBind, Bind, PostBind

Status codes preserve the Unschedulable vs UnschedulableAndUnresolvable
distinction (interface.go:74-93) that preemption relies on; scores are int64
in [MIN_NODE_SCORE, MAX_NODE_SCORE] (interface.go:95-103).
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence, Tuple

from ...api.types import Node, Pod

MAX_NODE_SCORE = 100  # interface.go:95 MaxNodeScore
MIN_NODE_SCORE = 0
MAX_TOTAL_SCORE = (1 << 63) - 1  # interface.go:101 MaxTotalScore (math.MaxInt64)


class Code(enum.IntEnum):
    """Status codes (interface.go:36-70)."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5


class Status:
    """Result of running a plugin (interface.go:106). None == Success."""

    __slots__ = ("code", "reasons", "failed_plugin")

    def __init__(self, code: Code = Code.SUCCESS, reasons: Optional[List[str]] = None):
        self.code = code
        self.reasons = reasons or []
        self.failed_plugin = ""

    @classmethod
    def success(cls) -> Optional["Status"]:
        return None

    @classmethod
    def unschedulable(cls, *reasons: str) -> "Status":
        return cls(Code.UNSCHEDULABLE, list(reasons))

    @classmethod
    def unschedulable_and_unresolvable(cls, *reasons: str) -> "Status":
        return cls(Code.UNSCHEDULABLE_AND_UNRESOLVABLE, list(reasons))

    @classmethod
    def error(cls, *reasons: str) -> "Status":
        return cls(Code.ERROR, list(reasons))

    @classmethod
    def wait(cls, *reasons: str) -> "Status":
        return cls(Code.WAIT, list(reasons))

    @classmethod
    def skip(cls) -> "Status":
        return cls(Code.SKIP)

    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def is_unschedulable(self) -> bool:
        return self.code in (Code.UNSCHEDULABLE, Code.UNSCHEDULABLE_AND_UNRESOLVABLE)

    def message(self) -> str:
        return ", ".join(self.reasons)

    def __repr__(self) -> str:
        return f"Status({self.code.name}, {self.reasons})"


def is_success(status: Optional[Status]) -> bool:
    return status is None or status.is_success()


class CycleState:
    """Per-scheduling-cycle key/value store plugins use to pass state between
    extension points (reference: pkg/scheduler/framework/cycle_state.go)."""

    __slots__ = ("data", "record_plugin_metrics", "skip_filter_plugins", "skip_score_plugins")

    def __init__(self):
        self.data: Dict[str, object] = {}
        self.record_plugin_metrics = False
        self.skip_filter_plugins: set = set()
        self.skip_score_plugins: set = set()

    def read(self, key: str):
        if key not in self.data:
            raise KeyError(f"{key} is not found in CycleState")
        return self.data[key]

    def write(self, key: str, value) -> None:
        self.data[key] = value

    def delete(self, key: str) -> None:
        self.data.pop(key, None)

    def clone(self) -> "CycleState":
        c = CycleState()
        # StateData.Clone: our state objects are treated as immutable once
        # written except where a plugin's Clone() deep-copies (preemption).
        for k, v in self.data.items():
            clone = getattr(v, "clone", None)
            c.data[k] = clone() if callable(clone) else v
        return c


# ---------------------------------------------------------------------------
# Plugin interfaces. Python duck-typing replaces Go interface assertions: a
# plugin participates in an extension point iff it defines the method.


class Plugin:
    name: str = ""


class QueueSortPlugin(Plugin):
    def less(self, pod_info1, pod_info2) -> bool:  # QueuedPodInfo
        raise NotImplementedError


class PreFilterPlugin(Plugin):
    def pre_filter(self, state: CycleState, pod: Pod) -> Optional[Status]:
        raise NotImplementedError

    # PreFilterExtensions (interface.go:243): return self to opt in.
    def pre_filter_extensions(self) -> Optional["PreFilterPlugin"]:
        return None

    def add_pod(self, state, pod_to_schedule, pod_info_to_add, node_info) -> Optional[Status]:
        return None

    def remove_pod(self, state, pod_to_schedule, pod_info_to_remove, node_info) -> Optional[Status]:
        return None


class FilterPlugin(Plugin):
    def filter(self, state: CycleState, pod: Pod, node_info) -> Optional[Status]:
        raise NotImplementedError


class PostFilterPlugin(Plugin):
    def post_filter(self, state: CycleState, pod: Pod, filtered_node_status_map) -> Tuple[Optional[object], Optional[Status]]:
        raise NotImplementedError


class PreScorePlugin(Plugin):
    def pre_score(self, state: CycleState, pod: Pod, nodes: Sequence[Node]) -> Optional[Status]:
        raise NotImplementedError


class ScorePlugin(Plugin):
    def score(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        raise NotImplementedError

    # ScoreExtensions: normalize_score presence opts in.
    def normalize_score(self, state: CycleState, pod: Pod, scores: List["NodeScore"]) -> Optional[Status]:
        return None

    has_normalize = False


class ReservePlugin(Plugin):
    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        raise NotImplementedError

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        pass


class PermitPlugin(Plugin):
    def permit(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[Optional[Status], float]:
        """Returns (status, timeout_seconds). Wait status parks the pod."""
        raise NotImplementedError


class PreBindPlugin(Plugin):
    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        raise NotImplementedError


class BindPlugin(Plugin):
    def bind(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        raise NotImplementedError


class PostBindPlugin(Plugin):
    def post_bind(self, state: CycleState, pod: Pod, node_name: str) -> None:
        raise NotImplementedError


class NodeScore:
    __slots__ = ("name", "score")

    def __init__(self, name: str, score: int):
        self.name = name
        self.score = score

    def __repr__(self):
        return f"NodeScore({self.name}={self.score})"


class FitError(Exception):
    """Scheduling failure with per-node statuses (framework/types.go:95)."""

    def __init__(self, pod: Pod, num_all_nodes: int, filtered_nodes_statuses: Dict[str, Status]):
        self.pod = pod
        self.num_all_nodes = num_all_nodes
        self.filtered_nodes_statuses = filtered_nodes_statuses
        super().__init__(
            f"0/{num_all_nodes} nodes are available for pod "
            f"{pod.metadata.namespace}/{pod.metadata.name}"
        )
