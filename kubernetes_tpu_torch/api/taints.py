"""Taint / toleration matching.

Reference: staging/src/k8s.io/api/core/v1/toleration.go ToleratesTaint and
pkg/apis/core/v1/helper/helpers.go TolerationsTolerateTaint /
FindMatchingUntoleratedTaint — used by the TaintToleration plugin
(pkg/scheduler/framework/plugins/tainttoleration/taint_toleration.go:55).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from .types import Taint, Toleration

TAINT_EFFECT_NO_SCHEDULE = "NoSchedule"
TAINT_EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_EFFECT_NO_EXECUTE = "NoExecute"

TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"


def toleration_tolerates_taint(toleration: Toleration, taint: Taint) -> bool:
    """toleration.go:30 ToleratesTaint."""
    if toleration.effect and toleration.effect != taint.effect:
        return False
    if toleration.key and toleration.key != taint.key:
        return False
    # an empty key with operator Exists matches all keys
    if toleration.operator == TOLERATION_OP_EXISTS:
        return True
    if toleration.operator in ("", TOLERATION_OP_EQUAL):
        return toleration.value == taint.value
    return False


def tolerations_tolerate_taint(
    tolerations: Optional[List[Toleration]], taint: Taint
) -> bool:
    return any(toleration_tolerates_taint(t, taint) for t in tolerations or [])


def find_matching_untolerated_taint(
    taints: Optional[List[Taint]],
    tolerations: Optional[List[Toleration]],
    inclusion_filter: Optional[Callable[[Taint], bool]] = None,
) -> Tuple[Optional[Taint], bool]:
    """helpers.go FindMatchingUntoleratedTaint: first filtered taint not
    tolerated; returns (taint, True) if found."""
    for taint in taints or []:
        if inclusion_filter is not None and not inclusion_filter(taint):
            continue
        if not tolerations_tolerate_taint(tolerations, taint):
            return taint, True
    return None, False
