"""Shared plugin helpers.

Reference: pkg/scheduler/framework/plugins/helper/normalize_score.go.
"""

from __future__ import annotations

from typing import List

from ..framework.interface import NodeScore


def default_normalize_score(max_priority: int, reverse: bool, scores: List[NodeScore]) -> None:
    """normalize_score.go:26 DefaultNormalizeScore: scale to [0, max], int64
    division; reverse subtracts from max."""
    max_count = 0
    for ns in scores:
        if ns.score > max_count:
            max_count = ns.score
    if max_count == 0:
        if reverse:
            for ns in scores:
                ns.score = max_priority
        return
    for ns in scores:
        score = max_priority * ns.score // max_count
        if reverse:
            score = max_priority - score
        ns.score = score
