"""String/tuple interning for the dense cluster encoding.

Every categorical dimension of cluster state (label pairs, label keys,
taints, ports, images, namespaces, scalar resource names) is interned into
a dense integer vocabulary so that per-node / per-pod state becomes boolean
or integer matrices the XLA kernel can gather from.

Id 0 is reserved as the "never matches" sentinel: column 0 of every
per-entity matrix stays False/zero, so compiled requirement tables can pad
with 0 and unknown strings resolve to 0 without branching in the kernel.

Reference analogy: the Go scheduler matches label strings directly per node
(e.g. labels.Selector.Matches, reference
staging/src/k8s.io/apimachinery/pkg/labels/selector.go); the TPU build
pre-resolves all strings host-side once so the device never sees them.
"""

from __future__ import annotations

import os
from typing import Dict, Hashable, Iterable, List, Optional

from ..utils import knobs


def node_headroom() -> float:
    """Growth headroom fraction for the node axis (`KTPU_NODE_HEADROOM`,
    default 0): capacity targets n*(1+headroom) at rebuild time, so node
    adds land in pre-padded tail lanes instead of forcing a rebuild —
    the delta-class envelope for churn at 100k nodes."""
    return max(0.0, knobs.get_float("KTPU_NODE_HEADROOM"))


def bucket_capacity(n: int, minimum: int = 8) -> int:
    """Round up to the next capacity bucket (1.5x geometric growth).

    Array dimensions are padded to buckets so vocab growth triggers few
    recompiles (SURVEY.md section 7 hard part (b): dynamic shapes).
    """
    cap = minimum
    while cap < n:
        cap = cap + (cap >> 1)
    return cap


class Interner:
    """Hashable -> dense id, starting at 1 (0 = null / never matches)."""

    __slots__ = ("_ids", "_items")

    def __init__(self) -> None:
        self._ids: Dict[Hashable, int] = {}
        self._items: List[Hashable] = []

    def intern(self, key: Hashable) -> int:
        i = self._ids.get(key)
        if i is None:
            i = len(self._items) + 1
            self._ids[key] = i
            self._items.append(key)
        return i

    def get(self, key: Hashable) -> int:
        """Id of key, or 0 (the never-matches sentinel) if unknown."""
        return self._ids.get(key, 0)

    def intern_all(self, keys: Iterable[Hashable]) -> List[int]:
        return [self.intern(k) for k in keys]

    def item(self, i: int) -> Optional[Hashable]:
        """Inverse lookup; id 0 -> None."""
        if i <= 0 or i > len(self._items):
            return None
        return self._items[i - 1]

    @property
    def size(self) -> int:
        """Number of slots including the null slot (= max id + 1)."""
        return len(self._items) + 1

    @property
    def capacity(self) -> int:
        """Bucketed array width that fits every current id."""
        return bucket_capacity(self.size)

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._ids
