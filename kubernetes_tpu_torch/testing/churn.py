"""Cluster churn as session deltas, for callers that drive a session
without the backend (chip_smoke.py, the tests).

Thin wrappers over the backend's classifiers
(scheduler/tpu_backend.py: `pod_self_rows`, `pod_structural`,
`pod_delta`, `alloc_patch`, which its `_queue_pod_delta` and
`_queue_alloc_patch` run): each runs the encoding mutation and returns
the delta the session absorbs through `apply_deltas`, or None where the
event is structural and only a rebuild of the session is exact. The
backend's queue cap (`KTPU_MAX_QUEUED_DELTAS`) is the caller's.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api import types as v1
from ..models.encoding import ClusterEncoding
from ..scheduler import tpu_backend
from ..scheduler.tpu_backend import pod_delta, pod_self_rows, pod_structural

__all__ = ["alloc_patch", "pod_delta", "pod_self_rows", "pod_structural"]


def alloc_patch(sess, enc: ClusterEncoding, node: v1.Node) -> Optional[Dict]:
    """An update of a known node: when ONLY its allocatable/capacity moved,
    the encoding row is updated in place and the node-alloc patch is
    returned; None when the update is structural (anything else in the
    fingerprint moved, the encoding cannot update the row in place, or
    the session's GCD envelope refuses it — the encoding row is then
    already patched, as the backend leaves it)."""
    old = ClusterEncoding.node_fingerprint(enc._nodes[node.metadata.name])
    fp = ClusterEncoding.node_fingerprint(node)
    _, delta = tpu_backend.alloc_patch(sess, enc, node, old, fp)
    return delta
