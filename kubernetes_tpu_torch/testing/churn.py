"""Cluster churn as session deltas, for callers that drive a ScanSession
without the backend (chip_smoke.py, the tests).

These are the reference backend's session-delta classifiers
(kubernetes_tpu/scheduler/tpu_backend.py: `_pod_self_rows` :1134,
`_pod_structural` :1156, `_queue_pod_delta` :1175, `_queue_alloc_patch`
:1054) as functions of an encoding and a live session: each runs the
encoding mutation and returns the delta the session absorbs through
`apply_deltas`, or None where the event is structural and only a rebuild
of the session is exact. The backend's queue cap
(`KTPU_MAX_QUEUED_DELTAS`) is the caller's. They move into the port's
TPUBackend when the backend is ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..api import types as v1
from ..models.encoding import ClusterEncoding
from ..ops.hoisted import ipa_term_match_np, match_matrices_np


def pod_self_rows(enc: ClusterEncoding, pod: v1.Pod) -> Dict:
    """The pod's label/namespace bit rows at current vocab widths — what
    match_matrices_np and the term-match classifier evaluate. Built with
    get() (never intern): a label pair the vocab has never seen cannot
    appear in any compiled selector, so the zero sentinel is exact."""
    pp = np.zeros(enc.pod_pair_vocab.capacity, bool)
    pk = np.zeros(enc.pod_key_vocab.capacity, bool)
    for k, val in (pod.metadata.labels or {}).items():
        kid = enc.pod_key_vocab.get(k)
        pid = enc.pod_pair_vocab.get((k, val))
        if kid:
            pk[kid] = True
        if pid:
            pp[pid] = True
    return {
        "self_ppair": pp, "self_pkey": pk,
        "self_ns": np.int32(enc.ns_vocab.get(pod.metadata.namespace)),
    }


def pod_structural(pod: v1.Pod) -> bool:
    """Pods whose assume/remove touches term/port tables."""
    from ..scheduler.framework.types import PodInfo

    pi = PodInfo(pod)
    if (
        pi.required_affinity_terms
        or pi.required_anti_affinity_terms
        or pi.preferred_affinity_terms
        or pi.preferred_anti_affinity_terms
    ):
        return True
    return any(
        port.host_port > 0
        for c in pod.spec.containers
        for port in c.ports or []
    )


def pod_delta(sess, enc: ClusterEncoding, pod: v1.Pod, node_name: str,
              sign: int, mutate: Callable[[], None]) -> Optional[Dict]:
    """Run `mutate` (the encoding update of a pod bound to, sign +1, or
    removed from, sign -1, `node_name`) and classify the event against the
    live session: the carry delta, or None when it is structural. The
    utilization delta is the encoding's row diff around the mutation."""
    snap = None
    nidx = None
    if (
        not enc._rebuild_needed
        # a remove must hit the row the encoding actually holds
        and (sign > 0
             or enc._pods.get(v1.pod_key(pod), (None, node_name))[1]
             == node_name)
    ):
        nidx = enc.node_index.get(node_name)
        if nidx is not None:
            A = enc._arrays
            snap = (
                A["requested"][nidx].copy(),
                A["nz_requested"][nidx].copy(),
                int(A["pod_count"][nidx]),
            )
    mutate()
    if snap is None or enc._rebuild_needed:
        return None  # structural: unknown node or capacity growth
    if pod_structural(pod):
        return None
    rows = pod_self_rows(enc, pod)
    if sess.dyn_ipa and ipa_term_match_np(sess._term_np, rows):
        # the pod counts toward a template's own-term statics
        return None
    A = enc._arrays
    dres = A["requested"][nidx] - snap[0]
    dnz = A["nz_requested"][nidx] - snap[1]
    dcount = int(A["pod_count"][nidx]) - snap[2]
    if not sess.delta_compatible(dres, dnz):
        return None  # int32 / GCD envelope
    t_n = sess._tp_np["self_ns"].shape[0]
    c_n = sess._tp_np["ptsf_op"].shape[1]
    if pod.metadata.deletion_timestamp is not None:
        # terminating pods never enter the prologue's PTS counts; only
        # utilization moves
        mf = np.zeros((t_n, c_n), np.int32)
        ms = np.zeros((t_n, c_n), np.int32)
    else:
        mfa, msa = match_matrices_np(sess._tp_np, [rows])
        mf = mfa[:, 0, :].astype(np.int32) * sign
        ms = msa[:, 0, :].astype(np.int32) * sign
    return {
        "kind": "pod-add" if sign > 0 else "pod-remove",
        "node": nidx, "dres": dres, "dnz": dnz, "dcount": dcount,
        "mf": mf, "ms": ms,
    }


def alloc_patch(sess, enc: ClusterEncoding, node: v1.Node) -> Optional[Dict]:
    """An update of a known node: when ONLY its allocatable/capacity moved,
    the encoding row is updated in place and the node-alloc patch is
    returned; None when the update is structural (anything else in the
    fingerprint moved, the encoding cannot update the row in place, or
    the session's GCD envelope refuses it — the encoding row is then
    already patched, as the backend leaves it)."""
    old = ClusterEncoding.node_fingerprint(enc._nodes[node.metadata.name])
    fp = ClusterEncoding.node_fingerprint(node)
    # fingerprint slots: labels, avoid-annotation, taints, unschedulable,
    # alloc, images — everything but alloc equal
    if enc._rebuild_needed or old[:4] != fp[:4] or old[5] != fp[5]:
        return None
    got = enc.update_node_alloc(node)
    if got is None:
        return None
    dalloc, dallowed = got
    if not sess.delta_compatible(dalloc, np.zeros(2, np.int64)):
        return None
    return {"kind": "node-alloc", "node": enc.node_index[node.metadata.name],
            "dalloc": dalloc, "dallowed": dallowed}
