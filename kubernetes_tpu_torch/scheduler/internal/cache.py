"""Scheduler cache: authoritative in-scheduler cluster state.

Reference: pkg/scheduler/internal/cache/cache.go — the assume/confirm/
expire protocol for optimistic binding (:361 AssumePod, :415 ForgetPod,
:443 AddPod confirms, :734 cleanupAssumedPods 30s TTL) and the
generation-based incremental snapshot (:203 UpdateSnapshot: only NodeInfos
whose generation advanced since the last snapshot are re-copied; nodes form
a doubly-linked list, most-recently-updated first, so the scan stops at the
first unchanged entry).

Listeners: the TPU backend registers a CacheListener to mirror every
mutation into its dense ClusterEncoding (models/encoding.py), keeping the
device arrays in lock-step with the cache at O(changed rows) per cycle —
SURVEY.md §7 hard part (a).

Columnar hot state (KTPU_COLUMNAR_CACHE, default on): the cache keeps
per-node utilization rows, allocatable columns and pod/assumed-count
columns as numpy arrays mirroring the device encoding's layout, in
lock-step with the object-level NodeInfo map. The completion worker's
batched assume lands one harvest's decisions as a single vectorized
columnar delta (the host dual of the device-side carry-delta algebra),
and host-priced readers — the shadow sentinel's audit snapshot, the fast
preemption planner's utilization gather, min_pod_priority — read the
columnar state instead of rebuilding object snapshots. Bit-parity
contract: decisions, drift counts and expiry semantics are identical to
the object-path cache (KTPU_COLUMNAR_CACHE=0), pinned by
tests/test_columnar_cache.py and the pipeline-parity A/B.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...api import types as v1
from ...utils import knobs
from ..framework.snapshot import Snapshot
from ..framework.types import (
    ImageStateSummary,
    NodeInfo,
    PodInfo,
    calculate_resource,
)

ASSUME_EXPIRATION_SECONDS = 30.0  # cache.go durationToExpireAssumedPod


def _columnar_default() -> bool:
    return knobs.get_bool("KTPU_COLUMNAR_CACHE")


class CacheListener:
    """Mutation hooks (all called with the cache lock held)."""

    def on_add_pod(self, pod: v1.Pod, node_name: str) -> None: ...
    def on_remove_pod(self, pod: v1.Pod, node_name: str) -> None: ...
    def on_add_node(self, node: v1.Node) -> None: ...
    def on_update_node(self, node: v1.Node) -> None: ...
    def on_remove_node(self, node_name: str) -> None: ...

    def on_assume_pods(self, items: List[Tuple[v1.Pod, str]]) -> None:
        """One batched hook per assume_pods call (columnar path): the
        whole harvest's (pod, node_name) placements at once, so a
        listener can land them as one fused delta instead of N per-pod
        events. Default: per-pod on_add_pod, so listeners that only
        implement the per-pod hooks observe exactly the object-path
        event stream."""
        for pod, node_name in items:
            self.on_add_pod(pod, node_name)

    def on_forget_pods(self, items: List[Tuple[v1.Pod, str]]) -> None:
        """One batched hook per forget_pods call — the retraction dual
        of on_assume_pods: a gang rollback releases every member's
        reserved capacity at once, so a listener can land the whole
        wave as one delta batch. Default: per-pod on_remove_pod."""
        for pod, node_name in items:
            self.on_remove_pod(pod, node_name)


class _PodState:
    __slots__ = ("pod", "deadline", "binding_finished")

    def __init__(self, pod: v1.Pod):
        self.pod = pod
        self.deadline: Optional[float] = None
        self.binding_finished = False


class SchedulerCache:
    def __init__(self, ttl: float = ASSUME_EXPIRATION_SECONDS, now=time.monotonic,
                 columnar: Optional[bool] = None):
        self._lock = threading.RLock()
        self._ttl = ttl
        self._now = now
        self._pod_states: Dict[str, _PodState] = {}  # key -> state (all known pods)
        self._assumed_pods: Dict[str, bool] = {}  # key -> True
        # most-recently-updated FIRST — an OrderedDict used as the cache.go
        # doubly-linked node list (move_to_end(last=False) == moveToHead)
        self._nodes: "OrderedDict[str, NodeInfo]" = OrderedDict()
        self._listeners: List[CacheListener] = []
        # snapshot bookkeeping
        self._last_snapshot_generation: Dict[str, int] = {}
        # foreign-mutation generation: bumped by every state change that
        # did NOT originate from this scheduler's own assume protocol —
        # informer adds/updates/removes, node events, TTL expiry, forget.
        # The shadow parity sentinel compares the value it latched at
        # dispatch against the value at completion: any advance means the
        # completion-time cache is no longer the decision-time state and
        # the oracle replay would adjudicate against a world the device
        # never saw (audit skipped, counted). Own-batch assumes and bind
        # confirmations on the assumed node deliberately do NOT bump:
        # they are exactly the deltas FIFO completion already accounts
        # for.
        self._foreign_mutations = 0
        # incremental priority multiset: count per (spec.priority or 0)
        # over every cached pod, so min_pod_priority is O(distinct
        # priorities) instead of an O(all-pods) scan under the lock per
        # failure wave. Updated at every _pod_states transition.
        self._prio_counts: Dict[int, int] = {}
        # incremental image-spread index (snapshot.go
        # createImageExistenceMap): image name -> holder node names, plus
        # each node's last-seen name->size map for diffing, plus the set
        # of nodes whose NodeInfo.image_states needs re-deriving. Kept on
        # node events so update_snapshot refreshes O(changed) nodes
        # instead of rebuilding the index over ALL nodes.
        self._image_nodes: Dict[str, set] = {}
        self._node_images: Dict[str, Dict[str, int]] = {}
        self._image_dirty: set = set()
        # columnar hot state (mirrors the device encoding's row layout):
        # requested[cpu-milli, memory, ephemeral], non-zero[cpu, mem],
        # alloc[cpu-milli, memory, ephemeral, allowed-pods],
        # counts[pods, assumed]. Rows are swap-compacted on node removal;
        # capacity doubles amortized.
        self._columnar = _columnar_default() if columnar is None else columnar
        self._col_index: Dict[str, int] = {}
        self._col_names: List[str] = []
        self._col_len = 0
        self._col_cap = 0
        self._col_req = np.zeros((0, 3), np.int64)
        self._col_nz = np.zeros((0, 2), np.int64)
        self._col_alloc = np.zeros((0, 4), np.int64)
        self._col_counts = np.zeros((0, 2), np.int64)
        # audit-view clone cache: node name -> (generation, NodeInfo
        # clone). audit_view() re-clones only nodes whose generation
        # advanced — the O(changed) view the shadow sentinel reads.
        self._audit_clones: Dict[str, Tuple[int, NodeInfo]] = {}

    def add_listener(self, listener: CacheListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    @property
    def columnar(self) -> bool:
        return self._columnar

    # -- internal helpers --------------------------------------------------

    def _node_info(self, name: str) -> NodeInfo:
        ni = self._nodes.get(name)
        if ni is None:
            ni = NodeInfo()
            self._nodes[name] = ni
        return ni

    def _touch(self, name: str) -> None:
        """O(1) move-to-head (cache.go moveNodeInfoToHead)."""
        if name in self._nodes:
            self._nodes.move_to_end(name, last=False)

    def _add_pod_locked(self, pod: v1.Pod, node_name: str,
                        pod_info: Optional[PodInfo] = None,
                        res3=None) -> None:
        ni = self._node_info(node_name)
        if pod_info is None:
            pod_info = PodInfo(pod)
        if res3 is None:
            res3 = calculate_resource(pod)
        ni.add_pod_info(pod_info, res3)
        self._touch(node_name)
        if self._columnar:
            self._col_pod_delta(node_name, res3, +1)
        for l in self._listeners:
            l.on_add_pod(pod, node_name)

    def _remove_pod_locked(self, pod: v1.Pod, node_name: str) -> None:
        ni = self._nodes.get(node_name)
        if ni is not None:
            res3 = calculate_resource(pod)
            ni.remove_pod(pod, res3)
            self._touch(node_name)
            if self._columnar:
                self._col_pod_delta(node_name, res3, -1)
        for l in self._listeners:
            l.on_remove_pod(pod, node_name)

    # -- columnar row bookkeeping ------------------------------------------

    def _col_slot(self, name: str) -> int:
        i = self._col_index.get(name)
        if i is not None:
            return i
        if self._col_len == self._col_cap:
            new_cap = max(64, self._col_cap * 2)
            grow = new_cap - self._col_cap
            self._col_req = np.concatenate(
                [self._col_req, np.zeros((grow, 3), np.int64)])
            self._col_nz = np.concatenate(
                [self._col_nz, np.zeros((grow, 2), np.int64)])
            self._col_alloc = np.concatenate(
                [self._col_alloc, np.zeros((grow, 4), np.int64)])
            self._col_counts = np.concatenate(
                [self._col_counts, np.zeros((grow, 2), np.int64)])
            self._col_cap = new_cap
        i = self._col_len
        self._col_len += 1
        self._col_index[name] = i
        self._col_names.append(name)
        return i

    def _col_free(self, name: str) -> None:
        i = self._col_index.pop(name, None)
        if i is None:
            return
        last = self._col_len - 1
        if i != last:
            moved = self._col_names[last]
            self._col_req[i] = self._col_req[last]
            self._col_nz[i] = self._col_nz[last]
            self._col_alloc[i] = self._col_alloc[last]
            self._col_counts[i] = self._col_counts[last]
            self._col_names[i] = moved
            self._col_index[moved] = i
        self._col_names.pop()
        self._col_req[last] = 0
        self._col_nz[last] = 0
        self._col_alloc[last] = 0
        self._col_counts[last] = 0
        self._col_len = last

    def _col_pod_delta(self, node_name: str, res3, sign: int) -> None:
        i = self._col_slot(node_name)
        res, non0_cpu, non0_mem = res3
        self._col_req[i, 0] += sign * res.milli_cpu
        self._col_req[i, 1] += sign * res.memory
        self._col_req[i, 2] += sign * res.ephemeral_storage
        self._col_nz[i, 0] += sign * non0_cpu
        self._col_nz[i, 1] += sign * non0_mem
        self._col_counts[i, 0] += sign

    def _col_assumed_delta(self, node_name: str, delta: int) -> None:
        if not self._columnar:
            return
        i = self._col_index.get(node_name)
        if i is not None:
            self._col_counts[i, 1] += delta

    # -- priority multiset (min_pod_priority O(1)) -------------------------

    def _prio_add(self, pod: v1.Pod) -> None:
        p = pod.spec.priority or 0
        self._prio_counts[p] = self._prio_counts.get(p, 0) + 1

    def _prio_remove(self, pod: v1.Pod) -> None:
        p = pod.spec.priority or 0
        n = self._prio_counts.get(p, 0) - 1
        if n <= 0:
            self._prio_counts.pop(p, None)
        else:
            self._prio_counts[p] = n

    # -- assume protocol (cache.go:361-441) --------------------------------

    def assume_pod(self, pod: v1.Pod) -> None:
        key = v1.pod_key(pod)
        with self._lock:
            if key in self._pod_states:
                raise ValueError(f"pod {key} is in the cache, so can't be assumed")
            self._add_pod_locked(pod, pod.spec.node_name)
            ps = _PodState(pod)
            self._pod_states[key] = ps
            self._assumed_pods[key] = True
            self._prio_add(pod)
            self._col_assumed_delta(pod.spec.node_name, +1)

    def assume_pods(self, pods: List[v1.Pod]) -> List[bool]:
        """Batch AssumePod under ONE lock acquisition (the TPU batch path
        assumes thousands of pods per cycle; per-pod locking ping-pongs
        with the binder threads' finish_binding). Returns per-pod success;
        False = already in the cache (informer raced us), same condition
        assume_pod raises ValueError for.

        Columnar path: each pod's PodInfo and Quantity parse happen
        exactly ONCE (shared between the NodeInfo writeback and the
        columnar rows), the whole harvest lands on the columnar arrays as
        a single vectorized delta, and listeners get ONE batched
        on_assume_pods instead of N per-pod on_add_pod calls — the host
        dual of the device-side carry-delta fold."""
        if not self._columnar:
            return self._assume_pods_object(pods)
        out: List[bool] = []
        with self._lock:
            accepted: List[Tuple[v1.Pod, str]] = []
            rows: List[Tuple[int, Tuple]] = []  # (col row, res3)
            for pod in pods:
                key = v1.pod_key(pod)
                if key in self._pod_states:
                    out.append(False)
                    continue
                node_name = pod.spec.node_name
                pod_info = PodInfo(pod)
                res3 = calculate_resource(pod)
                self._node_info(node_name).add_pod_info(pod_info, res3)
                self._touch(node_name)
                self._pod_states[key] = _PodState(pod)
                self._assumed_pods[key] = True
                self._prio_add(pod)
                rows.append((self._col_slot(node_name), res3))
                accepted.append((pod, node_name))
                out.append(True)
            if accepted:
                k = len(accepted)
                idx = np.empty(k, np.int64)
                dreq = np.empty((k, 3), np.int64)
                dnz = np.empty((k, 2), np.int64)
                for j, (slot, (res, non0_cpu, non0_mem)) in enumerate(rows):
                    idx[j] = slot
                    dreq[j, 0] = res.milli_cpu
                    dreq[j, 1] = res.memory
                    dreq[j, 2] = res.ephemeral_storage
                    dnz[j, 0] = non0_cpu
                    dnz[j, 1] = non0_mem
                np.add.at(self._col_req, idx, dreq)
                np.add.at(self._col_nz, idx, dnz)
                # pods and assumed both +1 per placement
                np.add.at(self._col_counts, idx, 1)
                for l in self._listeners:
                    l.on_assume_pods(accepted)
        return out

    def _assume_pods_object(self, pods: List[v1.Pod]) -> List[bool]:
        """The per-pod object path (KTPU_COLUMNAR_CACHE=0 kill switch):
        N _add_pod_locked walks with per-pod listener events — the
        bit-parity reference the columnar path is pinned against."""
        out: List[bool] = []
        with self._lock:
            for pod in pods:
                key = v1.pod_key(pod)
                if key in self._pod_states:
                    out.append(False)
                    continue
                self._add_pod_locked(pod, pod.spec.node_name)
                self._pod_states[key] = _PodState(pod)
                self._assumed_pods[key] = True
                self._prio_add(pod)
                out.append(True)
        return out

    def finish_binding(self, pod: v1.Pod) -> None:
        key = v1.pod_key(pod)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps is not None and self._assumed_pods.get(key):
                ps.binding_finished = True
                ps.deadline = self._now() + self._ttl

    def finish_binding_many(self, pods: List[v1.Pod]) -> None:
        """Batch FinishBinding under one lock acquisition. pod_key is
        computed once per pod (it walks metadata twice per call)."""
        with self._lock:
            deadline = self._now() + self._ttl
            states = self._pod_states
            assumed = self._assumed_pods
            for pod in pods:
                key = v1.pod_key(pod)
                ps = states.get(key)
                if ps is not None and assumed.get(key):
                    ps.binding_finished = True
                    ps.deadline = deadline

    def forget_pod(self, pod: v1.Pod) -> None:
        key = v1.pod_key(pod)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps is None:
                return
            if self._assumed_pods.get(key):
                self._col_assumed_delta(ps.pod.spec.node_name, -1)
                self._remove_pod_locked(ps.pod, ps.pod.spec.node_name)
                self._prio_remove(ps.pod)
                del self._pod_states[key]
                del self._assumed_pods[key]
                # a retracted assume breaks the FIFO accounting the
                # sentinel relies on — later in-flight batches decided
                # WITH this placement
                self._foreign_mutations += 1
            else:
                raise ValueError(f"pod {key} wasn't assumed so cannot be forgotten")

    def forget_pods(self, pods: List[v1.Pod]) -> None:
        """Batch forget_pod under ONE lock acquisition with ONE batched
        listener event (on_forget_pods): a gang rollback retracts every
        member's assumed placement as one wave, and the device-session
        listener absorbs the whole wave as one carry-delta batch
        instead of N per-pod removes. Pods not assumed (already
        forgotten, or never assumed) are skipped — rollback paths race
        informer echoes and must stay idempotent."""
        with self._lock:
            dropped: List[Tuple[v1.Pod, str]] = []
            for pod in pods:
                key = v1.pod_key(pod)
                ps = self._pod_states.get(key)
                if ps is None or not self._assumed_pods.get(key):
                    continue
                node_name = ps.pod.spec.node_name
                self._col_assumed_delta(node_name, -1)
                ni = self._nodes.get(node_name)
                if ni is not None:
                    res3 = calculate_resource(ps.pod)
                    ni.remove_pod(ps.pod, res3)
                    self._touch(node_name)
                    if self._columnar:
                        self._col_pod_delta(node_name, res3, -1)
                self._prio_remove(ps.pod)
                del self._pod_states[key]
                del self._assumed_pods[key]
                self._foreign_mutations += 1
                dropped.append((ps.pod, node_name))
            if dropped:
                for l in self._listeners:
                    l.on_forget_pods(dropped)

    def is_assumed_pod(self, pod: v1.Pod) -> bool:
        with self._lock:
            return bool(self._assumed_pods.get(v1.pod_key(pod)))

    def has_pod(self, key: str) -> bool:
        """Membership test by key — O(1), for callers (the Coscheduling
        prune) that would otherwise list_pods() + set-build per check."""
        with self._lock:
            return key in self._pod_states

    def min_pod_priority(self) -> int:
        """Lowest spec.priority among cached pods (0 when empty). A
        preemption dry-run can only evict strictly-lower-priority victims
        (defaultpreemption selectVictimsOnNode), so an incoming pod whose
        priority is <= this floor provably finds none — callers use that
        to skip the per-pod failure-status re-dispatch. O(distinct
        priorities) off the incremental multiset, not an O(all-pods)
        scan under the lock (tests/test_columnar_cache.py pins the
        multiset against the scan under random churn)."""
        with self._lock:
            if not self._prio_counts:
                return 0
            return min(self._prio_counts)

    # -- confirmed state from informers (cache.go:443-560) -----------------

    def add_pod(self, pod: v1.Pod) -> None:
        key = v1.pod_key(pod)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps is not None and self._assumed_pods.get(key):
                if ps.pod.spec.node_name != pod.spec.node_name:
                    # scheduler sent it elsewhere; informer wins (cache.go:455)
                    self._remove_pod_locked(ps.pod, ps.pod.spec.node_name)
                    self._add_pod_locked(pod, pod.spec.node_name)
                    self._foreign_mutations += 1
                # confirm on the assumed node: no state change, no bump
                self._col_assumed_delta(ps.pod.spec.node_name, -1)
                self._assumed_pods.pop(key, None)
                ps.deadline = None
                self._prio_remove(ps.pod)
                ps.pod = pod
                self._prio_add(pod)
            elif ps is None:
                self._add_pod_locked(pod, pod.spec.node_name)
                self._pod_states[key] = _PodState(pod)
                self._prio_add(pod)
                self._foreign_mutations += 1
            # else: duplicate add; ignore

    def update_pod(self, old: v1.Pod, new: v1.Pod) -> None:
        key = v1.pod_key(old)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps is None or self._assumed_pods.get(key):
                return
            # a listener may hold the removal until the add, so that both
            # reach it as one change (on_update_pod_begin and
            # on_update_pod_end; ROADMAP.md Queue 3)
            for l in self._listeners:
                getattr(l, "on_update_pod_begin", lambda pod: None)(ps.pod)
            self._remove_pod_locked(ps.pod, ps.pod.spec.node_name)
            self._add_pod_locked(new, new.spec.node_name)
            for l in self._listeners:
                getattr(l, "on_update_pod_end", lambda pod: None)(new)
            self._prio_remove(ps.pod)
            ps.pod = new
            self._prio_add(new)
            self._foreign_mutations += 1

    def remove_pod(self, pod: v1.Pod) -> None:
        key = v1.pod_key(pod)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps is None:
                return
            if self._assumed_pods.get(key):
                self._col_assumed_delta(ps.pod.spec.node_name, -1)
            self._remove_pod_locked(ps.pod, ps.pod.spec.node_name)
            self._prio_remove(ps.pod)
            del self._pod_states[key]
            self._assumed_pods.pop(key, None)
            self._foreign_mutations += 1

    def cleanup_expired_assumed_pods(self) -> int:
        """cache.go:734 cleanupAssumedPods: expire assumed pods whose
        binding finished but confirmation never arrived. Expiry routes
        through _remove_pod_locked like any other remove, so every
        CacheListener sees it — a live device session absorbs it as a
        carry-delta remove instead of drifting from the cache
        (tests/test_session_deltas.py pins expiry bit-identical to a
        rebuild). Returns the number expired; each one is a bind that
        was sent and never informer-confirmed, so the counter
        (scheduler_cache_expired_assumes_total) is a lost-bind signal,
        not bookkeeping. Also refreshes the assumed-pod gauges the
        endurance soak's TTL invariant reads."""
        from ..metrics import assumed_pods, expired_assumes, oldest_assume_age

        now = self._now()
        expired = 0
        oldest_age = 0.0
        with self._lock:
            for key in list(self._assumed_pods):
                ps = self._pod_states[key]
                if ps.binding_finished and ps.deadline is not None and now >= ps.deadline:
                    self._col_assumed_delta(ps.pod.spec.node_name, -1)
                    self._remove_pod_locked(ps.pod, ps.pod.spec.node_name)
                    self._prio_remove(ps.pod)
                    del self._pod_states[key]
                    del self._assumed_pods[key]
                    self._foreign_mutations += 1
                    expired += 1
                elif ps.binding_finished and ps.deadline is not None:
                    # age past bind-finish of the oldest survivor: if
                    # this ever exceeds ttl + a few sweep periods, the
                    # sweep itself is stalled
                    oldest_age = max(
                        oldest_age, now - (ps.deadline - self._ttl))
            assumed_pods.set(len(self._assumed_pods))
        oldest_assume_age.set(oldest_age)
        if expired:
            expired_assumes.inc(expired)
        return expired

    # -- nodes (cache.go:562-650) ------------------------------------------

    def _set_node_locked(self, node: v1.Node) -> NodeInfo:
        name = node.metadata.name
        ni = self._node_info(name)
        ni.set_node(node)
        self._touch(name)
        self._foreign_mutations += 1
        if self._columnar:
            i = self._col_slot(name)
            alloc = ni.allocatable
            self._col_alloc[i, 0] = alloc.milli_cpu
            self._col_alloc[i, 1] = alloc.memory
            self._col_alloc[i, 2] = alloc.ephemeral_storage
            self._col_alloc[i, 3] = alloc.allowed_pod_number
        self._note_node_images_locked(node)
        return ni

    def add_node(self, node: v1.Node) -> None:
        with self._lock:
            self._set_node_locked(node)
            for l in self._listeners:
                l.on_add_node(node)

    def update_node(self, node: v1.Node) -> None:
        with self._lock:
            self._set_node_locked(node)
            for l in self._listeners:
                l.on_update_node(node)

    def remove_node(self, node_name: str) -> None:
        with self._lock:
            ni = self._nodes.pop(node_name, None)
            if ni is None:
                return
            self._last_snapshot_generation.pop(node_name, None)
            self._foreign_mutations += 1
            if self._columnar:
                self._col_free(node_name)
            self._audit_clones.pop(node_name, None)
            self._drop_node_images_locked(node_name)
            for l in self._listeners:
                l.on_remove_node(node_name)

    # -- incremental image-spread index ------------------------------------

    def _note_node_images_locked(self, node: v1.Node) -> None:
        """Diff this node's image set against its last-seen one and fold
        the change into the spread index. Nodes whose ImageStateSummary
        num_nodes moved (the holders of a gained/lost image) plus the
        node itself become dirty — exactly the O(changed) set whose
        image_states need re-deriving."""
        name = node.metadata.name
        new: Dict[str, int] = {}
        for image in node.status.images or []:
            for nm in image.names or []:
                new[nm] = image.size_bytes
        old = self._node_images.get(name)
        if old != new:
            for nm in (old or {}):
                if nm not in new:
                    holders = self._image_nodes.get(nm)
                    if holders is not None:
                        holders.discard(name)
                        if holders:
                            self._image_dirty.update(holders)
                        else:
                            del self._image_nodes[nm]
            for nm in new:
                if old is None or nm not in old:
                    holders = self._image_nodes.setdefault(nm, set())
                    holders.add(name)
                    self._image_dirty.update(holders)
            self._node_images[name] = new
        # the node itself always refreshes: set_node may have been
        # preceded by a remove (fresh NodeInfo, empty image_states)
        self._image_dirty.add(name)

    def _drop_node_images_locked(self, name: str) -> None:
        old = self._node_images.pop(name, None)
        self._image_dirty.discard(name)
        if old:
            for nm in old:
                holders = self._image_nodes.get(nm)
                if holders is not None:
                    holders.discard(name)
                    if holders:
                        self._image_dirty.update(holders)
                    else:
                        del self._image_nodes[nm]

    def _refresh_image_states_locked(self) -> None:
        """Re-derive NodeInfo.image_states for dirty nodes only
        (snapshot.go createImageExistenceMap semantics: per-node size,
        cluster-wide holder count). The satellite replacing the full
        rebuild update_snapshot used to run over ALL nodes on any
        membership change; tests/test_columnar_cache.py pins equivalence
        against the full rebuild."""
        if not self._image_dirty:
            return
        for name in self._image_dirty:
            ni = self._nodes.get(name)
            if ni is None or ni.node is None:
                continue
            states: Dict[str, ImageStateSummary] = {}
            for image in ni.node.status.images or []:
                for nm in image.names or []:
                    holders = self._image_nodes.get(nm)
                    states[nm] = ImageStateSummary(
                        image.size_bytes, len(holders) if holders else 0
                    )
            ni.image_states = states
            # image_states changed without a generation bump: the audit
            # clone for this node is stale
            self._audit_clones.pop(name, None)
        self._image_dirty.clear()

    def foreign_mutations(self) -> int:
        """Current foreign-mutation generation (see __init__). Latched at
        dispatch onto the batch handle; the shadow sentinel audits only
        when it is unchanged at completion."""
        with self._lock:
            return self._foreign_mutations

    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def pod_count(self) -> int:
        with self._lock:
            return len(self._pod_states)

    def list_pods(self) -> List[v1.Pod]:
        """All known pods, assumed included (cache.go ListPods). Used by the
        Coscheduling Permit plugin to count reserved gang members."""
        with self._lock:
            return [s.pod for s in self._pod_states.values()]

    def dump(self) -> "Tuple[List[v1.Node], List[v1.Pod]]":
        """One consistent read of the raw cluster objects: every node and
        every PLACED pod (assumed included). The shadow parity sentinel's
        object-path read — unlike update_snapshot it touches no generation
        bookkeeping (a throwaway snapshot from the completion worker must
        not starve the scheduling thread's incremental refreshes) and
        shares no NodeInfos (callers rebuild their own)."""
        with self._lock:
            nodes = [
                ni.node for ni in self._nodes.values() if ni.node is not None
            ]
            pods = [
                pi.pod for ni in self._nodes.values() for pi in ni.pods
            ]
            return nodes, pods

    def audit_view(self) -> Optional[List[NodeInfo]]:
        """Cheap O(changed) audit snapshot (columnar mode): cloned
        NodeInfos sharing immutable PodInfos — no PodInfo construction,
        no Quantity re-parse, unlike dump() + Snapshot.from_objects which
        rebuilt every NodeInfo from raw objects per audited batch. Clones
        are cached per node and re-taken only when the node's generation
        advanced; callers must treat the returned NodeInfos as READ-ONLY
        (the shadow sentinel copy-on-writes its prefix overlays). Node
        order matches dump(). None when columnar is off — callers fall
        back to the object path."""
        if not self._columnar:
            return None
        with self._lock:
            self._refresh_image_states_locked()
            out: List[NodeInfo] = []
            clones = self._audit_clones
            for name, ni in self._nodes.items():
                if ni.node is None:
                    continue
                c = clones.get(name)
                if c is None or c[0] != ni.generation:
                    clone = ni.clone()
                    clones[name] = (ni.generation, clone)
                else:
                    clone = c[1]
                out.append(clone)
            return out

    def utilization_view(self, names: List[str]) -> Optional[Dict]:
        """Columnar utilization rows gathered in the given node order —
        the fast preemption planner's wave-book seed (one fancy-index
        gather instead of a per-node Python attribute walk). Arrays are
        copies (fancy indexing), stable against later cache mutation.
        None when columnar is off or a name has no row (caller falls
        back to the object walk)."""
        if not self._columnar:
            return None
        with self._lock:
            n = len(names)
            idx = np.empty(n, np.int64)
            col_index = self._col_index
            for j, name in enumerate(names):
                i = col_index.get(name)
                if i is None:
                    return None
                idx[j] = i
            return {
                "names": list(names),
                "requested": self._col_req[idx],
                "nz": self._col_nz[idx],
                "alloc": self._col_alloc[idx, :3],
                "allowed_pods": self._col_alloc[idx, 3],
                "pod_count": self._col_counts[idx, 0],
                "assumed": self._col_counts[idx, 1],
            }

    # -- snapshot (cache.go:203 UpdateSnapshot) ----------------------------

    def update_snapshot(self, snapshot: Snapshot) -> Snapshot:
        """Incremental: only NodeInfos whose generation advanced since this
        snapshot's last update are re-referenced; node list rebuilt only on
        membership change. NodeInfos are shared references — the scheduling
        cycle treats them as read-only for the cycle (the reference clones;
        we rely on the cycle not mutating, enforced by convention+tests).
        The image-spread index refresh is O(dirty nodes), not a full
        rebuild (see _refresh_image_states_locked)."""
        with self._lock:
            changed = False
            for name in self._nodes:
                ni = self._nodes.get(name)
                if ni is None or ni.node is None:
                    continue
                last = self._last_snapshot_generation.get(name)
                if last is not None and last >= ni.generation:
                    break  # list is MRU-first: the rest are unchanged
                self._last_snapshot_generation[name] = ni.generation
                changed = True
            names_with_node = [
                n for n, ni in self._nodes.items() if ni.node is not None
            ]
            if changed or len(snapshot.node_info_list) != len(names_with_node):
                self._refresh_image_states_locked()
                new_snap = Snapshot([self._nodes[n] for n in names_with_node])
                new_snap.generation = snapshot.generation + 1
                if self._columnar:
                    # one consistent columnar gather rides the snapshot:
                    # the preemption planner's utilization seed
                    new_snap.columnar_util = self.utilization_view(
                        names_with_node)
                return new_snap
            return snapshot
