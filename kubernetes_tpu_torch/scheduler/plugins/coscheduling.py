"""Coscheduling (gang scheduling) Permit plugin.

The reference has no in-tree gang plugin — Permit + PodNominator were
designed to host exactly this as an out-of-tree plugin (reference:
pkg/scheduler/framework/interface.go:384 PermitPlugin; the
sig-scheduling coscheduling plugin is the canonical consumer). Semantics
implemented here:

  * pods opt in with labels `scheduling.k8s.io/group-name` and
    `scheduling.k8s.io/min-available`;
  * Permit counts the gang's members that are already reserved (assumed
    or bound in the scheduler cache) plus those parked at Permit; while
    the count is below min-available the pod WAITs (holding its
    reservation) up to the configured timeout;
  * the member that completes the gang allows every waiting member;
  * when a member is rejected, deleted, or unreserved, the whole gang
    rolls back so partial gangs don't hold capacity.

Gang admission is a TRANSACTION, arbitrated by a single-assignment
``GangGate`` per waiting wave: the gate flips exactly once, to
``completed`` (the completing member commits, every waiting member is
allowed, they bind as one batch) or to ``failed`` (timeout, member
deletion/rejection, deadlock back-off, reconcile, device fault — the
whole wave is rejected and every member requeues). A permit timeout
firing concurrently with gang completion is therefore deterministic:
whichever side flips the gate wins whole — the loser observes the flip
and stands down (``WaitingPod._try_timeout`` yields to a completed
gate; a completing member whose ``gate.complete()`` loses bounces and
requeues with its siblings). The pre-gate implementation had a
documented self-healing race here (a timed-out member stayed counted
as reserved until its unreserve); the gate closes it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from ...api import types as v1
from .. import metrics
from ..framework import interface as fwk
from ..framework.interface import CycleState, Status

GROUP_LABEL = "scheduling.k8s.io/group-name"
MIN_AVAILABLE_LABEL = "scheduling.k8s.io/min-available"

DEFAULT_PERMIT_TIMEOUT = 60.0


def pod_group(pod: v1.Pod) -> Tuple[str, int]:
    """(group name, min available) — ("", 0) for non-gang pods.

    Annotations take precedence over labels. The label form matches the
    out-of-tree coscheduling convention; the annotation form exists
    because labels enter the pod's encoded self rows (models/pod_encoder)
    — a per-gang label value makes every gang a distinct template and
    defeats template hoisting, while gang identity itself is invisible to
    filter/score (it only gates Permit, host-side)."""
    meta = pod.metadata
    sources = (meta.annotations or {}, meta.labels or {})
    group = next((s[GROUP_LABEL] for s in sources if s.get(GROUP_LABEL)), "")
    if not group:
        return "", 0
    raw = next(
        (s[MIN_AVAILABLE_LABEL] for s in sources if s.get(MIN_AVAILABLE_LABEL)),
        "0",
    )
    try:
        min_available = int(raw)
    except ValueError:
        min_available = 0
    return group, min_available


class GangGate:
    """Single-assignment resolution arbiter for one gang WAVE (the set
    of members parked at Permit between two resolutions). The gate is
    the transaction's commit point: ``complete()`` and ``fail()`` race,
    exactly one flips the state, and both sides act only on the flip
    they own — all-or-nothing falls out of single assignment."""

    WAITING = "waiting"
    COMPLETED = "completed"
    FAILED = "failed"

    def __init__(self, namespace: str, group: str, min_available: int,
                 on_fail=None):
        self.namespace = namespace
        self.group = group
        self.min_available = min_available
        self._lock = threading.Lock()
        self.state = self.WAITING
        self.reason: Optional[str] = None
        self.message = ""
        self.first_park: Optional[float] = None
        self.member_keys: Set[str] = set()
        self._on_fail = on_fail

    def note_parked(self, key: str, now: float) -> None:
        with self._lock:
            self.member_keys.add(key)
            if self.first_park is None:
                self.first_park = now

    def complete(self) -> bool:
        """Commit the wave. True exactly once; False if the wave
        already failed (or someone else committed) — the caller must
        NOT bind."""
        with self._lock:
            if self.state != self.WAITING:
                return False
            self.state = self.COMPLETED
            return True

    def fail(self, reason: str = "timeout", message: str = "") -> bool:
        """Roll the wave back. True when the wave is failed (by this
        call or an earlier one) — the caller may resolve members as
        failed; False when completion won the race — the caller must
        stand down (the committing thread's allow() is in flight). The
        on_fail cascade (reject every waiting member, count the
        rollback) fires exactly once, on the flip, outside the lock."""
        fire = False
        with self._lock:
            if self.state == self.COMPLETED:
                return False
            if self.state == self.WAITING:
                self.state = self.FAILED
                self.reason = reason
                self.message = message
                fire = True
        if fire and self._on_fail is not None:
            self._on_fail(self)
        return True

    @property
    def failed(self) -> bool:
        with self._lock:
            return self.state == self.FAILED

    def has_member(self, key: str) -> bool:
        with self._lock:
            return key in self.member_keys

    def members(self) -> Set[str]:
        """Snapshot of the wave's parked member keys (safe to iterate;
        the live set mutates under the gate lock)."""
        with self._lock:
            return set(self.member_keys)

    def age(self, now: float) -> float:
        with self._lock:
            if self.first_park is None:
                return 0.0
            return now - self.first_park


class Coscheduling(fwk.PermitPlugin, fwk.ReservePlugin):
    """Must be enabled at BOTH the permit and reserve extension points:
    reserve maintains the per-group membership index and unreserve performs
    the gang-wide rejection (through the wave gate, so it is atomic with
    completion)."""

    name = "Coscheduling"

    def __init__(self, args=None, handle=None):
        self._handle = handle
        args = args or {}
        self._timeout = float(args.get("permit_timeout_seconds", DEFAULT_PERMIT_TIMEOUT))
        self._lock = threading.Lock()
        # (namespace, group) -> set of pod keys that passed Reserve and were
        # not unreserved — O(group) permit counting instead of scanning the
        # whole scheduler cache per permit
        self._groups: dict = {}
        # (namespace, group) -> GangGate for the CURRENT waiting wave;
        # failed gates are popped by the on_fail cascade so a fresh wave
        # starts clean
        self._gates: Dict[Tuple[str, str], GangGate] = {}
        self._reserve_count = 0
        # committed-gang admission latencies (first park -> commit), the
        # exact-sample source for the harness's gang_admission_p99 (the
        # histogram on /metricsz is bucketed; bench wants exact)
        self.admission_samples = deque(maxlen=100_000)

    # -- counting ----------------------------------------------------------

    def _reserved_members(self, group: str, namespace: str, prune: bool = False) -> int:
        """Gang members holding a reservation (passed Reserve, not
        unreserved): assumed or bound pods. With prune=True, members the
        scheduler cache no longer knows (bound then deleted, forgotten)
        are dropped first — O(group) key lookups (cache.has_pod), not an
        O(cache) list+set build: at gang scale a batch completes ~100
        gangs, and the per-completion full-cache scan was a measurable
        slice of the wave cadence."""
        cache = getattr(self._handle, "cache", None)
        with self._lock:
            members = set(self._groups.get((namespace, group), ()))
        if prune and cache is not None and members:
            if hasattr(cache, "has_pod"):
                stale = {k for k in members if not cache.has_pod(k)}
            else:
                known = {v1.pod_key(p) for p in cache.list_pods()}
                stale = members - known
            if stale:
                with self._lock:
                    live = self._groups.get((namespace, group))
                    if live is not None:
                        live -= stale
                members -= stale
        return len(members)

    def _waiting_members(self, group: str, namespace: str):
        """Waiting pods of THIS gang: waiting members are a subset of the
        reserved-member index, so O(group) get_waiting_pod lookups beat
        scanning every parked pod in the scheduler (at 1000 parked pods x
        100 completions per batch the full scan dominated the permit
        path)."""
        handle = self._handle
        if handle is None:
            return []
        if hasattr(handle, "get_waiting_pod"):
            with self._lock:
                members = list(self._groups.get((namespace, group), ()))
            out = []
            for key in members:
                wp = handle.get_waiting_pod(key)
                if wp is not None:
                    out.append(wp)
            return out
        if not hasattr(handle, "iterate_waiting_pods"):
            return []
        out = []
        for wp in handle.iterate_waiting_pods():
            if wp.pod.metadata.namespace != namespace:
                continue
            g, _ = pod_group(wp.pod)
            if g == group:
                out.append(wp)
        return out

    # -- gates -------------------------------------------------------------

    def on_waiting(self, wp) -> None:
        """Framework hook: a member of ours just parked (run_permit_plugins
        published its WaitingPod). Attach the current wave's gate so the
        permit timeout and gang completion arbitrate through it, and
        record the park for admission latency + wave membership."""
        pod = wp.pod
        group, min_available = pod_group(pod)
        if not group or min_available <= 1:
            return
        namespace = pod.metadata.namespace
        with self._lock:
            gate = self._gates.get((namespace, group))
            if gate is None:
                gate = GangGate(namespace, group, min_available,
                                on_fail=self._on_gate_failed)
                self._gates[(namespace, group)] = gate
        gate.note_parked(v1.pod_key(pod), time.monotonic())
        wp.set_gate(gate)

    def _on_gate_failed(self, gate: GangGate) -> None:
        """The fail() flip's cascade — runs exactly once per wave, on
        whichever thread won the flip (timeout drainer, unreserve,
        delete handler, deadlock breaker, reconcile). Pops the gate
        (next wave starts clean), drops the
        wave's members from the reserved index so a late member can't
        count dead reservations toward a new completion, counts the
        rollback once, and rejects every still-waiting member — the
        whole gang requeues, never a prefix."""
        gkey = (gate.namespace, gate.group)
        wave = gate.members()
        with self._lock:
            if self._gates.get(gkey) is gate:
                del self._gates[gkey]
            members = self._groups.get(gkey)
            if members is not None:
                members -= wave
        metrics.gang_rollbacks.inc(reason=gate.reason or "timeout")
        msg = gate.message or (
            f"gang {gate.group!r} wave rolled back ({gate.reason})"
        )
        # enumerate the waiting members from the WAVE snapshot, not the
        # reserved index — the index was just pruned above, and an
        # index-driven lookup here would reject nobody (the members
        # would camp parked until their permit timeouts fired)
        for wp in self._waiting_pods_of(wave, gate.group, gate.namespace):
            wp.reject(self.name, msg)

    def _waiting_pods_of(self, keys: Set[str], group: str, namespace: str):
        """Waiting pods for an explicit key set (a failed wave's
        snapshot): O(wave) get_waiting_pod lookups, with the
        iterate_waiting_pods fallback for unit-test fakes."""
        handle = self._handle
        if handle is None:
            return []
        if hasattr(handle, "get_waiting_pod"):
            out = []
            for key in keys:
                wp = handle.get_waiting_pod(key)
                if wp is not None:
                    out.append(wp)
            return out
        if not hasattr(handle, "iterate_waiting_pods"):
            return []
        out = []
        for wp in handle.iterate_waiting_pods():
            if wp.pod.metadata.namespace != namespace:
                continue
            g, _ = pod_group(wp.pod)
            if g == group:
                out.append(wp)
        return out

    def reject_gang(self, namespace: str, group: str, reason: str,
                    message: str = "") -> bool:
        """Scheduler-side whole-gang rollback (deadlock breaker, member
        deletion, device fault, demotion, reconcile). True when a
        waiting wave was rolled back by this call or an earlier one;
        False when there is no waiting wave or it already committed."""
        with self._lock:
            gate = self._gates.get((namespace, group))
        if gate is None:
            return False
        return gate.fail(reason=reason, message=message)

    def reject_gang_of(self, pod: v1.Pod, reason: str,
                       message: str = "") -> bool:
        group, min_available = pod_group(pod)
        if not group or min_available <= 1:
            return False
        return self.reject_gang(pod.metadata.namespace, group, reason,
                                message=message)

    def waiting_gangs(self) -> List[GangGate]:
        """Snapshot of the waves currently parked at Permit (deadlock
        breaker + promotion reconcile input)."""
        with self._lock:
            return list(self._gates.values())

    def seed_reserved(self, pod: v1.Pod) -> None:
        """Promotion reconcile adoption: a BOUND gang member from a prior
        leader enters the reserved index so re-driven siblings can
        rejoin it instead of waiting for a full fresh wave that will
        never assemble (restart parity for partially-bound gangs)."""
        group, min_available = pod_group(pod)
        if not group or min_available <= 1:
            return
        with self._lock:
            self._groups.setdefault(
                (pod.metadata.namespace, group), set()
            ).add(v1.pod_key(pod))

    # -- Permit ------------------------------------------------------------

    def permit(self, state: CycleState, pod: v1.Pod, node_name: str) -> Tuple[Optional[Status], float]:
        group, min_available = pod_group(pod)
        if not group:
            return None, 0
        if min_available < 1:
            # a grouped pod with a missing/garbled min-available label must
            # not silently bind solo while its siblings wait on it forever —
            # surface the misconfiguration
            metrics.gang_rejected.inc(reason="invalid")
            return (
                Status.unschedulable_and_unresolvable(
                    f"gang {group!r}: invalid or missing "
                    f"{MIN_AVAILABLE_LABEL} label"
                ),
                0,
            )
        if min_available == 1:
            return None, 0
        namespace = pod.metadata.namespace
        with self._lock:
            gate = self._gates.get((namespace, group))
        if gate is not None and gate.failed:
            # the current wave is mid-rollback (the on_fail cascade pops
            # the gate momentarily): joining it would hand this member a
            # reservation nobody will complete — requeue with the rest
            metrics.gang_rejected.inc(reason="late")
            return (
                Status.unschedulable(
                    f"gang {group!r}: wave rolled back while joining"
                ),
                0,
            )
        # the reserved index includes this pod (Reserve ran) and the waiting
        # pods (they reserved too): total == index size
        total = self._reserved_members(group, namespace)
        if total >= min_available:
            # about to complete: re-count with pruning so stale members
            # (deleted after binding) can't fake a full gang
            total = self._reserved_members(group, namespace, prune=True)
        if total >= min_available:
            if gate is not None:
                if not gate.complete():
                    # a timeout/rollback flipped the gate first: the wave
                    # is dead, this member bounces and requeues with its
                    # siblings (its unreserve finds the gate already
                    # failed — no double-count)
                    return (
                        Status.unschedulable(
                            f"gang {group!r}: wave failed while completing"
                        ),
                        0,
                    )
                # committed: the gate is spent — pop it so the next wave
                # (if this gang ever re-forms) starts clean
                with self._lock:
                    if self._gates.get((namespace, group)) is gate:
                        del self._gates[(namespace, group)]
                metrics.gang_admitted.inc()
                if gate.first_park is not None:
                    dt = max(0.0, time.monotonic() - gate.first_park)
                    metrics.gang_admission_duration.observe(dt)
                    self.admission_samples.append(dt)
            for wp in self._waiting_members(group, namespace):
                wp.allow(self.name)
            return None, 0
        return Status.wait(f"gang {group!r}: {total}/{min_available} members"), self._timeout

    # -- Reserve/Unreserve -------------------------------------------------

    # sweep the whole index every N reserves so groups whose pods are long
    # gone (bound then deleted) don't accumulate forever
    _SWEEP_EVERY = 256

    def reserve(self, state: CycleState, pod: v1.Pod, node_name: str) -> Optional[Status]:
        group, min_available = pod_group(pod)
        if not group or min_available <= 1:
            return None
        with self._lock:
            self._groups.setdefault(
                (pod.metadata.namespace, group), set()
            ).add(v1.pod_key(pod))
            self._reserve_count += 1
            sweep = self._reserve_count % self._SWEEP_EVERY == 0
        if sweep:
            self._sweep()
        return None

    def _sweep(self) -> None:
        cache = getattr(self._handle, "cache", None)
        if cache is None:
            return
        known = {v1.pod_key(p) for p in cache.list_pods()}
        with self._lock:
            waiting = set()
            for gate in self._gates.values():
                waiting |= gate.members()
            for key in list(self._groups):
                self._groups[key] &= known | waiting
                if not self._groups[key]:
                    del self._groups[key]

    def unreserve(self, state: CycleState, pod: v1.Pod, node_name: str) -> None:
        """A member failed after Reserve: drop it from the index and roll
        the whole waiting wave back (through the gate, so a concurrent
        completion is arbitrated instead of raced) — a partial gang must
        not camp on capacity until every timeout fires."""
        group, min_available = pod_group(pod)
        if not group or min_available <= 1:
            return
        namespace = pod.metadata.namespace
        key = v1.pod_key(pod)
        with self._lock:
            members = self._groups.get((namespace, group))
            if members is not None:
                members.discard(key)
            gate = self._gates.get((namespace, group))
        if gate is not None:
            # only a member of the CURRENT wave takes the wave down with
            # it: a prior wave's members drain their unreserves through
            # the binder/drainer threads after the rollback already
            # started a fresh wave, and those stragglers must not keep
            # killing every new wave (livelock)
            if gate.has_member(key):
                gate.fail(
                    reason="member-rejected",
                    message=f"gang member {pod.metadata.name!r} was "
                            f"unreserved",
                )
            return
        # no live gate (unit-test fakes drive unreserve directly, or the
        # wave already resolved): fall back to direct rejection
        for wp in self._waiting_members(group, namespace):
            wp.reject(self.name, f"gang member {pod.metadata.name!r} was unreserved")
