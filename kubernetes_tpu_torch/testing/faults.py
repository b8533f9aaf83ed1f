"""Deterministic fault seam for the scheduling backend.

Port of kubernetes_tpu/testing/faults.py (FaultInjector), for the
backend's fault drills: the hooks are the reference's, and
`corrupt_harvest` reads a tensor payload back to the host with `.cpu()`
(np.asarray refuses a CUDA tensor) and returns tensors. The gang and
bind integrity checkers are the reference's: they watch a pods informer
of the scheduler loop.

The backend holds an OPTIONAL `faults` attribute and calls the hooks
below at the natural fault points; production code never imports this
module — the seam is duck-typed, `None` means no injection.

Kinds:

  raise-dispatch   the next device dispatch raises (a launch error)
  raise-whatif     the next preemption what-if launch raises — the
                   planner must fall one rung (device -> fast/oracle)
                   with no victim double-claim and no live-session
                   invalidation (the PR-7 drill)
  nan-harvest      the next harvested payload is corrupted (NaN floats /
                   saturated ints) BEFORE decode — must be caught by the
                   backend's finite/in-range validation guard
  wedge-wait       device waits report not-ready until the dispatch
                   watchdog fires (a hung wait / a lost card)
  kill-scheduler   the scheduling loop thread dies at its next iteration
  kill-completion  the completion worker dies before its next batch
  stall-completion the completion worker sleeps `stall_delay` seconds
                   before its next batch — a transient SLOW host (GC
                   pause, noisy neighbor, audit tax), not a dead one.
                   The overload monitor must see the FIFO age climb,
                   shed optional work, and restore once shots run out
                   (the ChaosMonkey "overload" disruption's engine)

Faults are armed with a shot count (`-1` = until disarm) and optionally a
`min_rung` (scheduler/degradation.py rung constants): a kernel-only
bug is modeled as `min_rung=RUNG_KERNEL` — dispatches and probes
at or above that rung fault, lower rungs run clean, which is exactly the
shape the degradation ladder must survive. `injected` counts every fired
fault per kind; tests assert recovery against it (the ground-truth role
plan.injected played for the HTTP fault plan).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

KINDS = (
    "raise-dispatch",
    "raise-whatif",
    "nan-harvest",
    "wedge-wait",
    "kill-scheduler",
    "kill-completion",
    "stall-completion",
)


class InjectedFault(RuntimeError):
    """Raised by on_dispatch when raise-dispatch is armed; the backend
    treats it like any other device-path exception."""


class _Armed:
    __slots__ = ("shots", "min_rung")

    def __init__(self, shots: int, min_rung: Optional[int]):
        self.shots = shots
        self.min_rung = min_rung


class FaultInjector:
    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, _Armed] = {}
        self.injected: Dict[str, int] = {}
        # per-batch sleep while stall-completion is armed (seconds)
        self.stall_delay = 0.25

    # -- arming ------------------------------------------------------------

    def arm(self, kind: str, shots: int = 1,
            min_rung: Optional[int] = None) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if min_rung is not None and kind == "wedge-wait":
            # a wedged wait has no dispatch-rung context (wedge_active()
            # is polled from inside the wait loop), so a rung-filtered
            # wedge would wedge every rung but never consume its shot —
            # a permanent outage masquerading as a transient fault
            raise ValueError("wedge-wait does not support min_rung")
        with self._lock:
            self._armed[kind] = _Armed(shots, min_rung)

    def disarm(self, kind: Optional[str] = None) -> None:
        with self._lock:
            if kind is None:
                self._armed.clear()
            else:
                self._armed.pop(kind, None)

    def armed(self, kind: str) -> bool:
        with self._lock:
            return kind in self._armed

    def _take(self, kind: str, rung: Optional[int] = None) -> bool:
        """Consume one shot of `kind` if armed (and the rung filter
        passes); counts the injection."""
        with self._lock:
            a = self._armed.get(kind)
            if a is None:
                return False
            if a.min_rung is not None and (rung is None or rung < a.min_rung):
                return False
            if a.shots > 0:
                a.shots -= 1
                if a.shots == 0:
                    del self._armed[kind]
            self.injected[kind] = self.injected.get(kind, 0) + 1
            return True

    # -- hooks (called by tpu_backend / scheduler) -------------------------

    def on_dispatch(self, rung: Optional[int] = None,
                    probe: bool = False) -> None:
        """Called right before every device dispatch (and every ladder
        probe, with the rung the probe vouches for)."""
        if self._take("raise-dispatch", rung):
            raise InjectedFault(
                f"injected dispatch failure (probe={probe}, rung={rung})"
            )

    def on_whatif(self) -> None:
        """Called right before every preemption what-if launch
        (tpu_backend.check_whatif_fault)."""
        if self._take("raise-whatif"):
            raise InjectedFault("injected what-if launch failure")

    def corrupt_harvest(self, ys, rung: Optional[int] = None):
        """Possibly corrupt one harvested payload: float leaves -> NaN,
        int leaves -> dtype max (out of any node-index range). Returns a
        corrupted COPY (tensor leaves as CPU tensors); the original
        device tensors are untouched."""
        if not self._take("nan-harvest", rung):
            return ys
        if not isinstance(ys, dict):
            return ys
        bad = dict(ys)
        for k, v in ys.items():
            if isinstance(v, torch.Tensor):
                # one explicit readback: np.asarray cannot take a tensor
                # that lives on the card
                a = v.detach().cpu().numpy()
            elif np.ndim(v) == 0 and not hasattr(v, "dtype"):
                continue  # host scalars ("n", "_b_real") steer decode
            else:
                try:
                    a = np.asarray(v)
                except Exception:  # noqa: BLE001 — leave non-arrays alone
                    continue
            if a.dtype.kind == "f":
                bad[k] = np.full_like(a, np.nan)
            elif a.dtype.kind in "iu":
                bad[k] = np.full_like(a, np.iinfo(a.dtype).max)
            else:
                continue
            if isinstance(v, torch.Tensor):
                bad[k] = torch.from_numpy(bad[k])
        return bad

    def wedge_active(self) -> bool:
        """True while wedge-wait is armed: device waits must report
        not-ready (the watchdog, not this hook, ends the wedge). Does not
        consume a shot — one shot covers one full wedged wait."""
        with self._lock:
            return "wedge-wait" in self._armed

    def consume_wedge(self) -> None:
        """The wedged wait hit its watchdog: the shot fired; release it
        so the retry path finds a responsive device. (arm() guarantees
        wedge-wait carries no rung filter, so _take consumes cleanly.)"""
        self._take("wedge-wait")

    def take_kill(self, worker: str) -> bool:
        """worker = "scheduler" | "completion"; True means the caller
        must die now (it raises scheduler.WorkerKilled)."""
        return self._take(f"kill-{worker}")

    def on_completion(self) -> None:
        """Called at the top of every batch completion. While
        stall-completion is armed the worker sleeps stall_delay per
        batch (one shot = one stalled batch) — the synthetic form of a
        host that is ALIVE but too slow, which is what the overload
        monitor sheds against."""
        if self._take("stall-completion"):
            import time

            time.sleep(self.stall_delay)


class GangIntegrityChecker:
    """Gang atomicity monitor for fault drills: a gang is always
    all-bound, all-waiting, or all-rolled-back — never TORN (some live
    members holding a binding while sibling members sit unbound) for
    longer than `grace` seconds. Transient partials
    are legal and expected: a committed wave binds as one batch but the
    apiserver echoes its bindings one watch event at a time, and a
    killed member's ReplicaSet replacement takes a moment to reserve and
    re-complete the gang (bound siblings stay in the Coscheduling
    reserved index, so the replacement counts them and the gang heals).
    The grace window absorbs both; a gang that STAYS partial past it is
    exactly the torn state the permit/rollback protocol exists to
    prevent. Attach to any pods informer; read `violations` after the
    drill and assert `partial_gangs()` is empty once converged."""

    def __init__(self, grace: float = 15.0):
        self.grace = grace
        self._lock = threading.Lock()
        # (namespace, group) -> {pod key: bound?} over LIVE members
        # (deleting/deleted members left the gang — they are the
        # rolled-back third of the invariant, not a partial state)
        self._members: Dict[str, Dict[str, bool]] = {}
        self._min_avail: Dict[str, int] = {}
        self._partial_since: Dict[str, float] = {}
        self._flagged: set = set()
        self.violations = []

    def attach(self, pods_informer) -> "GangIntegrityChecker":
        from ..client.informer import EventHandler

        pods_informer.add_event_handler(EventHandler(
            on_add=self._on_add,
            on_update=self._on_update,
            on_delete=self._on_delete,
        ))
        return self

    @staticmethod
    def _gang_of(pod):
        from ..scheduler.plugins.coscheduling import pod_group

        group, min_available = pod_group(pod)
        if not group or min_available <= 1:
            return None, 0
        return (pod.metadata.namespace, group), min_available

    def _on_add(self, pod) -> None:
        self._observe(pod)

    def _on_update(self, old, new) -> None:
        self._observe(new)

    def _on_delete(self, pod) -> None:
        gk, _ = self._gang_of(pod)
        if gk is None:
            return
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        with self._lock:
            members = self._members.get(gk)
            if members is not None:
                members.pop(key, None)
                if not members:
                    self._members.pop(gk, None)
                    self._min_avail.pop(gk, None)
            self._scan_locked()

    def _observe(self, pod) -> None:
        gk, min_available = self._gang_of(pod)
        if gk is None:
            return
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        deleting = pod.metadata.deletion_timestamp is not None
        with self._lock:
            if deleting:
                members = self._members.get(gk)
                if members is not None:
                    members.pop(key, None)
            else:
                self._members.setdefault(gk, {})[key] = bool(
                    pod.spec.node_name)
                self._min_avail[gk] = min_available
            self._scan_locked()

    def _scan_locked(self, now: Optional[float] = None) -> None:
        import time

        now = time.monotonic() if now is None else now
        partial = self._partial_locked()
        for gk in list(self._partial_since):
            if gk not in partial:
                del self._partial_since[gk]
                self._flagged.discard(gk)  # episode over; re-flaggable
        for gk, (bound, live, need) in partial.items():
            since = self._partial_since.setdefault(gk, now)
            if now - since > self.grace and gk not in self._flagged:
                self._flagged.add(gk)
                self.violations.append(
                    f"{gk[0]}/{gk[1]}: partial gang for "
                    f"{now - since:.1f}s ({bound}/{need} bound, "
                    f"{live} live members)"
                )

    def _partial_locked(self) -> Dict:
        # torn = some live members bound while others are not: the state
        # the all-or-nothing permit protocol must never leave standing.
        # A gang whose bound membership merely SHRANK below min-available
        # (an external delete with no owner to replace the member) is
        # all-bound-though-shrunk, not torn — the scheduler admitted it
        # atomically and Kubernetes semantics keep bound pods bound.
        out = {}
        for gk, members in self._members.items():
            need = self._min_avail.get(gk, 0)
            if need <= 1 or not members:
                continue
            bound = sum(1 for b in members.values() if b)
            if 0 < bound < len(members):
                out[gk] = (bound, len(members), need)
        return out

    def partial_gangs(self) -> Dict:
        """Current partial gangs: {(ns, group): (bound, live, need)} —
        must be empty once the cluster has converged (the drill's final
        zero-partial-gangs gate, grace-independent)."""
        with self._lock:
            self._scan_locked()
            return dict(self._partial_locked())


class BindIntegrityChecker:
    """Double-bind detector for fault drills: a pod whose spec.nodeName
    moves from one non-empty node to a DIFFERENT non-empty node was bound
    twice — the invariant the fault-tolerant pipeline must never break
    (the apiserver's binding endpoint Conflict-rejects the second bind,
    so a violation surfacing here means a pod object was re-created or
    rebound around that guard). Attach to any pods informer; read
    `violations` after the drill."""

    def __init__(self):
        self._lock = threading.Lock()
        self.violations = []

    def attach(self, pods_informer) -> "BindIntegrityChecker":
        from ..client.informer import EventHandler

        pods_informer.add_event_handler(
            EventHandler(on_update=self._on_update))
        return self

    def _on_update(self, old, new) -> None:
        o = old.spec.node_name
        n = new.spec.node_name
        if o and n and o != n:
            with self._lock:
                self.violations.append(
                    f"{new.metadata.namespace}/{new.metadata.name}: "
                    f"rebound {o} -> {n}"
                )
