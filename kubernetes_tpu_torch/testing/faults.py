"""Deterministic fault seam for the scheduling backend.

Port of kubernetes_tpu/testing/faults.py (FaultInjector), for the
backend's fault drills: the hooks are the reference's, and
`corrupt_harvest` reads a tensor payload back to the host with `.cpu()`
(np.asarray refuses a CUDA tensor) and returns tensors. The reference's
gang and bind integrity checkers read the informer, and come with the
scheduler loop.

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
