"""Backend degradation ladder: kernel -> hoisted -> oracle under faults.

Port of kubernetes_tpu/scheduler/degradation.py, a copy except for the
top rung: there the single-launch Mosaic scan (PallasSession), here the
hand-written CUDA scan session (ops/scan.py ScanSession), named "kernel"
(RUNG_KERNEL, gauge value 2, where the reference has RUNG_PALLAS /
"pallas"). The rungs below it are the same: hoisted (ops/hoisted.py
HoistedSession) and oracle (the host path, no device at all).

The scoring backend assumes the device answers; production hardware
does not always oblige (a lost card, CUDA runtime errors, hung waits).
The ladder is the containment policy for PERSISTENT device faults: after
`threshold` consecutive faults the backend demotes one rung — kernel ->
hoisted -> oracle — and keeps scheduling at the lower rung instead of
crash-looping the pipeline. A background probe
(tpu_backend.TPUBackend._probe_loop) re-runs a canary dispatch with a
known answer; when the device answers correctly again the ladder
promotes one rung back, with the probe cadence backing off (capped, full
jitter) while the device stays sick so a flapping card cannot whipsaw
the session cache.

The active rung is exported as the `scheduler_backend_mode` gauge
(2=kernel, 1=hoisted, 0=oracle); demotions/promotions also count on the
ladder object itself for drills.

One transient fault never demotes: the dispatch retry path (bounded
attempts, capped exponential backoff + jitter — mirroring the
controllers/manager.Supervisor restart policy) absorbs it, and a clean
harvest resets the consecutive-fault count.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional, Tuple

from ..utils import tracing
from .metrics import (
    backend_mode,
    overload_level,
    overload_restores,
    overload_sheds,
)

# ladder rungs, ordered: demotion decrements, promotion increments
RUNG_ORACLE = 0  # host Go-semantics path; no device dispatch at all
RUNG_HOISTED = 1  # torch hoisted session (the fallback)
RUNG_KERNEL = 2  # the CUDA scan session (the card's fast path)

RUNG_NAMES = {RUNG_ORACLE: "oracle", RUNG_HOISTED: "hoisted",
              RUNG_KERNEL: "kernel"}


class DeviceFault(Exception):
    """A device dispatch failed: the launch raised, the wait exceeded the
    watchdog, or the harvested payload failed the finite/in-range guard.
    `kind` feeds the scheduler_device_faults_total counter."""

    def __init__(self, message: str = "", kind: str = "raise"):
        super().__init__(message)
        self.kind = kind


class DegradationLadder:
    """Fault accounting + rung state machine; thread-safe (dispatches,
    the completion worker, and the probe thread all touch it)."""

    def __init__(
        self,
        top: int = RUNG_KERNEL,
        threshold: int = 3,
        probe_interval: float = 1.0,
        probe_max: float = 30.0,
        rng: Optional[random.Random] = None,
    ):
        self.top = top
        self.threshold = max(1, threshold)
        self._rung = top
        self._consecutive = 0
        self._probe_interval = probe_interval
        self._probe_max = probe_max
        self._probe_delay = probe_interval
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self.demotions = 0
        self.promotions = 0
        # transition history for drills + flight-recorder dumps:
        # (monotonic time, "demote" | "promote", new rung). Bounded.
        self.transitions: List[Tuple[float, str, int]] = []
        backend_mode.set(self._rung)

    # -- state -------------------------------------------------------------

    def rung(self) -> int:
        with self._lock:
            return self._rung

    def mode(self) -> str:
        return RUNG_NAMES[self.rung()]

    def healthy(self) -> bool:
        with self._lock:
            return self._rung >= self.top and self._consecutive == 0

    # -- fault accounting --------------------------------------------------

    def record_fault(self, kind: str = "raise") -> bool:
        """One device fault; returns True when THIS fault crossed the
        demotion threshold (the caller logs + starts the probe). The
        counter is consecutive: any clean harvest resets it."""
        with self._lock:
            self._consecutive += 1
            if self._consecutive >= self.threshold and self._rung > RUNG_ORACLE:
                self._demote_locked()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._rung >= self.top:
                # genuinely healthy at the top rung: restore the probe
                # cadence (promotion alone does NOT — see on_probe)
                self._probe_delay = self._probe_interval

    def demote(self) -> bool:
        """Unconditional demotion (pipeline-stall escape hatch: a drain
        that exceeds even the watchdog-bounded budget)."""
        with self._lock:
            if self._rung <= RUNG_ORACLE:
                return False
            self._demote_locked()
            return True

    def _demote_locked(self) -> None:
        self._rung -= 1
        self.demotions += 1
        self._consecutive = 0
        self._record_transition_locked("demote")
        # flap hysteresis: each demotion doubles the probe cadence
        # (capped). The probe canary vouches for the DEVICE, not for the
        # kernel at the target rung — a kernel-level fault (garbage from
        # one workload shape) passes the probe, re-promotes, and faults
        # again; without this the demote/promote cycle would whipsaw at
        # probe_interval forever. With it the flap rate decays to once
        # per probe_max.
        self._probe_delay = min(self._probe_delay * 2, self._probe_max)
        backend_mode.set(self._rung)

    # -- probe / re-promotion ----------------------------------------------

    def probe_delay(self) -> float:
        """Next probe wait: current backoff with full jitter."""
        with self._lock:
            return self._probe_delay * (1 + self._rng.random())

    def on_probe(self, ok: bool) -> bool:
        """Probe verdict. A clean canary promotes ONE rung (stepwise —
        kernel confidence is rebuilt through hoisted, not assumed); a
        failed one doubles the cadence (capped). Promotion does NOT
        restore the cadence — only a clean harvest at the top rung does
        (record_success) — so a workload that faults right after every
        re-promotion keeps the backed-off cadence and the flapping stays
        bounded."""
        with self._lock:
            if ok:
                if self._rung >= self.top:
                    return False
                self._rung += 1
                self.promotions += 1
                self._consecutive = 0
                self._record_transition_locked("promote")
                backend_mode.set(self._rung)
                return True
            self._probe_delay = min(self._probe_delay * 2, self._probe_max)
            return False

    def _record_transition_locked(self, kind: str) -> None:
        """Ledger + flight-recorder marker for a rung change (the event
        the dump timeline anchors a demotion's surrounding spans to)."""
        self.transitions.append((time.monotonic(), kind, self._rung))
        del self.transitions[:-64]  # bounded
        tracing.event(f"ladder-{kind}", "fault",
                      rung=RUNG_NAMES[self._rung])


class OverloadMonitor:
    """Host-side overload detection + adaptive shedding — the HOST dual
    of the device-fault ladder above.

    The ladder handles a sick DEVICE; this handles a drowning HOST: the
    PR-8 stage attribution showed completion (assume/bind, plus the
    optional audit work riding it) is the largest stage, so when the
    host falls behind the completion FIFO ages and queue depth climbs
    with no device fault in sight. The monitor watches those signals
    once per completed batch and, under SUSTAINED pressure, sheds
    strictly OPTIONAL work in a fixed order:

        explain-harvest -> shadow-sample -> trace -> speculation

    Decision correctness is never shed — every lever changes how much
    observability/overlap the host pays for, never which node a pod
    lands on. Restore is hysteretic and LIFO (last shed, first
    restored): shedding needs `shed_dwell` consecutive hot ticks,
    restoring needs `restore_dwell` consecutive calm ticks, a tick in
    the dead band between the high and low water marks resets both
    streaks, and `cooldown` seconds must separate any two transitions —
    so a load level that hovers at the threshold cannot flap a lever.

    Levers are (name, shed_fn, restore_fn) closures supplied by the
    scheduler; the monitor owns only the policy. Thread-safety: `observe`
    is called from the completion worker, but everything is locked so
    drills/tests can poke it from other threads.
    """

    def __init__(
        self,
        levers,
        *,
        high_fifo_age: float = 0.5,
        low_fifo_age: float = 0.1,
        high_queue_depth: int = 512,
        low_queue_depth: int = 128,
        high_stage_p99: float = 0.0,
        low_stage_p99: float = 0.0,
        shed_dwell: int = 3,
        restore_dwell: int = 8,
        cooldown: float = 1.0,
        now=time.monotonic,
        on_shed=None,
        on_restore=None,
    ):
        self.levers = list(levers)
        self.high_fifo_age = high_fifo_age
        self.low_fifo_age = low_fifo_age
        self.high_queue_depth = high_queue_depth
        self.low_queue_depth = low_queue_depth
        # stage-p99 signal is opt-in (0 = disabled): per-stage latency is
        # workload-shaped, so the deployment picks the water marks
        self.high_stage_p99 = high_stage_p99
        self.low_stage_p99 = (
            low_stage_p99 if low_stage_p99 > 0 else high_stage_p99 / 2
        )
        self.shed_dwell = max(1, shed_dwell)
        self.restore_dwell = max(1, restore_dwell)
        self.cooldown = cooldown
        self._now = now
        self._on_shed = on_shed
        self._on_restore = on_restore
        self._lock = threading.Lock()
        self._hot_streak = 0
        self._calm_streak = 0
        self._level = 0  # levers currently shed (prefix of self.levers)
        self._last_transition = -float("inf")
        self.triggered = False  # any shed ever fired this run
        self.cycles = 0  # completed shed->...->fully-restored cycles
        # bounded ledger: (monotonic time, "shed"|"restore", lever name,
        # {signal: value}) — the soak report prints it
        self.history: List[Tuple[float, str, str, dict]] = []
        overload_level.set(0)

    # -- state -------------------------------------------------------------

    def level(self) -> int:
        with self._lock:
            return self._level

    def shed_names(self) -> List[str]:
        with self._lock:
            return [name for name, _, _ in self.levers[: self._level]]

    # -- the per-completion tick -------------------------------------------

    def observe(
        self,
        fifo_depth: int = 0,
        fifo_age: float = 0.0,
        queue_depth: int = 0,
        stage_p99: float = 0.0,
    ) -> Optional[str]:
        """One sample of the host-pressure signals; returns the lever
        name if THIS tick shed or restored one (else None)."""
        hot = (
            fifo_age >= self.high_fifo_age
            or queue_depth >= self.high_queue_depth
            or (self.high_stage_p99 > 0 and stage_p99 >= self.high_stage_p99)
        )
        calm = (
            fifo_age <= self.low_fifo_age
            and queue_depth <= self.low_queue_depth
            and (self.high_stage_p99 <= 0 or stage_p99 <= self.low_stage_p99)
        )
        signals = {
            "fifo_depth": fifo_depth,
            "fifo_age": round(fifo_age, 4),
            "queue_depth": queue_depth,
            "stage_p99": round(stage_p99, 4),
        }
        with self._lock:
            now = self._now()
            if hot:
                self._hot_streak += 1
                self._calm_streak = 0
                if (
                    self._hot_streak >= self.shed_dwell
                    and self._level < len(self.levers)
                    and now - self._last_transition >= self.cooldown
                ):
                    return self._shed_locked(now, signals)
            elif calm:
                self._calm_streak += 1
                self._hot_streak = 0
                if (
                    self._calm_streak >= self.restore_dwell
                    and self._level > 0
                    and now - self._last_transition >= self.cooldown
                ):
                    return self._restore_locked(now, signals)
            else:
                # dead band between the water marks: hysteresis — neither
                # streak accumulates, so hovering load cannot flap
                self._hot_streak = 0
                self._calm_streak = 0
            return None

    def _shed_locked(self, now: float, signals: dict) -> str:
        name, shed_fn, _ = self.levers[self._level]
        self._level += 1
        self._hot_streak = 0
        self._calm_streak = 0
        self._last_transition = now
        self.triggered = True
        self.history.append((now, "shed", name, signals))
        del self.history[:-128]  # bounded
        overload_sheds.inc(what=name)
        overload_level.set(self._level)
        tracing.event("overload-shed", "fault", what=name, **signals)
        shed_fn()
        if self._on_shed is not None:
            self._on_shed(name, signals)
        return name

    def _restore_locked(self, now: float, signals: dict) -> str:
        self._level -= 1
        name, _, restore_fn = self.levers[self._level]
        self._hot_streak = 0
        self._calm_streak = 0
        self._last_transition = now
        self.history.append((now, "restore", name, signals))
        del self.history[:-128]  # bounded
        overload_restores.inc(what=name)
        overload_level.set(self._level)
        tracing.event("overload-restore", "fault", what=name, **signals)
        if self._level == 0:
            self.cycles += 1
        restore_fn()
        if self._on_restore is not None:
            self._on_restore(name, signals)
        return name
