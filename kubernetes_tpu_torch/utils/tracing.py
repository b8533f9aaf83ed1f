"""Structured pipeline tracing: span recorder + bounded flight recorder.

Extends the threshold tracer in utils/trace.py (which answers "was this
ONE cycle slow?") with the causal record the pipeline needs: WHERE a
pod's time went across the three-stage scheduling pipeline
(pop -> encode -> queued-delta apply -> dispatch -> wait -> harvest ->
validate -> assume -> reserve/permit -> bind), plus the failure seams'
last-N-events dump. The loop-vs-kernel gap (~1600-2000 loop pods/s vs
9353 kernel-direct) is argued from totals today; the per-stage span
record turns it into a stage breakdown the chip rerun can adjudicate.

Levels (KTPU_TRACE):

  0  off — the default. A disabled trace point costs one predicate
     check plus trivially-cheap per-BATCH argument evaluation (sites
     whose attrs would take a lock guard on enabled() first), and
     allocates nothing per pod (span() returns a shared no-op
     singleton; tests pin this).
  1  per-stage spans — every pipeline stage records (name, stage, t0,
     dur, tid, attrs) into the ring. Batch granularity: a few spans per
     dispatched batch, bounded memory, safe to leave on in production.
  2  per-pod provenance — additionally, every decided pod records a
     provenance event: backend rung, session kind, last build/rebuild
     reason, pallas bucket, speculative chaining, replay/re-drive
     state, planner-ladder path. Costly per pod; drills + traces only.

The FLIGHT RECORDER is a fixed-capacity ring written lock-light: slot
allocation is one itertools.count() increment (atomic under the GIL)
and the write is a single guarded list-item assignment, so concurrent
writers never block each other; events are immutable tuples, so a
reader sees whole records only, and a monotonic slot guard keeps a
lagging writer from clobbering a newer record (in the pathological
deschedule window a slot may briefly hold an older record — never a
torn one). Every fault seam
(watchdog timeout, harvest-validation fault, PipelineStalled, ladder
demotion, supervised-worker restart) dumps the last N events before
recovery proceeds — a `PipelineStalled` leaves a triageable record, not
just gauge values.

Export: Chrome-trace / Perfetto JSON (chrome://tracing "trace event
format", ph="X" complete events) via chrome_trace(); text stage-latency
summaries via stage_stats(). scripts/trace_report.py renders dumps.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import knobs

logger = logging.getLogger(__name__)

TRACE_OFF = 0
TRACE_STAGES = 1
TRACE_PODS = 2

# canonical pipeline stage names (the span taxonomy; README
# "Observability" documents the meaning of each)
STAGES = (
    "pop",          # scheduler thread: queue pop + batch gather
    "encode",       # pod -> dense arrays (PodEncoder)
    "delta-apply",  # queued cluster-event deltas fused into the carry
    "dispatch",     # scan enqueue on the session (incl. speculative)
    "wait",         # watchdog-bounded device wait
    "harvest",      # decode + validate + apply decisions
    "replay",       # conflict-suffix / re-drive sequential replays
    "assume",       # cache.assume (completion worker)
    "reserve-permit",  # Reserve + Permit plugin pass
    "bind",         # batched bind POST
    "planner",      # preemption planner ladder: the per-WAVE plan span
    "whatif",       # per-pod fused what-if launches (nested inside a
                    # planner span — a separate stage so stage_stats
                    # never double-counts the wave's wall-clock)
    "session",      # session builds / teardowns
    "fault",        # fault + recovery markers (zero-duration events)
    "provenance",   # per-pod provenance records (level 2)
)


class _NoopSpan:
    """Shared do-nothing span: the KTPU_TRACE=0 fast path returns THIS
    SINGLETON from span(), so a disabled trace point allocates nothing
    (pinned by the overhead test)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    __slots__ = ("_rec", "name", "stage", "attrs", "t0")

    def __init__(self, rec: "FlightRecorder", name: str, stage: str,
                 attrs: Optional[dict]):
        self._rec = rec
        self.name = name
        self.stage = stage
        self.attrs = attrs
        self.t0 = 0.0

    def set(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self._rec.record(
            self.name, self.stage, self.t0,
            time.perf_counter() - self.t0, self.attrs,
        )
        return False


# event tuple layout: (seq, name, stage, t0, dur, tid, attrs)
Event = Tuple[int, str, str, float, float, int, Optional[dict]]


class FlightRecorder:
    """Bounded ring of span events; thread-safe, lock-light writes."""

    def __init__(self, capacity: Optional[int] = None,
                 level: Optional[int] = None):
        # defensive env parsing: the recorder is constructed at import
        # time (module-level RECORDER), so a malformed KTPU_TRACE=off or
        # KTPU_TRACE_CAPACITY=64k must degrade to the default, never
        # fail the scheduler's import; capacity is clamped >= 1 (a
        # zero-size ring would divide by zero on the first record)
        if capacity is None:
            capacity = knobs.get_int("KTPU_TRACE_CAPACITY")
        if level is None:
            level = knobs.get_int("KTPU_TRACE")
        self.capacity = max(1, int(capacity))
        self.level = max(0, int(level))
        self._buf: List[Optional[Event]] = [None] * self.capacity
        self._seq = itertools.count()
        # dump bookkeeping (tests + drills read these; the dump itself
        # is the observable for the fault-seam acceptance contract)
        self._dump_lock = threading.Lock()
        self.dump_history: List[dict] = []
        self.dump_dir = knobs.get_str("KTPU_TRACE_DUMP_DIR")

    # -- write side --------------------------------------------------------

    def record(self, name: str, stage: str, t0: float, dur: float,
               attrs: Optional[dict] = None) -> None:
        if not self.level:
            return
        seq = next(self._seq)
        ev = (seq, name, stage, t0, dur, threading.get_ident(), attrs)
        i = seq % self.capacity
        # monotonic slot guard: a writer descheduled for a full ring
        # revolution between its seq draw and its store must not clobber
        # the newer occupant with its stale record (the check/store pair
        # is itself racy, but it shrinks the hazard from "any write
        # latency" to two adjacent bytecodes — in the worst case one
        # slot briefly holds an older record, which snapshot()'s sort
        # tolerates)
        cur = self._buf[i]
        if cur is None or cur[0] < seq:
            self._buf[i] = ev

    def event(self, name: str, stage: str, **attrs) -> None:
        """Zero-duration marker (fault seams, state transitions)."""
        self.record(name, stage, time.perf_counter(), 0.0, attrs or None)

    def span(self, name: str, stage: str, **attrs):
        """Context manager recording a timed span at exit. Returns the
        shared no-op singleton when tracing is off — no allocation."""
        if not self.level:
            return NOOP_SPAN
        return Span(self, name, stage, attrs or None)

    def pod_level(self) -> bool:
        return self.level >= TRACE_PODS

    def provenance(self, pod_key: str, **fields) -> None:
        """Level-2 per-pod provenance record (rung, session kind, build
        reason, bucket, speculative, replay, planner path, ...)."""
        if self.level >= TRACE_PODS:
            self.record(pod_key, "provenance",
                        time.perf_counter(), 0.0, fields)

    # -- read side ---------------------------------------------------------

    def mark(self) -> int:
        """Current sequence high-water mark (a window anchor: events
        with seq >= mark() were recorded after this call)."""
        seq = next(self._seq)
        return seq + 1

    def snapshot(self, last: Optional[int] = None,
                 since: Optional[int] = None) -> List[Event]:
        """Events currently in the ring, oldest first. `last` keeps only
        the newest N; `since` keeps seq >= since (a mark() anchor)."""
        events = [e for e in list(self._buf) if e is not None]
        events.sort(key=lambda e: e[0])
        if since is not None:
            events = [e for e in events if e[0] >= since]
        if last is not None:
            events = events[-last:]
        return events

    def clear(self) -> None:
        """Drop buffered events (tests; the seq counter keeps running so
        mark() anchors stay valid)."""
        self._buf = [None] * self.capacity

    # -- fault-seam dump ---------------------------------------------------

    def dump(self, reason: str, last: int = 512,
             path: Optional[str] = None, **attrs) -> List[Event]:
        """Snapshot the last N events for a fault seam: append to
        dump_history, log a one-line summary, and (when a path or
        KTPU_TRACE_DUMP_DIR is configured) write the full record as
        JSON. No-op at level 0 — the ring is empty there, and the fault
        path must stay cheap for untraced production runs."""
        if not self.level:
            return []
        events = self.snapshot(last=last)
        record = {
            "reason": reason,
            "ts": time.time(),
            "level": self.level,
            "attrs": attrs,
            "n_events": len(events),
            "events": [event_dict(e) for e in events],
        }
        out_path = path
        if out_path is None and self.dump_dir:
            out_path = os.path.join(
                self.dump_dir,
                f"ktpu-trace-{int(time.time() * 1000)}-{reason}.json",
            )
        if out_path:
            try:
                with open(out_path, "w") as f:
                    json.dump(record, f)
                record["path"] = out_path
            except OSError:
                logger.warning("flight-recorder dump write failed (%s)",
                               out_path, exc_info=True)
        stages: Dict[str, int] = {}
        for e in events:
            stages[e[2]] = stages.get(e[2], 0) + 1
        logger.warning(
            "flight recorder dump (%s): %d events %s%s%s",
            reason, len(events), stages,
            f" attrs={attrs}" if attrs else "",
            f" -> {out_path}" if out_path else "",
        )
        with self._dump_lock:
            self.dump_history.append(record)
            del self.dump_history[:-64]  # bounded
        return events


# the process-wide recorder (the instrumentation points all write here)
RECORDER = FlightRecorder()


def level() -> int:
    return RECORDER.level


def enabled() -> bool:
    return RECORDER.level > 0


def set_level(n: int) -> int:
    """Set the live trace level (tests, drills); returns the old level."""
    old, RECORDER.level = RECORDER.level, int(n)
    return old


def span(name: str, stage: str, **attrs):
    return RECORDER.span(name, stage, **attrs)


def event(name: str, stage: str, **attrs) -> None:
    RECORDER.event(name, stage, **attrs)


def provenance(pod_key: str, **fields) -> None:
    RECORDER.provenance(pod_key, **fields)


def dump(reason: str, **kw) -> List[Event]:
    return RECORDER.dump(reason, **kw)


# -- export / summaries ----------------------------------------------------


def event_dict(e: Event) -> dict:
    d = {
        "seq": e[0], "name": e[1], "stage": e[2],
        "t0": e[3], "dur": e[4], "tid": e[5],
    }
    if e[6]:
        d.update(e[6])
    return d


def chrome_trace(events: List) -> List[dict]:
    """Chrome-trace "trace event format" complete events (ph="X", µs
    timebase) — loadable in chrome://tracing and Perfetto. Accepts raw
    ring tuples or event_dict() dicts (dump files)."""
    out = []
    for e in events:
        d = e if isinstance(e, dict) else event_dict(e)
        args = {
            k: v for k, v in d.items()
            if k not in ("seq", "name", "stage", "t0", "dur", "tid")
        }
        args["seq"] = d["seq"]
        out.append({
            "name": d["name"],
            "cat": d["stage"],
            "ph": "X",
            "ts": d["t0"] * 1e6,
            "dur": max(d["dur"], 1e-7) * 1e6,
            "pid": 0,
            "tid": d["tid"],
            "args": args,
        })
    return out


def _pctile(samples: List[float], p: float) -> float:
    """Nearest-rank percentile: ceil(p/100 * n) - 1. (round(x + 0.5)
    would hit banker's rounding on exact .5 ties — p50 of two samples
    must be the lower rank, not the max.)"""
    if not samples:
        return 0.0
    s = sorted(samples)
    import math

    idx = min(len(s) - 1, max(0, math.ceil(p / 100.0 * len(s)) - 1))
    return s[idx]


def stage_stats(events: List) -> Dict[str, Dict[str, float]]:
    """Per-stage wall-clock summary over a window of events: count,
    total seconds, p50/p99 span duration. Zero-duration marker stages
    (fault, provenance) report counts with zero totals."""
    durs: Dict[str, List[float]] = {}
    for e in events:
        d = e if isinstance(e, dict) else event_dict(e)
        durs.setdefault(d["stage"], []).append(float(d["dur"]))
    out: Dict[str, Dict[str, float]] = {}
    for stage, vals in sorted(durs.items()):
        out[stage] = {
            "count": len(vals),
            "total_s": round(sum(vals), 6),
            "p50_s": round(_pctile(vals, 50), 6),
            "p99_s": round(_pctile(vals, 99), 6),
        }
    return out


def window_span(events: List) -> float:
    """Wall-clock coverage of a window of events: last span end minus
    first span start (seconds). The reconciliation anchor: with tracing
    on, the harness pins this against the measured first-bind ->
    last-bind window."""
    t0s, t1s = [], []
    for e in events:
        d = e if isinstance(e, dict) else event_dict(e)
        t0s.append(d["t0"])
        t1s.append(d["t0"] + d["dur"])
    if not t0s:
        return 0.0
    return max(t1s) - min(t0s)


def provenance_mix(events: List) -> Dict[str, Dict[str, int]]:
    """Distribution of the level-2 provenance fields over a window:
    {field: {value: count}} for rung / session / planner path /
    speculative — the "which path did pods actually ride" summary
    trace_report prints."""
    mix: Dict[str, Dict[str, int]] = {}
    for e in events:
        d = e if isinstance(e, dict) else event_dict(e)
        if d["stage"] != "provenance":
            continue
        for field in ("rung", "session", "build_reason", "planner",
                      "speculative", "redrive", "bucket"):
            if field in d and d[field] is not None:
                vals = mix.setdefault(field, {})
                key = str(d[field])
                vals[key] = vals.get(key, 0) + 1
    return mix
