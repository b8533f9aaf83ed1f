"""Device-timeline attribution: per-launch kernel/transfer/compile timing.

Port of kubernetes_tpu/utils/devtime.py, a copy except for the level-2
capture (maybe_profile), which records a torch.profiler trace of the
CPU and CUDA activity around the launch instead of a jax.profiler one,
and the synchronization the callers take at level 1 (a CUDA event
synchronize on the backend's stream, scheduler/tpu_backend.py).

The flight recorder (utils/tracing.py) answers "where did the HOST's
time go" — per-stage wall-clock spans over the scheduling pipeline. This
module answers the other half: WHERE DEVICE TIME GOES. Every device
launch (dispatch scan, fused what-if, queued-delta apply, session-build
upload) records a (submit, ready) interval plus its H2D/D2H byte counts,
and every AOT-executable-cache miss records a COMPILE event — so a
compile storm or a transfer-bound mesh row is a counted, attributed
record instead of a mystery stall. Merging this timeline with the host
span ring yields the host<->device OVERLAP accounting (overlap();
device_busy / host_busy / overlapped per window) that the >=0.70
loop_kernel_ratio target turns on: "the 1-CPU box cannot overlap" stops
being a caveat and becomes a measured number any host can report.

Levels (KTPU_DEVTIME):

  0  off — the default. A disabled launch point costs one predicate
     check and allocates nothing (launch() returns a shared no-op
     singleton; decisions are bit-identical with the timeline off —
     both pinned by tests).
  1  per-launch records — submit->ready device intervals, byte counts,
     compile events. The dispatch pipeline's ready edge comes from the
     wait it already pays; synchronous launches (what-if, delta-apply)
     take an explicit event synchronize at their call site so their
     interval is the launch's own, not a later consumer's. Batch
     granularity, bounded memory, decision-inert.
  2  additionally arms maybe_profile(): a bounded number of launches
     are wrapped in a torch.profiler trace capture written to a directory
     keyed like the flight-recorder dump files. Drills + chip triage
     only; capture cost is real.

The TIMELINE is the same lock-light ring as the flight recorder: slot
allocation is one itertools.count() increment, records are immutable
tuples, and a monotonic slot guard keeps lagging writers from
clobbering newer records. Fault seams dump the timeline alongside the
span ring (scheduler/metrics.dump_seam), so a device fault leaves BOTH
halves of the story. Timebase is time.perf_counter — shared with
tracing spans, which is what makes the overlap merge a plain interval
intersection.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import knobs

logger = logging.getLogger(__name__)

DEVTIME_OFF = 0
DEVTIME_LAUNCHES = 1
DEVTIME_PROFILE = 2

# record kinds (the attribution taxonomy; README "Device-timeline
# attribution" documents each)
KINDS = (
    "kernel",    # scheduling scans: dispatch_many / schedule_many /
                 # what-if / delta-apply launches
    "transfer",  # explicit host<->device state movement: the session
                 # build's cluster upload (H2D); D2H bytes ride the
                 # kernel records' d2h field (harvest readback)
    "compile",   # AOT executable-cache misses (ops/pallas_scan.py) and
                 # any other counted recompile
)

# host stages EXCLUDED from host_busy in overlap(): "wait" is the host
# parked on the device (counting it as host work would make overlap
# tautologically ~1.0), and the zero-duration marker stages carry no
# wall-clock to overlap
OVERLAP_EXCLUDE_STAGES = ("wait", "provenance", "fault")


class _NoopLaunch:
    """Shared do-nothing launch token: the KTPU_DEVTIME=0 fast path
    returns THIS SINGLETON from launch(), so a disabled launch point
    allocates nothing (pinned by the overhead test)."""

    __slots__ = ()

    def done(self, d2h_bytes: int = 0, **attrs) -> "_NoopLaunch":
        return self

    def set(self, **attrs) -> "_NoopLaunch":
        return self


NOOP_LAUNCH = _NoopLaunch()


class _Launch:
    """One in-flight device launch: submit is stamped at construction
    (the enqueue moment), done() stamps ready and commits the record.
    done() is idempotent — recovery paths may race a normal finish."""

    __slots__ = ("_tl", "kind", "name", "h2d_bytes", "attrs", "submit",
                 "_done")

    def __init__(self, tl: "DeviceTimeline", kind: str, name: str,
                 h2d_bytes: int, attrs: Optional[dict]):
        self._tl = tl
        self.kind = kind
        self.name = name
        self.h2d_bytes = int(h2d_bytes)
        self.attrs = attrs
        self.submit = time.perf_counter()
        self._done = False

    def set(self, **attrs) -> "_Launch":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def done(self, d2h_bytes: int = 0, **attrs) -> "_Launch":
        if self._done:
            return self
        self._done = True
        if attrs:
            self.set(**attrs)
        self._tl.record(
            self.kind, self.name, self.submit, time.perf_counter(),
            h2d_bytes=self.h2d_bytes, d2h_bytes=int(d2h_bytes),
            attrs=self.attrs,
        )
        return self


# record tuple layout: (seq, kind, name, submit, ready, h2d, d2h, tid,
# attrs) — submit/ready in the time.perf_counter timebase shared with
# the flight recorder's spans
Record = Tuple[int, str, str, float, float, int, int, int,
               Optional[dict]]


class DeviceTimeline:
    """Bounded ring of device-launch records; thread-safe, lock-light
    writes (same discipline as tracing.FlightRecorder)."""

    def __init__(self, capacity: Optional[int] = None,
                 level: Optional[int] = None):
        # defensive env parsing: constructed at import time (module-
        # level TIMELINE) — malformed env degrades to defaults, never
        # fails the import; capacity clamps >= 1
        if capacity is None:
            capacity = knobs.get_int("KTPU_DEVTIME_CAPACITY")
        if level is None:
            level = knobs.get_int("KTPU_DEVTIME")
        self.capacity = max(1, int(capacity))
        self.level = max(0, int(level))
        self._buf: List[Optional[Record]] = [None] * self.capacity
        self._seq = itertools.count()
        # monotonic compile counter: survives ring overwrite, so the
        # harness's in-window recompile delta never undercounts a
        # compile storm that out-wrote the ring
        self.compiles = 0
        # level-2 profiler captures remaining (bounded: each capture is
        # a real torch.profiler trace, not a ring write)
        self.profile_budget = max(0, knobs.get_int("KTPU_DEVTIME_PROFILE_MAX"))
        self._dump_lock = threading.Lock()
        self.dump_history: List[dict] = []
        # timeline dumps land beside the flight-recorder dumps unless
        # pointed elsewhere — one triage directory per incident
        self.dump_dir = (knobs.get_str("KTPU_DEVTIME_DUMP_DIR")
                         or knobs.get_str("KTPU_TRACE_DUMP_DIR"))

    # -- write side --------------------------------------------------------

    def record(self, kind: str, name: str, submit: float, ready: float,
               h2d_bytes: int = 0, d2h_bytes: int = 0,
               attrs: Optional[dict] = None) -> None:
        if not self.level:
            return
        if kind == "compile":
            self.compiles += 1  # GIL-atomic enough for a triage counter
        seq = next(self._seq)
        rec = (seq, kind, name, submit, ready, int(h2d_bytes),
               int(d2h_bytes), threading.get_ident(), attrs)
        i = seq % self.capacity
        # monotonic slot guard (see tracing.FlightRecorder.record)
        cur = self._buf[i]
        if cur is None or cur[0] < seq:
            self._buf[i] = rec

    def launch(self, kind: str, name: str, h2d_bytes: int = 0, **attrs):
        """Open a launch record: submit stamps NOW, the returned token's
        done() stamps ready. Returns the shared no-op singleton when the
        timeline is off — no allocation."""
        if not self.level:
            return NOOP_LAUNCH
        return _Launch(self, kind, name, h2d_bytes, attrs or None)

    def compile_event(self, name: str, t0: float, dur: float,
                      **attrs) -> None:
        """One counted recompile (AOT bucket miss, forced eviction):
        records a kind="compile" interval and bumps the monotonic
        compile counter."""
        self.record("compile", name, t0, t0 + max(dur, 0.0),
                    attrs=attrs or None)

    @contextlib.contextmanager
    def maybe_profile(self, name: str):
        """Level-2 torch.profiler trace capture around a launch, bounded
        by profile_budget and keyed like the flight-recorder dump files
        (ktpu-devtime-<ms>-<name>/ under the dump dir). Strictly
        best-effort: no profiler, no dir, or a capture failure all
        degrade to a no-op — profiling must never add a failure mode to
        the dispatch path."""
        if (self.level < DEVTIME_PROFILE or self.profile_budget <= 0
                or not self.dump_dir):
            yield
            return
        self.profile_budget -= 1
        trace_dir = os.path.join(
            self.dump_dir,
            f"ktpu-devtime-{int(time.time() * 1000)}-{name}",
        )
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                yield
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            logger.warning("devtime profiler capture (%s) -> %s",
                           name, trace_dir)
        except Exception:  # noqa: BLE001 — capture is best-effort
            logger.warning("devtime profiler capture failed (%s)",
                           name, exc_info=True)
            yield

    # -- read side ---------------------------------------------------------

    def mark(self) -> int:
        """Current sequence high-water mark (window anchor)."""
        seq = next(self._seq)
        return seq + 1

    def snapshot(self, last: Optional[int] = None,
                 since: Optional[int] = None) -> List[Record]:
        """Records currently in the ring, oldest first."""
        records = [r for r in list(self._buf) if r is not None]
        records.sort(key=lambda r: r[0])
        if since is not None:
            records = [r for r in records if r[0] >= since]
        if last is not None:
            records = records[-last:]
        return records

    def clear(self) -> None:
        """Drop buffered records (tests; seq keeps running so mark()
        anchors stay valid). The compile counter is NOT reset — it is
        monotonic by contract; callers delta it."""
        self._buf = [None] * self.capacity

    # -- fault-seam dump ---------------------------------------------------

    def dump(self, reason: str, last: int = 512,
             path: Optional[str] = None, **attrs) -> List[Record]:
        """Snapshot the last N records for a fault seam: append to
        dump_history and (when a path or dump dir is configured) write
        the full record as JSON. Dumped ALONGSIDE the flight-recorder
        ring at every seam (scheduler/metrics.dump_seam), so a device
        fault leaves both the host spans and the device timeline.
        No-op at level 0."""
        if not self.level:
            return []
        records = self.snapshot(last=last)
        record = {
            "reason": reason,
            "ts": time.time(),
            "level": self.level,
            "attrs": attrs,
            "n_records": len(records),
            "compiles": self.compiles,
            "records": [record_dict(r) for r in records],
        }
        out_path = path
        if out_path is None and self.dump_dir:
            out_path = os.path.join(
                self.dump_dir,
                f"ktpu-devtime-{int(time.time() * 1000)}-{reason}.json",
            )
        if out_path:
            try:
                with open(out_path, "w") as f:
                    json.dump(record, f)
                record["path"] = out_path
            except OSError:
                logger.warning("device-timeline dump write failed (%s)",
                               out_path, exc_info=True)
        kinds: Dict[str, int] = {}
        for r in records:
            kinds[r[1]] = kinds.get(r[1], 0) + 1
        logger.warning(
            "device timeline dump (%s): %d records %s%s%s",
            reason, len(records), kinds,
            f" attrs={attrs}" if attrs else "",
            f" -> {out_path}" if out_path else "",
        )
        with self._dump_lock:
            self.dump_history.append(record)
            del self.dump_history[:-64]  # bounded
        return records


# the process-wide timeline (every launch point writes here)
TIMELINE = DeviceTimeline()


def level() -> int:
    return TIMELINE.level


def enabled() -> bool:
    return TIMELINE.level > 0


def set_level(n: int) -> int:
    """Set the live devtime level (tests, drills, the overload-shed
    lever); returns the old level."""
    old, TIMELINE.level = TIMELINE.level, int(n)
    return old


def launch(kind: str, name: str, h2d_bytes: int = 0, **attrs):
    return TIMELINE.launch(kind, name, h2d_bytes=h2d_bytes, **attrs)


def compile_event(name: str, t0: float, dur: float, **attrs) -> None:
    TIMELINE.compile_event(name, t0, dur, **attrs)


def dump(reason: str, **kw) -> List[Record]:
    return TIMELINE.dump(reason, **kw)


def payload_bytes(tree) -> int:
    """Total array bytes in an encoding payload / harvest output: sums
    .nbytes over dict/list/tuple leaves (device arrays expose nbytes
    without forcing a transfer). Cheap enough for the enabled path;
    call sites gate on enabled() so the disabled path never pays it."""
    if tree is None:
        return 0
    n = getattr(tree, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(tree, dict):
        return sum(payload_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(payload_bytes(v) for v in tree)
    return 0


# -- export / summaries ----------------------------------------------------


def record_dict(r: Record) -> dict:
    d = {
        "seq": r[0], "kind": r[1], "name": r[2],
        "submit": r[3], "ready": r[4],
        "h2d_bytes": r[5], "d2h_bytes": r[6], "tid": r[7],
    }
    if r[8]:
        d.update(r[8])
    return d


def device_track(records: List) -> List[dict]:
    """Chrome-trace complete events for the device timeline, as a
    SEPARATE track (pid=1, tid=kind index) so scripts/trace_report.py
    can merge it under the host spans (pid=0) in the same µs timebase.
    Accepts raw ring tuples or record_dict() dicts (dump files)."""
    out = []
    for r in records:
        d = r if isinstance(r, dict) else record_dict(r)
        args = {
            k: v for k, v in d.items()
            if k not in ("seq", "kind", "name", "submit", "ready", "tid")
        }
        args["seq"] = d["seq"]
        out.append({
            "name": f"{d['kind']}:{d['name']}",
            "cat": d["kind"],
            "ph": "X",
            "ts": d["submit"] * 1e6,
            "dur": max(d["ready"] - d["submit"], 1e-7) * 1e6,
            "pid": 1,  # the device "process"; host spans ride pid=0
            "tid": KINDS.index(d["kind"]) if d["kind"] in KINDS else 99,
            "args": args,
        })
    return out


def device_time_summary(records: List) -> Dict[str, float]:
    """Per-kind device-time split over a window of records: seconds by
    kind plus byte totals and the launch count — the bench rows'
    device_time_runs payload (kernel/transfer split, compile called
    out)."""
    out = {
        "kernel_s": 0.0, "transfer_s": 0.0, "compile_s": 0.0,
        "h2d_bytes": 0, "d2h_bytes": 0, "launches": 0,
    }
    for r in records:
        d = r if isinstance(r, dict) else record_dict(r)
        key = f"{d['kind']}_s"
        if key in out:
            out[key] += max(0.0, d["ready"] - d["submit"])
        out["h2d_bytes"] += int(d.get("h2d_bytes") or 0)
        out["d2h_bytes"] += int(d.get("d2h_bytes") or 0)
        out["launches"] += 1
    for k in ("kernel_s", "transfer_s", "compile_s"):
        out[k] = round(out[k], 6)
    return out


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted union of [start, end) intervals."""
    ivs = sorted((a, b) for a, b in intervals if b > a)
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _measure(merged: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in merged)


def _intersection(a: List[Tuple[float, float]],
                  b: List[Tuple[float, float]]) -> float:
    """Measure of the intersection of two MERGED interval lists
    (two-pointer sweep)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap(records: List, host_events: List,
            exclude_stages: Tuple[str, ...] = OVERLAP_EXCLUDE_STAGES,
            ) -> Dict[str, float]:
    """Host<->device overlap accounting over one window: merge the
    device timeline (submit->ready intervals) with the flight
    recorder's host spans (t0->t0+dur, excluding the stages that ARE
    the device wait) in their shared perf_counter timebase.

      device_busy_s  union measure of device launch intervals
      host_busy_s    union measure of included host spans
      overlapped_s   measure of the intersection
      overlap_ratio  overlapped / min(host_busy, device_busy) — 1.0
                     means the smaller side fully hides under the
                     larger; 0 means strict serialization (the 1-CPU
                     box) OR an empty side (reported as 0, never NaN)
      window_s       combined first-start .. last-end coverage

    Invariants (trace_report's reconciliation gate): device_busy <=
    window, host_busy <= window, overlapped <= min(host, device)."""
    dev: List[Tuple[float, float]] = []
    for r in records:
        d = r if isinstance(r, dict) else record_dict(r)
        dev.append((float(d["submit"]), float(d["ready"])))
    host: List[Tuple[float, float]] = []
    for e in host_events:
        d = e if isinstance(e, dict) else {
            "stage": e[2], "t0": e[3], "dur": e[4]}
        if d["stage"] in exclude_stages or d["dur"] <= 0:
            continue
        host.append((float(d["t0"]), float(d["t0"]) + float(d["dur"])))
    dev_m = _merged(dev)
    host_m = _merged(host)
    device_busy = _measure(dev_m)
    host_busy = _measure(host_m)
    overlapped = _intersection(dev_m, host_m)
    starts = [a for a, _ in dev_m] + [a for a, _ in host_m]
    ends = [b for _, b in dev_m] + [b for _, b in host_m]
    window = (max(ends) - min(starts)) if starts else 0.0
    floor = min(host_busy, device_busy)
    return {
        "window_s": round(window, 6),
        "device_busy_s": round(device_busy, 6),
        "host_busy_s": round(host_busy, 6),
        "overlapped_s": round(overlapped, 6),
        "overlap_ratio": round(overlapped / floor, 4) if floor > 0 else 0.0,
    }
