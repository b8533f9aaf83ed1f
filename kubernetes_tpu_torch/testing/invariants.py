"""Invariant monitors for endurance runs (scripts/soak.py, tests).

An endurance soak is only as strong as what it asserts, and asserting by
poking scheduler internals couples the harness to implementation detail
that a production operator cannot see. These monitors read the SAME
surface operations would: the Prometheus text of /metricsz (process
self-telemetry included — utils/selfstats.py) sampled over the run. The
suite samples on a cadence, each invariant folds the sample stream, and
`finish()` returns every violation; `bundle()` writes the triage
artifacts (flight-recorder ring dump + first/last metrics snapshots +
the violation report) for a failed run.

Invariants shipped (the soak wires all of them):

  CounterFlat       a counter must not move (zero shadow drift, zero
                    expired assumes)
  CounterMoved      a counter must move by at least min_delta (the
                    drill's disruption really exercised its path —
                    leader transitions under failover chaos)
  GaugeBaseline     a gauge must RETURN to its starting band by the end
                    (queue depth after each chaos wave, watcher count)
  BoundedGrowth     first-window vs last-window growth of a gauge stays
                    under an absolute and/or fractional bound (RSS, open
                    fds, thread count — the leak detectors)
  GaugeCeiling      a gauge never exceeds a ceiling at any sample (no
                    assumed pod outliving its TTL)
  HistogramP99Flat  windowed p99 from cumulative bucket deltas: the
                    last-third p99 must stay within a ratio of the
                    first-third p99 (stage latency flatness — the
                    "does it degrade over hours" question)
  Callback          escape hatch: any zero-argument callable returning
                    violation strings at finish (BindIntegrityChecker
                    wiring, convergence checks)
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Reading = Dict[str, float]


def parse_metrics(text: str) -> Reading:
    """Prometheus text -> {series: value}. Series keys keep their label
    string verbatim (`name{a="b"} 1.0` -> key `name{a="b"}`)."""
    out: Reading = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
        except ValueError:
            continue
    return out


def series_name(series: str) -> str:
    return series.split("{", 1)[0]


def total(reading: Reading, name: str) -> float:
    """Sum a metric across its label sets (histogram _bucket series are
    cumulative — address them explicitly, not through this)."""
    return sum(v for k, v in reading.items() if series_name(k) == name)


def bucket_counts(reading: Reading, name: str) -> Dict[float, float]:
    """Cumulative bucket counts of `name` summed across non-le labels:
    {le_upper_bound: cumulative_count} (+Inf included as inf)."""
    out: Dict[float, float] = {}
    prefix = f"{name}_bucket{{"
    for k, v in reading.items():
        if not k.startswith(prefix):
            continue
        le = ""
        for part in k[len(prefix):-1].split(","):
            if part.startswith("le="):
                le = part[4:-1]
        bound = float("inf") if le == "+Inf" else float(le)
        out[bound] = out.get(bound, 0.0) + v
    return out


def window_p99(a: Reading, b: Reading, name: str) -> float:
    """p99 (bucket upper bound) of the observations that landed BETWEEN
    two samples, from cumulative bucket deltas — a windowed percentile
    out of plain Prometheus text, no internal sample buffer needed."""
    ca, cb = bucket_counts(a, name), bucket_counts(b, name)
    deltas: List[Tuple[float, float]] = sorted(
        (le, cb.get(le, 0.0) - ca.get(le, 0.0)) for le in cb
    )
    if not deltas:
        return 0.0
    n = deltas[-1][1]  # +Inf bucket is cumulative total
    if n <= 0:
        return 0.0
    target = 0.99 * n
    for le, cum in deltas:
        if cum >= target:
            return le
    return deltas[-1][0]


class Invariant:
    name = "invariant"

    def on_sample(self, t: float, reading: Reading) -> None:  # noqa: B027
        pass

    def check(self, samples: Sequence[Tuple[float, Reading]]) -> List[str]:
        return []


class CounterFlat(Invariant):
    """A counter that must not move over the run (e.g. zero drift)."""

    def __init__(self, metric: str, allow: float = 0.0, label: str = ""):
        self.metric = metric
        self.allow = allow
        self.name = label or f"flat:{metric}"

    def check(self, samples):
        if len(samples) < 2:
            return []
        delta = total(samples[-1][1], self.metric) - total(
            samples[0][1], self.metric)
        if delta > self.allow:
            return [f"{self.name}: {self.metric} moved by {delta:g} "
                    f"(allowed {self.allow:g})"]
        return []


class CounterMoved(Invariant):
    """The inverse of CounterFlat: a counter that MUST move over the run
    by at least `min_delta` — proof that a drill actually exercised the
    path it claims to (e.g. scheduler_leader_transitions_total under a
    failover mix, scheduler_fencing_rejections_total after a stale-token
    replay). A chaos run whose injection silently no-opped passes every
    convergence check; this is the one that fails it."""

    def __init__(self, metric: str, min_delta: float = 1.0,
                 label: str = ""):
        self.metric = metric
        self.min_delta = min_delta
        self.name = label or f"moved:{metric}"

    def check(self, samples):
        if len(samples) < 2:
            return []
        delta = total(samples[-1][1], self.metric) - total(
            samples[0][1], self.metric)
        if delta < self.min_delta:
            return [f"{self.name}: {self.metric} moved by {delta:g} "
                    f"(expected >= {self.min_delta:g} — the disruption "
                    f"never exercised this path)"]
        return []


class GaugeBaseline(Invariant):
    """A gauge that must RETURN to its starting band by the last sample
    (churn may spike it mid-run; staying high at the end is the leak)."""

    def __init__(self, metric: str, slack: float, label: str = ""):
        self.metric = metric
        self.slack = slack
        self.name = label or f"baseline:{metric}"

    def check(self, samples):
        if len(samples) < 2:
            return []
        base = total(samples[0][1], self.metric)
        final = total(samples[-1][1], self.metric)
        if final > base + self.slack:
            return [f"{self.name}: {self.metric} ended at {final:g}, "
                    f"baseline {base:g} + slack {self.slack:g}"]
        return []


class BoundedGrowth(Invariant):
    """Leak detector: median of the last third vs median of the first
    third must stay under max_abs and/or max_frac growth."""

    def __init__(self, metric: str, max_abs: Optional[float] = None,
                 max_frac: Optional[float] = None, label: str = ""):
        self.metric = metric
        self.max_abs = max_abs
        self.max_frac = max_frac
        self.name = label or f"growth:{metric}"

    @staticmethod
    def _median(vals: List[float]) -> float:
        vals = sorted(vals)
        return vals[len(vals) // 2] if vals else 0.0

    def check(self, samples):
        if len(samples) < 6:
            return []
        third = max(1, len(samples) // 3)
        first = self._median(
            [total(r, self.metric) for _, r in samples[:third]])
        last = self._median(
            [total(r, self.metric) for _, r in samples[-third:]])
        growth = last - first
        out = []
        if self.max_abs is not None and growth > self.max_abs:
            out.append(f"{self.name}: {self.metric} grew {growth:g} "
                       f"({first:g} -> {last:g}), max_abs {self.max_abs:g}")
        if (self.max_frac is not None and first > 0
                and growth / first > self.max_frac):
            out.append(f"{self.name}: {self.metric} grew "
                       f"{growth / first:.1%} ({first:g} -> {last:g}), "
                       f"max_frac {self.max_frac:.0%}")
        return out


class GaugeCeiling(Invariant):
    """A gauge that must never exceed `ceiling` at ANY sample."""

    def __init__(self, metric: str, ceiling: float, label: str = ""):
        self.metric = metric
        self.ceiling = ceiling
        self.name = label or f"ceiling:{metric}"
        self.worst = 0.0
        self.breaches = 0

    def on_sample(self, t, reading):
        v = total(reading, self.metric)
        self.worst = max(self.worst, v)
        if v > self.ceiling:
            self.breaches += 1

    def check(self, samples):
        if self.breaches:
            return [f"{self.name}: {self.metric} exceeded {self.ceiling:g} "
                    f"at {self.breaches} samples (worst {self.worst:g})"]
        return []


class HistogramP99Flat(Invariant):
    """First-third vs last-third windowed p99 of a histogram: the
    last-third p99 must stay within `ratio` of the first-third p99
    (ignoring windows under `floor` seconds — bucket quantization noise).
    THE sustained-degradation detector: a slow leak in any per-batch cost
    shows up here long before anything crashes."""

    def __init__(self, metric: str, ratio: float = 5.0,
                 floor: float = 0.01, label: str = ""):
        self.metric = metric
        self.ratio = ratio
        self.floor = floor
        self.name = label or f"p99flat:{metric}"
        self.first_p99 = 0.0
        self.last_p99 = 0.0

    def check(self, samples):
        if len(samples) < 6:
            return []
        third = max(1, len(samples) // 3)
        self.first_p99 = window_p99(
            samples[0][1], samples[third][1], self.metric)
        self.last_p99 = window_p99(
            samples[-third - 1][1], samples[-1][1], self.metric)
        if (self.first_p99 >= self.floor or self.last_p99 >= self.floor) \
                and self.last_p99 > self.ratio * max(self.first_p99,
                                                     self.floor):
            return [f"{self.name}: {self.metric} windowed p99 degraded "
                    f"{self.first_p99:g}s -> {self.last_p99:g}s "
                    f"(> {self.ratio:g}x)"]
        return []


class Callback(Invariant):
    """Any zero-arg callable returning violation strings at finish."""

    def __init__(self, name: str, fn: Callable[[], List[str]]):
        self.name = name
        self._fn = fn

    def check(self, samples):
        return list(self._fn())


class InvariantSuite:
    """Sample /metricsz on a cadence, fold every invariant, report.

    `scrape` defaults to the in-process configz.metricsz_body (the same
    text the HTTP /metricsz route serves); pass a callable that GETs a
    real endpoint to monitor a remote process."""

    def __init__(self, invariants: Sequence[Invariant],
                 scrape: Optional[Callable[[], str]] = None):
        if scrape is None:
            from ..utils import configz

            scrape = configz.metricsz_body
        self._scrape = scrape
        self.invariants = list(invariants)
        self.samples: List[Tuple[float, Reading]] = []
        self.violations: List[str] = []

    def sample(self) -> Reading:
        reading = parse_metrics(self._scrape())
        t = time.monotonic()
        self.samples.append((t, reading))
        for inv in self.invariants:
            try:
                inv.on_sample(t, reading)
            except Exception as e:  # noqa: BLE001 — a broken monitor is
                # itself a violation, not a harness crash
                self.violations.append(f"{inv.name}: monitor error {e!r}")
        return reading

    def finish(self) -> List[str]:
        """Final sample + every invariant's verdict; returns ALL
        violations (also kept on self.violations)."""
        self.sample()
        for inv in self.invariants:
            try:
                self.violations.extend(inv.check(self.samples))
            except Exception as e:  # noqa: BLE001
                self.violations.append(f"{inv.name}: check error {e!r}")
        return self.violations

    def bundle(self, out_dir: str, reason: str = "invariant-violation",
               extra: Optional[dict] = None) -> str:
        """Write the triage bundle for a failed run: the flight-recorder
        ring (if tracing is on), the first and last metrics snapshots,
        and report.json (violations + invariant summaries). Returns the
        bundle directory."""
        from ..utils import tracing

        os.makedirs(out_dir, exist_ok=True)
        trace_path = os.path.join(out_dir, "trace.json")
        if tracing.RECORDER.snapshot():
            tracing.dump(reason, path=trace_path)
        for tag, idx in (("first", 0), ("last", -1)):
            if self.samples:
                with open(os.path.join(out_dir, f"metrics_{tag}.json"),
                          "w", encoding="utf-8") as f:
                    json.dump(self.samples[idx][1], f, indent=1,
                              sort_keys=True)
        report = {
            "reason": reason,
            "violations": self.violations,
            "n_samples": len(self.samples),
            "invariants": [inv.name for inv in self.invariants],
        }
        if extra:
            report.update(extra)
        with open(os.path.join(out_dir, "report.json"), "w",
                  encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        return out_dir
