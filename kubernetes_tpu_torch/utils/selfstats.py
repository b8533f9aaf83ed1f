"""Process self-telemetry gauges (process_* metrics on /metricsz).

The endurance soak's leak invariants (bounded RSS/fd/thread growth —
testing/invariants.py) read the SAME surface an operator scrapes instead
of poking process internals: `refresh()` samples the process and updates
the gauges, and `configz.metricsz_body()` calls it right before every
exposition so /metricsz is always current without a background sampler
thread.

Sources are Linux-first with portable fallbacks: RSS from
/proc/self/statm (resource.getrusage reports the PEAK, useless for a
growth invariant), fd count from /proc/self/fd, thread count from
threading (enumerate of live Python threads — the pipeline's workers,
binders, watch writers all register there).
"""

from __future__ import annotations

import os
import threading

from .metrics import Gauge, legacy_registry

process_rss = legacy_registry.register(
    Gauge(
        "process_resident_memory_bytes",
        "Resident set size of this process (from /proc/self/statm; 0 "
        "where /proc is unavailable). The soak's leak invariant bounds "
        "its first-window-to-last-window growth.",
        (),
    )
)
process_open_fds = legacy_registry.register(
    Gauge(
        "process_open_fds",
        "Open file descriptors of this process (from /proc/self/fd; 0 "
        "where /proc is unavailable). Sustained growth under churn = a "
        "leaked socket/stream per wave.",
        (),
    )
)
process_threads = legacy_registry.register(
    Gauge(
        "process_threads",
        "Live Python threads in this process (threading.active_count). "
        "The pipeline workers, binder pool, probe thread, and per-watch "
        "writer threads all count here; growth under churn = a worker "
        "restart or watch path leaking threads.",
        (),
    )
)

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes() -> int:
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


def open_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return 0


def refresh() -> None:
    """Sample the process into the gauges; called by metricsz_body()
    before every exposition. Cheap (two /proc reads) and must never
    raise into the metrics handler."""
    try:
        process_rss.set(rss_bytes())
        process_open_fds.set(open_fds())
        process_threads.set(threading.active_count())
    except Exception:  # noqa: BLE001 — telemetry is best-effort
        pass
