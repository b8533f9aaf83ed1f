"""The ``KTPU_*`` environment knobs this package reads.

Counterpart of kubernetes_tpu/utils/knobs.py, cut to the knobs the port
reads, under the same names, types and defaults: a knob that sizes an
array must resolve the same way in both packages, or their shapes part.
Malformed values degrade to the default with a warning, as there.
Defaults declared as ``DERIVED`` are resolved at the call site, which
passes ``default=`` (``KTPU_MULTIPOD_K``: ops/kernel.py multipod_k;
``KTPU_WHATIF``: scheduler/tpu_backend.py). The registry shows itself on
``/configz`` as ``ktpu-env`` (utils/configz.py), as the reference's does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Union

logger = logging.getLogger(__name__)

# sentinel for knobs whose default is computed at the call site
DERIVED = "(derived)"

_TRUE = frozenset(("1", "true", "on", "yes"))
_FALSE = frozenset(("0", "false", "off", "no"))


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "bool" | "int" | "float" | "str" | "flag"
    default: Union[str, int, float, bool, None]
    description: str


_REGISTRY: Dict[str, Knob] = {}


def _declare(name: str, kind: str, default, description: str) -> Knob:
    knob = Knob(name, kind, default, description)
    _REGISTRY[name] = knob
    return knob


def registry() -> Dict[str, Knob]:
    """Name -> Knob for every declared knob (insertion-ordered)."""
    return dict(_REGISTRY)


def _declared(name: str) -> Knob:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"undeclared knob {name!r}: declare it in "
            "kubernetes_tpu_torch/utils/knobs.py"
        ) from None


_UNSET = object()


def _resolve_default(knob: Knob, override):
    fallback = knob.default if override is _UNSET else override
    if fallback is DERIVED:
        raise ValueError(f"{knob.name} has a derived default; the call site "
                         "must pass default= explicitly")
    return fallback


def get_str(name: str, default=_UNSET) -> str:
    knob = _declared(name)
    raw = os.environ.get(name, "")
    if raw == "":
        return _resolve_default(knob, default) or ""
    return raw


def get_bool(name: str, default=_UNSET) -> bool:
    knob = _declared(name)
    raw = os.environ.get(name, "").strip().lower()
    fallback = bool(_resolve_default(knob, default))
    if raw == "":
        return fallback
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    logger.warning("invalid %s=%r; using %r", name, raw, fallback)
    return fallback


def get_int(name: str, default=_UNSET) -> Optional[int]:
    knob = _declared(name)
    fallback = _resolve_default(knob, default)
    raw = os.environ.get(name, "")
    if raw == "":
        return fallback
    try:
        return int(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using %r", name, raw, fallback)
        return fallback


def get_float(name: str, default=_UNSET) -> Optional[float]:
    knob = _declared(name)
    fallback = _resolve_default(knob, default)
    raw = os.environ.get(name, "")
    if raw == "":
        return fallback
    try:
        return float(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using %r", name, raw, fallback)
        return fallback


def get_flag(name: str) -> bool:
    """Truthy-if-set-nonempty (debug switches like KTPU_DEBUG_INVALIDATE)."""
    _declared(name)
    return os.environ.get(name, "") != ""


# -- mesh / scale-out
_declare("KTPU_NODE_HEADROOM", "float", 0.0,
         "node-axis growth headroom fraction: capacity targets "
         "n*(1+headroom) so node adds land in pre-padded lanes")

# -- scheduling session, kernel builds
_declare("KTPU_MULTIPOD_K", "int", DERIVED,
         "pods decided per scan step (default 1 on CUDA and CPU, 4 on "
         "TPU; 1 restores one-pod-per-step everywhere)")
_declare("KTPU_COMPILATION_CACHE", "str", "",
         "kernel build directory reused across processes (0/off disables "
         "reuse; unset uses build/torch_kernels)")

# -- backend: dispatch loop, session deltas, fault tolerance
_declare("KTPU_SPECULATION", "bool", True,
         "speculative dispatch: chain batch k+1 on the pre-harvest carry "
         "(0 serializes dispatch on harvest)")
_declare("KTPU_SESSION_DELTAS", "bool", True,
         "absorb batchable cluster events into the live session as carry "
         "deltas (0 forces rebuild-on-every-event)")
_declare("KTPU_MAX_QUEUED_DELTAS", "int", 4096,
         "queued-delta backstop: past this a rebuild is cheaper than the "
         "queue and the teardown path absorbs everything")
_declare("KTPU_WHATIF", "bool", DERIVED,
         "device-side preemption what-if planning (default on for CUDA, "
         "off on CPU; 0 is the kill switch, 1 the CPU opt-in)")
_declare("KTPU_WATCHDOG_TIMEOUT", "float", 30.0,
         "max seconds any device wait (harvest/flush/probe) may take "
         "before the dispatch is declared a fault")
_declare("KTPU_DISPATCH_RETRIES", "int", 2,
         "bounded re-drives of a faulted dispatch before RETRY_NODE")
_declare("KTPU_RETRY_BASE", "float", 0.05,
         "dispatch retry backoff base seconds (capped exponential + jitter)")
_declare("KTPU_RETRY_MAX", "float", 2.0,
         "dispatch retry backoff cap seconds")
_declare("KTPU_DEMOTE_THRESHOLD", "int", 3,
         "consecutive device faults before the degradation ladder demotes "
         "one rung")
_declare("KTPU_PROBE_INTERVAL", "float", 1.0,
         "re-promotion canary probe cadence seconds")
_declare("KTPU_DRAIN_TIMEOUT", "float", DERIVED,
         "pipeline drain budget seconds (default max(30, 3x watchdog))")
_declare("KTPU_DEBUG_INVALIDATE", "flag", "",
         "debug: print a stack trace at every session teardown")

# -- scheduler cache
_declare("KTPU_COLUMNAR_CACHE", "bool", True,
         "mirror scheduler-cache hot state in columnar int64 arrays "
         "(0 pins the per-pod object path)")

# -- observability: flight recorder / device timeline
_declare("KTPU_TRACE", "int", 0,
         "flight-recorder level: 0 off, 1 per-stage spans, 2 + per-pod "
         "provenance")
_declare("KTPU_TRACE_CAPACITY", "int", 8192,
         "flight-recorder ring capacity (span events)")
_declare("KTPU_TRACE_DUMP_DIR", "str", "",
         "where fault-seam ring dumps land as JSON (unset = log only)")
_declare("KTPU_DEVTIME", "int", 0,
         "device-timeline level: 0 off, 1 per-launch submit/ready "
         "records, 2 + bounded torch.profiler captures")
_declare("KTPU_DEVTIME_CAPACITY", "int", 4096,
         "device-timeline ring capacity (launch records)")
_declare("KTPU_DEVTIME_PROFILE_MAX", "int", 4,
         "level-2 profiler captures allowed per process")
_declare("KTPU_DEVTIME_DUMP_DIR", "str", "",
         "device-timeline dump dir (unset = beside KTPU_TRACE_DUMP_DIR)")

# -- explain / shadow parity sentinel
_declare("KTPU_EXPLAIN", "bool", False,
         "harvest per-plugin filter verdicts + score splits from the "
         "device alongside decisions (the hoisted session's explain mode)")
_declare("KTPU_EXPLAIN_TOPK", "int", 3,
         "candidate nodes carried per decided pod in the explain payload")
_declare("KTPU_SHADOW_SAMPLE", "float", 0.0,
         "fraction of decided pods the completion worker replays through "
         "the oracle parity sentinel (any rate > 0 turns explain on)")
_declare("KTPU_SHADOW_BUNDLE_DIR", "str", "",
         "where drift repro bundles land (unset = "
         "$TMPDIR/ktpu-shadow-bundles)")

# -- host overload monitor
_declare("KTPU_OVERLOAD", "bool", True,
         "host overload monitor: shed optional work under sustained "
         "pressure (0 disables)")
_declare("KTPU_OVERLOAD_FIFO_AGE", "float", 0.5,
         "completion-FIFO age high-water mark seconds")
_declare("KTPU_OVERLOAD_FIFO_AGE_LOW", "float", DERIVED,
         "FIFO-age low mark (default 0.2x the high mark)")
_declare("KTPU_OVERLOAD_QUEUE_DEPTH", "int", DERIVED,
         "scheduling-queue depth high mark (default max(256, 4x "
         "max_batch))")
_declare("KTPU_OVERLOAD_QUEUE_DEPTH_LOW", "int", DERIVED,
         "queue-depth low mark (default high//4)")
_declare("KTPU_OVERLOAD_STAGE_P99", "float", 0.0,
         "windowed completion-stage p99 high mark seconds (0 = signal "
         "off; workload-shaped, deployment sets it)")
_declare("KTPU_OVERLOAD_SHED_DWELL", "int", 3,
         "consecutive hot ticks before shedding the next lever")
_declare("KTPU_OVERLOAD_RESTORE_DWELL", "int", 8,
         "consecutive calm ticks before restoring the last-shed lever")
_declare("KTPU_OVERLOAD_COOLDOWN", "float", 1.0,
         "min seconds between overload-monitor transitions")

# -- apiserver watch wire
_declare("KTPU_WATCH_BUFFER", "int", 256 * 1024,
         "bounded per-watcher send buffer bytes (overflow evicts the "
         "watcher)")
_declare("KTPU_WATCH_EVICT_AFTER", "float", 10.0,
         "max seconds a watcher may hold queued frames with zero socket "
         "progress before eviction")
_declare("KTPU_WIRE_BINARY", "bool", True,
         "clients negotiate the ktpu-binary wire encoding for watch/list "
         "(0 = kill switch: plain JSON, the pre-binary wire bytes)")
_declare("KTPU_WIRE_BATCH_FRAMES", "int", 512,
         "max queued watch frames coalesced into one chunked socket "
         "write (byte-bounded at a quarter of KTPU_WATCH_BUFFER)")

# -- scheduler failover / leader election
_declare("KTPU_LEASE_FENCE_MARGIN", "float", 2.0,
         "seconds before lease expiry a leader self-fences (stops "
         "renewing and demotes) so a GC-paused or partitioned instance "
         "never races the successor's adoption")

# -- gang scheduling (Coscheduling permit transaction)
_declare("KTPU_GANG_PERMIT_TIMEOUT", "float", 60.0,
         "max seconds a gang may hold reserved capacity while waiting "
         "for its remaining members; past this the whole gang rolls "
         "back (also the orphaned-gang bound for promotion reconcile)")
_declare("KTPU_GANG_DEADLOCK_TICKS", "int", 3,
         "consecutive stalled drainer observations (>=2 gangs waiting, "
         "no membership progress) before the deadlock breaker backs "
         "off the youngest gang")
_declare("KTPU_GANG_DEADLOCK_INTERVAL", "float", 0.5,
         "min seconds between gang deadlock-breaker observations (the "
         "hysteresis clock; ticks faster than this are ignored)")


class _KnobConfigz:
    """Live /configz view: each declared knob's effective value and
    whether it came from the environment or the default."""

    def __serde_to_dict__(self):
        out = {}
        for knob in _REGISTRY.values():
            raw = os.environ.get(knob.name, "")
            out[knob.name] = {
                "value": raw if raw != "" else knob.default,
                "default": knob.default,
                "source": "env" if raw != "" else "default",
                "kind": knob.kind,
            }
        return out


def _install_configz() -> None:
    # deferred import: configz pulls serde
    from . import configz

    configz.install("ktpu-env", _KnobConfigz())


_install_configz()
