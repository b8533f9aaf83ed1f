"""/configz registry (component-base/configz equivalent).

Reference: staging/src/k8s.io/component-base/configz/configz.go — each
component installs its live ComponentConfig under a name; the /configz
handler serializes the whole map so operators can inspect the running
configuration.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict

from . import serde

_lock = threading.Lock()
_registry: Dict[str, Any] = {}


def install(name: str, config: Any) -> None:
    """Register (or replace) a component's live config object."""
    with _lock:
        _registry[name] = config


def install_knobs(name: str, **knobs: Any) -> None:
    """Merge key/value knobs into a named dict entry. The KTPU_* env-var
    surface registers its RUNTIME-EFFECTIVE values here (the resolved
    multipod k, speculation/whatif/session-delta switches, trace level,
    watchdog/drain timeouts) so a running scheduler's configuration is
    inspectable via /configz instead of invisible process environment.
    Multiple components (TPUBackend, Scheduler) contribute to one entry."""
    with _lock:
        entry = _registry.get(name)
        if not isinstance(entry, dict):
            entry = {}
            _registry[name] = entry
        entry.update(knobs)


def delete(name: str) -> None:
    with _lock:
        _registry.pop(name, None)


def delete_if_is(name: str, config: Any) -> None:
    """Remove the entry only if it is still this exact object — two
    components (test clusters) sharing a canonical name must not delete
    each other's live entry."""
    with _lock:
        if _registry.get(name) is config:
            _registry.pop(name, None)


def snapshot() -> Dict[str, Any]:
    """JSON-compatible view of every registered config (the /configz body)."""
    with _lock:
        return {name: serde.to_dict(cfg) for name, cfg in _registry.items()}


def handler_body() -> str:
    return json.dumps(snapshot(), indent=2, sort_keys=True)


def metricsz_body() -> str:
    """Prometheus text exposition of every registered scheduler_* metric
    (the /metricsz body). Served from the same debug HTTP surface as
    /configz so the drift/explain counters are scrapeable without a
    separate metrics server; the import is deferred because configz is
    otherwise metrics-free."""
    from . import metrics as metrics_mod
    from . import selfstats

    # process self-telemetry (RSS/fds/threads) refreshes at scrape time:
    # always-current gauges with no background sampler thread
    selfstats.refresh()
    return metrics_mod.legacy_registry.expose()
