"""Feature gates (component-base/featuregate equivalent).

Reference: staging/src/k8s.io/component-base/featuregate/feature_gate.go —
a registry of named features with prerelease stages (Alpha default-off,
Beta default-on, GA locked-on), set from the `--feature-gates=k=v,...`
flag, queryable anywhere via Enabled(). The known-gate set mirrors the
subset of pkg/features/kube_features.go this build implements behavior
for.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    pre_release: str = ALPHA
    lock_to_default: bool = False  # GA gates can't be turned off


class FeatureGate:
    def __init__(self, known: Optional[Dict[str, FeatureSpec]] = None):
        self._lock = threading.Lock()
        self._known: Dict[str, FeatureSpec] = dict(known or {})
        self._enabled: Dict[str, bool] = {}

    def add(self, features: Dict[str, FeatureSpec]) -> None:
        with self._lock:
            for name, spec in features.items():
                existing = self._known.get(name)
                if existing is not None and existing != spec:
                    raise ValueError(f"feature gate {name!r} already registered")
                self._known[name] = spec

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name in self._enabled:
                return self._enabled[name]
            spec = self._known.get(name)
            if spec is None:
                raise KeyError(f"unknown feature gate {name!r}")
            return spec.default

    def set(self, name: str, value: bool) -> None:
        with self._lock:
            spec = self._known.get(name)
            if spec is None:
                raise KeyError(f"unknown feature gate {name!r}")
            if spec.lock_to_default and value != spec.default:
                raise ValueError(
                    f"cannot set feature gate {name} to {value}: locked to "
                    f"{spec.default}"
                )
            self._enabled[name] = value

    def set_from_map(self, overrides: Dict[str, bool]) -> None:
        for name, value in overrides.items():
            self.set(name, value)

    def set_from_string(self, flag: str) -> None:
        """--feature-gates=Foo=true,Bar=false."""
        for part in flag.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            if val.lower() not in ("true", "false"):
                raise ValueError(f"invalid feature gate value {part!r}")
            self.set(key.strip(), val.lower() == "true")

    def known_features(self) -> Dict[str, FeatureSpec]:
        with self._lock:
            return dict(self._known)

    def overrides(self) -> Dict[str, bool]:
        """Current explicit overrides (for save/restore around a scope)."""
        with self._lock:
            return dict(self._enabled)

    def restore(self, overrides: Dict[str, bool]) -> None:
        with self._lock:
            self._enabled = dict(overrides)

    def state(self) -> Dict[str, bool]:
        with self._lock:
            return {
                name: self._enabled.get(name, spec.default)
                for name, spec in sorted(self._known.items())
            }


# The gate set the TPU build has behavior for (subset of the reference's
# 94 gates in pkg/features/kube_features.go, at their v1.21 stages).
DEFAULT_FEATURE_GATES: Dict[str, FeatureSpec] = {
    "DefaultPodTopologySpread": FeatureSpec(default=True, pre_release=BETA),
    "PodDisruptionBudget": FeatureSpec(default=True, pre_release=BETA),
    "TaintBasedEvictions": FeatureSpec(default=True, pre_release=GA, lock_to_default=True),
    "EndpointSlice": FeatureSpec(default=True, pre_release=GA, lock_to_default=True),
    "TTLAfterFinished": FeatureSpec(default=True, pre_release=BETA),
    "CronJobControllerV2": FeatureSpec(default=True, pre_release=BETA),
    "CSIStorageCapacity": FeatureSpec(default=False, pre_release=ALPHA),
    # TPU-build-specific: selects the XLA scoring backend by default
    "TPUScoringKernel": FeatureSpec(default=True, pre_release=BETA),
}


default_feature_gate = FeatureGate(DEFAULT_FEATURE_GATES)
