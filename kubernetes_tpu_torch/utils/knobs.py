"""The ``KTPU_*`` environment knobs this package reads.

Counterpart of kubernetes_tpu/utils/knobs.py, cut to the knobs the port
reads, under the same names, types and defaults: a knob that sizes an
array must resolve the same way in both packages, or their shapes part.
Malformed values degrade to the default with a warning, as there.
Defaults declared as ``DERIVED`` are resolved at the call site, which
passes ``default=`` (``KTPU_MULTIPOD_K``: ops/kernel.py multipod_k).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Union

logger = logging.getLogger(__name__)

# sentinel for knobs whose default is computed at the call site
DERIVED = "(derived)"


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "int" | "float"
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


def get_int(name: str, default=_UNSET) -> Optional[int]:
    knob = _declared(name)
    fallback = knob.default if default is _UNSET else default
    if fallback is DERIVED:
        raise ValueError(f"{name} has a derived default; the call site "
                         "must pass default= explicitly")
    raw = os.environ.get(name, "")
    if raw == "":
        return fallback
    try:
        return int(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using %r", name, raw, fallback)
        return fallback


def get_float(name: str) -> Optional[float]:
    knob = _declared(name)
    raw = os.environ.get(name, "")
    if raw == "":
        return knob.default
    try:
        return float(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using %r", name, raw, knob.default)
        return knob.default


# -- mesh / scale-out
_declare("KTPU_NODE_HEADROOM", "float", 0.0,
         "node-axis growth headroom fraction: capacity targets "
         "n*(1+headroom) so node adds land in pre-padded lanes")

# -- scheduling session
_declare("KTPU_MULTIPOD_K", "int", DERIVED,
         "pods decided per scan step (default 1 on CUDA and CPU, 4 on "
         "TPU; 1 restores one-pod-per-step everywhere)")
