"""The ``KTPU_*`` environment knobs this package reads.

Counterpart of kubernetes_tpu/utils/knobs.py, cut to the knobs the port
reads, under the same names, types and defaults: a knob that sizes an
array must resolve the same way in both packages, or their shapes part.
Malformed values degrade to the default with a warning, as there.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Union

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "float" (the only kind read so far)
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
