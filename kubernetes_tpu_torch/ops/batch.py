"""Batch grouping helpers of kubernetes_tpu/ops/batch.py: the shape
signature the backend groups a pending batch by, and the batchable test
of an encoded pod (copies).

The reference module's one-dispatch sequential batch, `schedule_batch`,
is not ported: the backend schedules through its sessions (ops/scan.py,
ops/hoisted.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def pod_batchable(pod_arrays: Dict) -> bool:
    """True if the encoded pod leaves term/port tables untouched when
    assumed: no required/preferred (anti-)affinity terms, no host ports."""
    return not (
        np.asarray(pod_arrays["ipaa_valid"]).any()
        or np.asarray(pod_arrays["ipaaa_valid"]).any()
        or np.asarray(pod_arrays["ipap_valid"]).any()
        or np.asarray(pod_arrays["want_valid"]).any()
    )


def shape_signature(pod_arrays: Dict) -> Tuple:
    return tuple(sorted((k, np.shape(v)) for k, v in pod_arrays.items()))
