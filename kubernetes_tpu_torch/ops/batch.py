"""Batched sequential scheduling: B pods decided in one call.

Port of kubernetes_tpu/ops/batch.py. The decision semantics stay
sequential — pod i sees the assumed state of pods 0..i-1, exactly like the
assume-cache (pkg/scheduler/internal/cache/cache.go:361 AssumePod) — over
a carry:

    carry = mutable slice of cluster state (requested, nz_requested,
            pod_count + the pod-row table)
    step  = every filter and score section (ops/kernel.py schedule_pod)
            -> argmax -> in-carry assume update

The reference runs the steps as one `lax.scan`; here they are a Python
loop of eager torch ops on the device of the cluster's tensors, with no
read-back until the batch's decisions are returned. It is the
reference-shaped scan, not a kernel: the port's batches run on the scan
kernel through ops/scan.py (whose carry is the kernel's count tables, not
this pod-row table) and on ops/hoisted.py.

Restrictions (callers take the sessions otherwise):
  * batch pods must share encoded array shapes (template-stamped pods do);
  * batch pods must carry no pod-(anti-)affinity terms and no host ports —
    those mutate the term/port tables, which stay static in the carry.
    `schedule_batch` refuses such a pod. Labels, resources, spread
    constraints, node affinity are all fine: their effect on later pods
    flows through the carried pod rows.

Tie-breaking is lowest-node-index (`torch.argmax` returns the first
maximum, as `jnp.argmax` does) rather than the reference scheduler's
reservoir sample over ties (core/generic_scheduler.go:152).

`shape_signature` and `pod_batchable` are also what the backend groups a
pending batch by.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .kernel import DEFAULT_WEIGHTS, schedule_pod

# cluster arrays mutated by the in-scan assume update
CARRY_KEYS = (
    "requested", "nz_requested", "pod_count",
    "ppair", "pkey", "pnode", "pns", "pterm", "pvalid",
)


def _step(static_c: Dict, weights: Dict, carry: Dict, x: Dict):
    """One pod: `carry` is updated in place (the caller owns it); returns
    the step's outputs as tensors on the carry's device."""
    c = dict(static_c)
    c.update(carry)
    out = schedule_pod(c, x["pod"], weights)
    total = out["total"]
    # one-element index tensors throughout: a 0-d index reads the index
    # back to the host
    best = torch.argmax(total).view(1)
    score = total.index_select(0, best)
    feasible = (score >= 0) & x["valid"].view(1)
    p = x["pod"]
    add = feasible.to(torch.int64)
    carry["requested"].index_add_(0, best, (p["req"] * add).view(1, -1))
    carry["nz_requested"].index_add_(0, best,
                                     (p["nz_req"] * add).view(1, -1))
    carry["pod_count"].index_add_(0, best, add.to(torch.int32))
    pidx = x["pidx"].view(1).to(torch.int64)
    best32 = best.to(torch.int32)
    rows = {
        "pvalid": feasible,
        "ppair": p["self_ppair"],
        "pkey": p["self_pkey"],
        "pnode": torch.where(feasible, best32, torch.zeros_like(best32)),
        "pns": p["self_ns"],
        "pterm": torch.zeros_like(feasible),
    }
    for k, v in rows.items():
        t = carry[k]
        t.index_copy_(0, pidx, v.to(t.dtype).reshape((1,) + t.shape[1:]))
    y = {
        "best": torch.where(feasible, best32, torch.full_like(best32, -1)),
        "score": torch.where(feasible, score, torch.full_like(score, -1)),
        "n_feasible": out["feasible"].to(torch.int32).sum().view(1),
    }
    return carry, y


def _scan_batch(static_c: Dict, carry: Dict, xs: Dict, weights_key
                ) -> Tuple[Dict, Dict]:
    """`_step` over the batch's rows (the reference's `lax.scan`). The
    carry is copied first, so the cluster's tensors stay as they were;
    the outputs are stacked over the batch: best int32, score int64,
    n_feasible int32."""
    carry = {k: v.clone() for k, v in carry.items()}
    weights = dict(weights_key)
    b = xs["pidx"].shape[0]
    ys = []
    for i in range(b):
        x = {"pod": {k: v[i] for k, v in xs["pod"].items()},
             "pidx": xs["pidx"][i], "valid": xs["valid"][i]}
        carry, y = _step(static_c, weights, carry, x)
        ys.append(y)
    return carry, {k: torch.cat([y[k] for y in ys]) for k in ys[0]}


# -- pod-array packing ------------------------------------------------------
# A batch's ~50 stacked pod arrays are packed host-side into one buffer
# per dtype group (bool / int32-ish / int64) and sliced back apart on the
# device: 3 uploads per batch instead of ~50.

_GROUP_OF_DTYPE = {
    np.dtype(np.bool_): ("b", np.bool_),
    np.dtype(np.int8): ("i4", np.int32),
    np.dtype(np.int16): ("i4", np.int32),
    np.dtype(np.int32): ("i4", np.int32),
    np.dtype(np.int64): ("i8", np.int64),
}


def _pack_stacked(stacked: Dict[str, np.ndarray]):
    """-> ({group: [B, W] array}, layout) with layout hashable."""
    b = next(iter(stacked.values())).shape[0]
    offsets = {"b": 0, "i4": 0, "i8": 0}
    chunks = {"b": [], "i4": [], "i8": []}
    layout = []
    for key in sorted(stacked):
        arr = stacked[key]
        group, gdtype = _GROUP_OF_DTYPE[arr.dtype]
        flat = np.ascontiguousarray(arr.reshape(b, -1), dtype=gdtype)
        layout.append(
            (key, group, offsets[group], flat.shape[1], arr.shape[1:], arr.dtype.str)
        )
        offsets[group] += flat.shape[1]
        chunks[group].append(flat)
    packed = {
        g: (
            np.concatenate(chunks[g], axis=1)
            if chunks[g]
            else np.zeros((b, 0), np.dtype(np.bool_ if g == "b" else np.int32))
        )
        for g in chunks
    }
    return packed, tuple(layout)


_TORCH_DTYPE = {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}


def _unpack_stacked(packed: Dict, layout) -> Dict:
    """Inverse of _pack_stacked, on the packed tensors' device."""
    out = {}
    for key, group, off, width, shape, dtype_str in layout:
        b = packed[group].shape[0]
        sl = packed[group][:, off:off + width]
        out[key] = sl.reshape((b,) + tuple(shape)).to(
            _TORCH_DTYPE[np.dtype(dtype_str)])
    return out


def _scan_batch_packed(
    static_c: Dict, carry: Dict, packed: Dict, pidx, valid, weights_key, layout
) -> Tuple[Dict, Dict]:
    xs = {"pod": _unpack_stacked(packed, layout), "pidx": pidx, "valid": valid}
    return _scan_batch(static_c, carry, xs, weights_key)


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


def schedule_batch(
    cluster: Dict,
    pod_arrays_list: List[Dict],
    free_slots: List[int],
    weights: Optional[Dict[str, int]] = None,
) -> Tuple[List[int], Dict]:
    """Schedule the batch sequentially on the cluster's device.

    cluster: the device dict of tensors (models/encoding.py
             device_state()); left unchanged.
    pod_arrays_list: encoded pods (numpy), all with identical shapes and
             each batchable (`pod_batchable`).
    free_slots: pre-allocated pod-table row ids, len >= len(batch).

    Returns (decisions, new_carry): decisions[i] is the chosen node index
    or -1; new_carry holds the post-batch mutable arrays (CARRY_KEYS, the
    cluster's dtypes; callers sync the host encoding from the returned
    decisions instead).
    """
    b = len(pod_arrays_list)
    assert len(free_slots) >= b
    sig0 = shape_signature(pod_arrays_list[0])
    for pa in pod_arrays_list[1:]:
        assert shape_signature(pa) == sig0, "batch pods must share shapes"
    if not all(pod_batchable(pa) for pa in pod_arrays_list):
        raise AssertionError("batch pods must carry no affinity terms and no "
                             "host ports (pod_batchable)")
    stacked = {
        k: np.stack([np.asarray(pa[k]) for pa in pod_arrays_list])
        for k in pod_arrays_list[0]
        if not k.startswith("_")
    }
    packed, layout = _pack_stacked(stacked)
    static_c = {k: v for k, v in cluster.items() if k not in CARRY_KEYS}
    carry = {k: cluster[k] for k in CARRY_KEYS}
    dev = cluster["requested"].device
    key = tuple(sorted((weights or DEFAULT_WEIGHTS).items()))
    new_carry, ys = _scan_batch_packed(
        static_c,
        carry,
        {g: torch.from_numpy(a).to(dev) for g, a in packed.items()},
        torch.from_numpy(np.asarray(free_slots[:b], np.int32)).to(dev),
        torch.ones(b, dtype=torch.bool, device=dev),
        key,
        layout,
    )
    # ktpu: allow-sync(harvest decode: the one-shot API returns its decisions as a host list by design)
    return [int(v) for v in ys["best"].cpu().tolist()], new_carry
