"""`whatif_walk`: the what-if reprieve walk, as one CUDA kernel launch.

Replaces the device half of the reference's jnp program `_whatif_run`
(kubernetes_tpu/ops/whatif.py:119-346): the feasibility passes `feas_one`
/ `feas`, fits_now (no eviction), base (every victim slot evicted) and the
greedy reprieve `lax.scan` over the L victim slots (:321-341), for every
node lane at once. Its inputs are the per-launch prologue of
ops/whatif.py (`whatif_prologue`, plain PyTorch), per node lane,
and the victim / nominated tensors the planner builds.

The kernel (csrc/whatif.cu) runs one thread per node lane: each walks its
own node's slots in order, its running eviction (R + 1 + C + TAA int64
words) in a [W, N] scratch the wrapper allocates in global memory, so no
shape is past a cap. All of it is integer arithmetic,
so it is exact. What bounds it on the card is the bytes of the victim
slots, read once; the simple design is slower than that: each thread's
serial chain of dependent loads sets its time (the note in the source).

`whatif_walk_reference` is the plain PyTorch version: the reference's
`lax.scan` as a Python loop over L, vectorized over the nodes, on the same
inputs. `whatif_walk` sends CPU tensors to it and CUDA tensors to the
kernel; on CUDA it raises `WhatifKernelError` if an input is malformed or
the build or the launch fails, and nothing falls back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from . import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "whatif.cu"

# the kernel's pointer arguments (csrc/whatif.cu WPtr) and int arguments
# (WDim), in order
PTRS = ("free0", "cnt0", "allowed", "req", "chk", "gate",
        "pts_sh", "pts_mn", "reg_at", "pts_chk", "self_m", "f_skew",
        "anti_eff", "anti_chk", "aff_eff", "aff_key_on", "aff_valid",
        "aff_total", "aff_keys", "has_aff", "aff_all_keys",
        "self_match_all",
        "nom_req", "nom_cnt", "nom_mfs", "nom_manti", "nom_mall",
        "v_valid", "v_cnt", "v_req", "v_mfs", "v_manti", "v_mall",
        "scratch", "fits_now", "base", "victims")
DIMS = ("N", "L", "R", "C", "TAA", "TA", "dyn_ipa", "has_nom", "threads")

THREADS = 128
# the min sentinel of the PTS min structure: iinfo(int32).max
BIG = torch.iinfo(torch.int32).max

# launches of the CUDA kernel; the plain version does not count
LAUNCHES = 0
_LIB = None

_I64, _I32, _BOOL = torch.int64, torch.int32, torch.bool


class WhatifKernelError(RuntimeError):
    """The what-if kernel did not build or load, was handed a malformed
    input, or failed to launch or run. Not a device fault: the planner
    lets it propagate, and nothing plans the preemptor on another rung."""


def _lib():
    global _LIB
    if _LIB is None:
        try:
            lib = _build.load(SOURCE)
        except Exception as e:  # noqa: BLE001 — any build or load error
            raise WhatifKernelError(
                f"what-if kernel did not build or load: {e}") from e
        lib.whatif_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p]
        lib.whatif_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def shapes(p: Dict, v: Dict) -> Dict[str, int]:
    """(N, L, R, C, TAA, TA) of one launch, read off its inputs."""
    n, r = p["free0"].shape
    return {"N": n, "L": v["valid"].shape[1], "R": r,
            "C": p["pts_sh"].shape[1], "TAA": v["manti"].shape[2],
            "TA": p["aff_eff"].shape[1] if "aff_eff" in p else 0}


def _specs(d: Dict[str, int], dyn_ipa: bool, has_nom: bool):
    """name -> (dtype, shape) of every tensor the kernel reads or writes."""
    n, L, r, c, taa, ta = (d[k] for k in ("N", "L", "R", "C", "TAA", "TA"))
    spec = {
        "free0": (_I64, (n, r)), "cnt0": (_I64, (n,)),
        "allowed": (_I64, (n,)), "req": (_I64, (r,)), "chk": (_BOOL, (r,)),
        "gate": (_BOOL, (n,)),
        "pts_sh": (_I64, (n, c)), "pts_mn": (_I64, (n, c)),
        "reg_at": (_BOOL, (n, c)), "pts_chk": (_BOOL, (n, c)),
        "self_m": (_I32, (c,)), "f_skew": (_I32, (c,)),
        "v_valid": (_BOOL, (n, L)), "v_cnt": (_I64, (n, L)),
        "v_req": (_I64, (n, L, r)), "v_mfs": (_I32, (n, L, c)),
        "v_manti": (_I32, (n, L, taa)), "v_mall": (_I32, (n, L)),
    }
    if dyn_ipa:
        spec.update({
            "anti_eff": (_I64, (n, taa)), "anti_chk": (_BOOL, (n, taa)),
            "aff_eff": (_I64, (n, ta)), "aff_key_on": (_BOOL, (n, ta)),
            "aff_valid": (_BOOL, (ta,)), "aff_total": (_I64, (1,)),
            "aff_keys": (_I32, (n,)), "has_aff": (_BOOL, (1,)),
            "aff_all_keys": (_BOOL, (n,)), "self_match_all": (_BOOL, (1,)),
        })
    if has_nom:
        spec.update({
            "nom_req": (_I64, (n, r)), "nom_cnt": (_I64, (n,)),
            "nom_mfs": (_I32, (n, c)), "nom_manti": (_I32, (n, taa)),
            "nom_mall": (_I32, (n,)),
        })
    return spec


def _named(p: Dict, v: Dict, nom: Dict) -> Dict[str, torch.Tensor]:
    out = dict(p)
    out.update({f"v_{k}": t for k, t in v.items()})
    out.update({f"nom_{k}": t for k, t in nom.items()})
    return out


def whatif_walk(p: Dict, v: Dict, nom: Dict, has_nom: bool,
                dyn_ipa: bool) -> Dict[str, torch.Tensor]:
    """fits_now [N], base [N] and victims [N, L] (bool) for one preemptor:
    `p` the prologue's tensors, `v` the victim slots (valid, cnt,
    req, mfs, manti, mall), `nom` the nominated pods' aggregates (req, cnt,
    mfs, manti, mall; read only with `has_nom`). CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream
    (asynchronous), or raise WhatifKernelError."""
    global LAUNCHES
    device = p["free0"].device
    if device.type != "cuda":
        return whatif_walk_reference(p, v, nom, has_nom, dyn_ipa)
    d = shapes(p, v)
    named = _named(p, v, nom)
    for name, (dtype, shape) in _specs(d, dyn_ipa, has_nom).items():
        t = named.get(name)
        if t is None or t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != device or not t.is_contiguous():
            got = "missing" if t is None else \
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            raise WhatifKernelError(
                f"whatif_walk: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {device}; got {got}")
    n, L = d["N"], d["L"]
    # each thread's running eviction, word w of lane n at [w, n]
    named["scratch"] = torch.empty((d["R"] + 1 + d["C"] + d["TAA"], n),
                                   dtype=_I64, device=device)
    named["fits_now"] = torch.empty(n, dtype=_BOOL, device=device)
    named["base"] = torch.empty(n, dtype=_BOOL, device=device)
    named["victims"] = torch.empty((n, L), dtype=_BOOL, device=device)
    dims = dict(d, dyn_ipa=int(dyn_ipa), has_nom=int(has_nom),
                threads=THREADS)
    lib = _lib()
    ptrs = [named[k].data_ptr() if k in named else 0 for k in PTRS]
    pa = (ctypes.c_void_p * len(ptrs))(*ptrs)
    da = (ctypes.c_int * len(DIMS))(*(dims[k] for k in DIMS))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.whatif_launch(pa, da, stream)
    if err != 0:
        raise WhatifKernelError(
            f"what-if kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return {k: named[k] for k in ("fits_now", "base", "victims")}


def whatif_walk_reference(p: Dict, v: Dict, nom: Dict, has_nom: bool,
                          dyn_ipa: bool) -> Dict[str, torch.Tensor]:
    """The plain version of `whatif_walk`: the reference's feas_one / feas
    and its reprieve lax.scan as a loop over the L slots, vectorized over
    the nodes, on the same inputs."""
    reg = p["reg_at"]
    self_m = p["self_m"][None, :]
    f_skew = p["f_skew"][None, :]
    if dyn_ipa:
        aff_on = p["aff_key_on"]

    def feas_one(ev, use_nom):
        ev_req, ev_cnt, ev_mfs, ev_manti, ev_mall = ev
        free_n = p["free0"] + ev_req
        cnt_n = p["cnt0"] - ev_cnt
        if use_nom:
            free_n = free_n - nom["req"]
            cnt_n = cnt_n + nom["cnt"]
        over = (p["req"][None, :] > free_n) & p["chk"][None, :]
        fit_ok = ~(over.any(dim=1) | ((cnt_n + 1) > p["allowed"]))
        delta = ev_mfs - nom["mfs"] if use_nom else ev_mfs
        adj = p["pts_sh"] - delta
        cnt_eff = torch.where(reg, adj, 0)
        m = torch.where(reg, torch.minimum(p["pts_mn"], adj), p["pts_mn"])
        m = torch.where(m == BIG, 0, m)
        skew = cnt_eff + self_m - m
        pts_ok = ~(p["pts_chk"] & (skew > f_skew)).any(dim=1)
        ok = p["gate"] & fit_ok & pts_ok
        if dyn_ipa:
            # an unchecked term (invalid, or its key off the node) is
            # never read, so the key-on gate of the reference's
            # subtraction is implied by anti_chk
            anti_adj = p["anti_eff"] - ev_manti
            aff_adj = p["aff_eff"] - torch.where(aff_on, ev_mall[:, None], 0)
            tot_adj = p["aff_total"] - ev_mall * p["aff_keys"]
            if use_nom:
                anti_adj = anti_adj + nom["manti"]
                aff_adj = aff_adj + torch.where(aff_on, nom["mall"][:, None],
                                                0)
                tot_adj = tot_adj + nom["mall"] * p["aff_keys"]
            fail_anti = (p["anti_chk"] & (anti_adj > 0)).any(dim=1)
            pods_exist = torch.where(p["aff_valid"][None, :], aff_adj > 0,
                                     True).all(dim=1)
            aff_ok = ~p["has_aff"] | (p["aff_all_keys"] & (pods_exist | (
                (tot_adj == 0) & p["self_match_all"])))
            ok = ok & ~fail_anti & aff_ok
        return ok

    def feas(ev):
        ok = feas_one(ev, False)
        if has_nom:
            ok = ok & feas_one(ev, True)
        return ok

    n, L = v["valid"].shape
    dev = p["free0"].device
    zero_ev = (
        torch.zeros_like(p["free0"]), torch.zeros(n, dtype=_I64, device=dev),
        torch.zeros_like(p["pts_sh"]),
        torch.zeros(v["manti"][:, 0].shape, dtype=_I64, device=dev),
        torch.zeros(n, dtype=_I32, device=dev),
    )
    fits_now = feas(zero_ev)
    state = (
        v["req"].sum(dim=1), v["cnt"].sum(dim=1),
        v["mfs"].sum(dim=1, dtype=_I64), v["manti"].sum(dim=1, dtype=_I64),
        v["mall"].sum(dim=1).to(_I32),
    )
    base = feas(state)
    victims = []
    for l in range(L):
        valid_l = v["valid"][:, l]
        cand = (
            state[0] - v["req"][:, l], state[1] - v["cnt"][:, l],
            state[2] - v["mfs"][:, l], state[3] - v["manti"][:, l],
            state[4] - v["mall"][:, l],
        )
        reprieved = feas(cand) & valid_l
        state = tuple(
            torch.where(reprieved.reshape((n,) + (1,) * (old.dim() - 1)),
                        new, old)
            for old, new in zip(state, cand))
        victims.append(valid_l & ~reprieved)
    return {"fits_now": fits_now, "base": base,
            "victims": torch.stack(victims, dim=1) if victims else
            torch.zeros((n, 0), dtype=_BOOL, device=dev)}
