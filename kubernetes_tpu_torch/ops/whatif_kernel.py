"""The what-if dry run on the card: one preemptor's device program.

Replaces the whole of the reference's jnp program `_whatif_run`
(kubernetes_tpu/ops/whatif.py:116-346): its prologue (:146-243),
`feas_one` / `feas` (:245-302), fits_now and base (:304-319) and the
greedy reprieve `lax.scan` over the L victim slots (:321-341), for every
node lane at once. Three hand-written kernels (csrc/whatif.cu):

  * `whatif_context` (once per what-if context and template): the values
    that depend only on the context's carry and the template `tj` — the
    eviction-invariant gate (`static_mask`, the host-port mask, the
    existing pods' anti terms), the PTS shared counts of the template's
    constraints, and the IPA effective term counts of the session's D1-D3
    composition (the reference's int32 count products included). They
    are kept on the context (`WhatifContext.tables`).
  * `whatif_mins` (once per preemptor, only where a spread constraint is
    valid): the PTS minimum structure of the claimed-drained shared
    counts, one block a constraint.
  * `whatif_device` (once per preemptor): `whatif_mins` where it is
    needed, then the walk: a warp a node lane, word w of the running
    eviction in a register of lane w, the per-lane prologue read straight
    from the context's tables and the claimed drains, every feasibility
    pass a compare a lane and a warp-wide vote.

Every per-preemptor input (the victim slots, the nominated pods'
aggregates, the claimed drains) arrives in ONE buffer at fixed aligned
offsets (`layout`, `pack`), copied in once; fits_now, base and victims
leave in one [N, L + 2] bool tensor (`outputs` splits it), read back once.

The plain version is the port's earlier composition: `context_reference`
(the torch prologue's invariant part), `mins_reference` and
`lane_prologue` (its per-launch part) and `whatif_walk_reference` (the reference's feas and scan as a
Python loop over L), composed by `whatif_plain`. CPU tensors take it;
CUDA tensors launch the kernels, and a malformed input, a failed build or
a launch error raises `WhatifKernelError`. Nothing falls back.

All of it is integer arithmetic (int64 as the reference's carry, int32
wraps where the reference's int32 wraps), so the kernels equal the plain
version bit for bit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import build as _build
from . import kernel as K
from .hoisted import _count_matmul, _gather_rows

SOURCE = Path(__file__).resolve().parent / "csrc" / "whatif.cu"

# the kernels' pointer arguments (csrc/whatif.cu WPtr) and int arguments
# (WDim), in order; both entries take the same two arrays
PTRS = (
    # the session's tables at template tj, the context's carry
    "alloc", "requested", "pod_count", "allowed", "req", "req_check",
    "req_has_any", "static_mask", "f_valid", "f_key_on", "f_pair_cn",
    "f_reg_real", "f_same_key", "f_cnt", "f_self_match", "f_skew",
    "want_pair", "want_triple", "want_wild", "want_valid",
    "cp_any", "cp_wild", "cp_trip",
    "anti_key_on", "anti_valid", "anti_key", "anti_cnt_n", "m_anti",
    "kaa_all", "fail_existing", "match_all", "aff_key", "aff_valid",
    "aff_cnt_n", "aff_total", "has_aff", "aff_all_keys", "self_match_all",
    "pok", "nkey", "u_cnt", "k_cnt",
    # whatif_context's outputs, the walk's inputs
    "gate0", "shared0", "anti0", "aff0", "atot0",
    # one preemptor's packed inputs, the minimum structure, the outputs
    "inp", "mins", "out",
)
# the packed per-preemptor inputs, in buffer order
PACKED = ("v_valid", "v_cnt", "v_req", "v_mfs", "v_manti", "v_mall",
          "nom_req", "nom_cnt", "nom_mfs", "nom_manti", "nom_mall",
          "pre_req", "pre_cnt", "pre_shared", "pre_anti", "pre_aff",
          "pre_atot")
DIMS = ("N", "L", "R", "C", "TAA", "TA", "VNP", "K", "U", "MP", "PW", "PT",
        "tj", "dyn_ipa", "dyn_ports", "has_nom", "any_f", "kw",
        *(f"o_{k}" for k in PACKED))

TEAM = 32                     # the walk's lanes a node lane: a warp
MAX_KW = 8                    # eviction words (or affinity terms) a lane
ALIGN = 128                   # byte alignment of each packed array
# the min sentinel of the PTS min structure: iinfo(int32).max
BIG = torch.iinfo(torch.int32).max

# launches of the what-if walk (one a preemptor), of the minimum-structure
# kernel (one a preemptor with a valid spread constraint) and of the
# context kernel (one a context and template); the plain version does not
# count
LAUNCHES = 0
MINS_LAUNCHES = 0
CONTEXT_LAUNCHES = 0
_LIB = None

_I64, _I32, _BOOL, _U8 = torch.int64, torch.int32, torch.bool, torch.uint8
_CNT = torch.int32
_NP = {_I64: np.int64, _I32: np.int32, _BOOL: np.bool_}


class WhatifKernelError(RuntimeError):
    """The what-if kernels did not build or load, were handed a malformed
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
        for fn in (lib.whatif_context_launch, lib.whatif_mins_launch,
                   lib.whatif_launch):
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# the context's tables


def tables(S: Dict, c_static: Dict, carry: Dict, tj: int, dyn_ipa: bool,
           dyn_ports: bool) -> Dict[str, torch.Tensor]:
    """The session's tables at template tj and the context's carry, under
    the kernels' names: views, nothing computed or copied."""

    def sel(key):
        return S[key][tj]

    tab = {
        "alloc": c_static["alloc"], "requested": carry["requested"],
        "pod_count": carry["pod_count"], "allowed": c_static["allowed_pods"],
        "req": sel("req"), "req_check": sel("req_check"),
        "req_has_any": sel("req_has_any").reshape(1),
        "static_mask": sel("static_mask"), "f_valid": sel("f_valid"),
        "f_key_on": sel("f_key_on_node"), "f_pair_cn": sel("f_pair_cn"),
        "f_reg_real": sel("f_reg_real"), "f_same_key": sel("f_same_key"),
        "f_cnt": carry["f_cnt"][tj], "f_self_match": sel("f_self_match"),
        "f_skew": sel("f_skew"),
    }
    if dyn_ports:
        tab.update({k: sel(k) for k in ("want_pair", "want_triple",
                                        "want_wild", "want_valid")})
        tab.update({k: carry[k] for k in ("cp_any", "cp_wild", "cp_trip")})
    if dyn_ipa:
        tab.update({
            "anti_key_on": sel("ipa_anti_key_on_node"),
            "anti_valid": sel("ipaaa_valid"), "anti_key": sel("ipaaa_key"),
            "anti_cnt_n": sel("ipa_anti_cnt_n"), "m_anti": S["M_anti"],
            "kaa_all": S["ipaaa_key"],
            "fail_existing": sel("ipa_fail_existing"),
            "match_all": sel("match_all"), "aff_key": sel("ipaa_key"),
            "aff_valid": sel("ipaa_valid"), "aff_cnt_n": sel("ipa_aff_cnt_n"),
            "aff_total": sel("ipa_aff_total").reshape(1),
            "has_aff": sel("ipa_has_aff").reshape(1),
            "aff_all_keys": sel("ipa_aff_all_keys"),
            "self_match_all": sel("ipa_self_match_all").reshape(1),
            "pok": c_static["pair_of_key"], "nkey": c_static["nkey"],
            "u_cnt": carry["u_cnt"], "k_cnt": carry["k_cnt"],
        })
    return tab


def table_dims(tab: Dict, tj: int, dyn_ipa: bool, dyn_ports: bool
               ) -> Dict[str, int]:
    """The context's shapes, read off its tables."""
    n, r = tab["alloc"].shape
    c, vnp = tab["f_reg_real"].shape
    d = {"N": n, "R": r, "C": c, "VNP": vnp, "tj": tj,
         "dyn_ipa": int(dyn_ipa), "dyn_ports": int(dyn_ports),
         "TAA": 1, "TA": 0, "K": 0, "U": 0, "MP": 0, "PW": 0, "PT": 0}
    if dyn_ipa:
        d.update(TAA=tab["anti_key"].shape[0], TA=tab["aff_key"].shape[0],
                 K=tab["pok"].shape[1], U=tab["u_cnt"].shape[0])
    if dyn_ports:
        d.update(MP=tab["want_pair"].shape[0], PW=tab["cp_any"].shape[1],
                 PT=tab["cp_trip"].shape[1])
    return d


def _table_specs(d: Dict[str, int]) -> Dict[str, Tuple]:
    """name -> (dtype, shape) of every table the kernels read."""
    n, r, c, vnp = d["N"], d["R"], d["C"], d["VNP"]
    spec = {
        "alloc": (_I64, (n, r)), "requested": (_I64, (n, r)),
        "pod_count": (_I32, (n,)), "allowed": (_I64, (n,)),
        "req": (_I64, (r,)), "req_check": (_BOOL, (r,)),
        "req_has_any": (_BOOL, (1,)), "static_mask": (_BOOL, (n,)),
        "f_valid": (_BOOL, (c,)), "f_key_on": (_BOOL, (n, c)),
        "f_pair_cn": (_I32, (n, c)), "f_reg_real": (_BOOL, (c, vnp)),
        "f_same_key": (_BOOL, (c, c)), "f_cnt": (_I32, (c, vnp)),
        "f_self_match": (_I32, (c,)), "f_skew": (_I32, (c,)),
    }
    if d["dyn_ports"]:
        mp, pw, pt = d["MP"], d["PW"], d["PT"]
        spec.update({
            "want_pair": (_I32, (mp,)), "want_triple": (_I32, (mp,)),
            "want_wild": (_BOOL, (mp,)), "want_valid": (_BOOL, (mp,)),
            "cp_any": (_I32, (n, pw)), "cp_wild": (_I32, (n, pw)),
            "cp_trip": (_I32, (n, pt)),
        })
    if d["dyn_ipa"]:
        taa, ta, k, u = d["TAA"], d["TA"], d["K"], d["U"]
        spec.update({
            "anti_key_on": (_BOOL, (n, taa)), "anti_valid": (_BOOL, (taa,)),
            "anti_key": (_I32, (taa,)), "anti_cnt_n": (_I64, (n, taa)),
            "m_anti": (_BOOL, (u, taa, u)), "kaa_all": (_I32, (u, taa)),
            "fail_existing": (_BOOL, (n,)), "match_all": (_BOOL, (u,)),
            "aff_key": (_I32, (ta,)), "aff_valid": (_BOOL, (ta,)),
            "aff_cnt_n": (_I64, (n, ta)), "aff_total": (_I64, (1,)),
            "has_aff": (_BOOL, (1,)), "aff_all_keys": (_BOOL, (n,)),
            "self_match_all": (_BOOL, (1,)), "pok": (_I32, (n, k)),
            "nkey": (_BOOL, (n, k)), "u_cnt": (_I32, (u, vnp)),
            "k_cnt": (_I32, (u, k)),
        })
    return spec


def _inv_specs(d: Dict[str, int]) -> Dict[str, Tuple]:
    """name -> (dtype, shape) of whatif_context's outputs."""
    spec = {"gate0": (_BOOL, (d["N"],)),
            "shared0": (_I64, (d["C"], d["VNP"]))}
    if d["dyn_ipa"]:
        spec.update({"anti0": (_I64, (d["N"], d["TAA"])),
                     "aff0": (_I64, (d["N"], d["TA"])),
                     "atot0": (_I64, (1,))})
    return spec


def check(named: Dict, specs: Dict[str, Tuple], device) -> None:
    """Raise WhatifKernelError unless every tensor of `specs` is present,
    of its dtype and shape, contiguous and on `device`."""
    device = torch.device(device)
    for name, (dtype, shape) in specs.items():
        t = named.get(name)
        if t is None or t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != device or not t.is_contiguous():
            got = "missing" if t is None else \
                f"{t.dtype} {tuple(t.shape)} on {t.device}" + (
                    "" if t.is_contiguous() else ", not contiguous")
            raise WhatifKernelError(
                f"what-if kernel: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {device}; got {got}")


def _launch(entry: str, named: Dict, dims: Dict, device) -> None:
    lib = _lib()
    ptrs = [named[k].data_ptr() if k in named else 0 for k in PTRS]
    pa = (ctypes.c_void_p * len(ptrs))(*ptrs)
    da = (ctypes.c_int * len(DIMS))(*(int(dims.get(k, 0)) for k in DIMS))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(pa, da, stream)
    if err != 0:
        raise WhatifKernelError(
            f"what-if kernel launch ({entry}) failed: CUDA error {err}")


def context_reference(tab: Dict, d: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The plain version of `whatif_context`: the invariant half of the
    port's torch prologue (the reference's whatif.py:155-224 for one
    template), from the same tables."""
    dyn_ipa, tj = bool(d["dyn_ipa"]), d["tj"]
    gate0 = tab["static_mask"]
    if d["dyn_ports"]:
        gate0 = gate0 & K.ports_mask(
            tab["cp_any"], tab["cp_wild"], tab["cp_trip"],
            {k: tab[k] for k in ("want_pair", "want_triple", "want_wild",
                                 "want_valid")})
    out = {}
    if dyn_ipa:
        u_cnt, k_cnt = tab["u_cnt"], tab["k_cnt"]
        pok, nk = tab["pok"], tab["nkey"]
        kaa = tab["kaa_all"].long()                   # [U, TAA]
        cnt1 = _gather_rows(u_cnt, pok[:, kaa].permute(1, 0, 2))  # [U,N,TAA]
        g1 = tab["m_anti"][:, :, tj]                  # [U, TAA]
        nk1 = nk[:, kaa].permute(1, 0, 2)             # [U, N, TAA]
        fail_existing_dyn = (g1[:, None, :] & nk1 & (cnt1 > 0)).any(
            dim=2).any(dim=0)                         # [N]
        w2 = _count_matmul(tab["m_anti"][tj].to(_CNT), u_cnt)  # [TAA, Vnp]
        pair_nt = pok[:, tab["anti_key"].long()].long()         # [N, TAA]
        out["anti0"] = tab["anti_cnt_n"] + torch.gather(w2.T, 0, pair_nt)
        g3 = tab["match_all"].to(_CNT)                # [U]
        w3 = _count_matmul(g3[None, :], u_cnt)[0]     # [Vnp]
        aff_key = tab["aff_key"].long()
        out["aff0"] = tab["aff_cnt_n"] + w3[pok[:, aff_key].long()]
        out["atot0"] = tab["aff_total"] + (
            tab["aff_valid"][None, :].to(_CNT) * g3[:, None]
            * k_cnt[:, aff_key]).sum(dtype=_I64)
        gate0 = gate0 & ~(tab["fail_existing"] | fail_existing_dyn)
    out["gate0"] = gate0
    out["shared0"] = torch.where(
        tab["f_same_key"][:, :, None], tab["f_cnt"][None, :, :], 0
    ).sum(dim=1, dtype=_I64)                          # [C, Vnp]
    return {k: t.contiguous() for k, t in out.items()}


def whatif_context(tab: Dict, d: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The context's invariants for one template (gate0 [N], shared0
    [C, Vnp], and with dyn_ipa anti0 [N, TAA], aff0 [N, TA], atot0 [1]):
    CPU tables take the plain version; CUDA tables launch the context
    kernel on the current stream, or raise WhatifKernelError."""
    global CONTEXT_LAUNCHES
    device = tab["alloc"].device
    if device.type != "cuda":
        return context_reference(tab, d)
    check(tab, _table_specs(d), device)
    inv = {name: torch.empty(shape, dtype=dtype, device=device)
           for name, (dtype, shape) in _inv_specs(d).items()}
    _launch("whatif_context_launch", dict(tab, **inv), d, device)
    CONTEXT_LAUNCHES += 1
    return inv


# ---------------------------------------------------------------------------
# one preemptor's packed inputs


def _packed_specs(d: Dict[str, int]) -> List[Tuple[str, torch.dtype, Tuple]]:
    n, L, r, c, taa, vnp = (d[k] for k in ("N", "L", "R", "C", "TAA",
                                           "VNP"))
    shapes = {
        "v_valid": (_BOOL, (n, L)), "v_cnt": (_I64, (n, L)),
        "v_req": (_I64, (n, L, r)), "v_mfs": (_I32, (n, L, c)),
        "v_manti": (_I32, (n, L, taa)), "v_mall": (_I32, (n, L)),
        "nom_req": (_I64, (n, r)), "nom_cnt": (_I64, (n,)),
        "nom_mfs": (_I32, (n, c)), "nom_manti": (_I32, (n, taa)),
        "nom_mall": (_I32, (n,)),
        "pre_req": (_I64, (n, r)), "pre_cnt": (_I64, (n,)),
        "pre_shared": (_I32, (c, vnp)), "pre_anti": (_I32, (taa, vnp)),
        "pre_aff": (_I32, (vnp,)), "pre_atot": (_I32, (1,)),
    }
    return [(k, *shapes[k]) for k in PACKED]


def layout(d: Dict[str, int]) -> Tuple[Dict[str, Tuple], int]:
    """({name: (offset, dtype, shape)}, total bytes) of the packed input
    buffer: PACKED's arrays in order, each at an ALIGN-byte offset. `d`
    needs N, L, R, C, VNP and TAA (the victim tensors' anti-term width,
    1 for a template without terms)."""
    out, off = {}, 0
    for name, dtype, shape in _packed_specs(d):
        out[name] = (off, dtype, shape)
        nbytes = int(np.prod(shape)) * np.dtype(_NP[dtype]).itemsize
        off += -(-nbytes // ALIGN) * ALIGN
    return out, off


def pack(v: Dict, nom: Dict, pre: Dict, d: Dict[str, int],
         buf: np.ndarray) -> None:
    """Write one preemptor's arrays (the planner's numpy layout: v valid,
    cnt, req, mfs, manti, mall; nom req, cnt, mfs, manti, mall; pre req,
    cnt, shared, anti, aff, atot) into `buf` (uint8, `layout`'s size)."""
    src = {**{f"v_{k}": a for k, a in v.items()},
           **{f"nom_{k}": a for k, a in nom.items() if k != "has_nom"},
           **{f"pre_{k}": a for k, a in pre.items()}}
    for name, (off, dtype, shape) in layout(d)[0].items():
        a = np.asarray(src[name])
        npt = np.dtype(_NP[dtype])
        if a.shape != shape and not (name == "pre_atot" and a.size == 1):
            raise WhatifKernelError(
                f"what-if inputs: {name} has shape {a.shape}, not {shape}")
        nbytes = a.size * npt.itemsize
        buf[off:off + nbytes].view(npt)[:] = a.astype(npt, copy=False
                                                      ).reshape(-1)


def unpack(buf: torch.Tensor, d: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The packed buffer's arrays as views, under PACKED's names."""
    out = {}
    for name, (off, dtype, shape) in layout(d)[0].items():
        nbytes = int(np.prod(shape)) * np.dtype(_NP[dtype]).itemsize
        out[name] = buf[off:off + nbytes].view(dtype).reshape(shape)
    return out


def outputs(out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """fits_now [N], base [N] and victims [N, L] of one [N, L + 2] output."""
    return {"fits_now": out[:, 0], "base": out[:, 1], "victims": out[:, 2:]}


# ---------------------------------------------------------------------------
# the plain version


def mins_reference(tab: Dict, pk: Dict) -> torch.Tensor:
    """The plain version of `whatif_mins`: per constraint, (min, count at
    the min, min of the rest) of its registered pairs' shared counts with
    the claimed drains applied, unregistered pairs counting as BIG;
    [C, 3] int64."""
    masked = torch.where(tab["f_reg_real"], tab["shared0"] - pk["pre_shared"],
                         BIG)                                 # [C, Vnp]
    min1 = masked.min(dim=1).values
    at_min = masked == min1[:, None]
    min2 = torch.where(at_min, BIG, masked).min(dim=1).values
    return torch.stack([min1, at_min.sum(dim=1), min2], dim=1)


def lane_prologue(tab: Dict, pk: Dict, dyn_ipa: bool
                  ) -> Dict[str, torch.Tensor]:
    """The per-launch half of the port's torch prologue (the reference's
    whatif.py:146-243 with the invariants of `tab` in place): per node
    lane, under the walk's names.

      free0 [N, R], cnt0 [N], allowed [N]: capacity and pod count with the
        claimed victims drained; req [R], chk [R] (req_check AND
        req_has_any); gate [N]: the invariant gate AND NOT (a
        constraint's key missing);
      pts_sh [N, C] (the shared count at the node's pair), pts_mn [N, C]
        (the global min with that pair excluded where it is registered,
        else the min), reg_at [N, C] (the pair is registered), pts_chk
        [N, C] (the constraint is checked at the node), self_m [C],
        f_skew [C];
      with dyn_ipa: anti_eff / aff_eff [N, TAA] / [N, Ta] (effective term
        counts), anti_chk [N, TAA] (the term is valid and its key on the
        node), aff_key_on [N, Ta], aff_valid [Ta], aff_total [1], aff_keys
        [N] (the node's scattered term entries), has_aff [1],
        aff_all_keys [N], self_match_all [1].

    The claimed drains (pk's pre_*) apply to every state; pre_shared /
    pre_anti / pre_aff at topology-PAIR granularity."""
    out = {}
    out["free0"] = tab["alloc"] - tab["requested"] + pk["pre_req"]
    out["cnt0"] = tab["pod_count"].to(_I64) - pk["pre_cnt"]
    out["allowed"] = tab["allowed"].to(_I64)
    out["req"] = tab["req"]
    out["chk"] = tab["req_check"] & tab["req_has_any"]
    if dyn_ipa:
        pok = tab["pok"]
        pair_nt = pok[:, tab["anti_key"].long()].long()       # [N, TAA]
        aff_key = tab["aff_key"].long()
        pair_na = pok[:, aff_key].long()                      # [N, Ta]
        aff_valid = tab["aff_valid"]
        aff_key_on = tab["nkey"][:, aff_key]                  # [N, Ta]
        out["anti_eff"] = tab["anti0"] - torch.gather(
            pk["pre_anti"].T, 0, pair_nt)
        out["anti_chk"] = tab["anti_key_on"] & tab["anti_valid"][None, :]
        out["aff_eff"] = tab["aff0"] - pk["pre_aff"][pair_na]
        out["aff_key_on"] = aff_key_on
        out["aff_valid"] = aff_valid
        out["aff_total"] = tab["atot0"] - pk["pre_atot"]
        # one evicted matches-all victim on node n drains aff_total by
        # the number of its node's scattered term entries
        out["aff_keys"] = (aff_valid[None, :] & aff_key_on).sum(
            dim=1).to(_CNT)                                   # [N]
        out["has_aff"] = tab["has_aff"]
        out["aff_all_keys"] = tab["aff_all_keys"]
        out["self_match_all"] = tab["self_match_all"]

    # PTS: shared counts (claimed drains applied), min structure
    f_valid = tab["f_valid"]
    any_f = f_valid.any()
    shared = tab["shared0"] - pk["pre_shared"]                # [C, Vnp]
    reg_real = tab["f_reg_real"]
    pair_cn = tab["f_pair_cn"].long()                         # [N, C]
    key_on_f = tab["f_key_on"]
    fail_missing = (f_valid[None, :] & ~key_on_f).any(dim=1)
    min1, cnt_min1, min2 = mins_reference(tab, pk).unbind(dim=1)
    shared_at = torch.gather(shared.T, 0, pair_cn)            # [N, C]
    reg_at = torch.gather(reg_real.T, 0, pair_cn)             # [N, C]
    # global min with this node's own pair EXCLUDED: re-enters adjusted
    min_excl = torch.where(
        reg_at & (shared_at == min1[None, :]) & (cnt_min1[None, :] == 1),
        min2[None, :], min1[None, :],
    )                                                         # [N, C]
    out["pts_sh"] = shared_at
    out["pts_mn"] = torch.where(reg_at, min_excl, min1[None, :])
    out["reg_at"] = reg_at
    out["pts_chk"] = any_f & f_valid[None, :] & key_on_f
    out["self_m"] = tab["f_self_match"]
    out["f_skew"] = tab["f_skew"]
    out["gate"] = tab["gate0"] & ~(any_f & fail_missing)
    return out


def whatif_walk_reference(p: Dict, v: Dict, nom: Dict, has_nom: bool,
                          dyn_ipa: bool) -> Dict[str, torch.Tensor]:
    """The reference's feas_one / feas and its reprieve lax.scan as a loop
    over the L slots, vectorized over the nodes: `p` the lane prologue,
    `v` the victim slots (valid, cnt, req, mfs, manti, mall), `nom` the
    nominated pods' aggregates (req, cnt, mfs, manti, mall; read only with
    `has_nom`)."""
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


def _split(pk: Dict) -> Tuple[Dict, Dict]:
    v = {k[2:]: pk[k] for k in PACKED if k.startswith("v_")}
    nom = {k[4:]: pk[k] for k in PACKED if k.startswith("nom_")}
    return v, nom


def whatif_plain(tab: Dict, buf: torch.Tensor, d: Dict[str, int]
                 ) -> torch.Tensor:
    """The plain version of `whatif_device` on the same inputs: the lane
    prologue, then the reference's walk; [N, L + 2] bool (fits_now, base,
    victims)."""
    with torch.no_grad():
        pk = unpack(buf, d)
        p = lane_prologue(tab, pk, bool(d["dyn_ipa"]))
        v, nom = _split(pk)
        ys = whatif_walk_reference(p, v, nom, bool(d["has_nom"]),
                                   bool(d["dyn_ipa"]))
        return torch.cat([ys["fits_now"][:, None], ys["base"][:, None],
                          ys["victims"]], dim=1)


# ---------------------------------------------------------------------------
# the wrapper


def launch_dims(d: Dict[str, int], L: int, has_nom: bool, any_f: bool
                ) -> Dict[str, int]:
    """One launch's int arguments: the context's shapes, the slot count,
    the packed offsets, the words a lane."""
    out = dict(d, L=L, has_nom=int(has_nom), any_f=int(any_f))
    words = d["R"] + 1 + d["C"] + (d["TAA"] if d["dyn_ipa"] else 0)
    need = -(-max(words, d["TA"], 1) // TEAM)
    kw = 1
    while kw < need:
        kw *= 2
    if kw > MAX_KW:
        raise WhatifKernelError(
            f"what-if kernel: {words} eviction words and {d['TA']} "
            f"affinity terms exceed {MAX_KW} a lane of a warp")
    out["kw"] = kw
    for name, (off, _, _) in layout(out)[0].items():
        out[f"o_{name}"] = off
    return out


def _checked(tab: Dict, buf: torch.Tensor, d: Dict[str, int]) -> Dict:
    """The launch's named tensors, after the spec check."""
    specs = dict(_table_specs(d), **_inv_specs(d))
    specs["inp"] = (_U8, (layout(d)[1],))
    named = dict(tab, inp=buf)
    check(named, specs, buf.device)
    return named


def _launch_mins(named: Dict, d: Dict[str, int], device) -> torch.Tensor:
    global MINS_LAUNCHES
    named["mins"] = torch.empty((d["C"], 3), dtype=_I64, device=device)
    _launch("whatif_mins_launch", named, d, device)
    MINS_LAUNCHES += 1
    return named["mins"]


def whatif_mins(tab: Dict, buf: torch.Tensor, d: Dict[str, int]
                ) -> torch.Tensor:
    """The PTS minimum structure of one preemptor alone: [C, 3] int64
    (min, count at the min, second min). CPU tensors take
    `mins_reference`; CUDA tensors launch its kernel on the current stream,
    or raise WhatifKernelError. `whatif_device` launches it itself where a
    spread constraint is valid."""
    if buf.device.type != "cuda":
        return mins_reference(tab, unpack(buf, d))
    return _launch_mins(_checked(tab, buf, d), d, buf.device)


def whatif_device(tab: Dict, buf: torch.Tensor, d: Dict[str, int]
                  ) -> torch.Tensor:
    """One preemptor's dry run: [N, L + 2] bool (fits_now, base, victims;
    `outputs` splits it). `tab` is the context's tables and invariants for
    the template, `buf` the packed inputs (`layout`), `d` the launch's
    dims (`launch_dims`). CPU tensors take the plain version; CUDA tensors
    launch the kernels on the current stream (asynchronous): the minimum
    structure's where a spread constraint is valid, then the walk's; or
    raise WhatifKernelError."""
    global LAUNCHES
    device = buf.device
    if device.type != "cuda":
        return whatif_plain(tab, buf, d)
    named = _checked(tab, buf, d)
    if d["any_f"]:
        _launch_mins(named, d, device)
    named["out"] = torch.empty((d["N"], d["L"] + 2), dtype=_BOOL,
                               device=device)
    _launch("whatif_launch", named, d, device)
    LAUNCHES += 1
    return named["out"]
