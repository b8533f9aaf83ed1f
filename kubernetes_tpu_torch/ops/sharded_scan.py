"""Sharded two-phase scheduling session: the scan session's math over a
node-axis mesh, exact.

Port of kubernetes_tpu/ops/sharded_scan.py (ShardedPallasSession). The
single-device scan (ops/scan.py ScanSession, one kernel launch a batch)
cannot span devices: each pod needs GLOBAL reductions (the score
normalizations' min/max over all nodes, reference
helper/normalize_score.go:24 and framework/runtime/framework.go:757; the
PTS min-match; the cross-node argmax), and sharding those away silently
changes decisions. So each per-pod step takes the reference's two-phase
form:

  raw partials   — every shard computes masks/counts/scores over ITS node
                   lanes only, from node-sharded carries (the scan
                   session's node-space layout: requested/nzpc/cnt_fn/
                   cnt_sn, all [rows, N] — nothing pair-global);
  collectives    — the cross-shard values are reduced over the node axis:
                   the PTS filter's per-constraint min-match, zone
                   presence, n_scored / n_feasible, the normalize
                   min/max pairs, the argmax (max score, then the least
                   global lane among the maxima: the first-max
                   convention) and the winner's pair ids for the count
                   updates;
  finish + apply — normalization and totals are lane-local; the winning
                   shard alone takes the carry updates (`hot` is
                   all-zero off the winner).

The mesh is parallel/sharded.py `Mesh`: one process owns every shard,
as in the reference. Torch has no shard_map and no lax.scan: a batch is
a Python loop over its pods on the host, and each step runs its torch
ops once per GROUP — the shards one device holds, side by side on the
lane axis (a group tensor [rows, k*Npl] is the shards' [rows, k, Npl]) —
so one group of k shards costs the ops of one shard. A collective
reduces each group's partial over its lanes (the group's shards), then
across groups: each partial moves to the mesh's lead device, the
partials are combined there in shard order, and the result goes back to
every group's device. Every reduced value is an integer (min, max, sum
and OR of int32 counts, integer-valued f32 counts below 2^24 in the
reference), so the result does not depend on how the lanes are split;
the argmax is one max over a packed int64 (score, least lane) key.
Everything is enqueued on the caller's current stream; nothing is read
back inside a batch.

Decisions are BIT-IDENTICAL to the single-device ScanSession and the
reference's PallasSession (same int32 rescaled resources, f32 score math
in the same order, first-max tie-break) and to the reference's
ShardedPallasSession wherever that one runs (templates without affinity
terms: its commit reads an unbound `ucnt` with terms). Pinned by
tests/test_torch_sharded_scan.py.

Statics and envelope come from ScanSession's own prologue (the GCD int32
rescale, per-template static rows, compact topology vocab): a shape
ScanSession rejects is rejected here with the same SessionUnsupported
reasons. Templates with affinity TERMS ride the sharded session too:
the D1-D5 ucnt carry is per-node (sharded like the rest), kcnt holds
per-shard partial key totals summed at read, and the presence flags
(rowany) are a max.

Pod and allocatable deltas (`apply_deltas`) run through the hand-written
delta kernel (ops/scan_kernel.py `carry_delta`, `ops/csrc/scan_full.cu`
carry_delta_kernel) on each group's lanes; node joins and leaves are
lane-column writes between those runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.encoding import StagingRing, cluster_from_numpy
from ..parallel.partition import (
    SESSION_PARTITION_RULES,
    session_specs,
    shard_tree,
)
from .kernel import MAX_NODE_SCORE
from .kernel import multipod_k as resolve_multipod_k
from .kernel import multipod_utilization_conflicts
from .scan import (
    CARRY_KEYS,
    LANE,
    POS_BIG,
    SUB,
    ScanSession,
    SessionUnsupported,
    _ceil,
    batch_prologue,
)
from .scan_kernel import carry_delta, log_weights

I32, I64, F32, F64 = torch.int32, torch.int64, torch.float32, torch.float64
# the argmax key: (total << 32) + (LANE_KEY - global lane)
LANE_KEY = 2 ** 31 - 1
_REDUCE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


class _Group:
    """One mesh group's part of the session: its lanes [lo, hi) (its
    shards' lanes in shard order), its statics and carry on its device."""

    def __init__(self, mg, npl: int, statics: Dict, carry: Dict):
        self.device = mg.device
        self.k, self.s0 = mg.k, mg.s0
        self.lo = mg.s0 * npl
        self.L = mg.k * npl
        self.hi = self.lo + self.L
        self.st = statics
        self.carry = carry
        self.glane = torch.arange(self.lo, self.hi, dtype=I64,
                                  device=self.device)
        self.lanekey = LANE_KEY - self.glane
        self.shard = torch.arange(mg.k, dtype=I64, device=self.device)


def g_key(g: _Group) -> str:
    """The key of a group's device in the session's per-device tables."""
    return str(g.device)


class _T:
    """Template t's tables on one device, with the host-known facts the
    step branches on (its valid constraint rows, its term flags)."""


def _rows(idx: List[int], device: torch.device):
    """A row selector: a slice for a contiguous run, else an index
    tensor on `device` (nothing is uploaded inside a step)."""
    if idx == list(range(idx[0], idx[-1] + 1)):
        return slice(idx[0], idx[-1] + 1)
    return torch.tensor(idx, dtype=I64, device=device)


def _fit_row(c: _T, st: Dict, carry: Dict) -> torch.Tensor:
    """NodeResourcesFit row for template t against `carry` (local, no
    collectives) — shared by the eval and the multi-pod step's conflict
    recheck."""
    nzpc = carry["nzpc"]
    fail = (nzpc[2] + 1) > nzpc[3]
    if c.has_any and c.R:
        free = st["alloc"][:c.R] - carry["requested"][:c.R]
        fail = fail | ((c.req_col > free) & c.chk_col).any(0)
    return ~fail


def _resource_scores(c: _T, st: Dict, carry: Dict):
    """(balanced, least) rows for template t against `carry` (local, no
    collectives) — shared by the eval and the multi-pod step's recheck;
    the same f32 / int32 operations as the reference."""
    nzpc, alloc = carry["nzpc"], st["alloc"]
    nz0, nz1 = c.nz
    nzc = nzpc[0] + nz0
    nzm = nzpc[1] + nz1
    cap_c, cap_m = alloc[0], alloc[1]
    cap_cf, cap_mf = cap_c.to(F32), cap_m.to(F32)
    one = torch.ones((), dtype=F32, device=nzc.device)
    frac_c = torch.where(cap_cf == 0, one, nzc.to(F32) / cap_cf)
    frac_m = torch.where(cap_mf == 0, one, nzm.to(F32) / cap_mf)
    balanced = ((1.0 - (frac_c - frac_m).abs()) * 100.0).to(I32)
    balanced = torch.where((frac_c >= 1) | (frac_m >= 1), 0, balanced)

    def least_dim(cap, reqq):
        d = torch.div((cap - reqq) * MAX_NODE_SCORE,
                      torch.where(cap == 0, 1, cap), rounding_mode="floor")
        return torch.where((cap == 0) | (reqq > cap), 0, d)

    least = torch.div(least_dim(cap_c, nzc) + least_dim(cap_m, nzm), 2,
                      rounding_mode="floor")
    return balanced, least


def _wbl(c: _T, st: Dict, carry: Dict, W: Dict) -> torch.Tensor:
    balanced, least = _resource_scores(c, st, carry)
    return balanced * W["balanced"] + least * W["least"]


def _eval_fn(s: "ShardedScanSession", t: int) -> Dict:
    """Filter + score one pod of template t against the current carries
    WITHOUT updating them: local partials -> collectives -> finish ->
    cross-shard argmax. Mirrors the reference's _eval_fn step for step.
    Returns per-group rows (feasible, total, wbl) and the global best
    lane, score and feasible count (0-d tensors on the lead device, and
    `best_g` / `m_g` per group)."""
    G = s._groups
    W = s.weights
    CP, C, UR = s.CP, s.C, s.UR
    base = t * CP
    cs = [s._tconst(t, g.device) for g in G]

    # ---- phase A: carry-only partials -> collective 1 ----
    A, parts = [], []
    for g, c in zip(G, cs):
        st, cr = g.st, g.carry
        a, p = {"fit": _fit_row(c, st, cr)}, {}
        if c.f_rows is not None:
            sh = (c.f_same @ cr["cnt_fn"][base:base + C].to(F64)).to(I32)
            reg = st["regrow_f"][c.f_rows] != 0
            a["sh"], a["reg"] = sh, reg
            p["min_c"] = ("min", torch.where(reg, sh, POS_BIG).amin(1))
        if UR:
            ucnt = cr["ucnt"]
            pos = ucnt > 0
            a["pos"] = pos
            p["rowany"] = ("max", pos.any(1))
            p["kc"] = ("sum", cr["kcnt"].sum(1))
        A.append(a)
        parts.append(p)
    R1 = s._collective(parts)

    # ---- phase B: feasibility, local scores -> collective 2 ----
    parts = []
    for g, c, a, r in zip(G, cs, A, R1):
        st, cr = g.st, g.carry
        stat = st["stat"][t]
        feasible = (stat[0] != 0) & a["fit"] & (st["valid_n"][0] != 0)
        if c.f_rows is not None:
            min_c = r["min_c"]
            min_c = torch.where(min_c == POS_BIG, 0, min_c)
            cnt_n = torch.where(a["reg"], a["sh"], 0)
            skew = cnt_n + c.f_self - min_c[:, None]
            fail = (st["konn_f"][c.f_rows] == 0) | (skew > c.f_skew)
            feasible = feasible & ~fail.any(0)
        raw_ipa = stat[1]
        present = None
        if UR:
            ucf = cr["ucnt"].to(F64)
            fail1 = (c.g1 @ a["pos"].to(F64)) > 0
            dyn = c.wdyn @ ucf                        # [8 + 8 + 1, L]
            ist = st["ipa_stat"][t]
            fail_anti = (c.avld & (st["anti_konn"][t] != 0)
                         & ((st["anti_static"][t] + dyn[:SUB]) > 0)).any(0)
            ok_ipa = ~((ist[0] != 0) | fail1) & ~fail_anti
            if c.has_aff:
                pods_missing = (
                    c.fvld & ((st["aff_static"][t] + dyn[SUB:2 * SUB]) <= 0)
                ).any(0)
                at_dyn = (c.w3tot * r["kc"]).sum()
                aff_ok = ~pods_missing
                if c.smatch:
                    aff_ok = aff_ok | ((c.aff_total + at_dyn) == 0)
                ok_ipa = ok_ipa & (ist[1] != 0) & aff_ok
            feasible = feasible & ok_ipa
            raw_ipa = raw_ipa + dyn[2 * SUB].to(I32) * c.w45_scale
            present = (c.gpres & (r["rowany"] != 0)).any()
            if c.ipa_present:
                present = torch.ones_like(present)
        a.update(feasible=feasible, raw_ipa=raw_ipa, present=present,
                 wbl=_wbl(c, st, cr, W))
        p = {"nf": ("sum", feasible.sum())}
        if c.s_rows is not None:
            scored = feasible & (st["shasall"][t] != 0)
            a["scored"] = scored
            p["ns"] = ("sum", scored.sum())
            zi = st["zidx"]                                 # [K, L]
            pres = torch.zeros((s.K, s.VZ + 1), dtype=I32, device=g.device)
            pres.scatter_reduce_(1, zi, scored.to(I32).expand(s.K, -1),
                                 "amax")
            p["pres"] = ("max", pres)
        if UR or c.ipa_present:
            p["max_i"] = ("max", torch.where(feasible, raw_ipa,
                                             -POS_BIG).amax())
            p["min_i"] = ("min", torch.where(feasible, raw_ipa,
                                             POS_BIG).amin())
        if W["taint"]:
            p["mx_t"] = ("max", torch.where(feasible, stat[2], 0).amax())
        if W["node_affinity"]:
            p["mx_na"] = ("max", torch.where(feasible, stat[3], 0).amax())
        parts.append(p)
    R2 = s._collective(parts)

    # ---- phase C: PTS score raw -> collective 3 ----
    if cs[0].s_rows is not None:
        parts = []
        for g, c, a, r in zip(G, cs, A, R2):
            st, cr = g.st, g.carry
            pres = r["pres"]
            zpn = pres.gather(1, st["zidx"])                # [K, L]
            topo = ((pres[c.s_key, :s.VZ] != 0) & c.zval_s).sum(1)  # [Cs]
            wbase = torch.where(c.s_perno, r["ns"],
                                torch.where(c.s_first, topo, 0))
            weight = s._logw[g_key(g)].index_select(0, wbase)  # [Cs] f32
            sh = c.s_same @ cr["cnt_sn"][base:base + C].to(F64)
            regn = (zpn[c.s_key] != 0) & (st["zvalid_node_s"][c.s_rows] != 0)
            regn = (regn & c.s_haskey) | c.s_perno[:, None]
            cnt_n = torch.where(regn, sh, 0.0).to(F32)
            term = cnt_n * weight[:, None]
            term = term + c.s_bias
            term = torch.where(st["konn_s"][c.s_rows] != 0, term, 0.0)
            raw = term[0]
            for j in range(1, term.shape[0]):
                raw = raw + term[j]
            raw_i = raw.to(I32)
            a["raw_i"] = raw_i
            parts.append({
                "min_r": ("min", torch.where(a["scored"], raw_i,
                                             POS_BIG).amin()),
                "max_r": ("max", torch.where(a["scored"], raw_i,
                                             0).amax()),
            })
        R3 = s._collective(parts)
    else:
        R3 = [{} for _ in G]

    # ---- phase D: finish, totals -> collective 4 (the argmax) ----
    parts = []
    for g, c, a, r2, r3 in zip(G, cs, A, R2, R3):
        st = g.st
        stat = st["stat"][t]
        feasible = a["feasible"]
        total = a["wbl"]
        if W["image"]:
            total = total + stat[4] * W["image"]
        if W["prefer_avoid"]:
            total = total + stat[5] * W["prefer_avoid"]
        if c.s_rows is not None and W["pts"]:
            min_r, max_r = r3["min_r"], r3["max_r"]
            min_r = torch.where(min_r == POS_BIG, 0, min_r)
            norm = torch.div(MAX_NODE_SCORE * (max_r + min_r - a["raw_i"]),
                             max_r.clamp(min=1), rounding_mode="floor")
            norm = torch.where(max_r == 0, MAX_NODE_SCORE, norm)
            norm = torch.where(a["scored"], norm, 0)
            total = total + norm * W["pts"]
        if (UR or c.ipa_present) and W["ipa"]:
            min_i = r2["min_i"]
            diff = (r2["max_i"] - min_i).to(F32)
            q = (a["raw_ipa"] - min_i).to(F32) / torch.where(diff > 0, diff,
                                                            1.0)
            ipa = torch.where(diff > 0, (q * 100.0).to(I32), 0)
            if a["present"] is not None:
                ipa = torch.where(a["present"], ipa, 0)
            total = total + ipa * W["ipa"]
        if W["taint"]:
            mx = r2["mx_t"]
            scaled = torch.div(MAX_NODE_SCORE * stat[2], mx.clamp(min=1),
                               rounding_mode="floor")
            total = total + torch.where(mx == 0, MAX_NODE_SCORE,
                                        MAX_NODE_SCORE - scaled) * W["taint"]
        if W["node_affinity"]:
            mx = r2["mx_na"]
            scaled = torch.div(MAX_NODE_SCORE * stat[3], mx.clamp(min=1),
                               rounding_mode="floor")
            total = total + torch.where(mx == 0, stat[3],
                                        scaled) * W["node_affinity"]
        total = torch.where(feasible, total, -1)
        a["total"] = total
        key = total.to(I64) * (1 << 32) + g.lanekey
        parts.append({"key": ("max", key.amax())})
    R4 = s._collective(parts)
    keys = [r["key"] for r in R4]
    return {
        "A": A,
        "m_g": [k >> 32 for k in keys],
        "best_g": [LANE_KEY - (k & 0xFFFFFFFF) for k in keys],
        "nf": R2[0]["nf"],
    }


def _commit_fn(s: "ShardedScanSession", t: int, e: Dict, ok_g: List,
               mf: Optional[np.ndarray], ms: Optional[np.ndarray],
               xdev: Dict) -> None:
    """Winner-shard carry updates for one decided pod of template t, in
    place (`hot` is all-zero off the winner, and everywhere when the
    pod is not placed): the apply side of the step, shared by _step_fn
    and the multi-pod step. `ok_g` is the per-group commit gate (a 0-d
    bool), `mf` / `ms` the pod's host match rows (a None row commits no
    counts), `xdev` their device copies per device."""
    G = s._groups
    CP, C, UR = s.CP, s.C, s.UR
    cs = [s._tconst(t, g.device) for g in G]
    parts, loc = [], []
    for g, c, best, ok in zip(G, cs, e["best_g"], ok_g):
        st, cr = g.st, g.carry
        hot = (g.glane == best) & ok
        if c.R:
            cr["requested"][:c.R] += c.req_col * hot
        cr["nzpc"][:3] += c.nz_col * hot
        off = best - g.lo
        inr = (off >= 0) & (off < g.L) & ok
        idx = off.clamp(0, g.L - 1).reshape(1)
        p = {}
        if mf is not None:
            p["pf"] = ("sum", torch.where(
                inr, st["prow_f"].index_select(1, idx)[:, 0], 0))
        if ms is not None:
            p["ps"] = ("sum", torch.where(
                inr, st["prow_s"].index_select(1, idx)[:, 0], 0))
            p["src"] = ("sum", torch.where(
                inr, st["stat"][:, 7].index_select(1, idx)[:, 0], 0))
        hask = None
        if UR:
            pi = torch.where(inr, st["prow_ipa"].index_select(1, idx)[:, 0],
                             0)
            hask = (st["prow_ipa"].index_select(1, idx)[:, 0] >= 0) & inr
            p["pi"] = ("sum", pi)
        parts.append(p)
        loc.append((ok, off, hask))
    if not parts[0]:
        return
    R5 = s._collective(parts)
    for g, c, r, (ok, off, hask) in zip(G, cs, R5, loc):
        st, cr = g.st, g.carry
        x = xdev[g_key(g)]
        if mf is not None:
            pf = st["prow_f"]
            m_f = (pf == r["pf"][:, None]) & (pf >= 0) & ok
            cr["cnt_fn"] += x["mf"][:, None] * m_f
        if ms is not None:
            ps = st["prow_s"]
            m_s = (ps == r["ps"][:, None]) & (ps >= 0) & ok
            v_rows = r["src"][:, None].expand(-1, CP).reshape(-1)
            factor = s._perno_dev[g_key(g)] + (1 - s._perno_dev[g_key(g)]) \
                * v_rows
            cr["cnt_sn"] += (x["ms"] * factor)[:, None] * m_s
        if UR:
            pi = st["prow_ipa"]
            m_i = (pi == r["pi"][:, None]) & (pi >= 0) & ok
            cr["ucnt"][t * SUB:(t + 1) * SUB] += m_i
            col = g.shard == torch.div(off, s.Npl, rounding_mode="floor")
            cr["kcnt"][t * SUB:(t + 1) * SUB] += hask[:, None] & col[None, :]


def _step_fn(s: "ShardedScanSession", x: Dict) -> torch.Tensor:
    """One pod through the two-phase step: _eval_fn -> _commit_fn, the
    one-pod-per-step path. Returns the pod's [best, score, n_feasible,
    -1] on the lead device."""
    t = x["tmpl"]
    e = _eval_fn(s, t)
    ok_g = [m >= 0 for m in e["m_g"]]
    _commit_fn(s, t, e, ok_g, x["mf"], x["ms"], x["dev"])
    m, best, ok = e["m_g"][0], e["best_g"][0], ok_g[0]
    return torch.stack([torch.where(ok, best, -1), torch.where(ok, m, -1),
                        e["nf"].to(I64), torch.full_like(m, -1)])


def _step_multi_fn(s: "ShardedScanSession", xk: List[Dict], seen_g: List):
    """k pods per step: every pod of the group is evaluated against the
    GROUP-START carry (k independent evals), then committed in order
    with the exact conflict test of the hoisted multi-pod step. As in the
    reference there is NO in-device replay: the first conflicted pod and
    everything after it in the batch are left UNCOMMITTED and flagged,
    and the caller replays exactly that suffix through the live session
    (scheduler/tpu_backend.py `schedule_exact`). The suffix flag `seen_g`
    (per group, every group's identical) rides from step to step. Returns
    (per-pod output columns, seen_g)."""
    G = s._groups
    W = s.weights
    evs = [_eval_fn(s, x["tmpl"]) for x in xk]
    committed = []  # (x, e, okc_g) of the already-committed prefix
    out = []
    for x, e in zip(xk, evs):
        t = x["tmpl"]
        cs = [s._tconst(t, g.device) for g in G]
        fv = s._tables["f_valid"][t]
        sv = s._tables["s_valid"][t]
        conf_g = [torch.zeros((), dtype=torch.bool, device=g.device)
                  for g in G]
        for (xj, ej, okj_g) in committed:
            hit = bool(
                (xj["mf"] is not None
                 and (xj["mf"][t * s.CP:t * s.CP + s.C] * fv).sum() > 0)
                or (xj["ms"] is not None
                    and (xj["ms"][t * s.CP:t * s.CP + s.C] * sv).sum() > 0)
                or (s.UR and s._tables["gmat"][xj["tmpl"], t] > 0))
            for gi in range(len(G)):
                prior = okj_g[gi]
                same = prior & (ej["best_g"][gi] == e["best_g"][gi])
                conf_g[gi] = conf_g[gi] | same & (e["m_g"][gi] >= 0)
                if hit:
                    conf_g[gi] = conf_g[gi] | prior
        parts = []
        for g, c, a, best, m in zip(G, cs, e["A"], e["best_g"], e["m_g"]):
            fit_new = _fit_row(c, g.st, g.carry)
            wbl_new = _wbl(c, g.st, g.carry, W)
            flip, over = multipod_utilization_conflicts(
                a["feasible"], a["total"], best, m, g.glane, fit_new,
                a["wbl"], wbl_new)
            util = flip.any() | (over.any() & (m >= 0))
            parts.append({"util": ("max", util)})
        R = s._collective(parts)
        okc_g = []
        for gi in range(len(G)):
            seen_g[gi] = seen_g[gi] | conf_g[gi] | (R[gi]["util"] != 0)
            okc_g.append((e["m_g"][gi] >= 0) & ~seen_g[gi])
        _commit_fn(s, t, e, okc_g, x["mf"], x["ms"], x["dev"])
        committed.append((x, e, okc_g))
        ok, best, m = okc_g[0], e["best_g"][0], e["m_g"][0]
        out.append(torch.stack([torch.where(ok, best, -1),
                                torch.where(ok, m, -1), e["nf"].to(I64),
                                seen_g[0].to(I64)]))
    return out, seen_g


def _sharded_scan(s: "ShardedScanSession", xs: List[Dict], rows: torch.Tensor,
                  k: int = 1) -> None:
    """The batch: a Python loop over its pods (groups of k with k > 1),
    every op enqueued on the current stream, nothing read back. Writes
    each pod's column of `rows` (int32 [4, Bp] on the lead device): best,
    score, n_feasible, and with k > 1 the conflict-suffix flag (else
    -1). One pod a step replays the step's CUDA graph where the session
    has them (`ShardedScanSession._graph_step`)."""
    if k > 1:
        seen_g = [torch.zeros((), dtype=torch.bool, device=g.device)
                  for g in s._groups]
        for i in range(0, len(xs), k):
            out, seen_g = _step_multi_fn(s, xs[i:i + k], seen_g)
            for j, col in enumerate(out):
                rows[:, i + j].copy_(col)
        return
    step = s._graph_step if s.graphs else _step_fn
    for i, x in enumerate(xs):
        rows[:, i].copy_(step(s, x) if step is _step_fn else step(x))


class ShardedScanSession:
    """Session API (schedule/decisions) over the two-phase sharded scan.

    Construction derives every static from ScanSession's prologue (the
    envelope gates — GCD int32 rescale bounds, <= 8 constraints, <= 128
    topology values, f32-exact weights, the IPA term/key budgets — apply
    identically), then splits the node axis over the mesh: Npl lanes a
    shard (a multiple of 128, Npl * nsh >= Np), global lane = shard *
    Npl + local lane, padded lanes invalid with pair ids −1. Affinity-
    TERM templates are supported: the D1-D5 ucnt carry is node-sharded
    like every other per-node count, and the two values that are
    genuinely global (the kcnt key-presence totals and the rowany
    presence flags) are summed / maxed over the node axis. Raises
    SessionUnsupported exactly where ScanSession would."""

    # explain mode demotes the mesh to the hoisted session on the lead
    # device: the two-phase step keeps no per-plugin sections
    supports_explain = False
    # per-batch pinned staging sets on the card (the backend sets its
    # pipeline depth)
    staging_depth = 2

    @staticmethod
    def explain_payload(ys):
        return None

    decisions = staticmethod(ScanSession.decisions)
    conflict_stats = staticmethod(ScanSession.conflict_stats)
    # same GCD-divisibility / int32-headroom envelope as the scan session
    # this mirrors (self._gcd is the inner session's)
    delta_compatible = ScanSession.delta_compatible

    def __init__(self, cluster: Dict, template_arrays_list: List[Dict],
                 weights: Optional[Dict[str, int]] = None,
                 mesh=None, multipod_k: Optional[int] = None):
        if mesh is None:
            raise ValueError("ShardedScanSession needs a mesh")
        lead = mesh.lead
        cluster = {k: v.to(lead) for k, v in cluster.items()}
        inner = ScanSession(cluster, template_arrays_list, weights,
                            multipod_k=1, device=lead)
        self.mesh = mesh
        self.device = lead
        self.multipod_k = resolve_multipod_k(multipod_k,
                                             platform=lead.type)
        self.weights = inner.weights
        self._fps = inner._fps
        self._tp_np = inner._tp_np
        # session-delta interface (tpu_backend classification + apply)
        self._gcd = inner._gcd
        self.dyn_ipa = inner.dyn_ipa
        self._term_np = inner._term_np
        self.T, self.C, self.CP = inner.T, inner.C, inner.CP
        self.R, self.SR, self.K = inner.R, inner.SR, inner.K
        self.TCp = inner.TCp
        self.VZ = inner._zvalid_s.shape[1]
        nsh = mesh.nsh
        Npl = _ceil(max(inner.Np // nsh, 1), LANE)
        while Npl * nsh < inner.Np:
            Npl += LANE
        self.Npl, self.Nps = Npl, Npl * nsh
        self.UR = inner.UR
        self.carry_keys = inner.carry_keys

        def padn(a, axis, fill=0):
            a = np.asarray(a)
            pad = self.Nps - a.shape[axis]
            if pad == 0:
                return a.copy()
            widths = [(0, 0)] * a.ndim
            widths[axis] = (0, pad)
            return np.pad(a, widths, constant_values=fill)

        T, SR, CP, C = self.T, self.SR, self.CP, self.C
        # host mirrors, global [rows, Nps]: the delta classifiers and the
        # node-delta envelope read these (kept in sync by the node deltas)
        self._alloc = padn(inner._alloc, 1)
        self._prow_f_np = padn(inner._prow_f, 1, fill=-1)
        self._prow_s_np = padn(inner._prow_s, 1, fill=-1)
        statics = {
            "alloc": self._alloc,
            # (T, SR, Nps): template-indexed static rows
            "stat": padn(inner._stat[:T * SR], 1).reshape(T, SR, self.Nps),
            "regrow_f": padn(inner._regrow_f, 1),
            "zvalid_node_s": padn(inner._zvalid_node_s, 1),
            "konn_f": padn(inner._konn_f, 1),
            "konn_s": padn(inner._konn_s, 1),
            "shasall": padn(inner._shasall[:T], 1),
            "valid_n": padn(inner._valid_n[0:1], 1),
            "prow_f": self._prow_f_np,
            "prow_s": self._prow_s_np,
            # zone id per node and key (−1: none), the compact form of the
            # reference's one-hots
            "zid": padn(inner._zid, 1, fill=-1),
            "zvalid_s_rows": inner._zvalid_s,
        }
        tb = inner._sc_tables

        def same_pad(a):  # [T, C, C] -> [T, CP, CP]
            out = np.zeros((T, CP, CP), np.float32)
            out[:, :C, :C] = a
            return out

        tables = {
            "req": inner._req_s,
            "req_check": inner._req_check_s,
            "req_has_any": inner._req_has_any_s,
            "nz_req": inner._nz_req_s,
            "f_valid": tb["f_valid"].astype(np.int32),
            "s_valid": tb["s_valid"].astype(np.int32),
            "f_skew": tb["f_skew"].astype(np.int32),
            "s_skew": tb["s_skew"].astype(np.int32),
            "f_self_match": tb["f_self_match"].astype(np.int32),
            "s_first": tb["s_first"].astype(np.int32),
            "s_perno": inner._s_perno.astype(np.int32),
            "s_keyid": inner._s_keyid,
            "f_same": same_pad(tb["f_same_key"]),
            "s_same": same_pad(tb["s_same_key"]),
            "ipa_present": tb["ipa_present"].astype(np.int32),
            "s_perno_rows": _perno_rows(inner._s_perno, T, C, CP),
            # multipod IPA interference superset (all zeros for term-free
            # sessions): G[u, t] != 0 means assuming a template-u pod can
            # perturb a template-t evaluation
            "gmat": inner._gmat[:T, :T],
        }
        if self.UR:
            ipa = inner._ipa
            S8, UR = SUB, self.UR
            statics["ipa_stat"] = padn(
                ipa["ipa_stat"][:2 * T], 1).reshape(T, 2, self.Nps)
            statics["anti_static"] = padn(
                ipa["anti_static"], 1).reshape(T, S8, self.Nps)
            statics["anti_konn"] = padn(
                ipa["anti_konn"], 1).reshape(T, S8, self.Nps)
            statics["aff_static"] = padn(
                ipa["aff_static"], 1).reshape(T, S8, self.Nps)
            statics["prow_ipa"] = padn(ipa["prow_ipa"], 1, fill=-1)
            tables["g1"] = ipa["g1"][:T]
            tables["wanti"] = ipa["wanti"].reshape(T, S8, UR)
            tables["waff"] = ipa["waff"].reshape(T, S8, UR)
            tables["w3tot"] = ipa["w3tot"][:T]
            tables["w45"] = ipa["w45"][:T]
            tables["w45_scale"] = np.int32(ipa["w45_scale"])
            tables["gpres"] = ipa["gpres"][:T]
            tables["has_aff"] = ipa["has_aff"].astype(np.int32)
            tables["self_match_all"] = ipa["self_match_all"].astype(np.int32)
            tables["aff_total"] = ipa["aff_total"].astype(np.int32)
            tables["anti_valid"] = ipa["anti_valid"].astype(np.int32)
            tables["aff_valid"] = ipa["aff_valid"].astype(np.int32)
        # the delta kernel's statics beside `stat` / `prow_*`: the scalar
        # table (its perno flags give the cnt_sn factor)
        delta_statics = {"scalars": inner._scalars}
        carry0 = {
            "requested": padn(inner._requested0, 1),
            "nzpc": padn(inner._nzpc0, 1),
            "cnt_fn": padn(inner._cnt_fn0, 1),
            "cnt_sn": padn(inner._cnt_sn0, 1),
        }
        if self.UR:
            # the session starts with zero ASSUMED pods; kcnt holds
            # PER-SHARD partial totals — one column per shard
            carry0["ucnt"] = np.zeros((self.UR, self.Nps), np.int32)
            carry0["kcnt"] = np.zeros((self.UR, nsh), np.int32)
        self._tables = tables
        # placement is DECLARED by the session rule table
        # (parallel/partition.py SESSION_PARTITION_RULES): one tree per
        # group, node-axis leaves cut to the group's lanes, the rest on
        # its device; a leaf no rule covers fails construction loudly
        placed = shard_tree(
            {"statics": statics, "delta": delta_statics, "carry": carry0},
            SESSION_PARTITION_RULES, mesh)
        self._groups: List[_Group] = []
        for mg, tree in zip(mesh.groups, placed):
            st = tree["statics"]
            # zone index per node, −1 -> the dump column VZ
            zid = st["zid"].to(I64)
            st["zidx"] = torch.where(zid >= 0, zid, self.VZ)
            st["scalars"] = tree["delta"]["scalars"]
            self._groups.append(_Group(mg, Npl, st, tree["carry"]))
        self._logw_np = log_weights(self.Nps + 2)
        self._logw: Dict[str, torch.Tensor] = {}
        self._perno_dev: Dict[str, torch.Tensor] = {}
        self._tc: Dict = {}
        self._rings: Dict[str, StagingRing] = {}
        # one pod a step replays a CUDA graph of the step where every
        # group is on one CUDA device (`_graph_step`); eager elsewhere
        self.graphs = lead.type == "cuda" and mesh.n_devices == 1
        self._graphs: Dict = {}
        self._cap_stream = None
        self.graph_replays = 0
        for g in self._groups:
            key = g_key(g)
            if key not in self._logw:
                self._logw[key] = torch.from_numpy(self._logw_np).to(g.device)
                self._perno_dev[key] = torch.from_numpy(
                    tables["s_perno_rows"].astype(np.int32)).to(g.device)

        # ---- node-delta envelope (node_join_delta / node_leave_delta) --
        # Node add/remove stays a per-lane column write when NOTHING
        # cross-node can change: no assumed-term machinery (UR), no
        # existing-pod affinity terms, no image-locality scores (they
        # embed the global node count), and hostname-only score
        # topologies (zone ids embed a global value vocab).
        self._templates = list(template_arrays_list)
        f_valid_b = np.asarray(tb["f_valid"], bool)
        s_valid_b = np.asarray(tb["s_valid"], bool)
        rows_f = np.zeros(self.TCp, bool)
        rows_s = np.zeros(self.TCp, bool)
        for t in range(T):
            rows_f[t * CP:t * CP + C] = f_valid_b[t]
            rows_s[t * CP:t * CP + C] = s_valid_b[t]
        self._rows_f_valid, self._rows_s_valid = rows_f, rows_s
        cluster_terms = bool(cluster["at_valid"].any()
                             or cluster["st_valid"].any())
        img_rows = inner._stat[:T * SR].reshape(T, SR, -1)[:, 4, :]
        self._node_delta_ok = (
            self.UR == 0 and not cluster_terms
            and not img_rows.any()
            and bool(np.all(inner._s_perno[s_valid_b])))

    # -- per-template tables on a device ------------------------------------

    def _tconst(self, t: int, dev: torch.device) -> _T:
        key = (str(dev), t)
        c = self._tc.get(key)
        if c is not None:
            return c
        tb = self._tables
        C, CP, R = self.C, self.CP, self.R

        def up(a, dtype=None):
            out = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return out if dtype is None else out.to(dtype)

        c = _T()
        c.R = R
        c.has_any = bool(tb["req_has_any"][t])
        c.req_col = up(tb["req"][t][:, None], I32)
        c.chk_col = up(tb["req_check"][t][:, None] != 0)
        nz = tb["nz_req"][t]
        c.nz = (int(nz[0]), int(nz[1]))
        c.nz_col = up(np.array([[nz[0]], [nz[1]], [1]], np.int32))
        base = t * CP
        fv = [ci for ci in range(C) if tb["f_valid"][t, ci]]
        c.f_rows = None
        if fv:
            c.f_rows = _rows([base + ci for ci in fv], dev)
            c.f_same = up(tb["f_same"][t][fv][:, :C], F64)
            c.f_self = up(tb["f_self_match"][t][fv][:, None], I32)
            c.f_skew = up(tb["f_skew"][t][fv][:, None], I32)
        sv = [cc for cc in range(C) if tb["s_valid"][t, cc]]
        c.s_rows = None
        if sv:
            c.s_rows = _rows([base + cc for cc in sv], dev)
            c.s_same = up(tb["s_same"][t][sv][:, :C], F64)
            perno = tb["s_perno"][t][sv] != 0
            keyid = tb["s_keyid"][t][sv]
            first = tb["s_first"][t][sv] != 0
            # non-perno rows register through their key's zone presence;
            # perno rows count every node, key-less rows none
            c.s_perno = up(perno)
            c.s_haskey = up((~perno & (keyid >= 0))[:, None])
            c.s_first = up(~perno & (keyid >= 0) & first)
            c.s_key = up(np.where(keyid >= 0, keyid, 0), I64)
            zv = self._groups[0].st["zvalid_s_rows"]
            c.zval_s = zv[[base + cc for cc in sv]].to(dev) != 0
            c.s_bias = up(
                (tb["s_skew"][t][sv] - 1).astype(np.float32)[:, None])
        c.ipa_present = bool(tb["ipa_present"][t])
        if self.UR:
            c.g1 = up(tb["g1"][t], F64)
            c.wdyn = up(np.concatenate([tb["wanti"][t], tb["waff"][t],
                                        tb["w45"][t][None]]), F64)
            c.avld = up(tb["anti_valid"][t][:, None] != 0)
            c.fvld = up(tb["aff_valid"][t][:, None] != 0)
            c.has_aff = bool(tb["has_aff"][t])
            c.smatch = bool(tb["self_match_all"][t])
            c.aff_total = int(tb["aff_total"][t])
            c.w3tot = up(tb["w3tot"][t], I64)
            c.w45_scale = int(tb["w45_scale"])
            c.gpres = up(tb["gpres"][t] != 0)
        self._tc[key] = c
        return c

    # -- collectives ---------------------------------------------------------

    def _collective(self, parts: List[Dict]) -> List[Dict]:
        """Reduce every group's named partials over the node axis: each
        group's partial already covers its shards' lanes; across groups,
        the partials (packed per reduction, as int64) move to the lead
        device, combine there in shard order, and go back to each
        group's device. `parts[g][name] = (op, tensor)`, op one of
        sum / max / min; returns `[g][name] -> tensor` (int64 after a
        cross-group reduction)."""
        if len(parts) == 1:
            return [{k: v for k, (_, v) in parts[0].items()}]
        lead = self.device
        names = list(parts[0])
        by_op: Dict[str, List[str]] = {}
        for n in names:
            by_op.setdefault(parts[0][n][0], []).append(n)
        out: List[Dict] = [{} for _ in parts]
        for op, ns in by_op.items():
            shapes = [tuple(parts[0][n][1].shape) for n in ns]
            sizes = [int(np.prod(sh)) for sh in shapes]
            fn = _REDUCE[op]
            acc = None
            for p in parts:
                flat = torch.cat([p[n][1].reshape(-1).to(I64) for n in ns])
                flat = flat.to(lead)
                acc = flat if acc is None else fn(acc, flat)
            for gi, g in enumerate(self._groups):
                here = acc.to(g.device)
                for n, sh, piece in zip(ns, shapes, here.split(sizes)):
                    out[gi][n] = piece.reshape(sh)
        return out

    # -- scheduling ----------------------------------------------------------

    def _upload(self, dev: torch.device, arrays: Dict[str, np.ndarray]):
        if dev.type != "cuda":
            return {k: torch.from_numpy(np.array(a, copy=True)).to(dev)
                    for k, a in arrays.items()}
        ring = self._rings.get(str(dev))
        if ring is None:
            ring = self._rings[str(dev)] = StagingRing(
                dev, depth=self.staging_depth)
        # the ring's event goes on `dev`'s current stream, where its copies
        # run
        with torch.cuda.device(dev):
            return ring.upload(arrays)

    def schedule(self, pod_arrays_list: List[Dict]) -> Dict:
        """Enqueue one batch; returns {"rows": [4, Bp] int32 on the lead
        device (best / score / n_feasible / conflict flag, −1 columns
        past the batch), "n", "mk"} — ScanSession's payload, so its
        decisions() and conflict_stats() read it. KeyError on an
        unregistered template (the backend rebuilds)."""
        B = len(pod_arrays_list)
        Bp, tmpl, mfa, msa = batch_prologue(
            self._fps, self._tp_np, pod_arrays_list, minimum=64)
        T, C, CP, TCp = self.T, self.C, self.CP, self.TCp
        mfx = np.zeros((max(B, 1), TCp), np.int32)
        msx = np.zeros((max(B, 1), TCp), np.int32)
        for t in range(T):
            mfx[:B, t * CP:t * CP + C] = mfa[t].reshape(B, C)
            msx[:B, t * CP:t * CP + C] = msa[t].reshape(B, C)
        # one upload a device: per pod its match rows [2, TCp] (mf | ms)
        packed = np.stack([mfx, msx], axis=1)
        dev_x = {}
        for g in self._groups:
            key = g_key(g)
            if key not in dev_x:
                dev_x[key] = self._upload(g.device, {"x": packed})["x"]
        xs = []
        for i in range(B):
            mf = mfx[i] if mfx[i].any() else None
            ms = msx[i] if msx[i].any() else None
            xs.append({
                "tmpl": int(tmpl[i]), "mf": mf, "ms": ms,
                "dev": {k: {"x": v[i], "mf": v[i, 0], "ms": v[i, 1]}
                        for k, v in dev_x.items()},
            })
        k = min(self.multipod_k, Bp)
        rows = torch.full((4, Bp), -1, dtype=I32, device=self.device)
        if B:
            _sharded_scan(self, xs, rows, k=k)
        return {"rows": rows, "n": B, "mk": k}

    # -- the step as a CUDA graph -------------------------------------------

    def _graph_step(self, x: Dict) -> torch.Tensor:
        """One pod a step through a CUDA graph of `_step_fn` (all groups
        on one CUDA device): one graph per (template, the pod's match rows
        present or not), captured the second time such a pod comes (the
        first runs eagerly, which also sets up the libraries the step
        calls) and replayed for every later one after copying the pod's
        match rows into the graph's input. Same ops as the eager step,
        so the same results; returns the graph's output column, valid
        until its next replay."""
        key = (x["tmpl"], x["mf"] is not None, x["ms"] is not None)
        ent = self._graphs.get(key)
        if ent is None:
            self._graphs[key] = "eager"
            return _step_fn(self, x)
        dk = str(self.device)
        if ent == "eager":
            buf = torch.empty_like(x["dev"][dk]["x"])
            xg = dict(x, dev={dk: {"x": buf, "mf": buf[0], "ms": buf[1]}})
            cur = torch.cuda.current_stream(self.device)
            if self._cap_stream is None:
                self._cap_stream = torch.cuda.Stream(self.device)
            self._cap_stream.wait_stream(cur)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._cap_stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = _step_fn(self, xg)
                finally:
                    graph.capture_end()
            cur.wait_stream(self._cap_stream)
            ent = self._graphs[key] = (graph, buf, out)
        graph, buf, out = ent
        buf.copy_(x["dev"][dk]["x"])
        graph.replay()
        self.graph_replays += 1
        return out

    # ktpu: allow-sync(harvest decode: the mesh's carries gathered to the host for parity checks, off the dispatch path)
    def gathered_carry(self) -> Dict[str, np.ndarray]:
        """The carries as host arrays over the whole node axis [rows,
        Nps] (kcnt: [UR, nsh], one partial column per shard)."""
        out = {}
        for k in self._groups[0].carry:
            out[k] = np.concatenate(
                [g.carry[k].cpu().numpy() for g in self._groups], axis=1)
        return out

    # -- incremental device-state deltas ------------------------------------

    def apply_deltas(self, deltas: List[Dict]) -> None:
        """The session-delta contract, extended with the node-axis deltas
        (node-join / node-leave): pod and allocatable deltas run through
        the delta kernel in runs, node deltas apply as lane-column writes
        BETWEEN those runs — ordering matters, because a pod delta may
        name a lane a node-join in the same flush introduced. Raises
        ValueError, before anything of a run moves, for a node outside
        the node axis."""
        run: List[Dict] = []
        for d in deltas:
            if d["kind"] in ("node-join", "node-leave"):
                if run:
                    self._apply_pod_deltas(run)
                    run = []
                self._node_col_apply(int(d["lane"]), d["cols"])
            else:
                run.append(d)
        if run:
            self._apply_pod_deltas(run)

    def _delta_row(self, d) -> tuple:
        """One backend delta -> (node, payload row dres[Rp] | dnzpc[8] |
        mf[TCp] | ms[TCp]) in this session's scaled layout; node-alloc
        patches the alloc static (host mirror and device column)."""
        rp = self._alloc.shape[0]
        dres = np.zeros(rp, np.int32)
        dnzpc = np.zeros(SUB, np.int32)
        mf_rows = np.zeros(self.TCp, np.int32)
        ms_rows = np.zeros(self.TCp, np.int32)
        n = int(d["node"])
        if d["kind"] == "node-alloc":
            scaled = (np.asarray(d["dalloc"], np.int64)
                      // self._gcd).astype(np.int32)
            col = self._alloc[: self.R, n].astype(np.int64) + scaled
            if int(np.abs(col).max(initial=0)) \
                    * (MAX_NODE_SCORE + 1) >= 2 ** 31:
                # cumulative capacity bumps outgrew the int32 score
                # headroom the build guaranteed: rebuild decides
                raise ValueError(
                    "cumulative alloc patches exceed the int32 score "
                    "headroom")
            self._alloc[: self.R, n] += scaled
            g = self._group_of(n)
            g.st["alloc"][: self.R, n - g.lo] += torch.from_numpy(
                scaled).to(g.device)
            dnzpc[3] = d["dallowed"]
        else:
            dres[: self.R] = (np.asarray(d["dres"], np.int64)
                              // self._gcd).astype(np.int32)
            dnzpc[0] = int(d["dnz"][0]) // int(self._gcd[0])
            dnzpc[1] = int(d["dnz"][1]) // int(self._gcd[1])
            dnzpc[2] = d["dcount"]
            for t in range(self.T):
                mf_rows[t * self.CP: t * self.CP + self.C] = d["mf"][t]
                ms_rows[t * self.CP: t * self.CP + self.C] = d["ms"][t]
        return n, np.concatenate([dres, dnzpc, mf_rows, ms_rows])

    def _group_of(self, lane: int) -> _Group:
        for g in self._groups:
            if g.lo <= lane < g.hi:
                return g
        raise ValueError(f"lane {lane} outside [0, {self.Nps})")

    def _apply_pod_deltas(self, deltas: List[Dict]) -> None:
        """Per-group carry patch through the delta kernel, one launch per
        group. An event on another group's node still moves this group's
        count lanes of the same topology pair: such nodes ride as extra
        lanes past the group's own — their pair ids and s_src columns
        gathered from their owners, their carry lanes scratch — and only
        the group's own lanes are kept. The per-shard kcnt partials are
        untouched (batchable pods never enter the assumed-term counts)."""
        for d in deltas:
            if not 0 <= int(d["node"]) < self.Nps:
                raise ValueError(f"delta node {d['node']} outside [0, "
                                 f"{self.Nps})")
        rows = [self._delta_row(d) for d in deltas]
        node = np.array([r[0] for r in rows], np.int64)
        payload = np.stack([r[1] for r in rows]).astype(np.int32)
        for g in self._groups:
            inside = (node >= g.lo) & (node < g.hi)
            ghosts = np.unique(node[~inside])
            local = np.where(inside, node - g.lo,
                             g.L + np.searchsorted(ghosts, node))
            dev = g.device
            if not len(ghosts):
                st = {"scalars": g.st["scalars"],
                      "stat": g.st["stat"].reshape(-1, g.L),
                      "prow_f": g.st["prow_f"], "prow_s": g.st["prow_s"]}
                carry_delta(
                    torch.from_numpy(local.astype(np.int32)).to(dev),
                    torch.from_numpy(payload).to(dev), st, g.carry,
                    self._delta_shapes(g.L))
                continue
            cols = {k: [] for k in ("stat", "prow_f", "prow_s")}
            for h in self._groups:
                mine = ghosts[(ghosts >= h.lo) & (ghosts < h.hi)]
                if not len(mine):
                    continue
                idx = torch.from_numpy(mine - h.lo).to(h.device)
                cols["stat"].append(
                    h.st["stat"].reshape(-1, h.L).index_select(1, idx)
                    .to(dev))
                cols["prow_f"].append(
                    h.st["prow_f"].index_select(1, idx).to(dev))
                cols["prow_s"].append(
                    h.st["prow_s"].index_select(1, idx).to(dev))
            st = {"scalars": g.st["scalars"],
                  "stat": torch.cat([g.st["stat"].reshape(-1, g.L)]
                                    + cols["stat"], 1),
                  "prow_f": torch.cat([g.st["prow_f"]] + cols["prow_f"], 1),
                  "prow_s": torch.cat([g.st["prow_s"]] + cols["prow_s"], 1)}
            ext = {k: torch.cat([g.carry[k], torch.zeros(
                (g.carry[k].shape[0], len(ghosts)), dtype=I32, device=dev)],
                1) for k in CARRY_KEYS}
            carry_delta(torch.from_numpy(local.astype(np.int32)).to(dev),
                        torch.from_numpy(payload).to(dev), st, ext,
                        self._delta_shapes(g.L + len(ghosts)))
            for k in CARRY_KEYS:
                g.carry[k].copy_(ext[k][:, :g.L])

    def _delta_shapes(self, n_lanes: int) -> tuple:
        return (self.T, self.C, n_lanes, self.R, self.SR, self.TCp, self.K,
                self.CP)

    # -- node-axis deltas ----------------------------------------------------

    def _node_col_apply(self, lane: int, cols: Dict) -> None:
        """Write one node lane's columns into the owning group's statics
        and carry. The node-axis position of every leaf comes from the
        rule table that placed it; `delta/src_rows` is the s_src the
        `stat` column already carries (row 7), so it has nothing of its
        own to write here."""
        g = self._group_of(lane)
        local = lane - g.lo
        trees = {"statics": g.st, "carry": g.carry}
        for group, g_cols in cols.items():
            if group not in trees:
                continue
            tree = trees[group]
            specs = session_specs(group, {k: tree[k] for k in g_cols})
            for k, colv in g_cols.items():
                arr = tree[k]
                dim = specs[k].node_dim()
                # ktpu: allow-sync(host column: colv is the queued delta's numpy column until this line uploads it)
                colv = torch.from_numpy(np.asarray(colv)).to(arr.dtype)
                arr.select(dim, local).copy_(colv.squeeze(dim).to(g.device))

    def _pair_rows_shared(self, pf: np.ndarray, ps: np.ndarray,
                          lane: int) -> bool:
        """True when any pair id in (pf, ps) also appears at ANOTHER lane
        of the same valid constraint row: the node event would change
        columns other than `lane`, so it must go structural. Pair id 0
        (node lacks the key) is exempt — konn == 0 gates those lanes."""
        for rows_valid, col, mirror in (
                (self._rows_f_valid, pf, self._prow_f_np),
                (self._rows_s_valid, ps, self._prow_s_np)):
            hit = ((mirror == col[:, None]) & (col[:, None] > 0)
                   & rows_valid[:, None])
            hit[:, lane] = False
            if hit.any():
                return True
        return False

    def node_join_delta(self, slice_cluster: Dict,
                        lane: int) -> Optional[Dict]:
        """Column-write delta for a node ADD at `lane`, or None when the
        add falls outside the delta envelope (caller rebuilds).

        The column comes from a 1-node ScanSession built on the node's own
        slice of the encoding (pod rows and term tables zeroed, see
        ClusterEncoding.node_slice_cluster). Inside the envelope —
        _node_delta_ok, fresh pair ids, a pod-free node — that slice's
        lane 0 IS what a full rebuild would put at `lane`. The alloc
        column is rescaled by the LIVE session's per-dimension GCD from
        the raw encoding values (the slice derives its own)."""
        if not self._node_delta_ok or not (0 <= lane < self.Nps):
            return None
        try:
            s1 = ScanSession(cluster_from_numpy(slice_cluster, self.device),
                             self._templates, self.weights,
                             multipod_k=1, device=self.device)
        except (SessionUnsupported, KeyError):
            return None
        T, SR, TCp = self.T, self.SR, self.TCp
        if (s1.T, s1.C, s1.CP, s1.SR, s1.R) != (
                T, self.C, self.CP, SR, self.R):
            return None
        raw = np.asarray(slice_cluster["alloc"], np.int64)[0]     # [R]
        if np.any(raw % self._gcd[: self.R]):
            return None
        scaled = raw // self._gcd[: self.R]
        if int(np.abs(scaled).max(initial=0)) * (MAX_NODE_SCORE + 1) \
                >= 2 ** 31:
            return None
        # a fresh node carries no pods: its utilization columns are zero
        # apart from the allowed-pods budget (nzpc row 3)
        if s1._requested0[:, 0].any() or s1._nzpc0[:3, 0].any():
            return None
        pf = s1._prow_f[: TCp, 0].copy()
        ps = s1._prow_s[: TCp, 0].copy()
        if int(max(pf.max(initial=0), ps.max(initial=0))) >= 2 ** 24:
            return None
        if self._pair_rows_shared(pf, ps, lane):
            return None
        stat_col = s1._stat[: T * SR].reshape(T, SR, -1)[:, :, 0]
        if stat_col[:, 1].any() or stat_col[:, 4].any():
            # the slice disagrees with the live envelope (terms / image
            # scores at the joining node) — structural
            return None
        alloc_col = np.zeros(self._alloc.shape[0], np.int32)
        alloc_col[: self.R] = scaled.astype(np.int32)
        cols = {
            "statics": {
                "alloc": alloc_col[:, None],
                "stat": stat_col[:, :, None],
                "regrow_f": s1._regrow_f[: TCp, 0:1],
                "konn_f": s1._konn_f[: TCp, 0:1],
                "konn_s": s1._konn_s[: TCp, 0:1],
                "shasall": s1._shasall[: T, 0:1],
                "valid_n": np.ones((1, 1), np.int32),
                "prow_f": pf[:, None],
                "prow_s": ps[:, None],
            },
            "delta": {"src_rows": s1._src_rows[: TCp, 0:1]},
            "carry": {
                "requested": np.zeros((self._alloc.shape[0], 1), np.int32),
                "nzpc": s1._nzpc0[:, 0:1],
                "cnt_fn": s1._cnt_fn0[: TCp, 0:1],
                "cnt_sn": s1._cnt_sn0[: TCp, 0:1],
            },
        }
        # host mirrors move at QUEUE time so later joins/leaves in the
        # same flush check against the post-queue state
        self._prow_f_np[:, lane] = pf
        self._prow_s_np[:, lane] = ps
        self._alloc[:, lane] = alloc_col
        return {"kind": "node-join", "lane": lane, "cols": cols}

    def node_leave_delta(self, lane: int) -> Optional[Dict]:
        """Column-clear delta for a node REMOVE at `lane` (the lane
        reverts to padding form: invalid, zero statics and counts, −1
        pair rows), or None outside the envelope. The caller guarantees
        the node hosts no pods; shared pair ids go structural for the
        same registration reason as joins."""
        if not self._node_delta_ok or not (0 <= lane < self.Nps):
            return None
        if self._pair_rows_shared(self._prow_f_np[:, lane],
                                  self._prow_s_np[:, lane], lane):
            return None
        T, SR, TCp = self.T, self.SR, self.TCp
        z = np.zeros((TCp, 1), np.int32)
        cols = {
            "statics": {
                "alloc": np.zeros((self._alloc.shape[0], 1), np.int32),
                "stat": np.zeros((T, SR, 1), np.int32),
                "regrow_f": z, "konn_f": z, "konn_s": z,
                "shasall": np.zeros((T, 1), np.int32),
                "valid_n": np.zeros((1, 1), np.int32),
                "prow_f": np.full((TCp, 1), -1, np.int32),
                "prow_s": np.full((TCp, 1), -1, np.int32),
            },
            "delta": {"src_rows": z},
            "carry": {
                "requested": np.zeros((self._alloc.shape[0], 1), np.int32),
                "nzpc": np.zeros((SUB, 1), np.int32),
                "cnt_fn": z, "cnt_sn": z,
            },
        }
        self._prow_f_np[:, lane] = -1
        self._prow_s_np[:, lane] = -1
        self._alloc[:, lane] = 0
        return {"kind": "node-leave", "lane": lane, "cols": cols}


def _perno_rows(s_perno: np.ndarray, T: int, C: int, CP: int) -> np.ndarray:
    out = np.zeros(T * CP, np.float32)
    for t in range(T):
        out[t * CP:t * CP + C] = s_perno[t].astype(np.float32)
    return out
