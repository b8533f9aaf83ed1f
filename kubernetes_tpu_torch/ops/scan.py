"""The batched scheduling session: one kernel launch schedules a batch.

Port of the host half of kubernetes_tpu/ops/pallas_scan.py
(PallasSession). The session runs the per-template prologue once
(ops/hoisted.py), fetches it to the host, packs it into the kernel's
layout (`_build`, `_pack_scalars`, copied as numpy so every static can be
compared array for array with PallasSession's), and then schedules batch
after batch against a device-resident carry: each `schedule()` is ONE
launch of `scan_full` (ops/scan_kernel.py), which filters, scores, picks
the node and commits each pod of the batch in turn.

Layout notes (the same as the reference's, so the two compare directly):

- **int32 resources**: quantities are rescaled per dimension by the GCD
  of every value in the session. This is EXACT: the fit comparisons,
  least-allocated's `(cap-req)*100 // cap` and balanced's fractions are
  invariant under a common rescale. A shape whose rescaled magnitudes
  overflow the int32 headroom raises SessionUnsupported.
- **per-node PTS counts**: pair-count tables become per-node count rows
  (`cnt_fn`/`cnt_sn`, row t*CP+c), and shared-value topology keys (zone,
  ...) get a per-node zone index `zid[K, Np]` (−1 where a node has no
  value) for the zone-presence registration of the score pass.
- the node axis is padded to Np = ceil(N, 128).

This slice runs mode "full" with one pod per step and no affinity-term
templates or host ports; those shapes raise SessionUnsupported with a
fixed reason slug and are later slices.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.encoding import _upload
from ..models.vocab import bucket_capacity
from .hoisted import (
    SESSION_TP_NP_KEYS,
    _session_prologue,
    _stack_templates,
    batch_bucket,
    match_matrices_np,
    template_fingerprint,
    templates_have_ports,
    templates_have_terms,
)
from .kernel import DEFAULT_WEIGHTS, MAX_NODE_SCORE
from .scan_kernel import WEIGHT_ORDER, scan_full

VZ = 128          # compact pair-value lanes per shared-value key
LANE = 128
SUB = 8
POS_BIG = 2 ** 30

CARRY_KEYS = ("requested", "nzpc", "cnt_fn", "cnt_sn")
STATIC_KEYS = ("scalars", "alloc", "stat", "zid", "regrow_f",
               "zvalid_node_s", "zvalid_s", "konn_f", "konn_s", "shasall",
               "valid_n", "prow_f", "prow_s")


class SessionUnsupported(Exception):
    """This cluster/template shape cannot ride the scan kernel.

    `reason` is a FIXED slug per raise site (no interpolated shape
    numbers), the same slugs as the reference's PallasUnsupported, plus
    the shapes this slice of the port leaves to later ones."""

    def __init__(self, message: str, reason: str = "other"):
        super().__init__(message)
        self.reason = reason


def _ceil(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad2(a: np.ndarray, rows: int = SUB, lanes: int = LANE) -> np.ndarray:
    """Pad the last two dims up to multiples of (rows, lanes)."""
    r, c = a.shape[-2], a.shape[-1]
    widths = [(0, 0)] * (a.ndim - 2) + [
        (0, _ceil(r, rows) - r), (0, _ceil(c, lanes) - c)]
    return np.pad(a, widths)


def _gcd_all(*arrays) -> int:
    g = 0
    for a in arrays:
        for v in np.unique(np.abs(np.asarray(a, dtype=np.int64))):
            g = math.gcd(g, int(v))
            if g == 1:
                return 1
    return max(g, 1)


def batch_prologue(fps: Dict, tp_np: Dict, pod_arrays_list: List[Dict],
                   minimum: int):
    """Host-side batch prep: pow2 length bucket, template ids, and the
    match matrices, computed on the HOST (match_matrices_np) so the
    dispatch never waits on the device. Returns (Bp, tmpl[Bp], mfa, msa)."""
    B = len(pod_arrays_list)
    Bp = batch_bucket(B, minimum=minimum)
    tmpl = np.zeros(Bp, np.int32)
    for i, pa in enumerate(pod_arrays_list):
        if bool(np.asarray(pa["has_node_name"])):
            raise ValueError("session pods must be unbound")
        tmpl[i] = fps[template_fingerprint(pa)]
    mfa, msa = match_matrices_np(tp_np, pod_arrays_list)
    return Bp, tmpl, mfa, msa


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class ScanSession:
    """Batched scheduling over a device-resident carry, one kernel launch
    per batch.

    Semantics: those of the reference's PallasSession in mode "full" with
    one pod per step (same prologue, same carry discipline, same int32 /
    f32 arithmetic) — pinned by tests/test_torch_scan.py against
    PallasSession in interpret mode and HoistedSession. The template set
    is fixed at construction: a batch pod whose fingerprint is unknown
    raises KeyError."""

    def __init__(self, cluster: Dict[str, torch.Tensor],
                 template_arrays_list: List[Dict],
                 weights: Optional[Dict[str, int]] = None,
                 multipod_k: int = 1, device=None):
        self.device = resolve_device(device)
        if templates_have_ports(template_arrays_list):
            raise SessionUnsupported(
                "templates with host ports ride the hoisted session",
                reason="host-ports",
            )
        if templates_have_terms(template_arrays_list):
            raise SessionUnsupported(
                "affinity-term templates are not ported yet",
                reason="affinity-terms",
            )
        if multipod_k != 1:
            raise SessionUnsupported(
                f"multipod_k={multipod_k}: only one pod per step is ported",
                reason="multipod",
            )
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        self._fps = {
            template_fingerprint(t): i
            for i, t in enumerate(template_arrays_list)
        }
        # pad the template axis to a pow2 bucket (min 2) with inert copies
        # of template 0 (never referenced by a pod's tmpl index), as the
        # reference does, so the layouts stay comparable
        Tb = bucket_capacity(len(template_arrays_list), minimum=2)
        template_arrays_list = list(template_arrays_list) + [
            template_arrays_list[0]
        ] * (Tb - len(template_arrays_list))
        # first-max tie-break + score output rely on f32-exact totals:
        # every plugin score is <= MAX_NODE_SCORE after normalization
        if sum(abs(int(v)) for v in self.weights.values()) \
                * (MAX_NODE_SCORE + 1) >= 2 ** 24:
            raise SessionUnsupported("weights too large for exact f32 totals",
                                     reason="weights-exceed-f32")
        tp = _stack_templates(template_arrays_list, self.device)
        self._tp = tp
        # numpy copies of the selector tables schedule() evaluates on the
        # HOST per batch (match_matrices_np)
        self._tp_np = {k: _host(tp[k]) for k in SESSION_TP_NP_KEYS}
        S = {k: _host(v) for k, v in _session_prologue(cluster, tp).items()}
        c = {k: _host(v) for k, v in cluster.items()}
        self._build(c, S)
        self._carry: Optional[Dict[str, torch.Tensor]] = None
        self._statics: Optional[Dict[str, torch.Tensor]] = None

    # -- host-side prologue remap ------------------------------------------

    def _build(self, c: Dict, S: Dict) -> None:
        T, N = S["static_mask"].shape
        C = S["f_valid"].shape[1]
        self.T, self.C, self.N = T, C, N
        Np = _ceil(N, LANE)
        self.Np = Np
        CP = SUB  # constraint rows padded to 8 per template
        if C > CP:
            raise SessionUnsupported(f"{C} constraints > {CP} per template",
                                     reason="too-many-constraints")
        TCp = T * CP
        self.CP = CP
        self.TCp = TCp
        R = c["alloc"].shape[1]
        self.R = R
        tp = self._tp

        # ---- exact per-dimension GCD rescale to int32 ----
        alloc = c["alloc"].astype(np.int64).T.copy()            # [R, N]
        requested = c["requested"].astype(np.int64).T.copy()
        req = _host(tp["req"]).astype(np.int64)                 # [T, R]
        nz_requested = c["nz_requested"].astype(np.int64).T.copy()  # [2, N]
        nz_req = _host(tp["nz_req"]).astype(np.int64)           # [T, 2]
        for r in range(R):
            extra = [nz_requested[r], nz_req[:, r]] if r < 2 else []
            g = _gcd_all(alloc[r], requested[r], req[:, r], *extra)
            alloc[r] //= g
            requested[r] //= g
            req[:, r] //= g
            if r < 2:
                nz_requested[r] //= g
                nz_req[:, r] //= g
        hi = max((int(a.max(initial=0)) for a in
                  (alloc, requested, req, nz_requested, nz_req)), default=0)
        if hi * (MAX_NODE_SCORE + 1) >= 2 ** 31:
            raise SessionUnsupported(
                f"rescaled resource magnitude {hi} too large for int32",
                reason="resource-magnitude")

        self._alloc = _pad2(alloc.astype(np.int32))             # [Rp, Np]
        self._requested0 = _pad2(requested.astype(np.int32))
        nzpc = np.zeros((SUB, N), np.int64)
        nzpc[0] = nz_requested[0]
        nzpc[1] = nz_requested[1]
        nzpc[2] = c["pod_count"].astype(np.int64)
        nzpc[3] = c["allowed_pods"].astype(np.int64)
        self._nzpc0 = _pad2(nzpc.astype(np.int32))              # [8, Np]
        self._req_s = req.astype(np.int32)
        self._nz_req_s = nz_req.astype(np.int32)
        self._req_check_s = _host(tp["req_check"]).astype(np.int32)
        self._req_has_any_s = _host(tp["req_has_any"]).astype(np.int32)

        # ---- per-template [T, N] statics: row t*SR+i ----
        stat_rows = [
            S["static_mask"], S["raw_ipa"], S["cnt_taint"],
            S["cnt_nodeaff"], S["sc_image"], S["sc_avoid"],
            np.zeros_like(S["static_mask"]), S["s_src"],
        ]
        if any(np.abs(a.astype(np.int64)).max(initial=0) >= POS_BIG
               for a in stat_rows):
            # POS_BIG (2^30), not 2^31: the kernel's min/max sentinels must
            # stay strictly above any genuine value
            raise SessionUnsupported("static score magnitude exceeds sentinel",
                                     reason="score-magnitude")
        SR = len(stat_rows)  # == 8
        self.SR = SR
        stat = np.stack([a.astype(np.int32) for a in stat_rows], axis=1)
        self._stat = _pad2(stat.reshape(T * SR, N))             # [T*SR, Np]

        # ---- PTS: per-constraint representation ----
        valid_nodes = c["valid"].astype(bool)

        def col(side, t, cc):
            return S[f"{side}_pair_cn"][t, :, cc]

        def node_distinct(column):
            real = column[valid_nodes]
            return len(real) == 0 or len(np.unique(real)) == len(real)

        uid_of: Dict[bytes, int] = {}
        uids: List[np.ndarray] = []

        def classify(side, force_host=None, intern=True):
            """-> (keyid [T,C], perno [T,C] bool): perno = per-node count
            representation; otherwise compact key `keyid`. With
            intern=False only perno is computed (the filter path works
            entirely per-node)."""
            keyid = np.full((T, C), -1, np.int32)
            perno = np.zeros((T, C), bool)
            for t in range(T):
                for cc in range(C):
                    if not S[f"{side}_valid"][t, cc]:
                        continue
                    column = col(side, t, cc)
                    is_host = (force_host[t, cc] if force_host is not None
                               else node_distinct(column))
                    if is_host:
                        perno[t, cc] = True
                        continue
                    if not intern:
                        continue
                    key = column.tobytes()
                    u = uid_of.get(key)
                    if u is None:
                        u = len(uids)
                        uid_of[key] = u
                        uids.append(column.copy())
                    keyid[t, cc] = u
            return keyid, perno

        # score side MUST follow the prologue's hostname flag (it selects
        # the log(n_scored) weight semantics, not just a representation)
        s_hostflag = S["s_hostname"].astype(bool)
        fk, fh = classify("f", intern=False)
        sk, sh = classify("s", force_host=s_hostflag)
        self._f_keyid, self._f_perno = fk, fh
        self._s_keyid, self._s_perno = sk, sh

        K = max(len(uids), 1)
        if len(uids) > 4:
            raise SessionUnsupported(f"{len(uids)} distinct shared-value keys",
                                     reason="too-many-topology-keys")
        self.K = K
        zid = np.full((K, Np), -1, np.int32)
        zof: List[Dict[int, int]] = []
        for u, column in enumerate(uids):
            vals = np.unique(column[valid_nodes])
            vals = vals[vals > 0]
            if len(vals) > VZ:
                raise SessionUnsupported(
                    f"topology key {u} has {len(vals)} values > {VZ}",
                    reason="too-many-topology-values")
            m = {int(v): z for z, v in enumerate(vals)}
            zof.append(m)
            z = np.array([m.get(int(v), -1) for v in column], np.int32)
            zid[u, :N] = np.where(valid_nodes, z, -1)
        self._zid = zid

        def gather_rows(side, cnt_tcv, perno, perno_src=None):
            """[T, C, Vnp] pair counts -> per-NODE count rows [TCp, Np]:
            row (t*CP+c), lane n = count of the pair node n belongs to."""
            out = np.zeros((TCp, Np), np.int32)
            for t in range(T):
                for cc in range(C):
                    row = t * CP + cc
                    if perno[t, cc] and perno_src is not None:
                        out[row, :N] = perno_src[t, cc]
                    else:
                        out[row, :N] = cnt_tcv[t, cc][col(side, t, cc)]
            return out

        self._cnt_fn0 = gather_rows("f", S["f_cnt0"], fh)
        self._cnt_sn0 = gather_rows(
            "s", S["s_cnt0"], sh,
            perno_src=S["h_cnt0"].astype(np.int64))

        # static per-node structures
        prow_f = np.full((TCp, Np), -1, np.int32)
        prow_s = np.full((TCp, Np), -1, np.int32)
        regrow_f = np.zeros((TCp, Np), np.int32)
        zvalid_node_s = np.zeros((TCp, Np), np.int32)
        zvalid_s = np.zeros((TCp, VZ), np.int32)
        for t in range(T):
            for cc in range(C):
                row = t * CP + cc
                if S["f_valid"][t, cc]:
                    column = col("f", t, cc)
                    prow_f[row, :N] = np.where(valid_nodes, column, -1)
                    regrow_f[row, :N] = S["f_reg_real"][t, cc][column]
                if S["s_valid"][t, cc]:
                    column = col("s", t, cc)
                    prow_s[row, :N] = np.where(valid_nodes, column, -1)
                    if not sh[t, cc] and sk[t, cc] >= 0:
                        zvalid_node_s[row, :N] = (column > 0) & valid_nodes
                        for pair, zz in zof[sk[t, cc]].items():
                            zvalid_s[row, zz] = 1
        self._prow_f = prow_f
        self._prow_s = prow_s
        self._regrow_f = regrow_f
        self._zvalid_node_s = zvalid_node_s
        self._zvalid_s = zvalid_s
        if max(prow_f.max(), prow_s.max()) >= 2 ** 24:
            raise SessionUnsupported("pair ids exceed exact-f32 range",
                                     reason="pair-ids-exceed-f32")

        def tcn(a):  # [T, N, C] bool -> [TCp, Np] i32 (stride CP)
            out = np.zeros((TCp, Np), np.int32)
            for t in range(T):
                for cc in range(C):
                    out[t * CP + cc, :N] = a[t, :, cc]
            return out

        self._konn_f = tcn(S["f_key_on_node"])
        self._konn_s = tcn(S["s_key_on_node"])
        sha = np.zeros((_ceil(T, SUB), Np), np.int32)
        sha[:T, :N] = S["s_has_all"].astype(np.int32)
        self._shasall = sha
        vn = np.zeros((SUB, Np), np.int32)
        vn[:, :N] = c["valid"].astype(np.int32)[None, :]
        self._valid_n = vn
        if TCp > LANE:
            raise SessionUnsupported(f"T*CP={TCp} exceeds {LANE} match lanes",
                                     reason="too-many-match-lanes")

        # scalar table (read once per launch into shared memory)
        self._scalars = self._pack_scalars(S)

    def _pack_scalars(self, S) -> np.ndarray:
        per_t = np.concatenate([
            self._req_s, self._req_check_s,
            self._req_has_any_s[:, None], self._nz_req_s,
            S["ipa_present"].astype(np.int32)[:, None]], axis=1)  # [T, 2R+4]
        tc = np.stack([
            S["f_valid"].astype(np.int32), S["s_valid"].astype(np.int32),
            S["f_skew"].astype(np.int32), S["s_skew"].astype(np.int32),
            S["f_self_match"].astype(np.int32), S["s_first"].astype(np.int32),
            self._f_keyid, self._s_keyid,
            self._f_perno.astype(np.int32), self._s_perno.astype(np.int32),
        ], axis=0)  # [10, T, C]
        return np.concatenate([
            per_t.reshape(-1), tc.reshape(-1),
            S["f_same_key"].astype(np.int32).reshape(-1),
            S["s_same_key"].astype(np.int32).reshape(-1),
        ]).astype(np.int32)

    # -- scheduling --------------------------------------------------------

    @property
    def shapes(self) -> tuple:
        """(T, C, Np, R, SR, TCp, K, CP): the kernel's static shape tuple,
        in the reference's order."""
        return (self.T, self.C, self.Np, self.R, self.SR, self.TCp, self.K,
                self.CP)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return _upload(a, self.device)

    def _initial_carry(self) -> Dict[str, torch.Tensor]:
        return {
            "requested": self._upload(self._requested0),
            "nzpc": self._upload(self._nzpc0),
            "cnt_fn": self._upload(self._cnt_fn0),
            "cnt_sn": self._upload(self._cnt_sn0),
        }

    def _get_statics(self) -> Dict[str, torch.Tensor]:
        if self._statics is None:
            self._statics = {
                k: self._upload(getattr(self, f"_{k}")) for k in STATIC_KEYS
            }
        return self._statics

    def _pack_batch(self, B, Bp, tmpl, mfa, msa):
        """Per-batch payload as two arrays: meta = [B_real | tmpl] and the
        int8 match lanes (t*CP+c) = that constraint row per pod, filter
        block then score block."""
        T, C, CP = self.T, self.C, self.CP
        meta = np.empty(1 + Bp, np.int32)
        meta[0] = B
        meta[1:] = tmpl
        match = np.zeros((Bp, 2 * LANE), np.int8)
        for t in range(T):
            match[:B, t * CP:t * CP + C] = mfa[t].reshape(B, C)
            match[:B, LANE + t * CP:LANE + t * CP + C] = msa[t].reshape(B, C)
        return meta, match

    def schedule(self, pod_arrays_list: List[Dict]) -> Dict:
        """Enqueue one batch (one kernel launch); returns the (8, Bp)
        result rows on the device — row 0 best / row 1 score / row 2
        n_feasible. decisions() waits for them."""
        B = len(pod_arrays_list)
        Bp, tmpl, mfa, msa = batch_prologue(
            self._fps, self._tp_np, pod_arrays_list, minimum=LANE)
        meta, match = self._pack_batch(B, Bp, tmpl, mfa, msa)
        if self._carry is None:
            self._carry = self._initial_carry()
        out = scan_full(
            self._upload(meta), self._upload(match), self._get_statics(),
            self._carry, self.shapes,
            tuple(int(self.weights[k]) for k in WEIGHT_ORDER),
        )
        return {"rows": out, "n": B}

    @staticmethod
    def decisions(ys) -> List[int]:
        return [int(v) for v in ys["rows"][0, :ys["n"]].tolist()]
