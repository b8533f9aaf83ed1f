"""The batched scheduling session: one kernel launch schedules a batch.

Port of the host half of kubernetes_tpu/ops/pallas_scan.py
(PallasSession). The session runs the per-template prologue once
(ops/hoisted.py), fetches it to the host, packs it into the kernel's
layout (`_build`, `_pack_scalars`, copied as numpy so every static can be
compared array for array with PallasSession's), and then schedules batch
after batch against a device-resident carry: each `schedule()` is ONE
launch of `scan_full` (ops/scan_kernel.py), which filters, scores, picks
the node and commits each pod of the batch in turn — one pod per step,
or `multipod_k` pods per step under the conflict-suffix contract
(scheduler/tpu_backend.py `schedule_exact` replays the suffix).
`evaluate` / `apply_decisions` run the kernel's "eval" and "apply" modes.
`apply_deltas` absorbs cluster churn (pods bound or evicted by other
actors, allocatable-only node updates) into the live carry: one launch of
the kernel's delta mode, or a host patch of the seed arrays before the
first launch.

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

- **affinity-term templates** (InterPodAffinity D1–D5, `_build_ipa`):
  the assumed pods' effect on later pods is kept as per-node counts,
  carry `ucnt` row (u*8 + ki) = assumed template-u pods in node n's
  topology group of key ki, and `kcnt` row (u*8 + ki) = their total;
  static template×term gate and weight matrices turn them into the
  D1–D5 terms.

Host-port templates raise SessionUnsupported with a fixed reason slug:
they ride ops/hoisted.py HoistedSession, as explain sessions do.

On the card each batch's `meta` / `match` (and `forced` in apply mode)
go up through a ring of `staging_depth` pinned host buffers
(models/encoding.py StagingRing) with non-blocking copies, so that
enqueueing batch k+1 does not wait for batch k's launch to finish.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.encoding import StagingRing, _upload
from ..models.vocab import bucket_capacity
from .hoisted import (
    SESSION_TP_NP_KEYS,
    TERM_NP_KEYS,
    _session_prologue,
    _stack_templates,
    batch_bucket,
    match_matrices_np,
    template_fingerprint,
    templates_have_ports,
    templates_have_terms,
)
from .kernel import DEFAULT_WEIGHTS, MAX_NODE_SCORE
from .kernel import multipod_k as resolve_multipod_k
from .scan_kernel import (
    IPA_STATIC_KEYS,
    SMEM_DYNAMIC_MAX,
    WEIGHT_ORDER,
    carry_delta,
    log_weights,
    scan_full,
    smem_bytes,
)

VZ = 128          # compact pair-value lanes per shared-value key
LANE = 128
SUB = 8
POS_BIG = 2 ** 30

CARRY_KEYS = ("requested", "nzpc", "cnt_fn", "cnt_sn")
IPA_CARRY_KEYS = ("ucnt", "kcnt")
STATIC_KEYS = ("scalars", "alloc", "stat", "zid", "regrow_f",
               "zvalid_node_s", "zvalid_s", "konn_f", "konn_s", "shasall",
               "valid_n", "prow_f", "prow_s", "logw", "gmat")


class SessionUnsupported(Exception):
    """This cluster/template shape cannot ride the scan kernel.

    `reason` is a FIXED slug per raise site (no interpolated shape
    numbers), the same slugs as the reference's PallasUnsupported, plus
    `smem-budget` (the CUDA kernel's shared-memory limit, which takes the
    place of the reference's TPU `ipa-vmem-budget`)."""

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
                   minimum: int, require_unbound: bool = True):
    """Host-side batch prep: pow2 length bucket, template ids, and the
    match matrices, computed on the HOST (match_matrices_np) so the
    dispatch never waits on the device. Bound pods are refused unless
    `require_unbound` is False (the eval / apply modes take them).
    Returns (Bp, tmpl[Bp], mfa, msa)."""
    B = len(pod_arrays_list)
    Bp = batch_bucket(B, minimum=minimum)
    tmpl = np.zeros(Bp, np.int32)
    for i, pa in enumerate(pod_arrays_list):
        if require_unbound and bool(np.asarray(pa["has_node_name"])):
            raise ValueError("session pods must be unbound")
        tmpl[i] = fps[template_fingerprint(pa)]
    mfa, msa = match_matrices_np(tp_np, pod_arrays_list)
    return Bp, tmpl, mfa, msa


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class ScanSession:
    """Batched scheduling over a device-resident carry, one kernel launch
    per batch.

    Semantics: those of the reference's PallasSession (same prologue,
    same carry discipline, same int32 / f32 arithmetic, the same
    multi-pod conflict-suffix contract and eval / apply modes) — pinned
    by tests/test_torch_scan.py, test_torch_multipod.py and
    test_torch_evalapply.py against PallasSession in interpret mode and
    HoistedSession. `multipod_k` None resolves through
    ops/kernel.multipod_k for the session's device. The template set is
    fixed at construction: a batch pod whose fingerprint is unknown
    raises KeyError.

    No explain mode (the reference kernel session's answer, which the
    backend's session ladder reads): the kernel keeps no per-plugin
    intermediates, so explain sessions ride ops/hoisted.py
    HoistedSession."""

    supports_explain = False
    # pinned staging sets for the per-batch uploads on the card: one per
    # batch in flight (the backend sets its pipeline depth)
    staging_depth = 2

    def __init__(self, cluster: Dict[str, torch.Tensor],
                 template_arrays_list: List[Dict],
                 weights: Optional[Dict[str, int]] = None,
                 multipod_k: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        dyn_ports = templates_have_ports(template_arrays_list)
        self.multipod_k = resolve_multipod_k(
            multipod_k, dyn_ports=dyn_ports, platform=self.device.type)
        if dyn_ports:
            raise SessionUnsupported(
                "templates with host ports ride the hoisted session",
                reason="host-ports",
            )
        # affinity-term templates ride the kernel's IPA branch: the D1-D5
        # deltas become per-node count carries (see _build_ipa)
        self.dyn_ipa = templates_have_terms(template_arrays_list)
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
        # the templates' own affinity terms, as numpy: the reference's
        # session-delta classifier reads them (a foreign pod matching one
        # perturbs the prologue statics, not just the carry)
        self._term_np = ({k: _host(tp[k]) for k in TERM_NP_KEYS}
                         if self.dyn_ipa else None)
        S = {k: _host(v) for k, v in
             _session_prologue(cluster, tp, dyn_ipa=self.dyn_ipa).items()}
        c = {k: _host(v) for k, v in cluster.items()}
        self._build(c, S)
        self._ipa = self._build_ipa(c, S) if self.dyn_ipa else None
        if self._ipa is not None:
            # scalar-table extension: [T,3] has_aff/self_match_all/
            # aff_total, then anti_valid/aff_valid [T,8] each, then the
            # w45 GCD scale — the reference's layout
            extra = np.concatenate([
                np.stack([
                    self._ipa["has_aff"], self._ipa["self_match_all"],
                    self._ipa["aff_total"],
                ], axis=1).reshape(-1),
                self._ipa["anti_valid"].reshape(-1),
                self._ipa["aff_valid"].reshape(-1),
                np.array([self._ipa["w45_scale"]]),
            ]).astype(np.int32)
            self._scalars = np.concatenate([self._scalars, extra])
        self.UR = self._ipa["UR"] if self._ipa is not None else 0
        self.carry_keys = CARRY_KEYS + (IPA_CARRY_KEYS if self.UR else ())
        # the kernel stages the scalar table and the IPA gate matrices in
        # shared memory: refuse what a block cannot hold
        if smem_bytes(self.T, self.C, self.R, self.UR) > SMEM_DYNAMIC_MAX:
            raise SessionUnsupported(
                "scalar table and IPA gate matrices exceed the kernel's "
                "shared memory", reason="smem-budget")
        self._carry: Optional[Dict[str, torch.Tensor]] = None
        self._statics: Optional[Dict[str, torch.Tensor]] = None
        self._ring: Optional[StagingRing] = None

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
        # the per-dimension factors are kept: a session delta must divide
        # by the SAME gcd to stay exact (delta_compatible)
        self._gcd = np.ones(R, np.int64)
        for r in range(R):
            extra = [nz_requested[r], nz_req[:, r]] if r < 2 else []
            g = _gcd_all(alloc[r], requested[r], req[:, r], *extra)
            self._gcd[r] = g
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
        # session-delta statics, as the reference builds them: row-expanded
        # s_src (the score-count node eligibility of the row's template)
        # and the per-row perno flag, the factor of a delta's cnt_sn lanes
        src_rows = np.zeros((TCp, Np), np.int32)
        perno_rows = np.zeros((TCp, 1), np.int32)
        for t in range(T):
            for cc in range(C):
                src_rows[t * CP + cc, :N] = S["s_src"][t].astype(np.int32)
                perno_rows[t * CP + cc, 0] = int(self._s_perno[t, cc])
        self._src_rows = src_rows
        self._perno_rows = perno_rows
        sha = np.zeros((_ceil(T, SUB), Np), np.int32)
        sha[:T, :N] = S["s_has_all"].astype(np.int32)
        self._shasall = sha
        vn = np.zeros((SUB, Np), np.int32)
        vn[:, :N] = c["valid"].astype(np.int32)[None, :]
        self._valid_n = vn
        if TCp > LANE:
            raise SessionUnsupported(f"T*CP={TCp} exceeds {LANE} match lanes",
                                     reason="too-many-match-lanes")
        # PTS score weights log(n + 2), n in [0, Np]: one table read by the
        # kernel and the plain version alike (bit-equal to the reference)
        self._logw = log_weights(Np + 2)
        # multipod IPA interference superset, row u / lane t (filled by
        # _build_ipa; zeros without term templates) — read by the
        # kernel's multi-pod conflict test
        self._gmat = np.zeros((_ceil(T, SUB), LANE), np.float32)

        # scalar table (read once per launch into shared memory)
        self._scalars = self._pack_scalars(S)

    def _build_ipa(self, c: Dict, S: Dict) -> Dict:
        """InterPodAffinity term machinery for the kernel (the reference's
        PallasSession._build_ipa, pallas_scan.py:582, array for array).

        The hoisted scan's D1-D5 deltas all reduce to per-(assumed-template
        u, topology key ki) counts gathered at each node's (ki, value)
        group, kept PER NODE: carry row (u*8 + ki) of `ucnt` holds, for
        every node n, the number of session-assumed u-pods in n's ki-group
        — updated on assume with a same-pair mask from `prow_ipa` (pair id
        per node per key; -1 where the node lacks the key, so rows never
        accumulate on keyless nodes). `kcnt` row (u*8+ki) carries the
        total (lanes all equal). Every D1-D5 read is then a STATIC
        gate/weight matrix (template × term match booleans from
        _term_gates) times ucnt:
          D1 fail-existing  : g1[t] . (ucnt > 0) > 0
          D2 own-anti counts: wanti[t-block] @ ucnt  (+ static anti rows)
          D3 own-aff counts : waff[t-block] @ ucnt   (+ static aff rows)
          D4+D5 score       : w45[t] @ ucnt  (weights pre-folded)
          presence flags    : gpres[t] . rowany(ucnt > 0)
          aff_total delta   : w3tot[t] . kcnt[:, 0]
        The matrices are f32 as the reference's; their values are small
        integers, and the kernel computes these products in int32."""
        T, N, Np = self.T, self.N, self.Np
        tp = self._tp
        aa_key = _host(tp["ipaaa_key"])
        aa_valid = _host(tp["ipaaa_valid"]).astype(bool)
        a_key = _host(tp["ipaa_key"])
        a_valid = _host(tp["ipaa_valid"]).astype(bool)
        p_key = _host(tp["ipap_key"])
        p_valid = _host(tp["ipap_valid"]).astype(bool)
        p_w = _host(tp["ipap_weight"]).astype(np.int64)
        if aa_key.shape[1] > SUB or a_key.shape[1] > SUB:
            raise SessionUnsupported(
                f"{max(aa_key.shape[1], a_key.shape[1])} required "
                f"(anti-)affinity terms > {SUB} per template",
                reason="too-many-ipa-terms")
        # distinct topology keys across every template's valid terms
        keys: set = set()
        for k_tbl, v_tbl in ((aa_key, aa_valid), (a_key, a_valid),
                             (p_key, p_valid)):
            keys.update(int(x) for x in k_tbl[v_tbl])
        ki_list = sorted(keys)
        if len(ki_list) > SUB:
            raise SessionUnsupported(f"{len(ki_list)} IPA topology keys > {SUB}",
                                     reason="too-many-ipa-keys")
        ki_of = {k: i for i, k in enumerate(ki_list)}
        UR = T * SUB  # ucnt rows: (u * 8 + ki)
        # (the reference's VMEM budget guard has no counterpart: the
        # kernel's own limit is its shared memory, checked by the caller)

        pok = c["pair_of_key"].astype(np.int64)  # [N, K]
        nkey = c["nkey"].astype(bool)
        valid_nodes = c["valid"].astype(bool)
        prow_ipa = np.full((SUB, Np), -1, np.int32)
        for i, key in enumerate(ki_list):
            ok = nkey[:, key] & valid_nodes
            prow_ipa[i, :N] = np.where(ok, pok[:, key], -1)
        if prow_ipa.max(initial=0) >= 2 ** 24:
            raise SessionUnsupported("IPA pair ids exceed exact-f32 range",
                                     reason="pair-ids-exceed-f32")

        M_anti = S["M_anti"].astype(bool)        # [T, TAA, T]
        M_aff = S["M_aff"].astype(bool)          # [T, TA, T]
        M_pref = S["M_pref"].astype(bool)        # [T, TP, T]
        match_all = S["match_all"].astype(bool)  # [T, T]
        hard_w = int(c["hard_pod_affinity_weight"])

        # multipod template-interference superset (symmetrized: a false
        # positive only costs a replay, never a wrong decision)
        self._gmat[:T, :T] = S["G_ipa"].astype(np.float32)

        t_pad = _ceil(T, SUB)  # per-template matrices: row t (T can be >8)
        g1 = np.zeros((t_pad, UR), np.float32)
        wanti = np.zeros((T * SUB, UR), np.float32)
        waff = np.zeros((T * SUB, UR), np.float32)
        w3tot = np.zeros((t_pad, UR), np.float32)
        w45_i = np.zeros((t_pad, UR), np.int64)
        gpres = np.zeros((t_pad, UR), np.float32)

        def cx(u, key):
            return u * SUB + ki_of[int(key)]

        for t in range(T):
            # D1: assumed u-pods' anti terms repel t where t matches them
            for u in range(T):
                for tau in range(aa_key.shape[1]):
                    if aa_valid[u, tau] and M_anti[u, tau, t]:
                        g1[t, cx(u, aa_key[u, tau])] = 1.0
            # D2: assumed pods counting toward t's own anti terms
            for tau in range(aa_key.shape[1]):
                if not aa_valid[t, tau]:
                    continue
                for u in range(T):
                    if M_anti[t, tau, u]:
                        wanti[t * SUB + tau, cx(u, aa_key[t, tau])] = 1.0
            # D3: assumed pods matching ALL of t's affinity terms
            for tau in range(a_key.shape[1]):
                if not a_valid[t, tau]:
                    continue
                for u in range(T):
                    if match_all[t, u]:
                        waff[t * SUB + tau, cx(u, a_key[t, tau])] = 1.0
                        w3tot[t, cx(u, a_key[t, tau])] += 1.0
            # D4: assumed pods' score terms vs t (required-aff at
            # hardPodAffinityWeight; preferred at signed weight) and
            # D5: t's own preferred terms vs assumed pods
            for u in range(T):
                for tau in range(a_key.shape[1]):
                    if a_valid[u, tau] and M_aff[u, tau, t] and hard_w > 0:
                        w45_i[t, cx(u, a_key[u, tau])] += hard_w
                        gpres[t, cx(u, a_key[u, tau])] = 1.0
                for tau in range(p_key.shape[1]):
                    if p_valid[u, tau] and M_pref[u, tau, t]:
                        w45_i[t, cx(u, p_key[u, tau])] += int(p_w[u, tau])
                        gpres[t, cx(u, p_key[u, tau])] = 1.0
                for tau in range(p_key.shape[1]):
                    if p_valid[t, tau] and M_pref[t, tau, u]:
                        w45_i[t, cx(u, p_key[t, tau])] += int(p_w[t, tau])
                        gpres[t, cx(u, p_key[t, tau])] = 1.0
        # score-dot exactness: the weights shed their common GCD (the
        # kernel multiplies the int32 dot back by w45_scale), and with
        # session assumed counts capped at 2^16 the scaled dot must stay
        # below 2^24: sum|w/g| < 2^8 ...
        w45_scale = _gcd_all(w45_i)
        w45_i //= w45_scale
        scaled_sum = int(np.abs(w45_i).sum(axis=1).max(initial=0))
        if scaled_sum >= 256:
            raise SessionUnsupported(
                "IPA score weights too large for exact f32 dot",
                reason="ipa-score-weights")
        # ... and the restored magnitude keeps clear of the 2^30 score
        # sentinel at the same count cap
        if w45_scale * scaled_sum >= 2 ** 14:
            raise SessionUnsupported(
                "IPA score weights too large for int32 score headroom",
                reason="ipa-score-weights")

        # static per-term per-node blocks (rows t*8+term)
        anti_static = np.zeros((T * SUB, Np), np.int32)
        anti_konn = np.zeros((T * SUB, Np), np.int32)
        aff_static = np.zeros((T * SUB, Np), np.int32)
        anti_cnt_n = S["ipa_anti_cnt_n"]         # [T, N, TAA]
        anti_kon = S["ipa_anti_key_on_node"]
        aff_cnt_n = S["ipa_aff_cnt_n"]           # [T, N, TA]
        for t in range(T):
            for tau in range(aa_key.shape[1]):
                anti_static[t * SUB + tau, :N] = anti_cnt_n[t, :, tau]
                anti_konn[t * SUB + tau, :N] = anti_kon[t, :, tau]
            for tau in range(a_key.shape[1]):
                aff_static[t * SUB + tau, :N] = aff_cnt_n[t, :, tau]
        # per-template per-node statics (rows t*2 / t*2+1)
        ipa_stat = np.zeros((_ceil(2 * T, SUB), Np), np.int32)
        for t in range(T):
            ipa_stat[2 * t, :N] = S["ipa_fail_existing"][t]
            ipa_stat[2 * t + 1, :N] = S["ipa_aff_all_keys"][t]
        if max(int(anti_static.max(initial=0)),
               int(aff_static.max(initial=0))) >= POS_BIG:
            raise SessionUnsupported("IPA static counts exceed sentinel",
                                     reason="score-magnitude")

        def pad_tc(a):  # [T, X<=8] -> [T, 8] zero-padded
            out = np.zeros((T, SUB), a.dtype)
            out[:, :a.shape[1]] = a
            return out

        return dict(
            UR=UR,
            prow_ipa=prow_ipa, ipa_stat=ipa_stat,
            anti_static=anti_static, anti_konn=anti_konn,
            aff_static=aff_static,
            g1=g1, wanti=wanti, waff=waff, w3tot=w3tot,
            w45=w45_i.astype(np.float32), w45_scale=w45_scale, gpres=gpres,
            has_aff=S["ipa_has_aff"].astype(np.int32),
            self_match_all=S["ipa_self_match_all"].astype(np.int32),
            aff_total=S["ipa_aff_total"].astype(np.int32),
            anti_valid=pad_tc(aa_valid.astype(np.int32)),
            aff_valid=pad_tc(a_valid.astype(np.int32)),
        )

    # ktpu: allow-sync(session build: packs static scalar rows on host before upload)
    def _pack_scalars(self, S) -> np.ndarray:
        # host mirror of the tables packed below: the sharded session
        # (ops/sharded_scan.py) reads them as structured tables
        self._sc_tables = {
            k: np.asarray(S[k]).copy()
            for k in ("f_valid", "s_valid", "f_skew", "s_skew",
                      "f_self_match", "s_first", "f_same_key", "s_same_key",
                      "ipa_present")
        }
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

    def _stage(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One batch's payload to the device: through the pinned ring on
        the card, plain copies elsewhere."""
        if self.device.type != "cuda":
            return {k: self._upload(a) for k, a in arrays.items()}
        if self._ring is None:
            self._ring = StagingRing(self.device, depth=self.staging_depth)
        return self._ring.upload(arrays)

    def _initial_carry(self) -> Dict[str, torch.Tensor]:
        carry = {
            "requested": self._upload(self._requested0),
            "nzpc": self._upload(self._nzpc0),
            "cnt_fn": self._upload(self._cnt_fn0),
            "cnt_sn": self._upload(self._cnt_sn0),
        }
        if self.UR:
            # the session starts with zero ASSUMED pods (existing pods
            # live in the static tables)
            carry["ucnt"] = self._upload(np.zeros((self.UR, self.Np),
                                                  np.int32))
            carry["kcnt"] = self._upload(np.zeros((self.UR, LANE), np.int32))
        return carry

    def _get_statics(self) -> Dict[str, torch.Tensor]:
        if self._statics is None:
            self._statics = {
                k: self._upload(getattr(self, f"_{k}")) for k in STATIC_KEYS
            }
            if self.UR:
                self._statics.update(
                    {k: self._upload(self._ipa[k]) for k in IPA_STATIC_KEYS})
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

    def _dispatch_mode(self, pod_arrays_list: List[Dict], mode: str,
                       forced=None, mk: int = 1) -> Dict:
        """One kernel launch over a batch in `mode` ("full" with mk pods
        per step, "eval", or "apply" with `forced` (lane | −1, ok)
        pairs); returns {"rows", "n"}."""
        B = len(pod_arrays_list)
        Bp, tmpl, mfa, msa = batch_prologue(
            self._fps, self._tp_np, pod_arrays_list, minimum=LANE,
            require_unbound=mode == "full")
        meta, match = self._pack_batch(B, Bp, tmpl, mfa, msa)
        payload = {"meta": meta, "match": match}
        if mode == "apply":
            fvec = np.zeros(2 * Bp, np.int32)
            for i, (lane, ok) in enumerate(forced):
                fvec[2 * i] = lane
                fvec[2 * i + 1] = ok
            payload["forced"] = fvec
        if self._carry is None:
            self._carry = self._initial_carry()
        dev = self._stage(payload)
        out = scan_full(
            dev["meta"], dev["match"], self._get_statics(),
            self._carry, self.shapes,
            tuple(int(self.weights[k]) for k in WEIGHT_ORDER),
            mode=mode, mk=mk, forced=dev.get("forced"),
        )
        return {"rows": out, "n": B}

    def schedule(self, pod_arrays_list: List[Dict]) -> Dict:
        """Enqueue one batch (one kernel launch, `multipod_k` pods per
        step); returns the (8, Bp) result rows on the device — row 0 best
        / row 1 score / row 2 n_feasible / with mk > 1 row 3 the
        conflict-suffix flag. decisions() waits for them."""
        ys = self._dispatch_mode(pod_arrays_list, "full",
                                 mk=self.multipod_k)
        ys["mk"] = self.multipod_k
        return ys

    @staticmethod
    # ktpu: allow-sync(harvest decode: host consumes batch verdicts after the launch completes)
    def decisions(ys) -> List[int]:
        return [int(v) for v in ys["rows"][0, :ys["n"]].tolist()]

    @staticmethod
    def explain_payload(ys):
        """No attribution rides the kernel's out rows: None for any batch,
        so a caller may ask every session kind unconditionally."""
        return None

    @staticmethod
    # ktpu: allow-sync(harvest decode: host reads conflict planes after the launch completes)
    def conflict_stats(ys):
        """(n_conflicts, replay_suffix_start) from out row 3 (the
        reference's PallasSession.conflict_stats): the kernel leaves the
        conflicted suffix UNCOMMITTED (flag 1), and the host replays
        exactly those pods through the session, whose carry holds the
        committed prefix. n_conflicts is 1: one detection headed the
        suffix, the flags after it are collateral, and a genuine later
        conflict is detected again when the suffix runs. (0, None) when
        the batch ran one pod per step (row 3 is the −1 init then)."""
        if ys.get("mk", 1) <= 1:
            return 0, None
        flags = [v > 0 for v in ys["rows"][3, :ys["n"]].tolist()]
        if not any(flags):
            return 0, None
        return 1, flags.index(True)

    # -- split eval/apply (the sharded session's building blocks): the
    # same kernel in mode "eval" (scores and local best, carries
    # untouched) and "apply" (commit externally decided placements; −1
    # lanes are no-ops), so eval -> argmax -> apply replays full mode

    def evaluate(self, pod_arrays_list: List[Dict]):
        """Local (best, score) per pod WITHOUT carry updates — every pod
        evaluated against the same carry state."""
        ys = self._dispatch_mode(pod_arrays_list, "eval")
        # ktpu: allow-sync(harvest decode: evaluate returns its (best, score) rows as host lists by design)
        rows = ys["rows"][:2, :ys["n"]].tolist()
        return list(zip(rows[0], rows[1]))

    def apply_decisions(self, pod_arrays_list: List[Dict],
                        decisions: List[int]) -> None:
        """Commit placements (node lane, or −1 = unplaced / off-shard) to
        the session carry."""
        forced = [(d if d >= 0 else -1, 1 if d >= 0 else 0)
                  for d in decisions]
        self._dispatch_mode(pod_arrays_list, "apply", forced=forced)

    # -- incremental cluster-state deltas (pallas_scan.py:952-1074) --------

    def delta_compatible(self, dres, dnz) -> bool:
        """A utilization delta rides this session's int32 carry only when
        the build-time per-dimension GCD rescale stays exact on it and
        the rescaled magnitudes keep the int32 headroom the build
        guaranteed."""
        dres = np.asarray(dres, np.int64)
        if dres.shape[0] != self._gcd.shape[0]:
            return False
        if (dres % self._gcd != 0).any():
            return False
        dnz = np.asarray(dnz, np.int64)
        if (dnz % self._gcd[:2] != 0).any():
            return False
        hi = max(
            int(np.abs(dres // self._gcd).max(initial=0)),
            int(np.abs(dnz // self._gcd[:2]).max(initial=0)),
        )
        return hi * (MAX_NODE_SCORE + 1) < 2 ** 31

    def _delta_rows(self, d) -> tuple:
        """One backend delta dict -> (node, dres[Rp] scaled, dnzpc[8],
        mf[TCp], ms[TCp]) in this session's carry layout."""
        rp = self._requested0.shape[0]
        dres = np.zeros(rp, np.int32)
        dnzpc = np.zeros(SUB, np.int32)
        mf_rows = np.zeros(self.TCp, np.int32)
        ms_rows = np.zeros(self.TCp, np.int32)
        if d["kind"] == "node-alloc":
            dnzpc[3] = d["dallowed"]
        else:
            dres[: self.R] = (
                np.asarray(d["dres"], np.int64) // self._gcd
            ).astype(np.int32)
            dnzpc[0] = int(d["dnz"][0]) // int(self._gcd[0])
            dnzpc[1] = int(d["dnz"][1]) // int(self._gcd[1])
            dnzpc[2] = d["dcount"]
            for t in range(self.T):
                mf_rows[t * self.CP: t * self.CP + self.C] = d["mf"][t]
                ms_rows[t * self.CP: t * self.CP + self.C] = d["ms"][t]
        return d["node"], dres, dnzpc, mf_rows, ms_rows

    def _patch_alloc_static(self, d) -> None:
        """node-alloc prologue patch: the static alloc column moves (the
        prologue never reads alloc, so nothing else needs recompute), in
        the host array and, once the statics are uploaded, in place in the
        device static (the reference rebuilt its bundle). The CUMULATIVE
        rescaled magnitude must keep the int32 headroom the build
        guaranteed — delta_compatible bounds one delta, not the sum of
        many capacity bumps — so the patched column is re-checked and an
        overflow raises."""
        scaled = (np.asarray(d["dalloc"], np.int64) // self._gcd).astype(
            np.int32)
        n = d["node"]
        col = self._alloc[: self.R, n].astype(np.int64) + scaled
        if int(np.abs(col).max(initial=0)) * (MAX_NODE_SCORE + 1) >= 2 ** 31:
            raise ValueError(
                "cumulative alloc patches exceed the int32 score headroom")
        self._alloc[: self.R, n] += scaled
        if self._statics is not None:
            self._statics["alloc"][: self.R, n] += self._upload(scaled)

    def apply_deltas(self, deltas: List[Dict]) -> None:
        """Absorb batched cluster-event deltas (the backend's carry deltas
        and node-alloc patches) into the carry and the alloc static
        without a session rebuild. With no launch yet (no carry) the numpy
        seed arrays are patched on the host; otherwise ONE launch of the
        kernel's delta mode (`scan_kernel.carry_delta`) updates the
        resident carry in place. Raises ValueError, before anything
        moves, for a node index outside [0, N) (the reference's scatter
        would drop it)."""
        for d in deltas:
            if not 0 <= int(d["node"]) < self.N:
                raise ValueError(f"delta node {d['node']} outside [0, "
                                 f"{self.N})")
        for d in deltas:
            if d["kind"] == "node-alloc":
                self._patch_alloc_static(d)
        rows = [self._delta_rows(d) for d in deltas]
        if self._carry is None:
            for n, dres, dnzpc, mf_rows, ms_rows in rows:
                self._requested0[:, n] += dres
                self._nzpc0[:, n] += dnzpc
                same_f = (
                    (self._prow_f == self._prow_f[:, n][:, None])
                    & (self._prow_f >= 0)
                )
                self._cnt_fn0 += mf_rows[:, None] * same_f
                same_s = (
                    (self._prow_s == self._prow_s[:, n][:, None])
                    & (self._prow_s >= 0)
                )
                factor = (
                    self._perno_rows
                    + (1 - self._perno_rows) * self._src_rows[:, n][:, None]
                )
                self._cnt_sn0 += ms_rows[:, None] * factor * same_s
            return
        if not rows:
            return
        node, payload = self._pack_deltas(rows)
        carry_delta(self._upload(node), self._upload(payload),
                    self._get_statics(), self._carry, self.shapes)

    @staticmethod
    def _pack_deltas(rows: List[tuple]) -> tuple:
        """`_delta_rows` tuples -> the delta mode's payload: node int32
        [E] and rows int32 [E, Rp + 8 + 2*TCp] of dres | dnzpc | mf | ms.
        The kernel takes any event count: no pow2 padding."""
        node = np.array([r[0] for r in rows], np.int32)
        payload = np.stack([np.concatenate(r[1:]) for r in rows])
        return node, payload

