"""What-if preemption: one preemptor's victim search as one device launch.

Port of kubernetes_tpu/ops/whatif.py. The oracle dry run
(plugins/defaultpreemption.py selectVictimsOnNode, reference
default_preemption.go:592) runs the full filter chain once per candidate
node per victim add-back; here it is one program per preemptor over every
node lane against a SCRATCH copy of the session carry:

  * every candidate node's victim set arrives as INVERSE carry deltas (a
    victim leaving node i moves the node's utilization row, the PTS pair
    counts at node i's topology pairs, and the preemptor's own IPA term
    counts in node i's groups);
  * base feasibility ("all lower-priority victims removed",
    default_preemption.go:626) is evaluated for all nodes at once;
  * the reprieve loop (:633 — victims added back highest-priority-first,
    the PDB-violating group first, while the preemptor still fits) is the
    sequential greedy the oracle runs, node-parallel because the nodes'
    dry runs are independent;
  * nominated pods ride as POSITIVE deltas with the framework's two-pass
    semantics (framework.go:610: pass with them added AND without).

The reference's `_whatif_run` is one jitted jnp program. The port splits
it in two: `whatif_prologue`, plain PyTorch run once per launch (free
capacity and pod count with the claimed-victim drains, the static gate,
the IPA effective counts of the session's D1-D3 composition, the PTS
minimum structure), per node lane; and the walk (fits_now, base
and the reprieve over the L victim slots), the hand-written CUDA kernel
of ops/whatif_kernel.py on the card and its plain twin on the CPU.
`_gang_fits_run` is a handful of reductions and stays plain PyTorch.

Exactness domain, as the reference's: the preemptor may carry pod
(anti-)affinity terms and topology-spread constraints; the planner
(scheduler/preemption_device.py) gates the rest of the envelope.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import kernel as K
from .hoisted import (
    HoistedSession,
    _PORT_STEP_KEYS,
    _count_matmul,
    _eval_reqs_batch_np,
    _gather_rows,
    batch_bucket,
    template_fingerprint,
)
from .kernel import _CNT, _I64
from .whatif_kernel import BIG, whatif_walk

# IPA term-table keys of ONE template the host victim-matcher reads
_TERM_SLICE_KEYS = tuple(
    f"{prefix}_{suffix}"
    for prefix in ("ipaaa", "ipaa")
    for suffix in ("op", "rkey", "pairs", "ns", "valid", "key")
)


def ipa_victim_matches_np(tt: Dict, rows_list: List[Dict]):
    """(manti [B, TAA], mall [B]) — does victim b match the preemptor's
    required anti-affinity term t / ALL of its required affinity terms
    (podMatchesAllAffinityTerms, filtering.go:357)? Host numpy twin of
    kernel._ipa_term_matches for a handful of victim rows; namespaces
    and term validity included."""
    B = len(rows_list)
    taa = tt["ipaaa_valid"].shape[0]
    ta = tt["ipaa_valid"].shape[0]
    manti = np.zeros((B, taa), np.int32)
    mall = np.zeros(B, np.int32)
    if B == 0:
        return manti, mall
    pp = np.stack([np.asarray(r["self_ppair"]) for r in rows_list]).astype(bool)
    pk = np.stack([np.asarray(r["self_pkey"]) for r in rows_list]).astype(bool)
    ns = np.asarray([int(np.asarray(r["self_ns"])) for r in rows_list])

    def fam(prefix, width):
        valid = tt[f"{prefix}_valid"].astype(bool)
        if not valid.any():
            return np.zeros((B, width), bool), valid
        m = _eval_reqs_batch_np(
            tt[f"{prefix}_op"], tt[f"{prefix}_rkey"], tt[f"{prefix}_pairs"],
            pp, pk,
        )  # [B, T]
        ns_tbl = tt[f"{prefix}_ns"]  # [T, X]
        ns_ok = (
            (ns_tbl[None, :, :] == ns[:, None, None]) & (ns_tbl[None, :, :] != 0)
        ).any(axis=-1)  # [B, T]
        return m & ns_ok & valid[None, :], valid

    m_anti, _ = fam("ipaaa", taa)
    manti = m_anti.astype(np.int32)
    m_aff, aff_valid = fam("ipaa", ta)
    if aff_valid.any():
        mall = np.all(
            np.where(aff_valid[None, :], m_aff, True), axis=1
        ).astype(np.int32)
    return manti, mall


# ---------------------------------------------------------------------------
# the what-if program: the prologue, then the walk


def whatif_prologue(S: Dict, c_static: Dict, carry: Dict,
                    pre_req, pre_cnt, pre_shared, pre_anti, pre_aff,
                    pre_atot, tj: int = 0, dyn_ipa: bool = False,
                    dyn_ports: bool = False) -> Dict[str, torch.Tensor]:
    """Everything of the reference's `_whatif_run` before `feas_one`
    (whatif.py:146-243), in its dtypes and under its names, per node
    lane for the walk (ops/whatif_kernel.py lists each tensor):

      free0 [N, R], cnt0 [N], allowed [N]: capacity and pod count with the
        claimed victims drained; req [R], chk [R] (req_check AND
        req_has_any); gate [N]: the eviction-invariant static gate (ports,
        existing anti terms) AND NOT (a constraint's key missing);
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

    The claimed drains (pre_*) are applied to every state; pre_shared /
    pre_anti / pre_aff at topology-PAIR granularity."""

    def sel(key):
        return S[key][tj]

    out = {}
    alloc = c_static["alloc"]
    out["free0"] = alloc - carry["requested"] + pre_req        # [N, R]
    out["cnt0"] = carry["pod_count"].to(_I64) - pre_cnt        # [N]
    out["allowed"] = c_static["allowed_pods"].to(_I64)
    out["req"] = sel("req").contiguous()
    out["chk"] = (sel("req_check") & sel("req_has_any")).contiguous()

    # -- eviction-invariant gate -------------------------------------------
    static_gate = sel("static_mask")
    if dyn_ports:
        static_gate = static_gate & K.ports_mask(
            carry["cp_any"], carry["cp_wild"], carry["cp_trip"],
            {k: sel(k) for k in _PORT_STEP_KEYS},
        )

    # -- IPA effective counts: prologue statics + session-assumed dynamics
    #    (the D1-D3 composition of ops/hoisted._eval_pod) + claimed-victim
    #    pair-level drains ---------------------------------------------------
    if dyn_ipa:
        u_cnt, k_cnt = carry["u_cnt"], carry["k_cnt"]
        pok, nk = c_static["pair_of_key"], c_static["nkey"]
        kaa = S["ipaaa_key"].long()                   # [U, TAA]
        cnt1 = _gather_rows(u_cnt, pok[:, kaa].permute(1, 0, 2))  # [U,N,TAA]
        g1 = S["M_anti"][:, :, tj]                    # [U, TAA]
        nk1 = nk[:, kaa].permute(1, 0, 2)             # [U, N, TAA]
        fail_existing_dyn = (g1[:, None, :] & nk1 & (cnt1 > 0)).any(
            dim=2).any(dim=0)                         # [N]
        w2 = _count_matmul(S["M_anti"][tj].to(_CNT), u_cnt)  # [TAA, Vnp]
        pair_nt = pok[:, sel("ipaaa_key").long()].long()     # [N, TAA]
        anti_dyn = torch.gather(w2.T, 0, pair_nt)     # [N, TAA]
        g3 = S["match_all"][tj].to(_CNT)              # [U]
        w3 = _count_matmul(g3[None, :], u_cnt)[0]     # [Vnp]
        aff_key = sel("ipaa_key").long()
        pair_na = pok[:, aff_key].long()              # [N, Ta]
        aff_dyn = w3[pair_na]                         # [N, Ta]
        aff_total_dyn = (sel("ipaa_valid")[None, :].to(_CNT) * g3[:, None]
                         * k_cnt[:, aff_key]).sum(dtype=_I64)
        anti_pre = torch.gather(pre_anti.T, 0, pair_nt)  # [N, TAA]
        aff_pre = pre_aff[pair_na]                    # [N, Ta]
        anti_key_on = sel("ipa_anti_key_on_node")     # [N, TAA]
        aff_valid = sel("ipaa_valid")
        aff_key_on = nk[:, aff_key]                   # [N, Ta]
        out["anti_eff"] = sel("ipa_anti_cnt_n") + anti_dyn - anti_pre
        out["anti_chk"] = anti_key_on & sel("ipaaa_valid")[None, :]
        out["aff_eff"] = sel("ipa_aff_cnt_n") + aff_dyn - aff_pre
        out["aff_key_on"] = aff_key_on
        out["aff_valid"] = aff_valid
        out["aff_total"] = (sel("ipa_aff_total") + aff_total_dyn
                            - pre_atot).reshape(1)
        # one evicted matches-all victim on node n drains aff_total by
        # the number of its node's scattered term entries
        out["aff_keys"] = (aff_valid[None, :] & aff_key_on).sum(
            dim=1).to(_CNT)                           # [N]
        out["has_aff"] = sel("ipa_has_aff").reshape(1)
        out["aff_all_keys"] = sel("ipa_aff_all_keys")
        out["self_match_all"] = sel("ipa_self_match_all").reshape(1)
        static_gate = static_gate & ~(sel("ipa_fail_existing")
                                      | fail_existing_dyn)

    # -- PTS base: shared counts (claimed drains applied), min structure ----
    f_valid = sel("f_valid")
    any_f = f_valid.any()
    shared = torch.where(
        sel("f_same_key")[:, :, None], carry["f_cnt"][tj][None, :, :], 0
    ).sum(dim=1, dtype=_I64) - pre_shared             # [C, Vnp]
    reg_real = sel("f_reg_real")                      # [C, Vnp]
    pair_cn = sel("f_pair_cn").long()                 # [N, C]
    key_on_f = sel("f_key_on_node")                   # [N, C]
    fail_missing = (f_valid[None, :] & ~key_on_f).any(dim=1)
    masked = torch.where(reg_real, shared, BIG)
    min1 = masked.min(dim=1).values                   # [C]
    at_min = masked == min1[:, None]
    cnt_min1 = at_min.sum(dim=1)
    min2 = torch.where(at_min, BIG, masked).min(dim=1).values
    shared_at = torch.gather(shared.T, 0, pair_cn)    # [N, C]
    reg_at = torch.gather(reg_real.T, 0, pair_cn)     # [N, C]
    # global min with this node's own pair EXCLUDED: re-enters adjusted
    min_excl = torch.where(
        reg_at & (shared_at == min1[None, :]) & (cnt_min1[None, :] == 1),
        min2[None, :], min1[None, :],
    )                                                 # [N, C]
    out["pts_sh"] = shared_at
    out["pts_mn"] = torch.where(reg_at, min_excl, min1[None, :])
    out["reg_at"] = reg_at
    out["pts_chk"] = any_f & f_valid[None, :] & key_on_f
    out["self_m"] = sel("f_self_match").to(torch.int32).contiguous()
    out["f_skew"] = sel("f_skew").to(torch.int32).contiguous()
    out["gate"] = static_gate & ~(any_f & fail_missing)
    return {k: t.contiguous() for k, t in out.items()}


def _whatif_run(
    S: Dict, c_static: Dict, carry: Dict,
    v_valid, v_cnt, v_req, v_mfs, v_manti, v_mall,
    nom_req, nom_cnt, nom_mfs, nom_manti, nom_mall,
    pre_req, pre_cnt, pre_shared, pre_anti, pre_aff, pre_atot,
    tj: int = 0, dyn_ipa: bool = False, dyn_ports: bool = False,
    has_nom: bool = False,
):
    """One preemptor's whole dry run: fits_now [N], base feasibility with
    every victim evicted, and the reprieve walk (victims [N, L]).

    Victim tensors are [N, L] slot-ordered PER NODE in the oracle's
    reprieve order (PDB-violating group first, then the rest, each by
    MoreImportantPod); pre_* are the already-claimed-victim aggregates
    applied to EVERY state. A slot may hold a whole same-node GANG UNIT:
    its req/mfs/manti/mall are the members' sums and v_cnt [N, L] the
    member count; singleton slots pass v_cnt == v_valid. The prologue runs
    here; the walk is `whatif_walk` (the kernel on the card, the plain
    version on the CPU), enqueued on the current stream."""
    with torch.no_grad():
        p = whatif_prologue(S, c_static, carry, pre_req, pre_cnt,
                            pre_shared, pre_anti, pre_aff, pre_atot, tj=tj,
                            dyn_ipa=dyn_ipa, dyn_ports=dyn_ports)
        v = {"valid": v_valid, "cnt": v_cnt, "req": v_req, "mfs": v_mfs,
             "manti": v_manti, "mall": v_mall}
        nom = {"req": nom_req, "cnt": nom_cnt, "mfs": nom_mfs,
               "manti": nom_manti, "mall": nom_mall}
        return whatif_walk(p, v, nom, has_nom=has_nom, dyn_ipa=dyn_ipa)


def _gang_fits_run(S: Dict, c_static: Dict, carry: Dict, k,
                   tj: int = 0, dyn_ports: bool = False):
    """Joint co-placement feasibility for k members of template tj: per-
    node template MULTIPLICITY m_i (min over checked dims of floor(free /
    req), capped by pod-count headroom, zeroed where the eviction-invariant
    static gate fails), feasible iff sum(min(m_i, k)) >= k. Returns a 0-d
    bool tensor.

    Optimistic by design, as the reference's: couplings between the
    members themselves are not modeled, so False is definitive ("cannot
    place even ignoring inter-member constraints") while True means
    "capacity exists" — the polarity the gang deadlock breaker wants."""

    def sel(key):
        return S[key][tj]

    with torch.no_grad():
        req = sel("req")
        req_check = sel("req_check")
        free = c_static["alloc"] - carry["requested"]          # [N, R]
        headroom = (c_static["allowed_pods"]
                    - carry["pod_count"].to(_I64))             # [N]
        gate = sel("static_mask")
        if dyn_ports:
            gate = gate & K.ports_mask(
                carry["cp_any"], carry["cp_wild"], carry["cp_trip"],
                {p: sel(p) for p in _PORT_STEP_KEYS},
            )
        big = torch.iinfo(_I64).max // 2
        checked = req_check & (req > 0)
        per_dim = torch.where(
            checked[None, :],
            torch.div(free, torch.where(checked, req, 1)[None, :],
                      rounding_mode="floor"),
            big,
        )                                                      # [N, R]
        m = torch.minimum(per_dim.min(dim=1).values, headroom)  # [N]
        m = torch.where(gate, m.clamp(min=0), 0)
        return torch.minimum(m, k).sum() >= k


# ---------------------------------------------------------------------------
# context: the scratch snapshot the launches plan against


class WhatifUnavailable(RuntimeError):
    """The what-if path cannot serve this preemptor (template outside
    the session envelope, unencodable pod, node-table skew); the planner
    falls one rung to the numpy fast path or the oracle."""

    def __init__(self, message: str, reason: str = "context"):
        super().__init__(message)
        self.reason = reason


class WhatifContext:
    """One scratch what-if view of the cluster: session statics + a
    SCRATCH copy of the carry, plus the host-side numpy caches the
    per-preemptor tensor prep reads. Built from the live HoistedSession
    (the carry is cloned on the device: the session updates its own in
    place) or from an encoding snapshot (the kernel session keeps its
    carry in kernel-private scaled layouts; the host encoding is its exact
    mirror after harvest, so the scratch hoisted view built from it
    scores the same cluster).

    Every launch runs on the current stream of the calling thread: the
    backend enqueues the build, the clone and the launches on its own
    stream."""

    def __init__(self, sess: HoistedSession, carry: Dict, node_names):
        self._sess = sess
        self.carry = carry
        self.node_names = list(node_names)
        self.n_lanes = int(carry["requested"].shape[0])
        self.device = sess.device
        self.fps = sess._fps
        self.dyn_ipa = sess._dyn_ipa
        self.dyn_ports = sess._dyn_ports
        self.tp_np = sess._tp_np  # match_matrices_np tables
        self._np_cache: Dict[int, Dict] = {}  # tj -> host-side slices
        self.vnp = int(sess._S["f_reg_real"].shape[2])
        self._pok_np: Optional[np.ndarray] = None

    @classmethod
    def from_session(cls, sess: HoistedSession, node_names) -> "WhatifContext":
        carry = {k: v.clone() for k, v in sess._carry.items()}
        return cls(sess, carry, node_names)

    @classmethod
    def from_host_snapshot(cls, host: Dict, node_names,
                           pod_arrays: Dict, mesh=None,
                           device=None) -> "WhatifContext":
        """Throwaway single-template hoisted view over a host-array
        snapshot (ClusterEncoding.host_snapshot), on `device` (the card
        unless the caller names the CPU). The snapshot is already a
        consistent copy, so the EXPENSIVE part — the upload and the
        prologue build — can run outside the encoding owner's lock. Never
        touches the encoder's cached device dict and never counts as a
        session build. With `mesh` (parallel/sharded.py) the view is built
        on the mesh's lead device over the snapshot padded to the shard
        multiple (sharded.shard_cluster), the reference's mesh placement
        without GSPMD: the what-if walk still takes the whole node axis,
        and the padded lanes are invalid, so the plans are the
        single-device plans."""
        if mesh is not None:
            from ..parallel.sharded import shard_cluster

            cluster = shard_cluster(
                {k: np.asarray(a) for k, a in host.items()}, mesh)
            device = mesh.lead
        else:
            cluster = {k: torch.from_numpy(np.ascontiguousarray(a))
                       for k, a in host.items()}
        sess = HoistedSession(cluster, [pod_arrays], multipod_k=1,
                              device=device)
        return cls(sess, sess._carry, node_names)

    @classmethod
    def from_encoding(cls, enc, pod_arrays: Dict,
                      device=None) -> "WhatifContext":
        """from_host_snapshot over the encoding's current state (single-
        threaded callers: tests, the probe)."""
        return cls.from_host_snapshot(
            enc.host_snapshot(), enc.node_names, pod_arrays, device=device)

    # -- host-side per-template slices -------------------------------------

    def pok_np(self) -> np.ndarray:
        if self._pok_np is None:
            self._pok_np = self._sess._c_static["pair_of_key"].cpu().numpy()
        return self._pok_np

    def template_index(self, pod_arrays: Dict) -> int:
        fp = template_fingerprint(pod_arrays)
        tj = self.fps.get(fp)
        if tj is None:
            raise WhatifUnavailable(
                "preemptor template not in the what-if view",
                reason="template",
            )
        return tj

    def np_slices(self, tj: int) -> Dict:
        got = self._np_cache.get(tj)
        if got is not None:
            return got
        sess = self._sess
        out = {
            "f_same_key": sess._S["f_same_key"][tj].cpu().numpy(),
            "f_pair_cn": sess._S["f_pair_cn"][tj].cpu().numpy(),
        }
        if self.dyn_ipa:
            for k in _TERM_SLICE_KEYS:
                out[k] = sess._tp[k][tj].cpu().numpy()
        else:
            # term-free template: zero-width anti/aff tables
            out.update({
                "ipaaa_valid": np.zeros(1, bool),
                "ipaa_valid": np.zeros(1, bool),
                "ipaaa_key": np.zeros(1, np.int32),
                "ipaa_key": np.zeros(1, np.int32),
            })
        self._np_cache[tj] = out
        return out

    def run(self, tj: int, v, nom, pre):
        """Enqueue the what-if program on the current stream; returns its
        outputs as device tensors (the caller bounds the wait and reads
        them back). v/nom/pre are dicts of numpy tensors shaped as
        _whatif_run documents."""
        from ..utils import devtime

        if devtime.enabled():
            # measured path: the launch is fenced inside the record window
            # so submit->ready is device time. Decision-inert: the
            # caller's watchdog wait then sees a finished launch.
            lt = devtime.launch(
                "kernel", "whatif", tj=tj,
                h2d_bytes=devtime.payload_bytes((v, nom, pre)))
            ys = self._run_impl(tj, v, nom, pre)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            lt.done(d2h_bytes=devtime.payload_bytes(ys))
            return ys
        return self._run_impl(tj, v, nom, pre)

    def _run_impl(self, tj: int, v, nom, pre):
        sess = self._sess

        def up(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=self.device, dtype=dtype or t.dtype)

        # singleton slots: count == validity (one member per slot)
        v_cnt = v.get("cnt")
        if v_cnt is None:
            v_cnt = np.asarray(v["valid"]).astype(np.int64)
        return _whatif_run(
            sess._S, sess._c_static, self.carry,
            up(v["valid"]), up(v_cnt), up(v["req"]), up(v["mfs"]),
            up(v["manti"]), up(v["mall"]),
            up(nom["req"]), up(nom["cnt"]), up(nom["mfs"]),
            up(nom["manti"]), up(nom["mall"]),
            up(pre["req"]), up(pre["cnt"]), up(pre["shared"]),
            up(pre["anti"]), up(pre["aff"]),
            torch.tensor(int(pre["atot"]), dtype=_CNT, device=self.device),
            tj=tj, dyn_ipa=self.dyn_ipa, dyn_ports=self.dyn_ports,
            has_nom=bool(nom["has_nom"]),
        )

    def gang_fits(self, tj: int, k: int) -> bool:
        """Can k members of template tj co-place right now? One pass of
        reductions over the scratch carry (_gang_fits_run) and one
        readback; optimistic on inter-member couplings."""
        if k <= 1:
            k = 1
        out = _gang_fits_run(
            self._sess._S, self._sess._c_static, self.carry,
            torch.tensor(k, dtype=_I64, device=self.device), tj=tj,
            dyn_ports=self.dyn_ports,
        )
        return bool(out.cpu())


def slot_bucket(n_slots: int) -> int:
    """Pow2 victim-slot bucket (min 4), as the reference's: production
    victim counts are ragged, and the planner's slot padding matches the
    reference's."""
    return batch_bucket(max(n_slots, 1), minimum=4)
