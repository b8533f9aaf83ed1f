"""Template-hoisted scheduling in torch: the prologue, the per-pod scan
step, and HoistedSession.

Port of kubernetes_tpu/ops/hoisted.py. Batch pods are stamped from a
few distinct templates, and during one session the pod table is static,
so everything except NodeResourcesFit / BalancedAllocation /
LeastAllocated (which read the carried utilization), the
PodTopologySpread pair counts and the dynamic InterPodAffinity /
NodePorts terms is computed ONCE per template in a prologue; the scan
then decides one pod per step against a carry that each decision
updates. The reference vmaps over templates and terms and runs the scan
as one `lax.scan` program; here the vmaps are loops whose outputs are
stacked in the same axis order, and the scan is a Python loop over pods
calling `_step` (eager torch ops on the session's device).

HoistedSession is the reference's fallback rung below the kernel session
(ops/scan.py ScanSession): it also takes host-port templates (the node
port tables join the carry) and explain mode (per-plugin filter bits and
the top-k candidates' score split), which the kernel session does not.
It keeps the reference's dtypes: int64 utilization carries, int32 pair
counts, f64 scores.

Reference frame: this replaces findNodesThatPassFilters +
RunScorePlugins (pkg/scheduler/core/generic_scheduler.go:235,
pkg/scheduler/framework/runtime/framework.go:723), restructured the way
the PreFilter/PreScore split intends (precompute once, reuse per node) —
lifted to precompute once per TEMPLATE per session.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import kernel as K
from .eval import eval_reqs, eval_reqs_single, ns_member
from .kernel import _CNT, _I64, DEFAULT_WEIGHTS

# carried cluster arrays (utilization only — pod-table rows are NOT
# written in-scan). When session templates have host ports, copies of the
# node port tables join the carry as cp_any/cp_wild/cp_trip
# (_init_dynamic_carries).
CARRY_KEYS = ("requested", "nz_requested", "pod_count")

# the cluster tensors the scan step reads (the session keeps copies of its
# own: the encoding's device state is rewritten in place)
STEP_STATIC_KEYS = ("valid", "alloc", "allowed_pods", "pair_of_key", "nkey",
                    "hard_pod_affinity_weight")

TEMPLATE_KEYS_EXCLUDED = ("node_name_idx", "has_node_name")

# Explain mode: canonical per-plugin attribution orders (the reference's
# tables, kubernetes_tpu/ops/hoisted.py:62-70). Filter verdicts pack into
# ONE int32 per node — bit i set = plugin i passed the node — in
# EXPLAIN_FILTER_PLUGINS order. Score rows stack in EXPLAIN_SCORE_KEYS
# order and are already WEIGHTED (schedule_pod's score_<key> convention),
# so a row sums to the decision total on feasible nodes.
EXPLAIN_FILTER_PLUGINS = (
    "NodeName", "NodeUnschedulable", "TaintToleration", "NodePorts",
    "NodeResourcesFit", "NodeAffinity", "PodTopologySpread",
    "InterPodAffinity",
)
EXPLAIN_SCORE_KEYS = (
    "balanced", "image", "ipa", "least", "node_affinity",
    "prefer_avoid", "pts", "taint",
)


_FP_MEMO = None  # id(anchor array) -> fingerprint; finalizer-evicted


def template_fingerprint(pod_arrays: Dict) -> Tuple:
    """Identity of the scheduling-relevant template: every encoded array
    except the per-pod node-name fields (which must be absent/false for
    batchable pending pods anyway).

    Memoized on the identity of the self_ppair buffer: the pod encoder
    caches encodings by spec fingerprint and hands out shallow copies, so
    same-template pods share the SAME array objects. Arrays are never
    mutated after encode; a fresh array (tests, non-encoder callers)
    simply misses the memo and pays the hash."""
    global _FP_MEMO
    if _FP_MEMO is None:
        _FP_MEMO = {}
    anchor = pod_arrays.get("self_ppair")
    if isinstance(anchor, np.ndarray):
        # ndarrays are unhashable, so key by id(); a weakref finalizer
        # evicts the entry when the array dies, BEFORE the id can be
        # reused (CPython refcounting runs finalizers at free time)
        hit = _FP_MEMO.get(id(anchor))
        if hit is not None:
            return hit
    else:
        anchor = None
    items = []
    for k in sorted(pod_arrays):
        if k.startswith("_") or k in TEMPLATE_KEYS_EXCLUDED:
            continue
        a = np.asarray(pod_arrays[k])
        items.append((k, a.shape, a.dtype.str, a.tobytes()))
    fp = tuple(items)
    if anchor is not None:
        import weakref

        key = id(anchor)
        _FP_MEMO[key] = fp
        weakref.finalize(anchor, _FP_MEMO.pop, key, None)
    return fp


def _stack_templates(templates: List[Dict], device) -> Dict[str, torch.Tensor]:
    """Template arrays stacked over a leading template axis, as tensors on
    `device` (dtypes kept)."""
    out = {
        k: torch.from_numpy(
            np.stack([np.asarray(t[k]) for t in templates])).to(device)
        for k in templates[0]
        if not k.startswith("_") and k not in TEMPLATE_KEYS_EXCLUDED
    }
    # kernel sections read these; hoisted pods are asserted unbound
    t = len(templates)
    out["has_node_name"] = torch.zeros(t, dtype=torch.bool, device=device)
    out["node_name_idx"] = torch.full((t,), -1, dtype=torch.int32,
                                      device=device)
    return out


# ---------------------------------------------------------------------------
# template term machinery: what makes affinity/host-port pods batchable.
#
# A session-assumed pod of template u changes, for every LATER pod of
# template t, exactly these InterPodAffinity quantities (filtering.go /
# scoring.go semantics):
#   D1 its required ANTI terms now repel t wherever t matches them;
#   D2 it now counts toward t's own required-anti term counts;
#   D3 it now counts toward t's required-affinity term counts (iff it
#      matches ALL of t's terms);
#   D4 its score terms (required-affinity at hardPodAffinityWeight,
#      preferred ±weight) now contribute to t's raw IPA score;
#   D5 it now counts toward t's preferred-term score counts.
# All five reduce to topology-group counts of assumed pods, gated by the
# STATIC template×term match booleans below: the scan carries
#   u_cnt[U, Vnp]  assumed-pod counts per template per (key,value) pair id
#   k_cnt[U, K]    assumed-pod counts per template per topology key
# and the step combines per-term gathers of u_cnt with the prologue's
# static counts through kernel.ipa_compose. Host ports ride the same way:
# the node port tables join the carry and the step recomputes the
# NodePorts mask against them (encoding._apply_ports semantics).


def _term_gates(tp: Dict) -> Dict[str, torch.Tensor]:
    """Static template×term match tensors.

    M_anti[a, τ, b]: template b's self row matches template a's required
    anti-affinity term τ (selector + namespaces + validity). Same layout
    for M_aff (required affinity) and M_pref (preferred, signed-weight
    terms). match_all[a, b]: b matches ALL of a's required-affinity terms
    (podMatchesAllAffinityTerms, filtering.go:357). G_ipa[u, t]: assuming
    a template-u pod can perturb a template-t evaluation (symmetrized
    superset for the multipod conflict test). The reference vmaps over
    the entity template; here it is a loop."""

    def fam(prefix, u):
        m = eval_reqs_single(
            tp[f"{prefix}_op"], tp[f"{prefix}_rkey"], tp[f"{prefix}_pairs"],
            tp["self_ppair"][u], tp["self_pkey"][u],
        )  # [T, X]
        return (m & ns_member(tp[f"{prefix}_ns"], tp["self_ns"][u])
                & tp[f"{prefix}_valid"])

    t_n = tp["self_ns"].shape[0]
    m_anti, m_aff, m_pref = (
        torch.stack([fam(prefix, u) for u in range(t_n)], dim=-1)
        for prefix in ("ipaaa", "ipaa", "ipap")
    )  # each [T(owner), X, T(entity)]
    has_aff = tp["ipaa_valid"].any(dim=1)  # [T]
    match_all = (
        torch.where(tp["ipaa_valid"][:, :, None], m_aff,
                    torch.ones_like(m_aff)).all(dim=1)
        & has_aff[:, None]
    )  # [T(owner), T(entity)]
    a1 = m_anti.any(dim=1)
    a2 = m_aff.any(dim=1)
    a3 = m_pref.any(dim=1)
    g = a1 | a1.T | a2 | a2.T | a3 | a3.T | match_all | match_all.T
    return {
        "M_anti": m_anti, "M_aff": m_aff, "M_pref": m_pref,
        "match_all": match_all, "G_ipa": g,
    }


def templates_have_terms(templates: List[Dict]) -> bool:
    return any(
        np.asarray(t["ipaa_valid"]).any()
        or np.asarray(t["ipaaa_valid"]).any()
        or np.asarray(t["ipap_valid"]).any()
        for t in templates
    )


def templates_have_ports(templates: List[Dict]) -> bool:
    return any(np.asarray(t["want_valid"]).any() for t in templates)


def _port_add_vectors(templates: List[Dict], vp: int, vt: int):
    """Per-template port-table increments for one assumed pod, with
    HostPortInfo's per-(ip,proto,port) set semantics (dedup by triple id —
    mirrors encoding._apply_ports exactly). numpy."""
    t_n = len(templates)
    add_any = np.zeros((t_n, vp), np.int32)
    add_wild = np.zeros((t_n, vp), np.int32)
    add_trip = np.zeros((t_n, vt), np.int32)
    for t, pa in enumerate(templates):
        valid = np.asarray(pa["want_valid"])
        trips = np.asarray(pa["want_triple"])[valid]
        pairs = np.asarray(pa["want_pair"])[valid]
        wild = np.asarray(pa["want_wild"])[valid]
        seen = set()
        for tr, pr, wl in zip(trips, pairs, wild):
            if int(tr) in seen:
                continue
            seen.add(int(tr))
            add_trip[t, tr] += 1
            add_any[t, pr] += 1
            if wl:
                add_wild[t, pr] += 1
    return add_any, add_wild, add_trip


def _port_adds_for(templates: List[Dict], cluster: Dict, device):
    return tuple(
        torch.from_numpy(a).to(device)
        for a in _port_add_vectors(
            templates,
            cluster["ports_pair_any"].shape[1],
            cluster["ports_triple"].shape[1],
        )
    )


# ---------------------------------------------------------------------------
# prologue: per-template static data + initial PTS counts


def _pts_template_static(c: Dict, p: Dict, node_match):
    """Static PTS data for one template (both filter and score passes)."""
    n = c["valid"].shape[0]
    vnp = c["npair"].shape[1]
    col = torch.arange(vnp, device=node_match.device)[None, :]

    def shared(prefix):
        valid_c = p[f"{prefix}_valid"]
        key_c = p[f"{prefix}_key"].long()
        pair_cn = c["pair_of_key"][:, key_c]              # [N, C]
        key_on_node = c["nkey"][:, key_c]                 # [N, C]
        has_all = torch.where(valid_c[None, :], key_on_node,
                              torch.ones_like(key_on_node)).all(dim=1)
        match = eval_reqs(
            p[f"{prefix}_op"], p[f"{prefix}_rkey"], p[f"{prefix}_pairs"],
            c["ppair"], c["pkey"],
        )
        match = (
            match
            & c["pvalid"][:, None]
            & ~c["pterm"][:, None]
            & (c["pns"] == p["self_ns"])[:, None]
        )  # [P, C]
        node_counts = torch.stack([
            K._seg_sum(match[:, j].to(_CNT), c["pnode"], n)
            for j in range(match.shape[1])
        ])  # [C, N]
        same_key = (
            (key_c[:, None] == key_c[None, :])
            & valid_c[:, None] & valid_c[None, :]
        )
        self_match = eval_reqs_single(
            p[f"{prefix}_op"], p[f"{prefix}_rkey"], p[f"{prefix}_pairs"],
            p["self_ppair"], p["self_pkey"],
        ).to(_CNT)
        return dict(
            valid_c=valid_c, pair_cn=pair_cn,
            key_on_node=key_on_node, has_all=has_all,
            node_counts=node_counts, same_key=same_key, self_match=self_match,
        )

    f = shared("ptsf")
    s = shared("ptss")
    n_c = f["pair_cn"].shape[1]

    # filter: registered pairs over eligible nodes (filtering.go:224) —
    # eligibility is nodeSelector/affinity + keys, NOT feasibility: static
    eligible = node_match & f["has_all"] & c["valid"]
    reg_f = torch.stack([
        K._seg_max_bool(
            eligible,
            torch.where(eligible, f["pair_cn"][:, j],
                        torch.zeros_like(f["pair_cn"][:, j])),
            vnp)
        for j in range(n_c)
    ])
    reg_real_f = reg_f & (col > 0)
    cnt_f0 = torch.stack([
        K._seg_sum(f["node_counts"][j], f["pair_cn"][:, j], vnp)
        for j in range(n_c)
    ])  # [C, Vnp]

    # score: count eligibility (scoring.go:252) is static; pair
    # REGISTRATION is over filtered nodes — feasibility-dependent, so it
    # stays in the scan
    src = node_match & s["has_all"] & c["valid"]          # [N]
    cnt_s0 = torch.stack([
        K._seg_sum(s["node_counts"][j] * src.to(_CNT), s["pair_cn"][:, j],
                   vnp)
        for j in range(s["pair_cn"].shape[1])
    ])  # [C, Vnp]

    return dict(
        # filter statics
        f_valid=f["valid_c"], f_pair_cn=f["pair_cn"],
        f_key_on_node=f["key_on_node"], f_same_key=f["same_key"],
        f_self_match=f["self_match"], f_reg_real=reg_real_f,
        f_skew=p["ptsf_skew"].to(_CNT), f_cnt0=cnt_f0,
        # score statics
        s_valid=s["valid_c"], s_pair_cn=s["pair_cn"],
        s_key_on_node=s["key_on_node"], s_has_all=s["has_all"],
        s_same_key=s["same_key"], s_src=src,
        s_hostname=p["ptss_hostname"], s_first=p["ptss_first"],
        s_skew=p["ptss_skew"], s_cnt0=cnt_s0, h_cnt0=s["node_counts"],
    )


def _prologue(c: Dict, tp: Dict, dyn_ipa: bool = False,
              dyn_ports: bool = False, explain: bool = False
              ) -> Dict[str, torch.Tensor]:
    """Per-template static arrays, stacked over the template axis.

    dyn_ipa/dyn_ports: leave the InterPodAffinity mask / NodePorts mask
    OUT of static_mask and expose their static parts separately (`ipa_*`
    and the term gates for dyn_ipa), so the scan step can recombine them
    with in-scan dynamic counts.

    explain: additionally keep the individual pre-fold masks (normally
    folded into static_mask and discarded) so the step can attribute a
    rejected node to the exact plugin that filtered it."""

    def one(p):
        node_match = K._node_match(c, p)
        _, mask_unsched, mask_taint, mask_ports, _ = K._filter_basics(c, p)
        parts = K._ipa_filter_parts(c, p)
        mask_ipa, _ = K.ipa_compose(p, parts)
        static_mask = c["valid"] & mask_unsched & mask_taint & node_match
        if not dyn_ports:
            static_mask = static_mask & mask_ports
        if not dyn_ipa:
            static_mask = static_mask & mask_ipa
        raw_ipa, ipa_present = K._score_ipa_raw(c, p)
        out = dict(
            static_mask=static_mask,
            node_match=node_match,
            raw_ipa=raw_ipa,
            ipa_present=ipa_present,
            cnt_taint=K._taint_count(c, p),
            cnt_nodeaff=K._nodeaff_count(c, p),
            sc_image=K._score_image(c, p),
            sc_avoid=K._score_prefer_avoid(c, p),
        )
        if explain:
            out.update(
                expl_unsched=mask_unsched,
                expl_taint=mask_taint,
                expl_ports=mask_ports,
                expl_ipa=mask_ipa,
            )
        if dyn_ipa:
            out.update({f"ipa_{k}": v for k, v in parts.items()})
        out.update(_pts_template_static(c, p, node_match))
        return out

    t_n = tp["self_ns"].shape[0]
    per_t = [one({k: v[t] for k, v in tp.items()}) for t in range(t_n)]
    S = {k: torch.stack([o[k] for o in per_t]) for k in per_t[0]}
    if dyn_ipa:
        S.update(_term_gates(tp))
    return S


def _session_prologue(c_all: Dict, tp: Dict, dyn_ipa: bool = False,
                      dyn_ports: bool = False, explain: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """The prologue a session runs once at construction (counterpart of
    the reference's jitted _session_prologue)."""
    with torch.no_grad():
        return _prologue(c_all, tp, dyn_ipa, dyn_ports, explain)


def _match_matrices(tp: Dict, batch: Dict):
    """Mf/Ms [T, B, C] int32: does batch pod b's row match template t's
    PTS constraint selectors (incl. the namespace gate)? The reference
    vmaps eval_reqs_single over the batch; eval_reqs over the batch rows
    is the same evaluation (numeric ops never match a pod row)."""
    mf, ms = [], []
    for t in range(tp["self_ns"].shape[0]):
        ns_ok = (batch["self_ns"] == tp["self_ns"][t])[:, None]  # [B, 1]
        for prefix, out in (("ptsf", mf), ("ptss", ms)):
            m = eval_reqs(tp[f"{prefix}_op"][t], tp[f"{prefix}_rkey"][t],
                          tp[f"{prefix}_pairs"][t], batch["self_ppair"],
                          batch["self_pkey"])  # [B, C]
            out.append((m & ns_ok).to(_CNT))
    return torch.stack(mf), torch.stack(ms)  # each [T, B, C]


def _eval_reqs_batch_np(op, key, pairs, pair_vecs, key_vecs):
    """numpy twin of eval_reqs_single over a pod batch: op/key [C, R],
    pairs [C, R, V], pair_vecs [B, P] bool, key_vecs [B, K] bool ->
    [B, C] bool. Pad ids are 0 = the never-present sentinel column, so
    plain fancy indexing matches the device gather semantics."""
    from ..models.selectors import (
        OP_EXISTS, OP_FALSE, OP_GT, OP_IN, OP_LT, OP_NOT_EXISTS, OP_NOT_IN,
    )

    any_pair = pair_vecs[:, pairs].any(axis=-1)  # [B, C, R]
    has_key = key_vecs[:, key]                   # [B, C, R]
    res = np.ones_like(has_key, dtype=bool)      # OP_PAD -> True
    res = np.where(op == OP_IN, any_pair, res)
    res = np.where(op == OP_NOT_IN, ~any_pair, res)
    res = np.where(op == OP_EXISTS, has_key, res)
    res = np.where(op == OP_NOT_EXISTS, ~has_key, res)
    res = np.where((op == OP_GT) | (op == OP_LT), False, res)
    res = np.where(op == OP_FALSE, False, res)
    return res.all(axis=-1)  # [B, C]


# tp keys the HOST-side batch prep reads (match_matrices_np); sessions
# snapshot these as numpy at construction so per-batch match evaluation
# never round-trips the device
SESSION_TP_NP_KEYS = (
    "ptsf_op", "ptsf_rkey", "ptsf_pairs",
    "ptss_op", "ptss_rkey", "ptss_pairs", "self_ns",
)

# tp keys of the templates' OWN affinity terms (the reference's session
# delta classifier reads these)
TERM_NP_KEYS = tuple(
    f"{prefix}_{suffix}"
    for prefix in ("ipaaa", "ipaa", "ipap")
    for suffix in ("op", "rkey", "pairs", "ns", "valid")
)


def ipa_term_match_np(term_np: Dict, pod_rows: Dict) -> bool:
    """Does this pod's self row match ANY session template's required /
    preferred (anti-)affinity term (selector + namespaces + validity)?
    Host twin of _term_gates.vs_entity, used by the session-delta
    classifier: matching pods affect prologue statics, not just the
    carry, so they force a rebuild."""
    pp = np.asarray(pod_rows["self_ppair"]).astype(bool)[None]
    pk = np.asarray(pod_rows["self_pkey"]).astype(bool)[None]
    ns = int(np.asarray(pod_rows["self_ns"]))
    t_n = term_np["ipaaa_op"].shape[0]
    for prefix in ("ipaaa", "ipaa", "ipap"):
        valid = term_np[f"{prefix}_valid"].astype(bool)
        if not valid.any():
            continue
        op = term_np[f"{prefix}_op"]
        rkey = term_np[f"{prefix}_rkey"]
        pairs = term_np[f"{prefix}_pairs"]
        ns_tbl = term_np[f"{prefix}_ns"]
        for t in range(t_n):
            if not valid[t].any():
                continue
            m = _eval_reqs_batch_np(op[t], rkey[t], pairs[t], pp, pk)[0]
            ns_ok = ((ns_tbl[t] == ns) & (ns_tbl[t] != 0)).any(axis=-1)
            if (m & ns_ok & valid[t]).any():
                return True
    return False


def match_matrices_np(tp_np: Dict, pod_arrays_list: List[Dict]):
    """Host-side Mf/Ms [T, B, C]: does batch pod b's row match template
    t's PTS constraint selectors (incl. the namespace gate)? Pure host
    numpy, so preparing a batch never waits on the device stream.

    tp_np: numpy template stacks (fields ptsf_*/ptss_*/self_ns, [T, ...]).
    """
    B = len(pod_arrays_list)
    pair_vecs = np.stack(
        [np.asarray(pa["self_ppair"]) for pa in pod_arrays_list]
    ).astype(bool)
    key_vecs = np.stack(
        [np.asarray(pa["self_pkey"]) for pa in pod_arrays_list]
    ).astype(bool)
    ns = np.asarray(
        [int(np.asarray(pa["self_ns"])) for pa in pod_arrays_list]
    )
    T = tp_np["self_ns"].shape[0]
    C = tp_np["ptsf_op"].shape[1]
    mf = np.zeros((T, B, C), np.int32)
    ms = np.zeros((T, B, C), np.int32)
    for t in range(T):
        ns_ok = ns == int(tp_np["self_ns"][t])  # [B]
        mf[t] = (
            _eval_reqs_batch_np(
                tp_np["ptsf_op"][t], tp_np["ptsf_rkey"][t],
                tp_np["ptsf_pairs"][t], pair_vecs, key_vecs,
            ) & ns_ok[:, None]
        ).astype(np.int32)
        ms[t] = (
            _eval_reqs_batch_np(
                tp_np["ptss_op"][t], tp_np["ptss_rkey"][t],
                tp_np["ptss_pairs"][t], pair_vecs, key_vecs,
            ) & ns_ok[:, None]
        ).astype(np.int32)
    return mf, ms


def batch_bucket(b: int, minimum: int = 64) -> int:
    """Power-of-two batch-length bucket (ragged production batches are
    padded to at most log2 distinct widths)."""
    cap = minimum
    while cap < b:
        cap *= 2
    return cap


# ---------------------------------------------------------------------------
# the scan step


def _gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[u, ...] = rows[u][idx[u, ...]] for rows [U, V] and idx [U, ...]
    (the reference's vmap of `uc[pv]` over the template axis)."""
    u = rows.shape[0]
    return torch.gather(rows, 1, idx.reshape(u, -1).long()).reshape(idx.shape)


def _count_matmul(g: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """g [X, U] @ counts [U, V] in int32, as the reference's int32 matmul
    (CUDA has no integer matmul: a broadcast product and a sum)."""
    return (g[:, :, None] * counts[None, :, :]).sum(dim=1, dtype=_CNT)


def _eval_pod(S: Dict, c_static: Dict, weights: Dict, dyn_ipa: bool,
              dyn_ports: bool, carry: Dict, tj: int, explain: bool = False):
    """Filter + score one pod of template `tj` against `carry` WITHOUT
    committing: returns (feasible [N] bool, total [N] int64 with -1 at
    infeasible nodes, n_feasible, expl). The one-pod _step and the
    multipod _step_multi both build on this, so the speculative
    evaluation cannot drift from the sequential one.

    expl is None unless `explain`: then a dict with `bits` ([N] int32,
    per-plugin filter verdicts packed in EXPLAIN_FILTER_PLUGINS bit
    order) and `scores` ([8, N] weighted per-plugin components in
    EXPLAIN_SCORE_KEYS order) — the SAME intermediates the total is built
    from, kept instead of folded."""
    n = c_static["valid"].shape[0]
    vnp = S["f_reg_real"].shape[2]
    device = c_static["valid"].device
    col = torch.arange(vnp, device=device)[None, :]

    def sel(key):
        return S[key][tj]

    # -- NodeResourcesFit (dynamic: carried utilization) --------------------
    mask_fit = K.fit_mask(
        carry["requested"], carry["pod_count"], c_static["alloc"],
        c_static["allowed_pods"], sel("req"), sel("req_check"),
        sel("req_has_any"),
    )

    # -- NodePorts over the carried port tables (dyn_ports) -----------------
    if dyn_ports:
        mask_ports = K.ports_mask(
            carry["cp_any"], carry["cp_wild"], carry["cp_trip"],
            {k: sel(k) for k in _PORT_STEP_KEYS},
        )
    else:
        mask_ports = True

    # -- InterPodAffinity: static parts + in-scan assumed-pod counts --------
    if dyn_ipa:
        u_cnt, k_cnt = carry["u_cnt"], carry["k_cnt"]
        pok, nk = c_static["pair_of_key"], c_static["nkey"]

        # D1: assumed pods' required anti terms repel this pod where it
        # matches them (filtering.go:162 existing-anti map, dynamic part)
        kaa = S["ipaaa_key"].long()                   # [U, TAA]
        cnt1 = _gather_rows(u_cnt, pok[:, kaa].permute(1, 0, 2))  # [U,N,TAA]
        g1 = S["M_anti"][:, :, tj]                    # [U, TAA]
        nk1 = nk[:, kaa].permute(1, 0, 2)             # [U, N, TAA]
        fail_existing_dyn = (g1[:, None, :] & nk1 & (cnt1 > 0)).any(
            dim=2).any(dim=0)                         # [N]

        # D2: assumed pods counting toward this pod's own anti terms
        w2 = _count_matmul(S["M_anti"][tj].to(_CNT), u_cnt)  # [TAA, Vnp]
        p2 = pok[:, sel("ipaaa_key").long()]          # [N, TAA]
        anti_dyn = torch.gather(w2.T, 0, p2.long())   # [N, TAA]

        # D3: assumed pods matching ALL of this pod's affinity terms
        g3 = S["match_all"][tj].to(_CNT)              # [U]
        w3 = _count_matmul(g3[None, :], u_cnt)[0]     # [Vnp]
        aff_key = sel("ipaa_key").long()
        aff_dyn = w3[pok[:, aff_key].long()]          # [N, Ta]
        aff_total_dyn = (sel("ipaa_valid")[None, :].to(_CNT) * g3[:, None]
                         * k_cnt[:, aff_key]).sum(dtype=_I64)

        p_t = {"ipaaa_valid": sel("ipaaa_valid"),
               "ipaa_valid": sel("ipaa_valid")}
        parts_t = {
            k: sel(f"ipa_{k}")
            for k in ("fail_existing", "anti_cnt_n", "anti_key_on_node",
                      "aff_cnt_n", "aff_all_keys", "aff_total",
                      "self_match_all", "has_aff")
        }
        mask_ipa, _ = K.ipa_compose(
            p_t, parts_t, anti_dyn=anti_dyn, aff_dyn=aff_dyn,
            aff_total_dyn=aff_total_dyn, fail_existing_dyn=fail_existing_dyn,
        )
    else:
        mask_ipa = True

    # -- PTS filter (dynamic counts) ---------------------------------------
    f_valid = sel("f_valid")
    any_f = f_valid.any()
    shared = torch.where(sel("f_same_key")[:, :, None],
                         carry["f_cnt"][tj][None, :, :], 0).sum(dim=1,
                                                                dtype=_I64)
    reg_real = sel("f_reg_real")
    big = torch.iinfo(_CNT).max
    min_c = torch.where(reg_real, shared, big).min(dim=1).values
    min_c = torch.where(min_c == big, 0, min_c)
    pair_cn = sel("f_pair_cn").long()  # [N, C]
    cnt_n = torch.gather(shared.T, 0, pair_cn)
    reg_n = torch.gather(reg_real.T, 0, pair_cn)
    cnt_n = torch.where(reg_n, cnt_n, 0)
    key_on_node = sel("f_key_on_node")
    fail_missing = (f_valid[None, :] & ~key_on_node).any(dim=1)
    skew = cnt_n + sel("f_self_match")[None, :] - min_c[None, :]
    fail_skew = (f_valid[None, :] & key_on_node
                 & (skew > sel("f_skew")[None, :])).any(dim=1)
    mask_pts = ~(any_f & (fail_missing | fail_skew))

    feasible = sel("static_mask") & mask_fit & mask_pts
    if dyn_ports:
        feasible = feasible & mask_ports
    if dyn_ipa:
        feasible = feasible & mask_ipa

    # -- scores -------------------------------------------------------------
    nz_req = sel("nz_req")
    sc_balanced = K.balanced_score(carry["nz_requested"], nz_req,
                                   c_static["alloc"])
    sc_least = K.least_allocated_score(carry["nz_requested"], nz_req,
                                       c_static["alloc"])

    # PTS score (scoring.go:221-287): registration over the FILTERED set
    s_valid = sel("s_valid")
    any_s = s_valid.any()
    has_all = sel("s_has_all")
    hostname = sel("s_hostname")
    scored = feasible & has_all
    ignored = feasible & ~has_all
    pair_cn_s = sel("s_pair_cn")  # [N, C]
    zeros = torch.zeros_like(pair_cn_s[:, 0])
    reg_s = torch.stack([
        K._seg_max_bool(scored, torch.where(scored, pair_cn_s[:, j], zeros),
                        vnp)
        for j in range(pair_cn_s.shape[1])
    ])
    reg_real_s = reg_s & (col > 0) & ~hostname[:, None] & s_valid[:, None]
    topo_size = torch.where(sel("s_first"), reg_real_s.sum(dim=1),
                            0).to(K._F64)
    n_scored = scored.sum().to(K._F64)
    weight = K.log_plus_2(torch.where(hostname, n_scored, topo_size),
                          max(n, vnp))
    shared_s = torch.where(sel("s_same_key")[:, :, None],
                           carry["s_cnt"][tj][None, :, :], 0).sum(dim=1,
                                                                  dtype=_I64)
    pair_s = pair_cn_s.long()
    cnt_n_s = torch.gather(shared_s.T, 0, pair_s)
    reg_n_s = torch.gather(reg_real_s.T, 0, pair_s)
    cnt_n_s = torch.where(reg_n_s, cnt_n_s, 0)
    cnt_n_s = torch.where(hostname[None, :], carry["h_cnt"][tj].T.to(_I64),
                          cnt_n_s)
    raw = K.pts_raw(s_valid[None, :] & sel("s_key_on_node"), cnt_n_s, weight,
                    sel("s_skew"))
    sc_pts = K.pts_normalize(raw, scored, ignored, any_s)

    # -- IPA score: static raw + assumed-pod contributions ------------------
    raw_ipa = sel("raw_ipa")
    ipa_present = sel("ipa_present")
    if dyn_ipa:
        hard_w = c_static["hard_pod_affinity_weight"].to(_CNT)

        def existing_terms(key_tbl, gate, w):
            """D4: assumed pods' score terms vs this pod. key_tbl [U, X],
            gate [U, X] (match+validity), w [U, X] signed weights."""
            key_tbl = key_tbl.long()
            cnt = _gather_rows(u_cnt, pok[:, key_tbl].permute(1, 0, 2))
            nkx = nk[:, key_tbl].permute(1, 0, 2)     # [U, N, X]
            contrib = (torch.where(gate[:, None, :] & nkx, cnt, 0)
                       * w[:, None, :]).sum(dim=(0, 2), dtype=_I64)  # [N]
            # k_cnt[:, key_tbl] is [U, U, X], broadcast against gate
            # [U, X] as the reference's expression does
            present = (gate & (k_cnt[:, key_tbl] > 0)).any()
            return contrib, present

        # required-affinity terms of assumed pods score at
        # hardPodAffinityWeight (scoring.go:88 processExistingPod)
        g4a = S["M_aff"][:, :, tj] & (hard_w > 0)
        c4a, p4a = existing_terms(S["ipaa_key"], g4a,
                                  hard_w.expand(g4a.shape))
        # preferred terms of assumed pods, signed weight
        c4p, p4p = existing_terms(S["ipap_key"], S["M_pref"][:, :, tj],
                                  S["ipap_weight"].to(_CNT))
        # D5: assumed pods vs this pod's own preferred terms
        w5 = _count_matmul(S["M_pref"][tj].to(_CNT), u_cnt)  # [TP, Vnp]
        pref_key = sel("ipap_key").long()
        cnt5 = torch.gather(w5.T, 0, pok[:, pref_key].long())  # [N, TP]
        c5 = (torch.where(nk[:, pref_key], cnt5, 0)
              * sel("ipap_weight").to(_CNT)[None, :]).sum(dim=1, dtype=_I64)
        p5p = (S["M_pref"][tj] & (k_cnt[:, pref_key].T > 0)).any()
        raw_ipa = raw_ipa + c4a + c4p + c5
        ipa_present = ipa_present | p4a | p4p | p5p
    sc_ipa = K._score_ipa_normalize(raw_ipa, ipa_present, feasible)
    sc_taint = K._normalize_default(sel("cnt_taint"), feasible, reverse=True)
    sc_nodeaff = K._normalize_default(sel("cnt_nodeaff"), feasible,
                                      reverse=False)

    weighted = {
        "balanced": sc_balanced * weights["balanced"],
        "image": sel("sc_image") * weights["image"],
        "ipa": sc_ipa * weights["ipa"],
        "least": sc_least * weights["least"],
        "node_affinity": sc_nodeaff * weights["node_affinity"],
        "prefer_avoid": sel("sc_avoid") * weights["prefer_avoid"],
        "pts": sc_pts * weights["pts"],
        "taint": sc_taint * weights["taint"],
    }
    total = sum(weighted[k] for k in EXPLAIN_SCORE_KEYS)
    total = torch.where(feasible, total, -1)
    n_feasible = feasible.sum()
    if not explain:
        return feasible, total, n_feasible, None
    # pack the per-plugin verdicts/components the fold normally discards.
    # NodeName is identically true — session pods are unbound
    # (prepare_batch / schedule refuse bound pods).
    plugin_masks = (
        torch.ones(n, dtype=torch.bool, device=device),
        sel("expl_unsched"),
        sel("expl_taint"),
        mask_ports if dyn_ports else sel("expl_ports"),
        mask_fit,
        sel("node_match"),
        mask_pts,
        mask_ipa if dyn_ipa else sel("expl_ipa"),
    )
    bits = torch.zeros(n, dtype=torch.int32, device=device)
    for i, m in enumerate(plugin_masks):
        bits = bits | (m.to(torch.int32) << i)
    scores = torch.stack([weighted[k] for k in EXPLAIN_SCORE_KEYS])
    return feasible, total, n_feasible, {"bits": bits, "scores": scores}


def _commit_pod(S: Dict, c_static: Dict, dyn_ipa: bool, dyn_ports: bool,
                carry: Dict, tj: int, j: int, best, ok) -> None:
    """Apply one decided pod (batch row j, template tj, node `best`, a 0-d
    index tensor) to the carry, in place — the assume side of the step,
    shared by _step and _step_multi. Every update is gated on `ok` (a 0-d
    bool tensor; a no-op for failed / padding rows) and accumulates
    (index_add_ / index_put_ with accumulate=True), as the reference's
    scatter-adds do where indices repeat. The node is indexed by a
    one-element tensor, never a 0-d one (which torch reads back to the
    host), so the step never waits for the device."""
    at = best.reshape(1).long()
    add64 = ok.to(_I64)
    addc = ok.to(_CNT)
    carry["requested"].index_add_(0, at, (S["req"][tj] * add64)[None, :])
    carry["nz_requested"].index_add_(0, at,
                                     (S["nz_req"][tj] * add64)[None, :])
    carry["pod_count"].index_add_(0, at, ok.to(torch.int32).reshape(1))
    # incremental count updates for EVERY template: the assumed pod's row
    # may match other templates' constraints too
    t_n, _, c_n = S["f_pair_cn"].shape
    device = at.device
    t_idx = torch.arange(t_n, device=device)[:, None]
    c_idx = torch.arange(c_n, device=device)[None, :]
    mf = S["Mf"][:, j, :] * addc  # [T, C]
    ms = S["Ms"][:, j, :] * addc
    pair_b_f = S["f_pair_cn"][:, at, :][:, 0, :].long()  # [T, C]
    pair_b_s = S["s_pair_cn"][:, at, :][:, 0, :].long()
    src_b = S["s_src"][:, at][:, 0]  # [T]
    carry["f_cnt"].index_put_((t_idx, c_idx, pair_b_f), mf, accumulate=True)
    carry["s_cnt"].index_put_((t_idx, c_idx, pair_b_s),
                              ms * src_b[:, None].to(_CNT), accumulate=True)
    carry["h_cnt"].index_add_(2, at, ms[:, :, None])
    if dyn_ipa:
        # the assumed pod joins its node's topology groups for every key
        # the node carries (pair id 0 rows get +0 via the nkey gate)
        nb = (c_static["nkey"][at][0] & ok).to(_CNT)  # [K]
        carry["u_cnt"][tj].index_add_(
            0, c_static["pair_of_key"][at][0].long(), nb)
        carry["k_cnt"][tj] += nb
    if dyn_ports:
        for key, add in (("cp_any", "padd_any"), ("cp_wild", "padd_wild"),
                         ("cp_trip", "padd_trip")):
            carry[key].index_add_(0, at, (S[add][tj] * addc)[None, :])


def _step(S: Dict, c_static: Dict, weights: Dict, dyn_ipa: bool,
          dyn_ports: bool, explain_k: int, carry: Dict, tj: int, j: int,
          valid: bool) -> Dict:
    """One scan step: evaluate pod j (template tj) and commit its
    decision to the carry in place. Returns the step's outputs."""
    feasible, total, n_feasible, expl = _eval_pod(
        S, c_static, weights, dyn_ipa, dyn_ports, carry, tj,
        explain=explain_k > 0,
    )
    # torch.argmax returns the first maximal index, as jnp.argmax does
    best = torch.argmax(total).to(torch.int32)
    score = total.max()  # total[best], without reading best back
    ok = (score >= 0) & valid
    _commit_pod(S, c_static, dyn_ipa, dyn_ports, carry, tj, j, best, ok)
    y = {
        "best": torch.where(ok, best, -1),
        "score": torch.where(ok, score, -1),
        "n_feasible": n_feasible,
    }
    if explain_k > 0:
        # top-k candidates with full attribution; ties break toward lower
        # indices (lax.top_k's order; torch.topk promises none, a stable
        # descending sort keeps it), so topk_idx[0] IS the decision
        kk = min(int(explain_k), int(total.shape[0]))
        topv, topi = torch.sort(total, descending=True, stable=True)
        topv, topi = topv[:kk], topi[:kk]
        y["expl_bits"] = expl["bits"]
        y["expl_topk_idx"] = topi.to(torch.int32)
        y["expl_topk_total"] = topv
        y["expl_topk_scores"] = expl["scores"][:, topi].T  # [kk, 8]
    return y


def _step_multi(S: Dict, c_static: Dict, weights: Dict, dyn_ipa: bool,
                dyn_ports: bool, carry: Dict, tmpl: List[int], js: List[int],
                valid: List[bool]) -> List[Dict]:
    """k pods per step with EXACT conflict replay (the reference's
    _step_multi): all k pods are filtered + scored against the
    step-initial carry, then committed in order. A pod's speculative
    decision stands only when none of the step's earlier committed pods
    could have perturbed what its evaluation read:

      same-node  — an earlier pod consumed capacity on the chosen node;
      PTS        — an earlier pod's row matches one of this template's
                   VALID spread selectors (Mf/Ms gated by f/s_valid);
      IPA        — template-level interference via the prologue's G_ipa;
      fit flip / — the shared utilization algebra
      overtake     (kernel.multipod_utilization_conflicts).

    A conflicted pod replays — the full evaluation against the current
    carry, the sequential computation — so decisions, scores and
    n_feasible equal one pod per step whatever the conflict rate. The
    reference branches on the device (lax.cond); here the host reads the
    conflict flag and replays."""
    k = len(tmpl)
    ev = [_eval_pod(S, c_static, weights, dyn_ipa, dyn_ports, carry, t)
          for t in tmpl]
    nz0 = carry["nz_requested"].clone()  # the step-initial carry's
    n = c_static["valid"].shape[0]
    device = c_static["valid"].device
    lane = torch.arange(n, dtype=torch.int32, device=device)
    alloc = c_static["alloc"]
    jt = torch.tensor(js, dtype=torch.long, device=device)
    tt = torch.tensor(tmpl, dtype=torch.long, device=device)

    def wbl(nz_requested, nz_req):
        return (
            K.balanced_score(nz_requested, nz_req, alloc)
            * weights["balanced"]
            + K.least_allocated_score(nz_requested, nz_req, alloc)
            * weights["least"]
        )

    best_arr = torch.full((k,), -1, dtype=torch.int32, device=device)
    ok_arr = torch.zeros(k, dtype=torch.bool, device=device)
    ys = []
    for i in range(k):
        tj = tmpl[i]
        feas_i, total_i, nfeas_i, _ = ev[i]
        best_spec = torch.argmax(total_i).to(torch.int32)
        score_spec = total_i.max()
        prior = (torch.arange(k, device=device) < i) & ok_arr
        same = (prior & (best_arr == best_spec)).any() & (score_spec >= 0)
        mf_k = (S["Mf"][tj][jt] != 0) & S["f_valid"][tj][None, :]
        ms_k = (S["Ms"][tj][jt] != 0) & S["s_valid"][tj][None, :]
        pts_conf = (prior & (mf_k.any(dim=1) | ms_k.any(dim=1))).any()
        if dyn_ipa:
            ipa_conf = (prior & S["G_ipa"][tt, tj]).any()
        else:
            ipa_conf = torch.zeros((), dtype=torch.bool, device=device)
        nz_req = S["nz_req"][tj]
        fit_new = K.fit_mask(
            carry["requested"], carry["pod_count"], alloc,
            c_static["allowed_pods"], S["req"][tj], S["req_check"][tj],
            S["req_has_any"][tj],
        )
        flip_row, over_row = K.multipod_utilization_conflicts(
            feas_i, total_i, best_spec, score_spec, lane, fit_new,
            wbl(nz0, nz_req), wbl(carry["nz_requested"], nz_req),
        )
        util_conf = flip_row.any() | (over_row.any() & (score_spec >= 0))
        conflict = (same | pts_conf | ipa_conf | util_conf) & valid[i]
        # ktpu: allow-sync(dispatch: the multi-pod step reads its conflict flag to choose the replay, one bool a step; only at multipod_k > 1, which the CUDA default never takes)
        if bool(conflict):
            _, t2, nf2, _ = _eval_pod(S, c_static, weights, dyn_ipa,
                                      dyn_ports, carry, tj)
            best = torch.argmax(t2).to(torch.int32)
            score, n_feasible = t2.max(), nf2
        else:
            best, score, n_feasible = best_spec, score_spec, nfeas_i
        ok = (score >= 0) & valid[i]
        _commit_pod(S, c_static, dyn_ipa, dyn_ports, carry, tj, js[i],
                    best, ok)
        placed = torch.where(ok, best, -1)
        best_arr[i] = placed
        ok_arr[i] = ok
        ys.append({"best": placed, "score": torch.where(ok, score, -1),
                   "n_feasible": n_feasible,
                   "conflicts": conflict.to(torch.int32)})
    return ys


# tp keys the step reads directly when the dynamic-IPA / dynamic-ports
# machinery is on
_TERM_STEP_KEYS = (
    "ipaaa_key", "ipaaa_valid", "ipaa_key", "ipaa_valid",
    "ipap_key", "ipap_weight",
)
_PORT_STEP_KEYS = ("want_pair", "want_triple", "want_wild", "want_valid")


def _merge_step_inputs(S: Dict, tp: Dict, dyn_ipa: bool, dyn_ports: bool,
                       port_adds) -> None:
    for k in ("req", "req_check", "req_has_any", "nz_req"):
        S[k] = tp[k]
    if dyn_ipa:
        for k in _TERM_STEP_KEYS:
            S[k] = tp[k]
    if dyn_ports:
        for k in _PORT_STEP_KEYS:
            S[k] = tp[k]
        S["padd_any"], S["padd_wild"], S["padd_trip"] = port_adds


def _init_dynamic_carries(carry: Dict, c_all: Dict, n_templates: int,
                          dyn_ipa: bool, dyn_ports: bool) -> None:
    """Zero-initialize the assumed-pod count carries and copy-adopt the
    port tables. The copies are unconditional: the step updates the carry
    in place, and the encoding's device state must never move with it."""
    device = c_all["valid"].device
    if dyn_ipa:
        vnp = c_all["npair"].shape[1]
        k_n = c_all["nkey"].shape[1]
        carry["u_cnt"] = torch.zeros((n_templates, vnp), dtype=_CNT,
                                     device=device)
        carry["k_cnt"] = torch.zeros((n_templates, k_n), dtype=_CNT,
                                     device=device)
    if dyn_ports:
        carry["cp_any"] = c_all["ports_pair_any"].to(_CNT, copy=True)
        carry["cp_wild"] = c_all["ports_pair_wild"].to(_CNT, copy=True)
        carry["cp_trip"] = c_all["ports_triple"].to(_CNT, copy=True)


def _initial_carry(c_all: Dict, S: Dict) -> Dict[str, torch.Tensor]:
    """Copies of the cluster's utilization rows and the prologue's count
    bases (popped from S)."""
    carry = {k: c_all[k].clone() for k in CARRY_KEYS}
    for k in ("f_cnt", "s_cnt", "h_cnt"):
        carry[k] = S.pop(f"{k}0")
    return carry


def _session_scan(S: Dict, c_static: Dict, tp: Dict, carry: Dict,
                  batch_self: Dict, xs: Dict, weights: Dict,
                  dyn_ipa: bool = False, dyn_ports: bool = False, k: int = 1,
                  explain_k: int = 0) -> Dict:
    """The scan over one batch (the reference's lax.scan over `_step`): the
    batch's match matrices, then a Python loop over its pods, one `_step`
    each (or `_step_multi` over groups of k), updating `carry` in place.
    xs holds host lists: `tmpl`, `j`, `valid`. Returns the ys, each a
    tensor stacked over the batch."""
    tmpl, js, valid = xs["tmpl"], xs["j"], xs["valid"]
    with torch.no_grad():
        S = dict(S)
        S["Mf"], S["Ms"] = _match_matrices(tp, batch_self)
        if k <= 1 or explain_k > 0:
            # explain rides the one-pod-per-step scan (the session pins
            # multipod_k to 1 in explain mode; decisions are identical)
            ys = [_step(S, c_static, weights, dyn_ipa, dyn_ports, explain_k,
                        carry, t, j, v)
                  for t, j, v in zip(tmpl, js, valid)]
        else:
            # the reference folds the pow2-padded batch into [steps, k];
            # unpadded, the last group is shorter (decisions equal one
            # pod per step either way)
            ys = []
            for lo in range(0, len(tmpl), k):
                ys += _step_multi(S, c_static, weights, dyn_ipa, dyn_ports,
                                  carry, tmpl[lo:lo + k], js[lo:lo + k],
                                  valid[lo:lo + k])
        if not ys:
            return {}
        return {key: torch.stack([y[key] for y in ys]) for key in ys[0]}


def _run(c_all: Dict, tp: Dict, batch_self: Dict, xs: Dict, weights: Dict,
         dyn_ipa: bool = False, dyn_ports: bool = False, port_adds=None,
         explain_k: int = 0):
    """One-shot scan: the prologue, the match matrices, a fresh carry and
    the scan over xs. Returns (carry, ys)."""
    with torch.no_grad():
        S = _prologue(c_all, tp, dyn_ipa, dyn_ports, explain=explain_k > 0)
        _merge_step_inputs(S, tp, dyn_ipa, dyn_ports, port_adds)
        carry = _initial_carry(c_all, S)
        _init_dynamic_carries(carry, c_all, tp["req"].shape[0], dyn_ipa,
                              dyn_ports)
    c_static = {k: c_all[k] for k in STEP_STATIC_KEYS}
    ys = _session_scan(S, c_static, tp, carry, batch_self, xs, weights,
                       dyn_ipa, dyn_ports, explain_k=explain_k)
    return carry, ys


def _batch_inputs(pod_arrays_list: List[Dict], tmpl_ids: np.ndarray,
                  device, pad_to: int = 0) -> Tuple[Dict, Dict]:
    """(batch_self, xs) for one scan over these pods (shared by
    prepare_batch and HoistedSession.schedule). batch_self holds the pods'
    self rows as tensors on `device`; xs the host lists the loop reads
    (`tmpl`, `j`, `valid`). Rows past len(pod_arrays_list) (up to pad_to)
    are zero-filled with valid=False: the step gates every carry update on
    valid, so they are pure no-ops."""
    b = len(pod_arrays_list)
    bp = max(pad_to, b)

    def stack(key):
        a = np.stack([np.asarray(pa[key]) for pa in pod_arrays_list])
        if bp > b:
            a = np.concatenate(
                [a, np.zeros((bp - b,) + a.shape[1:], a.dtype)])
        return torch.from_numpy(a).to(device)

    batch_self = {k: stack(k) for k in ("self_ppair", "self_pkey", "self_ns")}
    tmpl = np.zeros(bp, np.int32)
    tmpl[:b] = tmpl_ids
    xs = {"tmpl": tmpl.tolist(), "j": list(range(bp)),
          "valid": [i < b for i in range(bp)]}
    return batch_self, xs


def prepare_batch(pod_arrays_list: List[Dict], device
                  ) -> Tuple[Dict, Dict, Dict, List[Dict]]:
    """Group the batch by template and build the scan inputs: (stacked
    templates, batch self-rows, xs, template list). Pods with affinity
    terms and host ports ARE hoistable — the scan carries their dynamic
    effects; only bound pods (spec.nodeName) are refused."""
    b = len(pod_arrays_list)
    fps: Dict[Tuple, int] = {}
    templates: List[Dict] = []
    tmpl_ids = np.zeros(b, np.int32)
    for i, pa in enumerate(pod_arrays_list):
        if bool(np.asarray(pa["has_node_name"])):
            raise ValueError("hoisted: pods must be unbound")
        fp = template_fingerprint(pa)
        t = fps.get(fp)
        if t is None:
            t = len(templates)
            fps[fp] = t
            templates.append(pa)
        tmpl_ids[i] = t
    tp = _stack_templates(templates, device)
    batch_self, xs = _batch_inputs(pod_arrays_list, tmpl_ids, device)
    return tp, batch_self, xs, templates


# ktpu: allow-sync(harvest decode: one-shot API drains decisions to host lists by design)
def schedule_batch_hoisted(
    cluster: Dict[str, torch.Tensor],
    pod_arrays_list: List[Dict],
    weights: Optional[Dict[str, int]] = None,
    explain_k: int = 0,
) -> Tuple[List[int], Dict]:
    """Schedule a batch with template hoisting (affinity/port pods
    included — their assume effects ride the dynamic carries) on the
    device the cluster tensors lie on. Pods must be unbound. Returns
    (decisions, ys); explain_k > 0 adds per-pod attribution to ys
    (see HoistedSession.explain_payload)."""
    device = cluster["valid"].device
    tp, batch_self, xs, templates = prepare_batch(pod_arrays_list, device)
    dyn_ipa = templates_have_terms(templates)
    dyn_ports = templates_have_ports(templates)
    port_adds = (_port_adds_for(templates, cluster, device)
                 if dyn_ports else None)
    _, ys = _run(cluster, tp, batch_self, xs,
                 dict(weights or DEFAULT_WEIGHTS), dyn_ipa, dyn_ports,
                 port_adds, explain_k)
    return [int(v) for v in ys["best"].tolist()], ys


# ---------------------------------------------------------------------------
# cross-batch session: the carry stays on the device, the prologue runs ONCE


def _session_apply_deltas(carry: Dict, f_pair_cn, s_pair_cn, s_src, nodes,
                          dres, dnz, dcount, mf, ms) -> None:
    """Apply a batch of cluster-event deltas to the session carry, in
    place: per event e, a batchable pod landed on (sign +1) or left (sign
    -1) node nodes[e]. The math is the step's carry update with `best :=
    nodes[e]` — utilization rows plus the PTS pair-count scatter through
    the same match vectors — so a delta-patched carry equals one whose
    scan assumed / never saw the pod. mf/ms arrive sign-multiplied (and
    zeroed for terminating pods). Events may repeat a node: every update
    accumulates."""
    carry["requested"].index_add_(0, nodes, dres)
    carry["nz_requested"].index_add_(0, nodes, dnz)
    carry["pod_count"].index_add_(0, nodes, dcount)
    t_n, _, c_n = f_pair_cn.shape
    device = nodes.device
    t_ix = torch.arange(t_n, device=device)[:, None, None]
    c_ix = torch.arange(c_n, device=device)[None, None, :]
    mf_t = mf.permute(1, 0, 2)                    # [T, E, C]
    ms_t = ms.permute(1, 0, 2)
    pair_f = f_pair_cn[:, nodes, :].long()        # [T, E, C]
    carry["f_cnt"].index_put_((t_ix, c_ix, pair_f), mf_t, accumulate=True)
    pair_s = s_pair_cn[:, nodes, :].long()
    src = s_src[:, nodes].to(mf.dtype)            # [T, E]
    carry["s_cnt"].index_put_((t_ix, c_ix, pair_s), ms_t * src[:, :, None],
                              accumulate=True)
    c2_ix = torch.arange(c_n, device=device)[None, :, None]
    carry["h_cnt"].index_put_((t_ix, c2_ix, nodes[None, None, :]),
                              ms.permute(1, 2, 0), accumulate=True)


class HoistedSession:
    """Hoisted scheduling with the carry kept on the device across
    batches (the reference's HoistedSession).

    The prologue runs once at construction; every `schedule()` then runs
    the scan over its batch against the live carry (one pod per step, or
    `multipod_k` pods per step with exact replay), and `apply_deltas`
    absorbs cluster churn into the carry without a rebuild. The session
    kind with explain support (supports_explain): with explain_k > 0
    every step also returns packed per-plugin filter bits and the top-k
    candidates' weighted score split, decoded by explain_payload
    (decisions stay identical; multipod pins to 1). Host-port templates
    ride it: the node port tables join the carry.

    Runs on `device` (cuda when none is given; raises without CUDA); the
    cluster tensors are copied there. The carry and the statics the step
    reads are copies the session owns: the encoding's device state is
    rewritten in place and must not move the session.

    The template set is fixed at construction: a batch pod whose
    fingerprint is unknown raises KeyError.

    Reference frame: the assume-cache discipline of the reference's
    scheduler cache (pkg/scheduler/internal/cache/cache.go:361 AssumePod)
    applied to the device-resident arrays: the device carry IS the
    assume cache."""

    supports_explain = True

    def __init__(
        self,
        cluster: Dict[str, torch.Tensor],
        template_arrays_list: List[Dict],
        weights: Optional[Dict[str, int]] = None,
        multipod_k: Optional[int] = None,
        explain_k: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        self.explain_k = max(0, int(explain_k or 0))
        self._fps = {
            template_fingerprint(t): i
            for i, t in enumerate(template_arrays_list)
        }
        self._dyn_ipa = templates_have_terms(template_arrays_list)
        # uniform session-delta interface: dyn_ipa names whether the
        # templates carry IPA terms — a foreign pod matching one would
        # perturb prologue STATICS, not just the carry
        self.dyn_ipa = self._dyn_ipa
        self._dyn_ports = templates_have_ports(template_arrays_list)
        cluster = {k: v.to(self.device) for k, v in cluster.items()}
        port_adds = (
            _port_adds_for(template_arrays_list, cluster, self.device)
            if self._dyn_ports else None
        )
        tp = _stack_templates(template_arrays_list, self.device)
        S = dict(_session_prologue(cluster, tp, self._dyn_ipa,
                                   self._dyn_ports, self.explain_k > 0))
        self._carry = _initial_carry(cluster, S)
        _init_dynamic_carries(self._carry, cluster,
                              len(template_arrays_list), self._dyn_ipa,
                              self._dyn_ports)
        _merge_step_inputs(S, tp, self._dyn_ipa, self._dyn_ports, port_adds)
        self._S = S
        self._tp = tp
        self._c_static = {k: cluster[k].clone() for k in STEP_STATIC_KEYS}
        # host-side numpy snapshots for the session-delta path: match
        # evaluation (match_matrices_np) and the term-match classifier
        self._tp_np = {k: tp[k].cpu().numpy() for k in SESSION_TP_NP_KEYS}
        self._term_np = (
            {k: tp[k].cpu().numpy() for k in TERM_NP_KEYS}
            if self._dyn_ipa else None
        )
        # multi-pod steps with exact replay (_step_multi); port-carrying
        # sessions are pinned to k=1 (kernel.multipod_k), and so is
        # explain mode: attribution is per decided pod against its exact
        # decision-time carry
        self.multipod_k = K.multipod_k(multipod_k, dyn_ports=self._dyn_ports,
                                       platform=self.device.type)
        if self.explain_k:
            self.multipod_k = 1

    # -- incremental device-state deltas -----------------------------------

    def delta_compatible(self, dres, dnz) -> bool:
        """Every int64 utilization delta is exactly representable in this
        session's int64 carry."""
        return True

    def apply_deltas(self, deltas: List[Dict]) -> None:
        """Reconcile the live session with a batch of host-encoding
        mutations WITHOUT a rebuild. Two kinds (the backend's
        classification; testing/churn.py here):

          kind=pod-add / pod-remove — a batchable pod landed on / left a
          known node: utilization row + PTS pair counts, i.e. exactly the
          scan's carry. One in-place update for the whole batch.

          kind=node-alloc — an allocatable-only node update: patches the
          static alloc/allowed_pods rows (prologue products never read
          alloc, so the carry and every other static stay valid).

        A delta-patched session decides as a fresh session built from the
        mutated encoding. Raises ValueError, before anything moves, for a
        node index outside [0, N) (the reference's scatter would drop it
        from the utilization rows)."""
        n_nodes = self._c_static["valid"].shape[0]
        for d in deltas:
            if not 0 <= int(d["node"]) < n_nodes:
                raise ValueError(f"delta node {d['node']} outside [0, "
                                 f"{n_nodes})")
        pods = [d for d in deltas if d["kind"] != "node-alloc"]
        for d in deltas:
            if d["kind"] != "node-alloc":
                continue
            at = torch.tensor([int(d["node"])], device=self.device)
            dalloc = torch.as_tensor(np.asarray(d["dalloc"], np.int64),
                                     device=self.device)
            dallowed = torch.tensor([int(d["dallowed"])], dtype=torch.int64,
                                    device=self.device)
            self._c_static["alloc"].index_add_(0, at, dalloc[None, :])
            self._c_static["allowed_pods"].index_add_(
                0, at, dallowed.to(self._c_static["allowed_pods"].dtype))
        if not pods:
            return
        e = len(pods)
        r = self._carry["requested"].shape[1]
        t_n, _, c_n = self._S["f_pair_cn"].shape
        nodes = np.zeros(e, np.int64)
        dres = np.zeros((e, r), np.int64)
        dnz = np.zeros((e, 2), np.int64)
        dcount = np.zeros(e, np.int32)
        mf = np.zeros((e, t_n, c_n), np.int32)
        ms = np.zeros((e, t_n, c_n), np.int32)
        for i, d in enumerate(pods):
            nodes[i] = d["node"]
            dres[i] = d["dres"]
            dnz[i] = d["dnz"]
            dcount[i] = d["dcount"]
            mf[i] = d["mf"]
            ms[i] = d["ms"]

        def up(a):
            return torch.from_numpy(a).to(self.device)

        with torch.no_grad():
            _session_apply_deltas(
                self._carry, self._S["f_pair_cn"], self._S["s_pair_cn"],
                self._S["s_src"], up(nodes), up(dres), up(dnz),
                up(dcount), up(mf), up(ms),
            )

    def schedule(self, pod_arrays_list: List[Dict]) -> Dict:
        """Run the scan over one batch against the live carry; returns ys
        (tensors on the session's device, one row per pod; the ops are
        enqueued, and decisions() waits for them). Raises KeyError on a
        pod whose template was not registered at construction."""
        b = len(pod_arrays_list)
        tmpl_ids = np.zeros(b, np.int32)
        for i, pa in enumerate(pod_arrays_list):
            if bool(np.asarray(pa["has_node_name"])):
                raise ValueError("session pods must be unbound")
            tmpl_ids[i] = self._fps[template_fingerprint(pa)]
        if not b:
            return {"_b_real": 0}
        batch_self, xs = _batch_inputs(pod_arrays_list, tmpl_ids,
                                       self.device)
        ys = _session_scan(self._S, self._c_static, self._tp, self._carry,
                           batch_self, xs, self.weights, self._dyn_ipa,
                           self._dyn_ports, self.multipod_k, self.explain_k)
        ys["_b_real"] = b  # padding rows carry no decision
        return ys

    @staticmethod
    # ktpu: allow-sync(harvest decode: host consumes batch verdicts after the launch completes)
    def decisions(ys: Dict) -> List[int]:
        """Wait for a batch's results and return node indices (-1 =
        unschedulable), padding rows stripped."""
        if "best" not in ys:
            return []
        best = ys["best"].tolist()
        return [int(v) for v in best[: ys.get("_b_real", len(best))]]

    @staticmethod
    # ktpu: allow-sync(harvest decode: host reads conflict planes after the launch completes)
    def conflict_stats(ys: Dict):
        """(n_conflicts, replay_suffix_start) for one harvested batch. The
        hoisted scan replays conflicted pods in the step, so every
        decision is already exact: the suffix is always None and the
        count is observability only."""
        c = ys.get("conflicts")
        if c is None:
            return 0, None
        return int(c[: ys.get("_b_real", c.shape[0])].sum()), None

    @staticmethod
    # ktpu: allow-sync(harvest decode: explain attribution is read back off the hot path)
    def explain_payload(ys: Dict):
        """Per-pod attribution from an explain-mode batch, or None when the
        batch ran with explain off. Padding rows stripped; each entry
        (numpy):

          bits        [N] int32 — bit i set = EXPLAIN_FILTER_PLUGINS[i]
                      passed the node;
          topk_idx    [k] candidate node indices, best first (index 0 is
                      the decision when the pod was placed);
          topk_total  [k] decision totals (-1 = infeasible);
          topk_scores [k, 8] weighted per-plugin split in
                      EXPLAIN_SCORE_KEYS order (rows sum to the total on
                      feasible nodes)."""
        if "expl_bits" not in ys:
            return None
        bits = ys["expl_bits"].cpu().numpy()
        idx = ys["expl_topk_idx"].cpu().numpy()
        tot = ys["expl_topk_total"].cpu().numpy()
        sc = ys["expl_topk_scores"].cpu().numpy()
        b = ys.get("_b_real", bits.shape[0])
        return [
            {"bits": bits[i], "topk_idx": idx[i], "topk_total": tot[i],
             "topk_scores": sc[i]}
            for i in range(b)
        ]
