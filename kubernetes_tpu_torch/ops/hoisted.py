"""Template-hoisted scheduling: the per-template prologue, in torch.

Port of the prologue half of kubernetes_tpu/ops/hoisted.py. Batch pods
are stamped from a few distinct templates, and during one session the
pod table is static, so everything except NodeResourcesFit /
BalancedAllocation / LeastAllocated (which read the carried utilization)
and the PodTopologySpread pair counts is computed ONCE per template. The
reference vmaps `one` over the template axis; here it is a loop over
templates whose outputs are stacked.

The numpy helpers (template fingerprints, host-side match matrices,
batch buckets) are copies; the term gates (`_term_gates`) and the
`dyn_ipa` prologue feed the scan kernel's affinity-term branch. The
hoisted scan steps and HoistedSession are later slices of the port.

Reference frame: this replaces findNodesThatPassFilters +
RunScorePlugins (pkg/scheduler/core/generic_scheduler.go:235,
pkg/scheduler/framework/runtime/framework.go:723), restructured the way
the PreFilter/PreScore split intends (precompute once, reuse per node) —
lifted to precompute once per TEMPLATE per session.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import kernel as K
from .eval import eval_reqs, eval_reqs_single, ns_member
from .kernel import _CNT

TEMPLATE_KEYS_EXCLUDED = ("node_name_idx", "has_node_name")


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
# template term machinery: what makes affinity pods batchable.
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
# STATIC template×term match booleans below.


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


def _prologue(c: Dict, tp: Dict, dyn_ipa: bool = False
              ) -> Dict[str, torch.Tensor]:
    """Per-template static arrays, stacked over the template axis.

    dyn_ipa: leave the InterPodAffinity mask OUT of static_mask and expose
    its static parts (`ipa_*`) and the term gates separately, so the scan
    can recombine them with its in-scan assumed-pod counts. The NodePorts
    mask is always folded in: host-port templates ride the hoisted
    session, a later slice of the port."""

    def one(p):
        node_match = K._node_match(c, p)
        _, mask_unsched, mask_taint, mask_ports, _ = K._filter_basics(c, p)
        parts = K._ipa_filter_parts(c, p)
        mask_ipa, _ = K.ipa_compose(p, parts)
        static_mask = (c["valid"] & mask_unsched & mask_taint & node_match
                       & mask_ports)
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


def _session_prologue(c_all: Dict, tp: Dict, dyn_ipa: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """The prologue a session runs once at construction (counterpart of
    the reference's jitted _session_prologue)."""
    with torch.no_grad():
        return _prologue(c_all, tp, dyn_ipa)


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
