"""The scheduling plugins as dense tensor code over the cluster encoding.

Port of the part of kubernetes_tpu/ops/kernel.py that the per-template
prologue (ops/hoisted.py) calls. The reference ran these sections as
XLA programs outside any Pallas kernel, so here they are plain torch:
masked arithmetic over the ClusterEncoding tensors, one template at a
time. Every plugin of the default profile (reference:
pkg/scheduler/algorithmprovider/registry.go:71 getDefaultConfig) keeps
the reference's formula and dtypes; see the per-section docstrings for
their provenance.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.encoding import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    ST_PREFERRED_AFFINITY,
    ST_REQUIRED_AFFINITY,
)
from .eval import eval_reqs, eval_reqs_single, ns_member

MAX_NODE_SCORE = 100
MB = 1024 * 1024
MIN_IMG_THRESHOLD = 23 * MB  # image_locality.go:33
MAX_CONTAINER_THRESHOLD = 1000 * MB

# Default-profile score plugin weights
# (reference: pkg/scheduler/algorithmprovider/registry.go:110-131)
DEFAULT_WEIGHTS = {
    "balanced": 1,
    "image": 1,
    "ipa": 1,
    "least": 1,
    "node_affinity": 1,
    "prefer_avoid": 10000,
    "pts": 2,
    "taint": 1,
}

_I64 = torch.int64
_F64 = torch.float64
# Counting dtype for the pod-table sweeps (PTS/IPA pair counts, match
# sums): counts are bounded by the pod-table size, so int32 holds them
# exactly, as in the reference.
_CNT = torch.int32


def _seg_sum(data: torch.Tensor, segment_ids: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def _seg_max_bool(flags: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=torch.int32, device=flags.device)
    out = out.scatter_reduce(0, segment_ids.long(), flags.to(torch.int32),
                             "amax", include_self=True)
    return out > 0


# ---------------------------------------------------------------------------
# Filters


def fit_mask(requested, pod_count, alloc, allowed_pods, req, req_check,
             req_has_any):
    """NodeResourcesFit (fit.go:230 fitsRequest): insufficient if
    request > allocatable − requested per checked dim, or pod count full."""
    free = alloc - requested
    over = (req[None, :] > free) & req_check[None, :]
    fail_dims = req_has_any & over.any(dim=1)
    fail_count = (pod_count.to(_I64) + 1) > allowed_pods
    return ~(fail_count | fail_dims)


def ports_mask(pair_any, pair_wild, triple, p: Dict):
    """NodePorts conflict mask over the given port tables (reference:
    nodeports/node_ports.go HostPortInfo: a wildcard-ip want conflicts
    with any same (proto,port); a specific-ip want conflicts with a
    wildcard holder or the exact triple)."""
    want_pair = p["want_pair"].long()
    pa = pair_any[:, want_pair] > 0     # [N, MP]
    pw = pair_wild[:, want_pair] > 0
    tr = triple[:, p["want_triple"].long()] > 0
    conflict = (torch.where(p["want_wild"][None, :], pa, pw | tr)
                & p["want_valid"][None, :])
    return ~conflict.any(dim=1)


def _filter_basics(c: Dict, p: Dict):
    """NodeName, NodeUnschedulable, TaintToleration, NodePorts,
    NodeResourcesFit masks. References: nodename/node_name.go,
    nodeunschedulable/node_unschedulable.go,
    tainttoleration/taint_toleration.go:55,
    nodeports/node_ports.go, noderesources/fit.go:230."""
    n = c["valid"].shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=c["valid"].device)
    mask_name = ~p["has_node_name"] | (idx == p["node_name_idx"])
    mask_unsched = ~(c["unschedulable"] & ~p["tolerates_unsched"])
    eff = c["taint_effect"][None, :]
    hard_taint = (eff == EFFECT_NO_SCHEDULE) | (eff == EFFECT_NO_EXECUTE)
    mask_taint = ~(c["taints"] & hard_taint & ~p["tol_ns"][None, :]).any(dim=1)
    mask_ports = ports_mask(
        c["ports_pair_any"], c["ports_pair_wild"], c["ports_triple"], p
    )
    mask_fit = fit_mask(
        c["requested"], c["pod_count"], c["alloc"], c["allowed_pods"],
        p["req"], p["req_check"], p["req_has_any"],
    )
    return mask_name, mask_unsched, mask_taint, mask_ports, mask_fit


def _node_match(c: Dict, p: Dict):
    """pod_matches_node_selector_and_affinity over all nodes (reference:
    pkg/scheduler/framework/plugins/helper/node_affinity.go:27). Shared by
    the NodeAffinity filter and both PodTopologySpread passes."""
    sel_ok = eval_reqs(
        p["nodesel_op"], p["nodesel_key"], p["nodesel_pairs"],
        c["npair"], c["nkey"],
        threshold=p["nodesel_thr"], num=c["nnum"], num_valid=c["nnum_valid"],
    )  # [N]
    term_ok = eval_reqs(
        p["aff_op"], p["aff_key"], p["aff_pairs"],
        c["npair"], c["nkey"],
        threshold=p["aff_thr"], num=c["nnum"], num_valid=c["nnum_valid"],
    )  # [N, T]
    aff_ok = (term_ok & p["aff_valid"][None, :]).any(dim=1)
    return sel_ok & torch.where(p["has_node_affinity"], aff_ok,
                                torch.ones_like(aff_ok))


def _ipa_term_matches(c: Dict, p: Dict, prefix: str):
    """Per-term match of every existing pod: selector + namespaces."""
    match_pt = eval_reqs(
        p[f"{prefix}_op"], p[f"{prefix}_rkey"], p[f"{prefix}_pairs"],
        c["ppair"], c["pkey"],
    )  # [P, T]
    return match_pt & ns_member(
        p[f"{prefix}_ns"][None, :, :], c["pns"][:, None, None]
    )


def _ipa_scatter_terms(c: Dict, match_pt, keys, valid):
    """Accumulate matches into the ONE (key,value)-keyed global map
    (topologyToMatchedTermCount is shared across terms, filtering.go:60)."""
    vnp = c["npair"].shape[1]
    pair_pt = c["pair_of_key"][c["pnode"].long()[:, None],
                               keys.long()[None, :]]  # [P, T]
    m = match_pt & c["pvalid"][:, None] & valid[None, :]
    cnt = torch.stack([
        _seg_sum(m[:, t].to(_CNT), pair_pt[:, t], vnp)
        for t in range(pair_pt.shape[1])
    ])  # [T, Vnp]
    # summed to int64, as the reference's jnp.sum of int32 counts
    out = cnt.sum(dim=0, dtype=_I64)
    out[0] = 0
    return out  # [Vnp]


def _ipa_filter_parts(c: Dict, p: Dict) -> Dict:
    """Static pieces of the InterPodAffinity Filter for one incoming pod
    against the REAL pod/term tables (filtering.go:162 existing
    anti-affinity map, :194 incoming maps)."""
    vnp = c["npair"].shape[1]
    at_src = c["at_src"].long()
    match_at = (
        eval_reqs_single(c["at_op"], c["at_rkey"], c["at_pairs"],
                         p["self_ppair"], p["self_pkey"])
        & ns_member(c["at_ns"], p["self_ns"])
        & c["at_valid"]
        & c["pvalid"][at_src]
    )  # [A]
    at_pair = c["pair_of_key"][c["pnode"].long()[at_src], c["at_key"].long()]
    existing_cnt = _seg_sum(match_at.to(_CNT), at_pair, vnp)
    existing_cnt[0] = 0
    # gather per node LABEL (pair_of_key, ~K columns) instead of sweeping
    # the whole [N, Vnp] pair matrix
    hit_per_key = (existing_cnt > 0)[c["pair_of_key"].long()] & c["nkey"]
    fail_existing = hit_per_key.any(dim=1)

    # incoming required anti-affinity (filtering.go:341
    # satisfyPodAntiAffinity): a pod matching ANY term contributes at
    # that term's topology pair
    anti_valid = p["ipaaa_valid"]
    anti_vec = _ipa_scatter_terms(
        c, _ipa_term_matches(c, p, "ipaaa"), p["ipaaa_key"], anti_valid
    )
    anti_key = p["ipaaa_key"].long()
    pair_nt = c["pair_of_key"][:, anti_key]  # [N, Taa]
    anti_key_on_node = c["nkey"][:, anti_key]
    anti_cnt_n = anti_vec[pair_nt.long()]  # [N, Taa]

    # incoming required affinity (filtering.go:357 satisfyPodAffinity): a
    # pod must match ALL terms to contribute (podMatchesAllAffinityTerms)
    aff_valid = p["ipaa_valid"]
    has_aff = aff_valid.any()
    match_all = torch.where(
        aff_valid[None, :], _ipa_term_matches(c, p, "ipaa"),
        torch.ones((), dtype=torch.bool, device=aff_valid.device),
    ).all(dim=1) & has_aff  # [P]
    aff_vec = _ipa_scatter_terms(c, match_all[:, None], p["ipaa_key"],
                                 aff_valid)
    aff_key = p["ipaa_key"].long()
    pair_na = c["pair_of_key"][:, aff_key]
    aff_cnt_n = aff_vec[pair_na.long()]  # [N, Ta]
    key_aff = c["nkey"][:, aff_key]
    aff_all_keys = torch.where(aff_valid[None, :], key_aff,
                               torch.ones_like(key_aff)).all(dim=1)
    # first-pod-in-series escape hatch (filtering.go:357): the global map
    # is empty AND the incoming pod matches its own terms
    aff_total = aff_vec.sum(dtype=_I64)
    own = (eval_reqs_single(p["ipaa_op"], p["ipaa_rkey"], p["ipaa_pairs"],
                            p["self_ppair"], p["self_pkey"])
           & ns_member(p["ipaa_ns"], p["self_ns"]))
    self_match_all = has_aff & torch.where(aff_valid, own,
                                           torch.ones_like(own)).all()
    return dict(
        fail_existing=fail_existing,
        anti_cnt_n=anti_cnt_n,
        anti_key_on_node=anti_key_on_node,
        aff_cnt_n=aff_cnt_n,
        aff_all_keys=aff_all_keys,
        aff_total=aff_total,
        self_match_all=self_match_all,
        has_aff=has_aff,
    )


def ipa_compose(p: Dict, parts: Dict):
    """Compose the InterPodAffinity mask from its static parts (the
    reference also folds in-scan count deltas; term templates are a
    later slice of the port). Returns (mask, unresolvable)."""
    anti_valid = p["ipaaa_valid"]
    fail_anti = (
        anti_valid[None, :]
        & parts["anti_key_on_node"]
        & (parts["anti_cnt_n"] > 0)
    ).any(dim=1)
    aff_valid = p["ipaa_valid"]
    have = parts["aff_cnt_n"] > 0
    pods_exist = torch.where(aff_valid[None, :], have,
                             torch.ones_like(have)).all(dim=1)
    counts_empty = parts["aff_total"] == 0
    aff_ok = ~parts["has_aff"] | (
        parts["aff_all_keys"]
        & (pods_exist | (counts_empty & parts["self_match_all"]))
    )
    mask = ~parts["fail_existing"] & ~fail_anti & aff_ok
    unresolvable = ~aff_ok  # affinity miss is UnschedulableAndUnresolvable (:374)
    return mask, unresolvable


# ---------------------------------------------------------------------------
# Scores (pre-normalization parts the prologue keeps per template)


def _score_image(c: Dict, p: Dict):
    """ImageLocality (reference: imagelocality/image_locality.go:48 Score,
    :91 sumImageScores, :118 normalizedImageName)."""
    total = torch.clamp(c["n_nodes"].to(_F64), min=1.0)
    images = p["images"].long()
    sizes = c["img_size"][:, images]  # [N, MC]
    spread = c["img_nodes"][images].to(_F64) / total  # [MC]
    contrib = (sizes.to(_F64) * spread[None, :]).to(_I64)
    sum_scores = contrib.sum(dim=1)
    max_threshold = MAX_CONTAINER_THRESHOLD * p["n_containers"].to(_I64)
    sum_scores = torch.minimum(
        torch.clamp(sum_scores, min=MIN_IMG_THRESHOLD), max_threshold)
    score = torch.div(
        MAX_NODE_SCORE * (sum_scores - MIN_IMG_THRESHOLD),
        torch.clamp(max_threshold - MIN_IMG_THRESHOLD, min=1),
        rounding_mode="floor",
    )
    return torch.where(p["n_containers"] == 0, torch.zeros_like(score), score)


def _score_prefer_avoid(c: Dict, p: Dict):
    """NodePreferAvoidPods (reference:
    nodepreferavoidpods/node_prefer_avoid_pods.go:58): 0 when the node's
    preferAvoidPods annotation names the pod's RC/RS controller."""
    avoided = c["avoid"][:, p["avoid_ctrl"].long()]
    return torch.where(avoided, 0, MAX_NODE_SCORE).to(_I64)


def _taint_count(c: Dict, p: Dict):
    """Untolerated PreferNoSchedule taints per node (pre-normalization;
    reference: tainttoleration/taint_toleration.go:107)."""
    prefer = c["taint_effect"][None, :] == EFFECT_PREFER_NO_SCHEDULE
    return (c["taints"] & prefer & ~p["tol_prefer"][None, :]).sum(
        dim=1, dtype=_I64)


def _nodeaff_count(c: Dict, p: Dict):
    """Matched preferred-term weight sum per node (pre-normalization;
    reference: nodeaffinity/node_affinity.go:139)."""
    match = eval_reqs(
        p["npref_op"], p["npref_key"], p["npref_pairs"],
        c["npair"], c["nkey"],
        threshold=p["npref_thr"], num=c["nnum"], num_valid=c["nnum_valid"],
    )  # [N, T]
    return (match.to(_I64) * p["npref_weight"][None, :]).sum(dim=1)


def _score_ipa_raw(c: Dict, p: Dict):
    """Per-node raw InterPodAffinity score + whether any term matched
    (pre-normalize; reference: interpodaffinity/scoring.go:88
    processExistingPod, :225 Score); independent of the feasible set."""
    vnp = c["npair"].shape[1]
    hard_w = c["hard_pod_affinity_weight"].to(_CNT)
    # (a) incoming preferred terms vs existing pods
    match_pt = eval_reqs(p["ipap_op"], p["ipap_rkey"], p["ipap_pairs"],
                         c["ppair"], c["pkey"])
    match_pt = (
        match_pt
        & c["pvalid"][:, None]
        & ns_member(p["ipap_ns"][None, :, :], c["pns"][:, None, None])
        & p["ipap_valid"][None, :]
    )  # [P, T]
    pair_pt = c["pair_of_key"][c["pnode"].long()[:, None],
                               p["ipap_key"].long()[None, :]]
    cnt_t = torch.stack([
        _seg_sum(match_pt[:, t].to(_CNT), pair_pt[:, t], vnp)
        for t in range(pair_pt.shape[1])
    ])  # [T, Vnp]
    cnt_t[:, 0] = 0
    score_vec = (cnt_t * p["ipap_weight"].to(_CNT)[:, None]).sum(
        dim=0, dtype=_CNT)  # [Vnp]
    present = (cnt_t > 0).any(dim=0)
    # (b) existing pods' terms vs the incoming pod
    st_weight = c["st_weight"].to(_CNT)
    w_st = torch.where(
        c["st_kind"] == ST_REQUIRED_AFFINITY,
        hard_w,
        torch.where(c["st_kind"] == ST_PREFERRED_AFFINITY, st_weight,
                    -st_weight),
    )
    st_src = c["st_src"].long()
    match_st = (
        eval_reqs_single(c["st_op"], c["st_rkey"], c["st_pairs"],
                         p["self_ppair"], p["self_pkey"])
        & ns_member(c["st_ns"], p["self_ns"])
        & c["st_valid"]
        & c["pvalid"][st_src]
        & ~((c["st_kind"] == ST_REQUIRED_AFFINITY) & (hard_w <= 0))
    )  # [S]
    st_pair = c["pair_of_key"][c["pnode"].long()[st_src], c["st_key"].long()]
    score_vec = score_vec + _seg_sum(
        torch.where(match_st, w_st, torch.zeros_like(w_st)), st_pair, vnp)
    present = present | (_seg_sum(match_st.to(_CNT), st_pair, vnp) > 0)
    present[0] = False
    score_vec[0] = 0
    # Score(): sum score_vec over the node's label pairs, gathered per
    # label via pair_of_key; pair id 0 (no label) contributes 0
    per_label = score_vec[c["pair_of_key"].long()]
    raw = torch.where(c["nkey"], per_label, torch.zeros_like(per_label)).sum(
        dim=1, dtype=_I64)
    return raw, present.any()


# ---------------------------------------------------------------------------
# Multi-pod scan steps: k pods decided per scan step with EXACT conflict
# replay. The policy knob and the utilization-side conflict algebra the
# kernel's multi-pod step mirrors (reference: kernel.py:678-758).

# the reference's TPU default (kernel.py:684)
DEFAULT_MULTIPOD_K = 4


def multipod_k(explicit=None, dyn_ports: bool = False,
               platform: str = "") -> int:
    """Resolve the multi-pod step width for a session build.

    The reference's precedence: port-carrying sessions are pinned to 1
    (the NodePorts tables are outside the conflict algebra); then an
    explicit constructor argument; then KTPU_MULTIPOD_K (=1 restores
    one-pod-per-step everywhere); then the platform default. `platform`
    is the session device's type ("cuda", "cpu"); the reference's 4
    applies to "tpu" alone. The result is clamped to a power of two
    <= 64, so every pow2 batch bucket divides into whole steps."""
    from ..utils import knobs

    if dyn_ports:
        return 1
    if explicit is not None:
        k = int(explicit)
    else:
        env = knobs.get_int("KTPU_MULTIPOD_K", default=0)
        if env:
            k = int(env)
        else:
            # 1 on CUDA until a measurement on the card says otherwise:
            # the one-block kernel evaluates a group's pods one after the
            # other, so a step of k saves no sweep (PERF.md, multi-pod steps)
            k = DEFAULT_MULTIPOD_K if platform == "tpu" else 1
    k = max(1, k)
    p = 1
    while p * 2 <= min(k, 64):
        p *= 2
    return p


def multipod_utilization_conflicts(feasible, total, best, score, lane,
                                   fit_new, wbl_old, wbl_new):
    """The utilization side of the exact multi-pod conflict test, on
    per-node rows (reference: kernel.py:724).

    With the PTS/IPA count gates clean, committing a step's earlier pods
    changed this pod's true score vector only through NodeResourcesFit /
    BalancedAllocation / LeastAllocated at the committed nodes. Against
    the current carry:

      fit_flip — a speculatively feasible node no longer fits: the
                 feasible set changed, so the normalizations did;
      overtake — a still-feasible node's refreshed total beats (or
                 first-max-ties below) the speculative winner.

    Returns (fit_flip_row, overtake_row) for the caller to reduce."""
    new_total = total + (wbl_new - wbl_old)
    fit_flip = feasible & ~fit_new
    overtake = (
        feasible & fit_new
        & ((new_total > score) | ((new_total == score) & (lane < best)))
    )
    return fit_flip, overtake
