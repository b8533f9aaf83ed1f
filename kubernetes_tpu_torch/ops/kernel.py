"""The scheduling plugins as dense tensor code over the cluster encoding.

Port of kubernetes_tpu/ops/kernel.py: every filter and score section,
and `schedule_pod`, which filters and scores every node for one pending
pod. The reference ran these sections as XLA programs outside any
Pallas kernel, so here they are plain torch: masked arithmetic over the
ClusterEncoding tensors, one template at a time (the reference's vmaps
over constraints and terms are loops whose outputs are stacked in the
same axis order). Every plugin of the default profile (reference:
pkg/scheduler/algorithmprovider/registry.go:71 getDefaultConfig) keeps
the reference's formula and dtypes; see the per-section docstrings for
their provenance. Scores are int64 in [0,100] x weight (interface.go:95).

Outputs of `schedule_pod` (dict):
  feasible[N]    final filter mask
  total[N]       weighted sum of normalized scores (int64), -1 where
                 infeasible
  mask_*/score_* per-plugin masks and weighted normalized scores
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
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


def _pts_filter(c: Dict, p: Dict, node_match):
    """PodTopologySpread PreFilter+Filter (reference:
    pkg/scheduler/framework/plugins/podtopologyspread/filtering.go:224
    preFilter pair registration, :313 Filter skew check)."""
    n = c["valid"].shape[0]
    vnp = c["npair"].shape[1]
    valid_c = p["ptsf_valid"]  # [C]
    any_c = valid_c.any()
    key_c = p["ptsf_key"].long()
    n_c = key_c.shape[0]
    pair_cn = c["pair_of_key"][:, key_c]  # [N, C] pair id of (key_c, value)
    key_on_node = c["nkey"][:, key_c]     # [N, C]
    has_all_keys = torch.where(valid_c[None, :], key_on_node,
                               torch.ones_like(key_on_node)).all(dim=1)
    eligible = node_match & has_all_keys & c["valid"]
    # registered topology pairs (filtering.go:224): eligible nodes only
    zeros = torch.zeros_like(pair_cn[:, 0])
    reg = torch.stack([
        _seg_max_bool(eligible, torch.where(eligible, pair_cn[:, j], zeros),
                      vnp)
        for j in range(n_c)
    ])  # [C, Vnp]
    # pods matching each constraint's selector in the incoming pod's
    # namespace
    match_pc = eval_reqs(p["ptsf_op"], p["ptsf_rkey"], p["ptsf_pairs"],
                         c["ppair"], c["pkey"])
    match_pc = (
        match_pc
        & c["pvalid"][:, None]
        & ~c["pterm"][:, None]
        & (c["pns"] == p["self_ns"])[:, None]
    )  # [P, C]
    node_counts = torch.stack([
        _seg_sum(match_pc[:, j].to(_CNT), c["pnode"], n) for j in range(n_c)
    ])  # [C, N]
    count_pair = torch.stack([
        _seg_sum(node_counts[j], pair_cn[:, j], vnp) for j in range(n_c)
    ])  # [C, Vnp]
    # TpPairToMatchNum is ONE map keyed by (key, value): constraints
    # sharing a topology key accumulate into the same entries
    # (filtering.go:246)
    same_key = ((key_c[:, None] == key_c[None, :])
                & valid_c[:, None] & valid_c[None, :])  # [C, C]
    shared_cnt = torch.where(same_key[:, :, None], count_pair[None, :, :],
                             0).sum(dim=1, dtype=_I64)  # [C, Vnp]
    col = torch.arange(vnp, device=node_match.device)[None, :]
    reg_real = reg & (col > 0)
    big = torch.iinfo(_CNT).max
    min_c = torch.where(reg_real, shared_cnt, big).min(dim=1).values
    min_c = torch.where(min_c == big, 0, min_c)  # no registered pairs -> 0
    self_match = eval_reqs_single(
        p["ptsf_op"], p["ptsf_rkey"], p["ptsf_pairs"], p["self_ppair"],
        p["self_pkey"]).to(_CNT)  # [C]
    pair_l = pair_cn.long()
    cnt_n = torch.gather(shared_cnt.T, 0, pair_l)  # [N, C] counts at node
    reg_n = torch.gather(reg_real.T, 0, pair_l)
    cnt_n = torch.where(reg_n, cnt_n, 0)
    fail_missing = (valid_c[None, :] & ~key_on_node).any(dim=1)
    skew = cnt_n + self_match[None, :] - min_c[None, :]
    fail_skew = (valid_c[None, :] & key_on_node
                 & (skew > p["ptsf_skew"][None, :].to(_CNT))).any(dim=1)
    mask = ~(any_c & (fail_missing | fail_skew))
    # missing-key failures are UnschedulableAndUnresolvable
    # (filtering.go:316)
    unresolvable = any_c & fail_missing
    return mask, unresolvable


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


def ipa_compose(p: Dict, parts: Dict, anti_dyn=0, aff_dyn=0,
                aff_total_dyn=0, fail_existing_dyn=False):
    """Compose the InterPodAffinity mask from static parts + dynamic
    in-scan count deltas (all deltas default to the pure-static case;
    the hoisted session's step passes its assumed-pod counts).
    anti_dyn/aff_dyn broadcast against [N, Taa]/[N, Ta]. Returns (mask,
    unresolvable)."""
    anti_valid = p["ipaaa_valid"]
    fail_anti = (
        anti_valid[None, :]
        & parts["anti_key_on_node"]
        & ((parts["anti_cnt_n"] + anti_dyn) > 0)
    ).any(dim=1)
    aff_valid = p["ipaa_valid"]
    have = (parts["aff_cnt_n"] + aff_dyn) > 0
    pods_exist = torch.where(aff_valid[None, :], have,
                             torch.ones_like(have)).all(dim=1)
    counts_empty = (parts["aff_total"] + aff_total_dyn) == 0
    aff_ok = ~parts["has_aff"] | (
        parts["aff_all_keys"]
        & (pods_exist | (counts_empty & parts["self_match_all"]))
    )
    mask = ~(parts["fail_existing"] | fail_existing_dyn) & ~fail_anti & aff_ok
    unresolvable = ~aff_ok  # affinity miss is UnschedulableAndUnresolvable (:374)
    return mask, unresolvable


def _ipa_filter(c: Dict, p: Dict):
    """InterPodAffinity PreFilter+Filter (reference:
    pkg/scheduler/framework/plugins/interpodaffinity/filtering.go:162
    existing anti-affinity map, :194 incoming maps, :374 Filter)."""
    return ipa_compose(p, _ipa_filter_parts(c, p))


# ---------------------------------------------------------------------------
# Scores (each returns raw-normalized int64 in [0,100] BEFORE weighting,
# or the pre-normalization part the prologue keeps per template)


def balanced_score(nz_requested, nz_req, alloc):
    """(1 - |cpuFraction - memFraction|) * 100, fractions over NonZero
    requested+pod (reference: noderesources/balanced_allocation.go:82,
    resource_allocation.go:91). Shared by schedule_pod and the hoisted
    step."""
    cpu_req = (nz_requested[:, 0] + nz_req[0]).to(_F64)
    mem_req = (nz_requested[:, 1] + nz_req[1]).to(_F64)
    cpu_cap = alloc[:, 0].to(_F64)
    mem_cap = alloc[:, 1].to(_F64)
    cpu_frac = torch.where(cpu_cap == 0, 1.0, cpu_req / cpu_cap)
    mem_frac = torch.where(mem_cap == 0, 1.0, mem_req / mem_cap)
    diff = (cpu_frac - mem_frac).abs()
    score = ((1.0 - diff) * MAX_NODE_SCORE).to(_I64)
    return torch.where((cpu_frac >= 1) | (mem_frac >= 1), 0, score)


def least_allocated_score(nz_requested, nz_req, alloc):
    """leastResourceScorer with default cpu/mem weights 1/1 (reference:
    noderesources/least_allocated.go:93,:108). Shared by schedule_pod and
    the hoisted step."""

    def one(dim):
        cap = alloc[:, dim]
        req = nz_requested[:, dim] + nz_req[dim]
        s = torch.div((cap - req) * MAX_NODE_SCORE,
                      torch.where(cap == 0, 1, cap), rounding_mode="floor")
        return torch.where((cap == 0) | (req > cap), 0, s)

    return torch.div(one(0) + one(1), 2, rounding_mode="floor")


def _score_balanced(c: Dict, p: Dict):
    return balanced_score(c["nz_requested"], p["nz_req"], c["alloc"])


def _score_least(c: Dict, p: Dict):
    return least_allocated_score(c["nz_requested"], p["nz_req"], c["alloc"])


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


def _score_taint(c: Dict, p: Dict, feasible):
    """TaintToleration: count untolerated PreferNoSchedule taints, then
    DefaultNormalizeScore reverse (reference:
    tainttoleration/taint_toleration.go:107, helper/normalize_score.go:26)."""
    return _normalize_default(_taint_count(c, p), feasible, reverse=True)


def _score_node_affinity(c: Dict, p: Dict, feasible):
    """NodeAffinity Score: sum preferred-term weights whose preference
    matches, then DefaultNormalizeScore (reference:
    nodeaffinity/node_affinity.go:139)."""
    return _normalize_default(_nodeaff_count(c, p), feasible, reverse=False)


def _normalize_default(scores, feasible, reverse: bool):
    """DefaultNormalizeScore (reference: helper/normalize_score.go:26):
    scale by the max over the feasible set; reverse subtracts from 100."""
    max_count = torch.where(feasible, scores, 0).max()
    scaled = torch.div(MAX_NODE_SCORE * scores,
                       torch.where(max_count == 0, 1, max_count),
                       rounding_mode="floor")
    if reverse:
        return torch.where(max_count == 0, MAX_NODE_SCORE,
                           MAX_NODE_SCORE - scaled)
    return torch.where(max_count == 0, scores, scaled)


@functools.lru_cache(maxsize=16)
def log_table(n: int, device: torch.device) -> torch.Tensor:
    """f64 [n + 1] with entry k = log(k + 2), as a table on `device`.

    PodTopologySpread weighs its scores by log(size + 2) in f64
    (scoring.go:279 topologyNormalizingWeight), and the argument is
    always a whole count in [0, n]. The reference's jnp.log (XLA's CPU
    f64 log) returns the correctly rounded libm value, as math.log does;
    torch's vectorized f64 log does not at every argument (it is one ulp
    off at 9168 + 2, for one), and the card's log is not that either.
    So the port reads math.log's values from a table on both devices
    (tests/test_torch_schedule_pod.py holds it to jnp.log)."""
    vals = np.array([math.log(k + 2.0) for k in range(n + 1)], np.float64)
    return torch.from_numpy(vals).to(device)


def log_plus_2(counts, n: int):
    """log(counts + 2) in f64 for whole-valued counts in [0, n], read from
    `log_table(n)` on the counts' device."""
    return log_table(n, counts.device)[counts.long()]


def _score_pts(c: Dict, p: Dict, node_match, feasible):
    """PodTopologySpread PreScore+Score+NormalizeScore (reference:
    podtopologyspread/scoring.go:221 preScore pair registration, :279
    topologyNormalizingWeight, :287 Score, :247 NormalizeScore)."""
    n = c["valid"].shape[0]
    vnp = c["npair"].shape[1]
    valid_c = p["ptss_valid"]
    any_c = valid_c.any()
    key_c = p["ptss_key"].long()
    n_c = key_c.shape[0]
    hostname = p["ptss_hostname"]
    key_on_node = c["nkey"][:, key_c]  # [N, C]
    has_all = torch.where(valid_c[None, :], key_on_node,
                          torch.ones_like(key_on_node)).all(dim=1)
    ignored = feasible & ~has_all  # scoring.go:233 ignored filtered nodes
    scored = feasible & has_all
    pair_cn = c["pair_of_key"][:, key_c]  # [N, C]
    # pair registration over filtered nodes (non-hostname constraints)
    zeros = torch.zeros_like(pair_cn[:, 0])
    reg = torch.stack([
        _seg_max_bool(scored, torch.where(scored, pair_cn[:, j], zeros), vnp)
        for j in range(n_c)
    ])  # [C, Vnp]
    col = torch.arange(vnp, device=feasible.device)[None, :]
    reg_real = reg & (col > 0) & ~hostname[:, None] & valid_c[:, None]
    # duplicate-key constraints register no pairs of their own -> size 0
    # (pair_counts is one (key,value)-keyed map, scoring.go:221-240)
    topo_size = torch.where(p["ptss_first"], reg_real.sum(dim=1),
                            0).to(_F64)
    n_scored = scored.sum().to(_F64)
    weight = log_plus_2(torch.where(hostname, n_scored, topo_size),
                        max(n, vnp))  # [C]
    # pod counts per pair over ALL nodes passing nodeSelector/affinity+keys
    match_pc = eval_reqs(p["ptss_op"], p["ptss_rkey"], p["ptss_pairs"],
                         c["ppair"], c["pkey"])
    match_pc = (
        match_pc
        & c["pvalid"][:, None]
        & ~c["pterm"][:, None]
        & (c["pns"] == p["self_ns"])[:, None]
    )  # [P, C]
    node_counts = torch.stack([
        _seg_sum(match_pc[:, j].to(_CNT), c["pnode"], n) for j in range(n_c)
    ])  # [C, N]
    src = (node_match & has_all & c["valid"]).to(_CNT)  # scoring.go:252
    count_pair = torch.stack([
        _seg_sum(node_counts[j] * src, pair_cn[:, j], vnp)
        for j in range(n_c)
    ])  # [C, Vnp]
    # one shared (key,value)-keyed map across same-key constraints
    same_key = ((key_c[:, None] == key_c[None, :])
                & valid_c[:, None] & valid_c[None, :])
    shared_cnt = torch.where(same_key[:, :, None], count_pair[None, :, :],
                             0).sum(dim=1, dtype=_I64)  # [C, Vnp]
    pair_l = pair_cn.long()
    cnt_n = torch.gather(shared_cnt.T, 0, pair_l)  # [N, C]
    reg_n = torch.gather(reg_real.T, 0, pair_l)
    cnt_n = torch.where(reg_n, cnt_n, 0)
    cnt_n = torch.where(hostname[None, :], node_counts.T.to(_I64), cnt_n)
    raw = pts_raw(valid_c[None, :] & key_on_node, cnt_n, weight,
                  p["ptss_skew"])
    return pts_normalize(raw, scored, ignored, any_c)


def pts_raw(on, cnt_n, weight, skew):
    """Per-node raw PTS score (scoring.go:287 Score): the sum over
    constraints of count * weight + (maxSkew - 1) where the constraint
    applies, truncated to int64. The f64 terms are added left to right
    from 0.0, the order of the reference's reduction."""
    terms = torch.where(
        on,
        cnt_n.to(_F64) * weight[None, :] + (skew[None, :].to(_F64) - 1.0),
        0.0,
    )  # [N, C]
    acc = torch.zeros(terms.shape[0], dtype=_F64, device=terms.device)
    for j in range(terms.shape[1]):
        acc = acc + terms[:, j]
    return acc.to(_I64)  # int(score) truncation


def pts_normalize(raw, scored, ignored, any_c):
    """PTS NormalizeScore (scoring.go:247) over the scored set."""
    big = torch.iinfo(torch.int64).max
    min_s = torch.where(scored, raw, big).min()
    max_s = torch.where(scored, raw, 0).max()
    min_s = torch.where(min_s == big, 0, min_s)
    norm = torch.div(MAX_NODE_SCORE * (max_s + min_s - raw),
                     torch.where(max_s == 0, 1, max_s), rounding_mode="floor")
    norm = torch.where(max_s == 0, MAX_NODE_SCORE, norm)
    norm = torch.where(ignored, 0, norm)
    return torch.where(any_c, norm, 0)


def _score_ipa(c: Dict, p: Dict, feasible):
    """InterPodAffinity PreScore+Score+NormalizeScore (reference:
    interpodaffinity/scoring.go:88 processExistingPod, :225 Score, :247
    NormalizeScore)."""
    raw, any_present = _score_ipa_raw(c, p)
    return _score_ipa_normalize(raw, any_present, feasible)


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


def _score_ipa_normalize(raw, any_present, feasible):
    """IPA NormalizeScore (scoring.go:247): (raw - min) / (max - min) over
    the feasible set, in f64, truncated."""
    big = torch.iinfo(_CNT).max
    min_s = torch.where(feasible, raw, big).min()
    max_s = torch.where(feasible, raw, -big).max()
    diff = (max_s - min_s).to(_F64)
    norm = torch.where(
        diff > 0,
        (MAX_NODE_SCORE * ((raw - min_s).to(_F64)
                           / torch.where(diff > 0, diff, 1.0))).to(_I64),
        0,
    )
    return torch.where(any_present, norm, 0)


# ---------------------------------------------------------------------------


def schedule_pod(c: Dict, p: Dict, weights: Dict[str, int] = None) -> Dict:
    """Filter + score every node for one pending pod (the reference's
    schedule_pod, and its schedule_pod_jit: eager torch needs no
    separate compiled entry). Pure."""
    w = weights or DEFAULT_WEIGHTS
    with torch.no_grad():
        mask_name, mask_unsched, mask_taint, mask_ports, mask_fit = \
            _filter_basics(c, p)
        node_match = _node_match(c, p)
        mask_pts, pts_unresolvable = _pts_filter(c, p, node_match)
        mask_ipa, ipa_unresolvable = _ipa_filter(c, p)
        feasible = (
            c["valid"]
            & mask_name
            & mask_unsched
            & mask_taint
            & mask_ports
            & mask_fit
            & node_match
            & mask_pts
            & mask_ipa
        )
        out = {
            "feasible": feasible,
            "mask_name": mask_name,
            "mask_unsched": mask_unsched,
            "mask_taint": mask_taint,
            "mask_ports": mask_ports,
            "mask_fit": mask_fit,
            "mask_node_affinity": node_match,
            "mask_pts": mask_pts,
            "pts_unresolvable": pts_unresolvable,
            "mask_ipa": mask_ipa,
            "ipa_unresolvable": ipa_unresolvable,
        }
        scores = {
            "balanced": _score_balanced(c, p),
            "least": _score_least(c, p),
            "image": _score_image(c, p),
            "prefer_avoid": _score_prefer_avoid(c, p),
            "taint": _score_taint(c, p, feasible),
            "node_affinity": _score_node_affinity(c, p, feasible),
            "pts": _score_pts(c, p, node_match, feasible),
            "ipa": _score_ipa(c, p, feasible),
        }
        total = torch.zeros_like(scores["balanced"])
        for name, s in scores.items():
            weighted = s * w[name]
            out[f"score_{name}"] = weighted
            total = total + weighted
        out["total"] = torch.where(feasible, total, -1)
    return out


def schedule_pods(c: Dict, P: Dict, weights: Dict[str, int] = None) -> Dict:
    """Batched independent evaluation (the reference's schedule_pods_jit,
    a vmap over pods): every pod of the stacked arrays P ([B, ...] rows)
    against the SAME cluster state, each output stacked over a leading
    pod axis. A loop over pods here."""
    b = next(iter(P.values())).shape[0]
    outs = [schedule_pod(c, {k: v[i] for k, v in P.items()}, weights)
            for i in range(b)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


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
