"""Evaluation of compiled requirement tables, in torch.

Port of kubernetes_tpu/ops/eval.py. The host compiles every selector to
integer tables over interned vocabs (models/selectors.py); these
primitives evaluate them against entity matrices (nodes or pods) with
pure gathers — no string work on the device.

Semantics mirror api.labels.requirement_matches (reference:
staging/src/k8s.io/apimachinery/pkg/labels/selector.go:194 Matches):
  In            any listed (key,value) pair present
  NotIn         no listed pair present (missing key matches)
  Exists        key present
  DoesNotExist  key absent
  Gt / Lt       key present, integer-valued, compares to threshold
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.selectors import (
    OP_EXISTS,
    OP_FALSE,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_EXISTS,
    OP_NOT_IN,
)


def eval_reqs(
    op: torch.Tensor,         # [..., R] int8
    key: torch.Tensor,        # [..., R] int32
    pairs: torch.Tensor,      # [..., R, V] int32
    pair_bits: torch.Tensor,  # [E, P] bool
    key_bits: torch.Tensor,   # [E, K] bool
    threshold: Optional[torch.Tensor] = None,  # [..., R] int64
    num: Optional[torch.Tensor] = None,        # [E, K] int64
    num_valid: Optional[torch.Tensor] = None,  # [E, K] bool
) -> torch.Tensor:
    """AND over the R requirement rows -> match [E, ...].

    Column 0 of every entity matrix is the never-present sentinel, so pad
    ids (0) and unknown strings resolve to False without branching.
    """
    key = key.long()
    any_pair = pair_bits[:, pairs.long()].any(dim=-1)  # [E, ..., R]
    has_key = key_bits[:, key]                        # [E, ..., R]
    res = torch.ones_like(has_key)                    # OP_PAD -> True
    res = torch.where(op == OP_IN, any_pair, res)
    res = torch.where(op == OP_NOT_IN, ~any_pair, res)
    res = torch.where(op == OP_EXISTS, has_key, res)
    res = torch.where(op == OP_NOT_EXISTS, ~has_key, res)
    if num is not None:
        val = num[:, key]                             # [E, ..., R]
        ok = num_valid[:, key] & has_key
        res = torch.where(op == OP_GT, ok & (val > threshold), res)
        res = torch.where(op == OP_LT, ok & (val < threshold), res)
    else:
        # numeric ops over entities without numeric matrices never match
        res = torch.where((op == OP_GT) | (op == OP_LT),
                          torch.zeros_like(res), res)
    res = torch.where(op == OP_FALSE, torch.zeros_like(res), res)
    return res.all(dim=-1)                            # [E, ...]


def _bits(vec: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """vec[ids], an id past vec's end (a pair or key interned after the
    entity's bit vector was encoded) read as its last element: the
    reference's jnp gather clamps the index so, where torch raises."""
    return vec[ids.long().clamp(max=vec.shape[0] - 1)]


def eval_reqs_single(op, key, pairs, pair_vec: torch.Tensor,
                     key_vec: torch.Tensor) -> torch.Tensor:
    """Evaluate tables against ONE entity given as flat bit vectors.

    pair_vec [P] bool, key_vec [K] bool -> match [...] (table lead dims).
    Used for cluster-wide affinity term tables vs the incoming pod.
    """
    any_pair = _bits(pair_vec, pairs).any(dim=-1)  # [..., R]
    has_key = _bits(key_vec, key)                  # [..., R]
    res = torch.ones_like(has_key)
    res = torch.where(op == OP_IN, any_pair, res)
    res = torch.where(op == OP_NOT_IN, ~any_pair, res)
    res = torch.where(op == OP_EXISTS, has_key, res)
    res = torch.where(op == OP_NOT_EXISTS, ~has_key, res)
    never = (op == OP_GT) | (op == OP_LT) | (op == OP_FALSE)
    res = torch.where(never, torch.zeros_like(res), res)
    return res.all(dim=-1)


def ns_member(ns_sets: torch.Tensor, ns_id) -> torch.Tensor:
    """ns_sets [..., S] int32 (0-padded), ns_id scalar/broadcast int32 ->
    bool [...]: is ns_id in the set? Mirrors the resolved namespaces check
    of AffinityTerm.matches (reference: pkg/scheduler/framework/types.go
    PodMatchesTermsNamespaceAndSelector via util/topologies.go:40)."""
    return ((ns_sets == ns_id) & (ns_sets != 0)).any(dim=-1)
