"""Compile label selectors / node-selector terms into padded id tables.

The reference evaluates selectors string-by-string per node inside the
filter loop (labels.Selector.Matches, reference
staging/src/k8s.io/apimachinery/pkg/labels/selector.go:194;
MatchNodeSelectorTerms, pkg/apis/core/v1/helper/helpers.go). The TPU build
compiles each selector ONCE into fixed-shape integer tables over the
interned label vocabulary; the kernel evaluates it against every entity in
one gather (ops/eval.py).

Table semantics (all ids are vocab ids; 0 = never present):

  op[r]        one of the OP_* codes below; OP_PAD rows are always-true
  key[r]       label-KEY vocab id (0 -> key never present)
  pairs[r, v]  label-PAIR vocab ids for the requirement's value set
  threshold[r] int64 rhs for Gt/Lt

Row evaluation against an entity's (pair_bits, key_bits, num_val) exactly
mirrors api.labels.requirement_matches:

  In           any(pair present)
  NotIn        !any(pair present)           (missing key matches)
  Exists       key present
  DoesNotExist !key present
  Gt / Lt      key present & value parses & value >/< threshold
  OP_FALSE     never matches (nil selector, unparseable Gt/Lt rhs,
               row overflow)

A compiled selector/table carries its shape (n_reqs rows, n_vals columns);
callers pad batches of tables to common bucketed shapes (encoding.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as lbl
from ..api import types as v1
from ..api.labels import Selector
from .vocab import Interner

OP_PAD = 0  # always true (padding row)
OP_IN = 1
OP_NOT_IN = 2
OP_EXISTS = 3
OP_NOT_EXISTS = 4
OP_GT = 5
OP_LT = 6
OP_FALSE = 7  # never true

_OP_BY_NAME = {
    lbl.IN: OP_IN,
    lbl.NOT_IN: OP_NOT_IN,
    lbl.EXISTS: OP_EXISTS,
    lbl.DOES_NOT_EXIST: OP_NOT_EXISTS,
    lbl.GT: OP_GT,
    lbl.LT: OP_LT,
}

# Reserved pseudo-label key carrying a node's metadata.name so that
# NodeSelectorTerm.matchFields compiles to ordinary pair lookups
# (reference: node field selectors only support metadata.name,
# pkg/apis/core/v1/helper/helpers.go NodeSelectorRequirementsAsFieldSelector).
FIELD_NAME_KEY = "\x00field:metadata.name"


class ReqTable:
    """A conjunction of compiled requirements (one selector)."""

    __slots__ = ("op", "key", "pairs", "threshold")

    def __init__(self, op: np.ndarray, key: np.ndarray, pairs: np.ndarray, threshold: np.ndarray):
        self.op = op  # [R] int8
        self.key = key  # [R] int32
        self.pairs = pairs  # [R, V] int32
        self.threshold = threshold  # [R] int64

    @property
    def n_reqs(self) -> int:
        return int(self.op.shape[0])

    @property
    def n_vals(self) -> int:
        return int(self.pairs.shape[1])

    @classmethod
    def always(cls) -> "ReqTable":
        return cls(
            np.zeros(0, np.int8), np.zeros(0, np.int32),
            np.zeros((0, 1), np.int32), np.zeros(0, np.int64),
        )

    @classmethod
    def never(cls) -> "ReqTable":
        return cls(
            np.array([OP_FALSE], np.int8), np.zeros(1, np.int32),
            np.zeros((1, 1), np.int32), np.zeros(1, np.int64),
        )

    def padded(self, n_reqs: int, n_vals: int) -> "ReqTable":
        """Pad to [n_reqs, n_vals]; overflow degrades to OP_FALSE (never a
        silent wrong-match) — callers size buckets so overflow cannot occur."""
        r, v = self.n_reqs, self.n_vals
        if r > n_reqs:
            t = ReqTable.never()
            return t.padded(n_reqs, n_vals)
        op = np.zeros(n_reqs, np.int8)
        key = np.zeros(n_reqs, np.int32)
        pairs = np.zeros((n_reqs, n_vals), np.int32)
        thr = np.zeros(n_reqs, np.int64)
        op[:r] = self.op
        key[:r] = self.key
        if v > n_vals:
            return ReqTable.never().padded(n_reqs, n_vals)
        pairs[:r, :v] = self.pairs
        thr[:r] = self.threshold
        return ReqTable(op, key, pairs, thr)


def _compile_requirements(
    reqs: Sequence[Tuple[str, str, Optional[List[str]]]],
    key_vocab: Interner,
    pair_vocab: Interner,
    intern: bool,
) -> ReqTable:
    """Compile (key, op, values) triples. `intern=True` registers new vocab
    entries (cluster-side state); False resolves only (per-pod lookups must
    not grow the vocab mid-flight — unknown strings can never match)."""
    n = len(reqs)
    n_vals = max([len(v or []) for _, _, v in reqs], default=0)
    n_vals = max(n_vals, 1)
    op = np.zeros(n, np.int8)
    key = np.zeros(n, np.int32)
    pairs = np.zeros((n, n_vals), np.int32)
    thr = np.zeros(n, np.int64)
    for i, (k, o, values) in enumerate(reqs):
        code = _OP_BY_NAME.get(o, OP_FALSE)
        values = values or []
        if code in (OP_GT, OP_LT):
            rhs = lbl._parse_int64(values[0]) if len(values) == 1 else None
            if rhs is None:
                code = OP_FALSE
            else:
                thr[i] = rhs
        op[i] = code
        key[i] = key_vocab.intern(k) if intern else key_vocab.get(k)
        if code in (OP_IN, OP_NOT_IN):
            for j, val in enumerate(values):
                pairs[i, j] = (
                    pair_vocab.intern((k, val)) if intern else pair_vocab.get((k, val))
                )
    return ReqTable(op, key, pairs, thr)


def compile_selector(
    selector: Selector, key_vocab: Interner, pair_vocab: Interner, intern: bool = False
) -> ReqTable:
    """Compile an api.labels.Selector (conjunction) to a ReqTable."""
    if selector._matches_nothing:
        return ReqTable.never()
    if not selector.requirements:
        return ReqTable.always()
    return _compile_requirements(selector.requirements, key_vocab, pair_vocab, intern)


def compile_label_selector(
    sel: Optional[v1.LabelSelector], key_vocab: Interner, pair_vocab: Interner,
    intern: bool = False,
) -> ReqTable:
    """metav1.LabelSelector -> table (nil matches nothing)."""
    return compile_selector(Selector.from_label_selector(sel), key_vocab, pair_vocab, intern)


class TermList:
    """OR of conjunction tables (NodeSelectorTerms / affinity terms).

    valid[t] marks real terms; the reference skips terms with neither
    expressions nor fields (api.labels.match_node_selector_terms), which
    compile to valid=False here.
    """

    __slots__ = ("tables", "valid")

    def __init__(self, tables: List[ReqTable], valid: List[bool]):
        self.tables = tables
        self.valid = valid

    def stacked(self, n_terms: int, n_reqs: int, n_vals: int):
        """-> dict of stacked arrays op[T,R], key[T,R], pairs[T,R,V],
        threshold[T,R], valid[T]."""
        tabs = list(self.tables[:n_terms])
        valid = list(self.valid[:n_terms])
        if len(self.tables) > n_terms:
            # overflow: degrade extra terms to never-match but keep validity
            # semantics safe (a dropped OR-term could flip a match to a miss;
            # callers size buckets from observed maxima so this is unreachable)
            pass
        while len(tabs) < n_terms:
            tabs.append(ReqTable.never())
            valid.append(False)
        padded = [t.padded(n_reqs, n_vals) for t in tabs]
        return {
            "op": np.stack([t.op for t in padded]),
            "key": np.stack([t.key for t in padded]),
            "pairs": np.stack([t.pairs for t in padded]),
            "threshold": np.stack([t.threshold for t in padded]),
            "valid": np.array(valid, bool),
        }

    @property
    def n_terms(self) -> int:
        return len(self.tables)

    def max_shape(self) -> Tuple[int, int]:
        r = max((t.n_reqs for t in self.tables), default=0)
        v = max((t.n_vals for t in self.tables), default=1)
        return r, v


def compile_node_selector_terms(
    terms: Optional[Sequence[v1.NodeSelectorTerm]],
    key_vocab: Interner,
    pair_vocab: Interner,
    intern: bool = True,
) -> TermList:
    """NodeSelector.nodeSelectorTerms -> OR table list.

    matchFields(metadata.name) compiles against the FIELD_NAME_KEY
    pseudo-label the node encoding registers for every node.
    """
    tables: List[ReqTable] = []
    valid: List[bool] = []
    for term in terms or []:
        if not term.match_expressions and not term.match_fields:
            tables.append(ReqTable.never())
            valid.append(False)
            continue
        reqs: List[Tuple[str, str, Optional[List[str]]]] = []
        for r in term.match_expressions or []:
            reqs.append((r.key, r.operator, r.values))
        for r in term.match_fields or []:
            if r.key == "metadata.name":
                reqs.append((FIELD_NAME_KEY, r.operator, r.values))
            else:
                reqs.append(("\x00field:unknown", "__never__", None))
        tables.append(_compile_requirements(reqs, key_vocab, pair_vocab, intern=intern))
        valid.append(True)
    return TermList(tables, valid)


def compile_pod_node_constraints(
    pod: v1.Pod, key_vocab: Interner, pair_vocab: Interner
) -> Tuple[ReqTable, TermList, bool]:
    """Compile pod.spec.nodeSelector + required node affinity.

    Returns (node_selector_conjunction, affinity_terms, has_affinity).
    Mirrors api.labels.pod_matches_node_selector_and_affinity (reference:
    pkg/scheduler/framework/plugins/helper/node_affinity.go:27): the map
    selector requires exact label equality; affinity terms are OR'd.
    """
    sel_reqs: List[Tuple[str, str, Optional[List[str]]]] = []
    for k, v in sorted((pod.spec.node_selector or {}).items()):
        sel_reqs.append((k, lbl.IN, [v]))
    sel_table = (
        _compile_requirements(sel_reqs, key_vocab, pair_vocab, intern=True)
        if sel_reqs
        else ReqTable.always()
    )
    affinity = pod.spec.affinity
    required = None
    if affinity is not None and affinity.node_affinity is not None:
        required = affinity.node_affinity.required_during_scheduling_ignored_during_execution
    if required is None:
        return sel_table, TermList([], []), False
    return (
        sel_table,
        compile_node_selector_terms(required.node_selector_terms, key_vocab, pair_vocab),
        True,
    )
