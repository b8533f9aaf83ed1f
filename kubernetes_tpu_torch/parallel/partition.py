"""Declarative node-axis placement: regex-on-leaf-path -> PartitionSpec.

Port of kubernetes_tpu/parallel/partition.py. Every node-sharded array
of the mesh path gets its placement from a rule table, not per-key
wiring: flatten the tree with key paths, join each path into a
`/`-separated name, and take the first regex rule that matches. Scalars
and one-element leaves short-circuit to replicated. An unmatched leaf is
an ERROR, not a default — new state must name its placement (one line in
a rule table) or construction fails loudly.

Two rule tables live here, with the reference's names and contents:

- `CLUSTER_PARTITION_RULES` — the ClusterEncoding cluster dict: node rows
  (dim 0 = node axis) sharded, pod/term/vocab state replicated.
- `SESSION_PARTITION_RULES` — the sharded session's grouped tree
  (`statics/`, `tables/`, `carry/`, `delta/`, `xs/`): per-node statics
  and carries split along their node axis, score tables and batch rows
  replicated. The port's session keeps its zone ids as `statics/zid`
  (the compact form of the reference's one-hots), a per-node row.

What a placement means here: torch has no GSPMD and no named-axis
program. A mesh (parallel/sharded.py `Mesh`) is held by ONE process and
is a list of groups, each a torch device and the node-axis shards it
holds. `shard_tree` turns a tree into one tree per group: a node-axis
leaf is cut to the group's contiguous lane range (its shards' lanes, in
shard order) and put on the group's device; a replicated leaf is put on
each group's device once. `shard_map_compat` maps a per-group function
over the groups, one thread each, and `psum` / `pmax` / `pmin` inside it
reduce over the node axis in shard order on the mesh's lead device.
"""

from __future__ import annotations

import re
import threading
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

NODE_AXIS = "nodes"


class PartitionSpec(tuple):
    """Per-dimension axis names of one leaf (None: not split), as
    jax.sharding.PartitionSpec: `P()` replicated, `P(NODE_AXIS)` split
    on dim 0, `P(None, NODE_AXIS)` split on dim 1."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def node_dim(self):
        """Index of the node-axis dimension, or None when replicated."""
        return self.index(NODE_AXIS) if NODE_AXIS in self else None


P = PartitionSpec


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) or isinstance(x, P)


def tree_paths(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) pairs of a tree of dicts / lists / tuples, in
    insertion (dict) and index (sequence) order."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out.extend(tree_paths(v, prefix + (k,)))
    return out


def tree_path_to_string(path: Tuple, sep: str = "/") -> str:
    """Join a key path into a readable `/`-separated name."""
    return sep.join(str(k) for k in path)


def named_tree_map(f: Callable, tree: Any, *rest, sep: str = "/",
                   _path: Tuple = ()) -> Any:
    """Tree map where `f` receives (path-name, leaf, *rest-leaves)."""
    if _is_leaf(tree):
        return f(tree_path_to_string(_path, sep=sep), tree, *rest)
    if isinstance(tree, dict):
        return {k: named_tree_map(f, v, *(r[k] for r in rest), sep=sep,
                                  _path=_path + (k,))
                for k, v in tree.items()}
    out = [named_tree_map(f, v, *(r[i] for r in rest), sep=sep,
                          _path=_path + (i,))
           for i, v in enumerate(tree)]
    return type(tree)(out)


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def match_partition_rules(rules: List[Tuple[str, P]], tree: Any,
                          sep: str = "/") -> Any:
    """PartitionSpec tree for `tree`: the first rule whose regex matches
    the leaf's path name wins; 0-d / 1-element leaves are replicated
    without consulting the rules; a leaf no rule covers raises
    ValueError (new state MUST declare its placement)."""

    def get_partition_spec(name, leaf):
        shape = _shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()
        for rule, ps in rules:
            if re.search(rule, name) is not None:
                return ps
        raise ValueError(f"partition rule not found for leaf: {name}")

    return named_tree_map(get_partition_spec, tree, sep=sep)


def _to_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def place_leaf(x, spec: P, mesh) -> List[torch.Tensor]:
    """One leaf placed on the mesh: per group, its lane range along the
    spec's node dimension (a contiguous copy) or, replicated, the whole
    leaf, on the group's device; one upload per device for a replicated
    leaf. The node dimension must divide into the mesh's shards."""
    dim = spec.node_dim() if isinstance(spec, P) else None
    if dim is None:
        per_dev: Dict[str, torch.Tensor] = {}
        out = []
        for g in mesh.groups:
            key = str(g.device)
            if key not in per_dev:
                per_dev[key] = _to_tensor(x, g.device)
            out.append(per_dev[key])
        return out
    n = _shape(x)[dim]
    if n % mesh.nsh:
        raise ValueError(
            f"node axis of {n} lanes does not divide into {mesh.nsh} shards")
    npl = n // mesh.nsh
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    # a copy for every group: the caller's arrays (host mirrors) move on
    # their own
    return [t.narrow(dim, g.s0 * npl, g.k * npl).to(g.device, copy=True)
            .contiguous() for g in mesh.groups]


def shard_tree(tree: Any, rules: List[Tuple[str, P]], mesh) -> List[Any]:
    """Match + place in one call: one tree per group of `mesh`, every
    leaf placed under its matched spec (`place_leaf`)."""
    specs = match_partition_rules(rules, tree)
    placed = named_tree_map(lambda _n, x, s: place_leaf(x, s, mesh),
                            tree, specs)

    def pick(node, gi):
        if isinstance(node, list) and (not node
                                       or isinstance(node[0], torch.Tensor)):
            return node[gi]
        if isinstance(node, dict):
            return {k: pick(v, gi) for k, v in node.items()}
        return type(node)(pick(v, gi) for v in node)

    return [pick(placed, gi) for gi in range(len(mesh.groups))]


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# ClusterEncoding cluster dict: arrays whose dim 0 is the node axis. The
# name list mirrors ClusterEncoding._NODE_ROW_KEYS; everything else (pod
# rows, term tables, vocab-indexed vectors, scalars) replicates.
_CLUSTER_NODE_KEYS = (
    "valid", "alloc", "requested", "nz_requested", "pod_count",
    "allowed_pods", "unschedulable", "taints", "ports_triple",
    "ports_pair_any", "ports_pair_wild", "npair", "nkey", "pair_of_key",
    "nnum", "nnum_valid", "img_size", "avoid",
)

CLUSTER_PARTITION_RULES: List[Tuple[str, P]] = [
    (r"^(%s)$" % "|".join(_CLUSTER_NODE_KEYS), P(NODE_AXIS)),
    (r".*", P()),
]

# ShardedScanSession grouped tree. Node-axis positions mirror the session
# layouts: carries and most statics are [rows, N]; the stat / IPA blocks
# are template-major [T, rows, N]; the reference's onehot is [K, N, VZ].
SESSION_PARTITION_RULES: List[Tuple[str, P]] = [
    # carries: requested/nzpc/cnt_fn/cnt_sn [rows, N]; ucnt [UR, N];
    # kcnt [UR, nsh] keeps one per-shard partial column per shard
    (r"^carry/", P(None, NODE_AXIS)),
    # template-major static blocks, node axis last
    (r"^statics/(stat|ipa_stat|anti_static|anti_konn|aff_static)$",
     P(None, None, NODE_AXIS)),
    # zone one-hots [K, N, VZ]
    (r"^statics/onehot$", P(None, NODE_AXIS, None)),
    # replicated zone-validity rows [TCp, VZ] — vocab space, not nodes
    (r"^statics/zvalid_s_rows$", P()),
    # per-node row statics [rows, N]
    (r"^statics/(alloc|regrow_f|zvalid_node_s|konn_f|konn_s|shasall"
     r"|valid_n|prow_f|prow_s|prow_ipa|zid)$", P(None, NODE_AXIS)),
    # delta statics: src factor rows are per-node, perno flags replicate
    (r"^delta/src_rows$", P(None, NODE_AXIS)),
    (r"^delta/", P()),
    # score/meta tables and batch rows replicate
    (r"^tables/", P()),
    (r"^xs/", P()),
]


def session_specs(group: str, tree: Dict) -> Dict:
    """Spec dict for one session group ('statics'/'tables'/'carry'/
    'delta'/'xs')."""
    return match_partition_rules(SESSION_PARTITION_RULES,
                                 {group: tree})[group]


# ---------------------------------------------------------------------------
# shard_map: a per-group function mapped over the mesh's groups, with
# node-axis collectives
# ---------------------------------------------------------------------------

_AXIS = threading.local()


class _AxisContext:
    """The collectives of one shard_map call: every group's thread posts
    its partial, the last to arrive reduces them in group (= shard)
    order on the lead device, and each thread takes the result back to
    its own device."""

    def __init__(self, mesh):
        self.mesh = mesh
        n = len(mesh.groups)
        self.barrier = threading.Barrier(n)
        self.slots: List[Any] = [None] * n
        self.result = None

    def reduce(self, gi: int, v: torch.Tensor, op: Callable):
        self.slots[gi] = v
        if self.barrier.wait() == 0:
            lead = self.mesh.lead
            acc = self.slots[0].to(lead)
            for p in self.slots[1:]:
                acc = op(acc, p.to(lead))
            self.result = acc
        self.barrier.wait()
        out = self.result.to(v.device)
        self.barrier.wait()
        return out


def _collective(v, op: Callable, local: Callable):
    ctx = getattr(_AXIS, "ctx", None)
    if ctx is None:
        raise RuntimeError("node-axis collective outside shard_map_compat")
    return ctx[0].reduce(ctx[1], local(v), op)


def axis_index() -> int:
    """Index of the first shard of the calling group (inside
    shard_map_compat)."""
    ctx = getattr(_AXIS, "ctx", None)
    if ctx is None:
        raise RuntimeError("axis_index outside shard_map_compat")
    return ctx[0].mesh.groups[ctx[1]].s0


def psum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis of a per-group partial."""
    return _collective(v, torch.add, lambda x: x)


def pmax(v: torch.Tensor) -> torch.Tensor:
    return _collective(v, torch.maximum, lambda x: x)


def pmin(v: torch.Tensor) -> torch.Tensor:
    return _collective(v, torch.minimum, lambda x: x)


def shard_map_compat(f, mesh, in_specs, out_specs):
    """Map `f` over the mesh's groups: the returned function takes whole
    (unsharded) arguments, places each under its spec in `in_specs`
    (`place_leaf`), and calls `f` once per group, each in its own thread,
    on that group's pieces; `psum` / `pmax` / `pmin` inside `f` reduce
    over the node axis. An output spec `P()` takes the lead group's
    result (every group holds the same value after a collective); a
    node-axis spec concatenates the groups' pieces along that axis on the
    lead device."""

    def mapped(*args):
        pieces = [place_leaf(a, s, mesh) for a, s in zip(args, in_specs)]
        ctx = _AxisContext(mesh)
        outs: List[Any] = [None] * len(mesh.groups)
        errors: List[BaseException] = []

        def run(gi):
            _AXIS.ctx = (ctx, gi)
            try:
                outs[gi] = f(*(p[gi] for p in pieces))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                ctx.barrier.abort()
            finally:
                _AXIS.ctx = None

        threads = [threading.Thread(target=run, args=(gi,))
                   for gi in range(len(mesh.groups))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        single = isinstance(out_specs, P)
        specs = [out_specs] if single else list(out_specs)
        per_out = [[o] if single else list(o) for o in outs]
        result = []
        for j, spec in enumerate(specs):
            dim = spec.node_dim()
            if dim is None:
                result.append(per_out[0][j])
            else:
                result.append(torch.cat(
                    [per_out[gi][j].to(mesh.lead)
                     for gi in range(len(mesh.groups))], dim=dim))
        return result[0] if single else tuple(result)

    return mapped
