"""Decision explainability: per-plugin attribution of scheduling decisions.

Shared machinery for three consumers:

- the ``KTPU_EXPLAIN`` harvest path (TPUBackend decodes the hoisted
  session's explain payload into per-plugin filter verdicts and weighted
  score splits, attached to level-2 trace provenance),
- the shadow parity sentinel (``KTPU_SHADOW_SAMPLE``: the completion
  worker replays sampled decisions through the oracle filter/score chain
  and diffs per plugin), and
- the triage CLIs (``scripts/explain_decision.py`` renders a decision as
  the oracle would log it; ``scripts/replay_drift.py`` re-runs a frozen
  repro bundle through both paths).

Both paths produce the same *breakdown* shape so they diff directly:

    {"filters": {node: {plugin: passed}},   # per-plugin verdicts
     "scores":  {plugin: {node: weighted}}, # feasible nodes only
     "totals":  {node: total},
     "best":    [nodes tied at max total]}

The oracle breakdown deliberately does NOT reuse
``Framework.run_filter_plugins``: that runner stops at the first failing
plugin (framework.go:530 semantics), which is correct for scheduling but
useless for attribution — a rejected node must report every plugin's
verdict so it can be diffed against the kernel's packed mask bits.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence

from ..api import types as v1
from ..api.types import pod_key
from ..utils import knobs, serde

# explain score key (kernel/hoisted stack order) -> oracle plugin name.
# Must stay in lockstep with ops.hoisted.EXPLAIN_SCORE_KEYS and the score
# sections of ops.kernel.schedule_pod.
SCORE_PLUGIN_OF = {
    "balanced": "NodeResourcesBalancedAllocation",
    "image": "ImageLocality",
    "ipa": "InterPodAffinity",
    "least": "NodeResourcesLeastAllocated",
    "node_affinity": "NodeAffinity",
    "prefer_avoid": "NodePreferAvoidPods",
    "pts": "PodTopologySpread",
    "taint": "TaintToleration",
}

BUNDLE_DIR_ENV = "KTPU_SHADOW_BUNDLE_DIR"


def bundle_dir() -> str:
    import tempfile

    return knobs.get_str(BUNDLE_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "ktpu-shadow-bundles"
    )


def _best(totals: Dict[str, int]) -> List[str]:
    if not totals:
        return []
    mx = max(totals.values())
    return [n for n, t in totals.items() if t == mx]


# ---------------------------------------------------------------------------
# oracle path


def oracle_breakdown(snapshot, pod: v1.Pod) -> Dict:
    """Replay the oracle filter/score chain read-only against ``snapshot``.

    Unlike a scheduling cycle, every filter plugin is run on every node
    (no first-failure short circuit) so rejected nodes carry full
    per-plugin verdicts; scoring then runs on the feasible set exactly as
    RunScorePlugins would (raw -> normalize -> x weight).
    """
    from .framework import interface as fwkif
    from .framework.interface import CycleState
    from .framework.runtime import Framework
    from .plugins.registry import default_plugins, new_in_tree_registry

    fwk = Framework(
        new_in_tree_registry(), plugins=default_plugins(), snapshot_fn=lambda: snapshot
    )
    state = CycleState()
    prefilter = fwk.run_pre_filter_plugins(state, pod)
    filters: Dict[str, Dict[str, bool]] = {}
    feasible: List[v1.Node] = []
    if prefilter is not None:
        # PreFilter rejected the pod outright: attribute every node to the
        # failing plugin rather than guessing per-filter verdicts.
        plugin = prefilter.failed_plugin or "PreFilter"
        for ni in snapshot.list():
            filters[ni.node.metadata.name] = {plugin: False}
    else:
        for ni in snapshot.list():
            verdicts: Dict[str, bool] = {}
            ok = True
            for pl in fwk.filter_plugins:
                passed = fwkif.is_success(pl.filter(state, pod, ni))
                verdicts[pl.name] = passed
                ok = ok and passed
            filters[ni.node.metadata.name] = verdicts
            if ok:
                feasible.append(ni.node)

    scores: Dict[str, Dict[str, int]] = {}
    totals: Dict[str, int] = {}
    if feasible:
        st = fwk.run_pre_score_plugins(state, pod, feasible)
        if st is not None:
            raise RuntimeError(f"PreScore failed during explain: {st}")
        scores_map, st = fwk.run_score_plugins(state, pod, feasible)
        if st is not None:
            raise RuntimeError(f"Score failed during explain: {st}")
        for plugin, node_scores in scores_map.items():
            scores[plugin] = {ns.name: int(ns.score) for ns in node_scores}
        for node in feasible:
            name = node.metadata.name
            totals[name] = sum(per_node[name] for per_node in scores.values())
    return {"filters": filters, "scores": scores, "totals": totals, "best": _best(totals)}


# ---------------------------------------------------------------------------
# device path


def device_breakdown(
    nodes: Sequence[v1.Node],
    pods: Sequence[v1.Pod],
    pod: v1.Pod,
    weights: Optional[Dict[str, int]] = None,
    device=None,
) -> Dict:
    """Run the fused kernel standalone (fresh encoding, one dispatch) and
    decode its per-plugin mask/score sections into a breakdown. This is the
    replay/triage path; the production harvest path decodes the session's
    explain payload instead (see ``payload_breakdown``). ``device`` is
    where the encoding and the kernel live: the card unless the caller
    names another."""
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..models.encoding import ClusterEncoding
    from ..models.pod_encoder import PodEncoder
    # ktpu: allow-inert(read-only import: schedule_pod scores a copy for attribution, no state is written)
    from ..ops.kernel import schedule_pod
    # ktpu: allow-inert(read-only import: plugin mask table consulted, never mutated)
    from .tpu_backend import MASK_PLUGINS

    device = resolve_device(device)
    enc = ClusterEncoding()
    enc.set_cluster(list(nodes), list(pods))
    enc.device_state(device)  # build arrays FIRST: encode resolves
    # tolerations (and every other vocab lookup) against the built
    # vocabularies
    pe = PodEncoder(enc)
    parrays = {k: torch.as_tensor(np.asarray(v), device=device)
               for k, v in pe.encode(pod).items() if not k.startswith("_")}
    cluster = enc.device_state(device)  # re-read: encode may grow vocab
    # capacities; the outputs come back with .cpu() (np.asarray refuses a
    # tensor on the card)
    out = {k: v.cpu().numpy()
           for k, v in schedule_pod(cluster, parrays, weights).items()}

    filters: Dict[str, Dict[str, bool]] = {}
    scores: Dict[str, Dict[str, int]] = {plugin: {} for plugin in SCORE_PLUGIN_OF.values()}
    totals: Dict[str, int] = {}
    decision = None
    decision_total = None
    for name, idx in enc.node_index.items():
        filters[name] = {plugin: bool(out[key][idx]) for key, plugin in MASK_PLUGINS}
        if bool(out["feasible"][idx]):
            for key, plugin in SCORE_PLUGIN_OF.items():
                scores[plugin][name] = int(out[f"score_{key}"][idx])
            total = int(out["total"][idx])
            totals[name] = total
            # first-max over encoding order: the device's own argmax convention
            if decision_total is None or total > decision_total:
                decision, decision_total = name, total
    return {
        "filters": filters,
        "scores": scores,
        "totals": totals,
        "best": _best(totals),
        "decision": decision,
    }


def payload_breakdown(payload: Dict, node_names: Sequence[str]) -> Dict:
    """Decode one pod's session explain payload (HoistedSession
    ``explain_payload`` entry: packed mask bits + top-k totals/score
    stacks) into the common breakdown shape. Scores cover only the top-k
    candidates — that is what the device shipped back."""
    # ktpu: allow-inert(read-only import: filter/score key tables consulted, never mutated)
    from ..ops.hoisted import EXPLAIN_FILTER_PLUGINS, EXPLAIN_SCORE_KEYS

    bits = payload["bits"]
    filters: Dict[str, Dict[str, bool]] = {}
    for i, name in enumerate(node_names):
        b = int(bits[i])
        filters[name] = {
            plugin: bool((b >> j) & 1) for j, plugin in enumerate(EXPLAIN_FILTER_PLUGINS)
        }
    scores: Dict[str, Dict[str, int]] = {
        SCORE_PLUGIN_OF[key]: {} for key in EXPLAIN_SCORE_KEYS
    }
    totals: Dict[str, int] = {}
    for j, idx in enumerate(payload["topk_idx"]):
        idx = int(idx)
        if idx < 0 or idx >= len(node_names):
            continue
        total = int(payload["topk_total"][j])
        if total < 0:  # padded/infeasible top-k slot
            continue
        name = node_names[idx]
        totals[name] = total
        for si, key in enumerate(EXPLAIN_SCORE_KEYS):
            scores[SCORE_PLUGIN_OF[key]][name] = int(payload["topk_scores"][j][si])
    return {"filters": filters, "scores": scores, "totals": totals, "best": _best(totals)}


# ---------------------------------------------------------------------------
# drift detection / diffing


def decision_drifts(oracle_bd: Dict, node: Optional[str]) -> bool:
    """True iff the device's chosen ``node`` disagrees with the oracle:
    infeasible under the oracle, or scored strictly below the oracle's
    max total (ties are fine — both sides break first-max over their own
    node order, which legitimately differs)."""
    if node is None:
        # device declined; oracle finding any feasible node is a drift
        return bool(oracle_bd["totals"])
    totals = oracle_bd["totals"]
    if node not in totals:
        return True
    return totals[node] != max(totals.values())


def drift_plugins(oracle_bd: Dict, device_bd: Optional[Dict], node: Optional[str]) -> List[str]:
    """Attribute a drift at ``node`` to plugins: filter verdicts that
    disagree there first, then weighted score components. Falls back to
    the catch-all ``decision`` label when no per-plugin signal survives
    (e.g. no device breakdown was captured)."""
    out: List[str] = []
    if device_bd is not None and node is not None:
        of = oracle_bd["filters"].get(node, {})
        df = device_bd["filters"].get(node, {})
        for plugin in sorted(set(of) & set(df)):
            if of[plugin] != df[plugin]:
                out.append(plugin)
        if not out:
            for plugin in sorted(set(oracle_bd["scores"]) | set(device_bd["scores"])):
                o = oracle_bd["scores"].get(plugin, {}).get(node)
                d = device_bd["scores"].get(plugin, {}).get(node)
                if o is not None and d is not None and o != d:
                    out.append(plugin)
    return out or ["decision"]


def attribution_diff(oracle_bd: Dict, device_bd: Dict) -> List[str]:
    """Bitwise per-plugin comparison on everything the device reported:
    filter verdicts on shared nodes and shared plugins (the oracle also
    runs volume plugins the device folds elsewhere — those are skipped),
    weighted scores on the device's top-k candidates. Returns the
    drifting plugin names, sorted; empty means clean. This is the check
    that catches a wrong weight or mask before it ever flips a decision."""
    out = set()
    for node, df in device_bd["filters"].items():
        of = oracle_bd["filters"].get(node)
        if of is None:
            continue
        for plugin, passed in df.items():
            if plugin in of and of[plugin] != passed:
                out.add(plugin)
    for plugin, per_node in device_bd["scores"].items():
        for node, score in per_node.items():
            oracle_score = oracle_bd["scores"].get(plugin, {}).get(node)
            if oracle_score is not None and oracle_score != score:
                out.add(plugin)
    return sorted(out)


def diff_table(oracle_bd: Dict, device_bd: Dict, node: str) -> str:
    """Per-plugin oracle-vs-device table at ``node`` for CLI output."""
    lines = [f"{'plugin':<40} {'oracle':>10} {'device':>10}  drift"]
    of = oracle_bd["filters"].get(node, {})
    df = device_bd["filters"].get(node, {})
    for plugin in sorted(set(of) | set(df)):
        o, d = of.get(plugin), df.get(plugin)
        mark = "  <--" if (o is not None and d is not None and o != d) else ""
        lines.append(
            f"{plugin:<40} {_verdict(o):>10} {_verdict(d):>10}{mark}"
        )
    for plugin in sorted(set(oracle_bd["scores"]) | set(device_bd["scores"])):
        o = oracle_bd["scores"].get(plugin, {}).get(node)
        d = device_bd["scores"].get(plugin, {}).get(node)
        mark = "  <--" if (o is not None and d is not None and o != d) else ""
        lines.append(
            f"{plugin + ' (score)':<40} {_num(o):>10} {_num(d):>10}{mark}"
        )
    ot = oracle_bd["totals"].get(node)
    dt = device_bd["totals"].get(node)
    mark = "  <--" if (ot is not None and dt is not None and ot != dt) else ""
    lines.append(f"{'total':<40} {_num(ot):>10} {_num(dt):>10}{mark}")
    return "\n".join(lines)


def _verdict(v) -> str:
    return "-" if v is None else ("pass" if v else "FAIL")


def _num(v) -> str:
    return "-" if v is None else str(v)


# ---------------------------------------------------------------------------
# rendering


def render_decision(bd: Dict, pod_name: str, node: Optional[str] = None, top: int = 3) -> str:
    """Render a breakdown the way the oracle scheduler would log the
    decision: feasibility summary, who rejected each infeasible node, and
    the per-plugin score split of the winner vs runners-up."""
    node = node or (bd["best"][0] if bd["best"] else None)
    lines = []
    n_total = len(bd["filters"])
    n_feasible = sum(1 for v in bd["filters"].values() if all(v.values()))
    if node is None:
        lines.append(f'pod "{pod_name}": unschedulable ({n_total} nodes, 0 feasible)')
    else:
        total = bd["totals"].get(node)
        lines.append(
            f'pod "{pod_name}": scheduled on "{node}" '
            f"(total {total}, {n_feasible}/{n_total} nodes feasible)"
        )
    rejected = {
        name: [plugin for plugin, ok in verdicts.items() if not ok]
        for name, verdicts in sorted(bd["filters"].items())
        if not all(verdicts.values())
    }
    if rejected:
        lines.append("  filtered:")
        for name, plugins in rejected.items():
            lines.append(f"    {name}: rejected by {', '.join(plugins)}")
    ranked = sorted(bd["totals"].items(), key=lambda kv: (-kv[1], kv[0]))[: max(top, 1)]
    if ranked:
        names = [name for name, _ in ranked]
        header = f"  scores ({' vs '.join(names)}):"
        lines.append(header)
        for plugin in sorted(bd["scores"]):
            row = [bd["scores"][plugin].get(name) for name in names]
            if not any(r is not None for r in row):
                continue
            cells = " ".join(f"{_num(r):>8}" for r in row)
            lines.append(f"    {plugin:<40} {cells}")
        cells = " ".join(f"{total:>8}" for _, total in ranked)
        lines.append(f"    {'total':<40} {cells}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# repro bundles


def write_bundle(
    pod: v1.Pod,
    nodes: Sequence[v1.Node],
    cluster_pods: Sequence[v1.Pod],
    node: Optional[str],
    plugins: Sequence[str],
    oracle_bd: Dict,
    device_bd: Optional[Dict] = None,
    weights: Optional[Dict[str, int]] = None,
    dir_path: Optional[str] = None,
) -> str:
    """Freeze a sentinel mismatch as a self-contained JSON bundle: the
    decision-time cluster objects (serde round-trippable), the pod, the
    device decision, and both per-plugin breakdowns. replay_drift.py
    re-runs it from scratch."""
    dir_path = dir_path or bundle_dir()
    os.makedirs(dir_path, exist_ok=True)
    payload = {
        "version": 1,
        "podKey": pod_key(pod),
        "node": node,
        "plugins": list(plugins),
        "weights": dict(weights) if weights else None,
        "pod": serde.to_dict(pod),
        "nodes": [serde.to_dict(n) for n in nodes],
        "clusterPods": [serde.to_dict(p) for p in cluster_pods],
        "oracle": oracle_bd,
        "device": device_bd,
    }
    slug = re.sub(r"[^A-Za-z0-9_.-]", "-", pod_key(pod))
    path = os.path.join(dir_path, f"shadow-drift-{slug}-{int(time.time() * 1e6):x}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    return path


def load_bundle(path: str) -> Dict:
    with open(path) as f:
        raw = json.load(f)
    raw["pod"] = serde.from_dict(v1.Pod, raw["pod"])
    raw["nodes"] = [serde.from_dict(v1.Node, n) for n in raw["nodes"]]
    raw["clusterPods"] = [serde.from_dict(v1.Pod, p) for p in raw["clusterPods"]]
    return raw
