"""Encode one pending pod into the fixed-shape kernel inputs.

The reference runs per-pod PreFilter plugins to precompute CycleState
(reference: pkg/scheduler/framework/runtime/framework.go:426
RunPreFilterPlugins); this module is that precompute for the TPU path —
requirement tables, tolerated-taint bitmaps, and resource vectors whose
shapes are bucketed so identical pods hit the same compiled kernel.

Encodings are cached by spec fingerprint: benchmark workloads (reference:
test/integration/scheduler_perf/config/performance-config.yaml) create
thousands of pods from one template, so the per-pod host cost amortizes to
a dict lookup.
"""

from __future__ import annotations

import json

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import types as v1
from ..utils import serde
from ..api.labels import Selector
from ..api.taints import (
    TAINT_EFFECT_NO_EXECUTE,
    TAINT_EFFECT_NO_SCHEDULE,
    TAINT_EFFECT_PREFER_NO_SCHEDULE,
    toleration_tolerates_taint,
    tolerations_tolerate_taint,
)
from ..scheduler.framework.types import PodInfo, calculate_resource
from ..scheduler.plugins.nodebasic import get_container_ports, normalized_image_name
from ..scheduler.plugins.noderesources import calculate_pod_resource_request
from ..scheduler.plugins.podtopologyspread import (
    DO_NOT_SCHEDULE,
    SCHEDULE_ANYWAY,
    filter_constraints,
)
from .encoding import ClusterEncoding, _fingerprint, _is_wildcard
from .selectors import ReqTable, compile_pod_node_constraints, compile_selector
from .vocab import bucket_capacity


def _stack_tables(tables: List[ReqTable], min_terms: int = 1) -> Dict[str, np.ndarray]:
    """Stack per-term ReqTables into [T, R, V] arrays with bucketed shapes."""
    n_t = bucket_capacity(max(len(tables), 1), minimum=min_terms)
    n_r = bucket_capacity(max([t.n_reqs for t in tables], default=0) or 1, minimum=2)
    n_v = bucket_capacity(max([t.n_vals for t in tables], default=1), minimum=2)
    padded = [t.padded(n_r, n_v) for t in tables]
    while len(padded) < n_t:
        padded.append(ReqTable.never().padded(n_r, n_v))
    return {
        "op": np.stack([t.op for t in padded]),
        "key": np.stack([t.key for t in padded]),
        "pairs": np.stack([t.pairs for t in padded]),
        "threshold": np.stack([t.threshold for t in padded]),
    }


class PodEncoder:
    """Compiles pending pods against a ClusterEncoding's vocabularies."""

    def __init__(
        self,
        enc: ClusterEncoding,
        ignored_resources: Optional[set] = None,
        ignored_resource_groups: Optional[set] = None,
        default_constraints: Optional[List[v1.TopologySpreadConstraint]] = None,
    ):
        self.enc = enc
        self.ignored_resources = ignored_resources or set()
        self.ignored_resource_groups = ignored_resource_groups or set()
        self.default_constraints = default_constraints or []
        self._cache: Dict[str, dict] = {}
        # volume device path (scheduler/volume_device.py): resolves a
        # bound-PVC pod's volume constraints into extra node-affinity
        # term groups + attach-count scalars. None = PVC pods never
        # reach this encoder (the oracle diversion).
        self.volume_resolver = None

    def encode(self, pod: v1.Pod) -> dict:
        # PVC-bearing pods: the kernel inputs depend on volumes ONLY
        # through the RESOLUTION (term groups + attach scalars), so the
        # cache key embeds that and drops the volumes section — 5000
        # PV pods with 5000 distinct claim names in the same zone share
        # ONE encode instead of missing per pod (the per-pod ~2ms
        # re-encode was SchedulingInTreePVs-5000n's dominant host cost)
        vol = None
        vol_sig = None
        if self.volume_resolver is not None and any(
            (v.source or {}).get("persistentVolumeClaim")
            for v in pod.spec.volumes or []
        ):
            vol = self.volume_resolver.resolve(pod)
            if vol is not None:
                vol_sig = json.dumps(
                    [[serde.to_dict(t) for t in g] for g in vol.term_groups],
                    sort_keys=True, default=str,
                ) + "|" + json.dumps(sorted(vol.extra_scalars.items()))
        fp = (
            _fingerprint(pod, strip_volumes=True) + "#V" + vol_sig
            if vol_sig is not None else _fingerprint(pod)
        )
        cached = self._cache.get(fp)
        if (
            cached is not None
            and cached["_caps"] == self._caps_signature()
            and cached["_volver"] in (None, self._vol_version())
        ):
            out = dict(cached)
            # node-name index depends on current node table, not the spec
            out["node_name_idx"], out["has_node_name"] = self._node_name(pod)
            return out
        arrays = self._encode(pod, vol=vol, have_vol=vol_sig is not None)
        arrays["_caps"] = self._caps_signature()
        self._cache[fp] = arrays
        out = dict(arrays)
        out["node_name_idx"], out["has_node_name"] = self._node_name(pod)
        return out

    def _vol_version(self):
        return (
            self.volume_resolver.version
            if self.volume_resolver is not None else None
        )

    def _caps_signature(self) -> tuple:
        e = self.enc
        return (
            e._res_width(), e.taint_vocab.capacity, e.pod_key_vocab.capacity,
            e.pod_pair_vocab.capacity,
        )

    def _node_name(self, pod: v1.Pod) -> Tuple[np.ndarray, np.ndarray]:
        if not pod.spec.node_name:
            return np.array(-1, np.int32), np.array(False)
        idx = self.enc.node_index.get(pod.spec.node_name, -9)
        return np.array(idx, np.int32), np.array(True)

    # ------------------------------------------------------------------

    def _encode(self, pod: v1.Pod, vol=None, have_vol: bool = False) -> dict:
        enc = self.enc
        enc._intern_pod_vocabs(pod)
        pod_info = PodInfo(pod)
        out: dict = {}

        # volume device path: resolve bound-PVC constraints FIRST so the
        # attach-limit scalar names intern before the resource width is
        # captured (a new driver widens the resource rows; device_state's
        # _caps_grew rebuild aligns the cluster side). encode() may have
        # resolved already (have_vol) — the resolution is part of its
        # cache key.
        out["_volver"] = None
        if self.volume_resolver is not None and any(
            (v.source or {}).get("persistentVolumeClaim")
            for v in pod.spec.volumes or []
        ):
            out["_volver"] = self._vol_version()
            if not have_vol:
                vol = self.volume_resolver.resolve(pod)
            if vol is None and not pod.spec.node_name:
                # the scheduler gated this pod kernel-safe, but the
                # resolution changed before encode (a PVC/assume event
                # raced the cycle). Encoding WITHOUT the volume
                # constraints would let the kernel violate the PV's node
                # affinity — fail the attempt instead; the retry
                # re-gates. (Bound pods are pinned by NodeName; encoding
                # them without volume constraints is safe.)
                from ..scheduler.volume_device import (
                    VolumeResolutionChanged,
                )

                raise VolumeResolutionChanged(
                    f"volume resolution changed for "
                    f"{pod.metadata.namespace}/{pod.metadata.name}"
                )
            if vol is not None:
                for name in vol.extra_scalars:
                    enc.scalar_vocab.intern(name)

        # -- NodeResourcesFit (fit.go:148 computePodResourceRequest) -------
        res, _, _ = calculate_resource(pod)
        rw = enc._res_width()
        req = np.zeros(rw, np.int64)
        req[0] = res.milli_cpu
        req[1] = res.memory
        req[2] = res.ephemeral_storage
        # dimensions fitsRequest checks (fit.go:230): cpu/mem/eph always,
        # scalar dims only when the pod requests them and they aren't ignored
        check = np.zeros(rw, bool)
        check[0:3] = True
        for name, val in res.scalar_resources.items():
            s = enc.scalar_vocab.intern(name)
            req[2 + s] = val
            ignored = name in self.ignored_resources or (
                "/" in name and name.split("/", 1)[0] in self.ignored_resource_groups
            )
            check[2 + s] = not ignored
        if vol is not None:
            # attach limits ride the resource-fit mask as scalar dims
            # (nodevolumelimits/csi.go -> attachable-volumes-csi-<drv>)
            for name, val in vol.extra_scalars.items():
                s = enc.scalar_vocab.intern(name)
                req[2 + s] += val
                check[2 + s] = True
        out["req"] = req
        out["req_check"] = check
        out["req_has_any"] = np.array(
            res.milli_cpu != 0 or res.memory != 0 or res.ephemeral_storage != 0
            or bool(res.scalar_resources)
            or bool(vol is not None and vol.extra_scalars)
        )
        out["nz_req"] = np.array(
            [
                calculate_pod_resource_request(pod, v1.RESOURCE_CPU),
                calculate_pod_resource_request(pod, v1.RESOURCE_MEMORY),
            ],
            np.int64,
        )

        # -- taints (tainttoleration + nodeunschedulable) ------------------
        tcap = enc.taint_vocab.capacity
        tol_ns = np.zeros(tcap, bool)
        tol_prefer = np.zeros(tcap, bool)
        prefer_tolerations = [
            t for t in pod.spec.tolerations or []
            if not t.effect or t.effect == TAINT_EFFECT_PREFER_NO_SCHEDULE
        ]
        for tid, (key, value, effect) in enumerate(enc.taint_vocab._items, start=1):
            taint = v1.Taint(key=key, value=value, effect=effect)
            tol_ns[tid] = tolerations_tolerate_taint(pod.spec.tolerations, taint)
            tol_prefer[tid] = tolerations_tolerate_taint(prefer_tolerations, taint)
        out["tol_ns"] = tol_ns
        out["tol_prefer"] = tol_prefer
        out["tolerates_unsched"] = np.array(
            tolerations_tolerate_taint(
                pod.spec.tolerations,
                v1.Taint(key=v1.TAINT_NODE_UNSCHEDULABLE, effect=TAINT_EFFECT_NO_SCHEDULE),
            )
        )

        # -- ports (node_ports.go:60 getContainerPorts) --------------------
        want = get_container_ports(pod)
        mp = bucket_capacity(max(len(want), 1), minimum=2)
        want_pair = np.zeros(mp, np.int32)
        want_triple = np.zeros(mp, np.int32)
        want_wild = np.zeros(mp, bool)
        want_valid = np.zeros(mp, bool)
        for i, port in enumerate(want):
            proto = port.protocol or "TCP"
            ip = "" if _is_wildcard(port.host_ip) else port.host_ip
            want_pair[i] = enc.port_pair_vocab.intern((proto, port.host_port))
            want_triple[i] = enc.port_triple_vocab.intern((ip, proto, port.host_port))
            want_wild[i] = ip == ""
            want_valid[i] = True
        out.update(
            want_pair=want_pair, want_triple=want_triple,
            want_wild=want_wild, want_valid=want_valid,
        )

        # -- node selector + required node affinity ------------------------
        sel_table, aff_terms, has_aff = compile_pod_node_constraints(
            pod, enc.node_key_vocab, enc.node_pair_vocab
        )
        if vol is not None and vol.term_groups:
            # bound-PV constraints (PV nodeAffinity + VolumeZone) join
            # the pod's required node affinity by term distribution —
            # mask_node_affinity then enforces them on-device
            from ..scheduler.volume_device import (
                _own_affinity_terms,
                distribute_term_groups,
            )
            from .selectors import compile_node_selector_terms

            combined = distribute_term_groups(
                _own_affinity_terms(pod), vol.term_groups
            )
            aff_terms = compile_node_selector_terms(
                combined, enc.node_key_vocab, enc.node_pair_vocab
            )
            has_aff = True
        nr = bucket_capacity(max(sel_table.n_reqs, 1), minimum=2)
        nv = bucket_capacity(max(sel_table.n_vals, 1), minimum=2)
        sel = sel_table.padded(nr, nv)
        out["nodesel_op"] = sel.op
        out["nodesel_key"] = sel.key
        out["nodesel_pairs"] = sel.pairs
        out["nodesel_thr"] = sel.threshold
        tr, tv = aff_terms.max_shape()
        stacked = aff_terms.stacked(
            bucket_capacity(max(aff_terms.n_terms, 1), minimum=2),
            bucket_capacity(max(tr, 1), minimum=2),
            bucket_capacity(max(tv, 1), minimum=2),
        )
        out["aff_op"] = stacked["op"]
        out["aff_key"] = stacked["key"]
        out["aff_pairs"] = stacked["pairs"]
        out["aff_thr"] = stacked["threshold"]
        out["aff_valid"] = stacked["valid"]
        out["has_node_affinity"] = np.array(has_aff)

        # -- preferred node affinity (nodeaffinity.go:139 Score) ----------
        pref = []
        a = pod.spec.affinity
        if a is not None and a.node_affinity is not None:
            pref = a.node_affinity.preferred_during_scheduling_ignored_during_execution or []
        pref_tables = []
        pref_weights = []
        for term in pref:
            if term.weight == 0:
                continue
            from .selectors import compile_node_selector_terms

            tl = compile_node_selector_terms([term.preference], enc.node_key_vocab, enc.node_pair_vocab)
            pref_tables.append(tl.tables[0] if tl.valid and tl.valid[0] else ReqTable.never())
            pref_weights.append(term.weight)
        pstacked = _stack_tables(pref_tables, min_terms=2)
        n_pref = pstacked["op"].shape[0]
        out["npref_op"] = pstacked["op"]
        out["npref_key"] = pstacked["key"]
        out["npref_pairs"] = pstacked["pairs"]
        out["npref_thr"] = pstacked["threshold"]
        w = np.zeros(n_pref, np.int64)
        w[: len(pref_weights)] = pref_weights
        out["npref_weight"] = w

        # -- PodTopologySpread constraints ---------------------------------
        for prefix, action in (("ptsf", DO_NOT_SCHEDULE), ("ptss", SCHEDULE_ANYWAY)):
            if pod.spec.topology_spread_constraints:
                constraints = filter_constraints(pod.spec.topology_spread_constraints, action)
            else:
                constraints = filter_constraints(self.default_constraints, action)
            tables = [
                compile_selector(c.selector, enc.pod_key_vocab, enc.pod_pair_vocab, intern=True)
                for c in constraints
            ]
            stacked = _stack_tables(tables, min_terms=2)
            n_c = stacked["op"].shape[0]
            key = np.zeros(n_c, np.int32)
            skew = np.zeros(n_c, np.int32)
            valid = np.zeros(n_c, bool)
            hostname = np.zeros(n_c, bool)
            # pair registration is first-come per topology key: a later
            # constraint with a duplicate key registers no pairs, so its
            # topologyNormalizingWeight sees size 0 (scoring.go:221-240)
            first = np.zeros(n_c, bool)
            seen_keys = set()
            for i, c in enumerate(constraints):
                key[i] = enc.node_key_vocab.intern(c.topology_key)
                skew[i] = c.max_skew
                valid[i] = True
                hostname[i] = c.topology_key == v1.LABEL_HOSTNAME
                if not hostname[i] and c.topology_key not in seen_keys:
                    first[i] = True
                    seen_keys.add(c.topology_key)
            out[f"{prefix}_op"] = stacked["op"]
            out[f"{prefix}_rkey"] = stacked["key"]
            out[f"{prefix}_pairs"] = stacked["pairs"]
            out[f"{prefix}_key"] = key
            out[f"{prefix}_skew"] = skew
            out[f"{prefix}_valid"] = valid
            out[f"{prefix}_hostname"] = hostname
            out[f"{prefix}_first"] = first

        # -- InterPodAffinity incoming terms -------------------------------
        def term_group(terms, prefix: str, weights: Optional[List[int]] = None):
            tables = [
                compile_selector(t.selector, enc.pod_key_vocab, enc.pod_pair_vocab, intern=True)
                for t in terms
            ]
            stacked = _stack_tables(tables, min_terms=2)
            n_t = stacked["op"].shape[0]
            n_ns = bucket_capacity(
                max([len(t.namespaces) for t in terms], default=1), minimum=2
            )
            ns = np.zeros((n_t, n_ns), np.int32)
            key = np.zeros(n_t, np.int32)
            valid = np.zeros(n_t, bool)
            wout = np.zeros(n_t, np.int64)
            for i, t in enumerate(terms):
                ids = [enc.ns_vocab.intern(x) for x in sorted(t.namespaces)]
                ns[i, : len(ids)] = ids
                key[i] = enc.node_key_vocab.intern(t.topology_key)
                valid[i] = True
                if weights is not None:
                    wout[i] = weights[i]
            out[f"{prefix}_op"] = stacked["op"]
            out[f"{prefix}_rkey"] = stacked["key"]
            out[f"{prefix}_pairs"] = stacked["pairs"]
            out[f"{prefix}_ns"] = ns
            out[f"{prefix}_key"] = key
            out[f"{prefix}_valid"] = valid
            if weights is not None:
                out[f"{prefix}_weight"] = wout

        term_group(pod_info.required_affinity_terms, "ipaa")
        term_group(pod_info.required_anti_affinity_terms, "ipaaa")
        pref_terms = list(pod_info.preferred_affinity_terms) + list(
            pod_info.preferred_anti_affinity_terms
        )
        signs = [t.weight for t in pod_info.preferred_affinity_terms] + [
            -t.weight for t in pod_info.preferred_anti_affinity_terms
        ]
        term_group(pref_terms, "ipap", weights=signs)
        out["has_preferred_ipa"] = np.array(bool(pref_terms))

        # -- incoming pod self (labels / namespace) ------------------------
        self_pair = np.zeros(enc.pod_pair_vocab.capacity, bool)
        self_key = np.zeros(enc.pod_key_vocab.capacity, bool)
        for k, val in (pod.metadata.labels or {}).items():
            self_key[enc.pod_key_vocab.intern(k)] = True
            self_pair[enc.pod_pair_vocab.intern((k, val))] = True
        out["self_ppair"] = self_pair
        out["self_pkey"] = self_key
        out["self_ns"] = np.array(enc.ns_vocab.intern(pod.metadata.namespace), np.int32)

        # -- ImageLocality / NodePreferAvoidPods ---------------------------
        imgs = [
            enc.image_vocab.intern(normalized_image_name(c.image))
            for c in pod.spec.containers
        ]
        mc = bucket_capacity(max(len(imgs), 1), minimum=2)
        images = np.zeros(mc, np.int32)
        images[: len(imgs)] = imgs
        out["images"] = images
        out["n_containers"] = np.array(len(pod.spec.containers), np.int32)
        ctrl = None
        for ref in pod.metadata.owner_references or []:
            if ref.controller:
                ctrl = ref
                break
        if ctrl is not None and ctrl.kind in ("ReplicationController", "ReplicaSet"):
            out["avoid_ctrl"] = np.array(enc.avoid_vocab.intern((ctrl.kind, ctrl.uid)), np.int32)
        else:
            out["avoid_ctrl"] = np.array(0, np.int32)
        return out
