"""What-if preemption: one preemptor's victim search as one device program.

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

The reference's `_whatif_run` is one jitted jnp program. On the card the
port runs it as hand-written kernels (ops/whatif_kernel.py,
ops/csrc/whatif.cu): the values that depend only on the context's carry
and the preemptor's template are computed once per (context, template)
(`WhatifContext.tables`, the context kernel); each preemptor is one packed
upload, the walk's launch (with the PTS minimum structure before it) and
one readback of an [N, L + 2] bool output. On the CPU the same entry
points run the plain version (the torch prologue and the reference's walk
as a loop over the slots). `_gang_fits_run` is a handful of reductions
and stays plain PyTorch.

Exactness domain, as the reference's: the preemptor may carry pod
(anti-)affinity terms and topology-spread constraints; the planner
(scheduler/preemption_device.py) gates the rest of the envelope.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import kernel as K
from . import whatif_kernel as wk
from .hoisted import (
    HoistedSession,
    _PORT_STEP_KEYS,
    _eval_reqs_batch_np,
    batch_bucket,
    template_fingerprint,
)
from .kernel import _I64
from .whatif_kernel import whatif_context, whatif_device

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
        # tj -> (the kernels' tables with the context's invariants, their
        # dims, any PTS constraint valid): the carry is never written
        self._tabs: Dict[int, Tuple[Dict, Dict, bool]] = {}
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

    def tables(self, tj: int) -> Tuple[Dict, Dict, bool]:
        """(tables, dims, any PTS constraint valid) of template tj: the
        session's tables at tj and this context's carry, with the
        invariants of the context kernel (`whatif_context`; on the CPU its
        plain version) computed on the first call and kept."""
        got = self._tabs.get(tj)
        if got is None:
            sess = self._sess
            tab = wk.tables(sess._S, sess._c_static, self.carry, tj,
                            self.dyn_ipa, self.dyn_ports)
            d = wk.table_dims(tab, tj, self.dyn_ipa, self.dyn_ports)
            tab.update(whatif_context(tab, d))
            any_f = bool(tab["f_valid"].cpu().any())
            got = self._tabs[tj] = (tab, d, any_f)
        return got

    def run(self, tj: int, v, nom, pre):
        """Enqueue one preemptor's what-if on the current stream; returns
        its [N, L + 2] bool output on the device (fits_now, base, victims:
        `whatif_kernel.outputs` splits it; the caller bounds the wait and
        reads it back once). v/nom/pre are dicts of numpy arrays in the
        layout the reference's _whatif_run documents."""
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
        tab, d, any_f = self.tables(tj)
        if v.get("cnt") is None:
            # singleton slots: count == validity (one member per slot)
            v = dict(v, cnt=np.asarray(v["valid"]).astype(np.int64))
        dims = wk.launch_dims(d, np.asarray(v["valid"]).shape[1],
                              bool(nom["has_nom"]), any_f)
        # one pinned staging buffer, one copy in; the caching host
        # allocator keeps it until the copy has run
        host = torch.empty(wk.layout(dims)[1], dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        wk.pack(v, nom, pre, dims, host.numpy())
        buf = host.to(self.device, non_blocking=True)
        return whatif_device(tab, buf, dims)

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
