"""The scheduling backend: the kernel-driven replacement for the oracle
filter/score path, on the card.

Port of kubernetes_tpu/scheduler/tpu_backend.py (TPUBackend). Where the
reference runs findNodesThatPassFilters + RunScorePlugins per node on
goroutines (reference: pkg/scheduler/core/generic_scheduler.go:235,
pkg/scheduler/framework/runtime/framework.go:723), this backend keeps the
whole cluster as dense arrays (models/encoding.py), mirrors every
scheduler-cache mutation into them through the CacheListener hooks, and
evaluates ALL nodes per pod on the device: batches ride a cross-batch
session whose carry lives on the device, one kernel launch per batch
(ops/scan.py ScanSession, the hand-written CUDA scan) or, a rung lower,
the torch hoisted session (ops/hoisted.py HoistedSession); single pods
ride ops/kernel.py schedule_pod.

What the port changes against the reference, and why:

- The device: `device` (CUDA unless the caller names the CPU, as the
  tests do; device.resolve_device decides, with no CPU fallback). The
  kernel rung is `use_kernel` (device.type == "cuda" unless forced; on
  the CPU a forced kernel rung runs ScanSession on the kernels' plain
  versions). On the card the kernel library is built and loaded at
  construction, and a build or load error raises there: it is never a
  device fault the ladder would hide by demoting.
- Streams: the backend owns one torch.cuda.Stream. Every enqueue (session
  build, schedule, delta flush, the encoding's device sync, the canary)
  runs under it, whichever thread calls, and each batch records a CUDA
  event on it; waits poll `event.query()` under the watchdog (the
  reference polls `is_ready()` on the result arrays). Nothing here calls
  the device-wide torch.cuda.synchronize().
- Readback: a harvested payload is read back once, with `.cpu()` after
  its event, before decode, validation and the fault seam look at it
  (np.asarray cannot take a tensor on the card). The copy runs on a
  readback stream that waits for that event alone: queued on the dispatch
  stream it would wait for the batches dispatched after it.
- Device state: the encoding's device_state() rewrites its cached tensors
  in place where the reference donated them. The teardown points stay the
  reference's (so are the decisions); no live session reads those
  tensors (ScanSession uploads its own statics, HoistedSession clones
  what its step reads), and every rewrite is ordered on the stream.
- The what-if planner (ops/whatif.py, the device rung of
  preemption_device.py) is on by default on the card and off on the CPU,
  as the reference's is on its chip and off on the CPU; its context
  build, carry clone and launches are enqueued on the backend's stream.
- A mesh (`mesh=`, parallel/sharded.py `Mesh`) is the reference's
  single-controller mesh without GSPMD: the kernel rung builds
  ops/sharded_scan.py ShardedScanSession (node-axis groups, exact
  collectives); the rungs the reference runs as GSPMD programs (the
  hoisted session, single-pod and re-evaluation dispatches, the what-if
  view) run on the mesh's lead device over the cluster padded to the
  shard multiple (sharded.shard_cluster). The backend's device is the
  mesh's lead device. The reference's AOT-bucket
  quarantine (`retire_exec`, `warm_buckets`, `_suspect_buckets`) has no
  counterpart: the port has no per-bucket executables, one library is
  loaded once per process; a warm launch at session build, its
  counterpart, took nothing off a fresh process's first batch on the
  H100 (chip_smoke.py phase 12a measures it), so there is none.

Status reconstruction: each kernel mask corresponds to one plugin's
Filter; infeasible nodes get Unschedulable statuses naming the failing
plugins, so FitError output matches the oracle's shape (plugin-name
level, not message-string level).
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
import time as _time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api import types as v1
from ..device import resolve_device
from ..models.encoding import ClusterEncoding
from ..models.pod_encoder import PodEncoder
from ..ops.batch import shape_signature
from ..ops.hoisted import (
    HoistedSession,
    ipa_term_match_np,
    match_matrices_np,
    schedule_batch_hoisted,
    template_fingerprint,
)
from ..ops.kernel import DEFAULT_WEIGHTS, schedule_pod, schedule_pods
from ..ops.scan import ScanSession, SessionUnsupported
from ..ops.sharded_scan import ShardedScanSession
from ..utils import devtime, knobs, tracing
from .core import ScheduleResult
from .degradation import (
    RUNG_HOISTED,
    RUNG_KERNEL,
    RUNG_ORACLE,
    DegradationLadder,
    DeviceFault,
)
from .framework.interface import FitError, Status
from .internal.cache import CacheListener
from .volume_device import VolumeResolutionChanged

logger = logging.getLogger(__name__)

# sentinel "node" for a gate/encode volume-resolution race: the pod is
# not unschedulable — it must RE-GATE promptly (the scheduler re-adds it
# to the active queue instead of parking it for the leftover flusher)
RETRY_NODE = "\x00volume-retry"

# kernel mask key -> plugin name (for FitError statuses)
MASK_PLUGINS = (
    ("mask_name", "NodeName"),
    ("mask_unsched", "NodeUnschedulable"),
    ("mask_taint", "TaintToleration"),
    ("mask_ports", "NodePorts"),
    ("mask_fit", "NodeResourcesFit"),
    ("mask_node_affinity", "NodeAffinity"),
    ("mask_pts", "PodTopologySpread"),
    ("mask_ipa", "InterPodAffinity"),
)


def _explain_topk(payload: Dict, node_names: List[str]) -> List[Tuple[str, int]]:
    """Level-2 provenance rendering of one pod's explain payload: the
    top-k candidates as (node, weighted total), best first."""
    out: List[Tuple[str, int]] = []
    for idx, total in zip(payload["topk_idx"], payload["topk_total"]):
        idx, total = int(idx), int(total)
        if 0 <= idx < len(node_names) and total >= 0:
            out.append((node_names[idx], total))
    return out


def _host_array(val) -> np.ndarray:
    """One payload leaf as numpy: a tensor is read back explicitly
    (np.asarray refuses a tensor on the card)."""
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


# ktpu: allow-sync(harvest decode: a batch's one readback, one .cpu() a leaf after its event)
def _readback(ys):
    """A batch's payload with every tensor leaf read back to the host
    (one `.cpu()` each); host scalars ride along."""
    if isinstance(ys, torch.Tensor):
        return ys.detach().cpu()
    if not isinstance(ys, dict):
        return ys
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in ys.items()}


# -- session-delta classification ---------------------------------------------
# The classifiers of the backend's delta queue, as functions of an encoding
# and a live session (testing/churn.py offers them to callers that drive a
# session without a backend). Each runs the encoding mutation and returns
# the delta the session absorbs through `apply_deltas`, or None where only
# a rebuild of the session is exact.


def pod_self_rows(enc: ClusterEncoding, pod: v1.Pod) -> Dict:
    """The pod's label/namespace bit rows at current vocab widths — what
    match_matrices_np and the term-match classifier evaluate. Built with
    get() (never intern): a label pair the vocab has never seen cannot
    appear in any compiled selector, so the zero sentinel is exact."""
    pp = np.zeros(enc.pod_pair_vocab.capacity, bool)
    pk = np.zeros(enc.pod_key_vocab.capacity, bool)
    for k, val in (pod.metadata.labels or {}).items():
        kid = enc.pod_key_vocab.get(k)
        pid = enc.pod_pair_vocab.get((k, val))
        if kid:
            pk[kid] = True
        if pid:
            pp[pid] = True
    return {
        "self_ppair": pp, "self_pkey": pk,
        "self_ns": np.int32(enc.ns_vocab.get(pod.metadata.namespace)),
    }


def pod_structural(pod: v1.Pod) -> bool:
    """Pods whose assume/remove touches term/port tables (the exact
    complement of ops/batch.py pod_batchable, from the spec)."""
    from .framework.types import PodInfo

    pi = PodInfo(pod)
    if (
        pi.required_affinity_terms
        or pi.required_anti_affinity_terms
        or pi.preferred_affinity_terms
        or pi.preferred_anti_affinity_terms
    ):
        return True
    return any(
        port.host_port > 0
        for c in pod.spec.containers
        for port in c.ports or []
    )


def pod_delta(sess, enc: ClusterEncoding, pod: v1.Pod, node_name: str,
              sign: int, mutate) -> Optional[Dict]:
    """Run `mutate` (the encoding update of a pod bound to, sign +1, or
    removed from, sign -1, `node_name`) and classify the event against the
    live session `sess`: the carry delta, or None when it is structural.
    The utilization delta is captured as the host ROW diff around the
    mutation, so volume attach-scalar extras and every other row-math
    subtlety transfer exactly."""
    nidx = None
    snap = None
    if (
        not enc._rebuild_needed
        # a remove must hit the row the encoding actually holds: a
        # relocated pod (informer-wins path) removes from its STORED
        # node, which is the node_name the cache passes — verify
        and (sign > 0
             or enc._pods.get(v1.pod_key(pod), (None, node_name))[1]
             == node_name)
    ):
        nidx = enc.node_index.get(node_name)
        if nidx is not None:
            A = enc._arrays
            snap = (
                A["requested"][nidx].copy(),
                A["nz_requested"][nidx].copy(),
                int(A["pod_count"][nidx]),
            )
    mutate()
    if snap is None or enc._rebuild_needed:
        return None  # structural: unknown node or capacity growth
    if pod_structural(pod):
        return None
    rows = pod_self_rows(enc, pod)
    if getattr(sess, "dyn_ipa", False) and ipa_term_match_np(
            sess._term_np, rows):
        # the pod counts toward a template's own-term statics (anti/aff
        # counts, D5 score rows) — not carry-only
        return None
    A = enc._arrays
    dres = A["requested"][nidx] - snap[0]
    dnz = A["nz_requested"][nidx] - snap[1]
    dcount = int(A["pod_count"][nidx]) - snap[2]
    if not sess.delta_compatible(dres, dnz):
        return None  # the kernel session's int32 / GCD envelope
    t_n = sess._tp_np["self_ns"].shape[0]
    c_n = sess._tp_np["ptsf_op"].shape[1]
    if pod.metadata.deletion_timestamp is not None:
        # terminating pods never enter the prologue's PTS counts (the
        # ~pterm gate); only utilization moves
        mf = np.zeros((t_n, c_n), np.int32)
        ms = np.zeros((t_n, c_n), np.int32)
    else:
        mfa, msa = match_matrices_np(sess._tp_np, [rows])
        mf = mfa[:, 0, :].astype(np.int32) * sign
        ms = msa[:, 0, :].astype(np.int32) * sign
    return {
        "kind": "pod-add" if sign > 0 else "pod-remove",
        "node": nidx, "dres": dres, "dnz": dnz, "dcount": dcount,
        "mf": mf, "ms": ms,
    }


def alloc_patch(sess, enc: ClusterEncoding, node: v1.Node, old,
                fp) -> Tuple[bool, Optional[Dict]]:
    """Prologue-patch classification of an update of a known node whose
    fingerprint went from `old` to `fp`: when ONLY the allocatable/
    capacity slot moved, the encoding updates the row in place and the
    live session patches its static alloc column — no other prologue
    product reads alloc. Returns (patched, delta): patched False — the
    update is structural and the encoding is untouched; patched True with
    delta None — the row is patched in the encoding, but the session's
    GCD envelope refuses the delta (only the session must go)."""
    if (
        old is None
        or enc._rebuild_needed
        # fingerprint slots: labels, avoid-annotation, taints,
        # unschedulable, alloc, images — everything but alloc equal
        or old[:4] != fp[:4]
        or old[5] != fp[5]
    ):
        return False, None
    got = enc.update_node_alloc(node)
    if got is None:
        return False, None
    dalloc, dallowed = got
    if not sess.delta_compatible(dalloc, np.zeros(2, np.int64)):
        return True, None
    return True, {"kind": "node-alloc",
                  "node": enc.node_index[node.metadata.name],
                  "dalloc": dalloc, "dallowed": dallowed}


class _BatchHandle:
    """One dispatched batch: device outputs + how to decode them. The
    decode fn is captured at dispatch time because the session may be
    invalidated (by foreign cluster events) before harvest — the computed
    ys stay valid either way. `event` is the CUDA event recorded on the
    backend's stream after the batch's enqueue (None on the CPU, whose
    ops have run when they return)."""

    __slots__ = ("group", "ys", "decide", "node_names", "results",
                 "deadline", "timed_out", "speculative", "conflicts",
                 "prov", "explain", "basis_mutations", "wave_binds", "dt",
                 "event")

    def __init__(self, group: List[v1.Pod]):
        self.group = group
        self.ys = None
        self.decide = None
        # speculative dispatch: this scan was enqueued while EARLIER
        # batches were still in flight — it chained on a carry whose
        # decisions had not been harvested/validated yet. A clean FIFO
        # harvest is a speculation hit; a re-drive because that carry
        # was invalidated (fault, validation failure, conflict suffix,
        # worker-crash abandon) is a miss.
        self.speculative = False
        # session-captured conflict decoder (like `decide`): maps ys to
        # (n_conflicts, replay_suffix_start)
        self.conflicts = None
        # decisions are node INDICES into the cluster as of dispatch; a
        # node remove/rebuild before harvest would shift enc.node_names,
        # so the dispatch-time table rides the handle
        self.node_names: Optional[List[str]] = None
        self.results: Optional[List[Tuple[v1.Pod, Optional[str]]]] = None
        # dispatch watchdog: the wall-clock deadline for this scan's
        # results; a wait past it is a device fault, not a longer wait
        self.deadline: Optional[float] = None
        self.timed_out = False
        # flight-recorder provenance (KTPU_TRACE >= 2 only)
        self.prov: Optional[Dict] = None
        # KTPU_EXPLAIN: the decoded per-pod explain payloads
        self.explain: Optional[List[Dict]] = None
        # the shadow sentinel's stale-basis gate (set by the scheduler)
        self.basis_mutations: Optional[Tuple[int, int]] = None
        # the scheduler's failure-wave bind count latched at dispatch
        self.wave_binds: Optional[int] = None
        # device-timeline launch token (KTPU_DEVTIME >= 1 only)
        self.dt = None
        self.event = None


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def schedule_exact(session, arrays: List[Dict], run=None) -> List[int]:
    """Schedule a batch through `session` to completion under the
    conflict-suffix contract and return its decisions, which equal one
    pod per step: schedule, keep the decisions before the suffix, and
    replay exactly the suffix through the same live session (its carry
    holds the committed prefix) until none is left. `run(batch)` enqueues
    one pass and returns its payload read back (default:
    `session.schedule`); the backend's run waits under the watchdog.
    Counts scheduler_multipod_conflicts_total and
    scheduler_conflict_replays_total. A suffix at the batch head raises
    DeviceFault (kind "invalid"): a step's first pod was evaluated
    against the carry it commits to, so it cannot conflict, and every
    pass lands at least one pod."""
    from .metrics import conflict_replays, multipod_conflicts

    run = run or session.schedule
    stats = getattr(type(session), "conflict_stats", None)
    decisions: List[int] = []
    arrays = list(arrays)
    while arrays:
        ys = run(arrays)
        got = type(session).decisions(ys)
        n_conf, suffix = stats(ys) if stats is not None else (0, None)
        if n_conf:
            multipod_conflicts.inc(n_conf)
        if suffix is None:
            if n_conf:
                conflict_replays.inc(n_conf)
            decisions.extend(got)
            break
        if suffix <= 0:
            raise DeviceFault(
                "conflict suffix at batch head (kernel invariant "
                "violation)", kind="invalid")
        conflict_replays.inc(len(arrays) - suffix)
        decisions.extend(got[:suffix])
        arrays = arrays[suffix:]
    return decisions


class TPUBackend(CacheListener):
    """Owns the dense encoding + kernel dispatch; registered as a cache
    listener so device state tracks the assume-cache at O(changed rows)."""

    def __init__(
        self,
        weights: Optional[Dict[str, int]] = None,
        rng: Optional[random.Random] = None,
        mesh=None,
        device=None,
        use_kernel: Optional[bool] = None,
    ):
        if mesh is not None:
            from ..parallel.sharded import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError("mesh: a parallel.sharded.Mesh, not "
                                f"{type(mesh).__name__}")
            if device is not None and not _same_device(
                    resolve_device(device), mesh.lead):
                raise ValueError(
                    f"device {device} is not the mesh's lead device "
                    f"{mesh.lead}")
            device = mesh.lead
        self.device = resolve_device(device)
        self.enc = ClusterEncoding()
        self.pe = PodEncoder(self.enc)
        self.weights = weights or DEFAULT_WEIGHTS
        self.rng = rng or random.Random()
        # a mesh shards the NODE axis of the kernel session over its
        # groups (ops/sharded_scan.py); the other rungs run on its lead
        # device over the padded cluster
        self.mesh = mesh
        if mesh is not None:
            # rebuild-time node capacity lands on a shard multiple, so
            # the mesh path never re-pads and node adds stay inside the
            # session's lanes
            from ..parallel.sharded import node_capacity_multiple

            self.enc.node_quantum = node_capacity_multiple(mesh)
        # the kernel rung: the CUDA scan session on the card; forced on
        # for the CPU it runs on the kernels' plain versions
        # on a mesh the kernel rung is the sharded session, on the CPU
        # too (the reference builds its sharded session on any platform)
        self.use_kernel = (
            (self.device.type == "cuda" or mesh is not None)
            if use_kernel is None else bool(use_kernel))
        # device-side preemption planning (ops/whatif.py): on where the
        # launch is a real device dispatch, as the reference's is on its
        # chip (its default is platform == "tpu"); KTPU_WHATIF=0 is the
        # kill switch, =1 the CPU opt-in. The what-if context is a SCRATCH
        # view of the cluster: launches never chain onto or invalidate the
        # live session.
        self.whatif = knobs.get_bool("KTPU_WHATIF",
                                     default=self.device.type == "cuda")
        self._stream = None
        self._d2h = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # readbacks: a copy queued on the dispatch stream would wait
            # for every batch enqueued after the one it reads
            self._d2h = torch.cuda.Stream(self.device)
            # build + load the kernel libraries NOW: a build or load
            # error must surface here, not at a first launch mid-run
            if self.use_kernel:
                from ..ops import scan_kernel

                scan_kernel._lib()
            if self.whatif:
                from ..ops import whatif_kernel

                whatif_kernel._lib()
        self._lock = threading.RLock()
        # cross-cycle session (ScanSession or HoistedSession): the
        # device-resident carry survives between schedule_many calls as
        # long as the ONLY cluster mutations are the assumes the session
        # itself produced (tracked in _session_assumed — the cache.assume
        # confirmation arrives later through on_add_pod and must not
        # invalidate). Any other mutation is queued as a delta or tears
        # the session down; the next batch rebuilds it from the encoding.
        self._session = None
        self._session_assumed: set = set()
        # incremental device-state deltas: cluster events the classifier
        # proved touch ONLY the session's carry (batchable pod add/remove
        # on a known node) or template-invariant statics (allocatable-only
        # node updates) queue here instead of tearing the session down,
        # and the next dispatch applies them in one fused launch
        # (_apply_session_deltas_locked). Teardown stays the path for
        # everything structural.
        self._deltas: List[Dict] = []
        self.delta_patching = knobs.get_bool("KTPU_SESSION_DELTAS")
        # a pod update reaches the backend as a removal and an add; the
        # cache announces it first (on_update_pod_begin), and the removal
        # is held here, by pod key, until the add applies both under one
        # acquisition of the lock: a batch dispatched between the two
        # sees the pod as it was, never its node without it
        self._update_held: Dict[str, Optional[Tuple[v1.Pod, str]]] = {}
        # batches dispatched so far; with `event_log` a list, each cache
        # event the backend takes is appended to it under the lock, in
        # the order taken: (dispatches before it, "node" | "remove" |
        # "add", the object, seconds the backend spent on it)
        self.dispatches = 0
        self.event_log: Optional[List[Tuple]] = None
        # backstop for an idle scheduler accumulating events with no
        # dispatch to flush them
        self.max_queued_deltas = knobs.get_int("KTPU_MAX_QUEUED_DELTAS")
        self._node_fps: Dict[str, tuple] = {}  # heartbeat-change gate
        self._known_templates: Dict = {}  # fingerprint -> pod arrays
        # in-flight batches, oldest first. Depth 2 double-buffers the
        # device: batch k+1's scan is enqueued (chained on k's carry as a
        # stream-ordered data dependency) while k still runs. Harvests
        # are strictly FIFO — sequential assume semantics ride the carry
        # chain, and the host encoding applies each batch's decisions in
        # dispatch order (_harvest_locked).
        self._pending: deque = deque()  # of _BatchHandle
        self.max_pending = 2
        # back-pressure seam: when _pending is full, dispatch_many either
        # waits on this condition for a completion worker to drain
        # (async_harvest_drain=True) or harvests inline (direct users)
        self._pending_cv = threading.Condition(self._lock)
        self.async_harvest_drain = False
        # speculative dispatch kill switch (KTPU_SPECULATION=0)
        self.speculation = knobs.get_bool("KTPU_SPECULATION")
        self.MAX_SESSION_TEMPLATES = 8
        self.volume_resolver = None  # scheduler/volume_device.py
        # what-if contexts (a scratch view of the cluster per preemptor
        # template), valid for one encoding version
        self._whatif_cache: Dict = {}
        self._whatif_cache_version = -1
        self.whatif_builds = 0
        self.whatif_build_s = 0.0
        # -- device fault tolerance ------------------------------------
        # Optional FaultInjector seam (testing/faults.py, duck-typed)
        self.faults = None
        self.watchdog_timeout = knobs.get_float("KTPU_WATCHDOG_TIMEOUT")
        self.retry_cap = knobs.get_int("KTPU_DISPATCH_RETRIES")
        self.retry_base = knobs.get_float("KTPU_RETRY_BASE")
        self.retry_max = knobs.get_float("KTPU_RETRY_MAX")
        # degradation ladder: consecutive faults demote kernel -> hoisted
        # -> oracle; the probe loop re-promotes when a canary dispatch
        # answers correctly again
        self.ladder = DegradationLadder(
            top=RUNG_KERNEL if self.use_kernel else RUNG_HOISTED,
            threshold=knobs.get_int("KTPU_DEMOTE_THRESHOLD"),
            probe_interval=knobs.get_float("KTPU_PROBE_INTERVAL"),
            rng=self.rng,
        )
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_lock = threading.Lock()
        self._probe_stop = threading.Event()
        # backend-health event hook: (event_type, reason, message); must
        # never raise into the dispatch path — _notify_health guards it
        self.health_cb = None
        # decision explainability: KTPU_EXPLAIN (or an armed shadow
        # sentinel) makes every harvest carry per-plugin filter verdicts
        # and score splits; explain rides the hoisted session only
        self.shadow_sample = min(1.0, max(0.0,
            knobs.get_float("KTPU_SHADOW_SAMPLE")))
        self.explain = (
            knobs.get_bool("KTPU_EXPLAIN")
            or self.shadow_sample > 0
        )
        self.explain_topk = max(1, knobs.get_int("KTPU_EXPLAIN_TOPK"))
        # overload-shed lever: False skips the attribution decode
        self.explain_harvest = True
        # flight-recorder provenance context
        self._last_build = ""
        self._last_invalidate = ""
        self._upload_seconds = 0.0
        from ..models.vocab import node_headroom as _nh
        from ..ops.kernel import multipod_k as _mk
        from ..utils import configz
        from .metrics import mesh_shards

        mesh_shards.set(float(self.mesh.nsh) if self.mesh is not None
                        else 0.0)
        configz.install_knobs(
            "ktpu",
            multipod_k=_mk(platform=self.device.type),
            mesh_devices=self.mesh.nsh if self.mesh is not None else 0,
            mesh_layout=self.mesh.layout if self.mesh is not None else "",
            node_headroom=_nh(),
            speculation=self.speculation,
            whatif=self.whatif,
            session_deltas=self.delta_patching,
            max_queued_deltas=self.max_queued_deltas,
            use_kernel=self.use_kernel,
            device=str(self.device),
            watchdog_timeout=self.watchdog_timeout,
            dispatch_retries=self.retry_cap,
            demote_threshold=self.ladder.threshold,
            trace_level=tracing.level(),
            trace_capacity=tracing.RECORDER.capacity,
            devtime_level=devtime.level(),
            devtime_capacity=devtime.TIMELINE.capacity,
            explain=self.explain,
            explain_topk=self.explain_topk,
            shadow_sample=self.shadow_sample,
        )

    # -- the backend's stream ----------------------------------------------

    def _on_stream(self):
        """Context that puts this thread's enqueues on the backend's
        stream (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _record_event(self):
        """A CUDA event after everything enqueued on the backend's stream
        so far; None on the CPU."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    def _read_back(self, ys, event):
        """A payload read back to the host once, after `event` (its
        batch's), on the readback stream: it waits for that batch alone,
        not for the batches dispatched after it."""
        if self._d2h is None:
            return _readback(ys)
        if event is not None:
            self._d2h.wait_event(event)
        with torch.cuda.stream(self._d2h):
            return _readback(ys)

    # ktpu: allow-sync(devtime fence: the wait is the measurement, taken only with device timing on)
    def _sync_stream(self) -> None:
        """Wait for the backend's stream (the devtime fences)."""
        ev = self._record_event()
        if ev is not None:
            ev.synchronize()

    def _pod_tensors(self, p: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in p.items()}

    def _notify_health(self, event_type: str, reason: str,
                       message: str) -> None:
        """Best-effort backend-health event (ladder transitions,
        speculation-miss re-drives). Never raises."""
        cb = self.health_cb
        if cb is None:
            return
        try:
            cb(event_type, reason, message)
        except Exception:  # noqa: BLE001 — observability is best-effort
            logger.warning("backend health event failed", exc_info=True)

    def set_shadow_sample(self, rate: float) -> None:
        """Arm (or disarm) the shadow parity sentinel at runtime. Arming
        forces explain mode on; a live non-explain session is torn down
        and the next dispatch rebuilds with explain outputs."""
        from ..utils import configz

        with self._lock:
            self.shadow_sample = min(1.0, max(0.0, float(rate)))
            explain = (
                knobs.get_bool("KTPU_EXPLAIN")
                or self.shadow_sample > 0
            )
            if explain != self.explain:
                self.explain = explain
                self._invalidate_session("explain-toggle")
            configz.install_knobs(
                "ktpu", explain=self.explain,
                shadow_sample=self.shadow_sample,
            )

    def set_shadow_rate_only(self, rate: float) -> None:
        """Overload-shed path for the sentinel: change the sample rate
        WITHOUT re-deriving explain mode (no teardown)."""
        from ..utils import configz

        with self._lock:
            self.shadow_sample = min(1.0, max(0.0, float(rate)))
            configz.install_knobs("ktpu", shadow_sample=self.shadow_sample)

    def set_volume_resolver(self, resolver) -> None:
        """Enable the volume device path: bound-PVC pods encode their PV
        constraints + attach counts into kernel inputs."""
        with self._lock:
            self.volume_resolver = resolver
            self.pe.volume_resolver = resolver
            self.enc.volume_hook = resolver
            resolver.on_new_driver = self._on_new_volume_driver

    def _on_new_volume_driver(self) -> None:
        """A driver just entered use: node rows built before it carry no
        limit column — rebuild before the next dispatch."""
        with self._lock:
            self._invalidate_session("volume-driver")
            self.enc._rebuild_needed = True

    def volume_kernel_safe(self, pod: v1.Pod) -> bool:
        """True when this PVC-bearing pod's volume constraints resolve
        into the kernel envelope RIGHT NOW (gates the oracle diversion)."""
        if self.volume_resolver is None:
            return False
        return self.volume_resolver.resolve(pod) is not None

    def on_volume_change(self, kind: str = "", obj=None) -> None:
        """A PVC/PV/CSINode event: the resolver version bumps always; the
        session teardown + encoding rebuild only runs when the object can
        touch encoded state."""
        resolver = self.volume_resolver
        if resolver is None:
            return
        with self._lock:
            resolver.bump()
            if not self._volume_obj_encoded(kind, obj, resolver):
                return
            self._invalidate_session("volume-change")
            self.enc._rebuild_needed = True

    @staticmethod
    def _volume_obj_encoded(kind: str, obj, resolver) -> bool:
        if obj is None or not kind:
            return True  # unknown shape: stay conservative
        try:
            if kind == "pvc":
                key = (obj.metadata.namespace, obj.metadata.name)
                return resolver.claim_referenced(key)
            if kind == "pv":
                ns = obj.spec.claim_ref_namespace
                name = obj.spec.claim_ref_name
                if not name:
                    return False  # unbound PV: no encoded pod can see it
                return resolver.claim_referenced((ns or "default", name))
            if kind == "csinode":
                drivers = {d.name for d in obj.spec.drivers or []}
                return resolver.drivers_referenced(drivers)
        except Exception:  # noqa: BLE001 — malformed object: conservative
            return True
        return True

    def _shards_label(self) -> str:
        """`shards` metric label: the mesh's shard count, '' off-mesh."""
        return str(self.mesh.nsh) if self.mesh is not None else ""

    def _cluster_for_lead(self, cluster: Dict) -> Dict:
        """The cluster dict a single-device path runs on: as it is, or on
        a mesh padded to the shard multiple on the lead device (the
        reference's shard_cluster placement)."""
        if self.mesh is None:
            return cluster
        from ..parallel import sharded

        return sharded.shard_cluster(cluster, self.mesh)

    def _devtime_slug(self, session=None) -> str:
        """Device-time slug: the session kind ('kernel', 'hoisted'), '-'
        with no live session; '@<shards>' on a mesh."""
        s = session if session is not None else self._session
        if s is None:
            return "-"
        kind = ("kernel" if isinstance(s, (ScanSession, ShardedScanSession))
                else "hoisted")
        sh = self._shards_label()
        return f"{kind}@{sh}" if sh else kind

    def _feed_device_time(self, kind: str, seconds: float,
                          session=None) -> None:
        """Accumulate one launch's device seconds (KTPU_DEVTIME >= 1;
        callers gate)."""
        from .metrics import device_time

        if seconds > 0:
            device_time.inc(
                seconds, slug=self._devtime_slug(session), kind=kind)

    def _invalidate_session(self, reason: str = "unspecified") -> None:
        # _session_assumed survives invalidation deliberately (an assume
        # echo is host bookkeeping either way); queued deltas do NOT: the
        # fresh session builds from the already-mutated encoding
        self._deltas.clear()
        if self._session is None:
            return
        from .metrics import session_rebuilds

        session_rebuilds.inc(reason=reason, shards=self._shards_label())
        self._last_invalidate = reason
        tracing.event("session-teardown", "session", reason=reason)
        if knobs.get_flag("KTPU_DEBUG_INVALIDATE"):
            import sys
            import traceback as _tb

            print(f"SESSION INVALIDATED ({reason}) BY:", file=sys.stderr)
            _tb.print_stack(limit=8)
        self._session = None

    # -- device fault tolerance --------------------------------------------
    # Every device-touching path runs under this discipline: the dispatch
    # is guarded (injector seam + real exceptions), the wait is bounded by
    # the watchdog, and the harvested payload passes a finite/in-range
    # check BEFORE its decisions reach assume(). A fault tears the session
    # down, counts toward the ladder (demotion after `threshold`
    # consecutive), and the batch re-drives synchronously with capped
    # backoff; an exhausted batch resolves to RETRY_NODE.

    def _check_dispatch_fault(self, rung: Optional[int] = None) -> None:
        inj = self.faults
        if inj is not None:
            inj.on_dispatch(rung=self.ladder.rung() if rung is None else rung)

    def _wait_ready(self, event, timeout: float) -> bool:
        """Watchdog-bounded device wait: True once `event` (recorded on
        the backend's stream after a batch's enqueue; None on the CPU)
        has completed, False when the deadline passes (wedged device).
        Polling `query()` instead of `synchronize()` keeps a hung wait
        from pinning the calling thread forever."""
        deadline = _time.monotonic() + max(0.0, timeout)
        while True:
            inj = self.faults
            wedged = inj is not None and inj.wedge_active()
            if not wedged:
                try:
                    if event is None or event.query():
                        return True
                except Exception:  # noqa: BLE001 — let decode surface it
                    return True
            if _time.monotonic() >= deadline:
                # an injected wedge shot is NOT consumed here: the shot
                # ends when the timeout FAULT is recorded
                # (_device_fault_locked), i.e. when recovery begins
                return False
            # a tenth of the reference's 2 ms poll: a 4096-pod batch's
            # scan takes about 115 ms on the card, and the poll's latency
            # is the harvest's
            _time.sleep(0.0002)

    def _validate_decisions(self, decisions: List[int], n_names: int,
                            ys=None) -> None:
        """Cheap guard between harvest and assume: every decision must be
        a node index (or -1) against the dispatch-time node table, and
        any float payload must be finite. Tensor leaves are read back
        with `.cpu()`."""
        for d in decisions:
            if not (-1 <= int(d) < n_names):
                raise DeviceFault(
                    f"decision {d} outside [-1, {n_names})", kind="invalid")
        if isinstance(ys, dict):
            for k, val in ys.items():
                if not hasattr(val, "dtype"):
                    continue
                a = _host_array(val)
                if a.dtype.kind == "f" and not np.isfinite(a).all():
                    raise DeviceFault(
                        f"non-finite device payload in {k!r}", kind="invalid")

    def _device_fault_locked(self, kind: str,
                             attrs: Optional[Dict] = None) -> None:
        """Record one device fault: count it, dump the flight recorder,
        tear the session down, and demote the ladder when this fault
        crossed the consecutive threshold."""
        from .metrics import device_faults, dump_seam

        device_faults.inc(kind=kind)
        if kind == "timeout" and self.faults is not None:
            # injected-wedge shot accounting: the watchdog fired and the
            # fault is now recorded — recovery's retry path must see a
            # responsive device again
            self.faults.consume_wedge()
        fault_attrs = dict(attrs or ())
        fault_attrs.update(kind=kind, rung=self.ladder.mode())
        tracing.event("device-fault", "fault", **fault_attrs)
        dump_seam(f"device-fault-{kind}", **fault_attrs)
        self._invalidate_session("device-fault")
        if self.ladder.record_fault(kind):
            logger.warning(
                "scheduling backend demoted to %s after %d consecutive "
                "device faults (last: %s); background probe will re-promote",
                self.ladder.mode(), self.ladder.threshold, kind,
            )
            dump_seam("ladder-demoted", **fault_attrs)
            self._notify_health(
                "Warning", "BackendDemoted",
                f"scoring backend demoted to {self.ladder.mode()} after "
                f"consecutive device faults (last: {kind})",
            )
            self._ensure_probe_thread()

    def _dispatch_with_retry(self, attempt):
        """THE bounded-retry policy, shared by every synchronous dispatch
        path: capped exponential backoff + full jitter, one recorded fault
        per failed attempt (so persistent faults walk the ladder down),
        and an immediate stop once the ladder hits oracle. Returns
        `attempt()`'s value; raises DeviceFault when retries exhaust or
        the backend is fully demoted."""
        from .metrics import dispatch_retries

        delay = self.retry_base
        for n in range(self.retry_cap + 1):
            if self.ladder.rung() <= RUNG_ORACLE:
                break
            if n:
                dispatch_retries.inc()
                tracing.event("dispatch-retry", "fault", attempt=n,
                              rung=self.ladder.mode())
                _time.sleep(
                    min(delay, self.retry_max) * (1 + self.rng.random()))
                delay *= 2
            try:
                out = attempt()
                self.ladder.record_success()
                return out
            except DeviceFault as e:
                logger.warning("device dispatch fault (%s, attempt %d/%d)",
                               e.kind, n + 1, self.retry_cap + 1)
                self._device_fault_locked(e.kind)
            except Exception:  # noqa: BLE001 — any device-path error
                logger.warning("device dispatch fault (attempt %d/%d)",
                               n + 1, self.retry_cap + 1, exc_info=True)
                self._device_fault_locked("raise")
        raise DeviceFault(
            "dispatch retries exhausted (or backend demoted)", kind="raise")

    def _session_schedule_guarded(self, arrays: List[Dict]) -> Optional[List[int]]:
        """_session_schedule under the retry policy. Returns None when
        retries exhaust or the ladder hit oracle."""

        def attempt():
            self._check_dispatch_fault()
            decisions = self._session_schedule(arrays)
            self._validate_decisions(decisions, self.enc.n_lanes)
            return decisions

        try:
            return self._dispatch_with_retry(attempt)
        except DeviceFault:
            return None

    def _recover_dispatches_locked(self, kind: str, first: "_BatchHandle") -> None:
        """Harvest-side fault: `first`'s payload is bad, and every later
        pending batch chained its scan on the same carry — all of it is
        suspect. Abandon the chain, record the fault, then re-decide each
        batch synchronously IN DISPATCH ORDER, so sequential-assume
        semantics — and decision parity when the fault was transient —
        survive the recovery."""
        from .metrics import dispatch_retries

        dropped = [first] + list(self._pending)
        self._pending.clear()
        self._pending_cv.notify_all()
        self._miss_speculative(dropped[1:])
        self._device_fault_locked(
            kind,
            attrs={
                "n_batches": len(dropped), "n_pods": len(first.group),
                "speculative": first.speculative,
            },
        )
        for h in dropped:
            h.ys = None
            dispatch_retries.inc()
            with tracing.span("re-drive", "replay", n=len(h.group),
                              speculative=h.speculative, kind=kind):
                h.results = self.schedule_many(h.group)

    def abandon_pending(self) -> int:
        """Drop every not-yet-harvested in-flight dispatch WITHOUT
        re-deciding it (completion-worker crash recovery): abandoned
        handles resolve to RETRY_NODE results; the session is torn down
        because its device carry includes the abandoned assumes."""
        with self._lock:
            n = len(self._pending)
            self._miss_speculative(self._pending)
            for h in self._pending:
                h.ys = None
                h.results = [(p, RETRY_NODE) for p in h.group]
            self._pending.clear()
            self._pending_cv.notify_all()
            if n:
                self._invalidate_session("abandon-pending")
            return n

    def drop_placements(self, items) -> None:
        """Harvested placements (pod, node) the scheduler will not
        assume: the encoding lets them go, and the session, whose carry
        holds them, is torn down."""
        with self._lock:
            for pod, node_name in items:
                self._session_assumed.discard(
                    (pod.metadata.namespace, pod.metadata.name, node_name))
                if v1.pod_key(pod) in self.enc._pods:
                    self.enc.remove_pod(pod)
            if items:
                self._invalidate_session("dropped-placement")

    # -- device-side preemption: what-if context ---------------------------

    def whatif_enabled(self) -> bool:
        """True when the planner's device rung may run: kill switch on
        and the degradation ladder above oracle."""
        return self.whatif and self.ladder.rung() > RUNG_ORACLE

    def whatif_context(self, pod_arrays: Dict):
        """A WhatifContext for this preemptor template against CURRENT
        cluster state. Preference order: the live HoistedSession when it
        knows the template (queued deltas reconciled first, its carry
        cloned on the backend's stream — zero uploads); otherwise a
        throwaway hoisted view over an encoding snapshot (the kernel
        session keeps its carry in kernel-private scaled layouts, and the
        host encoding is its exact mirror after harvest). Neither path
        invalidates the live session or counts a session build. Cached per
        encoding version; `whatif_builds` counts the snapshot views built
        and `whatif_build_s` their seconds."""
        from ..ops.whatif import WhatifContext, WhatifUnavailable

        with self._lock:
            if not self.whatif:
                raise WhatifUnavailable("KTPU_WHATIF=0", reason="disabled")
            if self.ladder.rung() <= RUNG_ORACLE:
                raise WhatifUnavailable("backend demoted to oracle",
                                        reason="demoted")
            if self.enc.n_nodes == 0:
                raise WhatifUnavailable("empty cluster", reason="context")
            # settle the array epoch BEFORE keying the cache: volume
            # events flag _rebuild_needed without an object-level
            # version bump, and rebuild() bumps the version itself
            if self.enc._rebuild_needed or self.enc._caps_grew():
                self.enc.rebuild()
            if self._whatif_cache_version != self.enc.version:
                self._whatif_cache.clear()
                self._whatif_cache_version = self.enc.version
            fp = template_fingerprint(pod_arrays)
            sess = self._session
            if isinstance(sess, HoistedSession) and fp in sess._fps:
                ctx = self._whatif_cache.get(("sess",))
                if ctx is not None and ctx._sess is sess:
                    return ctx
                # reconcile queued cluster-event deltas into the live
                # carry first (the normal pre-dispatch apply — the
                # scratch copy must see them); an apply failure falls
                # through to the encoding path
                self._apply_session_deltas_locked()
                sess = self._session
                if isinstance(sess, HoistedSession) and fp in sess._fps:
                    # the clone is ordered after every batch and delta
                    # flush already enqueued on the stream
                    with self._on_stream():
                        ctx = WhatifContext.from_session(
                            sess, self.enc.node_names)
                    self._whatif_cache[("sess",)] = ctx
                    return ctx
            ctx = self._whatif_cache.get(("enc", fp))
            if ctx is not None:
                return ctx
            # the throwaway hoisted view costs an upload + a prologue
            # build — carry a consistent host copy out and do the
            # expensive part WITHOUT the lock (dispatch/harvest contend
            # on it); double-checked insert below
            host = self.enc.host_snapshot()
            node_names = list(self.enc.node_names)
            version = self.enc.version
        t0 = _time.perf_counter()
        with self._on_stream():
            ctx = WhatifContext.from_host_snapshot(
                host, node_names, pod_arrays, mesh=self.mesh,
                device=self.device)
        self.whatif_builds += 1
        self.whatif_build_s += _time.perf_counter() - t0
        with self._lock:
            if (self._whatif_cache_version == version
                    and self.enc.version == version):
                self._whatif_cache[("enc", fp)] = ctx
        return ctx

    def gang_feasible(self, pod: v1.Pod, k: int) -> Optional[bool]:
        """Joint co-placement probe for the gang deadlock breaker: can
        k pods of this pod's template co-place on the current cluster?
        One pass of reductions on a scratch carry
        (ops/whatif._gang_fits_run) — False is definitive capacity-wise
        ("cannot place even ignoring inter-member constraints"), True
        is optimistic on inter-member couplings. None when the what-if
        path cannot serve (disabled, demoted, template outside the
        envelope, encode failure): the probe is advisory, and the
        caller treats unknown as 'maybe feasible'."""
        try:
            enc_pa = self.pe.encode(pod)
            pa = {n: a for n, a in enc_pa.items() if not n.startswith("_")}
            ctx = self.whatif_context(pa)
            tj = ctx.template_index(pa)
            with self._on_stream():
                return ctx.gang_fits(tj, int(k))
        except Exception:  # noqa: BLE001 — advisory probe, never fatal
            return None

    def check_whatif_fault(self) -> None:
        """Injector seam for the what-if launch path (testing/faults.py
        raise-whatif)."""
        inj = self.faults
        if inj is not None:
            inj.on_whatif()

    def record_whatif_fault(self, kind: str) -> None:
        """A what-if launch faulted: count it and walk the ladder
        (consecutive faults demote and wake the probe), but DO NOT
        invalidate the live session — the what-if ran on a scratch
        snapshot, so there is nothing to rebuild, and tearing the session
        down would charge planning with a rebuild storm
        (session_rebuilds_total stays unchanged by planning)."""
        from .metrics import device_faults, dump_seam

        device_faults.inc(kind=kind)
        tracing.event("whatif-fault", "fault", kind=kind,
                      rung=self.ladder.mode())
        dump_seam("whatif-fault", kind=kind)
        with self._lock:
            self._whatif_cache.clear()
            self._whatif_cache_version = -1
        if self.ladder.record_fault(kind):
            logger.warning(
                "TPU backend demoted to %s after %d consecutive device "
                "faults (last: what-if %s); background probe will "
                "re-promote", self.ladder.mode(), self.ladder.threshold,
                kind,
            )
            self._notify_health(
                "Warning", "BackendDemoted",
                f"scoring backend demoted to {self.ladder.mode()} after "
                f"consecutive device faults (last: {kind})",
            )
            self._ensure_probe_thread()

    # -- ladder probe: background re-promotion -----------------------------

    def _ensure_probe_thread(self) -> None:
        with self._probe_lock:
            t = self._probe_thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(
                target=self._probe_loop, name="backend-ladder-probe",
                daemon=True)
            self._probe_thread = t
            t.start()

    def _probe_loop(self) -> None:
        """While demoted, periodically run a canary dispatch vouching for
        the NEXT rung up; a correct answer promotes one rung, a wrong or
        absent one doubles the cadence (capped). Exits once fully
        re-promoted; a later demotion starts a fresh thread."""
        while not self._probe_stop.is_set():
            if self.ladder.rung() >= self.ladder.top:
                return
            if self._probe_stop.wait(self.ladder.probe_delay()):
                return
            ok = self._probe_device()
            if self.ladder.on_probe(ok):
                logger.warning(
                    "scheduling backend re-promoted to %s after a clean "
                    "probe", self.ladder.mode(),
                )
                self._notify_health(
                    "Normal", "BackendPromoted",
                    f"scoring backend re-promoted to {self.ladder.mode()} "
                    f"after a clean probe",
                )
                with self._lock:
                    # the next batch must rebuild at the restored rung
                    self._invalidate_session("probe-promoted")

    def _probe_device(self) -> bool:
        """One canary with a known answer through the same fault seam as
        real dispatches (rung = the rung being vouched for): a small
        torch op on the backend's stream."""
        try:
            target = min(self.ladder.rung() + 1, self.ladder.top)
            inj = self.faults
            if inj is not None:
                inj.on_dispatch(rung=target, probe=True)
            with self._on_stream():
                y = (torch.arange(64, dtype=torch.int32,
                                  device=self.device) * 2).sum()
                ev = self._record_event()
            if not self._wait_ready(ev, self.watchdog_timeout):
                # consume an armed wedge shot here too: at the oracle
                # rung no dispatch traffic exists to consume it
                if inj is not None:
                    inj.consume_wedge()
                return False
            return int(self._read_back(y, ev)) == 64 * 63
        except Exception:  # noqa: BLE001 — a raising probe is a failed probe
            return False

    def close(self) -> None:
        """Stop the background probe."""
        self._probe_stop.set()
        t = self._probe_thread
        if t is not None:
            t.join(timeout=2)

    # -- CacheListener (called under the cache lock) -----------------------
    # Classification contract (the session-delta design): every event is
    # one of
    #   carry-delta     — a batchable pod (no affinity terms, no host
    #                     ports) added to / removed from a KNOWN node,
    #                     whose row fits the encoding incrementally and
    #                     whose labels match no session template's IPA
    #                     term: a utilization row and PTS pair counts
    #                     move, both the session carry — the event queues
    #                     as a device-side patch;
    #   prologue-patch  — a node update whose fingerprint moved ONLY in
    #                     allocatable/capacity: the static alloc column
    #                     patches in place;
    #   structural      — everything else (node add/remove, term/port
    #                     pods, vocab or capacity growth, volume-world
    #                     changes): session teardown, full rebuild at the
    #                     next dispatch.

    def _logged(self, kind: str, obj, take) -> None:
        """`take()`, appended to `event_log` when it is on (lock held)."""
        if self.event_log is None:
            take()
            return
        t0 = _time.perf_counter()
        try:
            take()
        finally:
            self.event_log.append((self.dispatches, kind, obj,
                                   _time.perf_counter() - t0))

    def on_update_pod_begin(self, pod: v1.Pod) -> None:
        """The cache's update of `pod` begins: its removal waits for the
        add (`_update_held`)."""
        with self._lock:
            self._update_held[v1.pod_key(pod)] = None

    def on_update_pod_end(self, pod: v1.Pod) -> None:
        """The cache's update of `pod` ends: a removal still held (no
        add came) applies now."""
        with self._lock:
            held = self._update_held.pop(v1.pod_key(pod), None)
            if held is not None:
                self._logged("remove", held[0],
                             lambda: self._remove_pod_locked(*held))

    def on_add_pod(self, pod: v1.Pod, node_name: str) -> None:
        with self._lock:
            held = self._update_held.pop(v1.pod_key(pod), None)
            if held is not None:
                self._logged("remove", held[0],
                             lambda: self._remove_pod_locked(*held))
            self._logged("add", pod,
                         lambda: self._add_pod_locked(pod, node_name))

    def _add_pod_locked(self, pod: v1.Pod, node_name: str) -> None:
        with self._lock:
            key = (pod.metadata.namespace, pod.metadata.name, node_name)
            if key in self._session_assumed:
                # the cache confirming an assume the session already
                # applied on-device: host bookkeeping only
                self._session_assumed.discard(key)
                self.enc.add_pod(pod, node_name)
                return
            if v1.pod_key(pod) in self.enc._pods:
                # duplicate add (re-add nets a remove+add inside
                # enc.add_pod — the old row's counts are not
                # reconstructible here)
                self._invalidate_session("foreign-pod-add")
                self.enc.add_pod(pod, node_name)
                return
            if not self._queue_pod_delta(
                pod, node_name, +1,
                lambda: self.enc.add_pod(pod, node_name),
            ):
                self._invalidate_session("foreign-pod-add")

    def on_assume_pods(self, items) -> None:
        """Batched assume-echo from the cache's columnar assume_pods: for
        placements this backend itself applied on-device, the echo
        collapses to a stored-object swap (enc.swap_pod_object); anything
        else falls through to the per-pod on_add_pod path."""
        leftovers = None
        with self._lock:
            assumed = self._session_assumed
            swap = self.enc.swap_pod_object
            for pod, node_name in items:
                key = (pod.metadata.namespace, pod.metadata.name, node_name)
                if key in assumed and swap(v1.pod_key(pod), pod, node_name):
                    assumed.discard(key)
                    continue
                if leftovers is None:
                    leftovers = []
                leftovers.append((pod, node_name))
            if leftovers:
                for pod, node_name in leftovers:
                    self.on_add_pod(pod, node_name)  # RLock: nested is fine

    def on_forget_pods(self, items) -> None:
        """Batched forget-echo (gang rollback): every member's removal
        lands under ONE backend lock acquisition."""
        with self._lock:
            for pod, node_name in items:
                self.on_remove_pod(pod, node_name)  # RLock: nested is fine

    def on_remove_pod(self, pod: v1.Pod, node_name: str) -> None:
        with self._lock:
            key = v1.pod_key(pod)
            if key in self._update_held and self._update_held[key] is None:
                self._update_held[key] = (pod, node_name)
                return
            self._logged("remove", pod,
                         lambda: self._remove_pod_locked(pod, node_name))

    def _remove_pod_locked(self, pod: v1.Pod, node_name: str) -> None:
        with self._lock:
            # removing a pod the encoding never contained is a no-op
            if not node_name or v1.pod_key(pod) not in self.enc._pods:
                return
            self._session_assumed.discard(
                (pod.metadata.namespace, pod.metadata.name, node_name)
            )
            if not self._queue_pod_delta(
                pod, node_name, -1, lambda: self.enc.remove_pod(pod),
            ):
                self._invalidate_session("pod-remove")

    def on_add_node(self, node: v1.Node) -> None:
        with self._lock:
            self._node_fps[node.metadata.name] = ClusterEncoding.node_fingerprint(node)
            lane = self.enc.add_node(node)
            if not self._queue_node_delta(lane, "node-join"):
                self._invalidate_session("node-add")

    def on_update_node(self, node: v1.Node) -> None:
        with self._lock:
            self._logged("node", node, lambda: self._update_node_locked(node))

    def _update_node_locked(self, node: v1.Node) -> None:
        with self._lock:
            # heartbeat gate: only scheduling-relevant changes (labels,
            # annotations, taints, unschedulable, allocatable/capacity,
            # images) reach the encoding
            name = node.metadata.name
            fp = ClusterEncoding.node_fingerprint(node)
            old = self._node_fps.get(name)
            if old == fp:
                return
            self._node_fps[name] = fp
            if self._queue_alloc_patch(node, old, fp):
                return
            self._invalidate_session("node-update")
            self.enc.update_node(node)

    def _queue_alloc_patch(self, node: v1.Node, old, fp) -> bool:
        """Prologue-patch classification for a node update (alloc_patch).
        False -> caller takes the structural path."""
        sess = self._session
        if (
            not self.delta_patching
            or sess is None
            or len(self._deltas) >= self.max_queued_deltas
        ):
            return False
        patched, delta = alloc_patch(sess, self.enc, node, old, fp)
        if not patched:
            return False
        if delta is None:
            # the row is already patched in the host encoding (dirty-row
            # sync covers the next build); only the session must go
            self._invalidate_session("node-update")
            return True
        self._deltas.append(delta)
        return True

    def on_remove_node(self, node_name: str) -> None:
        with self._lock:
            self._node_fps.pop(node_name, None)
            lane = self.enc.remove_node(node_name)
            if not self._queue_node_delta(lane, "node-leave"):
                self._invalidate_session("node-remove")

    def _queue_node_delta(self, lane: Optional[int], kind: str) -> bool:
        """Absorb a node add/remove into the LIVE session as a lane-column
        delta. The encoding has already decided the host half: `lane` is
        None when the event was structural there (vocab bucket growth,
        lane space exhausted, node still carrying pods). The session half
        gates itself (ShardedScanSession's node_join_delta /
        node_leave_delta return None outside their exactness envelope; the
        other sessions offer none). True -> the event is fully reconciled;
        False -> the caller tears the session down (rebuild from the
        already-mutated encoding is always correct)."""
        if lane is None or not self.delta_patching:
            return False
        sess = self._session
        if sess is None:
            return True  # nothing device-resident; next build sees it
        if (
            not hasattr(sess, "node_join_delta")
            or len(self._deltas) >= self.max_queued_deltas
        ):
            return False
        try:
            if kind == "node-join":
                d = sess.node_join_delta(
                    self.enc.node_slice_cluster(lane), lane)
            else:
                d = sess.node_leave_delta(lane)
        except Exception:  # noqa: BLE001 — rebuild is always correct
            logger.warning("node delta classification failed; rebuilding",
                           exc_info=True)
            return False
        if d is None:
            return False
        self._deltas.append(d)
        return True

    # -- session-delta classification + apply ------------------------------

    def _pod_self_rows(self, pod: v1.Pod) -> Dict:
        return pod_self_rows(self.enc, pod)

    @staticmethod
    def _pod_structural(pod: v1.Pod) -> bool:
        return pod_structural(pod)

    def _queue_pod_delta(self, pod: v1.Pod, node_name: str, sign: int,
                         mutate) -> bool:
        """Run `mutate` (the host-encoding update) and try to absorb the
        event into the live session as a carry delta (pod_delta). True ->
        the event is fully reconciled (delta queued, or no live session
        to reconcile); False -> structural, the caller tears the session
        down."""
        sess = self._session
        if sess is None:
            # nothing device-resident to reconcile; the next session
            # builds from the mutated encoding
            mutate()
            return True
        if (not self.delta_patching
                or len(self._deltas) >= self.max_queued_deltas):
            mutate()
            return False
        d = pod_delta(sess, self.enc, pod, node_name, sign, mutate)
        if d is None:
            return False
        self._deltas.append(d)
        return True

    def _apply_session_deltas_locked(self) -> None:
        """Flush the queued deltas into the live session in one fused
        launch — called right before a dispatch rides the session, so
        patches chain onto any in-flight scans in stream order. An apply
        failure downgrades to the structural path (teardown + rebuild from
        the already-mutated encoding) — never to wrong state."""
        if not self._deltas:
            return
        if self._session is None:
            self._deltas.clear()
            return
        deltas, self._deltas = self._deltas, []
        from .metrics import session_delta_applies

        try:
            with tracing.span("queued-delta-apply", "delta-apply",
                              n=len(deltas)), self._on_stream():
                if devtime.enabled():
                    # measured delta apply: the fused patch launch gets
                    # its own submit->ready interval via an explicit wait
                    lt = devtime.launch("kernel", "delta-apply",
                                        n=len(deltas))
                    self._session.apply_deltas(deltas)
                    self._sync_stream()
                    lt.done()
                    self._feed_device_time(
                        "kernel", _time.perf_counter() - lt.submit)
                else:
                    self._session.apply_deltas(deltas)
        except Exception:  # noqa: BLE001 — rebuild is always correct
            logger.warning(
                "session delta apply failed; falling back to a rebuild",
                exc_info=True,
            )
            self._invalidate_session("delta-apply-failed")
            return
        for d in deltas:
            session_delta_applies.inc(kind=d["kind"])

    # -- scheduling --------------------------------------------------------

    def schedule(self, pod: v1.Pod) -> ScheduleResult:
        """One pod against every node; raises FitError when none fit
        (generic_scheduler.go:95 Schedule semantics)."""
        with self._lock:
            # an outstanding pipelined batch must land in the encoding
            # first (its decisions are part of the ground truth)
            self._flush_pending()
            # the reference tears the session down here because the
            # device sync donates its statics; the port keeps the same
            # teardown point (decisions equal), and its enc.add_pod()s
            # (schedule_many's bound-pod path) must not leave a surviving
            # session's carry missing those pods
            self._invalidate_session("single-pod-dispatch")
            try:
                p = {k: v for k, v in self.pe.encode(pod).items()
                     if not k.startswith("_")}
            except VolumeResolutionChanged:
                # gate/encode race: fail this attempt; the retry re-gates
                raise FitError(pod, self.enc.n_nodes, {})

            def attempt(p=p):
                self._check_dispatch_fault()
                with self._on_stream():
                    c = self._cluster_for_lead(
                        self.enc.device_state(self.device))
                    out = schedule_pod(c, self._pod_tensors(p), self.weights)
                    ev = self._record_event()
                if not self._wait_ready(ev, self.watchdog_timeout):
                    raise DeviceFault(
                        "single-pod dispatch exceeded the watchdog",
                        kind="timeout")
                out = self._read_back(out, ev)
                total = _host_array(out["total"])
                feasible = _host_array(out["feasible"])
                if total.dtype.kind == "f" and not np.isfinite(total).all():
                    raise DeviceFault("non-finite scores", kind="invalid")
                return out, total, feasible

            # raises DeviceFault when retries exhaust or the ladder sits
            # at oracle (callers requeue)
            out, total, feasible = self._dispatch_with_retry(attempt)
            n_nodes = self.enc.n_nodes
            n_feasible = int(feasible.sum())
            if n_feasible == 0:
                # statuses walk the LANE space (kernel outputs are
                # lane-indexed); the FitError count stays the live count
                raise FitError(
                    pod, n_nodes, self._statuses(out, self.enc.n_lanes))
            best = self._select_host(total, feasible)
            return ScheduleResult(self.enc.node_names[best], n_nodes, n_feasible)

    def reevaluate(self, pods: List[v1.Pod]) -> List[Tuple[Optional[str], Dict]]:
        """Batched re-evaluation of FAILED pods against current state: per
        pod, (best node | None, per-node failure statuses), every pod of a
        shape group against the same cluster state."""
        results: List[Tuple[Optional[str], Dict]] = []
        with self._lock:
            self._flush_pending()
            if self.ladder.rung() <= RUNG_ORACLE:
                # fully demoted: no device dispatch at all
                return [(RETRY_NODE, {}) for _ in pods]
            # same teardown discipline as schedule()
            self._invalidate_session("reevaluate")
            with self._on_stream():
                c = self._cluster_for_lead(self.enc.device_state(self.device))
            n_nodes = self.enc.n_lanes  # kernel outputs are lane-indexed
            encoded = []
            skipped = set()
            for idx, p in enumerate(pods):
                try:
                    encoded.append({
                        k: v for k, v in self.pe.encode(p).items()
                        if not k.startswith("_")
                    })
                except VolumeResolutionChanged:
                    encoded.append(None)
                    skipped.add(idx)
            # group by shape signature so each group stacks; fixed-width
            # chunks (rows padded by repeating row 0 — pads discarded)
            CHUNK = 32
            out_rows: List[Tuple[Dict, int]] = [None] * len(pods)
            by_shape: Dict[Tuple, List[int]] = {}
            for idx, e in enumerate(encoded):
                if idx in skipped:
                    continue
                by_shape.setdefault(shape_signature(e), []).append(idx)
            for group in by_shape.values():
                for lo in range(0, len(group), CHUNK):
                    chunk = group[lo:lo + CHUNK]
                    pad = CHUNK - len(chunk)
                    stacked = {
                        k: np.stack(
                            [np.asarray(encoded[g][k]) for g in chunk]
                            + [np.asarray(encoded[chunk[0]][k])] * pad
                        )
                        for k in encoded[chunk[0]]
                    }
                    try:
                        if self.ladder.rung() <= RUNG_ORACLE:
                            continue  # demoted mid-loop: rest re-gates
                        self._check_dispatch_fault()
                        with self._on_stream():
                            outs = schedule_pods(
                                c, self._pod_tensors(stacked), self.weights)
                            ev = self._record_event()
                        if not self._wait_ready(ev, self.watchdog_timeout):
                            raise DeviceFault(
                                "re-evaluation dispatch exceeded the "
                                "watchdog", kind="timeout")
                        outs = {k: v.numpy() for k, v in
                                self._read_back(outs, ev).items()}
                    except DeviceFault as e:
                        self._device_fault_locked(e.kind)
                        continue
                    except Exception:  # noqa: BLE001 — device-path error
                        self._device_fault_locked("raise")
                        continue
                    for row, g in enumerate(chunk):
                        out_rows[g] = (outs, row)
            for g, pod in enumerate(pods):
                if g in skipped:
                    results.append((RETRY_NODE, {}))  # prompt re-gate
                    continue
                if out_rows[g] is None:
                    results.append((RETRY_NODE, {}))  # faulted chunk
                    continue
                outs, row = out_rows[g]
                feasible = outs["feasible"][row][:n_nodes]
                if feasible.any():
                    total = outs["total"][row][:n_nodes]
                    best = self._select_host(total, feasible)
                    results.append((self.enc.node_names[best], {}))
                else:
                    results.append(
                        (None, self._statuses(outs, n_nodes, row=row))
                    )
        return results

    # -- pipelined batch API -----------------------------------------------
    # The session dispatch is ASYNC: schedule() enqueues on the backend's
    # stream and returns device tensors; batch k+1's scan chains on k's
    # carry in stream order. dispatch_many/harvest expose that to a
    # three-stage pipeline: the dispatching thread encodes + enqueues
    # batch k+1 (its per-batch uploads are non-blocking copies from
    # pinned buffers), the device scans batch k, and the harvesting
    # thread reads back + assumes batch k-1.

    def dispatch_many(self, pods: List[v1.Pod]) -> "_BatchHandle":
        """Dispatch a batch; returns a handle for harvest(). Up to
        `max_pending` batches may be outstanding — a dispatch beyond that
        harvests the OLDEST first. Falls back to the synchronous path
        (ready handle) when the batch can't ride the live session (bound
        pods, mixed shapes, unknown templates or no session yet)."""
        with self._lock:
            try:
                return self._dispatch_many(pods)
            finally:
                self.dispatches += 1

    def _dispatch_many(self, pods: List[v1.Pod]) -> "_BatchHandle":
        h = _BatchHandle(list(pods))
        with self._lock:
            while len(self._pending) >= max(1, self.max_pending):
                if self.async_harvest_drain:
                    self._pending_cv.wait(0.2)
                    continue
                self._harvest_locked()
            if pods and not self.speculation:
                # KTPU_SPECULATION=0: never chain a scan on a carry whose
                # decisions have not been harvested + validated
                self._flush_pending()
            if pods and self._session is not None \
                    and self.ladder.rung() > RUNG_ORACLE and all(
                not p.spec.node_name for p in pods
            ):
                try:
                    with tracing.span("encode", "encode", n=len(pods)):
                        clean = [
                            {k: v for k, v in self.pe.encode(p).items()
                             if not k.startswith("_")}
                            for p in pods
                        ]
                except VolumeResolutionChanged:
                    clean = None  # schedule_many handles it per pod
                if clean is None:
                    h.results = self.schedule_many(pods)
                    return h
                sig0 = shape_signature(clean[0])
                if (
                    all(shape_signature(a) == sig0 for a in clean[1:])
                    and all(
                        template_fingerprint(a) in self._session._fps
                        for a in clean
                    )
                ):
                    try:
                        # queued cluster-event deltas land first (one
                        # fused launch chained on the carry)
                        self._apply_session_deltas_locked()
                        if self._session is None:
                            # delta apply failed: structural fallback
                            h.results = self.schedule_many(pods)
                            return h
                        self._check_dispatch_fault()
                        sp = tracing.span(
                            "dispatch", "dispatch", n=len(pods),
                            rung=self.ladder.rung(),
                            speculative=bool(self._pending),
                            pipelined=True,
                            group_pos=len(self._pending),
                        ) if tracing.enabled() else tracing.NOOP_SPAN
                        with sp, devtime.TIMELINE.maybe_profile(
                                "dispatch"), self._on_stream():
                            ys = self._session.schedule(clean)  # async
                            h.event = self._record_event()
                        if devtime.enabled():
                            h.dt = devtime.launch(
                                "kernel", "dispatch",
                                h2d_bytes=devtime.payload_bytes(clean),
                                n=len(pods),
                            )
                    except Exception:  # noqa: BLE001 — dispatch-time fault:
                        # the enqueue failed BEFORE the scan chained onto
                        # the carry, so earlier pending batches stay
                        # valid; this batch re-drives synchronously
                        # through the guarded (retrying) path
                        self._device_fault_locked("raise")
                        h.results = self.schedule_many(pods)
                        return h
                    h.ys = ys
                    h.decide = type(self._session).decisions
                    h.conflicts = getattr(
                        type(self._session), "conflict_stats", None)
                    h.node_names = list(self.enc.node_names)
                    h.deadline = _time.monotonic() + self.watchdog_timeout
                    # chained on a not-yet-harvested carry: speculative
                    h.speculative = bool(self._pending)
                    if tracing.RECORDER.pod_level():
                        h.prov = {
                            "rung": self.ladder.mode(),
                            "session": type(self._session).__name__,
                            "build_reason": self._last_build,
                            "speculative": h.speculative,
                        }
                    self._pending.append(h)
                    return h
            h.results = self.schedule_many(pods)  # re-entrant: RLock
        return h

    def harvest(self, handle: "_BatchHandle") -> List[Tuple[v1.Pod, Optional[str]]]:
        if handle.ys is not None and handle.results is None:
            # wait for the device OUTSIDE the backend lock, so a thread
            # parked here does not block the next dispatch; the wait is
            # watchdog-bounded: a wedged device marks the handle timed
            # out and the locked harvest runs recovery
            with tracing.span("wait", "wait", n=len(handle.group),
                              speculative=handle.speculative) as sp:
                if not self._wait_ready(handle.event, self.watchdog_timeout):
                    handle.timed_out = True
                    sp.set(timed_out=True)
        with self._lock:
            # strictly FIFO: older batches' decisions are ground truth
            # for this one — land them first
            while handle.results is None and self._pending:
                self._harvest_locked()
        assert handle.results is not None, "harvest of an abandoned handle"
        return handle.results

    def _flush_pending(self) -> None:
        """Apply every outstanding batch's assumes to the host encoding.
        MUST run (under the lock) before anything treats the encoding as
        ground truth."""
        while self._pending:
            self._harvest_locked()

    def _apply_decisions_locked(
        self, pods: List[v1.Pod], decisions: List[int],
        node_names: List[str], prov: Optional[Dict] = None,
        explain: Optional[List[Dict]] = None,
    ) -> List[Tuple[v1.Pod, Optional[str]]]:
        """Land a batch's harvested decisions in the host encoding (the
        host half of the assume; the device carry already holds them)."""
        results: List[Tuple[v1.Pod, Optional[str]]] = []
        rec = tracing.RECORDER
        pod_level = rec.pod_level()
        live = self._session is not None
        record_assume = self._session_assumed.add
        enc_add = self.enc.add_pod
        append = results.append
        for i, (g, best) in enumerate(zip(pods, decisions)):
            if best < 0:
                append((g, None))
                node = None
            else:
                node = node_names[best]
                if live:
                    record_assume(
                        (g.metadata.namespace, g.metadata.name, node)
                    )
                enc_add(g, node)
                append((g, node))
            if pod_level:
                if explain is not None and i < len(explain):
                    rec.provenance(
                        v1.pod_key(g), node=node,
                        explain_topk=_explain_topk(explain[i], node_names),
                        **(prov or {}),
                    )
                else:
                    rec.provenance(
                        v1.pod_key(g), node=node, **(prov or {}),
                    )
        return results

    def _miss_speculative(self, handles) -> None:
        """Speculation-miss accounting for handles whose chained-on carry
        was invalidated before they could harvest."""
        from .metrics import speculative_dispatches

        n = sum(1 for h in handles if h.speculative)
        if n:
            speculative_dispatches.inc(n, outcome="miss")
            tracing.event("speculation-miss", "fault", n=n)
            for _ in range(n):
                self._notify_health(
                    "Warning", "SpeculationMissRedrive",
                    "speculative dispatch re-driven: the carry it "
                    "chained on was invalidated",
                )

    def _close_launch_devtime(self, h, ys) -> None:
        """Commit a dispatched batch's device-timeline record: ready is
        stamped when the pipeline's own wait returned."""
        lt = h.dt
        if lt is None:
            return
        h.dt = None
        if not devtime.enabled():
            return  # shed mid-flight: drop, don't record a torn window
        ready = _time.perf_counter()
        lt.done(
            d2h_bytes=devtime.payload_bytes(ys) if isinstance(ys, dict)
            else 0,
            speculative=h.speculative,
        )
        self._feed_device_time("kernel", ready - lt.submit)

    def _harvest_locked(self) -> None:
        h = self._pending.popleft()
        self._pending_cv.notify_all()  # back-pressured dispatchers
        hsp = tracing.span("harvest", "harvest", n=len(h.group),
                           speculative=h.speculative)
        try:
            with hsp:
                if h.timed_out or not self._wait_ready(
                    h.event, self.watchdog_timeout
                    if h.deadline is None
                    else h.deadline - _time.monotonic()
                ):
                    raise DeviceFault(
                        "device wait exceeded the dispatch watchdog",
                        kind="timeout")
                # one explicit readback after the batch's event
                ys = self._read_back(h.ys, h.event)
                if self.faults is not None:
                    ys = self.faults.corrupt_harvest(
                        ys, rung=self.ladder.rung())
                decisions = h.decide(ys)
                self._validate_decisions(decisions, len(h.node_names), ys)
        except DeviceFault as e:
            self._recover_dispatches_locked(e.kind, h)
            return
        except Exception:  # noqa: BLE001 — decode blew up on garbage
            logger.warning("harvest decode failed", exc_info=True)
            self._recover_dispatches_locked("invalid", h)
            return
        self._close_launch_devtime(h, ys)
        self.ladder.record_success()
        if (self.explain and self.explain_harvest
                and isinstance(ys, dict) and "expl_bits" in ys):
            try:
                h.explain = HoistedSession.explain_payload(ys)
            except Exception:  # noqa: BLE001 — attribution must never
                # fail a harvest that already produced valid decisions
                logger.warning("explain decode failed", exc_info=True)
            else:
                from .metrics import explain_harvests

                explain_harvests.inc()
        from .metrics import (
            conflict_replays,
            multipod_conflicts,
            speculative_dispatches,
        )

        if h.speculative:
            speculative_dispatches.inc(outcome="hit")
        n_conf, suffix = (
            h.conflicts(ys) if h.conflicts is not None else (0, None)
        )
        if n_conf:
            multipod_conflicts.inc(n_conf)
        if h.prov is not None:
            h.prov["spec_outcome"] = "hit" if h.speculative else None
            h.prov["conflicts"] = n_conf
        if suffix is None:
            if n_conf:
                # hoisted multipod: conflicts were replayed IN-DEVICE
                conflict_replays.inc(n_conf)
            h.results = self._apply_decisions_locked(
                h.group, decisions, h.node_names, prov=h.prov,
                explain=h.explain)
            return
        # conflict SUFFIX (the kernel session's multipod contract): pods
        # [suffix:] were left UNCOMMITTED — the carry holds exactly the
        # committed prefix. Land the prefix, then replay the suffix
        # through the session. LATER pending batches chained on a carry
        # missing the suffix commits: abandon them, tear the session
        # down, and re-decide them in dispatch order.
        results = self._apply_decisions_locked(
            h.group[:suffix], decisions[:suffix], h.node_names,
            prov=h.prov)
        conflict_replays.inc(len(h.group) - suffix)
        dropped = list(self._pending)
        self._pending.clear()
        self._pending_cv.notify_all()
        if dropped:
            self._miss_speculative(dropped)
            for hd in dropped:
                hd.ys = None
            self._invalidate_session("conflict-replay")
        with tracing.span("conflict-suffix-replay", "replay",
                          n=len(h.group) - suffix,
                          n_dropped=len(dropped)):
            results.extend(self.schedule_many(h.group[suffix:]))
        h.results = results
        for hd in dropped:
            hd.results = self.schedule_many(hd.group)

    def schedule_many(self, pods: List[v1.Pod]) -> List[Tuple[v1.Pod, Optional[str]]]:
        """Batched sequential scheduling: groups same-shape pending pods
        into single session dispatches; bound pods go one at a time.
        Decisions are applied to the encoding as if each pod was assumed;
        callers MUST follow up with cache.assume_pod for each bound pod
        (which re-syncs the same rows idempotently via the listener
        hooks)."""
        results: List[Tuple[v1.Pod, Optional[str]]] = []
        with self._lock:
            self._flush_pending()
            i = 0
            while i < len(pods):
                pod = pods[i]
                try:
                    p = self.pe.encode(pod)
                except VolumeResolutionChanged:
                    results.append((pod, RETRY_NODE))  # prompt re-gate
                    i += 1
                    continue
                if pod.spec.node_name:
                    try:
                        # schedule() invalidates the session at entry, so
                        # the term/port-table writes of this add_pod
                        # cannot leak into a stale device carry
                        r = self.schedule(pod)
                        node = r.suggested_host
                        # never mutate the caller's pod; the node rides
                        # the result tuple
                        self.enc.add_pod(pod, node)
                        results.append((pod, node))
                    except FitError:
                        results.append((pod, None))
                    except DeviceFault:
                        results.append((pod, RETRY_NODE))
                    i += 1
                    continue
                # group a maximal run of pending, shape-identical pods
                group = [pod]
                arrays = [p]
                sig = shape_signature({k: v for k, v in p.items() if not k.startswith("_")})
                j = i + 1
                while j < len(pods):
                    if pods[j].spec.node_name:
                        break
                    try:
                        q = self.pe.encode(pods[j])
                    except VolumeResolutionChanged:
                        break  # handled when the outer loop reaches j
                    qa = {k: v for k, v in q.items() if not k.startswith("_")}
                    if shape_signature(qa) != sig:
                        break
                    group.append(pods[j])
                    arrays.append(q)
                    j += 1
                sp = tracing.span(
                    "dispatch-sync", "dispatch", n=len(group),
                    rung=self.ladder.rung(), pipelined=False,
                ) if tracing.enabled() else tracing.NOOP_SPAN
                with sp:
                    decisions = self._session_schedule_guarded([
                        {k: v for k, v in a.items()
                         if not k.startswith("_")}
                        for a in arrays
                    ])
                if decisions is None:
                    # retries exhausted (or fully demoted): the whole
                    # group re-gates via the queue exactly once
                    results.extend((g, RETRY_NODE) for g in group)
                    i = j
                    continue
                prov = None
                if tracing.RECORDER.pod_level():
                    prov = {
                        "rung": self.ladder.mode(),
                        "session": type(self._session).__name__
                        if self._session is not None else "",
                        "build_reason": self._last_build,
                        "speculative": False,
                    }
                results.extend(self._apply_decisions_locked(
                    group, decisions, self.enc.node_names, prov=prov))
                i = j
        return results

    def _session_schedule(self, arrays: List[Dict]) -> List[int]:
        """Schedule a batchable pending group through the cross-cycle
        session, (re)building it when torn down or when a new template
        fingerprint appears."""
        fps = [template_fingerprint(a) for a in arrays]
        uniq: Dict = {}
        for fp, a in zip(fps, arrays):
            uniq.setdefault(fp, a)
        if len(uniq) > self.MAX_SESSION_TEMPLATES:
            # one batch alone exceeds the session template budget: a
            # one-shot hoisted dispatch from the synced encoding (the
            # reference tears the session down first; so does the port)
            self._invalidate_session("template-overflow")
            with self._on_stream():
                cluster = self._cluster_for_lead(
                    self.enc.device_state(self.device))
                decisions, _ = schedule_batch_hoisted(
                    cluster, arrays, self.weights
                )
            return decisions
        # an encoding rebuild (vocab/table growth) changes array shapes;
        # cached templates from before it can no longer stack
        sig = shape_signature(arrays[0])
        stale = [
            fp for fp, a in self._known_templates.items()
            if shape_signature(a) != sig
        ]
        if stale:
            for fp in stale:
                del self._known_templates[fp]
            self._invalidate_session("shape-change")
        new = [fp for fp in uniq if fp not in self._known_templates]
        if new:
            for fp in new:
                self._known_templates[fp] = uniq[fp]
            # evict oldest templates NOT used by this batch
            while len(self._known_templates) > self.MAX_SESSION_TEMPLATES:
                for old in list(self._known_templates):
                    if old not in uniq:
                        del self._known_templates[old]
                        break
                else:
                    break
            self._invalidate_session("new-template")
        if self._session is None:
            self._session = self._build_session()
        else:
            # a surviving session may carry queued cluster-event deltas:
            # reconcile before this scan chains on the carry
            self._apply_session_deltas_locked()
            if self._session is None:  # apply failed -> rebuild now
                self._session = self._build_session()
        sess = self._session

        def run(batch):
            with self._on_stream():
                ys = sess.schedule(batch)
                ev = self._record_event()
            # bound the wait with the watchdog before decoding: the
            # synchronous re-decide path (fault recovery!) must not hang
            # on the very wedge it is recovering from
            if not self._wait_ready(ev, self.watchdog_timeout):
                raise DeviceFault(
                    "synchronous dispatch exceeded the watchdog",
                    kind="timeout")
            return self._read_back(ys, ev)

        return schedule_exact(sess, arrays, run)

    def _build_session(self):
        """Span-wrapped _build_session_impl: records the build and pins
        the session-kind/rebuild-reason pair the provenance reports."""
        with tracing.span("session-build", "session",
                          reason=self._last_invalidate) as sp:
            s = self._build_session_impl()
            self._last_build = (
                f"{type(s).__name__}/{self._last_invalidate or 'initial'}"
            )
            sp.set(kind=type(s).__name__)
            up, self._upload_seconds = self._upload_seconds, 0.0
            if up:
                self._feed_device_time("transfer", up, session=s)
            return s

    def _build_session_impl(self):
        """The kernel session (ops/scan.py ScanSession; on a mesh
        ops/sharded_scan.py ShardedScanSession) when the rung and the
        cluster shape allow it, else the torch hoisted session (on a mesh,
        on its lead device over the padded cluster) — identical decisions
        either way. Every build is counted in
        scheduler_tpu_session_builds_total{kind, reason, shards};
        downgrades are logged."""
        from .metrics import session_builds

        sh = self._shards_label()
        templates = list(self._known_templates.values())
        with self._on_stream():
            if devtime.enabled():
                lt = devtime.launch("transfer", "session-upload")
                cluster = self.enc.device_state(self.device)
                self._sync_stream()
                lt.h2d_bytes = devtime.payload_bytes(cluster)
                lt.done()
                self._upload_seconds = _time.perf_counter() - lt.submit
            else:
                cluster = self.enc.device_state(self.device)
            # KTPU_EXPLAIN (or an armed shadow sentinel): per-plugin
            # attribution exists only on the hoisted session's outputs —
            # kernel builds demote, loudly, while the knob is on
            explain_k = self.explain_topk if self.explain else 0
            if explain_k:
                if self.use_kernel:
                    logger.warning(
                        "explain mode: hoisted session instead of the "
                        "kernel session")
                session_builds.inc(kind="hoisted", reason="explain",
                                   shards=sh)
                return HoistedSession(self._cluster_for_lead(cluster),
                                      templates, self.weights,
                                      explain_k=explain_k,
                                      device=self.device)
            # a DEMOTED backend (rung below its top) builds the hoisted
            # session; the probe loop re-promotes and invalidates, so the
            # NEXT build climbs back
            demoted = self.ladder.rung() < self.ladder.top
            if self.mesh is not None and self.use_kernel:
                return self._build_mesh_session(cluster, templates, demoted)
            if self.use_kernel and demoted:
                logger.warning(
                    "ladder-demoted session build: %s instead of the "
                    "kernel session", self.ladder.mode(),
                )
                session_builds.inc(kind="hoisted", reason="ladder-demoted",
                                   shards=sh)
            elif self.use_kernel:
                try:
                    s = ScanSession(cluster, templates, self.weights,
                                    device=self.device)
                except SessionUnsupported as e:
                    logger.warning(
                        "kernel session unsupported for this workload "
                        "shape (%s); downgrading to the hoisted session", e,
                    )
                    session_builds.inc(kind="hoisted", reason=e.reason,
                                       shards=sh)
                else:
                    s.staging_depth = max(1, self.max_pending)
                    session_builds.inc(kind="kernel", reason="", shards=sh)
                    return s
            else:
                session_builds.inc(
                    kind="hoisted",
                    reason=("use_kernel off" if self.device.type == "cuda"
                            else "platform is not cuda"),
                    shards=sh)
            return HoistedSession(self._cluster_for_lead(cluster), templates,
                                  self.weights, device=self.device)

    def _build_mesh_session(self, cluster: Dict, templates: List[Dict],
                            demoted: bool):
        """The mesh's session: ShardedScanSession at the kernel rung
        (session_builds{kind="kernel", reason="mesh-sharded"}), or the
        hoisted session on the lead device over the padded cluster where
        the reference takes its GSPMD hoisted session: a demoted ladder
        ("mesh-ladder-demoted") and a shape the sharded session refuses
        ("mesh-<reason>"). Called on the backend's stream."""
        from .metrics import session_builds

        sh = self._shards_label()
        if demoted:
            logger.warning("ladder-demoted mesh session build: %s instead "
                           "of the sharded session", self.ladder.mode())
            session_builds.inc(kind="hoisted", reason="mesh-ladder-demoted",
                               shards=sh)
        else:
            try:
                s = ShardedScanSession(cluster, templates, self.weights,
                                       mesh=self.mesh)
            except SessionUnsupported as e:
                logger.warning(
                    "sharded session unsupported for this workload shape "
                    "(%s); the mesh rides the hoisted session on its lead "
                    "device", e)
                # mesh- prefix: a mesh downgrade is told apart from a
                # single-device one; slugs stay bounded
                session_builds.inc(kind="hoisted", reason=f"mesh-{e.reason}",
                                   shards=sh)
            else:
                s.staging_depth = max(1, self.max_pending)
                session_builds.inc(kind="kernel", reason="mesh-sharded",
                                   shards=sh)
                return s
        return HoistedSession(self._cluster_for_lead(cluster), templates,
                              self.weights, device=self.device)

    # -- helpers -----------------------------------------------------------

    def _select_host(self, total: np.ndarray, feasible: np.ndarray) -> int:
        """selectHost, FIRST-MAX tie-break — the convention of every
        kernel path (the reference reservoir-samples ties,
        generic_scheduler.go:152; a randomized pick can never be
        bit-reproducible across differently-batched paths)."""
        masked = np.where(feasible, total, np.iinfo(np.int64).min)
        return int(np.argmax(masked))

    def _statuses(
        self, out: Dict, n_nodes: int, row: Optional[int] = None
    ) -> Dict[str, Status]:
        """row selects one pod of a batched output."""
        statuses: Dict[str, Status] = {}

        def arr(key):
            a = _host_array(out[key])
            return a[row] if row is not None else a

        masks = {k: arr(k) for k, _ in MASK_PLUGINS}
        pts_unres = arr("pts_unresolvable")
        ipa_unres = arr("ipa_unresolvable")
        names = self.enc.node_names
        for i in range(n_nodes):
            if i >= len(names) or names[i] is None:
                continue  # tombstoned lane: no node to report on
            failed = [name for key, name in MASK_PLUGINS if not masks[key][i]]
            if not failed:
                continue
            unresolvable = (
                ("PodTopologySpread" in failed and pts_unres[i])
                or ("InterPodAffinity" in failed and ipa_unres[i])
                or "NodeName" in failed
                or "NodeAffinity" in failed
            )
            reasons = [f"{name}" for name in failed]
            statuses[names[i]] = (
                Status.unschedulable_and_unresolvable(*reasons)
                if unresolvable
                else Status.unschedulable(*reasons)
            )
        return statuses
