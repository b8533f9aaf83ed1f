"""Declarative manifests for the port's ktpu-lint checkers.

Counterpart of kubernetes_tpu/analysis/manifests.py: the same five
contracts, held over ``kubernetes_tpu_torch/``. Everything the checkers
treat as policy — which modules are hot, which are observability-only,
which APIs mutate scheduling state, which counters are fault-seam
counters — lives HERE as data, so tightening a contract is a manifest
edit plus a fixture, never a checker rewrite. Paths are repo-relative
with forward slashes.

What differs from the reference is data only: every path and dotted
module names the port's package (a dotted-prefix match on the
reference's ``ops`` would not match the port's), ``torch`` is a taint
root, and the README knob table the knob-registry checker reads is the
port's own span of the README (``KNOB_TABLE_BEGIN`` .. ``KNOB_TABLE_END``).
"""

from __future__ import annotations

import re

# the package the checkers walk, and the command that lints it
PACKAGE = "kubernetes_tpu_torch"
CLI = "python -m kubernetes_tpu_torch.analysis"

# ---------------------------------------------------------------------------
# host-sync-in-hot-path (checker: host-sync)
#
# Modules on the dispatch hot path: nothing here may trigger an
# implicit host<->device sync without a `# ktpu: allow-sync(reason)`
# pragma. Directory entries (trailing "/") cover every file below them.

HOT_PATHS = (
    "kubernetes_tpu_torch/ops/",
    "kubernetes_tpu_torch/scheduler/tpu_backend.py",
)

# import roots whose call results are device values (taint sources):
# the reference's (its fixture corpus runs on these checkers too) and
# torch, whose tensors may live on the card
DEVICE_ROOTS = frozenset({"jax", "jnp", "lax", "pl", "pltpu", "torch"})

# parameter names that conventionally carry device values (session
# trees, scan carries, harvested outputs) in the hot modules — a
# function taking one of these starts with it tainted
DEVICE_PARAM_NAMES = frozenset({
    "ys", "carry", "tp", "xs", "S", "tree", "cluster", "meta", "match",
})

# attribute names that hold device values on session/backend objects:
# ops/scan.py and ops/hoisted.py `_carry`, ops/scan.py `_statics`, the
# prologue's tables `_S`, `_tp`, `_c_static` (ops/hoisted.py, ops/scan.py),
# a mesh group's `carry` (ops/sharded_scan.py), models/encoding.py
# `device_state`
DEVICE_ATTRS = frozenset({"_carry", "_statics", "_S", "_tp", "_c_static",
                          "carry", "device_state"})

# calls (by terminal name) that produce device values: models/encoding.py
# `device_state`, ops/hoisted.py `_initial_carry` and `_run`, ops/scan.py
# `_initial_carry` and `_dispatch_mode`, ops/batch.py
# `_scan_batch_packed`, ops/kernel.py `schedule_pod(s)`, the kernels'
# wrappers (ops/scan_kernel.py `scan_full`, `carry_delta`;
# ops/whatif_kernel.py `tables`, `whatif_context`, `whatif_device`) and
# ops/whatif.py `_gang_fits_run`
DEVICE_PRODUCERS = frozenset({
    "device_state", "_initial_carry", "_run", "_dispatch_mode",
    "_scan_batch_packed", "schedule_pod", "schedule_pods", "scan_full",
    "carry_delta", "tables", "whatif_context", "whatif_device",
    "_gang_fits_run",
})

# numpy aliases whose asarray/array on a device value is a D2H readback
NUMPY_ROOTS = frozenset({"np", "numpy", "onp"})

# ---------------------------------------------------------------------------
# knob-registry (checker: knob-registry)

KNOBS_MODULE = "kubernetes_tpu_torch/utils/knobs.py"
KNOB_PREFIX = "KTPU_"
KNOB_TOKEN_RE = re.compile(r"KTPU_[A-Z0-9_]+")
README = "README.md"
# the port's knob table: the README lines between these two markers
# (rendered by `python -m kubernetes_tpu_torch.analysis --knob-table`);
# a README without them is read whole, as the reference reads it
KNOB_TABLE_BEGIN = "<!-- kubernetes_tpu_torch knob table: begin -->"
KNOB_TABLE_END = "<!-- kubernetes_tpu_torch knob table: end -->"

# ---------------------------------------------------------------------------
# decision-inertness (checker: decision-inert)
#
# Observability-only modules: they may read anything, but must never
# import the scheduling-state surface or call its mutating APIs — a
# trace/explain/timeline code path that can change a placement is the
# exact bug class the reference's observability work promised away.

DECISION_INERT_MODULES = (
    "kubernetes_tpu_torch/utils/tracing.py",
    "kubernetes_tpu_torch/utils/devtime.py",
    "kubernetes_tpu_torch/utils/selfstats.py",
    "kubernetes_tpu_torch/scheduler/explain.py",
)

# modules an observability-only module may not import (the mutating
# scheduling-state surface; dotted-prefix match)
INERT_DENY_IMPORTS = (
    "kubernetes_tpu_torch.scheduler.internal.cache",
    "kubernetes_tpu_torch.scheduler.tpu_backend",
    "kubernetes_tpu_torch.scheduler.scheduler",
    "kubernetes_tpu_torch.ops",
    "kubernetes_tpu_torch.parallel",
    "kubernetes_tpu_torch.cluster",
)

# mutating method names of the carry/session/cache surface: calling one
# from an observability-only module is a violation regardless of how
# the receiver was obtained
INERT_DENY_CALLS = frozenset({
    "assume", "finish_binding", "forget", "expire_assumed",
    "add_pod", "remove_pod", "update_pod",
    "add_node", "remove_node", "update_node",
    "apply_deltas", "dispatch_many", "schedule_many",
    "set_shadow_sample", "set_shadow_rate_only",
    "_invalidate_session", "_apply_decisions_locked",
})

# ---------------------------------------------------------------------------
# seam-dump pairing (checker: seam-pairing)
#
# Fault-seam counters must bump WITH a flight-recorder dump: an `.inc()`
# on one of these is legal only in a function that also calls
# `dump_seam` (or inside metrics.py, which defines the paired helper
# itself).

SEAM_COUNTERS = frozenset({
    "device_faults", "worker_restarts", "parity_drift", "trace_dumps",
})
SEAM_PAIR_CALL = "dump_seam"
SEAM_EXEMPT_MODULES = ("kubernetes_tpu_torch/scheduler/metrics.py",)

# ---------------------------------------------------------------------------
# lock-order (checker: lock-order)

# a `with <expr>:` context whose terminal name matches this is treated
# as a lock acquisition
LOCK_NAME_RE = re.compile(r"(?:^|_)(?:lock|mutex|cv|cond|condition)$|_lock$",
                          re.IGNORECASE)

# with-contexts that look lock-ish but are not exclusive locks (never
# graph nodes)
LOCK_NAME_DENY = frozenset({"self"})
