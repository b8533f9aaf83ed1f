"""`scan_full`: the batched scheduling scan, as one CUDA kernel launch.

Replaces the Pallas kernel of kubernetes_tpu/ops/pallas_scan.py
(`_build_kernel` -> `kernel`, launched by `_dispatch`) in its modes, as
instantiations of one CUDA kernel: for sessions without affinity-term
templates (ur = 0) and with them (ur > 0: the InterPodAffinity term
machinery, pallas_scan.py:1552-1592, :1680-1693, :1417-1435), each in

- mode "full" with one pod per step (`scan_full`, `scan_full_ipa`): for
  each pod of the batch, in order, against the live carry: the static
  mask, NodeResourcesFit on GCD-rescaled int32 resources, the
  PodTopologySpread filter, with ur > 0 the IPA filter over the
  assumed-pod counts (D1-D3), balanced / least allocated, the
  PodTopologySpread score with its log(n + 2) weights, the
  InterPodAffinity normalize (with ur > 0 over the static raw score plus
  the assumed-pod terms D4+D5), the taint and node-affinity default
  normalize, the weighted total and the first-max argmax (min lane among
  the maxima); then the commit of the chosen node into the carries
  `requested`, `nzpc`, `cnt_fn`, `cnt_sn` (and `ucnt`, `kcnt` with
  ur > 0), in place;
- mode "full" with mk > 1 pods per step (`scan_multi`, `scan_multi_ipa`;
  `multi_group`, :1798-1866): each group of mk pods is evaluated against
  the group-start carry, then committed in order, each commit gated by
  the exact conflict test (same node, PTS match lanes, IPA template
  interference, the fit / balanced / least recheck against the current
  carry). The first conflict starts the suffix: it and every later pod
  of the batch stay uncommitted and are flagged in out row 3, for the
  host to replay (scheduler/tpu_backend.py `schedule_exact`);
- mode "eval" (`scan_eval`, `scan_eval_ipa`; :1751-1766): out rows 0-2
  per pod, every pod against the same carry, the carries untouched;
- mode "apply" (`scan_apply`, `scan_apply_ipa`; :1736-1746): the commit
  of forced (lane | -1, ok) pairs, without evaluating;
- the delta mode (`scan_delta`, launched by `carry_delta`): the
  counterpart of the reference's jnp program `_carry_delta_scan`
  (pallas_scan.py:168-195), signed cluster-event deltas on the carry,
  each the commit's column update at the event's node with its own
  payload. Its additions commute, so it is a kernel of its own
  (`carry_delta_kernel`), an order-free grid over every SM: block (lane
  tile, carry row), each thread the sole writer of its lanes, summing the
  events whose key (the node, or its pair id) equals its lanes'. It
  serves sessions with and without affinity-term templates (`ucnt` /
  `kcnt` are never touched, as in the reference).

What bounds it on the card: not bytes and not arithmetic, but the chain
of dependent steps. Each pod needs whole-node-axis reductions (the PTS
minimum, the feasible count and zone presence, the PTS score range, the
argmax) before the next can start, and its commit before the next pod's
filter. The design: one thread block strides the Np node lanes, keeps
the pod loop inside the kernel (one launch per batch), does each
reduction in shared memory, holds the scalar table (and the IPA gate
matrices) in shared memory, and updates the carries in global memory
column-locally — every thread only ever writes its own lanes, so the
same-pair masks need nothing but `prow[row, best]`, read after the block
agrees on `best`. At 5000 nodes the per-step working set is a few MB and
stays in the 50 MB L2.

Mode "full" with one pod per step, the main path, runs by default on a
thread-block cluster instead (`CLUSTER` blocks, on as many SMs), with
(ur > 0) or without (ur = 0) the IPA carries: block rank r owns the
contiguous lane slice `cluster_slices(Np, cb)[r]`, each of the four
per-pod reductions is the block's own followed by one cluster barrier and
a fold over the blocks' values in distributed shared memory, and the
carries stay in global memory, each lane touched only by its owner. The
one carry that is not lane-local, `kcnt` (read by every block for the
per-pod IPA scalars), is added to by rank 0 alone and read after the next
pod's first cluster barrier (the order is stated in csrc/scan_full.cu).
The reductions are integer min / max / sum, OR and the packed argmax key,
so any cluster size decides bit for bit as one block.
`scan_full(..., cluster=1)` forces the one-block kernel.

`scan_full_reference` is the plain PyTorch version: a loop over pods of
tensor ops with the same int32 / f32 arithmetic (floor divisions,
truncating casts, no fused multiply-add, IEEE division, the `log_weights`
table), split as the reference is into `eval_pod` and `commit`;
`carry_delta_reference` is the delta mode's, a loop over events that
mirrors `_carry_delta_scan` line for line, and `carry_delta_grouped` the
grid kernel's order-free formulation in plain PyTorch (the tests hold the
two equal). The wrappers `scan_full` and
`carry_delta` send CPU tensors to them and CUDA tensors to the kernel; on
CUDA they raise if the build or the launch fails.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import build as _build
from .kernel import multipod_utilization_conflicts

WEIGHT_ORDER = ("balanced", "image", "ipa", "least", "node_affinity",
                "prefer_avoid", "pts", "taint")
LANE = 128
VZ = 128
POS_BIG = 2 ** 30
NEG_BIG = -(2 ** 30)
MAX_NODE_SCORE = 100

# indices of the per-(template, constraint) scalar blocks
(W_F_VALID, W_S_VALID, W_F_SKEW, W_S_SKEW, W_F_SELF, W_S_FIRST,
 W_F_KEY, W_S_KEY, W_F_PERNO, W_S_PERNO) = range(10)

# IPA statics of a term-template session, in the kernel's argument order
IPA_STATIC_KEYS = ("ipa_stat", "anti_static", "anti_konn", "aff_static",
                   "prow_ipa", "g1", "wanti", "waff", "w3tot", "w45",
                   "gpres")
# the per-template IPA scalar extension: has_aff/self_match_all/aff_total
# [T, 3], anti_valid/aff_valid [T, 8] each, w45_scale
IPA_SCALARS_PER_T = 3 + 2 * 8

MODES = ("full", "eval", "apply")
# the kernel's mode argument (csrc/scan_full.cu MODE_*): "full" with
# mk > 1 is its multi-pod instantiation; MODE_DELTA is `carry_delta`'s
MODE_FULL, MODE_MULTI, MODE_EVAL, MODE_APPLY, MODE_DELTA = range(5)
MAX_MK = 64
# the launched variant per kernel mode, without and with affinity-term
# templates
VARIANTS = {MODE_FULL: "scan_full", MODE_MULTI: "scan_multi",
            MODE_EVAL: "scan_eval", MODE_APPLY: "scan_apply"}

# launches of the CUDA kernel (one per batch or delta flush), in all and
# per variant; the plain versions do not count
LAUNCHES = 0
VARIANT_LAUNCHES = {f"{v}{suffix}": 0 for v in VARIANTS.values()
                    for suffix in ("", "_ipa")}
VARIANT_LAUNCHES["scan_delta"] = 0

# the thread-block cluster sizes the cluster kernel takes (16 is above the
# portable 8), and the default for mode "full", mk = 1: the fastest point of
# chip_smoke.py's ur = 0 sweep on the H100 (PERF.md)
CLUSTER_SIZES = (2, 4, 8, 16)
CLUSTER = 16
# launches of the cluster kernel per cluster size; each also counts under
# VARIANT_LAUNCHES["scan_full"] (or "scan_full_ipa"), the port of the same
# TPU kernel mode
CLUSTER_LAUNCHES = dict.fromkeys(CLUSTER_SIZES, 0)
# threads per block, in both designs (csrc/scan_full.cu THREADS)
THREADS = 1024

# the launcher's pointer arguments, in the order of the kernel's ArgPtr
# enum (csrc/scan_args.cuh); a name absent from a launch is passed as null
ARG_PTRS = ("meta", "match", "scalars", "alloc", "stat", "zid", "regrow_f",
            "zvalid_node_s", "zvalid_s", "konn_f", "konn_s", "shasall",
            "valid_n", "prow_f", "prow_s", "logw", "gmat", "requested",
            "nzpc", "cnt_fn", "cnt_sn", "out", "work", "forced",
            *IPA_STATIC_KEYS, "ucnt", "kcnt", "dnode", "drows")

# dynamic shared memory the kernel may ask for: the card's 227 KB per
# block less room for the kernel's static shared arrays
SMEM_DYNAMIC_MAX = 227 * 1024 - 8 * 1024

SOURCE = Path(__file__).resolve().parent / "csrc" / "scan_full.cu"

_LIB = None


class ClusterUnplaceable(RuntimeError):
    """The card cannot place one thread-block cluster of the asked size
    (`cudaOccupancyMaxActiveClusters` is 0)."""


def cluster_slices(Np: int, cb: int):
    """The cluster kernel's lane partition: [(lo_r, hi_r)] for block ranks
    r < cb, S = ceil(Np / cb), lo_r = min(r * S, Np), hi_r = min(lo_r + S,
    Np). Contiguous, each lane in exactly one slice, the empty ones (if
    any) at the tail; thread (n - lo_r) % THREADS of rank r owns lane n."""
    S = -(-Np // cb)
    slices = []
    for r in range(cb):
        lo = min(r * S, Np)
        slices.append((lo, min(lo + S, Np)))
    return slices

# XLA's CPU f32 log (the Cephes / Eigen `plog` polynomial): the SQRT(1/2)
# fold threshold, the 9 polynomial coefficients p0..p8, and ln 2 split as
# q2 + q1 (bit patterns, so the constants are exactly the compiled ones)
_LOG_SQRTHF = 0x3F3504F3
_LOG_P = (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
          0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375


def _f32(bits: int) -> np.float32:
    return np.array(bits, np.uint32).view(np.float32)[()]


def _fma(a, b, c) -> np.ndarray:
    """f32 fused multiply-add, emulated: the f32 x f32 product is exact
    in f64, and the f64 sum rounded to f32 equals the fused result on
    every argument log_weights is held to (tests/test_torch_scan.py)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def log_weights(n: int) -> np.ndarray:
    """f32 table [n]: logw[i] == log(f32(i) + 2) exactly as the reference
    computes the PodTopologySpread score weight (`jnp.log` on the CPU,
    pallas_scan.py:1655), bit for bit.

    The weight's argument is always an integer in [0, Np] (n_scored or a
    zone count), so the kernel and the plain version both index this
    table instead of calling a log of their own: a correctly rounded log
    (torch's) differs from XLA's by one ulp at 575 of the first 65536
    arguments. This is a numpy emulation of XLA's CPU f32 log, operation
    by operation in f32, with the multiply-adds fused where the compiled
    code fuses them."""
    f32 = np.float32
    v = np.arange(n, dtype=f32) + f32(2.0)     # >= 2: normal, positive
    u = v.view(np.uint32)
    e = f32(1.0) + ((u >> 23).astype(np.int32) - 127).astype(f32)
    m = ((u & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f32)
    fold = m < _f32(_LOG_SQRTHF)               # mantissa in [0.5, 1)
    x = (m - f32(1.0)) + np.where(fold, m, f32(0.0))
    e = e - np.where(fold, f32(1.0), f32(0.0))
    x2 = x * x
    x3 = x2 * x
    p = [_f32(b) for b in _LOG_P]
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, f32(_LOG_Q1) * e)
    r = _fma(f32(-0.5), x2, x) + y
    return _fma(f32(_LOG_Q2), e, r)


def n_scalars(T: int, C: int, R: int, UR: int) -> int:
    """Length of ScanSession's scalar table (with the IPA extension when
    UR > 0)."""
    n = T * (2 * R + 4) + 10 * T * C + 2 * T * C * C
    return n + (IPA_SCALARS_PER_T * T + 1 if UR else 0)


def smem_bytes(T: int, C: int, R: int, UR: int) -> int:
    """Dynamic shared memory of one launch: the scalar table, and with
    UR > 0 the six gate matrices as int32 (g1, w3tot, w45, gpres [T, UR];
    wanti, waff [T*8, UR])."""
    return 4 * (n_scalars(T, C, R, UR) + (20 * T * UR if UR else 0))


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        lib.scan_full_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p]
        lib.scan_full_launch.restype = ctypes.c_int
        lib.scan_full_cluster_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_void_p]
        lib.scan_full_cluster_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, dtype, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"scan_full: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _ceil8(n: int) -> int:
    return (n + 7) // 8 * 8


def _launch(tensors: Dict[str, torch.Tensor], dims, device,
            cluster: int = 1) -> None:
    """One call of the C launcher: `tensors` by ARG_PTRS name (absent =
    null), `dims` in the kernel's ArgDim order; `cluster` > 1 launches the
    cluster kernel over that many blocks. Raises on a refused launch
    (ClusterUnplaceable where the card cannot place the cluster)."""
    ptrs = [tensors[k].data_ptr() if k in tensors else 0 for k in ARG_PTRS]
    lib = _lib()
    p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    d = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if cluster > 1:
            err = lib.scan_full_cluster_launch(p, d, cluster, stream)
        else:
            err = lib.scan_full_launch(p, d, stream)
    if err == -2:
        raise ClusterUnplaceable(f"scan_full: the card cannot place a "
                                 f"cluster of {cluster} blocks")
    if err != 0:
        raise RuntimeError(f"scan_full kernel launch failed: CUDA error {err}")


def _kernel_mode(mode: str, mk) -> int:
    """The kernel's mode id for (mode, pods per step); raises on a pair
    the kernel does not take."""
    if mode not in MODES:
        raise ValueError(f"scan_full: mode {mode!r} is not one of {MODES}")
    if isinstance(mk, bool) or not isinstance(mk, (int, np.integer)) \
            or not 1 <= mk <= MAX_MK or mk & (mk - 1):
        raise ValueError(f"scan_full: mk={mk!r} must be a power of two "
                         f"<= {MAX_MK}")
    if mk > 1 and mode != "full":
        raise ValueError(f"scan_full: mk={mk} needs mode 'full'")
    if mode == "full":
        return MODE_MULTI if mk > 1 else MODE_FULL
    return MODE_EVAL if mode == "eval" else MODE_APPLY


def _cluster_size(cluster, UR: int, kmode: int) -> int:
    """The blocks to launch: `cluster` None is CLUSTER for mode "full",
    mk = 1 (any UR) and 1 (the one-block kernel) otherwise; 1 forces the
    one-block kernel; a size of CLUSTER_SIZES only that variant takes."""
    takes = kmode == MODE_FULL
    if cluster is None:
        return CLUSTER if takes else 1
    if isinstance(cluster, bool) \
            or not isinstance(cluster, (int, np.integer)) \
            or cluster not in (1, *CLUSTER_SIZES):
        raise ValueError(f"scan_full: cluster={cluster!r} is not 1 or one "
                         f"of {CLUSTER_SIZES}")
    if cluster > 1 and not takes:
        raise ValueError(f"scan_full: cluster={cluster} needs mode 'full' "
                         "and mk=1")
    return int(cluster)


def _validate(meta, match, statics, carry, shapes, mode, mk,
              forced) -> Tuple[int, int]:
    """Check every input the kernel reads; returns (UR, kernel mode id),
    UR = 0 without the IPA carries."""
    T, C, Np, R, SR, TCp, K, CP = shapes
    UR = carry["ucnt"].shape[0] if "ucnt" in carry else 0
    Bp = meta.shape[0] - 1
    dev = meta.device
    i32, f32 = torch.int32, torch.float32
    kmode = _kernel_mode(mode, mk)
    if Bp % mk:
        raise ValueError(f"scan_full: mk={mk} does not divide Bp={Bp}")
    Rp = carry["requested"].shape[0]
    _check("meta", meta, i32, (1 + Bp,), dev)
    _check("match", match, torch.int8, (Bp, 2 * LANE), dev)
    _check("alloc", statics["alloc"], i32, (Rp, Np), dev)
    _check("stat", statics["stat"], i32, (T * SR, Np), dev)
    _check("zid", statics["zid"], i32, (K, Np), dev)
    for k in ("regrow_f", "zvalid_node_s", "konn_f", "konn_s", "prow_f",
              "prow_s"):
        _check(k, statics[k], i32, (TCp, Np), dev)
    _check("zvalid_s", statics["zvalid_s"], i32, (TCp, VZ), dev)
    _check("shasall", statics["shasall"], i32,
           (statics["shasall"].shape[0], Np), dev)
    _check("valid_n", statics["valid_n"], i32, (8, Np), dev)
    _check("logw", statics["logw"], f32, (Np + 2,), dev)
    _check("gmat", statics["gmat"], f32, (_ceil8(T), LANE), dev)
    _check("scalars", statics["scalars"], i32, (n_scalars(T, C, R, UR),),
           dev)
    _check("requested", carry["requested"], i32, (Rp, Np), dev)
    _check("nzpc", carry["nzpc"], i32, (8, Np), dev)
    _check("cnt_fn", carry["cnt_fn"], i32, (TCp, Np), dev)
    _check("cnt_sn", carry["cnt_sn"], i32, (TCp, Np), dev)
    if Rp < R or statics["shasall"].shape[0] < T or TCp != T * CP \
            or C > CP or K > 4 or TCp > LANE:
        raise ValueError(f"scan_full: inconsistent shapes {shapes}")
    if mode == "apply":
        if forced is None:
            raise ValueError("scan_full: mode 'apply' needs `forced`")
        _check("forced", forced, i32, (2 * Bp,), dev)
    elif forced is not None:
        raise ValueError(f"scan_full: `forced` is for mode 'apply', not "
                         f"{mode!r}")
    if UR:
        if UR != T * 8:
            raise ValueError(f"scan_full: UR={UR} != 8 * T ({T})")
        _check("ipa_stat", statics["ipa_stat"], i32, (_ceil8(2 * T), Np),
               dev)
        for k in ("anti_static", "anti_konn", "aff_static"):
            _check(k, statics[k], i32, (T * 8, Np), dev)
        _check("prow_ipa", statics["prow_ipa"], i32, (8, Np), dev)
        for k in ("g1", "w3tot", "w45", "gpres"):
            _check(k, statics[k], f32, (_ceil8(T), UR), dev)
        for k in ("wanti", "waff"):
            _check(k, statics[k], f32, (T * 8, UR), dev)
        _check("ucnt", carry["ucnt"], i32, (UR, Np), dev)
        _check("kcnt", carry["kcnt"], i32, (UR, LANE), dev)
    return UR, kmode


def scan_full(meta: torch.Tensor, match: torch.Tensor,
              statics: Dict[str, torch.Tensor],
              carry: Dict[str, torch.Tensor], shapes: Tuple[int, ...],
              weights: Tuple[int, ...], mode: str = "full", mk: int = 1,
              forced: Optional[torch.Tensor] = None,
              cluster: Optional[int] = None) -> torch.Tensor:
    """Run one batch: meta = [B_real | tmpl[Bp]] int32, match int8
    [Bp, 256]; statics and carries as ScanSession lays them out (the IPA
    statics and the `ucnt`/`kcnt` carries select the ur > 0 variant);
    shapes = (T, C, Np, R, SR, TCp, K, CP); weights in WEIGHT_ORDER.

    mode "full" schedules the batch, mk pods per step (a power of two
    <= 64 dividing Bp); "eval" evaluates every pod against the carry as
    it stands; "apply" commits `forced`, int32 [2*Bp] of (lane | -1, ok)
    pairs. "full" and "apply" update the carries in place. Returns out
    int32 [8, Bp]: row 0 best lane or −1, row 1 score or −1, row 2
    n_feasible, and with mk > 1 row 3 the conflict-suffix flag (1 = not
    committed, to be replayed); −1 elsewhere and for pods b >= B_real.

    `cluster` picks the design on the card (`_cluster_size`): None the
    default, 1 the one-block kernel, 2 / 4 / 8 / 16 the cluster kernel of
    that size (mode "full", mk = 1 only); each decides the same.
    CPU tensors go to the plain version whatever it says."""
    global LAUNCHES
    UR, kmode = _validate(meta, match, statics, carry, shapes, mode, mk,
                          forced)
    cb = _cluster_size(cluster, UR, kmode)
    if meta.device.type == "cpu":
        return scan_full_reference(meta, match, statics, carry, shapes,
                                   weights, mode=mode, mk=mk, forced=forced)
    if meta.device.type != "cuda":
        raise ValueError(f"scan_full: unsupported device {meta.device}")
    T, C, Np, R, SR, TCp, K, CP = shapes
    Bp = meta.shape[0] - 1
    out = torch.full((8, Bp), -1, dtype=torch.int32, device=meta.device)
    # lane flags, raw PTS and IPA scores; the multi-pod step adds each
    # group pod's total and balanced/least rows
    rows = 3 + (2 * mk if kmode == MODE_MULTI else 0)
    work = torch.empty((rows, Np), dtype=torch.int32, device=meta.device)
    # `forced` and, without IPA carries, the IPA pointers are null
    tensors = dict(statics, **carry, meta=meta, match=match, out=out,
                   work=work)
    if forced is not None:
        tensors["forced"] = forced
    # dims in the kernel's ArgDim order; ScanSession refuses a session
    # whose shared memory exceeds SMEM_DYNAMIC_MAX (`smem-budget`)
    Rp = carry["requested"].shape[0]
    dims = [T, C, Np, R, SR, TCp, K, CP, Bp, UR, smem_bytes(T, C, R, UR),
            kmode, int(mk), 0, Rp, *[int(w) for w in weights]]
    _launch(tensors, dims, meta.device, cb)
    LAUNCHES += 1
    VARIANT_LAUNCHES[VARIANTS[kmode] + ("_ipa" if UR else "")] += 1
    if cb > 1:
        CLUSTER_LAUNCHES[cb] += 1
    return out


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def scan_full_reference(meta: torch.Tensor, match: torch.Tensor,
                        statics: Dict[str, torch.Tensor],
                        carry: Dict[str, torch.Tensor],
                        shapes: Tuple[int, ...],
                        weights: Tuple[int, ...], mode: str = "full",
                        mk: int = 1,
                        forced: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function, a Python
    loop over pods of tensor ops on whatever device the inputs live on,
    structured as the reference's kernel body: `eval_pod` (filter, score
    and argmax against the current carry), `commit` (the carry updates of
    one placement), one pod per step or `multi_group`'s mk. Pods at
    b >= B_real are not evaluated and keep their −1 out column. The IPA
    gate products (ur > 0) are integer sums of products of the small
    integer weights and the counts, as the reference's exact f32 dots."""
    T, C, Np, R, SR, TCp, K, CP = shapes
    UR = carry["ucnt"].shape[0] if "ucnt" in carry else 0
    Wb, Wi, Wipa, Wl, Wna, Wpa, Wpts, Wt = (int(w) for w in weights)
    dev = meta.device
    i32, f32 = torch.int32, torch.float32
    Bp = meta.shape[0] - 1
    m_host = meta.tolist()
    b_real, tmpl = m_host[0], m_host[1:]
    B = min(b_real, Bp)
    mt = match.tolist()
    sc = statics["scalars"].tolist()
    row_len = 2 * R + 4
    off_tc = T * row_len
    off_fsame = off_tc + 10 * T * C
    off_ssame = off_fsame + T * C * C
    # IPA scalar extension (ur > 0)
    off_ipa_t = off_ssame + T * C * C
    off_av = off_ipa_t + 3 * T
    off_w45s = off_av + 2 * T * 8

    def sm_t(t, i):
        return sc[t * row_len + i]

    def sm_tc(which, t, cc):
        return sc[off_tc + which * T * C + t * C + cc]

    alloc, stat = statics["alloc"], statics["stat"]
    zid, zvalid_s = statics["zid"], statics["zvalid_s"]
    valid_n = statics["valid_n"][0]
    logw = statics["logw"]
    requested, nzpc = carry["requested"], carry["nzpc"]
    cnt_fn, cnt_sn = carry["cnt_fn"], carry["cnt_sn"]
    prow_f, prow_s = statics["prow_f"], statics["prow_s"]
    if UR:
        ucnt, kcnt = carry["ucnt"], carry["kcnt"]
        prow_ipa, ipa_stat = statics["prow_ipa"], statics["ipa_stat"]
        # the f32 gate / weight matrices hold small integers
        g1, wanti, waff, w3tot, w45, gpres = (
            statics[k].to(i32) for k in ("g1", "wanti", "waff", "w3tot",
                                          "w45", "gpres"))
        w45_scale = sc[off_w45s]
        gmat = statics["gmat"].tolist()
    out = torch.full((8, Bp), -1, dtype=i32, device=dev)
    lane = torch.arange(Np, dtype=i32, device=dev)
    zero_i = torch.zeros(Np, dtype=i32, device=dev)
    zero_f = torch.zeros(Np, dtype=f32, device=dev)

    def fmax(x, mask, init):
        return max(init, int(torch.where(mask, x, init).max()))

    def fmin(x, mask, init):
        return min(init, int(torch.where(mask, x, init).min()))

    def fit_row(t):
        """NodeResourcesFit against the current carry (exact int32 after
        the GCD rescale), shared by the eval and the multi-pod recheck."""
        over = torch.zeros(Np, dtype=torch.bool, device=dev)
        for r in range(R):
            if sm_t(t, R + r) != 0:
                over |= sm_t(t, r) > (alloc[r] - requested[r])
        fail_dims = over if sm_t(t, 2 * R) != 0 else torch.zeros_like(over)
        fail_count = (nzpc[2] + 1) > nzpc[3]
        return ~(fail_count | fail_dims)

    def wbl_row(t):
        """balanced * w_b + least * w_l against the current carry, shared
        by the eval and the multi-pod recheck."""
        nzr0, nzr1 = sm_t(t, 2 * R + 1), sm_t(t, 2 * R + 2)
        nz_cpu = (nzpc[0] + nzr0).to(f32)
        nz_mem = (nzpc[1] + nzr1).to(f32)
        cap_cpu = alloc[0].to(f32)
        cap_mem = alloc[1].to(f32)
        one = torch.ones((), dtype=f32, device=dev)
        frac_c = torch.where(cap_cpu == 0, one, nz_cpu / cap_cpu)
        frac_m = torch.where(cap_mem == 0, one, nz_mem / cap_mem)
        balanced = ((1.0 - (frac_c - frac_m).abs()) * 100.0).to(i32)
        balanced = torch.where((frac_c >= 1) | (frac_m >= 1), zero_i, balanced)

        def least_dim(cap, reqq):
            d = _floordiv((cap - reqq) * MAX_NODE_SCORE,
                          torch.where(cap == 0, 1, cap))
            return torch.where((cap == 0) | (reqq > cap), zero_i, d)

        least = _floordiv(least_dim(alloc[0], nzpc[0] + nzr0)
                          + least_dim(alloc[1], nzpc[1] + nzr1), 2)
        return balanced * Wb + least * Wl

    def eval_pod(b):
        """Filter + score pod b against the current carry without
        committing: (t, best, m, n_feasible, total, wbl) — total is −1
        on infeasible lanes, m its maximum (−1: no feasible node)."""
        t = tmpl[b]
        base = t * CP
        static_mask = stat[t * SR + 0]
        raw_ipa = stat[t * SR + 1]
        cnt_taint = stat[t * SR + 2]
        cnt_nodeaff = stat[t * SR + 3]
        sc_image = stat[t * SR + 4]
        sc_avoid = stat[t * SR + 5]

        # ---- NodeResourcesFit ----
        mask_fit = fit_row(t)

        # ---- PTS filter (per-node counts; same-key constraints share
        # one (key, value) map) ----
        fail_pts = torch.zeros(Np, dtype=torch.bool, device=dev)
        for ci in range(C):
            if sm_tc(W_F_VALID, t, ci) == 0:
                continue
            sh = zero_i
            for cj in range(C):
                if sc[off_fsame + (t * C + ci) * C + cj]:
                    sh = sh + cnt_fn[base + cj]
            reg = statics["regrow_f"][base + ci] != 0
            min_c = fmin(sh, reg, POS_BIG)
            min_c = 0 if min_c == POS_BIG else min_c
            cnt_n = torch.where(reg, sh, zero_i)
            konn = statics["konn_f"][base + ci] != 0
            skew = cnt_n + sm_tc(W_F_SELF, t, ci) - min_c
            fail_pts |= ~konn | (skew > sm_tc(W_F_SKEW, t, ci))

        # ---- InterPodAffinity filter: static parts + assumed-pod counts
        # (D1-D3 over the ucnt / kcnt carries) ----
        mask_ipa = torch.ones(Np, dtype=torch.bool, device=dev)
        if UR:
            rows8 = slice(t * 8, t * 8 + 8)
            pos = ucnt > 0                                       # [UR, Np]
            # D1: assumed pods' anti terms repel this pod
            fail1 = ((g1[t][:, None] != 0) & pos).any(dim=0)
            # D2: assumed pods vs this pod's own anti terms
            anti_dyn = (wanti[rows8, :, None] * ucnt[None]).sum(dim=1)
            avld = torch.tensor(sc[off_av + t * 8:off_av + t * 8 + 8],
                                device=dev) != 0
            fail_anti = (avld[:, None] & (statics["anti_konn"][rows8] != 0)
                         & ((statics["anti_static"][rows8] + anti_dyn) > 0)
                         ).any(dim=0)
            # D3: assumed pods matching ALL of this pod's affinity terms
            aff_dyn = (waff[rows8, :, None] * ucnt[None]).sum(dim=1)
            fvld = torch.tensor(
                sc[off_av + (T + t) * 8:off_av + (T + t) * 8 + 8],
                device=dev) != 0
            pods_missing = (fvld[:, None]
                            & ((statics["aff_static"][rows8] + aff_dyn) <= 0)
                            ).any(dim=0)
            at_dyn = int((w3tot[t] * kcnt[:, 0]).sum())
            counts_empty = sc[off_ipa_t + t * 3 + 2] + at_dyn == 0
            has_aff = sc[off_ipa_t + t * 3] != 0
            smatch = sc[off_ipa_t + t * 3 + 1] != 0
            aff_allk = ipa_stat[2 * t + 1] != 0
            if has_aff:
                aff_ok = aff_allk & (~pods_missing
                                     | bool(counts_empty and smatch))
            else:
                aff_ok = mask_ipa
            mask_ipa = (~((ipa_stat[2 * t] != 0) | fail1) & ~fail_anti
                        & aff_ok)

        feasible = ((static_mask != 0) & mask_fit & ~fail_pts & mask_ipa
                    & (valid_n != 0))
        n_feasible = int(feasible.sum())

        # ---- resource scores ----
        wbl = wbl_row(t)

        # ---- PTS score ----
        shasall = statics["shasall"][t] != 0
        scored = feasible & shasall
        ignored = feasible & ~shasall
        n_scored = int(scored.sum())
        zpn = []
        present = []
        for k in range(K):
            z = zid[k]
            p = torch.zeros(VZ, dtype=torch.bool, device=dev)
            p[z[scored & (z >= 0)].long()] = True
            present.append(p)
            zpn.append((z >= 0) & p[z.clamp(min=0).long()])
        have_s = any(sm_tc(W_S_VALID, t, cc) != 0 for cc in range(C))
        raw = zero_f
        for cc in range(C):
            if sm_tc(W_S_VALID, t, cc) == 0:
                continue
            row = base + cc
            sh = zero_i
            for cj in range(C):
                if sc[off_ssame + (t * C + cc) * C + cj]:
                    sh = sh + cnt_sn[base + cj]
            key = sm_tc(W_S_KEY, t, cc)
            if sm_tc(W_S_PERNO, t, cc) != 0:
                wbase = n_scored
                cnt_n = sh
            else:
                if key >= 0:
                    topo = int((present[key] & (zvalid_s[row] != 0)).sum())
                    regn = zpn[key] & (statics["zvalid_node_s"][row] != 0)
                else:
                    topo = 0
                    regn = torch.zeros(Np, dtype=torch.bool, device=dev)
                wbase = topo if sm_tc(W_S_FIRST, t, cc) != 0 else 0
                cnt_n = torch.where(regn, sh, zero_i)
            weight = logw[wbase]                  # log(wbase + 2) in f32
            konn = statics["konn_s"][row] != 0
            bias = torch.tensor(float(sm_tc(W_S_SKEW, t, cc) - 1), dtype=f32,
                                device=dev)
            term = cnt_n.to(f32) * weight
            term = term + bias
            raw = raw + torch.where(konn, term, zero_f)
        raw_i = raw.to(i32)
        min_r = fmin(raw_i, scored, POS_BIG)
        max_r = fmax(raw_i, scored, 0)
        min_r = 0 if min_r == POS_BIG else min_r
        norm = _floordiv(MAX_NODE_SCORE * (max_r + min_r - raw_i),
                         max_r if max_r != 0 else 1)
        if max_r == 0:
            norm = torch.full_like(raw_i, MAX_NODE_SCORE)
        norm = torch.where(ignored, zero_i, norm)
        sc_pts = norm if have_s else zero_i

        # ---- InterPodAffinity score: static raw + assumed-pod terms
        # (D4+D5; the int32 dot on GCD-scaled weights, then the scale) ----
        present = sm_t(t, 2 * R + 3) != 0
        if UR:
            dyn45 = (w45[t][:, None] * ucnt).sum(dim=0).to(i32)
            raw_ipa = raw_ipa + dyn45 * w45_scale
            rowany = pos.any(dim=1)                              # [UR]
            present = present or bool(((gpres[t] != 0) & rowany).any())

        # ---- InterPodAffinity normalize ----
        min_i = fmin(raw_ipa, feasible, POS_BIG)
        max_i = fmax(raw_ipa, feasible, NEG_BIG)
        diff = float(torch.tensor(max_i - min_i, dtype=i32).to(f32))
        if diff > 0 and present:
            dt = torch.tensor(diff, dtype=f32, device=dev)
            ipa = (((raw_ipa - min_i).to(f32) / dt) * 100.0).to(i32)
        else:
            ipa = zero_i

        # ---- default-normalized taint / node-affinity ----
        def norm_default(counts, reverse):
            mx = fmax(counts, feasible, 0)
            scaled = _floordiv(MAX_NODE_SCORE * counts, mx if mx else 1)
            if reverse:
                return (torch.full_like(counts, MAX_NODE_SCORE) if mx == 0
                        else MAX_NODE_SCORE - scaled)
            return counts if mx == 0 else scaled

        sc_taint = norm_default(cnt_taint, True)
        sc_nodeaff = norm_default(cnt_nodeaff, False)

        total = (wbl + sc_image * Wi + ipa * Wipa + sc_nodeaff * Wna
                 + sc_avoid * Wpa + sc_pts * Wpts + sc_taint * Wt)
        total = torch.where(feasible, total, torch.full_like(total, -1))
        m = int(total.max())
        best = int(torch.where(total == m, lane, POS_BIG).min())
        return t, best, m, n_feasible, total, wbl

    def commit(b, t, best):
        """The carry updates of pod b (template t) placed at lane best:
        utilization columns and same-pair count lanes."""
        for r in range(R):
            requested[r, best] += sm_t(t, r)
        nzpc[0, best] += sm_t(t, 2 * R + 1)
        nzpc[1, best] += sm_t(t, 2 * R + 2)
        nzpc[2, best] += 1
        mrow = mt[b]
        for row in range(TCp):
            mf = mrow[row]
            if mf:
                pv = int(prow_f[row, best])
                if pv >= 0:
                    cnt_fn[row] += mf * (prow_f[row] == pv).to(i32)
            ms = mrow[LANE + row]
            tt, cc = divmod(row, CP)
            if ms and cc < C:
                factor = (1 if sm_tc(W_S_PERNO, tt, cc) != 0
                          else int(stat[tt * SR + 7, best]))
                pv = int(prow_s[row, best])
                if factor and pv >= 0:
                    cnt_sn[row] += ms * factor * (prow_s[row] == pv).to(i32)
        if UR:
            # the assumed pod joins its node's topology group for every
            # IPA key the node carries, in template t's 8-row block
            for ki in range(8):
                pv = int(prow_ipa[ki, best])
                if pv >= 0:
                    ucnt[t * 8 + ki] += (prow_ipa[ki] == pv).to(i32)
                    kcnt[t * 8 + ki] += 1

    def write(b, best, m, n_feasible, placed):
        out[2, b] = n_feasible
        if placed:
            out[0, b] = best
            out[1, b] = m

    def count_conflict(e, be, te, t, best, m):
        """The count legs of the multi-pod conflict test between group pod
        e (batch index, template te, committed at lane be) and a later pod
        of template t with speculative pick best: same node, pod e's PTS
        match lanes of t's valid constraints (summed), the IPA template
        interference gmat[te, t]."""
        if be == best and m >= 0:
            return True
        me = mt[e]
        hit = sum(me[t * CP + cc] * sm_tc(W_F_VALID, t, cc)
                  + me[LANE + t * CP + cc] * sm_tc(W_S_VALID, t, cc)
                  for cc in range(C))
        return hit > 0 or bool(UR) and gmat[te][t] > 0

    if mode == "apply":
        # forced (lane | −1, ok): a commit where ok and the lane is on the
        # node axis; −1 commits nothing
        fv = forced.tolist()
        for b in range(B):
            best, ok = fv[2 * b], fv[2 * b + 1]
            if ok != 0 and 0 <= best < Np:
                commit(b, tmpl[b], best)
        return out

    if mode == "full" and mk > 1:
        # multi_group: evals against the group-start carry, then in-order
        # commits gated by the exact conflict test; `seen` (the suffix
        # flag) carries across groups
        seen = 0
        for g0 in range(0, B, mk):
            evs = [eval_pod(b) for b in range(g0, min(g0 + mk, B))]
            committed = []  # (batch index, lane, committed, template)
            for i, (t, best, m, n_feasible, total, wbl) in enumerate(evs):
                b = g0 + i
                conf = any(okc_e and count_conflict(e, be, te, t, best, m)
                           for e, be, okc_e, te in committed)
                flip, over = multipod_utilization_conflicts(
                    total >= 0, total, best, m, lane, fit_row(t), wbl,
                    wbl_row(t))
                conf = conf or bool(flip.any()) or (bool(over.any())
                                                    and m >= 0)
                seen = max(seen, int(conf))
                okc = m >= 0 and not seen
                if okc:
                    commit(b, t, best)
                committed.append((b, best, okc, t))
                write(b, best, m, n_feasible, okc)
                out[3, b] = seen
        return out

    for b in range(B):
        t, best, m, n_feasible, _, _ = eval_pod(b)
        write(b, best, m, n_feasible, m >= 0)
        if mode == "full" and m >= 0:
            commit(b, t, best)
    return out


def delta_width(Rp: int, TCp: int) -> int:
    """Length of one event's payload row: dres[Rp] | dnzpc[8] | mf[TCp] |
    ms[TCp]."""
    return Rp + 8 + 2 * TCp


def _validate_delta(node, rows, statics, carry, shapes) -> int:
    """Check every input the delta mode reads; returns Rp."""
    T, C, Np, R, SR, TCp, K, CP = shapes
    dev = node.device
    i32 = torch.int32
    Rp = carry["requested"].shape[0]
    E = node.shape[0] if node.dim() == 1 else -1
    _check("node", node, i32, (E,), dev)
    _check("rows", rows, i32, (E, delta_width(Rp, TCp)), dev)
    _check("scalars", statics["scalars"], i32,
           (statics["scalars"].shape[0],), dev)
    _check("stat", statics["stat"], i32, (T * SR, Np), dev)
    _check("prow_f", statics["prow_f"], i32, (TCp, Np), dev)
    _check("prow_s", statics["prow_s"], i32, (TCp, Np), dev)
    _check("requested", carry["requested"], i32, (Rp, Np), dev)
    _check("nzpc", carry["nzpc"], i32, (8, Np), dev)
    _check("cnt_fn", carry["cnt_fn"], i32, (TCp, Np), dev)
    _check("cnt_sn", carry["cnt_sn"], i32, (TCp, Np), dev)
    if Rp < R or SR < 8 or TCp != T * CP or C > CP or TCp > LANE \
            or statics["scalars"].shape[0] < n_scalars(T, C, R, 0):
        raise ValueError(f"carry_delta: inconsistent shapes {shapes}")
    return Rp


def carry_delta(node: torch.Tensor, rows: torch.Tensor,
                statics: Dict[str, torch.Tensor],
                carry: Dict[str, torch.Tensor],
                shapes: Tuple[int, ...]) -> None:
    """Apply E signed cluster-event deltas to the carry, in place, in ONE
    launch of the grid kernel: node int32 [E], each in [0, Np); rows
    int32 [E, Rp + 8 + 2*TCp], per event dres[Rp] (GCD-scaled) |
    dnzpc[8] | mf[TCp] | ms[TCp]. Event e adds dres to requested[:,
    node], dnzpc to nzpc[:, node], mf[row] to every cnt_fn lane whose
    prow_f pair id equals the node's (none where the node's is -1), and
    ms[row] times the row's perno / s_src factor likewise to cnt_sn. `ucnt` / `kcnt`, where the
    carry has them, are not touched. The statics read are `scalars`
    (its prefix without the IPA extension), `stat` (row t*SR+7 = s_src),
    `prow_f` and `prow_s`."""
    global LAUNCHES
    Rp = _validate_delta(node, rows, statics, carry, shapes)
    if node.device.type == "cpu":
        carry_delta_reference(node, rows, statics, carry, shapes)
        return
    if node.device.type != "cuda":
        raise ValueError(f"carry_delta: unsupported device {node.device}")
    T, C, Np, R, SR, TCp, K, CP = shapes
    E = node.shape[0]
    tensors = {k: statics[k] for k in ("scalars", "stat", "prow_f",
                                       "prow_s")}
    tensors.update({k: carry[k] for k in ("requested", "nzpc", "cnt_fn",
                                          "cnt_sn")})
    tensors.update(dnode=node, drows=rows)
    # the weights are not read: zeros
    dims = [T, C, Np, R, SR, TCp, K, CP, 0, 0, smem_bytes(T, C, R, 0),
            MODE_DELTA, 1, E, Rp, *[0] * len(WEIGHT_ORDER)]
    _launch(tensors, dims, node.device)
    LAUNCHES += 1
    VARIANT_LAUNCHES["scan_delta"] += 1


def delta_factor_rows(statics: Dict[str, torch.Tensor],
                      shapes: Tuple[int, ...]):
    """(src_rows [TCp, Np], perno_rows [TCp, 1]) int32, the reference's
    session-delta statics (pallas_scan.py:536-547), read from where the
    kernel reads them: the score perno flags of the scalar table and the
    s_src rows of `stat`. Rows c >= C of a template are zero."""
    T, C, Np, R, SR, TCp, K, CP = shapes
    sc = statics["scalars"]
    off = T * (2 * R + 4) + W_S_PERNO * T * C
    perno = sc[off:off + T * C].reshape(T, C)
    stat = statics["stat"]
    src_rows = torch.zeros((TCp, Np), dtype=torch.int32, device=sc.device)
    perno_rows = torch.zeros((TCp, 1), dtype=torch.int32, device=sc.device)
    for t in range(T):
        src_rows[t * CP:t * CP + C] = stat[t * SR + 7]
        perno_rows[t * CP:t * CP + C, 0] = perno[t]
    return src_rows, perno_rows


def carry_delta_reference(node: torch.Tensor, rows: torch.Tensor,
                          statics: Dict[str, torch.Tensor],
                          carry: Dict[str, torch.Tensor],
                          shapes: Tuple[int, ...]) -> None:
    """Plain PyTorch version of the delta mode: the reference's
    `_carry_delta_scan` step, line for line, over the events in order,
    on whatever device the inputs live on, updating `carry` in place.
    Raises ValueError for a node outside [0, Np)."""
    T, C, Np, R, SR, TCp, K, CP = shapes
    Rp = carry["requested"].shape[0]
    prow_f, prow_s = statics["prow_f"], statics["prow_s"]
    src_rows, perno_rows = delta_factor_rows(statics, shapes)
    for e, n in enumerate(node.tolist()):
        if not 0 <= n < Np:
            raise ValueError(f"carry_delta: node {n} outside [0, {Np})")
        x = rows[e]
        dres, dnzpc = x[:Rp], x[Rp:Rp + 8]
        mf, ms = x[Rp + 8:Rp + 8 + TCp], x[Rp + 8 + TCp:]
        carry["requested"][:, n] += dres
        carry["nzpc"][:, n] += dnzpc
        pf_b = prow_f[:, n:n + 1]                              # [TCp, 1]
        same_f = (prow_f == pf_b) & (prow_f >= 0)
        carry["cnt_fn"] += mf[:, None] * same_f
        ps_b = prow_s[:, n:n + 1]
        same_s = (prow_s == ps_b) & (prow_s >= 0)
        src_b = src_rows[:, n:n + 1]
        factor = perno_rows + (1 - perno_rows) * src_b         # [TCp, 1]
        carry["cnt_sn"] += ms[:, None] * factor * same_s


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32, as int32 addition wraps."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def carry_delta_grouped(node: torch.Tensor, rows: torch.Tensor,
                        statics: Dict[str, torch.Tensor],
                        carry: Dict[str, torch.Tensor],
                        shapes: Tuple[int, ...]) -> None:
    """Plain PyTorch version of the grid kernel's formulation: for every
    carry row, the sum over ALL events of the event's value where its key
    equals the lane's key, added once to each lane, modulo 2**32. Keys
    are the node for `requested` / `nzpc` and the pair ids prow_f /
    prow_s for `cnt_fn` / `cnt_sn` (an event whose node has pair id -1
    adds nothing there); `cnt_sn` values carry the perno / s_src factor.
    The events are taken 64 at a time, with no order among them.
    Equals `carry_delta_reference`, which applies them one by one; updates
    `carry` in place. Raises ValueError for a node outside [0, Np)."""
    T, C, Np, R, SR, TCp, K, CP = shapes
    Rp = carry["requested"].shape[0]
    bad = [n for n in node.tolist() if not 0 <= n < Np]
    if bad:
        raise ValueError(f"carry_delta: node {bad[0]} outside [0, {Np})")
    n = node.long()
    x = rows.long()
    src_rows, perno_rows = delta_factor_rows(statics, shapes)
    factor = (perno_rows + (1 - perno_rows) * src_rows[:, n]).long()
    lane = torch.arange(Np, device=node.device)
    prow_f, prow_s = statics["prow_f"].long(), statics["prow_s"].long()
    # per carry: (event keys [rows, E], lane keys [rows, Np], values)
    groups = {
        "requested": (n.expand(Rp, -1), lane.expand(Rp, -1), x[:, :Rp].T),
        "nzpc": (n.expand(8, -1), lane.expand(8, -1), x[:, Rp:Rp + 8].T),
        "cnt_fn": (prow_f[:, n], prow_f, x[:, Rp + 8:Rp + 8 + TCp].T),
        "cnt_sn": (prow_s[:, n], prow_s, x[:, Rp + 8 + TCp:].T * factor),
    }
    for name, (ekey, lkey, val) in groups.items():
        val = torch.where(ekey >= 0, val & 0xFFFFFFFF, 0)
        acc = torch.zeros(lkey.shape, dtype=torch.int64, device=node.device)
        for e0 in range(0, n.shape[0], 64):
            hit = ekey[:, e0:e0 + 64, None] == lkey[:, None, :]
            acc += (val[:, e0:e0 + 64, None] * hit).sum(dim=1)
        carry[name].copy_(_wrap32(carry[name].long() + acc))
