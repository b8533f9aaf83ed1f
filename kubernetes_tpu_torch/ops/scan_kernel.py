"""`scan_full`: the batched scheduling scan, as one CUDA kernel launch.

Replaces the Pallas kernel of kubernetes_tpu/ops/pallas_scan.py
(`_build_kernel` -> `kernel`, launched by `_dispatch`) in mode "full"
with one pod per step and no affinity-term templates (ur = 0). For each
pod of the batch, in order, against the live carry: the static mask,
NodeResourcesFit on GCD-rescaled int32 resources, the PodTopologySpread
filter, balanced / least allocated, the PodTopologySpread score with its
log(n + 2) weights, the InterPodAffinity static normalize, the taint and
node-affinity default normalize, the weighted total and the first-max
argmax (min lane among the maxima); then the commit of the chosen node
into the carries `requested`, `nzpc`, `cnt_fn`, `cnt_sn`, in place.

What bounds it on the card: not bytes and not arithmetic, but the chain
of dependent steps. Each pod needs whole-node-axis reductions (the PTS
minimum, the feasible count and zone presence, the PTS score range, the
argmax) before the next can start, and its commit before the next pod's
filter. The design: one thread block strides the Np node lanes, keeps
the pod loop inside the kernel (one launch per batch), does each
reduction in shared memory, holds the scalar table in shared memory,
and updates the carries in global memory column-locally — every thread
only ever writes its own lanes, so the same-pair masks need nothing but
`prow[row, best]`, read after the block agrees on `best`. At 5000 nodes
the per-step working set is a few MB and stays in the 50 MB L2. A
multi-block cooperative design is later work.

`scan_full_reference` is the plain PyTorch version: a loop over pods of
tensor ops with the same int32 / f32 arithmetic (floor divisions,
truncating casts, no fused multiply-add, IEEE division, `log`). The
wrapper `scan_full` sends CPU tensors to it and CUDA tensors to the
kernel; on CUDA it raises if the build or the launch fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

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

# launches of the CUDA kernel (one per batch); the plain version does
# not count
LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "scan_full.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_LIB = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build(verbose: bool = False) -> float:
    """Compile csrc/scan_full.cu into build/torch_kernels/ (once per
    process; the output is reused while it is newer than the source).
    Returns the seconds spent compiling (0.0 when reused)."""
    out = BUILD_DIR / "libscan_full.so"
    if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    if verbose and (res.stdout or res.stderr):
        print(res.stdout + res.stderr)
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _lib():
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(str(BUILD_DIR / "libscan_full.so"))
        P = ctypes.c_void_p
        I = ctypes.c_int
        lib.scan_full_launch.argtypes = [P] * 21 + [I] * 9 + [I] * 8 + [P]
        lib.scan_full_launch.restype = I
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


def _validate(meta, match, statics, carry, shapes):
    T, C, Np, R, SR, TCp, K, CP = shapes
    Bp = meta.shape[0] - 1
    dev = meta.device
    i32 = torch.int32
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
    n_sc = T * (2 * R + 4) + 10 * T * C + 2 * T * C * C
    _check("scalars", statics["scalars"], i32, (n_sc,), dev)
    _check("requested", carry["requested"], i32, (Rp, Np), dev)
    _check("nzpc", carry["nzpc"], i32, (8, Np), dev)
    _check("cnt_fn", carry["cnt_fn"], i32, (TCp, Np), dev)
    _check("cnt_sn", carry["cnt_sn"], i32, (TCp, Np), dev)
    if Rp < R or statics["shasall"].shape[0] < T or TCp != T * CP \
            or C > CP or K > 4 or TCp > LANE:
        raise ValueError(f"scan_full: inconsistent shapes {shapes}")


def scan_full(meta: torch.Tensor, match: torch.Tensor,
              statics: Dict[str, torch.Tensor],
              carry: Dict[str, torch.Tensor], shapes: Tuple[int, ...],
              weights: Tuple[int, ...]) -> torch.Tensor:
    """Schedule one batch: meta = [B_real | tmpl[Bp]] int32, match int8
    [Bp, 256]; statics and carries as ScanSession lays them out; shapes
    = (T, C, Np, R, SR, TCp, K, CP); weights in WEIGHT_ORDER. Updates the
    carries in place and returns out int32 [8, Bp] (row 0 best lane or
    −1, row 1 score or −1, row 2 n_feasible; −1 elsewhere)."""
    global LAUNCHES
    _validate(meta, match, statics, carry, shapes)
    if meta.device.type == "cpu":
        return scan_full_reference(meta, match, statics, carry, shapes,
                                   weights)
    if meta.device.type != "cuda":
        raise ValueError(f"scan_full: unsupported device {meta.device}")
    T, C, Np, R, SR, TCp, K, CP = shapes
    Bp = meta.shape[0] - 1
    out = torch.full((8, Bp), -1, dtype=torch.int32, device=meta.device)
    s = statics
    ptrs = [meta, match, s["scalars"], s["alloc"], s["stat"], s["zid"],
            s["regrow_f"], s["zvalid_node_s"], s["zvalid_s"], s["konn_f"],
            s["konn_s"], s["shasall"], s["valid_n"], s["prow_f"],
            s["prow_s"], carry["requested"], carry["nzpc"], carry["cnt_fn"],
            carry["cnt_sn"], out,
            torch.empty((2, Np), dtype=torch.int32, device=meta.device)]
    lib = _lib()
    with torch.cuda.device(meta.device):
        stream = torch.cuda.current_stream(meta.device).cuda_stream
        err = lib.scan_full_launch(
            *[t.data_ptr() for t in ptrs],
            T, C, Np, R, SR, TCp, K, CP, Bp, *[int(w) for w in weights],
            stream)
    if err != 0:
        raise RuntimeError(f"scan_full kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def scan_full_reference(meta: torch.Tensor, match: torch.Tensor,
                        statics: Dict[str, torch.Tensor],
                        carry: Dict[str, torch.Tensor],
                        shapes: Tuple[int, ...],
                        weights: Tuple[int, ...]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function, a Python
    loop over pods of tensor ops on whatever device the inputs live on.
    Pods at b >= B_real commit nothing and keep their −1 out column."""
    T, C, Np, R, SR, TCp, K, CP = shapes
    Wb, Wi, Wipa, Wl, Wna, Wpa, Wpts, Wt = (int(w) for w in weights)
    dev = meta.device
    i32, f32 = torch.int32, torch.float32
    Bp = meta.shape[0] - 1
    m_host = meta.tolist()
    b_real, tmpl = m_host[0], m_host[1:]
    mt = match.tolist()
    sc = statics["scalars"].tolist()
    row_len = 2 * R + 4
    off_tc = T * row_len
    off_fsame = off_tc + 10 * T * C
    off_ssame = off_fsame + T * C * C

    def sm_t(t, i):
        return sc[t * row_len + i]

    def sm_tc(which, t, cc):
        return sc[off_tc + which * T * C + t * C + cc]

    alloc, stat = statics["alloc"], statics["stat"]
    zid, zvalid_s = statics["zid"], statics["zvalid_s"]
    valid_n = statics["valid_n"][0]
    requested, nzpc = carry["requested"], carry["nzpc"]
    cnt_fn, cnt_sn = carry["cnt_fn"], carry["cnt_sn"]
    prow_f, prow_s = statics["prow_f"], statics["prow_s"]
    out = torch.full((8, Bp), -1, dtype=i32, device=dev)
    lane = torch.arange(Np, dtype=i32, device=dev)
    zero_i = torch.zeros(Np, dtype=i32, device=dev)
    zero_f = torch.zeros(Np, dtype=f32, device=dev)

    def fmax(x, mask, init):
        return max(init, int(torch.where(mask, x, init).max()))

    def fmin(x, mask, init):
        return min(init, int(torch.where(mask, x, init).min()))

    for b in range(min(b_real, Bp)):
        t = tmpl[b]
        base = t * CP
        static_mask = stat[t * SR + 0]
        raw_ipa = stat[t * SR + 1]
        cnt_taint = stat[t * SR + 2]
        cnt_nodeaff = stat[t * SR + 3]
        sc_image = stat[t * SR + 4]
        sc_avoid = stat[t * SR + 5]

        # ---- NodeResourcesFit (exact int32 after the GCD rescale) ----
        over = torch.zeros(Np, dtype=torch.bool, device=dev)
        for r in range(R):
            if sm_t(t, R + r) != 0:
                over |= sm_t(t, r) > (alloc[r] - requested[r])
        fail_dims = over if sm_t(t, 2 * R) != 0 else torch.zeros_like(over)
        fail_count = (nzpc[2] + 1) > nzpc[3]
        mask_fit = ~(fail_count | fail_dims)

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

        feasible = ((static_mask != 0) & mask_fit & ~fail_pts
                    & (valid_n != 0))
        n_feasible = int(feasible.sum())

        # ---- resource scores ----
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
            weight = torch.log(
                torch.tensor(float(wbase), dtype=f32, device=dev) + 2.0)
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

        # ---- InterPodAffinity static normalize ----
        min_i = fmin(raw_ipa, feasible, POS_BIG)
        max_i = fmax(raw_ipa, feasible, NEG_BIG)
        diff = float(torch.tensor(max_i - min_i, dtype=i32).to(f32))
        if diff > 0 and sm_t(t, 2 * R + 3) != 0:
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

        total = (balanced * Wb + sc_image * Wi + ipa * Wipa + least * Wl
                 + sc_nodeaff * Wna + sc_avoid * Wpa + sc_pts * Wpts
                 + sc_taint * Wt)
        total = torch.where(feasible, total, torch.full_like(total, -1))
        m = int(total.max())
        best = int(torch.where(total == m, lane, POS_BIG).min())
        ok = m >= 0
        out[2, b] = n_feasible
        if not ok:
            continue
        out[0, b] = best
        out[1, b] = m

        # ---- commit: utilization columns + same-pair count lanes ----
        for r in range(R):
            requested[r, best] += sm_t(t, r)
        nzpc[0, best] += nzr0
        nzpc[1, best] += nzr1
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
    return out
