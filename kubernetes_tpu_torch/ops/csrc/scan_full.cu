// scan_full: the batched scheduling scan as ONE kernel launch per batch.
//
// Replaces the Pallas kernel of kubernetes_tpu/ops/pallas_scan.py
// (_build_kernel -> kernel, launched by _dispatch) in mode "full", one pod
// per step, no affinity-term templates. The plain PyTorch version of the
// same function is scan_full_reference in ops/scan_kernel.py; the two
// agree bit for bit.
//
// What bounds it on the card: the chain of dependent steps, not bytes or
// arithmetic. Every pod needs whole-node-axis reductions (PTS filter
// minimum; feasible count, zone presence and score ranges; PTS score
// range; argmax) before the next pod may read the carry its commit
// changes. Design: ONE block of 1024 threads strides the Np node lanes
// (lane n belongs to thread n % 1024 for the whole launch), the pod loop
// runs inside the kernel, each reduction goes through shared memory, the
// scalar table is loaded into shared memory once, and every carry update
// is column-local: a thread only ever writes its own lanes, so the
// same-pair masks need nothing but prow[row, best], read after the block
// agrees on best. The per-step working set (a few MB at 5000 nodes) stays
// in L2.
//
// Arithmetic that must match the plain version exactly: f32 products and
// sums go through __fmul_rn / __fadd_rn (no fused multiply-add; the file
// is also built with -fmad=false), f32 division is __fdiv_rn (IEEE), the
// log is the library logf, f32 -> int32 casts truncate, and integer
// divisions floor (floordiv below), as jnp's // does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int VZ = 128;       // zone-presence lanes per shared-value key
constexpr int LANE = 128;     // match lanes per side
constexpr int MAXC = 8;       // constraint rows per template (CP)
constexpr int MAXK = 4;       // shared-value topology keys
constexpr int POS_BIG = 1 << 30;
constexpr int NEG_BIG = -(1 << 30);
constexpr int MAX_NODE_SCORE = 100;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long NO_KEY = -(1LL << 62);

// indices of the per-(template, constraint) scalar blocks
enum { W_F_VALID, W_S_VALID, W_F_SKEW, W_S_SKEW, W_F_SELF, W_S_FIRST,
       W_F_KEY, W_S_KEY, W_F_PERNO, W_S_PERNO };

struct Args {
  const int* meta;           // [1 + Bp]: B_real | tmpl
  const int8_t* match;       // [Bp, 2*LANE]: filter lanes | score lanes
  const int* scalars;        // scalar table (ScanSession._pack_scalars)
  const int* alloc;          // [Rp, Np]
  const int* stat;           // [T*SR, Np]
  const int* zid;            // [K, Np] zone index per node, -1 = none
  const int* regrow_f;       // [TCp, Np]
  const int* zvalid_node_s;  // [TCp, Np]
  const int* zvalid_s;       // [TCp, VZ]
  const int* konn_f;         // [TCp, Np]
  const int* konn_s;         // [TCp, Np]
  const int* shasall;        // [>=T, Np]
  const int* valid_n;        // [8, Np] (row 0 read)
  const int* prow_f;         // [TCp, Np]
  const int* prow_s;         // [TCp, Np]
  int* requested;            // carry [Rp, Np]
  int* nzpc;                 // carry [8, Np]: nz cpu, nz mem, pods, allowed
  int* cnt_fn;               // carry [TCp, Np]
  int* cnt_sn;               // carry [TCp, Np]
  int* out;                  // [8, Bp]
  int* work;                 // scratch [2, Np]: lane flags, raw PTS score
  int T, C, Np, R, SR, TCp, K, CP, Bp;
  int w[8];                  // balanced image ipa least node_affinity
                             // prefer_avoid pts taint
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ long long warp_max64(long long x) {
  for (int o = 16; o > 0; o >>= 1) {
    long long y = __shfl_xor_sync(FULL, x, o);
    x = y > x ? y : x;
  }
  return x;
}

__global__ void __launch_bounds__(THREADS, 1) scan_full_kernel(Args a) {
  extern __shared__ int sc[];             // the scalar table
  __shared__ int red1[WARPS * MAXC];      // PTS filter minima
  __shared__ int red2[WARPS * 6];         // feasible-set reductions
  __shared__ int red3[WARPS * 2];         // PTS raw score range
  __shared__ long long red4[WARPS];       // argmax keys
  __shared__ int zflag[MAXK * VZ];        // zone presence among scored
  __shared__ float wsh[MAXC];             // PTS score weights

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, C = a.C, Np = a.Np, R = a.R, SR = a.SR, K = a.K;
  const int CP = a.CP, TCp = a.TCp, Bp = a.Bp;
  const int row_len = 2 * R + 4;
  const int off_tc = T * row_len;
  const int off_fsame = off_tc + 10 * T * C;
  const int off_ssame = off_fsame + T * C * C;
  const int n_sc = off_ssame + T * C * C;
  for (int i = tid; i < n_sc; i += THREADS) sc[i] = a.scalars[i];
  __syncthreads();

  int* flags = a.work;       // bit 0 feasible, bit 1 scored
  int* rawv = a.work + Np;   // truncated raw PTS score (scored lanes)
  const int B = min(a.meta[0], Bp);

  for (int b = 0; b < B; ++b) {
    const int t = a.meta[1 + b];
    const int base = t * CP;
    const int* tsc = sc + t * row_len;
    const int* tc = sc + off_tc + t * C;   // tc[which*T*C + c]
    const int TC = T * C;
    for (int i = tid; i < K * VZ; i += THREADS) zflag[i] = 0;

    // ---- phase 1: PTS filter minimum count per constraint over the
    // registered pairs (same-key constraints share one count map) ----
    int minc[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) minc[c] = POS_BIG;
    for (int n = tid; n < Np; n += THREADS) {
#pragma unroll
      for (int ci = 0; ci < MAXC; ++ci) {
        if (ci >= C || !tc[W_F_VALID * TC + ci]) continue;
        if (a.regrow_f[(base + ci) * Np + n] == 0) continue;
        int sh = 0;
        for (int cj = 0; cj < C; ++cj)
          if (sc[off_fsame + (t * C + ci) * C + cj])
            sh += a.cnt_fn[(base + cj) * Np + n];
        minc[ci] = min(minc[ci], sh);
      }
    }
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c >= C) continue;
      int x = warp_min(minc[c]);
      if (lane == 0) red1[warp * MAXC + c] = x;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c >= C) continue;
      int x = red1[c];
      for (int w = 1; w < WARPS; ++w) x = min(x, red1[w * MAXC + c]);
      minc[c] = x == POS_BIG ? 0 : x;
    }

    // ---- phase 2: feasibility, zone presence, feasible-set ranges ----
    int n_feas = 0, n_scored = 0, min_i = POS_BIG, max_i = NEG_BIG;
    int mx_taint = 0, mx_naff = 0;
    for (int n = tid; n < Np; n += THREADS) {
      bool feas = a.valid_n[n] != 0 && a.stat[(t * SR + 0) * Np + n] != 0;
      if (feas) {  // NodeResourcesFit (exact int32 after the GCD rescale)
        bool over = false;
        for (int r = 0; r < R; ++r)
          if (tsc[R + r] != 0
              && tsc[r] > a.alloc[r * Np + n] - a.requested[r * Np + n])
            over = true;
        const bool fail_dims = tsc[2 * R] != 0 && over;
        const bool fail_count = a.nzpc[2 * Np + n] + 1 > a.nzpc[3 * Np + n];
        feas = !(fail_dims || fail_count);
      }
      if (feas) {  // PodTopologySpread filter
#pragma unroll
        for (int ci = 0; ci < MAXC; ++ci) {
          if (ci >= C || !tc[W_F_VALID * TC + ci]) continue;
          const int row = base + ci;
          if (a.konn_f[row * Np + n] == 0) { feas = false; continue; }
          int cnt = 0;
          if (a.regrow_f[row * Np + n] != 0)
            for (int cj = 0; cj < C; ++cj)
              if (sc[off_fsame + (t * C + ci) * C + cj])
                cnt += a.cnt_fn[(base + cj) * Np + n];
          const int skew = cnt + tc[W_F_SELF * TC + ci] - minc[ci];
          if (skew > tc[W_F_SKEW * TC + ci]) feas = false;
        }
      }
      int f = 0;
      if (feas) {
        f = 1;
        ++n_feas;
        if (a.shasall[t * Np + n] != 0) {
          f |= 2;
          ++n_scored;
          for (int k = 0; k < K; ++k) {
            const int z = a.zid[k * Np + n];
            if (z >= 0) zflag[k * VZ + z] = 1;
          }
        }
        const int ri = a.stat[(t * SR + 1) * Np + n];
        min_i = min(min_i, ri);
        max_i = max(max_i, ri);
        mx_taint = max(mx_taint, a.stat[(t * SR + 2) * Np + n]);
        mx_naff = max(mx_naff, a.stat[(t * SR + 3) * Np + n]);
      }
      flags[n] = f;
    }
    {
      const int v0 = warp_sum(n_feas), v1 = warp_sum(n_scored);
      const int v2 = warp_min(min_i), v3 = warp_max(max_i);
      const int v4 = warp_max(mx_taint), v5 = warp_max(mx_naff);
      if (lane == 0) {
        int* p = red2 + warp * 6;
        p[0] = v0; p[1] = v1; p[2] = v2; p[3] = v3; p[4] = v4; p[5] = v5;
      }
    }
    __syncthreads();
    n_feas = 0; n_scored = 0; min_i = POS_BIG; max_i = NEG_BIG;
    mx_taint = 0; mx_naff = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int* p = red2 + w * 6;
      n_feas += p[0]; n_scored += p[1];
      min_i = min(min_i, p[2]); max_i = max(max_i, p[3]);
      mx_taint = max(mx_taint, p[4]); mx_naff = max(mx_naff, p[5]);
    }

    // PTS score weights: log(n_scored + 2) for per-node (hostname) rows,
    // log(present zones + 2) for the first constraint of a shared key
    if (tid < C && tc[W_S_VALID * TC + tid]) {
      int wbase;
      if (tc[W_S_PERNO * TC + tid]) {
        wbase = n_scored;
      } else {
        const int key = tc[W_S_KEY * TC + tid];
        int topo = 0;
        if (key >= 0)
          for (int z = 0; z < VZ; ++z)
            topo += (zflag[key * VZ + z] != 0)
                    && (a.zvalid_s[(base + tid) * VZ + z] != 0);
        wbase = tc[W_S_FIRST * TC + tid] ? topo : 0;
      }
      wsh[tid] = logf(__fadd_rn((float)wbase, 2.0f));
    }
    __syncthreads();

    // ---- phase 3: raw PTS score on scored lanes, and its range ----
    int have_s = 0;
    for (int c = 0; c < C; ++c) have_s |= tc[W_S_VALID * TC + c] != 0;
    int min_r = POS_BIG, max_r = 0;
    for (int n = tid; n < Np; n += THREADS) {
      if (!(flags[n] & 2)) continue;
      float raw = 0.0f;
      for (int c = 0; c < C; ++c) {
        if (!tc[W_S_VALID * TC + c]) continue;
        const int row = base + c;
        if (a.konn_s[row * Np + n] == 0) continue;
        int sh = 0;
        for (int cj = 0; cj < C; ++cj)
          if (sc[off_ssame + (t * C + c) * C + cj])
            sh += a.cnt_sn[(base + cj) * Np + n];
        int cnt = sh;
        if (!tc[W_S_PERNO * TC + c]) {
          const int key = tc[W_S_KEY * TC + c];
          bool regn = false;
          if (key >= 0 && a.zvalid_node_s[row * Np + n] != 0) {
            const int z = a.zid[key * Np + n];
            regn = z >= 0 && zflag[key * VZ + z] != 0;
          }
          cnt = regn ? sh : 0;
        }
        const float term = __fadd_rn(__fmul_rn((float)cnt, wsh[c]),
                                     (float)(tc[W_S_SKEW * TC + c] - 1));
        raw = __fadd_rn(raw, term);
      }
      const int ri = (int)raw;  // truncation toward zero
      rawv[n] = ri;
      min_r = min(min_r, ri);
      max_r = max(max_r, ri);
    }
    {
      const int v0 = warp_min(min_r), v1 = warp_max(max_r);
      if (lane == 0) { red3[warp * 2] = v0; red3[warp * 2 + 1] = v1; }
    }
    __syncthreads();
    min_r = POS_BIG; max_r = 0;
    for (int w = 0; w < WARPS; ++w) {
      min_r = min(min_r, red3[w * 2]);
      max_r = max(max_r, red3[w * 2 + 1]);
    }
    if (min_r == POS_BIG) min_r = 0;

    // ---- phase 4: weighted total and first-max argmax ----
    const int nzr0 = tsc[2 * R + 1], nzr1 = tsc[2 * R + 2];
    const bool ipa_on = tsc[2 * R + 3] != 0;
    const float diff = (float)(max_i - min_i);
    long long bestkey = NO_KEY;
    for (int n = tid; n < Np; n += THREADS) {
      const int f = flags[n];
      if (!(f & 1)) continue;
      // balanced allocation (f32) and least allocated (int32, floored)
      const int req0 = a.nzpc[n] + nzr0, req1 = a.nzpc[Np + n] + nzr1;
      const int cap0 = a.alloc[n], cap1 = a.alloc[Np + n];
      const float fc = cap0 == 0 ? 1.0f : __fdiv_rn((float)req0, (float)cap0);
      const float fm = cap1 == 0 ? 1.0f : __fdiv_rn((float)req1, (float)cap1);
      int balanced = 0;
      if (!(fc >= 1.0f || fm >= 1.0f))
        balanced = (int)__fmul_rn(__fsub_rn(1.0f, fabsf(__fsub_rn(fc, fm))),
                                  (float)MAX_NODE_SCORE);
      const int l0 = (cap0 == 0 || req0 > cap0)
          ? 0 : floordiv((cap0 - req0) * MAX_NODE_SCORE, cap0);
      const int l1 = (cap1 == 0 || req1 > cap1)
          ? 0 : floordiv((cap1 - req1) * MAX_NODE_SCORE, cap1);
      const int least = floordiv(l0 + l1, 2);
      // PodTopologySpread normalize (ignored = feasible but not scored)
      int pts = 0;
      if (have_s && (f & 2))
        pts = max_r == 0 ? MAX_NODE_SCORE
            : floordiv(MAX_NODE_SCORE * (max_r + min_r - rawv[n]), max_r);
      // InterPodAffinity static normalize
      int ipa = 0;
      if (ipa_on && diff > 0.0f) {
        const int ri = a.stat[(t * SR + 1) * Np + n];
        ipa = (int)__fmul_rn(__fdiv_rn((float)(ri - min_i), diff),
                             (float)MAX_NODE_SCORE);
      }
      // default-normalized taint (reverse) and node affinity
      const int ct = a.stat[(t * SR + 2) * Np + n];
      const int taint = mx_taint == 0 ? MAX_NODE_SCORE
          : MAX_NODE_SCORE - floordiv(MAX_NODE_SCORE * ct, mx_taint);
      const int ca = a.stat[(t * SR + 3) * Np + n];
      const int naff = mx_naff == 0 ? ca
          : floordiv(MAX_NODE_SCORE * ca, mx_naff);
      const int image = a.stat[(t * SR + 4) * Np + n];
      const int avoid = a.stat[(t * SR + 5) * Np + n];
      const int total = balanced * a.w[0] + image * a.w[1] + ipa * a.w[2]
          + least * a.w[3] + naff * a.w[4] + avoid * a.w[5] + pts * a.w[6]
          + taint * a.w[7];
      // max total first, then the minimum lane among equal totals
      const long long key = (long long)total * 4294967296LL
          + (long long)(0x7fffffff - n);
      if (key > bestkey) bestkey = key;
    }
    {
      const long long v = warp_max64(bestkey);
      if (lane == 0) red4[warp] = v;
    }
    __syncthreads();
    bestkey = red4[0];
    for (int w = 1; w < WARPS; ++w) bestkey = red4[w] > bestkey ? red4[w] : bestkey;
    int m = -1, best = 0;
    if (bestkey != NO_KEY) {
      m = (int)(bestkey >> 32);
      best = 0x7fffffff - (int)(bestkey & 0xffffffffLL);
    }
    const bool ok = m >= 0;
    if (tid == 0) {
      a.out[2 * Bp + b] = n_feas;
      if (ok) { a.out[b] = best; a.out[Bp + b] = m; }
    }
    if (!ok) continue;

    // ---- commit: utilization columns and same-pair count lanes ----
    if (best % THREADS == tid) {
      for (int r = 0; r < R; ++r) a.requested[r * Np + best] += tsc[r];
      a.nzpc[best] += nzr0;
      a.nzpc[Np + best] += nzr1;
      a.nzpc[2 * Np + best] += 1;
    }
    const int8_t* mrow = a.match + (size_t)b * 2 * LANE;
    for (int row = 0; row < TCp; ++row) {
      const int mf = mrow[row];
      if (mf) {
        const int pv = a.prow_f[row * Np + best];
        if (pv >= 0)
          for (int n = tid; n < Np; n += THREADS)
            if (a.prow_f[row * Np + n] == pv) a.cnt_fn[row * Np + n] += mf;
      }
      const int ms = mrow[LANE + row];
      const int tt = row / CP, cc = row % CP;
      if (ms && cc < C) {
        const int factor = sc[off_tc + W_S_PERNO * TC + tt * C + cc]
            ? 1 : a.stat[(tt * SR + 7) * Np + best];
        const int pv = a.prow_s[row * Np + best];
        if (factor && pv >= 0)
          for (int n = tid; n < Np; n += THREADS)
            if (a.prow_s[row * Np + n] == pv)
              a.cnt_sn[row * Np + n] += ms * factor;
      }
    }
  }
}

}  // namespace

extern "C" int scan_full_launch(
    const int* meta, const int8_t* match, const int* scalars,
    const int* alloc, const int* stat, const int* zid, const int* regrow_f,
    const int* zvalid_node_s, const int* zvalid_s, const int* konn_f,
    const int* konn_s, const int* shasall, const int* valid_n,
    const int* prow_f, const int* prow_s, int* requested, int* nzpc,
    int* cnt_fn, int* cnt_sn, int* out, int* work,
    int T, int C, int Np, int R, int SR, int TCp, int K, int CP, int Bp,
    int w0, int w1, int w2, int w3, int w4, int w5, int w6, int w7,
    void* stream) {
  if (C > MAXC || K > MAXK || TCp > LANE || TCp != T * CP) return -1;
  Args a;
  a.meta = meta; a.match = match; a.scalars = scalars; a.alloc = alloc;
  a.stat = stat; a.zid = zid; a.regrow_f = regrow_f;
  a.zvalid_node_s = zvalid_node_s; a.zvalid_s = zvalid_s;
  a.konn_f = konn_f; a.konn_s = konn_s; a.shasall = shasall;
  a.valid_n = valid_n; a.prow_f = prow_f; a.prow_s = prow_s;
  a.requested = requested; a.nzpc = nzpc; a.cnt_fn = cnt_fn;
  a.cnt_sn = cnt_sn; a.out = out; a.work = work;
  a.T = T; a.C = C; a.Np = Np; a.R = R; a.SR = SR; a.TCp = TCp; a.K = K;
  a.CP = CP; a.Bp = Bp;
  a.w[0] = w0; a.w[1] = w1; a.w[2] = w2; a.w[3] = w3;
  a.w[4] = w4; a.w[5] = w5; a.w[6] = w6; a.w[7] = w7;
  const int n_sc = T * (2 * R + 4) + 10 * T * C + 2 * T * C * C;
  const size_t smem = (size_t)n_sc * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scan_full_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
