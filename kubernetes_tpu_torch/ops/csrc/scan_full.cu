// scan_full: the batched scheduling scan as ONE kernel launch per batch.
//
// Replaces the Pallas kernel of kubernetes_tpu/ops/pallas_scan.py
// (_build_kernel -> kernel, launched by _dispatch) in its three modes, as
// instantiations of one template scan_kernel<IPA, MODE>: IPA = false for
// sessions without affinity-term templates (ur = 0), true for the
// InterPodAffinity term machinery (ur > 0: pallas_scan.py:1552-1592
// filter, :1680-1693 score, :1417-1435 commit); MODE is
//   MODE_FULL  mode "full", one pod per step: evaluate, pick, commit;
//   MODE_MULTI mode "full", mk > 1 pods per step (multi_group :1798-1866):
//              the group's pods are evaluated against the group-start
//              carry, then committed in order, each gated by the exact
//              conflict test; the first conflict starts the suffix that
//              stays uncommitted (out row 3) for the host to replay;
//   MODE_EVAL  mode "eval" (:1751-1766): out rows 0-2, carries untouched;
//   MODE_APPLY mode "apply" (:1736-1746): commit forced (lane, ok) pairs;
//   MODE_DELTA the counterpart of the reference's jnp program
//              _carry_delta_scan (:168-195): signed cluster-event deltas
//              (pods bound or evicted by other actors, allocatable-only
//              node updates) on the carry, each the commit's column update
//              with best := the event's node and the event's own payload.
//              One instantiation, IPA = false, serves every session: the
//              reference never touches ucnt / kcnt there.
// The pod body is split as the reference splits it: eval_pod (filter,
// score, argmax against the current carry) and commit_pod (the carry
// updates for one placement, through update_columns, which the delta mode
// shares). The plain PyTorch versions of the same functions are
// scan_full_reference and carry_delta_reference in ops/scan_kernel.py;
// each agrees with the kernel bit for bit.
//
// What bounds it on the card: the chain of dependent steps, not bytes or
// arithmetic. Every pod needs whole-node-axis reductions (PTS filter
// minimum; feasible count, zone presence and score ranges; PTS score
// range; argmax) before the next pod may read the carry its commit
// changes. Design: ONE block of 1024 threads strides the Np node lanes
// (lane n belongs to thread n % 1024 for the whole launch), the pod loop
// runs inside the kernel, each reduction goes through shared memory, the
// scalar table (and, with ur > 0, the IPA gate matrices) is loaded into
// shared memory once, and every carry update
// is column-local: a thread only ever writes its own lanes, so the
// same-pair masks need nothing but prow[row, best], read after the block
// agrees on best. The per-step working set (a few MB at 5000 nodes) stays
// in L2. The same ownership lets the delta mode run its events back to
// back without a barrier (their updates are additions to owned lanes). The multi-pod step keeps that ownership: each group pod's per-lane
// total and balanced/least share live in a scratch row that only the
// lane's owner writes and reads, and the utilization recheck is one
// block-wide OR (__syncthreads_or) per pod.
//
// The lanes belong to a team, a template parameter of the pod body. `Block`
// is the design above, and every instantiation but two uses it. `Cluster`
// (scan_kernel<IPA, MODE_FULL, Cluster>, launched by
// scan_full_cluster_launch) spreads the lanes of mode "full", one pod per
// step, with or without the IPA carries (ur = 0 or ur > 0), over a
// thread-block cluster of cb = 2..16 blocks on as many SMs:
// block rank r owns the contiguous slice [lo_r, hi_r), S = ceil(Np / cb),
// lo_r = min(r * S, Np), hi_r = min(lo_r + S, Np), and thread tid of it the
// lanes lo_r + tid + k * 1024. What changes is only where the lane loops
// start and end and how the four per-pod reductions combine: each block
// reduces as before, thread 0 publishes the block's value in its own shared
// memory (`mine`), one cluster barrier, then warp 0 folds the cb published
// values through distributed shared memory (lane r reads rank r) into the
// block's `all`, and a block barrier hands that to every thread. (Every
// thread reading every rank's value costs a block 32 * cb remote requests
// per value, and measured slower at cb = 16 than at cb = 2.) Every reduction
// is an integer min / max / sum, a zone-flag OR or the packed argmax key, so
// the result does not depend on the partition; a slice without a feasible
// lane contributes the identity, and the mappings of an empty result run
// after the combine. Ordering: a block's `mine` value of a reduction is read
// by peers only between that reduction's cluster barrier and the next
// cluster barrier, and rewritten only in the next pod, after three more, so
// one barrier per reduction suffices; `all` and the merged zone flags are
// block-local and read after the block barrier; the local zone flags, which
// peers read after the phase-2 barrier, are cleared only in the next pod.
// The kernel ends with one more cluster barrier, so that no block exits
// while a peer reads its shared memory. What does not change: the carries
// stay in global memory (L2), every carry access stays at the accessing
// thread's own lanes (the commit's owner of `best` is the thread of the
// slice holding it, and eval and commit visit a lane from the same thread),
// and the arithmetic below.
//
// With ur > 0 two more carries ride along. `ucnt` [UR, Np] is lane-local
// like the four above: the commit's sweep and eval's reads (D1-D5) visit
// only the thread's own lanes. `kcnt` [UR, LANE] is not: every thread of
// every block reads kcnt[r, 0] for the per-pod IPA scalars, so one block
// alone, rank 0, adds to it (`kcnt_writer`; a commit in every block would
// add cb times), and the others read what it wrote in global memory. The
// order that makes this exact:
//   - rank 0 adds to kcnt for pod b after pod b's combine4;
//   - every block reads kcnt for pod b + 1 only after pod b + 1's
//     combine1, a cluster barrier (barrier.cluster.arrive.release /
//     wait.acquire), which rank 0's writing threads reach after their
//     adds: the adds are visible to every reader;
//   - every block has read kcnt for pod b + 1 before it arrives at pod
//     b + 1's combine2 barrier, and rank 0's next adds come after pod
//     b + 1's combine4, two barriers later: no read races a write;
//   - so no read of kcnt may move above combine1 (it sits right below
//     it), and kcnt stays a plain int* read by ordinary global loads: the
//     read-only path (__ldg, ld.global.nc) is not coherent with writes
//     made during the same launch.

// Arithmetic that must match the plain version exactly: f32 products and
// sums go through __fmul_rn / __fadd_rn (no fused multiply-add; the file
// is also built with -fmad=false), f32 division is __fdiv_rn (IEEE), the
// PTS weight log(n + 2) is read from the host-built table `logw` (equal to
// the reference's f32 log bit for bit), f32 -> int32 casts truncate, and
// integer divisions floor (floordiv below), as jnp's // does. The IPA gate
// products are int32 sums of small integer weights times counts; the
// reference computes them as f32 dots that its session guards keep exact
// (scaled weight sums < 2^8, assumed counts < 2^16), so the two agree.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_args.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int VZ = 128;       // zone-presence lanes per shared-value key
constexpr int LANE = 128;     // match lanes per side
constexpr int MAXC = 8;       // constraint rows per template (CP)
constexpr int MAXK = 4;       // shared-value topology keys
constexpr int SUB = 8;        // IPA terms / topology keys per template
constexpr int MAXMK = 64;     // pods per multi-pod step
constexpr int POS_BIG = 1 << 30;
constexpr int NEG_BIG = -(1 << 30);
constexpr int MAX_NODE_SCORE = 100;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long NO_KEY = -(1LL << 62);
constexpr int MAXCB = 16;     // blocks per cluster (non-portable above 8)

// the launcher's mode argument (ops/scan_kernel.py MODE_IDS)
enum { MODE_FULL, MODE_MULTI, MODE_EVAL, MODE_APPLY, MODE_DELTA };

// indices of the per-(template, constraint) scalar blocks
enum { W_F_VALID, W_S_VALID, W_F_SKEW, W_S_SKEW, W_F_SELF, W_S_FIRST,
       W_F_KEY, W_S_KEY, W_F_PERNO, W_S_PERNO };

// the kernel's static shared memory
struct Shared {
  int red1[WARPS * MAXC];      // PTS filter minima
  int red2[WARPS * 6];         // feasible-set reductions
  int red3[WARPS * 2];         // PTS raw score range
  long long red4[WARPS];       // argmax keys
  int zflag[MAXK * VZ];        // zone presence among scored
  float wsh[MAXC];             // PTS score weights
  // multi-pod group: each pod's eval result, written by thread 0
  int g_t[MAXMK], g_best[MAXMK], g_m[MAXMK], g_nf[MAXMK];
};

// offsets into the shared scalar table and the shared IPA gate matrices
struct Ctx {
  const int* sc;
  int row_len, off_tc, off_fsame, off_ssame, off_ipa_t, off_av, off_w45s;
  const int *g1s, *w3s, *w45s, *gps, *wantis, *waffs;
};

// one pod's evaluation, the same in every thread of the team
struct Eval {
  int t, best, m, n_feas;
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

// The team that owns the node lanes: where thread tid's lane loop starts
// and ends (`first(tid)`, then every THREADS lanes below `end(Np)`), which
// thread owns a lane and which thread writes `out`; a cluster also says how
// a block's reduced values combine across it (combine1..4, after the
// block's own reduction at each of eval_pod's four reduction points, and
// finish). The callers read threadIdx.x once and pass it in, and reach the
// combines only under `if constexpr (Team::CLUSTER)`: the one-block code
// compiles to what it compiled to before teams existed.

// One block owns every lane: lane n belongs to thread n % THREADS.
struct Block {
  static constexpr bool CLUSTER = false;
  __device__ static Block make(int) { return Block{}; }
  __device__ int first(int tid) const { return tid; }
  __device__ int end(int Np) const { return Np; }
  __device__ bool owns(int node, int tid) const {
    return node % THREADS == tid;
  }
  __device__ bool leader() const { return threadIdx.x == 0; }
  // the threads that add the commit's kcnt lanes (lane l by thread l)
  __device__ bool kcnt_writer(int tid) const { return tid < LANE; }
};

// A block's reduced values: `mine` is read by the peers through
// distributed shared memory, `all` holds the cluster's fold of them (and
// the zone flags OR-ed over the cluster), read by the block's own threads.
struct ClusterVals {
  int red1[MAXC];
  int red2[6];
  int red3[2];
  long long red4;
};
struct ClusterSlots {
  ClusterVals mine, all;
  int zflag[MAXK * VZ];
};

// A thread-block cluster of cb blocks owns the lanes, block rank r the
// slice [lo, hi) (see the note at the head of the file). At each combine
// thread 0 publishes the block's value, one cluster barrier, warp 0 folds
// the cb published values (lane r reads rank r, one remote load per peer
// and value), and a block barrier hands the fold to the block's threads.
struct Cluster {
  static constexpr bool CLUSTER = true;
  int lo, hi, rank, cb;
  ClusterSlots* slots;
  __device__ static Cluster make(int Np) {
    __shared__ ClusterSlots slots;
    const cg::cluster_group c = cg::this_cluster();
    Cluster t;
    t.cb = (int)c.num_blocks();
    t.rank = (int)c.block_rank();
    const int S = (Np + t.cb - 1) / t.cb;
    t.lo = min(t.rank * S, Np);
    t.hi = min(t.lo + S, Np);
    t.slots = &slots;
    return t;
  }
  __device__ int first(int tid) const { return lo + tid; }
  __device__ int end(int) const { return hi; }
  __device__ bool owns(int node, int tid) const {
    return node >= lo && node < hi && (node - lo) % THREADS == tid;
  }
  __device__ bool leader() const { return threadIdx.x == 0 && rank == 0; }
  // rank 0's alone (the order is in the note at the head of the file)
  __device__ bool kcnt_writer(int tid) const {
    return rank == 0 && tid < LANE;
  }
  // for warp 0's lane r < cb: rank r's published values, else null
  __device__ const ClusterVals* peer() const {
    const int r = threadIdx.x;
    return r < cb ? &cg::this_cluster().map_shared_rank(slots, r)->mine
                  : nullptr;
  }
  // phase 1: the PTS filter minima
  __device__ void combine1(int (&minc)[MAXC], int C) const {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) slots->mine.red1[c] = minc[c];
    }
    cg::this_cluster().sync();
    if (threadIdx.x < 32) {
      const ClusterVals* p = peer();
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c >= C) continue;
        const int v = warp_min(p ? p->red1[c] : POS_BIG);
        if (threadIdx.x == 0) slots->all.red1[c] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) minc[c] = slots->all.red1[c];
  }
  // phase 2: the feasible-set values, and the zone flags OR-ed over the
  // ranks into the local merged array (peers may still read the local
  // flags, so they are not OR-ed in place); returns the merged flags
  __device__ const int* combine2(int& n_feas, int& n_scored, int& min_i,
                                 int& max_i, int& mx_taint, int& mx_naff,
                                 int* zflag, int K) const {
    if (threadIdx.x == 0) {
      int* q = slots->mine.red2;
      q[0] = n_feas; q[1] = n_scored; q[2] = min_i; q[3] = max_i;
      q[4] = mx_taint; q[5] = mx_naff;
    }
    cg::this_cluster().sync();
    if (threadIdx.x < 32) {
      int v[6] = {0, 0, POS_BIG, NEG_BIG, 0, 0};
      if (const ClusterVals* p = peer()) {
#pragma unroll
        for (int i = 0; i < 6; ++i) v[i] = p->red2[i];
      }
      v[0] = warp_sum(v[0]);
      v[1] = warp_sum(v[1]);
      v[2] = warp_min(v[2]);
      v[3] = warp_max(v[3]);
      v[4] = warp_max(v[4]);
      v[5] = warp_max(v[5]);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < 6; ++i) slots->all.red2[i] = v[i];
      }
    }
    const cg::cluster_group c = cg::this_cluster();
    for (int i = threadIdx.x; i < K * VZ; i += THREADS) {
      int f = 0;
#pragma unroll
      for (int r = 0; r < MAXCB; ++r)
        if (r < cb) f |= c.map_shared_rank(zflag, r)[i];
      slots->zflag[i] = f;
    }
    __syncthreads();
    const int* q = slots->all.red2;
    n_feas = q[0]; n_scored = q[1]; min_i = q[2]; max_i = q[3];
    mx_taint = q[4]; mx_naff = q[5];
    return slots->zflag;
  }
  // phase 3: the PTS raw score range
  __device__ void combine3(int& min_r, int& max_r) const {
    if (threadIdx.x == 0) {
      slots->mine.red3[0] = min_r;
      slots->mine.red3[1] = max_r;
    }
    cg::this_cluster().sync();
    if (threadIdx.x < 32) {
      const ClusterVals* p = peer();
      const int v0 = warp_min(p ? p->red3[0] : POS_BIG);
      const int v1 = warp_max(p ? p->red3[1] : 0);
      if (threadIdx.x == 0) {
        slots->all.red3[0] = v0;
        slots->all.red3[1] = v1;
      }
    }
    __syncthreads();
    min_r = slots->all.red3[0];
    max_r = slots->all.red3[1];
  }
  // phase 4: the packed argmax key
  __device__ void combine4(long long& bestkey) const {
    if (threadIdx.x == 0) slots->mine.red4 = bestkey;
    cg::this_cluster().sync();
    if (threadIdx.x < 32) {
      const ClusterVals* p = peer();
      const long long v = warp_max64(p ? p->red4 : NO_KEY);
      if (threadIdx.x == 0) slots->all.red4 = v;
    }
    __syncthreads();
    bestkey = slots->all.red4;
  }
  // no block exits while a peer may still read its slots
  __device__ void finish() const { cg::this_cluster().sync(); }
};

// NodeResourcesFit of a template-t pod on lane n against the CURRENT carry
// (exact int32 after the GCD rescale); tsc = template t's scalar row.
// Shared by the eval and the multi-pod recheck (pallas_scan.py fit_row).
__device__ __forceinline__ bool fits(const Args& a, const int* tsc, int n) {
  const int R = a.R, Np = a.Np;
  bool over = false;
  for (int r = 0; r < R; ++r)
    if (tsc[R + r] != 0
        && tsc[r] > a.alloc[r * Np + n] - a.requested[r * Np + n])
      over = true;
  const bool fail_dims = tsc[2 * R] != 0 && over;
  const bool fail_count = a.nzpc[2 * Np + n] + 1 > a.nzpc[3 * Np + n];
  return !(fail_dims || fail_count);
}

// balanced allocation (f32) times its weight plus least allocated (int32,
// floored) times its weight, on lane n against the CURRENT carry (the
// reference's resource_rows; nzr0 / nzr1 = the template's non-zero cpu /
// memory request)
__device__ __forceinline__ int resource_score(const Args& a, int nzr0,
                                              int nzr1, int n) {
  const int Np = a.Np;
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
  return balanced * a.w[0] + least * a.w[3];
}

// Filter + score pod b against the CURRENT carry WITHOUT committing (the
// reference's eval_pod, pallas_scan.py:1489). With MODE_MULTI it also
// writes, per own lane, the total (-1 where infeasible) to gtot and the
// balanced/least share of it to gwbl. With `scores` false it stops after
// the feasible count (best 0, m -1): a pod of the conflict suffix needs
// nothing else.
template <bool IPA, int MODE, typename Team>
__device__ __forceinline__ Eval eval_pod(const Args& a, const Ctx& x,
                                         Shared& s, const Team& team, int b,
                                         bool scores, int* gtot, int* gwbl) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, C = a.C, Np = a.Np, R = a.R, SR = a.SR, K = a.K;
  const int CP = a.CP, UR = a.UR;
  const int* sc = x.sc;
  int* flags = a.work;           // bit 0 feasible, bit 1 scored
  int* rawv = a.work + Np;       // truncated raw PTS score (scored lanes)
  int* rawi = a.work + 2 * Np;   // raw IPA score incl. D4+D5 (IPA)

  const int t = a.meta[1 + b];
  const int base = t * CP;
  const int* tsc = sc + t * x.row_len;
  const int* tc = sc + x.off_tc + t * C;   // tc[which*T*C + c]
  const int TC = T * C;
  for (int i = tid; i < K * VZ; i += THREADS) s.zflag[i] = 0;

  // ---- phase 1: PTS filter minimum count per constraint over the
  // registered pairs (same-key constraints share one count map) ----
  int minc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) minc[c] = POS_BIG;
  for (int n = team.first(tid); n < team.end(Np); n += THREADS) {
#pragma unroll
    for (int ci = 0; ci < MAXC; ++ci) {
      if (ci >= C || !tc[W_F_VALID * TC + ci]) continue;
      if (a.regrow_f[(base + ci) * Np + n] == 0) continue;
      int sh = 0;
      for (int cj = 0; cj < C; ++cj)
        if (sc[x.off_fsame + (t * C + ci) * C + cj])
          sh += a.cnt_fn[(base + cj) * Np + n];
      minc[ci] = min(minc[ci], sh);
    }
  }
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c >= C) continue;
    int v = warp_min(minc[c]);
    if (lane == 0) s.red1[warp * MAXC + c] = v;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c >= C) continue;
    int v = s.red1[c];
    for (int w = 1; w < WARPS; ++w) v = min(v, s.red1[w * MAXC + c]);
    minc[c] = Team::CLUSTER ? v : (v == POS_BIG ? 0 : v);
  }
  if constexpr (Team::CLUSTER) {  // over the cluster, then no-pair -> 0
    team.combine1(minc, C);
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C && minc[c] == POS_BIG) minc[c] = 0;
  }

  // ---- per-pod IPA scalars from the kcnt carry (added by the
  // `kcnt_writer` threads in the previous pod's commit; visible after the
  // barrier above, the cluster's combine1 on a cluster) ----
  bool pres_dyn = false, counts_empty = false, has_aff = false,
       smatch = false;
  int w45_scale = 0;
  if (IPA) {
    const int* w3 = x.w3s + t * UR;
    const int* gp = x.gps + t * UR;
    int at_dyn = 0;
    for (int r = 0; r < UR; ++r) {
      const int k0 = a.kcnt[r * LANE];
      at_dyn += w3[r] * k0;
      // rowany_r = max_n (ucnt[r, n] > 0) is kcnt[r, 0] > 0 within a
      // session: both start at zero, and each commit raises kcnt[r]
      // exactly when it raises some lane of ucnt[r] (at least the
      // chosen node's own), so no whole-row reduction is needed
      if (gp[r] != 0 && k0 > 0) pres_dyn = true;
    }
    has_aff = sc[x.off_ipa_t + 3 * t] != 0;
    smatch = sc[x.off_ipa_t + 3 * t + 1] != 0;
    counts_empty = sc[x.off_ipa_t + 3 * t + 2] + at_dyn == 0;
    w45_scale = sc[x.off_w45s];
  }

  // ---- phase 2: feasibility, zone presence, feasible-set ranges ----
  int n_feas = 0, n_scored = 0, min_i = POS_BIG, max_i = NEG_BIG;
  int mx_taint = 0, mx_naff = 0;
  for (int n = team.first(tid); n < team.end(Np); n += THREADS) {
    bool feas = a.valid_n[n] != 0 && a.stat[(t * SR + 0) * Np + n] != 0;
    if (feas) feas = fits(a, tsc, n);  // NodeResourcesFit
    if (feas) {  // PodTopologySpread filter
#pragma unroll
      for (int ci = 0; ci < MAXC; ++ci) {
        if (ci >= C || !tc[W_F_VALID * TC + ci]) continue;
        const int row = base + ci;
        if (a.konn_f[row * Np + n] == 0) { feas = false; continue; }
        int cnt = 0;
        if (a.regrow_f[row * Np + n] != 0)
          for (int cj = 0; cj < C; ++cj)
            if (sc[x.off_fsame + (t * C + ci) * C + cj])
              cnt += a.cnt_fn[(base + cj) * Np + n];
        const int skew = cnt + tc[W_F_SELF * TC + ci] - minc[ci];
        if (skew > tc[W_F_SKEW * TC + ci]) feas = false;
      }
    }
    const int* ucol = a.ucnt + n;    // ucol[r * Np] = ucnt[r, n]
    if (IPA && feas) {  // InterPodAffinity: static parts + D1-D3
      bool fail = a.ipa_stat[(2 * t) * Np + n] != 0;
      // D1: assumed pods' anti terms repel this pod
      const int* g1r = x.g1s + t * UR;
      for (int r = 0; r < UR && !fail; ++r)
        if (g1r[r] != 0 && ucol[(size_t)r * Np] > 0) fail = true;
      // D2: assumed pods vs this pod's own anti terms
      for (int tau = 0; tau < SUB && !fail; ++tau) {
        const int row = t * SUB + tau;
        if (sc[x.off_av + t * SUB + tau] == 0
            || a.anti_konn[row * Np + n] == 0) continue;
        int cnt = a.anti_static[row * Np + n];
        const int* w = x.wantis + row * UR;
        for (int r = 0; r < UR; ++r)
          if (w[r] != 0) cnt += w[r] * ucol[(size_t)r * Np];
        if (cnt > 0) fail = true;
      }
      // D3: assumed pods matching ALL of this pod's affinity terms, with
      // the first-pod escape (counts empty and the pod matches itself)
      if (!fail && has_aff) {
        bool ok = a.ipa_stat[(2 * t + 1) * Np + n] != 0;
        if (ok) {
          bool missing = false;
          for (int tau = 0; tau < SUB && !missing; ++tau) {
            if (sc[x.off_av + (T + t) * SUB + tau] == 0) continue;
            const int row = t * SUB + tau;
            int cnt = a.aff_static[row * Np + n];
            const int* w = x.waffs + row * UR;
            for (int r = 0; r < UR; ++r)
              if (w[r] != 0) cnt += w[r] * ucol[(size_t)r * Np];
            if (cnt <= 0) missing = true;
          }
          ok = !missing || (counts_empty && smatch);
        }
        fail = !ok;
      }
      feas = !fail;
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
          if (z >= 0) s.zflag[k * VZ + z] = 1;
        }
      }
      int ri = a.stat[(t * SR + 1) * Np + n];
      if (IPA) {  // D4+D5: the int32 dot on GCD-scaled weights, rescaled
        const int* w = x.w45s + t * UR;
        int dyn45 = 0;
        for (int r = 0; r < UR; ++r)
          if (w[r] != 0) dyn45 += w[r] * ucol[(size_t)r * Np];
        ri += dyn45 * w45_scale;
        rawi[n] = ri;
      }
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
      int* p = s.red2 + warp * 6;
      p[0] = v0; p[1] = v1; p[2] = v2; p[3] = v3; p[4] = v4; p[5] = v5;
    }
  }
  __syncthreads();
  n_feas = 0; n_scored = 0; min_i = POS_BIG; max_i = NEG_BIG;
  mx_taint = 0; mx_naff = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int* p = s.red2 + w * 6;
    n_feas += p[0]; n_scored += p[1];
    min_i = min(min_i, p[2]); max_i = max(max_i, p[3]);
    mx_taint = max(mx_taint, p[4]); mx_naff = max(mx_naff, p[5]);
  }
  const int* zf = s.zflag;
  if constexpr (Team::CLUSTER)
    zf = team.combine2(n_feas, n_scored, min_i, max_i, mx_taint, mx_naff,
                       s.zflag, K);
  Eval e;
  e.t = t;
  e.n_feas = n_feas;
  e.m = -1;
  e.best = 0;
  if (!scores) return e;  // block-uniform

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
          topo += (zf[key * VZ + z] != 0)
                  && (a.zvalid_s[(base + tid) * VZ + z] != 0);
      wbase = tc[W_S_FIRST * TC + tid] ? topo : 0;
    }
    s.wsh[tid] = a.logw[wbase];  // log(wbase + 2); wbase <= Np
  }
  __syncthreads();

  // ---- phase 3: raw PTS score on scored lanes, and its range ----
  int have_s = 0;
  for (int c = 0; c < C; ++c) have_s |= tc[W_S_VALID * TC + c] != 0;
  int min_r = POS_BIG, max_r = 0;
  for (int n = team.first(tid); n < team.end(Np); n += THREADS) {
    if (!(flags[n] & 2)) continue;
    float raw = 0.0f;
    for (int c = 0; c < C; ++c) {
      if (!tc[W_S_VALID * TC + c]) continue;
      const int row = base + c;
      if (a.konn_s[row * Np + n] == 0) continue;
      int sh = 0;
      for (int cj = 0; cj < C; ++cj)
        if (sc[x.off_ssame + (t * C + c) * C + cj])
          sh += a.cnt_sn[(base + cj) * Np + n];
      int cnt = sh;
      if (!tc[W_S_PERNO * TC + c]) {
        const int key = tc[W_S_KEY * TC + c];
        bool regn = false;
        if (key >= 0 && a.zvalid_node_s[row * Np + n] != 0) {
          const int z = a.zid[key * Np + n];
          regn = z >= 0 && zf[key * VZ + z] != 0;
        }
        cnt = regn ? sh : 0;
      }
      const float term = __fadd_rn(__fmul_rn((float)cnt, s.wsh[c]),
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
    if (lane == 0) { s.red3[warp * 2] = v0; s.red3[warp * 2 + 1] = v1; }
  }
  __syncthreads();
  min_r = POS_BIG; max_r = 0;
  for (int w = 0; w < WARPS; ++w) {
    min_r = min(min_r, s.red3[w * 2]);
    max_r = max(max_r, s.red3[w * 2 + 1]);
  }
  if constexpr (Team::CLUSTER) team.combine3(min_r, max_r);
  if (min_r == POS_BIG) min_r = 0;

  // ---- phase 4: weighted total and first-max argmax ----
  const int nzr0 = tsc[2 * R + 1], nzr1 = tsc[2 * R + 2];
  const bool ipa_on = tsc[2 * R + 3] != 0 || pres_dyn;
  const float diff = (float)(max_i - min_i);
  long long bestkey = NO_KEY;
  for (int n = team.first(tid); n < team.end(Np); n += THREADS) {
    const int f = flags[n];
    if (!(f & 1)) {
      if (MODE == MODE_MULTI) gtot[n] = -1;
      continue;
    }
    // balanced allocation and least allocated, weighted
    const int wbl = resource_score(a, nzr0, nzr1, n);
    // PodTopologySpread normalize (ignored = feasible but not scored)
    int pts = 0;
    if (have_s && (f & 2))
      pts = max_r == 0 ? MAX_NODE_SCORE
          : floordiv(MAX_NODE_SCORE * (max_r + min_r - rawv[n]), max_r);
    // InterPodAffinity static normalize
    int ipa = 0;
    if (ipa_on && diff > 0.0f) {
      const int ri = IPA ? rawi[n] : a.stat[(t * SR + 1) * Np + n];
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
    const int total = wbl + image * a.w[1] + ipa * a.w[2]
        + naff * a.w[4] + avoid * a.w[5] + pts * a.w[6] + taint * a.w[7];
    if (MODE == MODE_MULTI) {
      gtot[n] = total;
      gwbl[n] = wbl;
    }
    // max total first, then the minimum lane among equal totals
    const long long key = (long long)total * 4294967296LL
        + (long long)(0x7fffffff - n);
    if (key > bestkey) bestkey = key;
  }
  {
    const long long v = warp_max64(bestkey);
    if (lane == 0) s.red4[warp] = v;
  }
  __syncthreads();
  bestkey = s.red4[0];
  for (int w = 1; w < WARPS; ++w)
    bestkey = s.red4[w] > bestkey ? s.red4[w] : bestkey;
  if constexpr (Team::CLUSTER) team.combine4(bestkey);
  if (bestkey != NO_KEY) {
    e.m = (int)(bestkey >> 32);
    e.best = 0x7fffffff - (int)(bestkey & 0xffffffffLL);
  }
  return e;
}

// The column update of one placement at node lane `node` (the reference's
// _apply_updates, :1361, and the step of its jnp twin _carry_delta_scan,
// :179-192): dres[0, nres) into requested[:, node], dnzpc into
// nzpc[:, node], and per match row mf[row] into every cnt_fn lane of the
// node's pair (prow_f == prow_f[row, node]; none where that is -1), and
// ms[row] times the factor (1 for a per-node row, else the node's s_src,
// stat row tt*SR+7) into every cnt_sn lane of its pair likewise. M is the
// payload type: the batch's int8 match lanes for a commit, the event's
// signed int32 row for a delta. dnzpc is read before any store (a commit's
// folds to constants), so the owner thread's column adds do not wait on
// payload loads behind its own stores. Every thread writes only its own
// lanes.
template <typename Team, typename M>
__device__ __forceinline__ void update_columns(const Args& a, const Ctx& x,
                                               const Team& team,
                                               int node, int nres,
                                               const int* dres,
                                               const int (&dnzpc)[SUB],
                                               const M* mf, const M* ms) {
  const int tid = threadIdx.x;
  const int T = a.T, C = a.C, Np = a.Np, SR = a.SR, CP = a.CP;
  const int TC = T * C;
  if (team.owns(node, tid)) {
    for (int r = 0; r < nres; ++r) a.requested[r * Np + node] += dres[r];
#pragma unroll
    for (int i = 0; i < SUB; ++i)
      if (dnzpc[i] != 0) a.nzpc[i * Np + node] += dnzpc[i];
  }
  for (int row = 0; row < a.TCp; ++row) {
    const int df = mf[row];
    if (df) {
      const int pv = a.prow_f[row * Np + node];
      if (pv >= 0)
        for (int n = team.first(tid); n < team.end(Np); n += THREADS)
          if (a.prow_f[row * Np + n] == pv) a.cnt_fn[row * Np + n] += df;
    }
    const int ds = ms[row];
    const int tt = row / CP, cc = row % CP;
    if (ds && cc < C) {
      const int factor = x.sc[x.off_tc + W_S_PERNO * TC + tt * C + cc]
          ? 1 : a.stat[(tt * SR + 7) * Np + node];
      const int pv = a.prow_s[row * Np + node];
      if (factor && pv >= 0)
        for (int n = team.first(tid); n < team.end(Np); n += THREADS)
          if (a.prow_s[row * Np + n] == pv)
            a.cnt_sn[row * Np + n] += ds * factor;
    }
  }
}

// Commit pod b (template t) at node lane `best`: the template's requests,
// its non-zero cpu / memory requests and one pod into the utilization
// columns, the pod's match lanes into the same-pair count lanes, and with
// IPA the assumed-pod term counts.
template <bool IPA, typename Team>
__device__ __forceinline__ void commit_pod(const Args& a, const Ctx& x,
                                           const Team& team, int b, int t,
                                           int best) {
  const int tid = threadIdx.x;
  const int Np = a.Np, R = a.R;
  const int* tsc = x.sc + t * x.row_len;
  const int dnzpc[SUB] = {tsc[2 * R + 1], tsc[2 * R + 2], 1, 0, 0, 0, 0, 0};
  const int8_t* mrow = a.match + (size_t)b * 2 * LANE;
  update_columns(a, x, team, best, R, tsc, dnzpc, mrow, mrow + LANE);
  if (IPA) {
    // the assumed pod joins its node's topology group for every IPA
    // key the node carries, in template t's 8-row block of ucnt (each
    // thread at its own lanes) and of kcnt (by the team's kcnt writers)
    for (int ki = 0; ki < SUB; ++ki) {
      const int pv = a.prow_ipa[ki * Np + best];
      if (pv < 0) continue;
      int* urow = a.ucnt + (size_t)(t * SUB + ki) * Np;
      for (int n = team.first(tid); n < team.end(Np); n += THREADS)
        if (a.prow_ipa[ki * Np + n] == pv) urow[n] += 1;
      if (team.kcnt_writer(tid)) a.kcnt[(t * SUB + ki) * LANE + tid] += 1;
    }
  }
}

// The block-uniform legs of the multi-pod conflict test between group pod
// e (batch index be_b, template te, committed at lane be) and the later
// group pod of template t whose speculative pick is `best` (:1817-1837):
// same node; pod e's PTS filter / score match lanes of template t's valid
// constraints (a sum, as the reference's gated dot); with ur > 0 the IPA
// template-interference superset gmat[te, t].
template <bool IPA>
__device__ __forceinline__ bool count_conflict(const Args& a, const Ctx& x,
                                               int be_b, int te, int be,
                                               int t, int best, int m) {
  if (be == best && m >= 0) return true;
  const int C = a.C, TC = a.T * a.C;
  const int* tc = x.sc + x.off_tc + t * C;
  const int8_t* me = a.match + (size_t)be_b * 2 * LANE + t * a.CP;
  int hit = 0;
  for (int c = 0; c < C; ++c)
    hit += me[c] * tc[W_F_VALID * TC + c]
        + me[LANE + c] * tc[W_S_VALID * TC + c];
  if (hit > 0) return true;
  return IPA && a.gmat[te * LANE + t] > 0.0f;
}

// __grid_constant__: the device functions take `a` by reference without
// a copy of it to local memory. Team = Cluster only for mode "full", one pod
// per step (scan_full_cluster_launch).
template <bool IPA, int MODE, typename Team = Block>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ Args a) {
  static_assert(!Team::CLUSTER || MODE == MODE_FULL,
                "the cluster team runs mode full, mk = 1");
  // the scalar table, then (IPA) the gate matrices as int32
  extern __shared__ int sc[];
  __shared__ Shared s;

  const int tid = threadIdx.x;
  const int T = a.T, C = a.C, Np = a.Np, R = a.R, UR = a.UR, Bp = a.Bp;
  Ctx x;
  x.sc = sc;
  x.row_len = 2 * R + 4;
  x.off_tc = T * x.row_len;
  x.off_fsame = x.off_tc + 10 * T * C;
  x.off_ssame = x.off_fsame + T * C * C;
  // IPA scalar extension: has_aff / self_match_all / aff_total [T, 3],
  // anti_valid then aff_valid [T, 8] each, then the w45 GCD scale
  x.off_ipa_t = x.off_ssame + T * C * C;
  x.off_av = x.off_ipa_t + 3 * T;
  x.off_w45s = x.off_av + 2 * T * SUB;
  const int n_sc = IPA ? x.off_w45s + 1 : x.off_ipa_t;
  for (int i = tid; i < n_sc; i += THREADS) sc[i] = a.scalars[i];
  // IPA gate matrices (values are small integers stored as f32)
  const int TU = T * UR;
  int* g1s = sc + n_sc;            // [T, UR]
  int* w3s = g1s + TU;             // [T, UR]
  int* w45s = w3s + TU;            // [T, UR]
  int* gps = w45s + TU;            // [T, UR]
  int* wantis = gps + TU;          // [T*8, UR]
  int* waffs = wantis + SUB * TU;  // [T*8, UR]
  if (IPA) {
    for (int i = tid; i < TU; i += THREADS) {
      g1s[i] = (int)a.g1[i];
      w3s[i] = (int)a.w3tot[i];
      w45s[i] = (int)a.w45[i];
      gps[i] = (int)a.gpres[i];
    }
    for (int i = tid; i < SUB * TU; i += THREADS) {
      wantis[i] = (int)a.wanti[i];
      waffs[i] = (int)a.waff[i];
    }
  }
  x.g1s = g1s; x.w3s = w3s; x.w45s = w45s; x.gps = gps;
  x.wantis = wantis; x.waffs = waffs;
  const Team team = Team::make(Np);
  __syncthreads();

  if (MODE == MODE_DELTA) {
    // the events in order, each the commit's column update at its node
    // with its own payload row; no barrier between events (each thread
    // reads static pair ids and writes only its own lanes)
    const int W = a.Rp + SUB + 2 * a.TCp;
    for (int e = 0; e < a.E; ++e) {
      const int node = a.dnode[e];
      if (node < 0 || node >= Np) continue;  // refused by the wrapper
      const int* row = a.drows + (size_t)e * W;
      int dnzpc[SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) dnzpc[i] = row[a.Rp + i];
      update_columns(a, x, team, node, a.Rp, row, dnzpc, row + a.Rp + SUB,
                     row + a.Rp + SUB + a.TCp);
    }
    return;
  }

  const int B = min(a.meta[0], Bp);

  if (MODE == MODE_APPLY) {
    // forced decisions: a commit where ok != 0 and the lane is on this
    // node axis; a -1 lane (unplaced, or another shard's node) commits
    // nothing
    for (int b = 0; b < B; ++b) {
      const int best = a.forced[2 * b], ok = a.forced[2 * b + 1];
      if (ok != 0 && best >= 0 && best < Np)
        commit_pod<IPA>(a, x, team, b, a.meta[1 + b], best);
    }
  } else if (MODE == MODE_MULTI) {
    const int mk = a.mk;
    int* scratch = a.work + 3 * Np;  // [2*mk, Np]: total | wbl per pod
    // the conflict-suffix flag; it carries across groups, since a later
    // group's evals chained on a carry that lacks the suffix's commits
    int seen = 0;
    for (int g0 = 0; g0 < B; g0 += mk) {
      const int gn = min(mk, B - g0);
      // evaluate the group's pods against the group-start carry; inside
      // the suffix only their feasible counts (out row 2) are needed
      for (int i = 0; i < gn; ++i) {
        const Eval e = eval_pod<IPA, MODE>(a, x, s, team, g0 + i, !seen,
                                           scratch + 2 * i * Np,
                                           scratch + (2 * i + 1) * Np);
        if (tid == 0) {
          s.g_t[i] = e.t; s.g_best[i] = e.best; s.g_m[i] = e.m;
          s.g_nf[i] = e.n_feas;
        }
      }
      __syncthreads();
      // commit in order, each gated by the exact conflict test
      for (int i = 0; i < gn; ++i) {
        const int b = g0 + i, t = s.g_t[i], best = s.g_best[i];
        const int m = s.g_m[i];
        // pod 0 of a group evaluated against the carry it commits to:
        // it cannot conflict, and once the suffix started nothing else
        // is committed
        if (!seen && i > 0) {
          // every earlier pod of this group was committed iff it found
          // a node (no conflict has been seen in the group yet)
          bool conf = false;
          for (int e = 0; e < i && !conf; ++e)
            if (s.g_m[e] >= 0)
              conf = count_conflict<IPA>(a, x, g0 + e, s.g_t[e],
                                         s.g_best[e], t, best, m);
          if (!conf) {
            // utilization legs (the reference's recheck, mirroring
            // kernel.multipod_utilization_conflicts): a speculatively
            // feasible lane that no longer fits, or one whose refreshed
            // total overtakes the pick, against the current carry
            const int* gtot = scratch + 2 * i * Np;
            const int* gwbl = gtot + Np;
            const int* tsc = sc + t * x.row_len;
            const int nzr0 = tsc[2 * R + 1], nzr1 = tsc[2 * R + 2];
            int util = 0;
            for (int n = tid; n < Np; n += THREADS) {
              const int tot = gtot[n];
              if (tot < 0) continue;
              if (!fits(a, tsc, n)) { util = 1; continue; }
              const int nt = tot - gwbl[n]
                  + resource_score(a, nzr0, nzr1, n);
              if (m >= 0 && (nt > m || (nt == m && n < best))) util = 1;
            }
            conf = __syncthreads_or(util) != 0;
          }
          seen = conf ? 1 : 0;
        }
        const bool okc = m >= 0 && !seen;
        if (okc) commit_pod<IPA>(a, x, team, b, t, best);
        if (tid == 0) {
          a.out[b] = okc ? best : -1;
          a.out[Bp + b] = okc ? m : -1;
          a.out[2 * Bp + b] = s.g_nf[i];
          a.out[3 * Bp + b] = seen;
        }
      }
    }
  } else {
    // MODE_FULL and MODE_EVAL: one pod per step
    for (int b = 0; b < B; ++b) {
      const Eval e = eval_pod<IPA, MODE>(a, x, s, team, b, true, nullptr,
                                         nullptr);
      const bool ok = e.m >= 0;
      if (team.leader()) {
        a.out[2 * Bp + b] = e.n_feas;
        if (ok) { a.out[b] = e.best; a.out[Bp + b] = e.m; }
      }
      if (MODE == MODE_FULL && ok)
        commit_pod<IPA>(a, x, team, b, e.t, e.best);
    }
  }
  if constexpr (Team::CLUSTER) team.finish();
}

typedef void (*KernelFn)(const Args);

// [IPA][MODE]
const KernelFn KERNELS[2][4] = {
    {scan_kernel<false, MODE_FULL>, scan_kernel<false, MODE_MULTI>,
     scan_kernel<false, MODE_EVAL>, scan_kernel<false, MODE_APPLY>},
    {scan_kernel<true, MODE_FULL>, scan_kernel<true, MODE_MULTI>,
     scan_kernel<true, MODE_EVAL>, scan_kernel<true, MODE_APPLY>},
};

}  // namespace

// p: the ArgPtr pointers, d: the ArgDim integers then the 8 weights.
// Launches the instantiation for (UR > 0, mode); MODE_DELTA has one. Returns
// 0 or a CUDA error (-1 for shapes or modes the kernel does not take).
extern "C" int scan_full_launch(void* const* p, const int* d, void* stream) {
  const int T = d[D_T], C = d[D_C], R = d[D_R], TCp = d[D_TCP];
  const int K = d[D_K], CP = d[D_CP], UR = d[D_UR];
  const int mode = d[D_MODE], mk = d[D_MK];
  if (C > MAXC || K > MAXK || TCp > LANE || TCp != T * CP) return -1;
  if (UR != 0 && UR != T * SUB) return -1;
  if (mode < MODE_FULL || mode > MODE_DELTA) return -1;
  if (mode == MODE_MULTI ? (mk < 2 || mk > MAXMK) : mk != 1) return -1;
  if (mode == MODE_APPLY && p[P_FORCED] == nullptr) return -1;
  if (mode == MODE_DELTA && (p[P_DNODE] == nullptr || p[P_DROWS] == nullptr
                             || d[D_E] < 0 || d[D_RP] < R || UR != 0))
    return -1;
  const Args a = unpack_args(p, d);
  // dynamic shared memory: the scalar table (with the IPA extension),
  // then the six gate matrices as int32, sized by the caller
  // (scan_kernel.smem_bytes)
  const size_t smem = (size_t)d[D_SMEM];
  const KernelFn kernel = mode == MODE_DELTA
      ? scan_kernel<false, MODE_DELTA> : KERNELS[UR ? 1 : 0][mode];
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The cluster instantiation for (UR > 0) in mode "full", mk = 1, over
// `cluster` blocks, one cluster: p and d as for scan_full_launch. Returns 0
// or a CUDA error; -1 for a shape, mode or cluster size it does not take, -2
// when the card cannot place one cluster of that size
// (cudaOccupancyMaxActiveClusters).
extern "C" int scan_full_cluster_launch(void* const* p, const int* d,
                                        int cluster, void* stream) {
  const int T = d[D_T], C = d[D_C], TCp = d[D_TCP];
  const int K = d[D_K], CP = d[D_CP], UR = d[D_UR];
  if (cluster != 2 && cluster != 4 && cluster != 8 && cluster != MAXCB)
    return -1;
  if (C > MAXC || K > MAXK || TCp > LANE || TCp != T * CP) return -1;
  if (UR != 0 && UR != T * SUB) return -1;
  if (d[D_MODE] != MODE_FULL || d[D_MK] != 1) return -1;
  const Args a = unpack_args(p, d);
  // dynamic shared memory as for scan_full_launch, on top of the static
  // Shared and ClusterSlots
  const size_t smem = (size_t)d[D_SMEM];
  const KernelFn kernel = UR ? scan_kernel<true, MODE_FULL, Cluster>
                             : scan_kernel<false, MODE_FULL, Cluster>;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (cluster > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return -2;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
