// The what-if reprieve walk: one preemptor's dry run on every node lane.
//
// Replaces the device half of kubernetes_tpu/ops/whatif.py `_whatif_run`
// (a jnp program, not a Pallas kernel): `feas_one` / `feas` (:245-302),
// fits_now and base feasibility (:304-319) and the reprieve `lax.scan` over
// the victim slots (:321-341). The per-launch prologue (free capacity and
// pod count with the claimed drains, the static gate, the PTS minimum
// structure, the IPA effective counts) stays in PyTorch
// (kubernetes_tpu_torch/ops/whatif.py `whatif_prologue`) and arrives here
// per node lane, with the reference's names.
//
// Design: one thread per node lane, a grid over the lanes. The nodes' dry
// runs are independent, so a thread walks its node's L slots in order with
// nothing shared: it evaluates feasibility with no eviction (fits_now) and
// with every slot evicted (base), then for each slot in order tries adding
// it back (cand = ev - slot) and keeps the add-back where the preemptor
// still fits. With nominated pods every feasibility is the AND of the pass
// without them and the pass with them (framework.go:610). The running
// eviction (R resource words, the pod count, C PTS match counts and TAA
// anti-term counts, all int64 as the reference's scan carry) lives in a
// [W, N] global scratch the wrapper allocates, word w of lane n at
// [w * N + n], so a warp's accesses coalesce and no shape is past a cap;
// the int32 matches-all count in a register. Everything is integer, so the
// result is exact. What bounds it on the card: the bytes of the victim
// slots (v_req dominates), read once, well under a microsecond at the
// preemption rows' shapes. This simple design does not reach that: each
// thread runs a serial chain of dependent global loads (L slots, each
// pass reading its R + C + TAA words again), and N / 128 blocks occupy a
// few SMs, so a launch costs tens of microseconds (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// pointer arguments, in the order of whatif_kernel.PTRS
enum WPtr {
  P_FREE0, P_CNT0, P_ALLOWED, P_REQ, P_CHK, P_GATE,
  P_PTS_SH, P_PTS_MN, P_REG_AT, P_PTS_CHK, P_SELF_M, P_F_SKEW,
  P_ANTI_EFF, P_ANTI_CHK, P_AFF_EFF, P_AFF_KEY_ON, P_AFF_VALID,
  P_AFF_TOTAL, P_AFF_KEYS, P_HAS_AFF, P_AFF_ALL_KEYS, P_SELF_MATCH_ALL,
  P_NOM_REQ, P_NOM_CNT, P_NOM_MFS, P_NOM_MANTI, P_NOM_MALL,
  P_V_VALID, P_V_CNT, P_V_REQ, P_V_MFS, P_V_MANTI, P_V_MALL,
  P_SCRATCH, P_FITS_NOW, P_BASE, P_VICTIMS,
  N_PTRS
};
// int arguments, in the order of whatif_kernel.DIMS
enum WDim { D_N, D_L, D_R, D_C, D_TAA, D_TA, D_DYN_IPA, D_HAS_NOM, D_THREADS,
            N_DIMS };

constexpr long long BIG = 2147483647LL;  // iinfo(int32).max, the min sentinel

struct Args {
  const long long *free0, *cnt0, *allowed, *req;
  const uint8_t *chk, *gate;
  const long long *pts_sh, *pts_mn;
  const uint8_t *reg_at, *pts_chk;
  const int *self_m, *f_skew;
  const long long *anti_eff;
  const uint8_t *anti_chk;
  const long long *aff_eff;
  const uint8_t *aff_key_on, *aff_valid;
  const long long *aff_total;
  const int *aff_keys;
  const uint8_t *has_aff, *aff_all_keys, *self_match_all;
  const long long *nom_req, *nom_cnt;
  const int *nom_mfs, *nom_manti, *nom_mall;
  const uint8_t *v_valid;
  const long long *v_cnt, *v_req;
  const int *v_mfs, *v_manti, *v_mall;
  long long* scratch;
  uint8_t *fits_now, *base, *victims;
  int N, L, R, C, TAA, TA, dyn_ipa, has_nom;
};

// int32 arithmetic that wraps as the reference's int32 does
__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// One filter pass at node n against the running eviction `st` (this
// thread's words, stride ts) with slot l added back (l < 0: as it is).
// NOM: the pass with the node's nominated pods added.
template <bool NOM>
__device__ bool feas_one(const Args& a, int n, const long long* st,
                         size_t ts, int l, int mall) {
  const bool sl = l >= 0;
  const size_t s = (size_t)n * a.L + (sl ? l : 0);
  const size_t nr = (size_t)n * a.R;
  // NodeResourcesFit: pod count, then every checked dimension
  long long cnt = a.cnt0[n] - (st[a.R * ts] - (sl ? a.v_cnt[s] : 0));
  if (NOM) cnt += a.nom_cnt[n];
  if (cnt + 1 > a.allowed[n]) return false;
  for (int r = 0; r < a.R; ++r) {
    if (!a.chk[r]) continue;
    long long f = a.free0[nr + r]
        + (st[r * ts] - (sl ? a.v_req[s * a.R + r] : 0));
    if (NOM) f -= a.nom_req[nr + r];
    if (a.req[r] > f) return false;
  }
  // PodTopologySpread: this node's pair count drops by the evicted
  // matches; the global min re-enters with it
  const size_t nc = (size_t)n * a.C;
  for (int c = 0; c < a.C; ++c) {
    if (!a.pts_chk[nc + c]) continue;
    long long delta = st[(a.R + 1 + c) * ts]
        - (sl ? (long long)a.v_mfs[s * a.C + c] : 0);
    if (NOM) delta -= a.nom_mfs[nc + c];
    const long long adj = a.pts_sh[nc + c] - delta;
    long long m = a.pts_mn[nc + c];
    long long cnt_eff = 0;
    if (a.reg_at[nc + c]) {
      cnt_eff = adj;
      m = m < adj ? m : adj;
    }
    if (m == BIG) m = 0;
    if (cnt_eff + a.self_m[c] - m > a.f_skew[c]) return false;
  }
  if (!a.dyn_ipa) return true;
  // InterPodAffinity: the preemptor's anti terms, then its affinity terms
  const size_t nt = (size_t)n * a.TAA;
  for (int t = 0; t < a.TAA; ++t) {
    if (!a.anti_chk[nt + t]) continue;
    long long adj = a.anti_eff[nt + t]
        - (st[(a.R + 1 + a.C + t) * ts]
           - (sl ? (long long)a.v_manti[s * a.TAA + t] : 0));
    if (NOM) adj += a.nom_manti[nt + t];
    if (adj > 0) return false;
  }
  if (!a.has_aff[0]) return true;       // no affinity terms
  if (!a.aff_all_keys[n]) return false;  // a term's key is off the node
  const int ml = sl ? add32(mall, -a.v_mall[s]) : mall;
  const size_t na = (size_t)n * a.TA;
  bool exist = true;
  for (int t = 0; t < a.TA; ++t) {
    if (!a.aff_valid[t]) continue;
    long long adj = a.aff_eff[na + t];
    if (a.aff_key_on[na + t]) {
      adj -= ml;
      if (NOM) adj += a.nom_mall[n];
    }
    if (!(adj > 0)) exist = false;
  }
  if (exist) return true;
  long long tot = a.aff_total[0] - (long long)mul32(ml, a.aff_keys[n]);
  if (NOM) tot += (long long)mul32(a.nom_mall[n], a.aff_keys[n]);
  return tot == 0 && a.self_match_all[0];
}

__device__ __forceinline__ bool feas(const Args& a, int n, const long long* st,
                                     size_t ts, int l, int mall) {
  if (!a.gate[n]) return false;
  if (!feas_one<false>(a, n, st, ts, l, mall)) return false;
  return !a.has_nom || feas_one<true>(a, n, st, ts, l, mall);
}

__global__ void whatif_kernel(Args a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const size_t ts = (size_t)a.N;
  long long* st = a.scratch + n;
  const int W = a.R + 1 + a.C + a.TAA;
  const int w_mfs = a.R + 1, w_manti = a.R + 1 + a.C;
  for (int w = 0; w < W; ++w) st[w * ts] = 0;
  a.fits_now[n] = feas(a, n, st, ts, -1, 0);
  // every slot evicted (the reference sums all L slots, valid or not)
  const size_t nL = (size_t)n * a.L;
  int mall = 0;
  for (int l = 0; l < a.L; ++l) {
    const size_t s = nL + l;
    for (int r = 0; r < a.R; ++r) st[r * ts] += a.v_req[s * a.R + r];
    st[a.R * ts] += a.v_cnt[s];
    for (int c = 0; c < a.C; ++c) st[(w_mfs + c) * ts] += a.v_mfs[s * a.C + c];
    for (int t = 0; t < a.TAA; ++t)
      st[(w_manti + t) * ts] += a.v_manti[s * a.TAA + t];
    mall = add32(mall, a.v_mall[s]);
  }
  a.base[n] = feas(a, n, st, ts, -1, mall);
  // the reprieve walk: add each slot back, in order, where it still fits
  for (int l = 0; l < a.L; ++l) {
    const size_t s = nL + l;
    const bool valid = a.v_valid[s] != 0;
    const bool rep = valid && feas(a, n, st, ts, l, mall);
    if (rep) {
      for (int r = 0; r < a.R; ++r) st[r * ts] -= a.v_req[s * a.R + r];
      st[a.R * ts] -= a.v_cnt[s];
      for (int c = 0; c < a.C; ++c)
        st[(w_mfs + c) * ts] -= a.v_mfs[s * a.C + c];
      for (int t = 0; t < a.TAA; ++t)
        st[(w_manti + t) * ts] -= a.v_manti[s * a.TAA + t];
      mall = add32(mall, -a.v_mall[s]);
    }
    a.victims[s] = valid && !rep;
  }
}

}  // namespace

// One launch on `stream`; returns the CUDA error of the launch (0 = none).
// The wrapper (whatif_kernel.py) checks shapes and types before calling.
extern "C" int whatif_launch(void* const* p, const int* d, void* stream) {
  Args a;
  a.free0 = (const long long*)p[P_FREE0];
  a.cnt0 = (const long long*)p[P_CNT0];
  a.allowed = (const long long*)p[P_ALLOWED];
  a.req = (const long long*)p[P_REQ];
  a.chk = (const uint8_t*)p[P_CHK];
  a.gate = (const uint8_t*)p[P_GATE];
  a.pts_sh = (const long long*)p[P_PTS_SH];
  a.pts_mn = (const long long*)p[P_PTS_MN];
  a.reg_at = (const uint8_t*)p[P_REG_AT];
  a.pts_chk = (const uint8_t*)p[P_PTS_CHK];
  a.self_m = (const int*)p[P_SELF_M];
  a.f_skew = (const int*)p[P_F_SKEW];
  a.anti_eff = (const long long*)p[P_ANTI_EFF];
  a.anti_chk = (const uint8_t*)p[P_ANTI_CHK];
  a.aff_eff = (const long long*)p[P_AFF_EFF];
  a.aff_key_on = (const uint8_t*)p[P_AFF_KEY_ON];
  a.aff_valid = (const uint8_t*)p[P_AFF_VALID];
  a.aff_total = (const long long*)p[P_AFF_TOTAL];
  a.aff_keys = (const int*)p[P_AFF_KEYS];
  a.has_aff = (const uint8_t*)p[P_HAS_AFF];
  a.aff_all_keys = (const uint8_t*)p[P_AFF_ALL_KEYS];
  a.self_match_all = (const uint8_t*)p[P_SELF_MATCH_ALL];
  a.nom_req = (const long long*)p[P_NOM_REQ];
  a.nom_cnt = (const long long*)p[P_NOM_CNT];
  a.nom_mfs = (const int*)p[P_NOM_MFS];
  a.nom_manti = (const int*)p[P_NOM_MANTI];
  a.nom_mall = (const int*)p[P_NOM_MALL];
  a.v_valid = (const uint8_t*)p[P_V_VALID];
  a.v_cnt = (const long long*)p[P_V_CNT];
  a.v_req = (const long long*)p[P_V_REQ];
  a.v_mfs = (const int*)p[P_V_MFS];
  a.v_manti = (const int*)p[P_V_MANTI];
  a.v_mall = (const int*)p[P_V_MALL];
  a.scratch = (long long*)p[P_SCRATCH];
  a.fits_now = (uint8_t*)p[P_FITS_NOW];
  a.base = (uint8_t*)p[P_BASE];
  a.victims = (uint8_t*)p[P_VICTIMS];
  a.N = d[D_N];
  a.L = d[D_L];
  a.R = d[D_R];
  a.C = d[D_C];
  a.TAA = d[D_TAA];
  a.TA = d[D_TA];
  a.dyn_ipa = d[D_DYN_IPA];
  a.has_nom = d[D_HAS_NOM];
  const int threads = d[D_THREADS];
  const int blocks = (a.N + threads - 1) / threads;
  whatif_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
