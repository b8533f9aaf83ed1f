// The what-if dry run: one preemptor's victim search on every node lane.
//
// Replaces the whole of kubernetes_tpu/ops/whatif.py `_whatif_run` (a jnp
// program, not a Pallas kernel): its prologue (:146-243), `feas_one` /
// `feas` (:245-302), fits_now and base (:304-319) and the reprieve
// `lax.scan` over the victim slots (:321-341). Three kernels:
//
//   whatif_context_kernel  once per what-if context and template: the
//       values that depend only on the context's carry and the template
//       (the eviction-invariant gate: static_mask, the host-port mask, the
//       existing pods' anti terms; the PTS shared counts of the template's
//       constraints; the IPA effective term counts with the reference's
//       int32 count products), kept on the context;
//   whatif_mins_kernel     once per preemptor where a spread constraint is
//       valid, one block a constraint: the PTS minimum structure (min,
//       count at the min, second min) of the shared counts with the
//       claimed drains applied;
//   whatif_kernel          once per preemptor: the walk.
//
// The walk's design. The nodes' dry runs are independent and each is a
// serial greedy over its L slots, so a node lane is a warp and the slot
// walk is the only serial loop.
// Word w of the running eviction (R resources, the pod count, C PTS match
// counts, TAA anti-term counts; int64 as the reference's scan carry) lives
// in a register of lane w % 32 (KW words a lane where W > 32); the
// matches-all count (int32, wrapping as the reference's) in every lane.
// Each lane reads its own word's prologue values once, straight from the
// session's tables at the template and the packed per-preemptor inputs
// (free capacity with the claimed drains, the PTS gathers through the
// node's pairs, the IPA gathers through pair_of_key), and folds them into
// a threshold: a resource, the pod count or an anti term fails where the
// eviction word is below it. A lane reads only what its word needs: a
// node whose gate is shut reads nothing more, an unchecked word nothing,
// and what only the nominated pass needs is read only with nominated
// pods. A feasibility pass is then a compare a lane and a warp-wide vote
// (__any_sync): a failing word (either pass with
// nominated pods: framework.go:610 is the AND of both); with affinity
// terms, two more: a term with no pod left, without / with the nominated
// pods. A slot's rows (v_req[n, l, :], v_mfs, v_manti) are
// one load a lane, neighbouring lanes on neighbouring words, issued a slot
// ahead of the pass that needs them. All of it is integer arithmetic, so
// the result is exact.
//
// What bounds it on the card: the bytes of the packed inputs and the
// tables read (v_req dominates), each once: a fraction of a microsecond
// at the preemption rows' shapes (chip_smoke.whatif_bound). At a few
// hundred nodes the grid is N warps, 8 a block: most SMs hold a
// block, and a launch costs its fixed overhead plus L serial passes of a
// few dozen cycles each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// pointer arguments, in the order of whatif_kernel.PTRS
enum WPtr {
  P_ALLOC, P_REQUESTED, P_POD_COUNT, P_ALLOWED, P_REQ, P_REQ_CHECK,
  P_REQ_HAS_ANY, P_STATIC_MASK, P_F_VALID, P_F_KEY_ON, P_F_PAIR_CN,
  P_F_REG_REAL, P_F_SAME_KEY, P_F_CNT, P_F_SELF_MATCH, P_F_SKEW,
  P_WANT_PAIR, P_WANT_TRIPLE, P_WANT_WILD, P_WANT_VALID,
  P_CP_ANY, P_CP_WILD, P_CP_TRIP,
  P_ANTI_KEY_ON, P_ANTI_VALID, P_ANTI_KEY, P_ANTI_CNT_N, P_M_ANTI,
  P_KAA_ALL, P_FAIL_EXISTING, P_MATCH_ALL, P_AFF_KEY, P_AFF_VALID,
  P_AFF_CNT_N, P_AFF_TOTAL, P_HAS_AFF, P_AFF_ALL_KEYS, P_SELF_MATCH_ALL,
  P_POK, P_NKEY, P_U_CNT, P_K_CNT,
  P_GATE0, P_SHARED0, P_ANTI0, P_AFF0, P_ATOT0,
  P_INP, P_MINS, P_OUT,
  N_PTRS
};
// int arguments, in the order of whatif_kernel.DIMS (the o_* are byte
// offsets of the packed inputs in P_INP, in whatif_kernel.PACKED's order)
enum WDim {
  D_N, D_L, D_R, D_C, D_TAA, D_TA, D_VNP, D_K, D_U, D_MP, D_PW, D_PT,
  D_TJ, D_DYN_IPA, D_DYN_PORTS, D_HAS_NOM, D_ANY_F, D_KW,
  D_O_V_VALID, D_O_V_CNT, D_O_V_REQ, D_O_V_MFS, D_O_V_MANTI, D_O_V_MALL,
  D_O_NOM_REQ, D_O_NOM_CNT, D_O_NOM_MFS, D_O_NOM_MANTI, D_O_NOM_MALL,
  D_O_PRE_REQ, D_O_PRE_CNT, D_O_PRE_SHARED, D_O_PRE_ANTI, D_O_PRE_AFF,
  D_O_PRE_ATOT,
  N_DIMS
};

typedef long long i64;
typedef uint8_t u8;

constexpr i64 BIG = 2147483647LL;  // iinfo(int32).max, the min sentinel
constexpr int THREADS = 256;       // every kernel's block
constexpr int TEAM = 32;           // the walk's lanes a node lane: a warp

struct Args {
  // the session's tables at template tj, the context's carry
  const i64 *alloc, *requested;
  const int* pod_count;
  const i64 *allowed, *req;
  const u8 *req_check, *req_has_any, *static_mask, *f_valid, *f_key_on;
  const int* f_pair_cn;
  const u8 *f_reg_real, *f_same_key;
  const int *f_cnt, *f_self_match, *f_skew;
  const int *want_pair, *want_triple;
  const u8 *want_wild, *want_valid;
  const int *cp_any, *cp_wild, *cp_trip;
  const u8 *anti_key_on, *anti_valid;
  const int* anti_key;
  const i64* anti_cnt_n;
  const u8* m_anti;
  const int* kaa_all;
  const u8 *fail_existing, *match_all;
  const int* aff_key;
  const u8* aff_valid;
  const i64 *aff_cnt_n, *aff_total;
  const u8 *has_aff, *aff_all_keys, *self_match_all;
  const int* pok;
  const u8* nkey;
  const int *u_cnt, *k_cnt;
  // the context's invariants (whatif_context_kernel writes them)
  u8* gate0;
  i64 *shared0, *anti0, *aff0, *atot0;
  // one preemptor's packed inputs
  const u8* v_valid;
  const i64 *v_cnt, *v_req;
  const int *v_mfs, *v_manti, *v_mall;
  const i64 *nom_req, *nom_cnt;
  const int *nom_mfs, *nom_manti, *nom_mall;
  const i64 *pre_req, *pre_cnt;
  const int *pre_shared, *pre_anti, *pre_aff, *pre_atot;
  i64* mins;
  u8* out;
  int N, L, R, C, TAA, TA, VNP, K, U, MP, PW, PT, tj, dyn_ipa, dyn_ports,
      has_nom, any_f;
};

// int32 arithmetic that wraps as the reference's int32 does
__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }

// -- the context's invariants -------------------------------------------------

__global__ void __launch_bounds__(THREADS) whatif_context_kernel(Args a) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  // the template's PTS shared counts: each constraint's same-key sum
  for (int i = tid; i < a.C * a.VNP; i += stride) {
    const int c = i / a.VNP, v = i - c * a.VNP;
    i64 s = 0;
    for (int c2 = 0; c2 < a.C; ++c2)
      if (a.f_same_key[c * a.C + c2]) s += a.f_cnt[c2 * a.VNP + v];
    a.shared0[i] = s;
  }
  // the eviction-invariant gate
  for (int n = tid; n < a.N; n += stride) {
    bool g = a.static_mask[n] != 0;
    if (a.dyn_ports) {
      // NodePorts (the session's assumed ports): a wildcard want
      // conflicts with any holder of the (proto, port), a specific one
      // with a wildcard holder or the exact triple
      for (int p = 0; p < a.MP && g; ++p) {
        if (!a.want_valid[p]) continue;
        const int pr = a.want_pair[p];
        const bool conflict = a.want_wild[p]
            ? a.cp_any[(size_t)n * a.PW + pr] > 0
            : a.cp_wild[(size_t)n * a.PW + pr] > 0
                  || a.cp_trip[(size_t)n * a.PT + a.want_triple[p]] > 0;
        if (conflict) g = false;
      }
    }
    if (a.dyn_ipa && g) {
      // an existing pod's anti term matching the preemptor, by the
      // prologue's statics or the session's assumed pods
      if (a.fail_existing[n]) g = false;
      for (int u = 0; u < a.U && g; ++u)
        for (int t = 0; t < a.TAA && g; ++t) {
          if (!a.m_anti[((size_t)u * a.TAA + t) * a.U + a.tj]) continue;
          const int key = a.kaa_all[u * a.TAA + t];
          const size_t nk = (size_t)n * a.K + key;
          if (a.nkey[nk] && a.u_cnt[(size_t)u * a.VNP + a.pok[nk]] > 0)
            g = false;
        }
    }
    a.gate0[n] = g;
  }
  if (!a.dyn_ipa) return;
  // the preemptor's anti terms' counts at the node's pairs: statics plus
  // the int32 count product of the session's assumed pods
  for (int i = tid; i < a.N * a.TAA; i += stride) {
    const int n = i / a.TAA, t = i - n * a.TAA;
    const int pair = a.pok[(size_t)n * a.K + a.anti_key[t]];
    int w = 0;
    for (int u = 0; u < a.U; ++u)
      if (a.m_anti[((size_t)a.tj * a.TAA + t) * a.U + u])
        w = add32(w, a.u_cnt[(size_t)u * a.VNP + pair]);
    a.anti0[i] = a.anti_cnt_n[i] + (i64)w;
  }
  // its affinity terms' counts: pods matching ALL of its terms
  for (int i = tid; i < a.N * a.TA; i += stride) {
    const int n = i / a.TA, t = i - n * a.TA;
    const int pair = a.pok[(size_t)n * a.K + a.aff_key[t]];
    int w = 0;
    for (int u = 0; u < a.U; ++u)
      if (a.match_all[u]) w = add32(w, a.u_cnt[(size_t)u * a.VNP + pair]);
    a.aff0[i] = a.aff_cnt_n[i] + (i64)w;
  }
  if (tid == 0) {
    i64 s = 0;
    for (int u = 0; u < a.U; ++u)
      for (int t = 0; t < a.TA; ++t)
        if (a.aff_valid[t] && a.match_all[u])
          s += a.k_cnt[(size_t)u * a.K + a.aff_key[t]];
    a.atot0[0] = a.aff_total[0] + s;
  }
}

// -- the PTS minimum structure ------------------------------------------------

// block-wide min / sum of one value a thread (every thread calls)
__device__ i64 block_min(i64 x, i64* red) {
  for (int o = 16; o; o >>= 1) x = imin(x, __shfl_xor_sync(~0u, x, o));
  __syncthreads();  // red's previous use is read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < THREADS / 32; ++w) x = imin(x, red[w]);
  return x;
}
__device__ i64 block_sum(i64 x, i64* red) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < THREADS / 32; ++w) x += red[w];
  return x;
}

// (min, count at the min, min of the rest) of constraint c's registered
// pairs' shared counts, claimed drains applied; unregistered pairs count
// as BIG. Thread 0 writes res[0..2].
__device__ void min_triple(const Args& a, int c, i64* red, i64* res) {
  const size_t cv = (size_t)c * a.VNP;
  i64 m = BIG;
  for (int v = threadIdx.x; v < a.VNP; v += THREADS)
    m = imin(m, a.f_reg_real[cv + v] ? a.shared0[cv + v] - a.pre_shared[cv + v]
                                     : BIG);
  const i64 m1 = block_min(m, red);
  i64 cnt = 0, m2 = BIG;
  for (int v = threadIdx.x; v < a.VNP; v += THREADS) {
    const i64 x = a.f_reg_real[cv + v]
        ? a.shared0[cv + v] - a.pre_shared[cv + v] : BIG;
    if (x == m1) ++cnt;
    else m2 = imin(m2, x);
  }
  cnt = block_sum(cnt, red);
  m2 = block_min(m2, red);
  if (threadIdx.x == 0) {
    res[0] = m1;
    res[1] = cnt;
    res[2] = m2;
  }
}

__global__ void __launch_bounds__(THREADS) whatif_mins_kernel(Args a) {
  __shared__ i64 red[THREADS / 32];
  min_triple(a, blockIdx.x, red, a.mins + 3 * blockIdx.x);
}

// -- the walk -----------------------------------------------------------------

// one eviction word of a lane
struct Word {
  int kind;          // 0 unchecked, 1 threshold, 2 PTS constraint
  i64 thr0, thr1;    // kind 1: fails where the word is below (without /
                     // with the nominated pods)
  i64 sh, mn, self_m, skew, nmfs;  // kind 2
  bool reg;
  const void* src;   // the word's column of the node's slot rows
  int stride;
  bool wide;         // int64 rows (else int32)
};

__device__ __forceinline__ i64 slot_word(const Word& w, int l) {
  return w.wide ? ((const i64*)w.src)[(size_t)l * w.stride]
                : (i64)((const int*)w.src)[(size_t)l * w.stride];
}

// PodTopologySpread at the node's pair of the constraint: its count drops
// by the evicted matches (nominated matches re-added), and the global min
// re-enters with the adjusted count
__device__ __forceinline__ bool pts_fails(const Word& w, i64 x, i64 nom) {
  const i64 adj = w.sh - (x - nom);
  const i64 cnt_eff = w.reg ? adj : 0;
  i64 m = w.reg ? imin(w.mn, adj) : w.mn;
  if (m == BIG) m = 0;
  return cnt_eff + w.self_m - m > w.skew;
}

__device__ __forceinline__ bool word_fails(const Word& w, i64 x,
                                           bool has_nom) {
  if (w.kind == 1) return x < w.thr0 || (has_nom && x < w.thr1);
  if (w.kind == 2)
    return pts_fails(w, x, 0) || (has_nom && pts_fails(w, x, w.nmfs));
  return false;
}

// the lane's affinity terms
template <int KW>
struct Terms {
  bool valid[KW], on[KW];
  i64 eff[KW];
};

// A node whose gate is shut fits at no eviction: every valid slot is a
// victim, and fits_now and base are false.
__device__ __forceinline__ void shut(const Args& a, u8* orow, size_t nL,
                                     int lane) {
  for (int l = lane; l < a.L; l += TEAM) orow[2 + l] = a.v_valid[nL + l];
  if (lane == 0) orow[0] = orow[1] = 0;
}

template <int KW>
__global__ void __launch_bounds__(THREADS) whatif_kernel(Args a) {
  const int lane = threadIdx.x & (TEAM - 1);
  const int n = (int)(((long long)blockIdx.x * THREADS + threadIdx.x) / TEAM);
  if (n >= a.N) return;  // the whole warp
  const int L = a.L, R = a.R, C = a.C, TAA = a.TAA;
  const size_t nL = (size_t)n * L;
  u8* orow = a.out + (size_t)n * (L + 2);
  if (!a.gate0[n]) {
    shut(a, orow, nL, lane);
    return;
  }
  const int W = R + 1 + C + (a.dyn_ipa ? TAA : 0);
  const bool has_nom = a.has_nom != 0;

  // -- the lane prologue: each word's threshold or PTS state; what only
  // the nominated pass reads is loaded only with nominated pods ----------
  Word wd[KW];
  bool miss = false;  // a valid PTS constraint's key is off the node
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    Word& w = wd[k];
    const int i = lane + TEAM * k;
    w.kind = 0;
    if (i < R) {  // NodeResourcesFit, one checked dimension
      if (a.req_check[i] && a.req_has_any[0]) {
        const size_t nr = (size_t)n * R + i;
        const i64 free0 = a.alloc[nr] - a.requested[nr] + a.pre_req[nr];
        w.kind = 1;
        w.thr0 = a.req[i] - free0;
        w.thr1 = has_nom ? w.thr0 + a.nom_req[nr] : 0;
        w.src = a.v_req + nL * R + i;
        w.stride = R;
        w.wide = true;
      }
    } else if (i == R) {  // the pod count
      const i64 cnt0 = (i64)a.pod_count[n] - a.pre_cnt[n];
      w.kind = 1;
      w.thr0 = cnt0 + 1 - a.allowed[n];
      w.thr1 = has_nom ? w.thr0 + a.nom_cnt[n] : 0;
      w.src = a.v_cnt + nL;
      w.stride = 1;
      w.wide = true;
    } else if (i < R + 1 + C) {  // a PTS constraint
      const int c = i - R - 1;
      const size_t nc = (size_t)n * C + c;
      if (a.any_f && a.f_valid[c]) {
        if (!a.f_key_on[nc]) {
          miss = true;
        } else {
          const int pair = a.f_pair_cn[nc];
          const size_t cv = (size_t)c * a.VNP + pair;
          const i64 m1 = a.mins[3 * c], cm = a.mins[3 * c + 1],
                    m2 = a.mins[3 * c + 2];
          w.kind = 2;
          w.sh = a.shared0[cv] - a.pre_shared[cv];
          w.reg = a.f_reg_real[cv] != 0;
          // the global min with this node's own pair EXCLUDED where it is
          // registered: it re-enters adjusted
          w.mn = w.reg && w.sh == m1 && cm == 1 ? m2 : m1;
          w.self_m = a.f_self_match[c];
          w.skew = a.f_skew[c];
          w.nmfs = has_nom ? a.nom_mfs[nc] : 0;
          w.src = a.v_mfs + nL * C + c;
          w.stride = C;
          w.wide = false;
        }
      }
    } else if (i < W) {  // one of the preemptor's anti terms
      const int t = i - R - 1 - C;
      const size_t nt = (size_t)n * TAA + t;
      if (a.anti_valid[t] && a.anti_key_on[nt]) {
        const int pair = a.pok[(size_t)n * a.K + a.anti_key[t]];
        w.kind = 1;
        w.thr0 = a.anti0[nt] - a.pre_anti[(size_t)t * a.VNP + pair];
        w.thr1 = has_nom ? w.thr0 + a.nom_manti[nt] : 0;
        w.src = a.v_manti + nL * TAA + t;
        w.stride = TAA;
        w.wide = false;
      }
    }
  }
  if (__any_sync(~0u, miss)) {  // a constraint's key is off the node
    shut(a, orow, nL, lane);
    return;
  }
  // the affinity terms, a lane each
  const bool has_aff = a.dyn_ipa && a.has_aff[0];
  Terms<KW> tm;
  // one evicted matches-all victim drains aff_total by the number of its
  // node's scattered term entries
  int aff_keys = 0;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const int t = lane + TEAM * k;
    tm.valid[k] = has_aff && t < a.TA && a.aff_valid[t];
    tm.on[k] = false;
    if (tm.valid[k]) {
      const size_t nk = (size_t)n * a.K + a.aff_key[t];
      tm.on[k] = a.nkey[nk] != 0;
      tm.eff[k] = a.aff0[(size_t)n * a.TA + t] - a.pre_aff[a.pok[nk]];
    }
    aff_keys += __popc(__ballot_sync(~0u, tm.valid[k] && tm.on[k]));
  }
  const bool all_keys = has_aff && a.aff_all_keys[n];
  const bool self_all = has_aff && a.self_match_all[0];
  const i64 atot = has_aff ? a.atot0[0] - (i64)a.pre_atot[0] : 0;
  // the matches-all counts enter only through the affinity terms
  const int nom_mall = has_aff && has_nom ? a.nom_mall[n] : 0;

  // one feasibility pass against the eviction x (matches-all count ml)
  auto feas = [&](const i64* x, int ml) -> bool {
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < KW; ++k)
      if (word_fails(wd[k], x[k], has_nom)) bits = 1;
    if (all_keys) {
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        if (!tm.valid[k]) continue;
        const i64 adj = tm.eff[k] - (tm.on[k] ? (i64)ml : 0);
        if (!(adj > 0)) bits |= 2;
        if (has_nom && !(adj + (tm.on[k] ? (i64)nom_mall : 0) > 0)) bits |= 4;
      }
    }
    if (__any_sync(~0u, bits & 1)) return false;
    if (!has_aff) return true;
    if (!all_keys) return false;  // a term's key is off the node
    const i64 tot0 = atot - (i64)mul32(ml, aff_keys);
    if (__any_sync(~0u, bits & 2) && !(tot0 == 0 && self_all)) return false;
    if (has_nom) {
      const i64 tot1 = tot0 + (i64)mul32(nom_mall, aff_keys);
      if (__any_sync(~0u, bits & 4) && !(tot1 == 0 && self_all))
        return false;
    }
    return true;
  };

  i64 x[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) x[k] = 0;
  const bool fits_now = feas(x, 0);
  // every slot evicted (the reference sums all L slots, valid or not)
  int ml = 0;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int k = 0; k < KW; ++k)
      if (wd[k].kind) x[k] += slot_word(wd[k], l);
    if (has_aff) ml = add32(ml, a.v_mall[nL + l]);
  }
  const bool base = feas(x, ml);

  // the reprieve walk: add each slot back, in order, where the preemptor
  // still fits; the next slot's rows are loaded during this slot's pass
  i64 nxt[KW];
  int nxt_mall = 0;
  bool nxt_valid = false;
  if (L > 0) {
#pragma unroll
    for (int k = 0; k < KW; ++k) nxt[k] = wd[k].kind ? slot_word(wd[k], 0) : 0;
    nxt_mall = has_aff ? a.v_mall[nL] : 0;
    nxt_valid = a.v_valid[nL] != 0;
  }
  for (int l = 0; l < L; ++l) {
    i64 cand[KW];
#pragma unroll
    for (int k = 0; k < KW; ++k) cand[k] = x[k] - nxt[k];
    const int cml = sub32(ml, nxt_mall);
    const bool valid = nxt_valid;
    if (l + 1 < L) {
#pragma unroll
      for (int k = 0; k < KW; ++k)
        nxt[k] = wd[k].kind ? slot_word(wd[k], l + 1) : 0;
      nxt_mall = has_aff ? a.v_mall[nL + l + 1] : 0;
      nxt_valid = a.v_valid[nL + l + 1] != 0;
    }
    const bool rep = valid && feas(cand, cml);
    if (rep) {
#pragma unroll
      for (int k = 0; k < KW; ++k) x[k] = cand[k];
      ml = cml;
    }
    if (lane == 0) orow[2 + l] = valid && !rep;
  }
  if (lane == 0) {
    orow[0] = fits_now;
    orow[1] = base;
  }
}

cudaError_t launch_walk(const Args& a, int kw, cudaStream_t s) {
  const int blocks = (int)(((long long)a.N * TEAM + THREADS - 1) / THREADS);
  switch (kw) {
    case 1: whatif_kernel<1><<<blocks, THREADS, 0, s>>>(a); break;
    case 2: whatif_kernel<2><<<blocks, THREADS, 0, s>>>(a); break;
    case 4: whatif_kernel<4><<<blocks, THREADS, 0, s>>>(a); break;
    case 8: whatif_kernel<8><<<blocks, THREADS, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

Args make_args(void* const* p, const int* d) {
  Args a;
  a.alloc = (const i64*)p[P_ALLOC];
  a.requested = (const i64*)p[P_REQUESTED];
  a.pod_count = (const int*)p[P_POD_COUNT];
  a.allowed = (const i64*)p[P_ALLOWED];
  a.req = (const i64*)p[P_REQ];
  a.req_check = (const u8*)p[P_REQ_CHECK];
  a.req_has_any = (const u8*)p[P_REQ_HAS_ANY];
  a.static_mask = (const u8*)p[P_STATIC_MASK];
  a.f_valid = (const u8*)p[P_F_VALID];
  a.f_key_on = (const u8*)p[P_F_KEY_ON];
  a.f_pair_cn = (const int*)p[P_F_PAIR_CN];
  a.f_reg_real = (const u8*)p[P_F_REG_REAL];
  a.f_same_key = (const u8*)p[P_F_SAME_KEY];
  a.f_cnt = (const int*)p[P_F_CNT];
  a.f_self_match = (const int*)p[P_F_SELF_MATCH];
  a.f_skew = (const int*)p[P_F_SKEW];
  a.want_pair = (const int*)p[P_WANT_PAIR];
  a.want_triple = (const int*)p[P_WANT_TRIPLE];
  a.want_wild = (const u8*)p[P_WANT_WILD];
  a.want_valid = (const u8*)p[P_WANT_VALID];
  a.cp_any = (const int*)p[P_CP_ANY];
  a.cp_wild = (const int*)p[P_CP_WILD];
  a.cp_trip = (const int*)p[P_CP_TRIP];
  a.anti_key_on = (const u8*)p[P_ANTI_KEY_ON];
  a.anti_valid = (const u8*)p[P_ANTI_VALID];
  a.anti_key = (const int*)p[P_ANTI_KEY];
  a.anti_cnt_n = (const i64*)p[P_ANTI_CNT_N];
  a.m_anti = (const u8*)p[P_M_ANTI];
  a.kaa_all = (const int*)p[P_KAA_ALL];
  a.fail_existing = (const u8*)p[P_FAIL_EXISTING];
  a.match_all = (const u8*)p[P_MATCH_ALL];
  a.aff_key = (const int*)p[P_AFF_KEY];
  a.aff_valid = (const u8*)p[P_AFF_VALID];
  a.aff_cnt_n = (const i64*)p[P_AFF_CNT_N];
  a.aff_total = (const i64*)p[P_AFF_TOTAL];
  a.has_aff = (const u8*)p[P_HAS_AFF];
  a.aff_all_keys = (const u8*)p[P_AFF_ALL_KEYS];
  a.self_match_all = (const u8*)p[P_SELF_MATCH_ALL];
  a.pok = (const int*)p[P_POK];
  a.nkey = (const u8*)p[P_NKEY];
  a.u_cnt = (const int*)p[P_U_CNT];
  a.k_cnt = (const int*)p[P_K_CNT];
  a.gate0 = (u8*)p[P_GATE0];
  a.shared0 = (i64*)p[P_SHARED0];
  a.anti0 = (i64*)p[P_ANTI0];
  a.aff0 = (i64*)p[P_AFF0];
  a.atot0 = (i64*)p[P_ATOT0];
  const u8* inp = (const u8*)p[P_INP];
  a.v_valid = inp + d[D_O_V_VALID];
  a.v_cnt = (const i64*)(inp + d[D_O_V_CNT]);
  a.v_req = (const i64*)(inp + d[D_O_V_REQ]);
  a.v_mfs = (const int*)(inp + d[D_O_V_MFS]);
  a.v_manti = (const int*)(inp + d[D_O_V_MANTI]);
  a.v_mall = (const int*)(inp + d[D_O_V_MALL]);
  a.nom_req = (const i64*)(inp + d[D_O_NOM_REQ]);
  a.nom_cnt = (const i64*)(inp + d[D_O_NOM_CNT]);
  a.nom_mfs = (const int*)(inp + d[D_O_NOM_MFS]);
  a.nom_manti = (const int*)(inp + d[D_O_NOM_MANTI]);
  a.nom_mall = (const int*)(inp + d[D_O_NOM_MALL]);
  a.pre_req = (const i64*)(inp + d[D_O_PRE_REQ]);
  a.pre_cnt = (const i64*)(inp + d[D_O_PRE_CNT]);
  a.pre_shared = (const int*)(inp + d[D_O_PRE_SHARED]);
  a.pre_anti = (const int*)(inp + d[D_O_PRE_ANTI]);
  a.pre_aff = (const int*)(inp + d[D_O_PRE_AFF]);
  a.pre_atot = (const int*)(inp + d[D_O_PRE_ATOT]);
  a.mins = (i64*)p[P_MINS];
  a.out = (u8*)p[P_OUT];
  a.N = d[D_N];
  a.L = d[D_L];
  a.R = d[D_R];
  a.C = d[D_C];
  a.TAA = d[D_TAA];
  a.TA = d[D_TA];
  a.VNP = d[D_VNP];
  a.K = d[D_K];
  a.U = d[D_U];
  a.MP = d[D_MP];
  a.PW = d[D_PW];
  a.PT = d[D_PT];
  a.tj = d[D_TJ];
  a.dyn_ipa = d[D_DYN_IPA];
  a.dyn_ports = d[D_DYN_PORTS];
  a.has_nom = d[D_HAS_NOM];
  a.any_f = d[D_ANY_F];
  return a;
}

}  // namespace

// The context's invariants for one template, on `stream`; returns the CUDA
// error of the launch (0 = none). The wrapper (whatif_kernel.py) checks
// shapes and types before calling; the packed-input pointers are unused.
extern "C" int whatif_context_launch(void* const* p, const int* d,
                                     void* stream) {
  Args a = make_args(p, d);
  long long work = (long long)a.C * a.VNP;
  const long long lanes = (long long)a.N * (a.TAA > a.TA ? a.TAA : a.TA);
  if (lanes > work) work = lanes;
  if (a.N > work) work = a.N;
  if (work == 0) return 0;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 1056) blocks = 1056;  // 8 a multiprocessor; the loops stride
  whatif_context_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The PTS minimum structure of one preemptor's claimed-drained shared
// counts on `stream` (launched only where a spread constraint is valid);
// returns the CUDA error of the launch (0 = none).
extern "C" int whatif_mins_launch(void* const* p, const int* d,
                                  void* stream) {
  Args a = make_args(p, d);
  if (a.C == 0) return 0;
  whatif_mins_kernel<<<a.C, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// One preemptor's walk on `stream`, after whatif_mins_launch where a spread
// constraint is valid; returns the CUDA error of the launch (0 = none).
extern "C" int whatif_launch(void* const* p, const int* d, void* stream) {
  Args a = make_args(p, d);
  if (a.N == 0) return 0;
  return (int)launch_walk(a, d[D_KW], (cudaStream_t)stream);
}
