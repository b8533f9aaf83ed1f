// The scan kernel's argument set, shared by the kernel (scan_full.cu) and
// the fixed-launch-cost probe (probes/csrc/probes.cu), which takes the same
// arguments through the same C interface: an array of pointers in ArgPtr
// order and an array of integers in ArgDim order (ops/scan_kernel.py
// ARG_PTRS and scan_full's dims), unpacked into one `Args` that the kernel
// receives as a __grid_constant__ parameter.

#pragma once

#include <stdint.h>

namespace {

// the launcher's pointer and integer arguments, in the wrapper's order
// (ops/scan_kernel.py ARG_PTRS); the IPA pointers are null when UR == 0,
// `forced` is null outside MODE_APPLY, `dnode` / `drows` outside
// MODE_DELTA, which reads only scalars, stat, prow_f, prow_s, the four
// carries and those two
enum ArgPtr { P_META, P_MATCH, P_SCALARS, P_ALLOC, P_STAT, P_ZID,
              P_REGROW_F, P_ZVALID_NODE_S, P_ZVALID_S, P_KONN_F, P_KONN_S,
              P_SHASALL, P_VALID_N, P_PROW_F, P_PROW_S, P_LOGW, P_GMAT,
              P_REQUESTED, P_NZPC, P_CNT_FN, P_CNT_SN, P_OUT, P_WORK,
              P_FORCED,
              P_IPA_STAT, P_ANTI_STATIC, P_ANTI_KONN, P_AFF_STATIC,
              P_PROW_IPA, P_G1, P_WANTI, P_WAFF, P_W3TOT, P_W45, P_GPRES,
              P_UCNT, P_KCNT, P_DNODE, P_DROWS };
enum ArgDim { D_T, D_C, D_NP, D_R, D_SR, D_TCP, D_K, D_CP, D_BP, D_UR,
              D_SMEM, D_MODE, D_MK, D_E, D_RP, D_W0 };

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
  const float* logw;         // [Np + 2]: log(i + 2) in f32
  const float* gmat;         // [ceil8(T), LANE] IPA template interference
  const int* forced;         // [2*Bp]: (lane | -1, ok) per pod (apply)
  // InterPodAffinity term machinery (ur > 0; ScanSession._build_ipa)
  const int* ipa_stat;       // [ceil8(2T), Np]: fail_existing | aff_all_keys
  const int* anti_static;    // [T*8, Np] existing-pod anti counts per term
  const int* anti_konn;      // [T*8, Np] anti term key on node
  const int* aff_static;     // [T*8, Np] existing-pod affinity counts
  const int* prow_ipa;       // [8, Np] pair id per IPA key, -1 = no key
  const float* g1;           // [ceil8(T), UR] D1 gates
  const float* wanti;        // [T*8, UR] D2 gates
  const float* waff;         // [T*8, UR] D3 gates
  const float* w3tot;        // [ceil8(T), UR] D3 totals
  const float* w45;          // [ceil8(T), UR] D4+D5 GCD-scaled weights
  const float* gpres;        // [ceil8(T), UR] D4+D5 presence gates
  int* ucnt;                 // carry [UR, Np]
  int* kcnt;                 // carry [UR, LANE] (lanes all equal)
  int* requested;            // carry [Rp, Np]
  int* nzpc;                 // carry [8, Np]: nz cpu, nz mem, pods, allowed
  int* cnt_fn;               // carry [TCp, Np]
  int* cnt_sn;               // carry [TCp, Np]
  int* out;                  // [8, Bp]
  const int* dnode;          // [E] delta events' node lanes (MODE_DELTA)
  const int* drows;          // [E, Rp + 8 + 2*TCp] their payloads: dres |
                             // dnzpc | mf | ms, int32, signed
  int* work;                 // scratch [3 (+ 2*mk), Np]: lane flags, raw
                             // PTS score, raw IPA score with the assumed-pod
                             // terms; with MODE_MULTI then per group pod
                             // its total (-1 where infeasible) and wbl
  int T, C, Np, R, SR, TCp, K, CP, Bp, UR, mk, E, Rp;
  int w[8];                  // balanced image ipa least node_affinity
                             // prefer_avoid pts taint
};

// the Args of one launch from the launcher's two arrays
inline Args unpack_args(void* const* p, const int* d) {
  Args a;
  a.meta = (const int*)p[P_META];
  a.match = (const int8_t*)p[P_MATCH];
  a.scalars = (const int*)p[P_SCALARS];
  a.alloc = (const int*)p[P_ALLOC];
  a.stat = (const int*)p[P_STAT];
  a.zid = (const int*)p[P_ZID];
  a.regrow_f = (const int*)p[P_REGROW_F];
  a.zvalid_node_s = (const int*)p[P_ZVALID_NODE_S];
  a.zvalid_s = (const int*)p[P_ZVALID_S];
  a.konn_f = (const int*)p[P_KONN_F];
  a.konn_s = (const int*)p[P_KONN_S];
  a.shasall = (const int*)p[P_SHASALL];
  a.valid_n = (const int*)p[P_VALID_N];
  a.prow_f = (const int*)p[P_PROW_F];
  a.prow_s = (const int*)p[P_PROW_S];
  a.logw = (const float*)p[P_LOGW];
  a.gmat = (const float*)p[P_GMAT];
  a.forced = (const int*)p[P_FORCED];
  a.ipa_stat = (const int*)p[P_IPA_STAT];
  a.anti_static = (const int*)p[P_ANTI_STATIC];
  a.anti_konn = (const int*)p[P_ANTI_KONN];
  a.aff_static = (const int*)p[P_AFF_STATIC];
  a.prow_ipa = (const int*)p[P_PROW_IPA];
  a.g1 = (const float*)p[P_G1];
  a.wanti = (const float*)p[P_WANTI];
  a.waff = (const float*)p[P_WAFF];
  a.w3tot = (const float*)p[P_W3TOT];
  a.w45 = (const float*)p[P_W45];
  a.gpres = (const float*)p[P_GPRES];
  a.ucnt = (int*)p[P_UCNT];
  a.kcnt = (int*)p[P_KCNT];
  a.requested = (int*)p[P_REQUESTED];
  a.nzpc = (int*)p[P_NZPC];
  a.cnt_fn = (int*)p[P_CNT_FN];
  a.cnt_sn = (int*)p[P_CNT_SN];
  a.out = (int*)p[P_OUT];
  a.work = (int*)p[P_WORK];
  a.dnode = (const int*)p[P_DNODE];
  a.drows = (const int*)p[P_DROWS];
  a.T = d[D_T]; a.C = d[D_C]; a.Np = d[D_NP]; a.R = d[D_R]; a.SR = d[D_SR];
  a.TCp = d[D_TCP]; a.K = d[D_K]; a.CP = d[D_CP]; a.Bp = d[D_BP];
  a.UR = d[D_UR]; a.mk = d[D_MK];
  a.E = d[D_E]; a.Rp = d[D_RP];
  for (int i = 0; i < 8; ++i) a.w[i] = d[D_W0 + i];
  return a;
}

}  // namespace
