// Hopper probes: the counterparts of the TPU probe kernels in scripts/.
// Each answers, on the card, the question its TPU probe asked of the TPU
// runtime; each has a plain PyTorch version beside its wrapper in
// kubernetes_tpu_torch/probes/, and the two agree bit for bit.
//
//   probe_scan      scripts/probe_pallas.py:19-61 (`run`): a sequential scan
//                   with a scratch carry. The TPU ran it as a sequential grid
//                   of B steps over a VMEM scratch row; here ONE block of
//                   1024 threads loops over the B steps with `util` in shared
//                   memory. Each step: fits = util + req <= alloc, score =
//                   fits ? alloc - util : -1, the first-max argmax, util[best]
//                   += req, out[b, :128] = best. What bounds it: the chain of
//                   dependent steps (one block-wide argmax each), as in the
//                   scan kernel, whose per-pod cost it strips to the minimum.
//   probe_int64     scripts/probe_pallas.py:64-77: int64 inside a kernel,
//                   o = a * 2 + 1.
//   probe_layouts   scripts/probe_pallas2.py:12-74 (`try_kernel`, bodies k1,
//                   k2, k3): the scratch init and a row write, then the
//                   argmax, then the one-hot update, over B sequential steps.
//   fixed_cost      scripts/probe_fixed_cost.py:17-70: a trivial body behind
//                   the scan kernel's own argument set and C interface, so
//                   its launch time is the fixed cost of one scan launch.
//
// f32 arithmetic goes through __fadd_rn / __fsub_rn (the file is also built
// with -fmad=false), so the results equal the plain versions exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_args.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int OUT_LANES = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long NO_KEY = -(1LL << 62);

// f32 -> int32 with the order of the floats (no NaN here)
__device__ __forceinline__ int ordered(float v) {
  const int bits = __float_as_int(v);
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

// argmax key: the larger score first, then the smaller lane
__device__ __forceinline__ long long argmax_key(float score, int n) {
  return (long long)ordered(score) * 4294967296LL
      + (long long)(0x7fffffff - n);
}

__device__ __forceinline__ long long warp_max64(long long x) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(FULL, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// the lane of the block-wide maximum key; `red` holds WARPS keys and is
// not written again until every thread has passed the next barrier
__device__ __forceinline__ int block_argmax(long long key, long long* red) {
  const int tid = threadIdx.x;
  key = warp_max64(key);
  if ((tid & 31) == 0) red[tid >> 5] = key;
  __syncthreads();
  long long best = red[0];
  for (int w = 1; w < WARPS; ++w) best = red[w] > best ? red[w] : best;
  return 0x7fffffff - (int)(best & 0xffffffffLL);
}

// probe_scan: req [B], alloc [N], out [B, 128]; util [N] in dynamic shared
// memory; lane n belongs to thread n % 1024, so only the argmax needs the
// block. The reduction buffer alternates between two halves, one barrier a
// step.
__global__ void __launch_bounds__(THREADS, 1)
scan_probe(const float* req, const float* alloc, int* out, int B, int N) {
  extern __shared__ float util[];
  __shared__ long long red[2][WARPS];
  const int tid = threadIdx.x;
  for (int n = tid; n < N; n += THREADS) util[n] = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float r = req[b];
    long long key = NO_KEY;
    for (int n = tid; n < N; n += THREADS) {
      const float u = util[n], al = alloc[n];
      const bool fits = __fadd_rn(u, r) <= al;
      const float score = fits ? __fsub_rn(al, u) : -1.0f;
      const long long k = argmax_key(score, n);
      key = k > key ? k : key;
    }
    const int best = block_argmax(key, red[b & 1]);
    if (best % THREADS == tid) util[best] = __fadd_rn(util[best], r);
    if (tid < OUT_LANES) out[b * OUT_LANES + tid] = best;
  }
}

__global__ void int64_probe(const long long* a, long long* o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = a[i] * 2 + 1;
}

// probe_layouts: req [B, 128], alloc [N], out [B, 128] f32; K = 1 (k1),
// 2 (k2) or 3 (k3) of scripts/probe_pallas2.py
template <int K>
__global__ void __launch_bounds__(THREADS, 1)
layouts_probe(const float* req, const float* alloc, float* out, int B,
              int N) {
  extern __shared__ float util[];
  __shared__ long long red[2][WARPS];
  const int tid = threadIdx.x;
  for (int n = tid; n < N; n += THREADS) util[n] = 0.0f;
  __syncthreads();  // k1 reads util[0], thread 0's lane
  for (int b = 0; b < B; ++b) {
    if (K == 1) {
      if (tid < OUT_LANES)
        out[b * OUT_LANES + tid] = __fadd_rn(req[b * OUT_LANES + tid],
                                             util[0]);
      continue;
    }
    long long key = NO_KEY;
    for (int n = tid; n < N; n += THREADS) {
      const long long k = argmax_key(__fsub_rn(alloc[n], util[n]), n);
      key = k > key ? k : key;
    }
    const int best = block_argmax(key, red[b & 1]);
    if (K == 3 && best % THREADS == tid)
      util[best] = __fadd_rn(util[best], req[b * OUT_LANES]);
    if (tid < OUT_LANES) out[b * OUT_LANES + tid] = (float)best;
  }
}

// fixed_cost: the scan kernel's parameter block and launch shape (one block
// of 1024 threads, the same dynamic shared memory), a trivial body: out
// [8, Bp] = -1, then B_real (meta[0]) increments. The TPU probe also copied
// the four carries through input/output aliases; the CUDA carries are
// updated in place, so there is nothing to copy and none is touched.
__global__ void __launch_bounds__(THREADS, 1)
fixed_cost_probe(const __grid_constant__ Args a) {
  const int breal = a.meta[0];
  for (int i = threadIdx.x; i < 8 * a.Bp; i += THREADS) {
    int v = -1;
    for (int b = 0; b < breal; ++b) v += 1;
    a.out[i] = v;
  }
}

}  // namespace

// Each launcher returns 0 or a CUDA error (-1 for shapes it does not take).

extern "C" int probe_scan_launch(const float* req, const float* alloc,
                                 int* out, int B, int N, void* stream) {
  if (B < 0 || N <= 0 || N * sizeof(float) > 48 * 1024) return -1;
  scan_probe<<<1, THREADS, N * sizeof(float), (cudaStream_t)stream>>>(
      req, alloc, out, B, N);
  return (int)cudaGetLastError();
}

extern "C" int probe_int64_launch(const long long* a, long long* o, int n,
                                  void* stream) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  int64_probe<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, o, n);
  return (int)cudaGetLastError();
}

extern "C" int probe_layouts_launch(int k, const float* req,
                                    const float* alloc, float* out, int B,
                                    int N, void* stream) {
  if (B < 0 || N <= 0 || N * sizeof(float) > 48 * 1024) return -1;
  const size_t smem = N * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: layouts_probe<1><<<1, THREADS, smem, s>>>(req, alloc, out, B, N);
            break;
    case 2: layouts_probe<2><<<1, THREADS, smem, s>>>(req, alloc, out, B, N);
            break;
    case 3: layouts_probe<3><<<1, THREADS, smem, s>>>(req, alloc, out, B, N);
            break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// p, d: the scan launcher's pointer and integer arrays (scan_args.cuh)
extern "C" int fixed_cost_launch(void* const* p, const int* d, void* stream) {
  if (p[P_META] == nullptr || p[P_OUT] == nullptr || d[D_BP] < 0) return -1;
  const Args a = unpack_args(p, d);
  const size_t smem = (size_t)d[D_SMEM];
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fixed_cost_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fixed_cost_probe<<<1, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
