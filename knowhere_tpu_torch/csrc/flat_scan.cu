// Exact FLAT phase 1 for Hopper (sm_90a): replaces
// knowhere_tpu/ops/pallas_flat.py _phase1_kernel (via _phase1 / flat_topk).
//
// Phase 1 ranks 16-row groups of the corpus by their best score
// a*<x,q> - |x|^2 (a=2 for L2, 1 for IP) and keeps the top-k groups per
// query; phase 2 (torch, cuda_flat.py) rescores the rows of those groups.
// The TPU carried a running top-k across a sequential grid in scratch
// memory. Blocks on the H100 run in parallel with no order, so the work is
// two launches:
//   (a) flat_group_max: each block takes a 64-query x 64-row tile (query
//       tile x corpus split), computes the scores in f32 (register-tiled,
//       4x4 per thread, operands staged in shared memory), takes the max of
//       each 16-row group with warp shuffles and writes the group maxima.
//   (b) flat_select: one block per query merges every split's group maxima
//       into the top-k: a 4-pass radix select finds the k-th largest value,
//       the larger values and the lowest-id ties at the threshold are
//       gathered, and a bitonic sort in shared memory orders them by value,
//       then by lower group id (the TPU's leftmost rule). Group ids of empty
//       slots (value <= -5e37, i.e. pad groups) are -1.
// Rather than keeping a per-split top-k inside (a), which k up to 1024 and
// 64 queries per block would push out of shared memory, (a) writes all group
// maxima (nq x nb/16 f32, 1/16 of the score matrix) and (b) selects.
//
// What bounds it on the H100: (a) does nq*nb*d FMAs in plain f32 (67 TFLOP/s
// peak without tensor cores) and re-reads the corpus once per 64 queries;
// at 1M x 128 it is FMA-bound. (b) reads the group maxima four times (radix
// passes) and is bound by device memory. Full f32 replaces the TPU's 3-pass
// hi/lo bf16 product; it is at least as accurate. Moving (a) onto wgmma
// (bf16 hi/lo or TF32x3) is left for a later change.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace kw {

constexpr int kTile = 64;  // queries and corpus rows per block tile
constexpr int kK = 32;     // feature chunk staged in shared memory
constexpr int kGroup = 16;

__global__ void __launch_bounds__(256)
    flat_group_max_kernel(const float* __restrict__ base, const float* __restrict__ nrm,
                          const float* __restrict__ q, float* __restrict__ gmax, int d,
                          int n_groups, float a) {
  __shared__ float qs[kK][kTile + 4];
  __shared__ float xs[kK][kTile + 4];
  const int tx = threadIdx.x & 15;  // rows tx + 16 j: row j of group j
  const int ty = threadIdx.x >> 4;  // queries 4 ty .. 4 ty + 3
  const size_t row0 = (size_t)blockIdx.x * kTile;
  const size_t q0 = (size_t)blockIdx.y * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kK) {
    for (int i = threadIdx.x; i < kTile * kK; i += 256) {
      const int r = i / kK, k = i - r * kK;
      qs[k][r] = q[(q0 + r) * d + k0 + k];
      xs[k][r] = base[(row0 + r) * d + k0 + k];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      float qa[4], xb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) xb[j] = xs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qa[i], xb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float nr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) nr[j] = nrm[row0 + tx + 16 * j];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float m = __fsub_rn(__fmul_rn(a, acc[i][j]), nr[j]);
      // the 16 rows of group j sit on lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (tx == 0) gmax[(q0 + ty * 4 + i) * n_groups + blockIdx.x * (kTile / kGroup) + j] = m;
    }
  }
}

__device__ __forceinline__ unsigned f2key(float f) {  // order-preserving
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

constexpr int kSelThreads = 256;
constexpr int kMaxK = 1024;

__global__ void __launch_bounds__(kSelThreads)
    flat_select_kernel(const float* __restrict__ gmax, int n, int k, float* __restrict__ out_v,
                       int* __restrict__ out_g) {
  __shared__ unsigned hist[256];
  __shared__ unsigned s_key[kMaxK];
  __shared__ int s_idx[kMaxK];
  __shared__ int s_cnt[kSelThreads];
  __shared__ unsigned s_prefix;
  __shared__ int s_need;
  __shared__ int s_ngt;
  const float* g = gmax + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;

  // radix select: the k-th largest key T, and how many keys == T to take
  unsigned prefix = 0, mask = 0;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kSelThreads) {
      const unsigned u = f2key(g[i]);
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      int c = 0, bin = 255;
      for (; bin > 0; --bin) {
        if (c + (int)hist[bin] >= need) break;
        c += (int)hist[bin];
      }
      s_prefix = prefix | ((unsigned)bin << shift);
      s_need = need - c;
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    mask |= 255u << shift;
  }
  const unsigned T = prefix;

  // keys above T (k - need of them), in any order
  if (tid == 0) s_ngt = 0;
  __syncthreads();
  for (int i = tid; i < n; i += kSelThreads) {
    const unsigned u = f2key(g[i]);
    if (u > T) {
      const int p = atomicAdd(&s_ngt, 1);
      s_key[p] = u;
      s_idx[p] = i;
    }
  }
  // ties at T: the `need` lowest group ids, via contiguous ranges + a scan
  const int per = (n + kSelThreads - 1) / kSelThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += f2key(g[i]) == T;
  s_cnt[tid] = c;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int i = 0; i < kSelThreads; ++i) {
      const int v = s_cnt[i];
      s_cnt[i] = run;
      run += v;
    }
  }
  __syncthreads();
  const int base = k - need;
  int rank = s_cnt[tid];
  for (int i = lo; i < hi && rank < need; ++i) {
    if (f2key(g[i]) == T) {
      s_key[base + rank] = T;
      s_idx[base + rank] = i;
      ++rank;
    }
  }
  int P = 1;
  while (P < k) P <<= 1;
  for (int i = k + tid; i < P; i += kSelThreads) {
    s_key[i] = 0u;  // below every real key
    s_idx[i] = INT_MAX;
  }
  __syncthreads();
  // bitonic sort: larger key first, then lower group id
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += kSelThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned ka = s_key[i], kb = s_key[j];
          const int ia = s_idx[i], ib = s_idx[j];
          const bool a_first = ka > kb || (ka == kb && ia < ib);
          if (((i & size) == 0) != a_first) {
            s_key[i] = kb;
            s_key[j] = ka;
            s_idx[i] = ib;
            s_idx[j] = ia;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += kSelThreads) {
    const float v = key2f(s_key[i]);
    out_v[(size_t)blockIdx.x * k + i] = v;
    out_g[(size_t)blockIdx.x * k + i] = v <= -5e37f ? -1 : s_idx[i];
  }
}

}  // namespace kw

using namespace kw;

// base (nb_pad, d) f32, nrm (nb_pad,) f32 (pad rows 1e38), q (nq_pad, d) f32;
// nb_pad and nq_pad multiples of 64, d a multiple of 32. gmax: (nq_pad, nb_pad/16).
extern "C" int kw_flat_group_max(const void* base, const void* nrm, const void* q, void* gmax,
                                 int nb_pad, int nq_pad, int d, float a, void* stream) {
  if (nb_pad % kTile || nq_pad % kTile || d % kK || nb_pad <= 0 || nq_pad <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(nb_pad / kTile, nq_pad / kTile);
  flat_group_max_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)base, (const float*)nrm, (const float*)q, (float*)gmax, d, nb_pad / kGroup,
      a);
  return (int)cudaGetLastError();
}

// gmax rows 0..nq-1 (row stride n) -> top-k (value, group id) per row.
extern "C" int kw_flat_select(const void* gmax, int n, int nq, int k, void* out_v, void* out_g,
                              void* stream) {
  if (nq <= 0) return 0;
  if (k < 1 || k > kMaxK || k > n) return (int)cudaErrorInvalidValue;
  flat_select_kernel<<<nq, kSelThreads, 0, (cudaStream_t)stream>>>(
      (const float*)gmax, n, k, (float*)out_v, (int*)out_g);
  return (int)cudaGetLastError();
}
