// Single-pass flat kNN scan for Hopper (sm_90a): replaces
// knowhere_tpu/ops/pallas_topk.py _fused_kernel (via fused_knn_scan /
// pallas_knn).
//
// Scores are a*<bf16(q), bf16(x)> - nrm (a=2 for L2 with nrm=|x|^2, a=1 for
// IP with nrm=0 on real rows; pad rows carry nrm=1e38): q and the corpus rows
// are rounded to bf16 (round to nearest even), every product is exact in f32
// and the sum is f32 -- the TPU's single MXU pass. The result is the top-k per
// query over every row, the smaller row id winning among equal scores, and a
// slot whose score is <= -1e38/2 gets id -1.
//
// The TPU walked the corpus in one sequential grid and kept the running
// (nq, k) list in scratch memory. Blocks on the H100 run in parallel with no
// order, so the work is two launches:
//   (a) fused_knn_partial: a block takes 64 queries and one contiguous split
//       of the corpus. Per 64-row tile it computes the 64 x 64 scores in f32
//       (register-tiled, 4x4 per thread, operands staged in shared memory)
//       and folds them into one sorted list of k (score, id) per query, held
//       in shared memory (k <= 128) or in the output buffer. Rows arrive in
//       increasing id order, so a row enters only when its score beats the
//       list's k-th score strictly; one warp inserts it (shift by k/32
//       chunks). Each warp owns 8 queries of the block.
//   (b) fused_knn_merge: one warp per query merges the splits' lists, best
//       head first; equal scores go to the smaller id, then the -1 rule.
//
// What bounds it on the H100: (a) does nq*nb*d FMAs on the CUDA cores (67
// TFLOP/s f32 peak) and re-reads the corpus once per 64 queries; the bound
// counted against it is the bf16 tensor-core peak, which a later change can
// reach with wgmma. The list updates cost ~k ln(rows/k) insertions per query
// and split, small next to the products at serving k.

#include <cuda_bf16.h>

#include "topk_common.cuh"

namespace kw {

constexpr int kFTile = 64;  // queries and corpus rows per block tile
constexpr int kFK = 32;     // feature chunk staged in shared memory
constexpr int kFThreads = 256;
constexpr int kFMaxK = 1024;
constexpr int kFSmemK = 128;     // lists live in shared memory up to this k
constexpr int kFMaxSplits = 128;  // the merge warp holds 4 heads a lane

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Insert (v, id) into the sorted list (ls, li) of length k; v beats ls[k-1].
// Every lane of the warp calls it. Entries with a score >= v stay ahead
// (they hold smaller ids); the tail shifts by one, last chunk first.
__device__ __forceinline__ void list_insert(volatile float* ls, volatile int* li, int k, float v, int id) {
  const int lane = threadIdx.x & 31;
  int p = 0;
  for (int c = 0; c < k; c += 32) {
    const int i = c + lane;
    p += __popc(__ballot_sync(0xffffffffu, i < k && ls[i] >= v));
  }
  for (int c = ((k - 2) / 32) * 32; c >= 0; c -= 32) {
    const int i = c + lane;
    const bool mv = i >= p && i < k - 1;
    float s = 0.f;
    int d = 0;
    if (mv) {
      s = ls[i];
      d = li[i];
    }
    __syncwarp();
    if (mv) {
      ls[i + 1] = s;
      li[i + 1] = d;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[p] = v;
    li[p] = id;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kFThreads)
    fused_knn_partial_kernel(const float* __restrict__ base, const float* __restrict__ nrm,
                             const float* __restrict__ q, float* __restrict__ part_s,
                             int* __restrict__ part_i, int nb, int nq_pad, int d, int k,
                             int rows_per_split, float a, int smem_lists) {
  extern __shared__ float f_smem[];
  float(*qs)[kFTile + 4] = reinterpret_cast<float(*)[kFTile + 4]>(f_smem);
  float(*xs)[kFTile + 4] = reinterpret_cast<float(*)[kFTile + 4]>(f_smem + kFK * (kFTile + 4));
  float(*st)[kFTile + 1] = reinterpret_cast<float(*)[kFTile + 1]>(f_smem + 2 * kFK * (kFTile + 4));
  float* thr = f_smem + 2 * kFK * (kFTile + 4) + kFTile * (kFTile + 1);
  float* sl_s = thr + kFTile;
  int* sl_i = reinterpret_cast<int*>(sl_s + kFTile * k);

  const int split = blockIdx.x;
  const size_t q0 = (size_t)blockIdx.y * kFTile;
  const int r_begin = split * rows_per_split;
  const int r_end = min(nb, r_begin + rows_per_split);
  // the block's 64 lists: shared memory, or its slice of the partial output
  float* gl_s = part_s + ((size_t)split * nq_pad + q0) * k;
  int* gl_i = part_i + ((size_t)split * nq_pad + q0) * k;
  float* ls_all = smem_lists ? sl_s : gl_s;
  int* li_all = smem_lists ? sl_i : gl_i;
  for (int i = threadIdx.x; i < kFTile * k; i += kFThreads) {
    ls_all[i] = KW_NEG_INF;
    li_all[i] = -1;
  }
  if (threadIdx.x < kFTile) thr[threadIdx.x] = KW_NEG_INF;
  __syncthreads();

  const int tx = threadIdx.x & 15;  // rows tx + 16 j
  const int ty = threadIdx.x >> 4;  // queries 4 ty .. 4 ty + 3
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row0 = r_begin; row0 < r_end; row0 += kFTile) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kFK) {
      for (int i = threadIdx.x; i < kFTile * kFK; i += kFThreads) {
        const int r = i / kFK, c = i - r * kFK;
        qs[c][r] = bf16r(q[(q0 + r) * d + k0 + c]);
        xs[c][r] = bf16r(base[((size_t)row0 + r) * d + k0 + c]);
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kFK; ++c) {
        float qa[4], xb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qs[c][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) xb[j] = xs[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qa[i], xb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float nr = nrm[row0 + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) st[ty * 4 + i][tx + 16 * j] = __fsub_rn(__fmul_rn(a, acc[i][j]), nr);
    }
    __syncthreads();
    // fold the tile into the lists: warp w owns queries 8 w .. 8 w + 7
    for (int qq = 0; qq < 8; ++qq) {
      const int ql = warp * 8 + qq;
      volatile float* ls = ls_all + (size_t)ql * k;
      volatile int* li = li_all + (size_t)ql * k;
      float t = thr[ql];
      const float v0 = st[ql][lane], v1 = st[ql][lane + 32];
      unsigned long long m = (unsigned long long)__ballot_sync(0xffffffffu, v0 > t) |
                             ((unsigned long long)__ballot_sync(0xffffffffu, v1 > t) << 32);
      while (m) {  // candidates in increasing row order
        const int r = __ffsll((long long)m) - 1;
        m &= m - 1;
        const float v = st[ql][r];
        if (v > t) {
          list_insert(ls, li, k, v, row0 + r);
          t = ls[k - 1];
        }
      }
      if (lane == 0) thr[ql] = t;
    }
    __syncthreads();
  }
  if (smem_lists) {
    for (int i = threadIdx.x; i < kFTile * k; i += kFThreads) {
      gl_s[i] = sl_s[i];
      gl_i[i] = sl_i[i];
    }
  }
}

// a before b: the larger score, then the smaller id
__device__ __forceinline__ bool f_better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__global__ void __launch_bounds__(256)
    fused_knn_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                           int n_splits, int nq, int nq_pad, int k, float* __restrict__ out_s,
                           int* __restrict__ out_i) {
  const int qi = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (qi >= nq) return;
  const int lane = threadIdx.x & 31;
  int head[kFMaxSplits / 32];
#pragma unroll
  for (int j = 0; j < kFMaxSplits / 32; ++j) head[j] = 0;
  for (int r = 0; r < k; ++r) {
    float bs = __int_as_float(0xff800000);  // -inf
    int bi = INT_MAX, bj = -1;
#pragma unroll
    for (int j = 0; j < kFMaxSplits / 32; ++j) {
      const int s = lane + 32 * j;
      if (s < n_splits && head[j] < k) {
        const size_t o = ((size_t)s * nq_pad + qi) * k + head[j];
        const float v = part_s[o];
        const int id = part_i[o];
        if (bj < 0 || f_better(v, id, bs, bi)) {
          bs = v;
          bi = id;
          bj = j;
        }
      }
    }
    int bl = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
      if (f_better(os, oi, bs, bi) || (os == bs && oi == bi && ol < bl)) {
        bs = os;
        bi = oi;
        bl = ol;
      }
    }
    if (lane == bl && bj >= 0) {
#pragma unroll
      for (int j = 0; j < kFMaxSplits / 32; ++j)
        if (j == bj) ++head[j];
    }
    if (lane == 0) {
      out_s[(size_t)qi * k + r] = bs;
      out_i[(size_t)qi * k + r] = bs <= KW_NEG_INF * 0.5f ? -1 : bi;
    }
  }
}

}  // namespace kw

using namespace kw;

// Shared memory of one partial block: qs, xs, the score tile, thresholds and
// (for k <= kFSmemK) the 64 lists.
static size_t fused_smem(int k, int smem_lists) {
  size_t f = 2 * kFK * (kFTile + 4) + kFTile * (kFTile + 1) + kFTile;
  if (smem_lists) f += 2 * (size_t)kFTile * k;
  return f * 4;
}

// base (nb, d) f32 with nb % 64 == 0, nrm (nb,) f32 (pad rows 1e38), q
// (nq_pad, d) f32 with nq_pad % 64 == 0, d % 32 == 0, 1 <= k <= 1024;
// part_s / part_i: (n_splits, nq_pad, k) scratch; out: (nq, k).
extern "C" int kw_fused_knn(const void* base, const void* nrm, const void* q, void* part_s, void* part_i,
                            void* out_s, void* out_i, int nb, int nq, int nq_pad, int d, int k,
                            int rows_per_split, int n_splits, float a, void* stream) {
  if (nb <= 0 || nb % kFTile || nq_pad % kFTile || nq > nq_pad || d <= 0 || d % kFK || k < 1 ||
      k > kFMaxK || rows_per_split % kFTile || n_splits < 1 || n_splits > kFMaxSplits ||
      (size_t)rows_per_split * n_splits < (size_t)nb)
    return (int)cudaErrorInvalidValue;
  if (nq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem_lists = k <= kFSmemK;
  const size_t smem = fused_smem(k, smem_lists);
  cudaError_t e = cudaFuncSetAttribute(fused_knn_partial_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_splits, nq_pad / kFTile);
  fused_knn_partial_kernel<<<grid, kFThreads, smem, s>>>(
      (const float*)base, (const float*)nrm, (const float*)q, (float*)part_s, (int*)part_i, nb, nq_pad,
      d, k, rows_per_split, a, smem_lists);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fused_knn_merge_kernel<<<(nq + 7) / 8, 256, 0, s>>>((const float*)part_s, (const int*)part_i, n_splits,
                                                       nq, nq_pad, k, (float*)out_s, (int*)out_i);
  return (int)cudaGetLastError();
}
