// Exact FLAT phase 1 for Hopper (sm_90a): replaces
// knowhere_tpu/ops/pallas_flat.py _phase1_kernel (via _phase1 / flat_topk).
//
// Phase 1 ranks 16-row groups of the corpus by their best score
// a*<x,q> - |x|^2 (a=2 for L2, 1 for IP) and keeps the top-k groups per
// query; phase 2 (torch, cuda_flat.py) rescores the rows of those groups.
// The TPU carried a running top-k across a sequential grid in scratch
// memory. Blocks on the H100 run in parallel with no order, so the work is
// two launches:
//   (a) flat_group_max: each block holds one 128-row corpus tile in shared
//       memory and passes every 128-query tile of the launch over it, so the
//       corpus is read once per launch. The products run on the tensor cores
//       (wgmma, wgmma_common.cuh) as the reference's three bf16 passes
//       (hi.hi + hi.lo + lo.hi, f32 accumulators). Corpus rows sit on wgmma's
//       M axis (the TPU's transposed layout): each warp's accumulator rows
//       are 16 consecutive corpus rows, exactly one group, so a group max is
//       a max over a thread's two rows and three shuffles across lane / 4;
//       no score leaves the registers. The corpus tile is read as f32 (the
//       store's only copy): cp.async stages it over the second query stage
//       in two groups of 64 rows, and the threads split each into the hi/lo
//       bf16 image on its way to the operand tile, the first while the
//       second is in flight; at d = 128 this happens once per launch. The
//       queries, re-read by every block, arrive pre-split (ops/cuda_flat.py
//       query_operand, built once a launch) through bulk (TMA) copies on
//       mbarriers, in a two-stage ring so the next tile's copy overlaps this
//       tile's products. A bf16 copy of the corpus in the store would let a
//       bulk copy replace the staging, for 512 MB more at 1M x 128; PERF.md
//       gives both versions' times.
//   (b) flat_select: one block per query merges every tile's group maxima
//       into the top-k. For k <= 256 a pre-filter pass takes each thread's
//       maximum; the k-th largest of those bounds the k-th largest value
//       from below, and one more pass gathers the values at or above it.
//       Otherwise (or when too many values tie at that bound) a 4-pass radix
//       select finds the k-th largest value, and the larger values and the
//       lowest-id ties at it are gathered. A bitonic sort in shared memory
//       orders the gathered values by value, then by lower group id (the
//       TPU's leftmost rule). Group ids of empty slots (value <= -5e37, i.e.
//       pad groups) are -1.
// Rather than keeping a per-tile top-k inside (a), which k up to 1024 would
// push out of shared memory, (a) writes all group maxima (nq x nb/16 f32,
// 1/16 of the score matrix) and (b) selects.
//
// What bounds it on the H100: (a) does 3 x 2 nq nb d bf16 operations (0.80
// ms at 989 TFLOP/s for 1,024 queries over 1M x 128) and reads the corpus
// once (0.15 ms of bytes), so it is bound by the tensor cores; the query
// tiles are re-read from L2 by every block. Features beyond the first 128
// (d > 128) are streamed as further chunks, the corpus chunk then re-read
// and re-split per query tile (and the queries held in one stage). (b)
// reads the group maxima twice (six times on the radix path) and is bound
// by device memory.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "wgmma_common.cuh"

namespace kw {

constexpr int kTileRows = 128;  // corpus rows per block: two warpgroups of 64
constexpr int kTileQ = 128;     // queries per tile (wgmma N)
constexpr int kGroup = 16;
constexpr int kGroupsPerTile = kTileRows / kGroup;
constexpr uint32_t kOpBytes = kTileRows * 2 * kChunk * 2;  // one hi/lo chunk image: 64 KB
constexpr int kHalfRows = kTileRows / 2;                   // corpus rows a cp.async group
// the f32 staging tile (kTileRows rows of kStageStride floats) lies over the
// second query stage and the group maxima's buffer just past it
constexpr uint32_t kStageBytes = kTileRows * kStageStride * 4;
constexpr uint32_t kGbufBytes = kTileQ * kGroupsPerTile * 4;
static_assert(2 * kOpBytes + kStageBytes <= 3 * kOpBytes + kGbufBytes, "staging overruns the buffers");
constexpr size_t kFlatSmem = 3 * (size_t)kOpBytes + kGbufBytes + 2 * 8;

__device__ __forceinline__ float flat_score(float a, float dot, float nr) {
  return __fsub_rn(__fmul_rn(a, dot), nr);  // a*dot - |x|^2, no FMA contraction
}

// base (nb_pad, d) f32; q_op: (nq_pad/128, kc_n) chunk images of the
// queries; gmax (nq_pad, n_groups).
__global__ void __launch_bounds__(256, 1)
    flat_group_max_kernel(const float* __restrict__ base, const float* __restrict__ nrm,
                          const __nv_bfloat16* __restrict__ q_op, float* __restrict__ gmax, int kc_n,
                          int n_qt, int n_groups, float a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sA = smem;              // the corpus chunk's hi/lo image
  unsigned char* sB0 = smem + kOpBytes;  // query stages: sB0 and sB0 + kOpBytes
  float* xst = reinterpret_cast<float*>(smem + 2 * kOpBytes);  // f32 staging, over stage 1
  float* gbuf = reinterpret_cast<float*>(smem + 3 * kOpBytes);  // [kTileQ][8] group maxima
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 3 * kOpBytes + kGbufBytes);  // B0, B1
  const int tid = threadIdx.x;
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const size_t tile = blockIdx.x;
  const int d = kc_n * kChunk;
  const int steps = n_qt * kc_n;  // step s: query tile s / kc_n, feature chunk s % kc_n
  // One chunk (d = 128): the corpus tile is staged once, then the query
  // tiles run through both stages. More chunks: the corpus chunk is staged
  // every step, so stage 1 stays the staging tile and the queries use stage 0.
  const bool ring = kc_n == 1;
  constexpr size_t kOpElems = kOpBytes / 2;
  // corpus chunk kc -> sA: two cp.async groups of 64 rows, the first split
  // to hi/lo while the second is in flight
  auto load_a = [&](int kc) {
    __syncthreads();  // sA, the staging tile and gbuf are free
    const float* src = base + tile * kTileRows * d + kc * kChunk;
    stage_rows<256>(xst, src, d, kHalfRows, kHalfRows, tid);
    stage_rows<256>(xst + kHalfRows * kStageStride, src + (size_t)kHalfRows * d, d, kHalfRows, kHalfRows, tid);
    cp_async_wait_group<1>();
    __syncthreads();
    split_rows<256>(xst, sA, kHalfRows, kTileRows, 0, true, tid);
    cp_async_wait_group<0>();
    __syncthreads();
    split_rows<256>(xst + kHalfRows * kStageStride, sA, kHalfRows, kTileRows, kHalfRows, true, tid);
    fence_async_smem();
    __syncthreads();  // sA is whole and visible to wgmma; the staging tile is free
  };
  auto load_b = [&](int s) {  // q_op chunk image s is (query tile, chunk) of step s
    const int st = ring ? s & 1 : 0;
    mbar_expect_tx(&bars[st], kOpBytes);
    bulk_g2s(sB0 + st * kOpBytes, q_op + (size_t)s * kOpElems, kOpBytes, &bars[st]);
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) load_b(0);
  const size_t row0 = tile * kTileRows + 64 * wg + 16 * w + (lane >> 2);
  const float nr0 = nrm[row0], nr1 = nrm[row0 + 8];
  uint32_t ph_b[2] = {0, 0};
  float acc[kTileQ / 2];
  for (int s = 0; s < steps; ++s) {
    const int kc = s % kc_n;
    const int st = ring ? s & 1 : 0;
    if (!ring || s == 0) load_a(kc);  // the last step's products and group maxima are done
    if (ring && s == 0 && tid == 0 && steps > 1) load_b(1);  // stage 1 is free of the staging
    mbar_wait(&bars[st], ph_b[st]);
    ph_b[st] ^= 1;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < kTileQ / 2; ++i) acc[i] = 0.f;
    }
    wgmma_fence();
    chunk_product<kTileQ>(acc, smem_u32(sA) + wg * 64 * 16, kTileRows, smem_u32(sB0) + st * kOpBytes, true, true);
    wgmma_commit();
    wgmma_wait0();
    __syncthreads();  // every warpgroup is done with stage st
    if (tid == 0 && s + 1 + ring < steps) load_b(s + 1 + ring);
    if (kc != kc_n - 1) continue;
    // group max: rows lane/4 and lane/4 + 8 of the warp's 16, then across lane/4
#pragma unroll
    for (int c2 = 0; c2 < kTileQ / 8; ++c2) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = 4 * c2 + b;
        float m = fmaxf(flat_score(a, acc[i], nr0), flat_score(a, acc[i + 2], nr1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (lane < 4) gbuf[(8 * c2 + 2 * lane + b) * kGroupsPerTile + 4 * wg + w] = m;
      }
    }
    __syncthreads();
    // 128 queries x 8 groups: one float4 a thread, 32 bytes a query row
    const int qt = s / kc_n;
    const float4 v = reinterpret_cast<const float4*>(gbuf)[tid];
    float* dst = gmax + (size_t)(qt * kTileQ + (tid >> 1)) * n_groups + tile * kGroupsPerTile + 4 * (tid & 1);
    *reinterpret_cast<float4*>(dst) = v;
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

  // Pre-filter (k <= 256): T0, the k-th largest of the threads' own maxima,
  // has at least k keys at or above it, so it bounds the k-th largest key
  // from below. When the keys >= T0 fit in shared memory (a few k on
  // scores), one more pass gathers them and the sort below orders them;
  // the radix passes are skipped. Two reads of the row instead of six.
  __shared__ unsigned s_tmax[kSelThreads];
  __shared__ unsigned s_t0;
  int m = k;  // entries gathered into s_key / s_idx
  bool gathered = false;
  if (k <= kSelThreads) {
    unsigned mx = 0u;
    for (int i = tid; i < n; i += kSelThreads) mx = max(mx, f2key(g[i]));
    s_tmax[tid] = mx;
    if (tid == 0) s_ngt = 0;
    __syncthreads();
    int rank = 0;  // distinct ranks: ties go to the lower thread
    for (int j = 0; j < kSelThreads; ++j) {
      const unsigned o = s_tmax[j];
      rank += o > mx || (o == mx && j < tid);
    }
    if (rank == k - 1) s_t0 = mx;
    __syncthreads();
    const unsigned t0 = s_t0;
    for (int i = tid; i < n; i += kSelThreads) {
      const unsigned u = f2key(g[i]);
      if (u >= t0) {
        const int p = atomicAdd(&s_ngt, 1);
        if (p < kMaxK) {
          s_key[p] = u;
          s_idx[p] = i;
        }
      }
    }
    __syncthreads();
    m = s_ngt;
    gathered = m <= kMaxK;
    __syncthreads();  // every thread has read s_ngt
  }
  if (!gathered) {
    m = k;
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
  }
  int P = 1;
  while (P < m) P <<= 1;
  for (int i = m + tid; i < P; i += kSelThreads) {
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

// base (nb_pad, d) f32, 16-byte aligned; q_op (nq_pad/128, d/128, 32, 128,
// 8) bf16 chunk images (cuda_flat.query_operand); nrm (nb_pad,) f32 (pad
// rows 1e38); nb_pad, nq_pad and d multiples of 128. gmax: (nq_pad,
// nb_pad/16).
extern "C" int kw_flat_group_max(const void* base, const void* nrm, const void* q_op, void* gmax,
                                 int nb_pad, int nq_pad, int d, float a, void* stream) {
  if (nb_pad % kTileRows || nq_pad % kTileQ || d % kChunk || nb_pad <= 0 || nq_pad <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flat_group_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kFlatSmem);
  if (e != cudaSuccess) return (int)e;
  flat_group_max_kernel<<<nb_pad / kTileRows, 256, kFlatSmem, (cudaStream_t)stream>>>(
      (const float*)base, (const float*)nrm, (const __nv_bfloat16*)q_op, (float*)gmax,
      d / kChunk, nq_pad / kTileQ, nb_pad / kGroup, a);
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
