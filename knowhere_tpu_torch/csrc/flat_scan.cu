// Exact FLAT phase 1 and the single-pass fused scan for Hopper (sm_90a):
// replaces knowhere_tpu/ops/pallas_flat.py _phase1_kernel (via _phase1 /
// flat_topk) and knowhere_tpu/ops/pallas_topk.py _fused_kernel (via
// fused_knn_scan / pallas_knn).
//
// FLAT phase 1 ranks 16-row groups of the corpus by their best score
// a*<x,q> - |x|^2 (a=2 for L2, 1 for IP) and keeps the top-k groups per
// query; phase 2 (torch, cuda_flat.py) rescores the rows of those groups.
// The TPU carried a running top-k across a sequential grid in scratch
// memory. Blocks on the H100 run in parallel with no order, so the work is
// two launches:
//   (a) group_max_kernel: each block holds one 128-row corpus tile in shared
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
// The fused scan (the reference's single bf16 pass, a*<bf16(q), bf16(x)> -
// nrm, top-k rows with the lower row id winning ties, -1 for slots <=
// -5e37) is three launches on the same pieces. The top-k rows of a query
// lie in its top-k groups: a row outside them is beaten by the best row of
// each of k groups, by score or, at equal scores, by a lower row id (a
// lower group holds lower ids). So:
//   (a') group_max_kernel's single-pass instance: only the hi.hi product,
//       on hi-only images (half the tiles: cuda_flat.query_operand_hi for
//       the queries, the threads round the f32 corpus tile to bf16 on its way
//       from device memory to the operand tile, no staging tile). That
//       frees enough shared memory for two blocks an SM, so one block's
//       corpus load overlaps the other's products;
//   (b') flat_select at kg = min(k, groups);
//   (c') fused_rescore_kernel: one block per query sorts its kg group ids,
//       scores their 16 rows each (f32 rows rounded to bf16, exact products
//       summed in f32, one warp a row), selects the top-k by (score, lower
//       row id) as (b) does, and writes -1 ids for slots <= -5e37 and
//       (-1e38, -1) past the kg * 16 candidates.
//
// What bounds it on the H100: (a) does 3 x 2 nq nb d bf16 operations (0.80
// ms at 989 TFLOP/s for 1,024 queries over 1M x 128) and reads the corpus
// once (0.15 ms of bytes), so it is bound by the tensor cores; the query
// tiles are re-read from L2 by every block. (a') does a third of those
// operations (0.27 ms) against the same bytes. Features beyond the first
// 128 (d > 128) are streamed as further chunks, the corpus chunk then
// re-read and re-split per query tile (FLAT: the queries held in one
// stage). (b) reads the group maxima twice (six times on the radix path)
// and is bound by device memory; so is (c'), which reads kg * 16 rows a
// query. Writing the group maxima and reading them back is this design's
// own byte floor above the function's (0.23 ms at 1,024 x 1M); a per-query
// threshold inside (a')'s epilogue would keep them on chip.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "wgmma_common.cuh"

namespace kw {

constexpr int kTileRows = 128;  // corpus rows per block: two warpgroups of 64
constexpr int kTileQ = 128;     // queries per tile (wgmma N)
constexpr int kGroup = 16;
constexpr float kNegInf = -1e38f;  // empty slots (the reference's NEG_INF)
constexpr int kGroupsPerTile = kTileRows / kGroup;
constexpr uint32_t kOpBytes = kTileRows * 2 * kChunk * 2;  // one hi/lo chunk image: 64 KB
constexpr uint32_t kHiOpBytes = kOpBytes / 2;              // one hi-only chunk image: 32 KB
constexpr int kHalfRows = kTileRows / 2;                   // corpus rows a cp.async group
// FLAT's f32 staging tile (kTileRows rows of kStageStride floats) lies over
// the second query stage and the group maxima's buffer just past it
constexpr uint32_t kStageBytes = kTileRows * kStageStride * 4;
constexpr uint32_t kGbufBytes = kTileQ * kGroupsPerTile * 4;
static_assert(2 * kOpBytes + kStageBytes <= 3 * kOpBytes + kGbufBytes, "staging overruns the buffers");
constexpr size_t kFlatSmem = 3 * (size_t)kOpBytes + kGbufBytes + 2 * 8;
// both instances ring two query stages; the single pass's smaller tiles fit
// two blocks an SM (FLAT's one)
constexpr int kStages = 2;
constexpr size_t kFusedSmem = (1 + kStages) * (size_t)kHiOpBytes + kGbufBytes + kStages * 8;

__device__ __forceinline__ float flat_score(float a, float dot, float nr) {
  return __fsub_rn(__fmul_rn(a, dot), nr);  // a*dot - |x|^2, no FMA contraction
}

// base (nb_pad, d) f32; q_op: (nq_pad/128, kc_n) chunk images of the
// queries (hi/lo with kThree, hi-only without); gmax (nq_pad, n_groups).
template <bool kThree>
__global__ void __launch_bounds__(256, kThree ? 1 : 2)
    group_max_kernel(const float* __restrict__ base, const float* __restrict__ nrm,
                     const __nv_bfloat16* __restrict__ q_op, float* __restrict__ gmax, int kc_n, int n_qt,
                     int n_groups, float a) {
  constexpr uint32_t kOp = kThree ? kOpBytes : kHiOpBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sA = smem;         // the corpus chunk's operand image
  unsigned char* sB0 = smem + kOp;  // query stages: sB0 + st * kOp
  float* xst = reinterpret_cast<float*>(smem + 2 * kOp);                    // FLAT's f32 staging, over stage 1
  float* gbuf = reinterpret_cast<float*>(smem + (1 + kStages) * kOp);       // [kTileQ][8] group maxima
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (1 + kStages) * kOp + kGbufBytes);  // one a stage
  const int tid = threadIdx.x;
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const size_t tile = blockIdx.x;
  const int d = kc_n * kChunk;
  const int steps = n_qt * kc_n;  // step s: query tile s / kc_n, feature chunk s % kc_n
  // One chunk (d = 128): the corpus tile is loaded once, then the query
  // tiles run through the ring. More chunks: the corpus chunk is loaded
  // every step; FLAT's staging tile then keeps stage 1, so its queries use
  // stage 0, while the single pass (no staging tile) keeps its ring.
  const bool ring = !kThree || kc_n == 1;
  constexpr size_t kOpElems = kOp / 2;
  // corpus chunk kc -> sA
  auto load_a = [&](int kc) {
    __syncthreads();  // sA, the staging tile and gbuf are free
    const float* src = base + tile * kTileRows * d + kc * kChunk;
    if constexpr (kThree) {
      // two cp.async groups of 64 rows, the first split to hi/lo while the
      // second is in flight
      stage_rows<256>(xst, src, d, kHalfRows, kHalfRows, tid);
      stage_rows<256>(xst + kHalfRows * kStageStride, src + (size_t)kHalfRows * d, d, kHalfRows, kHalfRows, tid);
      cp_async_wait_group<1>();
      __syncthreads();
      split_rows<256>(xst, sA, kHalfRows, kTileRows, 0, true, tid);
      cp_async_wait_group<0>();
      __syncthreads();
      split_rows<256>(xst + kHalfRows * kStageStride, sA, kHalfRows, kTileRows, kHalfRows, true, tid);
    } else {
      // thread t rounds row t % 128's slices t / 128 + 2 j (8 features, two
      // float4 each) straight into the image, kRound slices in flight (four
      // spilled at the two blocks' 128 registers)
      constexpr int kRound = 2;
      const int r = tid % kTileRows;
      const float* src_r = src + (size_t)r * d;
#pragma unroll
      for (int h = 0; h < 8; h += kRound) {
        float4 v[2 * kRound];
#pragma unroll
        for (int j = 0; j < kRound; ++j) {
          const float4* p = reinterpret_cast<const float4*>(src_r + 8 * (tid / kTileRows + 2 * (h + j)));
          v[2 * j] = __ldg(p);
          v[2 * j + 1] = __ldg(p + 1);
        }
#pragma unroll
        for (int j = 0; j < kRound; ++j)
          *reinterpret_cast<uint4*>(sA + (tid / kTileRows + 2 * (h + j)) * (kTileRows * 16) + r * 16) =
              hi8(v[2 * j], v[2 * j + 1]);
      }
    }
    fence_async_smem();
    __syncthreads();  // sA is whole and visible to wgmma; the staging tile is free
  };
  auto load_b = [&](int s) {  // q_op chunk image s is (query tile, chunk) of step s
    const int st = ring ? s & 1 : 0;
    mbar_expect_tx(&bars[st], kOp);
    bulk_g2s(sB0 + st * kOp, q_op + (size_t)s * kOpElems, kOp, &bars[st]);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // FLAT's staging tile covers stage 1 until the corpus tile is split; the
  // single pass fills its whole ring at once
  if constexpr (kThree) {
    if (tid == 0) load_b(0);
  } else {
    if (tid == 0)
      for (int s = 0; s < min(kStages, steps); ++s) load_b(s);
  }
  const size_t row0 = tile * kTileRows + 64 * wg + 16 * w + (lane >> 2);
  const float nr0 = nrm[row0], nr1 = nrm[row0 + 8];
  uint32_t ph_b[kStages] = {};
  float acc[kTileQ / 2];
  for (int s = 0; s < steps; ++s) {
    const int kc = s % kc_n;
    const int st = ring ? s & 1 : 0;
    if ((kThree ? !ring : kc_n > 1) || s == 0) load_a(kc);  // the last step's products and group maxima are done
    if (kThree && ring && s == 0 && tid == 0 && steps > 1) load_b(1);  // stage 1 is free of the staging
    mbar_wait(&bars[st], ph_b[st]);
    ph_b[st] ^= 1;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < kTileQ / 2; ++i) acc[i] = 0.f;
    }
    wgmma_fence();
    chunk_product<kTileQ>(acc, smem_u32(sA) + wg * 64 * 16, kTileRows, smem_u32(sB0) + st * kOp, kThree, kThree);
    wgmma_commit();
    wgmma_wait0();
    __syncthreads();  // every warpgroup is done with stage st
    const int next = kThree ? s + 1 + ring : s + kStages;
    if (tid == 0 && next < steps) load_b(next);
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

struct SelScratch {
  unsigned hist[256];
  int cnt[kSelThreads];
  unsigned prefix;
  int need;
  int ngt;
};

// The k largest of the n keys key(i) into s_key / s_idx[0, k), in no order:
// a 4-pass radix select finds the k-th largest key T, then the keys above T
// and the `need` lowest indices i among the keys equal to T are gathered.
template <class Key>
__device__ __forceinline__ void radix_gather(const Key& key, int n, int k, unsigned* s_key, int* s_idx,
                                             SelScratch& x, int tid) {
  unsigned prefix = 0, mask = 0;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    x.hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kSelThreads) {
      const unsigned u = key(i);
      if ((u & mask) == prefix) atomicAdd(&x.hist[(u >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      int c = 0, bin = 255;
      for (; bin > 0; --bin) {
        if (c + (int)x.hist[bin] >= need) break;
        c += (int)x.hist[bin];
      }
      x.prefix = prefix | ((unsigned)bin << shift);
      x.need = need - c;
    }
    __syncthreads();
    prefix = x.prefix;
    need = x.need;
    mask |= 255u << shift;
  }
  const unsigned T = prefix;

  // keys above T (k - need of them), in any order
  if (tid == 0) x.ngt = 0;
  __syncthreads();
  for (int i = tid; i < n; i += kSelThreads) {
    const unsigned u = key(i);
    if (u > T) {
      const int p = atomicAdd(&x.ngt, 1);
      s_key[p] = u;
      s_idx[p] = i;
    }
  }
  // ties at T: the `need` lowest indices, via contiguous ranges + a scan
  const int per = (n + kSelThreads - 1) / kSelThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += key(i) == T;
  x.cnt[tid] = c;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int i = 0; i < kSelThreads; ++i) {
      const int v = x.cnt[i];
      x.cnt[i] = run;
      run += v;
    }
  }
  __syncthreads();
  const int base = k - need;
  int rank = x.cnt[tid];
  for (int i = lo; i < hi && rank < need; ++i) {
    if (key(i) == T) {
      s_key[base + rank] = T;
      s_idx[base + rank] = i;
      ++rank;
    }
  }
}

// s_key / s_idx[0, m) (m <= kMaxK, written by this block) sorted: larger key
// first, then lower index. Syncs first.
__device__ __forceinline__ void sort_gathered(unsigned* s_key, int* s_idx, int m, int tid) {
  int P = 1;
  while (P < m) P <<= 1;
  for (int i = m + tid; i < P; i += kSelThreads) {
    s_key[i] = 0u;  // below every real key
    s_idx[i] = INT_MAX;
  }
  __syncthreads();
  // bitonic sort
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
}

__global__ void __launch_bounds__(kSelThreads)
    flat_select_kernel(const float* __restrict__ gmax, int n, int k, float* __restrict__ out_v,
                       int* __restrict__ out_g) {
  __shared__ unsigned s_key[kMaxK];
  __shared__ int s_idx[kMaxK];
  __shared__ SelScratch x;
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
    if (tid == 0) x.ngt = 0;
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
        const int p = atomicAdd(&x.ngt, 1);
        if (p < kMaxK) {
          s_key[p] = u;
          s_idx[p] = i;
        }
      }
    }
    __syncthreads();
    m = x.ngt;
    gathered = m <= kMaxK;
    __syncthreads();  // every thread has read x.ngt
  }
  if (!gathered) {
    m = k;
    radix_gather([&](int i) { return f2key(g[i]); }, n, k, s_key, s_idx, x, tid);
  }
  sort_gathered(s_key, s_idx, m, tid);
  for (int i = tid; i < k; i += kSelThreads) {
    const float v = key2f(s_key[i]);
    out_v[(size_t)blockIdx.x * k + i] = v;
    out_g[(size_t)blockIdx.x * k + i] = v <= -5e37f ? -1 : s_idx[i];
  }
}

constexpr int kRsWarps = kSelThreads / 32;
constexpr int kRsRows = 4;  // candidate rows a warp scores at once (4 | 16: one group)

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// One block per query: q (nq, d) f32, base (nb_pad, d) f32, nrm (nb_pad,),
// gids (nq, kg) group ids (-1: empty) -> the top-k rows of those groups.
__global__ void __launch_bounds__(kSelThreads)
    fused_rescore_kernel(const float* __restrict__ q, const float* __restrict__ base, const float* __restrict__ nrm,
                         const int* __restrict__ gids, int kg, int d, int k, float a, float* __restrict__ out_s,
                         int* __restrict__ out_i) {
  extern __shared__ __align__(16) float rs_smem[];
  float* qs = rs_smem;      // bf16(q) (d)
  float* sc = rs_smem + d;  // the candidates' scores (kg * 16), in row-id order
  __shared__ unsigned s_key[kMaxK];
  __shared__ int s_idx[kMaxK];
  __shared__ int s_grp[kMaxK];
  __shared__ SelScratch x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qi = blockIdx.x;
  // the groups in increasing id order, empty ones (INT_MAX) last: candidate
  // c = 16 j + r is row r of group s_grp[j], so candidate order is row order
  for (int i = tid; i < kg; i += kSelThreads) {
    const int g = gids[qi * kg + i];
    s_key[i] = 0u;
    s_idx[i] = g < 0 ? INT_MAX : g;
  }
  for (int i = tid; i < d; i += kSelThreads) qs[i] = bf16r(q[qi * d + i]);
  sort_gathered(s_key, s_idx, kg, tid);
  for (int i = tid; i < kg; i += kSelThreads) s_grp[i] = s_idx[i];
  __syncthreads();
  // scores: a warp takes kRsRows consecutive rows of one group, lane l
  // features 4 l + 128 f; exact bf16 products summed in f32
  const int n = kg * kGroup;
  for (int c0 = kRsRows * warp; c0 < n; c0 += kRsRows * kRsWarps) {
    const int g = s_grp[c0 / kGroup];
    const size_t r0 = (size_t)g * kGroup + c0 % kGroup;
    float acc[kRsRows] = {};
    if (g != INT_MAX) {
      for (int f = 4 * lane; f < d; f += 128) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + f);
        float4 xv[kRsRows];
#pragma unroll
        for (int j = 0; j < kRsRows; ++j) xv[j] = __ldg(reinterpret_cast<const float4*>(base + (r0 + j) * d + f));
#pragma unroll
        for (int j = 0; j < kRsRows; ++j) {
          acc[j] = fmaf(bf16r(xv[j].x), qv.x, acc[j]);
          acc[j] = fmaf(bf16r(xv[j].y), qv.y, acc[j]);
          acc[j] = fmaf(bf16r(xv[j].z), qv.z, acc[j]);
          acc[j] = fmaf(bf16r(xv[j].w), qv.w, acc[j]);
        }
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int j = 0; j < kRsRows; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
      if (lane == j) mine = acc[j];
    }
    if (lane < kRsRows) sc[c0 + lane] = g == INT_MAX ? kNegInf : flat_score(a, mine, nrm[r0 + lane]);
  }
  __syncthreads();
  int m = n;  // entries gathered into s_key / s_idx
  if (n <= kMaxK) {
    for (int i = tid; i < n; i += kSelThreads) {
      s_key[i] = f2key(sc[i]);
      s_idx[i] = i;
    }
  } else {
    m = k;
    radix_gather([&](int i) { return f2key(sc[i]); }, n, k, s_key, s_idx, x, tid);
  }
  sort_gathered(s_key, s_idx, m, tid);
  for (int i = tid; i < k; i += kSelThreads) {
    float v = kNegInf;
    int id = -1;
    if (i < m) {
      v = key2f(s_key[i]);
      const int c = s_idx[i];
      if (v > -5e37f) id = s_grp[c / kGroup] * kGroup + c % kGroup;
    }
    out_s[qi * k + i] = v;
    out_i[qi * k + i] = id;
  }
}

template <bool kThree>
int launch_group_max(size_t smem, const void* base, const void* nrm, const void* q_op, void* gmax, int nb_pad,
                     int nq_pad, int d, float a, void* stream) {
  if (nb_pad % kTileRows || nq_pad % kTileQ || d % kChunk || nb_pad <= 0 || nq_pad <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = group_max_kernel<kThree>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<nb_pad / kTileRows, 256, smem, (cudaStream_t)stream>>>(
      (const float*)base, (const float*)nrm, (const __nv_bfloat16*)q_op, (float*)gmax, d / kChunk, nq_pad / kTileQ,
      nb_pad / kGroup, a);
  return (int)cudaGetLastError();
}

}  // namespace kw

using namespace kw;

// base (nb_pad, d) f32, 16-byte aligned; q_op (nq_pad/128, d/128, 32, 128,
// 8) bf16 chunk images (cuda_flat.query_operand); nrm (nb_pad,) f32 (pad
// rows 1e38); nb_pad, nq_pad and d multiples of 128. gmax: (nq_pad,
// nb_pad/16).
extern "C" int kw_flat_group_max(const void* base, const void* nrm, const void* q_op, void* gmax,
                                 int nb_pad, int nq_pad, int d, float a, void* stream) {
  return launch_group_max<true>(kFlatSmem, base, nrm, q_op, gmax, nb_pad, nq_pad, d, a, stream);
}

// As kw_flat_group_max with the single bf16 pass: q_op (nq_pad/128, d/128,
// 16, 128, 8) hi-only images (cuda_flat.query_operand_hi).
extern "C" int kw_fused_group_max(const void* base, const void* nrm, const void* q_op, void* gmax,
                                  int nb_pad, int nq_pad, int d, float a, void* stream) {
  return launch_group_max<false>(kFusedSmem, base, nrm, q_op, gmax, nb_pad, nq_pad, d, a, stream);
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

// q (nq, d) f32, base (nb_pad, d) f32 16-byte aligned, nrm (nb_pad,) f32,
// gids (nq, kg) int32 from flat_select (-1: empty); d a multiple of 128,
// kg <= 1024, k <= 1024. out_s / out_i: (nq, k).
extern "C" int kw_fused_rescore(const void* q, const void* base, const void* nrm, const void* gids, int nq, int kg,
                                int d, int k, float a, void* out_s, void* out_i, void* stream) {
  if (nq <= 0) return 0;
  if (kg < 1 || kg > kMaxK || k < 1 || k > kMaxK || d <= 0 || d % kChunk) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(d + kGroup * kg) * 4;
  cudaError_t e = cudaFuncSetAttribute(fused_rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_rescore_kernel<<<nq, kSelThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)base, (const float*)nrm, (const int*)gids, kg, d, k, a, (float*)out_s,
      (int*)out_i);
  return (int)cudaGetLastError();
}
