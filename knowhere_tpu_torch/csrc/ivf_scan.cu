// IVF task-scan kernels for Hopper (sm_90a).
//
// ivf_int8_scan replaces knowhere_tpu/ops/ivf_pallas.py _int8_kernel
// (pallas_int8_tasks); ivf_f32_scan replaces _scan_kernel (pallas_scan_tasks).
//
// A task is one aligned 512-row list block (blk[t]) scanned by one group of
// Qg pre-gathered queries; a block reads its own blk[t] and nrows[t] (the TPU
// scalar-prefetched them).
//
// ivf_int8_scan: one thread block per task. Each warp takes one query row at
// a time, lane l owning the 16 columns l + 32 j, and finishes the row with
// the warp top-kk of topk_common.cuh, so the (Qg, 512) score block never
// leaves registers. Per task it reads 64 KB of codes once and does
// Qg * 512 * d / 4 dp4a on the CUDA cores: it is bound by dp4a issue and
// shared-memory loads, not by device memory.
//
// ivf_f32_scan (below): the products run on the tensor cores (wgmma) as the
// reference's three bf16 passes, one thread block per task and 64 queries.
// Per task it does 3 x 2 Qg * nrows * d bf16 operations and reads the f32
// block once, so it is bound by device memory (the blocks and the gathered
// queries) and by its top-kk epilogue, which replaces the kk warp rounds.
#include <cuda_bf16.h>

#include "topk_common.cuh"
#include "wgmma_common.cuh"

namespace kw {

// ---------------------------------------------------------------------------
// int8: zi (Qg, d) i8 . codes (B, d) i8 -> i32, score 2*sz*dot - nrm (L2) or
// sz*dot (IP). u8 codes (SQ8) are recentred by c ^ 0x80 as in the TPU kernel.
// Shared memory: the task's whole code block (B rows of d bytes, row stride
// padded by one word so lanes reading 32 different rows hit 32 banks) plus
// one query row per warp.
// ---------------------------------------------------------------------------
template <bool kU8, bool kL2, bool kMask>
__global__ void __launch_bounds__(kThreads)
    ivf_int8_scan_kernel(const int* __restrict__ blk, const int* __restrict__ nrows,
                         const int8_t* __restrict__ q, const float* __restrict__ sz,
                         const int8_t* __restrict__ codes, const float* __restrict__ nrm,
                         const uint8_t* __restrict__ keep, float* __restrict__ out_s,
                         int* __restrict__ out_p, int Qg, int d, int kk) {
  extern __shared__ int smem_i[];
  const int dw = d >> 2;
  const int stride = dw + 1;
  int* cs = smem_i;                // kB * stride words
  int* qs = smem_i + kB * stride;  // kWarps * dw words
  const int t = blockIdx.x;
  const int b = blk[t];
  const int n = nrows[t];
  const int* gcodes = reinterpret_cast<const int*>(codes + (size_t)b * kB * d);
  for (int i = threadIdx.x; i < kB * dw; i += kThreads) {
    const int r = i / dw;
    int v = gcodes[i];
    if (kU8) v ^= 0x80808080;  // c - 128 as an i8 bit pattern, per byte
    cs[r * stride + (i - r * dw)] = v;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float nr[kNJ];
  bool ok[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int c = lane + 32 * j;
    const size_t g = (size_t)b * kB + c;
    ok[j] = c < n && (!kMask || keep[g] != 0);
    nr[j] = kL2 ? nrm[g] : 0.f;
  }
  __syncthreads();
  int* qw = qs + warp * dw;
  const int* gq = reinterpret_cast<const int*>(q + (size_t)t * Qg * d);
  for (int r = warp; r < Qg; r += kWarps) {
    for (int w = lane; w < dw; w += 32) qw[w] = gq[r * dw + w];
    __syncwarp();
    int acc[kNJ];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[j] = 0;
    for (int w = 0; w < dw; ++w) {
      const int qv = qw[w];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[j] = __dp4a(cs[(lane + 32 * j) * stride + w], qv, acc[j]);
    }
    __syncwarp();  // the next row overwrites qw
    const float s = sz[(size_t)t * Qg + r];
    const float s2 = __fmul_rn(2.f, s);
    float sc[kNJ];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const float dot = (float)acc[j];
      // no FMA contraction: the reference rounds the product, then subtracts
      const float v = kL2 ? __fsub_rn(__fmul_rn(s2, dot), nr[j]) : __fmul_rn(s, dot);
      sc[j] = ok[j] ? v : KW_NEG_INF;
    }
    const size_t o = ((size_t)t * Qg + r) * kk;
    warp_topk_row<kNJ>(sc, kk, b * kB, out_s + o, out_p + o);
  }
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores: q (Qg, d) . rows (B, d) as the reference's three
// bf16 passes (three_pass) or its single hi.hi pass, in-kernel |x|^2 from the
// f32 rows, score 2*dot - |x|^2 (L2) or dot (IP), then the per-row top-kk.
//
// Orientation: list rows on wgmma's M axis (64 a chunk), the block's query
// rows on N. N then takes a query group exactly (32 or 64 a block; Qg = 128
// runs as two blocks), where M = 64 would pad a 32-query group to twice its
// work. The 512 x d f32 block (256 KB at d=128) does not fit shared memory:
// it streams through in 64-row chunks by cp.async into a staging tile, is
// split into hi/lo bf16 while it moves to the operand tile, and the next
// chunk's copy runs under this chunk's products and selection. Chunks past
// nrows are never read, and an empty task (nrows = 0) writes its sentinels
// before any load. Features beyond the first 128 stream as further chunks.
//
// Epilogue: the accumulators go to a scores tile [query][row] in shared
// memory (over the operand tile, which the products no longer need), and
// P = 128 / N threads own each query row, each keeping a sorted list of its
// best KL >= kk (score, position) pairs in registers. The first chunk fills
// the list with one sorting network; after it a score enters only if it
// beats the list's last entry and is not below another part's list end
// (that part then holds KL >= kk better scores), so few do, and the
// insertion shifts the list branch-free. Positions reach a thread in
// increasing order, so the strict test keeps the leftmost column among equal
// scores. At the end one thread per row merges its P lists (larger score,
// then lower position first) into the row's kk outputs.
// ---------------------------------------------------------------------------
constexpr int kXRows = 64;                     // list rows per chunk (wgmma M)
constexpr int kSStride = kXRows + 1;           // scores tile row stride
constexpr int kStageBytes = kXRows * kStageStride * 4;
constexpr int kXOpBytes = kXRows * 2 * kChunk * 2;  // 32 KB hi/lo operand

// sort M (score, position) pairs in registers: larger score first, then lower
// position (a bitonic network, fully unrolled)
template <int M>
__device__ __forceinline__ void sort_desc(float (&s)[M], int (&p)[M]) {
#pragma unroll
  for (int size = 2; size <= M; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const bool a_first = s[i] > s[j] || (s[i] == s[j] && p[i] < p[j]);
          if (((i & size) == 0) != a_first) {
            const float ts = s[i];
            s[i] = s[j];
            s[j] = ts;
            const int tp = p[i];
            p[i] = p[j];
            p[j] = tp;
          }
        }
      }
    }
  }
}

template <int N>
constexpr size_t f32_scan_smem() {
  return (size_t)kStageBytes + kXOpBytes + N * 2 * kChunk * 2 + 4 * kXRows * 4 + 128 * 4;
}

template <int N, int KL>
__global__ void __launch_bounds__(128)
    ivf_f32_scan_kernel(const int* __restrict__ blk, const int* __restrict__ nrows,
                        const float* __restrict__ q, const float* __restrict__ data,
                        const uint8_t* __restrict__ keep, float* __restrict__ out_s,
                        int* __restrict__ out_p, int Qg, int d, int kk, bool l2, bool three) {
  static_assert(128 % N == 0, "N must divide the block's threads");
  constexpr int P = 128 / N;           // threads per query row in the selection
  constexpr int kCols = kXRows / P;    // columns of a chunk each of them scans
  extern __shared__ __align__(128) unsigned char smem[];
  float* xst = reinterpret_cast<float*>(smem);                   // f32 staging tile
  unsigned char* xop = smem + kStageBytes;                        // x hi/lo operand; then scores, lists
  unsigned char* qop = xop + kXOpBytes;                           // q hi/lo operand (N rows)
  float* nrm_part = reinterpret_cast<float*>(qop + N * 2 * kChunk * 2);  // [2][64]
  float* nrm_s = nrm_part + 2 * kXRows;                           // [64] |x|^2 of the chunk's rows
  float* ok_s = nrm_s + kXRows;                                   // [64] 1 where the row is scored
  float* thr_s = ok_s + kXRows;                                   // [P][N] each list's last score
  float* sc = reinterpret_cast<float*>(xop);                      // [N][kSStride]

  const int t = blockIdx.x;
  const int q0 = blockIdx.y * N;
  const int nq = min(N, Qg - q0);
  const int n = nrows[t];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const size_t o0 = ((size_t)t * Qg + q0) * kk;
  if (n <= 0) {  // empty task: sentinels, no load
    for (int i = tid; i < nq * kk; i += 128) {
      out_s[o0 + i] = KW_NEG_INF;
      out_p[o0 + i] = -1;
    }
    return;
  }
  const int b = blk[t];
  const int kc_n = d / kChunk;
  const int n_chunks = (min(n, kB) + kXRows - 1) / kXRows;
  const float* gx = data + (size_t)b * kB * d;
  const float* gq = q + ((size_t)t * Qg + q0) * d;

  // rows x 128 features of src (row stride d) -> xst by cp.async; rows at or
  // past `valid` are zeros
  auto stage = [&](const float* src, int rows, int valid) { stage_rows<128>(xst, src, d, rows, valid, tid); };
  auto stage_q = [&](int kc) {
    stage(gq + kc * kChunk, N, nq);
    cp_async_wait_all();
    __syncthreads();
    split_rows<128>(xst, qop, N, N, 0, three, tid);
    __syncthreads();  // xst is free again
  };

  float ls[KL];
  int lp[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    ls[j] = KW_NEG_INF;
    lp[j] = -1;
  }
  const int srow = tid % N, spart = tid / N;
  float acc[N / 2];
  if (kc_n == 1) {
    stage_q(0);
    stage(gx, kXRows, kXRows);
  }
  for (int c = 0; c < n_chunks; ++c) {
    for (int kc = 0; kc < kc_n; ++kc) {
      if (kc_n > 1) {
        __syncthreads();  // the last chunk's selection is done with the shared tiles
        stage_q(kc);
        stage(gx + (size_t)c * kXRows * d + kc * kChunk, kXRows, kXRows);
      }
      cp_async_wait_all();
      __syncthreads();  // xst holds chunk (c, kc); the last selection is done with xop
      // each thread's sum of squares over its half row (rows = 64: thread
      // tid holds row tid % 64, half tid / 64)
      const float part = split_rows<128>(xst, xop, kXRows, kXRows, 0, three, tid);
      if (l2) nrm_part[tid] = part;
      fence_async_smem();
      __syncthreads();
      if (kc_n == 1 && c + 1 < n_chunks) stage(gx + (size_t)(c + 1) * kXRows * d, kXRows, kXRows);
      if (tid < kXRows) {
        const int gr = c * kXRows + tid;
        if (l2) nrm_s[tid] = (kc ? nrm_s[tid] : 0.f) + (nrm_part[tid] + nrm_part[tid + kXRows]);
        ok_s[tid] = (gr < n && (keep == nullptr || keep[(size_t)b * kB + gr] != 0)) ? 1.f : 0.f;
      }
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      }
      wgmma_fence();
      chunk_product<N>(acc, smem_u32(xop), kXRows, smem_u32(qop), three);
      wgmma_commit();
      wgmma_wait0();
    }
    __syncthreads();  // every warp is done reading xop; nrm_s / ok_s are written
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int r = 16 * w + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int qn = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      // no FMA contraction: the reference rounds the product, then subtracts
      const float v = l2 ? __fsub_rn(__fmul_rn(2.f, acc[i]), nrm_s[r]) : acc[i];
      sc[qn * kSStride + r] = ok_s[r] != 0.f ? v : KW_NEG_INF;
    }
    __syncthreads();
    const int pos0 = b * kB + c * kXRows + spart * kCols;
    const float* row_sc = sc + srow * kSStride + spart * kCols;
    if (c == 0) {  // the first chunk fills the list by one sort
      float fs[kCols];
      int fp[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        fs[j] = row_sc[j];
        fp[j] = pos0 + j;
      }
      sort_desc<kCols>(fs, fp);
#pragma unroll
      for (int e = 0; e < KL && e < kCols; ++e) {
        ls[e] = fs[e];
        lp[e] = fp[e];
      }
    } else {
      // a score below another part's list end has KL >= kk better scores
      // in that part, so it cannot reach the row's top-kk
      float other = KW_NEG_INF;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (p != spart) other = fmaxf(other, thr_s[p * N + srow]);
      for (int j = 0; j < kCols; ++j) {
        const float v = row_sc[j];
        if (v > ls[KL - 1] && v >= other) {  // strict: an equal score to the left stays ahead
#pragma unroll
          for (int e = KL - 1; e > 0; --e) {
            const bool down = ls[e - 1] < v, here = ls[e] < v;
            lp[e] = down ? lp[e - 1] : (here ? pos0 + j : lp[e]);
            ls[e] = down ? ls[e - 1] : (here ? v : ls[e]);
          }
          if (ls[0] < v) {
            ls[0] = v;
            lp[0] = pos0 + j;
          }
        }
      }
    }
    thr_s[spart * N + srow] = ls[KL - 1];
  }
  // merge the P lists of each row: larger score first, then lower position
  __syncthreads();
  float* lsm = reinterpret_cast<float*>(xop);  // [KL][128]
  int* lpm = reinterpret_cast<int*>(xop + KL * 128 * 4);
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    lsm[j * 128 + tid] = ls[j];
    lpm[j * 128 + tid] = lp[j];
  }
  __syncthreads();
  if (tid >= nq) return;
  int h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) h[p] = 0;
  for (int o = 0; o < kk; ++o) {
    float bs = 0.f;
    int bp = INT_MAX, bi = -1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (h[p] >= KL) continue;
      const float s = lsm[h[p] * 128 + tid + p * N];
      const int ps = lpm[h[p] * 128 + tid + p * N];
      const unsigned psu = (unsigned)ps;  // empty slots (-1) order last among equal scores
      if (bi < 0 || s > bs || (s == bs && psu < (unsigned)bp)) {
        bs = s;
        bp = ps;
        bi = p;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) h[p] += (p == bi);
    out_s[o0 + (size_t)tid * kk + o] = bs;
    out_p[o0 + (size_t)tid * kk + o] = bs <= KW_NEG_INF * 0.5f ? -1 : bp;
  }
}

}  // namespace kw

using namespace kw;

#define KW_INT8_CASE(U8, L2, M)                                                              \
  if ((u8 != 0) == (U8) && (is_l2 != 0) == (L2) && has_mask == (M)) {                                            \
    auto k = ivf_int8_scan_kernel<U8, L2, M>;                                                \
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);     \
    if (e != cudaSuccess) return (int)e;                                                     \
    k<<<T, kThreads, smem, s>>>((const int*)blk, (const int*)nrows, (const int8_t*)q,        \
                                (const float*)sz, (const int8_t*)codes, (const float*)nrm,   \
                                (const uint8_t*)keep, (float*)out_s, (int*)out_p, Qg, d, kk); \
    return (int)cudaGetLastError();                                                          \
  }

extern "C" int kw_ivf_int8_scan(const void* blk, const void* nrows, const void* q,
                                const void* sz, const void* codes, const void* nrm,
                                const void* keep, void* out_s, void* out_p, int T, int Qg,
                                int d, int kk, int is_l2, int u8, void* stream) {
  if (T <= 0) return 0;
  if (d % 4 != 0 || kk < 1 || kk > kB) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kB * (d / 4 + 1) + (size_t)kWarps * (d / 4)) * sizeof(int);
  const bool has_mask = keep != nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  KW_INT8_CASE(false, false, false) KW_INT8_CASE(false, false, true)
  KW_INT8_CASE(false, true, false) KW_INT8_CASE(false, true, true)
  KW_INT8_CASE(true, false, false) KW_INT8_CASE(true, false, true)
  KW_INT8_CASE(true, true, false) KW_INT8_CASE(true, true, true)
  return (int)cudaErrorInvalidValue;
}

template <int N, int KL>
static int launch_f32(const void* blk, const void* nrows, const void* q, const void* data,
                      const void* keep, void* out_s, void* out_p, int T, int Qg, int d, int kk,
                      bool l2, bool three, cudaStream_t s) {
  auto k = ivf_f32_scan_kernel<N, KL>;
  constexpr size_t smem = f32_scan_smem<N>();
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(T, (Qg + N - 1) / N);
  k<<<grid, 128, smem, s>>>((const int*)blk, (const int*)nrows, (const float*)q, (const float*)data,
                           (const uint8_t*)keep, (float*)out_s, (int*)out_p, Qg, d, kk, l2, three);
  return (int)cudaGetLastError();
}

template <int N>
static int launch_f32_kl(const void* blk, const void* nrows, const void* q, const void* data,
                         const void* keep, void* out_s, void* out_p, int T, int Qg, int d, int kk,
                         bool l2, bool three, cudaStream_t s) {
  if (kk <= 8) return launch_f32<N, 8>(blk, nrows, q, data, keep, out_s, out_p, T, Qg, d, kk, l2, three, s);
  if (kk <= 16) return launch_f32<N, 16>(blk, nrows, q, data, keep, out_s, out_p, T, Qg, d, kk, l2, three, s);
  return launch_f32<N, 32>(blk, nrows, q, data, keep, out_s, out_p, T, Qg, d, kk, l2, three, s);
}

// q (T, Qg, d) f32, data (n * 512, d) f32 with d a multiple of 128, kk <= 32.
extern "C" int kw_ivf_f32_scan(const void* blk, const void* nrows, const void* q,
                               const void* data, const void* keep, void* out_s, void* out_p,
                               int T, int Qg, int d, int kk, int is_l2, int three_pass,
                               void* stream) {
  if (T <= 0) return 0;
  if (kk < 1 || kk > 32 || Qg < 1 || d <= 0 || d % kChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (Qg <= 32)
    return launch_f32_kl<32>(blk, nrows, q, data, keep, out_s, out_p, T, Qg, d, kk, is_l2 != 0, three_pass != 0, s);
  return launch_f32_kl<64>(blk, nrows, q, data, keep, out_s, out_p, T, Qg, d, kk, is_l2 != 0, three_pass != 0, s);
}
