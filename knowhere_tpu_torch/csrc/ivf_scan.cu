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
// ivf_f32_scan (below): the f32 row source of the tensor-core task scan of
// ivf_task_scan.cuh (wgmma, the reference's three bf16 passes or its single
// pass), one thread block per task and 64 queries. Per task it does 3 x 2 Qg
// * nrows * d bf16 operations and reads the f32 block once, so it is bound
// by device memory (the blocks and the gathered queries) and by its top-kk
// epilogue, which replaces the kk warp rounds.
#include <cuda_bf16.h>

#include "ivf_task_scan.cuh"
#include "topk_common.cuh"

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
// f32 on the tensor cores (ivf_task_scan.cuh): q (Qg, d) . rows (B, d) as the
// reference's three bf16 passes (three_pass) or its single hi.hi pass, the
// f32 rows staged by cp.async and split into hi/lo bf16 in the kernel,
// in-kernel |x|^2 from the f32 rows, score 2*dot - |x|^2 (L2) or dot (IP).
// ---------------------------------------------------------------------------
struct F32Rows {
  const float* data;  // (n * 512, d) f32 rows
  static constexpr bool kRowNorm = true, kQuerySide = false;
  __device__ bool a_lo(bool three) const { return three; }
  __device__ void stage(unsigned char* st, int b, int c, int kc, int d, int tid) const {
    stage_rows<128>(reinterpret_cast<float*>(st), data + ((size_t)b * kB + c * kXRows) * d + kc * kChunk, d,
                    kXRows, kXRows, tid);
  }
  __device__ void load_aux(float*, int, int, int, int) const {}
  __device__ float rows_op(const unsigned char* st, unsigned char* xop, const float*, bool three, int tid) const {
    return split_rows<128>(reinterpret_cast<const float*>(st), xop, kXRows, kXRows, 0, three, tid);
  }
  __device__ float query_op(const float* qst, unsigned char* qop, const float*, int n, bool, bool three,
                            int tid) const {
    return split_queries(qst, qop, n, three, tid);
  }
  __device__ void row_side(float*, float*, size_t, int) const {}
  __device__ float score(float acc, float nrm, float, float, bool l2) const { return dot_score(acc, nrm, l2); }
};

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

// q (T, Qg, d) f32, data (n * 512, d) f32 with d a multiple of 128, kk <= 32.
extern "C" int kw_ivf_f32_scan(const void* blk, const void* nrows, const void* q,
                               const void* data, const void* keep, void* out_s, void* out_p,
                               int T, int Qg, int d, int kk, int is_l2, int three_pass,
                               void* stream) {
  return launch_task_scan(F32Rows{(const float*)data}, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, is_l2,
                          three_pass, stream);
}
