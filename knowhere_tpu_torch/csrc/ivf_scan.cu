// IVF task-scan kernels for Hopper (sm_90a).
//
// ivf_int8_scan replaces knowhere_tpu/ops/ivf_pallas.py _int8_kernel
// (pallas_int8_tasks); ivf_f32_scan replaces _scan_kernel (pallas_scan_tasks).
//
// One thread block per task. A task is one aligned 512-row list block
// (blk[t]) scanned by one group of Qg pre-gathered queries; the block reads
// its own blk[t] and nrows[t] (the TPU scalar-prefetched them). Each warp
// takes one query row at a time (two for the f32 scan), lane l owning the 16
// columns l + 32 j, and finishes the row with the warp top-kk of
// topk_common.cuh, so the (Qg, 512) score block never leaves registers.
//
// What bounds them on the H100: per task the int8 scan reads 64 KB of codes
// once and does Qg * 512 * d / 4 dp4a; the f32 scan does Qg * 512 * d FMAs.
// Neither uses the tensor cores yet, so both are bound by issue rate of
// dp4a/FFMA and by shared-memory loads (one shared load per dp4a/FMA pair),
// not by device memory. The design keeps every score in registers and reads
// the code block once per task (int8) to stay off device memory; moving the
// dots onto wgmma is left for a later change.

#include <cuda_bf16.h>

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
// f32: q (Qg, d) . rows (B, d), in-kernel |x|^2 from the f32 rows, score
// 2*dot - |x|^2 (L2) or dot (IP). The 512 x d f32 block (256 KB at d=128)
// does not fit shared memory, so it streams through in 32-row chunks (chunk
// j is column j of every lane); a pass covers 16 query rows, two per warp,
// and the block is re-read once per pass (from L2 after the first).
//
// kBf16 (three_pass=False on the TPU): q and x are rounded to bf16
// (__float2bfloat16_rn) and multiplied and summed in f32, which is what the
// TPU's single bf16 pass computes. three_pass=True runs full f32 FFMA: at
// least as accurate as the TPU's hi*hi + hi*lo + lo*hi split, which drops
// the lo*lo term.
// ---------------------------------------------------------------------------
constexpr int kRowsPerWarp = 2;
constexpr int kPassRows = kWarps * kRowsPerWarp;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16, bool kL2, bool kMask>
__global__ void __launch_bounds__(kThreads)
    ivf_f32_scan_kernel(const int* __restrict__ blk, const int* __restrict__ nrows,
                        const float* __restrict__ q, const float* __restrict__ data,
                        const uint8_t* __restrict__ keep, float* __restrict__ out_s,
                        int* __restrict__ out_p, int Qg, int d, int kk) {
  extern __shared__ float smem_f[];
  const int stride = d + 1;
  float* xs = smem_f;               // 32 rows * stride
  float* qs = smem_f + 32 * stride;  // kPassRows * d
  const int t = blockIdx.x;
  const int b = blk[t];
  const int n = nrows[t];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool ok[kNJ];
  float nr[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int c = lane + 32 * j;
    ok[j] = c < n && (!kMask || keep[(size_t)b * kB + c] != 0);
    nr[j] = 0.f;
  }
  const float* gdata = data + (size_t)b * kB * d;
  const float* gq = q + (size_t)t * Qg * d;
  for (int r0 = 0; r0 < Qg; r0 += kPassRows) {
    __syncthreads();
    for (int i = threadIdx.x; i < kPassRows * d; i += kThreads) {
      const int rr = r0 + i / d;
      const float v = rr < Qg ? gq[(size_t)r0 * d + i] : 0.f;
      qs[i] = kBf16 ? bf16_round(v) : v;
    }
    const float* q0 = qs + (warp * kRowsPerWarp) * d;
    const float* q1 = q0 + d;
    float acc0[kNJ], acc1[kNJ];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      __syncthreads();
      for (int i = threadIdx.x; i < 32 * d; i += kThreads) {
        const int rr = i / d;
        xs[rr * stride + (i - rr * d)] = gdata[(size_t)(32 * j) * d + i];
      }
      __syncthreads();
      const float* xr = xs + lane * stride;
      if (kL2 && r0 == 0) {
        float s = 0.f;
        for (int k = 0; k < d; ++k) s = fmaf(xr[k], xr[k], s);
        nr[j] = s;
      }
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int k = 0; k < d; ++k) {
        const float x = kBf16 ? bf16_round(xr[k]) : xr[k];
        a0 = fmaf(q0[k], x, a0);
        a1 = fmaf(q1[k], x, a1);
      }
      acc0[j] = a0;
      acc1[j] = a1;
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int row = r0 + warp * kRowsPerWarp + rr;
      if (row >= Qg) break;  // warp-uniform
      float sc[kNJ];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float dot = rr == 0 ? acc0[j] : acc1[j];
        const float v = kL2 ? __fsub_rn(__fmul_rn(2.f, dot), nr[j]) : dot;
        sc[j] = ok[j] ? v : KW_NEG_INF;
      }
      const size_t o = ((size_t)t * Qg + row) * kk;
      warp_topk_row<kNJ>(sc, kk, b * kB, out_s + o, out_p + o);
    }
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

#define KW_F32_CASE(BF, L2, M)                                                                \
  if (bf16 == (BF) && (is_l2 != 0) == (L2) && has_mask == (M)) {                                           \
    auto k = ivf_f32_scan_kernel<BF, L2, M>;                                                  \
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);      \
    if (e != cudaSuccess) return (int)e;                                                      \
    k<<<T, kThreads, smem, s>>>((const int*)blk, (const int*)nrows, (const float*)q,          \
                                (const float*)data, (const uint8_t*)keep, (float*)out_s,      \
                                (int*)out_p, Qg, d, kk);                                      \
    return (int)cudaGetLastError();                                                           \
  }

extern "C" int kw_ivf_f32_scan(const void* blk, const void* nrows, const void* q,
                               const void* data, const void* keep, void* out_s, void* out_p,
                               int T, int Qg, int d, int kk, int is_l2, int three_pass,
                               void* stream) {
  if (T <= 0) return 0;
  if (kk < 1 || kk > kB) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)32 * (d + 1) + (size_t)kPassRows * d) * sizeof(float);
  const bool has_mask = keep != nullptr;
  const bool bf16 = three_pass == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  KW_F32_CASE(false, false, false) KW_F32_CASE(false, false, true)
  KW_F32_CASE(false, true, false) KW_F32_CASE(false, true, true)
  KW_F32_CASE(true, false, false) KW_F32_CASE(true, false, true)
  KW_F32_CASE(true, true, false) KW_F32_CASE(true, true, true)
  return (int)cudaErrorInvalidValue;
}
