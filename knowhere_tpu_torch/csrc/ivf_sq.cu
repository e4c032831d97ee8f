// IVF SQ task scan for Hopper (sm_90a).
//
// ivf_sq_scan replaces knowhere_tpu/ops/ivf_pallas.py _sq_kernel
// (pallas_sq_tasks): the IVF_SQ8 (SQ8 and SQ6) scan of u8 codes decoded in the
// scan as the TPU kernel decodes them,
//     x = vmin + ((c + 0.5) * (1/levels)) * vdiff        (f32, no FMA contraction)
// then scored like the f32 scan: 2*dot - |x|^2 (L2) or dot (IP), |x|^2 from
// the f32 decoded rows, the dot from bf16-rounded q and x (three_pass=False,
// the TPU's single bf16 pass) or full f32 (three_pass=True).
//
// One thread block per task (one aligned 512-row list block against one
// query group). The block's 512 x d u8 codes (64 KB at d=128, a quarter of
// the f32 scan's bytes) are read from device memory once, into shared
// memory with a row stride of d/4 + 1 words, so lanes reading one word of 32
// different rows hit 32 banks. Codes are decoded per element in registers
// and never written back as rows. Each warp takes 4 query rows at a time, so
// one decode feeds 4 FMAs; lane l owns the 16 columns l + 32 j, and each row
// ends in the warp top-kk of topk_common.cuh. The L2 norms are one pre-pass
// over the block, two rows per thread, into shared memory.
//
// What bounds it on the H100: per task it reads 64 KB of codes and does
// Qg * 512 * d FMAs plus (Qg / 4) * 512 * d decodes (about 7 instructions
// each) on the CUDA cores, so it is bound by instruction issue, not by
// device memory (the bytes bound is ~20x lower). Moving the dots onto wgmma
// over a bf16 tile decoded once per task is left for a later change.

#include <cuda_bf16.h>

#include "topk_common.cuh"

namespace kw {

constexpr int kSqRows = 4;                  // query rows a warp holds at once
constexpr int kSqPass = kWarps * kSqRows;  // query rows per pass of the block

__device__ __forceinline__ float sq_bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sq_decode(uint32_t c, float inv, float vmin, float vdiff) {
  // (c + 0.5) * inv is exact for levels 64 / 256; then the reference's two
  // roundings in its order: * vdiff, + vmin
  const float tq = __fmul_rn(__fadd_rn((float)c, 0.5f), inv);
  return __fadd_rn(vmin, __fmul_rn(tq, vdiff));
}

template <bool kBf16, bool kL2, bool kMask>
__global__ void __launch_bounds__(kThreads)
    ivf_sq_scan_kernel(const int* __restrict__ blk, const int* __restrict__ nrows,
                       const float* __restrict__ q, const uint8_t* __restrict__ codes,
                       const float* __restrict__ vmin, const float* __restrict__ vdiff,
                       const uint8_t* __restrict__ keep, float* __restrict__ out_s,
                       int* __restrict__ out_p, int Qg, int d, int kk, float inv) {
  extern __shared__ uint32_t smem_sq[];
  const int dw = d >> 2;
  const int stride = dw + 1;
  uint32_t* cs = smem_sq;                                  // kB * stride words
  float* vm = reinterpret_cast<float*>(cs + kB * stride);  // d
  float* vd = vm + d;                                      // d
  float* nrm_s = vd + d;                                   // kB
  float* qs = nrm_s + kB;                                  // kSqPass * d
  const int t = blockIdx.x;
  const int b = blk[t];
  const int n = nrows[t];
  const uint32_t* gcodes = reinterpret_cast<const uint32_t*>(codes + (size_t)b * kB * d);
  for (int i = threadIdx.x; i < kB * dw; i += kThreads) {
    const int r = i / dw;
    cs[r * stride + (i - r * dw)] = gcodes[i];
  }
  for (int i = threadIdx.x; i < d; i += kThreads) {
    vm[i] = vmin[i];
    vd[i] = vdiff[i];
  }
  __syncthreads();
  if (kL2) {
    for (int r = threadIdx.x; r < kB; r += kThreads) {
      const uint32_t* row = cs + r * stride;
      float s = 0.f;
      for (int w = 0; w < dw; ++w) {
        const uint32_t word = row[w];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sq_decode((word >> (8 * e)) & 0xffu, inv, vm[4 * w + e], vd[4 * w + e]);
          s = fmaf(x, x, s);
        }
      }
      nrm_s[r] = s;
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool ok[kNJ];
  float nr[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int c = lane + 32 * j;
    ok[j] = c < n && (!kMask || keep[(size_t)b * kB + c] != 0);
    nr[j] = kL2 ? nrm_s[c] : 0.f;
  }
  const float* gq = q + (size_t)t * Qg * d;
  for (int r0 = 0; r0 < Qg; r0 += kSqPass) {
    __syncthreads();  // the previous pass is done with qs
    for (int i = threadIdx.x; i < kSqPass * d; i += kThreads) {
      const int rr = r0 + i / d;
      const float v = rr < Qg ? gq[(size_t)r0 * d + i] : 0.f;
      qs[i] = kBf16 ? sq_bf16_round(v) : v;
    }
    __syncthreads();
    const float* qw = qs + warp * kSqRows * d;
    float acc[kSqRows][kNJ];
#pragma unroll
    for (int r = 0; r < kSqRows; ++r)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[r][j] = 0.f;
    for (int w = 0; w < dw; ++w) {
      uint32_t words[kNJ];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) words[j] = cs[(lane + 32 * j) * stride + w];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * w + e;
        const float vmk = vm[k], vdk = vd[k];
        float qv[kSqRows];
#pragma unroll
        for (int r = 0; r < kSqRows; ++r) qv[r] = qw[r * d + k];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          float x = sq_decode((words[j] >> (8 * e)) & 0xffu, inv, vmk, vdk);
          if (kBf16) x = sq_bf16_round(x);
#pragma unroll
          for (int r = 0; r < kSqRows; ++r) acc[r][j] = fmaf(qv[r], x, acc[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSqRows; ++r) {
      const int row = r0 + warp * kSqRows + r;
      if (row >= Qg) break;  // warp-uniform
      float sc[kNJ];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        // no FMA contraction: the reference rounds 2 * dot, then subtracts
        const float v = kL2 ? __fsub_rn(__fmul_rn(2.f, acc[r][j]), nr[j]) : acc[r][j];
        sc[j] = ok[j] ? v : KW_NEG_INF;
      }
      const size_t o = ((size_t)t * Qg + row) * kk;
      warp_topk_row<kNJ>(sc, kk, b * kB, out_s + o, out_p + o);
    }
  }
}

}  // namespace kw

using namespace kw;

#define KW_SQ_CASE(BF, L2, M)                                                                 \
  if (bf16 == (BF) && (is_l2 != 0) == (L2) && has_mask == (M)) {                              \
    auto k = ivf_sq_scan_kernel<BF, L2, M>;                                                   \
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);      \
    if (e != cudaSuccess) return (int)e;                                                      \
    k<<<T, kThreads, smem, s>>>((const int*)blk, (const int*)nrows, (const float*)q,          \
                                (const uint8_t*)codes, (const float*)vmin,                    \
                                (const float*)vdiff, (const uint8_t*)keep, (float*)out_s,     \
                                (int*)out_p, Qg, d, kk, inv);                                 \
    return (int)cudaGetLastError();                                                           \
  }

extern "C" int kw_ivf_sq_scan(const void* blk, const void* nrows, const void* q,
                              const void* codes, const void* vmin, const void* vdiff,
                              const void* keep, void* out_s, void* out_p, int T, int Qg, int d,
                              int kk, int levels, int is_l2, int three_pass, void* stream) {
  if (T <= 0) return 0;
  if (d % 4 != 0 || kk < 1 || kk > kB || (levels != 64 && levels != 256))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kB * (d / 4 + 1)) * sizeof(uint32_t) +
                      ((size_t)2 * d + kB + (size_t)kSqPass * d) * sizeof(float);
  const float inv = 1.0f / (float)levels;  // a power of two: exact
  const bool has_mask = keep != nullptr;
  const bool bf16 = three_pass == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  KW_SQ_CASE(false, false, false) KW_SQ_CASE(false, false, true)
  KW_SQ_CASE(false, true, false) KW_SQ_CASE(false, true, true)
  KW_SQ_CASE(true, false, false) KW_SQ_CASE(true, false, true)
  KW_SQ_CASE(true, true, false) KW_SQ_CASE(true, true, true)
  return (int)cudaErrorInvalidValue;
}
