// IVF RaBitQ task scan for Hopper (sm_90a).
//
// ivf_rbq_scan replaces knowhere_tpu/ops/ivf_pallas.py _rbq_kernel
// (pallas_rbq_tasks): the IVF_RABITQ sign-plane estimator. Per task, with the
// task's rotated centroid c = cents[lid] and each rotated query q:
//     qr  = q - c                                  (f32)
//     dot = sum_j s_j * bf16(qr_j), s_j = +/-1     (f32 sums; full f32 qr
//                                                   for three_pass=True)
//     est = rn * dot / (max(t, 1e-6) * sqrt(d))    (d: the scanned width)
//     score = -(|qr|^2 + rn^2 - 2 est)   (L2, |qr|^2 from the f32 qr)
//           = <q, c> + est               (IP, an f32 dot)
// The TPU multiplied bf16(qr) by +/-1 int8 planes on the MXU. Here the sign
// planes stay packed bits (d/8 bytes a row, 16 B at d=128 against the
// 128 B of the +/-1 int8 rows), and the product is a sum of +/-bf16(qr_j):
// the bit, shifted to the sign position, is xor-ed into qr_j's sign bit.
//
// One thread block per task. The block's 512 rows of packed signs (8 KB at
// d=128) go to shared memory with a row stride of d/32 + 1 words (32 rows,
// one word each, hit 32 banks); each warp stages the qr of its own 4 query
// rows (plus |qr|^2 or <q,c>, warp-reduced) and keeps 4 x 16 sums in
// registers: lane l owns columns l + 32 j. Each row ends in the warp top-kk
// of topk_common.cuh.
//
// What bounds it on the H100: per task it reads 8 KB of signs and 4 KB of
// corrections and does Qg * 512 * d sign-flipped adds (about 2.25
// instructions each) on the CUDA cores, so it is bound by instruction issue,
// not by device memory. A popcount form (bits of a quantized qr) is the
// next step.

#include <cuda_bf16.h>

#include <cmath>

#include "topk_common.cuh"

namespace kw {

constexpr int kRbRows = 4;  // query rows a warp holds at once

__device__ __forceinline__ float rbq_bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16, bool kL2, bool kMask>
__global__ void __launch_bounds__(kThreads)
    ivf_rbq_scan_kernel(const int* __restrict__ blk, const int* __restrict__ nrows,
                        const int* __restrict__ lids, const float* __restrict__ q,
                        const float* __restrict__ cents, const uint32_t* __restrict__ signs,
                        const float* __restrict__ rn, const float* __restrict__ tt,
                        const uint8_t* __restrict__ keep, float* __restrict__ out_s,
                        int* __restrict__ out_p, int Qg, int d, int kk, float sqrt_d) {
  extern __shared__ uint32_t smem_rb[];
  const int dw = d >> 5;  // sign words per row
  const int stride = dw + 1;
  uint32_t* ss = smem_rb;                                  // kB * stride words
  float* cs = reinterpret_cast<float*>(ss + kB * stride);  // d: rotated centroid
  float* qs = cs + d;                                      // kWarps * kRbRows * d
  float* qk = qs + kWarps * kRbRows * d;                   // kWarps * kRbRows
  const int t = blockIdx.x;
  const int b = blk[t];
  const int n = nrows[t];
  const int lid = lids[t];
  const uint32_t* gs = signs + (size_t)b * kB * dw;
  for (int i = threadIdx.x; i < kB * dw; i += kThreads) {
    const int r = i / dw;
    ss[r * stride + (i - r * dw)] = gs[i];
  }
  for (int i = threadIdx.x; i < d; i += kThreads) cs[i] = cents[(size_t)lid * d + i];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool ok[kNJ];
  float rnj[kNJ], den[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int c = lane + 32 * j;
    const size_t g = (size_t)b * kB + c;
    ok[j] = c < n && (!kMask || keep[g] != 0);
    rnj[j] = rn[g];
    den[j] = __fmul_rn(fmaxf(tt[g], 1e-6f), sqrt_d);
  }
  __syncthreads();
  const float* gq = q + (size_t)t * Qg * d;
  float* qw = qs + warp * kRbRows * d;
  float* qkw = qk + warp * kRbRows;
  for (int r0 = warp * kRbRows; r0 < Qg; r0 += kWarps * kRbRows) {
    // stage this warp's rows: qr, and |qr|^2 (L2) or <q, c> (IP)
#pragma unroll
    for (int r = 0; r < kRbRows; ++r) {
      const int row = r0 + r;
      float part = 0.f;
      for (int k = lane; k < d; k += 32) {
        const float qv = row < Qg ? gq[(size_t)row * d + k] : 0.f;
        const float x = __fsub_rn(qv, cs[k]);
        part = kL2 ? fmaf(x, x, part) : fmaf(qv, cs[k], part);
        qw[r * d + k] = kBf16 ? rbq_bf16_round(x) : x;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) qkw[r] = part;
    }
    __syncwarp();
    float acc[kRbRows][kNJ];
#pragma unroll
    for (int r = 0; r < kRbRows; ++r)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[r][j] = 0.f;
    for (int w = 0; w < dw; ++w) {
      uint32_t nw[kNJ];  // inverted: a clear bit (s = -1) becomes the sign bit
#pragma unroll
      for (int j = 0; j < kNJ; ++j) nw[j] = ~ss[(lane + 32 * j) * stride + w];
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        uint32_t qb[kRbRows];
#pragma unroll
        for (int r = 0; r < kRbRows; ++r) qb[r] = __float_as_uint(qw[r * d + 32 * w + bit]);
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const uint32_t m = (nw[j] << (31 - bit)) & 0x80000000u;
#pragma unroll
          for (int r = 0; r < kRbRows; ++r) acc[r][j] += __uint_as_float(qb[r] ^ m);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRbRows; ++r) {
      const int row = r0 + r;
      if (row >= Qg) break;  // warp-uniform
      const float cq = qkw[r];
      float sc[kNJ];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        // the reference's order, no FMA contraction: (rn * dot) / den, then
        // -((|qr|^2 + rn^2) - 2 est) or <q,c> + est
        const float est = __fdiv_rn(__fmul_rn(rnj[j], acc[r][j]), den[j]);
        const float v = kL2 ? -__fsub_rn(__fadd_rn(cq, __fmul_rn(rnj[j], rnj[j])), __fmul_rn(2.f, est))
                            : __fadd_rn(cq, est);
        sc[j] = ok[j] ? v : KW_NEG_INF;
      }
      const size_t o = ((size_t)t * Qg + row) * kk;
      warp_topk_row<kNJ>(sc, kk, b * kB, out_s + o, out_p + o);
    }
    __syncwarp();  // the next rows overwrite qw
  }
}

}  // namespace kw

using namespace kw;

#define KW_RBQ_CASE(BF, L2, M)                                                                 \
  if (bf16 == (BF) && (is_l2 != 0) == (L2) && has_mask == (M)) {                               \
    auto k = ivf_rbq_scan_kernel<BF, L2, M>;                                                   \
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);       \
    if (e != cudaSuccess) return (int)e;                                                       \
    k<<<T, kThreads, smem, s>>>((const int*)blk, (const int*)nrows, (const int*)lids,          \
                                (const float*)q, (const float*)cents, (const uint32_t*)signs,  \
                                (const float*)rn, (const float*)t, (const uint8_t*)keep,       \
                                (float*)out_s, (int*)out_p, Qg, d, kk, sqrt_d);                \
    return (int)cudaGetLastError();                                                            \
  }

extern "C" int kw_ivf_rbq_scan(const void* blk, const void* nrows, const void* lids,
                               const void* q, const void* cents, const void* signs,
                               const void* rn, const void* t, const void* keep, void* out_s,
                               void* out_p, int T, int Qg, int d, int kk, int is_l2,
                               int three_pass, void* stream) {
  if (T <= 0) return 0;
  if (d % 32 != 0 || kk < 1 || kk > kB) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kB * (d / 32 + 1)) * sizeof(uint32_t) +
                      ((size_t)d + (size_t)kWarps * kRbRows * (d + 1)) * sizeof(float);
  // sqrt(d) rounded once to f32, as the reference's f32 * float64-scalar
  const float sqrt_d = (float)sqrt((double)d);
  const bool has_mask = keep != nullptr;
  const bool bf16 = three_pass == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  KW_RBQ_CASE(false, false, false) KW_RBQ_CASE(false, false, true)
  KW_RBQ_CASE(false, true, false) KW_RBQ_CASE(false, true, true)
  KW_RBQ_CASE(true, false, false) KW_RBQ_CASE(true, false, true)
  KW_RBQ_CASE(true, true, false) KW_RBQ_CASE(true, true, true)
  return (int)cudaErrorInvalidValue;
}
