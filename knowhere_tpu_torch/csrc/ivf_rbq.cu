// IVF RaBitQ task scan for Hopper (sm_90a).
//
// ivf_rbq_scan replaces knowhere_tpu/ops/ivf_pallas.py _rbq_kernel
// (pallas_rbq_tasks): the IVF_RABITQ sign-plane estimator. Per task, with the
// task's rotated centroid c = cents[lid] and each rotated query q:
//     qr  = q - c                                  (f32)
//     dot = <bf16(qr), s>, s_j = +/-1              (the TPU's single bf16 pass)
//         = <qr_hi, s> + <qr_lo, s>                (three_pass=True: the
//                                                   reference's two passes)
//     est = rn * dot / (max(t, 1e-6) * sqrt(d))    (d: the scanned width)
//     score = -(|qr|^2 + rn^2 - 2 est)   (L2, |qr|^2 from the f32 qr)
//           = <q, c> + est               (IP, an f32 dot)
// The TPU multiplied bf16(qr) by +/-1 int8 planes on the MXU. Here the sign
// planes stay packed bits in device memory (d/8 bytes a row, 16 B at d=128
// against the 128 B of the +/-1 int8 rows, little-endian, a set bit is +1)
// and are expanded in shared memory into the +/-1 bf16 A operand, exact in
// bf16; the products run on wgmma.
//
// It is the RaBitQ row source of the tensor-core task scan
// (ivf_task_scan.cuh): cp.async stages a chunk's sign bits (64 rows x 16
// bytes, 1 KB), qr = q - c is formed in f32 once per task and query block
// while the queries become the B operand (qr_hi, and qr_lo for
// three_pass, which then runs as a second pass into the same accumulator),
// with |qr|^2 or <q, c> summed beside it; rn and den = max(t, 1e-6) sqrt(d)
// come per row from device memory for the epilogue.
//
// What bounds it on the H100: per task it reads 8 KB of signs, 4 KB of
// corrections and the query group (64 KB at Qg=128, d=128) once and does 1
// or 2 x 2 Qg * nrows * d bf16 operations: device memory bounds it (the
// query groups most), and the expansion, the query operand and the
// epilogue set its time above that bound.

#include <cuda_bf16.h>

#include <cmath>

#include "ivf_task_scan.cuh"

namespace kw {

struct RbqRows {
  const uint8_t* signs;  // (n * 512, d / 8) packed sign bits
  const float* rn;       // residual norms, one a stored row
  const float* tt;       // alignment corrections, one a stored row
  const float* cents;    // (nlist, d) rotated centroids
  const int* lids;       // (T,) list of each task
  float sqrt_d;
  using Query = float;
  static constexpr bool kRowNorm = false, kQuerySide = true;
  __device__ bool a_lo(bool) const { return false; }  // +/-1 is exact in bf16
  __device__ void stage(unsigned char* st, int b, int c, int kc, int d, int tid) const {
    if (tid < kXRows) {  // 16 bytes (128 features) of one row each
      const size_t row = (size_t)b * kB + c * kXRows + tid;
      cp_async16(st + tid * 16, signs + row * (d / 8) + kc * (kChunk / 8));
    }
    cp_async_commit();
  }
  // the task's rotated centroid, feature chunk kc
  __device__ void load_aux(float* aux, int t, int kc, int d, int tid) const {
    aux[tid] = cents[(size_t)lids[t] * d + kc * kChunk + tid];
  }
  // thread tid expands half tid / 64 of row tid % 64: 8 bytes, 8 slices
  __device__ float rows_op(const unsigned char* st, unsigned char* xop, const float*, bool, int tid) const {
    const int r = tid % kXRows, h8 = tid / kXRows;
    const uint2 raw = *reinterpret_cast<const uint2*>(st + r * 16 + 8 * h8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bits = ((j < 4 ? raw.x : raw.y) >> (8 * (j & 3))) & 0xffu;
      uint32_t h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // bf16 +1 = 0x3F80, -1 = 0xBF80; feature 2i in the low half
        h[i] = (((bits >> (2 * i)) & 1u) ? 0x3F80u : 0xBF80u) |
               ((((bits >> (2 * i + 1)) & 1u) ? 0x3F80u : 0xBF80u) << 16);
      *reinterpret_cast<uint4*>(xop + (8 * h8 + j) * (kXRows * 16) + r * 16) = make_uint4(h[0], h[1], h[2], h[3]);
    }
    return 0.f;
  }
  // qr = q - c -> qr_hi (and qr_lo where three); the part of |qr|^2 (L2) or
  // <q, c> (IP) over the values this thread took
  __device__ float query_op(const float* qst, unsigned char* qop, const float* aux, int n, bool l2, bool three,
                            int tid) const {
    float part = 0.f;
    for (int u = tid; u < n * kSlices; u += 128) {
      const int r = u % n, g = u / n;
      const float4 q0 = *reinterpret_cast<const float4*>(qst + r * kStageStride + 8 * g);
      const float4 q1 = *reinterpret_cast<const float4*>(qst + r * kStageStride + 8 * g + 4);
      const float4 c0 = *reinterpret_cast<const float4*>(aux + 8 * g);
      const float4 c1 = *reinterpret_cast<const float4*>(aux + 8 * g + 4);
      const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = __fsub_rn(qv[e], cv[e]);
        part = l2 ? fmaf(x[e], x[e], part) : fmaf(qv[e], cv[e], part);
      }
      uint4 hi, lo;
      split8(make_float4(x[0], x[1], x[2], x[3]), make_float4(x[4], x[5], x[6], x[7]), hi, lo);
      *reinterpret_cast<uint4*>(qop + g * (n * 16) + r * 16) = hi;
      if (three) *reinterpret_cast<uint4*>(qop + (kSlices + g) * (n * 16) + r * 16) = lo;
    }
    return part;
  }
  __device__ void row_side(float* rs0, float* rs1, size_t g, int r) const {
    rs0[r] = rn[g];
    rs1[r] = __fmul_rn(fmaxf(tt[g], 1e-6f), sqrt_d);
  }
  // the reference's order, no FMA contraction: (rn * dot) / den, then
  // -((|qr|^2 + rn^2) - 2 est) or <q,c> + est
  __device__ float score(float acc, float rnv, float den, float cq, bool l2) const {
    const float est = __fdiv_rn(__fmul_rn(rnv, acc), den);
    return l2 ? -__fsub_rn(__fadd_rn(cq, __fmul_rn(rnv, rnv)), __fmul_rn(2.f, est)) : __fadd_rn(cq, est);
  }
};

}  // namespace kw

using namespace kw;

// q (T, Qg, d) f32 rotated queries, signs (n * 512, d / 8) u8 with d a
// multiple of 128, kk <= 32.
extern "C" int kw_ivf_rbq_scan(const void* blk, const void* nrows, const void* lids,
                               const void* q, const void* cents, const void* signs,
                               const void* rn, const void* t, const void* keep, void* out_s,
                               void* out_p, int T, int Qg, int d, int kk, int is_l2,
                               int three_pass, void* stream) {
  // sqrt(d) rounded once to f32, as the reference's f32 * float64-scalar
  const RbqRows src{(const uint8_t*)signs, (const float*)rn, (const float*)t, (const float*)cents,
                    (const int*)lids, (float)sqrt((double)d)};
  return launch_task_scan(src, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, is_l2, three_pass, stream);
}
