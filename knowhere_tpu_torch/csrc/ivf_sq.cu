// IVF SQ task scan for Hopper (sm_90a).
//
// ivf_sq_scan replaces knowhere_tpu/ops/ivf_pallas.py _sq_kernel
// (pallas_sq_tasks): the IVF_SQ8 (SQ8 and SQ6) scan of u8 codes decoded in the
// scan as the TPU kernel decodes them,
//     x = vmin + ((c + 0.5) * (1/levels)) * vdiff        (f32, no FMA contraction)
// then scored like the f32 scan: 2*dot - |x|^2 (L2) or dot (IP), |x|^2 from
// the f32 decoded rows, the dot as the TPU's single bf16 pass
// bf16(q).bf16(x) (three_pass=False) or the reference's three hi/lo passes
// q_hi.x_hi + q_hi.x_lo + q_lo.x_hi (three_pass=True).
//
// It is the SQ row source of the tensor-core task scan (ivf_task_scan.cuh):
// cp.async stages a chunk of 64 rows x 128 u8 codes (8 KB, a quarter of the
// f32 scan's bytes), and each thread decodes 16 codes of a row at a time
// from the staging tile into the bf16 operand (hi, and lo for three_pass),
// summing the f32 squares for L2. The products run on wgmma, the top-kk in
// the shared sorted-list epilogue.
//
// What bounds it on the H100: per task it reads 64 KB of codes and the
// query group (64 KB at Qg=128, d=128) once and does 1 or 3 x 2 Qg * nrows
// * d bf16 operations, far below the tensor cores' rate; so device memory
// bounds it, and the decode (about 8 instructions a code, once a task and
// query block) and the epilogue set its time above that bound.

#include <cuda_bf16.h>

#include "ivf_task_scan.cuh"

namespace kw {

struct SqRows {
  const uint8_t* codes;  // (n * 512, d) u8
  const float* vmin;     // (d,)
  const float* vdiff;    // (d,)
  float inv;             // 1 / levels, a power of two: exact
  using Query = float;
  static constexpr bool kRowNorm = true, kQuerySide = false;
  __device__ bool a_lo(bool three) const { return three; }
  __device__ void stage(unsigned char* st, int b, int c, int kc, int d, int tid) const {
    stage_code_rows(st, codes + ((size_t)b * kB + c * kXRows) * d + kc * kChunk, d, tid);
  }
  // the grid of feature chunk kc: aux[0:128] vmin, aux[128:256] vdiff
  __device__ void load_aux(float* aux, int, int kc, int, int tid) const {
    aux[tid] = vmin[kc * kChunk + tid];
    aux[kChunk + tid] = vdiff[kc * kChunk + tid];
  }
  // unit (row r, 16 features from f0): thread tid takes row tid % 64 and
  // every other unit of it
  __device__ float rows_op(const unsigned char* st, unsigned char* xop, const float* aux, bool three,
                           int tid) const {
    float part = 0.f;
    for (int u = tid; u < kXRows * (kChunk / 16); u += 128) {
      const int r = u % kXRows, f0 = 16 * (u / kXRows);
      const uint4 raw = *reinterpret_cast<const uint4*>(st + r * kCodeStride + f0);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float x[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float code = (float)((words[e >> 2] >> (8 * (e & 3))) & 0xffu);
        // (c + 0.5) * inv is exact for levels 64 / 256; then the reference's
        // two roundings in its order: * vdiff, + vmin
        const float tq = __fmul_rn(__fadd_rn(code, 0.5f), inv);
        x[e] = __fadd_rn(aux[f0 + e], __fmul_rn(tq, aux[kChunk + f0 + e]));
        part = fmaf(x[e], x[e], part);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = f0 / 8 + h;
        uint4 hi, lo;
        split8(make_float4(x[8 * h], x[8 * h + 1], x[8 * h + 2], x[8 * h + 3]),
               make_float4(x[8 * h + 4], x[8 * h + 5], x[8 * h + 6], x[8 * h + 7]), hi, lo);
        *reinterpret_cast<uint4*>(xop + g * (kXRows * 16) + r * 16) = hi;
        if (three) *reinterpret_cast<uint4*>(xop + (kSlices + g) * (kXRows * 16) + r * 16) = lo;
      }
    }
    return part;
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

// q (T, Qg, d) f32, codes (n * 512, d) u8 with d a multiple of 128, kk <= 32,
// levels 64 (SQ6) or 256 (SQ8).
extern "C" int kw_ivf_sq_scan(const void* blk, const void* nrows, const void* q,
                              const void* codes, const void* vmin, const void* vdiff,
                              const void* keep, void* out_s, void* out_p, int T, int Qg, int d,
                              int kk, int levels, int is_l2, int three_pass, void* stream) {
  if (levels != 64 && levels != 256) return (int)cudaErrorInvalidValue;
  const SqRows src{(const uint8_t*)codes, (const float*)vmin, (const float*)vdiff, 1.0f / (float)levels};
  return launch_task_scan(src, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, is_l2, three_pass, stream);
}
