// IVF task-scan kernels for Hopper (sm_90a): the int8 and f32 row sources
// of the tensor-core task scan of ivf_task_scan.cuh, one thread block per
// task and 32 or 64 queries.
//
// ivf_int8_scan replaces knowhere_tpu/ops/ivf_pallas.py _int8_kernel
// (pallas_int8_tasks): the FAST serving scan of IVF_FLAT (its int8 sidecar)
// and IVF_SQ8 (its u8 codes), i8 queries . i8 codes -> s32. cp.async stages a
// chunk of 64 rows x 128 code bytes (8 KB), which moves (recentred for u8)
// to the s8 A operand; the i8 query group goes to the B operand by cp.async
// with no conversion, and the products are s8 wgmma into s32 accumulators,
// exact, so its scores and positions equal the plain version's bit for bit.
// What bounds it on the H100: per task it reads the block's codes up to
// nrows (64 KB in full) and the query group (16 KB at Qg=128, d=128) once,
// and does 2 Qg * nrows * d int8 operations, far below the tensor cores'
// rate; so device memory bounds it, and the staging latency of each 64-row
// chunk, the barriers and the top-kk epilogue set its time above that
// bound. Its tiles hold one byte a feature, so a block needs about 38 KB of
// shared memory (kk <= 16) and several blocks share an SM to hide that
// latency.
//
// ivf_f32_scan replaces _scan_kernel (pallas_scan_tasks): f32 rows against
// f32 queries as the reference's three bf16 passes or its single pass. Per
// task it does 3 x 2 Qg * nrows * d bf16 operations and reads the f32 block
// once, so it is bound by device memory (the blocks and the gathered
// queries) and by its top-kk epilogue.
#include <cuda_bf16.h>

#include "ivf_task_scan.cuh"

namespace kw {

// ---------------------------------------------------------------------------
// int8 on the tensor cores (ivf_task_scan.cuh): zi (Qg, d) i8 . codes (B, d)
// i8 as s8 wgmma into s32 accumulators (exact), score 2*sz*dot - nrm (L2) or
// sz*dot (IP). u8 codes (SQ8) are recentred by c ^ 0x80 as in the TPU
// kernel, while the staged chunk moves to the operand tile.
// ---------------------------------------------------------------------------
struct Int8Rows {
  const uint8_t* codes;  // (n * 512, d) i8 sidecar or u8 SQ8 codes
  const float* nrm;      // centred norms, one a stored row (zeros for IP)
  const float* sz;       // (T * Qg) per-query scales
  uint32_t flip;         // 0x80808080 for u8 codes (c - 128 as an i8 bit pattern), else 0
  using Query = int8_t;
  static constexpr bool kRowNorm = false, kQuerySide = true;
  __device__ bool a_lo(bool) const { return false; }
  __device__ void stage(unsigned char* st, int b, int c, int kc, int d, int tid) const {
    stage_code_rows(st, codes + ((size_t)b * kB + c * kXRows) * d + kc * kChunk, d, tid);
  }
  // slice sl (16 codes) of row r: thread tid takes row tid % 64 and every
  // other slice of it
  __device__ float rows_op(const unsigned char* st, unsigned char* xop, const float*, bool, int tid) const {
    for (int u = tid; u < kXRows * (kChunk / 16); u += 128) {
      const int r = u % kXRows, sl = u / kXRows;
      uint4 v = *reinterpret_cast<const uint4*>(st + r * kCodeStride + 16 * sl);
      v.x ^= flip;
      v.y ^= flip;
      v.z ^= flip;
      v.w ^= flip;
      *reinterpret_cast<uint4*>(xop + sl * (kXRows * 16) + r * 16) = v;
    }
    return 0.f;
  }
  __device__ float query_side(size_t i) const { return sz[i]; }
  __device__ void row_side(float* rs0, float*, size_t g, int r) const { rs0[r] = nrm[g]; }
  // the dot rounded once to f32, then the reference's order, no FMA
  // contraction: (2 sz) dot - nrm, or sz dot
  __device__ float score(int acc, float nrm_r, float, float s, bool l2) const {
    const float dot = __int2float_rn(acc);
    return l2 ? __fsub_rn(__fmul_rn(__fmul_rn(2.f, s), dot), nrm_r) : __fmul_rn(s, dot);
  }
};

// ---------------------------------------------------------------------------
// f32 on the tensor cores (ivf_task_scan.cuh): q (Qg, d) . rows (B, d) as the
// reference's three bf16 passes (three_pass) or its single hi.hi pass, the
// f32 rows staged by cp.async and split into hi/lo bf16 in the kernel,
// in-kernel |x|^2 from the f32 rows, score 2*dot - |x|^2 (L2) or dot (IP).
// ---------------------------------------------------------------------------
struct F32Rows {
  const float* data;  // (n * 512, d) f32 rows
  using Query = float;
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

// q (T, Qg, d) i8 with d a multiple of 128, sz (T, Qg) f32, codes (n * 512,
// d) i8 or u8 (u8 != 0), nrm (n * 512,) f32, kk <= 32.
extern "C" int kw_ivf_int8_scan(const void* blk, const void* nrows, const void* q,
                                const void* sz, const void* codes, const void* nrm,
                                const void* keep, void* out_s, void* out_p, int T, int Qg,
                                int d, int kk, int is_l2, int u8, void* stream) {
  const Int8Rows src{(const uint8_t*)codes, (const float*)nrm, (const float*)sz, u8 ? 0x80808080u : 0u};
  return launch_task_scan(src, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, is_l2, 0, stream);
}

// q (T, Qg, d) f32, data (n * 512, d) f32 with d a multiple of 128, kk <= 32.
extern "C" int kw_ivf_f32_scan(const void* blk, const void* nrows, const void* q,
                               const void* data, const void* keep, void* out_s, void* out_p,
                               int T, int Qg, int d, int kk, int is_l2, int three_pass,
                               void* stream) {
  return launch_task_scan(F32Rows{(const float*)data}, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, is_l2,
                          three_pass, stream);
}
