// IVF_PQ ADC task scan for Hopper (sm_90a).
//
// ivf_adc_scan replaces both ADC kernels of knowhere_tpu/ops/ivf_pallas.py:
// _adc_kernel (pallas_adc_tasks, m * ksub <= 8192) and _adc_kernel_mc
// (pallas_adc_tasks_mc, the m-chunked grid for larger m). The two compute the
// same scores; the second exists only because of the TPU's 8192-entry VMEM
// cap. Here the subspaces are walked in chunks inside one block, which puts
// no cap on m * ksub, so one kernel serves SIFT's m=16 and GIST's m=96.
//
// Per task t (one aligned 512-row block blk[t] of list lids[t], one group of
// Qg pre-gathered queries in the OPQ-rotated frame), with b the bf16-rounded
// codebooks (m, ksub, sub) and f = 2 for L2, 1 for IP:
//
//   lut[q, j, v] = bf16( f * (sum_s bf16(q)_s b[j,v,s] + sum_s bf16(q - bf16(q))_s b[j,v,s])
//                        - clut[lid, j * ksub + v] )           (no clut for IP)
//   score[q, r]  = base[q] + sum_j lut[q, j, code[r, j]]      (f32)
//   base[q]      = 2 <q, c> - |c|^2 (L2) or <q, c> (IP),  c = cent_scan[lid]
//
// then the per-query top-kk (topk_common.cuh's contract), with rows at or past
// nrows[t] and rows the keep-mask drops at -1e38. With nib, code byte j holds
// subspace j in its low nibble and subspace j + m/2 in its high nibble.
//
// Design (one block of 8 warps per task), on the frame of the task scans
// (ivf_task_scan.cuh): an empty task (nrows = 0) writes its sentinels before
// any load, and nothing past nrows is read or scored. The task's code rows
// below nrows go to shared memory by cp.async (row stride padded to an odd
// number of words, so the 32 rows a warp reads at one subspace hit 32
// banks); the rest of the last 32-row slab is zeroed, and whole slabs past
// nrows are skipped by a warp-uniform bound. Queries go in groups of 8, one
// per warp. For each group the block builds the group's LUT for a chunk of
// subspaces in shared memory (lut_chunk: bf16, at most 32 KB), then
// each warp adds its query's lookups for the chunk into 16 register
// accumulators per lane (lane l owns rows l + 32 i); the next chunk reuses
// the buffer. The lookups are unrolled over the slabs below nrows
// (lookup_slabs picks the instance), so a subspace's reads issue together;
// the LUT build is a function of its own (build_lut_chunk), out of line.
// The scores never leave registers before the epilogue, topk_common.cuh's
// warp_topk_select, whose scratch lies over the queries and the LUT once
// every warp is done with the group's lookups.
//
// What bounds it on the H100: building the LUT costs Qg * m * ksub * sub * 2
// FMAs per non-empty task (8.4 M at the SIFT shape Qg=128, m=16, ksub=256,
// sub=8), each FMA fed by a shared-memory read of the query; the scan itself
// is only Qg * nrows * m <= 1 M lookups. So FFMA and shared-memory issue,
// not device memory (at most 8 KB of codes per task), set the pace. The LUT
// depends on the list only through clut, so every block of a list rebuilds
// the same query part; moving the LUT build onto wgmma is the next change.

#include <cuda_bf16.h>

#include "topk_common.cuh"
#include "wgmma_common.cuh"

namespace kw {

constexpr int kAdcWarps = 8;                 // warps per task block
constexpr int kAdcThreads = kAdcWarps * 32;
constexpr int kAdcG = kAdcWarps;             // queries per group: one per warp
constexpr int kAdcNJ = kB / 32;              // rows a lane scores: lane + 32 j
constexpr int kAdcLutBytes = 32 * 1024;      // LUT chunk of one group, bf16
constexpr int kAdcSelBytes = kAdcG * kB * 6;  // warp_topk_select's scratch, every warp

// shared-memory row stride of the code block: bytes, an odd number of words
__host__ __device__ __forceinline__ int adc_code_stride(int mb) {
  int w = (mb + 3) / 4;
  if (w % 2 == 0) w += 1;
  return 4 * w;
}

// subspaces per LUT chunk
__host__ __device__ __forceinline__ int adc_chunk(int m, int ksub) {
  const int mc = kAdcLutBytes / (kAdcG * ksub * 2);
  return mc < m ? mc : m;
}

// the front of shared memory: [kAdcG][d] hi queries, [kAdcG][d] lo queries
// and the group's LUT chunk [kAdcG][MC][ksub] while a group's lookups run;
// the selection's scratch, [kAdcG][kB] f32 scores and [kAdcG][kB] u16
// columns, after them
__host__ __device__ __forceinline__ size_t adc_front_bytes(int d, int m, int ksub) {
  const size_t qlut = (size_t)2 * kAdcG * d * sizeof(float) + (size_t)kAdcG * adc_chunk(m, ksub) * ksub * 2;
  return qlut > (size_t)kAdcSelBytes ? qlut : (size_t)kAdcSelBytes;
}

// the front, then the code block [kB][stride]
__host__ __device__ __forceinline__ size_t adc_smem_bytes(int d, int m, int ksub, int mb) {
  return adc_front_bytes(d, m, ksub) + (size_t)kB * adc_code_stride(mb);
}

__device__ __forceinline__ float bf16_rn(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum_s x[s] * b[s] for one subspace, x in shared memory; vector loads where
// SUB allows (x is 16-byte aligned for SUB % 4 == 0, 8-byte for SUB % 2 == 0)
template <int SUB>
__device__ __forceinline__ float sub_dot(const float* x, const float (&b)[SUB]) {
  float a = 0.f;
  if constexpr (SUB % 4 == 0) {
#pragma unroll
    for (int s = 0; s < SUB; s += 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + s);
      a = fmaf(v.x, b[s], a);
      a = fmaf(v.y, b[s + 1], a);
      a = fmaf(v.z, b[s + 2], a);
      a = fmaf(v.w, b[s + 3], a);
    }
  } else if constexpr (SUB % 2 == 0) {
#pragma unroll
    for (int s = 0; s < SUB; s += 2) {
      const float2 v = *reinterpret_cast<const float2*>(x + s);
      a = fmaf(v.x, b[s], a);
      a = fmaf(v.y, b[s + 1], a);
    }
  } else {
#pragma unroll
    for (int s = 0; s < SUB; ++s) a = fmaf(x[s], b[s], a);
  }
  return a;
}

// one LUT entry from its hi and lo partial dots, rounded as the TPU kernel
// rounds it: (hi + lo), times 2 and minus clut for L2, then to bf16
__device__ __forceinline__ __nv_bfloat16 lut_entry(float hi, float lo, float cl, bool l2) {
  const float lq = __fadd_rn(hi, lo);
  return __float2bfloat16_rn(l2 ? __fsub_rn(__fmul_rn(2.f, lq), cl) : lq);
}

// The group's LUT for subspaces j0 .. j0 + mc - 1: lut[g * MC * ksub + jj *
// ksub + v] = lut_entry of query g (hi / lo rows of qhi / qlo, row stride d),
// subspace j0 + jj, codeword v. One thread an entry (jj, v), all 8 queries.
template <int SUB>
__device__ __forceinline__ void lut_chunk(__nv_bfloat16* lut, const float* qhi, const float* qlo,
                                          const __nv_bfloat16* books, const __nv_bfloat16* clut_l, int j0,
                                          int mc, int MC, int d, int ksub, int sub, bool l2) {
  for (int p = threadIdx.x; p < mc * ksub; p += kAdcThreads) {
    const int jj = p / ksub;
    const int v = p - jj * ksub;
    const int J = j0 + jj;
    const __nv_bfloat16* bp = books + ((size_t)J * ksub + v) * sub;
    const float cl = l2 ? __bfloat162float(clut_l[J * ksub + v]) : 0.f;
    __nv_bfloat16* dst = lut + jj * ksub + v;
    if constexpr (SUB > 0) {
      float bv[SUB];
#pragma unroll
      for (int s = 0; s < SUB; ++s) bv[s] = __bfloat162float(bp[s]);
#pragma unroll 2
      for (int g = 0; g < kAdcG; ++g) {
        const float hi = sub_dot<SUB>(qhi + g * d + J * SUB, bv);
        const float lo = sub_dot<SUB>(qlo + g * d + J * SUB, bv);
        dst[g * MC * ksub] = lut_entry(hi, lo, cl, l2);
      }
    } else {
      for (int g = 0; g < kAdcG; ++g) {
        const float* h = qhi + g * d + J * sub;
        const float* l = qlo + g * d + J * sub;
        float hi = 0.f, lo = 0.f;
        for (int s = 0; s < sub; ++s) {
          const float bs = __bfloat162float(bp[s]);
          hi = fmaf(h[s], bs, hi);
          lo = fmaf(l[s], bs, lo);
        }
        dst[g * MC * ksub] = lut_entry(hi, lo, cl, l2);
      }
    }
  }
}

// lut_chunk out of line, for the compile-time widths. Inlined, the LUT
// build shares one register allocation with the accumulators and the
// unrolled lookups, and the GIST shape ran about 1.5x as long on the H100
// (PERF.md). The run-time width (SUB = 0) stays inline: out of line it
// spilled (ptxas -v).
template <int SUB>
__device__ __noinline__ void build_lut_chunk(__nv_bfloat16* lut, const float* qhi, const float* qlo,
                                             const __nv_bfloat16* books, const __nv_bfloat16* clut_l, int j0,
                                             int mc, int MC, int d, int ksub, int sub, bool l2) {
  lut_chunk<SUB>(lut, qhi, qlo, books, clut_l, j0, mc, MC, d, ksub, sub, l2);
}

// The warp's lookups of one LUT chunk (lw: its query's [mc][ksub] entries):
// acc[j] += lut[J, code of row lane + 32 j at subspace J], J ascending, for
// the row slabs J0 <= j < J1. The bounds are compile-time, so the reads of
// a subspace issue together.
template <int J0, int J1>
__device__ __forceinline__ void lookup_range(float (&acc)[kAdcNJ], const __nv_bfloat16* lw, const uint8_t* cs,
                                             int cstride, int j0, int mc, int ksub, int mb, int mask, int lane) {
  for (int jj = 0; jj < mc; ++jj) {
    const int J = j0 + jj;
    const int byte = J < mb ? J : J - mb;  // nib: high nibble for J >= m/2
    const int shift = J < mb ? 0 : 4;
    const __nv_bfloat16* lj = lw + jj * ksub;
#pragma unroll
    for (int j = J0; j < J1; ++j) {
      const int code = (cs[(lane + 32 * j) * cstride + byte] >> shift) & mask;
      acc[j] += __bfloat162float(lj[code]);
    }
  }
}

// The lookups of the jn (warp-uniform, 1 .. JN) row slabs that hold a row
// below nrows, as compile-time ranges of at most 8 slabs a pass (16 at once
// took 128 registers and spilled); each row still sums its subspaces in
// ascending order.
template <int JN>
__device__ __forceinline__ void lookup_slabs(int jn, float (&acc)[kAdcNJ], const __nv_bfloat16* lw,
                                             const uint8_t* cs, int cstride, int j0, int mc, int ksub, int mb,
                                             int mask, int lane) {
  if constexpr (JN > 1) {
    if (jn < JN) {
      lookup_slabs<JN - 1>(jn, acc, lw, cs, cstride, j0, mc, ksub, mb, mask, lane);
      return;
    }
  }
  lookup_range<0, (JN < 8 ? JN : 8)>(acc, lw, cs, cstride, j0, mc, ksub, mb, mask, lane);
  if constexpr (JN > 8) lookup_range<8, JN>(acc, lw, cs, cstride, j0, mc, ksub, mb, mask, lane);
}

// SUB = sub_dim known at compile time; 0 reads it from sub_rt. words: the
// code rows are copied as 4-byte words (mb % 4 == 0, codes 4-byte aligned)
template <int SUB>
__global__ void __launch_bounds__(kAdcThreads)
    ivf_adc_scan_kernel(const int* __restrict__ blk, const int* __restrict__ nrows,
                        const int* __restrict__ lids, const float* __restrict__ q,
                        const __nv_bfloat16* __restrict__ books,
                        const __nv_bfloat16* __restrict__ clut, const float* __restrict__ cents,
                        const uint8_t* __restrict__ codes, const uint8_t* __restrict__ keep,
                        float* __restrict__ out_s, int* __restrict__ out_p, int Qg, int d, int m,
                        int ksub, int sub_rt, int kk, int is_l2, int nib, int words) {
  const int t = blockIdx.x;
  const int n = min(nrows[t], kB);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (n <= 0) {  // empty task: sentinels, no load
    const size_t o0 = (size_t)t * Qg * kk;
    for (int i = tid; i < Qg * kk; i += kAdcThreads) {
      out_s[o0 + i] = KW_NEG_INF;
      out_p[o0 + i] = -1;
    }
    return;
  }
  const int sub = SUB > 0 ? SUB : sub_rt;
  const int mb = nib ? m / 2 : m;  // code bytes per row
  const int cstride = adc_code_stride(mb);
  const int MC = adc_chunk(m, ksub);
  const bool l2 = is_l2 != 0;
  extern __shared__ __align__(16) unsigned char smem_adc[];
  float* qhi = reinterpret_cast<float*>(smem_adc);                    // [kAdcG][d]
  float* qlo = qhi + kAdcG * d;                                        // [kAdcG][d]
  __nv_bfloat16* lut = reinterpret_cast<__nv_bfloat16*>(qlo + kAdcG * d);  // [kAdcG][MC][ksub]
  float* sel_s = reinterpret_cast<float*>(smem_adc);                  // [kAdcG][kB], over the above
  uint16_t* sel_c = reinterpret_cast<uint16_t*>(sel_s + kAdcG * kB);   // [kAdcG][kB]
  uint8_t* cs = smem_adc + adc_front_bytes(d, m, ksub);               // [kB][cstride]

  // the code rows below n, then zeros to the end of their last 32-row slab
  const int b = blk[t];
  const int lid = lids[t];
  const uint8_t* gc = codes + (size_t)b * kB * mb;
  if (words) {
    const int wpr = mb / 4;
    for (int i = tid; i < n * wpr; i += kAdcThreads) {
      const int r = i / wpr;
      cp_async4(cs + r * cstride + 4 * (i - r * wpr), gc + 4 * i);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < n * mb; i += kAdcThreads) {
      const int r = i / mb;
      cs[r * cstride + (i - r * mb)] = gc[i];
    }
  }
  const int jn = (n + 31) / 32;  // row slabs with a row below n (warp-uniform, >= 1)
  for (int i = tid; i < (32 * jn - n) * cstride; i += kAdcThreads) cs[n * cstride + i] = 0;
  unsigned ok = 0;  // bit j: row lane + 32 j is scored
#pragma unroll
  for (int j = 0; j < kAdcNJ; ++j) {
    const int c = lane + 32 * j;
    if (c < n && (keep == nullptr || keep[(size_t)b * kB + c] != 0)) ok |= 1u << j;
  }
  const float* cent = cents + (size_t)lid * d;
  float cc = 0.f;
  for (int k = lane; k < d; k += 32) cc = fmaf(cent[k], cent[k], cc);
  cc = warp_sum(cc);
  const __nv_bfloat16* clut_l = clut + (size_t)lid * m * ksub;
  const float* gq = q + (size_t)t * Qg * d;
  const int mask = nib ? 15 : 255;

  for (int g0 = 0; g0 < Qg; g0 += kAdcG) {
    __syncthreads();  // the previous group's selection is done with the front
    for (int i = tid; i < kAdcG * d; i += kAdcThreads) {
      const float v = g0 + i / d < Qg ? gq[(size_t)g0 * d + i] : 0.f;
      const float hi = bf16_rn(v);
      qhi[i] = hi;
      qlo[i] = bf16_rn(v - hi);
    }
    const int row = g0 + warp;  // this warp's query (warp-uniform)
    float qc = 0.f;
    if (row < Qg)
      for (int k = lane; k < d; k += 32) qc = fmaf(gq[(size_t)row * d + k], cent[k], qc);
    qc = warp_sum(qc);
    float acc[kAdcNJ];
#pragma unroll
    for (int j = 0; j < kAdcNJ; ++j) acc[j] = 0.f;

    for (int j0 = 0; j0 < m; j0 += MC) {
      const int mc = min(MC, m - j0);
      __syncthreads();  // queries stored; the previous chunk's lookups are done
      if constexpr (SUB > 0)
        build_lut_chunk<SUB>(lut, qhi, qlo, books, clut_l, j0, mc, MC, d, ksub, sub, l2);
      else
        lut_chunk<0>(lut, qhi, qlo, books, clut_l, j0, mc, MC, d, ksub, sub, l2);
      cp_async_wait_all();  // the code rows (first chunk of the first group)
      __syncthreads();      // the chunk's LUT and the code rows are in place
      if (row < Qg)
        lookup_slabs<kAdcNJ>(jn, acc, lut + warp * MC * ksub, cs, cstride, j0, mc, ksub, mb, mask, lane);
    }
    __syncthreads();  // every warp is done with the queries and the LUT: the selection takes the front
    if (row < Qg) {
      const float base = l2 ? __fsub_rn(__fmul_rn(2.f, qc), cc) : qc;
#pragma unroll
      for (int j = 0; j < kAdcNJ; ++j) acc[j] = (ok >> j) & 1u ? __fadd_rn(base, acc[j]) : KW_NEG_INF;
      const size_t o = ((size_t)t * Qg + row) * kk;
      warp_topk_select<kAdcNJ>(acc, kk, b * kB, sel_s + warp * kB, sel_c + warp * kB, out_s + o, out_p + o);
    }
  }
}

template <int SUB>
int launch_adc(const void* blk, const void* nrows, const void* lids, const void* q,
               const void* books, const void* clut, const void* cents, const void* codes,
               const void* keep, void* out_s, void* out_p, int T, int Qg, int d, int m, int ksub,
               int sub, int kk, int is_l2, int nib, int words, size_t smem, cudaStream_t s) {
  auto k = ivf_adc_scan_kernel<SUB>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k<<<T, kAdcThreads, smem, s>>>((const int*)blk, (const int*)nrows, (const int*)lids,
                                  (const float*)q, (const __nv_bfloat16*)books,
                                  (const __nv_bfloat16*)clut, (const float*)cents,
                                  (const uint8_t*)codes, (const uint8_t*)keep, (float*)out_s,
                                  (int*)out_p, Qg, d, m, ksub, sub, kk, is_l2, nib, words);
  return (int)cudaGetLastError();
}

}  // namespace kw

using namespace kw;

// ops/adc_cuda.adc_smem_bytes mirrors adc_smem_bytes: the search takes this
// kernel only for shapes whose shared memory fits a block.
extern "C" int kw_ivf_adc_scan(const void* blk, const void* nrows, const void* lids,
                               const void* q, const void* books, const void* clut,
                               const void* cents, const void* codes, const void* keep,
                               void* out_s, void* out_p, int T, int Qg, int d, int m, int ksub,
                               int sub, int kk, int is_l2, int nib, void* stream) {
  if (T <= 0) return 0;
  if (kk < 1 || kk > 32 || m < 1 || sub < 1 || m * sub > d || d % 4 != 0 || ksub < 1 ||
      ksub > 256 || (nib && (ksub != 16 || m % 2 != 0)))
    return (int)cudaErrorInvalidValue;
  const int mb = nib ? m / 2 : m;
  const size_t smem = adc_smem_bytes(d, m, ksub, mb);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int words = mb % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define KW_ADC_ARGS blk, nrows, lids, q, books, clut, cents, codes, keep, out_s, out_p, T, Qg, d, m, \
                    ksub, sub, kk, is_l2, nib, words, smem, s
  switch (sub) {
    case 2: return launch_adc<2>(KW_ADC_ARGS);
    case 4: return launch_adc<4>(KW_ADC_ARGS);
    case 8: return launch_adc<8>(KW_ADC_ARGS);
    case 10: return launch_adc<10>(KW_ADC_ARGS);
    case 16: return launch_adc<16>(KW_ADC_ARGS);
    default: return launch_adc<0>(KW_ADC_ARGS);
  }
#undef KW_ADC_ARGS
}
