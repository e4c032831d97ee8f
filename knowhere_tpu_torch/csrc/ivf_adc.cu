// IVF_PQ ADC task scan for Hopper (sm_90a).
//
// ivf_adc_scan replaces both ADC kernels of knowhere_tpu/ops/ivf_pallas.py:
// _adc_kernel (pallas_adc_tasks, m * ksub <= 8192) and _adc_kernel_mc
// (pallas_adc_tasks_mc, the m-chunked grid for larger m). The two compute the
// same scores; the second exists only because of the TPU's 8192-entry VMEM
// cap. Here the subspaces are walked in chunks inside one block, which puts
// no cap on m * ksub, so one kernel serves SIFT's m=16 and GIST's m=96.
//
// The lookup table splits as Faiss's precomputed one does. Its query part,
// with b the bf16-rounded codebooks (m, ksub, sub) and f = 2 for L2, 1 for IP,
//
//   P[q, j * ksub + v] = f * sum_s bf16(q)_s b[j,v,s] + f * sum_s bf16(q - bf16(q))_s b[j,v,s]
//
// (each sum one FMA chain in ascending feature, then one add) does not
// depend on the list, so ivf_adc_qtable builds it once a search, on the CUDA
// cores (ivf_adc_scan_kernel_qtable). A product of two bf16 values is exact
// in f32, so the chain's order is the whole of its rounding, and the plain
// version (ops/adc_cuda.compute_qlut) sums in the same order: the two agree
// bit for bit. Per task t (one aligned 512-row block blk[t] of list lids[t],
// one group of Qg queries qids[t], rows of q and P):
//
//   lut[q, j, v] = bf16(P[q, j * ksub + v] - clut[lid, j * ksub + v])   (no clut for IP)
//   score[q, r]  = base[q] + sum_j lut[q, j, code[r, j]]      (f32)
//   base[q]      = 2 <q, c> - |c|^2 (L2) or <q, c> (IP),  c = cent_scan[lid]
//
// then the per-query top-kk (topk_common.cuh's contract), with rows at or past
// nrows[t] and rows the keep-mask drops at -1e38. With nib, code byte j holds
// subspace j in its low nibble and subspace j + m/2 in its high nibble.
//
// Design (one block of 8 warps per task; two blocks an SM where the shared
// memory allows, so registers are capped at 128), on the frame of the task
// scans (ivf_task_scan.cuh): an empty task (nrows = 0) writes its sentinels
// before any load, and nothing past nrows is read or scored. The task's
// code rows below nrows go to shared memory by cp.async (row stride padded
// to an odd number of words, so the 32 rows a warp reads at one subspace
// hit 32 banks), the rest of the last 32-row slab is zeroed, and whole slabs
// past nrows are skipped by a warp-uniform bound; the list's clut row goes
// beside them. That is the block's one barrier.
//
// Queries go in groups of G = 16, two a warp, and a warp then works through
// its pair alone. The pair's rows of P go a chunk of subspaces at a time
// (512 entries a query) by cp.async into one of the warp's two buffers, the
// next chunk's copy in flight under this chunk's lookups; the warp writes
// each entry pair bf16(P - clut) in place over the first query's f32 row,
// one word holding one codeword of both queries, so a lookup reads two
// queries' entries with one load. Each lane adds its queries' lookups into
// 16 register accumulators a query (lane l owns rows l + 32 i), one code
// read serving both; the lookups are unrolled over the slabs below nrows
// (lookup_slabs picks the instance), so a subspace's reads issue together,
// and each row sums its subspaces in ascending order. The scores never
// leave registers before the epilogue, topk_common.cuh's warp_topk_select,
// one query at a time, whose scratch lies over the warp's buffers.
//
// What bounds it on the H100: a task reads Qg * m * ksub * 4 bytes of P
// (12.6 MB at GIST's Qg=128, m=96; P itself is nq * m * ksub * 4 bytes,
// mostly served by L2), makes Qg * nrows * m shared-memory lookups and
// rounds Qg * m * ksub entries; its codes are at most 48 KB (PERF.md).

#include <cuda_bf16.h>

#include "topk_common.cuh"
#include "wgmma_common.cuh"

namespace kw {

constexpr int kAdcWarps = 8;                 // warps per task block
constexpr int kAdcThreads = kAdcWarps * 32;
constexpr int kAdcQPW = 2;                   // queries a warp scores: one LUT word holds both
constexpr int kAdcG = kAdcWarps * kAdcQPW;   // queries per group
constexpr int kAdcNJ = kB / 32;              // rows a lane scores: lane + 32 j
constexpr int kAdcChunk = 512;               // table entries of a query a chunk
constexpr int kAdcBuf = kAdcQPW * kAdcChunk;  // floats of a buffer: a chunk of the pair's rows of P
constexpr int kAdcWarpBytes = 2 * kAdcBuf * 4;  // a warp's two buffers
constexpr int kAdcMinBlocks = 2;             // blocks an SM (__launch_bounds__): 128 registers a thread
constexpr int kAdcQtRows = 16;               // queries a thread of the table kernel takes
static_assert(kB * 6 <= kAdcWarpBytes, "a warp's selection scratch lies over its buffers");

// shared-memory row stride of the code block: bytes, an odd number of words
__host__ __device__ __forceinline__ int adc_code_stride(int mb) {
  int w = (mb + 3) / 4;
  if (w % 2 == 0) w += 1;
  return 4 * w;
}

// subspaces a chunk: 512 entries of a query (ksub <= 256: at least 2), at most m
__host__ __device__ __forceinline__ int adc_chunk_subspaces(int m, int ksub) {
  return kAdcChunk / ksub < m ? kAdcChunk / ksub : m;
}

// the task's clut row, bf16 [m * ksub]
__host__ __device__ __forceinline__ size_t adc_clut_bytes(int m, int ksub) {
  return ((size_t)m * ksub * 2 + 15) / 16 * 16;
}

// the warps' buffers, then the code block [kB][stride] and the clut row
__host__ __device__ __forceinline__ size_t adc_smem_bytes(int m, int ksub, int mb) {
  return (size_t)kAdcWarps * kAdcWarpBytes + (size_t)kB * adc_code_stride(mb) + adc_clut_bytes(m, ksub);
}

// bytes from global to shared memory by cp.async (16 bytes a copy where both
// ends allow it, else 4, else plain byte stores); the caller commits and waits
__device__ __forceinline__ void stage_bytes(void* dst, const void* src, size_t bytes, int tid) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  if (reinterpret_cast<uintptr_t>(s) % 16 == 0 && bytes % 16 == 0) {
    for (size_t i = 16 * (size_t)tid; i < bytes; i += 16 * kAdcThreads) cp_async16(d + i, s + i);
  } else if (reinterpret_cast<uintptr_t>(s) % 4 == 0 && bytes % 4 == 0) {
    for (size_t i = 4 * (size_t)tid; i < bytes; i += 4 * kAdcThreads) cp_async4(d + i, s + i);
  } else {
    for (size_t i = tid; i < bytes; i += kAdcThreads) d[i] = s[i];
  }
}

// half h (0: low) of a bf16x2 word, as f32
__device__ __forceinline__ float bf16_half(uint32_t w, int h) { return __uint_as_float(h ? w & 0xFFFF0000u : w << 16); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp's copy of n entries of its pair's rows of P (from pa and pb) to
// a buffer: pa's at buf, pb's at buf + kAdcChunk; 16 bytes a copy where the
// rows allow it (vec: m * ksub % 4 == 0), else 4. One commit group.
__device__ __forceinline__ void stage_pair(float* buf, const float* pa, const float* pb, int n, bool vec, int lane) {
  if (vec) {
    for (int i = 4 * lane; i < n; i += 128) {
      cp_async16(buf + i, pa + i);
      cp_async16(buf + kAdcChunk + i, pb + i);
    }
  } else {
    for (int i = lane; i < n; i += 32) {
      cp_async4(buf + i, pa + i);
      cp_async4(buf + kAdcChunk + i, pb + i);
    }
  }
  cp_async_commit();
}

// The landed buffer (n entries) as the pair's LUT words, in place over the
// first row: word i = bf16(a_i - cl_i) | bf16(b_i - cl_i) << 16 (cl: the
// chunk's clut entries, none for IP), four a lane at a time. A chunk starts
// at a multiple of 4 entries (ksub a power of two), so cl is 8-byte aligned;
// the words past n are never looked up.
__device__ __forceinline__ void pair_lut(float* buf, const __nv_bfloat16* cl, int n, bool l2, int lane) {
  for (int i = 4 * lane; i < n; i += 128) {
    const float4 a = *reinterpret_cast<const float4*>(buf + i);
    const float4 b = *reinterpret_cast<const float4*>(buf + kAdcChunk + i);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if (l2) {
      const uint2 cw = *reinterpret_cast<const uint2*>(cl + i);
      c[0] = bf16_half(cw.x, 0), c[1] = bf16_half(cw.x, 1), c[2] = bf16_half(cw.y, 0), c[3] = bf16_half(cw.y, 1);
    }
    const __nv_bfloat162 w[4] = {
        __floats2bfloat162_rn(__fsub_rn(a.x, c[0]), __fsub_rn(b.x, c[0])),
        __floats2bfloat162_rn(__fsub_rn(a.y, c[1]), __fsub_rn(b.y, c[1])),
        __floats2bfloat162_rn(__fsub_rn(a.z, c[2]), __fsub_rn(b.z, c[2])),
        __floats2bfloat162_rn(__fsub_rn(a.w, c[3]), __fsub_rn(b.w, c[3]))};
    *reinterpret_cast<uint4*>(buf + i) = *reinterpret_cast<const uint4*>(w);
  }
}

// The warp's lookups of one LUT chunk: acc[q][j] += lut[query q of the
// warp's pair, J, code of row lane + 32 j at subspace J], J ascending, for
// the row slabs J0 <= j < J1; lw: the pair's LUT words, one read serving
// both queries. The bounds are compile-time, so the reads of a subspace
// issue together.
template <int J0, int J1>
__device__ __forceinline__ void lookup_range(float (&acc)[kAdcQPW][kAdcNJ], const uint32_t* lw, const uint8_t* cs,
                                             int cstride, int j0, int mc, int ksub, int mb, int mask, int lane) {
  for (int jj = 0; jj < mc; ++jj) {
    const int J = j0 + jj;
    const int byte = J < mb ? J : J - mb;  // nib: high nibble for J >= m/2
    const int shift = J < mb ? 0 : 4;
    const uint32_t* lj = lw + jj * ksub;
#pragma unroll
    for (int j = J0; j < J1; ++j) {
      const uint32_t w = lj[(cs[(lane + 32 * j) * cstride + byte] >> shift) & mask];
      acc[0][j] += bf16_half(w, 0);
      acc[1][j] += bf16_half(w, 1);
    }
  }
}

// The lookups of the jn (warp-uniform, 1 .. JN) row slabs that hold a row
// below nrows, as compile-time ranges of at most 8 slabs a pass (16 at once
// took 128 registers and spilled); each row still sums its subspaces in
// ascending order.
template <int JN>
__device__ __forceinline__ void lookup_slabs(int jn, float (&acc)[kAdcQPW][kAdcNJ], const uint32_t* lw,
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

// P (nq, m * ksub) f32, the table's query part (above): a thread takes one
// entry e = j * ksub + v of kAdcQtRows queries, a block 256 entries; the
// queries' features of subspace j are read by every thread of j (one
// broadcast load), the codeword once a feature.
__global__ void __launch_bounds__(256)
    ivf_adc_scan_kernel_qtable(const float* __restrict__ q, const __nv_bfloat16* __restrict__ books,
                               float* __restrict__ out, int nq, int d, int m, int ksub, int sub, float f) {
  constexpr int R = kAdcQtRows;
  const int mk = m * ksub;
  const int e = blockIdx.y * 256 + threadIdx.x;
  const int n0 = blockIdx.x * R;
  if (e >= mk) return;
  const int nr = min(R, nq - n0);
  const __nv_bfloat16* b = books + (size_t)e * sub;
  const float* x = q + (size_t)n0 * d + (e / ksub) * sub;
  float hi[R], lo[R];
  // -0, the additive identity: a chain of -0 products stays -0, as the
  // plain version's sum that starts from its first product
#pragma unroll
  for (int r = 0; r < R; ++r) hi[r] = lo[r] = -0.f;
  for (int s = 0; s < sub; ++s) {
    const float bs = __bfloat162float(b[s]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        const float v = x[(size_t)r * d + s];
        const float h = __bfloat162float(__float2bfloat16_rn(v));
        const float l = __bfloat162float(__float2bfloat16_rn(__fsub_rn(v, h)));
        hi[r] = __fmaf_rn(f * h, bs, hi[r]);  // f = 2 or 1: f * h exact
        lo[r] = __fmaf_rn(f * l, bs, lo[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < nr) out[(size_t)(n0 + r) * mk + e] = __fadd_rn(hi[r], lo[r]);
}

// words: the code rows are copied as 4-byte words (mb % 4 == 0, codes
// 4-byte aligned); vec: P's rows are whole 16-byte words (m * ksub % 4 == 0)
__global__ void __launch_bounds__(kAdcThreads, kAdcMinBlocks)
    ivf_adc_scan_kernel(const int* __restrict__ blk, const int* __restrict__ nrows,
                        const int* __restrict__ lids, const int* __restrict__ qids,
                        const float* __restrict__ q, const float* __restrict__ qtab,
                        const __nv_bfloat16* __restrict__ clut, const float* __restrict__ cents,
                        const uint8_t* __restrict__ codes, const uint8_t* __restrict__ keep,
                        float* __restrict__ out_s, int* __restrict__ out_p, int Qg, int d, int m,
                        int ksub, int kk, int is_l2, int nib, int words, int vec) {
  constexpr int QPW = kAdcQPW;
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
  const int mb = nib ? m / 2 : m;  // code bytes per row
  const int cstride = adc_code_stride(mb);
  const int mk = m * ksub, mc = adc_chunk_subspaces(m, ksub);
  const bool l2 = is_l2 != 0;
  extern __shared__ __align__(128) unsigned char smem_adc[];
  float* buf = reinterpret_cast<float*>(smem_adc + warp * kAdcWarpBytes);  // this warp's two buffers
  uint8_t* cs = smem_adc + kAdcWarps * kAdcWarpBytes;                      // [kB][cstride]
  const __nv_bfloat16* clut_s = reinterpret_cast<const __nv_bfloat16*>(cs + (size_t)kB * cstride);  // [m * ksub]

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
  } else {
    for (int i = tid; i < n * mb; i += kAdcThreads) {
      const int r = i / mb;
      cs[r * cstride + (i - r * mb)] = gc[i];
    }
  }
  // the list's clut row beside them
  if (l2) stage_bytes(const_cast<__nv_bfloat16*>(clut_s), clut + (size_t)lid * mk, (size_t)mk * 2, tid);
  cp_async_commit();
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
  const int mask = nib ? 15 : 255;
  cp_async_wait_all();
  __syncthreads();  // the code rows and the clut row are in place; from here each warp runs alone

  for (int row0 = warp * QPW; row0 < Qg; row0 += kAdcG) {  // this warp's pair of each group
    const int* tq = qids + (size_t)t * Qg + row0;
    const int qp[QPW] = {tq[0], row0 + 1 < Qg ? tq[1] : tq[0]};  // an odd Qg's last pair repeats its query
    const float* pa = qtab + (size_t)qp[0] * mk;
    const float* pb = qtab + (size_t)qp[1] * mk;
    stage_pair(buf, pa, pb, mc * ksub, vec, lane);
    float acc[QPW][kAdcNJ];
#pragma unroll
    for (int qi = 0; qi < QPW; ++qi)
#pragma unroll
      for (int j = 0; j < kAdcNJ; ++j) acc[qi][j] = 0.f;

    for (int j0 = 0, c = 0; j0 < m; j0 += mc, ++c) {
      float* cur = buf + (c & 1) * kAdcBuf;
      const int nsub = min(mc, m - j0);
      if (j0 + mc < m) {  // the next chunk's copy, under this chunk's lookups
        const int e1 = (j0 + mc) * ksub;
        stage_pair(buf + ((c + 1) & 1) * kAdcBuf, pa + e1, pb + e1, min(mc, m - j0 - mc) * ksub, vec, lane);
        cp_async_wait_group<1>();
      } else {
        cp_async_wait_group<0>();
      }
      __syncwarp();  // every lane's copies of this chunk have landed
      pair_lut(cur, clut_s + j0 * ksub, nsub * ksub, l2, lane);
      __syncwarp();
      lookup_slabs<kAdcNJ>(jn, acc, reinterpret_cast<const uint32_t*>(cur), cs, cstride, j0, nsub, ksub, mb, mask,
                           lane);
      __syncwarp();  // the buffer is read before the copy two chunks on lands in it
    }
    float* sel_s = buf;                                    // [kB], over the buffers
    uint16_t* sel_c = reinterpret_cast<uint16_t*>(buf + kB);  // [kB]
#pragma unroll
    for (int qi = 0; qi < QPW; ++qi) {
      const int row = row0 + qi;
      if (row >= Qg) break;
      const float* qr = q + (size_t)qp[qi] * d;
      float qc = 0.f;
      for (int k = lane; k < d; k += 32) qc = fmaf(qr[k], cent[k], qc);
      qc = warp_sum(qc);
      const float base = l2 ? __fsub_rn(__fmul_rn(2.f, qc), cc) : qc;
#pragma unroll
      for (int j = 0; j < kAdcNJ; ++j) acc[qi][j] = (ok >> j) & 1u ? __fadd_rn(base, acc[qi][j]) : KW_NEG_INF;
      const size_t o = ((size_t)t * Qg + row) * kk;
      warp_topk_select<kAdcNJ>(acc[qi], kk, b * kB, sel_s, sel_c, out_s + o, out_p + o);
      __syncwarp();  // the next query, or the next pair's copy, reuses the scratch
    }
  }
}

}  // namespace kw

using namespace kw;

// ops/adc_cuda.adc_smem_bytes mirrors adc_smem_bytes (chip_smoke.py holds
// the two equal through kw_ivf_adc_smem_bytes): the search takes this kernel
// only for shapes whose shared memory fits a block.
extern "C" int kw_ivf_adc_smem_bytes(int m, int ksub, int nib) {
  return (int)adc_smem_bytes(m, ksub, nib ? m / 2 : m);
}

extern "C" int kw_ivf_adc_qtable(const void* q, const void* books, void* out, int nq, int d, int m, int ksub,
                                 int sub, int is_l2, void* stream) {
  if (nq <= 0) return 0;
  if (m < 1 || sub < 1 || m * sub > d || ksub < 1 || ksub > 256) return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kAdcQtRows - 1) / kAdcQtRows, (m * ksub + 255) / 256);
  ivf_adc_scan_kernel_qtable<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const __nv_bfloat16*)books, (float*)out, nq, d, m, ksub, sub, is_l2 ? 2.f : 1.f);
  return (int)cudaGetLastError();
}

extern "C" int kw_ivf_adc_scan(const void* blk, const void* nrows, const void* lids, const void* qids,
                               const void* q, const void* qtab, const void* clut, const void* cents,
                               const void* codes, const void* keep, void* out_s, void* out_p, int T, int Qg,
                               int d, int m, int ksub, int kk, int is_l2, int nib, void* stream) {
  if (T <= 0) return 0;
  if (kk < 1 || kk > 32 || m < 1 || d % 4 != 0 || ksub < 1 || ksub > 256 || (ksub & (ksub - 1)) != 0 ||
      (nib && (ksub != 16 || m % 2 != 0)) || reinterpret_cast<uintptr_t>(qtab) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int mb = nib ? m / 2 : m;
  const size_t smem = adc_smem_bytes(m, ksub, mb);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int words = mb % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  const int vec = (m * ksub) % 4 == 0;
  cudaError_t e = cudaFuncSetAttribute(ivf_adc_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ivf_adc_scan_kernel<<<T, kAdcThreads, smem, (cudaStream_t)stream>>>(
      (const int*)blk, (const int*)nrows, (const int*)lids, (const int*)qids, (const float*)q, (const float*)qtab,
      (const __nv_bfloat16*)clut, (const float*)cents, (const uint8_t*)codes, (const uint8_t*)keep, (float*)out_s,
      (int*)out_p, Qg, d, m, ksub, kk, is_l2, nib, words, vec);
  return (int)cudaGetLastError();
}
