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
// Design (one block of 8 warps, two warpgroups, per task; two blocks an
// SM, so registers are capped at 128), on the frame of the task scans
// (ivf_task_scan.cuh): an empty task (nrows = 0) writes its sentinels
// before any load, and nothing past nrows is read or scored. The task's
// code rows below nrows go to shared memory by cp.async (row stride padded
// to an odd number of words, so the 32 rows a warp reads at one subspace
// hit 32 banks), the rest of the last 32-row slab is zeroed, and whole slabs
// past nrows are skipped by a warp-uniform bound; the list's clut row goes
// beside them.
//
// Queries go in groups of G = 16, two a warp. A group's LUT is
// built a chunk of subspaces at a time on the tensor cores, as the TPU
// kernel builds it on its matrix unit (q_hi @ books_bd and q_lo @ books_bd,
// ivf_pallas.py:587-593): one bf16 wgmma with f32 accumulators a 64-row
// slab, M on codewords, N = 2G on the group's queries (f * hi rows, then f *
// lo rows: f = 2 is exact in bf16, and hi and lo keep accumulators of their
// own, as the reference sums them apart before adding), K on a subspace's
// features padded to 16 (one k16 step for SIFT's sub = 8 and GIST's sub =
// 10). A slab is 64 codewords of one subspace for ksub >= 64; for a smaller
// ksub it holds 64 / ksub subspaces block-diagonally, as the TPU's books_bd
// does (the nibble layout: four subspaces of 16 codewords). The A fragments
// come from the bf16 books in device memory straight into registers (no
// padded image is staged or stored: a thread's pair of K columns is one
// aligned bf16x2 of a codeword, or zero); B, the queries' chunk, is written
// to shared memory as the wgmma operand image while the previous chunk's
// lookups run. The epilogue of an entry is f32 hi + lo, minus clut (L2), and
// the bf16 rounding, two entries packed into one 32-bit store.
//
// The tensor cores add a sum's products in another order than a sequential
// FMA chain, and not rounded to nearest at each add, so where an entry lies
// near a bf16 rounding midpoint the two may round it apart: by a whole bf16
// unit of the entry, which the score's cancellation (x = 2 q.b - clut)
// makes large beside a small score. The epilogue tests each entry of
// magnitude 2 or more against a window around the midpoint
// (near_bf16_midpoint: a heuristic, not a bound) and a thread writes the
// few it finds again from the sequential order (fix_marked,
// sequential_entry: about 1 entry in 1,650 on the real IVF_PQ launch), the
// order the plain version's f32 products gave on every case measured; the
// smaller entries may keep the other rounding, one bf16 unit, at most 2^-7.
//
// The LUT chunk is laid out in query pairs (a word holds one codeword of
// queries 2p and 2p + 1), so a warp's lookups read two queries' entries
// with one load; the row stride is padded so that the epilogue's stores hit
// 32 banks. Each warp adds its queries' lookups into 16 register
// accumulators a query per lane (lane l owns rows l + 32 i), one code read
// serving all of them; the lookups are unrolled over the slabs below nrows
// (lookup_slabs picks the instance), so a subspace's reads issue together,
// and each row sums its subspaces in ascending order. The scores never
// leave registers before the epilogue, topk_common.cuh's warp_topk_select,
// one query of each warp at a time, whose scratch lies over the operand
// image and the LUT once every warp is done with the group's lookups.
//
// What bounds it on the H100: the LUT is 2 * 2 * Qg * m * ksub * sub bf16
// operations a task (16.8 M at the SIFT shape Qg=128, m=16, ksub=256,
// sub=8; 17 us of the card's tensor-core peak over the whole real launch),
// the lookups Qg * nrows * m <= 1 M shared-memory reads, and the epilogue
// Qg * m * ksub entries; device memory is at most 8 KB of codes a task. So
// the issue of the lookups, the epilogue and the selection, and the latency
// of each batch of products, not the tensor cores or the bytes, set the
// pace (PERF.md).

#include <cuda_bf16.h>

#include "topk_common.cuh"
#include "wgmma_common.cuh"

namespace kw {

constexpr int kAdcWarps = 8;                 // warps per task block
constexpr int kAdcThreads = kAdcWarps * 32;
constexpr int kAdcQPW = 2;                   // queries a warp scores: one LUT word holds both
constexpr int kAdcG = kAdcWarps * kAdcQPW;   // queries per group: the wgmma's N is 2G (hi, lo)
constexpr int kAdcNJ = kB / 32;              // rows a lane scores: lane + 32 j
constexpr int kAdcLutBytes = 32 * 1024;      // LUT chunk of one group, bf16 (before padding)
constexpr int kAdcSelBytes = kAdcWarps * kB * 6;  // warp_topk_select's scratch, every warp
constexpr int kAdcMinBlocks = 2;             // blocks an SM (__launch_bounds__): 128 registers a thread
constexpr int kAdcImgRows = 2 * kAdcG;       // operand image rows: f hi and f lo of each query

// shared-memory row stride of the code block: bytes, an odd number of words
__host__ __device__ __forceinline__ int adc_code_stride(int mb) {
  int w = (mb + 3) / 4;
  if (w % 2 == 0) w += 1;
  return 4 * w;
}

// Geometry of the LUT's products (host and device):
//   kr: slab rows a subspace takes (ksub rounded up to a power of two, at
//       most 64); P = 64 / kr subspaces a slab; S = ceil(ksub / 64) slabs a
//       subspace;
//   KS: the K depth of a slab, the features of its P subspaces padded to
//       16;
//   MC: subspaces a chunk (a multiple of P), nbg = MC / P slab columns of
//       the operand image a chunk (B tiles of 2G rows x KS);
//   PS: words per query pair of the LUT chunk (MC * ksub, rounded to 32 and
//       8 more, so that the 4 pairs of an epilogue store hit 4 bank octets).
struct AdcGeom {
  int kr, lkr, P, S, KS, MC, nbg, PS;
  __host__ __device__ AdcGeom(int m, int ksub, int sub) {
    kr = 1;
    lkr = 0;
    while (kr < ksub && kr < 64) {
      kr <<= 1;
      ++lkr;
    }
    P = 64 / kr;
    S = (ksub + 63) / 64;
    KS = (P * sub + 15) / 16 * 16;
    const int mp = (m + P - 1) / P * P;
    MC = kAdcLutBytes / (kAdcG * ksub * 2) / P * P;
    if (MC < P) MC = P;
    if (MC > mp) MC = mp;
    nbg = MC / P;
    PS = (MC * ksub + 31) / 32 * 32 + 8;
  }
  __host__ __device__ size_t image_bytes() const { return (size_t)nbg * KS * kAdcImgRows * 2; }
  __host__ __device__ size_t lut_bytes() const { return (size_t)(kAdcG / 2) * PS * 4; }
  __host__ __device__ size_t window_bytes() const { return ((size_t)MC * 4 + 15) / 16 * 16; }
};

// the front of shared memory: the operand image of a chunk's queries, the
// group's LUT chunk and the chunk's windows [MC] (chunk_image), while a group's
// products and lookups run; the selection's scratch, [8][kB] f32 scores and
// [8][kB] u16 columns, over them
__host__ __device__ __forceinline__ size_t adc_front_bytes(const AdcGeom& g) {
  const size_t f = g.image_bytes() + g.lut_bytes() + g.window_bytes();
  return ((f > (size_t)kAdcSelBytes ? f : (size_t)kAdcSelBytes) + 15) / 16 * 16;
}

// the task's clut row, bf16 [m * ksub]
__host__ __device__ __forceinline__ size_t adc_clut_bytes(int m, int ksub) {
  return ((size_t)m * ksub * 2 + 15) / 16 * 16;
}

// the front, then the code block [kB][stride] and the clut row
__host__ __device__ __forceinline__ size_t adc_smem_bytes(int m, int ksub, int sub, int mb) {
  return adc_front_bytes(AdcGeom(m, ksub, sub)) + (size_t)kB * adc_code_stride(mb) + adc_clut_bytes(m, ksub);
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

// 32-bit shared-memory addresses (the LUT build keeps no generic pointers)
__device__ __forceinline__ void sts_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_u16(uint32_t a, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "h"(v) : "memory");
}
__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ uint4 lds_u128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a) : "memory");
  return v;
}
// half h (0: low) of a bf16x2 word, as f32
__device__ __forceinline__ float bf16_half(uint32_t w, int h) { return __uint_as_float(h ? w & 0xFFFF0000u : w << 16); }

// the bf16 at shared address a, as f32
__device__ __forceinline__ float lds_bf16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a) : "memory");
  return __uint_as_float((uint32_t)v << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// D (64 x N, f32) += A (64 x 16, bf16, registers) . B (N x 16, K-major in
// shared memory)^T. A's fragment: warp w of the warpgroup holds rows 16 w ..
// 16 w + 15; a[0] = (row r, cols c, c + 1), a[1] = (r + 8, c, c + 1), a[2] =
// (r, c + 8, c + 9), a[3] = (r + 8, c + 8, c + 9) with r = 16 w + lane / 4,
// c = 2 (lane % 4). D's layout is wgmma_m64n32's (wgmma_common.cuh). With
// accumulate false, D = A . B^T (D's old values are not read).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, bool accumulate) {
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate));
  } else {
    static_assert(N == 64, "wgmma_rs takes N = 8, 16, 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate));
  }
}

// Columns k, k + 1 (k even, k < 16) of a slab row at slab place i whose
// codeword starts at row (a bf16 pointer): column k is feature k mod sub of
// place k / sub. For an even SUB the two columns are one aligned bf16x2 of
// the codeword's feature k mod SUB, loaded whatever the row's place (the
// caller zeroes the pair where pair_used is false); for other widths each
// column is loaded, or zero, here.
template <int SUB>
__device__ __forceinline__ uint32_t books_pair(const __nv_bfloat16* row, int i, int k, int sub) {
  if constexpr (SUB > 0 && SUB % 2 == 0) {
    return *reinterpret_cast<const unsigned int*>(row + k % SUB);
  } else {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
    uint32_t out = 0u;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ip = (k + e) / sub;
      if (ip == i) out |= (uint32_t)r[k + e - ip * sub] << (16 * e);
    }
    return out;
  }
}

template <int SUB>
__device__ __forceinline__ bool pair_used(int i, int k) {
  if constexpr (SUB > 0 && SUB % 2 == 0) return k / SUB == i;
  return true;
}

// The operand image of the group's queries for the chunk of subspaces j0 ..
// jend - 1: for slab column bl (subspaces j0 + bl P ..), slice s8 (K columns
// 8 s8 .. 8 s8 + 7) and operand row n, 16 bytes at img + bl * KS * 2G * 2 +
// s8 * 2G * 16 + n * 16 (wgmma_common.cuh's K-major layout). Row n < G is
// query n's f * hi, row G + n its f * lo; column k holds feature k mod sub of
// subspace j0 + bl P + k / sub, zero past the slab's subspaces and for
// queries past nq. Also qn[jj] = 2^-22 max_n |f q_nj| max_v |b_jv| (q_nj:
// query n's features of subspace j = j0 + jj; b_jv its codewords, L2 norms),
// the window of near_bf16_midpoint for the rows of j. The caller fences
// (fence_async_smem) and syncs before a wgmma reads the image.
template <int SUB>
__device__ __forceinline__ void chunk_image(unsigned char* img, float* qn, const AdcGeom& g, const float* gq,
                                            const __nv_bfloat16* books, int nq, int d, int j0, int jend, int ksub,
                                            int sub, float f, int tid) {
  constexpr int G = kAdcG, N = kAdcImgRows;
  const int ns8 = g.KS / 8;
  for (int u = tid; u < g.nbg * ns8 * N; u += kAdcThreads) {
    const int n = u % N, s8 = (u / N) % ns8, bl = u / (N * ns8);
    const int qi = n < G ? n : n - G;
    __nv_bfloat16 h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 8 * s8 + e, ip = k / sub;
      const int J = j0 + bl * g.P + ip;
      float v = 0.f;
      if (ip < g.P && J < jend && qi < nq) {
        const float x = gq[(size_t)qi * d + J * sub + (k - ip * sub)];
        const float hi = __bfloat162float(__float2bfloat16_rn(x));
        v = n < G ? hi : __bfloat162float(__float2bfloat16_rn(__fsub_rn(x, hi)));
      }
      h[e] = __float2bfloat16_rn(f * v);  // f = 2 or 1: exact
    }
    *reinterpret_cast<uint4*>(img + (size_t)bl * g.KS * N * 2 + s8 * N * 16 + n * 16) =
        *reinterpret_cast<const uint4*>(h);
  }
  const int warp = tid >> 5, lane = tid & 31;
  for (int jj = warp; jj < g.MC; jj += kAdcWarps) {  // a warp a subspace: lanes over queries, then codewords
    const int J = j0 + jj;
    if (J >= jend) {
      if (lane == 0) qn[jj] = 0.f;
      continue;
    }
    float qm = 0.f, bm = 0.f;
    for (int n = lane; n < nq; n += 32) {
      float ss = 0.f;
      for (int s = 0; s < sub; ++s) {
        const float x = f * gq[(size_t)n * d + J * sub + s];
        ss = fmaf(x, x, ss);
      }
      qm = fmaxf(qm, ss);
    }
    for (int v = lane; v < ksub; v += 32) {
      const __nv_bfloat16* r = books + ((size_t)J * ksub + v) * sub;
      float ss = 0.f;
      for (int s = 0; s < sub; ++s) {
        const float x = __bfloat162float(r[s]);
        ss = fmaf(x, x, ss);
      }
      bm = fmaxf(bm, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qm = fmaxf(qm, __shfl_xor_sync(0xffffffffu, qm, o));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
    }
    if (lane == 0) qn[jj] = sqrtf(qm) * sqrtf(bm) * 0x1p-22f;
  }
}

// An entry x = y - clut of magnitude 2 or more, y = f * (hi + lo) from the
// tensor cores, that lies within w = 2^-22 a of the midpoint between its two
// bf16 neighbours, a = max_n |f q_nj| max_v |b_jv| >= f * sum_s |hi_s b_s|
// (Cauchy-Schwarz; the largest norms of the group's queries and of the
// subspace's codewords). A heuristic, not a bound: a sequential FMA chain
// may stray up to about (sub - 1) 2^-24 sum_s |p_s| from the exact sum,
// wider than w where a query and a codeword are nearly parallel and sub >=
// 5; a is several times sum_s |hi_s b_s| on most entries, and the chip
// check holds the result to the plain version on the real IVF_PQ launch.
// Below 2 the two roundings may differ by one bf16 unit, at most 2^-7.
__device__ __forceinline__ bool near_bf16_midpoint(float x, float w) {
  const float mid = __uint_as_float((__float_as_uint(x) & 0xFFFF0000u) | 0x8000u);
  return fabsf(x) >= 2.f && fabsf(__fsub_rn(x, mid)) <= w;
}

// f * (hi + lo) of one LUT entry (query n, subspace j0 + jj, codeword v) in
// the sequential order: two FMA chains in ascending feature, from the
// chunk's operand image, then one add; for the entries
// near_bf16_midpoint finds (fix_marked); where a subspace is whole 8-feature
// slices, 16 bytes at a time.
template <int SUB>
__device__ __forceinline__ float sequential_entry(uint32_t img, const AdcGeom& g,
                                                  const __nv_bfloat16* books, int j0, int jj, int v, int n, int ksub,
                                                  int sub_rt) {
  constexpr int N = kAdcImgRows;
  const int sub = SUB > 0 ? SUB : sub_rt;
  const int bl = jj / g.P, i = jj - bl * g.P;
  const uint32_t col = img + (uint32_t)(bl * g.KS * N * 2);
  const __nv_bfloat16* b = books + ((size_t)(j0 + jj) * ksub + v) * sub;
  float hi = 0.f, lo = 0.f;
  if constexpr (SUB > 0 && SUB % 8 == 0) {
    if (g.P == 1) {  // the subspace's features are whole 8-feature slices: 16-byte loads
#pragma unroll
      for (int s8 = 0; s8 < SUB / 8; ++s8) {
        const uint4 bw = *reinterpret_cast<const uint4*>(b + 8 * s8);
        const uint4 hw = lds_u128(col + s8 * N * 16 + n * 16);
        const uint4 lw = lds_u128(col + s8 * N * 16 + (kAdcG + n) * 16);
        const uint32_t bv[4] = {bw.x, bw.y, bw.z, bw.w}, hv[4] = {hw.x, hw.y, hw.z, hw.w},
                       lv[4] = {lw.x, lw.y, lw.z, lw.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) {  // feature q: half q % 2 of word q / 2
          const float bs = bf16_half(bv[q >> 1], q & 1);
          hi = fmaf(bf16_half(hv[q >> 1], q & 1), bs, hi);
          lo = fmaf(bf16_half(lv[q >> 1], q & 1), bs, lo);
        }
      }
      return __fadd_rn(hi, lo);
    }
  }
#pragma unroll 1
  for (int s = 0; s < sub; ++s) {
    const int k = i * sub + s;
    const uint32_t at = col + (k >> 3) * N * 16 + (k & 7) * 2;
    const float bs = __bfloat162float(b[s]);
    hi = fmaf(lds_bf16(at + n * 16), bs, hi);
    lo = fmaf(lds_bf16(at + (kAdcG + n) * 16), bs, lo);
  }
  return __fadd_rn(hi, lo);
}

// the image column of slab sl: sl / S, without a division for S = 1, 2, 4
__device__ __forceinline__ int slab_col(int sl, int S) {
  return S == 4 ? sl >> 2 : S == 1 ? sl : S == 2 ? sl >> 1 : sl / S;
}

// Per-thread state of a chunk's LUT build.
struct AdcLutCtx {
  uint32_t lut, qn, img;  // shared addresses: the LUT chunk, the windows, the operand image
  int steps, ps4, q0;       // q0: this thread's first LUT word, (lane % 4) * PS
  int r0;                   // this thread's first fragment row, 16 (warp % 4) + lane / 4 (and r0 + 8)
};

// Columns k, k + 1 of a slab row at place i (any k: the steps past the
// first, KS > 16).
__device__ __forceinline__ uint32_t books_pair_at(const __nv_bfloat16* row, int i, int k, int sub) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t out = 0u;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int ip = (k + e) / sub;
    if (ip == i) out |= (uint32_t)r[k + e - ip * sub] << (16 * e);
  }
  return out;
}

// One slab sl of the chunk's LUT (image column bl = sl / S, codewords
// (sl mod S) * 64 .. of its subspaces; the thread's fragment row r = r0 + 8 e
// is subspace j0 + bl P + r / kr, codeword r mod kr of them). Its A
// fragments (the bf16 books) times the image's f hi and f lo rows go into
// accumulators of 2G columns (hi products, then lo). The epilogue stores
// each entry as bf16(f hi + f lo - clut) (no clut for IP) at word (query
// pair) * PS + (j - j0) * ksub + v, half (query & 1), and returns a bit for
// each entry near a bf16 rounding midpoint (bit e * G / 4 + (i / 4) * 2 + h:
// row e, column 8 (i / 4) + 2 (lane % 4) + h).
template <int SUB>
__device__ __forceinline__ unsigned lut_slab(int sl, const AdcLutCtx& x, const AdcGeom& g, const __nv_bfloat16* books,
                                             const __nv_bfloat16* clut_l, int j0, int jend, int ksub, int sub, bool l2,
                                             int lane) {
  constexpr int G = kAdcG, N = kAdcImgRows;
  const int ri[2] = {x.r0 >> g.lkr, (x.r0 + 8) >> g.lkr}, rv[2] = {x.r0 & (g.kr - 1), (x.r0 + 8) & (g.kr - 1)};
  const int bl = slab_col(sl, g.S), jb = j0 + bl * g.P, vb = (sl - bl * g.S) * 64;
  const uint32_t base = x.img + (uint32_t)(bl * g.KS * N * 2);
  uint32_t a[4];
  int word[2];          // the row's LUT word (j - j0) * ksub + v, -1 for padding
  float cl[2], win[2];  // the row's clut and its near_bf16_midpoint window
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int J = jb + ri[e], v = vb + rv[e];
    const bool ok = v < ksub && J < jend;
    word[e] = ok ? (J - j0) * ksub + v : -1;
    const int at = ok ? J * ksub + v : j0 * ksub;  // a padding row reads codeword 0 of subspace j0
    cl[e] = l2 ? __bfloat162float(clut_l[at]) : 0.f;
    win[e] = __uint_as_float(lds_u32(x.qn + 4 * (ok ? J - j0 : 0)));
    const __nv_bfloat16* row = books + (size_t)at * sub;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * h + 2 * (lane & 3);
      a[e + 2 * h] = ok && pair_used<SUB>(ri[e], k) ? books_pair<SUB>(row, ri[e], k, sub) : 0u;
    }
  }
  float acc[G];
  wgmma_fence();
  wgmma_rs<N>(acc, a, make_desc(base, N * 16, 128), false);
  wgmma_commit();
  for (int t = 1; t < x.steps; ++t) {  // K past 16 (sub > 16, or ksub < 64 with P * sub > 16)
    wgmma_wait0();
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      const int e = xx & 1;
      const __nv_bfloat16* row = books + ((size_t)j0 * ksub + word[e]) * sub;
      a[xx] = word[e] >= 0 ? books_pair_at(row, ri[e], 16 * t + 8 * (xx >> 1) + 2 * (lane & 3), sub) : 0u;
    }
    wgmma_fence();
    wgmma_rs<N>(acc, a, make_desc(base + t * 2 * N * 16, N * 16, 128), true);
    wgmma_commit();
  }
  wgmma_wait0();
  unsigned marks = 0u;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (word[e] < 0) continue;
#pragma unroll
    for (int i = 2 * e; i < G / 2; i += 4) {  // cols 8 (i / 4) + 2 (lane % 4) + {0, 1}; lo at + G
      const float x0 = __fsub_rn(__fadd_rn(acc[i], acc[i + G / 2]), cl[e]);
      const float x1 = __fsub_rn(__fadd_rn(acc[i + 1], acc[i + 1 + G / 2]), cl[e]);
      marks |= (unsigned)(near_bf16_midpoint(x0, win[e]) | near_bf16_midpoint(x1, win[e]) << 1)
               << (e * (G / 4) + (i >> 2) * 2);
      const __nv_bfloat162 p = __floats2bfloat162_rn(x0, x1);
      sts_u32(x.lut + 4 * (x.q0 + word[e] + (i >> 2) * x.ps4), *reinterpret_cast<const uint32_t*>(&p));
    }
  }
  return marks;
}

// The entries of slab sl that lut_slab marked, each written again from the
// sequential order (sequential_entry).
template <int SUB>
__device__ __forceinline__ void fix_marked(unsigned mk, int sl, const AdcLutCtx& x, const AdcGeom& g,
                                           const __nv_bfloat16* books, const __nv_bfloat16* clut_l, int j0, int ksub,
                                           int sub, bool l2, int lane) {
  constexpr int G = kAdcG;
  const int bl = slab_col(sl, g.S);
  while (mk) {
    const int bit = __ffs(mk) - 1;
    mk &= mk - 1u;
    const int e = bit / (G / 4), i4 = (bit % (G / 4)) >> 1, h = bit & 1;
    const int r = x.r0 + 8 * e, jj = bl * g.P + (r >> g.lkr), v = (sl - bl * g.S) * 64 + (r & (g.kr - 1));
    const int n = 8 * i4 + 2 * (lane & 3) + h;
    const float cl = l2 ? __bfloat162float(clut_l[(j0 + jj) * ksub + v]) : 0.f;
    const float y = sequential_entry<SUB>(x.img, g, books, j0, jj, v, n, ksub, sub);
    const __nv_bfloat16 xr = __float2bfloat16_rn(__fsub_rn(y, cl));
    sts_u16(x.lut + 4 * (x.q0 + jj * ksub + v + i4 * x.ps4) + 2 * h, *reinterpret_cast<const unsigned short*>(&xr));
  }
}

// The group's LUT chunk of subspaces j0 .. jend - 1 on the tensor cores:
// warpgroup wg takes slabs wg, wg + 2, ...; after each slab a thread writes
// again, in the sequential order, its entries near a bf16 rounding midpoint.
template <int SUB>
__device__ __forceinline__ void chunk_lut(uint32_t* lut, const float* qn, const unsigned char* img, const AdcGeom& g,
                                          const __nv_bfloat16* books, const __nv_bfloat16* clut_l, int j0, int jend,
                                          int ksub, int sub, bool l2, int warp, int lane) {
  AdcLutCtx x;
  x.lut = smem_u32(lut);
  x.qn = smem_u32(qn);
  x.img = smem_u32(img);
  x.steps = g.KS / 16;
  x.ps4 = 4 * g.PS;
  x.q0 = (lane & 3) * g.PS;
  x.r0 = 16 * (warp & 3) + (lane >> 2);
  const int nsl = ((jend - j0 + g.P - 1) / g.P) * g.S;  // slabs of the chunk
  for (int sl = warp >> 2; sl < nsl; sl += 2) {
    const unsigned mk = lut_slab<SUB>(sl, x, g, books, clut_l, j0, jend, ksub, sub, l2, lane);
    if (mk) fix_marked<SUB>(mk, sl, x, g, books, clut_l, j0, ksub, sub, l2, lane);
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

// SUB = sub_dim known at compile time; 0 reads it from sub_rt (that
// instance, whose index arithmetic takes more registers, is not held to
// kAdcMinBlocks blocks an SM). words: the code rows are copied as 4-byte
// words (mb % 4 == 0, codes 4-byte aligned)
template <int SUB>
__global__ void __launch_bounds__(kAdcThreads, SUB > 0 ? kAdcMinBlocks : 1)
    ivf_adc_scan_kernel(const int* __restrict__ blk, const int* __restrict__ nrows,
                        const int* __restrict__ lids, const float* __restrict__ q,
                        const __nv_bfloat16* __restrict__ books,
                        const __nv_bfloat16* __restrict__ clut, const float* __restrict__ cents,
                        const uint8_t* __restrict__ codes, const uint8_t* __restrict__ keep,
                        float* __restrict__ out_s, int* __restrict__ out_p, int Qg, int d, int m,
                        int ksub, int sub_rt, int kk, int is_l2, int nib, int words) {
  constexpr int QPW = kAdcQPW, G = kAdcG;
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
  const AdcGeom geo(m, ksub, sub);
  const bool l2 = is_l2 != 0;
  const float f = l2 ? 2.f : 1.f;
  extern __shared__ __align__(128) unsigned char smem_adc[];
  unsigned char* img = smem_adc;                                          // the chunk's operand image
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem_adc + geo.image_bytes());  // [G / 2][PS] words
  float* qn = reinterpret_cast<float*>(smem_adc + geo.image_bytes() + geo.lut_bytes());  // [MC]
  float* sel_s = reinterpret_cast<float*>(smem_adc);                      // [8][kB], over the above
  uint16_t* sel_c = reinterpret_cast<uint16_t*>(sel_s + kAdcWarps * kB);   // [8][kB]
  uint8_t* cs = smem_adc + adc_front_bytes(geo);                          // [kB][cstride]
  unsigned char* clut_s = cs + (size_t)kB * cstride;                      // [m * ksub] bf16

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
  // the list's clut row beside them: the LUT epilogue reads it from here
  if (l2) stage_bytes(clut_s, clut + (size_t)lid * m * ksub, (size_t)m * ksub * 2, tid);
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
  const __nv_bfloat16* clut_l = reinterpret_cast<const __nv_bfloat16*>(clut_s);
  const float* gq = q + (size_t)t * Qg * d;
  const int mask = nib ? 15 : 255;
  // this warp's queries g0 + 2 warp + qi; their pair's LUT words
  const uint32_t* lw = lut + warp * geo.PS;

  for (int g0 = 0; g0 < Qg; g0 += G) {
    __syncthreads();  // the previous group's selection is done with the front
    const int nq = min(G, Qg - g0);
    chunk_image<SUB>(img, qn, geo, gq + (size_t)g0 * d, books, nq, d, 0, min(geo.MC, m), ksub, sub, f, tid);
    fence_async_smem();
    const int row0 = g0 + warp * QPW;  // this warp's first query (warp-uniform)
    float acc[QPW][kAdcNJ];
#pragma unroll
    for (int qi = 0; qi < QPW; ++qi)
#pragma unroll
      for (int j = 0; j < kAdcNJ; ++j) acc[qi][j] = 0.f;

    for (int j0 = 0; j0 < m; j0 += geo.MC) {
      const int jend = min(j0 + geo.MC, m);
      cp_async_wait_all();  // the code rows and the clut (first chunk of the first group)
      __syncthreads();      // they and the chunk's image are in place; the previous chunk's lookups are done
      chunk_lut<SUB>(lut, qn, img, geo, books, clut_l, j0, jend, ksub, sub, l2, warp, lane);
      __syncthreads();  // the chunk's LUT is in place; the image is read
      if (jend < m) {       // the next chunk's image, under this chunk's lookups
        chunk_image<SUB>(img, qn, geo, gq + (size_t)g0 * d, books, nq, d, jend, min(jend + geo.MC, m), ksub, sub, f, tid);
        fence_async_smem();
      }
      if (row0 < Qg)
        lookup_slabs<kAdcNJ>(jn, acc, lw, cs, cstride, j0, jend - j0, ksub, mb, mask, lane);
    }
    __syncthreads();  // every warp is done with the LUT: the selection takes the front
#pragma unroll
    for (int qi = 0; qi < QPW; ++qi) {
      const int row = row0 + qi;
      if (row >= Qg) break;
      float qc = 0.f;  // <q, c>, here rather than with the group's start: no register through the LUT
      for (int k = lane; k < d; k += 32) qc = fmaf(gq[(size_t)row * d + k], cent[k], qc);
      qc = warp_sum(qc);
      const float base = l2 ? __fsub_rn(__fmul_rn(2.f, qc), cc) : qc;
#pragma unroll
      for (int j = 0; j < kAdcNJ; ++j) acc[qi][j] = (ok >> j) & 1u ? __fadd_rn(base, acc[qi][j]) : KW_NEG_INF;
      const size_t o = ((size_t)t * Qg + row) * kk;
      warp_topk_select<kAdcNJ>(acc[qi], kk, b * kB, sel_s + warp * kB, sel_c + warp * kB, out_s + o, out_p + o);
      __syncwarp();  // the next query reuses the warp's scratch
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

// ops/adc_cuda.adc_smem_bytes mirrors adc_smem_bytes (chip_smoke.py holds
// the two equal through kw_ivf_adc_smem_bytes): the search takes this kernel
// only for shapes whose shared memory fits a block.
extern "C" int kw_ivf_adc_smem_bytes(int m, int ksub, int sub, int nib) {
  return (int)adc_smem_bytes(m, ksub, sub, nib ? m / 2 : m);
}

extern "C" int kw_ivf_adc_scan(const void* blk, const void* nrows, const void* lids,
                               const void* q, const void* books, const void* clut,
                               const void* cents, const void* codes, const void* keep,
                               void* out_s, void* out_p, int T, int Qg, int d, int m, int ksub,
                               int sub, int kk, int is_l2, int nib, void* stream) {
  if (T <= 0) return 0;
  if (kk < 1 || kk > 32 || m < 1 || sub < 1 || m * sub > d || d % 4 != 0 || ksub < 1 ||
      ksub > 256 || (nib && (ksub != 16 || m % 2 != 0)) || reinterpret_cast<uintptr_t>(books) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int mb = nib ? m / 2 : m;
  const size_t smem = adc_smem_bytes(m, ksub, sub, mb);
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
