// The tensor-core IVF task scan for Hopper (sm_90a), shared by ivf_int8_scan
// and ivf_f32_scan (ivf_scan.cu), ivf_sq_scan (ivf_sq.cu) and ivf_rbq_scan
// (ivf_rbq.cu).
//
// A task is one aligned 512-row list block (blk[t], nrows[t] valid rows)
// against one pre-gathered group of Qg queries; the result is each query
// row's top-kk. The four scans differ only in where a list row comes from,
// what the query operand is and how a product becomes a score, so the
// kernel takes a row source Src with these members:
//
//   Query           the queries' element type. float: the f32 query rows
//                   are staged and converted by query_op, and the products
//                   are bf16 wgmma into f32 accumulators (chunk_product).
//                   int8_t: the i8 query rows go straight into the B
//                   operand by cp.async, and the products are s8 wgmma into
//                   s32 accumulators (chunk_product_s8), exact
//   kRowNorm        rs0 = |x|^2 of the staged rows (L2), summed from the
//                   parts rows_op returns; else row_side fills rs0 / rs1
//   kQuerySide      qside, a value per query row for the score: the sum of
//                   the parts query_op returns (f32 queries) or
//                   query_side(row) (i8 queries)
//   a_lo(three)     whether rows_op writes lo slices (the lo.hi pass)
//   stage(st, b, c, kc, d, tid)   cp.async of chunk (c, kc) of block b to
//                   the staging tile st, one commit group
//   load_aux(aux, t, kc, d, tid)  per-task, per-feature-chunk side values
//                   (plain loads, visible after the next barrier)
//   rows_op(st, xop, aux, three, tid) -> part   the staged chunk as the A
//                   operand (bf16 hi, and lo slices where a_lo)
//   query_op(qst, qop, aux, n, l2, three, tid) -> part   n staged f32 query
//                   rows as the B operand (hi, and lo where three)
//   query_side(i)   (i8 queries) the side value of query row i of q
//   row_side(rs0, rs1, g, r)      row r's side values from storage row g
//   score(acc, rs0, rs1, qside, l2)   the score of one product
//
// Orientation: list rows on wgmma's M axis (64 a chunk), the block's query
// rows on N. N then takes a query group exactly (32 or 64 a block; Qg = 128
// runs as two blocks), where M = 64 would pad a 32-query group to twice its
// work. A block's list rows stream through in 64-row chunks by cp.async into
// a staging tile and are converted (split, decoded, expanded or copied)
// while they move to the operand tile; the next chunk's copy runs under
// this chunk's products and selection. Chunks past nrows are never read,
// and an empty task (nrows = 0) writes its sentinels before any load.
// Features beyond the first 128 stream as further chunks (the queries are
// staged again for each).
//
// Epilogue: the accumulators go to a scores tile [query][row] in shared
// memory (over the operand tile, which the products no longer need), and
// P = 128 / N threads own each query row, each keeping a sorted list of its
// best KL >= kk (score, position) pairs in registers. The first chunk fills
// the list with one sorting network; after it a score enters only if it
// beats the list's last entry and is not below another part's list end
// (that part then holds KL >= kk better scores), so few do, and the
// insertion shifts the list branch-free. Positions reach a thread in
// increasing order, so the strict test keeps the leftmost column among equal
// scores. At the end one thread per row merges its P lists (larger score,
// then lower position first) into the row's kk outputs. The result contract
// is topk_common.cuh's. The four instances share this epilogue; the ADC scan
// (ivf_adc.cu) does not: it holds a query's whole block in one warp, so P
// would be 32, and with this merge of 32 lists it ran 2-3x as long as with
// topk_common.cuh's warp_topk_select (PERF.md).
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "topk_common.cuh"
#include "wgmma_common.cuh"

namespace kw {

constexpr int kXRows = 64;                     // list rows per chunk (wgmma M)
constexpr int kSStride = kXRows + 1;           // scores tile row stride
constexpr int kStageBytes = kXRows * kStageStride * 4;  // f32 staging tile (rows or queries)
constexpr int kXOpBytes = kXRows * 2 * kChunk * 2;      // 32 KB hi/lo operand
constexpr int kAuxFloats = 2 * kChunk;                  // a row source's side vectors
constexpr int kCodeStride = kChunk + 16;  // byte-row staging stride: conflict-free 16-byte reads

// chunk rows 0..63 of one-byte codes (row stride ld bytes), 128 bytes each,
// -> the staging tile st (row stride kCodeStride) by cp.async, one commit
// group; eight neighbouring threads read one row's 128 bytes
__device__ __forceinline__ void stage_code_rows(unsigned char* st, const uint8_t* src, size_t ld, int tid) {
  for (int i = tid; i < kXRows * (kChunk / 16); i += 128) {
    const int r = i / (kChunk / 16), c16 = i % (kChunk / 16);
    cp_async16(st + r * kCodeStride + 16 * c16, src + r * ld + 16 * c16);
  }
  cp_async_commit();
}

// n of N i8 query rows (row stride ld bytes), 128 features each, -> the s8
// B operand of an N-row tile at op by cp.async, one commit group; rows at or
// past n are zeros. Two neighbouring threads take one 32-byte sector of a
// row, and a warp's 16-byte writes fill whole 128-byte lines.
template <int N>
__device__ __forceinline__ void stage_s8_rows(unsigned char* op, const int8_t* src, size_t ld, int n, int tid) {
  for (int u = tid; u < N * (kChunk / 16); u += 128) {
    const int rest = u >> 1, r = rest % N, s = 2 * (rest / N) + (u & 1);
    unsigned char* dst = op + s * (N * 16) + r * 16;
    if (r < n)
      cp_async16(dst, src + r * ld + 16 * s);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

// sort M (score, position) pairs in registers: larger score first, then lower
// position (a bitonic network, fully unrolled)
template <int M>
__device__ __forceinline__ void sort_desc(float (&s)[M], int (&p)[M]) {
#pragma unroll
  for (int size = 2; size <= M; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const bool a_first = s[i] > s[j] || (s[i] == s[j] && p[i] < p[j]);
          if (((i & size) == 0) != a_first) {
            const float ts = s[i];
            s[i] = s[j];
            s[j] = ts;
            const int tp = p[i];
            p[i] = p[j];
            p[j] = tp;
          }
        }
      }
    }
  }
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// A block's shared memory: the staging tile, the row operand (later the
// scores tile, then the merge's lists), the query operand, then [128] row
// parts, [128] query parts, [64] rs0, [64] rs1, [64] ok, [128] list ends,
// aux, [N] query side values. An s8 source keeps one byte a feature in
// every tile (about 38 KB a block at N = 64, kk <= 16, against ~101 KB), so
// more blocks share an SM.
template <bool kS8, int N, int KL>
struct TaskScanSmem {
  static constexpr int kStage = kS8 ? kXRows * kCodeStride : kStageBytes;
  static constexpr int kXOp = kS8 ? cmax(cmax(kXRows * kChunk, N * kSStride * 4), KL * 128 * 8) : kXOpBytes;
  static constexpr int kQOp = kS8 ? N * kChunk : N * 2 * kChunk * 2;
  static constexpr size_t kBytes =
      (size_t)kStage + kXOp + kQOp + (2 * 128 + 3 * kXRows + 128 + kAuxFloats + N) * 4;
  static_assert(kStage % 128 == 0 && kXOp % 128 == 0, "operand tiles stay 128-byte aligned");
};

template <class Src, int N, int KL>
__global__ void __launch_bounds__(128)
    ivf_task_scan_kernel(const Src src, const int* __restrict__ blk, const int* __restrict__ nrows,
                         const typename Src::Query* __restrict__ q, const uint8_t* __restrict__ keep,
                         float* __restrict__ out_s, int* __restrict__ out_p, int Qg, int d, int kk, bool l2,
                         bool three) {
  static_assert(128 % N == 0, "N must divide the block's threads");
  constexpr bool kS8 = std::is_same<typename Src::Query, int8_t>::value;  // i8 queries, s8 products
  using Acc = typename std::conditional<kS8, int, float>::type;
  using Smem = TaskScanSmem<kS8, N, KL>;
  constexpr int P = 128 / N;           // threads per query row in the selection
  constexpr int kCols = kXRows / P;    // columns of a chunk each of them scans
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* st = smem;                                       // staging tile
  float* xst = reinterpret_cast<float*>(smem);                    // the same, as f32 query rows
  unsigned char* xop = smem + Smem::kStage;                       // row operand; then scores, lists
  unsigned char* qop = xop + Smem::kXOp;                          // query operand (N rows)
  float* part_s = reinterpret_cast<float*>(qop + Smem::kQOp);     // [128] rows_op parts
  float* qpart_s = part_s + 128;                                  // [128] query_op parts
  float* rs0 = qpart_s + 128;                                     // [64] the chunk's row side values
  float* rs1 = rs0 + kXRows;                                      // [64]
  float* ok_s = rs1 + kXRows;                                     // [64] 1 where the row is scored
  float* thr_s = ok_s + kXRows;                                   // [P][N] each list's last score
  float* aux = thr_s + 128;                                       // [kAuxFloats]
  float* qside = aux + kAuxFloats;                                // [N]
  float* sc = reinterpret_cast<float*>(xop);                      // [N][kSStride]

  const int t = blockIdx.x;
  const int q0 = blockIdx.y * N;
  const int nq = min(N, Qg - q0);
  const int n = nrows[t];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const size_t o0 = ((size_t)t * Qg + q0) * kk;
  if (n <= 0) {  // empty task: sentinels, no load
    for (int i = tid; i < nq * kk; i += 128) {
      out_s[o0 + i] = KW_NEG_INF;
      out_p[o0 + i] = -1;
    }
    return;
  }
  const int b = blk[t];
  const int kc_n = d / kChunk;
  const int n_chunks = (min(n, kB) + kXRows - 1) / kXRows;
  const typename Src::Query* gq = q + ((size_t)t * Qg + q0) * d;
  const bool a_lo = src.a_lo(three);

  // queries' feature chunk kc -> qop (f32: through xst), the source's side
  // values of chunk kc -> aux, the query side values -> qside
  auto stage_q = [&](int kc) {
    if constexpr (kS8) {  // no conversion: landed by the chunk loop's wait, fenced with the rows
      stage_s8_rows<N>(qop, gq + kc * kChunk, d, nq, tid);
      if (kc == 0 && tid < N) qside[tid] = tid < nq ? src.query_side((size_t)t * Qg + q0 + tid) : 0.f;
    } else {
      stage_rows<128>(xst, gq + kc * kChunk, d, N, nq, tid);
      src.load_aux(aux, t, kc, d, tid);
      cp_async_wait_all();
      __syncthreads();
      const float part = src.query_op(xst, qop, aux, N, l2, three, tid);
      if constexpr (Src::kQuerySide) qpart_s[tid] = part;
      __syncthreads();  // xst is free again
      if constexpr (Src::kQuerySide) {
        if (tid < N) {  // thread tid + p N took part p of row tid
          float s = 0.f;
#pragma unroll
          for (int p = 0; p < P; ++p) s += qpart_s[tid + p * N];
          qside[tid] = kc ? qside[tid] + s : s;
        }
      }
    }
  };

  float ls[KL];
  int lp[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    ls[j] = KW_NEG_INF;
    lp[j] = -1;
  }
  const int srow = tid % N, spart = tid / N;
  Acc acc[N / 2];
  if (kc_n == 1) {
    stage_q(0);
    src.stage(st, b, 0, 0, d, tid);
  }
  for (int c = 0; c < n_chunks; ++c) {
    for (int kc = 0; kc < kc_n; ++kc) {
      if (kc_n > 1) {
        __syncthreads();  // the last chunk's selection is done with the shared tiles
        stage_q(kc);
        src.stage(st, b, c, kc, d, tid);
      }
      cp_async_wait_all();
      __syncthreads();  // st holds chunk (c, kc); the last selection is done with xop
      // each thread's part of a row (rows = 64: thread tid holds row tid %
      // 64, half tid / 64)
      const float part = src.rows_op(st, xop, aux, three, tid);
      if (Src::kRowNorm && l2) part_s[tid] = part;
      fence_async_smem();
      __syncthreads();
      if (kc_n == 1 && c + 1 < n_chunks) src.stage(st, b, c + 1, 0, d, tid);
      if (tid < kXRows) {
        const int gr = c * kXRows + tid;
        if constexpr (Src::kRowNorm) {
          if (l2) rs0[tid] = (kc ? rs0[tid] : 0.f) + (part_s[tid] + part_s[tid + kXRows]);
        } else {
          if (kc == 0) src.row_side(rs0, rs1, (size_t)b * kB + gr, tid);
        }
        ok_s[tid] = (gr < n && (keep == nullptr || keep[(size_t)b * kB + gr] != 0)) ? 1.f : 0.f;
      }
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] = 0;
      }
      wgmma_fence();
      if constexpr (kS8)
        chunk_product_s8<N>(acc, smem_u32(xop), kXRows, smem_u32(qop));
      else
        chunk_product<N>(acc, smem_u32(xop), kXRows, smem_u32(qop), three, a_lo);
      wgmma_commit();
      wgmma_wait0();
    }
    __syncthreads();  // every warp is done reading xop; rs0 / rs1 / ok_s are written
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int r = 16 * w + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int qn = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const float v = src.score(acc[i], rs0[r], rs1[r], Src::kQuerySide ? qside[qn] : 0.f, l2);
      sc[qn * kSStride + r] = ok_s[r] != 0.f ? v : KW_NEG_INF;
    }
    __syncthreads();
    const int pos0 = b * kB + c * kXRows + spart * kCols;
    const float* row_sc = sc + srow * kSStride + spart * kCols;
    if (c == 0) {  // the first chunk fills the list by one sort
      float fs[kCols];
      int fp[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        fs[j] = row_sc[j];
        fp[j] = pos0 + j;
      }
      sort_desc<kCols>(fs, fp);
#pragma unroll
      for (int e = 0; e < KL && e < kCols; ++e) {
        ls[e] = fs[e];
        lp[e] = fp[e];
      }
    } else {
      // a score below another part's list end has KL >= kk better scores
      // in that part, so it cannot reach the row's top-kk
      float other = KW_NEG_INF;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (p != spart) other = fmaxf(other, thr_s[p * N + srow]);
      for (int j = 0; j < kCols; ++j) {
        const float v = row_sc[j];
        if (v > ls[KL - 1] && v >= other) {  // strict: an equal score to the left stays ahead
#pragma unroll
          for (int e = KL - 1; e > 0; --e) {
            const bool down = ls[e - 1] < v, here = ls[e] < v;
            lp[e] = down ? lp[e - 1] : (here ? pos0 + j : lp[e]);
            ls[e] = down ? ls[e - 1] : (here ? v : ls[e]);
          }
          if (ls[0] < v) {
            ls[0] = v;
            lp[0] = pos0 + j;
          }
        }
      }
    }
    thr_s[spart * N + srow] = ls[KL - 1];
  }
  // merge the P lists of each row: larger score first, then lower position
  __syncthreads();
  float* lsm = reinterpret_cast<float*>(xop);  // [KL][128]
  int* lpm = reinterpret_cast<int*>(xop + KL * 128 * 4);
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    lsm[j * 128 + tid] = ls[j];
    lpm[j * 128 + tid] = lp[j];
  }
  __syncthreads();
  if (tid >= nq) return;
  int h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) h[p] = 0;
  for (int o = 0; o < kk; ++o) {
    float bs = 0.f;
    int bp = INT_MAX, bi = -1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (h[p] >= KL) continue;
      const float s = lsm[h[p] * 128 + tid + p * N];
      const int ps = lpm[h[p] * 128 + tid + p * N];
      const unsigned psu = (unsigned)ps;  // empty slots (-1) order last among equal scores
      if (bi < 0 || s > bs || (s == bs && psu < (unsigned)bp)) {
        bs = s;
        bp = ps;
        bi = p;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) h[p] += (p == bi);
    out_s[o0 + (size_t)tid * kk + o] = bs;
    out_p[o0 + (size_t)tid * kk + o] = bs <= KW_NEG_INF * 0.5f ? -1 : bp;
  }
}

template <class Src, int N, int KL>
int launch_task_scan_nk(const Src& src, const void* blk, const void* nrows, const void* q, const void* keep,
                        void* out_s, void* out_p, int T, int Qg, int d, int kk, bool l2, bool three,
                        cudaStream_t s) {
  auto k = ivf_task_scan_kernel<Src, N, KL>;
  constexpr size_t smem = TaskScanSmem<std::is_same<typename Src::Query, int8_t>::value, N, KL>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(T, (Qg + N - 1) / N);
  k<<<grid, 128, smem, s>>>(src, (const int*)blk, (const int*)nrows, (const typename Src::Query*)q,
                           (const uint8_t*)keep, (float*)out_s, (int*)out_p, Qg, d, kk, l2, three);
  return (int)cudaGetLastError();
}

template <class Src, int N>
int launch_task_scan_n(const Src& src, const void* blk, const void* nrows, const void* q, const void* keep,
                       void* out_s, void* out_p, int T, int Qg, int d, int kk, bool l2, bool three,
                       cudaStream_t s) {
  if (kk <= 8) return launch_task_scan_nk<Src, N, 8>(src, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, l2, three, s);
  if (kk <= 16) return launch_task_scan_nk<Src, N, 16>(src, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, l2, three, s);
  return launch_task_scan_nk<Src, N, 32>(src, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, l2, three, s);
}

// q (T, Qg, d) of Src::Query with d a multiple of 128, kk <= 32; 32 queries
// a block for groups of at most 32, else 64
template <class Src>
int launch_task_scan(const Src& src, const void* blk, const void* nrows, const void* q, const void* keep,
                     void* out_s, void* out_p, int T, int Qg, int d, int kk, int is_l2, int three_pass,
                     void* stream) {
  if (T <= 0) return 0;
  if (kk < 1 || kk > 32 || Qg < 1 || d <= 0 || d % kChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (Qg <= 32)
    return launch_task_scan_n<Src, 32>(src, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, is_l2 != 0, three_pass != 0, s);
  return launch_task_scan_n<Src, 64>(src, blk, nrows, q, keep, out_s, out_p, T, Qg, d, kk, is_l2 != 0, three_pass != 0, s);
}

// the f32 query rows' operand: hi, and lo where three (ivf_f32_scan's and
// ivf_sq_scan's query_op)
__device__ __forceinline__ float split_queries(const float* qst, unsigned char* qop, int n, bool three, int tid) {
  split_rows<128>(qst, qop, n, n, 0, three, tid);
  return 0.f;
}

// the reference's score of a dot product: 2 dot - |x|^2 (L2) or dot (IP).
// No FMA contraction: the reference rounds the product, then subtracts.
__device__ __forceinline__ float dot_score(float acc, float nrm, bool l2) {
  return l2 ? __fsub_rn(__fmul_rn(2.f, acc), nrm) : acc;
}

}  // namespace kw
