// Shared pieces of the IVF task-scan kernels: the result contract and block
// geometry of every task scan (ivf_task_scan.cuh, ivf_adc.cu), and the warp
// top-k of the CUDA-core ADC scan (ivf_adc.cu).
//
// Result contract, kept from the TPU kernels (knowhere_tpu/ops/ivf_pallas.py):
// scores are larger-is-better, empty slots hold -1e38 with position -1, and
// among equal scores the leftmost column wins (_topk_rows, ivf_pallas.py:79).
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#define KW_NEG_INF (-1e38f)

namespace kw {

constexpr int kB = 512;      // rows per list block (LIST_ALIGN)
constexpr int kNJ = kB / 32;  // columns a lane holds: c = lane + 32 * j
constexpr int kWarps = 8;     // warps per task block
constexpr int kThreads = kWarps * 32;

// Top-kk of one query row held by a whole warp: lane owns the scores of
// columns lane + 32 * j (j < NJ) in s[]. kk rounds of (warp max, leftmost
// column among the maxima, mask) -- the same passes as _topk_rows. Lane 0
// writes kk (score, position) pairs; positions are pos_base + column, or -1
// where the score is the empty sentinel.
template <int NJ>
__device__ __forceinline__ void warp_topk_row(float (&s)[NJ], int kk, int pos_base,
                                              float* out_s, int* out_p) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < kk; ++r) {
    float m = s[0];
    int mj = 0;
#pragma unroll
    for (int j = 1; j < NJ; ++j) {
      if (s[j] > m) {  // strict: the smallest j (leftmost column) wins ties
        m = s[j];
        mj = j;
      }
    }
    float wm = m;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
    int col = (m == wm) ? (lane + 32 * mj) : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) col = min(col, __shfl_xor_sync(0xffffffffu, col, o));
    if (lane == (col & 31)) {
      const int jm = col >> 5;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j == jm) s[j] = KW_NEG_INF;  // unrolled: s[] stays in registers
    }
    if (lane == 0) {
      out_s[r] = wm;
      out_p[r] = (wm <= KW_NEG_INF * 0.5f) ? -1 : pos_base + col;
    }
  }
}

}  // namespace kw
