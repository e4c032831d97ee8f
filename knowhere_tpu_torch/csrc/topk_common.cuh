// Shared pieces of the IVF task-scan kernels: the result contract and the
// list block of every task scan (ivf_task_scan.cuh's four instances and
// ivf_adc.cu), and the warp selection of ivf_adc.cu's epilogue. The
// tensor-core task scans keep per-thread sorted lists over many 64-row
// chunks (ivf_task_scan.cuh); the ADC scan holds a query's whole 512-row
// block in one warp's registers at once and selects it with
// warp_topk_select.
//
// Result contract, kept from the TPU kernels (knowhere_tpu/ops/ivf_pallas.py):
// scores are larger-is-better, empty slots hold -1e38 with position -1, and
// among equal scores the leftmost column wins (_topk_rows, ivf_pallas.py:79).
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#define KW_NEG_INF (-1e38f)

namespace kw {

constexpr int kB = 512;  // rows per list block (LIST_ALIGN)

// Top-kk (kk <= 32) of one row of NJ * 32 scores held by a warp: lane l holds
// column l + 32 j in s[j]; positions are pos_base + column. Exact, under the
// contract above, in three steps:
//   1. tau = the kk-th largest of the 64 values that are each lane's two
//      best scores. At least kk scores reach tau, so every score of the
//      row's top-kk does.
//   2. The scores >= tau that are not the empty sentinel go, in column
//      order, to the warp's scratch: scores to cs, columns to cc (NJ * 32
//      entries each).
//   3. A candidate's rank is the number of candidates ahead of it (a larger
//      score, or an equal one to its left), and the candidate of rank r < kk
//      is output r. Slots past the candidates are empty.
// Few scores pass tau (kk to kk + kk / 8 on random scores), so the work is
// one read of the row plus a small rank; on a row of ties every score
// passes and the rank costs (NJ * 32)^2 / 32 compares a lane.
template <int NJ>
__device__ __forceinline__ void warp_topk_select(const float (&s)[NJ], int kk, int pos_base, float* cs,
                                                 uint16_t* cc, float* out_s, int* out_p) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float m1 = KW_NEG_INF, m2 = KW_NEG_INF;  // the lane's best and second best
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    m2 = fmaxf(m2, fminf(m1, s[j]));
    m1 = fmaxf(m1, s[j]);
  }
  int c1 = 0, c2 = 0;  // how many of the 64 values reach m1, m2
#pragma unroll 8
  for (int src = 0; src < 32; ++src) {
    const float a = __shfl_sync(full, m1, src), b = __shfl_sync(full, m2, src);
    c1 += (a >= m1) + (b >= m1);
    c2 += (a >= m2) + (b >= m2);
  }
  // the lane with the least value has 64 >= kk: some lane always qualifies
  float tau = c1 >= kk ? m1 : (c2 >= kk ? m2 : -INFINITY);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tau = fmaxf(tau, __shfl_xor_sync(full, tau, o));

  int n = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const bool take = s[j] >= tau && s[j] > KW_NEG_INF * 0.5f;
    const unsigned bal = __ballot_sync(full, take);
    if (take) {
      const int at = n + __popc(bal & ((1u << lane) - 1u));
      cs[at] = s[j];
      cc[at] = lane + 32 * j;
    }
    n += __popc(bal);
  }
  const int n4 = (n + 3) & ~3;  // padded for float4 reads: -inf neither leads nor ties
  if (lane < n4 - n) cs[n + lane] = -INFINITY;
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const float v = cs[i];
    int r = 0;
    for (int k = 0; k < n4; k += 4) {
      const float4 u = *reinterpret_cast<const float4*>(cs + k);
      r += (u.x > v) | ((u.x == v) & (k < i));
      r += (u.y > v) | ((u.y == v) & (k + 1 < i));
      r += (u.z > v) | ((u.z == v) & (k + 2 < i));
      r += (u.w > v) | ((u.w == v) & (k + 3 < i));
    }
    if (r < kk) {
      out_s[r] = v;
      out_p[r] = pos_base + cc[i];
    }
  }
  for (int r = n + lane; r < kk; r += 32) {
    out_s[r] = KW_NEG_INF;
    out_p[r] = -1;
  }
}

}  // namespace kw
