// The membership test of one step of both graph walks, for Hopper (sm_90a):
// the inline walk (ops/graph_inline.py beam_search_inline) and the general
// walk (ops/graph.py beam_search: HNSW over bf16 / fp16 rows or under
// 100,000 rows, Add after build, DISKANN and AISAQ, SHARDED_HNSW's
// non-inline shards), both through ops/graph.py fresh_step.
//
// graph_fresh replaces no TPU kernel: the JAX walks
// (knowhere_tpu/ops/graph.py, graph_inline.py) run this step as XLA ops, and
// the port ran it as torch ops that write, each step, an (nq, G, V) bool tensor
// for the visited ring, an (nq, G, ef) one for the beam and three (nq, G, G)
// ones for the dedup, each read back once by a reduction, for an answer of
// one bit a candidate. It was added for that cost: about half of the HNSW
// cell's device time.
//
// Per query row, with nbrs (G,) the step's candidate ids (-1: a masked
// parent), visited (V,) the row's visited ids and bids (ef,) the beam's:
//     fresh[j]  = nbrs[j] >= 0, nbrs[j] not in visited, not in bids, and
//                 (dedup, beam width W > 1) no column i < j holds the same
//                 id (equal ids are fresh alike, so the first keeps it)
//     visited[off + j] = fresh[j] ? nbrs[j] : -1       (the ring slot)
//     scores[j]        = -inf where not fresh[j]       (in place)
//     new_p[j]         = fresh[j] ? nbrs[j] << 1 : -1
// With W = 1 there is no dedup: a repeated id of one adjacency row stays
// fresh twice, as in the torch step.
//
// What bounds it on the H100: a row reads 4 (G + V + ef) bytes of ids and 4G
// of scores and writes 13G bytes: 51.4 MB a step at the HNSW cell's shape
// (10,240 rows, G 192, V 200, ef 48), 15 us at 3.35 TB/s. Its G (V + ef) +
// G (G - 1) / 2 integer compares a row (0.68 G a step there) come from
// shared memory, four ids a 16-byte load that every thread of the warp reads
// at the same address (a broadcast), so they cost about as much as the bytes.
//
// Design: one block a query row, one thread a candidate column (blocks of at
// most 256 threads loop over tiles of columns). The row's visited and beam
// ids are staged in shared memory kChunk ids at a time (one chunk at the
// cell's V + ef = 248) and each thread stops at its first match; the dedup
// stages the row's earlier candidates the same way. The ring slot is part
// of what every tile reads, so it is written after a barrier that follows
// the last tile.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace kw {

constexpr int kFreshChunk = 1024;     // ids staged in shared memory at a time (4 KB)
constexpr int kFreshMaxThreads = 256;

// ids [c0, c0 + n) of a (na ids) followed by b into buf, padded with -1 to
// a multiple of 4 (-1 matches no candidate that is compared)
__device__ __forceinline__ void stage_ids(int* buf, const int* a, int na, const int* b, int c0, int n) {
  const int n4 = (n + 3) & ~3;
  for (int x = threadIdx.x; x < n4; x += blockDim.x) {
    const int g = c0 + x;
    buf[x] = x >= n ? -1 : (g < na ? a[g] : b[g - na]);
  }
}

__global__ void graph_fresh_kernel(const int* __restrict__ nbrs, int* __restrict__ visited,
                                   const int* __restrict__ bids, float* __restrict__ scores,
                                   unsigned char* __restrict__ fresh, int* __restrict__ new_p, int G, int V, int E,
                                   int off, int dedup) {
  __shared__ int4 buf4[kFreshChunk / 4];
  int* buf = reinterpret_cast<int*>(buf4);
  const size_t r = blockIdx.x;
  const int* nb = nbrs + r * G;
  int* vis = visited + r * V;
  const int* bi = bids + r * E;
  const int S = V + E;
  for (int t0 = 0; t0 < G; t0 += blockDim.x) {
    const int j = t0 + threadIdx.x;
    const int id = j < G ? nb[j] : -1;
    bool out = id < 0;  // -1 is never fresh
    for (int c0 = 0; c0 < S; c0 += kFreshChunk) {
      const int n = min(kFreshChunk, S - c0);
      __syncthreads();
      stage_ids(buf, vis, V, bi, c0, n);
      __syncthreads();
      for (int x = 0; x < (n + 3) / 4 && !out; ++x) {
        const int4 v = buf4[x];
        out = v.x == id || v.y == id || v.z == id || v.w == id;
      }
    }
    if (dedup) {  // the earlier columns of the row, up to the tile's last
      const int last = min(G, t0 + (int)blockDim.x) - 1;
      for (int c0 = 0; c0 < last; c0 += kFreshChunk) {
        const int n = min(kFreshChunk, last - c0);
        __syncthreads();
        stage_ids(buf, nb, G, nb, c0, n);
        __syncthreads();
        const int m = min(n, j - c0);
        int x = 0;
        for (; x + 4 <= m && !out; x += 4) {
          const int4 v = buf4[x / 4];
          out = v.x == id || v.y == id || v.z == id || v.w == id;
        }
        for (; x < m && !out; ++x) out = buf[x] == id;
      }
    }
    if (j < G) {
      const size_t o = r * G + j;
      fresh[o] = !out;
      if (out) scores[o] = -CUDART_INF_F;
      new_p[o] = out ? -1 : (int)((unsigned)id << 1);
    }
  }
  __syncthreads();  // every tile has read the ring: its slot may change now
  for (int j = threadIdx.x; j < G; j += blockDim.x) vis[off + j] = fresh[r * G + j] ? nb[j] : -1;
}

}  // namespace kw

// nbrs (nq, G) int32, visited (nq, V) int32 (slot [off, off + G) written),
// bids (nq, E) int32, scores (nq, G) f32 (masked in place), fresh (nq, G)
// bool, new_p (nq, G) int32; all contiguous.
extern "C" int kw_graph_fresh(const void* nbrs, void* visited, const void* bids, void* scores, void* fresh,
                              void* new_p, int nq, int G, int V, int E, int off, int dedup, void* stream) {
  if (nq <= 0 || G <= 0) return 0;
  if (E < 0 || off < 0 || off + G > V) return (int)cudaErrorInvalidValue;
  const int threads = min(kw::kFreshMaxThreads, (G + 31) / 32 * 32);
  kw::graph_fresh_kernel<<<nq, threads, 0, (cudaStream_t)stream>>>(
      (const int*)nbrs, (int*)visited, (const int*)bids, (float*)scores, (unsigned char*)fresh, (int*)new_p, G, V,
      E, off, dedup);
  return (int)cudaGetLastError();
}

// the ids a block stages in shared memory at a time
extern "C" int kw_graph_fresh_chunk_ids() { return kw::kFreshChunk; }
