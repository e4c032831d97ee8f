// Hopper building blocks shared by the tensor-core scans (flat_scan.cu and
// the IVF task scans of ivf_task_scan.cuh): wgmma on bf16 operands with f32
// accumulators and on s8 operands with s32 accumulators, the shared memory
// descriptors they read, mbarriers with bulk (TMA) copies, cp.async (which
// the ADC scan, ivf_adc.cu, also takes), and the three-pass hi/lo product of
// the reference.
//
// Operand layout (K-major, no swizzle). A tile of R rows x 256 bf16 holds
// one 128-feature chunk as [hi: 16 slices of 8 | lo: 16 slices of 8]; slice
// s of row r sits at byte s * (R * 16) + r * 16, so each 8 x 8 core matrix
// is 128 contiguous bytes, the next 8 rows follow at +128 (SBO) and the next
// 8 features at +R * 16 (LBO). ops/cuda_flat.py's split_operand writes the
// same image of FLAT's queries from PyTorch (query_operand_hi the hi slices
// alone, the single pass's 16-slice image); the kernels write their f32
// rows' image while staging them (stage_rows, then split_rows). An s8 tile
// has the same byte geometry with 16 i8 features a slice: a chunk is 8
// slices, R x 128 bytes.
//
// The product is the reference's (knowhere_tpu/ops/pallas_flat.py:85,
// ivf_pallas.py:143-152): hi = bf16(x), lo = bf16(x - hi), and
//   <x, q> ~= x_hi.q_hi + x_hi.q_lo + x_lo.q_hi
// with every bf16 x bf16 product exact in f32 and summed in f32 (one
// accumulator for the three passes: a depth-3d product over [x_hi | x_hi |
// x_lo] . [q_hi | q_lo | q_hi]). Not TF32: it keeps ~10 mantissa bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace kw {

constexpr int kChunk = 128;        // features per operand chunk
constexpr int kSlices = kChunk / 8;  // 8-feature slices per half (hi or lo)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: start address, LBO (next 8 features) and
// SBO (next 8 rows) in 16-byte units, no swizzle (layout type 0).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// generic-proxy shared-memory writes -> visible to wgmma / bulk copies
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// D (64 x N, f32, registers) += A (64 x 16) . B (N x 16)^T, both K-major in
// shared memory. Thread t of the warpgroup holds D[r][c] in d[i] with
// r = 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), c = 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 32) wgmma_m64n32(d, a, b);
  else if constexpr (N == 64) wgmma_m64n64(d, a, b);
  else wgmma_m64n128(d, a, b);
}

// D (64 x N, s32, registers) += A (64 x 32) . B (N x 32)^T on s8 operands,
// both K-major in shared memory: every product and sum is exact. The integer
// forms take only scale-d (no scale or transpose immediates). D's fragment
// layout is the f32 form's.
__device__ __forceinline__ void wgmma_m64n32_s8(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64_s8(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// One 128-feature chunk of the product into acc: a_addr / b_addr are the
// shared addresses of this warpgroup's A rows (64 of a_rows) and of B (N
// rows), each laid out as described above. The hi.hi pass always runs (the
// reference's single bf16 pass); b_lo adds hi.lo, a_lo adds lo.hi (both: the
// three passes; b_lo alone: two, where A is exact in bf16). The caller
// fences (wgmma_fence) before and commits / waits after.
template <int N>
__device__ __forceinline__ void chunk_product(float (&acc)[N / 2], uint32_t a_addr, int a_rows,
                                              uint32_t b_addr, bool b_lo, bool a_lo) {
  const uint32_t a_lbo = a_rows * 16, b_lbo = N * 16;
  const uint32_t a_lo_addr = a_addr + kSlices * a_lbo, b_lo_addr = b_addr + kSlices * b_lbo;
#pragma unroll
  for (int j = 0; j < kSlices / 2; ++j) {  // k16 steps: two slices each
    const uint32_t ao = 2 * j * a_lbo, bo = 2 * j * b_lbo;
    wgmma_tile<N>(acc, make_desc(a_addr + ao, a_lbo, 128), make_desc(b_addr + bo, b_lbo, 128));
    if (b_lo) wgmma_tile<N>(acc, make_desc(a_addr + ao, a_lbo, 128), make_desc(b_lo_addr + bo, b_lbo, 128));
    if (a_lo) wgmma_tile<N>(acc, make_desc(a_lo_addr + ao, a_lbo, 128), make_desc(b_addr + bo, b_lbo, 128));
  }
}

// One 128-feature chunk of an s8 product into acc: the same byte geometry
// as above (a slice is 16 bytes, here 16 i8 features, so a chunk is 8
// slices and 4 k32 steps), no lo slices. The caller fences before and
// commits / waits after.
template <int N>
__device__ __forceinline__ void chunk_product_s8(int (&acc)[N / 2], uint32_t a_addr, int a_rows, uint32_t b_addr) {
  static_assert(N == 32 || N == 64, "s8 tiles of 32 or 64 columns");
  const uint32_t a_lbo = a_rows * 16, b_lbo = N * 16;
#pragma unroll
  for (int j = 0; j < kChunk / 32; ++j) {  // k32 steps: two slices each
    const uint64_t a = make_desc(a_addr + 2 * j * a_lbo, a_lbo, 128), b = make_desc(b_addr + 2 * j * b_lbo, b_lbo, 128);
    if constexpr (N == 32) wgmma_m64n32_s8(acc, a, b);
    else wgmma_m64n64_s8(acc, a, b);
  }
}

// bf16 hi part and bf16 lo residual of 8 f32 values, as two 16-byte slices
// (the reference's split: lo = bf16(x - f32(bf16(x))))
__device__ __forceinline__ void split8(const float4 v0, const float4 v1, uint4& hi, uint4& lo) {
  const float x[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  __nv_bfloat16 h[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = __float2bfloat16_rn(x[i]);
    l[i] = __float2bfloat16_rn(__fsub_rn(x[i], __bfloat162float(h[i])));
  }
  hi = *reinterpret_cast<const uint4*>(h);
  lo = *reinterpret_cast<const uint4*>(l);
}

// bf16 of 8 f32 values (round to nearest even) as one 16-byte slice: the
// single pass's operand
__device__ __forceinline__ uint4 hi8(const float4 v0, const float4 v1) {
  const float x[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  __nv_bfloat16 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(x[i]);
  return *reinterpret_cast<const uint4*>(h);
}

// ---- cp.async (16 bytes a thread; 4 where the rows are not 16-aligned) --
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// ---- f32 rows -> the hi/lo operand image, through a staging tile ---------
constexpr int kStageStride = kChunk + 4;  // staging row stride (floats): conflict-free float4 reads

// rows x 128 f32 features of src (row stride ld floats) -> the staging tile
// xst by cp.async, one commit group; rows at or past `valid` are zeros.
// kNT threads take part.
template <int kNT>
__device__ __forceinline__ void stage_rows(float* xst, const float* src, size_t ld, int rows, int valid, int tid) {
  for (int i = tid; i < rows * (kChunk / 4); i += kNT) {
    const int r = i / (kChunk / 4), c4 = i % (kChunk / 4);
    float* dst = xst + r * kStageStride + 4 * c4;
    if (r < valid)
      cp_async16(dst, src + r * ld + 4 * c4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
}

// The staged rows (landed: after cp_async_wait_all and a barrier) -> rows
// row0 .. row0 + rows - 1 of the operand image of a tile_rows-row tile at op:
// the hi slices, and the lo slices when `lo`. Returns the sum of squares of
// the values this thread split (with kNT = 2 rows, thread t takes half t /
// rows of staged row t % rows). The caller fences (fence_async_smem) and
// syncs before wgmma reads op.
template <int kNT>
__device__ __forceinline__ float split_rows(const float* xst, unsigned char* op, int rows, int tile_rows, int row0,
                                            bool lo, int tid) {
  float part = 0.f;
  for (int u = tid; u < rows * kSlices; u += kNT) {
    const int r = u % rows, g = u / rows;
    const float4 v0 = *reinterpret_cast<const float4*>(xst + r * kStageStride + 8 * g);
    const float4 v1 = *reinterpret_cast<const float4*>(xst + r * kStageStride + 8 * g + 4);
    part = fmaf(v0.x, v0.x, part); part = fmaf(v0.y, v0.y, part);
    part = fmaf(v0.z, v0.z, part); part = fmaf(v0.w, v0.w, part);
    part = fmaf(v1.x, v1.x, part); part = fmaf(v1.y, v1.y, part);
    part = fmaf(v1.z, v1.z, part); part = fmaf(v1.w, v1.w, part);
    uint4 h, l;
    split8(v0, v1, h, l);
    *reinterpret_cast<uint4*>(op + g * (tile_rows * 16) + (row0 + r) * 16) = h;
    if (lo) *reinterpret_cast<uint4*>(op + (kSlices + g) * (tile_rows * 16) + (row0 + r) * 16) = l;
  }
  return part;
}

// ---- mbarriers and bulk (TMA) copies -------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of parity `phase`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from global to shared, completing on bar
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace kw
