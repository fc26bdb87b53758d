// Hopper's warpgroup matrix multiply (wgmma, sm_90a), shared by K7's prefill
// route (int4_matmul_sm90.cu), K3 (flash_attention.cu) and K5's dq
// (flash_attention_bwd.cu): shared-memory descriptors of tiles in the
// 128-byte swizzle that TMA writes, the fence/commit/wait of the
// asynchronous products, the two m64n128k16 bf16 products (A from shared
// memory, or from registers) and m64n64k16 (both from shared memory).
#pragma once

#include <stdint.h>

namespace o3v {
namespace wg {

// Descriptor of a K-major tile in the 128-byte swizzle: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO), base 1024-aligned. A k16 step of a
// bf16 tile starts 32 bytes further along the row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Descriptor of an MN-major tile in the 128-byte swizzle (a B operand whose
// N index is contiguous, e.g. V read as keys x head_dim): 64 N values (128
// bytes) per row, rows = the K index, 8-row groups 1024 bytes apart (SBO);
// the next 64 N values lie `mn_stride` bytes further (LBO). A k16 step
// starts 16 rows (2048 bytes) further.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr, uint32_t mn_stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((mn_stride >> 4) & 0x3FFF) << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for a register A operand (P of attention): the products read it
// until they are awaited.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define O3V_WG_D64                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),             \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),             \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),             \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),             \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),             \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),             \
      "+f"(d[62]), "+f"(d[63])
#define O3V_WG_R64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "          \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "            \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "            \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// d (64 x 128 f32, this thread's 64) = (accumulate ? d : 0) + A @ B; A and B
// K-major bf16 from shared memory. d[4 nt + j] is row 16 warp + lane/4 +
// 8 (j >> 1), column 8 nt + 2 (lane % 4) + (j & 1) of the warpgroup's tile.
__device__ __forceinline__ void m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " O3V_WG_R64
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : O3V_WG_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A @ B with A (64 x 16 bf16) from registers, in the layout of an
// mma.sync m16n8k16 A fragment per warp (a[0]: row lane/4, columns 2 (lane
// % 4) + {0, 1}; a[1]: row + 8; a[2], a[3]: columns + 8), and B MN-major
// (transposed) from shared memory.
__device__ __forceinline__ void m64n128k16_rs_mn(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " O3V_WG_R64
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : O3V_WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define O3V_WG_D32                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define O3V_WG_R32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "          \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// As m64n128k16 with N = 64: d (64 x 64 f32, this thread's 32), d[4 nt + j]
// at row 16 warp + lane/4 + 8 (j >> 1), column 8 nt + 2 (lane % 4) + (j & 1).
__device__ __forceinline__ void m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " O3V_WG_R32
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : O3V_WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef O3V_WG_D64
#undef O3V_WG_R64
#undef O3V_WG_D32
#undef O3V_WG_R32

}  // namespace wg
}  // namespace o3v
