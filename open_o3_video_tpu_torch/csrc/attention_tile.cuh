// Shared building blocks of the attention kernels: K1's general route (row
// widths other than 64 and 128; parts serve K2, K5, K6 and K1's row
// kernels) runs a 64-query-row CTA of four warps that walks the keys in
// 64-row tiles staged in shared memory, and computes
//
//     p = exp(min(s, 60))   (0 where masked)      l += sum(p)
//     acc += bf16(p) @ v                           out = acc / (l == 0 ? 1 : l)
//
// with bf16 mma.sync.m16n8k16 products accumulated in f32. This is the
// fixed-m inference softmax of the JAX package's Pallas kernels: no running
// max, so no rescale of acc or l between key tiles. p <= e^60 keeps l and acc
// far from f32 overflow; p is cast to bf16 (not fp16, whose range e^60
// exceeds) before the PV product, as the Pallas kernels cast it to v's dtype.
// A row whose every key is masked has l == 0 and writes 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace o3v {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;        // query rows per CTA (16 per warp)
constexpr int kKeys = 64;        // keys per shared-memory tile
constexpr int kThreads = 128;    // four warps
constexpr int kPad = 8;          // row padding (bf16) against bank conflicts
constexpr float kClamp = 60.0f;  // fixed-m softmax logit clamp

template <int D>
using Tile = bf16[kKeys][D + kPad];

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// Four 8x8 b16 matrices from shared memory; lane i gives the shared-space
// address of row i % 8 of matrix i / 8. TRANS: each matrix transposed.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  ldsm_x4<TRANS>(r, static_cast<uint32_t>(__cvta_generic_to_shared(p)));
}

// Copy `rows` rows [r0, r0 + rows) of a strided bf16 matrix (row i at
// src + i * row_stride, D contiguous values) into a shared array of row pitch
// D + kPad (a Tile by default), 16 bytes per thread per step over a block of
// THREADS threads; rows at or past n_rows are zero-filled.
template <int D, int THREADS = kThreads>
__device__ __forceinline__ void load_tile(bf16 (*dst)[D + kPad], const bf16* src,
                                          long long row_stride, int r0, int n_rows,
                                          int rows = kKeys) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += THREADS) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// A fragments of this warp's 16 query rows (rows 16*warp .. +15 of the tile).
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[D / 16][4], const Tile<D>& sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld_u32(&sq[r][kk * 16 + 2 * t]);
    qa[kk][1] = ld_u32(&sq[r + 8][kk * 16 + 2 * t]);
    qa[kk][2] = ld_u32(&sq[r][kk * 16 + 2 * t + 8]);
    qa[kk][3] = ld_u32(&sq[r + 8][kk * 16 + 2 * t + 8]);
  }
}

// One key tile for this warp's 16 query rows (K1). Each thread owns rows g
// and g + 8 (half 0 and 1) of the warp's slice. A key is visible where its
// segment id is that of the row: key_tag[c] != 0 && key_tag[c] ==
// row_tag[half]. s is multiplied by `scale`.
template <int D>
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[D / 16][4], const Tile<D>& sk,
                                            const Tile<D>& sv, const int* key_tag,
                                            const int (&row_tag)[2], float scale,
                                            float (&acc)[D / 8][4], float (&l)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kN = kKeys / 8;  // n-tiles of the score block
  float s[kN][4];
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* krow = &sk[nt * 8 + g][kk * 16 + 2 * t];
      mma_16816(s[nt], qa[kk], ld_u32(krow), ld_u32(krow + 8));
    }
  }
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = nt * 8 + 2 * t + (e & 1);
      const int half = e >> 1;
      const int tag = key_tag[c];
      const bool ok = tag != 0 && tag == row_tag[half];
      const float p = ok ? expf(fminf(s[nt][e] * scale, kClamp)) : 0.f;
      l[half] += p;
      s[nt][e] = p;
    }
  }
#pragma unroll
  for (int kt = 0; kt < kKeys / 16; ++kt) {
    const uint32_t pa[4] = {
        pack_bf16x2(s[2 * kt][0], s[2 * kt][1]), pack_bf16x2(s[2 * kt][2], s[2 * kt][3]),
        pack_bf16x2(s[2 * kt + 1][0], s[2 * kt + 1][1]),
        pack_bf16x2(s[2 * kt + 1][2], s[2 * kt + 1][3])};
    const int r = kt * 16 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + g;
      mma_16816(acc[dt], pa, ld_pair(&sv[r][col], &sv[r + 1][col]),
                ld_pair(&sv[r + 8][col], &sv[r + 9][col]));
    }
  }
}

// acc / l for this thread's two rows, stored as bf16 pairs. `out_row(i)`
// points at the first of the D outputs of tile row i; rows past n_rows are
// not stored.
template <int D, typename RowPtr>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float (&l)[2],
                                           int q0, int n_rows, RowPtr out_row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + 8 * half;
    if (row >= n_rows) continue;
    const float denom = l[half] == 0.f ? 1.f : l[half];
    bf16* o = out_row(row);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(o + dt * 8 + 2 * t) =
          pack_bf16x2(acc[dt][2 * half] / denom, acc[dt][2 * half + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Training (exact-softmax) building blocks, shared by the exact forwards and
// the backward kernels.

// The JAX package's finite mask value, -0.7 * FLT_MAX: exp(NEG_INF - m) is 0
// for any finite m, and a fully masked row never produces inf - inf.
constexpr float kNegInf = -0.7f * 3.402823466e38f;

// Mask kinds. CAUSAL: the decoder (row tag = query position, -1 for a pad
// query; key tag = kv validity). SEGMENT: the ViT's exact softmax (tags are
// segment ids; a key past the row width has tag -1, a query row past it -2).
// A pad query (id 0) sees no key, so its scores are all NEG_INF and the max-
// subtracted softmax of the JAX kernels attends uniformly over the row's W
// keys: modelled as score 0 on every key of the row.
enum MaskKind { kCausal = 0, kSegment = 1 };

template <int MODE>
__device__ __forceinline__ bool visible(int row_tag, int key_tag, int key) {
  if (MODE == kCausal) return key_tag != 0 && key <= row_tag;
  return row_tag == 0 ? key_tag >= 0 : key_tag == row_tag;
}

template <int MODE>
__device__ __forceinline__ float score(float s, int row_tag, float s_scale) {
  return (MODE == kSegment && row_tag == 0) ? 0.f : s * s_scale;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// As load_tile, for one head's q or k slice rotated by the per-row cos/sin
// tables (rows of D floats, row i at cos + i * D) in f32 and rounded to
// bf16: y = x * cos + rotate_half(x) * sin, rotate_half([x1, x2]) =
// [-x2, x1]. Explicit _rn intrinsics keep the compiler from contracting into
// an FMA, so the rounding matches the plain version op for op.
template <int D>
__device__ __forceinline__ void load_rope_tile(bf16 (*dst)[D + kPad], const bf16* src,
                                               long long row_stride, const float* cos,
                                               const float* sin, int r0, int n_rows) {
  constexpr int kVec = D / 8, kHalf = D / 2;
  for (int i = threadIdx.x; i < kKeys * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows) {
      const bf16* row = src + (r0 + r) * row_stride;
      const uint4 xv = *reinterpret_cast<const uint4*>(row + c);
      const uint4 pv = *reinterpret_cast<const uint4*>(row + (c < kHalf ? c + kHalf : c - kHalf));
      const float* cr = cos + static_cast<long long>(r0 + r) * D + c;
      const float* sr = sin + static_cast<long long>(r0 + r) * D + c;
      const bf16* x = reinterpret_cast<const bf16*>(&xv);
      const bf16* partner = reinterpret_cast<const bf16*>(&pv);
      bf16* y = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = __bfloat162float(partner[j]);
        const float rot = c < kHalf ? -pj : pj;
        y[j] = __float2bfloat16_rn(
            __fadd_rn(__fmul_rn(__bfloat162float(x[j]), cr[j]), __fmul_rn(rot, sr[j])));
      }
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = packed;
  }
}

// s[nt] = A(16 rows of this warp) @ B^T over D, for NT n-tiles of 8 columns:
// A rows come from a (row pitch D + kPad) shared array at row a_row0 (the
// warp's 16 rows), B rows (the columns of s) from b at rows nt * 8 + g.
template <int D, int NT>
__device__ __forceinline__ void scores_smem(float (&s)[NT][4], bf16 (*a)[D + kPad],
                                            int a_row0, bf16 (*b)[D + kPad]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t af[4] = {ld_u32(&a[a_row0 + g][kk * 16 + 2 * t]),
                            ld_u32(&a[a_row0 + g + 8][kk * 16 + 2 * t]),
                            ld_u32(&a[a_row0 + g][kk * 16 + 2 * t + 8]),
                            ld_u32(&a[a_row0 + g + 8][kk * 16 + 2 * t + 8])};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* brow = &b[nt * 8 + g][kk * 16 + 2 * t];
      mma_16816(s[nt], af, ld_u32(brow), ld_u32(brow + 8));
    }
  }
}

// acc += bf16(x) @ B, x the C fragments of a 16 x (8 * NT) block held by
// this warp (NT even), B rows (the contraction index) from b, row pitch
// D + kPad: the PV-style product.
template <int D, int NT>
__device__ __forceinline__ void accumulate_xb(float (&acc)[D / 8][4], const float (&x)[NT][4],
                                              bf16 (*b)[D + kPad]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt) {
    const uint32_t xa[4] = {pack_bf16x2(x[2 * kt][0], x[2 * kt][1]),
                            pack_bf16x2(x[2 * kt][2], x[2 * kt][3]),
                            pack_bf16x2(x[2 * kt + 1][0], x[2 * kt + 1][1]),
                            pack_bf16x2(x[2 * kt + 1][2], x[2 * kt + 1][3])};
    const int r = kt * 16 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + g;
      mma_16816(acc[dt], xa, ld_pair(&b[r][col], &b[r + 1][col]),
                ld_pair(&b[r + 8][col], &b[r + 9][col]));
    }
  }
}

// Store this warp's 16 x D f32 fragments times `scale` as bf16 rows:
// out_row(i) points at tile row i's D outputs; rows >= n_rows are skipped.
template <int D, typename RowPtr>
__device__ __forceinline__ void store_frags(const float (&acc)[D / 8][4], float scale, int row0,
                                            int n_rows, RowPtr out_row) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= n_rows) continue;
    bf16* o = out_row(row);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(o + dt * 8 + 2 * t) =
          pack_bf16x2(acc[dt][2 * half] * scale, acc[dt][2 * half + 1] * scale);
  }
}

constexpr int kSmemMax = 232448;  // the dynamic shared memory a block may have (H100)

// Launch helper for kernels that need more than 48 KB of shared memory.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace o3v
