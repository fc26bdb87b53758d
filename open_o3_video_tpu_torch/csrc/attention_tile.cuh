// Shared building blocks of the three attention kernels (window, fused
// rope+window, causal GQA flash): a 64-query-row CTA of four warps walks the
// keys in 64-row tiles staged in shared memory, and computes
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

// Copy rows [r0, r0 + kKeys) of a strided bf16 matrix (row i at
// src + i * row_stride, D contiguous values) into a shared tile, 16 bytes per
// thread per step; rows at or past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(Tile<D>& dst, const bf16* src,
                                          long long row_stride, int r0, int n_rows) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kKeys * kVec; i += kThreads) {
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

// One key tile for this warp's 16 query rows. Each thread owns rows g and
// g + 8 (half 0 and 1) of the warp's slice. The mask is
//   CAUSAL:  key_tag[c] != 0 && k0 + c <= row_tag[half]     (kv validity, position)
//   else:    key_tag[c] != 0 && key_tag[c] == row_tag[half] (segment ids)
// s is multiplied by `scale` (1.0 for the prescaled causal kernel, exact).
template <int D, bool CAUSAL>
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[D / 16][4], const Tile<D>& sk,
                                            const Tile<D>& sv, const int* key_tag, int k0,
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
      const bool ok = CAUSAL ? (tag != 0 && k0 + c <= row_tag[half])
                             : (tag != 0 && tag == row_tag[half]);
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

}  // namespace o3v
