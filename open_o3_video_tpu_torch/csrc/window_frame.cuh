// Whole frames of the ViT's whole-frame blocks, as K2 (csrc/window_attention.cu)
// and K6's global-block backward (csrc/window_attention_bwd.cu) take them on
// Hopper: Qwen2.5-VL's 4 global blocks (W = 448 tokens at 18x24 patches, 16
// heads of 80), and every block of the towers without windows (Qwen2-VL, 16
// heads of 80; Qwen3-VL, 16 heads of 72).
//
// A CTA serves one (frame, head). A producer warp brings two of the
// frame-head's (W, D) slices (K and V, or q and dout) by TMA in 64-row
// tiles of kPitch<D> columns: D + 8 = 88 at D = 80 (176-byte rows, so the
// ldmatrix loads of the mma.sync fragments are conflict-free; the 8 columns
// past the head are the next head's or, past the last, zeros that nothing
// reads), D itself at D = 72 (144-byte rows are conflict-free as they are,
// and the box holds the head's columns alone). Rows past W are zero-filled.
// Where both slices fit in shared memory (W <= 640 for K2 at D = 80, 768 at
// D = 72) they stay resident, tile i in slot i on its own mbarrier, each
// loaded once; wider frames stream through a ring of up to kRing slots
// (full and empty mbarriers, one arrive per consumer warp), and the
// frame-head's strips of 16 rows are spread over several CTAs. Consumer
// warps each take 16 rows (a strip) and walk the tiles in 32-row halves
// with bf16 mma.sync m16n8k16, f32 accumulation. Where D is not a multiple
// of 16 (72 = 4.5 steps of 16), the scores take the last 8 columns by one
// m16n8k8 and the PV product the last 8-wide d-tile by its own ldmatrix, so
// no product reads a column past the head.
#pragma once

#include "async_copy.cuh"
#include "attention_tile.cuh"

namespace o3v {
namespace frame {

constexpr int kRing = 8;                       // tile slots when a frame streams
constexpr int kAlign = 128;                    // TMA destinations: 128-byte aligned
constexpr int kHalf = kKeys / 2;               // rows per step: a tile in two halves
constexpr int kHalfN = kHalf / 8;              // 8-row n-tiles of a half
constexpr float kLog2e = 1.4426950408889634f;

// Row pitch (bf16) of a frame tile: the rows an ldmatrix reads must start
// in 8 distinct 16-byte bank groups, i.e. the pitch must be an odd number of
// 16-byte units: D where D * 2 bytes already is (D = 72), else D + 8 (D = 80,
// where FTile<80> is attention_tile.cuh's Tile<80>).
template <int D>
constexpr int kPitch = (D / 8) % 2 ? D : D + kPad;
template <int D>
using FTile = bf16[kKeys][kPitch<D>];
// 16-column steps of a row of D: the last is half full where D % 16 == 8.
template <int D>
constexpr int kKSteps = (D + 15) / 16;

template <int D>
constexpr int kTileBytes = static_cast<int>(sizeof(FTile<D>));

// Shared memory of a CTA: `slots` tiles of each of its two slices, `words`
// 4-byte words for each of the frame's `tiles` * 64 rows (tags, and lse
// and delta in K6's dk/dv), and 2 * slots mbarriers (resident: one per tile;
// streaming: full and empty of each slot), after the alignment slack.
template <int D>
constexpr int smem(int tiles, int slots, int words) {
  return kAlign + 2 * slots * kTileBytes<D> + words * tiles * kKeys * 4 + 2 * slots * 8;
}

// How a frame of width w runs: resident (one CTA per frame-head, `ring` ==
// `tiles` slots) where it fits, else streamed through `ring` slots by `ctas`
// CTAs of `warps` strips each. smem 0: w too wide even to stream.
struct Plan {
  bool resident;
  int tiles, ring, ctas, smem;
};

template <int D>
inline Plan plan(int w, int warps, int words) {
  const int tiles = (w + kKeys - 1) / kKeys, strips = (w + 15) / 16;
  Plan p{true, tiles, tiles, 1, smem<D>(tiles, tiles, words)};
  if (p.smem <= kSmemMax) return p;
  p.resident = false;
  p.ring = kRing;
  while (p.ring > 2 && smem<D>(tiles, p.ring, words) > kSmemMax) --p.ring;
  p.smem = smem<D>(tiles, p.ring, words) <= kSmemMax ? smem<D>(tiles, p.ring, words) : 0;
  p.ctas = (strips + warps - 1) / warps;
  return p;
}

// The tensor map of an (N, W, heads * D) bf16 tensor as {heads * D, W, N},
// in boxes of kPitch<D> columns and 64 rows.
template <int D>
inline bool encode(CUtensorMap* map, const void* base, int n, int w, int heads) {
  const async::EncodeTiled enc = async::encoder();
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(heads) * D, static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {kPitch<D>, kKeys, 1}, unit[3] = {1, 1, 1};
  return enc != nullptr &&
         enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The A fragments of this thread's rows r and r + 8 (r = 16 strip + lane / 4)
// from device memory, row i at src + i * row_stride; rows at or past w are 0.
// Where D % 16 == 8 the last step holds only its first two registers (the
// A operand of an m16n8k8); the others stay 0 and are never read.
template <int D>
__device__ __forceinline__ void a_frags(uint32_t (&a)[kKSteps<D>][4], const bf16* src,
                                        long long row_stride, int r, int w) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < kKSteps<D>; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r + 8 * (j & 1), col = kk * 16 + 8 * (j >> 1);
      a[kk][j] = row < w && col < D ? __ldg(reinterpret_cast<const unsigned*>(
                                          src + row * row_stride + col + 2 * t))
                                    : 0u;
    }
}

// bf16 m16n8k8, f32 accumulation: the last 8 columns of a row of D = 72.
__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// s = a (this warp's 16 rows) @ B^T over rows k0 .. k0 + 31 of a tile: the B
// fragments of two 8-row n-tiles and one 16-wide d-step per ldmatrix; where
// D % 16 == 8, those of the last 8 columns of all four n-tiles by one more.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kHalfN][4], const uint32_t (&a)[kKSteps<D>][4],
                                       const FTile<D>& b, int k0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int nt = 0; nt < kHalfN; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < kHalfN / 2; ++np) {
      uint32_t f[4];
      ldsm_x4<false>(f, &b[k0 + (2 * np + (mat >> 1)) * 8 + r][kk * 16 + (mat & 1) * 8]);
      mma_16816(s[2 * np], a[kk], f[0], f[1]);
      mma_16816(s[2 * np + 1], a[kk], f[2], f[3]);
    }
  if constexpr (D % 16 != 0) {
    static_assert(D % 16 == 8 && kHalfN == 4, "the tail is one 8-column step of 4 n-tiles");
    uint32_t f[4];  // matrix i: keys k0 + 8i .. + 7, columns D - 8 .. D - 1
    ldsm_x4<false>(f, &b[k0 + mat * 8 + r][D - 8]);
#pragma unroll
    for (int nt = 0; nt < kHalfN; ++nt) mma_1688(s[nt], a[D / 16][0], a[D / 16][1], f[nt]);
  }
}

// acc += bf16(p) @ B over rows k0 .. k0 + 31 of a tile (the PV-style
// product): the B fragments of two 8-wide d-tiles and one 16-row step per
// transposed ldmatrix; where D % 16 == 8, those of the last d-tile for both
// 16-row steps by one more.
template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 8][4], const float (&p)[kHalfN][4],
                                   const FTile<D>& b, int k0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
  uint32_t tail[4];  // matrix i: rows k0 + 8i .. + 7, columns D - 8 .. D - 1
  if constexpr (D % 16 != 0) ldsm_x4<true>(tail, &b[k0 + mat * 8 + r][D - 8]);
#pragma unroll
  for (int kt = 0; kt < kHalfN / 2; ++kt) {
    const uint32_t pa[4] = {pack_bf16x2(p[2 * kt][0], p[2 * kt][1]),
                            pack_bf16x2(p[2 * kt][2], p[2 * kt][3]),
                            pack_bf16x2(p[2 * kt + 1][0], p[2 * kt + 1][1]),
                            pack_bf16x2(p[2 * kt + 1][2], p[2 * kt + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t f[4];
      ldsm_x4<true>(f, &b[k0 + kt * 16 + (mat & 1) * 8 + r][(2 * dp + (mat >> 1)) * 8]);
      mma_16816(acc[2 * dp], pa, f[0], f[1]);
      mma_16816(acc[2 * dp + 1], pa, f[2], f[3]);
    }
    if constexpr (D % 16 != 0) mma_16816(acc[D / 8 - 1], pa, tail[2 * kt], tail[2 * kt + 1]);
  }
}

// This thread's tags (or any 4-byte words) of a half: columns 8 nt + 2t +
// (e & 1), from `words` at the half's first row.
template <typename T2, typename T>
__device__ __forceinline__ void pairs(T2 (&x)[kHalfN], const T* words) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kHalfN; ++nt) x[nt] = *reinterpret_cast<const T2*>(words + nt * 8 + 2 * t);
}

// 2^x by the SFU (ex2.approx, relative error ~2^-22, far under the bf16
// rounding of p that follows; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace frame
}  // namespace o3v
