// The packed window rows of the ViT's 28 windowed blocks (W = 64 or 128
// tokens a row, 16 heads of 80), as K1 (csrc/window_attention.cu) and K6's
// fused backward (csrc/window_attention_bwd.cu) take them on Hopper.
//
// A CTA serves one head of one row (blockIdx.x = row * heads + head;
// ops/window_attention.py:row_items mirrors it). Each of its W / 16 warps
// owns 16 rows of the row and attends to all W keys, its scores in
// registers. The head's slabs (q, k, v and, in the backward, dout: W rows
// of D + 8 columns from the head's first column) come by TMA at once, on
// one mbarrier, and the many small CTAs an SM holds overlap each other's
// loads (scripts/exp_k1_k6_plans.py measured rings of several heads per
// CTA: slower, PERF.md). Each slab is one box of a 2-D tensor map over the
// raw (N * W, columns) matrix: 88 columns give 176-byte rows (conflict-free
// ldmatrix), and the 8 columns past the head are the next head's or, past
// the last, zeros that nothing reads.
//
// The rope needs no staging: with D = 80 a column's rotate-half partner lies
// D / 2 = 40 columns (five 8-column tiles) away, and the columns an mma.sync
// fragment gives a thread (8 dt + 2t + {0, 1}, dt = 0 .. D/8 - 1, rows g and
// g + 8 of its warp's 16) hold every partner. So each thread reads the
// row's cos/sin at its own positions (float2 loads, each table element read
// once per head) and ropes q and k, and in the backward transposes the rope
// of dq and dk, in registers.
#pragma once

#include "async_copy.cuh"
#include "attention_tile.cuh"

namespace o3v {
namespace row {

constexpr int kBoxCols = 80 + kPad;  // slab columns at D = 80

// The CTAs an SM should hold in K1 (the register cap of its
// __launch_bounds__: at W = 128 it keeps two CTAs of 8 warps on an SM).
// Measured with scripts/exp_k1_k6_plans.py (PERF.md); K6 ran slower under a
// register cap (spills) and asks for one CTA an SM.
constexpr int k1_min_ctas(int w) { return w == 64 ? 4 : 2; }

template <int D, int W>
using Slab = bf16[W][D + kPad];

template <int D, int W>
constexpr int kSlabBytes = W * (D + kPad) * 2;

// The row's cos or sin (rows of D floats from `tab`) at this thread's
// positions: rows r0 + g + 8 half, columns 8 dt + 2t + {0, 1}. The loads are
// volatile so that each use reads them anew (from L1) rather than holding
// 40 registers across the products.
template <int D>
__device__ __forceinline__ void load_tab(float2 (&x)[2][D / 8], const float* tab, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(x[half][dt].x), "=f"(x[half][dt].y)
                   : "l"(tab + (r0 + g + 8 * half) * D + 8 * dt + 2 * t));
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ uint32_t pack(float2 v) { return pack_bf16x2(v.x, v.y); }

// y = x cos + rotate_half(x) sin, rotate_half([x1, x2]) = [-x2, x1], in f32
// with no FMA contraction (as K1's plain version rounds it), on this
// thread's positions; partners are the tiles dt and dt + D/16.
template <int D>
__device__ __forceinline__ void rope(float2 (&x)[2][D / 8], const float2 (&c)[2][D / 8],
                                     const float2 (&s)[2][D / 8]) {
  constexpr int P = D / 16;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int dt = 0; dt < P; ++dt) {
      const float2 lo = x[half][dt], hi = x[half][dt + P];
      const float2 cl = c[half][dt], ch = c[half][dt + P], sl = s[half][dt], sh = s[half][dt + P];
      x[half][dt] = make_float2(__fsub_rn(__fmul_rn(lo.x, cl.x), __fmul_rn(hi.x, sl.x)),
                                __fsub_rn(__fmul_rn(lo.y, cl.y), __fmul_rn(hi.y, sl.y)));
      x[half][dt + P] = make_float2(__fadd_rn(__fmul_rn(hi.x, ch.x), __fmul_rn(lo.x, sh.x)),
                                    __fadd_rn(__fmul_rn(hi.y, ch.y), __fmul_rn(lo.y, sh.y)));
    }
}

// The rope's transpose on C fragments acc[dt][2 half + {0, 1}]: dx = dy cos
// + [a2, -a1], a = dy sin (halves D / 2 apart), as K6's plain version.
template <int D>
__device__ __forceinline__ void rope_transpose(float (&acc)[D / 8][4], const float2 (&c)[2][D / 8],
                                               const float2 (&s)[2][D / 8]) {
  constexpr int P = D / 16;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int dt = 0; dt < P; ++dt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float lo = acc[dt][2 * half + j], hi = acc[dt + P][2 * half + j];
        const float cl = j ? c[half][dt].y : c[half][dt].x, ch = j ? c[half][dt + P].y : c[half][dt + P].x;
        const float sl = j ? s[half][dt].y : s[half][dt].x, sh = j ? s[half][dt + P].y : s[half][dt + P].x;
        acc[dt][2 * half + j] = __fadd_rn(__fmul_rn(lo, cl), __fmul_rn(hi, sh));
        acc[dt + P][2 * half + j] = __fsub_rn(__fmul_rn(hi, ch), __fmul_rn(lo, sl));
      }
}

// This thread's positions of a slab (rows r0 + g + 8 half) as f32 pairs.
template <int D, int W>
__device__ __forceinline__ void read_own(float2 (&x)[2][D / 8], const Slab<D, W>& sl, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) x[half][dt] = unpack(ld_u32(&sl[r0 + g + 8 * half][8 * dt + 2 * t]));
}

template <int D, int W>
__device__ __forceinline__ void write_own(Slab<D, W>& sl, const float2 (&x)[2][D / 8], int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(&sl[r0 + g + 8 * half][8 * dt + 2 * t]) = pack(x[half][dt]);
}

// A fragments of the m16n8k16 product from this thread's positions:
// a[kk] = rows (g, g + 8) x columns 16 kk + 2t + {0, 1} and + 8.
template <int D>
__device__ __forceinline__ void own_to_a(uint32_t (&a)[D / 16][4], const float2 (&x)[2][D / 8]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = pack(x[0][2 * kk]);
    a[kk][1] = pack(x[1][2 * kk]);
    a[kk][2] = pack(x[0][2 * kk + 1]);
    a[kk][3] = pack(x[1][2 * kk + 1]);
  }
}

// A fragments of 16 rows from r0 of a slab (ldmatrix).
template <int D, int W>
__device__ __forceinline__ void slab_a(uint32_t (&a)[D / 16][4], const Slab<D, W>& sl, int r0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4<false>(a[kk], &sl[r0 + (mat & 1) * 8 + r][kk * 16 + (mat >> 1) * 8]);
}

// s = A (this warp's 16 rows) @ B^T over D, B the W rows of a slab: the
// B fragments of two 8-column n-tiles and one 16-wide d-step per ldmatrix.
template <int D, int W>
__device__ __forceinline__ void scores(float (&s)[W / 8][4], const uint32_t (&a)[D / 16][4],
                                       const Slab<D, W>& b) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < W / 16; ++np) {
      uint32_t f[4];
      ldsm_x4<false>(f, &b[(2 * np + (mat >> 1)) * 8 + r][kk * 16 + (mat & 1) * 8]);
      mma_16816(s[2 * np], a[kk], f[0], f[1]);
      mma_16816(s[2 * np + 1], a[kk], f[2], f[3]);
    }
}

// acc += bf16(x) @ B over the W rows of a slab (x the C fragments of this
// warp's 16 x W block): the B fragments of two 8-wide d-tiles and one
// 16-row step per transposed ldmatrix.
template <int D, int W>
__device__ __forceinline__ void times_slab(float (&acc)[D / 8][4], const float (&x)[W / 8][4],
                                           const Slab<D, W>& b) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kt = 0; kt < W / 16; ++kt) {
    const uint32_t xa[4] = {pack_bf16x2(x[2 * kt][0], x[2 * kt][1]),
                            pack_bf16x2(x[2 * kt][2], x[2 * kt][3]),
                            pack_bf16x2(x[2 * kt + 1][0], x[2 * kt + 1][1]),
                            pack_bf16x2(x[2 * kt + 1][2], x[2 * kt + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t f[4];
      ldsm_x4<true>(f, &b[kt * 16 + (mat & 1) * 8 + r][(2 * dp + (mat >> 1)) * 8]);
      mma_16816(acc[2 * dp], xa, f[0], f[1]);
      mma_16816(acc[2 * dp + 1], xa, f[2], f[3]);
    }
  }
}

// This thread's key tags of n-tile nt: columns 8 nt + 2t + {0, 1}.
__device__ __forceinline__ int2 key_tags(const int* tag, int nt) {
  return *reinterpret_cast<const int2*>(tag + nt * 8 + 2 * (threadIdx.x & 3));
}

// 2^x by the SFU (ex2.approx, relative error ~2^-22; below 2^-126 it
// flushes to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The exact in-window softmax of this warp's 16 rows over all W keys, in
// place: s (raw q.k) becomes p = exp(s' - m) / l, s' the scaled score where
// visible and NEG_INF elsewhere (a pad row, tag 0, scores 0 on all W keys:
// the uniform row of the JAX kernels). Scores in log2 units, one multiply
// before ex2.
template <int W>
__device__ __forceinline__ void exact_softmax(float (&s)[W / 8][4], const int* tag,
                                              const int (&row_tag)[2], float scale) {
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt) {
    const int2 kt = key_tags(tag, nt);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1, key = e & 1 ? kt.y : kt.x;
      s[nt][e] = visible<kSegment>(row_tag[half], key, 0) ? score<kSegment>(s[nt][e], row_tag[half], scale2)
                                                          : kNegInf;
      m[half] = fmaxf(m[half], s[nt][e]);
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = s[nt][e] != kNegInf ? exp2_approx(s[nt][e] - m[e >> 1]) : 0.f;
      l[e >> 1] += s[nt][e];
    }
  const float inv_l[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= inv_l[e >> 1];
}

// Shared memory of a row CTA: `slabs` slabs, then `extra` bytes, the W key
// tags and the mbarrier, after the TMA alignment.
template <int D, int W>
constexpr int smem_bytes(int slabs, int extra) {
  return 128 + slabs * kSlabBytes<D, W> + extra + W * 4 + 8;
}

// The slabs at the start of a row CTA's dynamic shared memory, 128-byte
// aligned for the TMA.
template <int D, int W>
__device__ __forceinline__ Slab<D, W>* slabs(uint8_t* smem) {
  const uint32_t raw = async::smem_u32(smem);
  return reinterpret_cast<Slab<D, W>*>(smem + (((raw + 127) & ~127u) - raw));
}

// A row CTA's start: the row's W key tags (`ids` from the row's first)
// into shared memory, and its mbarrier set for one arrival, thread 0's with
// the slabs' bytes.
template <int W>
__device__ __forceinline__ void begin(int* tag, const int* ids, uint32_t bar) {
  for (int i = threadIdx.x; i < W; i += blockDim.x) tag[i] = ids[i];
  if (threadIdx.x == 0) {
    async::mbar_init(bar, 1);
    async::mbar_fence_init();
  }
  __syncthreads();
}

// The 2-D tensor map of a (rows, cols) bf16 matrix with boxes of W rows of
// kBoxCols columns; columns past `cols` read as zeros.
inline bool encode_rows(CUtensorMap* map, const void* base, long long rows, long long cols, int w) {
  const async::EncodeTiled encode = async::encoder();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBoxCols, static_cast<cuuint32_t>(w)}, unit[2] = {1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches row kernel K on `blocks` CTAs of 2 W threads (W / 16 warps)
// with `smem` bytes of dynamic shared memory, its limit raised to all a
// block may have on the first launch.
template <auto K, int W, typename... Args>
inline cudaError_t launch(int blocks, int smem, cudaStream_t stream, Args... args) {
  static const cudaError_t allowed = allow_smem(K, kSmemMax);
  if (allowed != cudaSuccess) return allowed;
  K<<<blocks, 2 * W, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace row
}  // namespace o3v
