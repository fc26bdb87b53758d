// Int4 weight-only matmul for Hopper (sm_90a): K7, and the two K7a probes.
//
// Replaces open_o3_video_tpu/ops/int4.py _int4_kernel (via _int4_matmul_pallas
// and int4_dense), and the probes make_stream / make_convert of
// scripts/profile_int4_kernel_parts.py (the third probe, make_grouped, is K7).
//
//   out = bf16( sum_g (x[:, g] @ q_g) * scale[g, :] )        f32 accumulation
//
// x (M, K) bf16 row-major (the wrapper casts it first). w_p (K/2, N) int8:
// packed row k holds weight row 2k in its low nibble and row 2k+1 in its
// high nibble, each a two's-complement int4 in -8..7 (the quantizer uses
// -7..7). scale (K/128, N) f32, one per (group of 128 input rows, column).
// The group's partial product is multiplied by its scale in f32 and added
// to the sum in f32 (no FMA contraction, as the plain version computes it).
//
// What bounds it on the H100: at decode (M = 2-4) HBM bytes, K*N/2 of
// packed weights plus K*N/32 of scales per call (36 MB for the 7B gate_w,
// ~11 us at 3.35 TB/s), at ~1 FLOP per byte; at prefill (M ~ 5.9k) the
// bf16 tensor cores (8.0e11 FLOP for the 7B gate_w, ~0.81 ms). The design:
// - One CTA of four warps per (BM-row, 128-column) output tile; it walks K
//   one quant group (64 packed rows, 8 KB of weights) per pipeline stage,
//   with a kStages-deep cp.async ring in shared memory (16-byte copies), so
//   several groups' loads are in flight while one is multiplied.
// - No unpacked copy anywhere: the mma.sync m16n8k16 B fragment of a thread
//   is the pair (row 2k, row 2k+1) of one column, which is exactly one
//   packed byte. Each thread reads its bytes from shared memory and turns
//   each into one bf16x2 register: (int8)(b << 4) >> 4 and (int8)b >> 4,
//   exact integers in bf16. Columns are assigned so that a thread's bytes
//   for all of its n-tiles are adjacent (one 4-16 byte load per k row).
// - The group's f32 partial stays in registers and is scaled there; the
//   scales of the tile's 128 columns ride in the same pipeline stage.
// - BM = 16 at decode (4 warps split the 128 columns), 32, or 64 at
//   prefill (4 warps split the rows). No split-K and no atomics: each
//   output element is summed by one thread in group order, so two runs
//   give the same bits. An odd group count (231 for the 72B down_w) is
//   just a longer loop.
// wgmma, TMA, a persistent schedule and cheaper nibble conversion are
// later work.
//
// The probes share the template: kConvert drops the scales (one dot over
// all of K of the unpacked codes); kStream reads the packed bytes as int8
// values (no unpack, no scale) against x[:, :K/2], the HBM and tensor-core
// floor of the TPU scripts (its result is not K7's on purpose).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"  // mma_16816, pack_bf16x2, ld_u32, allow_smem

namespace o3v {
namespace int4mm {

constexpr int kGroup = 128;              // input rows per quant group (one stage)
constexpr int kStageRows = kGroup / 2;   // packed rows per stage
constexpr int kBN = 128;                 // output columns per CTA
constexpr int kWarps = 4;
constexpr int kThreadsMM = 32 * kWarps;
constexpr int kStages = 4;               // cp.async ring depth
// Packed rows in shared memory at a pitch of 160 bytes: the bytes one warp
// reads for a k row (rows t and t + 4 for lanes t = lane % 4) then fall in
// distinct banks for the 4-, 8- and 16-byte loads alike.
constexpr int kPitchW = kBN + 32;

enum Mode { kGrouped = 0, kConvert = 1, kStream = 2 };

template <int MODE, int BM>
struct Cfg {
  static constexpr int kWarpsM = BM / 16;
  static constexpr int kWarpsN = kWarps / kWarpsM;
  static constexpr int kNT = kBN / 8 / kWarpsN;  // n-tiles (8 columns each) per warp
  static constexpr int kXC = MODE == kStream ? kStageRows : kGroup;  // x columns per stage
  static constexpr int kPitchX = kXC + kPad;                          // bf16, as attention_tile
  static constexpr int kWBytes = kStageRows * kPitchW;
  static constexpr int kXBytes = BM * kPitchX * 2;
  static constexpr int kSBytes = MODE == kGrouped ? kBN * 4 : 0;
  static constexpr int kStageBytes = kWBytes + kXBytes + kSBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kWarpsM * kWarpsN == kWarps && kNT % 4 == 0, "tile shape");
  static_assert(kWBytes % 16 == 0 && kXBytes % 16 == 0, "16-byte stage alignment");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage s of the K walk: packed rows [64 s, 64 s + 64) of columns [n0, n0 +
// 128), x rows [m0, m0 + BM) of columns [XC s, XC s + XC) (rows past M are
// zero-filled) and, for K7, scale row s of the same columns.
template <int MODE, int BM>
__device__ __forceinline__ void load_stage(uint8_t* stage, const bf16* __restrict__ x,
                                           const int8_t* __restrict__ wp,
                                           const float* __restrict__ scale, int M, int K, int N,
                                           int m0, int n0, int s) {
  using C = Cfg<MODE, BM>;
  bf16* sx = reinterpret_cast<bf16*>(stage + C::kWBytes);
  const int8_t* wsrc = wp + static_cast<long long>(s) * kStageRows * N + n0;
  constexpr int kWVec = kBN / 16;
  for (int i = threadIdx.x; i < kStageRows * kWVec; i += kThreadsMM) {
    const int r = i / kWVec, c = (i % kWVec) * 16;
    cp_async16(stage + r * kPitchW + c, wsrc + static_cast<long long>(r) * N + c, true);
  }
  constexpr int kXVec = C::kXC / 8;
  for (int i = threadIdx.x; i < BM * kXVec; i += kThreadsMM) {
    const int r = i / kXVec, c = (i % kXVec) * 8;
    const bool ok = m0 + r < M;
    const bf16* src = ok ? x + static_cast<long long>(m0 + r) * K + static_cast<long long>(s) * C::kXC + c
                         : x;
    cp_async16(sx + r * C::kPitchX + c, src, ok);
  }
  if constexpr (MODE == kGrouped) {
    float* ss = reinterpret_cast<float*>(stage + C::kWBytes + C::kXBytes);
    for (int i = threadIdx.x; i < kBN / 4; i += kThreadsMM)
      cp_async16(ss + i * 4, scale + static_cast<long long>(s) * N + n0 + i * 4, true);
  }
}

// NT adjacent bytes of shared memory as NT / 4 words (one 4-, 8- or 16-byte load).
template <int NT>
__device__ __forceinline__ void load_bytes(uint32_t (&w)[NT / 4], const uint8_t* src) {
  if constexpr (NT == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (NT == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  }
}

template <int NT>
__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[NT / 4], int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
}

// One packed byte -> the bf16x2 B register {row 2k (low nibble), row 2k+1
// (high nibble)}, each nibble sign-extended to an exact integer.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t b) {
  const int lo = static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4;
  const int hi = static_cast<int8_t>(static_cast<uint8_t>(b)) >> 4;
  return pack_bf16x2(static_cast<float>(lo), static_cast<float>(hi));
}

// Two packed bytes as int8 values -> one bf16x2 register (the stream probe).
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t even, uint32_t odd) {
  return pack_bf16x2(static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(even))),
                     static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(odd))));
}

// acc[nt] += x rows (16 of this warp) @ this stage's weights, for the warp's
// NT n-tiles. Output column of (n-tile nt, fragment column n) is
// warp_n * 8 NT + n * NT + nt, so lane group g = lane / 4 reads the NT
// adjacent bytes at g * NT of each k row.
template <int MODE, int BM>
__device__ __forceinline__ void mma_stage(float (&acc)[Cfg<MODE, BM>::kNT][4],
                                          const uint8_t* stage, int warp_m, int warp_n) {
  using C = Cfg<MODE, BM>;
  constexpr int NT = C::kNT;
  const bf16(*sx)[C::kPitchX] = reinterpret_cast<const bf16(*)[C::kPitchX]>(stage + C::kWBytes);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = warp_m * 16 + g;
  const uint8_t* wcol = stage + warp_n * 8 * NT + g * NT;
#pragma unroll
  for (int kk = 0; kk < C::kXC / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const uint32_t a[4] = {ld_u32(&sx[r][c]), ld_u32(&sx[r + 8][c]), ld_u32(&sx[r][c + 8]),
                           ld_u32(&sx[r + 8][c + 8])};
    if constexpr (MODE == kStream) {  // B rows are packed rows kk*16 + {2t, 2t+1, 2t+8, 2t+9}
      uint32_t e0[NT / 4], e1[NT / 4], e2[NT / 4], e3[NT / 4];
      load_bytes<NT>(e0, wcol + (kk * 16 + 2 * t) * kPitchW);
      load_bytes<NT>(e1, wcol + (kk * 16 + 2 * t + 1) * kPitchW);
      load_bytes<NT>(e2, wcol + (kk * 16 + 2 * t + 8) * kPitchW);
      load_bytes<NT>(e3, wcol + (kk * 16 + 2 * t + 9) * kPitchW);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_16816(acc[nt], a, bytes_to_bf16x2(byte_at<NT>(e0, nt), byte_at<NT>(e1, nt)),
                  bytes_to_bf16x2(byte_at<NT>(e2, nt), byte_at<NT>(e3, nt)));
    } else {  // B rows 2t, 2t+1 and 2t+8, 2t+9 of this k16 step are packed rows t and t+4
      uint32_t w0[NT / 4], w1[NT / 4];
      load_bytes<NT>(w0, wcol + (kk * 8 + t) * kPitchW);
      load_bytes<NT>(w1, wcol + (kk * 8 + t + 4) * kPitchW);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_16816(acc[nt], a, nibbles_to_bf16x2(byte_at<NT>(w0, nt)),
                  nibbles_to_bf16x2(byte_at<NT>(w1, nt)));
    }
  }
}

template <int MODE, int BM>
__global__ void __launch_bounds__(kThreadsMM)
    int4_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wp,
                       const float* __restrict__ scale, bf16* __restrict__ out, int M, int K,
                       int N) {
  using C = Cfg<MODE, BM>;
  constexpr int NT = C::kNT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, warp_m = warp / C::kWarpsN, warp_n = warp % C::kWarpsN;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_stages = K / kGroup;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_stage<MODE, BM>(smem + s * C::kStageBytes, x, wp, scale, M, K, N, m0, n0, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage s - 1 is consumed
    const int next = s + kStages - 1;
    if (next < n_stages)
      load_stage<MODE, BM>(smem + (next % kStages) * C::kStageBytes, x, wp, scale, M, K, N, m0, n0,
                           next);
    cp_async_commit();
    const uint8_t* stage = smem + (s % kStages) * C::kStageBytes;
    if constexpr (MODE == kGrouped) {
      float part[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) part[nt][0] = part[nt][1] = part[nt][2] = part[nt][3] = 0.f;
      mma_stage<MODE, BM>(part, stage, warp_m, warp_n);
      // this thread's columns: warp_n*8NT + 2t*NT + nt (c0, c2) and + NT (c1, c3)
      const float* ss = reinterpret_cast<const float*>(stage + C::kWBytes + C::kXBytes) +
                        warp_n * 8 * NT + 2 * t * NT;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float s_lo = ss[nt], s_hi = ss[NT + nt];
        acc[nt][0] = __fadd_rn(acc[nt][0], __fmul_rn(part[nt][0], s_lo));
        acc[nt][1] = __fadd_rn(acc[nt][1], __fmul_rn(part[nt][1], s_hi));
        acc[nt][2] = __fadd_rn(acc[nt][2], __fmul_rn(part[nt][2], s_lo));
        acc[nt][3] = __fadd_rn(acc[nt][3], __fmul_rn(part[nt][3], s_hi));
      }
    } else {
      mma_stage<MODE, BM>(acc, stage, warp_m, warp_n);
    }
  }
  cp_async_wait<0>();

  // Each thread holds, for rows g and g + 8, the 2 NT adjacent columns from
  // warp_n*8NT + 2t*NT: NT of fragment column 2t, then NT of column 2t + 1.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + warp_m * 16 + g + 8 * half;
    if (row >= M) continue;
    bf16* o = out + static_cast<long long>(row) * N + n0 + warp_n * 8 * NT + 2 * t * NT;
#pragma unroll
    for (int j = 0; j < NT; j += 4) {
      *reinterpret_cast<uint2*>(o + j) =
          make_uint2(pack_bf16x2(acc[j][2 * half], acc[j + 1][2 * half]),
                     pack_bf16x2(acc[j + 2][2 * half], acc[j + 3][2 * half]));
      *reinterpret_cast<uint2*>(o + NT + j) =
          make_uint2(pack_bf16x2(acc[j][2 * half + 1], acc[j + 1][2 * half + 1]),
                     pack_bf16x2(acc[j + 2][2 * half + 1], acc[j + 3][2 * half + 1]));
    }
  }
}

template <int MODE, int BM>
cudaError_t launch(const void* x, const void* wp, const void* scale, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  using C = Cfg<MODE, BM>;
  static bool smem_set = false;  // the attribute is per function; set it once
  if (!smem_set) {
    const cudaError_t err = allow_smem(int4_matmul_kernel<MODE, BM>, C::kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(N / kBN, (M + BM - 1) / BM);
  int4_matmul_kernel<MODE, BM><<<grid, kThreadsMM, C::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wp), static_cast<const float*>(scale),
      static_cast<bf16*>(out), M, K, N);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_rows(const void* x, const void* wp, const void* scale, void* out, int M, int K,
                        int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K % kGroup != 0 || N % kBN != 0 || M > 65535 * 64)
    return cudaErrorInvalidValue;
  if (M <= 16) return launch<MODE, 16>(x, wp, scale, out, M, K, N, st);
  if (M <= 32) return launch<MODE, 32>(x, wp, scale, out, M, K, N, st);
  return launch<MODE, 64>(x, wp, scale, out, M, K, N, st);
}

}  // namespace int4mm
}  // namespace o3v

// Plain C interface (loaded with ctypes); each returns cudaGetLastError()
// after its launch. x (M, K) bf16, w_p (K/2, N) int8, scale (K/128, N) f32,
// out (M, N) bf16, all contiguous and 16-byte aligned; N % 128 == 0 and
// K % 128 == 0. Built for quant groups of 128 rows only.
extern "C" int o3v_int4_matmul(const void* x, const void* w_p, const void* scale, void* out, int m,
                               int k, int n, int group, void* stream) {
  if (group != o3v::int4mm::kGroup) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      o3v::int4mm::launch_rows<o3v::int4mm::kGrouped>(x, w_p, scale, out, m, k, n, stream));
}

// K7a: the unpacked codes through one dot over K, no scales.
extern "C" int o3v_int4_matmul_convert(const void* x, const void* w_p, void* out, int m, int k,
                                       int n, void* stream) {
  return static_cast<int>(
      o3v::int4mm::launch_rows<o3v::int4mm::kConvert>(x, w_p, nullptr, out, m, k, n, stream));
}

// K7a: the packed bytes as int8 values through one dot with x[:, :K/2].
extern "C" int o3v_int4_matmul_stream(const void* x, const void* w_p, void* out, int m, int k,
                                      int n, void* stream) {
  return static_cast<int>(
      o3v::int4mm::launch_rows<o3v::int4mm::kStream>(x, w_p, nullptr, out, m, k, n, stream));
}
