// Int4 weight-only matmul for Hopper (sm_90a), decode route: K7 at M <= 64,
// and the two K7a probes.
//
// Replaces open_o3_video_tpu/ops/int4.py _int4_kernel (via _int4_matmul_pallas
// and int4_dense) where few rows share each weight: the decoder's decode
// steps (M = batch, 2 for the 7B slice, 4 for the 72B judge) and the lm_head
// at the last positions. The probes replace make_stream / make_convert of
// scripts/profile_int4_kernel_parts.py (the third probe, make_grouped, is K7).
//
//   out = bf16( sum_g (x[:, g] @ q_g) * scale[g, :] )        f32 accumulation
//
// x (M, K) bf16 row-major (the wrapper casts it first). w_p (K/2, N) int8:
// packed row k holds weight row 2k in its low nibble and row 2k+1 in its
// high nibble, each a two's-complement int4 in -8..7 (the quantizer uses
// -7..7). scale (K/128, N) f32, one per (group of 128 input rows, column).
// Each group's partial product is multiplied by its scale in f32 and added
// to the sum in f32 (no FMA contraction, as the plain version computes it).
//
// What bounds it on the H100: HBM bytes, K*N/2 of packed weights plus K*N/32
// of scales per call (36 MB for the 7B gate_w, ~11 us at 3.35 TB/s), at
// ~1 FLOP per byte. The design keeps enough bytes in flight on every SM:
// - Split-K over quant groups. A CTA computes one (BN = 128, 64 or 32)-
//   column tile over a contiguous range of groups: split s of S takes groups
//   [s*G/S, (s+1)*G/S). ops/int4.py:decode_plan picks BN and S so that every
//   decode shape of the 7B and 72B models puts at least 2 CTAs on each SM
//   (the 72B down_w: 64 column tiles x 4-5 splits instead of 64 CTAs).
// - Each split writes its f32 sum to a workspace (S, M, N) that the wrapper
//   allocates, then counts itself on its column tile's counter; the CTA
//   that arrives last adds the S partials in order 0..S-1, rounds to bf16
//   and resets the counter to 0 for the next call. The sum's order is fixed
//   whichever CTA adds it: two runs give the same bits. One launch per
//   call; with S = 1 each CTA writes bf16 itself.
// - A producer warp keeps a ring of stages (one quant group each: 64 packed
//   rows of BN bytes, the x columns of the group, BN scales) in flight on
//   mbarriers, 4-8 stages deep (~32 KB of weights per CTA): the weight tile
//   as one TMA box, x row by row and the scales as bulk copies. (One bulk
//   copy per 128-byte weight row ran at ~1 TB/s with the products left out:
//   the copy engine, not HBM, set the pace.) The consumer warps wait on the
//   stage's barrier and free it with one arrive per warp: no __syncthreads
//   in the loop.
// - Weights are the A operand of mma.sync.m16n8k16 (16 output columns), x
//   rows the n = 8 side, so M = 2 wastes 6 of 8 columns and not 14 of 16
//   rows, and each packed byte is converted once per CTA. A thread's A
//   fragments for its two 16-column m-tiles are the 4 adjacent bytes of one
//   packed row (columns are permuted inside the warp's 32 so that they are);
//   each byte becomes one bf16x2 {row 2k, row 2k+1} by XOR 0x8 into the low
//   mantissa bits of bf16 128.0 (one prmt, one lop3) minus 136: exact.
// - At BN = 128 the weight tile comes in the TMA's 128-byte swizzle (16-byte
//   chunk c of row r at chunk c ^ (r % 8)), and warp w takes chunks w and
//   w + 4, so the 4 rows a warp reads at once fall in distinct banks.
//   Narrower tiles (the narrow-N shapes, bound by latency) are dense.
//
// The probes are modes of the same kernel: kConvert drops the scales (one
// dot over all of K of the unpacked codes); kStream reads the packed bytes
// as int8 values (no unpack, no scale) against x[:, :K/2], the HBM and
// tensor-core floor of the TPU scripts (its result is not K7's on purpose).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "attention_tile.cuh"  // mma_16816, pack_bf16x2, ld_u32, kPad, allow_smem

namespace o3v {
namespace int4mm {

constexpr int kGroup = 128;             // input rows per quant group (one stage)
constexpr int kStageRows = kGroup / 2;  // packed rows per stage
constexpr int kMaxRows = 64;            // rows of the decode route
constexpr int kRingBudget = 54 * 1024;  // ring bytes per CTA: up to 4 CTAs share an SM

enum Mode { kGrouped = 0, kConvert = 1, kStream = 2 };

template <int MODE, int BN, int BM>
struct Cfg {
  static constexpr int kWarpsC = BN / 32;              // consumer warps, 32 columns each
  static constexpr int kThreads = 32 * (kWarpsC + 1);  // and one producer warp
  static constexpr int kNT = BM / 8;                   // n-tiles of 8 x rows
  static constexpr int kXC = MODE == kStream ? kStageRows : kGroup;  // x columns per stage
  static constexpr int kPitchX = kXC + kPad;                          // bf16
  static constexpr int kWBytes = kStageRows * BN;                     // dense rows
  static constexpr int kXBytes = BM * kPitchX * 2;
  static constexpr int kSBytes = MODE == kGrouped ? BN * 4 : 0;
  // a multiple of 1024: the swizzled weight tile opens each stage
  static constexpr int kStageBytes = (kWBytes + kXBytes + kSBytes + 1023) / 1024 * 1024;
  static constexpr int kFit = kRingBudget / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 8 ? 8 : kFit);
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 2 * kStages * 8;  // after aligning the base
  static_assert(kWBytes % 16 == 0 && kXBytes % 16 == 0, "16-byte alignment");
};

// First group of split s of `splits` over `groups` (ops/int4.py:split_bounds).
__device__ __forceinline__ int split_begin(int s, int groups, int splits) {
  return static_cast<int>(static_cast<long long>(s) * groups / splits);
}

// Byte j of packed word w (h = w >> 4) -> the bf16x2 {low nibble, high
// nibble}: each nibble XOR 8 in the low mantissa bits of 128.0 is 136 + code.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t w, uint32_t h, int j) {
  const uint32_t biased = (__byte_perm(w, h, j | ((j + 4) << 8)) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte j of two words as int8 values -> one bf16x2 register (the stream probe).
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t even, uint32_t odd, int j) {
  return pack_bf16x2(static_cast<float>(static_cast<int8_t>((even >> (8 * j)) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((odd >> (8 * j)) & 0xffu)));
}

// The tile columns of lane group g = lane / 4 of a warp: wcol .. wcol + 3.
// At BN = 128, chunks w and w + 4 of the swizzled rows; else 32 w + 4 g.
template <int BN>
__device__ __forceinline__ int warp_col(int warp, int g) {
  return BN == 128 ? (g < 4 ? 16 * warp : 64 + 16 * warp) + 4 * (g & 3) : 32 * warp + 4 * g;
}

// Byte offset of tile column `col` (a multiple of 4) of packed row `row`.
template <int BN>
__device__ __forceinline__ int weight_offset(int row, int col) {
  return BN == 128 ? row * 128 + (((col >> 4) ^ (row & 7)) << 4) + (col & 15) : row * BN + col;
}

// d[j][nt] += A (this warp's m-tile j: 16 columns) @ B (x rows nt*8 ..
// nt*8 + 7) over one stage. Row g of m-tile j is tile column wcol + 2j, row
// g + 8 is wcol + 2j + 1: bytes 2j and 2j + 1 of the word at wcol of a
// packed row.
template <int MODE, int BN, int BM>
__device__ __forceinline__ void mma_stage(float (&d)[2][Cfg<MODE, BN, BM>::kNT][4],
                                          const uint8_t* stage, int wcol) {
  using C = Cfg<MODE, BN, BM>;
  const bf16(*sx)[C::kPitchX] = reinterpret_cast<const bf16(*)[C::kPitchX]>(stage + C::kWBytes);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto word = [&](int row) {
    return *reinterpret_cast<const uint32_t*>(stage + weight_offset<BN>(row, wcol));
  };
#pragma unroll
  for (int kk = 0; kk < C::kXC / 16; ++kk) {
    uint32_t a[2][4];
    if constexpr (MODE == kStream) {  // A columns k are packed rows kk*16 + {2t, 2t+1, 2t+8, 2t+9}
      const uint32_t e0 = word(kk * 16 + 2 * t), e1 = word(kk * 16 + 2 * t + 1);
      const uint32_t e2 = word(kk * 16 + 2 * t + 8), e3 = word(kk * 16 + 2 * t + 9);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        a[j][0] = bytes_to_bf16x2(e0, e1, 2 * j);
        a[j][1] = bytes_to_bf16x2(e0, e1, 2 * j + 1);
        a[j][2] = bytes_to_bf16x2(e2, e3, 2 * j);
        a[j][3] = bytes_to_bf16x2(e2, e3, 2 * j + 1);
      }
    } else {  // A columns 2t, 2t+1 (and + 8, + 9) are the nibbles of packed row kk*8 + t (+ 4)
      const uint32_t w0 = word(kk * 8 + t), w1 = word(kk * 8 + t + 4);
      const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        a[j][0] = nibbles_to_bf16x2(w0, h0, 2 * j);
        a[j][1] = nibbles_to_bf16x2(w0, h0, 2 * j + 1);
        a[j][2] = nibbles_to_bf16x2(w1, h1, 2 * j);
        a[j][3] = nibbles_to_bf16x2(w1, h1, 2 * j + 1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt) {
      const uint32_t b0 = ld_u32(&sx[nt * 8 + g][kk * 16 + 2 * t]);
      const uint32_t b1 = ld_u32(&sx[nt * 8 + g][kk * 16 + 2 * t + 8]);
      mma_16816(d[0][nt], a[0], b0, b1);
      mma_16816(d[1][nt], a[1], b0, b1);
    }
  }
}

template <int MODE, int BN, int BM>
__global__ void __launch_bounds__(Cfg<MODE, BN, BM>::kThreads)
    int4_decode_kernel(const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ x,
                       const float* __restrict__ scale, bf16* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ counters, int M, int K, int N,
                       int splits) {
  using C = Cfg<MODE, BN, BM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = async::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int n0 = blockIdx.x * BN, split = blockIdx.y;
  const int groups = K / kGroup;
  const int first = split_begin(split, groups, splits);
  const int n_st = split_begin(split + 1, groups, splits) - first;
  auto full = [&](int slot) { return base + C::kBarOffset + 8 * slot; };
  auto empty = [&](int slot) { return base + C::kBarOffset + 8 * (C::kStages + slot); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // x rows M .. BM - 1 of every stage stay zero: the copies fill rows < M only
  constexpr int kXVec = C::kXC / 8;
  const int zero_rows = BM - M;
  for (int i = threadIdx.x; i < C::kStages * zero_rows * kXVec; i += C::kThreads) {
    const int st = i / (zero_rows * kXVec), rem = i % (zero_rows * kXVec);
    const int r = M + rem / kXVec, c = (rem % kXVec) * 8;
    *reinterpret_cast<uint4*>(smem + st * C::kStageBytes + C::kWBytes + (r * C::kPitchX + c) * 2) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      async::mbar_init(full(s), 1);
      async::mbar_init(empty(s), C::kWarpsC);
    }
    async::mbar_fence_init();
  }
  __syncthreads();

  if (warp == C::kWarpsC) {  // ---- producer: one stage per quant group ----
    const uint32_t bytes = kStageRows * BN + M * C::kXC * 2 + C::kSBytes;
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % C::kStages, grp = first + i;
      if (i >= C::kStages) async::mbar_wait(empty(slot), (i / C::kStages - 1) & 1);
      const uint32_t st = base + slot * C::kStageBytes;
      if (lane == 0) {
        async::mbar_expect_tx(full(slot), bytes);
        async::tma_load_2d(st, &tm_w, full(slot), n0, grp * kStageRows);
      }
      __syncwarp();
      for (int r = lane; r < M; r += 32)
        async::bulk_load(st + C::kWBytes + r * C::kPitchX * 2,
                         x + static_cast<long long>(r) * K + static_cast<long long>(grp) * C::kXC,
                         C::kXC * 2, full(slot));
      if constexpr (MODE == kGrouped)
        if (lane == 0)
          async::bulk_load(st + C::kWBytes + C::kXBytes, scale + static_cast<long long>(grp) * N + n0,
                           C::kSBytes, full(slot));
    }
    return;
  }

  // ---- consumers: 32 columns a warp ----------------------------------------
  const int g = lane >> 2, t = lane & 3;
  const int wcol = warp_col<BN>(warp, g);
  float acc[2][C::kNT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt) acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.f;
  for (int i = 0; i < n_st; ++i) {
    const int slot = i % C::kStages;
    async::mbar_wait(full(slot), (i / C::kStages) & 1);
    const uint8_t* stage = smem + slot * C::kStageBytes;
    if constexpr (MODE == kGrouped) {
      float part[2][C::kNT][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt)
          part[j][nt][0] = part[j][nt][1] = part[j][nt][2] = part[j][nt][3] = 0.f;
      mma_stage<MODE, BN, BM>(part, stage, wcol);
      // the scales of columns wcol .. wcol + 3: m-tile j's rows g, g + 8
      const float4 sc = *reinterpret_cast<const float4*>(stage + C::kWBytes + C::kXBytes + wcol * 4);
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][nt][e] = __fadd_rn(acc[0][nt][e], __fmul_rn(part[0][nt][e], e < 2 ? sc.x : sc.y));
          acc[1][nt][e] = __fadd_rn(acc[1][nt][e], __fmul_rn(part[1][nt][e], e < 2 ? sc.z : sc.w));
        }
    } else {
      mma_stage<MODE, BN, BM>(acc, stage, wcol);
    }
    __syncwarp();
    if (lane == 0) async::mbar_arrive(empty(slot));
  }

  // d[e] of (j, nt): column wcol + 2j + (e >> 1), x row nt*8 + 2t + (e & 1)
  auto out_at = [&](int row) { return out + static_cast<long long>(row) * N + n0 + wcol; };
  auto ws_at = [&](int s, int row) { return ws + (static_cast<long long>(s) * M + row) * N + n0 + wcol; };
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = nt * 8 + 2 * t + e;
      if (row >= M) continue;
      const float v0 = acc[0][nt][e], v1 = acc[0][nt][2 + e], v2 = acc[1][nt][e], v3 = acc[1][nt][2 + e];
      if (splits == 1)
        *reinterpret_cast<uint2*>(out_at(row)) = make_uint2(pack_bf16x2(v0, v1), pack_bf16x2(v2, v3));
      else
        *reinterpret_cast<float4*>(ws_at(split, row)) = make_float4(v0, v1, v2, v3);
    }
  if (splits == 1) return;

  // the last split of this column tile to arrive sums all of them
  __shared__ int last;
  constexpr int kConsumerThreads = 32 * C::kWarpsC;
  __threadfence();  // this CTA's partial is visible before it is counted
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  if (threadIdx.x == 0) last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = nt * 8 + 2 * t + e;
      if (row >= M) continue;
      float4 a = __ldcg(reinterpret_cast<const float4*>(ws_at(0, row)));  // L2: other SMs wrote it
      for (int s = 1; s < splits; ++s) {
        const float4 b = __ldcg(reinterpret_cast<const float4*>(ws_at(s, row)));
        a.x = __fadd_rn(a.x, b.x);
        a.y = __fadd_rn(a.y, b.y);
        a.z = __fadd_rn(a.z, b.z);
        a.w = __fadd_rn(a.w, b.w);
      }
      *reinterpret_cast<uint2*>(out_at(row)) = make_uint2(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w));
    }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next call
}

// A call's split sums: the (splits, M, N) f32 workspace and one int counter
// per column tile, 0 between calls (both unused with one split).
struct Partials {
  void* ws;
  void* counters;
};

template <int MODE, int BN, int BM>
cudaError_t launch(const void* x, const void* wp, const void* scale, void* out, Partials p, int M,
                   int K, int N, int splits, cudaStream_t stream) {
  using C = Cfg<MODE, BN, BM>;
  static bool smem_set = false;  // the attribute is per function; set it once
  if (!smem_set) {
    const cudaError_t err = allow_smem(int4_decode_kernel<MODE, BN, BM>, C::kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  // the packed weights as (K/2 rows, N bytes); a box is one stage's tile
  const async::EncodeTiled encode = async::encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_w;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K / 2)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t box[2] = {BN, kStageRows}, unit[2] = {1, 1};
  if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wp), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  int4_decode_kernel<MODE, BN, BM><<<dim3(N / BN, splits), C::kThreads, C::kSmem, stream>>>(
      tm_w, static_cast<const bf16*>(x), static_cast<const float*>(scale), static_cast<bf16*>(out),
      static_cast<float*>(p.ws), static_cast<int*>(p.counters), M, K, N, splits);
  return cudaGetLastError();
}

template <int MODE, int BN>
cudaError_t launch_rows(const void* x, const void* wp, const void* scale, void* out, Partials p,
                        int M, int K, int N, int splits, cudaStream_t st) {
  if (M <= 8) return launch<MODE, BN, 8>(x, wp, scale, out, p, M, K, N, splits, st);
  if (M <= 16) return launch<MODE, BN, 16>(x, wp, scale, out, p, M, K, N, splits, st);
  if (M <= 32) return launch<MODE, BN, 32>(x, wp, scale, out, p, M, K, N, splits, st);
  return launch<MODE, BN, 64>(x, wp, scale, out, p, M, K, N, splits, st);
}

inline bool valid_plan(Partials p, int M, int K, int N, int splits) {
  return M >= 1 && M <= kMaxRows && K % kGroup == 0 && N % 128 == 0 && splits >= 1 &&
         splits <= K / kGroup && (splits == 1 || (p.ws != nullptr && p.counters != nullptr));
}

}  // namespace int4mm
}  // namespace o3v

// Plain C interface (loaded with ctypes); each returns cudaGetLastError()
// after its launch. x (M, K) bf16 with 1 <= M <= 64, w_p (K/2, N) int8,
// scale (K/128, N) f32, out (M, N) bf16, all contiguous and 16-byte aligned;
// N % 128 == 0 and K % 128 == 0. block_n (128, 64 or 32) and splits come
// from ops/int4.py:decode_plan; with more than one split, ws holds splits *
// M * N floats and counters N / block_n ints that are 0 (and are 0 again
// when the kernel ends); both may be null with one split. Built for quant
// groups of 128 rows only.
extern "C" int o3v_int4_matmul(const void* x, const void* w_p, const void* scale, void* out,
                               void* ws, void* counters, int m, int k, int n, int group,
                               int block_n, int splits, void* stream) {
  namespace mm = o3v::int4mm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mm::Partials p{ws, counters};
  if (group != mm::kGroup || !mm::valid_plan(p, m, k, n, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (block_n) {
    case 128: return static_cast<int>(mm::launch_rows<mm::kGrouped, 128>(x, w_p, scale, out, p, m, k, n, splits, st));
    case 64: return static_cast<int>(mm::launch_rows<mm::kGrouped, 64>(x, w_p, scale, out, p, m, k, n, splits, st));
    case 32: return static_cast<int>(mm::launch_rows<mm::kGrouped, 32>(x, w_p, scale, out, p, m, k, n, splits, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7a: the unpacked codes through one dot over K, no scales (128-column tiles).
extern "C" int o3v_int4_matmul_convert(const void* x, const void* w_p, void* out, void* ws,
                                       void* counters, int m, int k, int n, int splits,
                                       void* stream) {
  namespace mm = o3v::int4mm;
  const mm::Partials p{ws, counters};
  if (!mm::valid_plan(p, m, k, n, splits)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mm::launch_rows<mm::kConvert, 128>(x, w_p, nullptr, out, p, m, k, n, splits,
                                                             static_cast<cudaStream_t>(stream)));
}

// K7a: the packed bytes as int8 values through one dot with x[:, :K/2].
extern "C" int o3v_int4_matmul_stream(const void* x, const void* w_p, void* out, void* ws,
                                      void* counters, int m, int k, int n, int splits,
                                      void* stream) {
  namespace mm = o3v::int4mm;
  const mm::Partials p{ws, counters};
  if (!mm::valid_plan(p, m, k, n, splits)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mm::launch_rows<mm::kStream, 128>(x, w_p, nullptr, out, p, m, k, n, splits,
                                                             static_cast<cudaStream_t>(stream)));
}
