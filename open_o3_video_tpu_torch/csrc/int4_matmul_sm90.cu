// Int4 weight-only matmul for Hopper (sm_90a), prefill route: K7 at M > 64.
//
// Replaces open_o3_video_tpu/ops/int4.py _int4_kernel (via _int4_matmul_pallas
// and int4_dense) where many rows share each weight: the decoder's prefill
// (M ~ 5.9k rows for the 7B video slice, ~4k for the 72B judge). Decode
// (M <= 64) keeps int4_matmul.cu's mma.sync route; both compute
//
//   out = bf16( sum_g (x[:, g] @ q_g) * scale[g, :] )        f32 accumulation
//
// with the same operands (see int4_matmul.cu): x (M, K) bf16, w_p (K/2, N)
// int8 (packed row k = code rows 2k, 2k+1 in its low, high nibble), scale
// (K/128, N) f32. Each group's bf16 products are summed in f32 by wgmma, the
// partial multiplied by its scale and added to the sum in group order with
// __fmul_rn / __fadd_rn (no FMA contraction), rounded to bf16 once. No
// split-K and no atomics: two runs give the same bits.
//
// What bounds it on the H100: the bf16 tensor cores (8.0e11 FLOP for the 7B
// gate_w at M = 5878, 0.81 ms at 989 TFLOP/s); the int4 bytes are 1/4 of a
// bf16 weight's. The mma.sync route spent its time turning nibbles into
// bf16 in every warp of every CTA, on 64 x 128 tiles. The design:
// - A CTA computes a 128 x 128 output tile with four warpgroups: two
//   consumers (64 rows each) issue wgmma.m64n128k16 with A (x) and B from
//   shared memory; two producers do the loads and the conversion, with their
//   registers lowered by setmaxnreg for the consumers' sum and partial.
// - A 4-deep ring of loaded groups (one quant group of 128 input rows per
//   slot), signalled by mbarriers: the x tile (128 x 128 bf16, two 64-column
//   TMA boxes in the 128-byte swizzle; rows past M are zero-filled by the
//   TMA), the packed weights (64 x 128 bytes, TMA) and the 128 scales (bulk
//   copy). A 2-deep ring of converted B tiles beside it.
// - The conversion is done once per CTA and group: byte (k, n) holds rows 2k
//   and 2k+1 of column n, which is one 32-bit word of a K-major B tile, so
//   the producers write the 32 KB bf16 B tile in the layout the wgmma
//   descriptor reads (128-byte swizzle, 16-byte stores, conflict-free). Per
//   word: XOR with 0x8 (offset binary), the nibble in the low mantissa bits
//   of bf16 128.0 (one prmt, one lop3), minus 136: exact small integers.
// - The two consumers take turns issuing their products (named barriers),
//   so one's scale-and-add runs while the tensor cores do the other's.
//   (Two partials per consumer in ping-pong, group g scaled while g+1 is in
//   flight, would hold two slots of each ring.)
// - Output tiles are ordered in bands of 8 row tiles, so CTAs resident
//   together share x and the weight tile in L2.
// What holds it back now (PERF.md): the conversion's traffic through shared
// memory beside the TMA writes and the wgmma reads; see
// scripts/exp_int4_wgmma_variants.py.
#include <cuda_bf16.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace o3v {
namespace int4wg {

using bf16 = __nv_bfloat16;
using async::bulk_load;
using async::mbar_arrive;
using async::mbar_expect_tx;
using async::mbar_init;
using async::mbar_wait;
using async::smem_u32;
using async::tma_load_2d;

constexpr int kGroup = 128;                      // input rows per quant group = one stage
constexpr int kBM = 128, kBN = 128;              // output tile
constexpr int kRawStages = 4;                    // ring of loaded groups: x, packed weights, scales
constexpr int kBStages = 2;                      // ring of converted B tiles
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kProducers = 2;                    // warpgroups that load and convert
constexpr int kThreads = 128 * (kConsumers + kProducers);
constexpr int kProducerRegs = 64, kConsumerRegs = 192;  // setmaxnreg: 128-thread shares
constexpr int kBand = 8;                         // row tiles per band of the schedule
constexpr int kXBytes = kBM * kGroup * 2;        // two 64-column boxes of 128 rows x 128 bytes
constexpr int kBoxBytes = kXBytes / 2;
constexpr int kWBytes = kGroup / 2 * kBN;        // packed bytes, 64 rows of 128
constexpr int kRawBytes = kXBytes + kWBytes;     // a multiple of 1024, as the swizzle needs
constexpr int kBBytes = kBN * kGroup * 2;        // the converted tile, K-major, x's layout
constexpr int kSBytes = kBN * 4;
constexpr int kBOffset = kRawStages * kRawBytes;
constexpr int kSOffset = kBOffset + kBStages * kBBytes;
constexpr int kBarOffset = kSOffset + kRawStages * kSBytes;
constexpr int kLayoutBytes = kBarOffset + (3 * kRawStages + 2 * kBStages) * 8;
constexpr int kSmem = 232448;                    // all a block may have: the slack aligns the base
static_assert(kLayoutBytes <= kSmem, "shared memory layout");

// Bytes i of a packed word p and of p >> 4 (selected into halves 0 and 2 by
// the caller's prmt) -> the bf16x2 {low nibble, high nibble}: each nibble
// XOR 8 in the low mantissa bits of 128.0 is 136 + code, exact in bf16.
__device__ __forceinline__ uint32_t nibble_pair_to_bf16x2(uint32_t sel_word) {
  const uint32_t biased = (sel_word & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The producer warpgroup's part of one stage: 64 x 128 packed bytes -> the
// K-major bf16 B tile (column n: 128 codes = 256 bytes, two 128-byte halves
// of 64 codes, each a 128-row swizzled box). A thread reads 4 packed rows x
// 4 columns (four 32-bit loads) and writes 4 16-byte chunks, one per column;
// it rotates the column order by its lane so the 8 lanes of each store
// phase hit 8 distinct chunks.
__device__ __forceinline__ void convert_stage(const uint8_t* wraw, uint8_t* bt, int pt) {
  const int col4 = pt & 31, rot = (col4 >> 1) & 3;
  constexpr int kWarps = 4 * kProducers;
#pragma unroll
  for (int it = 0; it < 16 / kWarps; ++it) {
    const int rowq = it * kWarps + (pt >> 5);  // packed rows 4 rowq .. 4 rowq + 3
    uint32_t r[4], h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = *reinterpret_cast<const uint32_t*>(wraw + (4 * rowq + j) * kBN + 4 * col4);
      h[j] = r[j] >> 4;
    }
    uint8_t* half = bt + (rowq >> 3) * kBoxBytes;
    const int chunk = rowq & 7;
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int i = (step + rot) & 3;
      const int n = 4 * col4 + i;
      const uint32_t sel = static_cast<uint32_t>(i | ((i + 4) << 8));
      uint4 v;
      v.x = nibble_pair_to_bf16x2(__byte_perm(r[0], h[0], sel));
      v.y = nibble_pair_to_bf16x2(__byte_perm(r[1], h[1], sel));
      v.z = nibble_pair_to_bf16x2(__byte_perm(r[2], h[2], sel));
      v.w = nibble_pair_to_bf16x2(__byte_perm(r[3], h[3], sel));
      *reinterpret_cast<uint4*>(half + n * 128 + ((chunk ^ (n & 7)) << 4)) = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    int4_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_w,
                             const float* __restrict__ scale, bf16* __restrict__ out, int M,
                             int N, int n_groups, int n_mt, int n_nt) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle needs 1024-byte alignment
  if (base - raw > static_cast<uint32_t>(kSmem - kLayoutBytes)) __trap();
  uint8_t* gbase = smem_raw + (base - raw);
  auto xs = [&](int r) { return base + r * kRawBytes; };               // x tile of a raw slot
  auto wsm = [&](int r) { return base + r * kRawBytes + kXBytes; };    // its packed weights
  auto bs = [&](int b) { return base + kBOffset + b * kBBytes; };      // converted B tile
  auto ss = [&](int r) { return base + kSOffset + r * kSBytes; };      // scales of a raw slot
  const uint32_t bars = base + kBarOffset;
  auto full = [&](int r) { return bars + 8 * r; };                          // x and scales landed
  auto empty = [&](int r) { return bars + 8 * (kRawStages + r); };          // raw slot consumed
  auto bready = [&](int b) { return bars + 8 * (2 * kRawStages + b); };     // B tile converted
  auto bfree = [&](int b) { return bars + 8 * (2 * kRawStages + kBStages + b); };  // B tile read
  auto wfull = [&](int r) { return bars + 8 * (2 * kRawStages + 2 * kBStages + r); };  // weights landed

  // bands of kBand row tiles, column tiles inside a band, rows fastest
  const int band_size = kBand * n_nt;
  const int band = blockIdx.x / band_size, first_m = band * kBand;
  const int rows_in_band = min(n_mt - first_m, kBand);
  const int local = blockIdx.x - band * band_size;
  const int m0 = (first_m + local % rows_in_band) * kBM, n0 = (local / rows_in_band) * kBN;

  const int tid = threadIdx.x;
  // the warpgroup index through a shuffle, so the compiler knows it is
  // uniform in each warp (wgmma in a path it thinks divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int r = 0; r < kRawStages; ++r) {
      mbar_init(full(r), 1);
      mbar_init(wfull(r), 1);
      mbar_init(empty(r), 128 * kConsumers);
    }
    for (int b = 0; b < kBStages; ++b) {
      mbar_init(bready(b), 128 * kProducers);
      mbar_init(bfree(b), 128 * kConsumers);
    }
    async::mbar_fence_init();
  }
  __syncthreads();

  if (wg >= kConsumers) {
    // ---- producer: loads and conversion --------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    const int pt = tid - 128 * kConsumers;
    auto issue = [&](int g) {
      const int r = g % kRawStages;
      // the weights first, on their own barrier: the conversion needs only them
      mbar_expect_tx(wfull(r), kWBytes);
      tma_load_2d(wsm(r), &tm_w, wfull(r), n0, g * (kGroup / 2));
      mbar_expect_tx(full(r), kXBytes + kSBytes);
      tma_load_2d(xs(r), &tm_x, full(r), g * kGroup, m0);
      tma_load_2d(xs(r) + kBoxBytes, &tm_x, full(r), g * kGroup + 64, m0);
      bulk_load(ss(r), scale + static_cast<long long>(g) * N + n0, kSBytes, full(r));
    };
    if (pt == 0)
      for (int g = 0; g < min(kRawStages, n_groups); ++g) issue(g);  // the ring starts empty
    for (int g = 0; g < n_groups; ++g) {
      const int r = g % kRawStages, b = g % kBStages;
      mbar_wait(wfull(r), (g / kRawStages) & 1);
      if (g >= kBStages) mbar_wait(bfree(b), ((g - kBStages) / kBStages) & 1);
      convert_stage(gbase + (wsm(r) - base), gbase + (bs(b) - base), pt);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      mbar_arrive(bready(b));
      // refill the raw slot of group g - 1 once both consumers are done with it
      const int gp = g - 1;
      if (pt == 0 && gp >= 0 && gp + kRawStages < n_groups) {
        mbar_wait(empty(gp % kRawStages), (gp / kRawStages) & 1);
        issue(gp + kRawStages);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const uint32_t a_off = wg * 64 * 128;  // this warpgroup's rows in each x box
    const int lane = tid & 31, t = lane & 3;
    float acc[64], p[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // The two warpgroups take turns issuing (named barriers 1 and 2), so one's
    // scale-and-add runs while the tensor cores do the other's products.
    if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    for (int g = 0; g < n_groups; ++g) {
      const int r = g % kRawStages, b = g % kBStages;
      mbar_wait(full(r), (g / kRawStages) & 1);
      mbar_wait(bready(b), (g / kBStages) & 1);
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kGroup / 16; ++kk) {
        const uint32_t koff = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
        wg::m64n128k16(p, wg::sw128_desc(xs(r) + a_off + koff), wg::sw128_desc(bs(b) + koff), kk > 0);
      }
      wg::commit();
      if (wg == 0 || g + 1 < n_groups) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
      wg::wait<0>();
      wg::fence_regs(p);
      mbar_arrive(bfree(b));
      // the group's products times its scales, added to the sum in group order
      const float* sc = reinterpret_cast<const float*>(gbase + (ss(r) - base)) + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const float2 v = *reinterpret_cast<const float2*>(sc + nt * 8);
        acc[nt * 4 + 0] = __fadd_rn(acc[nt * 4 + 0], __fmul_rn(p[nt * 4 + 0], v.x));
        acc[nt * 4 + 1] = __fadd_rn(acc[nt * 4 + 1], __fmul_rn(p[nt * 4 + 1], v.y));
        acc[nt * 4 + 2] = __fadd_rn(acc[nt * 4 + 2], __fmul_rn(p[nt * 4 + 2], v.x));
        acc[nt * 4 + 3] = __fadd_rn(acc[nt * 4 + 3], __fmul_rn(p[nt * 4 + 3], v.y));
      }
      mbar_arrive(empty(r));
    }

    // d[4 nt + j]: row 16 warp + lane/4 + 8 (j >> 1), column 8 nt + 2 t + (j & 1)
    const int warp = (tid & 127) >> 5;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * half;
      if (row >= M) continue;
      bf16* o = out + static_cast<long long>(row) * N + n0 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[nt * 4 + 2 * half], acc[nt * 4 + 2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) = v;
      }
    }
  }
}

cudaError_t launch(const void* x, const void* wp, const void* scale, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  if (M < 1 || K % kGroup != 0 || N % kBN != 0) return cudaErrorInvalidValue;
  const async::EncodeTiled encode = async::encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap tm_x, tm_w;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t x_stride[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t x_box[2] = {64, kBM};
  if (encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), x_dims, x_stride,
             x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K / 2)};
  const cuuint64_t w_stride[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t w_box[2] = {kBN, kGroup / 2};
  if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wp), w_dims, w_stride, w_box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int n_mt = (M + kBM - 1) / kBM, n_nt = N / kBN;
  int4_matmul_wgmma_kernel<<<n_mt * n_nt, kThreads, kSmem, stream>>>(
      tm_x, tm_w, static_cast<const float*>(scale), static_cast<bf16*>(out), M, N, K / kGroup, n_mt,
      n_nt);
  return cudaGetLastError();
}

}  // namespace int4wg
}  // namespace o3v

// Plain C interface (loaded with ctypes); returns cudaGetLastError() after
// the launch. Operands as o3v_int4_matmul's: x (M, K) bf16, w_p (K/2, N)
// int8, scale (K/128, N) f32, out (M, N) bf16, contiguous and 16-byte
// aligned; N % 128 == 0, K % 128 == 0, groups of 128 rows only.
extern "C" int o3v_int4_matmul_wgmma(const void* x, const void* w_p, const void* scale, void* out,
                                     int m, int k, int n, int group, void* stream) {
  if (group != o3v::int4wg::kGroup) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(o3v::int4wg::launch(x, w_p, scale, out, m, k, n,
                                              static_cast<cudaStream_t>(stream)));
}
