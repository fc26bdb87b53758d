// GQA decode attention for Hopper (sm_90a): K4.
//
// Replaces open_o3_video_tpu/ops/decode_attention.py _decode_kernel: S <= 8
// query rows (a decode step) against a long KV buffer held in its STORED
// dtype, bf16 or fp8 e4m3, read through the batch and token strides of a
// layer view of the stacked (L, B, T, Hkv, D) cache. q (B, S, Hq, D) bf16 is
// prescaled by D^-1/2 and rounded to bf16 as it is loaded (the bits of K3's
// wrapper's prescale). A key t is visible to a query row iff t <= q_pos and
// kv_valid[b, t] != 0; rows with q_pos = -1, or with no visible key, write 0.
// q_pos is int64 and kv_valid bool bytes, the decode step's own tensors, so
// a step launches no conversion kernels around K4.
// The softmax is the fixed-m one of attention_tile.cuh: p = exp(min(s, 60)),
// bf16(p) @ v accumulated in f32, one division by l at the end.
//
// What bounds it on the H100: HBM bytes. A decode step reads each written
// key and value once, 2 * t * Hkv * D * itemsize per layer (84 MB at
// t = 81920 in fp8, ~25 us at 3.35 TB/s), and does ~2 FLOP per byte. The
// design:
// - All G * S query rows of one kv head (at most 64) live in one CTA, so
//   each K/V tile is read from HBM once for the whole GQA group. B * Hkv is
//   4 at a long context's shape (20-32 in a serving batch), too few CTAs
//   for the card, so the written key range [0, max_pos] is split
//   (split-K) over gridDim.x CTAs; each CTA divides the 64-key tiles evenly
//   among the splits itself, from its batch row's largest q_pos.
// - A producer warp streams the split's tiles through a ring of kRing bytes
//   (4 fp8 or 2 bf16 tiles of K and V) with TMA in the 128-byte swizzle,
//   full and empty mbarriers per slot, so several tiles are in flight under
//   the products. Keys past max_pos, or invalid, are never fetched: a tile
//   that is fully valid and below k_end is one TMA box of K and one of V (two
//   of each in bf16); a tile with any such key is copied by the producer
//   warp in 16-byte cp.async pieces, the valid rows only, the rest
//   zero-filled, so a NaN tail cannot reach a product (0 * NaN); a tile with
//   no valid key is skipped.
// - All four consumer warps compute. With G * S <= 16 rows (every S = 1 and
//   S = 2 step of both models) each warp takes 16 of every tile's 64 keys,
//   with its own acc and l over the same 16 rows; at 17-32 rows two warps
//   share each 16-row group, above that each warp has its own rows. The
//   partials of a row group are summed in shared memory in warp order: under
//   the fixed-m softmax that is a plain sum.
// - Fragments come straight from the ring by ldmatrix (the swizzle keeps it
//   conflict-free): K untransposed, V transposed. fp8 is widened in
//   registers with Hopper's native e4m3 -> f16x2 conversion (every e4m3
//   value, denormals included, is exact in f16 and in bf16), with no bf16
//   copy in shared memory: an fp8 K fragment holds 4 consecutive head
//   dimensions per thread, so q's fragments take the same order; an fp8 V
//   fragment holds two keys of two head dimensions, so each ldmatrix feeds
//   two output columns, and the output columns are stored back in order.
// - Because the softmax is fixed-m, the splits combine by plain addition of
//   their partial acc (R, D) and l (R) in f32: each split writes its
//   partials to scratch, and a second small kernel sums them in split order
//   and divides. No atomics: the result is the same bits on every run.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <climits>

#include "async_copy.cuh"
#include "attention_tile.cuh"

namespace o3v {
namespace k4 {

using fp8 = __nv_fp8_storage_t;  // one e4m3 byte

constexpr int kD = 128;
constexpr int kTile = 64;                     // keys per ring slot
constexpr int kChunk = 16;                    // keys per mma k-step
constexpr int kConsumerWarps = 4;
constexpr int kThreads5 = 32 * (kConsumerWarps + 1);  // and a producer warp
constexpr int kRing = 64 * 1024;              // K and V slots
constexpr int kBox = kTile * 128;             // one 128-byte-wide box of a tile
constexpr int kRedBytes = kConsumerWarps * 16 * (kD + 1) * 4;  // the warps' partials
constexpr float kQScale = 0.08838834764831845f;  // kD^-1/2, as the float PyTorch multiplies by
static_assert(kRedBytes <= kRing, "the partials reuse the ring");

template <typename KV>
constexpr int kTileBytes = kTile * kD * static_cast<int>(sizeof(KV));  // K or V of one tile
template <typename KV>
constexpr int kStages = kRing / (2 * kTileBytes<KV>);
template <typename KV>
constexpr int kTagOff = kRing;
template <typename KV>
constexpr int kKindOff = kTagOff<KV> + kStages<KV> * kTile * 4;
template <typename KV>
constexpr int kBarOff = kKindOff<KV> + kStages<KV> * 8;
template <typename KV>
constexpr int kSmem = kBarOff<KV> + 2 * kStages<KV> * 8 + 1024;  // slack: 1024-aligned base

// Byte `x` (< 128) of row r of a 128-byte-wide box in the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(uint32_t box, int r, int x) {
  return box + r * 128 + ((((x >> 4) ^ (r & 7)) << 4) | (x & 15));
}

// Shared address of byte `x` of key row r of a K or V tile (bf16: two boxes
// of 64 head dimensions).
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int r, int x) {
  return swz(tile + (x >> 7) * kBox, r, x & 127);
}

// Two e4m3 values (low byte first) -> two bf16 packed as in pack_bf16x2.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return pack_bf16x2(f.x, f.y);
}

// Two bf16 of q -> q * kD^-1/2 rounded to bf16 (round to nearest even), the
// bits of PyTorch's bf16 product with the scalar.
__device__ __forceinline__ uint32_t prescale_bf16x2(uint32_t two) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&two));
  return pack_bf16x2(f.x * kQScale, f.y * kQScale);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The keys [c0, c0 + 16) of a tile for this warp's 16 rows: s = q K^T, the
// fixed-m p where `visible`, l += p, acc += bf16(p) V. With fp8, acc's
// output columns are in the order the V fragments give them (see the
// partials' store in decode_split_kernel).
template <typename KV, typename Visible>
__device__ __forceinline__ void attend_chunk(const uint32_t (&qa)[kD / 16][4], uint32_t ks,
                                             uint32_t vs, int c0, Visible visible,
                                             float (&acc)[kD / 8][4], float (&l)[2]) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r8 = lane & 7;
  constexpr bool kFp8 = sizeof(KV) == 1;
  float s[2][4] = {};
  if constexpr (!kFp8) {
    // matrices: (keys 0-7 | 8-15) x (d 16kk .. +7 | +8 .. +15)
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4<false>(b, tile_addr(ks, c0 + (mat >> 1) * 8 + r8, 2 * (16 * kk + (mat & 1) * 8)));
      mma_16816(s[0], qa[kk], b[0], b[1]);
      mma_16816(s[1], qa[kk], b[2], b[3]);
    }
  } else {
    // matrices: (keys 0-7 | 8-15) x (d of k-step kk | kk + 1); a register
    // holds d 16kk + 4t .. + 3 of one key
#pragma unroll
    for (int kk = 0; kk < kD / 16; kk += 2) {
      uint32_t b[4];
      ldsm_x4<false>(b, tile_addr(ks, c0 + (mat & 1) * 8 + r8, 16 * (kk + (mat >> 1))));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_16816(s[0], qa[kk + h], e4m3x2_to_bf16x2(b[2 * h]), e4m3x2_to_bf16x2(b[2 * h] >> 16));
        mma_16816(s[1], qa[kk + h], e4m3x2_to_bf16x2(b[2 * h + 1]),
                  e4m3x2_to_bf16x2(b[2 * h + 1] >> 16));
      }
    }
  }
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1;
      const float p = visible(c0 + 8 * nt + 2 * t + (e & 1), half)
                          ? ex2(fminf(s[nt][e], kClamp) * 1.4426950408889634f) : 0.f;
      l[half] += p;
      s[nt][e] = p;
    }
  const uint32_t pa[4] = {pack_bf16x2(s[0][0], s[0][1]), pack_bf16x2(s[0][2], s[0][3]),
                          pack_bf16x2(s[1][0], s[1][1]), pack_bf16x2(s[1][2], s[1][3])};
  if constexpr (!kFp8) {
    // transposed matrices: (keys 0-7 | 8-15) x (d 8 dt .. | 8 (dt + 1) ..)
#pragma unroll
    for (int dp = 0; dp < kD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4<true>(b, tile_addr(vs, c0 + (mat & 1) * 8 + r8, 2 * 8 * (2 * dp + (mat >> 1))));
      mma_16816(acc[2 * dp], pa, b[0], b[1]);
      mma_16816(acc[2 * dp + 1], pa, b[2], b[3]);
    }
  } else {
    // transposed b16 matrices over byte pairs: (keys 0-7 | 8-15) x (d 16 cb
    // .. + 15 | 16 (cb + 1) ..). A register holds bytes {v(2t, 2g),
    // v(2t, 2g+1), v(2t+1, 2g), v(2t+1, 2g+1)}: bytes 0, 2 feed output
    // column 16 cb + 2g (acc[2 cb]), bytes 1, 3 column 16 cb + 2g + 1
    // (acc[2 cb + 1]).
#pragma unroll
    for (int cp = 0; cp < kD / 32; ++cp) {
      uint32_t b[4];
      ldsm_x4<true>(b, tile_addr(vs, c0 + (mat & 1) * 8 + r8, 16 * (2 * cp + (mat >> 1))));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cb = 2 * cp + h;
        const uint32_t lo = b[2 * h], hi = b[2 * h + 1];
        mma_16816(acc[2 * cb], pa, e4m3x2_to_bf16x2(__byte_perm(lo, 0, 0x3320)),
                  e4m3x2_to_bf16x2(__byte_perm(hi, 0, 0x3320)));
        mma_16816(acc[2 * cb + 1], pa, e4m3x2_to_bf16x2(__byte_perm(lo, 0, 0x3331)),
                  e4m3x2_to_bf16x2(__byte_perm(hi, 0, 0x3331)));
      }
    }
  }
}

// One (split, kv head, batch row). Row r < n_rows = G * S is query row
// (g, s) = (r / S, r % S) of q-head hk * G + g. Writes the split's partial
// acc (n_rows, D) and l (n_rows) to part_acc / part_l at [b][hk][split].
template <typename KV>
__global__ void __launch_bounds__(kThreads5, 2)
    decode_split_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ q,
                        const KV* __restrict__ k, const KV* __restrict__ v,
                        const long long* __restrict__ q_pos,
                        const uint8_t* __restrict__ kv_valid,
                        float* __restrict__ part_acc, float* __restrict__ part_l, int s_len,
                        int t_len, int hq, int group, int n_rows, long long k_stride_b,
                        long long k_stride_t, long long v_stride_b, long long v_stride_t) {
  constexpr int kS = kStages<KV>;
  constexpr int kTB = kTileBytes<KV>;
  constexpr bool kFp8 = sizeof(KV) == 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = async::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle needs 1024-byte alignment
  uint8_t* gbase = smem_raw + (base - raw);
  int* tags = reinterpret_cast<int*>(gbase + kTagOff<KV>);
  int* kinds = reinterpret_cast<int*>(gbase + kKindOff<KV>);
  const uint32_t bars = base + kBarOff<KV>;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kS + st); };
  auto k_slot = [&](int st) { return base + 2 * st * kTB; };
  auto v_slot = [&](int st) { return base + (2 * st + 1) * kTB; };

  const int split = blockIdx.x, splits = gridDim.x, hk = blockIdx.y, hkv = gridDim.y;
  const int b = blockIdx.z;
  const long long* pos = q_pos + static_cast<long long>(b) * s_len;
  const uint8_t* valid = kv_valid + static_cast<long long>(b) * t_len;
  int max_pos = -1;
  for (int s = 0; s < s_len; ++s) max_pos = max(max_pos, static_cast<int>(pos[s]));
  const int k_end = min(t_len, max_pos + 1);  // keys past every row's position are never read
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int tile0 = static_cast<int>(static_cast<long long>(split) * n_tiles / splits);
  const int tile1 = static_cast<int>(static_cast<long long>(split + 1) * n_tiles / splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      async::mbar_init(full(st), 1);
      async::mbar_init(empty(st), 32 * kConsumerWarps);
    }
    async::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer ---------------------------------------------------------
    constexpr int kPer = kTile / 32;  // keys per lane
    // a tile's keys of this lane that are valid and below k_end; the next
    // tile's are read while this one's slot is awaited
    auto read_valid = [&](int j, bool (&ok)[kPer]) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int key = j * kTile + kPer * lane + e;
        ok[e] = key < k_end && valid[key] != 0;
      }
    };
    bool cur[kPer], nxt[kPer];
    if (tile0 < tile1) read_valid(tile0, cur);
    for (int j = tile0; j < tile1; ++j) {
      const int i = j - tile0, st = i % kS, k0 = j * kTile;
      if (j + 1 < tile1) read_valid(j + 1, nxt);
      if (i >= kS) {
        async::mbar_wait(empty(st), (i / kS - 1) & 1);
        // the slot may hold cp.async writes (generic proxy) that a TMA write
        // (async proxy) now follows
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      bool all = true, any = false;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        tags[st * kTile + kPer * lane + e] = cur[e];
        all = all && cur[e];
        any = any || cur[e];
        cur[e] = nxt[e];
      }
      all = __all_sync(0xffffffffu, all);
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) kinds[st] = all ? 2 : any ? 1 : 0;
      __syncwarp();
      if (all) {
        if (lane == 0) {
          async::mbar_expect_tx(full(st), 2 * kTB);
          for (int h = 0; h < kTB / kBox; ++h) {
            async::tma_load_4d(k_slot(st) + h * kBox, &tm_k, full(st), h * (kBox / kTile / sizeof(KV)),
                               hk, k0, b);
            async::tma_load_4d(v_slot(st) + h * kBox, &tm_v, full(st), h * (kBox / kTile / sizeof(KV)),
                               hk, k0, b);
          }
        }
      } else {
        if (any) {
          // The valid rows below k_end only, 16 bytes a copy, all in flight at
          // once (cp.async); a copy of size 0 reads nothing and zero-fills.
          // Each lane's copies complete on the slot's barrier.
          constexpr int kRowChunks = kD * sizeof(KV) / 16;
          for (int c = lane; c < 2 * kTile * kRowChunks; c += 32) {
            const int which = c / (kTile * kRowChunks), rc = c % (kTile * kRowChunks);
            const int r = rc / kRowChunks, x = (rc % kRowChunks) * 16;
            const int ok = tags[st * kTile + r];
            const int key = k0 + (ok ? r : 0);  // an address inside the buffer either way
            const KV* src = (which ? v + b * v_stride_b + key * v_stride_t
                                   : k + b * k_stride_b + key * k_stride_t) + hk * kD;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                             tile_addr(which ? v_slot(st) : k_slot(st), r, x)),
                         "l"(reinterpret_cast<const uint8_t*>(src) + x), "r"(ok ? 16 : 0)
                         : "memory");
          }
          asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(full(st))
                       : "memory");
        }
        __syncwarp();
        if (lane == 0) async::mbar_arrive(full(st));
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  const int rg = (n_rows + 15) / 16;                   // 16-row groups
  const int kp = rg == 1 ? 4 : rg == 2 ? 2 : 1;        // warps per row group
  const int rgi = warp / kp, kpi = warp % kp;
  const bool busy = rgi < rg;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * rgi + g;
  int row_pos[2], rows_min = INT_MAX;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    row_pos[half] = r < n_rows ? static_cast<int>(pos[r % s_len]) : -1;
    const bf16* qrow = q + ((static_cast<long long>(b) * s_len + r % s_len) * hq + hk * group +
                            r / s_len) * kD;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // a[half], a[half + 2]: the d pairs K's fragments take
        const int d = kFp8 ? 16 * kk + 4 * t + 2 * j : 16 * kk + 2 * t + 8 * j;
        qa[kk][half + 2 * j] =
            r < n_rows ? prescale_bf16x2(__ldg(reinterpret_cast<const unsigned*>(qrow + d))) : 0u;
      }
  }
  for (int i = 0; i < 16; ++i)  // the fast path needs every real row of the group at or past the tile
    if (16 * rgi + i < n_rows)
      rows_min = min(rows_min, static_cast<int>(pos[(16 * rgi + i) % s_len]));

  float acc[kD / 8][4] = {};
  float l[2] = {0.f, 0.f};
  const int chunks = kTile / kChunk / kp;  // of 16 keys, per warp and tile
  for (int j = tile0; j < tile1; ++j) {
    const int i = j - tile0, st = i % kS, k0 = j * kTile;
    async::mbar_wait(full(st), (i / kS) & 1);
    const int kind = kinds[st];
    if (busy && kind != 0) {
      const int* tag = tags + st * kTile;
      if (kind == 2 && k0 + kTile - 1 <= rows_min) {
        for (int c = 0; c < chunks; ++c)
          attend_chunk<KV>(qa, k_slot(st), v_slot(st), kChunk * (kpi * chunks + c),
                           [](int, int) { return true; }, acc, l);
      } else {
        for (int c = 0; c < chunks; ++c)
          attend_chunk<KV>(qa, k_slot(st), v_slot(st), kChunk * (kpi * chunks + c),
                           [&](int col, int half) { return tag[col] && k0 + col <= row_pos[half]; },
                           acc, l);
      }
    }
    async::mbar_arrive(empty(st));
  }

  // The warps' partials, in the ring (all its tiles are consumed): red[warp]
  // (16 rows of D + 1 floats, the last one l), summed per row group in warp
  // order.
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
  float* red = reinterpret_cast<float*>(gbase);
  constexpr int kPitch = kD + 1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    float* row = red + (warp * 16 + g + 8 * half) * kPitch;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      if constexpr (kFp8) {  // acc[2 cb] and acc[2 cb + 1]: columns 16 cb + 4t + {0, 2} and {1, 3}
        const int cb = nt >> 1, odd = nt & 1;
        row[16 * cb + 4 * t + odd] = acc[nt][2 * half];
        row[16 * cb + 4 * t + 2 + odd] = acc[nt][2 * half + 1];
      } else {
        row[8 * nt + 2 * t] = acc[nt][2 * half];
        row[8 * nt + 2 * t + 1] = acc[nt][2 * half + 1];
      }
    }
    if (t == 0) row[kD] = l[half];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
  const long long part = (static_cast<long long>(b * hkv + hk) * splits + split) * n_rows;
  for (int e = threadIdx.x; e < n_rows * kPitch; e += 32 * kConsumerWarps) {
    const int r = e / kPitch, col = e % kPitch, grp = r / 16;
    float sum = 0.f;
    for (int w = 0; w < kp; ++w) sum += red[((grp * kp + w) * 16 + r % 16) * kPitch + col];
    if (col < kD)
      part_acc[(part + r) * kD + col] = sum;
    else
      part_l[part + r] = sum;
  }
}

// Sums the splits' partials in split order and divides: one CTA of D
// threads per (query row, kv head, batch row).
__global__ void __launch_bounds__(kD)
    decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_l,
                          bf16* __restrict__ out, int s_len, int hq, int group, int splits,
                          int n_rows) {
  const int r = blockIdx.x, hk = blockIdx.y, hkv = gridDim.y, b = blockIdx.z;
  const long long first = static_cast<long long>(b * hkv + hk) * splits * n_rows + r;
  float acc = 0.f, l = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const long long at = first + static_cast<long long>(s) * n_rows;
    acc += part_acc[at * kD + threadIdx.x];
    l += part_l[at];
  }
  const long long row = (static_cast<long long>(b) * s_len + r % s_len) * hq + hk * group + r / s_len;
  out[row * kD + threadIdx.x] = __float2bfloat16_rn(acc / (l == 0.f ? 1.f : l));
}

template <typename KV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_valid, void* out, void* part_acc, void* part_l, int b, int s_len,
                   int t_len, int hq, int hkv, int splits, long long k_stride_b,
                   long long k_stride_t, long long v_stride_b, long long v_stride_t,
                   cudaStream_t stream) {
  constexpr int item = sizeof(KV);
  CUtensorMap tm_k, tm_v;
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(hkv), static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t k_strides[3] = {kD * item, static_cast<cuuint64_t>(k_stride_t) * item,
                                   static_cast<cuuint64_t>(k_stride_b) * item};
  const cuuint64_t v_strides[3] = {kD * item, static_cast<cuuint64_t>(v_stride_t) * item,
                                   static_cast<cuuint64_t>(v_stride_b) * item};
  const cuuint32_t box[4] = {128 / item, 1, kTile, 1};  // 128 bytes of a row: one swizzle span
  const auto type = item == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!async::encode_4d(&tm_k, type, k, dims, k_strides, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !async::encode_4d(&tm_v, type, v, dims, v_strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is per function; set it once
  if (!smem_set) {
    const cudaError_t err = allow_smem(decode_split_kernel<KV>, kSmem<KV>);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int group = hq / hkv, n_rows = group * s_len;
  decode_split_kernel<KV><<<dim3(splits, hkv, b), kThreads5, kSmem<KV>, stream>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const long long*>(q_pos),
      static_cast<const uint8_t*>(kv_valid), static_cast<float*>(part_acc),
      static_cast<float*>(part_l), s_len, t_len, hq, group, n_rows, k_stride_b, k_stride_t,
      v_stride_b, v_stride_t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<dim3(n_rows, hkv, b), kD, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_l),
      static_cast<bf16*>(out), s_len, hq, group, splits, n_rows);
  return cudaGetLastError();
}

}  // namespace k4
}  // namespace o3v

// Plain C interface (loaded with ctypes); returns cudaGetLastError() after
// the two launches. q is bf16 as computed (not prescaled), q_pos (B, S)
// int64, kv_valid (B, T) one byte a slot (bool). Strides are in elements of
// the stored dtype (bytes for fp8) and must keep every token row on a
// 16-byte boundary (TMA). part_acc (B, Hkv, splits, G*S, D) and part_l (B,
// Hkv, splits, G*S) are f32 scratch. Built for the decoder's head_dim of
// 128 only, and for at most 64 query rows (G * S) per kv head.
extern "C" int o3v_decode_attention_gqa(const void* q, const void* k, const void* v,
                                        const void* q_pos, const void* kv_valid, void* out,
                                        void* part_acc, void* part_l, int b, int s_len, int t_len,
                                        int hq, int hkv, int head_dim, int kv_fp8, int splits,
                                        long long k_stride_b, long long k_stride_t,
                                        long long v_stride_b, long long v_stride_t,
                                        void* stream) {
  if (head_dim != o3v::k4::kD || hkv < 1 || hq % hkv != 0 || (hq / hkv) * s_len > 64 ||
      s_len < 1 || splits < 1 || b < 1 || t_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_fp8)
    return o3v::k4::launch<o3v::k4::fp8>(q, k, v, q_pos, kv_valid, out, part_acc, part_l, b, s_len,
                                         t_len, hq, hkv, splits, k_stride_b, k_stride_t,
                                         v_stride_b, v_stride_t, st);
  return o3v::k4::launch<o3v::bf16>(q, k, v, q_pos, kv_valid, out, part_acc, part_l, b, s_len,
                                    t_len, hq, hkv, splits, k_stride_b, k_stride_t, v_stride_b,
                                    v_stride_t, st);
}
