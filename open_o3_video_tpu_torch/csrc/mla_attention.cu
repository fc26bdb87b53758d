// Multi-head latent attention (DeepSeek-V3, Kimi-VL) for Hopper (sm_90a):
// the absorbed decode over the latent cache and the expanded prefill.
//
// Replaces no TPU kernel: the JAX package has no latent attention. The cache
// holds one row of kLatent + kRope values a token and layer ([c_kv | k_pe],
// 512 + 64), shared by every head. A key (a buffer column) is visible to a
// query row iff its validity byte is set and the column is at most the
// row's position (int64; -1 for a pad row), so holes, left padding and a
// ring that has wrapped are masked as K3 and K4 mask them. A row with no
// visible key writes 0. Both kernels take the max-subtracted softmax (exp2
// with log2(e) and the scale folded into one multiply).
//
// o3v_mla_decode_kernel + o3v_mla_decode_combine_kernel (absorbed decode,
// S <= 8 query rows a batch row x the heads): each head's query is
// q_nope W_UK (512) beside its roped q_pe (64), so every (row, head) scores
// the shared latent row as stored, and the output is the probability-
// weighted c_kv (512), which the caller maps through W_UV. Bound by HBM
// bytes: a step reads every live latent column once (1152 B a column and
// layer), ~2 operations a byte for 16 query rows. The design:
// - A CTA holds 16 query rows (a row-head each; the grid's z covers more)
//   and one split of the batch row's written columns [0, max q_pos]; the
//   splits (the grid's x, planned on the host to put one CTA on each SM)
//   divide the 32-key tiles evenly among themselves, from the batch row's
//   largest position read on the device, so a captured decode step stays
//   valid as the positions advance.
// - A producer warp streams the split's tiles through a 4-slot ring by
//   TMA, a tile of 32 keys as nine 64-column boxes in the 128-byte swizzle
//   (the consumers' ldmatrix addresses follow it, free of bank conflicts),
//   on the slot's full mbarrier; its lanes write the tile's validity bytes
//   beside the slot. A masked column is read and weighted by 0, so the
//   cache's masked columns must be finite (the engine's caches start as
//   zeros); columns past T are TMA's zero fill. Each consumer thread
//   arrives on the slot's empty mbarrier once it has read the tile.
// - Four consumer warps split the scores by depth (warp w: dimensions
//   144w .. 144w + 143 of all 32 keys, its q fragments held in registers
//   for the whole split, mma.sync m16n8k16) and sum the partials through
//   shared memory in warp order; every warp then runs the same softmax over
//   the 32 keys (the same values in the same order, so the same bits) and
//   multiplies its own 128 of the 512 output columns, V read transposed
//   from the tile it already holds: a tile is read from HBM once for both
//   products.
// - Each split writes its normalised partial output and its log-sum-exp;
//   the combine kernel merges the splits in split order (no atomics: the
//   same bits on every run).
// On an H100 at the Kimi cell's step (8 rows x 18700 columns) the pair takes
// 0.078 ms, 66% of its byte bound; with the consumers' products and softmax
// removed the pipeline alone takes 0.073 ms, and 2 to 5 ring slots time the
// same, so what is left is the stream and the fixed costs (the prologue,
// the partials, the combine's launch), not the products.
//
// o3v_mla_prefill_kernel (expanded prefill, query blocks of more than 8
// rows): q = [q_nope (128) | q_pe (64)], k = [k_nope (128) of the head |
// k_pe (64) shared by the heads], v (128) of the head; bound by the bf16
// tensor cores at prefill lengths. K3's CTA (causal_cta.cuh: a TMA producer
// warpgroup and two wgmma consumer warpgroups of 64 query rows, 128 rows of
// one head a CTA, longest query tiles first, a ring of K/V tiles with full
// and empty mbarriers, S of tile j in flight while P of tile j - 1
// multiplies V) at qk 192 and v 128: Q and K tiles are three 64-column
// boxes (two of k_nope from the expansion's output as it lies, one of k_pe
// from the latent cache itself, so nothing is concatenated), V two, and the
// ring has three slots of 64 keys (40 KB a slot). The key tile and the
// ring's depth are the design's knobs (128 keys take wgmma's N = 128 for the
// scores): on an H100 at the Kimi cell's prefix block, 64 keys x 3 slots
// took 3.93 ms, 64 x 4 the same, 128 x 2 4.56 ms; the two warpgroups taking
// turns to issue their products (FlashAttention-3's ping-pong, named
// barriers) gained nothing there and was left out. That is 44% of the bf16
// peak, K3's own share at long context; causal SDPA (cuDNN) computes the
// same block in 2.74 ms. The max-subtracted softmax is K3's exact mode,
// without the lse.
#include <cuda_bf16.h>

#include <climits>

#include "causal_cta.cuh"
#include "wgmma.cuh"

namespace o3v {
namespace mla {

constexpr int kLatent = 512, kRope = 64, kRow = kLatent + kRope;  // a cache row
constexpr int kNope = 128, kV = 128;                               // a head's k_nope, v

template <int N>
inline bool encode_bf16(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[N],
                        const cuuint64_t (&strides)[N - 1], const cuuint32_t (&box)[N]) {
  const async::EncodeTiled encode = async::encoder();
  cuuint32_t unit[N];
  for (int i = 0; i < N; ++i) unit[i] = 1;
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------------ decode

constexpr int kDecTile = 32;     // keys per ring slot
constexpr int kDecStages = 4;    // ring slots
constexpr int kDecRows = 16;     // query rows (row-heads) a CTA
constexpr int kDecWarps = 4;     // consumer warps
constexpr int kDecThreads = 32 * (kDecWarps + 1);  // and a producer warp
constexpr int kDecDims = kRow / kDecWarps;         // a consumer warp's share of the scores' depth
constexpr int kPitch = kRow + 8;                   // bf16 a row of q in shared memory
constexpr int kDecBox = kDecTile * 128;            // a 64-column box of a tile
constexpr int kDecSlot = (kRow / 64) * kDecBox;    // nine boxes
constexpr int kSPitch = kDecTile + 4;              // floats a row of partial scores
constexpr int kDecKOff = (kDecRows * kPitch * 2 + 1023) & ~1023;  // after q
constexpr int kDecSOff = kDecKOff + kDecStages * kDecSlot;
constexpr int kDecSBytes = 2 * kDecWarps * kDecRows * kSPitch * 4;  // two tiles' partials
constexpr int kDecMaskOff = kDecSOff + kDecSBytes;
constexpr int kDecBarOff = (kDecMaskOff + kDecStages * kDecTile + 7) & ~7;
constexpr int kDecSmem = kDecBarOff + 2 * kDecStages * 8 + 1024;  // slack: 1024-aligned base
static_assert(kDecSmem <= kSmemMax, "decode shared memory");
static_assert(kDecDims % 16 == 0 && kDecTile == 32, "the consumers' fragments");

__device__ __forceinline__ void consumers_sync() {  // the four consumer warps
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kDecWarps) : "memory");
}

// Shared address of the 16-byte piece holding dimensions d .. d + 7 (d a
// multiple of 8) of key r of a slot: nine 64-column boxes in the 128-byte
// swizzle that TMA writes.
__device__ __forceinline__ uint32_t kv_addr(uint32_t slot, int r, int d) {
  const int c = d >> 3;
  return slot + (c >> 3) * kDecBox + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__global__ void __launch_bounds__(kDecThreads, 1)
    o3v_mla_decode_kernel(const __grid_constant__ CUtensorMap tm_kv,
                          const bf16* __restrict__ q_lat, const bf16* __restrict__ q_pe,
                          const long long* __restrict__ q_pos, const uint8_t* __restrict__ valid,
                          float* __restrict__ part, float* __restrict__ lse, int s_len, int hq,
                          int t_len, float sl2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = async::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle needs 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  float* ss = reinterpret_cast<float*>(smem + kDecSOff);
  uint8_t* smask = smem + kDecMaskOff;
  const uint32_t bars = base + kDecBarOff;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kDecStages + s); };
  auto slot = [&](int s) { return base + kDecKOff + s * kDecSlot; };
  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.y, mb = blockIdx.z;
  const int rows = s_len * hq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  const long long* pos_b = q_pos + static_cast<long long>(b) * s_len;
  int max_pos = -1;
  for (int s = 0; s < s_len; ++s) max_pos = max(max_pos, static_cast<int>(pos_b[s]));
  const int k_end = min(t_len, max_pos + 1);
  const int n_all = k_end > 0 ? (k_end + kDecTile - 1) / kDecTile : 0;
  const int per = (n_all + nsplit - 1) / nsplit;
  const int j0 = split * per;
  const int n = max(0, min(n_all, j0 + per) - j0);
  if (tid == 0) {
    for (int s = 0; s < kDecStages; ++s) {
      async::mbar_init(full(s), 1);
      async::mbar_init(empty(s), 32 * kDecWarps);
    }
    async::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kDecWarps) {
    // ---- producer: nine TMA boxes a tile; each lane reads its key's
    // validity byte (the next tile's while the slot is awaited) ------------
    const uint8_t* val_b = valid + static_cast<long long>(b) * t_len;
    auto visible = [&](int j) {
      const int col = (j0 + j) * kDecTile + lane;
      return col < k_end && val_b[col] != 0;
    };
    bool cur = n > 0 && visible(0);
    for (int j = 0; j < n; ++j) {
      const int st = j % kDecStages;
      const bool nxt = j + 1 < n && visible(j + 1);
      if (j >= kDecStages) async::mbar_wait(empty(st), (j / kDecStages - 1) & 1);
      smask[st * kDecTile + lane] = cur;
      cur = nxt;
      __syncwarp();
      if (lane == 0) {
        async::mbar_expect_tx(full(st), kDecSlot);
        for (int bx = 0; bx < kRow / 64; ++bx)
          async::tma_load_3d(slot(st) + bx * kDecBox, &tm_kv, full(st), 64 * bx,
                             (j0 + j) * kDecTile, b);
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  constexpr int kVec = kRow / 8;  // 16-byte pieces a row
  for (int i = tid; i < kDecRows * kVec; i += 32 * kDecWarps) {
    const int r = i / kVec, c = (i % kVec) * 8, row = mb * kDecRows + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const long long at = (static_cast<long long>(b) * s_len + row / hq) * hq + row % hq;
      val = c < kLatent ? *reinterpret_cast<const uint4*>(q_lat + at * kLatent + c)
                        : *reinterpret_cast<const uint4*>(q_pe + at * kRope + (c - kLatent));
    }
    *reinterpret_cast<uint4*>(sq + r * kPitch + c) = val;
  }
  consumers_sync();
  // this warp's A fragments of q over its kDecDims dimensions, kept for every tile
  uint32_t qa[kDecDims / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDecDims / 16; ++kk)
    ldsm_x4<false>(qa[kk], sq + ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + kDecDims * warp +
                               16 * kk + (lane >> 4) * 8);
  int row_pos[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = mb * kDecRows + g + 8 * half;
    row_pos[half] = row < rows ? static_cast<int>(pos_b[row / hq]) : -1;
  }

  float acc[16][4];  // this warp's columns 128 warp + 8 nt (+ 2t, + 1), rows g, g + 8
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const int st = j % kDecStages;
    async::mbar_wait(full(st), (j / kDecStages) & 1);
    const uint32_t tile = slot(st);

    // partial scores of the tile's 32 keys over this warp's dimensions
    float sp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[nt][e] = 0.f;
    const int k_key = (lane & 7) + ((lane >> 4) << 3);
    const int k_dim = kDecDims * warp + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kDecDims / 16; ++kk)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t kb[4];
        ldsm_x4<false>(kb, kv_addr(tile, k_key + 16 * p, k_dim + 16 * kk));
        mma_16816(sp[2 * p], qa[kk], kb[0], kb[1]);
        mma_16816(sp[2 * p + 1], qa[kk], kb[2], kb[3]);
      }
    float* pw = ss + ((j & 1) * kDecWarps + warp) * kDecRows * kSPitch;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<float2*>(pw + g * kSPitch + 8 * nt + 2 * t) =
          make_float2(sp[nt][0], sp[nt][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * kSPitch + 8 * nt + 2 * t) =
          make_float2(sp[nt][2], sp[nt][3]);
    }
    consumers_sync();  // every warp's partials of this tile written

    // the softmax over the tile's 32 keys, the same in every warp (the
    // partials summed in warp order); p[half][2q + e] is key 8q + 2t + e of
    // row g + 8 half
    const int c0 = (j0 + j) * kDecTile;
    const uint8_t* mk = smask + st * kDecTile;
    const float* pb = ss + (j & 1) * kDecWarps * kDecRows * kSPitch;
    float p[2][8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = kNegInf;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 8 * q + 2 * t, r = (g + 8 * half) * kSPitch + col;
        float2 v = *reinterpret_cast<const float2*>(pb + r);
#pragma unroll
        for (int w = 1; w < kDecWarps; ++w) {
          const float2 o = *reinterpret_cast<const float2*>(pb + w * kDecRows * kSPitch + r);
          v.x += o.x;
          v.y += o.y;
        }
        const bool ok0 = mk[col] && c0 + col <= row_pos[half];
        const bool ok1 = mk[col + 1] && c0 + col + 1 <= row_pos[half];
        p[half][2 * q] = ok0 ? v.x * sl2 : kNegInf;
        p[half][2 * q + 1] = ok1 ? v.y * sl2 : kNegInf;
        tmax = fmaxf(tmax, fmaxf(p[half][2 * q], p[half][2 * q + 1]));
      }
      const float m_new = fmaxf(m[half], quad_max(tmax));
      const float alpha = causal::ex2(m[half] - m_new);
      m[half] = m_new;
      l[half] *= alpha;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        acc[nt][2 * half] *= alpha;
        acc[nt][2 * half + 1] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pv = p[half][i] == kNegInf ? 0.f : causal::ex2(p[half][i] - m_new);
        l[half] += pv;
        p[half][i] = pv;
      }
    }
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0] = pack_bf16x2(p[0][4 * kk], p[0][4 * kk + 1]);
      pa[kk][1] = pack_bf16x2(p[1][4 * kk], p[1][4 * kk + 1]);
      pa[kk][2] = pack_bf16x2(p[0][4 * kk + 2], p[0][4 * kk + 3]);
      pa[kk][3] = pack_bf16x2(p[1][4 * kk + 2], p[1][4 * kk + 3]);
    }
    // acc += P c_kv over this warp's 128 columns, V transposed from the tile
    const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8, v_dim = 128 * warp + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t vb[4];
        ldsm_x4<true>(vb, kv_addr(tile, v_key + 16 * kk, v_dim + 16 * np));
        mma_16816(acc[2 * np], pa[kk], vb[0], vb[1]);
        mma_16816(acc[2 * np + 1], pa[kk], vb[2], vb[3]);
      }
    async::mbar_arrive(empty(st));  // this thread's reads of the slot are done
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lt = quad_sum(l[half]);
    const int row = mb * kDecRows + g + 8 * half;
    if (row >= rows) continue;
    const float inv = lt == 0.f ? 0.f : 1.f / lt;
    const long long at = (static_cast<long long>(b) * nsplit + split) * rows + row;
    float* o = part + at * kLatent + 128 * warp + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      *reinterpret_cast<float2*>(o + 8 * nt) =
          make_float2(acc[nt][2 * half] * inv, acc[nt][2 * half + 1] * inv);
    if (warp == 0 && t == 0) lse[at] = lt == 0.f ? kNegInf : m[half] + log2f(lt);
  }
}

// out[b, row] = the splits' partials weighted by exp2(lse - max), in split order.
__global__ void __launch_bounds__(kLatent / 4)
    o3v_mla_decode_combine_kernel(const float* __restrict__ part, const float* __restrict__ lse,
                                  bf16* __restrict__ out, int nsplit, int rows) {
  const int row = blockIdx.x, b = blockIdx.y, c = 4 * threadIdx.x;
  const float* ls = lse + static_cast<long long>(b) * nsplit * rows + row;
  float mx = kNegInf;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, ls[static_cast<long long>(i) * rows]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float tot = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float w = causal::ex2(ls[static_cast<long long>(i) * rows] - mx);
    const float4 o = *reinterpret_cast<const float4*>(
        part + ((static_cast<long long>(b) * nsplit + i) * rows + row) * kLatent + c);
    acc.x += w * o.x;
    acc.y += w * o.y;
    acc.z += w * o.z;
    acc.w += w * o.w;
    tot += w;
  }
  const float inv = 1.f / tot;  // the largest split's weight is 1
  bf16* dst = out + (static_cast<long long>(b) * rows + row) * kLatent + c;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16x2(acc.x * inv, acc.y * inv), pack_bf16x2(acc.z * inv, acc.w * inv));
}

// ----------------------------------------------------------------- prefill

using causal::kConsumerRegs;
using causal::kCtaThreads;
using causal::kHalfBox;
using causal::kLog2e;
using causal::kProducerRegs;
using causal::kQBox;
using causal::kWgRows;
using causal::Work;

constexpr int kQkBoxes = (kNope + kRope) / 64;  // 3 boxes of 64 columns
constexpr int kVBoxes = kV / 64;                // 2
constexpr int kKeyTile = 64;                    // keys per ring slot (64 or 128)
constexpr int kStages = 3;                      // ring slots
constexpr int kSRegs = kKeyTile / 2;            // a consumer thread's scores of a tile
constexpr int kKVBox = kKeyTile * kHalfBox;     // 16 KB: 128 keys, 64 columns
constexpr int kQBytes = 2 * kQkBoxes * kQBox;   // two warpgroups
constexpr int kKBytes = kQkBoxes * kKVBox;
constexpr int kVBytes = kVBoxes * kKVBox;
constexpr int kKOff = kQBytes;
constexpr int kVOff = kKOff + kStages * kKBytes;
constexpr int kTagOff = kVOff + kStages * kVBytes;  // a byte per key: valid
constexpr int kFlagOff = kTagOff + kStages * kKeyTile;
constexpr int kPosOff = (kFlagOff + kStages * 4 + 15) & ~15;
constexpr int kBarOff = kPosOff + 2 * kWgRows * 4;
constexpr int kPreSmem = kBarOff + (1 + 2 * kStages) * 8 + 1024;  // slack: 1024-aligned base
static_assert(kPreSmem <= kSmemMax, "prefill shared memory");

// The scores' product at the key tile's width (N = 128 or 64).
__device__ __forceinline__ void scores_mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  wg::m64n128k16(d, da, db, acc);
}
__device__ __forceinline__ void scores_mma(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  wg::m64n64k16(d, da, db, acc);
}

__global__ void __launch_bounds__(kCtaThreads, 1)
    o3v_mla_prefill_kernel(const __grid_constant__ CUtensorMap tm_qn,
                           const __grid_constant__ CUtensorMap tm_qp,
                           const __grid_constant__ CUtensorMap tm_kn,
                           const __grid_constant__ CUtensorMap tm_kp,
                           const __grid_constant__ CUtensorMap tm_v,
                           const long long* __restrict__ q_pos, const uint8_t* __restrict__ valid,
                           bf16* __restrict__ out, int s_len, int t_len, int hq, float sl2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = async::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  uint8_t* tags = gbase + kTagOff;
  int* flags = reinterpret_cast<int*>(gbase + kFlagOff);
  int* spos = reinterpret_cast<int*>(gbase + kPosOff);
  const uint32_t bars = base + kBarOff;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_slot = [&](int s) { return base + kKOff + s * kKBytes; };
  auto v_slot = [&](int s) { return base + kVOff + s * kVBytes; };

  const Work w = causal::cta_work(s_len, hq);
  const int tid = threadIdx.x;
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid < 2 * kWgRows) {
    const int row = w.row0 + tid;
    spos[tid] = row < s_len ? static_cast<int>(q_pos[static_cast<long long>(w.b) * s_len + row])
                            : -1;
  }
  if (tid == 0) {
    async::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      async::mbar_init(full(s), 1);
      async::mbar_init(empty(s), 256);
    }
    async::mbar_fence_init();
  }
  __syncthreads();
  int max_pos = -1;
  for (int i = 0; i < 2 * kWgRows; ++i) max_pos = max(max_pos, spos[i]);
  const int k_end = min(t_len, max_pos + 1);
  const int n_tiles = k_end > 0 ? (k_end + kKeyTile - 1) / kKeyTile : 0;
  if (wgi == 0) {
    // ---- producer: Q once, then K (k_nope, k_nope, k_pe) and V tiles -----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      async::mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < 2; ++c) {
        const int r0 = w.row0 + c * kWgRows;
        const uint32_t q0 = base + c * kQkBoxes * kQBox;
        async::tma_load_4d(q0, &tm_qn, q_full, 0, w.head, r0, w.b);
        async::tma_load_4d(q0 + kQBox, &tm_qn, q_full, 64, w.head, r0, w.b);
        async::tma_load_4d(q0 + 2 * kQBox, &tm_qp, q_full, 0, w.head, r0, w.b);
      }
    }
    constexpr int kPer = kKeyTile / 32;  // keys per lane
    const uint8_t* val = valid + static_cast<long long>(w.b) * t_len;
    auto read_valid = [&](int j, bool (&ok)[kPer]) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int key = j * kKeyTile + lane * kPer + i;
        ok[i] = key < t_len && val[key] != 0;
      }
    };
    bool cur[kPer], nxt[kPer];
    if (n_tiles > 0) read_valid(0, cur);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages, k0 = j * kKeyTile;
      if (j + 1 < n_tiles) read_valid(j + 1, nxt);
      if (j >= kStages) async::mbar_wait(empty(st), (j / kStages - 1) & 1);
      bool all = true;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        tags[st * kKeyTile + lane * kPer + i] = cur[i];
        all = all && cur[i];
        cur[i] = nxt[i];
      }
      all = __all_sync(0xffffffffu, all);
      if (lane == 0) flags[st] = all;
      __syncwarp();
      if (lane == 0) {
        async::mbar_expect_tx(full(st), kKBytes + kVBytes);
        async::tma_load_4d(k_slot(st), &tm_kn, full(st), 0, w.head, k0, w.b);
        async::tma_load_4d(k_slot(st) + kKVBox, &tm_kn, full(st), 64, w.head, k0, w.b);
        async::tma_load_3d(k_slot(st) + 2 * kKVBox, &tm_kp, full(st), 0, k0, w.b);
        async::tma_load_4d(v_slot(st), &tm_v, full(st), 0, w.head, k0, w.b);
        async::tma_load_4d(v_slot(st) + kKVBox, &tm_v, full(st), 64, w.head, k0, w.b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ---------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int c = wgi - 1, ct = tid - 128 * wgi;
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int row0 = w.row0 + c * kWgRows;
  const int* wpos = spos + c * kWgRows;
  int wg_min = INT_MAX, wg_max = -1;
  for (int i = 0; i < kWgRows; ++i) {
    wg_min = min(wg_min, wpos[i]);
    wg_max = max(wg_max, wpos[i]);
  }
  const int row_pos[2] = {wpos[16 * warp + g], wpos[16 * warp + g + 8]};
  const int mine =
      __shfl_sync(0xffffffffu, wg_max < 0 ? 0 : min(n_tiles, wg_max / kKeyTile + 1), 0);
  const uint32_t q_base = base + c * kQkBoxes * kQBox;
  async::mbar_wait(q_full, 0);

  float acc[64], s[kSRegs];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float l[2] = {0.f, 0.f}, m[2] = {kNegInf, kNegInf}, alpha[2] = {1.f, 1.f};
  uint32_t pa[kKeyTile / 16][4], pn[kKeyTile / 16][4];

  auto scores = [&](int st) {  // s = Q K^T over 192 columns, committed, not awaited
#pragma unroll
    for (int kk = 0; kk < kQkBoxes * 4; ++kk) {
      const uint32_t koff = (kk & 3) * 32;
      const uint64_t da = wg::sw128_desc(q_base + (kk >> 2) * kQBox + koff);
      const uint64_t db = wg::sw128_desc(k_slot(st) + (kk >> 2) * kKVBox + koff);
      scores_mma(s, da, db, kk > 0);
    }
    wg::commit();
  };
  auto pv = [&](int st) {  // acc += P V from pa, committed, not awaited
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk)
      wg::m64n128k16_rs_mn(acc, pa[kk], wg::sw128_mn_desc(v_slot(st) + kk * 2048, kKVBox));
    wg::commit();
  };
  // s of tile j -> bf16 P in pn; m, l and alpha updated (log2 units).
  // s[4 nt + e]: row 16 warp + g + 8 (e >> 1), key k0 + 8 nt + 2t + (e & 1)
  auto softmax = [&](int j, int st) {
    const int k0 = j * kKeyTile;
    const bool interior = flags[st] && k0 + kKeyTile - 1 <= wg_min;
    const uint8_t* tag = tags + st * kKeyTile;
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKeyTile / 8; ++nt) {
      const uint16_t tg = *reinterpret_cast<const uint16_t*>(tag + 8 * nt + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, col = 8 * nt + 2 * t + (e & 1);
        const bool ok = interior || (((tg >> (8 * (e & 1))) & 0xff) && k0 + col <= row_pos[half]);
        s[4 * nt + e] = ok ? s[4 * nt + e] * sl2 : kNegInf;
        tmax[half] = fmaxf(tmax[half], s[4 * nt + e]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = fmaxf(m[half], quad_max(tmax[half]));
      alpha[half] = causal::ex2(m[half] - m_new);
      m[half] = m_new;
      l[half] *= alpha[half];
    }
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) {
      const int half = (i >> 1) & 1;
      const float p = s[i] == kNegInf ? 0.f : causal::ex2(s[i] - m[half]);
      l[half] += p;
      s[i] = p;
    }
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      pn[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
      pn[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      pn[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      pn[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto rescale = [&]() {  // once no product is in flight
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
  };
  auto take_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pn[kk][i];
  };

  if (mine > 0) {
    async::mbar_wait(full(0), 0);
    wg::fence();
    scores(0);
    wg::wait<0>();
    wg::fence_regs(s);
    softmax(0, 0);
    rescale();
    take_p();
    for (int j = 1; j < mine; ++j) {
      const int st = j % kStages, prev = (j - 1) % kStages;
      async::mbar_wait(full(st), (j / kStages) & 1);
      wg::fence();
      scores(st);
      pv(prev);
      wg::wait<1>();  // the scores; the products of tile j - 1 may still run
      wg::fence_regs(s);
      softmax(j, st);
      wg::wait<0>();
      wg::fence_regs(acc);
      wg::fence_regs(pa);
      async::mbar_arrive(empty(prev));
      rescale();
      take_p();
    }
    wg::fence();
    pv((mine - 1) % kStages);
    wg::wait<0>();
    wg::fence_regs(acc);
    wg::fence_regs(pa);
    async::mbar_arrive(empty((mine - 1) % kStages));
  }
  for (int j = mine; j < n_tiles; ++j) {  // tiles past this warpgroup's rows
    async::mbar_wait(full(j % kStages), (j / kStages) & 1);
    async::mbar_arrive(empty(j % kStages));
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) l[half] = quad_sum(l[half]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * warp + g + 8 * half;
    if (row >= s_len) continue;
    const float inv = 1.f / (l[half] == 0.f ? 1.f : l[half]);
    bf16* o = out + ((static_cast<long long>(w.b) * s_len + row) * hq + w.head) * kV + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      *reinterpret_cast<uint32_t*>(o + 8 * nt) =
          pack_bf16x2(acc[4 * nt + 2 * half] * inv, acc[4 * nt + 2 * half + 1] * inv);
  }
}

}  // namespace mla
}  // namespace o3v

// Plain C interface (loaded with ctypes); each returns cudaGetLastError()
// after its launches.

// Absorbed decode. q_lat (B, S, H, 512) and q_pe (B, S, H, 64) contiguous
// bf16; cache (B, T, 576) bf16, rows contiguous, batch stride cache_sb
// elements, its masked columns finite (they are read and weighted by 0);
// q_pos (B, S) int64; kv_valid (B, T) bytes; part (B, nsplit, S * H, 512)
// and lse (B, nsplit, S * H) float32 scratch; out (B, S, H, 512) bf16.
// nsplit CTAs a batch row and 16 query rows.
extern "C" int o3v_mla_decode(const void* q_lat, const void* q_pe, const void* cache,
                              long long cache_sb, const void* q_pos, const void* kv_valid,
                              void* part, void* lse, void* out, int b, int s_len, int hq,
                              int t_len, int nsplit, float scale, void* stream) {
  using namespace o3v::mla;
  if (b < 1 || s_len < 1 || hq < 1 || t_len < 1 || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_kv;
  const cuuint64_t dims[3] = {kRow, static_cast<cuuint64_t>(t_len), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {kRow * 2, static_cast<cuuint64_t>(cache_sb) * 2};
  const cuuint32_t box[3] = {64, kDecTile, 1};
  if (!encode_bf16<3>(&tm_kv, cache, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = o3v::allow_smem(o3v_mla_decode_kernel, kDecSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int rows = s_len * hq;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nsplit, b, (rows + kDecRows - 1) / kDecRows);
  o3v_mla_decode_kernel<<<grid, kDecThreads, kDecSmem, st>>>(
      tm_kv, static_cast<const o3v::bf16*>(q_lat), static_cast<const o3v::bf16*>(q_pe),
      static_cast<const long long*>(q_pos), static_cast<const uint8_t*>(kv_valid),
      static_cast<float*>(part), static_cast<float*>(lse), s_len, hq, t_len,
      scale * o3v::causal::kLog2e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  o3v_mla_decode_combine_kernel<<<dim3(rows, b), kLatent / 4, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(lse), static_cast<o3v::bf16*>(out),
      nsplit, rows);
  return static_cast<int>(cudaGetLastError());
}

// Expanded prefill. q_nope (B, S, H, 128), q_pe (B, S, H, 64), k_nope (B, T,
// H, 128), k_pe (B, T, 64), v (B, T, H, 128), all bf16 with the last axis
// contiguous and the other strides (elements) given, each a multiple of 8;
// q_pos (B, S) int64; kv_valid (B, T) bytes, contiguous; out (B, S, H, 128)
// bf16, contiguous.
extern "C" int o3v_mla_prefill(const void* q_nope, const void* q_pe, const void* k_nope,
                               const void* k_pe, const void* v, const void* q_pos,
                               const void* kv_valid, void* out, int b, int s_len, int t_len,
                               int hq, long long qn_b, long long qn_s, long long qn_h,
                               long long qp_b, long long qp_s, long long qp_h, long long kn_b,
                               long long kn_t, long long kn_h, long long kp_b, long long kp_t,
                               long long v_b, long long v_t, long long v_h, float scale,
                               void* stream) {
  using namespace o3v::mla;
  if (b < 1 || s_len < 1 || t_len < 1 || hq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t B = b, S = s_len, T = t_len, H = hq;
  CUtensorMap tm_qn, tm_qp, tm_kn, tm_kp, tm_v;
  auto by = [](long long elems) { return static_cast<cuuint64_t>(elems) * 2; };
  const cuuint32_t q_box[4] = {64, 1, o3v::causal::kWgRows, 1};
  const cuuint32_t k_box[4] = {64, 1, kKeyTile, 1};
  const cuuint32_t kp_box[3] = {64, kKeyTile, 1};
  const cuuint64_t qn_dims[4] = {kNope, H, S, B}, qp_dims[4] = {kRope, H, S, B};
  const cuuint64_t kn_dims[4] = {kNope, H, T, B}, kp_dims[3] = {kRope, T, B};
  const cuuint64_t v_dims[4] = {kV, H, T, B};
  const cuuint64_t qn_str[3] = {by(qn_h), by(qn_s), by(qn_b)};
  const cuuint64_t qp_str[3] = {by(qp_h), by(qp_s), by(qp_b)};
  const cuuint64_t kn_str[3] = {by(kn_h), by(kn_t), by(kn_b)};
  const cuuint64_t kp_str[2] = {by(kp_t), by(kp_b)};
  const cuuint64_t v_str[3] = {by(v_h), by(v_t), by(v_b)};
  if (!encode_bf16<4>(&tm_qn, q_nope, qn_dims, qn_str, q_box) ||
      !encode_bf16<4>(&tm_qp, q_pe, qp_dims, qp_str, q_box) ||
      !encode_bf16<4>(&tm_kn, k_nope, kn_dims, kn_str, k_box) ||
      !encode_bf16<3>(&tm_kp, k_pe, kp_dims, kp_str, kp_box) ||
      !encode_bf16<4>(&tm_v, v, v_dims, v_str, k_box))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = o3v::allow_smem(o3v_mla_prefill_kernel, kPreSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int n_qt = (s_len + 2 * o3v::causal::kWgRows - 1) / (2 * o3v::causal::kWgRows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  o3v_mla_prefill_kernel<<<n_qt * b * hq, kCtaThreads, kPreSmem, st>>>(
      tm_qn, tm_qp, tm_kn, tm_kp, tm_v, static_cast<const long long*>(q_pos),
      static_cast<const uint8_t*>(kv_valid), static_cast<o3v::bf16*>(out), s_len, t_len, hq,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
