// Causal GQA flash attention forward for Hopper (sm_90a): K3, in its
// inference (fixed-m) and training (exact, with lse) modes.
//
// Replaces open_o3_video_tpu/ops/flash_attention.py _fwd_kernel, the decoder
// prefill. q (B, S, Hq, D) bf16 arrives prescaled by D^-1/2 and rounded to
// bf16 (the wrapper does that, as the JAX wrapper does). k/v are (B, T, Hkv,
// D) bf16 read through their batch and token strides, so a layer view of the
// stacked (L, B, T, Hkv, D) KV cache is consumed in place. A key t is visible
// to a query row iff t <= q_pos and kv_valid[b, t] != 0; pad rows carry q_pos
// = -1 and see nothing (output 0).
//
//   inference: p = exp(min(s, 60)), acc += bf16(p) @ v, out = acc / l
//   exact:     per key tile m' = max(m, tile max), acc and l scaled by
//              exp(m - m'), p = exp(s - m') -> bf16 -> PV; out = acc / l,
//              lse = m + log l (NEG_INF where l = 0), for K5
//
// What bounds it on the H100: the bf16 tensor cores (~56 GFLOP at the
// slice's prefill, ~9 TFLOP at an 8160-row chunk against 81920 keys); the
// causal skip leaves about half the products. The design (FlashAttention-3's
// shape):
// - A CTA is three warpgroups: a producer and two consumers of 64 query rows
//   each. The producer lowers its registers (setmaxnreg) and one of its
//   threads issues TMA loads: the CTA's Q once, then K and V in 128-key tiles
//   (two 64-column boxes each, 128-byte swizzle) through a ring of kStages
//   slots, full and empty mbarriers per slot, so loads stay in flight under
//   the products. Its first warp also reads the tile's kv_valid into shared
//   memory (the next tile's read while it waits for a free slot) and sets a
//   flag where the whole tile is valid.
// - S = Q K^T is wgmma m64n128k16 with Q and K from shared memory (K rows
//   hold D contiguously: the K-major B operand). P stays in registers: the
//   accumulator layout of S is the register A layout of the PV wgmma, cast
//   to bf16 in place; V is the MN-major B operand (transposed descriptor).
//   A warpgroup issues S of tile j, then P V of tile j - 1, and runs tile
//   j's softmax while the second product is in flight (FA3's
//   intra-warpgroup overlap); the two warpgroups interleave on their own.
// - A key tile fully at or below the warpgroup's smallest query position and
//   fully valid (the flag) takes a path with no mask; diagonal and edge
//   tiles take the masked one. Tiles past the CTA's largest position are
//   never loaded; a warpgroup skips the products of tiles past its own.
// - Query tiles run longest first (the last tiles, which see the most keys,
//   get the lowest block indices): a static order, so the result's bits do
//   not depend on timing. The CTA, its order and its producer are
//   causal_cta.cuh's, shared with K5's dq.
// - exp2 with log2(e) folded in (the 60 clamp is applied in natural-log
//   units before the fold), by the SFU's ex2.approx.
// - A CTA holds 128 query rows of one head; the GQA group's heads find each
//   K/V tile in L2. (Two heads of a group over 64 rows each, one tile
//   feeding both, also feed 128 rows per tile and ran slower: PERF.md.)
#include <climits>

#include "causal_cta.cuh"
#include "wgmma.cuh"

namespace o3v {
namespace k3 {

using namespace causal;
constexpr int kKeyTile = 128;           // keys per ring slot
constexpr int kStages = 3;              // ring slots
constexpr int kQBytes = 2 * 2 * kQBox;            // two warpgroups, two halves
constexpr int kKVBox = kKeyTile * kHalfBox;       // 16 KB: 128 keys, 64 columns
constexpr int kKVBytes = 2 * kKVBox;              // one K (or V) tile
constexpr int kKOff = kQBytes;
constexpr int kVOff = kKOff + kStages * kKVBytes;
constexpr int kTagOff = kVOff + kStages * kKVBytes;  // a byte per key: kv_valid != 0
constexpr int kFlagOff = kTagOff + kStages * kKeyTile;
constexpr int kPosOff = (kFlagOff + kStages * 4 + 15) & ~15;  // the CTA's query positions
constexpr int kBarOff = kPosOff + 2 * kWgRows * 4;
constexpr int kLayout = kBarOff + (1 + 2 * kStages) * 8;
constexpr int kSmem = kLayout + 1024;             // slack to align the base to 1024
static_assert(kSmem <= 232448, "shared memory layout");
constexpr float kLn2 = 0.6931471805599453f;

template <bool EXACT>
__global__ void __launch_bounds__(kCtaThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const int* __restrict__ q_pos, const int* __restrict__ kv_valid,
                                 bf16* __restrict__ out, float* __restrict__ lse, int s_len,
                                 int t_len, int hq, int group) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = async::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle needs 1024-byte alignment
  uint8_t* gbase = smem_raw + (base - raw);
  uint8_t* tags = gbase + kTagOff;
  int* flags = reinterpret_cast<int*>(gbase + kFlagOff);
  int* spos = reinterpret_cast<int*>(gbase + kPosOff);
  const uint32_t bars = base + kBarOff;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_slot = [&](int s) { return base + kKOff + s * kKVBytes; };
  auto v_slot = [&](int s) { return base + kVOff + s * kKVBytes; };

  const Work w = cta_work(s_len, hq);
  const int tid = threadIdx.x;
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform in each warp
  if (tid < 2 * kWgRows) {
    const int row = w.row0 + tid;
    spos[tid] = row < s_len ? q_pos[static_cast<long long>(w.b) * s_len + row] : -1;
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
  // Causal skip: key tiles past the CTA's largest query position are never loaded.
  const int k_end = min(t_len, max_pos + 1);
  const int n_tiles = (k_end + kKeyTile - 1) / kKeyTile;
  if (wgi == 0) {
    // ---- producer ---------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      async::mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < 2; ++c)
        for (int h = 0; h < 2; ++h)
          async::tma_load_4d(base + (2 * c + h) * kQBox, &tm_q, q_full, h * 64, w.head,
                             w.row0 + c * kWgRows, w.b);
    }
    produce_kv<kKeyTile, kStages>(&tm_k, &tm_v, w, w.head / group, kv_valid, t_len, n_tiles,
                                  k_slot(0), v_slot(0), full(0), empty(0), tags, flags, lane);
    return;
  }

  // ---- consumers: 64 query rows each -------------------------------------
  // S of tile j is in flight while P of tile j - 1 multiplies V (FA3's
  // intra-warpgroup overlap): the softmax of one tile runs under the
  // tensor cores' work on the other.
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
  // the tiles this warpgroup multiplies: those at or below its largest
  // position (uniform in the warpgroup; the shuffle lets the compiler see it)
  const int mine = __shfl_sync(0xffffffffu, wg_max < 0 ? 0 : min(n_tiles, wg_max / kKeyTile + 1), 0);
  const uint32_t q_base = base + c * 2 * kQBox;
  async::mbar_wait(q_full, 0);

  float acc[64], s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float l[2] = {0.f, 0.f}, m[2] = {kNegInf, kNegInf}, alpha[2] = {1.f, 1.f};
  uint32_t pa[kKeyTile / 16][4], pn[kKeyTile / 16][4];

  auto scores = [&](int st) {  // s = Q K^T, committed, not awaited
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t koff = (kk & 3) * 32;
      wg::m64n128k16(s, wg::sw128_desc(q_base + (kk >> 2) * kQBox + koff),
                     wg::sw128_desc(k_slot(st) + (kk >> 2) * kKVBox + koff), kk > 0);
    }
    wg::commit();
  };
  auto pv = [&](int st) {  // acc += P V from pa, committed, not awaited
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk)
      wg::m64n128k16_rs_mn(acc, pa[kk], wg::sw128_mn_desc(v_slot(st) + kk * 2048, kKVBox));
    wg::commit();
  };
  // s of tile j -> bf16 P in pn; l (and m, alpha in exact mode) updated.
  // s[4 nt + e]: row 16 warp + g + 8 (e >> 1), key k0 + 8 nt + 2t + (e & 1)
  auto softmax = [&](int j, int st) {
    const int k0 = j * kKeyTile;
    const bool interior = flags[st] && k0 + kKeyTile - 1 <= wg_min;
    const uint8_t* tag = tags + st * kKeyTile;
    if constexpr (!EXACT) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const uint16_t tg = *reinterpret_cast<const uint16_t*>(tag + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1, col = 8 * nt + 2 * t + (e & 1);
          const bool ok = interior || (((tg >> (8 * (e & 1))) & 0xff) && k0 + col <= row_pos[half]);
          const float p = ok ? ex2(fminf(s[4 * nt + e], kClamp) * kLog2e) : 0.f;
          l[half] += p;
          s[4 * nt + e] = p;
        }
      }
    } else {
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const uint16_t tg = *reinterpret_cast<const uint16_t*>(tag + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1, col = 8 * nt + 2 * t + (e & 1);
          const bool ok = interior || (((tg >> (8 * (e & 1))) & 0xff) && k0 + col <= row_pos[half]);
          s[4 * nt + e] = ok ? s[4 * nt + e] * kLog2e : kNegInf;  // log2 units
          tmax[half] = fmaxf(tmax[half], s[4 * nt + e]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float m_new = fmaxf(m[half], quad_max(tmax[half]));
        alpha[half] = ex2(m[half] - m_new);
        m[half] = m_new;
        l[half] *= alpha[half];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int half = (i >> 1) & 1;
        const float p = s[i] == kNegInf ? 0.f : ex2(s[i] - m[half]);
        l[half] += p;
        s[i] = p;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      pn[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
      pn[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      pn[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      pn[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // acc scaled by the latest alpha (exact mode), once no product is in flight
  auto rescale = [&]() {
    if constexpr (EXACT) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
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
      scores(j % kStages);
      pv(prev);
      wg::wait<1>();  // the scores; the products of tile j - 1 may still run
      wg::fence_regs(s);
      softmax(j, st);
      wg::wait<0>();
      wg::fence_regs(acc);
      wg::fence_regs(pa);  // the products read pa until here
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
    bf16* o = out + ((static_cast<long long>(w.b) * s_len + row) * hq + w.head) * kD + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      *reinterpret_cast<uint32_t*>(o + 8 * nt) =
          pack_bf16x2(acc[4 * nt + 2 * half] * inv, acc[4 * nt + 2 * half + 1] * inv);
    if (EXACT && t == 0)
      lse[(static_cast<long long>(w.b) * hq + w.head) * s_len + row] =
          l[half] == 0.f ? kNegInf : (m[half] + log2f(l[half])) * kLn2;
  }
}

template <bool EXACT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_valid, void* out, void* lse, int b, int s_len, int t_len, int hq,
                   int hkv, long long k_stride_b, long long k_stride_t, long long v_stride_b,
                   long long v_stride_t, cudaStream_t stream) {
  if (b < 1 || s_len < 1 || t_len < 1 || hkv < 1 || hq % hkv != 0) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  const cuuint64_t q_dims[4] = {kD, static_cast<cuuint64_t>(hq), static_cast<cuuint64_t>(s_len),
                                static_cast<cuuint64_t>(b)};
  const cuuint64_t q_strides[3] = {kD * 2, static_cast<cuuint64_t>(hq) * kD * 2,
                                   static_cast<cuuint64_t>(s_len) * hq * kD * 2};
  const cuuint32_t q_box[4] = {64, 1, kWgRows, 1};
  const cuuint64_t kv_dims[4] = {kD, static_cast<cuuint64_t>(hkv), static_cast<cuuint64_t>(t_len),
                                 static_cast<cuuint64_t>(b)};
  const cuuint64_t k_strides[3] = {kD * 2, static_cast<cuuint64_t>(k_stride_t) * 2,
                                   static_cast<cuuint64_t>(k_stride_b) * 2};
  const cuuint64_t v_strides[3] = {kD * 2, static_cast<cuuint64_t>(v_stride_t) * 2,
                                   static_cast<cuuint64_t>(v_stride_b) * 2};
  const cuuint32_t kv_box[4] = {64, 1, kKeyTile, 1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!async::encode_4d(&tm_q, bf, q, q_dims, q_strides, q_box, sw) ||
      !async::encode_4d(&tm_k, bf, k, kv_dims, k_strides, kv_box, sw) ||
      !async::encode_4d(&tm_v, bf, v, kv_dims, v_strides, kv_box, sw))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is per function; set it once
  if (!smem_set) {
    const cudaError_t err = allow_smem(flash_attention_wgmma_kernel<EXACT>, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int group = hq / hkv;
  const int n_qt = (s_len + 2 * kWgRows - 1) / (2 * kWgRows);
  flash_attention_wgmma_kernel<EXACT><<<n_qt * b * hq, kCtaThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int*>(q_pos), static_cast<const int*>(kv_valid),
      static_cast<bf16*>(out), static_cast<float*>(lse), s_len, t_len, hq, group);
  return cudaGetLastError();
}

}  // namespace k3
}  // namespace o3v

// Plain C interface (loaded with ctypes); returns cudaGetLastError() after the
// launch. Strides are in elements and must keep every token row on a 16-byte
// boundary (TMA). Built for the decoder's head_dim of 128 only.
extern "C" int o3v_flash_attention_gqa(const void* q, const void* k, const void* v,
                                       const void* q_pos, const void* kv_valid, void* out, int b,
                                       int s_len, int t_len, int hq, int hkv, int head_dim,
                                       long long k_stride_b, long long k_stride_t,
                                       long long v_stride_b, long long v_stride_t,
                                       void* stream) {
  if (head_dim != o3v::k3::kD) return static_cast<int>(cudaErrorInvalidValue);
  return o3v::k3::launch<false>(q, k, v, q_pos, kv_valid, out, nullptr, b, s_len, t_len, hq, hkv,
                                k_stride_b, k_stride_t, v_stride_b, v_stride_t,
                                static_cast<cudaStream_t>(stream));
}

// Exact mode: as above, plus lse (B, Hq, S) float32.
extern "C" int o3v_flash_attention_gqa_exact(const void* q, const void* k, const void* v,
                                             const void* q_pos, const void* kv_valid, void* out,
                                             void* lse, int b, int s_len, int t_len, int hq,
                                             int hkv, int head_dim, long long k_stride_b,
                                             long long k_stride_t, long long v_stride_b,
                                             long long v_stride_t, void* stream) {
  if (head_dim != o3v::k3::kD) return static_cast<int>(cudaErrorInvalidValue);
  return o3v::k3::launch<true>(q, k, v, q_pos, kv_valid, out, lse, b, s_len, t_len, hq, hkv,
                               k_stride_b, k_stride_t, v_stride_b, v_stride_t,
                               static_cast<cudaStream_t>(stream));
}
