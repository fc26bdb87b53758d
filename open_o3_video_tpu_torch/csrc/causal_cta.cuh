// The CTA shared by K3 (flash_attention.cu) and K5's dq
// (flash_attention_bwd.cu), causal GQA attention over the decoder's head_dim
// of 128 on Hopper: three warpgroups, a TMA producer and two wgmma consumers
// of 64 query rows each, 128 query rows of one head a CTA, in a static
// order that puts the longest query tiles first
// (ops/flash_attention.py:cta_plan mirrors it). The producer's first warp
// feeds K and V tiles through a ring of full and empty mbarriers, with each
// tile's kv_valid as a byte per key and a flag where the whole tile is valid.
#pragma once

#include "async_copy.cuh"
#include "attention_tile.cuh"

namespace o3v {
namespace causal {

constexpr int kD = 128;                 // head_dim, the decoder's
constexpr int kWgRows = 64;             // query rows per consumer warpgroup
constexpr int kCtaThreads = 384;        // producer + two consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kHalfBox = 64 * 2;                  // bytes of a 64-column box row
constexpr int kQBox = kWgRows * kHalfBox;         // 8 KB: 64 rows, 64 columns
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The CTA's work: blockIdx.x -> (batch row, head, first of its 128 query
// rows). Query tiles are taken from the last: all (b, head) units of the
// last tile first.
struct Work {
  int b, head, row0;
};

__device__ __forceinline__ Work cta_work(int s_len, int hq) {
  const int n_qt = (s_len + 2 * kWgRows - 1) / (2 * kWgRows);
  const int units = gridDim.x / n_qt;
  const int unit = blockIdx.x % units;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / units;
  return {unit / hq, unit % hq, qt * 2 * kWgRows};
}

// The producer's first warp (lane = its lane): n_tiles tiles of KEYS keys of
// kv head hk, K into k_base and V into v_base + s * (KEYS * 256 bytes) of
// slot s = j % STAGES (two 64-column boxes each), full barrier full0 + 8 s,
// after the slot's empty barrier (empty0 + 8 s) once the ring has wrapped.
// Before each load it writes the tile's kv_valid (a byte per key) to tags +
// s * KEYS and whether all are valid to flags[s]; the next tile's kv_valid
// is read while this one's slot is awaited.
template <int KEYS, int STAGES>
__device__ __forceinline__ void produce_kv(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                           const Work& w, int hk, const int* kv_valid, int t_len,
                                           int n_tiles, uint32_t k_base, uint32_t v_base,
                                           uint32_t full0, uint32_t empty0, uint8_t* tags,
                                           int* flags, int lane) {
  constexpr int kPer = KEYS / 32;            // keys per lane
  constexpr int kBox = KEYS * kHalfBox;      // one 64-column box of a tile
  const int* valid = kv_valid + static_cast<long long>(w.b) * t_len;
  auto read_valid = [&](int j, bool (&ok)[kPer]) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int key = j * KEYS + lane * kPer + i;
      ok[i] = key < t_len && valid[key] != 0;
    }
  };
  bool cur[kPer], nxt[kPer];
  if (n_tiles > 0) read_valid(0, cur);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES, k0 = j * KEYS;
    if (j + 1 < n_tiles) read_valid(j + 1, nxt);
    if (j >= STAGES) async::mbar_wait(empty0 + 8 * st, (j / STAGES - 1) & 1);
    bool all = true;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      tags[st * KEYS + lane * kPer + i] = cur[i];
      all = all && cur[i];
      cur[i] = nxt[i];
    }
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) flags[st] = all;
    __syncwarp();
    if (lane == 0) {
      const uint32_t full = full0 + 8 * st;
      async::mbar_expect_tx(full, 4 * kBox);
      for (int h = 0; h < 2; ++h) {
        async::tma_load_4d(k_base + st * 2 * kBox + h * kBox, tm_k, full, h * 64, hk, k0, w.b);
        async::tma_load_4d(v_base + st * 2 * kBox + h * kBox, tm_v, full, h * 64, hk, k0, w.b);
      }
    }
  }
}

}  // namespace causal
}  // namespace o3v
