// ViT window (segment) attention for Hopper (sm_90a): K1 and K2, in their
// inference (fixed-m) and training (exact) modes.
//
// K1 fused_window_attention replaces open_o3_video_tpu/ops/window_attention.py
// _fused_fwd_kernel (the 28 windowed blocks of the Qwen2.5-VL tower). It reads
// the raw qkv projection (N, W, 3*H*D) bf16 once, applies the 2D rotary
// embedding to q and k in f32 (cos/sin (N, W, D) f32) and rounds them to bf16,
// runs masked bidirectional attention where ids_q == ids_k != 0 (several
// packed edge windows share a row), and writes (N, W, H*D) bf16 at lane
// offset h*D: the layout the output projection reads. Nothing but qkv, the
// tables and ids in and attn out touches device memory. At W = 64 it does
// about 33 FLOP per byte of qkv read, far under the ~295 FLOP/byte at which
// bf16 tensor cores become the limit, so it is bound by device-memory bytes,
// and a design that waits on each load in turn is bound by their latency.
// - At the packed row widths (W = 64 and 128) a CTA takes one head of one
//   row (window_row.cuh), its q, k, v slabs coming by TMA, with no wait
//   between the loads. Each warp holds its 16 query rows against all W
//   keys in registers, ropes its own positions of q (straight into its A
//   fragments) and k (written back for the other warps) with the row's
//   cos/sin read at those positions, and in exact mode forms p = exp(s -
//   m) / l in one pass, the whole row's scores being in hand.
// - Other widths take the general route: one CTA per (64-row query tile,
//   head, row), keys in 64-row tiles, rope applied as the tiles are staged,
//   exact mode in two passes.
//
// K2 window_attention replaces ops/window_attention.py _fwd_kernel (the 4
// global blocks, over whole frames: W = 448, 432 valid, at 18x24 patches;
// and every block of the towers without windows: Qwen2-VL's 32 at D = 80,
// Qwen3-VL's 27 at D = 72, W = 352 at 16x22 patches and 784 at 28x28; the
// tiles and products of window_frame.cuh, built for D = 72 and 80 in both
// modes).
// Same masked attention on q/k/v (N, W, H, D) bf16, no rope. The TPU kernel
// holds the whole W x W score tile and falls back to XLA past a size limit;
// here every width W runs. A frame-head's K and V are read once and kept:
// - A CTA serves one (frame, head) with 14 consumer warps of 16 query rows
//   each (the 28 strips of W = 448 in two rounds) and a producer warp (two
//   CTAs per frame-head, each loading K/V for half the rows, ran slower). Its frame-head's K and V (2 x 448 x 80 bf16 at W = 448)
//   stay resident in dynamic shared memory, loaded once by TMA in 64-key
//   tiles, one mbarrier per tile, so the first tile's products start while
//   later tiles land. Each warp walks its query rows against the resident
//   tiles; no __syncthreads after the start.
// - The exact mode's first pass (max and sum) waits for the K tiles only,
//   and its second (p / l -> bf16 -> PV) reads the same tiles: K and V leave
//   device memory once.
// - Tiles are rows of D + 8 = 88 bf16 (176 bytes) at D = 80, so the ldmatrix
//   loads of the mma.sync fragments are conflict-free: the TMA box is 88
//   columns wide from the head's first column and brings 8 columns of the
//   next head (or zeros past the last) that nothing reads. At D = 72 the
//   rows are the head's 72 columns (144 bytes, conflict-free already), and
//   the last 8 of them go through an m16n8k8 (scores) and one more 8-wide
//   d-tile (PV). Rows past W are zero-filled by the TMA and masked by their
//   key tags.
// - With K/V resident the time is the warps' own: the products, the
//   exponentials and their latency. So a warp takes a tile in two 32-key
//   halves, unrolled so that one half's exponentials overlap the other's
//   products within the 136 registers that 15 warps allow, reads K and V
//   fragments by ldmatrix (x4: two n-tiles at once; V transposed), keeps
//   scores in log2 units (one multiply before ex2.approx) and its key tags
//   in registers.
// - Past 10 tiles (W > 640) at D = 80, 12 (W > 768) at D = 72, K and V do
//   not fit; the same kernel then streams
//   them through a ring of 8 tile slots that the producer refills as the
//   consumer warps free them, each CTA covering 8 strips of 16 query rows.
//   The exact mode then reads K twice.
// At the slice's shapes the products and the exponentials set the time (~60
// MFLOP and ~0.19M exponentials per frame-head, against ~0.29 MB of q, k, v
// and out); the exact mode's two passes compute the scores and exponentials
// twice. wgmma is later work.
#include "async_copy.cuh"
#include "attention_tile.cuh"
#include "window_frame.cuh"
#include "window_row.cuh"

namespace o3v {

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_window_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ cos,
                                  const float* __restrict__ sin, const int* __restrict__ ids,
                                  bf16* __restrict__ out, int w, int heads, float scale) {
  __shared__ __align__(16) Tile<D> sk;
  __shared__ __align__(16) Tile<D> sv;
  __shared__ int skey[kKeys];
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, n = blockIdx.z;
  const int hd = heads * D;
  const long long row_stride = 3LL * hd;
  const bf16* base = qkv + static_cast<long long>(n) * w * row_stride + h * D;
  const float* cs = cos + static_cast<long long>(n) * w * D;
  const float* sn = sin + static_cast<long long>(n) * w * D;
  const int* id = ids + static_cast<long long>(n) * w;

  load_rope_tile<D>(sk, base, row_stride, cs, sn, q0, w);  // q, staged in the key buffer
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = q0 + warp * 16 + (lane >> 2);
  const int row_tag[2] = {r < w ? id[r] : 0, r + 8 < w ? id[r + 8] : 0};

  float acc[D / 8][4] = {};
  float l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < w; k0 += kKeys) {
    __syncthreads();
    load_rope_tile<D>(sk, base + hd, row_stride, cs, sn, k0, w);
    load_tile<D>(sv, base + 2 * hd, row_stride, k0, w);
    if (threadIdx.x < kKeys) skey[threadIdx.x] = k0 + threadIdx.x < w ? id[k0 + threadIdx.x] : 0;
    __syncthreads();
    attend_tile<D>(qa, sk, sv, skey, row_tag, scale, acc, l);
  }
  bf16* ob = out + static_cast<long long>(n) * w * hd + h * D;
  store_rows<D>(acc, l, q0, w, [&](int row) { return ob + static_cast<long long>(row) * hd; });
}

// Exact mode (training): the JAX kernels with exact=True, p = exp(s - m) / l
// normalized BEFORE its cast to bf16 for the PV product. Two passes over the
// key tiles: the first finds each row's max m and sum l (online, rescaling l
// by exp(m_old - m_new)), the second forms p / l -> bf16 -> PV, so the
// rounding of p matches JAX's at any row width (one tile at W = 64, whose
// keys then stay in shared memory for both passes). Scores are masked to
// NEG_INF; a pad row (id 0) scores 0 on all W keys of its row, the uniform
// softmax that JAX's all-NEG_INF row gives.
template <int D, typename LoadKV>
__device__ __forceinline__ void window_exact_rows(const uint32_t (&qa)[D / 16][4], Tile<D>& sk,
                                                  Tile<D>& sv, const int* skey, int w,
                                                  const int (&row_tag)[2], float scale,
                                                  float (&acc)[D / 8][4], float (&m)[2],
                                                  float (&l)[2], LoadKV load_kv) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kN = kKeys / 8;
  const int n_tiles = (w + kKeys - 1) / kKeys;
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kKeys;
      if (n_tiles > 1 || pass == 0) {
        __syncthreads();
        load_kv(k0);
        __syncthreads();
      }
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
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t + (e & 1), half = e >> 1;
          s[nt][e] = visible<kSegment>(row_tag[half], skey[c], k0 + c)
                         ? score<kSegment>(s[nt][e], row_tag[half], scale) : kNegInf;
          tmax[half] = fmaxf(tmax[half], s[nt][e]);
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float m_new = fmaxf(m[half], quad_max(tmax[half]));
          l[half] *= expf(m[half] - m_new);
          m[half] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + 2 * t + (e & 1), half = e >> 1;
            if (visible<kSegment>(row_tag[half], skey[c], k0 + c))
              l[half] += expf(s[nt][e] - m[half]);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + 2 * t + (e & 1), half = e >> 1;
            s[nt][e] = visible<kSegment>(row_tag[half], skey[c], k0 + c)
                           ? expf(s[nt][e] - m[half]) / l[half] : 0.f;
          }
        accumulate_xb<D, kN>(acc, s, sv);
      }
    }
    if (pass == 0) {
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_window_attention_exact_kernel(const bf16* __restrict__ qkv,
                                        const float* __restrict__ cos,
                                        const float* __restrict__ sin,
                                        const int* __restrict__ ids, bf16* __restrict__ out,
                                        int w, int heads, float scale) {
  __shared__ __align__(16) Tile<D> sk;
  __shared__ __align__(16) Tile<D> sv;
  __shared__ int skey[kKeys];
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, n = blockIdx.z;
  const int hd = heads * D;
  const long long row_stride = 3LL * hd;
  const bf16* base = qkv + static_cast<long long>(n) * w * row_stride + h * D;
  const float* cs = cos + static_cast<long long>(n) * w * D;
  const float* sn = sin + static_cast<long long>(n) * w * D;
  const int* id = ids + static_cast<long long>(n) * w;

  load_rope_tile<D>(sk, base, row_stride, cs, sn, q0, w);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = q0 + warp * 16 + (lane >> 2);
  const int row_tag[2] = {r < w ? id[r] : -2, r + 8 < w ? id[r + 8] : -2};

  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  window_exact_rows<D>(qa, sk, sv, skey, w, row_tag, scale, acc, m, l, [&](int k0) {
    load_rope_tile<D>(sk, base + hd, row_stride, cs, sn, k0, w);
    load_tile<D>(sv, base + 2 * hd, row_stride, k0, w);
    if (threadIdx.x < kKeys) skey[threadIdx.x] = k0 + threadIdx.x < w ? id[k0 + threadIdx.x] : -1;
  });
  bf16* ob = out + static_cast<long long>(n) * w * hd + h * D;
  store_frags<D>(acc, 1.f, q0 + warp * 16, w,
                 [&](int row) { return ob + static_cast<long long>(row) * hd; });
}

// ---- K1 at the packed row widths (W = 64, 128): see window_row.cuh -------

// One head of one row, its q, k, v slabs landed (sl[0..2]) and this
// thread's cos/sin in hand: k is roped in place for the other warps, this
// warp's 16 query rows attend to all W keys, and the head's lanes of the
// output row (`ob`, row stride hd) are written.
template <int D, int W, bool EXACT>
__device__ __forceinline__ void fused_row_head(row::Slab<D, W>* sl, const float2 (&c)[2][D / 8],
                                               const float2 (&s)[2][D / 8], const int* tag,
                                               bf16* ob, int hd, float scale) {
  const int g = (threadIdx.x & 31) >> 2, r0 = (threadIdx.x >> 5) * 16;
  uint32_t qa[D / 16][4];
  {
    float2 x[2][D / 8];
    row::read_own<D, W>(x, sl[0], r0);
    row::rope<D>(x, c, s);
    row::own_to_a<D>(qa, x);
    row::read_own<D, W>(x, sl[1], r0);
    row::rope<D>(x, c, s);
    row::write_own<D, W>(sl[1], x, r0);
  }
  __syncthreads();  // every warp's rows of k roped
  const int row_tag[2] = {tag[r0 + g], tag[r0 + g + 8]};
  float p[W / 8][4];
  row::scores<D, W>(p, qa, sl[1]);
  float acc[D / 8][4] = {};
  auto out_row = [&](int r) { return ob + static_cast<long long>(r) * hd; };
  if constexpr (EXACT) {
    row::exact_softmax<W>(p, tag, row_tag, scale);
    row::times_slab<D, W>(acc, p, sl[2]);
  } else {  // p = exp(min(s, 60)) where the ids match
    const float scale2 = scale * row::kLog2e;
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt) {
      const int2 kt = row::key_tags(tag, nt);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, key = e & 1 ? kt.y : kt.x;
        p[nt][e] = row_tag[half] != 0 && key == row_tag[half]
                       ? row::exp2_approx(fminf(p[nt][e] * scale2, kClamp * row::kLog2e)) : 0.f;
        l[half] += p[nt][e];
      }
    }
    row::times_slab<D, W>(acc, p, sl[2]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // acc / l, 0 where l == 0 (acc is 0 there)
      l[half] = quad_sum(l[half]);
      const float inv = l[half] == 0.f ? 1.f : 1.f / l[half];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * half] *= inv;
        acc[dt][2 * half + 1] *= inv;
      }
    }
  }
  store_frags<D>(acc, 1.f, r0, W, out_row);
}

// A CTA per (row n, head h): blockIdx.x = n * heads + h. The head's q, k, v
// slabs come by TMA on one mbarrier while each thread reads its cos/sin.
template <int D, int W, bool EXACT>
__global__ void __launch_bounds__(2 * W, row::k1_min_ctas(W))
    fused_window_rows_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                             const float* __restrict__ cos, const float* __restrict__ sin,
                             const int* __restrict__ ids, bf16* __restrict__ out, int heads,
                             float scale) {
  static_assert(D + kPad == row::kBoxCols, "the TMA box is built for D = 80");
  extern __shared__ uint8_t smem_raw[];
  row::Slab<D, W>* slab = row::slabs<D, W>(smem_raw);  // q, k, v
  int* tag = reinterpret_cast<int*>(slab + 3);
  const uint32_t bar = async::smem_u32(tag + W);
  const int n = blockIdx.x / heads, h = blockIdx.x % heads, hd = heads * D;
  const long long row0 = static_cast<long long>(n) * W;
  row::begin<W>(tag, ids + row0, bar);
  if (threadIdx.x == 0) {
    async::mbar_expect_tx(bar, 3 * row::kSlabBytes<D, W>);
    for (int part = 0; part < 3; ++part)
      async::tma_load_2d(async::smem_u32(slab + part), &tm_qkv, bar, part * hd + h * D, n * W);
  }
  float2 c[2][D / 8], s[2][D / 8];
  const int r0 = (threadIdx.x >> 5) * 16;
  row::load_tab<D>(c, cos + row0 * D, r0);
  row::load_tab<D>(s, sin + row0 * D, r0);
  async::mbar_wait(bar, 0);
  fused_row_head<D, W, EXACT>(slab, c, s, tag, out + row0 * hd + h * D, hd, scale);
}

// ---- K2: a frame-head's K and V resident in shared memory ------------------

constexpr int kWWarps = 14;                    // consumer warps, 16 query rows each
constexpr int kWThreads = 32 * (kWWarps + 1);  // and one producer warp

// Query rows [16 strip, 16 strip + 16) of (frame n, head h): a strip per warp
// at a time. RESIDENT: all n_tiles K/V tiles were loaded once (barrier tile
// for K, n_tiles + tile for V, each completing once). Otherwise: load i of
// the producer's sequence (tiles 0..n_tiles-1 once, twice in exact mode: K
// alone, then K and V) sits in slot i % ring, on barrier slot (full) and
// ring + slot (empty, one arrive per consumer warp).
template <int D, bool EXACT, bool RESIDENT>
__global__ void __launch_bounds__(kWThreads, 1)
    window_attention_tma_kernel(const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const bf16* __restrict__ q, const int* __restrict__ ids,
                                bf16* __restrict__ out, float* __restrict__ lse, int w, int heads,
                                float scale, int n_tiles, int ring) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = async::smem_u32(smem_raw);
  const uint32_t base = (raw + frame::kAlign - 1) & ~static_cast<uint32_t>(frame::kAlign - 1);
  uint8_t* gbase = smem_raw + (base - raw);
  frame::FTile<D>* sk = reinterpret_cast<frame::FTile<D>*>(gbase);
  frame::FTile<D>* sv = sk + ring;
  int* stag = reinterpret_cast<int*>(sv + ring);
  const uint32_t bars = base + 2 * ring * frame::kTileBytes<D> + n_tiles * kKeys * 4;
  auto bar = [&](int i) { return bars + 8 * i; };

  const int h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strips = (w + 15) / 16;
  // this CTA's strips: all of the frame-head's (resident), or kWWarps
  const int first = RESIDENT ? 0 : blockIdx.x * kWWarps;
  const int last = RESIDENT ? strips : min(strips, first + kWWarps);
  const int* id = ids + static_cast<long long>(n) * w;
  for (int i = threadIdx.x; i < n_tiles * kKeys; i += kWThreads) stag[i] = i < w ? id[i] : (EXACT ? -1 : 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < ring; ++i) {
      async::mbar_init(bar(i), 1);
      async::mbar_init(bar(ring + i), RESIDENT ? 1 : min(kWWarps, last - first));
    }
    async::mbar_fence_init();
  }
  __syncthreads();

  const int loads = (EXACT ? 2 : 1) * n_tiles;
  if (warp == kWWarps) {  // ---- producer: TMA loads of 64-key tiles --------
    if (lane != 0) return;
    for (int i = 0; i < (RESIDENT ? 2 * n_tiles : loads); ++i) {
      int tile, slot;
      bool with_k = true, with_v = true;
      uint32_t b;
      if constexpr (RESIDENT) {  // exact mode: all K tiles first, its first pass needs no V
        with_k = EXACT ? i < n_tiles : (i & 1) == 0;
        with_v = !with_k;
        tile = slot = EXACT ? i % n_tiles : i / 2;
        b = bar(with_k ? tile : n_tiles + tile);
      } else {
        tile = i % n_tiles;
        slot = i % ring;
        with_v = !EXACT || i >= n_tiles;
        b = bar(slot);
        if (i >= ring) async::mbar_wait(bar(ring + slot), (i / ring - 1) & 1);
      }
      async::mbar_expect_tx(b, (with_k + with_v) * frame::kTileBytes<D>);
      if (with_k) async::tma_load_3d(async::smem_u32(sk + slot), &tm_k, b, h * D, tile * kKeys, n);
      if (with_v) async::tma_load_3d(async::smem_u32(sv + slot), &tm_v, b, h * D, tile * kKeys, n);
    }
    return;
  }

  // ---- consumers ---------------------------------------------------------
  // load i of the sequence: wait for its K (and V) and return its slot
  auto acquire = [&](int i, bool need_v) {
    const int tile = i % n_tiles;
    if constexpr (RESIDENT) {
      async::mbar_wait(bar(tile), 0);
      if (need_v) async::mbar_wait(bar(n_tiles + tile), 0);
      return tile;
    } else {
      async::mbar_wait(bar(i % ring), (i / ring) & 1);
      return i % ring;
    }
  };
  auto release = [&](int slot) {
    if constexpr (!RESIDENT) {
      __syncwarp();
      if (lane == 0) async::mbar_arrive(bar(ring + slot));
    }
  };
  const int g = lane >> 2, t = lane & 3;
  const long long row_stride = static_cast<long long>(heads) * D;
  const long long off = static_cast<long long>(n) * w * row_stride + h * D;
  for (int strip = first + warp; strip < last; strip += kWWarps) {
    const int r = strip * 16 + g;
    uint32_t qa[frame::kKSteps<D>][4];
    frame::a_frags<D>(qa, q + off, row_stride, r, w);
    const int row_tag[2] = {r < w ? stag[r] : (EXACT ? -2 : 0), r + 8 < w ? stag[r + 8] : (EXACT ? -2 : 0)};
    float acc[D / 8][4] = {};
    bf16* ob = out + off;
    float s[frame::kHalfN][4];
    int2 tag[frame::kHalfN];
    const float scale2 = scale * frame::kLog2e;  // scores in log2 units: exp(x) = 2^(x log2 e)
    if constexpr (!EXACT) {  // p = exp(min(s, 60)) where the ids match
      const bool row_ok[2] = {row_tag[0] != 0, row_tag[1] != 0};
      float l[2] = {0.f, 0.f};
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int slot = acquire(kt, true);
#pragma unroll
        for (int k0 = 0; k0 < kKeys; k0 += frame::kHalf) {
          frame::scores<D>(s, qa, sk[slot], k0);
          frame::pairs(tag, stag + kt * kKeys + k0);
#pragma unroll
          for (int nt = 0; nt < frame::kHalfN; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int half = e >> 1, key = e & 1 ? tag[nt].y : tag[nt].x;
              const float p = row_ok[half] && key == row_tag[half]
                                  ? frame::ex2(fminf(s[nt][e] * scale2, kClamp * frame::kLog2e)) : 0.f;
              l[half] += p;
              s[nt][e] = p;
            }
          frame::pv<D>(acc, s, sv[slot], k0);
        }
        release(slot);
      }
      // store_rows counts rows from 16 * warp
      store_rows<D>(acc, l, (strip - warp) * 16, w, [&](int row) { return ob + row * row_stride; });
    } else {  // pass 0: max m and sum l; pass 1: exp(s - m) / l -> bf16 -> PV
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, inv_l[2];
      for (int i = 0; i < loads; ++i) {
        const bool pass1 = i >= n_tiles;
        const int kt = i % n_tiles;
        const int slot = acquire(i, pass1);
#pragma unroll
        for (int k0 = 0; k0 < kKeys; k0 += frame::kHalf) {
          frame::scores<D>(s, qa, sk[slot], k0);
          frame::pairs(tag, stag + kt * kKeys + k0);
          float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
          for (int nt = 0; nt < frame::kHalfN; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int half = e >> 1, key = e & 1 ? tag[nt].y : tag[nt].x;
              s[nt][e] = visible<kSegment>(row_tag[half], key, 0)
                             ? score<kSegment>(s[nt][e], row_tag[half], scale2) : kNegInf;
              tmax[half] = fmaxf(tmax[half], s[nt][e]);
            }
          if (!pass1) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float m_new = fmaxf(m[half], quad_max(tmax[half]));
              l[half] *= frame::ex2(m[half] - m_new);
              m[half] = m_new;
            }
#pragma unroll
            for (int nt = 0; nt < frame::kHalfN; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (s[nt][e] != kNegInf) l[e >> 1] += frame::ex2(s[nt][e] - m[e >> 1]);
          } else {
#pragma unroll
            for (int nt = 0; nt < frame::kHalfN; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[nt][e] = s[nt][e] != kNegInf ? frame::ex2(s[nt][e] - m[e >> 1]) * inv_l[e >> 1] : 0.f;
            frame::pv<D>(acc, s, sv[slot], k0);
          }
        }
        if (i == n_tiles - 1)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            l[half] = quad_sum(l[half]);
            inv_l[half] = 1.f / l[half];
          }
        release(slot);
      }
      store_frags<D>(acc, 1.f, strip * 16, w, [&](int row) { return ob + row * row_stride; });
      if (t == 0) {
        float* lb = lse + (static_cast<long long>(n) * heads + h) * w;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          if (r + 8 * half < w) lb[r + 8 * half] = (m[half] + log2f(l[half])) / frame::kLog2e;
      }
    }
  }
}

template <int D>
cudaError_t launch_fused(const void* qkv, const void* cos, const void* sin, const void* ids,
                         void* out, int n, int w, int heads, float scale, cudaStream_t stream) {
  const dim3 grid((w + kRows - 1) / kRows, heads, n);
  fused_window_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<const int*>(ids), static_cast<bf16*>(out), w,
      heads, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fused_exact(const void* qkv, const void* cos, const void* sin, const void* ids,
                               void* out, int n, int w, int heads, float scale,
                               cudaStream_t stream) {
  const dim3 grid((w + kRows - 1) / kRows, heads, n);
  fused_window_attention_exact_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<const int*>(ids), static_cast<bf16*>(out), w,
      heads, scale);
  return cudaGetLastError();
}

// K1 at W = 64 or 128: one tensor map over qkv as (N * W, 3 * H * D), a
// CTA per (row, head).
template <int D, int W, bool EXACT>
cudaError_t launch_fused_rows(const void* qkv, const void* cos, const void* sin, const void* ids,
                              void* out, int n, int heads, float scale, cudaStream_t stream) {
  CUtensorMap tm;
  if (!row::encode_rows(&tm, qkv, static_cast<long long>(n) * W, 3LL * heads * D, W))
    return cudaErrorInvalidValue;
  return row::launch<fused_window_rows_kernel<D, W, EXACT>, W>(
      n * heads, row::smem_bytes<D, W>(3, 0), stream, tm, static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<const int*>(ids), static_cast<bf16*>(out), heads,
      scale);
}

// K2's launch: the tensor maps of k and v (dims {H*D, W, N}, boxes of
// kPitch<D> columns and 64 keys), then the resident kernel where the frame-head's tiles
// fit (one CTA per frame-head), else the streaming one.
template <int D, bool EXACT>
cudaError_t launch_window_tma(const void* q, const void* k, const void* v, const void* ids, void* out,
                              void* lse, int n, int w, int heads, float scale, cudaStream_t stream) {
  if (w < 1) return cudaErrorInvalidValue;
  CUtensorMap tm[2];
  if (!frame::encode<D>(&tm[0], k, n, w, heads) || !frame::encode<D>(&tm[1], v, n, w, heads))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is per function; set it once
  if (!smem_set) {
    cudaError_t err = allow_smem(window_attention_tma_kernel<D, EXACT, true>, kSmemMax);
    if (err == cudaSuccess) err = allow_smem(window_attention_tma_kernel<D, EXACT, false>, kSmemMax);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const frame::Plan pl = frame::plan<D>(w, kWWarps, 1);
  if (pl.smem == 0) return cudaErrorInvalidValue;  // W past ~14000
  auto kernel = pl.resident ? window_attention_tma_kernel<D, EXACT, true>
                            : window_attention_tma_kernel<D, EXACT, false>;
  kernel<<<dim3(pl.ctas, heads, n), kWThreads, pl.smem, stream>>>(
      tm[0], tm[1], static_cast<const bf16*>(q), static_cast<const int*>(ids), static_cast<bf16*>(out),
      static_cast<float*>(lse), w, heads, scale, pl.tiles, pl.ring);
  return cudaGetLastError();
}

}  // namespace o3v

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. All are built for the vision tower's
// head_dim of 80, K2 (both modes) for 72 too (Qwen3-VL's tower). K1 takes
// the row kernel at W = 64 and 128, the general route at other widths.
extern "C" int o3v_fused_window_attention(const void* qkv, const void* cos, const void* sin,
                                          const void* ids, void* out, int n, int w, int heads,
                                          int head_dim, float scale, void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 64) return o3v::launch_fused_rows<80, 64, false>(qkv, cos, sin, ids, out, n, heads, scale, s);
  if (w == 128) return o3v::launch_fused_rows<80, 128, false>(qkv, cos, sin, ids, out, n, heads, scale, s);
  return o3v::launch_fused<80>(qkv, cos, sin, ids, out, n, w, heads, scale, s);
}

// K2 keeps a frame-head's K and V in shared memory where they fit (W <=
// 640 at head_dim 80, 768 at 72); wider frames stream them.
extern "C" int o3v_window_attention(const void* q, const void* k, const void* v, const void* ids,
                                    void* out, int n, int w, int heads, int head_dim, float scale,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 80)
    return o3v::launch_window_tma<80, false>(q, k, v, ids, out, nullptr, n, w, heads, scale, s);
  if (head_dim == 72)
    return o3v::launch_window_tma<72, false>(q, k, v, ids, out, nullptr, n, w, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Exact modes (training). window_attention_exact also writes lse (N, H, W)
// float32, the log-sum-exp of each row's masked scores, for K6.
extern "C" int o3v_fused_window_attention_exact(const void* qkv, const void* cos,
                                                const void* sin, const void* ids, void* out,
                                                int n, int w, int heads, int head_dim,
                                                float scale, void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 64) return o3v::launch_fused_rows<80, 64, true>(qkv, cos, sin, ids, out, n, heads, scale, s);
  if (w == 128) return o3v::launch_fused_rows<80, 128, true>(qkv, cos, sin, ids, out, n, heads, scale, s);
  return o3v::launch_fused_exact<80>(qkv, cos, sin, ids, out, n, w, heads, scale, s);
}

extern "C" int o3v_window_attention_exact(const void* q, const void* k, const void* v,
                                          const void* ids, void* out, void* lse, int n, int w,
                                          int heads, int head_dim, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 80) return o3v::launch_window_tma<80, true>(q, k, v, ids, out, lse, n, w, heads, scale, s);
  if (head_dim == 72) return o3v::launch_window_tma<72, true>(q, k, v, ids, out, lse, n, w, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
