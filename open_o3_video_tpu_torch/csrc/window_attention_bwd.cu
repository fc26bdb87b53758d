// ViT window-attention backward for Hopper (sm_90a): K6.
//
// fused_window_attention_bwd replaces open_o3_video_tpu/ops/window_attention.py
// _fused_bwd_kernel (the 28 windowed blocks), at the packed row widths W = 64
// and 128. Per (row, head) it re-ropes q and k from the raw qkv row in f32
// with no FMA contraction, as K1 does, rounds them to bf16, and recomputes
// the exact in-window softmax p = exp(s - m) / l in registers (a pad row, id
// 0, attends uniformly, as JAX's all-NEG_INF row does). Then, as JAX does,
// ds = p * (dp - rowsum(dp * p)) * D^-1/2 with dp = dout @ v^T, dq = ds @ k,
// dk = ds^T @ q, dv = p^T @ dout, and the rope transpose dx = dy * cos +
// [a2, -a1] (a = dy * sin, halves D / 2 apart) on dq and dk, written with dv
// into one (N, W, 3 * H * D) dqkv row at the lane offsets h * D, H * D + h *
// D and 2 * H * D + h * D of the qkv layout.
//
// What bounds it on the H100: per (row, head) at W = 64 five 64 x 64 x 80
// products (~3.3 MFLOP) against ~60 KB of qkv, dout and dqkv: ~44 FLOP per
// byte, under the ~295 FLOP/byte where bf16 tensor cores become the limit,
// so it is bound by device-memory bytes, and by latency where each load is
// awaited in turn. The design (window_row.cuh):
// - a CTA takes one head of one row, its q, k, v and dout slabs coming by
//   TMA at once, so every SM holds several (row, head) items with their
//   loads in flight;
// - each warp owns 16 rows: as query rows it forms s, dp, p and ds in
//   registers and dq = ds @ k; as key rows, dk = ds^T @ q and dv = p^T @
//   dout, with p and ds staged in shared memory as bf16 (read transposed by
//   ldmatrix), the one exchange between warps;
// - the rope of q and k and its transpose on dq and dk run on each thread's
//   own fragment positions in registers, cos/sin read at those positions
//   through L1: no f32 staging, no table reads per element.
//
// window_attention_bwd_{dq,dkv} replace _bwd_kernel (the 4 global blocks,
// whole frames: W = 448, 432 valid, at 18x24 patches; 16 heads of 80; and
// every block of the towers without windows: Qwen2-VL's at 80, Qwen3-VL's
// 27 at 72, W = 352 at 16x22 patches and 784 at 28x28), which returns dq,
// dk and dv from one pallas_call; here two kernels. They
// take the keys in 64-row tiles, so rowsum(dp * p) comes as delta =
// rowsum(dout * out) (the caller's) with p = exp(s - lse) from the
// forward's lse (FlashAttention-2 form), in log2 units by ex2.approx:
//     ds = p * (dp - delta)      dq = D^-1/2 * bf16(ds) @ k
//     dk = D^-1/2 * bf16(ds)^T @ q                  dv = bf16(p)^T @ dout
// with s = D^-1/2 q.k, and a pad row (id 0) scoring 0 on every key of its
// frame (the uniform softmax of JAX's all-NEG_INF row).
//
// What bounds them on the H100: device-memory bytes, by a little. Per
// frame-head at the slice's frames dq's three products are ~90 MFLOP and
// dk/dv's four ~120 against ~0.36 and ~0.43 MB of inputs and outputs: ~250
// FLOP per byte, just under the ~295 at which bf16 tensor cores become the
// limit (bounds of 0.028 and 0.023 ms for dq), and mma.sync runs below
// wgmma's rate, so the products are about as tight a limit. So each input
// crosses device memory once and the products never wait on a load in
// turn. The design is K2's (window_frame.cuh): one CTA per (frame, head), a
// producer warp loading by TMA, the frame-head's two slices resident in
// shared memory, consumer warps of 16 rows each with their own rows'
// fragments from device memory.
// - dq: K and V resident; each warp takes 16 query rows (q and dout A
//   fragments), forms s and dp against every resident key, p from lse and
//   ds from delta in registers, and dq += ds @ K: K2's exact second pass
//   plus one product.
// - dk, dv: q and dout resident, with the frame's query tags, lse and
//   delta; each warp takes 16 key rows (k and v A fragments) and forms the
//   transposed blocks s^T = k q^T and dp^T = v dout^T, then dv += p^T @
//   dout and dk += ds^T @ q.
// At D = 72 the tiles are window_frame.cuh's rows of the head's own 72
// columns: the products over D (s, dp, and their transposes) take its last
// 8 columns by an m16n8k8, those that write D columns (dq, dk, dv) nine
// 8-wide d-tiles, so no product reads the next head's columns.
// A frame past the resident limit (dq: W > 640; dk/dv, whose per-row words
// are three: W > 576; W > 768 for both at D = 72) streams the same way
// through a ring. mma.sync stays:
// the work is bytes-bound, and an 80-column row does not fit the 128-byte
// swizzle of wgmma's operands. Up to four accumulators of 16 x 80 and two
// operand fragments a thread keep a CTA to 7 (dk/dv) or 8 (dq) consumer
// warps, where K2 has 14.
#include "window_frame.cuh"
#include "window_row.cuh"

namespace o3v {

template <int W>
using Square = bf16[W][W + kPad];  // p or ds of the row's W x W scores

// One head of one row, its q, k, v, dout slabs landed (sl[0..3]) and this
// thread's cos/sin in hand (read again, from `cs` and `sn`, for the rope
// transposes): q and k roped in place (q as dk's operand), then this warp's
// 16 rows as query rows (p, ds, dq) and as key rows (dk, dv), p and ds
// staged in sp and sds between the two. dq, dk, dv go to the head's lanes
// h * D, hd + h * D, 2 hd + h * D of the dqkv row `out`.
template <int D, int W>
__device__ __forceinline__ void fused_bwd_row_head(row::Slab<D, W>* sl, Square<W>& sp,
                                                   Square<W>& sds, float2 (&c)[2][D / 8],
                                                   float2 (&s)[2][D / 8], const float* cs,
                                                   const float* sn, const int* tag, bf16* out,
                                                   int h, int hd, float scale) {
  using Slab = row::Slab<D, W>;
  const long long row_stride = 3LL * hd;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3, r8 = lane & 7;
  Slab &sq = sl[0], &sk = sl[1], &sv = sl[2], &sdo = sl[3];
  auto out_row = [&](int col) { return [=](int r) { return out + r * row_stride + col; }; };
  uint32_t qa[D / 16][4];
  {
    float2 x[2][D / 8];
    row::read_own<D, W>(x, sq, r0);
    row::rope<D>(x, c, s);
    row::own_to_a<D>(qa, x);
    row::write_own<D, W>(sq, x, r0);  // roped q: dk's operand
    row::read_own<D, W>(x, sk, r0);
    row::rope<D>(x, c, s);
    row::write_own<D, W>(sk, x, r0);
  }
  __syncthreads();  // q and k roped

  // This warp's 16 query rows against all W keys: p, ds, dq.
  {
    const int row_tag[2] = {tag[r0 + g], tag[r0 + g + 8]};
    float p[W / 8][4], dp[W / 8][4];
    row::scores<D, W>(p, qa, sk);
    {
      uint32_t da[D / 16][4];
      row::slab_a<D, W>(da, sdo, r0);
      row::scores<D, W>(dp, da, sv);
    }
    row::exact_softmax<W>(p, tag, row_tag, scale);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += dp[nt][e] * p[nt][e];
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - rs[e >> 1]) * scale;
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&sp[r0 + g][col]) = pack_bf16x2(p[nt][0], p[nt][1]);
      *reinterpret_cast<uint32_t*>(&sp[r0 + g + 8][col]) = pack_bf16x2(p[nt][2], p[nt][3]);
      *reinterpret_cast<uint32_t*>(&sds[r0 + g][col]) = pack_bf16x2(dp[nt][0], dp[nt][1]);
      *reinterpret_cast<uint32_t*>(&sds[r0 + g + 8][col]) = pack_bf16x2(dp[nt][2], dp[nt][3]);
    }
    float dq[D / 8][4] = {};
    row::times_slab<D, W>(dq, dp, sk);  // dq = ds @ k
    row::load_tab<D>(c, cs, r0);
    row::load_tab<D>(s, sn, r0);
    row::rope_transpose<D>(dq, c, s);
    store_frags<D>(dq, 1.f, r0, W, out_row(h * D));
  }
  __syncthreads();  // p and ds of every row staged

  // This warp's 16 key rows: dk = ds^T @ q, dv = p^T @ dout.
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
#pragma unroll
  for (int kt = 0; kt < W / 16; ++kt) {
    uint32_t ads[4], ap[4];
    ldsm_x4<true>(ads, &sds[kt * 16 + (mat >> 1) * 8 + r8][r0 + (mat & 1) * 8]);
    ldsm_x4<true>(ap, &sp[kt * 16 + (mat >> 1) * 8 + r8][r0 + (mat & 1) * 8]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t f[4];
      ldsm_x4<true>(f, &sq[kt * 16 + (mat & 1) * 8 + r8][(2 * dp + (mat >> 1)) * 8]);
      mma_16816(dk[2 * dp], ads, f[0], f[1]);
      mma_16816(dk[2 * dp + 1], ads, f[2], f[3]);
      ldsm_x4<true>(f, &sdo[kt * 16 + (mat & 1) * 8 + r8][(2 * dp + (mat >> 1)) * 8]);
      mma_16816(dv[2 * dp], ap, f[0], f[1]);
      mma_16816(dv[2 * dp + 1], ap, f[2], f[3]);
    }
  }
  store_frags<D>(dv, 1.f, r0, W, out_row(2 * hd + h * D));
  row::load_tab<D>(c, cs, r0);
  row::load_tab<D>(s, sn, r0);
  row::rope_transpose<D>(dk, c, s);
  store_frags<D>(dk, 1.f, r0, W, out_row(hd + h * D));
}

// A CTA per (row n, head h): blockIdx.x = n * heads + h. The head's q, k, v
// and dout slabs come by TMA on one mbarrier while each thread reads its
// cos/sin. A minimum of one CTA an SM lets ptxas take ~240 registers, where
// left to itself it takes 137 at W = 64 and runs 13% slower
// (scripts/exp_k1_k6_plans.py, PERF.md).
template <int D, int W>
__global__ void __launch_bounds__(2 * W, 1)
    fused_window_bwd_rows_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                                 const __grid_constant__ CUtensorMap tm_dout,
                                 const float* __restrict__ cos, const float* __restrict__ sin,
                                 const int* __restrict__ ids, bf16* __restrict__ dqkv, int heads,
                                 float scale) {
  static_assert(D + kPad == row::kBoxCols, "the TMA box is built for D = 80");
  extern __shared__ uint8_t smem_raw[];
  row::Slab<D, W>* slab = row::slabs<D, W>(smem_raw);  // q, k, v, dout
  Square<W>& sp = *reinterpret_cast<Square<W>*>(slab + 4);
  Square<W>& sds = *(&sp + 1);
  int* tag = reinterpret_cast<int*>(&sds + 1);
  const uint32_t bar = async::smem_u32(tag + W);
  const int n = blockIdx.x / heads, h = blockIdx.x % heads, hd = heads * D;
  const long long row0 = static_cast<long long>(n) * W;
  row::begin<W>(tag, ids + row0, bar);
  if (threadIdx.x == 0) {
    async::mbar_expect_tx(bar, 4 * row::kSlabBytes<D, W>);
    for (int part = 0; part < 3; ++part)
      async::tma_load_2d(async::smem_u32(slab + part), &tm_qkv, bar, part * hd + h * D, n * W);
    async::tma_load_2d(async::smem_u32(slab + 3), &tm_dout, bar, h * D, n * W);
  }
  const float* cs = cos + row0 * D;
  const float* sn = sin + row0 * D;
  float2 c[2][D / 8], s[2][D / 8];
  const int r0 = (threadIdx.x >> 5) * 16;
  row::load_tab<D>(c, cs, r0);
  row::load_tab<D>(s, sn, r0);
  async::mbar_wait(bar, 0);
  fused_bwd_row_head<D, W>(slab, sp, sds, c, s, cs, sn, tag, dqkv + row0 * 3 * hd, h, hd, scale);
}

// Tensor maps over qkv as (N * W, 3 * H * D) and dout as (N * W, H * D), a
// CTA per (row, head).
template <int D, int W>
cudaError_t launch_fused_bwd(const void* qkv, const void* cos, const void* sin, const void* ids,
                             const void* dout, void* dqkv, int n, int heads, float scale,
                             cudaStream_t stream) {
  CUtensorMap tm[2];
  const long long rows = static_cast<long long>(n) * W;
  if (!row::encode_rows(&tm[0], qkv, rows, 3LL * heads * D, W) ||
      !row::encode_rows(&tm[1], dout, rows, static_cast<long long>(heads) * D, W))
    return cudaErrorInvalidValue;
  return row::launch<fused_window_bwd_rows_kernel<D, W>, W>(
      n * heads, row::smem_bytes<D, W>(4, 2 * sizeof(Square<W>)), stream, tm[0], tm[1],
      static_cast<const float*>(cos), static_cast<const float*>(sin), static_cast<const int*>(ids),
      static_cast<bf16*>(dqkv), heads, scale);
}

// ---- the global blocks: a frame-head per CTA --------------------------------

// Consumer warps a CTA, 16 rows (queries or keys) each, beside one producer
// warp. An SM's registers are split over its 4 sub-partitions, so a CTA of
// 8 warps may give a thread up to 255 registers and one of 9 to 12 warps
// 168. dk/dv's four accumulators and two operand fragments take 248: 7
// consumer warps, no spills, the slice's 28 strips in 4 rounds, where 10
// spilled and ran 17% slower. dq fits in 168: 8 consumer warps
// (scripts/exp_k5_k6g_plans.py, PERF.md).
__host__ __device__ constexpr int frame_warps(bool dkv) { return dkv ? 7 : 8; }
__host__ __device__ constexpr int frame_threads(bool dkv) { return 32 * (frame_warps(dkv) + 1); }

// 4-byte words per frame row in shared memory: the key tags (dq), or the
// query rows' tags, lse in log2 units and delta (dk, dv).
__host__ __device__ constexpr int row_words(bool dkv) { return dkv ? 3 : 1; }

struct FrameBwd {
  const bf16 *q, *k, *v, *dout;  // (N, W, H, D)
  const float *lse, *delta;      // (N, H, W)
  const int* ids;                // (N, W) segment ids
  bf16 *dq, *dk, *dv;            // (N, W, H, D)
  int w, heads, n_tiles, ring;
  float scale;                   // D^-1/2
};

// DKV false: dq, with K and V (tm_a, tm_b) resident or streamed; true: dk
// and dv, with q and dout. RESIDENT: tile i in slot i on barrier i, each
// completing once; otherwise load i in slot i % ring on barrier slot (full)
// and ring + slot (empty, one arrive per consumer warp).
template <int D, bool DKV, bool RESIDENT>
__global__ void __launch_bounds__(frame_threads(DKV), 1)
    window_bwd_frame_kernel(const __grid_constant__ CUtensorMap tm_a,
                            const __grid_constant__ CUtensorMap tm_b, FrameBwd f) {
  constexpr int kWarps = frame_warps(DKV), kThreadsF = frame_threads(DKV);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = async::smem_u32(smem_raw);
  const uint32_t base = (raw + frame::kAlign - 1) & ~static_cast<uint32_t>(frame::kAlign - 1);
  frame::FTile<D>* sa = reinterpret_cast<frame::FTile<D>*>(smem_raw + (base - raw));  // K, or q
  frame::FTile<D>* sb = sa + f.ring;                                                   // V, or dout
  const int rows = f.n_tiles * kKeys;
  int* stag = reinterpret_cast<int*>(sb + f.ring);
  float* slse = reinterpret_cast<float*>(stag + rows);  // dk/dv only
  float* sdelta = slse + rows;
  const uint32_t bars = base + 2 * f.ring * frame::kTileBytes<D> + row_words(DKV) * rows * 4;
  auto bar = [&](int i) { return bars + 8 * i; };

  const int h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strips = (f.w + 15) / 16;
  // this CTA's strips: all of the frame-head's (resident), or kWarps
  const int first = RESIDENT ? 0 : blockIdx.x * kWarps;
  const int last = RESIDENT ? strips : min(strips, first + kWarps);
  const int* id = f.ids + static_cast<long long>(n) * f.w;
  const long long stat = (static_cast<long long>(n) * f.heads + h) * f.w;
  for (int i = threadIdx.x; i < rows; i += kThreadsF) {
    const bool in = i < f.w;
    if constexpr (DKV) {  // query rows; -2 past the frame sees no key
      stag[i] = in ? id[i] : -2;
      slse[i] = in ? f.lse[stat + i] * frame::kLog2e : 0.f;
      sdelta[i] = in ? f.delta[stat + i] : 0.f;
    } else {  // keys; -1 past the frame is seen by no row
      stag[i] = in ? id[i] : -1;
    }
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < f.ring; ++i) {
      async::mbar_init(bar(i), 1);
      async::mbar_init(bar(f.ring + i), RESIDENT ? 1 : min(kWarps, last - first));
    }
    async::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {  // ---- producer: TMA loads of 64-row tiles of both slices
    if (lane == 0)
      for (int i = 0; i < f.n_tiles; ++i) {
        const int slot = RESIDENT ? i : i % f.ring;
        if (!RESIDENT && i >= f.ring) async::mbar_wait(bar(f.ring + slot), (i / f.ring - 1) & 1);
        async::mbar_expect_tx(bar(slot), 2 * frame::kTileBytes<D>);
        async::tma_load_3d(async::smem_u32(sa + slot), &tm_a, bar(slot), h * D, i * kKeys, n);
        async::tma_load_3d(async::smem_u32(sb + slot), &tm_b, bar(slot), h * D, i * kKeys, n);
      }
    return;
  }

  // ---- consumers ---------------------------------------------------------
  auto acquire = [&](int i) {  // tile i landed: its slot
    const int slot = RESIDENT ? i : i % f.ring;
    async::mbar_wait(bar(slot), RESIDENT ? 0 : (i / f.ring) & 1);
    return slot;
  };
  auto release = [&](int slot) {
    if constexpr (!RESIDENT) {
      __syncwarp();
      if (lane == 0) async::mbar_arrive(bar(f.ring + slot));
    }
  };
  const int g = lane >> 2;
  const long long row_stride = static_cast<long long>(f.heads) * D;
  const long long off = static_cast<long long>(n) * f.w * row_stride + h * D;
  const float scale2 = f.scale * frame::kLog2e;  // scores in log2 units
  auto out_row = [&](bf16* out) { return [=](int row) { return out + off + row * row_stride; }; };
  float s[frame::kHalfN][4], dp[frame::kHalfN][4];
  for (int strip = first + warp; strip < last; strip += kWarps) {
    const int r = strip * 16 + g;  // this thread's rows r and r + 8
    // q and dout (dq), or k and v (dk/dv); at D = 72 the last step is 8 wide
    uint32_t xa[frame::kKSteps<D>][4], ya[frame::kKSteps<D>][4];
    frame::a_frags<D>(xa, (DKV ? f.k : f.q) + off, row_stride, r, f.w);
    frame::a_frags<D>(ya, (DKV ? f.v : f.dout) + off, row_stride, r, f.w);
    if constexpr (!DKV) {
      const int row_tag[2] = {r < f.w ? stag[r] : -2, r + 8 < f.w ? stag[r + 8] : -2};
      float lse2[2], dlt[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const bool in = r + 8 * half < f.w;
        lse2[half] = in ? f.lse[stat + r + 8 * half] * frame::kLog2e : 0.f;
        dlt[half] = in ? f.delta[stat + r + 8 * half] : 0.f;
      }
      float acc[D / 8][4] = {};
      for (int kt = 0; kt < f.n_tiles; ++kt) {
        const int slot = acquire(kt);
#pragma unroll
        for (int k0 = 0; k0 < kKeys; k0 += frame::kHalf) {
          frame::scores<D>(s, xa, sa[slot], k0);
          frame::scores<D>(dp, ya, sb[slot], k0);
          int2 tag[frame::kHalfN];
          frame::pairs(tag, stag + kt * kKeys + k0);
#pragma unroll
          for (int nt = 0; nt < frame::kHalfN; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int half = e >> 1, key = e & 1 ? tag[nt].y : tag[nt].x;
              const float p =
                  visible<kSegment>(row_tag[half], key, 0)
                      ? frame::ex2(score<kSegment>(s[nt][e], row_tag[half], scale2) - lse2[half])
                      : 0.f;
              s[nt][e] = p * (dp[nt][e] - dlt[half]);
            }
          frame::pv<D>(acc, s, sa[slot], k0);  // dq += ds @ K
        }
        release(slot);
      }
      store_frags<D>(acc, f.scale, strip * 16, f.w, out_row(f.dq));
    } else {
      const int key_tag[2] = {r < f.w ? stag[r] : -1, r + 8 < f.w ? stag[r + 8] : -1};
      float dk[D / 8][4] = {}, dv[D / 8][4] = {};
      for (int qt = 0; qt < f.n_tiles; ++qt) {
        const int slot = acquire(qt);
#pragma unroll
        for (int i0 = 0; i0 < kKeys; i0 += frame::kHalf) {
          frame::scores<D>(s, xa, sa[slot], i0);  // s^T = k q^T
          frame::scores<D>(dp, ya, sb[slot], i0);  // dp^T = v dout^T
          const int c0 = qt * kKeys + i0;
          int2 tag[frame::kHalfN];
          float2 lse2[frame::kHalfN], dlt[frame::kHalfN];
          frame::pairs(tag, stag + c0);
          frame::pairs(lse2, slse + c0);
          frame::pairs(dlt, sdelta + c0);
#pragma unroll
          for (int nt = 0; nt < frame::kHalfN; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool y = e & 1;
              const int row_tag = y ? tag[nt].y : tag[nt].x;
              const float p = visible<kSegment>(row_tag, key_tag[e >> 1], 0)
                                  ? frame::ex2(score<kSegment>(s[nt][e], row_tag, scale2) -
                                               (y ? lse2[nt].y : lse2[nt].x))
                                  : 0.f;
              s[nt][e] = p;
              dp[nt][e] = p * (dp[nt][e] - (y ? dlt[nt].y : dlt[nt].x));
            }
          frame::pv<D>(dv, s, sb[slot], i0);   // dv += p^T @ dout
          frame::pv<D>(dk, dp, sa[slot], i0);  // dk += ds^T @ q
        }
        release(slot);
      }
      store_frags<D>(dk, f.scale, strip * 16, f.w, out_row(f.dk));
      store_frags<D>(dv, 1.f, strip * 16, f.w, out_row(f.dv));
    }
  }
}

// The tensor maps of the two slices a CTA keeps (dims {H*D, W, N}, boxes of
// kPitch<D> columns and 64 rows), then the resident kernel where they fit
// (one CTA per frame-head), else the streaming one.
template <int D, bool DKV>
cudaError_t launch_frame_bwd(const FrameBwd& args, int n, cudaStream_t stream) {
  if (args.w < 1 || n < 1 || args.heads < 1) return cudaErrorInvalidValue;
  CUtensorMap tm[2];
  if (!frame::encode<D>(&tm[0], DKV ? args.q : args.k, n, args.w, args.heads) ||
      !frame::encode<D>(&tm[1], DKV ? args.dout : args.v, n, args.w, args.heads))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is per function; set it once
  if (!smem_set) {
    cudaError_t err = allow_smem(window_bwd_frame_kernel<D, DKV, true>, kSmemMax);
    if (err == cudaSuccess) err = allow_smem(window_bwd_frame_kernel<D, DKV, false>, kSmemMax);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const frame::Plan pl = frame::plan<D>(args.w, frame_warps(DKV), row_words(DKV));
  if (pl.smem == 0) return cudaErrorInvalidValue;
  FrameBwd f = args;
  f.n_tiles = pl.tiles;
  f.ring = pl.ring;
  auto kernel = pl.resident ? window_bwd_frame_kernel<D, DKV, true>
                            : window_bwd_frame_kernel<D, DKV, false>;
  kernel<<<dim3(pl.ctas, args.heads, n), frame_threads(DKV), pl.smem, stream>>>(tm[0], tm[1], f);
  return cudaGetLastError();
}

FrameBwd frame_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, const void* ids, int w, int heads, float scale) {
  FrameBwd f{};
  f.q = static_cast<const bf16*>(q);
  f.k = static_cast<const bf16*>(k);
  f.v = static_cast<const bf16*>(v);
  f.dout = static_cast<const bf16*>(dout);
  f.lse = static_cast<const float*>(lse);
  f.delta = static_cast<const float*>(delta);
  f.ids = static_cast<const int*>(ids);
  f.w = w;
  f.heads = heads;
  f.scale = scale;
  return f;
}

}  // namespace o3v

// Plain C interface (loaded with ctypes); each returns cudaGetLastError()
// after its launch. The fused kernel is built for the vision head_dim of 80
// at row widths 64 and 128; the whole-frame dq and dk/dv for 72 (Qwen3-VL)
// and 80.
extern "C" int o3v_fused_window_attention_bwd(const void* qkv, const void* cos, const void* sin,
                                              const void* ids, const void* dout, void* dqkv,
                                              int n, int w, int heads, int head_dim, float scale,
                                              void* stream) {
  if (head_dim != 80) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 64) return o3v::launch_fused_bwd<80, 64>(qkv, cos, sin, ids, dout, dqkv, n, heads, scale, s);
  if (w == 128) return o3v::launch_fused_bwd<80, 128>(qkv, cos, sin, ids, dout, dqkv, n, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q/k/v/dout/dq/dk/dv (N, W, H, D) contiguous bf16; lse, delta (N, H, W)
// float32; ids (N, W) int32 segment ids.
extern "C" int o3v_window_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* ids, void* dq, int n, int w, int heads,
                                           int head_dim, float scale, void* stream) {
  o3v::FrameBwd f = o3v::frame_args(q, k, v, dout, lse, delta, ids, w, heads, scale);
  f.dq = static_cast<o3v::bf16*>(dq);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 80) return o3v::launch_frame_bwd<80, false>(f, n, s);
  if (head_dim == 72) return o3v::launch_frame_bwd<72, false>(f, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int o3v_window_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            const void* ids, void* dk, void* dv, int n, int w,
                                            int heads, int head_dim, float scale, void* stream) {
  o3v::FrameBwd f = o3v::frame_args(q, k, v, dout, lse, delta, ids, w, heads, scale);
  f.dk = static_cast<o3v::bf16*>(dk);
  f.dv = static_cast<o3v::bf16*>(dv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 80) return o3v::launch_frame_bwd<80, true>(f, n, s);
  if (head_dim == 72) return o3v::launch_frame_bwd<72, true>(f, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
