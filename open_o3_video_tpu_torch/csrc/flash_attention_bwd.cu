// Causal GQA flash attention backward for Hopper (sm_90a): K5.
//
// Replaces open_o3_video_tpu/ops/flash_attention.py _bwd_dq_kernel and
// _bwd_dkv_kernel, the decoder's FlashAttention-2 backward under training.
// q arrives prescaled by D^-1/2 and rounded to bf16 exactly as the forward
// saw it, so the recomputed p = exp(q.k - lse) matches the forward's, with
// dp = dout @ v^T and delta = rowsum(dout * out) (computed by the caller):
//     ds = bf16(p * (dp - delta))
//     dq = D^-1/2 * ds @ k     dk = ds^T @ q     dv = bf16(p)^T @ dout
// dq carries the explicit D^-1/2 (applied once, at the end; JAX applies it
// to each tile's product), dk none (the prescale holds it). Keys past a
// row's right padding (kv_valid 0) take no part; a query at position -1
// gets dq = 0. Positions are data: -1, holes and any order are allowed.
//
// dq (causal_dq_kernel) is FlashAttention-3's dq. What bounds it on the
// H100: the bf16 tensor cores, 6 FLOP per visible (query, key, d) pair
// (S = Q K^T, dP = dO V^T, dq += ds K), 0.11 ms at the SFT shape (S = T =
// 3136, 28/4 heads of 128). The design is K3's (flash_attention.cu; the
// CTA, its order and its producer in causal_cta.cuh):
// - A CTA is three warpgroups: a TMA producer (setmaxnreg down) and two
//   consumers of 64 query rows each, 128 rows of one head. The producer
//   loads the CTA's Q and dout once, then K and V in 64-key tiles (two
//   64-column boxes each, 128-byte swizzle) through a ring of kStages slots
//   with full and empty mbarriers; its first warp reads each tile's
//   kv_valid into shared memory and flags a fully valid tile.
// - S and dP are wgmma m64n64k16 from shared memory (K and V rows hold D
//   contiguously: the K-major B operand). ds stays in registers: the
//   accumulator layout of S is the register A layout of the next product,
//   dq += bf16(ds) K, with K as the MN-major B operand (V's role in K3's PV).
//   A warpgroup issues S and dP of tile j, then ds K of tile j - 1, and
//   forms tile j's ds while that product runs. 64-key tiles keep the three
//   accumulators (dq 64 x 128, S and dP 64 x 64) in 128 f32 registers a
//   thread, where 128-key tiles would need 192.
// - p = 2^(s log2 e - lse log2 e) by the SFU's ex2.approx; ds in f32.
// - A tile fully at or below the warpgroup's smallest position and fully
//   valid takes the path with no mask. Tiles past the CTA's largest
//   position are never loaded; a warpgroup skips the products of tiles past
//   its own. Query tiles run longest first, K3's static order
//   (ops/flash_attention.py:cta_plan mirrors it).
//
// dk/dv have their own pair of kernels (bound by the products too, 8 FLOP
// per visible pair; mma.sync m16n8k16 with f32 accumulation):
//
//   1. causal_dkv_partial_kernel: one CTA per (64-key tile, query head,
//      batch row): 1372 CTAs at the SFT shape (T = 3136, 28 heads), where
//      one CTA per kv head gave 196 that each walked 7 heads serially. It
//      loads its kv head's k and v tile once, finds from the positions alone
//      which 64-row query tiles can see a key of the tile, and walks only
//      those, q/dout/lse/delta/positions through a 2-stage cp.async ring, so
//      the next tile's loads overlap this tile's products and no load is
//      thrown away. Heads vary fastest in the launch order and key tiles
//      ascend, so the heaviest CTAs (key tile 0 sees every query) start
//      first. It writes its head's dk and dv in f32 to a workspace (2, B, T,
//      Hq, D).
//   2. dkv_group_sum_kernel: sums the G heads of each kv head in head order
//      in f32, applies dk_scale and rounds to bf16: deterministic, no
//      atomics, the f32 group sum of the JAX kernel.
#include <climits>

#include "causal_cta.cuh"
#include "wgmma.cuh"

namespace o3v {
namespace {

struct BwdArgs {
  const bf16* q;       // (B, S, Hq, D), prescaled
  const bf16* k;       // (B, T, Hkv, D)
  const bf16* v;       // (B, T, Hkv, D)
  const bf16* dout;    // (B, S, Hq, D)
  const float* lse;    // (B, Hq, S)
  const float* delta;  // (B, Hq, S)
  const int* q_tag;    // (B, S): positions
  const int* k_tag;    // (B, T): kv validity
  bf16* dk;            // (B, T, Hkv, D)
  bf16* dv;
  int s_len, t_len, hq, hkv;
  float dk_scale;
};

// kv validity of key j (0 past the end)
__device__ __forceinline__ int key_tag_at(const int* tags, int j, int n) {
  return j < n ? tags[j] : 0;
}

constexpr int kDkvRows = 64;    // query rows per ring stage
constexpr int kDkvStages = 2;

template <int D>
struct DkvStage {
  bf16 q[kDkvRows][D + kPad];
  bf16 dout[kDkvRows][D + kPad];
  float lse[kDkvRows];
  float delta[kDkvRows];
  int pos[kDkvRows];
};

template <int D>
constexpr size_t dkv_partial_smem_bytes(int n_qtiles) {
  return 2 * sizeof(Tile<D>) + kDkvStages * sizeof(DkvStage<D>) + kKeys * sizeof(int) +
         n_qtiles * sizeof(int);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Query tile i's rows of head h into a ring stage (rows past S zero-filled;
// their positions are read as -1 by the caller).
template <int D>
__device__ __forceinline__ void load_dkv_stage(DkvStage<D>& st, const BwdArgs& a, long long q_off,
                                               long long q_stride, long long stat, int i0) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < kDkvRows * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 8;
    const bool ok = i0 + r < a.s_len;
    const long long off = ok ? q_off + (i0 + r) * q_stride + c : 0;
    cp_async16(&st.q[r][c], a.q + off, ok);
    cp_async16(&st.dout[r][c], a.dout + off, ok);
  }
  for (int idx = threadIdx.x; idx < 3 * kDkvRows; idx += kThreads) {
    const int which = idx / kDkvRows, r = idx % kDkvRows;
    const bool ok = i0 + r < a.s_len;
    const long long row = ok ? i0 + r : 0;
    if (which == 0) cp_async4(&st.lse[r], a.lse + stat + row, ok);
    else if (which == 1) cp_async4(&st.delta[r], a.delta + stat + row, ok);
    else cp_async4(&st.pos[r], a.q_tag + static_cast<long long>(blockIdx.z) * a.s_len + row, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) causal_dkv_partial_kernel(BwdArgs a, float* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<D>& sk = *reinterpret_cast<Tile<D>*>(smem);
  Tile<D>& sv = *reinterpret_cast<Tile<D>*>(smem + sizeof(Tile<D>));
  DkvStage<D>* ring = reinterpret_cast<DkvStage<D>*>(smem + 2 * sizeof(Tile<D>));
  int* skey = reinterpret_cast<int*>(ring + kDkvStages);
  int* live = skey + kKeys;  // per query tile: can it see a key of this tile
  const int h = blockIdx.x, k0 = blockIdx.y * kKeys, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const long long q_stride = static_cast<long long>(a.hq) * D;
  const long long kv_stride = static_cast<long long>(a.hkv) * D;
  const long long q_off = static_cast<long long>(b) * a.s_len * q_stride + h * D;
  const long long kv_off = static_cast<long long>(b) * a.t_len * kv_stride + hk * D;
  const long long stat = (static_cast<long long>(b) * a.hq + h) * a.s_len;
  const int* qt = a.q_tag + static_cast<long long>(b) * a.s_len;
  const int* kt = a.k_tag + static_cast<long long>(b) * a.t_len;
  const int n_qtiles = (a.s_len + kDkvRows - 1) / kDkvRows;

  load_tile<D>(sk, a.k + kv_off, kv_stride, k0, a.t_len);
  load_tile<D>(sv, a.v + kv_off, kv_stride, k0, a.t_len);
  int any_key = 0;
  if (threadIdx.x < kKeys) {
    skey[threadIdx.x] = key_tag_at(kt, k0 + threadIdx.x, a.t_len);
    any_key = skey[threadIdx.x] != 0;
  }
  any_key = __syncthreads_or(any_key);
  // A query tile is live iff one of its positions reaches k0: decided from
  // the 64 positions before any q/dout load.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n_qtiles; i += kThreads / 32) {
    const int r0 = i * kDkvRows + lane, r1 = r0 + 32;
    int m = max(r0 < a.s_len ? qt[r0] : -1, r1 < a.s_len ? qt[r1] : -1);
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) live[i] = any_key && m >= k0;
  }
  __syncthreads();
  auto next_live = [&](int i) {
    while (i < n_qtiles && !live[i]) ++i;
    return i;
  };

  const int g = lane >> 2, t = lane & 3, jr = warp * 16 + g;
  const int ktag[2] = {skey[jr], skey[jr + 8]};
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  int cur = next_live(0), slot = 0;
  if (cur < n_qtiles) load_dkv_stage<D>(ring[0], a, q_off, q_stride, stat, cur * kDkvRows);
  cp_async_commit();
  while (cur < n_qtiles) {
    const int nxt = next_live(cur + 1);
    if (nxt < n_qtiles) load_dkv_stage<D>(ring[slot ^ 1], a, q_off, q_stride, stat, nxt * kDkvRows);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile cur have landed
    __syncthreads();     // ... and everyone's
    DkvStage<D>& st = ring[slot];
    const int i0 = cur * kDkvRows;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // 32 query rows at a time
      constexpr int kN = 4;
      float s[kN][4], dp[kN][4];
      scores_smem<D, kN>(s, sk, warp * 16, st.q + 32 * hf);
      scores_smem<D, kN>(dp, sv, warp * 16, st.dout + 32 * hf);
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 32 * hf + nt * 8 + 2 * t + (e & 1), half = e >> 1;
          const int rt = i0 + i < a.s_len ? st.pos[i] : -1;
          const float p = visible<kCausal>(rt, ktag[half], k0 + jr + 8 * half)
                              ? expf(s[nt][e] - st.lse[i])
                              : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - st.delta[i]);
        }
      accumulate_xb<D, kN>(dv, s, st.dout + 32 * hf);
      accumulate_xb<D, kN>(dk, dp, st.q + 32 * hf);
    }
    __syncthreads();  // the stage is consumed before the next load reuses it
    cur = nxt;
    slot ^= 1;
  }
  cp_async_wait<0>();

  const long long plane = static_cast<long long>(gridDim.z) * a.t_len * a.hq * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + jr + 8 * half;
    if (row >= a.t_len) continue;
    float* pk = ws + ((static_cast<long long>(b) * a.t_len + row) * a.hq + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<float2*>(pk + dt * 8) = make_float2(dk[dt][2 * half], dk[dt][2 * half + 1]);
      *reinterpret_cast<float2*>(pk + plane + dt * 8) =
          make_float2(dv[dt][2 * half], dv[dt][2 * half + 1]);
    }
  }
}

// dk[b, t, hk] = bf16(dk_scale * sum over the group's heads in order), dv
// likewise (scale 1): one thread per 4 values of one row.
template <int D>
__global__ void dkv_group_sum_kernel(const float* __restrict__ ws, bf16* __restrict__ dk,
                                     bf16* __restrict__ dv, long long rows, int hq, int hkv,
                                     float dk_scale) {
  const long long n_vec = rows * hkv * (D / 4);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 2 * n_vec) return;
  const int which = idx >= n_vec;
  const long long rem = idx - which * n_vec;
  const long long r = rem / (hkv * (D / 4));
  const int hk = static_cast<int>((rem / (D / 4)) % hkv), d = static_cast<int>(rem % (D / 4)) * 4;
  const int group = hq / hkv;
  const float* src = ws + which * rows * hq * D + (r * hq + hk * group) * D + d;
  float4 sum = *reinterpret_cast<const float4*>(src);
  for (int gh = 1; gh < group; ++gh) {
    const float4 v = *reinterpret_cast<const float4*>(src + gh * D);
    sum.x = __fadd_rn(sum.x, v.x);
    sum.y = __fadd_rn(sum.y, v.y);
    sum.z = __fadd_rn(sum.z, v.z);
    sum.w = __fadd_rn(sum.w, v.w);
  }
  const float sc = which ? 1.f : dk_scale;
  bf16* o = (which ? dv : dk) + (r * hkv + hk) * D + d;
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16x2(__fmul_rn(sum.x, sc), __fmul_rn(sum.y, sc)),
                                            pack_bf16x2(__fmul_rn(sum.z, sc), __fmul_rn(sum.w, sc)));
}

template <int D>
cudaError_t launch_causal_dkv(const BwdArgs& a, float* ws, int b, cudaStream_t stream) {
  const int n_qtiles = (a.s_len + kDkvRows - 1) / kDkvRows;
  const size_t smem = dkv_partial_smem_bytes<D>(n_qtiles);
  cudaError_t err = allow_smem(causal_dkv_partial_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.hq, (a.t_len + kKeys - 1) / kKeys, b);
  causal_dkv_partial_kernel<D><<<grid, kThreads, smem, stream>>>(a, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(b) * a.t_len;
  const long long threads = 2 * rows * a.hkv * (D / 4);
  constexpr int kSumThreads = 256;
  dkv_group_sum_kernel<D><<<static_cast<unsigned>((threads + kSumThreads - 1) / kSumThreads),
                            kSumThreads, 0, stream>>>(ws, a.dk, a.dv, rows, a.hq, a.hkv, a.dk_scale);
  return cudaGetLastError();
}

BwdArgs causal_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, const void* q_pos, const void* kv_valid, int s_len,
                    int t_len, int hq, int hkv) {
  BwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.q_tag = static_cast<const int*>(q_pos);
  a.k_tag = static_cast<const int*>(kv_valid);
  a.s_len = s_len;
  a.t_len = t_len;
  a.hq = hq;
  a.hkv = hkv;
  a.dk_scale = 1.f;
  return a;
}

// ---- dq --------------------------------------------------------------------

namespace k5 {

using namespace causal;
constexpr int kKeyTile = 64;            // keys per ring slot
constexpr int kStages = 4;              // ring slots
constexpr int kQBytes = 2 * 2 * kQBox;            // the CTA's q (or dout): two warpgroups, two halves
constexpr int kKVBox = kKeyTile * kHalfBox;       // 8 KB: 64 keys, 64 columns
constexpr int kKVBytes = 2 * kKVBox;              // one K (or V) tile
constexpr int kDoOff = kQBytes;
constexpr int kKOff = 2 * kQBytes;
constexpr int kVOff = kKOff + kStages * kKVBytes;
constexpr int kTagOff = kVOff + kStages * kKVBytes;  // a byte per key: kv_valid != 0
constexpr int kFlagOff = kTagOff + kStages * kKeyTile;
constexpr int kPosOff = (kFlagOff + kStages * 4 + 15) & ~15;  // the CTA's query positions
constexpr int kBarOff = kPosOff + 2 * kWgRows * 4;
constexpr int kLayout = kBarOff + (1 + 2 * kStages) * 8;
constexpr int kSmem = kLayout + 1024;             // slack to align the base to 1024
static_assert(kSmem <= kSmemMax, "shared memory layout");
static_assert(kQBox == kKVBox, "q and K tiles share their k16 offsets");

__global__ void __launch_bounds__(kCtaThreads, 1)
    causal_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ q_pos,
                     const int* __restrict__ kv_valid, bf16* __restrict__ dq, int s_len,
                     int t_len, int hq, int group, float dq_scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = async::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle needs 1024-byte alignment
  uint8_t* gbase = smem_raw + (base - raw);
  uint8_t* tags = gbase + kTagOff;
  int* flags = reinterpret_cast<int*>(gbase + kFlagOff);
  int* spos = reinterpret_cast<int*>(gbase + kPosOff);
  const uint32_t bars = base + kBarOff;
  const uint32_t q_full = bars;  // q and dout
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
      async::mbar_expect_tx(q_full, 2 * kQBytes);
      for (int c = 0; c < 2; ++c)
        for (int h = 0; h < 2; ++h) {
          const int row = w.row0 + c * kWgRows;
          async::tma_load_4d(base + (2 * c + h) * kQBox, &tm_q, q_full, h * 64, w.head, row, w.b);
          async::tma_load_4d(base + kDoOff + (2 * c + h) * kQBox, &tm_do, q_full, h * 64, w.head,
                             row, w.b);
        }
    }
    produce_kv<kKeyTile, kStages>(&tm_k, &tm_v, w, w.head / group, kv_valid, t_len, n_tiles,
                                  k_slot(0), v_slot(0), full(0), empty(0), tags, flags, lane);
    return;
  }

  // ---- consumers: 64 query rows each -------------------------------------
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
  // this thread's two rows: lse in log2 units (a row with no visible key,
  // lse NEG_INF, is masked on every key) and delta
  float lse2[2], dlt[2];
  const long long stat = (static_cast<long long>(w.b) * hq + w.head) * s_len;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * warp + g + 8 * half;
    const float l = row < s_len ? lse[stat + row] : 0.f;
    lse2[half] = l == kNegInf ? 0.f : l * kLog2e;
    dlt[half] = row < s_len ? delta[stat + row] : 0.f;
  }
  // the tiles this warpgroup multiplies: those at or below its largest
  // position (uniform in the warpgroup; the shuffle lets the compiler see it)
  const int mine = __shfl_sync(0xffffffffu, wg_max < 0 ? 0 : min(n_tiles, wg_max / kKeyTile + 1), 0);
  const uint32_t q_base = base + c * 2 * kQBox, do_base = q_base + kDoOff;
  async::mbar_wait(q_full, 0);

  float acc[64], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t da[kKeyTile / 16][4], dn[kKeyTile / 16][4];

  auto products = [&](int st) {  // s = Q K^T and dp = dO V^T, committed, not awaited
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kQBox + (kk & 3) * 32;  // kQBox == kKVBox
      wg::m64n64k16(s, wg::sw128_desc(q_base + off), wg::sw128_desc(k_slot(st) + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kQBox + (kk & 3) * 32;
      wg::m64n64k16(dp, wg::sw128_desc(do_base + off), wg::sw128_desc(v_slot(st) + off), kk > 0);
    }
    wg::commit();
  };
  auto dq_product = [&](int st) {  // acc += ds K from da, committed, not awaited
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk)
      wg::m64n128k16_rs_mn(acc, da[kk], wg::sw128_mn_desc(k_slot(st) + kk * 2048, kKVBox));
    wg::commit();
  };
  // ds = p (dp - delta) of tile j, as bf16 A fragments in dn; p = 0 where
  // masked. s[4 nt + e] (and dp): row 16 warp + g + 8 (e >> 1), key k0 + 8
  // nt + 2t + (e & 1)
  auto grads = [&](int j, int st) {
    const int k0 = j * kKeyTile;
    const bool interior = flags[st] && k0 + kKeyTile - 1 <= wg_min;
    const uint8_t* tag = tags + st * kKeyTile;
#pragma unroll
    for (int nt = 0; nt < kKeyTile / 8; ++nt) {
      const uint16_t tg = *reinterpret_cast<const uint16_t*>(tag + 8 * nt + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, col = 8 * nt + 2 * t + (e & 1);
        const bool ok = interior || (((tg >> (8 * (e & 1))) & 0xff) && k0 + col <= row_pos[half]);
        const float p = ok ? ex2(s[4 * nt + e] * kLog2e - lse2[half]) : 0.f;
        s[4 * nt + e] = p * (dp[4 * nt + e] - dlt[half]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      dn[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
      dn[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      dn[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      dn[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto take = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) da[kk][i] = dn[kk][i];
  };

  if (mine > 0) {
    async::mbar_wait(full(0), 0);
    wg::fence();
    products(0);
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);
    grads(0, 0);
    take();
    for (int j = 1; j < mine; ++j) {
      const int st = j % kStages, prev = (j - 1) % kStages;
      async::mbar_wait(full(st), (j / kStages) & 1);
      wg::fence();
      products(st);
      dq_product(prev);
      wg::wait<1>();  // s and dp; ds K of tile j - 1 may still run
      wg::fence_regs(s);
      wg::fence_regs(dp);
      grads(j, st);
      wg::wait<0>();
      wg::fence_regs(acc);
      wg::fence_regs(da);  // the product reads da until here
      async::mbar_arrive(empty(prev));
      take();
    }
    wg::fence();
    dq_product((mine - 1) % kStages);
    wg::wait<0>();
    wg::fence_regs(acc);
    wg::fence_regs(da);
    async::mbar_arrive(empty((mine - 1) % kStages));
  }
  for (int j = mine; j < n_tiles; ++j) {  // tiles past this warpgroup's rows
    async::mbar_wait(full(j % kStages), (j / kStages) & 1);
    async::mbar_arrive(empty(j % kStages));
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * warp + g + 8 * half;
    if (row >= s_len) continue;
    bf16* o = dq + ((static_cast<long long>(w.b) * s_len + row) * hq + w.head) * kD + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(o + 8 * nt) =
          pack_bf16x2(acc[4 * nt + 2 * half] * dq_scale, acc[4 * nt + 2 * half + 1] * dq_scale);
  }
}

// Tensor maps over q and dout (B, S, Hq, D) and k, v (B, T, Hkv, D), all
// contiguous, in 64-column boxes with the 128-byte swizzle; a CTA per 128
// query rows of one head.
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* q_pos, const void* kv_valid,
                      void* dq, int b, int s_len, int t_len, int hq, int hkv, float dq_scale,
                      cudaStream_t stream) {
  if (b < 1 || s_len < 1 || t_len < 1 || hkv < 1 || hq % hkv != 0) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  const cuuint64_t q_dims[4] = {kD, static_cast<cuuint64_t>(hq), static_cast<cuuint64_t>(s_len),
                                static_cast<cuuint64_t>(b)};
  const cuuint64_t q_strides[3] = {kD * 2, static_cast<cuuint64_t>(hq) * kD * 2,
                                   static_cast<cuuint64_t>(s_len) * hq * kD * 2};
  const cuuint32_t q_box[4] = {64, 1, kWgRows, 1};
  const cuuint64_t kv_dims[4] = {kD, static_cast<cuuint64_t>(hkv), static_cast<cuuint64_t>(t_len),
                                 static_cast<cuuint64_t>(b)};
  const cuuint64_t kv_strides[3] = {kD * 2, static_cast<cuuint64_t>(hkv) * kD * 2,
                                    static_cast<cuuint64_t>(t_len) * hkv * kD * 2};
  const cuuint32_t kv_box[4] = {64, 1, kKeyTile, 1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!async::encode_4d(&tm_q, bf, q, q_dims, q_strides, q_box, sw) ||
      !async::encode_4d(&tm_do, bf, dout, q_dims, q_strides, q_box, sw) ||
      !async::encode_4d(&tm_k, bf, k, kv_dims, kv_strides, kv_box, sw) ||
      !async::encode_4d(&tm_v, bf, v, kv_dims, kv_strides, kv_box, sw))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is per function; set it once
  if (!smem_set) {
    const cudaError_t err = allow_smem(causal_dq_kernel, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int n_qt = (s_len + 2 * kWgRows - 1) / (2 * kWgRows);
  causal_dq_kernel<<<n_qt * b * hq, kCtaThreads, kSmem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_valid), static_cast<bf16*>(dq),
      s_len, t_len, hq, hq / hkv, dq_scale);
  return cudaGetLastError();
}

}  // namespace k5
}  // namespace
}  // namespace o3v

// Plain C interface (loaded with ctypes); each returns cudaGetLastError()
// after its launch(es). q (prescaled), dout, dq: (B, S, Hq, D); k, v, dk, dv:
// (B, T, Hkv, D), all contiguous bf16; lse, delta: (B, Hq, S) float32;
// q_pos (B, S), kv_valid (B, T) int32; ws (2, B, T, Hq, D) float32 scratch.
// Built for head_dim 128 only.
extern "C" int o3v_flash_attention_gqa_bwd_dq(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, const void* q_pos,
                                              const void* kv_valid, void* dq, int b, int s_len,
                                              int t_len, int hq, int hkv, int head_dim,
                                              void* stream) {
  if (head_dim != o3v::k5::kD) return static_cast<int>(cudaErrorInvalidValue);
  return o3v::k5::launch_dq(q, k, v, dout, lse, delta, q_pos, kv_valid, dq, b, s_len, t_len, hq,
                            hkv, 1.f / sqrtf(128.f), static_cast<cudaStream_t>(stream));
}

// Two kernels on the stream: the per-head partials into ws, then the group
// sum into dk and dv.
extern "C" int o3v_flash_attention_gqa_bwd_dkv(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, const void* q_pos,
                                               const void* kv_valid, void* dk, void* dv, void* ws,
                                               int b, int s_len, int t_len, int hq, int hkv,
                                               int head_dim, void* stream) {
  if (head_dim != 128 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
  o3v::BwdArgs a =
      o3v::causal_args(q, k, v, dout, lse, delta, q_pos, kv_valid, s_len, t_len, hq, hkv);
  a.dk = static_cast<o3v::bf16*>(dk);
  a.dv = static_cast<o3v::bf16*>(dv);
  return o3v::launch_causal_dkv<128>(a, static_cast<float*>(ws), b,
                                     static_cast<cudaStream_t>(stream));
}
