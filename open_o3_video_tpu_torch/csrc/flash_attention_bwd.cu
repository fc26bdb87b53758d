// Causal GQA flash attention backward for Hopper (sm_90a): K5.
//
// Replaces open_o3_video_tpu/ops/flash_attention.py _bwd_dq_kernel and
// _bwd_dkv_kernel, the decoder's FlashAttention-2 backward under training.
// q arrives prescaled by D^-1/2 and rounded to bf16 exactly as the forward
// saw it, so the recomputed p = exp(q.k - lse) matches the forward's; dq
// carries the explicit D^-1/2, dk none (the prescale holds it). Rows past a
// row's right padding (kv_valid 0) take no part; a query at position -1 gets
// dq = 0.
//
// dq is attention_bwd.cuh's kernel in causal mode (one CTA per 64-row query
// tile and query head). dk/dv have their own causal kernels here (K6's
// window backward keeps the shared one):
//
//   1. causal_dkv_partial_kernel: one CTA per (64-key tile, query head,
//      batch row): 1372 CTAs at the SFT shape (T = 3136, 28 heads), where
//      one CTA per kv head gave 196 that each walked 7 heads serially. It
//      loads its kv head's k and v tile once, finds from the positions alone
//      which 64-row query tiles can see a key of the tile (positions are
//      data: -1, padding and any order are allowed), and walks only those,
//      q/dout/lse/delta/positions through a 2-stage cp.async ring, so the
//      next tile's loads overlap this tile's products and no load is thrown
//      away. Heads vary fastest in the launch order and key tiles ascend, so
//      the heaviest CTAs (key tile 0 sees every query) start first. It
//      writes its head's dk and dv in f32 to a workspace (2, B, T, Hq, D).
//   2. dkv_group_sum_kernel: sums the G heads of each kv head in head order
//      in f32, applies dk_scale and rounds to bf16: deterministic, no
//      atomics, the f32 group sum of the JAX kernel.
//
// Products stay bf16 mma.sync m16n8k16 with f32 accumulation (the routines
// of attention_tile.cuh); p and ds are rounded to bf16 as operands. What
// bounds it on the H100: the products, ~4 causal matmuls of the forward's
// size (8 FLOP per visible (query, key, d) pair; 0.14 ms at the SFT shape).
// wgmma is later work.
#include "attention_bwd.cuh"

namespace o3v {
namespace {

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
    skey[threadIdx.x] = key_tag_at<kCausal>(kt, k0 + threadIdx.x, a.t_len);
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
  a.s_scale = 1.f;
  a.dq_scale = 1.f / sqrtf(128.f);
  a.dk_scale = 1.f;
  return a;
}

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
  if (head_dim != 128 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
  o3v::BwdArgs a =
      o3v::causal_args(q, k, v, dout, lse, delta, q_pos, kv_valid, s_len, t_len, hq, hkv);
  a.dq = static_cast<o3v::bf16*>(dq);
  return o3v::launch_bwd_dq<128, o3v::kCausal>(a, b, static_cast<cudaStream_t>(stream));
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
